"""The port's CUDA kernels (K1, K2, K3, K4) against their plain PyTorch
versions, on the card.

Marked ``cuda``: every test skips where there is no CUDA device (decided in
a fixture, never at import). On a machine with an H100 run

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_cuda.py

(``--noconftest``: the repo's conftest imports JAX, which these tests do
not need). This file imports neither JAX nor ``tpualign``.
"""

import numpy as np
import pytest
import torch

from tpualign_torch.models.text import causal_mask
from tpualign_torch.ops.attention import fused_mha, fused_mha_reference
from tpualign_torch.ops.sim_topk import (
    SENTINEL_IDX, masked_sim_topk, masked_sim_topk_reference)
from tpualign_torch.ops.similarity import NEG_INF, WILDCARD_KEY

pytestmark = [pytest.mark.fast, pytest.mark.cuda]


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


@pytest.mark.parametrize("b,t,heads,hd,dtype,causal", [
    (3, 5, 2, 80, torch.float32, False),
    (2, 50, 12, 64, torch.float32, False),
    (4, 77, 8, 64, torch.float32, True),
    (2, 257, 4, 104, torch.float32, False),
    (2, 257, 3, 88, torch.bfloat16, False),
    (5, 33, 8, 64, torch.bfloat16, True),
])
def test_fused_mha_matches_plain(dev, b, t, heads, hd, dtype, causal):
    rng = np.random.default_rng(t * hd)
    qkv = torch.from_numpy(rng.normal(size=(b, t, 3 * heads * hd)).astype(np.float32))
    qkv = qkv.to(dev, dtype)
    mask = causal_mask(t, dev) if causal else None
    before = fused_mha.launches
    got = fused_mha(qkv, heads, mask)
    torch.cuda.synchronize()
    want = fused_mha_reference(qkv, heads, mask)
    assert fused_mha.launches == before + 1
    assert got.dtype == dtype and got.shape == (b, t, heads * hd)
    # fp32: summation order only; bf16: one bf16 ulp (2**-7 relative) of
    # the output or of a rounded probability
    tol = 2e-5 if dtype == torch.float32 else 2e-2
    err = (got.float() - want.float()).abs().max().item()
    assert err <= tol, f"max abs error {err:.3g} > {tol}"


def test_fused_mha_rejects(dev):
    qkv = torch.zeros(1, 4, 3 * 2 * 32, device=dev)
    with pytest.raises(ValueError, match="head dim"):
        fused_mha(qkv, 2)
    with pytest.raises(ValueError, match="sequence length"):
        fused_mha(torch.zeros(1, 300, 3 * 64, device=dev), 1)
    with pytest.raises(NotImplementedError):
        fused_mha(torch.zeros(1, 4, 3 * 64, device=dev, requires_grad=True), 1)


def _sim_inputs(rng, q, n, d, groups, dup=0):
    qv = rng.normal(size=(q, d)).astype(np.float32)
    cv = rng.normal(size=(n, d)).astype(np.float32)
    if dup:
        cv[n - dup:] = cv[:dup]  # exact ties across the corpus
    qv /= np.linalg.norm(qv, axis=1, keepdims=True)
    cv /= np.linalg.norm(cv, axis=1, keepdims=True)
    qk = rng.integers(0, groups, q).astype(np.int32)
    ck = rng.integers(0, groups, n).astype(np.int32)
    return qv, qk, cv, ck


@pytest.mark.parametrize("q,n,d,k,groups", [
    (1, 5000, 512, 10, 1),        # one query: many corpus ranges
    (70, 3001, 64, 128, 3),       # k at the bound
    (33, 200, 40, 1, 4),          # D not a multiple of the depth chunk
    (300, 20000, 512, 100, 50),
])
def test_masked_sim_topk_matches_plain(dev, q, n, d, k, groups):
    rng = np.random.default_rng(q + n + k)
    qv, qk, cv, ck = _sim_inputs(rng, q, n, d, groups, dup=16)
    qk[::8] = WILDCARD_KEY
    qk[1::9] = 10**6                     # no candidates
    ck[::11] = -1                        # padding rows never match
    args = [torch.from_numpy(a).to(dev) for a in (qv, qk, cv, ck)]
    before = masked_sim_topk.launches
    vals, idx = masked_sim_topk(*args, k)
    torch.cuda.synchronize()
    rv, ri = masked_sim_topk_reference(*args, k)
    assert masked_sim_topk.launches == before + 1
    vals, idx, rv, ri = (t.cpu().numpy() for t in (vals, idx, rv, ri))
    empty = ri == SENTINEL_IDX
    assert (idx[empty] == SENTINEL_IDX).all() and (vals[empty] == np.float32(NEG_INF)).all()
    # indices agree except inside runs of the plain version's values that
    # lie within 1e-6 of a neighbour (summation order decides those)
    near = np.zeros_like(empty)
    close = np.abs(np.diff(rv, axis=1)) <= 1e-6
    near[:, 1:] |= close
    near[:, :-1] |= close
    assert (idx[~near] == ri[~near]).all()
    np.testing.assert_allclose(vals, rv, atol=1e-5)


def test_masked_sim_topk_ties_ascending(dev):
    qv = np.ones((2, 64), np.float32) / 8.0
    cv = np.tile(qv[:1], (300, 1))
    keys = np.zeros(300, np.int32)
    args = [torch.from_numpy(a).to(dev) for a in (qv, np.zeros(2, np.int32), cv, keys)]
    _, idx = masked_sim_topk(*args, 7)
    assert idx.cpu().numpy().tolist() == [list(range(7))] * 2


K3_VARIANTS = [("s8", "_quantize_rows", True), ("dequant", "_quantize_rows", False),
               ("int4", "_quantize_rows_int4", True), ("int2", "_quantize_rows_int2", True)]


@pytest.mark.parametrize("variant,quantizer,mxu", K3_VARIANTS)
@pytest.mark.parametrize("k", [1, 10, 40, 128])
def test_masked_sim_topk_quant_matches_plain(dev, variant, quantizer, mxu, k):
    from tpualign_torch.ops.sim_topk import masked_sim_topk_quant
    from tpualign_torch.parallel import retrieval

    rng = np.random.default_rng(k)
    qv, qk, cv, ck = _sim_inputs(rng, 70, 30001, 512, 40, dup=16)
    qk[::8] = WILDCARD_KEY
    qk[1::9] = 10**6                     # no candidates
    ck[::11] = -1                        # padding rows never match
    codes, scales = getattr(retrieval, quantizer)(cv)
    args = [torch.from_numpy(a).to(dev) for a in (qv, qk, codes, ck)]
    kw = dict(corpus_scales=torch.from_numpy(scales).to(dev), int8_mxu=mxu)
    before = masked_sim_topk_quant.launches
    vals, idx = masked_sim_topk(*args, k, **kw)
    torch.cuda.synchronize()
    rv, ri = masked_sim_topk_reference(*args, k, **kw)
    assert masked_sim_topk_quant.launches == before + 1
    vals, idx, rv, ri = (t.cpu().numpy() for t in (vals, idx, rv, ri))
    empty = ri == SENTINEL_IDX
    assert (idx[empty] == SENTINEL_IDX).all() and (vals[empty] == np.float32(NEG_INF)).all()
    if variant == "dequant":
        # fp32 products: indices agree outside runs of values within 1e-6
        near = np.zeros_like(empty)
        close = np.abs(np.diff(rv, axis=1)) <= 1e-6
        near[:, 1:] |= close
        near[:, :-1] |= close
        assert (idx[~near] == ri[~near]).all()
        np.testing.assert_allclose(vals, rv, atol=1e-5)
    else:
        # exact integer sums rescaled in one order: identical
        np.testing.assert_array_equal(idx, ri)
        np.testing.assert_array_equal(vals, rv)


def test_masked_sim_topk_quant_rejects(dev):
    from tpualign_torch.ops.sim_topk import masked_sim_topk_quant

    q = torch.zeros(2, 24, device=dev)
    keys = torch.zeros(2, dtype=torch.int32, device=dev)
    ck = torch.zeros(5, dtype=torch.int32, device=dev)
    scales = torch.ones(5, device=dev)
    with pytest.raises(ValueError, match="multiple of 16"):
        masked_sim_topk_quant(q, keys, torch.zeros(5, 6, dtype=torch.uint8, device=dev), ck, 3,
                              scales, "int2")
    with pytest.raises(ValueError, match="k must be"):
        masked_sim_topk(q, keys, torch.zeros(5, 24, dtype=torch.int8, device=dev), ck, 129,
                        corpus_scales=scales)


@pytest.mark.parametrize("precision", ["int8", "int4", "int2"])
def test_refined_index_on_the_card_matches_the_plain_path(dev, precision):
    """RetrievalIndex(precision, refine=4) on the card: K3 first, then the
    host rescore, equal to the same index built on the CPU, where the plain
    version runs."""
    from tpualign_torch.ops.sim_topk import masked_sim_topk_quant
    from tpualign_torch.parallel import RetrievalIndex

    rng = np.random.default_rng(3)
    emb = rng.normal(size=(20000, 512)).astype(np.float32)
    emb /= np.linalg.norm(emb, axis=1, keepdims=True)
    manuals = [f"m{i % 7}" for i in range(20000)]
    pages = [i % 13 for i in range(20000)]
    q = emb[:37] + 0.1 * rng.normal(size=(37, 512)).astype(np.float32)
    card = RetrievalIndex(emb, manuals, pages, precision=precision, refine=4, device=dev)
    cpu = RetrievalIndex(emb, manuals, pages, precision=precision, refine=4, device="cpu")
    before = masked_sim_topk_quant.launches
    for kw in ({"query_manuals": manuals[:37], "query_pages": pages[:37]},
               {"global_search": True}):
        got = card.search(q, k=10, **kw)
        want = cpu.search(q, k=10, **kw)
        np.testing.assert_array_equal(got[1], want[1])
        np.testing.assert_array_equal(got[0], want[0])
    assert masked_sim_topk_quant.launches == before + 2


K4_VARIANTS = [("fp32", None, False), ("s8", "_quantize_rows", True),
               ("dequant", "_quantize_rows", False), ("int4", "_quantize_rows_int4", True),
               ("int2", "_quantize_rows_int2", True)]


def _k4_inputs(rng, q, d=512, n_lists=20, cap=200, spill=3, p=5, groups=4):
    """A packed layout (capacity not a multiple of the 64-row tile), unused
    slots, duplicated rows, padding queries, and a union with padding
    entries between the real blocks and the spill blocks."""
    rows = (n_lists + 1 + spill) * cap
    cv = rng.normal(size=(rows, d)).astype(np.float32)
    cv[rows - 16:] = cv[:16]
    cv /= np.linalg.norm(cv, axis=1, keepdims=True)
    ck = rng.integers(0, groups, rows).astype(np.int32)
    ck[::11] = -1
    ck[n_lists * cap:(n_lists + 1) * cap] = -1
    qv = rng.normal(size=(q, d)).astype(np.float32)
    qv /= np.linalg.norm(qv, axis=1, keepdims=True)
    qk = rng.integers(0, groups, q).astype(np.int32)
    qk[::8] = WILDCARD_KEY
    qk[1::9] = 10**6                     # no candidates
    probes = np.stack([rng.choice(n_lists, p, replace=False) for _ in range(q)]).astype(
        np.int32)
    if q > 2:
        qk[-1], probes[-1] = -2, n_lists     # a padding query
    real = np.unique(probes[probes != n_lists])
    uids = np.concatenate([real, [n_lists] * 3, n_lists + 1 + np.arange(spill)]).astype(
        np.int32)
    return qv, qk, probes, uids, cv, ck, (cap, n_lists)


@pytest.mark.parametrize("variant,quantizer,mxu", K4_VARIANTS)
@pytest.mark.parametrize("q,k", [(2, 10), (130, 40)])
def test_ivf_probe_topk_matches_plain(dev, variant, quantizer, mxu, q, k):
    from tpualign_torch.ops.ivf_topk import ivf_probe_topk, ivf_probe_topk_reference
    from tpualign_torch.parallel import retrieval

    rng = np.random.default_rng(q + k)
    qv, qk, probes, uids, cv, ck, (cap, n_lists) = _k4_inputs(rng, q)
    scales = None
    if quantizer is not None:
        cv, scales = getattr(retrieval, quantizer)(cv)
        scales = torch.from_numpy(scales).to(dev)
    args = [torch.from_numpy(a).to(dev) for a in (qv, qk, probes, uids, cv, ck)]
    kw = dict(packed_scales=scales, int8_mxu=mxu)
    before = ivf_probe_topk.launches
    vals, idx = ivf_probe_topk(*args, k, cap, n_lists, **kw)
    torch.cuda.synchronize()
    rv, ri = ivf_probe_topk_reference(*args, k, cap, n_lists, **kw)
    assert ivf_probe_topk.launches == before + 1
    vals, idx, rv, ri = (t.cpu().numpy() for t in (vals, idx, rv, ri))
    empty = ri == SENTINEL_IDX
    assert (idx[empty] == SENTINEL_IDX).all() and (vals[empty] == np.float32(NEG_INF)).all()
    assert not empty.all()
    if variant in ("fp32", "dequant"):
        near = np.zeros_like(empty)
        close = np.abs(np.diff(rv, axis=1)) <= 1e-6
        near[:, 1:] |= close
        near[:, :-1] |= close
        assert (idx[~near] == ri[~near]).all()
        np.testing.assert_allclose(vals, rv, atol=1e-5)
    else:
        np.testing.assert_array_equal(idx, ri)
        np.testing.assert_array_equal(vals, rv)


@pytest.mark.parametrize("precision", ["fp32", "int8", "int4", "int2"])
def test_ivf_index_on_the_card_matches_the_cpu(dev, precision, tmp_path):
    """One artifact, loaded on the card and on the CPU: probed searches
    (K4, then refine for the quantized rungs) return the same corpus ids."""
    from tpualign_torch.ops.ivf_topk import ivf_probe_topk
    from tpualign_torch.parallel.ivf import IVFIndex

    rng = np.random.default_rng(5)
    centers = rng.normal(size=(64, 512)).astype(np.float32)
    emb = centers[rng.integers(0, 64, 20000)] + rng.normal(size=(20000, 512)).astype(np.float32)
    emb /= np.linalg.norm(emb, axis=1, keepdims=True)
    manuals = [f"m{i % 7}" for i in range(20000)]
    pages = [i % 13 for i in range(20000)]
    refine = 0 if precision == "fp32" else 4
    IVFIndex(emb, manuals, pages, n_lists=64, iters=4, precision=precision,
             device=dev).save(tmp_path / "a.npz")
    card = IVFIndex.load(tmp_path / "a.npz", emb, refine=refine, device=dev)
    cpu = IVFIndex.load(tmp_path / "a.npz", emb, refine=refine, device="cpu")
    q = emb[:37] + 0.1 * rng.normal(size=(37, 512)).astype(np.float32)
    before = ivf_probe_topk.launches
    for kw in ({"query_manuals": manuals[:37], "query_pages": pages[:37]},
               {"global_search": True}):
        got = card.search(q, k=10, n_probes=8, **kw)
        want = cpu.search(q, k=10, n_probes=8, **kw)
        np.testing.assert_array_equal(got[1], want[1])
        np.testing.assert_allclose(got[0], want[0], atol=1e-5 if precision == "fp32" else 0)
    assert ivf_probe_topk.launches == before + 2
