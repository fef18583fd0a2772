"""The port's CUDA kernels (K1, K2, K3, K4, K5) against their plain PyTorch
versions, on the card, and the device image feed on the card against the
CPU.

Marked ``cuda``: every test skips where there is no CUDA device (decided in
a fixture, never at import). On a machine with an H100 run

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_cuda.py

(``--noconftest``: the repo's conftest imports JAX, which these tests do
not need). This file imports neither JAX nor ``tpualign``; the bf16
tower case reads tpualign's embeddings from a fixture.
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


def _mha_case(dev, b, t, heads, hd, dtype, causal):
    rng = np.random.default_rng(1000 * t + 10 * hd + b)
    qkv = torch.from_numpy(rng.normal(size=(b, t, 3 * heads * hd)).astype(np.float32))
    qkv = qkv.to(dev, dtype)
    mask = causal_mask(t, dev) if causal else None
    before = fused_mha.launches
    got = fused_mha(qkv, heads, mask)
    torch.cuda.synchronize()
    want = fused_mha_reference(qkv, heads, mask)
    assert fused_mha.launches == before + 1
    assert got.dtype == dtype and got.shape == (b, t, heads * hd)
    # the bounds of test_fused_mha_matches_plain
    tol = 2e-5 if dtype == torch.float32 else 2e-2
    err = (got.float() - want.float()).abs().max().item()
    assert err <= tol, f"T={t} hd={hd} B={b} causal={causal}: max abs error {err:.3g} > {tol}"


# past T=128 the query tiles (64 rows) and the key chunks (32 keys) end
# at 192 and 256: one short of each edge, on it and one past it
LONG_EDGES = [191, 192, 193, 255, 256]


@pytest.mark.parametrize("hd", [64, 80, 88, 104])
@pytest.mark.parametrize("t", [1, 16, 50, 63, 64, 65, 77, 128, 129, 257] + LONG_EDGES)
def test_fused_mha_bf16_tensor_cores_match_plain(dev, t, hd):
    """The bf16 kernel (mma.sync) at T padded to 16 (one pass up to 128;
    past it 64-row query tiles, K and V through a ring of 32-row chunks,
    two passes) and hd padded to 16, causal and unmasked, B=1 and an odd
    B."""
    for b in (1, 3):
        for causal in (False, True):
            _mha_case(dev, b, t, 2, hd, torch.bfloat16, causal)


@pytest.mark.parametrize("hd", [64, 80, 88, 104])
@pytest.mark.parametrize("t", [1, 16, 50, 63, 64, 65, 77, 128, 129, 257] + LONG_EDGES)
def test_fused_mha_fp32_dispatch_matches_plain(dev, t, hd):
    """The fp32 kernel (CUDA cores, register tiles) at the bf16 test's grid:
    Q, K and V resident up to T=128 (64, 128 or 256 threads), 64-row query
    blocks with K and V streamed through a ring of 32-row chunks past it and
    where the resident layout would pass 227 KB (hd=104 at T=128); causal
    and unmasked, B=1 and an odd B."""
    for b in (1, 3):
        for causal in (False, True):
            _mha_case(dev, b, t, 2, hd, torch.float32, causal)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("t", [129, 200, 257])
def test_fused_mha_long_small_grid_matches_plain(dev, t, dtype):
    """Past T=128 with fewer (batch row, head) pairs than the card has SMs
    (B=2, H=3): every query tile a block, causal and unmasked, each head
    dim."""
    for hd in (64, 80, 88, 104):
        for causal in (False, True):
            _mha_case(dev, 2, t, 3, hd, dtype, causal)


@pytest.mark.parametrize("t", [16, 77, 257])
def test_fused_mha_fp32_unaligned_base(dev, t):
    """An fp32 ``qkv`` view 4 bytes past a 16-byte boundary takes the
    kernel's 4-byte copies, with the same result as an aligned copy."""
    heads, hd = 2, 64
    rng = np.random.default_rng(t)
    n = 3 * t * 3 * heads * hd
    flat = torch.from_numpy(rng.normal(size=n + 1).astype(np.float32)).to(dev)
    qkv = flat[1:].view(3, t, 3 * heads * hd)
    assert qkv.data_ptr() % 16 == 4
    mask = causal_mask(t, dev)
    got = fused_mha(qkv, heads, mask)
    torch.cuda.synchronize()
    want = fused_mha_reference(qkv, heads, mask)
    err = (got - want).abs().max().item()
    assert err <= 2e-5, f"T={t}: max abs error {err:.3g}"
    assert torch.equal(got, fused_mha(qkv.clone(), heads, mask))


@pytest.mark.parametrize("t", [50, 77, 200])
def test_fused_mha_fp32_random_additive_mask(dev, t):
    """An arbitrary finite additive (T, T) mask with -1e9 entries (no row
    fully masked), read once per score."""
    heads, hd = 4, 64
    rng = np.random.default_rng(7 * t)
    qkv = torch.from_numpy(rng.normal(size=(2, t, 3 * heads * hd)).astype(np.float32)).to(dev)
    m = rng.normal(scale=3.0, size=(t, t)).astype(np.float32)
    m[rng.random((t, t)) < 0.3] = -1e9
    m[np.arange(t), rng.integers(0, t, t)] = 0.5  # one key left open in every row
    mask = torch.from_numpy(m).to(dev)
    got = fused_mha(qkv, heads, mask)
    torch.cuda.synchronize()
    want = fused_mha_reference(qkv, heads, mask)
    assert bool(torch.isfinite(got).all())
    err = (got - want).abs().max().item()
    assert err <= 2e-5, f"T={t}: max abs error {err:.3g}"


def test_fused_mha_fp32_empty_batch(dev):
    """B=0 launches nothing and returns the empty context."""
    qkv = torch.zeros(0, 77, 3 * 512, device=dev)
    before = fused_mha.launches
    out = fused_mha(qkv, 8, causal_mask(77, dev))
    assert out.shape == (0, 77, 512) and out.dtype == torch.float32
    assert fused_mha.launches == before


def test_fused_mha_bf16_rejects_unaligned(dev):
    flat = torch.zeros(1 + 4 * 3 * 64, dtype=torch.bfloat16, device=dev)
    with pytest.raises(ValueError, match="16-byte"):
        fused_mha(flat[1:].view(1, 4, 3 * 64), 1)


def test_fused_mha_rejects(dev):
    qkv = torch.zeros(1, 4, 3 * 2 * 32, device=dev)
    with pytest.raises(ValueError, match="head dim"):
        fused_mha(qkv, 2)
    with pytest.raises(ValueError, match="sequence length"):
        fused_mha(torch.zeros(1, 300, 3 * 64, device=dev), 1)
    # under autograd it trains (the backward recomputes the plain path) and
    # still rejects what the kernel does not take
    assert fused_mha(torch.zeros(1, 4, 3 * 64, device=dev, requires_grad=True), 1).requires_grad
    with pytest.raises(ValueError, match="head dim"):
        fused_mha(torch.zeros(1, 4, 3 * 2 * 32, device=dev, requires_grad=True), 2)


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


def _check_against_plain(vals, idx, rv, ri):
    """Empty slots exact; indices equal outside runs of the plain version's
    values within 1e-6 of a neighbour; values within 1e-5 (the bounds of
    test_masked_sim_topk_matches_plain)."""
    vals, idx, rv, ri = (t.cpu().numpy() for t in (vals, idx, rv, ri))
    empty = ri == SENTINEL_IDX
    assert (idx[empty] == SENTINEL_IDX).all() and (vals[empty] == np.float32(NEG_INF)).all()
    near = np.zeros_like(empty)
    close = np.abs(np.diff(rv, axis=1)) <= 1e-6
    near[:, 1:] |= close
    near[:, :-1] |= close
    assert (idx[~near] == ri[~near]).all()
    np.testing.assert_allclose(vals, rv, atol=1e-5)


@pytest.mark.parametrize("k", [1, 10, 100, 128])
def test_masked_sim_topk_key_skip_is_exact(dev, k):
    """A corpus whose rows lie together by key (N not a multiple of the
    128-row tile) and keyed queries in no order, 70 of them (more than a
    64-query tile) with a key no row has, and some wildcards: the kernel
    skips most corpus tiles. It must return what it returns for the same
    rows in a random order, where no tile can be skipped (the same values
    bit for bit, the same rows), and match the plain version."""
    rng = np.random.default_rng(k)
    n, d, pages = 20_037, 512, 400
    qv, _, cv, _ = _sim_inputs(rng, 300, n, d, 1)
    ck = np.sort(rng.integers(0, pages, n)).astype(np.int32)
    ck[::13] = -1                        # padding rows never match
    qk = rng.integers(0, pages, 300).astype(np.int32)
    qk[rng.choice(300, 70, replace=False)] = pages + 5   # admit nothing
    qk[::37] = WILDCARD_KEY
    nothing = qk == pages + 5
    perm = rng.permutation(n)
    grouped = [torch.from_numpy(a).to(dev) for a in (qv, qk, cv, ck)]
    shuffled = [torch.from_numpy(a).to(dev) for a in (qv, qk, cv[perm], ck[perm])]
    before = masked_sim_topk.launches
    vals, idx = masked_sim_topk(*grouped, k)
    svals, sidx = masked_sim_topk(*shuffled, k)
    torch.cuda.synchronize()
    assert masked_sim_topk.launches == before + 2
    _check_against_plain(vals, idx, *masked_sim_topk_reference(*grouped, k))
    _check_against_plain(svals, sidx, *masked_sim_topk_reference(*shuffled, k))
    vals, idx, svals, sidx = (t.cpu().numpy() for t in (vals, idx, svals, sidx))
    np.testing.assert_array_equal(svals, vals)
    mapped = np.where(sidx == SENTINEL_IDX, SENTINEL_IDX, perm[np.minimum(sidx, n - 1)])
    np.testing.assert_array_equal(mapped, idx)
    assert (idx[nothing] == SENTINEL_IDX).all() and (idx[~nothing, 0] != SENTINEL_IDX).all()


@pytest.mark.parametrize("k", [10, 128])
def test_masked_sim_topk_all_wildcard(dev, k):
    """A global search: every query a wildcard, every tile scored."""
    rng = np.random.default_rng(7 + k)
    qv, qk, cv, ck = _sim_inputs(rng, 130, 5_000, 512, 3, dup=16)
    qk[:] = WILDCARD_KEY
    args = [torch.from_numpy(a).to(dev) for a in (qv, qk, cv, ck)]
    vals, idx = masked_sim_topk(*args, k)
    torch.cuda.synchronize()
    _check_against_plain(vals, idx, *masked_sim_topk_reference(*args, k))


def test_quantize_queries_on_the_card_matches_the_cpu(dev):
    """The card's per-row query scales and codes equal the CPU's bit for
    bit, on rows whose max|q| / 127 rounds otherwise as a product with
    fl(1/127), which is how CUDA torch divides by a Python scalar."""
    from tpualign_torch.ops.sim_topk import quantize_queries

    rng = np.random.default_rng(29)
    q = rng.normal(size=(4096, 512)).astype(np.float32)
    top = np.abs(q).max(axis=1)
    differs = top / np.float32(127.0) != top * (np.float32(1.0) / np.float32(127.0))
    assert differs.sum() >= 100
    q = q[differs]
    qq, qs = quantize_queries(torch.from_numpy(q).to(dev))
    want_qq, want_qs = quantize_queries(torch.from_numpy(q))
    assert torch.equal(qs.cpu(), want_qs)
    assert torch.equal(qq.cpu(), want_qq)


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


@pytest.mark.parametrize("shape,offset", [
    ((256, 224, 224, 3), 0),   # the main path's batch
    ((3, 7, 5, 3), 0),         # 315 elements: a tail of 11
    ((2, 31, 17, 3), 1),       # a view one byte past an aligned base
    ((1, 4, 4, 3), 5),         # unaligned and shorter than one group
])
def test_normalize_u8_matches_plain(dev, shape, offset):
    from tpualign_torch.ops.normalize import normalize_u8, normalize_u8_reference

    n = int(np.prod(shape))
    flat = torch.from_numpy(np.random.default_rng(n).integers(0, 256, n + offset,
                                                              dtype=np.uint8)).to(dev)
    x = flat[offset:].view(shape)
    assert (x.data_ptr() % 16 != 0) == (offset % 16 != 0)
    before = normalize_u8.launches
    got = normalize_u8(x)
    torch.cuda.synchronize()
    assert normalize_u8.launches == before + 1
    assert got.dtype == torch.float32 and got.shape == shape
    # bit-identical: three separately rounded fp32 operations on both sides
    assert torch.equal(got, normalize_u8_reference(x))
    assert torch.equal(got.cpu(), normalize_u8_reference(x.cpu()))


def test_normalize_u8_rejects(dev):
    from tpualign_torch.ops.normalize import normalize_u8

    with pytest.raises(ValueError, match="contiguous"):
        normalize_u8(torch.zeros(2, 4, 4, 3, dtype=torch.uint8, device=dev).transpose(1, 2))
    with pytest.raises(TypeError, match="uint8"):
        normalize_u8(torch.zeros(2, 4, 4, 3, device=dev))


@pytest.mark.parametrize("method,boxes", [("bicubic", False), ("bicubic", True),
                                          ("bilinear", False)])
def test_preprocess_device_on_the_card_matches_the_cpu(dev, method, boxes):
    """The card's device feed against the port's CPU path, with TF32 on
    globally (the resize must not take it): the parity bounds in raw [0, 1]
    units (two uint8 steps at most, 1e-4 of pixels more than one, mean
    1e-4), 1e-5 for bilinear; K5 launched once for a bicubic batch."""
    from tpualign_torch.ops import preprocess as pp
    from tpualign_torch.ops.normalize import normalize_u8

    rng = np.random.default_rng(17)
    sizes = [(120, 180), (300, 200), (640, 480), (224, 224), (150, 640), (47, 251), (96, 96),
             (256, 255)]
    bufs, hws = zip(*(pp.pad_to_bucket(rng.integers(0, 256, (h, w, 3), dtype=np.uint8), 256)
                      for h, w in sizes))
    u8, hw = np.stack(bufs), np.asarray(hws, np.int32)
    kw = {"method": method}
    if boxes:
        b, f = pp.sample_crop_boxes(np.random.default_rng(3), hw)
        kw.update(crop_boxes=torch.from_numpy(b), flip=torch.from_numpy(f))
    want = pp.preprocess_device(torch.from_numpy(u8), torch.from_numpy(hw), 224, **kw).numpy()
    prev = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = True
    try:
        before = normalize_u8.launches
        got = pp.preprocess_device(torch.from_numpy(u8).to(dev), torch.from_numpy(hw).to(dev),
                                   224, **kw)
        torch.cuda.synchronize()
        assert torch.backends.cuda.matmul.allow_tf32
        assert normalize_u8.launches == before + (method == "bicubic")
    finally:
        torch.backends.cuda.matmul.allow_tf32 = prev
    got = got.cpu().numpy()
    if method == "bilinear":
        np.testing.assert_allclose(got, want, atol=1e-5, rtol=0)
        return
    draw = np.abs(got - want) * np.asarray(pp.CLIP_STD)
    assert draw.max() <= 2.01 / 255.0, draw.max() * 255
    assert np.mean(draw * 255 > 1.01) <= 1e-4
    assert draw.mean() <= 1e-4, draw.mean()


def _first_positional_difference(a, b, got, want) -> str:
    """The first (image, chunk) pair whose card and CPU scores differ: its
    boxes, both scores (and their bits) and the branch the pair takes."""
    i, j = [int(x) for x in torch.nonzero(got != want)[0]]
    ba, bb = a[i], b[j]
    inside = (min(ba[2], bb[2]) > max(ba[0], bb[0])) and (min(ba[3], bb[3]) > max(ba[1], bb[1]))
    bits = [int(np.float32(t[i, j]).view(np.int32)) for t in (got, want)]
    return (f"{int((got != want).sum())} pairs differ; first ({i}, {j}): image box "
            f"{ba.tolist()}, chunk box {bb.tolist()}, card {float(got[i, j])!r} "
            f"(bits {bits[0]}), CPU {float(want[i, j])!r} (bits {bits[1]}), branch "
            f"{'IoU' if inside else 'distance'}")


def test_weak_supervision_on_the_card_matches_the_cpu(dev):
    """Positional grids on the card equal the CPU's bit for bit (divisors
    go in as tensors: CUDA multiplies by a Python scalar's reciprocal), so
    ``compute_alignments`` writes the same records on either device."""
    from tpualign_torch.weaksup import compute_alignments, positional_scores

    rng = np.random.default_rng(23)

    def boxes(n):
        x0, y0 = rng.integers(0, 500, n), rng.integers(0, 700, n)
        b = np.stack([x0, y0, x0 + rng.integers(0, 300, n), y0 + rng.integers(0, 200, n)], 1)
        return b.astype(np.float32)

    a, b = boxes(300), boxes(700)
    got = positional_scores(torch.from_numpy(a).to(dev), b)
    assert got.device.type == "cuda"
    want = positional_scores(a, b)
    assert torch.equal(got.cpu(), want), _first_positional_difference(a, b, got.cpu(), want)
    images = [{"image_id": f"i{i}", "manual_id": f"m{i % 5}", "page": i % 7,
               "bbox": a[i].tolist()} for i in range(300)]
    chunks = [{"chunk_id": f"c{j}", "manual_id": f"m{j % 5}", "page": j % 7,
               "bbox": b[j].tolist(), "text": "filter pomp" if j % 3 else "bout"}
              for j in range(700)]
    for flags in ((False, True), (True, True)):
        assert (compute_alignments(images, chunks, ["filter", "bout"], *flags, device=dev)
                == compute_alignments(images, chunks, ["filter", "bout"], *flags, device="cpu"))


# -- K3 and K4 with the tile skip and the tensor-core product -----------------

BATCHES = [1, 2, 16, 17, 64, 1024]   # one 16-query block, two 64-query blocks, ...


def _paged_inputs(rng, q, n, d, rows_per_page=8):
    """A page-ordered corpus (a page's rows together, as the store keeps
    chunks) with unused rows, and a batch that mixes queries keyed to a
    page, wildcards, queries without candidates and padding (-2) rows."""
    cv = rng.normal(size=(n, d)).astype(np.float32)
    cv /= np.linalg.norm(cv, axis=1, keepdims=True)
    ck = (np.arange(n) // rows_per_page).astype(np.int32)
    ck[5::13] = -1
    qk = rng.integers(0, n // rows_per_page, q).astype(np.int32)
    qv = cv[qk * rows_per_page] + 0.3 * rng.normal(size=(q, d)).astype(np.float32)
    qv /= np.linalg.norm(qv, axis=1, keepdims=True)
    qk[::7] = WILDCARD_KEY
    qk[3::11] = 10**6
    qk[5::13] = -2
    return qv, qk, cv, ck


def _assert_same_topk(vals, idx, rv, ri, exact, what=""):
    vals, idx, rv, ri = (t.cpu().numpy() for t in (vals, idx, rv, ri))
    empty = ri == SENTINEL_IDX
    assert (idx[empty] == SENTINEL_IDX).all() and (vals[empty] == np.float32(NEG_INF)).all(), what
    if exact:
        np.testing.assert_array_equal(idx, ri, err_msg=what)
        np.testing.assert_array_equal(vals, rv, err_msg=what)
    else:
        near = np.zeros_like(empty)
        close = np.abs(np.diff(rv, axis=1)) <= 1e-6
        near[:, 1:] |= close
        near[:, :-1] |= close
        assert (idx[~near] == ri[~near]).all(), what
        np.testing.assert_allclose(vals, rv, atol=1e-5, err_msg=what)


def _k3_case(dev, variant, quantizer, mxu, qv, qk, cv, ck, k):
    from tpualign_torch.ops.sim_topk import masked_sim_topk_quant
    from tpualign_torch.parallel import retrieval

    codes, scales = getattr(retrieval, quantizer)(cv)
    args = [torch.from_numpy(a).to(dev) for a in (qv, qk, codes, ck)]
    kw = dict(corpus_scales=torch.from_numpy(scales).to(dev), int8_mxu=mxu)
    before = masked_sim_topk_quant.launches
    vals, idx = masked_sim_topk(*args, k, **kw)
    torch.cuda.synchronize()
    assert masked_sim_topk_quant.launches == before + 1
    rv, ri = masked_sim_topk_reference(*args, k, **kw)
    _assert_same_topk(vals, idx, rv, ri, variant != "dequant", f"K3 {variant} Q={len(qv)}")
    return vals, idx


@pytest.mark.parametrize("q", BATCHES)
@pytest.mark.parametrize("variant,quantizer,mxu", K3_VARIANTS)
def test_k3_every_variant_and_batch_matches_plain(dev, variant, quantizer, mxu, q):
    """K3 over a page-ordered corpus (most tiles skipped by the keyed
    queries), every variant, batches of one 16-query block up to sixteen
    64-query blocks."""
    qv, qk, cv, ck = _paged_inputs(np.random.default_rng(q), q, 30000, 512)
    _k3_case(dev, variant, quantizer, mxu, qv, qk, cv, ck, 40)


@pytest.mark.parametrize("variant,quantizer,mxu", K3_VARIANTS)
def test_k3_shuffled_corpus_gives_the_same_answers(dev, variant, quantizer, mxu):
    """The skip is exact in any row order: a shuffled corpus admits other
    tiles, and every answer still equals the plain version's, with the
    same values as the page-ordered corpus."""
    rng = np.random.default_rng(77)
    qv, qk, cv, ck = _paged_inputs(rng, 70, 20000, 512)
    perm = rng.permutation(len(cv))
    vals, _ = _k3_case(dev, variant, quantizer, mxu, qv, qk, cv, ck, 10)
    svals, sidx = _k3_case(dev, variant, quantizer, mxu, qv, qk, cv[perm], ck[perm], 10)
    assert torch.equal(vals, svals)


@pytest.mark.parametrize("variant,quantizer,mxu,d", [
    ("s8", "_quantize_rows", True, 4), ("s8", "_quantize_rows", True, 20),
    ("int4", "_quantize_rows_int4", True, 8), ("int2", "_quantize_rows_int2", True, 16),
    ("dequant", "_quantize_rows", False, 3)])
@pytest.mark.parametrize("q", [5, 70])
def test_k3_smallest_depth(dev, variant, quantizer, mxu, d, q):
    """D at the smallest multiple each variant takes (and an s8 D that is
    no multiple of 16, loaded without 16-byte copies)."""
    qv, qk, cv, ck = _paged_inputs(np.random.default_rng(d + q), q, 3000, d)
    _k3_case(dev, variant, quantizer, mxu, qv, qk, cv, ck, 7)


def _k4_paged(rng, q, d=512, n_lists=20, cap=200):
    """_k4_inputs with page-ordered keys inside the blocks: keyed queries
    admit few of the union's tiles."""
    qv, qk, probes, uids, cv, ck, geom = _k4_inputs(rng, q, d=d, n_lists=n_lists, cap=cap)
    ck = np.where(ck >= 0, np.arange(len(ck)) // 8, -1).astype(np.int32)
    keyed = qk >= 0
    keyed &= qk != 10**6
    qk[keyed] = rng.integers(0, len(ck) // 8, int(keyed.sum()))
    return qv, qk, probes, uids, cv, ck, geom


def _k4_case(dev, variant, quantizer, mxu, inputs, k):
    from tpualign_torch.ops.ivf_topk import ivf_probe_topk, ivf_probe_topk_reference
    from tpualign_torch.parallel import retrieval

    qv, qk, probes, uids, cv, ck, (cap, n_lists) = inputs
    scales = None
    if quantizer is not None:
        cv, scales = getattr(retrieval, quantizer)(cv)
        scales = torch.from_numpy(scales).to(dev)
    args = [torch.from_numpy(a).to(dev) for a in (qv, qk, probes, uids, cv, ck)]
    kw = dict(packed_scales=scales, int8_mxu=mxu)
    before = ivf_probe_topk.launches
    vals, idx = ivf_probe_topk(*args, k, cap, n_lists, **kw)
    torch.cuda.synchronize()
    assert ivf_probe_topk.launches == before + 1
    rv, ri = ivf_probe_topk_reference(*args, k, cap, n_lists, **kw)
    _assert_same_topk(vals, idx, rv, ri, variant not in ("fp32", "dequant"),
                      f"K4 {variant} Q={len(qv)}")
    return vals, idx


@pytest.mark.parametrize("q", BATCHES)
@pytest.mark.parametrize("variant,quantizer,mxu", K4_VARIANTS)
def test_k4_every_variant_and_batch_matches_plain(dev, variant, quantizer, mxu, q):
    """K4 over a layout with page-ordered keys, probes, spill and padding
    blocks (capacity not a multiple of the tile), every variant and batch."""
    _k4_case(dev, variant, quantizer, mxu, _k4_paged(np.random.default_rng(q), q), 40)


@pytest.mark.parametrize("variant,quantizer,mxu", K4_VARIANTS)
def test_k4_rows_shuffled_within_blocks_give_the_same_answers(dev, variant, quantizer, mxu):
    rng = np.random.default_rng(78)
    qv, qk, probes, uids, cv, ck, (cap, n_lists) = _k4_paged(rng, 70)
    perm = np.concatenate([b * cap + rng.permutation(cap) for b in range(len(cv) // cap)])
    vals, _ = _k4_case(dev, variant, quantizer, mxu,
                       (qv, qk, probes, uids, cv, ck, (cap, n_lists)), 10)
    svals, _ = _k4_case(dev, variant, quantizer, mxu,
                        (qv, qk, probes, uids, cv[perm], ck[perm], (cap, n_lists)), 10)
    assert torch.equal(vals, svals)


@pytest.mark.parametrize("variant,quantizer,mxu,d", [
    ("s8", "_quantize_rows", True, 4), ("int4", "_quantize_rows_int4", True, 8),
    ("int2", "_quantize_rows_int2", True, 16), ("dequant", "_quantize_rows", False, 3),
    ("fp32", None, False, 3)])
def test_k4_smallest_depth(dev, variant, quantizer, mxu, d):
    _k4_case(dev, variant, quantizer, mxu, _k4_paged(np.random.default_rng(d), 37, d=d), 7)


# -- the port's bf16 towers against tpualign's bf16 ---------------------------


def test_bf16_towers_against_tpualign_bf16(dev):
    """ViT-B-32 from one seeded parameter tree: the port's bf16 towers on
    the card against tpualign's bf16 towers on JAX's CPU backend, whose
    embeddings tests/test_torch_bf16_parity.py wrote to its fixture (this
    machine has no flax). The two round to bf16 at other places and sum in
    other orders; the test prints the largest absolute and cosine gaps and
    holds the cosine of every embedding pair to 0.99 (different inputs
    reach 0.82-0.89 in the fixture)."""
    import json

    from test_torch_bf16_parity import FIXTURE, parity_inputs, seeded_tree
    from tpualign_torch import config as torch_config
    from tpualign_torch.models import CLIP, from_jax_params

    port = CLIP(torch_config.CLIP_VARIANTS["ViT-B-32"], True, torch.bfloat16, True)
    port = from_jax_params(port, seeded_tree(port)).to(dev).eval()
    images, tokens = parity_inputs()
    want = np.load(FIXTURE)
    np.testing.assert_array_equal(want["tokens"], tokens)
    gaps = {}
    with torch.inference_mode():
        for tower, x, enc in (("image", images, port.encode_image),
                              ("text", tokens, port.encode_text)):
            got = enc(torch.from_numpy(x).to(dev), normalize=True).float().cpu().numpy()
            ref = want[tower]
            cos = (got * ref).sum(1) / np.linalg.norm(got, axis=1) / np.linalg.norm(ref, axis=1)
            gaps[tower] = {"max_abs": float(np.abs(got - ref).max()),
                           "min_cosine": float(cos.min()), "rows": len(x)}
    print("bf16_parity " + json.dumps(gaps))
    for tower, gap in gaps.items():
        assert gap["min_cosine"] >= 0.99, f"{tower}: {gap}"


# -- the int8 towers and the live corpus on the card ----------------------------


@pytest.mark.parametrize("m", [1, 16, 17, 300])
def test_int8_dot_on_the_card_matches_the_cpu(dev, m):
    """torch._int_mm (rows padded past 16) against the CPU's int32 product:
    the same codes, the exact integer product, and the epilogue within an
    ulp (an FMA on the card, float64 rounded once on the CPU)."""
    from tpualign_torch.ops import quant

    rng = np.random.default_rng(m)
    x = torch.from_numpy((rng.normal(size=(m, 768)) * 3).astype(np.float32))
    w = torch.from_numpy((rng.normal(size=(768, 2304)) * 0.02).astype(np.float32))
    bias = torch.from_numpy(rng.normal(size=(2304,)).astype(np.float32))
    calls = quant.int8_dot.int_mm_calls
    got = quant.int8_dot(x.to(dev), w.to(dev), bias.to(dev)).cpu()
    assert quant.int8_dot.int_mm_calls == calls + 1
    want = quant.int8_dot(x, w, bias)
    ulps = (got.view(torch.int32).long() - want.view(torch.int32).long()).abs().max()
    assert int(ulps) <= 1
    card_q, card_s = quant._quantize_rows(x.to(dev))
    cpu_q, cpu_s = quant._quantize_rows(x)
    assert torch.equal(card_q.cpu(), cpu_q) and torch.equal(card_s.cpu(), cpu_s)
    wq, ws = quant.quantize_weight(w.to(dev))
    cq, cs = quant.quantize_weight(w)
    assert torch.equal(wq.cpu(), cq) and torch.equal(ws.cpu(), cs)
    assert torch.equal(quant._int_matmul(card_q, wq).cpu(), quant._int_matmul(cpu_q, cq))


@pytest.mark.parametrize("precision", ["fp32", "int8", "int4", "int2"])
def test_index_mutations_on_the_card_match_the_cpu(dev, precision):
    """Adds (through growth and into slack), tombstones and a compaction on
    the card give the CPU index's ids, and K2/K3/K4 over the mutated
    corpora give their plain versions' answers."""
    from tpualign_torch.parallel.ivf import IVFIndex
    from tpualign_torch.parallel.retrieval import RetrievalIndex

    rng = np.random.default_rng(3)
    rows = rng.normal(size=(6000, 64)).astype(np.float32)
    rows /= np.linalg.norm(rows, axis=1, keepdims=True)
    manuals = [f"m{i % 7}" for i in range(6000)]
    pages = [i % 11 for i in range(6000)]
    q = rows[::97][:40] + 0.05
    for cls, kw in ((RetrievalIndex, {"refine": 4}), (IVFIndex, {"n_lists": 16, "iters": 3})):
        kw = dict(kw, precision=precision)
        if precision == "fp32":
            kw.pop("refine", None)
        card = cls(rows[:4000], manuals[:4000], pages[:4000], device=dev, **kw)
        cpu = cls(rows[:4000], manuals[:4000], pages[:4000], device="cpu", **kw)
        steps = (lambda x: x.add(rows[4000:5500], manuals[4000:5500], pages[4000:5500]),
                 lambda x: x.remove(np.arange(0, 5500, 3)),
                 lambda x: x.add(rows[5500:], manuals[5500:], pages[5500:]),
                 lambda x: x.compact())
        for step in steps:
            got, want = step(card), step(cpu)
            if isinstance(got, np.ndarray):
                assert np.array_equal(got, want)
            search = (dict(n_probes=5) if cls is IVFIndex else {})
            for args in ((manuals[::97][:40], pages[::97][:40]), (None, None)):
                gv, gi = card.search(q, *args, k=10, global_search=args[0] is None, **search)
                wv, wi = cpu.search(q, *args, k=10, global_search=args[0] is None, **search)
                assert np.array_equal(gi, wi), (cls.__name__, precision)
                np.testing.assert_allclose(gv, wv, rtol=1e-5, atol=1e-5)


# -- training: K1 under autograd, the bf16 products' gradients, one step --------------


@pytest.mark.parametrize("t,d,heads,causal", [(50, 768, 12, False), (77, 512, 8, True),
                                              (25, 768, 12, False)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_fused_mha_backward_matches_plain_autograd(dev, t, d, heads, causal, dtype):
    """K1 forward, then the backward that recomputes the plain attention:
    its dqkv equals the plain version's autograd exactly (the same
    recompute on the same inputs and cotangent), one recompute counted;
    the forward within K1's bound."""
    gen = torch.Generator(device=dev).manual_seed(t)
    qkv = torch.randn(8, t, 3 * d, generator=gen, device=dev).to(dtype).requires_grad_()
    mask = causal_mask(t, dev) if causal else None
    launches, recomputes = fused_mha.launches, fused_mha.backward_recomputes
    out = fused_mha(qkv, heads, mask)
    g = torch.randn(out.shape, generator=gen, device=dev).to(dtype)
    (got,) = torch.autograd.grad(out, qkv, g)
    assert fused_mha.launches == launches + 1
    assert fused_mha.backward_recomputes == recomputes + 1
    ref = fused_mha_reference(qkv, heads, mask)
    (want,) = torch.autograd.grad(ref, qkv, g)
    assert got.dtype == dtype and torch.equal(got, want)
    tol = 2e-5 if dtype == torch.float32 else 2e-2
    assert (out.float() - ref.float()).abs().max().item() <= tol


@pytest.mark.parametrize("b_shape", [(768, 2304), (6, 50, 64, 50)])
def test_matmul_f32acc_gradients_on_the_card(dev, b_shape):
    """The bf16 product's transpose rule on the card against the fp32
    product of the widened operands: dA and dB within the bf16 rounding of
    the cotangent and of the result (2^-7 of the largest |value|)."""
    from tpualign_torch.ops.dense import matmul_f32acc

    gen = torch.Generator(device=dev).manual_seed(0)
    a_shape = (256, 50, 768) if len(b_shape) == 2 else (6, 50, 50, 64)
    a = torch.randn(a_shape, generator=gen, device=dev).bfloat16().requires_grad_()
    b = (torch.randn(b_shape, generator=gen, device=dev) * 0.05).bfloat16().requires_grad_()
    out = matmul_f32acc(a, b)
    assert out.dtype == torch.float32
    g = torch.randn(out.shape, generator=gen, device=dev)
    da, db = torch.autograd.grad(out, (a, b), g)
    assert da.dtype == db.dtype == torch.bfloat16
    a32, b32 = a.detach().float().requires_grad_(), b.detach().float().requires_grad_()
    wa, wb = torch.autograd.grad(torch.matmul(a32, b32), (a32, b32), g)
    for got, want in ((da, wa), (db, wb)):
        err = (got.float() - want).abs().max().item()
        assert err <= 2**-7 * want.abs().max().item(), err


def test_int8_qat_carries_gradients_on_the_card(dev):
    from tpualign_torch.ops.quant import int8_dot_qat

    gen = torch.Generator(device=dev).manual_seed(1)
    x = torch.randn(64, 128, generator=gen, device=dev).bfloat16().requires_grad_()
    w = torch.randn(128, 96, generator=gen, device=dev).requires_grad_()
    out = int8_dot_qat(x, w)
    gx, gw = torch.autograd.grad(out.float().sum(), (x, w))
    assert float(gx.float().abs().max()) > 0 and float(gw.abs().max()) > 0
    assert torch.isfinite(gx.float()).all() and torch.isfinite(gw).all()


def _small_clip(fused, dtype=torch.bfloat16):
    from tpualign_torch.config import ClipVariant
    from tpualign_torch.models.clip import CLIP, init_clip_params

    v = ClipVariant(name="small", embed_dim=64, image_size=32, patch_size=8, vision_width=128,
                    vision_layers=2, vision_heads=2, context_length=16, vocab_size=1000,
                    text_width=128, text_layers=2, text_heads=2)
    return init_clip_params(CLIP(v, True, dtype, fused), seed=0).to("cuda")


@pytest.mark.parametrize("accum", [1, 2])
def test_bf16_train_step_with_k1_matches_plain(dev, accum):
    """One bf16 step with K1 against the same step on the plain attention
    (head dim 64): loss and grad_norm within 1e-2 relative, every gradient
    leaf within 5e-2 of its largest |g| (bf16 towers: an ulp of a bf16
    activation is 2^-8 relative)."""
    from tpualign_torch.config import TrainConfig
    from tpualign_torch.train import step as S

    gen = np.random.default_rng(2)
    images = torch.from_numpy(gen.normal(size=(8, 32, 32, 3)).astype(np.float32)).to(dev)
    tokens = np.zeros((8, 16), np.int64)
    tokens[:, 0], tokens[:, 1], tokens[:, 2] = 998, gen.integers(1, 100, 8), 999
    tokens = torch.from_numpy(tokens).to(dev)
    weak = torch.from_numpy(gen.random(8).astype(np.float32)).to(dev)
    cfg = TrainConfig(learning_rate=1e-3, warmup_steps=0, total_steps=10,
                      grad_accum_steps=accum)
    out = {}
    for fused in (True, False):
        model = _small_clip(fused).requires_grad_(False)
        state = S.create_train_state(model, S.model_params(model), cfg)
        grads = {}
        real = state.apply_gradients

        def keep(g, n, real=real, grads=grads):
            grads.update({k: v.float().clone() for k, v in g.items()})
            return real(g, n)

        state.apply_gradients = keep
        before = fused_mha.launches
        state, m = S.train_step(state, model, images, tokens, weak, cfg)
        assert (fused_mha.launches > before) == fused
        out[fused] = (float(m["loss"]), float(m["grad_norm"]), grads)
    (l1, n1, g1), (l0, n0, g0) = out[True], out[False]
    assert abs(l1 - l0) <= 1e-2 * abs(l0) and abs(n1 - n0) <= 1e-2 * abs(n0)
    for k, want in g0.items():
        err = (g1[k] - want).abs().max().item()
        assert err <= 5e-2 * want.abs().max().item() + 1e-12, (k, err)


# -- more than one card: the per-card launch setup, and the mesh ------------------


@pytest.fixture
def cards():
    if not torch.cuda.is_available() or torch.cuda.device_count() < 2:
        pytest.skip("needs two or more CUDA cards (launches on a card other than card 0)")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.cuda.device_count()


# each kernel at a shape whose launch needs more than 48 KB of dynamic
# shared memory where the kernel takes it (K1 bf16 at T=257, K2, K3, K4)
MULTI_CARD = ["K1 bf16", "K1 fp32", "K2", "K3 s8", "K3 int4", "K4 fp32", "K4 s8", "K5"]


def _kernel_case(name: str, dev) -> None:
    """One launch of the kernel ``name`` on ``dev`` (a bare ``cuda`` is the
    current card), held against its plain version there."""
    from tpualign_torch.ops.normalize import normalize_u8, normalize_u8_reference

    rng = np.random.default_rng(len(name))
    if name == "K1 bf16":
        _mha_case(dev, 2, 257, 3, 88, torch.bfloat16, False)
    elif name == "K1 fp32":
        _mha_case(dev, 4, 77, 8, 64, torch.float32, True)
    elif name == "K2":
        qv, qk, cv, ck = _paged_inputs(rng, 70, 30000, 512)
        args = [torch.from_numpy(a).to(dev) for a in (qv, qk, cv, ck)]
        before = masked_sim_topk.launches
        vals, idx = masked_sim_topk(*args, 40)
        torch.cuda.synchronize()
        assert masked_sim_topk.launches == before + 1
        _check_against_plain(vals, idx, *masked_sim_topk_reference(*args, 40))
    elif name.startswith("K3"):
        variant, quantizer = (("s8", "_quantize_rows") if name.endswith("s8")
                              else ("int4", "_quantize_rows_int4"))
        _k3_case(dev, variant, quantizer, True, *_paged_inputs(rng, 70, 30000, 512), 40)
    elif name.startswith("K4"):
        variant, quantizer = ("fp32", None) if name.endswith("fp32") else ("s8", "_quantize_rows")
        _k4_case(dev, variant, quantizer, variant == "s8", _k4_paged(rng, 70), 40)
    else:
        x = torch.from_numpy(rng.integers(0, 256, (8, 224, 224, 3), dtype=np.uint8)).to(dev)
        before = normalize_u8.launches
        got = normalize_u8(x)
        torch.cuda.synchronize()
        assert normalize_u8.launches == before + 1
        assert torch.equal(got, normalize_u8_reference(x))


@pytest.mark.parametrize("name", MULTI_CARD)
def test_kernels_on_a_bare_cuda_device_while_another_card_is_current(cards, name):
    """``torch.device("cuda")`` while the last card is current: the kernel
    launches there (not on card 0) and leaves that card current."""
    last = cards - 1
    with torch.cuda.device(last):
        _kernel_case(name, torch.device("cuda"))
        assert torch.cuda.current_device() == last


@pytest.mark.parametrize("name", MULTI_CARD)
def test_kernels_on_the_last_card_after_the_first(cards, name):
    """A launch on card 0, then on the last card in the same process: the
    shared-memory limit is set on each card (it applies to the current
    card only), and card 0 stays current."""
    torch.cuda.set_device(0)
    _kernel_case(name, torch.device("cuda", 0))
    _kernel_case(name, torch.device("cuda", cards - 1))
    assert torch.cuda.current_device() == 0


def _mesh_checks(mesh) -> None:
    """The mesh phase of chip_smoke.py at a small size: the sharded index
    at every precision and strategy, keyed and wildcard, k=10 and k=100,
    against the one-device index on the first card (indices identical,
    values equal); add, remove and compact against fresh indexes; the
    data-parallel towers (K1 on every replica, K5 in the device feed)
    within 1e-5 of the one-device engine: the replicas run the same
    kernels on the same weights."""
    from tpualign_torch.config import ModelConfig
    from tpualign_torch.ops.attention import fused_mha
    from tpualign_torch.ops.normalize import normalize_u8
    from tpualign_torch.parallel import EmbedEngine, RetrievalIndex

    dev0 = mesh.data_devices[0]
    rng = np.random.default_rng(4)
    n, d = 20000, 512
    c = rng.normal(size=(n, d)).astype(np.float32)
    c /= np.linalg.norm(c, axis=1, keepdims=True)
    man = [f"m{i // 400}" for i in range(n)]
    page = [i // 8 % 50 for i in range(n)]
    pick = rng.integers(0, n, 64)
    q = c[pick] + 0.2 * rng.normal(size=(64, d)).astype(np.float32)
    qm, qp = [man[i] for i in pick], [page[i] for i in pick]
    for precision, strategies in (("fp32", ("gather", "ring", "streaming")),
                                  ("int8", ("gather", "streaming")),
                                  ("int4", ("gather", "streaming")),
                                  ("int2", ("gather", "streaming"))):
        one = RetrievalIndex(c, man, page, precision=precision, device=dev0)
        sharded = RetrievalIndex(c, man, page, precision=precision, mesh=mesh)
        assert [p.device for p in sharded._corpus.parts] == mesh.data_devices
        for k in (10, 100):
            for kw in (dict(query_manuals=qm, query_pages=qp), dict(global_search=True)):
                want = one.search(q, k=k, **kw)
                for strategy in strategies:
                    got = sharded.search(q, k=k, strategy=strategy, **kw)
                    np.testing.assert_array_equal(got[1], want[1], err_msg=precision)
                    np.testing.assert_array_equal(got[0], want[0], err_msg=precision)
    # mutations: an add past the capacity, a remove of a quarter, compact
    sharded = RetrievalIndex(c[:16000], man[:16000], page[:16000], precision="int8", mesh=mesh)
    sharded.add(c[16000:], man[16000:], page[16000:])
    gone = rng.choice(n, n // 4, replace=False)
    assert sharded.remove(gone) == n // 4
    live = sharded.compact()
    np.testing.assert_array_equal(live, np.setdiff1d(np.arange(n), gone))
    fresh = RetrievalIndex(c[live], [man[i] for i in live], [page[i] for i in live],
                           precision="int8", device=dev0)
    for kw in (dict(query_manuals=qm, query_pages=qp), dict(global_search=True)):
        got, want = sharded.search(q, k=10, **kw), fresh.search(q, k=10, **kw)
        np.testing.assert_array_equal(got[1], want[1])
        np.testing.assert_array_equal(got[0], want[0])
    # the towers, replicated
    one = EmbedEngine(ModelConfig("ViT-B-32"), batch_size=8, device=dev0, preprocess="device")
    sharded = EmbedEngine(ModelConfig("ViT-B-32"), batch_size=8, mesh=mesh, preprocess="device")
    images = rng.normal(size=(10, 224, 224, 3)).astype(np.float32)
    texts = ["replace the oil filter", "torque 25 Nm", "check the pump seal " * 5] * 3
    u8 = [rng.integers(0, 256, (256, 256, 3), dtype=np.uint8) for _ in range(8)]
    hws = np.asarray([[256, 256], [200, 180], [256, 120], [64, 256]] * 2, np.int32)
    before = (fused_mha.launches, normalize_u8.launches)
    got = (sharded.encode_image_batch(images), sharded.encode_text_batch(texts),
           sharded._encode_image_u8(u8, hws, None))
    torch.cuda.synchronize()
    launched = (fused_mha.launches - before[0], normalize_u8.launches - before[1])
    want = (one.encode_image_batch(images), one.encode_text_batch(texts),
            one._encode_image_u8(u8, hws, None))
    data = mesh.shape["data"]
    assert launched[1] == data and launched[0] >= data * 12
    for what, g, w in zip(("images", "texts", "device feed"), got, want):
        gap = np.abs(g - w).max()
        assert gap <= 1e-5, f"{what}: the replicas read {gap:.3g} from one device"


def test_mesh_of_one_card_matches_one_device(dev):
    from tpualign_torch.parallel import create_mesh

    _mesh_checks(create_mesh(4, devices=[torch.device("cuda", 0)] * 4))


def test_mesh_of_distinct_cards_matches_one_device(cards):
    from tpualign_torch.parallel import create_mesh

    _mesh_checks(create_mesh(min(cards, 4)))


# -- tensor parallel parts (the sharded towers) -------------------------------------


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("t,heads,hd,causal", [(50, 3, 64, False), (77, 2, 64, True),
                                               (257, 4, 80, False)])
def test_k1_on_a_tensor_parallel_part_of_card_1_while_card_0_is_current(cards, t, heads, hd,
                                                                        causal, dtype):
    """K1 on one card's part of a 4-way model axis (ViT-B-32 vision 12/4
    heads, text 8/4, ViT-H-14 vision 16/4 at head dim 80) on card 1 while
    card 0 is current, against its plain version; card 0 stays current."""
    torch.cuda.set_device(0)
    _mha_case(torch.device("cuda", 1), 8, t, heads, hd, dtype, causal)
    assert torch.cuda.current_device() == 0


def _sharded_step_checks(mesh) -> None:
    """One fp32 step of a small CLIP (K1 in every attention, 2 heads a
    tower split over the model axis) on ``mesh`` against the one-card step:
    loss within 1e-4 and grad_norm within 1e-3 relative (tests/test_train.py:116),
    K1 launched on every part of every block and recomputed as often."""
    from tpualign_torch.config import TrainConfig
    from tpualign_torch.train import step as S

    gen = np.random.default_rng(3)
    images = torch.from_numpy(gen.normal(size=(8, 32, 32, 3)).astype(np.float32)).to("cuda:0")
    tokens = np.zeros((8, 16), np.int64)
    tokens[:, 0], tokens[:, 1], tokens[:, 2] = 998, gen.integers(1, 100, 8), 999
    tokens = torch.from_numpy(tokens).to("cuda:0")
    weak = torch.from_numpy(gen.random(8).astype(np.float32)).to("cuda:0")
    model = _small_clip(True, torch.float32).requires_grad_(False)
    for fsdp in (False, True):
        cfg = TrainConfig(learning_rate=1e-3, warmup_steps=0, total_steps=10, fsdp=fsdp)
        one = S.create_train_state(model, S.model_params(model), cfg)
        _, m1 = S.train_step(one, model, images, tokens, weak, cfg)
        run, shard_state = S.make_sharded_train_step(model, mesh, cfg)
        state = shard_state(S.create_train_state(model, S.model_params(model), cfg))
        before = (fused_mha.launches, fused_mha.backward_recomputes)
        state, m2 = run(state, images, tokens, weak)
        torch.cuda.synchronize()
        parts = 4 * mesh.devices.size
        assert (fused_mha.launches - before[0], fused_mha.backward_recomputes - before[1]) == (
            parts, parts)
        assert abs(float(m2["loss"]) - float(m1["loss"])) <= 1e-4 * abs(float(m1["loss"]))
        assert abs(float(m2["grad_norm"]) - float(m1["grad_norm"])) <= 1e-3 * float(
            m1["grad_norm"])


def test_sharded_train_step_on_one_card_matches_one_card(dev):
    from tpualign_torch.parallel import create_mesh

    _sharded_step_checks(create_mesh(2, 2, devices=[torch.device("cuda", 0)] * 4))


def test_sharded_train_step_on_distinct_cards_matches_one_card(cards):
    from tpualign_torch.parallel import create_mesh

    _sharded_step_checks(create_mesh(2, 2) if cards >= 4 else create_mesh(1, 2))


# -- the sharded IVF index ---------------------------------------------------------


def _sharded_ivf_checks(mesh, tmp_path) -> None:
    """A sharded IVF artifact written on the CPU (a CPU mesh of as many
    shards), loaded onto ``mesh``: probed searches (K4 on every shard, each
    on its card) return the CPU's corpus ids, one launch a shard and
    search; a build on the cards at full probe equals the exact index on
    the first card; add, remove and compact at full probe equal a fresh
    sharded build over the live rows."""
    from tpualign_torch.ops.ivf_topk import ivf_probe_topk
    from tpualign_torch.parallel import RetrievalIndex, create_mesh
    from tpualign_torch.parallel.ivf import IVFIndex

    shards = mesh.shape["data"]
    rng = np.random.default_rng(6)
    centers = rng.normal(size=(64, 512)).astype(np.float32)
    emb = centers[rng.integers(0, 64, 20000)] + rng.normal(size=(20000, 512)).astype(np.float32)
    emb /= np.linalg.norm(emb, axis=1, keepdims=True)
    manuals, pages = [f"m{i % 7}" for i in range(20000)], [i % 13 for i in range(20000)]
    q = emb[:37] + 0.1 * rng.normal(size=(37, 512)).astype(np.float32)
    searches = ({"query_manuals": manuals[:37], "query_pages": pages[:37]},
                {"global_search": True})
    for precision in ("fp32", "int8"):
        IVFIndex(emb, manuals, pages, n_lists=64, iters=4, precision=precision,
                 mesh=create_mesh(shards, devices=["cpu"] * shards),
                 device="cpu").save(tmp_path / f"{precision}.npz")
        card = IVFIndex.load(tmp_path / f"{precision}.npz", emb, mesh=mesh)
        cpu = IVFIndex.load(tmp_path / f"{precision}.npz", emb,
                            mesh=create_mesh(shards, devices=["cpu"] * shards), device="cpu")
        assert [p.device for p in card._emb.parts] == mesh.data_devices
        before = ivf_probe_topk.launches
        for kw in searches:
            got, want = card.search(q, k=10, n_probes=3, **kw), cpu.search(q, k=10, n_probes=3,
                                                                          **kw)
            np.testing.assert_array_equal(got[1], want[1], err_msg=precision)
            np.testing.assert_allclose(got[0], want[0],
                                       atol=1e-5 if precision == "fp32" else 0)
        assert ivf_probe_topk.launches == before + 2 * shards
    built = IVFIndex(emb, manuals, pages, n_lists=64, iters=4, mesh=mesh)
    exact = RetrievalIndex(emb, manuals, pages, device=mesh.data_devices[0])
    for kw in searches:
        got = built.search(q, k=10, n_probes=built.n_lists_local, **kw)
        want = exact.search(q, k=10, **kw)
        np.testing.assert_array_equal(got[1], want[1])
        np.testing.assert_allclose(got[0], want[0], atol=1e-5)
    grown = IVFIndex(emb[:16000], manuals[:16000], pages[:16000], n_lists=64, iters=4,
                     precision="int8", mesh=mesh)
    grown.add(emb[16000:], manuals[16000:], pages[16000:])
    gone = rng.choice(20000, 5000, replace=False)
    assert grown.remove(gone) == 5000
    live = grown.compact()
    np.testing.assert_array_equal(live, np.setdiff1d(np.arange(20000), gone))
    fresh = IVFIndex(emb[live], [manuals[i] for i in live], [pages[i] for i in live],
                     n_lists=64, iters=4, precision="int8", mesh=mesh)
    for kw in searches:
        # the union route's cuBLAS product over another layout: an ulp apart
        got = grown.search(q, k=10, n_probes=grown.n_lists_local, **kw)
        want = fresh.search(q, k=10, n_probes=fresh.n_lists_local, **kw)
        np.testing.assert_array_equal(got[1], want[1])
        np.testing.assert_allclose(got[0], want[0], atol=1e-6)


def test_sharded_ivf_on_one_card_matches_the_cpu(dev, tmp_path):
    from tpualign_torch.parallel import create_mesh

    _sharded_ivf_checks(create_mesh(4, devices=[torch.device("cuda", 0)] * 4), tmp_path)


def test_sharded_ivf_on_two_cards_matches_the_cpu(cards, tmp_path):
    from tpualign_torch.parallel import create_mesh

    _sharded_ivf_checks(create_mesh(2), tmp_path)


@pytest.mark.parametrize("variant,quantizer", [("fp32", None), ("s8", "_quantize_rows")])
def test_k4_on_card_1_while_card_0_is_current(cards, variant, quantizer):
    """One K4 launch on card 1 while card 0 is current (a sharded IVF
    index's second shard), against its plain version; card 0 stays
    current."""
    torch.cuda.set_device(0)
    _k4_case(torch.device("cuda", 1), variant, quantizer, variant == "s8",
             _k4_paged(np.random.default_rng(11), 70), 40)
    assert torch.cuda.current_device() == 0
