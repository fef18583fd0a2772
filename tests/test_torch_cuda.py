"""The port's CUDA kernels against their plain PyTorch versions, on the card.

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
