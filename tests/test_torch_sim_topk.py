"""tpualign_torch's masked_sim_topk (CPU: its plain version) against the
JAX package's masked_sim_topk (Pallas, interpret mode) and the numpy oracle
of tests/test_pallas.py: ties, wildcard, no candidates, sentinels, k up to
128."""

import numpy as np
import pytest

import jax.numpy as jnp
import torch

from tests.test_pallas import make, oracle
from tpualign.ops.pallas_kernels import SENTINEL_IDX as JAX_SENTINEL
from tpualign.ops.pallas_kernels import masked_sim_topk as jax_sim_topk
from tpualign.ops.similarity import NEG_INF as JAX_NEG_INF
from tpualign.ops.similarity import WILDCARD_KEY as JAX_WILDCARD
from tpualign.ops.similarity import masked_topk as jax_masked_topk
from tpualign_torch.ops.sim_topk import (
    SENTINEL_IDX, group_by_key, key_mask, masked_sim_topk, ungroup_rows)
from tpualign_torch.ops.similarity import NEG_INF, WILDCARD_KEY, masked_topk

pytestmark = pytest.mark.fast


def _port(q, qk, c, ck, k):
    vals, idx = masked_sim_topk(*(torch.from_numpy(a) for a in (q, qk, c, ck)), k)
    assert vals.dtype == torch.float32 and idx.dtype == torch.int32
    return vals.numpy(), idx.numpy()


def _jax(q, qk, c, ck, k, bq=8, bn=128):
    vals, idx = jax_sim_topk(*(jnp.asarray(a) for a in (q, qk, c, ck)), k,
                             block_q=bq, block_n=bn)
    return np.asarray(vals), np.asarray(idx)


def test_constants_match_jax():
    assert (NEG_INF, WILDCARD_KEY, SENTINEL_IDX) == (JAX_NEG_INF, JAX_WILDCARD, JAX_SENTINEL)


@pytest.mark.parametrize("Q,N,D,k", [
    (23, 301, 64, 7),
    (64, 512, 128, 10),
    (3, 17, 32, 5),        # k near N, heavy padding on the JAX side
    (12, 257, 16, 100),    # the Evaluator's window
    (5, 300, 16, 128),     # the kernel's bound
])
def test_matches_jax_kernel_and_oracle(Q, N, D, k):
    rng = np.random.default_rng(Q * N + k)
    q, qk, c, ck = make(rng, Q, N, D, 4)
    vals, idx = _port(q, qk, c, ck, k)
    jvals, jidx = _jax(q, qk, c, ck, k)
    ovals, oidx = oracle(q, qk, c, ck, k)
    has = oidx >= 0
    np.testing.assert_array_equal(idx[has], oidx[has])
    np.testing.assert_allclose(vals[has], ovals[has], atol=1e-6)
    # identical to the JAX kernel in every filled slot. Its empty slots
    # carry NEG_INF but, once its running list holds winners, a repeated
    # winner's index rather than SENTINEL_IDX; the port's are exact.
    jhas = jvals > NEG_INF / 2
    np.testing.assert_array_equal(jhas, has)
    np.testing.assert_array_equal(idx[has], jidx[has])
    np.testing.assert_allclose(vals, jvals, atol=1e-6)
    assert (idx[~has] == SENTINEL_IDX).all()
    assert (vals[~has] == np.float32(NEG_INF)).all()


def test_ties_rank_by_ascending_index():
    q = np.full((2, 8), 8 ** -0.5, np.float32)
    c = np.tile(q[:1], (40, 1))
    c[5] = -c[5]
    qk = np.zeros(2, np.int32)
    ck = np.zeros(40, np.int32)
    ck[7] = 1
    _, idx = _port(q, qk, c, ck, 10)
    _, jidx = _jax(q, qk, c, ck, 10)
    want = [0, 1, 2, 3, 4, 6, 8, 9, 10, 11]
    assert idx.tolist() == [want, want]
    np.testing.assert_array_equal(idx, jidx)


def test_wildcard_and_padding_keys():
    rng = np.random.default_rng(13)
    q, _, c, ck = make(rng, 9, 200, 32, 4)
    qk = np.full(9, WILDCARD_KEY, np.int32)
    qk[3] = -2          # query padding matches nothing
    ck[::7] = -1        # corpus padding never matches, not even a wildcard
    vals, idx = _port(q, qk, c, ck, 6)
    jvals, jidx = _jax(q, qk, c, ck, 6)
    np.testing.assert_array_equal(idx, jidx)
    np.testing.assert_allclose(vals, jvals, atol=1e-6)
    sims = q @ c.T
    real = np.flatnonzero(ck >= 0)
    for r in (0, 1, 8):
        order = real[np.lexsort((real, -sims[r][real]))][:6]
        np.testing.assert_array_equal(idx[r], order)
    assert (idx[3] == SENTINEL_IDX).all()


def test_no_candidates_and_partial_rows():
    rng = np.random.default_rng(0)
    q, qk, c, ck = make(rng, 4, 32, 16, 2)
    qk[:2] = 99                  # matches nothing
    ck[:] = 0
    ck[:3] = 1
    qk[2] = 1                    # three candidates for k=5
    vals, idx = _port(q, qk, c, ck, 5)
    jvals, jidx = _jax(q, qk, c, ck, 5)
    np.testing.assert_array_equal(idx, jidx)
    assert (idx[:2] == SENTINEL_IDX).all() and (vals[:2] == np.float32(NEG_INF)).all()
    assert sorted(idx[2, :3].tolist()) == [0, 1, 2]
    assert (idx[2, 3:] == SENTINEL_IDX).all()


def test_k_beyond_corpus_pads_with_sentinels():
    rng = np.random.default_rng(4)
    q, qk, c, ck = make(rng, 3, 6, 8, 1)
    vals, idx = _port(q, qk, c, ck, 10)
    assert vals.shape == (3, 10)
    assert (idx[:, 6:] == SENTINEL_IDX).all() and (vals[:, 6:] == np.float32(NEG_INF)).all()
    assert sorted(idx[0, :6].tolist()) == list(range(6))


def test_masked_topk_matches_jax():
    rng = np.random.default_rng(2)
    sims = rng.integers(0, 4, size=(6, 50)).astype(np.float32)  # many ties
    mask = rng.random((6, 50)) < 0.6
    vals, idx = masked_topk(torch.from_numpy(sims), torch.from_numpy(mask), 12)
    jvals, jidx = jax_masked_topk(jnp.asarray(sims), jnp.asarray(mask), 12)
    np.testing.assert_array_equal(idx.numpy(), np.asarray(jidx))
    np.testing.assert_array_equal(vals.numpy(), np.asarray(jvals))


def test_key_mask():
    qk = torch.tensor([0, 5, WILDCARD_KEY, -2], dtype=torch.int32)
    ck = torch.tensor([0, 5, -1, 7], dtype=torch.int32)
    want = [[1, 0, 0, 0], [0, 1, 0, 0], [1, 1, 0, 1], [0, 0, 0, 0]]
    assert key_mask(qk, ck).int().tolist() == want


def test_group_by_key_is_stable_with_wildcards_first():
    qk = torch.tensor([5, WILDCARD_KEY, 2, 5, WILDCARD_KEY, 2, 7, 10**6], dtype=torch.int32)
    assert group_by_key(qk).tolist() == [1, 4, 2, 5, 0, 3, 6, 7]


@pytest.mark.parametrize("q", [1, 64, 301])
def test_ungroup_rows_inverts_group_by_key(q):
    rng = np.random.default_rng(q)
    qk = torch.from_numpy(rng.integers(-3, 20, q).astype(np.int32))
    order = group_by_key(qk)
    grouped = qk[order].numpy()
    assert (np.diff(grouped) >= 0).all()
    same = grouped[:-1] == grouped[1:]
    assert (np.diff(order.numpy())[same] > 0).all()   # stable within a key
    for rows in (torch.from_numpy(rng.normal(size=(q, 5)).astype(np.float32)),
                 torch.from_numpy(rng.integers(0, 99, (q, 3)).astype(np.int32))):
        assert torch.equal(ungroup_rows(rows[order], order), rows)


def test_grouped_search_matches_the_search_in_query_order():
    """What the CUDA wrapper does around K2 (search the queries grouped by
    key, put the rows back), composed here with the plain version, is the
    search in the queries' own order."""
    rng = np.random.default_rng(31)
    q, qk, c, ck = make(rng, 40, 300, 32, 6)
    qk[::5] = WILDCARD_KEY
    tq, tqk, tc, tck = (torch.from_numpy(a) for a in (q, qk, c, ck))
    order = group_by_key(tqk)
    vals, idx = masked_sim_topk(tq[order], tqk[order], tc, tck, 9)
    want_vals, want_idx = masked_sim_topk(tq, tqk, tc, tck, 9)
    assert torch.equal(ungroup_rows(idx, order), want_idx)
    assert torch.equal(ungroup_rows(vals, order), want_vals)
