"""The key-aware tile skip of K2, K3 and K4 is exact. The plain versions,
restricted to the tiles the kernels' admit prologue marks
(``admitted_tiles``, ``admitted_union_tiles``) and run on the queries in the
order the wrappers give the kernels (grouped by key), equal tpualign's
``masked_sim_topk`` and ``ivf_probe_topk`` (Pallas, interpret mode) on a
page-ordered corpus, with wildcard, keyed, no-candidate and padding
queries in one batch."""

import numpy as np
import pytest

import jax.numpy as jnp
import torch

from tpualign.ops.pallas_kernels import ivf_probe_topk as jax_ivf_probe_topk
from tpualign.ops.pallas_kernels import masked_sim_topk as jax_sim_topk
from tpualign_torch.ops.ivf_topk import admitted_union_tiles, ivf_probe_topk_reference
from tpualign_torch.ops.sim_topk import (
    _BN, _K2_BN, SENTINEL_IDX, admitted_tiles, group_by_key, masked_sim_topk_reference,
    query_tile, ungroup_rows)
from tpualign_torch.ops.similarity import NEG_INF, WILDCARD_KEY
from tpualign_torch.parallel import retrieval

pytestmark = pytest.mark.fast

# (variant, quantizer, int8_mxu): None is fp32 (K2, or K4's fp32 sweep)
VARIANTS = [(None, None, False), ("s8", "_quantize_rows", True),
            ("dequant", "_quantize_rows", False), ("int4", "_quantize_rows_int4", True),
            ("int2", "_quantize_rows_int2", True)]


def _unit(x):
    return x / np.linalg.norm(x, axis=1, keepdims=True)


def _batch_keys(rng, q, pages):
    qk = rng.integers(0, pages, q).astype(np.int32)
    qk[::7] = WILDCARD_KEY
    qk[3::11] = 10**6          # no candidates
    qk[5::13] = -2             # padding
    return qk


def _grouped(qk, bq):
    """The order the wrappers give the kernel: grouped by key when the
    batch takes more than one block."""
    return group_by_key(qk) if len(qk) > bq else torch.arange(len(qk))


def _assert_keyed_tiles_skip(admitted, keys, bq):
    """A query tile without a wildcard leaves corpus tiles unread."""
    for i in range(admitted.shape[0]):
        if not (keys[i * bq:(i + 1) * bq] == WILDCARD_KEY).any():
            assert not admitted[i].all()


def _assert_matches_jax(vals, idx, jv, ji, exact):
    vals, idx, jv, ji = (np.asarray(a) for a in (vals, idx, jv, ji))
    has = jv > NEG_INF / 2
    np.testing.assert_array_equal(vals > NEG_INF / 2, has)
    assert (idx[~has] == SENTINEL_IDX).all() and (vals[~has] == np.float32(NEG_INF)).all()
    if exact:
        np.testing.assert_array_equal(idx[has], ji[has])
        np.testing.assert_array_equal(vals[has], jv[has])
    else:
        np.testing.assert_allclose(vals[has], jv[has], atol=1e-6)
        close = np.abs(np.diff(jv, axis=1)) <= 1e-6
        near = np.zeros(has.shape, bool)
        near[:, 1:] |= close
        near[:, :-1] |= close
        np.testing.assert_array_equal(idx[has & ~near], ji[has & ~near])


def test_admitted_tiles_marks_key_matches_only():
    ck = torch.tensor([0, 0, 1, 1, 2, 2, -1, -1], dtype=torch.int32)
    qk = torch.tensor([1, 10**6, 2, -2, WILDCARD_KEY], dtype=torch.int32)
    got = admitted_tiles(qk, ck, 2, 2)
    # tiles [0 0] [1 1] [2 2] [-1 -1]; query tiles [1, none] [2, pad] [wild]
    assert got.tolist() == [[False, True, False, False], [False, False, True, False],
                            [True, True, True, False]]


@pytest.mark.parametrize("q", [5, 150])
@pytest.mark.parametrize("variant,quantizer,mxu", VARIANTS)
def test_sim_topk_over_admitted_tiles_matches_jax(variant, quantizer, mxu, q):
    """K2 (fp32) and K3: each query tile searches only the corpus tiles it
    admits (the rest masked as padding rows)."""
    rng = np.random.default_rng(q)
    n, d, k, rows_per_page = 640, 64, 12, 8
    cv = _unit(rng.normal(size=(n, d)).astype(np.float32))
    ck = (np.arange(n) // rows_per_page).astype(np.int32)
    ck[3::17] = -1
    qk = _batch_keys(rng, q, n // rows_per_page)
    qv = _unit(cv[np.clip(qk, 0, n - 1)] + 0.5 * rng.normal(size=(q, d)).astype(np.float32))
    corpus, scales = cv, None
    if quantizer is not None:
        corpus, scales = getattr(retrieval, quantizer)(cv)
    bq, bn = query_tile(variant, q), _K2_BN if variant is None else _BN
    tq, tqk, tc, tck = (torch.from_numpy(a) for a in (qv, qk, corpus, ck))
    kw = dict(corpus_scales=None if scales is None else torch.from_numpy(scales), int8_mxu=mxu)
    order = _grouped(tqk, bq)
    gq, gk = tq[order], tqk[order]
    admitted = admitted_tiles(gk, tck, bq, bn)
    _assert_keyed_tiles_skip(admitted, gk, bq)
    parts = []
    for i in range(admitted.shape[0]):
        rows = admitted[i].repeat_interleave(bn)[:n]
        parts.append(masked_sim_topk_reference(gq[i * bq:(i + 1) * bq], gk[i * bq:(i + 1) * bq],
                                               tc, torch.where(rows, tck, -1), k, **kw))
    vals = ungroup_rows(torch.cat([p[0] for p in parts]), order)
    idx = ungroup_rows(torch.cat([p[1] for p in parts]), order)
    jv, ji = jax_sim_topk(*(jnp.asarray(a) for a in (qv, qk, corpus, ck)), k, block_q=8,
                          block_n=128,
                          corpus_scales=None if scales is None else jnp.asarray(scales),
                          int8_mxu=mxu)
    _assert_matches_jax(vals, idx, jv, ji, variant not in (None, "dequant"))


def _ivf_inputs(rng, q, d=32, n_lists=6, cap=80, spill=2, p=2, rows_per_page=4):
    """A packed layout with page-ordered keys in its blocks, unused slots,
    an all-masked padding block and spill blocks; probes and a union with
    padding entries."""
    rows = (n_lists + 1 + spill) * cap
    emb = _unit(rng.normal(size=(rows, d)).astype(np.float32))
    keys = (np.arange(rows) // rows_per_page).astype(np.int32)
    keys[rng.random(rows) < 0.1] = -1
    keys[n_lists * cap:(n_lists + 1) * cap] = -1
    qk = _batch_keys(rng, q, rows // rows_per_page)
    queries = _unit(emb[np.clip(qk, 0, rows - 1)] + 0.5 * rng.normal(size=(q, d)).astype(
        np.float32))
    probes = np.stack([rng.choice(n_lists, p, replace=False) for _ in range(q)]).astype(
        np.int32)
    probes[qk == -2] = n_lists
    real = np.unique(probes[probes != n_lists])
    uids = np.concatenate([real, np.full(n_lists - len(real), n_lists),
                           n_lists + 1 + np.arange(spill)]).astype(
        np.int32)
    return queries, qk, probes, uids, emb, keys, (cap, n_lists)


@pytest.mark.parametrize("q", [5, 150])
@pytest.mark.parametrize("variant,quantizer,mxu", VARIANTS)
def test_ivf_probe_topk_over_admitted_tiles_matches_jax(variant, quantizer, mxu, q):
    """K4: each query tile searches only the union tiles it admits by key
    and probe (rows of the other tiles masked as unused slots)."""
    rng = np.random.default_rng(q + 1)
    queries, qk, probes, uids, emb, keys, (cap, n_lists) = _ivf_inputs(rng, q)
    packed, scales = emb, None
    if quantizer is not None:
        packed, scales = getattr(retrieval, quantizer)(emb)
    bq, bn = query_tile(variant, q), _K2_BN if variant is None else _BN
    t = [torch.from_numpy(a) for a in (queries, qk, probes, uids, packed, keys)]
    kw = dict(packed_scales=None if scales is None else torch.from_numpy(scales),
              int8_mxu=mxu)
    order = _grouped(t[1], bq)
    gq, gk, gp = t[0][order], t[1][order], t[2][order]
    admitted = admitted_union_tiles(gk, gp, t[3], t[5], cap, n_lists, bq, bn)
    _assert_keyed_tiles_skip(admitted, gk, bq)
    per_block = -(-cap // bn)
    offset = torch.arange(per_block * bn)
    union = (t[3].long()[:, None] * cap + offset[None, :]).reshape(-1)
    inside = ((offset < cap)[None, :] & (t[3] >= 0)[:, None]).reshape(-1) \
        & (union < len(keys))
    parts = []
    for i in range(admitted.shape[0]):
        open_rows = admitted[i].repeat_interleave(bn) & inside
        ck = torch.full_like(t[5], -1)
        ck[union[open_rows]] = t[5][union[open_rows]]
        s = slice(i * bq, (i + 1) * bq)
        parts.append(ivf_probe_topk_reference(gq[s], gk[s], gp[s], t[3], t[4], ck, 9, cap,
                                              n_lists, **kw))
    vals = ungroup_rows(torch.cat([p[0] for p in parts]), order)
    idx = ungroup_rows(torch.cat([p[1] for p in parts]), order)
    # the JAX kernel takes Q a multiple of block_q: pad with -2 rows
    pad = -q % 8
    jq = np.concatenate([queries, np.zeros((pad, queries.shape[1]), np.float32)])
    jk = np.concatenate([qk, np.full(pad, -2, np.int32)])
    jp = np.concatenate([probes, np.full((pad, probes.shape[1]), n_lists, np.int32)])
    j = lambda a: None if a is None else jnp.asarray(a)  # noqa: E731
    jv, ji = jax_ivf_probe_topk(j(jq), j(jk)[:, None], j(jp), j(uids), j(packed),
                                j(keys)[None, :], 9, cap, n_lists, block_q=8,
                                packed_scales=j(scales), int8_mxu=mxu)
    _assert_matches_jax(vals, idx, np.asarray(jv)[:q], np.asarray(ji)[:q],
                        variant not in (None, "dequant"))
