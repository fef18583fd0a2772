"""The port's IVF index and K4 against the JAX package's, on the CPU: K4's
plain version against the eager JAX ``ivf_probe_topk`` (Pallas, interpret
mode) for all five variants; the build's geometry, k-means, layout and
artifact; searches of both packages over the same artifact, probed and at
full probe; the fingerprint, calibration, ``build_index``'s cache, refine,
pre-quantized builds and the routes."""

import numpy as np
import pytest

import jax.numpy as jnp
import torch

import tpualign_torch.parallel.ivf as port_ivf
from tpualign.ops.pallas_kernels import ivf_probe_topk as jax_ivf_probe_topk
from tpualign.parallel import ivf as jax_ivf
from tpualign.parallel.retrieval import build_index as jax_build_index
from tpualign_torch.ops.ivf_topk import ivf_probe_topk, ivf_probe_topk_reference
from tpualign_torch.ops.sim_topk import SENTINEL_IDX
from tpualign_torch.ops.similarity import NEG_INF, WILDCARD_KEY
from tpualign_torch.parallel import retrieval as port_retrieval
from tpualign_torch.parallel.ivf import IVFIndex

pytestmark = pytest.mark.fast

# (name, port quantizer or None, int8_mxu)
VARIANTS = [("fp32", None, False), ("s8", "_quantize_rows", True),
            ("dequant", "_quantize_rows", False), ("int4", "_quantize_rows_int4", True),
            ("int2", "_quantize_rows_int2", True)]
PRECISIONS = ("fp32", "int8", "int4", "int2")


def unit(x):
    return x / np.linalg.norm(x, axis=-1, keepdims=True)


def make_clustered(rng, n=1024, d=32, g=8, noise=0.15):
    """g directions plus noise: k-means finds the structure."""
    centers = unit(rng.normal(size=(g, d)).astype(np.float32))
    a = rng.integers(g, size=n)
    return unit(centers[a] + noise * rng.normal(size=(n, d)).astype(np.float32)).astype(
        np.float32)


def oracle(q, qk, c, ck, k):
    """Dense exact ranking, (value desc, index asc), over key matches or
    every real row (key >= 0) for a wildcard query."""
    sims = q.astype(np.float64) @ c.astype(np.float64).T
    vals = np.full((len(q), k), NEG_INF, np.float32)
    idx = np.full((len(q), k), -1, np.int64)
    for r in range(len(q)):
        cand = np.where(ck >= 0 if qk[r] == WILDCARD_KEY else ck == qk[r])[0]
        order = cand[np.lexsort((cand, -sims[r][cand]))][:k]
        vals[r, :len(order)] = sims[r][order]
        idx[r, :len(order)] = order
    return vals, idx


def _near_ties(vals, gap=1e-6):
    close = np.abs(np.diff(vals, axis=1)) <= gap
    near = np.zeros(vals.shape, bool)
    near[:, 1:] |= close
    near[:, :-1] |= close
    return near


# -- K4: the plain version against the JAX kernel --------------------------------


def _k4_inputs(seed, variant, quantizer, q=24, d=64, n_lists=6, cap=40, spill=2, p=2):
    """A packed layout of n_lists + 1 + spill blocks with unused slots, an
    all-masked padding block and duplicated rows; queries with keys,
    wildcards, no candidates and padding; a union with padding entries."""
    rng = np.random.default_rng(seed)
    rows = (n_lists + 1 + spill) * cap
    emb = unit(rng.normal(size=(rows, d)).astype(np.float32))
    emb[rows - 5:] = emb[:5]                       # exact ties across blocks
    keys = rng.integers(0, 3, rows).astype(np.int32)
    keys[rng.random(rows) < 0.1] = -1              # unused slots
    keys[n_lists * cap:(n_lists + 1) * cap] = -1   # the padding block
    queries = unit(rng.normal(size=(q, d)).astype(np.float32))
    qk = rng.integers(0, 3, q).astype(np.int32)
    qk[::5] = WILDCARD_KEY
    qk[3::7] = 99                                  # no candidates
    probes = np.stack([rng.choice(n_lists, p, replace=False) for _ in range(q)]).astype(
        np.int32)
    qk[-2:] = -2                                   # padding queries
    probes[-2:] = n_lists
    real = np.unique(probes[:-2])
    uids = np.concatenate([real, np.full(n_lists - len(real), n_lists),
                           n_lists + 1 + np.arange(spill)]).astype(np.int32)
    scales = None
    if quantizer is not None:
        emb, scales = getattr(port_retrieval, quantizer)(emb)
    return queries, qk, probes, uids, emb, keys, scales, (cap, n_lists)


@pytest.mark.parametrize("variant,quantizer,mxu", VARIANTS)
@pytest.mark.parametrize("k", [5, 40])
def test_k4_plain_matches_jax_kernel(variant, quantizer, mxu, k):
    queries, qk, probes, uids, emb, keys, scales, (cap, n_lists) = _k4_inputs(k, variant,
                                                                              quantizer)
    t = lambda a: None if a is None else torch.from_numpy(a)  # noqa: E731
    vals, idx = ivf_probe_topk(t(queries), t(qk), t(probes), t(uids), t(emb), t(keys), k, cap,
                               n_lists, packed_scales=t(scales), int8_mxu=mxu)
    j = lambda a: None if a is None else jnp.asarray(a)  # noqa: E731
    jv, ji = jax_ivf_probe_topk(j(queries), j(qk)[:, None], j(probes), j(uids), j(emb),
                                j(keys)[None, :], k, cap, n_lists, block_q=8,
                                packed_scales=j(scales), int8_mxu=mxu)
    vals, idx, jv, ji = (np.asarray(a) for a in (vals, idx, jv, ji))
    has = jv > NEG_INF / 2
    np.testing.assert_array_equal(vals > NEG_INF / 2, has)
    # the port's empty slots are exact; JAX's repeat a winner's index
    assert (idx[~has] == SENTINEL_IDX).all() and (vals[~has] == np.float32(NEG_INF)).all()
    assert has[::5].any() and not has[3::7].any() and not has[-2:].any()
    if variant in ("fp32", "dequant"):
        # fp32 products in another summation order
        np.testing.assert_allclose(vals[has], jv[has], atol=1e-6)
        ok = has & ~_near_ties(jv)
        np.testing.assert_array_equal(idx[ok], ji[ok])
    else:
        # exact integer sums, and the eager JAX call divides by 127 as the
        # port does: identical
        np.testing.assert_array_equal(idx[has], ji[has])
        np.testing.assert_array_equal(vals[has], jv[has])
    # membership and spill: every winner's block is probed or spilled
    block = idx // cap
    for r, c in zip(*np.nonzero(has)):
        assert block[r, c] > n_lists or block[r, c] in probes[r]


def test_k4_empty_unions_and_spill_only():
    """No union at all, and a union of spill blocks only (every query is
    padding or probes nothing real): exact sentinels, spill rows found."""
    queries, qk, probes, uids, emb, keys, _, (cap, n_lists) = _k4_inputs(3, "fp32", None)
    t = [torch.from_numpy(a) for a in (queries, qk, probes)]
    none = torch.zeros(0, dtype=torch.int32)
    vals, idx = ivf_probe_topk(*t, none, torch.from_numpy(emb), torch.from_numpy(keys), 4,
                               cap, n_lists)
    assert (idx == SENTINEL_IDX).all() and (vals == np.float32(NEG_INF)).all()
    spill = torch.from_numpy(uids[uids > n_lists])
    wild = torch.full_like(t[1], WILDCARD_KEY)
    vals, idx = ivf_probe_topk(t[0], wild, t[2], spill, torch.from_numpy(emb),
                               torch.from_numpy(keys), 4, cap, n_lists)
    assert (idx // cap > n_lists).all()
    want = oracle(queries, np.full(len(queries), WILDCARD_KEY), emb[(n_lists + 1) * cap:],
                  keys[(n_lists + 1) * cap:], 4)
    np.testing.assert_array_equal(idx.numpy(), want[1] + (n_lists + 1) * cap)


def test_k4_rejects_bad_inputs():
    queries, qk, probes, uids, emb, keys, _, (cap, n_lists) = _k4_inputs(4, "fp32", None)
    t = [torch.from_numpy(a) for a in (queries, qk, probes, uids, emb, keys)]
    with pytest.raises(TypeError, match="int32"):
        ivf_probe_topk(t[0], t[1], t[2].long(), *t[3:], 3, cap, n_lists)
    with pytest.raises(ValueError, match="probes"):
        ivf_probe_topk(t[0], t[1], t[2][:3], *t[3:], 3, cap, n_lists)
    got = ivf_probe_topk(*t, 3, cap, n_lists)
    want = ivf_probe_topk_reference(*t, 3, cap, n_lists)
    assert all(torch.equal(g, w) for g, w in zip(got, want))


# -- the index: geometry, layout, k-means, artifact -----------------------------------


@pytest.mark.parametrize("precision", PRECISIONS)
def test_geometry_layout_and_kmeans_match_jax(precision):
    """Forced spill (a tiny capacity factor): the same lists, capacity,
    spill, layout (ids, keys, rows, scales) and centroids within 1e-5."""
    rng = np.random.default_rng(1)
    c = make_clustered(rng, n=2048, d=32, g=4)
    man = [f"m{i % 2}" for i in range(2048)]
    pg = [1 + i % 3 for i in range(2048)]
    kw = dict(n_lists=16, iters=4, capacity_factor=0.05, precision=precision)
    j = jax_ivf.IVFIndex(c, man, pg, **kw)
    t = IVFIndex(c, man, pg, device="cpu", **kw)
    assert t.spill >= 8
    for name in ("n_lists", "n_probes", "capacity", "spill", "spill_blocks", "dim", "vocab"):
        assert getattr(t, name) == getattr(j, name), name
    np.testing.assert_allclose(t.centroids.numpy(), np.asarray(j.centroids), atol=1e-5)
    np.testing.assert_array_equal(t._ids.numpy(), np.asarray(j._ids))
    np.testing.assert_array_equal(t._keys.numpy(), np.asarray(j._keys))
    np.testing.assert_array_equal(t._emb.numpy(), np.asarray(j._emb))
    if precision != "fp32":
        np.testing.assert_array_equal(t._scales.numpy(), np.asarray(j._scales))
    assert t.memory_bytes < IVFIndex(c, device="cpu", n_lists=16, iters=1).memory_bytes


def test_kmeans_assignments_match_jax():
    rng = np.random.default_rng(2)
    c = make_clustered(rng, n=1000, d=32, g=8)
    c[7] = 0.0                                     # an all-zero row takes no list
    init = c[(np.arange(8) * 1000) // 8]
    cent, assign, sizes = port_ivf._kmeans(torch.from_numpy(c), None, torch.from_numpy(init),
                                           5, 32, block=256)
    jc, ja, js = jax_ivf._kmeans(jnp.asarray(c), None, jnp.asarray(init), 5, 1000)
    np.testing.assert_allclose(cent.numpy(), np.asarray(jc), atol=1e-5)
    np.testing.assert_array_equal(assign.numpy(), np.asarray(ja))
    np.testing.assert_array_equal(sizes.numpy(), np.asarray(js))
    assert assign[7] == 8


def test_capacity_clamp_matches_jax():
    for args in ((512, 4), (512, 1), (512, 0), (64, 4), (4096, 4)):
        for mxu in (False, True):
            assert port_ivf._max_capacity(*args, int8_mxu=mxu) == jax_ivf._max_capacity(
                *args, int8_mxu=mxu)
    # too few lists for the clamp: bumped as tpualign bumps them
    c = unit(np.random.default_rng(3).normal(size=(4096, 1024)).astype(np.float32))
    t = IVFIndex(c, n_lists=2, iters=1, device="cpu")
    j = jax_ivf.IVFIndex(c, n_lists=2, iters=1)
    assert t.n_lists == j.n_lists == 8 and t.capacity == j.capacity <= 1536


def test_two_builds_write_identical_artifacts(tmp_path):
    rng = np.random.default_rng(4)
    c = make_clustered(rng, n=1024, d=32)
    arts = []
    for i in range(2):
        index = IVFIndex(c, [f"m{r % 3}" for r in range(1024)], [r % 4 for r in range(1024)],
                         n_lists=8, iters=4, precision="int8", device="cpu")
        index.save(tmp_path / f"a{i}.npz")
        arts.append(np.load(tmp_path / f"a{i}.npz"))
    assert sorted(arts[0].files) == ["centroids", "meta", "pids", "pkeys"]
    for name in arts[0].files:
        assert arts[0][name].tobytes() == arts[1][name].tobytes(), name


@pytest.mark.parametrize("precision", PRECISIONS)
def test_artifacts_cross_load_and_search_alike(precision, tmp_path):
    """An artifact tpualign writes loads in the port and the other way
    round; both packages then search it alike, probed and at full probe."""
    rng = np.random.default_rng(5)
    c = make_clustered(rng, n=1024, d=32, g=8, noise=0.3)
    man = [f"m{i % 2}" for i in range(1024)]
    pg = [1 + i % 3 for i in range(1024)]
    q = unit(c[:40] + 0.1 * rng.normal(size=(40, 32)).astype(np.float32))
    mxu = precision != "int8"  # int8 on the dequant route: products fp32 in both packages
    kw = dict(n_lists=8, iters=4, precision=precision)
    jax_ivf.IVFIndex(c, man, pg, **kw).save(tmp_path / "jax.npz")
    IVFIndex(c, man, pg, device="cpu", **kw).save(tmp_path / "port.npz")
    for path in ("jax.npz", "port.npz"):
        t = IVFIndex.load(tmp_path / path, c, device="cpu", int8_mxu=mxu)
        j = jax_ivf.IVFIndex.load(tmp_path / path, c, use_kernel=True, int8_mxu=mxu)
        assert (t.n_lists, t.capacity, t.vocab) == (j.n_lists, j.capacity, j.vocab)
        for p in (3, 8):
            for search_kw in ({"global_search": True},
                              {"query_manuals": man[:40], "query_pages": pg[:40]}):
                tv, ti = t.search(q, k=6, n_probes=p, **search_kw)
                jv, ji = j.search(q, k=6, n_probes=p, **search_kw)
                np.testing.assert_array_equal(ti, ji)
                # jitted JAX query quantization multiplies by fl(1/127)
                np.testing.assert_allclose(tv, jv, rtol=2.5e-7, atol=1e-6)


def test_load_rejects_a_changed_corpus(tmp_path):
    """The content fingerprint: a same-size corpus whose rows changed is
    refused by both packages, whichever wrote the artifact."""
    rng = np.random.default_rng(6)
    c = make_clustered(rng, n=512, d=16)
    changed = c.copy()
    changed[0] = -changed[0]
    IVFIndex(c, n_lists=8, iters=2, device="cpu").save(tmp_path / "port.npz")
    jax_ivf.IVFIndex(c, n_lists=8, iters=2).save(tmp_path / "jax.npz")
    for path in ("port.npz", "jax.npz"):
        IVFIndex.load(tmp_path / path, c, device="cpu")
        jax_ivf.IVFIndex.load(tmp_path / path, c)
        with pytest.raises(ValueError, match="fingerprint"):
            IVFIndex.load(tmp_path / path, changed, device="cpu")
        with pytest.raises(ValueError, match="fingerprint"):
            jax_ivf.IVFIndex.load(tmp_path / path, changed)
        with pytest.raises(ValueError, match="shape"):
            IVFIndex.load(tmp_path / path, c[:100], device="cpu")
    # save after load keeps the fingerprint
    IVFIndex.load(tmp_path / "jax.npz", c, device="cpu").save(tmp_path / "again.npz")
    with pytest.raises(ValueError, match="fingerprint"):
        jax_ivf.IVFIndex.load(tmp_path / "again.npz", changed)


def test_calibrate_picks_jax_probe_count(tmp_path):
    rng = np.random.default_rng(7)
    c = make_clustered(rng, n=2048, d=32, g=32, noise=0.35)
    jax_ivf.IVFIndex(c, n_lists=32, iters=6).save(tmp_path / "a.npz")
    t = IVFIndex.load(tmp_path / "a.npz", c, device="cpu")
    j = jax_ivf.IVFIndex.load(tmp_path / "a.npz", c)
    for target in (0.7, 0.9, 0.99):
        assert t.calibrate(target, k=10) == j.calibrate(target, k=10)
    assert t.n_probes == j.n_probes and t.calibrated_target == 0.99


# -- searches ------------------------------------------------------------------------------


@pytest.mark.parametrize("precision", PRECISIONS)
def test_full_probe_equals_dense_oracle_with_spill(precision):
    """n_probes == n_lists scans every block and the spill tail: the dense
    ranking of the index's own rows (dequantized), ties included."""
    rng = np.random.default_rng(8)
    c = make_clustered(rng, n=1024, d=32, g=4)
    c[-6:] = c[:6]                                 # exact ties
    man = [f"m{i % 2}" for i in range(1024)]
    pg = [1 + i % 3 for i in range(1024)]
    index = IVFIndex(c, man, pg, n_lists=16, iters=4, capacity_factor=0.05,
                     precision=precision, device="cpu")
    assert index.spill > 0
    rows = c
    if precision != "fp32":
        pos = index._positions.to(torch.int64)
        rows = port_ivf._dequant(index._emb[pos], index._scales[pos], index.dim).numpy()
    ck, vocab = port_retrieval.encode_keys(man, pg)
    qk, _ = port_retrieval.encode_keys(man[:30], pg[:30], dict(vocab))
    q = c[:30]
    for keys, search_kw in ((qk, {"query_manuals": man[:30], "query_pages": pg[:30]}),
                            (np.full(30, WILDCARD_KEY), {"global_search": True})):
        vals, idx = index.search(q, k=8, n_probes=index.n_lists, **search_kw)
        ovals, oidx = oracle(q, keys, rows, ck, 8)
        np.testing.assert_array_equal(idx, oidx)
        np.testing.assert_allclose(vals, ovals, atol=1e-5)


def test_probed_recall_and_key_mask():
    rng = np.random.default_rng(9)
    c = make_clustered(rng, n=2048, d=32, g=16)
    man = [f"m{i % 2}" for i in range(2048)]
    pg = [1 + i % 5 for i in range(2048)]
    index = IVFIndex(c, man, pg, n_lists=16, n_probes=4, iters=6, device="cpu")
    q = unit(c[:128] + 0.05 * rng.normal(size=(128, 32)).astype(np.float32))
    _, idx = index.search(q, k=10)
    _, oidx = oracle(q, np.full(128, WILDCARD_KEY), c, np.zeros(2048), 10)
    assert np.mean([len(np.intersect1d(a, b)) / 10 for a, b in zip(idx, oidx)]) >= 0.9
    _, idx = index.search(c[:50], man[:50], pg[:50], k=8)
    for r in range(50):
        assert all(man[j] == man[r] and pg[j] == pg[r] for j in idx[r] if j >= 0)
    np.testing.assert_array_equal(idx[:, 0], np.arange(50))
    _, none = index.search(c[:3], ["missing"] * 3, [9] * 3, k=4)
    assert (none == -1).all()


def test_routes_and_padding_queries(monkeypatch):
    """K4 for probed k <= 64, tpualign's union route at full probe and for
    k > 64, use_kernel honoured; padding queries stay out of the union."""
    rng = np.random.default_rng(10)
    c = make_clustered(rng, n=1024, d=32)
    index = IVFIndex(c, n_lists=8, iters=4, device="cpu")
    calls = []
    real = port_ivf.ivf_probe_topk

    def spy(q, qk, probes, uids, *args, **kw):
        calls.append(uids.tolist())
        return real(q, qk, probes, uids, *args, **kw)

    monkeypatch.setattr(port_ivf, "ivf_probe_topk", spy)
    q = c[:4].copy()
    qk = np.array([WILDCARD_KEY, -2, -2, WILDCARD_KEY], np.int32)
    vals, idx = index.search_encoded(q, qk, 5, n_probes=1)
    assert len(calls) == 1 and (idx[1:3] == -1).all() and (idx[[0, 3], 0] == [0, 3]).all()
    probes = port_ivf._probe(torch.from_numpy(q), torch.from_numpy(qk), index.centroids, 1, 8)
    want = sorted({int(probes[0, 0]), int(probes[3, 0])})
    assert calls[0] == want + list(range(9, 9 + index.spill_blocks))
    index.search(q, k=5, n_probes=8)                      # full probe: union route
    index.search(q, k=65, n_probes=2)                     # k > 64: union route
    assert len(calls) == 1
    index.use_kernel = False
    index.search(q, k=5, n_probes=2)
    assert len(calls) == 1
    index.use_kernel = True
    a = index.search(q, k=70, n_probes=2)
    index.use_kernel = False
    b = index.search(q, k=70, n_probes=2)
    assert len(calls) == 2
    np.testing.assert_array_equal(a[1], b[1])


@pytest.mark.parametrize("precision", ("int8", "int4", "int2"))
def test_prequantized_builds_match_jax(precision):
    rng = np.random.default_rng(11)
    c = make_clustered(rng, n=1024, d=32)
    codes, scales = port_retrieval._QUANTIZERS[precision](c)
    kw = dict(n_lists=8, iters=4, corpus_scales=scales, precision=precision)
    t = IVFIndex(codes, device="cpu", **kw)
    j = jax_ivf.IVFIndex(codes, **kw)
    assert t.precision == j.precision == precision
    np.testing.assert_allclose(t.centroids.numpy(), np.asarray(j.centroids), atol=1e-5)
    np.testing.assert_array_equal(t._ids.numpy(), np.asarray(j._ids))
    np.testing.assert_array_equal(t._emb.numpy(), np.asarray(j._emb))
    np.testing.assert_array_equal(t._scales.numpy(), np.asarray(j._scales))
    q = unit(rng.normal(size=(20, 32)).astype(np.float32))
    np.testing.assert_array_equal(t.search(q, k=5, n_probes=8)[1],
                                  j.search(q, k=5, n_probes=8)[1])
    with pytest.raises(ValueError, match="refine"):
        IVFIndex(codes, device="cpu", refine=4, **kw)
    with pytest.raises(ValueError, match="scales"):
        IVFIndex(codes, device="cpu", n_lists=8)


@pytest.mark.parametrize("precision", ("int8", "int4", "int2"))
def test_refine_matches_jax_and_fp64_oracle(precision, tmp_path):
    """Refine 4 over a shared artifact: the exact rescore makes the values
    bit-identical to tpualign's and each one the fp64 product of its row; at
    full probe int8 and int4 candidates hold the fp64 oracle's top 5 (int2's
    need not)."""
    rng = np.random.default_rng(12)
    c = make_clustered(rng, n=1024, d=32, noise=0.3)
    jax_ivf.IVFIndex(c, n_lists=8, iters=4, precision=precision).save(tmp_path / "a.npz")
    t = IVFIndex.load(tmp_path / "a.npz", c, refine=4, device="cpu")
    j = jax_ivf.IVFIndex.load(tmp_path / "a.npz", c, refine=4, use_kernel=True, int8_mxu=True)
    q = unit(c[:30] + 0.1 * rng.normal(size=(30, 32)).astype(np.float32))
    for p in (2, 8):
        tv, ti = t.search(q, k=5, n_probes=p)
        jv, ji = j.search(q, k=5, n_probes=p)
        np.testing.assert_array_equal(ti, ji)
        np.testing.assert_array_equal(tv, jv)
    vals, idx = t.search(q, k=5, n_probes=8)
    exact = np.einsum("qd,qkd->qk", q.astype(np.float64), c[idx].astype(np.float64))
    np.testing.assert_array_equal(vals, exact.astype(np.float32))
    if precision != "int2":
        ovals, oidx = oracle(q, np.full(30, WILDCARD_KEY), c, np.zeros(1024), 5)
        np.testing.assert_array_equal(idx, oidx)
        np.testing.assert_array_equal(vals, ovals)


# -- build_index -----------------------------------------------------------------------------


def test_build_index_ivf_cache_and_recalibration(tmp_path, monkeypatch):
    """The IVF_CACHE path: the first build saves, the second loads (no
    k-means), a precision change rebuilds, a new recall target recalibrates
    and re-saves, and an explicit IVF_PROBES wins over calibration."""
    rng = np.random.default_rng(13)
    c = make_clustered(rng, n=2048, d=32, g=32, noise=0.35)
    man = ["m0"] * 2048
    pages = [1 + i % 4 for i in range(2048)]
    cache = str(tmp_path / "ivf.npz")
    kw = dict(index_type="ivf", ivf_lists=32, ivf_cache=cache, device="cpu")
    a = port_retrieval.build_index(c, man, pages, recall_target=0.7, **kw)
    calls = []
    real = port_ivf._kmeans
    monkeypatch.setattr(port_ivf, "_kmeans", lambda *x, **y: calls.append(1) or real(*x, **y))
    b = port_retrieval.build_index(c, man, pages, recall_target=0.7, **kw)
    assert not calls and b.n_probes == a.n_probes and b.calibrated_target == 0.7
    hi = port_retrieval.build_index(c, man, pages, recall_target=0.99, **kw)
    assert not calls and hi.n_probes >= a.n_probes and hi.calibrated_target == 0.99
    assert IVFIndex.load(cache, c, device="cpu").calibrated_target == 0.99
    # the JAX factory reads the port's artifact without a rebuild either
    j = jax_build_index(c, man, pages, index_type="ivf", ivf_lists=32, ivf_cache=cache,
                        recall_target=0.99)
    assert j.n_probes == hi.n_probes
    i8 = port_retrieval.build_index(c, man, pages, precision="int8", **kw)
    assert calls and i8.precision == "int8"
    fixed = port_retrieval.build_index(c, man, pages, recall_target=0.99, ivf_probes=2,
                                       index_type="ivf", ivf_lists=32, device="cpu")
    assert fixed.n_probes == 2


def test_empty_corpus_serves_exact_and_later_slices_raise():
    index = port_retrieval.build_index(np.zeros((0, 16), np.float32), [], [],
                                       index_type="ivf", device="cpu")
    assert isinstance(index, port_retrieval.RetrievalIndex)
    assert (index.search(np.ones((2, 16), np.float32), k=3)[1] == -1).all()
    c = make_clustered(np.random.default_rng(14), n=256, d=16)
    with pytest.raises(NotImplementedError, match="multi-GPU"):
        IVFIndex(c, device="cpu", mesh=object())
    with pytest.raises(ValueError, match="non-empty"):
        IVFIndex(np.zeros((0, 16), np.float32), device="cpu")
    index = IVFIndex(c, n_lists=8, iters=2, device="cpu")
    for call in (lambda: index.add(c[:1]), lambda: index.remove([0]), index.compact):
        with pytest.raises(NotImplementedError, match="not yet ported"):
            call()
