"""The port's sharded IVF index against tpualign's, on the CPU: one
counterpart of each sharded test of ``tests/test_ivf.py``.

The port runs on ``create_mesh(8, devices=["cpu"] * 8)``, tpualign on its
eight virtual CPU devices (``tests/conftest.py``), over the same seeded
numpy inputs. The geometry (``n_lists_local``, ``capacity``,
``spill_blocks``, ``n_probes``) and the layout (``_ids``, ``_keys``,
``_emb``, ``_scales``) are equal, the centroids within 1e-5 (the bound of
``tests/test_torch_ivf.py``'s one-device build), and searches give
identical indices with values within 1e-6, probed and at full probe.
Probed searches take tpualign's kernel route (``use_kernel=True``, the
Pallas kernel in interpret mode), as the port routes everywhere; int8 is
compared on the dequantized route of both (``int8_mxu=False``), the
packed precisions on their integer route."""

import numpy as np
import pytest
import torch

import tpualign_torch.parallel.ivf as port_ivf
from tpualign.parallel import ivf as jax_ivf
from tpualign.parallel.mesh import create_mesh as jax_create_mesh
from tpualign.parallel.retrieval import build_index as jax_build_index
from tpualign.parallel.retrieval import encode_keys
from tpualign_torch.parallel import create_mesh
from tpualign_torch.parallel import retrieval as port_retrieval
from tpualign_torch.parallel.ivf import IVFIndex

from test_torch_ivf import make_clustered, oracle, unit

pytestmark = pytest.mark.fast

CPU = torch.device("cpu")


def port_mesh(data=8):
    return create_mesh(data, devices=[CPU] * data)


def jax_mesh(data=8):
    return jax_create_mesh(data=data)


def mxu(precision):
    """The route both packages share on the CPU (see the module notes)."""
    return precision != "int8"


def build_both(c, *args, precision="fp32", data=8, **kw):
    """The same sharded build in both packages."""
    t = IVFIndex(c, *args, precision=precision, mesh=port_mesh(data), device="cpu",
                 int8_mxu=mxu(precision), **kw)
    j = jax_ivf.IVFIndex(c, *args, precision=precision, mesh=jax_mesh(data), use_kernel=True,
                         int8_mxu=mxu(precision), **kw)
    return t, j


def assert_same_index(t, j):
    """Geometry and layout equal, centroids within 1e-5."""
    for name in ("n", "n_lists_local", "n_lists", "n_probes", "capacity", "spill",
                 "spill_blocks", "dim", "vocab"):
        assert getattr(t, name) == getattr(j, name), name
    np.testing.assert_array_equal(t._ids.cpu().numpy(), np.asarray(j._ids))
    np.testing.assert_array_equal(t._keys.cpu().numpy(), np.asarray(j._keys))
    np.testing.assert_array_equal(t._emb.cpu().numpy(), np.asarray(j._emb))
    if j._scales is None:
        assert t._scales is None
    else:
        np.testing.assert_array_equal(t._scales.cpu().numpy(), np.asarray(j._scales))
    np.testing.assert_allclose(t.centroids.cpu().numpy(), np.asarray(j.centroids), atol=1e-5)
    assert t._emb.devices == [CPU] * 8 and len(t._ids.parts) == 8


def assert_same_search(t, j, q, *args, probes=(), **kw):
    """Identical indices, values within 1e-6, at each of ``probes`` and at
    full probe."""
    for p in tuple(probes) + (t.n_lists_local,):
        tv, ti = t.search(q, *args, n_probes=p, **kw)
        jv, ji = j.search(q, *args, n_probes=p, **kw)
        np.testing.assert_array_equal(ti, ji, err_msg=f"n_probes={p}")
        np.testing.assert_allclose(tv, jv, rtol=0, atol=1e-6, err_msg=f"n_probes={p}")


def test_build_index_ivf_cache_sharded(tmp_path, monkeypatch):
    """tests/test_ivf.py:335: the first sharded build saves, a second on a
    same-size mesh loads without k-means (and tpualign's factory loads the
    port's artifact), a mesh of another size rebuilds."""
    rng = np.random.default_rng(94)
    c = make_clustered(rng, n=1024, d=16, g=8)
    man, pages = ["m0"] * 1024, [1 + i % 4 for i in range(1024)]
    cache = str(tmp_path / "sivf.npz")
    kw = dict(index_type="ivf", ivf_lists=32, ivf_cache=cache)
    a = port_retrieval.build_index(c, man, pages, mesh=port_mesh(), **kw)
    assert a.mesh is not None and (tmp_path / "sivf.npz").exists()
    calls = []
    real = port_ivf._kmeans
    monkeypatch.setattr(port_ivf, "_kmeans", lambda *x, **y: calls.append(1) or real(*x, **y))
    b = port_retrieval.build_index(c, man, pages, mesh=port_mesh(), **kw)
    assert not calls and b.mesh is not None
    j = jax_build_index(c, man, pages, mesh=jax_mesh(), **kw)
    assert j.mesh is not None and j.n_lists_local == b.n_lists_local
    q = unit(rng.normal(size=(16, 16)).astype(np.float32))
    va, ia = a.search(q, k=5, n_probes=a.n_lists_local)
    for other in (b, j):
        vb, ib = other.search(q, k=5, n_probes=other.n_lists_local)
        np.testing.assert_array_equal(ia, ib)
        np.testing.assert_allclose(va, vb, rtol=0, atol=1e-6)
    d4 = port_retrieval.build_index(c, man, pages, mesh=port_mesh(4), **kw)
    assert calls and d4.mesh.shape["data"] == 4


def test_sharded_full_probe_matches_dense_oracle():
    """tests/test_ivf.py:496: per-shard full probes and the exact merge equal
    the dense oracle, keys and ties included, and tpualign's index."""
    rng = np.random.default_rng(20)
    n, d = 1024, 32
    c = unit(rng.normal(size=(n, d)).astype(np.float32))
    cman, cpage = [f"m{i % 3}" for i in range(n)], [1 + i % 4 for i in range(n)]
    t, j = build_both(c, cman, cpage, n_lists=32, iters=4)
    assert t.n_lists_local * 8 == t.n_lists
    assert_same_index(t, j)
    q = c[:37]
    vals, idx = t.search(q, cman[:37], cpage[:37], k=9, n_probes=t.n_lists_local)
    ck, vocab = encode_keys(cman, cpage, {})
    qk, _ = encode_keys(cman[:37], cpage[:37], vocab)
    ovals, oidx = oracle(q, qk, c, ck, 9)
    np.testing.assert_array_equal(idx, oidx)
    np.testing.assert_allclose(vals, ovals, rtol=0, atol=1e-5)
    assert_same_search(t, j, q, cman[:37], cpage[:37], k=9, probes=(1, 2))


def test_sharded_probed_recall_and_int8():
    """tests/test_ivf.py:517: probed sharded search keeps recall on
    clusterable data, fp32 and int8, and answers as tpualign's does."""
    rng = np.random.default_rng(21)
    c = make_clustered(rng, n=8192, d=32, g=32)
    q = unit(c[rng.integers(len(c), size=128)]
             + 0.05 * rng.normal(size=(128, 32)).astype(np.float32))
    zeros = np.zeros(len(c), np.int32)
    _, oidx = oracle(q, np.zeros(len(q), np.int32), c, zeros, 10)
    for precision, floor in (("fp32", 0.9), ("int8", 0.85)):
        t, j = build_both(c, n_lists=64, n_probes=4, iters=6, precision=precision)
        assert_same_index(t, j)
        _, idx = t.search(q, k=10)
        rec = np.mean([len(np.intersect1d(idx[r], oidx[r])) / 10 for r in range(len(q))])
        assert rec >= floor, f"sharded {precision} recall {rec:.3f}"
        assert_same_search(t, j, q, k=10, probes=(4,))


def test_sharded_kernel_matches_union():
    """tests/test_ivf.py:543: K4 (its plain version here) on every shard
    agrees with the union route shard for shard, and with tpualign's
    interpret-mode kernel."""
    rng = np.random.default_rng(22)
    c = make_clustered(rng, n=2048, d=32, g=16)
    q = unit(rng.normal(size=(40, 32)).astype(np.float32))
    kern = IVFIndex(c, n_lists=32, iters=4, mesh=port_mesh(), use_kernel=True, device="cpu")
    union = IVFIndex(c, n_lists=32, iters=4, mesh=port_mesh(), use_kernel=False, device="cpu")
    j = jax_ivf.IVFIndex(c, n_lists=32, iters=4, mesh=jax_mesh(), use_kernel=True)
    vk, ik = kern.search(q, k=7, n_probes=2)
    vu, iu = union.search(q, k=7, n_probes=2)
    vj, ij = j.search(q, k=7, n_probes=2)
    np.testing.assert_array_equal(ik, iu)
    np.testing.assert_allclose(vk, vu, rtol=0, atol=1e-5)
    np.testing.assert_array_equal(ik, ij)
    np.testing.assert_allclose(vk, vj, rtol=0, atol=1e-6)


def test_factory_builds_sharded_ivf_on_mesh():
    """tests/test_ivf.py:559: build_index(mesh=) returns the sharded index."""
    rng = np.random.default_rng(23)
    c = make_clustered(rng, n=1024, d=16, g=8)
    kw = dict(index_type="ivf", ivf_lists=32, ivf_probes=2)
    ix = port_retrieval.build_index(c, ["m0"] * 1024, [1] * 1024, mesh=port_mesh(), **kw)
    j = jax_build_index(c, ["m0"] * 1024, [1] * 1024, mesh=jax_mesh(), **kw)
    assert isinstance(ix, IVFIndex) and ix.mesh is not None and ix.n_probes == 2
    assert_same_index(ix, j)
    v, i = ix.search(c[:5], k=3)
    assert (i[:, 0] == np.arange(5)).all()


def test_sharded_calibrate():
    """tests/test_ivf.py:571: the analytic calibration per shard picks
    tpualign's probe counts, and the calibrated default reaches the target
    against the exact ranking."""
    rng = np.random.default_rng(24)
    c = make_clustered(rng, n=8192, d=32, g=64, noise=0.35)
    t, j = build_both(c, n_lists=64, iters=6)
    assert_same_index(t, j)
    p_low, p_high = t.calibrate(0.7), t.calibrate(0.99)
    assert (p_low, p_high) == (j.calibrate(0.7), j.calibrate(0.99))
    assert 1 <= p_low <= p_high <= t.n_lists_local
    assert t.n_probes == p_high and t.calibrated_target == 0.99
    q = c[(np.arange(128) * len(c)) // 128]
    _, oidx = oracle(q, np.zeros(len(q), np.int32), c, np.zeros(len(c), np.int32), 10)
    _, idx = t.search(q, k=10)
    rec = np.mean([len(np.intersect1d(idx[r], oidx[r])) / 10 for r in range(len(q))])
    assert rec >= 0.95, f"sharded calibrated recall {rec:.3f}"


def test_sharded_int4_full_probe_matches_single_device():
    """tests/test_ivf.py:743: int4 over the mesh at full probe equals the
    one-device full probe (both exact over the same 4-bit grid)."""
    rng = np.random.default_rng(39)
    c = make_clustered(rng, n=1024, d=32, g=8)
    q = unit(rng.normal(size=(32, 32)).astype(np.float32))
    a = IVFIndex(c, n_lists=64, iters=4, precision="int4", device="cpu")
    va, ia = a.search(q, k=5, n_probes=a.n_lists)
    t, j = build_both(c, n_lists=64, iters=4, precision="int4")
    assert_same_index(t, j)
    vm, im = t.search(q, k=5, n_probes=t.n_lists_local)
    np.testing.assert_array_equal(im, ia)
    np.testing.assert_allclose(vm[im >= 0], va[ia >= 0], rtol=0, atol=1e-5)
    assert_same_search(t, j, q, k=5, probes=(2,))


def test_sharded_prequantized_scales_gather_per_shard():
    """tests/test_ivf.py:759: a build from pre-quantized rows takes each
    slot's scale from its own shard's rows (ids are global)."""
    rng = np.random.default_rng(41)
    n, d = 2048, 32
    c = rng.normal(size=(n, d)).astype(np.float32)
    c = c * np.repeat(np.logspace(-2, 2, 8), n // 8).astype(np.float32)[:, None]
    scale = np.maximum(np.abs(c).max(axis=1) / 127.0, 1e-12).astype(np.float32)
    c_i8 = np.clip(np.rint(c / scale[:, None]), -127, 127).astype(np.int8)
    t, j = build_both(c_i8, n_lists=64, iters=4, corpus_scales=scale, precision="int8")
    assert_same_index(t, j)
    ids, got = t._ids.cpu().numpy(), t._scales.cpu().numpy()
    shard = np.arange(len(ids)) // (len(ids) // 8)
    valid = ids >= 0
    assert (ids[valid] // (n // 8) == shard[valid]).all()
    np.testing.assert_allclose(got[valid], scale[ids[valid]], rtol=1e-6)


def test_sharded_ivf_add_full_probe_matches_fresh_build():
    """tests/test_ivf.py:873: adds route to the globally nearest centroid's
    shard and list (tpualign's layout slot for slot), and full probes after
    them equal a fresh sharded build over the combined corpus."""
    rng = np.random.default_rng(90)
    n, extra, d = 1024, 512, 32
    c = unit(rng.normal(size=(n + extra, d)).astype(np.float32))
    man, page = [f"m{i % 3}" for i in range(n + extra)], [1 + i % 4 for i in range(n + extra)]
    q, qm, qp = c[::17][:40], man[::17][:40], page[::17][:40]
    for precision in ("fp32", "int8"):
        t, j = build_both(c[:n], man[:n], page[:n], n_lists=32, iters=4, precision=precision)
        for ix in (t, j):
            ix.add(c[n:n + 200], man[n:n + 200], page[n:n + 200])
            ix.add(c[n + 200:], man[n + 200:], page[n + 200:])
        assert t.n == n + extra
        assert_same_index(t, j)
        fresh = IVFIndex(c, man, page, n_lists=32, iters=4, precision=precision,
                         mesh=port_mesh(), device="cpu", int8_mxu=mxu(precision))
        v1, i1 = t.search(q, qm, qp, k=8, n_probes=t.n_lists_local)
        v2, i2 = fresh.search(q, qm, qp, k=8, n_probes=fresh.n_lists_local)
        np.testing.assert_array_equal(i1, i2, err_msg=precision)
        has = i2 >= 0
        np.testing.assert_allclose(v1[has], v2[has], rtol=0, atol=2e-5, err_msg=precision)
        assert_same_search(t, j, q, qm, qp, k=8, probes=(2,))


def test_sharded_ivf_add_grows_spill_and_probed_finds_new_rows():
    """tests/test_ivf.py:902: overfull lists spill to their own shard's
    tail, a full tail grows every shard's by the same blocks, full probes
    stay exact and probed search finds the new rows."""
    rng = np.random.default_rng(91)
    c = make_clustered(rng, n=8492, d=16, g=4)
    n = 8192
    t, j = build_both(c[:n], n_lists=16, iters=4, capacity_factor=0.05)
    assert t.spill > 0
    sb0 = t.spill_blocks
    for ix in (t, j):
        ix.add(c[n:])
        ix.add(c[:2048])                           # copies into full lists: the tails grow
    assert t.n == len(c) + 2048 and t.spill_blocks > sb0
    assert t._ids.shape[0] == (t.n_lists_local + 1 + t.spill_blocks) * t.capacity * 8
    assert_same_index(t, j)
    c = np.concatenate([c, c[:2048]])
    q = c[::13][:40]
    ex = port_retrieval.RetrievalIndex(c, ["m"] * len(c), [1] * len(c), device="cpu")
    _, i1 = t.search(q, k=8, n_probes=t.n_lists_local, global_search=True)
    _, i2 = ex.search(q, k=8, global_search=True)
    np.testing.assert_array_equal(i1, i2)
    assert t.calibrate(0.9, k=5, sample=64) == j.calibrate(0.9, k=5, sample=64)
    _, iq = t.search(c[n:n + 16], k=1, global_search=True)
    assert (iq[:, 0] == np.arange(n, n + 16)).mean() >= 0.9
    assert t.n_probes == j.n_probes


def test_sharded_ivf_compact_reclaims_and_stays_exact():
    """tests/test_ivf.py:991: compact drops the tombstones, re-absorbs the
    spill across the shards and renumbers in ascending old-id order
    (tpualign's layout slot for slot); full probes equal a fresh sharded
    build over the survivors; adds work after it."""
    rng = np.random.default_rng(74)
    c = make_clustered(rng, n=8692, d=16, g=4)
    n = 8192
    for precision in ("fp32", "int8"):
        t, j = build_both(c[:n], n_lists=16, iters=4, capacity_factor=0.05,
                          precision=precision)
        gone = np.arange(0, n + 400, 97)
        for ix in (t, j):
            ix.add(c[n:n + 400])
            assert ix.remove(gone) == len(gone)
        assert t.spill > 0 and t.dead == len(gone)
        tot0 = t._ids.shape[0]
        live = t.compact()
        np.testing.assert_array_equal(live, j.compact())
        np.testing.assert_array_equal(live, np.setdiff1d(np.arange(n + 400), gone))
        assert t.n == len(live) and t.dead == 0 and t._ids.shape[0] <= tot0
        assert_same_index(t, j)
        sub = c[live]
        fresh = IVFIndex(sub, n_lists=16, iters=4, precision=precision, mesh=port_mesh(),
                         device="cpu", int8_mxu=mxu(precision))
        q = sub[::13][:40]
        _, i1 = t.search(q, k=8, n_probes=t.n_lists_local, global_search=True)
        _, i2 = fresh.search(q, k=8, n_probes=fresh.n_lists_local, global_search=True)
        np.testing.assert_array_equal(i1, i2, err_msg=precision)
        tail = c[n + 400:]
        for ix in (t, j):
            ix.add(tail)
        assert_same_index(t, j)
        _, iq = t.search(tail[:16], k=1, n_probes=t.n_lists_local, global_search=True)
        hits = iq[:, 0] == np.arange(t.n - len(tail), t.n - len(tail) + 16)
        assert hits.all() if precision == "fp32" else hits.mean() >= 0.9, precision


def test_sharded_ivf_remove_and_readd():
    """tests/test_ivf.py:1041: remove tombstones the owning shard's slot; a
    removed id added again serves the new copy."""
    rng = np.random.default_rng(92)
    n, d = 1024, 32
    c = unit(rng.normal(size=(n, d)).astype(np.float32))
    man, page = [f"m{i % 3}" for i in range(n)], [1 + i % 4 for i in range(n)]
    t, j = build_both(c, man, page, n_lists=32, iters=4)
    for ix in (t, j):
        assert ix.remove([0, 1, 2, 999999, -5]) == 3
        assert ix.remove([0]) == 0
    assert_same_index(t, j)
    _, i1 = t.search(c[:3], man[:3], page[:3], k=3, n_probes=t.n_lists_local)
    assert not np.isin(i1, [0, 1, 2]).any()
    for ix in (t, j):
        ix.add(c[:1], man[:1], page[:1])
    assert_same_index(t, j)
    _, i2 = t.search(c[:1], man[:1], page[:1], k=2, n_probes=t.n_lists_local)
    assert i2[0, 0] == n


def test_sharded_save_load_roundtrip(tmp_path):
    """tests/test_ivf.py:1061: a sharded artifact (after adds and
    tombstones) written by either package loads in both onto a same-size
    mesh and serves identical results; the refusals carry tpualign's
    messages."""
    rng = np.random.default_rng(93)
    c = make_clustered(rng, n=2248, d=32, g=8)
    n = 2048
    man, page = [f"m{i % 2}" for i in range(len(c))], [1 + i % 3 for i in range(len(c))]
    q = unit(rng.normal(size=(40, 32)).astype(np.float32))
    for precision in ("fp32", "int8"):
        t, j = build_both(c[:n], man[:n], page[:n], n_lists=32, iters=4, precision=precision)
        for name, ix in (("port", t), ("jax", j)):
            ix.add(c[n:], man[n:], page[n:])
            assert ix.remove([5, 700]) == 2
            ix.save(tmp_path / f"{name}_{precision}.npz")
        for name in ("port", "jax"):
            path = tmp_path / f"{name}_{precision}.npz"
            tb = IVFIndex.load(path, c, mesh=port_mesh(), device="cpu", int8_mxu=mxu(precision))
            jb = jax_ivf.IVFIndex.load(path, c, mesh=jax_mesh(), use_kernel=True,
                                       int8_mxu=mxu(precision))
            assert tb.mesh is not None and tb.dead == 2
            assert_same_index(tb, jb)
            assert_same_search(tb, t, q, man[:40], page[:40], k=5, probes=(2,))
            assert_same_search(tb, jb, q, man[:40], page[:40], k=5, probes=(2,))
            extra = unit(rng.normal(size=(1, 32)).astype(np.float32))
            tb.add(extra, ["m0"], [1])
            _, inew = tb.search(extra, ["m0"], [1], k=1, n_probes=tb.n_lists_local)
            assert inew[0, 0] == tb.n - 1
    with pytest.raises(ValueError, match="sharded over 8"):
        IVFIndex.load(tmp_path / "port_fp32.npz", c, device="cpu")
    with pytest.raises(ValueError, match="sharded over 8"):
        IVFIndex.load(tmp_path / "port_fp32.npz", c, mesh=port_mesh(4), device="cpu")
    s = IVFIndex(c[:256], man[:256], page[:256], n_lists=8, iters=2, device="cpu")
    s.save(tmp_path / "single.npz")
    with pytest.raises(ValueError, match="single-device"):
        IVFIndex.load(tmp_path / "single.npz", c[:256], mesh=port_mesh(), device="cpu")
    with pytest.raises(ValueError, match="does not match"):
        IVFIndex.load(tmp_path / "port_fp32.npz", c[:100], mesh=port_mesh(), device="cpu")


def test_int2_sharded_full_probe_matches_single_device():
    """tests/test_ivf.py:1329: int2 over the mesh at full probe equals the
    one-device full probe and tpualign's sharded index."""
    rng = np.random.default_rng(143)
    c = make_clustered(rng, n=1024, d=32, g=16)
    man, pages = ["m0"] * 1024, [1 + i % 4 for i in range(1024)]
    single = IVFIndex(c, man, pages, n_lists=16, iters=4, precision="int2", device="cpu")
    t, j = build_both(c, man, pages, n_lists=16, iters=4, precision="int2")
    assert_same_index(t, j)
    q = unit(rng.normal(size=(16, 32)).astype(np.float32))
    vs, is_ = single.search(q, k=5, n_probes=single.n_lists)
    vm, im = t.search(q, k=5, n_probes=t.n_lists_local)
    np.testing.assert_array_equal(is_, im)
    np.testing.assert_allclose(vs, vm, rtol=0, atol=1e-5)
    assert_same_search(t, j, q, k=5, probes=(1,))


def test_service_on_a_mesh_serves_the_sharded_ivf_index():
    """build_service(mesh=)'s index under RETRIEVAL_INDEX=ivf (the service
    of ``serve --mesh-data``) is the sharded IVF index: /stats shows the
    mesh and the IVF geometry, and its answers, a mutation included, are
    tpualign's sharded service's."""
    from tpualign.serving.server import RetrievalService as JaxService
    from tpualign_torch.serving import RetrievalService

    rng = np.random.default_rng(95)
    c = make_clustered(rng, n=1024, d=16, g=8)
    ids = [f"c{i}" for i in range(1024)]
    man, page = [f"m{i % 2}" for i in range(1024)], [1 + i % 3 for i in range(1024)]
    kw = dict(index_type="ivf", ivf_lists=32, ivf_probes=2, coalesce_window_ms=None)
    t = RetrievalService(c, ids, man, page, mesh=port_mesh(4), device="cpu", **kw)
    j = JaxService(c, ids, man, page, mesh=jax_mesh(4), **kw)
    stats = t.stats()
    assert stats["mesh"] == {"data": 4, "model": 1} == j.stats()["mesh"]
    assert stats["index"] == "IVFIndex" and stats["ivf"]["n_lists"] == 32
    assert stats["dead_rows"] == 0 and isinstance(t.index, IVFIndex)
    q = c[:12] + 0.05 * rng.normal(size=(12, 16)).astype(np.float32)
    for svc in (t, j):
        svc.index.remove([3, 5])
    for kwq in ({"query_manuals": man[:12], "query_pages": page[:12]}, {"global_search": True}):
        tv, ti = t.index.search(q, k=5, **kwq)
        jv, ji = j.index.search(q, k=5, **kwq)
        np.testing.assert_array_equal(ti, ji)
        np.testing.assert_allclose(tv, jv, rtol=0, atol=1e-6)
    assert t.stats()["dead_rows"] == 2
