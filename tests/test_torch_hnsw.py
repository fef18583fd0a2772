"""tpualign_torch's HNSW index against tpualign's: the same native graph
(byte-equal when serialized), the same planner, calibration, mutations and
artifact, at fp32 and fp16; and the behaviour tpualign's own HNSW tests
hold, at small sizes.

Both packages run over the port's library (``jax_native``, see
``test_torch_native.py``); nothing is written into ``tpualign/native/``.
"""

import concurrent.futures
import copy
import shutil
import sys
import threading

import numpy as np
import pytest

from tests.test_torch_native import jax_native  # noqa: F401  (fixture)
from tpualign.parallel.hnsw import HNSWIndex as JaxHNSW
from tpualign.parallel.retrieval import build_index as jax_build_index
from tpualign_torch.ops.similarity import NEG_INF
from tpualign_torch.parallel.hnsw import HNSWIndex
from tpualign_torch.parallel.retrieval import build_index, encode_keys

pytestmark = [pytest.mark.fast,
              pytest.mark.skipif(shutil.which("g++") is None, reason="needs g++"),
              pytest.mark.usefixtures("jax_native")]

PRECISIONS = ["fp32", "fp16"]


def unit(x):
    return (x / np.linalg.norm(x, axis=-1, keepdims=True)).astype(np.float32)


def make_corpus(seed=0, n=2000, d=48, n_manuals=5, n_pages=11):
    rng = np.random.default_rng(seed)
    c = unit(rng.normal(size=(n, d)))
    cman = [f"m{i % n_manuals}" for i in range(n)]
    cpage = [i % n_pages for i in range(n)]
    q = unit(rng.normal(size=(32, d)))
    return c, cman, cpage, q


def numpy_oracle(queries, qkeys, corpus, ckeys, k):
    """Exact keyed ranking, ties by ascending index, (NEG_INF, -1) padding."""
    sims = queries @ corpus.T
    vals = np.full((len(queries), k), NEG_INF, np.float32)
    idx = np.full((len(queries), k), -1, np.int64)
    for r in range(len(queries)):
        cand = np.where(qkeys[r] == ckeys)[0]
        order = cand[np.lexsort((cand, -sims[r][cand]))][:k]
        vals[r, :len(order)] = sims[r][order]
        idx[r, :len(order)] = order
    return vals, idx


def global_recall(index, q, c, k=10):
    _, pos = index.search(q, k=k, global_search=True)
    exact = np.argsort(-(q @ c.T), axis=1)[:, :k]
    return np.mean([len(set(pos[i]) & set(exact[i])) / k for i in range(len(q))])


def pair(c, cman, cpage, **kw):
    return HNSWIndex(c, cman, cpage, **kw), JaxHNSW(c, cman, cpage, **kw)


def assert_same_results(a, b):
    for x, y in zip(a, b):
        np.testing.assert_array_equal(x, y)


def assert_same_index(t, j):
    assert t._core.serialize() == j._core.serialize()
    assert (t.n, t.live, t.dead, t.dim, t.precision, t.vocab) == (
        j.n, j.live, j.dead, j.dim, j.precision, j.vocab)
    np.testing.assert_array_equal(t._keys, j._keys)
    np.testing.assert_array_equal(t._dead, j._dead)
    assert t._corpus.dtype == j._corpus.dtype
    np.testing.assert_array_equal(t._corpus, j._corpus)


# -- the port against tpualign ------------------------------------------------------


@pytest.mark.parametrize("precision", PRECISIONS)
def test_graph_is_byte_equal_to_tpualigns(precision):
    c, cman, cpage, _ = make_corpus(n=1200, d=40)
    t, j = pair(c, cman, cpage, m=12, ef_construction=48, seed=7, precision=precision)
    assert_same_index(t, j)
    assert t.memory_bytes() == j.memory_bytes()


@pytest.mark.parametrize("precision", PRECISIONS)
@pytest.mark.parametrize("case", ["keyed", "wildcard", "nonselective", "unknown", "refine"])
def test_searches_equal_tpualigns(precision, case):
    c, cman, cpage, q = make_corpus(n=1500, d=32)
    kw = dict(precision=precision, ef_search=50)
    if case == "nonselective":  # one key over the whole corpus: the graph serves it
        cman, cpage = ["M"] * len(c), [0] * len(c)
    if case == "refine":
        kw["refine"] = 4
    t, j = pair(c, cman, cpage, **kw)
    qkw = {"keyed": dict(query_manuals=["m2"] * 32, query_pages=[3] * 32),
           "wildcard": dict(global_search=True),
           "nonselective": dict(query_manuals=["M"] * 32, query_pages=[0] * 32),
           "unknown": dict(query_manuals=["nope"] * 32, query_pages=[99] * 32),
           "refine": dict(global_search=True)}[case]
    got = t.search(q, k=10, **qkw)
    assert_same_results(got, j.search(q, k=10, **qkw))
    if case == "nonselective":
        assert (got[1] >= 0).all()
    if case == "unknown":
        assert (got[1] == -1).all() and (got[0] == NEG_INF).all()
    # one call's ef override (the calibration ladder's hook)
    qk = np.full(len(q), -3, np.int64)
    assert_same_results(t.search_encoded(q, qk, 10, ef=17), j.search_encoded(q, qk, 10, ef=17))


def test_under_filled_beam_is_finished_exactly_as_tpualign():
    """A key larger than the planner's cutoff whose rows the beam misses:
    the per-key count sees the under-fill and the exact scan finishes it."""
    c, _, _, q = make_corpus(n=1500, d=32)
    # key "far" holds 200 rows; queries near the other rows fill the beam elsewhere
    cman = ["far" if i % 7 == 0 else "near" for i in range(len(c))]
    cpage = [1] * len(c)
    t, j = pair(c, cman, cpage, ef_search=10)
    got = t.search(q, ["far"] * 32, [1] * 32, k=40)
    assert_same_results(got, j.search(q, ["far"] * 32, [1] * 32, k=40))
    assert (got[1] >= 0).all()


@pytest.mark.parametrize("target", [0.5, 0.98, 0.995])
def test_calibrate_picks_tpualigns_ef(target):
    c, cman, cpage, _ = make_corpus(n=4000, d=64)
    t, j = pair(c, cman, cpage)
    assert t.calibrate(target) == j.calibrate(target)
    assert t.ef_search == j.ef_search and t.calibrated_target == target


@pytest.mark.parametrize("precision", PRECISIONS)
def test_mutations_match_tpualign_step_by_step(precision):
    c, cman, cpage, q = make_corpus(n=900, d=24)
    t, j = pair(c, cman, cpage, precision=precision)
    extra = unit(np.random.default_rng(5).normal(size=(120, 24)))
    steps = [("add", (extra[:60], ["new"] * 60, [1] * 60)),
             ("remove", (np.arange(0, 900, 9),)),
             ("add", (extra[60:], ["m1"] * 60, [2] * 60)),
             ("remove", ([3, 3, 5, 10_000, -1],)),
             ("compact", ()),
             ("remove", (np.arange(0, 400),)),
             ("compact", ())]
    for name, args in steps:
        got, want = getattr(t, name)(*args), getattr(j, name)(*args)
        if name == "compact":
            np.testing.assert_array_equal(got, want)
        else:
            assert got == want
        assert_same_index(t, j)
        for kw in (dict(global_search=True),
                   dict(query_manuals=["new"] * 32, query_pages=[1] * 32),
                   dict(query_manuals=["m1"] * 32, query_pages=[2] * 32)):
            assert_same_results(t.search(q, k=7, **kw), j.search(q, k=7, **kw))


def test_copy_gets_a_private_lock_and_compacts_apart():
    c, cman, cpage, q = make_corpus(n=600, d=24)
    index = HNSWIndex(c, cman, cpage)
    index.remove(np.arange(0, 600, 3))
    snap = copy.copy(index)
    assert snap._rw is not index._rw and snap._core is index._core
    before = index.search(q, k=5, global_search=True)
    live = snap.compact()
    assert snap.n == len(live) == 400 and index.n == 600 and snap._core is not index._core
    assert_same_results(index.search(q, k=5, global_search=True), before)


@pytest.mark.parametrize("precision", PRECISIONS)
@pytest.mark.parametrize("writer", ["port", "tpualign"])
def test_artifacts_cross_load(tmp_path, precision, writer):
    c, cman, cpage, q = make_corpus(n=700, d=32)
    t, j = pair(c, cman, cpage, precision=precision)
    for index in (t, j):
        index.remove([5, 6, 600])
        index.calibrate(0.9, sample=16)
    path = tmp_path / "g.hnsw.npz"
    (t if writer == "port" else j).save(path)
    loaded = {"port": HNSWIndex.load(path, c), "tpualign": JaxHNSW.load(path, c)}
    for index in loaded.values():
        assert_same_index(index, t)
        assert index.calibrated_target == 0.9 and index.ef_search == t.ef_search
    for kw in (dict(global_search=True), dict(query_manuals=["m1"] * 32, query_pages=[2] * 32)):
        want = t.search(q, k=7, **kw)
        for index in loaded.values():
            assert_same_results(index.search(q, k=7, **kw), want)


def test_stale_and_corrupt_artifacts_rebuild_in_build_index(tmp_path):
    import tpualign_torch.parallel.hnsw as hnsw_mod

    c, cman, cpage, q = make_corpus(n=300, d=16)
    cache = tmp_path / "s.hnsw.npz"
    a = build_index(c, cman, cpage, index_type="hnsw", hnsw_cache=str(cache), device="cpu")
    assert isinstance(a, HNSWIndex) and cache.exists()
    builds = []
    orig = hnsw_mod.make_hnsw_core

    def spy(*args, **kw):
        builds.append(1)
        return orig(*args, **kw)

    hnsw_mod.make_hnsw_core = spy
    try:
        b = build_index(c, cman, cpage, index_type="hnsw", hnsw_cache=str(cache))
        assert not builds  # a matching artifact loads, no graph build
        assert_same_results(a.search(q, k=5, global_search=True),
                            b.search(q, k=5, global_search=True))
        for stale in (np.roll(c, 1, axis=0), c[:200]):  # another corpus: rebuilt, re-saved
            rebuilt = build_index(stale, cman[:len(stale)], cpage[:len(stale)],
                                  index_type="hnsw", hnsw_cache=str(cache))
            assert builds and rebuilt.n == len(stale)
            assert HNSWIndex.load(cache, stale).n == len(stale)
            builds.clear()
        cache.write_bytes(b"not a real npz file")
        idx = build_index(c, cman, cpage, index_type="hnsw", hnsw_cache=str(cache))
        assert builds and (idx.search(q[:2], k=3, global_search=True)[1] >= 0).all()
    finally:
        hnsw_mod.make_hnsw_core = orig
    assert HNSWIndex.load(cache, c).n == 300 and JaxHNSW.load(cache, c).n == 300


def test_build_index_matches_tpualigns_cache_handling(tmp_path):
    """The same sequence of ``build_index`` calls over one artifact path in
    each package: calibrate and save, reload, recalibrate down on a lowered
    target, reset to ef 40 with the target unset, and fp16 against fp32."""
    c, cman, cpage, q = make_corpus(n=4000, d=64)
    calls = [dict(recall_target=0.995), dict(recall_target=0.995), dict(recall_target=0.5),
             dict(), dict(precision="fp16"), dict(precision="fp16"), dict(precision="fp32"),
             dict(precision="int8"), dict(recall_target=0.9, hnsw_ef_search=33)]
    for pkg, fn in (("port", build_index), ("tpualign", jax_build_index)):
        cache = str(tmp_path / f"{pkg}.hnsw.npz")
        rows = []
        for kw in calls:
            index = fn(c, cman, cpage, index_type="hnsw", hnsw_cache=cache, **kw)
            rows.append((index.ef_search, getattr(index, "calibrated_target", None),
                         index.precision, index.n, index._core.serialize()))
        if pkg == "port":
            port_rows = rows
    assert port_rows == rows
    efs = [r[0] for r in rows]
    assert efs[0] > 40 and efs[1] == efs[0] and efs[2] < efs[0] and efs[3] == 40
    assert rows[3][1] is None and [r[2] for r in rows[4:8]] == ["fp16", "fp16", "fp32", "fp32"]
    assert efs[8] == 33 and rows[8][1] is None


def test_build_index_warns_as_tpualign(monkeypatch):
    import tpualign_torch.parallel.retrieval as retrieval_mod

    warnings = []
    monkeypatch.setattr(retrieval_mod.log, "warning",
                        lambda msg, *a: warnings.append(msg % a if a else msg))
    from tpualign_torch.parallel import create_mesh

    c, cman, cpage, _ = make_corpus(n=200)
    idx = build_index(c, cman, cpage, index_type="hnsw", precision="int8",
                      recall_target=0.95, hnsw_ef_search=33,
                      mesh=create_mesh(2, devices=["cpu"] * 2))
    msgs = " ".join(warnings)
    assert "fp32" in msgs and "halfvec" in msgs and "RETRIEVAL_RECALL_TARGET" in msgs
    assert "mesh is ignored" in msgs
    assert idx.ef_search == 33 and not hasattr(idx, "calibrated_target")
    # as tpualign: a mesh warns only for a data axis above 1
    warnings.clear()
    build_index(c, cman, cpage, index_type="hnsw", mesh=create_mesh(1, 2, devices=["cpu"] * 2))
    assert "mesh" not in " ".join(warnings)


def test_config_hnsw_keys_match_tpualigns():
    from tpualign.config import load_config as jax_load
    from tpualign_torch.config import load_config

    envs = [{}, {"RETRIEVAL_INDEX": "hnsw", "HNSW_M": "24", "HNSW_EF_CONSTRUCTION": "100",
                 "HNSW_EF_SEARCH": "64", "HNSW_CACHE": "/data/g.npz",
                 "RETRIEVAL_PRECISION": "fp16"}]
    for env in envs:
        got, want = load_config(env), jax_load(env_file=None, overrides=env)
        for key in ("retrieval_index", "retrieval_precision", "hnsw_m", "hnsw_ef_construction",
                    "hnsw_ef_search", "hnsw_cache"):
            assert getattr(got, key) == getattr(want, key), key
    base = load_config({})
    assert (base.hnsw_m, base.hnsw_ef_construction, base.hnsw_ef_search, base.hnsw_cache) == (
        16, 64, None, None)
    for bad in ({"HNSW_M": "x"}, {"HNSW_EF_SEARCH": "1.5"}):
        with pytest.raises(ValueError):
            load_config(bad)
        with pytest.raises(ValueError):
            jax_load(env_file=None, overrides=bad)


def test_fp16_precision_through_the_exact_index_is_refused_as_in_tpualign():
    c, cman, cpage, _ = make_corpus(n=64, d=16)
    with pytest.raises(ValueError) as got:
        build_index(c, cman, cpage, precision="fp16", device="cpu")
    with pytest.raises(ValueError) as want:
        jax_build_index(c, cman, cpage, precision="fp16")
    assert str(got.value) == str(want.value)


# -- tpualign's HNSW cases, on the port -----------------------------------------------


def test_global_recall_at_pgvector_defaults():
    c, cman, cpage, q = make_corpus()
    r40 = global_recall(HNSWIndex(c, cman, cpage), q, c)
    r120 = global_recall(HNSWIndex(c, cman, cpage, ef_search=120), q, c)
    assert r40 >= 0.7 and r120 >= 0.9 and r120 >= r40
    wide = HNSWIndex(c, cman, cpage, ef_search=40, refine=8)
    assert global_recall(wide, q, c) >= r40


@pytest.mark.parametrize("precision", PRECISIONS)
def test_selective_keyed_queries_are_exact(precision):
    c, cman, cpage, q = make_corpus(n=800)
    index = HNSWIndex(c, cman, cpage, precision=precision)
    vals, idx = index.search(q, ["m2"] * len(q), [3] * len(q), k=10)
    ck, vocab = encode_keys(cman, cpage, {})
    qk, _ = encode_keys(["m2"] * len(q), [3] * len(q), vocab)
    corpus = c if precision == "fp32" else c.astype(np.float16).astype(np.float32)
    ovals, oidx = numpy_oracle(q, qk, corpus, ck, 10)
    np.testing.assert_array_equal(idx, oidx)
    np.testing.assert_allclose(vals, ovals, rtol=0, atol=1e-5)


def test_add_remove_and_empty_bootstrap():
    c, cman, cpage, q = make_corpus(n=600)
    index = HNSWIndex(c, cman, cpage, ef_search=120)
    extra = unit(np.random.default_rng(7).normal(size=(40, c.shape[1])))
    index.add(extra, ["newman"] * 40, [1] * 40)
    assert index.n == 640 and "newman" in index.vocab
    vals, idx = index.search(extra[:3], ["newman"] * 3, [1] * 3, k=1)
    np.testing.assert_array_equal(idx[:, 0], [600, 601, 602])
    np.testing.assert_allclose(vals[:, 0], 1.0, atol=1e-5)
    _, pos = index.search(q[:1], k=1, global_search=True)
    target = int(pos[0, 0])
    assert index.remove([target]) == 1 and index.remove([target]) == 0
    assert index.live == 639 and index.dead == 1
    assert target not in index.search(q[:1], k=10, global_search=True)[1][0]
    assert target not in index.search(q[:1], [cman[target]], [cpage[target]], k=index.n)[1][0]

    empty = HNSWIndex(np.zeros((0, 16), np.float32), [], [])
    vals, idx = empty.search(np.ones((2, 16), np.float32), k=5, global_search=True)
    assert (idx == -1).all() and (vals == NEG_INF).all()
    rows = unit(np.random.default_rng(1).normal(size=(30, 16)))
    empty.add(rows, ["a"] * 30, [1] * 30)
    np.testing.assert_array_equal(empty.search(rows[:2], ["a"] * 2, [1] * 2, k=1)[1][:, 0], [0, 1])


def test_compact_rewrites_graph_over_survivors():
    c, cman, cpage, q = make_corpus(n=600)
    index = HNSWIndex(c, cman, cpage)
    gone = np.arange(0, 600, 13)
    assert index.remove(gone) == len(gone)
    mem0 = index.memory_bytes()
    live = index.compact()
    expect = np.setdiff1d(np.arange(600), gone)
    np.testing.assert_array_equal(live, expect)
    assert index.n == len(expect) == index.live and index.memory_bytes() < mem0
    ck, vocab = encode_keys([cman[i] for i in expect], [cpage[i] for i in expect], {})
    qk, _ = encode_keys(["m2"] * len(q), [3] * len(q), vocab)
    np.testing.assert_array_equal(index.search(q, ["m2"] * len(q), [3] * len(q), k=10)[1],
                                  numpy_oracle(q, qk, c[expect], ck, 10)[1])
    core0 = index._core
    assert len(index.compact()) == index.n and index._core is core0  # nothing dead: kept
    index.remove(np.arange(index.n))
    assert len(index.compact()) == 0 and index.n == 0
    index.add(c[:2], cman[:2], cpage[:2])
    assert int(index.search(c[:1], k=1, global_search=True)[1][0, 0]) == 0


def test_load_rejects_stale_and_corrupt_artifacts(tmp_path):
    c, cman, cpage, _ = make_corpus(n=120, d=16)
    path = tmp_path / "g.npz"
    HNSWIndex(c, cman, cpage).save(path)
    other = c.copy()
    other[0] += 1.0
    for corpus in (other, c[:100]):
        with pytest.raises(ValueError):
            HNSWIndex.load(path, corpus)
    with np.load(path) as z:
        blob = bytes(z["blob"])
        meta, keys, dead = bytes(z["meta"]), z["keys"], z["dead"]
    cases = {
        "truncated": blob[:len(blob) // 3],
        "bad_magic": b"\x00" * 8 + blob[8:],
        "neg_dim": blob[:8] + (-5).to_bytes(4, "little", signed=True) + blob[12:],
        "zero_efc": blob[:16] + (0).to_bytes(4, "little") + blob[20:],
        "max_level_bump": blob[:24] + (64).to_bytes(4, "little") + blob[28:],
        "huge_n": blob[:28] + (1 << 40).to_bytes(8, "little") + blob[36:],
        "garbage_tail": blob[:-64] + b"\xff" * 64,
    }
    for name, mutated in cases.items():
        bad = tmp_path / f"{name}.npz"
        np.savez_compressed(bad, blob=np.frombuffer(mutated, np.uint8),
                            meta=np.frombuffer(meta, np.uint8), keys=keys, dead=dead)
        with pytest.raises(ValueError):
            HNSWIndex.load(bad, c)


def test_deserializer_fuzz_never_crashes():
    from tpualign_torch.native.bindings import load_hnsw_core

    c, cman, cpage, _ = make_corpus(n=150, d=24)
    blob = HNSWIndex(c, cman, cpage)._core.serialize()
    rng = np.random.default_rng(42)
    rejected = 0
    for trial in range(200):
        mutated = bytearray(blob)
        kind = trial % 4
        if kind == 0:
            mutated = mutated[:int(rng.integers(0, len(blob)))]
        elif kind == 1:
            for _ in range(int(rng.integers(1, 8))):
                mutated[int(rng.integers(0, len(mutated)))] ^= int(rng.integers(1, 256))
        elif kind == 2:
            off = int(rng.integers(0, max(1, len(mutated) // 4 - 1))) * 4
            val = int(rng.choice([-1, 2**31 - 1, -(2**31), 2**20]))
            mutated[off:off + 4] = val.to_bytes(4, "little", signed=True)
        else:
            a, b = sorted(int(rng.integers(0, len(mutated))) for _ in "ab")
            mutated[a:b] = mutated[a:b][::-1]
        core = load_hnsw_core(bytes(mutated), 24, seed=0)
        if core is None:
            rejected += 1
        else:
            core.search(c[:2], np.full(2, -3, np.int64), 5, 40)
    assert rejected >= 100


def test_calibrate_caps_at_ef_max(monkeypatch):
    import tpualign_torch.parallel.hnsw as hnsw_mod

    warnings = []
    monkeypatch.setattr(hnsw_mod.log, "warning",
                        lambda msg, *a: warnings.append(msg % a if a else msg))
    monkeypatch.setattr(HNSWIndex, "EF_MAX", 64)
    c, cman, cpage, _ = make_corpus(n=4000, d=64)
    assert HNSWIndex(c, cman, cpage).calibrate(1.0) == 64
    assert any("unreachable" in m for m in warnings)
    with pytest.raises(ValueError):
        HNSWIndex(c[:10], None, None).calibrate(0.0)


def test_fp16_halves_memory_and_keeps_recall():
    c, cman, cpage, q = make_corpus(n=2500)
    f32 = HNSWIndex(c, cman, cpage, ef_search=120)
    f16 = HNSWIndex(c, cman, cpage, ef_search=120, precision="fp16")
    assert f16.memory_bytes() < 0.62 * f32.memory_bytes()
    assert global_recall(f16, q, c) >= global_recall(f32, q, c) - 0.05
    np.testing.assert_allclose(f16.search(q[:4], k=3, global_search=True)[0],
                               f32.search(q[:4], k=3, global_search=True)[0], atol=5e-3)
    with pytest.raises(ValueError, match="fp32' or 'fp16"):
        HNSWIndex(c, cman, cpage, precision="int8")


def test_concurrent_searches_bit_identical():
    c, cman, cpage, _ = make_corpus(seed=31, n=3000, d=32)
    q = unit(np.random.default_rng(7).normal(size=(64, 32)))
    index = HNSWIndex(c, cman, cpage, ef_search=80)
    qk = np.full(len(q), -3, np.int64)
    base_v, base_i = index.search_encoded(q, qk, k=10)
    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-4)
    try:
        for _ in range(3):
            with concurrent.futures.ThreadPoolExecutor(8) as ex:
                outs = [f.result() for f in [ex.submit(index.search_encoded, q[i::8], qk[i::8], 10)
                                             for i in range(8)]]
            for i, (v, ix) in enumerate(outs):
                np.testing.assert_array_equal(ix, base_i[i::8])
                np.testing.assert_array_equal(v, base_v[i::8])
    finally:
        sys.setswitchinterval(old)


def test_mutation_under_concurrent_search():
    rng = np.random.default_rng(43)
    d = 24
    base, extra = unit(rng.normal(size=(800, d))), unit(rng.normal(size=(400, d)))
    index = HNSWIndex(base, ["m"] * 800, [1] * 800, ef_search=64)
    errors: list = []
    stop = threading.Event()

    def searcher(seed):
        r = np.random.default_rng(seed)
        try:
            while not stop.is_set():
                q = unit(r.normal(size=(4, d)))
                vals, idx = index.search_encoded(q, np.full(4, -3, np.int64), 5)
                for row in range(4):
                    for v, j in zip(vals[row], idx[row]):
                        if j >= 0 and abs(float(index._corpus[j] @ q[row]) - float(v)) > 1e-3:
                            errors.append(f"score {v} at row {j}")
        except Exception as e:
            errors.append(f"{type(e).__name__}: {e}")

    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-4)
    threads = [threading.Thread(target=searcher, args=(s,), daemon=True) for s in range(4)]
    try:
        for t in threads:
            t.start()
        for i in range(0, 400, 40):
            index.add(extra[i:i + 40], ["m"] * 40, [1] * 40)
            index.remove(list(range(i // 2, i // 2 + 20)))
        stop.set()
        for t in threads:
            t.join(timeout=30)
        index.compact()
    finally:
        stop.set()
        sys.setswitchinterval(old)
    assert not errors, errors[:10]
    assert index.n == 1000 and index.dead == 0
    v, _ = index.search_encoded(extra[:1], np.asarray([-3], np.int64), 1)
    assert v[0, 0] > 0.99
