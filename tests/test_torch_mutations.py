"""The port's index mutations against the JAX package's, on the CPU:
``RetrievalIndex`` and ``IVFIndex`` ``add``/``remove``/``dead``/``compact``
over sequences of adds, removals, re-adds and compactions at fp32, int8,
int4 and int2, with and without refine; the refine corpus's
``appended``/``selected``/``empty`` in every store mode; the IVF layout slot
for slot; and copy-on-write under threads (searches racing adds and
compactions see the old or the new corpus, never a mix)."""

import sys
import threading

import numpy as np
import pytest

from tpualign.parallel import ivf as jax_ivf
from tpualign.parallel import retrieval as jax_retrieval
from tpualign_torch.parallel import retrieval as port_retrieval
from tpualign_torch.parallel.ivf import IVFIndex

pytestmark = pytest.mark.fast

PRECISIONS = ("fp32", "int8", "int4", "int2")
# tpualign's jitted quantized first stage takes the query scale as
# max|q| * fl(1/127) where the port divides (tests/test_torch_quant.py):
# unrefined quantized values may differ by an ulp or two of the scale.
# fp32 products sum in another order than XLA's (tests/test_torch_retrieval.py).
SCALE_ULPS = 2.5e-7
FP32_ATOL = 1e-6


def unit(x):
    return (x / np.linalg.norm(x, axis=-1, keepdims=True)).astype(np.float32)


def make_clustered(rng, n, d=16, g=4, noise=0.15):
    centers = unit(rng.normal(size=(g, d)))
    return unit(centers[rng.integers(g, size=n)] + noise * rng.normal(size=(n, d)))


def _corpus(seed=0, n=420, d=32):
    rng = np.random.default_rng(seed)
    emb = unit(rng.normal(size=(n, d)))
    emb[n - 5:] = emb[:5]                      # duplicated rows: exact ties
    manuals = [f"m{i % 3}" for i in range(n)]
    pages = [None if i % 7 == 0 else 1 + i % 4 for i in range(n)]
    return emb, manuals, pages


def _values(index) -> str:
    """How the index's values compare with tpualign's: refined values are
    rescored in float64 on the host, identically."""
    if index.refine > 1 and index.precision != "fp32":
        return "refined"
    return "fp32" if index.precision == "fp32" else "quantized"


def _same(got, want, values):
    (v, i), (jv, ji) = got, want
    np.testing.assert_array_equal(i, np.asarray(ji))
    if values == "refined":
        np.testing.assert_array_equal(v, np.asarray(jv))
    elif values == "fp32":
        np.testing.assert_allclose(v, np.asarray(jv), rtol=0, atol=FP32_ATOL)
    else:
        np.testing.assert_allclose(v, np.asarray(jv), rtol=SCALE_ULPS, atol=0)


def _queries(emb, manuals, pages, seed=1):
    rng = np.random.default_rng(seed)
    rows = rng.integers(0, len(emb), 24)
    q = unit(emb[rows] + 0.05 * rng.normal(size=(24, emb.shape[1])))
    return q, [manuals[r] for r in rows], [pages[r] for r in rows]


def _against_fresh(index, live_rows, live_ids, q, qm, qp, k, fresh=None, **kw):
    """The index's answers equal a fresh port build over its live rows
    (``fresh``, else an exact index), after the fresh build's ids are
    mapped back to the index's."""
    emb, man, pg = live_rows
    if fresh is None:
        fresh = port_retrieval.RetrievalIndex(emb, man, pg, device="cpu", **kw)
    for args in ((qm, qp), (None, None)):
        v, i = index.search(q, *args, k=k, global_search=args[0] is None)
        fv, fi = fresh.search(q, *args, k=k, global_search=args[0] is None)
        np.testing.assert_array_equal(i, np.where(fi >= 0, np.asarray(live_ids)[fi], -1))
        np.testing.assert_array_equal(v, fv)


@pytest.mark.parametrize("precision", PRECISIONS)
@pytest.mark.parametrize("refine", [0, 4])
def test_exact_mutations_match_jax_and_a_fresh_build(precision, refine):
    emb, manuals, pages = _corpus()
    n0 = 300
    kw = dict(precision=precision, refine=refine)
    port = port_retrieval.RetrievalIndex(emb[:n0], manuals[:n0], pages[:n0], device="cpu", **kw)
    ref = jax_retrieval.RetrievalIndex(emb[:n0], manuals[:n0], pages[:n0], **kw)
    values = _values(port)
    q, qm, qp = _queries(emb, manuals, pages)
    # the index's own rows, in id order, and which are alive
    rows, man, pg = list(emb[:n0]), list(manuals[:n0]), list(pages[:n0])
    alive = [True] * n0

    def check():
        assert port.n == ref.n == len(rows) and port.dead == ref.dead
        assert port.vocab == ref.vocab
        for k in (3, 10):
            _same(port.search(q, qm, qp, k=k), ref.search(q, qm, qp, k=k), values)
            _same(port.search(q, k=k, global_search=True),
                  ref.search(q, k=k, global_search=True), values)
        live = [i for i, a in enumerate(alive) if a]
        _against_fresh(port, (np.stack(rows)[live], [man[i] for i in live],
                              [pg[i] for i in live]), live, q, qm, qp, 5, **kw)

    def add(lo, hi, manuals_given=True):
        args = (manuals[lo:hi], pages[lo:hi]) if manuals_given else ()
        port.add(emb[lo:hi], *args)
        ref.add(emb[lo:hi], *args)
        rows.extend(emb[lo:hi])
        man.extend(manuals[lo:hi] if manuals_given else [None] * (hi - lo))
        pg.extend(pages[lo:hi] if manuals_given else [None] * (hi - lo))
        alive.extend([True] * (hi - lo))

    check()
    add(n0, 360)                                # grows past the build's rows
    assert port._corpus.shape[0] == 1024
    check()
    gone = [0, 4, 17, 299, 300, 359, 359, 10**6, -3]
    assert port.remove(gone) == ref.remove(gone) == 6
    assert port.remove([4]) == ref.remove([4]) == 0
    for i in set(gone) & set(range(len(alive))):
        alive[i] = False
    check()
    add(360, 420)                               # into the slack
    for r in (0, 4, 17):                        # re-adds take new ids
        port.add(emb[r:r + 1], manuals[r:r + 1], pages[r:r + 1])
        ref.add(emb[r:r + 1], manuals[r:r + 1], pages[r:r + 1])
        rows.append(emb[r])
        man.append(manuals[r])
        pg.append(pages[r])
        alive.append(True)
    check()
    live = port.compact()
    np.testing.assert_array_equal(live, np.asarray(ref.compact()))
    np.testing.assert_array_equal(live, np.flatnonzero(alive))
    rows, man, pg = [rows[i] for i in live], [man[i] for i in live], [pg[i] for i in live]
    alive = [True] * len(live)
    assert port._corpus.shape[0] == port.n
    check()
    np.testing.assert_array_equal(port.compact(), np.arange(port.n))  # nothing to reclaim
    if port._refine_corpus is not None:
        assert len(port._refine_corpus) == port.n
        np.testing.assert_array_equal(port._refine_corpus.take(np.arange(port.n)),
                                      ref._refine_corpus.take(np.arange(port.n)))


@pytest.mark.parametrize("precision", ["fp32", "int8"])
def test_exact_remove_everything_then_compact_and_regrow(precision):
    emb, manuals, pages = _corpus(n=40)
    kw = dict(precision=precision, refine=4)
    port = port_retrieval.RetrievalIndex(emb, manuals, pages, device="cpu", **kw)
    ref = jax_retrieval.RetrievalIndex(emb, manuals, pages, **kw)
    assert port.remove(range(40)) == ref.remove(range(40)) == 40
    assert port.dead == ref.dead == 40
    assert port.compact().size == np.asarray(ref.compact()).size == 0
    assert port.n == ref.n == 0 and port.dead == 0
    v, i = port.search(emb[:2], k=3, global_search=True)
    assert (i == -1).all()
    port.add(emb[:8], manuals[:8], pages[:8])
    ref.add(emb[:8], manuals[:8], pages[:8])
    _same(port.search(emb[:8], manuals[:8], pages[:8], k=3),
          ref.search(emb[:8], manuals[:8], pages[:8], k=3), _values(port))


@pytest.mark.parametrize("store", ["ram", "memmap"])
def test_empty_index_with_refine_builds_then_grows(store):
    """tests/test_refine_store.py's case on the port: an index built before
    any rows exist takes its refine corpus from the first add's rows."""
    port = port_retrieval.RetrievalIndex(np.zeros((0,), np.float32), [], [], device="cpu",
                                         precision="int8", refine=8, refine_store=store)
    ref = jax_retrieval.RetrievalIndex(np.zeros((0,), np.float32), [], [], precision="int8",
                                       refine=8, refine_store=store)
    assert port.n == ref.n == 0
    assert (port.search(np.zeros((2, 16), np.float32), k=3, global_search=True)[1] == -1).all()
    emb = np.random.default_rng(0).standard_normal((50, 16)).astype(np.float32)
    port.add(emb, ["m"] * 50, [1] * 50)
    ref.add(emb, ["m"] * 50, [1] * 50)
    assert len(port._refine_corpus) == 50
    _same(port.search(emb[:9], k=4, global_search=True),
          ref.search(emb[:9], k=4, global_search=True), "refined")
    assert int(port.search(emb[7:8], k=1, global_search=True)[1][0, 0]) == 7


def test_add_without_manuals_and_bad_shapes():
    emb, manuals, pages = _corpus(n=30)
    port = port_retrieval.RetrievalIndex(emb, manuals, pages, device="cpu")
    ref = jax_retrieval.RetrievalIndex(emb, manuals, pages)
    port.add(emb[:3])                                   # key 0
    ref.add(emb[:3])
    _same(port.search(emb[:3], k=4, global_search=True),
          ref.search(emb[:3], k=4, global_search=True), "fp32")
    for bad in (np.zeros((3,), np.float32), np.zeros((2, 7), np.float32)):
        with pytest.raises(ValueError):
            port.add(bad)
    port.add(np.zeros((0, 32), np.float32))
    assert port.n == 33


@pytest.mark.parametrize("mode", ["ram", "fp16", "memmap", "memmap16"])
def test_refine_corpus_append_select_empty_match_jax(mode, tmp_path, monkeypatch):
    monkeypatch.setenv("RETRIEVAL_REFINE_DIR", str(tmp_path))
    rng = np.random.default_rng(5)
    rows = rng.normal(size=(40, 8)).astype(np.float32)
    more = rng.normal(size=(7, 8)).astype(np.float32)
    got = port_retrieval._RefineCorpus.build(rows, mode)
    want = jax_retrieval._RefineCorpus.build(rows, mode)
    for step in (lambda c: c.appended(more), lambda c: c.appended(more).appended(more[:2]),
                 lambda c: c.appended(more).selected(np.arange(0, 47, 3)),
                 lambda c: c.appended(more).selected(np.arange(47) % 5 == 0),
                 lambda c: c.selected([]), lambda c: c.empty()):
        g, w = step(got), step(want)
        assert (g.mode, len(g), g.nbytes_resident) == (w.mode, len(w), w.nbytes_resident)
        idx = np.arange(len(g))[::-1]
        np.testing.assert_array_equal(g.take(idx), w.take(idx))
    assert len(got) == 40                               # immutable


# -- IVF ---------------------------------------------------------------------------------


def _layout_equal(port, ref):
    for name in ("n", "spill", "spill_blocks", "capacity", "n_lists", "vocab"):
        assert getattr(port, name) == getattr(ref, name), name
    for name in ("_emb", "_keys", "_ids"):
        np.testing.assert_array_equal(getattr(port, name).numpy(), np.asarray(getattr(ref, name)),
                                      err_msg=name)
    if port._scales is None:
        assert ref._scales is None
    else:
        np.testing.assert_array_equal(port._scales.numpy(), np.asarray(ref._scales))
    assert port.dead == ref.dead


@pytest.mark.parametrize("precision", PRECISIONS)
@pytest.mark.parametrize("refine", [0, 4])
def test_ivf_mutations_match_jax_layout_and_exact_search(precision, refine):
    rng = np.random.default_rng(81)
    n0, n = 2048, 2348
    c = make_clustered(rng, n)
    manuals = [f"m{i % 2}" for i in range(n)]
    pages = [1 + i % 3 for i in range(n)]
    kw = dict(n_lists=16, iters=4, capacity_factor=0.05, precision=precision,
              refine=refine if precision != "fp32" else 0)
    port = IVFIndex(c[:n0], manuals[:n0], pages[:n0], device="cpu", **kw)
    ref = jax_ivf.IVFIndex(c[:n0], manuals[:n0], pages[:n0], **kw)
    assert port.spill > 0
    q = unit(c[::29][:32] + 0.05 * rng.normal(size=(32, c.shape[1])))
    qm, qp = manuals[::29][:32], pages[::29][:32]
    rows, man, pg = list(c[:n0]), list(manuals[:n0]), list(pages[:n0])
    alive = [True] * n0
    values = _values(port)

    def check():
        _layout_equal(port, ref)
        p = port.n_lists
        for args in ((qm, qp), (None, None)):
            g = port.search(q, *args, k=6, n_probes=p, global_search=args[0] is None)
            w = ref.search(q, *args, k=6, n_probes=p, global_search=args[0] is None)
            _same(g, w, values if values == "refined" else "fp32")
        # full probe equals a fresh build over the live rows (full probes do
        # not depend on the lists), and at fp32 the exact index
        live = [i for i, a in enumerate(alive) if a]
        live_rows = (np.stack(rows)[live], [man[i] for i in live], [pg[i] for i in live])
        fresh = IVFIndex(*live_rows, device="cpu", **kw)
        _against_fresh(_FullProbe(port), live_rows, live, q, qm, qp, 6, _FullProbe(fresh))
        if precision == "fp32":
            _against_fresh(_FullProbe(port), live_rows, live, q, qm, qp, 6)
        # a probed search agrees with the exact index's ranking among the
        # rows it can see: every winner is a live row of the query's key
        v, i = port.search(q, qm, qp, k=6)
        assert np.isin(i[i >= 0], live).all() and np.isfinite(v).all()

    check()
    tot0 = port._ids.shape[0]
    port.add(c[n0:n0 + 200], manuals[n0:n0 + 200], pages[n0:n0 + 200])
    ref.add(c[n0:n0 + 200], manuals[n0:n0 + 200], pages[n0:n0 + 200])
    rows += list(c[n0:n0 + 200])
    man += manuals[n0:n0 + 200]
    pg += pages[n0:n0 + 200]
    alive += [True] * 200
    assert port._ids.shape[0] > tot0, "the spill tail must have grown"
    check()
    gone = np.arange(0, len(rows), 37)
    assert port.remove(gone) == ref.remove(gone) == len(gone)
    assert port.remove(gone[:3]) == ref.remove(gone[:3]) == 0
    for i in gone:
        alive[i] = False
    check()
    for lo, hi in ((n0 + 200, n0 + 260), (0, 1), (37, 38)):   # re-adds take new ids
        port.add(c[lo:hi], manuals[lo:hi], pages[lo:hi])
        ref.add(c[lo:hi], manuals[lo:hi], pages[lo:hi])
        rows += list(c[lo:hi])
        man += manuals[lo:hi]
        pg += pages[lo:hi]
        alive += [True] * (hi - lo)
    check()
    live = port.compact()
    np.testing.assert_array_equal(live, np.asarray(ref.compact()))
    np.testing.assert_array_equal(live, np.flatnonzero(alive))
    rows, man, pg = [rows[i] for i in live], [man[i] for i in live], [pg[i] for i in live]
    alive = [True] * len(live)
    check()
    port.add(c[n0 + 260:], manuals[n0 + 260:], pages[n0 + 260:])   # adds after a re-pack
    ref.add(c[n0 + 260:], manuals[n0 + 260:], pages[n0 + 260:])
    rows += list(c[n0 + 260:])
    man += manuals[n0 + 260:]
    pg += pages[n0 + 260:]
    alive += [True] * (n - n0 - 260)
    check()
    assert port._corpus_fp is None


class _FullProbe:
    """An IVF index whose searches probe every list (exact)."""

    def __init__(self, index):
        self.index = index

    def search(self, q, manuals, pages, k, global_search=False):
        return self.index.search(q, manuals, pages, k=k, n_probes=self.index.n_lists,
                                 global_search=global_search)


@pytest.mark.parametrize("precision", ["fp32", "int8", "int4", "int2"])
def test_ivf_probed_search_after_mutations_matches_jax_kernel_route(precision, monkeypatch):
    """Probed searches (the port's K4 route) against tpualign's kernel
    route, which it takes on a TPU, over a grown, tombstoned and compacted
    layout."""
    monkeypatch.setattr(jax_ivf.IVFIndex, "_kernel_path",
                        lambda self, exact_ties, k: not exact_ties and k <= 64)
    monkeypatch.setattr(jax_retrieval, "_int8_mxu_override", True)
    rng = np.random.default_rng(7)
    c = make_clustered(rng, 1400)
    kw = dict(n_lists=16, iters=4, capacity_factor=0.05, precision=precision)
    port = IVFIndex(c[:1100], device="cpu", **kw)
    ref = jax_ivf.IVFIndex(c[:1100], **kw)
    q = unit(c[::41][:24] + 0.05 * rng.normal(size=(24, c.shape[1])))
    for step in (lambda x: x.add(c[1100:]), lambda x: x.remove(np.arange(0, 1400, 5)),
                 lambda x: x.compact()):
        step(port)
        step(ref)
        _layout_equal(port, ref)
        for p in (2, 5):
            v, i = port.search(q, k=8, n_probes=p, global_search=True)
            jv, ji = ref.search(q, k=8, n_probes=p, global_search=True)
            np.testing.assert_array_equal(i, np.asarray(ji))
            np.testing.assert_allclose(v, np.asarray(jv), rtol=SCALE_ULPS, atol=1e-6)


def test_ivf_remove_readd_and_compact_refusals():
    rng = np.random.default_rng(95)
    c = unit(rng.normal(size=(400, 32)))
    man = [f"m{i % 3}" for i in range(400)]
    page = [1 + i % 4 for i in range(400)]
    port = IVFIndex(c, man, page, n_lists=8, iters=4, device="cpu")
    ref = jax_ivf.IVFIndex(c, man, page, n_lists=8, iters=4)
    assert port.remove([0, 1, 2, 999999, -5]) == ref.remove([0, 1, 2, 999999, -5]) == 3
    assert port.remove([0]) == 0
    _, i1 = port.search(c[:3], man[:3], page[:3], k=3, n_probes=port.n_lists)
    assert not np.isin(i1, [0, 1, 2]).any()
    port.add(c[:1], man[:1], page[:1])
    ref.add(c[:1], man[:1], page[:1])
    _layout_equal(port, ref)
    assert port.search(c[:1], man[:1], page[:1], k=2, n_probes=port.n_lists)[1][0, 0] == 400
    with pytest.raises(ValueError, match="must be"):
        port.add(np.zeros((2, 8), np.float32))
    port.add(np.zeros((0, 32), np.float32))
    assert port.n == 401
    small = IVFIndex(c[:16], n_lists=8, iters=2, device="cpu")
    small.remove(range(16))
    with pytest.raises(ValueError, match="empty"):
        small.compact()
    assert small.n == 16 and small.dead == 16


def test_ivf_refine_add_extends_host_copy():
    rng = np.random.default_rng(47)
    c = make_clustered(rng, 192, d=32)
    q = unit(c[:20] + 0.01 * rng.normal(size=(20, 32)))
    kw = dict(n_lists=8, iters=4, precision="int8", refine=8)
    port = IVFIndex(c[:160], ["m"] * 160, [1] * 160, device="cpu", **kw)
    ref = jax_ivf.IVFIndex(c[:160], ["m"] * 160, [1] * 160, **kw)
    port.add(c[160:], ["m"] * 32, [1] * 32)
    ref.add(c[160:], ["m"] * 32, [1] * 32)
    assert len(port._refine_corpus) == 192
    _same(port.search(q, ["m"] * 20, [1] * 20, 6, n_probes=8),
          ref.search(q, ["m"] * 20, [1] * 20, 6, n_probes=8), "refined")


# -- copy-on-write ---------------------------------------------------------------------


def _race(index, mutate, check, threads=4):
    """Run ``check`` in ``threads`` threads while ``mutate`` runs; returns
    the errors the checks saw."""
    errors, stop = [], threading.Event()
    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-5)

    def loop(seed):
        rng = np.random.default_rng(seed)
        try:
            while not stop.is_set():
                check(rng)
        except Exception as e:  # a shape mismatch, an IndexError
            errors.append(f"{type(e).__name__}: {e}")

    workers = [threading.Thread(target=loop, args=(s,), daemon=True) for s in range(threads)]
    try:
        for t in workers:
            t.start()
        mutate()
    finally:
        stop.set()
        for t in workers:
            t.join(timeout=60)
        sys.setswitchinterval(old)
    return errors


@pytest.mark.parametrize("kind", ["exact-int8", "exact-fp32", "ivf-int8"])
def test_searches_racing_mutations_see_one_corpus(kind):
    """Each one-hot query matches exactly one row with score 1. Searches
    run while rows are appended (through growth), victims tombstoned and
    the index compacted on a shallow copy whose fields are then swapped in
    whole, as the service does: every search must return its row, under
    the numbering of the snapshot it searched."""
    n_victims, n_searched = 96, 24
    d = n_searched + 8
    emb = np.zeros((n_victims + 2 * n_searched, d), np.float32)
    emb[:n_victims, n_searched] = 1.0
    emb[n_victims:n_victims + n_searched, :n_searched] = np.eye(n_searched)
    emb[n_victims + n_searched:, n_searched + 1] = 1.0        # rows added later
    base = emb[:n_victims + n_searched]
    precision = "fp32" if kind == "exact-fp32" else "int8"
    if kind.startswith("ivf"):
        state = {"index": IVFIndex(base, n_lists=4, iters=2, device="cpu", precision=precision)}
    else:
        state = {"index": port_retrieval.RetrievalIndex(base, ["m"] * len(base),
                                                       [1] * len(base), device="cpu",
                                                       precision=precision)}
    # the searched rows' ids in the current numbering, swapped with the index
    state["ids"] = np.arange(n_victims, n_victims + n_searched)

    def check(rng):
        snap = dict(state)
        i = int(rng.integers(n_searched))
        q = emb[n_victims + i:n_victims + i + 1]
        if kind.startswith("ivf"):
            v, idx = snap["index"].search(q, k=1, n_probes=4, global_search=True)
        else:
            v, idx = snap["index"].search(q, k=1, global_search=True)
        assert idx[0, 0] == snap["ids"][i] and v[0, 0] > 0.99, (i, idx, v)

    def mutate():
        import copy

        index = state["index"]
        for j in range(n_searched):                # adds: growth and slack writes
            index.add(emb[n_victims + n_searched + j:n_victims + n_searched + j + 1])
        for lo in range(0, n_victims, 8):
            index = state["index"]
            index.remove(np.arange(lo, lo + 8) - lo)  # the victims sit first
            fresh = copy.copy(index)
            live = fresh.compact()
            new_ids = np.searchsorted(live, state["ids"])
            state.update(index=fresh, ids=new_ids)   # one swap, as the service's

    errors = _race(state["index"], mutate, check)
    assert not errors, errors[:5]
    assert state["index"].n == n_searched * 2
