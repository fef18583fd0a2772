"""The port's live corpus against the JAX package's, on the CPU: the
service's mutations (``add_chunks``, ``add_chunks_text``, ``add_images``,
``remove_chunks``, ``compact``, auto-compaction) and ``_ServiceBox``'s
``sync``/``reload`` give tpualign's answers and ``/stats``; searches racing
adds and compactions stay consistent; ``fetch_snapshot`` and ``/sync`` over
a store; ``Pipeline.ingest_cycle`` over the golden corpus plus an added
manual gives tpualign's store rows and ``metrics.json``; ``watch``,
``notify_sync`` and the CLI's ``ingest``/``watch``."""

import json
import shutil
import sys
import threading
import urllib.request

import numpy as np
import pytest

from tests.test_golden import Sha256Engine
from tests.test_pipeline import png
from tests.test_torch_pipeline import _overrides, _raw
from tests.test_torch_serving import _same_rows, _services, jax_as_on_tpu  # noqa: F401 (a fixture)
from tpualign import config as jax_config
from tpualign.data.backends import write_synthetic_document
from tpualign.pipeline import Pipeline as JaxPipeline
from tpualign.pipeline import notify_sync as jax_notify_sync
from tpualign.serving import build_service as jax_build_service
from tpualign.serving import serve as jax_serve
from tpualign.serving.server import _ServiceBox as JaxBox
from tpualign.serving.server import fetch_snapshot as jax_fetch_snapshot
from tpualign_torch import cli as torch_cli
from tpualign_torch import config as torch_config
from tpualign_torch import pipeline as torch_pipeline
from tpualign_torch.pipeline import Pipeline, notify_sync
from tpualign_torch.serving import RetrievalService, build_service, fetch_snapshot, serve
from tpualign_torch.serving.server import _ServiceBox
from tpualign_torch.store import SCHEMAS, EmbeddingStore

pytestmark = pytest.mark.fast

STATS = ("corpus_size", "dead_rows", "num_images", "precision", "refine", "auto_compact",
         "index", "dim")


def _stats(svc):
    st = svc.stats()
    out = {k: st[k] for k in STATS}
    if "ivf" in st:
        out["ivf"] = st["ivf"]
    return out


def _both_answer(port, ref, q, manuals, pages, values):
    exact = values != "fp32"
    rtol = 2.5e-7 if values == "quantized" else 0.0
    for k in (3, 8):
        _same_rows(port.search_embeddings(q, manuals, pages, k=k),
                   ref.search_embeddings(q, manuals, pages, k=k), exact, rtol)
        _same_rows(port.search_embeddings(q, None, None, k=k, global_search=True),
                   ref.search_embeddings(q, None, None, k=k, global_search=True), exact, rtol)
    images = ["img1", "img7"] + (["new-img0"] if "new-img0" in port._images else [])
    for alpha in (None, 0.4):
        _same_rows(port.search_images(images, k=6, rerank_alpha=alpha),
                   ref.search_images(images, k=6, rerank_alpha=alpha), exact, rtol)
    _same_rows(port.search_text(["replace the filter", "de pomp"], k=4),
               ref.search_text(["replace the filter", "de pomp"], k=4), exact, rtol)
    assert _stats(port) == _stats(ref)
    assert port.live_chunk_ids() == ref.live_chunk_ids()


@pytest.mark.parametrize("index_type,precision,refine", [
    ("exact", "fp32", 0), ("exact", "int8", 4), ("exact", "int2", 0), ("ivf", "fp32", 0),
    ("ivf", "int8", 4)])
def test_service_mutations_match_jax(index_type, precision, refine, jax_as_on_tpu):
    kw = dict(index_type=index_type, ivf_lists=8, ivf_probes=3) if index_type == "ivf" else {}
    port, ref, emb, manuals, pages = _services(precision, refine, coalesce=None, **kw)
    values = ("refined" if refine > 1 else "fp32" if precision == "fp32" else "quantized")
    rng = np.random.default_rng(31)
    new = rng.normal(size=(30, emb.shape[1])).astype(np.float32)
    new /= np.linalg.norm(new, axis=1, keepdims=True)
    q, qm, qp = np.concatenate([emb[10:14] + 0.05, new[:3]]), manuals[10:14] + ["m9"] * 3, \
        pages[10:14] + [1] * 3
    metas = [{"image_id": f"new-img{j}", "manual_id": "m9", "page": 1} for j in range(2)]
    steps = [
        lambda s: s.add_chunks([f"n{i}" for i in range(20)], ["m9"] * 20, [1] * 20, new[:20]),
        lambda s: s.add_chunks_text(["t0", "t1"], ["m1", "m9"], [2, 1],
                                    ["replace the filter", "nieuwe pomp"]),
        lambda s: s.add_images(metas, new[20:22]),
        lambda s: s.add_images(metas, new[20:22]),                 # known: skipped
        lambda s: s.remove_chunks(["c3", "n4", "nope", "c3"]),
        lambda s: s.add_chunks(["n4"], ["m9"], [1], new[4:5]),     # a re-add resurrects
        lambda s: s.compact(),
        lambda s: s.remove_chunks([f"c{i}" for i in range(100, 160)]),
        lambda s: setattr(s, "auto_compact", 0.2) or s.remove_chunks(["n1", "t1"]),
        lambda s: s.remove_chunks([]),
    ]
    for step in steps:
        got, want = step(port), step(ref)
        assert got == want
        _both_answer(port, ref, q, qm, qp, values)
    assert port.index.dead == 0 and port.index.n == ref.index.n


@pytest.mark.parametrize("index_type", ["exact", "ivf"])
def test_service_box_sync_and_reload_match_jax(index_type, jax_as_on_tpu):
    kw = dict(index_type=index_type, ivf_lists=8, ivf_probes=8) if index_type == "ivf" else {}
    port, ref, emb, manuals, pages = _services("int8", 4, coalesce=None, **kw)
    rng = np.random.default_rng(41)
    new = rng.normal(size=(6, emb.shape[1])).astype(np.float32)
    new /= np.linalg.norm(new, axis=1, keepdims=True)
    ids = [f"c{i}" for i in range(len(emb))]
    chunks = (ids[2:] + [f"s{i}" for i in range(6)], manuals[2:] + ["m0"] * 6,
              pages[2:] + [0] * 6, np.concatenate([emb[2:], new]))
    full = {"chunk_ids": chunks[0], "manuals": chunks[1], "pages": chunks[2],
            "embeddings": chunks[3], "images": [{"image_id": "img-s", "manual_id": "m0",
                                                 "page": 0}],
            "image_embeddings": new[:1], "weak_lookup": {("img-s", "s0"): 0.9}}
    boxes = []
    for svc, box_cls, other in ((port, _ServiceBox, 0), (ref, JaxBox, 1)):
        fetches = iter([chunks, full, full])
        boxes.append(box_cls(svc, rebuild=lambda o=other: _services("int8", 4, coalesce=None,
                                                                    **kw)[o],
                             fetch=lambda f=fetches: next(f)))
    for call in ("sync", "sync", "sync"):
        got, want = getattr(boxes[0], call)(), getattr(boxes[1], call)()
        assert got == want
        _same_rows(port.search_embeddings(new, None, None, k=5, global_search=True),
                   ref.search_embeddings(new, None, None, k=5, global_search=True), True)
        if "img-s" in ref._images:
            _same_rows(port.search_images(["img-s"], k=3), ref.search_images(["img-s"], k=3),
                       True)
        assert port.weak_lookup == ref.weak_lookup
    metrics = boxes[0].service.metrics
    got, want = boxes[0].reload(), boxes[1].reload()
    assert {k: got[k] for k in STATS} == {k: want[k] for k in STATS}
    assert boxes[0].service is not port and boxes[0].service.metrics is metrics
    for box in (_ServiceBox(port), JaxBox(ref)):
        for call in (box.sync, box.reload):
            with pytest.raises(RuntimeError, match="not configured"):
                call()


def _post(base, path, payload=None):
    req = urllib.request.Request(f"{base}{path}", json.dumps(payload or {}).encode(),
                                 {"Content-Type": "application/json"})
    with urllib.request.urlopen(req, timeout=60) as r:
        return json.loads(r.read())


def _http_error(fn):
    with pytest.raises(urllib.error.HTTPError) as exc:
        fn()
    return exc.value.code, json.loads(exc.value.read())


def test_http_mutation_routes_match_jax(jax_as_on_tpu):
    """The five routes' bodies and status codes, tpualign's: /add by
    embeddings and by texts (400 on mismatched lengths), /remove, /compact
    (400 when it would empty an IVF index), /sync and /reload (500 with
    ``synced``/``reloaded`` false when unconfigured or failing)."""
    results = []
    for which, server in ((0, serve), (1, jax_serve)):
        svc = _services("int8", 4, index_type="ivf", ivf_lists=4, ivf_probes=4,
                        coalesce=None)[which]
        emb = np.asarray(svc._image_embs)
        httpd = server(svc, host="127.0.0.1", port=0, fetch=lambda: (_ for _ in ()).throw(
            OSError("store unreadable")))
        threading.Thread(target=httpd.serve_forever, daemon=True).start()
        base = f"http://127.0.0.1:{httpd.server_address[1]}"
        seen = []
        try:
            seen.append(_post(base, "/add", {"chunk_ids": ["a0", "a1"], "manuals": ["m0"] * 2,
                                             "pages": [0, 0], "embeddings": emb[:2].tolist()}))
            seen.append(_post(base, "/add", {"chunk_ids": ["a2"], "manuals": ["m0"],
                                             "pages": [0], "texts": ["de pomp"]}))
            seen.append(_http_error(lambda: _post(base, "/add", {
                "chunk_ids": ["a", "b"], "manuals": ["m"], "pages": [1], "texts": ["x"]}))[0])
            seen.append(_post(base, "/remove", {"chunk_ids": ["a1", "zz"]}))
            seen.append(_post(base, "/compact"))
            seen.append(_post(base, "/search", {"embeddings": emb[:1].tolist(), "k": 3,
                                                "global": True})["results"])
            code, body = _http_error(lambda: _post(base, "/sync"))
            seen.append((code, body["synced"], body["error"]))
            code, body = _http_error(lambda: _post(base, "/reload"))
            seen.append((code, body["reloaded"]))
            svc.remove_chunks(list(svc.live_chunk_ids()))
            code, body = _http_error(lambda: _post(base, "/compact"))
            seen.append((code, "empty" in body["error"]))
            stats = json.loads(urllib.request.urlopen(f"{base}/stats", timeout=30).read())
            seen.append({k: stats[k] for k in ("corpus_size", "dead_rows")})
            seen.append({k: stats["metrics"]["requests"].get(k) for k in
                         ("/add", "/remove", "/compact")})
            seen.append(stats["metrics"]["errors"])
        finally:
            httpd.shutdown()
            httpd.server_close()
        results.append(seen)
    for got, want in zip(*results):
        if isinstance(got, list) and got and isinstance(got[0], list):
            _same_rows(got, want, True)
        else:
            assert got == want


def test_concurrent_adds_and_searches():
    """tests/test_serving.py's case on the port: adds racing searches, on
    the direct index path, growth included; every search sees one
    corpus, and every added chunk is found afterwards."""
    import concurrent.futures

    rng = np.random.default_rng(17)
    n, d = 64, 16
    emb = rng.normal(size=(n + 160, d)).astype(np.float32)
    emb /= np.linalg.norm(emb, axis=1, keepdims=True)
    svc = RetrievalService(emb[:n], [f"c{i}" for i in range(n)], ["m0"] * n, [1] * n,
                           coalesce_window_ms=None, precision="int8", refine=4, device="cpu")

    def adder(j):
        s = n + j * 16
        svc.add_chunks([f"c{i}" for i in range(s, s + 16)], ["m0"] * 16, [1] * 16,
                       emb[s:s + 16])

    def searcher(j):
        res = svc.search_embeddings(emb[j % n:j % n + 1], ["m0"], [1], k=3)
        assert res[0][0]["chunk_id"] == f"c{j % n}"

    jobs = [(adder, j) for j in range(10)] + [(searcher, j) for j in range(40)]
    rng.shuffle(jobs)
    with concurrent.futures.ThreadPoolExecutor(max_workers=8) as ex:
        for f in [ex.submit(fn, j) for fn, j in jobs]:
            f.result()
    assert svc.index.n == n + 160
    for s in range(n, n + 160, 40):
        assert svc.search_embeddings(emb[s:s + 1], ["m0"], [1], k=1)[0][0]["chunk_id"] == f"c{s}"


@pytest.mark.parametrize("mode", ["explicit", "auto", "coalesced", "ivf", "refine_memmap"])
def test_compact_under_concurrent_searches(mode, tmp_path, monkeypatch):
    """tests/test_serving.py's case on the port (HNSW is not ported): the
    searched chunks sit behind victim rows that every compaction removes,
    so a search formatted against the wrong snapshot returns a wrong id."""
    monkeypatch.setenv("RETRIEVAL_REFINE_DIR", str(tmp_path))
    n_victims, n_searched = 120, 32
    d = n_searched + 1
    emb = np.zeros((n_victims + n_searched, d), np.float32)
    emb[:n_victims, n_searched] = 1.0
    emb[n_victims:, :n_searched] = np.eye(n_searched, dtype=np.float32)
    ids = [f"v{i}" for i in range(n_victims)] + [f"s{i}" for i in range(n_searched)]
    n = len(ids)
    kw = {}
    if mode == "ivf":
        kw = {"index_type": "ivf", "ivf_lists": 4, "ivf_probes": 4}
    elif mode == "refine_memmap":
        kw = {"precision": "int8", "refine": 4, "refine_store": "memmap"}
    svc = RetrievalService(emb, ids, ["m"] * n, [1] * n,
                           coalesce_window_ms=0.0 if mode == "coalesced" else None,
                           auto_compact=0.001 if mode == "auto" else None, device="cpu", **kw)
    errors, stop = [], threading.Event()
    old_switch = sys.getswitchinterval()
    sys.setswitchinterval(1e-4)

    def searcher(seed):
        rng = np.random.default_rng(seed)
        try:
            while not stop.is_set():
                i = int(rng.integers(n_searched))
                hit = svc.search_embeddings(emb[n_victims + i:n_victims + i + 1], None, None,
                                            k=1, global_search=True)[0][0]
                if hit["chunk_id"] != f"s{i}" or hit["score"] < 0.5:
                    errors.append(f"query s{i} -> {hit['chunk_id']} ({hit['score']:.3f})")
        except Exception as e:
            errors.append(f"{type(e).__name__}: {e}")

    threads = [threading.Thread(target=searcher, args=(s,), daemon=True) for s in range(4)]
    try:
        for t in threads:
            t.start()
        removed = 0
        while removed + 3 <= n_victims and not errors:
            svc.remove_chunks([f"v{i}" for i in range(removed, removed + 3)])
            if mode != "auto":
                svc.compact()
            removed += 3
    finally:
        stop.set()
        for t in threads:
            t.join(timeout=30)
        sys.setswitchinterval(old_switch)
    assert not errors, errors[:10]
    assert svc.index.n == n - removed
    res = svc.search_embeddings(emb[n_victims:], None, None, k=1, global_search=True)
    assert [r[0]["chunk_id"] for r in res] == [f"s{i}" for i in range(n_searched)]


def _write_store(root, store_cls, lo, hi, images, emb):
    store = store_cls(root, embed_dim=emb.shape[1])
    store.setup(["vanilla_clip"])
    store.insert_chunks("vanilla_clip", [
        {"chunk_id": f"c{k}", "manual_id": "m", "page": 1, "bbox": [0, 0, 1, 1],
         "text": f"t{k}"} for k in range(lo, hi)], emb[lo:hi])
    store.insert_images("vanilla_clip", [
        {"image_id": f"i{j}", "manual_id": "m", "page": 1, "bbox": [0, 0, 1, 1],
         "bbox_source": "native", "caption": None, "filename": None,
         "image_type": "raster_image"} for j in range(images)], emb[:images])
    store.save(["vanilla_clip"])


def test_sync_applies_store_delta_as_tpualign(tmp_path):
    """tests/test_serving.py's ``/sync`` case, both packages over one store:
    ``fetch_snapshot`` equals tpualign's, and ``/sync`` adds the store's new
    chunks and image, idempotently."""
    rng = np.random.default_rng(21)
    emb = rng.normal(size=(8, 512)).astype(np.float32)
    emb /= np.linalg.norm(emb, axis=1, keepdims=True)
    root = tmp_path / "store"
    _write_store(root, EmbeddingStore, 0, 5, 1, emb)
    overrides = {"STORE_DIR": str(root)}
    cfg = torch_config.load_config(overrides)
    jcfg = jax_config.load_config(env_file=None, overrides=overrides)
    svcs = [build_service(cfg, "vanilla_clip", text_tower=False, device="cpu"),
            jax_build_service(jcfg, "vanilla_clip", text_tower=False)]
    servers = [serve(svcs[0], port=0, fetch=lambda: fetch_snapshot(cfg, "vanilla_clip")),
               jax_serve(svcs[1], port=0, fetch=lambda: jax_fetch_snapshot(jcfg, "vanilla_clip"))]
    for srv in servers:
        threading.Thread(target=srv.serve_forever, daemon=True).start()
    bases = [f"http://127.0.0.1:{srv.server_address[1]}" for srv in servers]
    try:
        _write_store(root, EmbeddingStore, 0, 8, 2, emb)      # an ingest cycle's delta
        got, want = fetch_snapshot(cfg, "vanilla_clip"), jax_fetch_snapshot(jcfg, "vanilla_clip")
        assert got.keys() == want.keys()
        for key in got:
            if key.endswith("embeddings"):
                np.testing.assert_array_equal(got[key], want[key])
            else:
                assert got[key] == want[key], key
        for _ in range(2):
            outs = [_post(b, "/sync") for b in bases]
            assert outs[0] == outs[1]
        assert outs[0] == {"synced": True, "added": 0, "removed": 0, "images_added": 0,
                           "corpus_size": 8}
        for path, body in (("/search", {"embeddings": emb[6:7].tolist(), "k": 2,
                                        "manuals": ["m"], "pages": [1]}),
                           ("/search_image", {"image_ids": ["i1"], "k": 2})):
            # fp32 products sum in another order than XLA's: within 1e-6
            _same_rows(_post(bases[0], path, body)["results"],
                       _post(bases[1], path, body)["results"], False)
    finally:
        for srv in servers:
            srv.shutdown()
            srv.server_close()


def test_notify_sync_as_tpualign(tmp_path):
    """``notify_sync`` posts ``/sync`` with the bearer token and survives a
    dead daemon, as tpualign's does."""
    port, ref, emb, manuals, pages = _services("fp32", 0, coalesce=None)
    snap = ([f"c{i}" for i in range(len(emb))] + ["x"], manuals + ["m0"], pages + [0],
            np.concatenate([emb, emb[:1]]))
    srv = serve(port, port=0, fetch=lambda: snap, token="tok")
    threading.Thread(target=srv.serve_forever, daemon=True).start()
    base = f"http://127.0.0.1:{srv.server_address[1]}"
    try:
        assert notify_sync(base) is None                      # 401 without the token
        out = notify_sync(base + "/", token="tok")
        assert out == {"synced": True, "added": 1, "removed": 0, "images_added": 0,
                       "corpus_size": len(emb) + 1}
        assert jax_notify_sync(base, token="tok")["added"] == 0
    finally:
        srv.shutdown()
        srv.server_close()
    assert notify_sync("http://127.0.0.1:1/", timeout=2) is None
    assert jax_notify_sync("http://127.0.0.1:1/", timeout=2) is None


def _new_manual(raw, name="manual2", color=(9, 99, 9), words="nieuwe onderdelen lijst"):
    write_synthetic_document(raw / f"{name}.synthdoc.json", [{
        "width": 612, "height": 792,
        "images": [{"data": png(color), "ext": "png", "rects": [[10, 10, 90, 90]]}],
        "drawings": [],
        "words": [{"text": t, "x0": 50 + 60 * i, "x1": 100 + 60 * i, "top": 300,
                   "bottom": 310} for i, t in enumerate(words.split())]}])


def _same_stores(port_root, jax_root):
    from tpualign.store import EmbeddingStore as JaxStore

    ps, js = EmbeddingStore(port_root, embed_dim=32), JaxStore(jax_root, embed_dim=32)
    for schema in SCHEMAS:
        assert ps.counts(schema) == js.counts(schema), schema
        for table in ("images", "text_chunks"):
            pi, pe = ps.embedding_matrix(schema, table)
            ji, je = js.embedding_matrix(schema, table)
            assert list(pi) == list(ji), (schema, table)
            np.testing.assert_array_equal(pe, je)
        assert ps.alignments(schema) == js.alignments(schema), schema
        assert ps.chunks(schema) == js.chunks(schema), schema


def test_ingest_cycle_matches_jax(tmp_path):
    """``ingest_cycle`` over the golden corpus and then one added manual:
    the same summaries, processed files, store rows and ``metrics.json`` as
    tpualign's; an interrupted cycle (manifest ahead of the store) heals."""
    overrides = _raw(tmp_path)
    jroot = tmp_path / "jax"
    jroot.mkdir()
    shutil.copytree(tmp_path / "raw", jroot / "raw")
    (jroot / "exclude.txt").write_text("pagina\n")
    pipe = Pipeline(torch_config.load_config(overrides), engine=Sha256Engine(), device="cpu")
    jpipe = JaxPipeline(jax_config.load_config(env_file=None, overrides=_overrides(jroot)),
                        engine=Sha256Engine())
    for p in (pipe, jpipe):
        p.store.embed_dim = Sha256Engine.dim

    def cycle(evaluate=False):
        got, want = pipe.ingest_cycle(evaluate=evaluate), jpipe.ingest_cycle(evaluate=evaluate)
        assert got == want
        return got

    assert len(cycle()["ingested"]) == 2                      # a fresh store: everything
    assert cycle()["ingested"] == []
    for root in (tmp_path, jroot):
        _new_manual(root / "raw")
    s = cycle(evaluate=True)
    assert s["ingested"] == ["manual2.synthdoc.json"] and s["skipped_unchanged"] == 2
    for name in ("image_metadata.json", "text_chunks.json", "filtered_lexical_components.json"):
        assert (json.loads((tmp_path / "processed" / name).read_text())
                == json.loads((jroot / "processed" / name).read_text())), name
    _same_stores(tmp_path / "store", jroot / "store")
    got = json.loads((tmp_path / "eval" / "metrics.json").read_text())
    want = json.loads((jroot / "eval" / "metrics.json").read_text())
    assert got.keys() == want.keys()
    for schema in want:
        assert got[schema]["num_pairs"] == want[schema]["num_pairs"]
        np.testing.assert_allclose(got[schema]["mrr"], want[schema]["mrr"], atol=1e-6)
        for k in want[schema]["top_k"]:
            np.testing.assert_allclose(got[schema]["top_k"][k], want[schema]["top_k"][k],
                                       atol=1e-6)
    # an interrupted cycle: the manifest records manual3, the store does not
    from tpualign.data.processor import DocumentProcessor as JaxProcessor
    from tpualign_torch.data.processor import DocumentProcessor

    for root, proc_cls, p in ((tmp_path, DocumentProcessor, pipe),
                              (jroot, JaxProcessor, jpipe)):
        _new_manual(root / "raw", "manual3", (1, 2, 3), "herstel")
        proc_cls(p.config.data, nlp=p._nlp,
                 lexical_fallback=p._lexical_fallback).process_incremental()
        assert not p._store_in_sync()
    assert cycle()["ingested"] == []                          # heals by re-embedding
    assert pipe._store_in_sync() and jpipe._store_in_sync()
    _same_stores(tmp_path / "store", jroot / "store")


def test_watch_notifies_a_daemon_as_tpualign(tmp_path):
    """``watch`` with ``max_cycles`` and ``notify``: a cycle that ingests
    posts ``/sync``, and the daemon then serves the new manual's chunks; a
    cycle that ingests nothing posts nothing; a failing cycle is logged
    and the loop goes on."""
    overrides = _raw(tmp_path)
    cfg = torch_config.load_config(overrides)
    pipe = Pipeline(cfg, engine=Sha256Engine(), device="cpu")
    pipe.store.embed_dim = Sha256Engine.dim
    pipe.ingest_cycle()
    store = EmbeddingStore(cfg.store.root, embed_dim=Sha256Engine.dim)
    ids, emb = store.embedding_matrix("vanilla_clip", "text_chunks")
    svc = RetrievalService(emb, ids, store.column("vanilla_clip", "text_chunks", "manual_id"),
                           store.column("vanilla_clip", "text_chunks", "page"),
                           coalesce_window_ms=None, device="cpu")
    syncs = []

    def fetch():
        syncs.append(1)
        return fetch_snapshot(cfg, "vanilla_clip")

    srv = serve(svc, port=0, fetch=fetch)
    threading.Thread(target=srv.serve_forever, daemon=True).start()
    base = f"http://127.0.0.1:{srv.server_address[1]}"
    try:
        pipe.watch(interval_seconds=0.0, max_cycles=2, notify=base)
        assert syncs == []                                    # nothing new: no sync
        _new_manual(tmp_path / "raw")
        pipe.watch(interval_seconds=0.0, max_cycles=2, notify=base)
        assert syncs == [1]
        fresh = EmbeddingStore(cfg.store.root, embed_dim=Sha256Engine.dim)
        assert svc.index.n == fresh.counts("vanilla_clip")["text_chunks"] > len(ids)
        assert svc.live_chunk_ids() == set(fresh.embedding_matrix("vanilla_clip",
                                                                  "text_chunks")[0])
    finally:
        srv.shutdown()
        srv.server_close()

    def broken(evaluate=False):
        raise RuntimeError("disk full")

    calls = []
    pipe.ingest_cycle = lambda evaluate=False: calls.append(1) or broken()
    pipe.watch(interval_seconds=0.0, max_cycles=3)
    assert calls == [1, 1, 1]


def test_cli_ingest_and_watch(tmp_path, monkeypatch, capsys):
    """``python -m tpualign_torch ingest --notify`` and ``watch
    --max-cycles`` in process, as tpualign's: the summary line, the
    ``/sync`` to the daemon, and a bounded watch."""
    overrides = _raw(tmp_path)
    monkeypatch.chdir(tmp_path)
    for key, value in overrides.items():
        monkeypatch.setenv(key, value)
    monkeypatch.setattr(torch_pipeline.Pipeline, "engine", Sha256Engine())
    assert torch_cli.main(["ingest", "--device", "cpu"]) == 0
    assert capsys.readouterr().out.strip().endswith("ingested 2 file(s); 0 unchanged")
    cfg = torch_config.load_config(overrides)
    synced = []
    svc = RetrievalService(np.zeros((0, 32), np.float32), [], [], [], coalesce_window_ms=None,
                           device="cpu")
    srv = serve(svc, port=0, fetch=lambda: synced.append(1) or fetch_snapshot(cfg,
                                                                           "vanilla_clip"))
    threading.Thread(target=srv.serve_forever, daemon=True).start()
    base = f"http://127.0.0.1:{srv.server_address[1]}"
    try:
        _new_manual(tmp_path / "raw")
        assert torch_cli.main(["ingest", "--notify", base, "--device", "cpu"]) == 0
        assert capsys.readouterr().out.strip().endswith("ingested 1 file(s); 2 unchanged")
        assert synced == [1]
        assert svc.index.n == EmbeddingStore(cfg.store.root, embed_dim=32).counts(
            "vanilla_clip")["text_chunks"]
        assert torch_cli.main(["watch", "--interval", "0", "--max-cycles", "2", "--notify",
                               base, "--device", "cpu"]) == 0
        assert synced == [1]
    finally:
        srv.shutdown()
        srv.server_close()
