"""The port's serving path against the JAX package's, on the CPU: config
keys, the weak-score rerank, RetrievalService (with an encoder that is a
fixed numpy projection) at fp32 and at int8 with refine, the coalescer
under 8 threads, the HTTP routes and limits, and the ``query`` CLI."""

import base64
import io
import json
import os
import subprocess
import sys
import threading
import urllib.error
import urllib.request
from types import SimpleNamespace

import numpy as np
import pytest

import tpualign.config as jax_config
import tpualign_torch.config as torch_config
import tpualign.parallel.ivf as jax_ivf
import tpualign.parallel.retrieval as jax_retrieval
from tpualign.serving import RetrievalService as JaxService
from tpualign.serving.server import index_kwargs as jax_index_kwargs
from tpualign.serving.server import make_image_bytes_encoder as jax_image_encoder
from tpualign.store import EmbeddingStore as JaxStore
from tpualign.weaksup.rerank import build_weak_lookup as jax_lookup
from tpualign.weaksup.rerank import rerank_with_weak_scores as jax_rerank
from tpualign_torch.serving import RetrievalService, serve
from tpualign_torch.serving.server import index_kwargs, make_image_bytes_encoder
from tpualign_torch.weaksup.rerank import build_weak_lookup, rerank_with_weak_scores

pytestmark = pytest.mark.fast

D = 32
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SERVE_FIELDS = ("retrieval_recall_target", "retrieval_index", "retrieval_precision",
                "retrieval_refine", "retrieval_refine_store", "text_buckets",
                "serve_coalesce_ms", "serve_query_cache", "serve_token", "serve_idle_timeout",
                "serve_max_body_bytes", "serve_max_connections", "serve_request_deadline",
                "serve_auto_compact", "batch_size", "seed", "ivf_lists", "ivf_probes",
                "ivf_cache")


@pytest.mark.parametrize("overrides", [
    {},
    {"RETRIEVAL_PRECISION": "int4", "RETRIEVAL_REFINE": "4", "RETRIEVAL_REFINE_STORE": "memmap",
     "RETRIEVAL_RECALL_TARGET": "0.95", "STORE_DIR": "/data/s", "SERVE_COALESCE_MS": "off",
     "SERVE_QUERY_CACHE": "0", "SERVE_TOKEN": "t", "SERVE_IDLE_TIMEOUT": "5",
     "SERVE_MAX_BODY_BYTES": "1000", "SERVE_MAX_CONNECTIONS": "3",
     "SERVE_REQUEST_DEADLINE": "2.5", "SERVE_AUTO_COMPACT": "0.2", "TEXT_BUCKETS": "off",
     "SEED": "7", "RETRIEVAL_INDEX": "ivf", "IVF_LISTS": "64", "IVF_PROBES": "9",
     "IVF_CACHE": "/data/g.ivf.npz"},
])
def test_serve_config_matches_jax(overrides, tmp_path, monkeypatch):
    monkeypatch.chdir(tmp_path)
    want = jax_config.load_config(env_file=None, overrides=overrides)
    got = torch_config.load_config(overrides)
    for name in SERVE_FIELDS:
        assert getattr(got, name) == getattr(want, name), name
    assert got.store.root == want.store.root
    assert index_kwargs(got, "vanilla_clip") == jax_index_kwargs(want, "vanilla_clip")


def test_config_env_file_and_validation(tmp_path):
    env = tmp_path / "x.env"
    env.write_text('RETRIEVAL_PRECISION="int2"  # comment\nSERVE_QUERY_CACHE=7 # c\n')
    got = torch_config.load_config(env_file=str(env))
    want = jax_config.load_config(env_file=str(env))
    assert (got.retrieval_precision, got.serve_query_cache) == ("int2", 7)
    assert (want.retrieval_precision, want.serve_query_cache) == ("int2", 7)
    for bad in ("0", "1.5"):
        with pytest.raises(ValueError, match="SERVE_AUTO_COMPACT"):
            torch_config.load_config({"SERVE_AUTO_COMPACT": bad})


def test_rerank_matches_jax():
    rng = np.random.default_rng(3)
    vals = np.sort(rng.random((5, 8)).astype(np.float32), axis=1)[:, ::-1].copy()
    idx = rng.integers(0, 30, (5, 8))
    idx[2, 5:] = -1
    vals[2, 5:] = -1e30
    vals[1, 3] = vals[1, 4]                        # a tie
    chunk_ids = [f"c{i}" for i in range(30)]
    aligns = [(f"q{r}", f"c{c}", float(rng.random()), t) for r in range(5)
              for c in rng.integers(0, 30, 6) for t in ("lexical", "positional")]
    lookup = build_weak_lookup(aligns)
    assert lookup == jax_lookup(aligns)
    for alpha in (0.0, 0.3, 1.0):
        got = rerank_with_weak_scores(vals, idx, [f"q{r}" for r in range(5)], chunk_ids,
                                      lookup, alpha)
        want = jax_rerank(vals, idx, [f"q{r}" for r in range(5)], chunk_ids, lookup, alpha)
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g, w)
    with pytest.raises(ValueError, match="alpha"):
        rerank_with_weak_scores(vals, idx, ["q"] * 5, chunk_ids, lookup, 1.5)


_W = np.random.default_rng(11).normal(size=(64, D)).astype(np.float32)


def encoder(texts):
    """A fixed numpy projection of character counts, unit rows."""
    feats = np.zeros((len(texts), 64), np.float32)
    for i, t in enumerate(texts):
        for ch in t:
            feats[i, ord(ch) % 64] += 1.0
    out = feats @ _W + 1e-3
    return out / np.linalg.norm(out, axis=1, keepdims=True)


class _Engine:
    """Stands in for the image tower: a fixed projection of the pixels."""

    variant = SimpleNamespace(image_size=16)
    _P = np.random.default_rng(12).normal(size=(16 * 16 * 3, D)).astype(np.float32)

    def encode_image_batch(self, images):
        out = np.asarray(images, np.float32).reshape(len(images), -1) @ self._P
        return out / np.linalg.norm(out, axis=1, keepdims=True)


def _png(seed):
    from PIL import Image

    buf = io.BytesIO()
    pixels = np.random.default_rng(seed).integers(0, 256, (30, 40, 3), dtype=np.uint8)
    Image.fromarray(pixels).save(buf, format="PNG")
    return buf.getvalue()


def _corpus(n=240):
    rng = np.random.default_rng(0)
    emb = rng.normal(size=(n, D)).astype(np.float32)
    emb[-4:] = emb[:4]
    emb /= np.linalg.norm(emb, axis=1, keepdims=True)
    ids = [f"c{i}" for i in range(n)]
    manuals = [f"m{i % 3}" for i in range(n)]
    pages = [i % 5 for i in range(n)]
    images = [{"image_id": f"img{j}", "manual_id": f"m{j % 3}", "page": j % 5}
              for j in range(12)]
    img_emb = rng.normal(size=(12, D)).astype(np.float32)
    img_emb /= np.linalg.norm(img_emb, axis=1, keepdims=True)
    aligns = [(f"img{j}", f"c{c}", float(rng.random()), "positional") for j in range(12)
              for c in rng.integers(0, n, 5)]
    return emb, ids, manuals, pages, images, img_emb, aligns


def _services(precision="fp32", refine=0, coalesce=2.0, **kw):
    emb, ids, manuals, pages, images, img_emb, aligns = _corpus()
    common = dict(schema="vanilla_clip", text_encoder=encoder, images=images,
                  image_embeddings=img_emb, precision=precision, refine=refine,
                  coalesce_window_ms=coalesce, **kw)
    port = RetrievalService(emb, ids, manuals, pages, weak_lookup=build_weak_lookup(aligns),
                            image_encoder=make_image_bytes_encoder(_Engine()), device="cpu",
                            **common)
    ref = JaxService(emb, ids, manuals, pages, weak_lookup=jax_lookup(aligns),
                     image_encoder=jax_image_encoder(_Engine()), **common)
    return port, ref, emb, manuals, pages


def _same_rows(got, want, exact, rtol=0.0):
    assert [[h["chunk_id"] for h in r] for r in got] == [[h["chunk_id"] for h in r] for r in want]
    for r, w in zip(got, want):
        np.testing.assert_allclose([h["score"] for h in r], [h["score"] for h in w],
                                   rtol=rtol, atol=0 if exact else 1e-6)


@pytest.mark.parametrize("precision,refine", [("fp32", 0), ("int8", 0), ("int8", 4),
                                              ("int2", 4)])
def test_service_matches_jax(precision, refine):
    port, ref, emb, manuals, pages = _services(precision, refine)
    # refined scores are exact rescores: bit-identical. Unrefined quantized
    # scores may differ by an ulp or two of the query scale (XLA turns
    # tpualign's / 127 into * fl(1/127) under jit; tests/test_torch_quant.py).
    # fp32 products sum in another order: within 1e-6.
    exact = precision != "fp32"
    rtol = 2.5e-7 if exact and refine <= 1 else 0.0
    q = emb[10:14] + 0.05

    def _same_rows_(got, want):
        _same_rows(got, want, exact, rtol)

    for k in (3, 10):
        _same_rows_(port.search_embeddings(q, manuals[10:14], pages[10:14], k=k),
                   ref.search_embeddings(q, manuals[10:14], pages[10:14], k=k))
        _same_rows_(port.search_embeddings(q, None, None, k=k, global_search=True),
                   ref.search_embeddings(q, None, None, k=k, global_search=True))
    for alpha in (None, 0.3):
        _same_rows_(port.search_images(["img1", "img7"], k=6, rerank_alpha=alpha),
                   ref.search_images(["img1", "img7"], k=6, rerank_alpha=alpha))
    _same_rows_(port.search_images(["img2"], k=5, global_search=True),
               ref.search_images(["img2"], k=5, global_search=True))
    texts = ["replace the filter", "de pomp", "replace the filter"]
    first = port.search_text(texts, k=4)
    _same_rows_(first, ref.search_text(texts, k=4))
    again = port.search_text(["de pomp"], k=4)                  # a cache hit
    assert again == [first[1]] and port.stats()["query_cache"]["hits"] == 1
    blobs = [_png(1), _png(2)]
    _same_rows_(port.search_image_bytes(blobs, k=5), ref.search_image_bytes(blobs, k=5))
    st, jst = port.stats(), ref.stats()
    for key in ("corpus_size", "dim", "precision", "refine", "num_images", "text_search",
                "image_search", "image_query", "dead_rows"):
        assert st[key] == jst[key], key
    assert (st["refine_store"] is None) == (jst["refine_store"] is None)
    with pytest.raises(KeyError):
        port.search_images(["nope"])


@pytest.fixture
def jax_as_on_tpu(monkeypatch):
    """tpualign's IVF routed as on its TPU: the K4 kernel (interpret mode)
    for probed k <= 64, int8 as s8 products: the port's routes."""
    monkeypatch.setattr(jax_ivf.IVFIndex, "_kernel_path",
                        lambda self, exact_ties, k: not exact_ties and k <= 64)
    monkeypatch.setattr(jax_retrieval, "_int8_mxu_override", True)


@pytest.mark.parametrize("precision,refine", [("fp32", 0), ("int8", 4), ("int4", 0)])
def test_ivf_service_matches_jax(precision, refine, jax_as_on_tpu):
    """RETRIEVAL_INDEX=ivf: the same answers and the same /stats ivf block
    as tpualign's service over the same rows."""
    port, ref, emb, manuals, pages = _services(precision, refine, index_type="ivf",
                                               ivf_lists=8, ivf_probes=3)
    # quantized first-stage values: an ulp or two of the query scale apart
    # (tpualign's jitted search multiplies by fl(1/127)); refined values are
    # exact rescores; fp32 products sum in another order
    exact = precision != "fp32"
    rtol = 2.5e-7 if exact and refine <= 1 else 0.0
    q = emb[10:14] + 0.05
    for k in (3, 10):
        _same_rows(port.search_embeddings(q, manuals[10:14], pages[10:14], k=k),
                   ref.search_embeddings(q, manuals[10:14], pages[10:14], k=k), exact, rtol)
        _same_rows(port.search_embeddings(q, None, None, k=k, global_search=True),
                   ref.search_embeddings(q, None, None, k=k, global_search=True), exact, rtol)
    _same_rows(port.search_images(["img1", "img7"], k=6, rerank_alpha=0.3),
               ref.search_images(["img1", "img7"], k=6, rerank_alpha=0.3), exact, rtol)
    _same_rows(port.search_text(["de pomp", "replace the filter"], k=4),
               ref.search_text(["de pomp", "replace the filter"], k=4), exact, rtol)
    st, jst = port.stats(), ref.stats()
    assert st["index"] == jst["index"] == "IVFIndex"
    assert st["ivf"] == jst["ivf"] and st["ivf"]["n_probes"] == 3


def test_coalescer_under_threads_equals_serial():
    """8 threads of keyed and global searches through the coalescer give
    what serial searches without it give."""
    port, _, emb, manuals, pages = _services("int4", 4, coalesce=5.0)
    serial, _, _, _, _ = _services("int4", 4, coalesce=None)
    jobs = [(emb[i:i + 1 + i % 3] * 0.9, manuals[i:i + 1 + i % 3], pages[i:i + 1 + i % 3],
             3 + i % 5, i % 2 == 0) for i in range(40)]
    got = [None] * len(jobs)

    def worker(t):
        for j in range(t, len(jobs), 8):
            q, m, p, k, g = jobs[j]
            got[j] = port.search_embeddings(q, None if g else m, None if g else p, k=k,
                                            global_search=g)

    threads = [threading.Thread(target=worker, args=(t,)) for t in range(8)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    for j, (q, m, p, k, g) in enumerate(jobs):
        assert got[j] == serial.search_embeddings(q, None if g else m, None if g else p, k=k,
                                                  global_search=g)
    stats = port.stats()["coalescer"]
    assert stats["batched_queries"] == sum(len(j[0]) for j in jobs)
    assert stats["dispatches"] <= len(jobs)


@pytest.fixture
def http_service():
    port, _, emb, manuals, pages = _services("int8", 4)
    httpd = serve(port, host="127.0.0.1", port=0, max_body_bytes=20_000)
    thread = threading.Thread(target=httpd.serve_forever, daemon=True)
    thread.start()
    yield f"http://127.0.0.1:{httpd.server_address[1]}", port, emb, manuals, pages
    httpd.shutdown()
    httpd.server_close()
    thread.join()


def _post(url, body, headers=None):
    data = body if isinstance(body, bytes) else json.dumps(body).encode()
    req = urllib.request.Request(url, data=data,
                                 headers={"Content-Type": "application/json", **(headers or {})})
    with urllib.request.urlopen(req, timeout=60) as r:
        return json.loads(r.read())


def _status(fn):
    with pytest.raises(urllib.error.HTTPError) as exc:
        fn()
    return exc.value.code, json.loads(exc.value.read())


def test_http_routes(http_service):
    base, svc, emb, manuals, pages = http_service
    with urllib.request.urlopen(f"{base}/healthz", timeout=30) as r:
        assert json.loads(r.read()) == {"status": "ok", "schema": "vanilla_clip"}
    out = _post(f"{base}/search", {"embeddings": emb[5:6].tolist(), "manuals": [manuals[5]],
                                   "pages": [pages[5]], "k": 3})
    assert out["results"] == svc.search_embeddings(emb[5:6], [manuals[5]], [pages[5]], k=3)
    assert out["results"][0][0]["chunk_id"] == "c5"
    out = _post(f"{base}/search_image", {"image_ids": ["img3"], "k": 4, "rerank": 0.3})
    assert out["results"] == svc.search_images(["img3"], k=4, rerank_alpha=0.3)
    out = _post(f"{base}/search_image_bytes",
                {"images_b64": [base64.b64encode(_png(5)).decode()], "k": 2})
    assert out["results"] == svc.search_image_bytes([_png(5)], k=2)
    out = _post(f"{base}/search_text", {"texts": ["filter"], "k": 2})
    assert len(out["results"][0]) == 2
    with urllib.request.urlopen(f"{base}/stats", timeout=30) as r:
        st = json.loads(r.read())
    assert st["precision"] == "int8" and st["refine"] == 4
    assert st["metrics"]["requests"]["/search"] == 1
    assert _status(lambda: _post(f"{base}/search", {"nope": 1}))[0] == 400
    assert _status(lambda: _post(f"{base}/search_image", {"image_ids": ["x"]}))[0] == 400
    assert _status(lambda: _post(f"{base}/bogus", {}))[0] == 404
    assert _status(lambda: urllib.request.urlopen(f"{base}/nope", timeout=30))[0] == 404


@pytest.mark.parametrize("route", ["/add", "/remove", "/sync", "/compact", "/reload"])
def test_http_mutations_answer_501(http_service, route):
    base = http_service[0]
    code, body = _status(lambda: _post(f"{base}{route}", {"chunk_ids": ["c1"]}))
    assert code == 501 and "not yet ported" in body["error"]


def test_http_body_limit(http_service):
    base, _, emb, _, _ = http_service
    big = {"embeddings": np.zeros((200, D)).tolist(), "global": True}
    code, body = _status(lambda: _post(f"{base}/search", big))
    assert code == 413 and "SERVE_MAX_BODY_BYTES" in body["error"]


def test_http_bearer_token():
    port, _, emb, _, _ = _services()
    httpd = serve(port, host="127.0.0.1", port=0, token="s3cret")
    thread = threading.Thread(target=httpd.serve_forever, daemon=True)
    thread.start()
    base = f"http://127.0.0.1:{httpd.server_address[1]}"
    try:
        with urllib.request.urlopen(f"{base}/healthz", timeout=30) as r:
            assert json.loads(r.read())["status"] == "ok"
        assert _status(lambda: urllib.request.urlopen(f"{base}/stats", timeout=30))[0] == 401
        body = {"embeddings": emb[1:2].tolist(), "global": True, "k": 1}
        for hdrs in ({}, {"Authorization": "Bearer wrong"}, {"Authorization": "s3cret"}):
            assert _status(lambda: _post(f"{base}/search", body, hdrs))[0] == 401
        out = _post(f"{base}/search", body, {"Authorization": "Bearer s3cret"})
        assert out["results"][0][0]["chunk_id"] == "c1"
    finally:
        httpd.shutdown()
        httpd.server_close()
        thread.join()


@pytest.fixture(scope="module")
def jax_store(tmp_path_factory):
    """A store written by the JAX package, for both CLIs."""
    root = tmp_path_factory.mktemp("store")
    emb, ids, manuals, pages, images, img_emb, aligns = _corpus(n=600)
    store = JaxStore(root, embed_dim=D)
    store.setup(["vanilla_clip"])
    store.insert_chunks("vanilla_clip", [
        {"chunk_id": c, "manual_id": m, "page": p, "text": f"text of {c}"}
        for c, m, p in zip(ids, manuals, pages)], emb)
    store.insert_images("vanilla_clip", [dict(im, caption=f"cap {im['image_id']}")
                                         for im in images], img_emb)
    store.insert_alignments("vanilla_clip", aligns)
    store.save()
    return root


def _cli(package, root, tmp_path, *args, **env):
    run_env = dict(os.environ, STORE_DIR=str(root), PYTHONPATH=REPO, JAX_PLATFORMS="cpu",
                   CLIP_MODEL="ViT-B-32", **env)
    extra = ["--device", "cpu"] if package == "tpualign_torch" else []
    return subprocess.run([sys.executable, "-m", package, "query", *args, *extra],
                          capture_output=True, text=True, timeout=300, cwd=tmp_path, env=run_env)


@pytest.mark.parametrize("refine,extra", [("0", ()), ("4", ("--rerank", "0.4"))])
def test_query_image_id_cli_matches_jax(jax_store, tmp_path, refine, extra):
    args = ("--image-id", "img4", "-k", "7", *extra)
    env = dict(RETRIEVAL_PRECISION="int8", RETRIEVAL_REFINE=refine)
    got = _cli("tpualign_torch", jax_store, tmp_path, *args, **env)
    want = _cli("tpualign", jax_store, tmp_path, *args, **env)
    assert got.returncode == 0, got.stderr
    assert want.returncode == 0, want.stderr
    assert got.stdout.splitlines()[0] == "top-7 chunks for img4:"
    ids = [[line.split()[1] for line in out.stdout.splitlines()[1:]] for out in (got, want)]
    assert len(ids[0]) == 7 and ids[0] == ids[1]
    if refine == "4":   # refined scores are exact rescores: the printout is identical
        assert got.stdout == want.stdout


def test_query_text_cli_matches_jax(jax_store, monkeypatch, capsys):
    """``query --text`` over fp32 images (K2's route), both CLIs in-process
    with the text encoder replaced by the same projection."""
    import tpualign.cli as jax_cli
    import tpualign.parallel.embed as jax_embed
    import tpualign_torch.cli as torch_cli
    import tpualign_torch.serving.server as torch_server

    tower = SimpleNamespace(encode_text_batch=encoder)
    monkeypatch.setattr(jax_embed, "EmbedEngine", lambda *a, **k: tower)
    monkeypatch.setattr(torch_server, "make_engine", lambda *a, **k: tower)
    monkeypatch.setenv("STORE_DIR", str(jax_store))
    argv = ["query", "--text", "replace the filter", "-k", "5", "--env-file", ""]
    assert jax_cli.main(argv) == 0
    want = capsys.readouterr().out
    assert torch_cli.main(argv + ["--device", "cpu"]) == 0
    assert capsys.readouterr().out == want
    assert want.startswith("top-5 images for 'replace the filter':")


def test_cli_needs_cuda_unless_cpu_is_asked(jax_store, tmp_path):
    out = subprocess.run(
        [sys.executable, "-c",
         "import torch; torch.cuda.is_available = lambda: False\n"
         "import sys; from tpualign_torch.cli import main\n"
         "sys.exit(main(['query', '--image-id', 'img4']))"],
        capture_output=True, text=True, timeout=300, cwd=tmp_path,
        env=dict(os.environ, STORE_DIR=str(jax_store), PYTHONPATH=REPO))
    assert out.returncode != 0 and "CUDA is not available" in out.stderr
    out = subprocess.run([sys.executable, "-m", "tpualign_torch", "evaluate"],
                         capture_output=True, text=True, timeout=300, cwd=tmp_path,
                         env=dict(os.environ, PYTHONPATH=REPO))
    assert out.returncode == 2 and "not yet ported" in out.stdout


def test_index_cli_then_query_matches_jax(jax_store, tmp_path, monkeypatch, capsys):
    """``index`` writes the artifact (the same JSON line as ``tpualign
    index``); ``query --image-id`` then searches through it, as tpualign's
    CLI does over the same artifact."""
    import tpualign.cli as jax_cli
    import tpualign_torch.cli as torch_cli

    monkeypatch.setenv("STORE_DIR", str(jax_store))
    monkeypatch.setenv("RETRIEVAL_INDEX", "ivf")
    monkeypatch.setenv("RETRIEVAL_PRECISION", "fp32")
    monkeypatch.setenv("RETRIEVAL_REFINE", "0")
    monkeypatch.setenv("IVF_LISTS", "8")
    monkeypatch.setenv("RETRIEVAL_RECALL_TARGET", "0.9")
    lines = []
    for main, cache, extra in ((torch_cli.main, "port", ["--device", "cpu"]),
                               (jax_cli.main, "jax", [])):
        path = str(tmp_path / f"{cache}.vanilla_clip.ivf.npz")
        assert main(["index", "--env-file", "", "--cache", path, *extra]) == 0
        lines.append(json.loads(capsys.readouterr().out.strip().splitlines()[-1]))
        assert lines[-1]["cache"] == path and os.path.exists(path)
    assert {**lines[0], "cache": None} == {**lines[1], "cache": None}
    assert lines[0]["index"] == "ivf" and lines[0]["calibrated_target"] == 0.9
    # both CLIs query through the port's artifact
    monkeypatch.setenv("IVF_CACHE", str(tmp_path / "port.vanilla_clip.ivf.npz"))
    argv = ["query", "--image-id", "img4", "-k", "6", "--env-file", ""]
    assert torch_cli.main(argv + ["--device", "cpu"]) == 0
    got = capsys.readouterr().out
    assert jax_cli.main(argv) == 0
    want = capsys.readouterr().out
    assert got.splitlines()[0] == "top-6 chunks for img4:" and "no prebuilt" not in got
    ids = [[line.split()[1] for line in out.splitlines()[1:]] for out in (got, want)]
    assert len(ids[0]) == 6 and ids[0] == ids[1]
