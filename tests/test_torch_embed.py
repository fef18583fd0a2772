"""The slice as a whole on the CPU: both packages' EmbedEngines over the
same PNG image records and chunk records with the same (tiny, fp32)
weights, then both RetrievalIndexes over the same embeddings."""

import dataclasses

import numpy as np
import pytest

import jax
import jax.numpy as jnp
from PIL import Image

from tests.test_models import TINY
from tpualign import config as jax_config
from tpualign.models.clip import CLIP as JaxCLIP
from tpualign.models.clip import init_clip_params as jax_init
from tpualign.parallel.embed import EmbedEngine as JaxEngine
from tpualign.parallel.retrieval import RetrievalIndex as JaxIndex
from tpualign_torch import config as torch_config
from tpualign_torch.parallel import EmbedEngine, RetrievalIndex

pytestmark = pytest.mark.fast

# a 77-token context so the 16/32/77 text buckets all take rows
TINY77 = dataclasses.replace(TINY, name="tiny", context_length=77)


@pytest.fixture
def engines(monkeypatch):
    monkeypatch.setitem(jax_config.CLIP_VARIANTS, "tiny", TINY77)
    monkeypatch.setitem(torch_config.CLIP_VARIANTS, "tiny",
                        torch_config.ClipVariant(**dataclasses.asdict(TINY77)))
    params = jax_init(JaxCLIP(variant=TINY77, compute_dtype=jnp.float32), seed=0)
    ref = JaxEngine(jax_config.ModelConfig("tiny", parity_mode=True), batch_size=4,
                    params=params)
    port = EmbedEngine(torch_config.ModelConfig("tiny", parity_mode=True), batch_size=4,
                       params=jax.tree.map(np.asarray, params), device="cpu",
                       decode_workers=2)
    return port, ref


def _image_records(tmp_path):
    rng = np.random.default_rng(0)
    records = []
    for i, (h, w) in enumerate([(40, 50), (32, 32), (20, 64), (64, 33), (35, 35), (50, 40)]):
        arr = rng.integers(0, 256, (h, w, 3), dtype=np.uint8)
        Image.fromarray(arr).save(tmp_path / f"img{i}.png")
        records.append({"image_id": f"img-{i}", "filename": f"img{i}.png",
                        "manual_id": f"m{i % 2}", "page": i % 3})
    (tmp_path / "corrupt.png").write_bytes(b"not a png")
    records.append({"image_id": "corrupt", "filename": "corrupt.png", "manual_id": "m0", "page": 0})
    records.append({"image_id": "missing", "filename": "gone.png", "manual_id": "m1", "page": 1})
    records.append({"image_id": "vector", "filename": None, "manual_id": "m0", "page": 2})
    return records


def _chunk_records():
    texts = ["Remove the filter.", "", "Draai de bouten los en vervang de pakking " * 2,
             "Torque 25 Nm", None, "x " * 40, "Vóór gebruik: controleer het peil.",
             "ok", "m² ½ — 'quoted' don't", "the end " * 12]
    return [{"chunk_id": f"c{i}", "text": t, "manual_id": f"m{i % 2}", "page": i % 3}
            for i, t in enumerate(texts)]


def test_embed_and_search_match_jax(engines, tmp_path):
    port, ref = engines
    images = _image_records(tmp_path)
    chunks = _chunk_records()
    lengths = np.argmax(port.tokenizer([c["text"] or "" for c in chunks]), axis=1) + 1
    assert {16, 32, 77} <= {int(b) for b in np.asarray(port.text_buckets)[
        np.searchsorted(port.text_buckets, lengths)]}

    img, jimg = port.embed_image_records(images, tmp_path), ref.embed_image_records(images, tmp_path)
    txt, jtxt = port.embed_chunk_records(chunks), ref.embed_chunk_records(chunks)
    for got, want in ((img, jimg), (txt, jtxt)):
        assert got.dtype == np.float32 and got.shape == want.shape
        err = float(np.abs(got - want).max())
        assert err <= 1e-3, f"max abs error {err:.3g}"
        np.testing.assert_allclose(np.linalg.norm(got, axis=1), 1.0, atol=1e-5)
    # placeholders are bit-identical
    for i in (6, 7, 8):
        np.testing.assert_array_equal(img[i], jimg[i])
    for i in (1, 4):
        np.testing.assert_array_equal(txt[i], jtxt[i])

    # both indexes over the same (port) embeddings: the Evaluator's keyed
    # call and the query --text global call
    man = [c["manual_id"] for c in chunks]
    pg = [c["page"] for c in chunks]
    index = RetrievalIndex(txt, man, pg, device="cpu")
    jindex = JaxIndex(txt, man, pg)
    qm = [r["manual_id"] for r in images]
    qp = [r["page"] for r in images]
    for k in (3, 100):
        vals, idx = index.search(img, qm, qp, k=k)
        jvals, jidx = jindex.search(img, qm, qp, k=k)
        np.testing.assert_array_equal(idx, jidx)
        np.testing.assert_allclose(vals, jvals, atol=1e-6)
    q = port.encode_text_batch(["replace the filter", "bouten"])
    img_index = RetrievalIndex(img, qm, qp, device="cpu")
    jimg_index = JaxIndex(img, qm, qp)
    vals, idx = img_index.search(q, k=10, global_search=True)
    jvals, jidx = jimg_index.search(q, k=10, global_search=True)
    np.testing.assert_array_equal(idx, jidx)
    np.testing.assert_allclose(vals, jvals, atol=1e-6)


def test_batch_and_bucket_invariance(engines):
    """The same texts through one bucketed batch or one at a time, and
    with buckets off, give the same embeddings."""
    port, _ = engines
    texts = [c["text"] for c in _chunk_records() if c["text"]]
    whole = port.encode_text_batch(texts)
    single = np.concatenate([port.encode_text_batch([t]) for t in texts])
    port.text_buckets = None
    unbucketed = port.encode_text_batch(texts)
    np.testing.assert_allclose(whole, single, atol=1e-5)
    np.testing.assert_allclose(whole, unbucketed, atol=1e-5)
    assert port.encode_text_batch([]).shape == (0, 64)
    assert port.encode_image_batch(np.zeros((0, 32, 32, 3), np.float32)).shape == (0, 64)


def _feed_records(tmp_path):
    """PNG and JPEG files below and above a 48-pixel bucket, a corrupt
    file, a missing one and a record without a file."""
    rng = np.random.default_rng(5)
    records = []
    for i, (h, w, ext) in enumerate([(40, 30, "png"), (48, 48, "jpg"), (90, 20, "png"),
                                     (33, 120, "jpg"), (7, 9, "png"), (100, 100, "png")]):
        y, x = np.mgrid[0:h, 0:w]
        smooth = np.stack([x * 255 // max(w - 1, 1), y * 255 // max(h - 1, 1),
                           (x + y) % 256], -1).astype(np.uint8)
        noisy = np.clip(smooth + rng.integers(-20, 21, smooth.shape), 0, 255).astype(np.uint8)
        Image.fromarray(noisy).save(tmp_path / f"f{i}.{ext}")
        records.append({"image_id": f"f-{i}", "filename": f"f{i}.{ext}",
                        "manual_id": "m0", "page": i})
    (tmp_path / "bad.jpg").write_bytes(b"\xff\xd8 truncated")
    records.append({"image_id": "bad", "filename": "bad.jpg", "manual_id": "m0", "page": 0})
    records.append({"image_id": "gone", "filename": "gone.png", "manual_id": "m0", "page": 1})
    records.append({"image_id": "vec", "filename": None, "manual_id": "m0", "page": 2})
    return records


@pytest.mark.parametrize("batch_size", [4, 16])
def test_device_feed_matches_jax(engines, tmp_path, batch_size):
    """Both packages' engines with ``preprocess="device"`` over the same
    files: embeddings within 1e-3 at fp32, identical placeholders; the
    port's device feed also agrees with its host feed to the parity of
    the two preprocesses."""
    port, ref = engines
    for engine in (port, ref):
        engine.preprocess, engine.preprocess_bucket = "device", 48
    port.batch_size = ref.batch_size = batch_size
    records = _feed_records(tmp_path)
    got = port.embed_image_records(records, tmp_path)
    want = ref.embed_image_records(records, tmp_path)
    assert got.dtype == np.float32 and got.shape == want.shape == (len(records), 64)
    err = float(np.abs(got - want).max())
    assert err <= 1e-3, f"max abs error {err:.3g}"
    np.testing.assert_allclose(np.linalg.norm(got, axis=1), 1.0, atol=1e-5)
    for i in (6, 7, 8):
        np.testing.assert_array_equal(got[i], want[i])
    port.preprocess = "host"
    host = port.embed_image_records(records, tmp_path)
    np.testing.assert_array_equal(host[6:], got[6:])
    assert float(np.abs(host[:6] - got[:6]).max()) <= 0.1


def test_engine_rejects_unknown_feed():
    with pytest.raises(ValueError, match="host|device"):
        EmbedEngine(torch_config.ModelConfig(), preprocess="gpu", device="cpu")
