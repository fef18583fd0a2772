"""The port's EmbeddingStore reads what tpualign's wrote and the reverse:
the same rows, metadata columns, alignments and embedding matrices,
through a plain save, a `.delta.parquet` upsert on a loaded store, and the
fold of that delta into the base."""

import numpy as np
import pytest

from tpualign.store import SCHEMAS as JAX_SCHEMAS
from tpualign.store import EmbeddingStore as JaxStore
from tpualign_torch.store import SCHEMAS, EmbeddingStore

pytestmark = pytest.mark.fast

D = 16


def _records(rng, n, start=0):
    chunks = [{"chunk_id": f"c{i}", "manual_id": f"m{i % 3}", "page": i % 5,
               "bbox": [0.0, 1.0, 2.0, 3.0] if i % 2 else None, "text": f"step {i}"}
              for i in range(start, start + n)]
    images = [{"image_id": f"img{i}", "manual_id": f"m{i % 3}", "page": i % 5,
               "bbox": None, "bbox_source": "pdf", "caption": f"figure {i}",
               "filename": f"img{i}.png", "image_type": "raster"}
              for i in range(start, start + n // 4)]
    return (chunks, rng.normal(size=(n, D)).astype(np.float32),
            images, rng.normal(size=(n // 4, D)).astype(np.float32))


def _fill(store, rng, n=40, start=0):
    chunks, c_emb, images, i_emb = _records(rng, n, start)
    store.insert_chunks("vanilla_clip", chunks, c_emb)
    store.insert_images("vanilla_clip", images, i_emb)
    store.insert_alignments("vanilla_clip", [(im["image_id"], f"c{start + j}", 0.25 * j, "lexical")
                                             for j, im in enumerate(images)])


def _assert_same(a, b, schema="vanilla_clip"):
    assert a.counts(schema) == b.counts(schema)
    assert a.chunks(schema) == b.chunks(schema)
    assert a.images(schema) == b.images(schema)
    assert a.alignments(schema) == b.alignments(schema)
    for table in ("text_chunks", "images"):
        ids_a, m_a = a.embedding_matrix(schema, table)
        ids_b, m_b = b.embedding_matrix(schema, table)
        assert ids_a == ids_b
        np.testing.assert_array_equal(m_a, m_b)
    assert a.column(schema, "text_chunks", "page") == b.column(schema, "text_chunks", "page")
    assert a.has_embeddings(schema) and b.has_embeddings(schema)


def test_schemas_match():
    assert SCHEMAS == JAX_SCHEMAS


@pytest.mark.parametrize("writer,reader", [(JaxStore, EmbeddingStore),
                                           (EmbeddingStore, JaxStore)])
def test_store_round_trips_between_packages(tmp_path, writer, reader):
    rng = np.random.default_rng(0)
    w = writer(tmp_path, embed_dim=D)
    w.setup(["vanilla_clip"])
    _fill(w, rng)
    w.save()
    _assert_same(reader(tmp_path, embed_dim=D), writer(tmp_path, embed_dim=D))


@pytest.mark.parametrize("writer,reader", [(JaxStore, EmbeddingStore),
                                           (EmbeddingStore, JaxStore)])
def test_delta_upsert_read_across_packages(tmp_path, writer, reader):
    """A loaded store takes an upsert as a `.delta.parquet` sidecar plus an
    embedding overlay; the other package reads base + delta, then, after
    a further upsert folds the delta, the folded base."""
    rng = np.random.default_rng(1)
    w = writer(tmp_path, embed_dim=D)
    w.setup(["vanilla_clip"])
    _fill(w, rng, n=80)
    w.save()

    w = writer(tmp_path, embed_dim=D)                  # disk-backed now
    chunks, emb, _, _ = _records(rng, 8, start=78)     # c78, c79 update; 6 new
    w.insert_chunks("vanilla_clip", chunks, emb)
    w.save()
    assert (tmp_path / "vanilla_clip" / "text_chunks.delta.parquet").exists()
    r = reader(tmp_path, embed_dim=D)
    _assert_same(r, writer(tmp_path, embed_dim=D))
    ids, m = r.embedding_matrix("vanilla_clip", "text_chunks")
    assert len(ids) == 86 and ids[-1] == "c85"
    np.testing.assert_array_equal(m[ids.index("c78")], emb[0])

    w = writer(tmp_path, embed_dim=D)
    chunks, emb, _, _ = _records(rng, 30, start=200)   # past the fold fraction
    w.insert_chunks("vanilla_clip", chunks, emb)
    w.save()
    assert not (tmp_path / "vanilla_clip" / "text_chunks.delta.parquet").exists()
    _assert_same(reader(tmp_path, embed_dim=D), writer(tmp_path, embed_dim=D))
    assert reader(tmp_path, embed_dim=D).counts("vanilla_clip")["text_chunks"] == 116


def test_port_store_memory_maps_the_matrix(tmp_path):
    rng = np.random.default_rng(2)
    w = EmbeddingStore(tmp_path, embed_dim=D)
    w.setup(["vanilla_clip"])
    _fill(w, rng)
    w.save()
    _, m = EmbeddingStore(tmp_path, embed_dim=D).embedding_matrix("vanilla_clip", "text_chunks")
    assert isinstance(m.base, np.memmap) or isinstance(m, np.memmap)
    assert not m.flags.writeable
    with pytest.raises(FileNotFoundError):
        EmbeddingStore(tmp_path).images("clip_lexical")
    assert not EmbeddingStore(tmp_path).has_embeddings("clip_lexical")
