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


# -- crash paths of the delta save (the port's fixes; tpualign keeps the faults) ---------

_IMAGE_COLS = ("image_id", "manual_id", "page", "bbox", "bbox_source", "caption", "filename",
               "image_type")


def _v1_store_with_a_hole(root, rng, n=40, hole=7):
    """A round-3 (v1) store: ``n`` images, row ``hole`` without an
    embedding, and one chunk; opened and saved, it becomes a disk-backed v2
    table with a has-embedding mask."""
    import pyarrow as pa
    import pyarrow.parquet as pq

    from tests.test_store import chunk_row, img_row

    d = root / "vanilla_clip"
    d.mkdir(parents=True)
    rows = [img_row(i) for i in range(n)]
    emb = rng.normal(size=(n, D)).astype(np.float32)
    data = {c: [r.get(c) for r in rows] for c in _IMAGE_COLS}
    data["clip_embedding"] = [None if i == hole else emb[i].tolist() for i in range(n)]
    pq.write_table(pa.table(data), d / "images.parquet")
    return rows, emb, chunk_row(0)


def _crash(monkeypatch, module, name, when=lambda *a, **k: True):
    """Make ``module.name`` raise (a crash at that write) when ``when``."""
    real = getattr(module, name)

    def write(*args, **kwargs):
        if when(*args, **kwargs):
            raise OSError(f"simulated crash in {name}")
        return real(*args, **kwargs)

    monkeypatch.setattr(module, name, write)


@pytest.mark.parametrize("pkg", ["port", "tpualign"])
def test_a_crash_before_the_overlay_leaves_no_claimed_row_without_bytes(tmp_path, monkeypatch,
                                                                         pkg):
    """A disk-backed table whose row 7 has no embedding takes one (an
    overlay row) and crashes while the overlay sidecar is written. The
    port writes the mask after the overlay, so the reopened store still
    lacks row 7. tpualign writes the mask first: its reopened store claims
    row 7 and serves zeros for it (the fault the port repairs)."""
    import tpualign.store.embedding_store as jax_mod
    import tpualign_torch.store.embedding_store as torch_mod

    store_cls, mod = (EmbeddingStore, torch_mod) if pkg == "port" else (JaxStore, jax_mod)
    rows, emb, chunk = _v1_store_with_a_hole(tmp_path, np.random.default_rng(5))
    s = store_cls(tmp_path, embed_dim=D)
    s.insert_chunks("vanilla_clip", [chunk], emb[:1])
    s.save(["vanilla_clip"])
    assert (tmp_path / "vanilla_clip" / "images.hasemb.npy").exists()

    s = store_cls(tmp_path, embed_dim=D)  # disk-backed
    s.insert_images("vanilla_clip", [rows[7]], np.full((1, D), 3.0, np.float32))
    with monkeypatch.context() as m:
        _crash(m, mod, "_atomic_npz_save")
        with pytest.raises(OSError, match="simulated crash"):
            s.save(["vanilla_clip"])

    reopened = store_cls(tmp_path, embed_dim=D)
    if pkg == "port":
        with pytest.raises(ValueError, match="1 rows missing embeddings"):
            reopened.embedding_matrix("vanilla_clip", "images")
    else:
        _, mat = reopened.embedding_matrix("vanilla_clip", "images")
        assert not mat[7].any()  # claimed, and its bytes were never written


def test_a_crash_at_the_delta_commit_keeps_the_store_readable(tmp_path, monkeypatch):
    """The same table takes row 7's embedding and one new image, and
    crashes at the delta Parquet (the commit record): the mask, written
    before it, covers the uncommitted row too (from_dir slices it), so the
    reopened store opens, shows the committed rows only and serves row 7
    from the durable overlay."""
    import tpualign_torch.store.embedding_store as torch_mod
    from tests.test_store import img_row

    rows, emb, chunk = _v1_store_with_a_hole(tmp_path, np.random.default_rng(6))
    s = EmbeddingStore(tmp_path, embed_dim=D)
    s.insert_chunks("vanilla_clip", [chunk], emb[:1])
    s.save(["vanilla_clip"])
    s = EmbeddingStore(tmp_path, embed_dim=D)
    s.insert_images("vanilla_clip", [rows[7], img_row(99)],
                    np.stack([np.full(D, 3.0), np.full(D, 4.0)]).astype(np.float32))
    with monkeypatch.context() as m:
        _crash(m, torch_mod, "_atomic_parquet_save",
               lambda path, table: path.name.endswith(".delta.parquet"))
        with pytest.raises(OSError, match="simulated crash"):
            s.save(["vanilla_clip"])

    reopened = EmbeddingStore(tmp_path, embed_dim=D)
    ids, mat = reopened.embedding_matrix("vanilla_clip", "images")
    assert ids == [r["image_id"] for r in rows]
    np.testing.assert_array_equal(mat[7], np.full(D, 3.0, np.float32))
    np.testing.assert_array_equal(np.delete(np.asarray(mat), 7, axis=0), np.delete(emb, 7, axis=0))


def _fold_with_an_older_overlay(store_cls, root, rng, prior_delta, crash=None):
    """40 chunks saved; reopened, c5 updated (an overlay sidecar) and, with
    ``prior_delta``, 2 chunks added (a delta sidecar); reopened again, c5
    updated once more with 12 new chunks, which folds: the newer c5 goes
    into the matrix, the sidecars go. ``crash()`` is entered around that
    last save."""
    import contextlib

    s = store_cls(root, embed_dim=D)
    s.setup(["vanilla_clip"])
    _fill(s, rng, n=40)
    s.save()
    chunks, _, _, _ = _records(rng, 40)
    more, more_emb, _, _ = _records(rng, 2, start=60)
    s = store_cls(root, embed_dim=D)
    s.insert_chunks("vanilla_clip", [chunks[5]] + (more if prior_delta else []),
                    np.concatenate([np.full((1, D), 1.0, np.float32)]
                                   + ([more_emb] if prior_delta else [])))
    s.save()
    assert (root / "vanilla_clip" / "text_chunks.emb.overlay.npz").exists()
    assert (root / "vanilla_clip" / "text_chunks.delta.parquet").exists() == prior_delta
    s = store_cls(root, embed_dim=D)
    new, new_emb, _, _ = _records(rng, 12, start=100)
    s.insert_chunks("vanilla_clip", [chunks[5]] + new,
                    np.concatenate([np.full((1, D), 2.0, np.float32), new_emb]))
    with crash() if crash else contextlib.nullcontext():
        s.save()


def _crash_after_the_fold_commit(monkeypatch, mod):
    """A crash at the fold's unlink of the delta sidecar (after its
    commit), as a context manager."""
    import contextlib

    @contextlib.contextmanager
    def crash():
        with monkeypatch.context() as m:
            _crash(m, mod, "_unlink_quiet", lambda p: p.name.endswith(".delta.parquet"))
            with pytest.raises(OSError, match="simulated crash"):
                yield

    return crash


def _assert_c5_folded(store, root):
    ids, mat = store.embedding_matrix("vanilla_clip", "text_chunks")
    np.testing.assert_array_equal(mat[ids.index("c5")], np.full(D, 2.0, np.float32))
    assert not (root / "vanilla_clip" / "text_chunks.emb.overlay.npz").exists()
    assert not (root / "vanilla_clip" / "text_chunks.delta.parquet").exists()


@pytest.mark.parametrize("prior_delta", [False, True])
def test_a_crash_after_the_fold_commit_serves_no_stale_overlay(tmp_path, monkeypatch,
                                                               prior_delta):
    """The port's fold drops the overlay sidecar as soon as its rows are in
    the matrix, so a crash after the commit (before the delta sidecar goes)
    leaves no overlay to serve c5's older row; the reopened store equals
    one that never crashed, which equals tpualign's."""
    import tpualign_torch.store.embedding_store as torch_mod

    crashed, clean, jax_clean = tmp_path / "crashed", tmp_path / "clean", tmp_path / "jax"
    _fold_with_an_older_overlay(EmbeddingStore, crashed, np.random.default_rng(7), prior_delta,
                                _crash_after_the_fold_commit(monkeypatch, torch_mod))
    _fold_with_an_older_overlay(EmbeddingStore, clean, np.random.default_rng(7), prior_delta)
    _fold_with_an_older_overlay(JaxStore, jax_clean, np.random.default_rng(7), prior_delta)
    reopened = EmbeddingStore(crashed, embed_dim=D)
    _assert_c5_folded(reopened, crashed)
    _assert_same(reopened, EmbeddingStore(clean, embed_dim=D))
    _assert_same(EmbeddingStore(clean, embed_dim=D), JaxStore(jax_clean, embed_dim=D))
    assert (sorted(p.name for p in (clean / "vanilla_clip").iterdir())
            == sorted(p.name for p in (jax_clean / "vanilla_clip").iterdir()))


def test_the_port_drops_both_sidecars_of_an_already_folded_store(tmp_path, monkeypatch):
    """tpualign's fold unlinks the overlay after its commit, so its crash
    there leaves both sidecars beside the folded base. tpualign's reopen
    drops only the delta and serves c5's older row from the overlay; the
    port's ``from_dir`` drops both and serves the folded row."""
    import tpualign.store.embedding_store as jax_mod

    root = tmp_path / "s"
    _fold_with_an_older_overlay(JaxStore, root, np.random.default_rng(9), True,
                                _crash_after_the_fold_commit(monkeypatch, jax_mod))
    assert (root / "vanilla_clip" / "text_chunks.emb.overlay.npz").exists()
    assert (root / "vanilla_clip" / "text_chunks.delta.parquet").exists()
    import shutil

    shutil.copytree(root, tmp_path / "copy")
    ids, mat = JaxStore(tmp_path / "copy", embed_dim=D).embedding_matrix("vanilla_clip",
                                                                         "text_chunks")
    np.testing.assert_array_equal(mat[ids.index("c5")], np.full(D, 1.0, np.float32))  # stale
    _assert_c5_folded(EmbeddingStore(root, embed_dim=D), root)
def test_uncrashed_delta_saves_match_tpualign(tmp_path):
    """Without a crash the reordered save leaves what tpualign leaves: the
    hole filled through an overlay, new rows through the delta, then a
    fold; after each save both stores read the same and hold the same
    files."""
    from tests.test_store import img_row

    roots = {}
    for name, cls in (("port", EmbeddingStore), ("jax", JaxStore)):
        root = tmp_path / name
        rows, emb, chunk = _v1_store_with_a_hole(root, np.random.default_rng(8))
        s = cls(root, embed_dim=D)
        s.insert_chunks("vanilla_clip", [chunk], emb[:1])
        s.save(["vanilla_clip"])
        roots[name] = (root, cls, rows)
    steps = [lambda r: ([r[7], img_row(99)], np.stack([np.full(D, 3.0), np.full(D, 4.0)])),
             lambda r: ([img_row(100 + i) for i in range(12)], np.full((12, D), 5.0))]
    for step in steps:
        for root, cls, rows in roots.values():
            s = cls(root, embed_dim=D)
            recs, e = step(rows)
            s.insert_images("vanilla_clip", recs, e.astype(np.float32))
            s.save(["vanilla_clip"])
        (pr, pcls, _), (jr, jcls, _) = roots["port"], roots["jax"]
        _assert_same(pcls(pr, embed_dim=D), jcls(jr, embed_dim=D))
        assert (sorted(p.name for p in (pr / "vanilla_clip").iterdir())
                == sorted(p.name for p in (jr / "vanilla_clip").iterdir()))
