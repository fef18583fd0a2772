"""The one-host mesh of tpualign_torch against tpualign's mesh on the CPU.

The port's meshes repeat the CPU device (``create_mesh(8, 1, devices=[cpu]
* 8)`` and ``(4, 2)``), standing in for tpualign's eight virtual CPU
devices (``tests/conftest.py``). Each case of ``tests/test_parallel.py``
runs in both packages on the same numpy-seeded inputs: the sharded exact
search at every precision and strategy, ties at corpus scale, the
wildcard, k above the corpus, empty inputs, add/remove/compact, the ring,
the data-parallel EmbedEngine, the Evaluator's ``metrics.json``, the mesh
constructors, the debugging checks and the CLI's mesh flags. Indices must
be identical (ascending-index ties, ``(NEG_INF, -1)`` padding) and values
within 1e-6.

tpualign's quantized gather quantizes the queries under jit, as
``max|q| * fl(1/127)``, where the port divides (ROADMAP settled difference
3): values may differ by an ulp of that scale, well within 1e-6.
"""

import json
import logging

import numpy as np
import pytest
import torch

import jax.numpy as jnp
from tests.test_golden import GOLDEN, Sha256Engine
from tests.test_parallel import _adversarial_tie_problem, make_problem, numpy_oracle
from tests.test_torch_pipeline import _assert_metrics_equal, _processed, tiny_variant  # noqa: F401
from tpualign import config as jax_config
from tpualign.config import MeshConfig as JaxMeshConfig
from tpualign.parallel import mesh as jax_mesh_mod
from tpualign.parallel import retrieval as jax_retrieval
from tpualign.parallel.ring import ring_topk_search as jax_ring
from tpualign.utils import debugging as jax_debugging
from tpualign_torch import cli as torch_cli
from tpualign_torch import config as torch_config
from tpualign_torch.parallel import (
    EmbedEngine, RetrievalIndex, create_mesh, default_mesh, encode_keys, sharded_topk_search)
from tpualign_torch.parallel.mesh import Mesh, ShardedRows
from tpualign_torch.parallel.ring import ring_topk_search
from tpualign_torch.utils.debugging import assert_sharded, check_finite, debug_mode

pytestmark = pytest.mark.fast

CPU = torch.device("cpu")
SHAPES = [(8, 1), (4, 2)]


def port_mesh(data, model=1):
    return create_mesh(data, model, devices=[CPU] * (data * model))


@pytest.fixture(scope="module", params=SHAPES, ids=["8x1", "4x2"])
def meshes(request):
    """(the port's mesh, tpualign's mesh) of one shape."""
    data, model = request.param
    return port_mesh(data, model), jax_mesh_mod.create_mesh(data, model)


def _same(got, want, atol=1e-6):
    (v, i), (jv, ji) = got, want
    i, ji = np.asarray(i), np.asarray(ji)
    assert i.dtype == np.int64 and i.shape == ji.shape
    np.testing.assert_array_equal(i, ji)
    has = ji >= 0
    np.testing.assert_allclose(np.asarray(v)[has], np.asarray(jv)[has], rtol=0, atol=atol)
    assert (np.asarray(v)[~has] <= -1e29).all()


def _problem(seed, nq=17, n=203, d=32):
    rng = np.random.default_rng(seed)
    q, qman, qpage, c, cman, cpage = make_problem(rng, nq=nq, n=n, d=d)
    c[-6:] = c[:6]  # duplicated rows: exact ties across shards
    return q, qman, qpage, c, cman, cpage


# -- the sharded search --------------------------------------------------------

CELLS = [("fp32", "gather"), ("fp32", "ring"), ("fp32", "streaming"),
         ("int8", "gather"), ("int8", "streaming"), ("int4", "gather"),
         ("int4", "streaming"), ("int2", "gather"), ("int2", "streaming")]


@pytest.mark.parametrize("precision,strategy", CELLS)
def test_mesh_search_matches_tpualign(meshes, precision, strategy, monkeypatch):
    """Keyed and wildcard searches at k=10, and at k=64 (above a shard's
    rows: the merge of every shard's winners), against tpualign's mesh
    index of the same precision: its gather (for the quantized precisions
    the integer dots the port's K3 takes on every strategy, as tpualign
    routes on a TPU), and at fp32 and k=10 its own strategy too.
    tpualign's streaming merges only ``min(k, n_local)`` winners (ROADMAP
    settled difference 21), so at k=64 only its gather is the reference."""
    mesh, jmesh = meshes
    q, qman, qpage, c, cman, cpage = _problem(23)
    q[3] *= 3.0  # an unnormalised row, as the serving path may send
    port = RetrievalIndex(c, cman, cpage, mesh=mesh, precision=precision)
    ref = jax_retrieval.RetrievalIndex(c, cman, cpage, mesh=jmesh, precision=precision)
    assert port._n_local == ref._n_local < 64 and isinstance(port._corpus, ShardedRows)
    refs = ["gather"] + ([strategy] if precision == "fp32" and strategy != "gather" else [])
    for k in (10, 64):
        for ref_strategy in refs if k == 10 else ["gather"]:
            _same(port.search(q, qman, qpage, k=k, strategy=strategy),
                  ref.search(q, qman, qpage, k=k, strategy=ref_strategy))
            _same(port.search(q, k=k, strategy=strategy, global_search=True),
                  ref.search(q, k=k, strategy=ref_strategy, global_search=True))


def test_mesh_matches_one_device_and_the_oracle(meshes):
    """Every strategy over the mesh equals the one-device index and the
    numpy oracle (ties by ascending index across shard boundaries)."""
    mesh, _ = meshes
    q, qman, qpage, c, cman, cpage = _problem(11, nq=37, n=197)
    vocab = {}
    ckeys, vocab = encode_keys(cman, cpage, vocab)
    qkeys, _ = encode_keys(qman, qpage, vocab)
    ovals, oidx = numpy_oracle(q, qkeys, c, ckeys, 10)
    one = sharded_topk_search(q, qkeys, c, ckeys, 10, device="cpu")
    _same(one, (ovals, oidx), atol=1e-5)
    _same(sharded_topk_search(q, qkeys, c, ckeys, 10, mesh=mesh), one)
    _same(ring_topk_search(q, qkeys, c, ckeys, 10, mesh), one)
    index = RetrievalIndex(c, cman, cpage, mesh=mesh)
    for strategy in ("auto", "gather", "ring", "streaming"):
        _same(index.search(q, qman, qpage, k=10, strategy=strategy), one)


def test_ring_matches_tpualigns_ring(meshes):
    mesh, jmesh = meshes
    q, qman, qpage, c, cman, cpage = _problem(12, nq=24, n=512)
    vocab = {}
    ckeys, vocab = encode_keys(cman, cpage, vocab)
    qkeys, _ = encode_keys(qman, qpage, vocab)
    for k in (7, 100):
        _same(ring_topk_search(q, qkeys, c, ckeys, k, mesh),
              jax_ring(q, qkeys, c, ckeys, k, jmesh))


@pytest.mark.parametrize("what", ["ulp_apart", "exact_ties"])
def test_ties_at_corpus_scale(meshes, what):
    """Values one fp32 ulp apart at a 120k index, and bit-identical values
    on both sides of shard boundaries, rank as tpualign ranks them."""
    mesh, jmesh = meshes
    if what == "ulp_apart":
        q, qk, c, ck, winner = _adversarial_tie_problem()
        k = 2
    else:
        c = np.zeros((640, 1), np.float32)
        for i in (3, 79, 80, 81, 400, 639):
            c[i, 0] = 0.5
        q, qk, ck, k = np.ones((1, 1), np.float32), np.zeros(1, np.int32), np.zeros(640, np.int32), 6
    got = sharded_topk_search(q, qk, c, ck, k, mesh=mesh)
    _same(got, jax_retrieval.sharded_topk_search(q, qk, c, ck, k, mesh=jmesh))
    _same(ring_topk_search(q, qk, c, ck, k, mesh), got)
    if what == "ulp_apart":
        assert got[1][0].tolist() == [winner, 0]


def test_k_above_the_corpus_and_empty_inputs(meshes):
    mesh, jmesh = meshes
    rng = np.random.default_rng(2)
    c = rng.normal(size=(3, 8)).astype(np.float32)
    q = rng.normal(size=(2, 8)).astype(np.float32)
    port = RetrievalIndex(c, ["m"] * 3, [1] * 3, mesh=mesh)
    ref = jax_retrieval.RetrievalIndex(c, ["m"] * 3, [1] * 3, mesh=jmesh)
    for strategy in ("gather", "ring", "streaming"):
        got = port.search(q, ["m"] * 2, [1, 1], k=10, strategy=strategy)
        _same(got, ref.search(q, ["m"] * 2, [1, 1], k=10, strategy="gather"))
        assert (got[1][:, :3] >= 0).all() and (got[1][:, 3:] == -1).all()
    # an unknown query manual finds nothing
    assert (port.search(q, ["unknown"] * 2, [1, 1], k=3)[1] == -1).all()
    for fn in (sharded_topk_search, jax_retrieval.sharded_topk_search):
        m = mesh if fn is sharded_topk_search else jmesh
        vals, idx = fn(np.zeros((0, 4), np.float32), np.zeros(0, np.int32),
                       np.zeros((5, 4), np.float32), np.zeros(5, np.int32), k=3, mesh=m)
        assert vals.shape == idx.shape == (0, 3)
        vals, idx = fn(np.zeros((2, 4), np.float32), np.zeros(2, np.int32),
                       np.zeros((0, 4), np.float32), np.zeros(0, np.int32), k=3, mesh=m)
        assert (idx == -1).all() and vals.shape == (2, 3)


def test_ring_over_a_quantized_corpus_routes_to_gather_once(meshes):
    mesh, _ = meshes
    q, qman, qpage, c, cman, cpage = _problem(29, nq=7)
    index = RetrievalIndex(c, cman, cpage, mesh=mesh, precision="int8")
    records = []
    handler = logging.Handler()
    handler.emit = records.append
    logger = logging.getLogger("tpualign_torch.parallel.retrieval")
    logger.addHandler(handler)
    try:
        ring = index.search(q, qman, qpage, k=10, strategy="ring")
        index.search(q, qman, qpage, k=10, strategy="ring")
    finally:
        logger.removeHandler(handler)
    assert sum("routing to" in r.getMessage() for r in records) == 1, records
    _same(ring, index.search(q, qman, qpage, k=10, strategy="gather"))


def test_the_router_is_tpualigns(meshes, monkeypatch):
    """``_pick_strategy`` takes tpualign's branches; "on the card" stands
    for "on a TPU" (the CPU mesh routes as tpualign's CPU mesh does)."""
    mesh, jmesh = meshes
    q, qman, qpage, c, cman, cpage = _problem(3, nq=8, n=64)
    for precision in ("fp32", "int8"):
        port = RetrievalIndex(c, cman, cpage, mesh=mesh, precision=precision)
        ref = jax_retrieval.RetrievalIndex(c, cman, cpage, mesh=jmesh, precision=precision)
        for cls in (type(port), type(ref)):
            monkeypatch.setattr(cls, "RING_THRESHOLD_BYTES", 100)
        for nq, k in ((1, 10), (8, 10), (8, 40)):
            assert port._pick_strategy(nq, "auto", k) == ref._pick_strategy(nq, "auto", k)
        port.device = torch.device("cuda", 0)  # read, not used: no launch follows
        assert port._pick_strategy(8, "auto", 10) == "streaming"
    with pytest.raises(ValueError, match="strategy"):
        port.search(q, k=3, strategy="bogus")


# -- the live corpus on a mesh -------------------------------------------------


@pytest.mark.parametrize("precision", ["fp32", "int8"])
def test_mesh_add_remove_compact_match_tpualign(meshes, precision):
    """Adds (one within the capacity, one past it: the shards regrow),
    removes and a compaction on the mesh index against tpualign's mesh
    index, a fresh mesh index and a fresh one-device index."""
    mesh, jmesh = meshes
    rng = np.random.default_rng(101)
    n, extra, d = 200, 120, 32
    c = rng.normal(size=(n + extra, d)).astype(np.float32)
    c /= np.linalg.norm(c, axis=1, keepdims=True)
    man = [f"m{i % 4}" for i in range(n + extra)]
    page = [1 + i % 3 for i in range(n + extra)]
    q, qm, qp = c[::7][:24], man[::7][:24], page[::7][:24]
    port = RetrievalIndex(c[:n], man[:n], page[:n], mesh=mesh, precision=precision)
    ref = jax_retrieval.RetrievalIndex(c[:n], man[:n], page[:n], mesh=jmesh,
                                       precision=precision)
    for s0, s1 in ((n, n + 4), (n + 4, n + extra)):
        for index in (port, ref):
            index.add(c[s0:s1], man[s0:s1], page[s0:s1])
    assert port.n == ref.n == n + extra and port._n_local == ref._n_local
    assert port._corpus.shape[0] == ref._corpus.shape[0]  # whole shards, the same capacity

    def check(live_rows):
        fresh = RetrievalIndex(c[live_rows], [man[i] for i in live_rows],
                               [page[i] for i in live_rows], mesh=mesh, precision=precision)
        one = RetrievalIndex(c[live_rows], [man[i] for i in live_rows],
                             [page[i] for i in live_rows], precision=precision, device="cpu")
        for kw in (dict(query_manuals=qm, query_pages=qp), dict(global_search=True)):
            got = port.search(q, k=8, **kw)
            _same(got, ref.search(q, k=8, **kw))
            for other in (fresh, one):
                v, i = other.search(q, k=8, **kw)
                _same(got, (v, np.where(i >= 0, np.asarray(live_rows)[np.maximum(i, 0)], -1)))

    check(np.arange(n + extra))
    gone = np.array([0, 5, 64, 90, 201, 250, 319])
    assert port.remove(gone) == ref.remove(gone) == len(gone)
    assert port.remove(gone) == 0 and port.dead == ref.dead == len(gone)
    check(np.setdiff1d(np.arange(n + extra), gone))
    live = port.compact()
    np.testing.assert_array_equal(live, ref.compact())
    assert port._corpus.shape[0] == ref._corpus.shape[0] and port.dead == 0
    # the survivors renumbered 0..L-1: a fresh index over them, as before
    c, man, page = c[live], [man[i] for i in live], [page[i] for i in live]
    check(np.arange(len(live)))
    assert port.remove(np.arange(port.n)) == port.n
    assert len(port.compact()) == 0 and port.n == 0
    assert (port.search(q, k=3, global_search=True)[1] == -1).all()


def test_mesh_add_to_an_empty_index(meshes):
    mesh, _ = meshes
    rng = np.random.default_rng(103)
    c = rng.normal(size=(48, 16)).astype(np.float32)
    index = RetrievalIndex(np.zeros((0, 16), np.float32), [], [], mesh=mesh)
    index.add(c, ["newman"] * 48, [2] * 48)
    assert index.n == 48 and "newman" in index.vocab
    assert index._corpus.shape[0] % mesh.shape["data"] == 0
    _, i = index.search(c[:4], ["newman"] * 4, [2] * 4, k=3)
    assert (i[:, 0] == np.arange(4)).all()


@pytest.mark.parametrize("precision", ["int8", "int4"])
def test_mesh_refine_matches_tpualign(meshes, precision):
    """refine over a sharded quantized first stage: the rescored values
    are exact, so they equal tpualign's bit for bit."""
    mesh, jmesh = meshes
    q, qman, qpage, c, cman, cpage = _problem(41)
    port = RetrievalIndex(c, cman, cpage, mesh=mesh, precision=precision, refine=4)
    ref = jax_retrieval.RetrievalIndex(c, cman, cpage, mesh=jmesh, precision=precision,
                                       refine=4)
    _same(port.search(q, k=5, global_search=True), ref.search(q, k=5, global_search=True),
          atol=0.0)


# -- data-parallel embedding and evaluation ---------------------------------------


def test_embed_engine_on_a_mesh(monkeypatch, tmp_path):
    """The towers replicated over the data axis: within 1e-6 of the port's
    one-device engine (images, the device feed, texts in their buckets)
    and within 1e-3 of tpualign's engine at fp32; the batch rounds to the
    data axis; a model axis of 2 (tensor parallel rows) gives the same
    embeddings within 1e-6."""
    import dataclasses

    import jax

    from tests.test_torch_embed import TINY77, _chunk_records, _image_records
    from tpualign.models.clip import CLIP as JaxCLIP
    from tpualign.models.clip import init_clip_params as jax_init
    from tpualign.parallel.embed import EmbedEngine as JaxEngine

    monkeypatch.setitem(jax_config.CLIP_VARIANTS, "tiny", TINY77)
    monkeypatch.setitem(torch_config.CLIP_VARIANTS, "tiny",
                        torch_config.ClipVariant(**dataclasses.asdict(TINY77)))
    params = jax_init(JaxCLIP(variant=TINY77, compute_dtype=jnp.float32), seed=0)
    host = jax.tree.map(np.asarray, params)
    model_config = torch_config.ModelConfig("tiny", parity_mode=True)
    ref = JaxEngine(jax_config.ModelConfig("tiny", parity_mode=True), batch_size=4,
                    params=params)
    port = EmbedEngine(model_config, batch_size=4, params=host, device="cpu", decode_workers=2)
    sharded = EmbedEngine(model_config, batch_size=12, params=host, device="cuda",
                          mesh=port_mesh(8), decode_workers=2)
    assert sharded.batch_size == 8 and sharded.device == CPU
    rng = np.random.default_rng(0)
    images = rng.normal(size=(19, 32, 32, 3)).astype(np.float32)
    one = port.encode_image_batch(images)
    np.testing.assert_allclose(sharded.encode_image_batch(images), one, rtol=0, atol=1e-6)
    np.testing.assert_allclose(one, ref.encode_image_batch(images), rtol=0, atol=1e-3)
    records = _chunk_records()
    got = sharded.embed_chunk_records(records)
    np.testing.assert_allclose(got, port.embed_chunk_records(records), rtol=0, atol=1e-6)
    np.testing.assert_allclose(got, ref.embed_chunk_records(records), rtol=0, atol=1e-3)
    image_records = _image_records(tmp_path)
    sharded.preprocess = port.preprocess = "device"
    np.testing.assert_allclose(sharded.embed_image_records(image_records, tmp_path),
                               port.embed_image_records(image_records, tmp_path),
                               rtol=0, atol=1e-6)
    # a model axis of 2: each data row runs the towers tensor parallel
    tp = EmbedEngine(model_config, batch_size=12, params=host, device="cuda",
                     mesh=port_mesh(4, 2), decode_workers=2)
    assert tp.batch_size == 12 and tp.device == CPU
    np.testing.assert_allclose(tp.encode_image_batch(images), one, rtol=0, atol=1e-6)
    np.testing.assert_allclose(tp.embed_chunk_records(records), got, rtol=0, atol=1e-6)


def test_evaluator_on_a_mesh_writes_the_golden_metrics(tmp_path):
    from tpualign_torch.evaluation import Evaluator
    from tpualign_torch.pipeline import Pipeline

    overrides = _processed(tmp_path)
    config = torch_config.load_config(overrides)
    mesh = port_mesh(4, 2)
    pipe = Pipeline(config, engine=Sha256Engine(), device="cuda", mesh=mesh)
    assert pipe.device == CPU
    pipe.store.embed_dim = Sha256Engine.dim
    pipe.step_store_setup()
    pipe.step_insert_embeddings()
    pipe.step_evaluation()
    got = json.loads((tmp_path / "eval" / "metrics.json").read_text())
    _assert_metrics_equal(got, json.loads(GOLDEN.read_text()))
    metrics = Evaluator(pipe.store, output_dir=str(tmp_path / "e8"), mesh=port_mesh(8)
                        ).print_metrics_report(["vanilla_clip"])
    assert json.loads(json.dumps(metrics))["vanilla_clip"] == got["vanilla_clip"]


def test_the_cli_takes_the_mesh_flags(tmp_path, monkeypatch):
    """``--mesh-data``/``--mesh-model`` set MESH_DATA/MESH_MODEL as
    tpualign's CLI sets them; ``evaluate --device cpu --mesh-data 4``
    evaluates over a 4-way CPU mesh and writes the golden metrics; ``train``
    hands its Trainer the (2, 2) CPU mesh of ``--mesh-data 2 --mesh-model 2``."""
    from tpualign import cli as jax_cli
    from tpualign_torch.pipeline import Pipeline

    for key in ("MESH_DATA", "MESH_MODEL"):
        monkeypatch.delenv(key, raising=False)
    argv = ["evaluate", "--env-file", str(tmp_path / "none.env"), "--mesh-data", "4",
            "--mesh-model", "2"]
    got = torch_cli._config_from(torch_cli_args(argv)).mesh
    want = jax_cli._config_from(torch_cli_args(argv)).mesh
    assert (got.data, got.model, got.num_devices) == (want.data, want.model, 8)
    assert torch_cli._mesh(torch_config.load_config({}), "cpu") is None
    mesh = torch_cli._mesh(torch_config.load_config({"MESH_DATA": "4"}), "cpu")
    assert mesh.shape == {"data": 4, "model": 1}

    overrides = _processed(tmp_path)
    pipe = Pipeline(torch_config.load_config(overrides), engine=Sha256Engine(), device="cpu")
    pipe.store.embed_dim = Sha256Engine.dim
    pipe.step_store_setup()
    pipe.step_insert_embeddings()
    for key, value in overrides.items():
        monkeypatch.setenv(key, value)
    assert torch_cli.main(["evaluate", "--device", "cpu", "--mesh-data", "4",
                           "--env-file", str(tmp_path / "none.env")]) == 0
    got = json.loads((tmp_path / "eval" / "metrics.json").read_text())
    _assert_metrics_equal(got, json.loads(GOLDEN.read_text()))
    from tpualign_torch.train import trainer as torch_trainer

    seen = {}

    class Recorder:  # the mesh train itself: tests/test_torch_train_mesh.py
        def __init__(self, config, mesh=None, device="cuda"):
            seen.update(shape=mesh.shape, devices=set(mesh.devices.flat), device=device)

        def train(self, **kw):
            return {"loss": 1.0}

    monkeypatch.setattr(torch_trainer, "Trainer", Recorder)
    assert torch_cli.main(["train", "--device", "cpu", "--mesh-data", "2", "--mesh-model", "2",
                           "--env-file", str(tmp_path / "none.env")]) == 0
    assert seen == {"shape": {"data": 2, "model": 2}, "devices": {CPU}, "device": "cpu"}


def test_cli_embed_on_a_mesh_stores_what_one_device_stores(tmp_path, monkeypatch,
                                                           tiny_variant):  # noqa: F811
    """``setup-db`` and ``embed --device cpu --mesh-data 4`` (the towers of a
    tiny variant replicated over a 4-way CPU mesh, the device feed on each
    replica) store, for every schema, the embeddings that ``embed --device
    cpu`` stores, within 1e-6, and the same alignment records."""
    from tpualign_torch.store import SCHEMAS, EmbeddingStore

    overrides = _processed(tmp_path)
    monkeypatch.chdir(tmp_path)
    for key, value in {**overrides, "CLIP_MODEL": "tiny", "IMAGE_PREPROCESS": "device",
                       "IMAGE_PREPROCESS_BUCKET": "48", "COMPUTE_DTYPE": "float32",
                       "BATCH_SIZE": "4"}.items():
        monkeypatch.setenv(key, value)
    meshes, init = [], EmbedEngine.__init__

    def spy(self, *a, **kw):
        meshes.append(kw.get("mesh"))
        init(self, *a, **kw)

    monkeypatch.setattr(EmbedEngine, "__init__", spy)
    stores = {}
    for name, extra in (("one", []), ("mesh", ["--mesh-data", "4"])):
        root = tmp_path / f"store-{name}"
        monkeypatch.setenv("STORE_DIR", str(root))
        for stage in ("setup-db", "embed"):
            assert torch_cli.main([stage, "--device", "cpu", *extra]) == 0
        stores[name] = EmbeddingStore(str(root), embed_dim=tiny_variant.embed_dim)
    assert len(meshes) == 2 and meshes[0] is None and meshes[1].shape == {"data": 4, "model": 1}
    for schema in SCHEMAS:
        for table in ("images", "text_chunks"):
            got_ids, got = stores["mesh"].embedding_matrix(schema, table)
            want_ids, want = stores["one"].embedding_matrix(schema, table)
            assert list(got_ids) == list(want_ids) and len(got) > 0
            np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)
        assert stores["mesh"].alignments(schema) == stores["one"].alignments(schema)


def torch_cli_args(argv):
    """The namespace both CLIs' ``_config_from`` read."""
    import argparse

    p = argparse.ArgumentParser()
    p.add_argument("command")
    torch_cli._add_common(p)
    return p.parse_args(argv)


# -- the mesh, and the debugging checks ----------------------------------------


def test_create_mesh_and_default_mesh_as_tpualign(monkeypatch):
    for data, model in SHAPES + [(2, 4), (1, 1)]:
        mesh = create_mesh(data, model, devices=[CPU] * 8, axis_names=("data", "model"))
        ref = jax_mesh_mod.create_mesh(data, model)
        assert mesh.shape == dict(ref.shape) and mesh.axis_names == ref.axis_names
        assert mesh.devices.shape == ref.devices.shape
        assert mesh.data_devices == [CPU] * data
    for fn in (create_mesh, jax_mesh_mod.create_mesh):
        with pytest.raises(ValueError, match="needs 9 devices, have 8"):
            fn(9, 1, devices=[CPU] * 8) if fn is create_mesh else fn(9, 1)
    # without devices a mesh takes the visible cards, in order, never twice
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 0)
    with pytest.raises(ValueError, match="needs 4 devices, have 0"):
        create_mesh(4)
    with pytest.raises(ValueError, match="needs 1 devices, have 0"):
        default_mesh()
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 4)
    cards = [torch.device("cuda", i) for i in range(4)]
    assert list(create_mesh(2, 2).devices.flat) == cards
    assert default_mesh().shape == {"data": 4, "model": 1}
    assert list(default_mesh().devices.flat) == cards
    for config, shape in ((torch_config.MeshConfig(2, 2), (2, 2)),
                          (torch_config.MeshConfig(1, 1), (1, 1)),
                          (torch_config.MeshConfig(3, 1), (3, 1))):
        got = default_mesh(config)
        want = jax_mesh_mod.default_mesh(JaxMeshConfig(*shape))
        assert tuple(got.shape.values()) == tuple(want.shape.values()) == shape
    with pytest.raises(ValueError, match="needs 8 devices, have 4"):
        default_mesh(torch_config.MeshConfig(4, 2))
    assert torch_config.load_config({"MESH_DATA": "4", "MESH_MODEL": "2"}).mesh.num_devices == 8
    with pytest.raises(TypeError, match="tpualign_torch Mesh"):
        RetrievalIndex(np.eye(4, dtype=np.float32), ["m"] * 4, [1] * 4,
                       mesh=jax_mesh_mod.create_mesh(2, 1))


def test_check_finite_as_tpualign():
    tree = {"a": np.ones(3, np.float32), "b": [np.zeros(2, np.int32),
                                               (np.ones(2, np.float32), np.array([np.inf]))]}
    messages = []
    for fn, leaf in ((check_finite, torch.from_numpy), (jax_debugging.check_finite, jnp.asarray)):
        conv = {"a": leaf(tree["a"]), "b": [leaf(tree["b"][0]),
                                             (leaf(tree["b"][1][0]), leaf(tree["b"][1][1]))]}
        fn({"a": conv["a"]}, name="ok")
        with pytest.raises(FloatingPointError) as err:
            fn(conv, name="params")
        messages.append(str(err.value))
    assert messages[0] == messages[1] == "non-finite values in params['b'][1][1]"
    with pytest.raises(FloatingPointError, match="non-finite values in x"):
        check_finite(np.array([np.nan]), name="x")


def test_debug_mode_raises_at_the_first_nan():
    x = torch.tensor([-1.0, 4.0])
    assert torch.isnan(torch.log(x)).any()  # outside: handed on
    layer = torch.nn.Linear(2, 2)
    with debug_mode():
        assert torch.isfinite(layer(torch.sqrt(x.abs()))).all()
        with pytest.raises(FloatingPointError, match="nan"):
            torch.log(x)
        with pytest.raises(FloatingPointError, match="nan"):
            layer(torch.sqrt(x))  # the NaN of sqrt(-1), before the layer
    assert torch.isnan(torch.log(x)).any()


def test_assert_sharded_on_the_sharded_corpus():
    mesh = port_mesh(4)
    c = np.random.default_rng(0).normal(size=(10, 8)).astype(np.float32)
    index = RetrievalIndex(c, ["m"] * 10, [1] * 10, mesh=mesh, precision="int8")
    for x in (index._corpus, index._keys, index._corpus_scales):
        assert_sharded(x, "data", 0)
        assert len(x.parts) == 4 and x.shape[0] == 12
    with pytest.raises(AssertionError, match="sharded over 'model'"):
        assert_sharded(index._corpus, "model", 0)
    with pytest.raises(AssertionError, match="expected dim 1"):
        assert_sharded(index._corpus, "data", 1)
    one = RetrievalIndex(c, ["m"] * 10, [1] * 10, device="cpu")
    with pytest.raises(AssertionError, match="no sharding"):
        assert_sharded(one._corpus, "data", 0)
    assert one.mesh is None and isinstance(mesh, Mesh)
