"""The port's pipeline stages 3-5 (``setup-db``, ``embed``, ``evaluate``)
and its ``Evaluator`` against the JAX package on the CPU.

Stages 1-2 (document processing, lexical filtering) run through
``tpualign``'s ``Pipeline`` on the golden corpus into a processed
directory; the port then runs stages 3-5 over it. With the golden test's
``Sha256Engine`` the port's ``metrics.json`` must equal
``tests/golden/metrics.json``; with the port's own towers (the CLI, a
tiny variant, the device image feed) the shape-only metrics must.
"""

import dataclasses
import json
from pathlib import Path

import numpy as np
import pytest
import torch

from tests.test_golden import GOLDEN, Sha256Engine
from tests.test_models import TINY
from tests.test_pipeline import make_corpus
from tpualign import config as jax_config
from tpualign.evaluation import Evaluator as JaxEvaluator
from tpualign.pipeline import Pipeline as JaxPipeline
from tpualign.store import EmbeddingStore as JaxStore
from tpualign_torch import cli as torch_cli
from tpualign_torch import config as torch_config
from tpualign_torch.evaluation import Evaluator
from tpualign_torch.pipeline import Pipeline
from tpualign_torch.store import SCHEMAS, EmbeddingStore

pytestmark = pytest.mark.fast


def _overrides(root: Path) -> dict:
    return {"INPUT_DIR": str(root / "raw"), "OUTPUT_DIR": str(root / "processed"),
            "STORE_DIR": str(root / "store"), "EVAL_OUTPUT_DIR": str(root / "eval"),
            "EXCLUDE_TERMS_FILE": str(root / "exclude.txt"), "LANGUAGE": "nl"}


def _processed(root: Path) -> dict:
    """tpualign's stages 1-2 over the golden corpus; returns the overrides
    that point both packages at it."""
    (root / "raw").mkdir()
    make_corpus(root / "raw", n_manuals=2, pages=2, imgs_per_page=2, lines_per_page=3)
    (root / "exclude.txt").write_text("pagina\n")
    overrides = _overrides(root)
    jpipe = JaxPipeline(jax_config.load_config(env_file=None, overrides=overrides),
                        engine=Sha256Engine())
    jpipe.step_document_processing()
    jpipe.step_lexical_filtering(non_interactive=True)
    return overrides


def _assert_metrics_equal(got: dict, want: dict, avg_similarity: bool = True) -> None:
    """``tests/test_golden.py``'s comparison."""
    assert got.keys() == want.keys()
    for schema in want:
        g, w = got[schema], want[schema]
        assert g["num_pairs"] == w["num_pairs"], schema
        np.testing.assert_allclose(g["mrr"], w["mrr"], atol=1e-6, err_msg=schema)
        if avg_similarity:
            np.testing.assert_allclose(g["avg_similarity"], w["avg_similarity"], atol=1e-5,
                                       err_msg=schema)
        for k in ("1", "5", "10"):
            np.testing.assert_allclose(g["top_k"][k], w["top_k"][k], atol=1e-6,
                                       err_msg=f"{schema} top-{k}")


def test_golden_metrics_through_the_port(tmp_path):
    overrides = _processed(tmp_path)
    config = torch_config.load_config(overrides)
    pipe = Pipeline(config, engine=Sha256Engine(), device="cpu")
    pipe.store.embed_dim = Sha256Engine.dim
    assert not pipe.check_store_setup()
    pipe.step_store_setup()
    assert pipe.check_store_setup()
    pipe.step_insert_embeddings()
    assert all(pipe.check_embeddings_inserted(s) for s in SCHEMAS)
    metrics = pipe.step_evaluation()
    got = json.loads((tmp_path / "eval" / "metrics.json").read_text())
    _assert_metrics_equal(got, json.loads(GOLDEN.read_text()))
    assert json.loads(json.dumps(metrics)) == got
    for chart in ("similarity_distributions", "top_k_comparison", "weak_supervision_scores"):
        assert (tmp_path / "eval" / f"{chart}.png").exists()

    # tpualign's stages 3-4 over the same processed outputs store the same
    # alignment records for every schema
    jconfig = jax_config.load_config(env_file=None, overrides={
        **overrides, "STORE_DIR": str(tmp_path / "jax_store")})
    jpipe = JaxPipeline(jconfig, engine=Sha256Engine())
    jpipe.store.embed_dim = Sha256Engine.dim
    jpipe.step_store_setup()
    jpipe.step_insert_embeddings()
    for schema in SCHEMAS:
        assert pipe.store.alignments(schema) == jpipe.store.alignments(schema), schema
        assert pipe.store.counts(schema) == jpipe.store.counts(schema), schema


def test_stages_skip_and_force(tmp_path, caplog):
    overrides = _processed(tmp_path)
    pipe = Pipeline(torch_config.load_config(overrides), engine=Sha256Engine(), device="cpu")
    pipe.store.embed_dim = Sha256Engine.dim
    pipe.step_store_setup()
    pipe.step_insert_embeddings(schemas=["vanilla_clip"])
    assert pipe.check_embeddings_inserted("vanilla_clip")
    assert not pipe.check_embeddings_inserted("clip_combined")
    before = pipe.store.counts("vanilla_clip")
    pipe.step_insert_embeddings(schemas=["vanilla_clip"])  # done: skipped
    assert pipe.store.counts("vanilla_clip") == before
    pipe.step_insert_embeddings(force=True)
    assert all(pipe.check_embeddings_inserted(s) for s in SCHEMAS)
    for step in (pipe.step_document_processing, pipe.step_lexical_filtering, pipe.run,
                 pipe.ingest_cycle, pipe.watch):
        with pytest.raises(NotImplementedError, match="ROADMAP"):
            step()


def _random_store(store_cls, root, seed, dim=16):
    """A store of random unit embeddings over 3 manuals x 4 pages (one
    page without chunks, one image without a page) and weak alignments."""
    rng = np.random.default_rng(seed)
    images, chunks = [], []
    for m in range(3):
        for p in range(4):
            for i in range(1 + (m + p) % 3):
                images.append({"image_id": f"m{m}p{p}i{i}", "manual_id": f"m{m}", "page": p,
                               "filename": None})
            for c in range(0 if (m, p) == (2, 3) else 2 + (m * p) % 9):
                chunks.append({"chunk_id": f"m{m}p{p}c{c}", "manual_id": f"m{m}", "page": p,
                               "text": f"chunk {c}"})
    images.append({"image_id": "loose", "manual_id": "m0", "page": None, "filename": None})
    img = rng.normal(size=(len(images), dim)).astype(np.float32)
    chk = rng.normal(size=(len(chunks), dim)).astype(np.float32)
    img /= np.linalg.norm(img, axis=1, keepdims=True)
    chk /= np.linalg.norm(chk, axis=1, keepdims=True)
    chk[5] = chk[4]  # a tie inside one page
    aligns = [(images[i]["image_id"], chunks[j]["chunk_id"], float(s), t)
              for i, j, s, t in zip(rng.integers(0, len(images), 40),
                                    rng.integers(0, len(chunks), 40), rng.random(40),
                                    rng.choice(["lexical", "positional", "combined"], 40))]
    store = store_cls(str(root), embed_dim=dim)
    store.setup(SCHEMAS)
    for schema in SCHEMAS:
        store.insert_images(schema, images, img)
        store.insert_chunks(schema, chunks, chk)
        if schema != "vanilla_clip":
            store.insert_alignments(schema, aligns)
    store.save(SCHEMAS)
    return store


def test_evaluator_matches_jax(tmp_path):
    port = Evaluator(_random_store(EmbeddingStore, tmp_path / "a", 3),
                     output_dir=str(tmp_path / "ea"), device="cpu")
    ref = JaxEvaluator(_random_store(JaxStore, tmp_path / "b", 3), output_dir=str(tmp_path / "eb"))
    for schema in SCHEMAS:
        got, want = port.evaluate_schema(schema), ref.evaluate_schema(schema)
        assert got["num_pairs"] == want["num_pairs"]
        for k in (1, 5, 10):
            assert got["top_k"][k] == pytest.approx(want["top_k"][k], abs=1e-6)
        assert got["mrr"] == pytest.approx(want["mrr"], abs=1e-6)
        assert got["avg_similarity"] == pytest.approx(want["avg_similarity"], abs=1e-6)
        for k, v in port.compute_top_k_accuracy(schema, (1, 3, 20), gt="alignments").items():
            assert v == pytest.approx(ref.compute_top_k_accuracy(schema, (1, 3, 20),
                                                                 gt="alignments")[k], abs=1e-6)
        assert port.compute_mrr(schema, gt="alignments") == pytest.approx(
            ref.compute_mrr(schema, gt="alignments"), abs=1e-6)
        assert port.get_weak_supervision_scores(schema) == ref.get_weak_supervision_scores(schema)
        np.testing.assert_allclose(port.pair_similarities(schema), ref.pair_similarities(schema),
                                   atol=1e-6)
    port.print_metrics_report(list(SCHEMAS))
    ref.print_metrics_report(list(SCHEMAS))
    got = json.loads((tmp_path / "ea" / "metrics.json").read_text())
    _assert_metrics_equal(got, json.loads((tmp_path / "eb" / "metrics.json").read_text()))


def test_pipeline_config_matches_jax(tmp_path, monkeypatch):
    monkeypatch.chdir(tmp_path)
    for overrides in ({}, {**_overrides(Path("/x")), "IMAGE_PREPROCESS": "device",
                           "IMAGE_PREPROCESS_BUCKET": "320", "LANGUAGE": "en"}):
        got = torch_config.load_config(overrides)
        want = jax_config.load_config(env_file=None, overrides=overrides)
        for name in ("image_preprocess", "image_preprocess_bucket", "eval_output_dir"):
            assert getattr(got, name) == getattr(want, name), name
        for name in ("output_dir", "images_dir"):
            assert getattr(got.data, name) == getattr(want.data, name), name


@pytest.fixture
def tiny_variant(monkeypatch):
    tiny = torch_config.ClipVariant(**{**dataclasses.asdict(TINY), "name": "tiny",
                                       "context_length": 77})
    monkeypatch.setitem(torch_config.CLIP_VARIANTS, "tiny", tiny)
    return tiny


def test_cli_stages_with_the_device_feed(tmp_path, monkeypatch, tiny_variant, capsys):
    """``python -m tpualign_torch setup-db/embed/evaluate --device cpu`` in
    process, ViT towers of a tiny variant, ``IMAGE_PREPROCESS=device``: the
    four schemas, unit-norm embeddings, tpualign's alignment records, and
    the golden file's metrics but the similarity (which depends on the
    towers' weights; the rest depends on the corpus alone)."""
    overrides = _processed(tmp_path)
    monkeypatch.chdir(tmp_path)
    for key, value in {**overrides, "CLIP_MODEL": "tiny", "IMAGE_PREPROCESS": "device",
                       "IMAGE_PREPROCESS_BUCKET": "48", "COMPUTE_DTYPE": "float32",
                       "BATCH_SIZE": "4"}.items():
        monkeypatch.setenv(key, value)
    assert torch_cli.main(["setup-db", "--device", "cpu"]) == 0
    assert torch_cli.main(["embed", "nope", "--device", "cpu"]) == 1
    assert torch_cli.main(["embed", "--device", "cpu"]) == 0
    assert torch_cli.main(["evaluate", "--device", "cpu"]) == 0
    assert "MULTIMODAL ALIGNMENT EVALUATION REPORT" in capsys.readouterr().out

    got = json.loads((tmp_path / "eval" / "metrics.json").read_text())
    _assert_metrics_equal(got, json.loads(GOLDEN.read_text()), avg_similarity=False)
    store = EmbeddingStore(str(tmp_path / "store"), embed_dim=tiny_variant.embed_dim)
    jstore = JaxStore(str(tmp_path / "jax_store"), embed_dim=tiny_variant.embed_dim)
    jpipe = JaxPipeline(jax_config.load_config(env_file=None, overrides={
        **overrides, "STORE_DIR": jstore.root}), engine=Sha256Engine(), store=jstore)
    jpipe.step_store_setup()
    jpipe.step_insert_embeddings()
    for schema in SCHEMAS:
        assert np.isfinite(got[schema]["avg_similarity"])
        for table in ("images", "text_chunks"):
            _, emb = store.embedding_matrix(schema, table)
            np.testing.assert_allclose(np.linalg.norm(emb, axis=1), 1.0, atol=1e-5)
        assert store.alignments(schema) == jstore.alignments(schema), schema


def test_cli_stages_exit_nonzero_when_a_schema_fails(tmp_path, monkeypatch, capsys):
    """A schema's failure is logged and the stage goes on with the next, as
    in tpualign, but ``embed`` and ``evaluate`` then exit with 1."""
    from tpualign_torch import pipeline as torch_pipeline

    overrides = _processed(tmp_path)
    monkeypatch.chdir(tmp_path)
    for key, value in overrides.items():
        monkeypatch.setenv(key, value)
    monkeypatch.setattr(torch_pipeline.Pipeline, "engine", Sha256Engine())
    real_alignments = torch_pipeline.compute_alignments

    def alignments(images, chunks, terms, use_lex, use_pos, **kw):
        if use_lex and not use_pos:
            raise RuntimeError("broken lexical scorer")
        return real_alignments(images, chunks, terms, use_lex, use_pos, **kw)

    monkeypatch.setattr(torch_pipeline, "compute_alignments", alignments)
    assert torch_cli.main(["setup-db", "--device", "cpu"]) == 0
    assert torch_cli.main(["embed", "vanilla_clip", "--device", "cpu"]) == 0
    assert torch_cli.main(["embed", "--device", "cpu"]) == 1
    assert "failed for clip_lexical" in capsys.readouterr().err
    monkeypatch.setattr(torch_pipeline, "compute_alignments", real_alignments)
    assert torch_cli.main(["embed", "clip_lexical", "--force", "--device", "cpu"]) == 0
    assert torch_cli.main(["evaluate", "--device", "cpu"]) == 0

    real_evaluate = Evaluator.evaluate_schema

    def evaluate(self, schema):
        if schema == "clip_positional":
            raise RuntimeError("kernel launch failed")
        return real_evaluate(self, schema)

    monkeypatch.setattr(Evaluator, "evaluate_schema", evaluate)
    assert torch_cli.main(["evaluate", "--device", "cpu"]) == 1
    assert "failed for clip_positional" in capsys.readouterr().err
    got = json.loads((tmp_path / "eval" / "metrics.json").read_text())
    assert sorted(got) == sorted(set(SCHEMAS) - {"clip_positional"})


def test_cli_stages_need_cuda_unless_cpu_is_asked(tmp_path, monkeypatch):
    monkeypatch.chdir(tmp_path)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    monkeypatch.setenv("STORE_DIR", str(tmp_path / "store"))
    for argv in (["setup-db"], ["embed"], ["evaluate"]):
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            torch_cli.main(argv)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        Pipeline(torch_config.load_config())
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        Evaluator(EmbeddingStore(str(tmp_path / "store")))
