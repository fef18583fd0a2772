"""The port's pipeline (``run``, ``process``, ``filter``, ``setup-db``,
``embed``, ``evaluate``, ``check``) and its ``Evaluator`` against the JAX
package on the CPU.

Stages 3-5 run over a directory that ``tpualign``'s stages 1-2 processed
from the golden corpus, and ``run`` starts from the raw manuals. With the
golden test's ``Sha256Engine`` the port's ``metrics.json`` must equal
``tests/golden/metrics.json``; with the port's own towers (the CLI, a
tiny variant, the device image feed) the shape-only metrics must, and with
a checkpoint file ``run`` must give tpualign's ``metrics.json``.
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
    # the first ingest cycle records the manuals (same rows), the next is a no-op
    assert len(pipe.ingest_cycle()["ingested"]) == 2
    assert pipe.store.counts("vanilla_clip") == before
    assert not pipe.ingest_cycle().get("ingested")


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
                           "IMAGE_PREPROCESS_BUCKET": "320", "LANGUAGE": "en",
                           "USE_OCR_FALLBACK": "yes", "MAX_FILE_SIZE_MB": "7",
                           "ALLOWED_FILE_TYPES": " pdf, docx ,", "SOFFICE_PATH": "/o/soffice",
                           "WORD_TO_PDF_TIMEOUT_SECONDS": "9", "CAPTION_LINKING": "spatial",
                           "CLIP_CHECKPOINT": "/w/clip.pt",
                           "CLIP_CHECKPOINT_ALLOW_PICKLE": "1"}):
        got = torch_config.load_config(overrides)
        want = jax_config.load_config(env_file=None, overrides=overrides)
        for name in ("image_preprocess", "image_preprocess_bucket", "eval_output_dir"):
            assert getattr(got, name) == getattr(want, name), name
        for field in dataclasses.fields(torch_config.DataConfig):
            assert getattr(got.data, field.name) == getattr(want.data, field.name), field.name
        assert got.data.images_dir == want.data.images_dir
        for name in ("checkpoint_path", "checkpoint_allow_pickle"):
            assert getattr(got.model, name) == getattr(want.model, name), name
    assert ({f.name for f in dataclasses.fields(torch_config.DataConfig)}
            == {f.name for f in dataclasses.fields(jax_config.DataConfig)})


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
    assert torch_cli.main(["run", "--skip-pdf", "--skip-lexical", "--skip-eval", "--force",
                           "--device", "cpu"]) == 1
    assert "tpualign_torch run: failed for clip_lexical" in capsys.readouterr().err
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


# -- from raw manuals: stages 1-2, run, the manifest, process/filter/check ---------------

def _raw(root: Path) -> dict:
    """The golden corpus as raw manuals; returns the overrides for both
    packages."""
    (root / "raw").mkdir()
    make_corpus(root / "raw", n_manuals=2, pages=2, imgs_per_page=2, lines_per_page=3)
    (root / "exclude.txt").write_text("pagina\n")
    return _overrides(root)


def _port_pipeline(overrides: dict) -> Pipeline:
    pipe = Pipeline(torch_config.load_config(overrides), engine=Sha256Engine(), device="cpu")
    pipe.store.embed_dim = Sha256Engine.dim
    return pipe


def test_run_from_raw_manuals_gives_the_golden_metrics(tmp_path, capsys):
    """``Pipeline.run`` from the raw manuals: tpualign's stage-1 and stage-2
    files, the four schemas, and ``tests/golden/metrics.json``."""
    overrides = _raw(tmp_path)
    pipe = _port_pipeline(overrides)
    assert pipe.run(non_interactive=True) == []
    out = capsys.readouterr().out
    assert "MULTIMODAL ALIGNMENT PIPELINE (tpualign_torch)" in out
    assert "Found " in out and "PIPELINE COMPLETE!" in out
    got = json.loads((tmp_path / "eval" / "metrics.json").read_text())
    _assert_metrics_equal(got, json.loads(GOLDEN.read_text()))

    jroot = tmp_path / "jax"
    jroot.mkdir()
    (jroot / "raw").symlink_to(tmp_path / "raw")
    (jroot / "exclude.txt").write_text("pagina\n")
    jpipe = JaxPipeline(jax_config.load_config(env_file=None, overrides=_overrides(jroot)),
                        engine=Sha256Engine())
    jpipe.store.embed_dim = Sha256Engine.dim
    jpipe.run(non_interactive=True)
    for name in ("image_metadata.json", "text_chunks.json", "lexical_components.json",
                 "filtered_lexical_components.json"):
        assert (json.loads((tmp_path / "processed" / name).read_text())
                == json.loads((jroot / "processed" / name).read_text())), name
    images = sorted(p.name for p in (tmp_path / "processed" / "images").iterdir())
    assert images == sorted(p.name for p in (jroot / "processed" / "images").iterdir())
    manifests = [json.loads((r / "processed" / ".tpualign_manifest.json").read_text())
                 for r in (tmp_path, jroot)]
    for m in manifests:
        m["document_processing"].pop("completed_at")
    assert manifests[0] == manifests[1]
    for schema in SCHEMAS:
        assert pipe.store.alignments(schema) == jpipe.store.alignments(schema), schema


@pytest.mark.parametrize("package", ["tpualign", "tpualign_torch"])
def test_manifest_resume_force_and_input_change(package, tmp_path, monkeypatch):
    """``tests/test_pipeline.py``'s manifest cases, each through both
    packages: a second run skips every stage, ``force`` recomputes the same
    counts, a touched input re-runs document processing, a missing input
    directory exits."""
    import os
    import time

    overrides = _raw(tmp_path)
    if package == "tpualign":
        def make():
            pipe = JaxPipeline(jax_config.load_config(env_file=None, overrides=overrides),
                               engine=Sha256Engine())
            pipe.store.embed_dim = Sha256Engine.dim
            return pipe
    else:
        def make():
            return _port_pipeline(overrides)
    pipe = make()
    pipe.run(non_interactive=True, skip_eval=True)
    before = pipe.store.counts("vanilla_clip")

    again = make()
    called = []
    monkeypatch.setattr(type(again.store), "insert_images",
                        lambda *a, **k: called.append("insert") or 0)
    monkeypatch.setattr(type(again.store), "setup", lambda *a, **k: called.append("setup"))
    processed = sorted((p.name, p.stat().st_mtime_ns)
                       for p in (tmp_path / "processed").glob("*.json"))
    again.run(non_interactive=True, skip_eval=True)
    assert called == []
    assert processed == sorted((p.name, p.stat().st_mtime_ns)
                               for p in (tmp_path / "processed").glob("*.json"))
    monkeypatch.undo()

    forced = make()
    forced.run(non_interactive=True, skip_eval=True, force=True)
    assert forced.store.counts("vanilla_clip") == before

    assert forced.check_document_processing()
    target = next((tmp_path / "raw").glob("*.synthdoc.json"))
    time.sleep(0.01)
    os.utime(target)
    assert not forced.check_document_processing()
    forced.step_document_processing()
    assert forced.check_document_processing()

    missing = {**overrides, "INPUT_DIR": str(tmp_path / "nope"),
               "OUTPUT_DIR": str(tmp_path / "out2")}
    pipe = (JaxPipeline(jax_config.load_config(env_file=None, overrides=missing),
                        engine=Sha256Engine()) if package == "tpualign"
            else Pipeline(torch_config.load_config(missing), engine=Sha256Engine(),
                          device="cpu"))
    with pytest.raises(SystemExit):
        pipe.step_document_processing()


def test_filtering_pause_and_skip(tmp_path, monkeypatch, capsys):
    """The operator's pause: Enter filters with the exclusion list,
    ``skip`` keeps every term unfiltered, as tpualign's."""
    overrides = _raw(tmp_path)
    pipe = _port_pipeline(overrides)
    with pytest.raises(SystemExit):
        pipe.step_lexical_filtering()  # nothing processed yet
    pipe.step_document_processing()
    monkeypatch.setattr("builtins.input", lambda: "skip")
    pipe.step_lexical_filtering()
    assert not pipe.check_lexical_filtering()
    assert "exclude.txt" in capsys.readouterr().out
    monkeypatch.setattr("builtins.input", lambda: "")
    pipe.step_lexical_filtering()
    filtered = json.loads(pipe.filtered_lexical_file.read_text())
    assert filtered["excluded_terms"] == ["pagina"]
    assert all(c["term"] != "pagina" for c in filtered["components"])


def test_process_and_filter_cli_match_tpualign(tmp_path, monkeypatch, capsys):
    import tpualign.cli as jax_cli

    _raw(tmp_path)
    monkeypatch.chdir(tmp_path)
    (tmp_path / "more.txt").write_text("regel\n# a comment\n")
    outs = {}
    for name, main in (("jax", jax_cli.main), ("port", torch_cli.main)):
        out = tmp_path / name
        argv = ["--env-file", "", "--input-dir", str(tmp_path / "raw"), "--output-dir",
                str(out), "--language", "nl"]
        assert main(["process", *argv]) == 0
        assert main(["filter", *argv, "--exclude-file", str(tmp_path / "more.txt")]) == 0
        outs[name] = ({p.name: p.read_bytes() for p in out.glob("*.json")},
                      {p.name: p.read_bytes() for p in (out / "images").iterdir()},
                      capsys.readouterr().out)
    assert outs["port"][1] == outs["jax"][1]
    assert outs["port"][2] == outs["jax"][2] and "Top 20 most frequent terms" in outs["port"][2]
    assert sorted(outs["port"][0]) == sorted(outs["jax"][0])
    for name in outs["jax"][0]:
        want, got = (json.loads(outs[k][0][name]) for k in ("jax", "port"))
        if name == ".tpualign_manifest.json":
            for m in (want, got):
                m["document_processing"].pop("completed_at")
        assert got == want, name
    filtered = json.loads(outs["port"][0]["filtered_lexical_components.json"])
    assert filtered["excluded_terms"] == ["regel"]


def test_cli_run_with_a_checkpoint_matches_tpualign(tmp_path, monkeypatch, capsys,
                                                    tiny_variant):
    """``python -m tpualign_torch run --non-interactive --device cpu`` with a
    tiny CLIP_CHECKPOINT (OpenCLIP layout) against ``tpualign run`` with the
    same file: the same metrics.json."""
    import tpualign.cli as jax_cli
    from tests.test_models import TINY as JAX_TINY
    from tests.test_torch_loader import save, to_openclip
    from tpualign.models.clip import CLIP as JaxCLIP
    from tpualign.models.clip import init_clip_params as jax_init

    jax_tiny = dataclasses.replace(JAX_TINY, context_length=77)
    monkeypatch.setitem(jax_config.CLIP_VARIANTS, "tiny", jax_tiny)
    import jax
    import jax.numpy as jnp

    tree = jax.tree.map(np.asarray, jax_init(
        JaxCLIP(variant=jax_tiny, use_quick_gelu=True, compute_dtype=jnp.float32), seed=3))
    ckpt = save(to_openclip(tree), tmp_path / "clip", "pt")
    (tmp_path / "raw").mkdir()
    make_corpus(tmp_path / "raw", n_manuals=2, pages=2, imgs_per_page=2, lines_per_page=3)
    (tmp_path / "exclude.txt").write_text("pagina\n")
    monkeypatch.chdir(tmp_path)
    for key, value in {"CLIP_MODEL": "tiny", "CLIP_CHECKPOINT": ckpt,
                       "COMPUTE_DTYPE": "float32", "BATCH_SIZE": "4", "LANGUAGE": "nl",
                       "INPUT_DIR": str(tmp_path / "raw"),
                       "EXCLUDE_TERMS_FILE": str(tmp_path / "exclude.txt")}.items():
        monkeypatch.setenv(key, value)
    metrics = {}
    for name, main, extra in (("jax", jax_cli.main, []),
                              ("port", torch_cli.main, ["--device", "cpu"])):
        for key, sub in (("OUTPUT_DIR", "processed"), ("STORE_DIR", "store"),
                         ("EVAL_OUTPUT_DIR", "eval")):
            monkeypatch.setenv(key, str(tmp_path / name / sub))
        assert main(["run", "--non-interactive", "--env-file", "", *extra]) == 0
        metrics[name] = json.loads((tmp_path / name / "eval" / "metrics.json").read_text())
    _assert_metrics_equal(metrics["port"], metrics["jax"])
    _assert_metrics_equal(metrics["port"], json.loads(GOLDEN.read_text()), avg_similarity=False)
    assert "PIPELINE COMPLETE!" in capsys.readouterr().out


def test_check_exits_as_tpualign(tmp_path, monkeypatch, capsys):
    """``check`` prints tpualign's sections and exits 0 when the imports
    and the devices are there, 1 when they are not: the port asks for a
    CUDA card, tpualign for JAX devices."""
    import jax

    import tpualign.cli as jax_cli

    overrides = _raw(tmp_path)
    _port_pipeline(overrides).run(non_interactive=True, skip_eval=True)
    monkeypatch.chdir(tmp_path)
    for key, value in overrides.items():
        monkeypatch.setenv(key, value)
    sections = ["imports:", "devices:", "directories:", "native:", "store:", "bbox quality:"]

    def run(main):
        code = main(["check", "--env-file", ""])
        out = capsys.readouterr().out
        assert [line for line in out.splitlines() if line in sections] == sections
        return code, out

    code, out = run(jax_cli.main)
    assert code == 0 and "RESULT: healthy" in out
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    code, out = run(torch_cli.main)
    assert code == 1 and "RESULT: PROBLEMS FOUND" in out and "CUDA is not available" in out
    assert "images with valid bbox: 8/8 (100.00%)" in out and "vanilla_clip: {" in out
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    monkeypatch.setattr(torch.cuda, "get_device_name", lambda i=0: "NVIDIA H100 80GB HBM3")
    code, out = run(torch_cli.main)
    assert code == 0 and "RESULT: healthy" in out and "cuda:0 NVIDIA H100 80GB HBM3" in out

    def no_devices(*a, **k):
        raise RuntimeError("no backend")

    monkeypatch.setattr(jax, "devices", no_devices)
    code, out = run(jax_cli.main)
    assert code == 1 and "RESULT: PROBLEMS FOUND" in out


def test_run_needs_cuda_unless_cpu_is_asked(tmp_path, monkeypatch):
    """``run`` raises without a card unless ``--device cpu`` is given;
    ``process`` and ``filter`` are host work and need none."""
    overrides = _raw(tmp_path)
    monkeypatch.chdir(tmp_path)
    for key, value in overrides.items():
        monkeypatch.setenv(key, value)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        torch_cli.main(["run", "--non-interactive", "--env-file", ""])
    assert torch_cli.main(["process", "--env-file", ""]) == 0
    assert torch_cli.main(["filter", "--env-file", ""]) == 0
    assert (tmp_path / "processed" / "filtered_lexical_components.json").exists()
