"""The port's trainer, checkpoints, ``TrainConfig`` and ``train`` CLI
(``tpualign_torch.train.trainer``, ``train.checkpoint``, ``config``,
``cli``) against tpualign's on the CPU, over the same small store and the
same converted tiny tree (fp32): the pair dataset, the feed's batches for
one seed (host and device feed), the held-out evaluation, the teacher
bank, a 5-step ``Trainer.train`` in both packages (per-step loss and
``grad_norm``, the exported params), the checkpoint round trip and
``CLIP_CHECKPOINT=<dir>`` into ``EmbedEngine``, and the CLI. Tolerances
are ``tests/test_torch_train.py``'s."""

import dataclasses
import json
import multiprocessing
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import tpualign.config as jax_config
import tpualign_torch.config as torch_config
from tests.test_models import TINY
from tests.test_torch_train import (  # noqa: F401  (jax_pair is a fixture)
    assert_params_close, flat, jax_grads, jax_pair)
from tests.test_trainer import small_store  # noqa: F401  (a fixture)
from tpualign.train import trainer as jax_trainer
from tpualign_torch.models.convert import to_jax_layout
from tpualign_torch.parallel.embed import EmbedEngine
from tpualign_torch.store import EmbeddingStore
from tpualign_torch.train import checkpoint as ckpt
from tpualign_torch.train import step as torch_step
from tpualign_torch.train import trainer as torch_trainer

pytestmark = pytest.mark.fast

TRAIN_KEYS = ("TRAIN_IMAGE_FEED", "TRAIN_AUGMENT", "LORA_RANK", "EMA_DECAY", "GRAD_ACCUM_STEPS",
              "PATCH_MASK_RATIO", "LOSS_TYPE", "TEXT_BUCKETS", "CLIP_CHECKPOINT",
              "DISTILL_CHECKPOINT", "DISTILL_MODEL", "TRAIN_FSDP", "MOMENTS_DTYPE")


@pytest.fixture
def tiny(monkeypatch):
    """``tiny`` in both packages' variant tables; no training key leaks in
    from an earlier test's env file."""
    monkeypatch.setitem(jax_config.CLIP_VARIANTS, "tiny", TINY)
    monkeypatch.setitem(torch_config.CLIP_VARIANTS, "tiny",
                        torch_config.ClipVariant(**dataclasses.asdict(TINY)))
    for key in TRAIN_KEYS:
        monkeypatch.delenv(key, raising=False)


def overrides(store, images_dir, **kw):
    out = {"STORE_DIR": str(store.root), "OUTPUT_DIR": str(images_dir.parent),
           "CLIP_MODEL": "tiny", "COMPUTE_DTYPE": "float32", "LEARNING_RATE": "1e-3",
           "WARMUP_STEPS": "0", "TOTAL_STEPS": "100", "SEED": "0"}
    out.update({k: str(v) for k, v in kw.items()})
    return out


def port_store(store) -> EmbeddingStore:
    """The port's store over the fixture's (tpualign's) directory."""
    store.save()
    return EmbeddingStore(store.root, embed_dim=16)


def trainers(store, images_dir, tree, **kw):
    """tpualign's and the port's Trainer over one store and tree."""
    ov = overrides(store, images_dir, **kw)
    # a copy: tpualign's jitted step donates the state, and the tree is shared
    jt = jax_trainer.Trainer(jax_config.load_config(env_file=None, overrides=ov), store=store,
                             params=jax.tree.map(lambda x: jnp.array(x, copy=True), tree))
    tt = torch_trainer.Trainer(torch_config.load_config(ov), params=jax.tree.map(
        np.asarray, tree), store=port_store(store), device="cpu")
    return jt, tt


# -- data -----------------------------------------------------------------------------


@pytest.mark.parametrize("schema", ["clip_combined", "vanilla_clip"])
def test_build_pair_dataset_matches_jax(small_store, schema):  # noqa: F811
    store, images_dir = small_store
    want = jax_trainer.build_pair_dataset(store, schema, images_dir)
    got = torch_trainer.build_pair_dataset(port_store(store), schema, images_dir)
    assert got == want and len(got) == (6 if schema == "clip_combined" else 36)


@pytest.mark.parametrize("feed", ["host", "device"])
def test_batches_match_jax(small_store, tiny, jax_pair, feed):  # noqa: F811
    """Two epochs of the feed for one seed, from the port's worker process
    and tpualign's thread: the same images (pixels, or uint8 buckets and
    sizes), tokens (bucketed), weights and extras, batch for batch, in the
    same dtypes; a missing file is a zero image whose weight stays."""
    store, images_dir = small_store
    _, tree = jax_pair
    jt, tt = trainers(store, images_dir, tree, TRAIN_IMAGE_FEED=feed,
                      IMAGE_PREPROCESS_BUCKET=64, TEXT_BUCKETS="8,12")
    triples = jax_trainer.build_pair_dataset(store, "clip_combined", images_dir)
    triples[0] = (str(images_dir / "nope.png"), triples[0][1], 0.7)
    extra = (np.arange(len(triples), dtype=np.float32)[:, None],)
    want = list(jt.batches(triples, 4, seed=5, epochs=2, extras=extra))
    got = list(tt.batches(triples, 4, seed=5, epochs=2, extras=extra))
    assert len(got) == len(want) == 2
    for g, w in zip(got, want):
        assert len(g) == len(w) == 4
        for a, b in zip(jax.tree.leaves(g), jax.tree.leaves(w)):
            assert a.dtype == b.dtype
            np.testing.assert_array_equal(a, b)
        assert g[1].shape[1] in (8, 12, TINY.context_length)
        if feed == "device":
            assert len(g[0]) == 2
    assert any(float(w) == np.float32(0.7) for _, _, ws, _ in got for w in ws)


@pytest.mark.parametrize("feed", ["host", "device"])
def test_batches_extras_errors_and_close(small_store, tiny, jax_pair, feed):  # noqa: F811
    """Extras follow the shuffle; an error in the worker process reaches the
    consumer; closing the generator ends the worker process."""
    store, images_dir = small_store
    _, tree = jax_pair
    _, tt = trainers(store, images_dir, tree, TRAIN_IMAGE_FEED=feed, IMAGE_PREPROCESS_BUCKET=64)
    triples = jax_trainer.build_pair_dataset(store, "clip_combined", images_dir)
    extra = np.arange(len(triples), dtype=np.float32)[:, None]
    rng = np.random.default_rng(3)
    order = rng.permutation(len(triples))[:4]
    *_, e = next(tt.batches(triples, 4, seed=3, extras=(extra,)))
    np.testing.assert_array_equal(e[:, 0], order)
    with pytest.raises(ValueError, match="extras rows"):
        next(tt.batches(triples, 4, extras=(extra[:2],)))
    # an error that escapes the producer reaches the consumer
    with pytest.raises(RuntimeError, match="feed producer"):
        next(tt.batches(triples[:2] + [("missing", "text")], batch_size=3, epochs=1))
    it = tt.batches(triples, 2, seed=0)
    next(it)
    it.close()
    for _ in range(50):
        if not multiprocessing.active_children():
            break
        time.sleep(0.1)
    assert not multiprocessing.active_children()


# -- evaluation and distillation --------------------------------------------------------


def test_evaluate_heldout_matches_jax(small_store, tiny, jax_pair):  # noqa: F811
    store, images_dir = small_store
    _, tree = jax_pair
    jt, tt = trainers(store, images_dir, tree)
    triples = jax_trainer.build_pair_dataset(store, "vanilla_clip", images_dir)[:20]
    want = jt.evaluate_heldout(triples, k=(1, 3))
    got = tt.evaluate_heldout(triples, k=(1, 3))
    assert got.keys() == want.keys()
    for k in want:
        assert got[k] == pytest.approx(want[k], abs=1e-9), k
    assert tt._prepare_heldout(triples) is tt._prepare_heldout(triples)


def test_teacher_bank_matches_jax(small_store, tiny, jax_pair):  # noqa: F811
    """The teacher bank (a wider teacher, duplicates sharing rows) equals
    tpualign's within the towers' 1e-5, and a distillation step runs."""
    from tests.test_distill import teacher_model
    from tpualign.models.clip import init_clip_params as jax_init
    from tpualign_torch.models.clip import CLIP

    store, images_dir = small_store
    _, tree = jax_pair
    jt, tt = trainers(store, images_dir, tree)
    jteacher = teacher_model()
    ttree = jax_init(jteacher, seed=7)
    jt.set_teacher(jteacher, ttree)
    tv = torch_config.ClipVariant(**dataclasses.asdict(jteacher.variant))
    tt.set_teacher(CLIP(tv, True, torch.float32), jax.tree.map(np.asarray, ttree))
    triples = jax_trainer.build_pair_dataset(store, "clip_combined", images_dir)
    triples = triples + [triples[0]]
    want = jt._teacher_bank(triples)
    got = tt._teacher_bank(triples)
    for a, b in zip(got, want):
        np.testing.assert_allclose(a, b, atol=1e-5)
    np.testing.assert_array_equal(got[0][0], got[0][-1])
    out = tt.train(schema="clip_combined", steps=2, batch_size=2)
    assert out["distill_kl"] > 0.0 and np.isfinite(out["loss"])


# -- the training loop ---------------------------------------------------------------------


def _record_jax_grads(jt, cfg):
    """Wrap tpualign's jitted step to record each step's gradient."""
    grads = []
    step = jt._step

    def rec(state, images, tokens, weak, *rest):
        grads.append(jax.tree.map(np.asarray, jax_grads(jt.model, state, images, tokens, weak,
                                                        cfg)))
        return step(state, images, tokens, weak, *rest)

    jt._step = rec
    return grads


@pytest.mark.parametrize("feed", ["host", "device"])
def test_trainer_train_matches_jax(small_store, tiny, jax_pair, tmp_path, feed):  # noqa: F811
    """The slice as a whole: tpualign's ``Trainer.train`` and the port's
    from one converted tree, 5 steps of batch 4 with EMA: the per-step loss
    and grad_norm of the metrics files, and the exported params. Adam's
    first step moves every param by about lr·sign(g), so an element whose
    near-zero gradient the two summation orders give opposite signs ends
    1-2 lr apart, and that feeds the later gradients: at lr 1e-3 this tiny
    batch's grad_norm drifts to 6e-5 by step 2, so the run uses lr 1e-4."""
    store, images_dir = small_store
    _, tree = jax_pair
    jt, tt = trainers(store, images_dir, tree, EMA_DECAY=0.5, TRAIN_IMAGE_FEED=feed,
                      IMAGE_PREPROCESS_BUCKET=64, LEARNING_RATE=1e-4)
    grads = _record_jax_grads(jt, jt.config.train)
    files = {}
    for name, t in (("jax", jt), ("torch", tt)):
        files[name] = tmp_path / f"{name}.jsonl"
        out = t.train(schema="clip_combined", steps=5, batch_size=4, log_every=1,
                      metrics_file=str(files[name]))
        assert np.isfinite(out["loss"])
    rows = {n: [json.loads(x) for x in f.read_text().splitlines()] for n, f in files.items()}
    assert [r["kind"] for r in rows["torch"]] == [r["kind"] for r in rows["jax"]]
    for g, w in zip(rows["torch"], rows["jax"]):
        assert g["step"] == w["step"]
        if g["kind"] != "train":
            continue
        # the device preprocess may differ by a uint8 step: 1e-3. The
        # grad_norm carries the sign-flip drift above: 8e-6 at step 3 and
        # 1.5e-5 at step 5 (measured), so it compares at 5e-5
        host = feed == "host"
        assert g.keys() == w.keys()
        np.testing.assert_allclose(g["loss"], w["loss"], rtol=1e-5 if host else 1e-3)
        np.testing.assert_allclose(g["grad_norm"], w["grad_norm"], rtol=5e-5 if host else 1e-3)
    assert len(grads) == 5 and tt.state.step == 5
    if feed == "host":
        assert_params_close(to_jax_layout(tt.export_params),
                            jax.tree.map(np.asarray, jt.export_params), grads, lr=1e-4)


def test_train_errors_like_jax(small_store, tiny, jax_pair):  # noqa: F811
    store, images_dir = small_store
    _, tree = jax_pair
    store.setup(["clip_lexical"])  # a schema without pairs
    jt, tt = trainers(store, images_dir, tree)
    for t in (jt, tt):
        with pytest.raises(ValueError, match="set together"):
            t.train(schema="clip_combined", steps=1, eval_fraction=0.3)
        with pytest.raises(ValueError, match="no trainable pairs"):
            t.train(schema="clip_lexical", steps=1)
    # TRAIN_FSDP without a mesh changes nothing, in both packages
    jt, tt = trainers(store, images_dir, tree, TRAIN_FSDP="1")
    assert tt.config.train.fsdp and tt.state.mesh is None
    got = tt.train(schema="clip_combined", steps=1, batch_size=2)
    want = jt.train(schema="clip_combined", steps=1, batch_size=2)
    np.testing.assert_allclose(got["loss"], want["loss"], rtol=1e-5)


def test_train_heldout_resume_and_metrics_file(small_store, tiny, jax_pair, tmp_path):  # noqa: F811
    """Held-out evaluation at start, interval and end; a checkpoint every
    2 steps; a new trainer resumes at the saved step and runs the rest."""
    store, images_dir = small_store
    _, tree = jax_pair
    _, tt = trainers(store, images_dir, tree)
    mf, ck = tmp_path / "h.jsonl", tmp_path / "ck"
    out = tt.train(schema="clip_combined", steps=4, batch_size=2, log_every=2, eval_every=2,
                   eval_fraction=0.34, metrics_file=str(mf), ckpt_dir=str(ck), ckpt_every=2)
    lines = [json.loads(x) for x in mf.read_text().splitlines()]
    assert [r["step"] for r in lines if r["kind"] == "train"] == [2, 4]
    assert [r["step"] for r in lines if r["kind"] == "heldout"] == [0, 2, 4]
    assert [r["step"] for r in out["heldout"]] == [0, 2, 4]
    assert ckpt.latest_step(ck) == 4 and sorted(p.name for p in ck.iterdir()) == ["2", "4"]
    _, again = trainers(store, images_dir, tree)
    again.train(schema="clip_combined", steps=6, batch_size=2, ckpt_dir=str(ck))
    assert again.state.step == 6 and ckpt.latest_step(ck) == 6


# -- checkpoints ----------------------------------------------------------------------------


def _state(tree, **kw):
    from tests.test_torch_train import torch_model

    model = torch_model(tree)
    cfg = torch_config.TrainConfig(learning_rate=1e-3, warmup_steps=0, total_steps=10, **kw)
    return model, cfg, torch_step.create_train_state(model, torch_step.model_params(model), cfg)


def _step(model, cfg, state, seed=0):
    from tests.test_train import batch_for

    images, tokens, weak = batch_for(TINY, 4, np.random.default_rng(seed))
    return torch_step.train_step(state, model, torch.from_numpy(images),
                                 torch.from_numpy(tokens).long(), torch.from_numpy(weak), cfg)[0]


@pytest.mark.parametrize("kind", ["plain", "ema", "lora", "bf16_moments"])
def test_checkpoint_round_trip(jax_pair, tmp_path, kind):
    """save -> restore into a fresh state: params, moments, count, step,
    the EMA and the frozen base; the newest three saves kept;
    ``load_trained_params`` gives the EMA (or the LoRA merge) in the JAX
    layout."""
    _, tree = jax_pair
    kw = {"plain": {}, "ema": {"ema_decay": 0.9}, "lora": {"lora_rank": 4, "lora_alpha": 8.0},
          "bf16_moments": {"moments_dtype": "bfloat16"}}[kind]
    model, cfg, state = _state(tree, **kw)
    for i in range(4):
        state = _step(model, cfg, state, seed=i)
        ckpt.save_checkpoint(tmp_path, state)
    assert ckpt.latest_step(tmp_path) == 4
    assert sorted(int(p.name) for p in tmp_path.iterdir()) == [2, 3, 4]
    _, _, fresh = _state(tree, **kw)
    restored = ckpt.restore_checkpoint(tmp_path, fresh)
    assert restored.step == 4 and restored.opt_state["count"] == 4
    for name in ("params", "ema_params", "frozen_params"):
        a, b = getattr(restored, name), getattr(state, name)
        assert (a is None) == (b is None)
        for k in b or {}:
            assert torch.equal(a[k], b[k]) and a[k].dtype == b[k].dtype, (name, k)
    for part in ("mu", "nu"):
        for k, v in state.opt_state[part].items():
            assert torch.equal(restored.opt_state[part][k], v)
    loaded = flat(ckpt.load_trained_params(tmp_path))
    want = flat(to_jax_layout(torch_step.export_params(state)))
    assert loaded.keys() == want.keys()
    for k in want:
        np.testing.assert_array_equal(loaded[k], want[k], err_msg=k)
    older = flat(ckpt.load_trained_params(tmp_path, step=3))
    assert any(not np.array_equal(older[k], want[k]) for k in want)


def test_restore_pre_ema_checkpoint_starts_the_average(jax_pair, tmp_path):
    _, tree = jax_pair
    model, cfg, state = _state(tree)
    state = _step(model, cfg, state)
    ckpt.save_checkpoint(tmp_path, state)
    _, _, fresh = _state(tree, ema_decay=0.9)
    restored = ckpt.restore_checkpoint(tmp_path, fresh)
    for k, v in restored.params.items():
        assert torch.equal(restored.ema_params[k], v)
        assert restored.ema_params[k].data_ptr() != v.data_ptr()


def test_checkpoint_errors(jax_pair, tmp_path, monkeypatch):
    _, tree = jax_pair
    assert ckpt.latest_step(tmp_path / "none") is None
    _, _, state = _state(tree)
    assert ckpt.restore_checkpoint(tmp_path / "none", state) is None
    with pytest.raises(FileNotFoundError, match="no checkpoint steps"):
        ckpt.load_trained_params(tmp_path)
    orbax = tmp_path / "orbax"
    (orbax / "3" / "default").mkdir(parents=True)
    for fn in (ckpt.latest_step, ckpt.load_trained_params):
        with pytest.raises(ValueError, match="orbax"):
            fn(orbax)
    model, cfg, lora = _state(tree, lora_rank=4, lora_alpha=8.0)
    ckpt.save_checkpoint(tmp_path / "l", lora)
    _, _, other = _state(tree, lora_rank=4, lora_alpha=16.0)
    warnings = []
    monkeypatch.setattr(ckpt.log, "warning", lambda msg, *a: warnings.append(msg % a))
    ckpt.restore_checkpoint(tmp_path / "l", other)
    assert any("lora scale" in w for w in warnings)


def test_checkpoint_dir_serves_as_clip_checkpoint(small_store, tiny, jax_pair, tmp_path):  # noqa: F811
    """A ``train --ckpt-dir`` directory as ``CLIP_CHECKPOINT``: the engine's
    embeddings equal those of the trainer's ``export_params``, bit for bit
    (EMA and LoRA alike)."""
    store, images_dir = small_store
    _, tree = jax_pair
    texts = ["instructie 1 voor de filter", "pomp"]
    images = np.random.default_rng(0).normal(size=(3, 32, 32, 3)).astype(np.float32)
    for kind, kw in (("ema", {"EMA_DECAY": 0.5}), ("lora", {"LORA_RANK": 4})):
        _, tt = trainers(store, images_dir, tree, **kw)
        d = tmp_path / kind
        tt.train(schema="clip_combined", steps=2, batch_size=4, ckpt_dir=str(d))
        mc = torch_config.ModelConfig("tiny", compute_dtype="float32", checkpoint_path=str(d))
        from_dir = EmbedEngine(mc, device="cpu")
        direct = EmbedEngine(dataclasses.replace(mc, checkpoint_path=None),
                             params=to_jax_layout(tt.export_params), device="cpu")
        np.testing.assert_array_equal(from_dir.encode_text_batch(texts),
                                      direct.encode_text_batch(texts))
        np.testing.assert_array_equal(from_dir.encode_image_batch(images),
                                      direct.encode_image_batch(images))


# -- configuration and CLI ----------------------------------------------------------------------


@pytest.mark.parametrize("env", [
    {},
    {"LEARNING_RATE": "3e-4", "WEIGHT_DECAY": "0.1", "TRAIN_BATCH_SIZE": "64",
     "WARMUP_STEPS": "5", "TOTAL_STEPS": "50", "WEAK_SCORE_TEMPERATURE": "0.2",
     "LABEL_SMOOTHING": "0.1", "PATCH_MASK_RATIO": "0.5", "LOSS_TYPE": "siglip",
     "SIGLIP_BIAS": "-5", "GRAD_ACCUM_STEPS": "4", "EMA_DECAY": "0.99",
     "MOMENTS_DTYPE": "bfloat16", "TRAIN_FSDP": "1", "SEED": "3", "TRAIN_FEED_WORKERS": "2",
     "TRAIN_FEED_CACHE_MB": "0", "TRAIN_IMAGE_FEED": "device", "TRAIN_AUGMENT": "rrc",
     "LORA_RANK": "8", "LORA_ALPHA": "4", "LORA_BASE_DTYPE": "bfloat16",
     "DISTILL_CHECKPOINT": "t.pt", "DISTILL_MODEL": "ViT-L-14", "DISTILL_WEIGHT": "0.3",
     "DISTILL_TEMPERATURE": "2"},
    {"BATCH_SIZE": "32"},
])
def test_train_config_matches_jax(env, monkeypatch):
    for key in TRAIN_KEYS + ("BATCH_SIZE", "TRAIN_BATCH_SIZE", "SEED"):
        monkeypatch.delenv(key, raising=False)
    got = dataclasses.asdict(torch_config.load_config(env).train)
    want = dataclasses.asdict(jax_config.load_config(env_file=None, overrides=env).train)
    assert got == want


@pytest.mark.parametrize("env", [
    {"DISTILL_WEIGHT": "1.5"}, {"DISTILL_TEMPERATURE": "0"}, {"DISTILL_MODEL": "ViT-B-32"},
    {"TRAIN_IMAGE_FEED": "gpu"}, {"TRAIN_AUGMENT": "flip"}, {"TRAIN_AUGMENT": "rrc"},
])
def test_train_config_errors_match_jax(env, monkeypatch):
    for key in TRAIN_KEYS:
        monkeypatch.delenv(key, raising=False)
    with pytest.raises(ValueError) as want:
        jax_config.load_config(env_file=None, overrides=env)
    with pytest.raises(ValueError) as got:
        torch_config.load_config(env)
    assert str(got.value) == str(want.value)


def test_train_cli_matches_jax(small_store, tiny, jax_pair, tmp_path, monkeypatch, capsys):  # noqa: F811
    """``python -m tpualign_torch train`` and ``tpualign train`` over the
    same store from the same checkpoint file: the same printed keys and
    losses, a checkpoint directory and a metrics file; then ``calibrate``
    prints what tpualign's prints over that store."""
    import tpualign.cli as jax_cli
    import tpualign_torch.cli as torch_cli
    from tests.test_torch_loader import to_openclip

    store, images_dir = small_store
    port_store(store)  # the CLIs open the store from disk
    _, tree = jax_pair
    weights = tmp_path / "tiny.pt"
    torch.save({k: torch.from_numpy(np.array(v)) for k, v in
                to_openclip(jax.tree.map(np.asarray, tree)).items()}, weights)
    for key, value in overrides(store, images_dir, CLIP_CHECKPOINT=weights,
                                LEARNING_RATE=1e-4).items():
        monkeypatch.setenv(key, value)
    printed = {}
    for name, main, extra in (("jax", jax_cli.main, []),
                              ("torch", torch_cli.main, ["--device", "cpu"])):
        argv = ["train", "--env-file", str(tmp_path / "none.env"), "--steps", "3",
                "--train-batch-size", "4", "--log-every", "1",
                "--ckpt-dir", str(tmp_path / f"ck_{name}"),
                "--metrics-file", str(tmp_path / f"{name}.jsonl")] + extra
        if name == "jax":
            argv.remove("--ckpt-dir")
            argv.remove(str(tmp_path / "ck_jax"))  # orbax is not exercised here
        capsys.readouterr()
        assert main(argv) == 0
        printed[name] = eval(capsys.readouterr().out.strip().splitlines()[-1])  # noqa: S307
    assert printed["torch"].keys() == printed["jax"].keys()
    # printed rounded to 4 decimals; grad_norm carries Adam's sign-flip drift
    # (see test_trainer_train_matches_jax)
    for k in ("loss", "grad_norm", "acc_i2t", "logit_scale"):
        assert printed["torch"][k] == pytest.approx(printed["jax"][k], rel=5e-5, abs=1.1e-4), k
    assert ckpt.latest_step(tmp_path / "ck_torch") == 3
    assert len((tmp_path / "torch.jsonl").read_text().splitlines()) == 4
    outs = []
    for main in (jax_cli.main, torch_cli.main):
        assert main(["calibrate", "--env-file", str(tmp_path / "none.env")]) == 0
        outs.append(capsys.readouterr().out)
    assert outs[0] == outs[1] and outs[0].startswith("calibrated "), outs
