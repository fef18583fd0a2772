"""``CLIP_REMAT`` and the mesh keys in tpualign_torch.

- ``ModelConfig.remat`` reads ``CLIP_REMAT`` as tpualign reads it, and
  ``build_clip`` hands it to both towers' ``Transformer``;
- a train step with every residual block under ``torch.utils.checkpoint``
  (``CLIP_REMAT=1``) gives the loss, the gradients and the updated params
  of the unwrapped step bit for bit on the CPU: the recompute runs the same
  fp32 operations on the same inputs in the same order;
- ``MESH_DATA`` and ``MESH_MODEL`` load as in tpualign; a ``CLIP_REMAT``
  step of the Trainer and ``EmbedEngine`` on a mesh of two devices on
  either axis match one device (``tests/test_torch_train_mesh.py`` holds
  the mesh step against tpualign's).
"""

import dataclasses

import numpy as np
import pytest
import torch

import tpualign_torch.config as torch_config
from tests.test_models import TINY
from tests.test_train import batch_for
from tpualign.config import load_config as jax_load_config
from tpualign_torch.models.clip import CLIP, build_clip, init_clip_params
from tpualign_torch.train import step as S

pytestmark = pytest.mark.fast

TORCH_TINY = torch_config.ClipVariant(**dataclasses.asdict(TINY))


@pytest.mark.parametrize("raw", [None, "1", "true", "YES", "on", "0", "false", "no", ""])
def test_clip_remat_reads_like_tpualign(monkeypatch, raw):
    monkeypatch.delenv("CLIP_REMAT", raising=False)
    env = {} if raw is None else {"CLIP_REMAT": raw}
    want = jax_load_config(env_file=None, overrides=env).model.remat
    assert torch_config.load_config(env).model.remat is want


def test_build_clip_hands_remat_to_both_towers(monkeypatch):
    monkeypatch.setitem(torch_config.CLIP_VARIANTS, "tiny", TORCH_TINY)
    for flag in (False, True):
        cfg = torch_config.ModelConfig("tiny", compute_dtype="float32", remat=flag)
        model = build_clip(cfg, device="cpu")
        assert model.visual.transformer.remat is flag
        assert model.text.transformer.remat is flag


def _step(remat: bool, calls: list):
    """One train step of the tiny fp32 CLIP from seeded weights, every
    block under checkpoint when ``remat``: (loss, grad_norm, grads,
    params after the update)."""
    model = init_clip_params(CLIP(TORCH_TINY, True, torch.float32, False, remat=remat), seed=3)
    model.requires_grad_(False)
    for tower in (model.visual, model.text):
        tower.transformer.remat = remat
    cfg = torch_config.TrainConfig(learning_rate=1e-3, warmup_steps=0, total_steps=10)
    state = S.create_train_state(model, S.model_params(model), cfg)
    grads = {}
    real = state.apply_gradients

    def keep(g, n):
        grads.update({k: v.clone() for k, v in g.items()})
        return real(g, n)

    state.apply_gradients = keep
    images, tokens, weak = batch_for(TINY, 6, np.random.default_rng(0))
    state, m = S.train_step(state, model, torch.from_numpy(images),
                            torch.from_numpy(tokens).long(), torch.from_numpy(weak), cfg)
    return float(m["loss"]), float(m["grad_norm"]), grads, {k: v.clone() for k, v in
                                                            state.params.items()}


def test_remat_step_equals_the_plain_step(monkeypatch):
    import torch.utils.checkpoint as ckpt

    from tpualign_torch.models import layers

    calls = []
    real = ckpt.checkpoint

    def counted(fn, *args, **kw):
        calls.append(kw.get("use_reentrant"))
        return real(fn, *args, **kw)

    monkeypatch.setattr(layers, "checkpoint", counted)
    loss0, norm0, g0, p0 = _step(False, calls)
    assert calls == []
    loss1, norm1, g1, p1 = _step(True, calls)
    # every block of both towers, once per forward, non-reentrant
    assert calls == [False] * (TINY.vision_layers + TINY.text_layers)
    assert loss1 == loss0 and norm1 == norm0
    assert g1.keys() == g0.keys() and len(g0) > 0
    for k in g0:
        assert torch.equal(g1[k], g0[k]), k
        assert torch.equal(p1[k], p0[k]), k


def test_remat_leaves_inference_alone(monkeypatch):
    """Without autograd (embedding, serving) the blocks run unwrapped."""
    from tpualign_torch.models import layers

    monkeypatch.setattr(layers, "checkpoint",
                        lambda *a, **k: pytest.fail("checkpoint under no_grad"))
    model = init_clip_params(CLIP(TORCH_TINY, True, torch.float32, False, remat=True), seed=1)
    images, tokens, _ = batch_for(TINY, 2, np.random.default_rng(1))
    with torch.no_grad():
        img = model.encode_image(torch.from_numpy(images))
        txt = model.encode_text(torch.from_numpy(tokens).long())
    assert img.shape == txt.shape == (2, TINY.embed_dim)


@pytest.mark.parametrize("key", ["MESH_DATA", "MESH_MODEL"])
def test_a_mesh_above_one_device_raises(monkeypatch, tmp_path, key):
    """(Named for what it held before the sharded towers existed.) A mesh of
    two devices on either axis loads as tpualign's, and now runs: a
    ``CLIP_REMAT=1`` step of the Trainer over it, every block checkpointed
    with its tensor-parallel parts on a model axis, gives the loss and the
    params of the one-device unwrapped step within 1e-5 (the sums of a
    split product round differently), and ``EmbedEngine`` over it the same
    embeddings within 1e-6."""
    from tpualign_torch.parallel import EmbedEngine, create_mesh
    from tpualign_torch.train.trainer import Trainer

    monkeypatch.delenv("MESH_DATA", raising=False)
    monkeypatch.delenv("MESH_MODEL", raising=False)
    monkeypatch.setitem(torch_config.CLIP_VARIANTS, "tiny", TORCH_TINY)
    env = {key: "2", "CLIP_MODEL": "tiny", "COMPUTE_DTYPE": "float32", "STORE_DIR": str(tmp_path),
           "LEARNING_RATE": "1e-3", "WARMUP_STEPS": "0", "TOTAL_STEPS": "100"}
    config = torch_config.load_config(env)
    want = jax_load_config(env_file=None, overrides={key: "2"}).mesh
    assert (config.mesh.data, config.mesh.model, config.mesh.num_devices) == (
        want.data, want.model, 2)
    mesh = create_mesh(config.mesh.data, config.mesh.model, devices=["cpu"] * 2)
    images, tokens, weak = (torch.from_numpy(x)
                            for x in batch_for(TINY, 4, np.random.default_rng(2)))
    one = Trainer(config, device="cpu")
    _, want_m = one._step(one.state, images, tokens.long(), weak)
    remat = Trainer(torch_config.load_config({**env, "CLIP_REMAT": "1"}), mesh=mesh)
    state, got_m = remat._step(remat.state, images, tokens, weak)
    np.testing.assert_allclose(float(got_m["loss"]), float(want_m["loss"]), rtol=1e-5)
    got, ref = S.export_params(state), S.export_params(one.state)
    for k in ref:
        np.testing.assert_allclose(got[k].numpy(), ref[k].numpy(), rtol=0, atol=1e-5, err_msg=k)
    engine = EmbedEngine(config.model, mesh=mesh, batch_size=4)
    single = EmbedEngine(config.model, device="cpu", batch_size=4)
    np.testing.assert_allclose(engine.encode_image_batch(images.numpy()),
                               single.encode_image_batch(images.numpy()), rtol=0, atol=1e-6)


def test_the_default_mesh_loads_like_tpualign(monkeypatch):
    monkeypatch.delenv("MESH_DATA", raising=False)
    monkeypatch.delenv("MESH_MODEL", raising=False)
    for env in ({}, {"MESH_DATA": "1", "MESH_MODEL": "1"}):
        got = torch_config.load_config(env).mesh
        want = jax_load_config(env_file=None, overrides=env).mesh
        assert (got.data, got.model, tuple(got.axis_names), got.num_devices) == (
            want.data, want.model, tuple(want.axis_names), want.num_devices)
