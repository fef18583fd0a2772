"""The port's sharded training (``make_sharded_train_step``,
``Trainer(mesh=)``, ``TRAIN_FSDP``, ``train --mesh-*``) against tpualign's
on the CPU.

The port's meshes repeat the CPU device (``create_mesh(4, 2, devices=[cpu]
* 8)``); tpualign's stand on its eight virtual CPU devices
(``tests/conftest.py``). The same converted tiny tree (fp32) and numpy
batches go through both packages' sharded steps, and through tpualign's
one-device step, as ``tests/test_train.py``'s mesh cases do.

Tolerances: the loss within rel 1e-4 and ``grad_norm`` within rel 1e-3 of
tpualign's sharded step (the bounds ``tests/test_train.py:116`` puts
between tpualign's own sharded and one-device steps: a split product and a
sum over the data rows round differently); params by
``tests/test_torch_train.py``'s ``assert_params_close`` (within 1e-2 x lr
where |g| >= 1e-3 x the leaf's max: Adam's first step moves an element
whose near-zero gradient the orders give opposite signs by a full lr
either way); FSDP against replicated within ``tests/test_train.py:765``'s
bounds (loss rel 1e-5, params 2e-6); checkpoints exactly.
"""

import dataclasses
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import NamedSharding
from jax.sharding import PartitionSpec as P

import tpualign.config as jax_config
import tpualign_torch.config as torch_config
from tests.test_distill import _teacher_embs
from tests.test_models import TINY
from tests.test_torch_lora import ALPHA, RANK, _lora_hook, jax_adapters
from tests.test_torch_train import (  # noqa: F401  (jax_pair is a fixture)
    LR, _feed, assert_params_close, configs, flat, jax_grads, jax_pair, torch_model)
from tests.test_torch_trainer import overrides, port_store, tiny  # noqa: F401
from tests.test_train import batch_for
from tests.test_trainer import small_store  # noqa: F401  (a fixture)
from tpualign.models.clip import CLIP as JaxCLIP
from tpualign.models.clip import init_clip_params as jax_init
from tpualign.parallel import mesh as jax_mesh
from tpualign.train import step as jax_step
from tpualign.train import trainer as jax_trainer
from tpualign_torch.models.clip import CLIP
from tpualign_torch.models.convert import from_jax_params, lora_from_jax, to_jax_layout
from tpualign_torch.parallel import create_mesh
from tpualign_torch.parallel.sharding import ShardedTensor
from tpualign_torch.train import checkpoint as ckpt
from tpualign_torch.train import step as torch_step
from tpualign_torch.train import trainer as torch_trainer

pytestmark = pytest.mark.fast

CPU = torch.device("cpu")
KERNEL = "visual.transformer.resblocks.0.attn.in_proj_kernel"


def port_mesh(data, model=1):
    return create_mesh(data, model, devices=[CPU] * (data * model))


def full(tree: dict) -> dict:
    """A mesh state's tensor dict gathered, in the JAX layout."""
    return to_jax_layout({k: v.full() for k, v in tree.items()})


def host(tree) -> dict:
    return jax.tree.map(np.asarray, tree)


def mesh_steps(jax_model, tree, cfgs, images, tokens, weak, shape=(4, 2), steps=1,
               patch_indices=None, teacher=None, torch_images=None, state_hook=None,
               tmodel=None):
    """``steps`` sharded steps of both packages on ``shape`` meshes from
    one tree (and, with ``state_hook``, one adapter tree); returns the
    per-step (loss, grad_norm) pairs, both states, the JAX gradients of the
    first step (at one device) and tpualign's one-device step's metrics.
    ``tmodel``: the port's model (default: the fp32 towers of ``tree``)."""
    jcfg, tcfg = cfgs
    tmodel = torch_model(tree) if tmodel is None else tmodel
    j0 = jax_step.create_train_state(jax_model, tree, jcfg)
    t0 = torch_step.create_train_state(tmodel, torch_step.model_params(tmodel), tcfg)
    if state_hook is not None:
        j0, t0 = state_hook(j0, t0, tmodel)
    jimg = images if isinstance(images, tuple) else jnp.asarray(images)
    jpi = None if patch_indices is None else jnp.asarray(patch_indices)
    grads = jax_grads(jax_model, j0, jimg, jnp.asarray(tokens), jnp.asarray(weak), jcfg, jpi,
                      teacher)
    _, one = jax_step.train_step(j0, jax_model, jimg, jnp.asarray(tokens), jnp.asarray(weak),
                                 jcfg, jpi, teacher)
    jrun, jshard = jax_step.make_sharded_train_step(jax_model, jax_mesh.create_mesh(*shape), jcfg)
    trun, tshard = torch_step.make_sharded_train_step(tmodel, port_mesh(*shape), tcfg)
    js, ts = jshard(j0), tshard(t0)
    history = []
    for _ in range(steps):
        js, jm = jrun(js, images, tokens, weak, patch_indices, teacher)
        ts, tm = trun(ts, images if torch_images is None else torch_images, tokens, weak,
                      patch_indices, teacher)
        history.append(((float(jm["loss"]), float(tm["loss"])),
                        (float(jm["grad_norm"]), float(tm["grad_norm"]))))
    return history, js, ts, grads, one


def assert_close_history(history, loss_rtol=1e-4, norm_rtol=1e-3):
    for (jl, tl), (jg, tg) in history:
        np.testing.assert_allclose(tl, jl, rtol=loss_rtol)
        np.testing.assert_allclose(tg, jg, rtol=norm_rtol)


@pytest.mark.parametrize("shape", [(4, 2), (2, 4), (8, 1)])
def test_sharded_step_matches_tpualign_and_one_device(jax_pair, shape):
    """tests/test_train.py:116 in both packages: one step on a (4, 2) mesh
    (and (2, 4), (8, 1)) against tpualign's sharded step and its one-device
    step; the updated params, and every replica of a slice equal."""
    jax_model, tree = jax_pair
    images, tokens, weak = batch_for(TINY, 8, np.random.default_rng(1))
    history, js, ts, grads, one = mesh_steps(jax_model, tree, configs(), images, tokens, weak,
                                             shape)
    assert_close_history(history)
    np.testing.assert_allclose(history[0][0][1], float(one["loss"]), rtol=1e-4)
    np.testing.assert_allclose(history[0][1][1], float(one["grad_norm"]), rtol=1e-3)
    assert_params_close(full(ts.params), host(js.params), host(grads))
    for st in ts.params.values():
        for i, j in st.positions():
            head = st.parts[st.group(i, j)[0]][st.group(i, j)[1]]
            assert torch.equal(st.parts[i][j], head)
    assert ts.step == 1 and ts.opt_state["count"] == 1


def test_sharded_accumulation_matches_tpualign(jax_pair):
    """tests/test_train.py:219: GRAD_ACCUM_STEPS=2 under the (4, 2) mesh."""
    jax_model, tree = jax_pair
    images, tokens, weak = batch_for(TINY, 8, np.random.default_rng(11))
    history, js, ts, grads, one = mesh_steps(jax_model, tree, configs(grad_accum_steps=2),
                                             images, tokens, weak)
    assert_close_history(history)
    assert_params_close(full(ts.params), host(js.params), host(grads))


def test_sharded_step_with_masking_matches_tpualign(jax_pair):
    """tests/test_train.py:605: FLIP patch masks (ratio 0.5) on (4, 2)."""
    jax_model, tree = jax_pair
    rng = np.random.default_rng(1)
    images, tokens, weak = batch_for(TINY, 8, rng)
    idx = jax_step.sample_patch_indices(rng, 8, TINY.num_patches, 0.5)
    history, js, ts, grads, _ = mesh_steps(jax_model, tree, configs(patch_mask_ratio=0.5),
                                           images, tokens, weak, patch_indices=idx)
    assert_close_history(history)
    assert_params_close(full(ts.params), host(js.params), host(grads))


@pytest.mark.parametrize("augment", [False, True])
def test_sharded_device_feed_matches_tpualign(jax_pair, augment):
    """tests/test_train.py:954: a ``(u8, hw)`` batch (and the four-tuple
    with crops and flips) split over the data rows, each row's slice
    resized on its device. The device preprocess agrees to two uint8 steps
    (tests/test_torch_preprocess.py), so the loss compares at rel 1e-3."""
    from tpualign_torch.ops.preprocess import sample_crop_boxes

    jax_model, tree = jax_pair
    rng = np.random.default_rng(9)
    _, tokens, weak = batch_for(TINY, 8, rng)
    feed = _feed(rng)
    if augment:
        feed = feed + sample_crop_boxes(np.random.default_rng(2), feed[1])
    history, _, ts, _, _ = mesh_steps(jax_model, tree, configs(), feed, tokens, weak,
                                      steps=2)
    assert_close_history(history, loss_rtol=1e-3)
    assert ts.step == 2


def test_sharded_lora_matches_tpualign(jax_pair):
    """tests/test_lora.py:161: the frozen base split by the TP specs, the
    adapters replicated; one step against tpualign's from one adapter
    tree."""
    jax_model, tree = jax_pair
    images, tokens, weak = batch_for(TINY, 8, np.random.default_rng(1))
    cfgs = configs(lora_rank=RANK, lora_alpha=ALPHA, total_steps=10)
    history, js, ts, grads, _ = mesh_steps(jax_model, tree, cfgs, images, tokens, weak,
                                           state_hook=_lora_hook(tree))
    base, adapter = ts.frozen_params[KERNEL], ts.params[KERNEL + ".a"]
    assert base.spec == (None, "model") and adapter.spec == ()
    assert tuple(adapter.parts[3][1].shape) == tuple(adapter.shape)
    assert_close_history(history, loss_rtol=1e-5)
    assert_params_close(full(ts.params), host(js.params), host(grads))
    export = torch_step.export_params(ts)
    want = host(jax_step.export_params(js))
    np.testing.assert_allclose(to_jax_layout(export)["visual"]["transformer"]["resblock_0"][
        "attn"]["in_proj_kernel"], want["visual"]["transformer"]["resblock_0"]["attn"][
        "in_proj_kernel"], rtol=0, atol=1e-5)


def test_sharded_distillation_matches_tpualign(jax_pair):
    """tests/test_distill.py:200: the teacher's rows and scale reach the
    loss on the mesh's first device with the gathered features."""
    jax_model, tree = jax_pair
    rng = np.random.default_rng(6)
    images, tokens, weak = batch_for(TINY, 8, rng)
    teacher = _teacher_embs(images, tokens)
    history, js, ts, grads, one = mesh_steps(jax_model, tree, configs(distill_weight=0.5),
                                             images, tokens, weak, teacher=teacher)
    assert_close_history(history)
    assert_params_close(full(ts.params), host(js.params), host(grads))


def _fs_models(tree_seed=3):
    """tests/test_train.py:724's 128-wide variant in both packages."""
    variant = jax_config.ClipVariant(
        name="fs", embed_dim=64, image_size=32, patch_size=8, vision_width=128, vision_layers=2,
        vision_heads=4, context_length=16, vocab_size=512, text_width=128, text_layers=2,
        text_heads=4)
    jax_model = JaxCLIP(variant=variant, use_quick_gelu=True, compute_dtype=jnp.float32)
    tree = jax_init(jax_model, seed=tree_seed)
    tv = torch_config.ClipVariant(**dataclasses.asdict(variant))
    return jax_model, tree, tv


def _fs_batch(rng):
    images = rng.normal(size=(8, 32, 32, 3)).astype(np.float32)
    tokens = np.zeros((8, 16), np.int32)
    tokens[:, 0] = 510
    tokens[:, 1] = rng.integers(1, 500, size=8).astype(np.int32)
    tokens[:, 2] = 511
    return images, tokens, rng.random(8).astype(np.float32)


def test_fsdp_matches_replicated_and_tpualign():
    """tests/test_train.py:765 in both packages: two FSDP steps with EMA
    against two replicated steps (loss rel 1e-5, params 2e-6) and against
    tpualign's FSDP steps; every part of params, moments and EMA at
    tpualign's shard shape ((32, 192) for the (128, 384) kernel)."""
    from tpualign_torch.models.convert import from_jax_params

    jax_model, tree, tv = _fs_models()
    images, tokens, weak = _fs_batch(np.random.default_rng(7))
    jmesh, tmesh = jax_mesh.create_mesh(4, 2), port_mesh(4, 2)
    model = from_jax_params(CLIP(tv, True, torch.float32, False), host(tree)).requires_grad_(False)
    out = {}
    for fsdp in (False, True):
        jcfg, tcfg = (c(learning_rate=1e-3, warmup_steps=0, total_steps=10, ema_decay=0.9,
                        fsdp=fsdp) for c in (jax_config.TrainConfig, torch_config.TrainConfig))
        jrun, jshard = jax_step.make_sharded_train_step(jax_model, jmesh, jcfg)
        trun, tshard = torch_step.make_sharded_train_step(model, tmesh, tcfg)
        js = jshard(jax_step.create_train_state(jax_model, tree, jcfg))
        ts = tshard(torch_step.create_train_state(model, torch_step.model_params(model), tcfg))
        for _ in range(2):
            js, jm = jrun(js, images, tokens, weak)
            ts, tm = trun(ts, images, tokens, weak)
        np.testing.assert_allclose(float(tm["loss"]), float(jm["loss"]), rtol=1e-4)
        out[fsdp] = (ts, tm, js)
    (rep, m_rep, _), (fs, m_fs, jfs) = out[False], out[True]
    np.testing.assert_allclose(float(m_fs["loss"]), float(m_rep["loss"]), rtol=1e-5)
    for k in rep.params:
        np.testing.assert_allclose(fs.params[k].full().numpy(), rep.params[k].full().numpy(),
                                   rtol=0, atol=2e-6, err_msg=k)
    assert tuple(fs.params[KERNEL].parts[0][0].shape) == (32, 192)
    assert tuple(rep.params[KERNEL].parts[0][0].shape) == (128, 192)
    for tree_name, port in (("params", fs.params), ("mu", fs.opt_state["mu"]),
                            ("ema", fs.ema_params)):
        for k, st in port.items():
            want = NamedSharding(jmesh, P(*st.spec)).shard_shape(st.shape)
            assert all(tuple(st.parts[i][j].shape) == want for i, j in st.positions()), (
                tree_name, k)
    jk = jfs.params["visual"]["transformer"]["resblock_0"]["attn"]["in_proj_kernel"]
    assert jk.sharding.shard_shape(jk.shape) == tuple(fs.params[KERNEL].parts[0][0].shape)


@pytest.mark.parametrize("fsdp", [False, True])
def test_sharded_checkpoint_round_trip(tmp_path, fsdp):
    """tests/test_train.py:506 and :823: a saved mesh state restored into a
    fresh one lands in its layout (TP, or TP+FSDP), values equal; the file
    holds whole tensors (one ``state.pt``, as on one device)."""
    from tpualign_torch.models.convert import from_jax_params

    jax_model, tree, tv = _fs_models()
    model = from_jax_params(CLIP(tv, True, torch.float32, False), host(tree)).requires_grad_(False)
    cfg = torch_config.TrainConfig(batch_size=8, warmup_steps=1, total_steps=4, fsdp=fsdp,
                                   ema_decay=0.5)
    run, shard_state = torch_step.make_sharded_train_step(model, port_mesh(4, 2), cfg)
    state = shard_state(torch_step.create_train_state(model, torch_step.model_params(model),
                                                      cfg))
    state, _ = run(state, *_fs_batch(np.random.default_rng(0)))
    ckpt.save_checkpoint(tmp_path / "ckpt", state)
    saved = torch.load(tmp_path / "ckpt" / "1" / "state.pt", weights_only=True)
    assert tuple(saved["params"][KERNEL].shape) == (128, 384)
    other = from_jax_params(CLIP(tv, True, torch.float32, False),
                            host(jax_init(jax_model, seed=99))).requires_grad_(False)
    fresh = shard_state(torch_step.create_train_state(other, torch_step.model_params(other), cfg))
    restored = ckpt.restore_checkpoint(tmp_path / "ckpt", fresh)
    assert restored.step == 1 and restored.opt_state["count"] == 1
    for tree_name in ("params", "ema_params"):
        for k, st in getattr(restored, tree_name).items():
            want = getattr(state, tree_name)[k]
            assert isinstance(st, ShardedTensor) and st.spec == want.spec
            for i, j in st.positions():
                assert torch.equal(st.parts[i][j], want.parts[i][j]), (tree_name, k)
    assert torch.equal(restored.opt_state["nu"][KERNEL].full(),
                       state.opt_state["nu"][KERNEL].full())
    assert (restored.params[KERNEL].parts[0][0].shape[0] == 32) == fsdp


def test_sharded_state_layout_and_fresh_tensors(jax_pair):
    """tests/test_train.py:365 and :386: moments and EMA take the params'
    layout (``c_fc`` split over ``model`` on its columns, ``c_proj`` on its
    rows); no part aliases the caller's tensors or another part."""
    _, tree = jax_pair
    model = torch_model(tree)
    cfg = configs(ema_decay=0.9)[1]
    one = torch_step.create_train_state(model, torch_step.model_params(model), cfg)
    _, shard_state = torch_step.make_sharded_train_step(model, port_mesh(4, 2), cfg)
    state = shard_state(one)
    blk = "visual.transformer.resblocks.0.mlp."
    for tree_ in (state.params, state.opt_state["mu"], state.opt_state["nu"], state.ema_params):
        assert tree_[blk + "c_fc_kernel"].spec == (None, "model")
        assert tree_[blk + "c_proj_kernel"].spec == ("model", None)
    ptrs = {p.data_ptr() for t in (state.params, state.ema_params) for st in t.values()
            for row in st.parts for p in row}
    assert len(ptrs) == 2 * sum(len(st.positions()) for st in state.params.values())
    assert not ptrs & {v.data_ptr() for v in one.params.values()}


def test_sharded_step_refuses_a_quantized_model(jax_pair):
    """tests/test_quant.py:140: an int8 model refuses the mesh step, on one
    device and on a model axis; so does a model axis that the heads do not
    divide. ``int8_qat`` takes a model axis (the test below)."""
    _, tree = jax_pair
    cfg = torch_config.TrainConfig(batch_size=2)
    for shape in ((1, 1), (1, 2)):
        with pytest.raises(ValueError, match="zero gradient"):
            torch_step.make_sharded_train_step(torch_model(tree, quant="int8"),
                                               port_mesh(*shape), cfg)
    with pytest.raises(ValueError, match="heads do not split"):
        torch_step.make_sharded_train_step(torch_model(tree), port_mesh(1, 8), cfg)
    with pytest.raises(ValueError, match="heads do not split"):
        torch_step.make_sharded_train_step(torch_model(tree, quant="int8_qat"), port_mesh(1, 8),
                                           cfg)


@pytest.mark.parametrize("shape,fsdp,remat,lora", [
    ((1, 2), False, False, False), ((2, 2), False, False, False), ((1, 2), True, False, False),
    ((2, 2), True, False, False), ((2, 2), True, True, False), ((2, 2), False, False, True)],
    ids=["1x2", "2x2", "1x2-fsdp", "2x2-fsdp", "2x2-fsdp-remat", "2x2-lora"])
def test_int8_qat_sharded_step_matches_one_device_and_tpualign(jax_pair, shape, fsdp, remat,
                                                               lora):
    """``CLIP_QUANT=int8_qat`` on a model axis of 2 (with and without FSDP):
    the row-split products fake-quantize every card's slices with the row
    and column maxima over the row's cards. One step against the port's
    one-device int8_qat step and tpualign's sharded int8_qat step on the
    same mesh: loss rel 1e-4, grad_norm rel 1e-3 (this file's bounds), the
    params by ``assert_params_close``. With ``CLIP_REMAT`` every block is
    checkpointed with its parts, and the recompute takes the maxima again;
    under LoRA (tpualign takes int8_qat with adapters) each card's kernel
    part is merged with its slice of the adapter before the split product,
    both packages from one adapter tree.

    The batch is ``tests/test_torch_train.py``'s int8_qat batch, on which
    that file holds the one-device step to tpualign's at these bounds. A
    fake-quantized code flips where an ulp moves a value across a rounding
    boundary, and an ulp apart the packages' fp32 paths often are, so on
    another batch a flip can move the loss past 1e-4 (ROADMAP settled
    difference 26)."""
    _, tree = jax_pair
    jax_model = JaxCLIP(variant=TINY, use_quick_gelu=True, compute_dtype=jnp.float32,
                        quant="int8_qat")
    tmodel = CLIP(torch_config.ClipVariant(**dataclasses.asdict(TINY)), True, torch.float32,
                  False, "int8_qat", remat=remat)
    tmodel = from_jax_params(tmodel, host(tree)).requires_grad_(False)
    images, tokens, weak = batch_for(TINY, 8, np.random.default_rng(31))
    extra = dict(lora_rank=RANK, lora_alpha=ALPHA, total_steps=10) if lora else {}
    cfgs = configs(fsdp=fsdp, **extra)
    history, js, ts, grads, _ = mesh_steps(jax_model, tree, cfgs, images, tokens, weak, shape,
                                           tmodel=tmodel,
                                           state_hook=_lora_hook(tree) if lora else None)
    assert_close_history(history)
    assert_params_close(full(ts.params), host(js.params), host(grads))
    one = torch_model(tree, quant="int8_qat")
    state = torch_step.create_train_state(one, torch_step.model_params(one), cfgs[1])
    if lora:
        state.params = lora_from_jax(one, host(jax_adapters(tree)))
        state.opt_state = state.tx.init(state.params)
    _, m = torch_step.train_step(state, one, torch.from_numpy(images),
                                 torch.from_numpy(tokens).long(), torch.from_numpy(weak), cfgs[1])
    np.testing.assert_allclose(history[0][0][1], float(m["loss"]), rtol=1e-4)
    np.testing.assert_allclose(history[0][1][1], float(m["grad_norm"]), rtol=1e-3)


@pytest.mark.parametrize("name", ["ViT-L-14", "ViT-H-14"])
def test_shallow_large_widths_tp_step(name):
    """tests/test_large_variants.py:34: two blocks a tower at the real
    L-14/H-14 widths and heads (56-pixel images) on a (2, 4) mesh, against
    the port's one-device step from the same params (loss rel 1e-4,
    grad_norm rel 1e-3)."""
    from tpualign_torch.models.clip import init_clip_params

    v = torch_config.CLIP_VARIANTS[name]
    variant = dataclasses.replace(v, name=f"{name}-shallow", image_size=56, vision_layers=2,
                                  context_length=16, vocab_size=512, text_layers=2)
    model = init_clip_params(CLIP(variant, False, torch.float32, False), seed=0)
    model.requires_grad_(False)
    cfg = torch_config.TrainConfig(batch_size=4, warmup_steps=1, total_steps=2)
    rng = np.random.default_rng(0)
    images = torch.from_numpy(rng.normal(size=(4, 56, 56, 3)).astype(np.float32))
    tokens = torch.zeros((4, 16), dtype=torch.long)
    tokens[:, 0], tokens[:, 1] = 510, 511
    weak = torch.from_numpy(rng.random(4).astype(np.float32))
    one = torch_step.create_train_state(model, torch_step.model_params(model), cfg)
    _, m1 = torch_step.train_step(one, model, images, tokens, weak, cfg)
    del one
    run, shard_state = torch_step.make_sharded_train_step(model, port_mesh(2, 4), cfg)
    state = shard_state(torch_step.create_train_state(model, torch_step.model_params(model), cfg))
    state, m2 = run(state, images, tokens, weak)
    assert state.step == 1
    np.testing.assert_allclose(float(m2["loss"]), float(m1["loss"]), rtol=1e-4)
    np.testing.assert_allclose(float(m2["grad_norm"]), float(m1["grad_norm"]), rtol=1e-3)


def test_trainer_on_a_mesh_matches_tpualign(small_store, tiny, jax_pair, tmp_path):  # noqa: F811
    """A 3-step ``Trainer(mesh=).train`` on (4, 2) in both packages, batch
    4 with EMA and held-out evaluation at the start and the end (the port
    runs it on the mesh's tensor parallel rows): per-step loss (rel 1e-4)
    and grad_norm (rel 1e-3), the held-out metrics equal, the exported
    params."""
    store, images_dir = small_store
    _, tree = jax_pair
    ov = overrides(store, images_dir, EMA_DECAY=0.5, LEARNING_RATE=1e-4)
    jt = jax_trainer.Trainer(jax_config.load_config(env_file=None, overrides=ov), store=store,
                             mesh=jax_mesh.create_mesh(4, 2),
                             params=jax.tree.map(lambda x: jnp.array(x, copy=True), tree))
    tt = torch_trainer.Trainer(torch_config.load_config(ov), store=port_store(store),
                               params=host(tree), mesh=port_mesh(4, 2))
    assert tt.state.mesh is not None and tt.model.logit_scale.is_meta
    files = {}
    for name, t in (("jax", jt), ("torch", tt)):
        files[name] = tmp_path / f"{name}.jsonl"
        t.train(schema="clip_combined", steps=3, batch_size=4, log_every=1, eval_every=3,
                eval_fraction=0.34, metrics_file=str(files[name]))
    rows = {n: [json.loads(x) for x in f.read_text().splitlines()] for n, f in files.items()}
    assert [r["kind"] for r in rows["torch"]] == [r["kind"] for r in rows["jax"]]
    for g, w in zip(rows["torch"], rows["jax"]):
        assert g["step"] == w["step"]
        if g["kind"] == "train":
            np.testing.assert_allclose(g["loss"], w["loss"], rtol=1e-4)
            np.testing.assert_allclose(g["grad_norm"], w["grad_norm"], rtol=1e-3)
        elif g["kind"] == "heldout":
            assert g == w
    got = to_jax_layout(tt.export_params)
    want = host(jt.export_params)
    for k, v in flat(want).items():
        np.testing.assert_allclose(flat(got)[k], v, rtol=0, atol=2e-6 + 1e-2 * 1e-4, err_msg=k)


def test_train_cli_on_a_mesh_matches_tpualign(small_store, tiny, jax_pair, tmp_path,  # noqa: F811
                                              monkeypatch, capsys):
    """``train --device cpu --mesh-data 4 --mesh-model 2`` against
    ``tpualign train --mesh-data 4 --mesh-model 2`` from one checkpoint
    file: the printed metrics (rounded to 4 decimals; rel 5e-5, abs
    1.1e-4, as tests/test_torch_trainer.py's one-device CLI case) and a
    checkpoint directory the port's ``latest_step`` reads."""
    import tpualign.cli as jax_cli
    import tpualign_torch.cli as torch_cli
    from tests.test_torch_loader import to_openclip

    store, images_dir = small_store
    port_store(store)
    _, tree = jax_pair
    weights = tmp_path / "tiny.pt"
    torch.save({k: torch.from_numpy(np.array(v)) for k, v in
                to_openclip(host(tree)).items()}, weights)
    for key, value in overrides(store, images_dir, CLIP_CHECKPOINT=weights,
                                LEARNING_RATE=1e-4).items():
        monkeypatch.setenv(key, value)
    printed = {}
    for name, main, extra in (("jax", jax_cli.main, []),
                              ("torch", torch_cli.main, ["--device", "cpu", "--ckpt-dir",
                                                         str(tmp_path / "ck")])):
        argv = ["train", "--env-file", str(tmp_path / "none.env"), "--steps", "2",
                "--train-batch-size", "4", "--mesh-data", "4", "--mesh-model", "2"] + extra
        capsys.readouterr()
        assert main(argv) == 0
        printed[name] = eval(capsys.readouterr().out.strip().splitlines()[-1])  # noqa: S307
    assert printed["torch"].keys() == printed["jax"].keys()
    for k in ("loss", "grad_norm", "acc_i2t", "logit_scale"):
        assert printed["torch"][k] == pytest.approx(printed["jax"][k], rel=5e-5, abs=1.1e-4), k
    assert ckpt.latest_step(tmp_path / "ck") == 2
