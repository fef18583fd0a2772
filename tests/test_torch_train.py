"""The port's training step (``tpualign_torch.train``: losses, optimizer,
step, accumulation, patch masking, EMA, the device feed) against
tpualign's on the CPU, from the same converted tiny tree (fp32) and the
same numpy batches.

Tolerances: losses and ``grad_norm`` rel 1e-5; every gradient leaf within
1e-4 x its largest |g|; params after AdamW steps within 1e-2 x lr on the
elements whose |g| is at least 1e-3 x the leaf's largest (Adam divides by
sqrt(v), so near-zero gradients, whose sign the summation order can flip,
move their params by a full lr step either way: expected, not compared).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

import tpualign_torch.config as torch_config
from tests.test_models import TINY
from tests.test_train import batch_for
from tpualign.config import TrainConfig as JaxTrainConfig
from tpualign.models.clip import CLIP as JaxCLIP
from tpualign.models.clip import init_clip_params as jax_init
from tpualign.train import loss as jax_loss
from tpualign.train import step as jax_step
from tpualign_torch.models.clip import CLIP
from tpualign_torch.models.convert import from_jax_params, to_jax_layout
from tpualign_torch.train import loss as torch_loss
from tpualign_torch.train import step as torch_step
from tpualign_torch.train.optim import AdamW, warmup_cosine_decay

pytestmark = pytest.mark.fast

TORCH_TINY = torch_config.ClipVariant(**dataclasses.asdict(TINY))
LR = 1e-3


# -- shared helpers (the trainer and LoRA tests import them) -------------------


@pytest.fixture(scope="module")
def jax_pair():
    model = JaxCLIP(variant=TINY, use_quick_gelu=True, compute_dtype=jnp.float32)
    return model, jax_init(model, seed=0)


def torch_model(tree, variant=TORCH_TINY, quant="none") -> CLIP:
    model = CLIP(variant, True, torch.float32, False, quant)
    return from_jax_params(model, jax.tree.map(np.asarray, tree)).requires_grad_(False)


def configs(**kw):
    """The same training config for both packages."""
    base = dict(learning_rate=LR, warmup_steps=0, total_steps=100)
    base.update(kw)
    return JaxTrainConfig(**base), torch_config.TrainConfig(**base)


def flat(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(flat(v, f"{prefix}{k}/"))
        else:
            out[prefix + k] = np.asarray(v, np.float32)
    return out


def assert_grads_close(got: dict, want: dict, rel=1e-4):
    """Each leaf within ``rel`` x its largest |g| (keys in JAX names)."""
    got, want = flat(got), flat(want)
    assert got.keys() == want.keys()
    for k in want:
        scale = max(float(np.abs(want[k]).max()), 1e-30)
        np.testing.assert_allclose(got[k], want[k], rtol=0, atol=rel * scale, err_msg=k)


def assert_params_close(got: dict, want: dict, grads, lr=LR, extra=0.0, floor=1e-3):
    """Params within 1e-2 x lr (+ ``extra``) where |g| >= ``floor`` x the
    leaf's max |g| (``grads`` a tree, or a list of trees, one per step:
    then in every step)."""
    got, want = flat(got), flat(want)
    grads = [flat(g) for g in (grads if isinstance(grads, list) else [grads])]
    assert got.keys() == want.keys()
    compared = 0
    for k in want:
        sel = np.ones(np.shape(want[k]), bool)
        for step in grads:
            g = np.abs(step[k])
            if g.max() > 0:
                sel &= g >= floor * g.max()
        np.testing.assert_allclose(got[k][sel], want[k][sel], rtol=0,
                                   atol=1e-2 * lr + extra, err_msg=k)
        compared += int(sel.sum())
    assert compared > 0


def torch_batch(images, tokens, weak):
    return torch.from_numpy(images), torch.from_numpy(tokens).long(), torch.from_numpy(weak)


def jax_grads(model, state, images, tokens, weak, config, patch_indices=None, teacher=None):
    """tpualign's gradient of the step's loss (what its train_step feeds
    the optimizer, before the clip)."""
    def loss_fn(p):
        img, txt, scale = model.apply({"params": state.effective_params(p)},
                                      jax_step._as_pixels(images, model), tokens,
                                      patch_indices)
        return jax_step._compose_loss(img, txt, scale, weak, config, teacher)[0]

    return jax.grad(loss_fn)(state.params)


def torch_grads(model, state, images, tokens, weak, config, patch_indices=None,
                teacher=None):
    leaves = torch_step._leaves(state.params)
    img, txt, scale = torch_step._encode(state, model, leaves, images, tokens, patch_indices)
    loss = torch_step._compose_loss(img, txt, scale, weak, config, teacher)[0]
    return dict(zip(leaves, torch.autograd.grad(loss, list(leaves.values()))))


def run_both(jax_model, jax_tree, cfgs, images, tokens, weak, steps=3, patch_indices=None,
             teacher=None, torch_images=None, quant="none", state_hook=None):
    """``steps`` train steps through both packages from one tree; returns
    per-step (loss, grad_norm) pairs, both final states, the JAX grads of
    the last step and the port's model."""
    jcfg, tcfg = cfgs
    tmodel = torch_model(jax_tree, quant=quant)
    jstate = jax_step.create_train_state(jax_model, jax_tree, jcfg)
    tstate = torch_step.create_train_state(tmodel, torch_step.model_params(tmodel), tcfg)
    if state_hook is not None:
        jstate, tstate = state_hook(jstate, tstate, tmodel)
    jimg = images if isinstance(images, tuple) else jnp.asarray(images)
    timg = torch_images if torch_images is not None else torch.from_numpy(images)
    jpi = None if patch_indices is None else jnp.asarray(patch_indices)
    tpi = None if patch_indices is None else torch.from_numpy(patch_indices).long()
    jteach = tteach = None
    if teacher is not None:
        jteach = tuple(jnp.asarray(t) for t in teacher)
        tteach = tuple(torch.as_tensor(t) for t in teacher)
    history = []
    for _ in range(steps):
        grads = jax_grads(jax_model, jstate, jimg, jnp.asarray(tokens), jnp.asarray(weak),
                          jcfg, jpi, jteach)
        jstate, jm = jax_step.train_step(jstate, jax_model, jimg, jnp.asarray(tokens),
                                         jnp.asarray(weak), jcfg, jpi, jteach)
        tstate, tm = torch_step.train_step(tstate, tmodel, timg, torch.from_numpy(tokens).long(),
                                           torch.from_numpy(weak), tcfg, tpi, tteach)
        history.append(((float(jm["loss"]), float(tm["loss"])),
                        (float(jm["grad_norm"]), float(tm["grad_norm"]))))
    return history, jstate, tstate, grads, tmodel


def assert_history(history, rtol=1e-5):
    for (jl, tl), (jg, tg) in history:
        np.testing.assert_allclose(tl, jl, rtol=rtol)
        np.testing.assert_allclose(tg, jg, rtol=rtol)


# -- losses -----------------------------------------------------------------------


def _embs(rng, b=6, d=16):
    img = rng.normal(size=(b, d)).astype(np.float32)
    txt = rng.normal(size=(b, d)).astype(np.float32)
    img /= np.linalg.norm(img, axis=1, keepdims=True)
    txt /= np.linalg.norm(txt, axis=1, keepdims=True)
    return img, txt


@pytest.mark.parametrize("case", ["plain", "weak", "smoothing", "weak_smoothing",
                                  "siglip", "siglip_weak", "distill"])
def test_losses_and_their_gradients_match_jax(case):
    rng = np.random.default_rng(3)
    img, txt = _embs(rng)
    t_img, t_txt = _embs(rng, d=24)
    weak = rng.random(6).astype(np.float32)
    scale = np.float32(7.5)

    def jax_fn(i, t, s):
        if case.startswith("siglip"):
            return jax_loss.siglip_loss(i, t, s, jnp.asarray(-2.0),
                                        weak_scores=jnp.asarray(weak) if "weak" in case else None,
                                        weight_temperature=0.3)[0]
        if case == "distill":
            return jax_loss.distill_kl_loss(i, t, s, jnp.asarray(t_img), jnp.asarray(t_txt),
                                            jnp.asarray(9.0), temperature=2.0)
        return jax_loss.clip_contrastive_loss(
            i, t, s, weak_scores=jnp.asarray(weak) if "weak" in case else None,
            weight_temperature=0.3,
            label_smoothing=0.1 if "smoothing" in case else 0.0)[0]

    def torch_fn(i, t, s):
        if case.startswith("siglip"):
            return torch_loss.siglip_loss(
                i, t, s, torch.tensor(-2.0),
                weak_scores=torch.from_numpy(weak) if "weak" in case else None,
                weight_temperature=0.3)[0]
        if case == "distill":
            return torch_loss.distill_kl_loss(i, t, s, torch.from_numpy(t_img),
                                              torch.from_numpy(t_txt), torch.tensor(9.0),
                                              temperature=2.0)
        return torch_loss.clip_contrastive_loss(
            i, t, s, weak_scores=torch.from_numpy(weak) if "weak" in case else None,
            weight_temperature=0.3, label_smoothing=0.1 if "smoothing" in case else 0.0)[0]

    want, jg = jax.value_and_grad(jax_fn, argnums=(0, 1, 2))(
        jnp.asarray(img), jnp.asarray(txt), jnp.asarray(scale))
    ti, tt, ts = (torch.tensor(x, requires_grad=True) for x in (img, txt, scale))
    got = torch_fn(ti, tt, ts)
    tg = torch.autograd.grad(got, (ti, tt, ts))
    np.testing.assert_allclose(float(got.detach()), float(want), rtol=1e-5)
    for a, b in zip(tg, jg):
        b = np.asarray(b)
        np.testing.assert_allclose(a.numpy(), b, rtol=0, atol=1e-4 * max(np.abs(b).max(), 1e-30))


def test_loss_metrics_match_jax():
    rng = np.random.default_rng(4)
    img, txt = _embs(rng, b=8)
    _, jm = jax_loss.clip_contrastive_loss(jnp.asarray(img), jnp.asarray(txt), jnp.asarray(4.0))
    _, tm = torch_loss.clip_contrastive_loss(torch.from_numpy(img), torch.from_numpy(txt),
                                             torch.tensor(4.0))
    for k in ("acc_i2t", "acc_t2i"):
        assert float(tm[k]) == float(jm[k])


# -- schedule and optimizer ----------------------------------------------------------


@pytest.mark.parametrize("warmup,total", [(0, 10), (4, 12), (3, 3), (5, 2)])
def test_schedule_matches_optax(warmup, total):
    """The learning rate at every count: warmup_steps=0 is join_schedules'
    boundary-0 case; warmup > 0 starts at lr 0. Both are float32; numpy's
    and XLA's float32 cos may differ by an ulp (rtol 1e-6)."""
    want = optax.warmup_cosine_decay_schedule(
        init_value=0.0, peak_value=3e-4, warmup_steps=warmup,
        decay_steps=max(total, warmup + 1))
    got = warmup_cosine_decay(3e-4, warmup, total)
    for count in range(total + 4):
        np.testing.assert_allclose(got(count), float(want(count)), rtol=1e-6, atol=1e-12,
                                   err_msg=f"count {count}")
    if warmup:
        assert got(0) == 0.0


@pytest.mark.parametrize("mu_dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("grad_scale", [0.01, 10.0])  # below / above the clip at 1.0
@pytest.mark.parametrize("warmup", [0, 2])
def test_adamw_matches_optax_chain(mu_dtype, grad_scale, warmup):
    """Four updates of random params: params, mu and nu against
    ``make_optimizer``'s chain (weight decay on every leaf, the count read
    before its increment, a bf16 first moment stored in bf16)."""
    rng = np.random.default_rng(5)
    params = {"w": rng.normal(size=(5, 7)).astype(np.float32),
              "b": rng.normal(size=(7,)).astype(np.float32),
              "logit_scale": np.float32(2.6)}
    jcfg, tcfg = configs(warmup_steps=warmup, total_steps=6, weight_decay=0.2,
                         moments_dtype=mu_dtype)
    tx = jax_step.make_optimizer(jcfg)
    jp = jax.tree.map(jnp.asarray, params)
    jopt = tx.init(jp)
    tp = {k: torch.tensor(v) for k, v in params.items()}
    opt = torch_step.make_optimizer(tcfg)
    tstate = opt.init(tp)
    assert isinstance(opt, AdamW) and tstate["mu"]["w"].dtype == getattr(torch, mu_dtype)
    for i in range(4):
        grads = {k: (rng.normal(size=np.shape(v)) * grad_scale).astype(np.float32)
                 for k, v in params.items()}
        updates, jopt = tx.update(jax.tree.map(jnp.asarray, grads), jopt, jp)
        jp = optax.apply_updates(jp, updates)
        tg = {k: torch.tensor(v) for k, v in grads.items()}
        g_norm = torch.sqrt(sum((g * g).sum() for g in tg.values()))
        tstate = opt.update(tp, tg, tstate, g_norm)
        adam = jopt[1][0]
        for k in params:
            np.testing.assert_allclose(tp[k].numpy(), np.asarray(jp[k]), rtol=1e-6, atol=1e-9,
                                       err_msg=f"step {i} {k}")
            np.testing.assert_allclose(tstate["mu"][k].float().numpy(),
                                       np.asarray(adam.mu[k], np.float32),
                                       rtol=1e-5 if mu_dtype == "float32" else 2**-7,
                                       atol=1e-9, err_msg=f"mu {k}")
            np.testing.assert_allclose(tstate["nu"][k].numpy(), np.asarray(adam.nu[k]),
                                       rtol=1e-5, atol=1e-12, err_msg=f"nu {k}")
        assert tstate["count"] == int(adam.count) == i + 1


def test_bad_moments_dtype_raises_like_jax(jax_pair):
    with pytest.raises(ValueError, match="moments_dtype"):
        torch_step.make_optimizer(torch_config.TrainConfig(moments_dtype="float16"))
    with pytest.raises(ValueError, match="moments_dtype"):
        jax_step.make_optimizer(JaxTrainConfig(moments_dtype="float16"))


# -- the step -----------------------------------------------------------------------


@pytest.mark.parametrize("loss_type", ["clip", "siglip"])
def test_gradients_match_jax(jax_pair, loss_type):
    jax_model, tree = jax_pair
    jcfg, tcfg = configs(loss_type=loss_type, label_smoothing=0.05)
    images, tokens, weak = batch_for(TINY, 8, np.random.default_rng(1))
    jstate = jax_step.create_train_state(jax_model, tree, jcfg)
    tmodel = torch_model(tree)
    tstate = torch_step.create_train_state(tmodel, torch_step.model_params(tmodel), tcfg)
    want = jax_grads(jax_model, jstate, jnp.asarray(images), jnp.asarray(tokens),
                     jnp.asarray(weak), jcfg)
    got = torch_grads(tmodel, tstate, *torch_batch(images, tokens, weak), tcfg)
    assert_grads_close(to_jax_layout(got), jax.tree.map(np.asarray, want))


@pytest.mark.parametrize("variant", ["clip", "siglip", "warmup", "ema", "bf16_moments",
                                     "label_smoothing"])
def test_train_steps_match_jax(jax_pair, variant):
    """Three steps: per-step loss and grad_norm (above 1 here, so the clip
    acts; ``test_adamw_matches_optax_chain`` covers both sides), the params,
    the EMA and the optimizer's moments. With bf16 first moments a moment
    whose fp32 value lies within the two packages' rounding of a bf16
    boundary stores one bf16 step apart, which moves its param by up to
    2^-8 x lr a step: that case adds 3 x 2^-8 x lr."""
    jax_model, tree = jax_pair
    kw = {"clip": {}, "siglip": {"loss_type": "siglip"}, "warmup": {"warmup_steps": 2},
          "ema": {"ema_decay": 0.9}, "bf16_moments": {"moments_dtype": "bfloat16"},
          "label_smoothing": {"label_smoothing": 0.1}}[variant]
    images, tokens, weak = batch_for(TINY, 8, np.random.default_rng(2))
    history, jstate, tstate, grads, _ = run_both(jax_model, tree, configs(**kw), images,
                                                 tokens, weak)
    assert_history(history)
    assert all(g[0] > 1.0 for _, g in history)
    jp = jax.tree.map(np.asarray, jstate.params)
    extra = 3 * 2**-8 * LR if variant == "bf16_moments" else 0.0
    assert_params_close(to_jax_layout(tstate.params), jp, jax.tree.map(np.asarray, grads),
                        extra=extra)
    assert float(tstate.params["logit_scale"]) <= torch_step.MAX_LOGIT_SCALE
    assert tstate.step == int(jstate.step) == 3
    if variant == "ema":
        assert_params_close(to_jax_layout(tstate.ema_params),
                            jax.tree.map(np.asarray, jstate.ema_params),
                            jax.tree.map(np.asarray, grads))
        ex = to_jax_layout(torch_step.export_params(tstate))
        assert_params_close(ex, jax.tree.map(np.asarray, jax_step.export_params(jstate)),
                            jax.tree.map(np.asarray, grads))
    if variant == "bf16_moments":
        mu = tstate.opt_state["mu"]
        assert all(m.dtype == torch.bfloat16 for m in mu.values())
        assert all(v.dtype == torch.float32 for v in tstate.opt_state["nu"].values())


def test_warmup_first_step_moves_only_the_moments(jax_pair):
    jax_model, tree = jax_pair
    images, tokens, weak = batch_for(TINY, 8, np.random.default_rng(2))
    _, jstate, tstate, _, tmodel = run_both(jax_model, tree, configs(warmup_steps=3), images,
                                            tokens, weak, steps=1)
    before = torch_step.model_params(tmodel)
    for k, v in tstate.params.items():
        assert torch.equal(v, before[k]), k
    assert any(float(m.abs().max()) > 0 for m in tstate.opt_state["mu"].values())


def test_logit_scale_clamp_like_jax(jax_pair):
    jax_model, tree = jax_pair
    tree = dict(tree)
    tree["logit_scale"] = jnp.asarray(4.6050, jnp.float32)  # just under ln(100)
    images, tokens, weak = batch_for(TINY, 8, np.random.default_rng(6))
    history, jstate, tstate, _, _ = run_both(
        jax_model, tree, configs(learning_rate=0.05), images, tokens, weak, steps=2)
    assert float(tstate.params["logit_scale"]) == pytest.approx(
        float(jstate.params["logit_scale"]), abs=1e-6)
    assert float(tstate.params["logit_scale"]) <= torch_step.MAX_LOGIT_SCALE


@pytest.mark.parametrize("accum,loss_type", [(2, "clip"), (4, "clip"), (2, "siglip"),
                                             (4, "siglip")])
def test_accumulation_matches_jax_and_the_full_batch(jax_pair, accum, loss_type):
    """The cached-feature schedule against tpualign's, and against the
    port's own full-batch step (the same update)."""
    jax_model, tree = jax_pair
    images, tokens, weak = batch_for(TINY, 8, np.random.default_rng(7))
    cfgs = configs(loss_type=loss_type, grad_accum_steps=accum)
    history, jstate, tstate, grads, tmodel = run_both(jax_model, tree, cfgs, images, tokens,
                                                      weak, steps=2)
    assert_history(history)
    assert_params_close(to_jax_layout(tstate.params), jax.tree.map(np.asarray, jstate.params),
                        jax.tree.map(np.asarray, grads))
    full_cfg = configs(loss_type=loss_type)[1]
    full = torch_step.create_train_state(tmodel, torch_step.model_params(tmodel), full_cfg)
    acc = torch_step.create_train_state(tmodel, torch_step.model_params(tmodel), cfgs[1])
    full, fm = torch_step.train_step(full, tmodel, *torch_batch(images, tokens, weak), full_cfg)
    acc, am = torch_step.train_step(acc, tmodel, *torch_batch(images, tokens, weak), cfgs[1])
    np.testing.assert_allclose(float(am["loss"]), float(fm["loss"]), rtol=1e-5)
    np.testing.assert_allclose(float(am["grad_norm"]), float(fm["grad_norm"]), rtol=1e-4)
    for k in full.params:
        np.testing.assert_allclose(acc.params[k].numpy(), full.params[k].numpy(), atol=1e-5,
                                   err_msg=k)


def test_accumulation_indivisible_batch_raises(jax_pair):
    jax_model, tree = jax_pair
    images, tokens, weak = batch_for(TINY, 6, np.random.default_rng(13))
    tmodel = torch_model(tree)
    cfg = torch_config.TrainConfig(grad_accum_steps=4)
    state = torch_step.create_train_state(tmodel, torch_step.model_params(tmodel), cfg)
    with pytest.raises(ValueError, match="divisible"):
        torch_step.train_step(state, tmodel, *torch_batch(images, tokens, weak), cfg)


@pytest.mark.parametrize("accum", [1, 2])
def test_patch_masking_matches_jax(jax_pair, accum):
    """FLIP masking: the same sampled indices (the same numpy stream) give
    the same masked towers and steps."""
    jax_model, tree = jax_pair
    rng = np.random.default_rng(9)
    images, tokens, weak = batch_for(TINY, 8, rng)
    idx = jax_step.sample_patch_indices(np.random.default_rng(1), 8, TINY.num_patches, 0.5)
    idx2 = torch_step.sample_patch_indices(np.random.default_rng(1), 8, TINY.num_patches, 0.5)
    np.testing.assert_array_equal(idx, idx2)
    assert idx.shape == (8, TINY.num_patches // 2)
    assert torch_step.sample_patch_indices(rng, 8, TINY.num_patches, 0.0) is None
    want = jax_model.apply({"params": tree}, jnp.asarray(images), normalize=True,
                           patch_indices=jnp.asarray(idx), method=jax_model.encode_image)
    tmodel = torch_model(tree)
    with torch.no_grad():
        got = tmodel.encode_image(torch.from_numpy(images), normalize=True,
                                  patch_indices=torch.from_numpy(idx).long())
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5)
    history, jstate, tstate, grads, _ = run_both(
        jax_model, tree, configs(grad_accum_steps=accum, patch_mask_ratio=0.5), images,
        tokens, weak, steps=2, patch_indices=idx)
    assert_history(history)
    assert_params_close(to_jax_layout(tstate.params), jax.tree.map(np.asarray, jstate.params),
                        jax.tree.map(np.asarray, grads))


def test_full_permutation_equals_unmasked(jax_pair):
    _, tree = jax_pair
    tmodel = torch_model(tree)
    rng = np.random.default_rng(0)
    images = torch.from_numpy(rng.normal(size=(3, 32, 32, 3)).astype(np.float32))
    idx = torch.from_numpy(np.stack([rng.permutation(TINY.num_patches) for _ in range(3)]))
    with torch.no_grad():
        base = tmodel.encode_image(images)
        perm = tmodel.encode_image(images, patch_indices=idx)
    np.testing.assert_allclose(base.numpy(), perm.numpy(), atol=1e-4)


def test_distillation_step_matches_jax(jax_pair):
    jax_model, tree = jax_pair
    rng = np.random.default_rng(17)
    images, tokens, weak = batch_for(TINY, 8, rng)
    t_img, t_txt = _embs(rng, b=8, d=24)
    teacher = (t_img, t_txt, np.float32(30.0))
    history, jstate, tstate, grads, _ = run_both(
        jax_model, tree, configs(distill_weight=0.7, distill_temperature=2.0), images, tokens,
        weak, steps=2, teacher=teacher)
    assert_history(history)
    assert_params_close(to_jax_layout(tstate.params), jax.tree.map(np.asarray, jstate.params),
                        jax.tree.map(np.asarray, grads))


def _feed(rng, n=8, bucket=48):
    """A device-feed batch: uint8 buckets and true sizes."""
    hw = np.stack([rng.integers(20, bucket + 1, size=n), rng.integers(20, bucket + 1, size=n)],
                  axis=1).astype(np.int32)
    u8 = np.zeros((n, bucket, bucket, 3), np.uint8)
    for i, (h, w) in enumerate(hw):
        u8[i, :h, :w] = rng.integers(0, 256, size=(h, w, 3), dtype=np.uint8)
    return u8, hw


@pytest.mark.parametrize("augment", ["none", "rrc"])
def test_device_feed_step_matches_jax(jax_pair, augment):
    """A ``(u8, hw)`` batch (and the four-tuple rrc arm with crop boxes and
    flips) preprocessed inside the step, as tpualign's ``_as_pixels``."""
    from tpualign.ops.preprocess import sample_crop_boxes as jax_boxes
    from tpualign_torch.ops.preprocess import sample_crop_boxes

    jax_model, tree = jax_pair
    rng = np.random.default_rng(21)
    _, tokens, weak = batch_for(TINY, 8, rng)
    u8, hw = _feed(rng)
    jimgs, timgs = (jnp.asarray(u8), jnp.asarray(hw)), (torch.from_numpy(u8),
                                                         torch.from_numpy(hw))
    if augment == "rrc":
        boxes, flips = jax_boxes(np.random.default_rng(2), hw)
        b2, f2 = sample_crop_boxes(np.random.default_rng(2), hw)
        np.testing.assert_array_equal(boxes, b2)
        np.testing.assert_array_equal(flips, f2)
        jimgs += (jnp.asarray(boxes), jnp.asarray(flips))
        timgs += (torch.from_numpy(boxes), torch.from_numpy(flips))
    pix_j = np.asarray(jax_step._as_pixels(jimgs, jax_model))
    pix_t = torch_step._as_pixels(timgs, torch_model(tree)).numpy()
    # the device preprocess agrees to two uint8 steps (tests/test_torch_preprocess.py)
    assert np.abs(pix_t - pix_j).max() <= 2.0 / 255.0 / 0.26130258 + 1e-6
    history, jstate, tstate, grads, _ = run_both(
        jax_model, tree, configs(), jimgs, tokens, weak, steps=1, torch_images=timgs)
    # the pixels may differ by a uint8 step, so the losses compare at 1e-3
    assert_history(history, rtol=1e-3)


def test_device_feed_accumulation_splits_the_tuple(jax_pair):
    jax_model, tree = jax_pair
    rng = np.random.default_rng(22)
    _, tokens, weak = batch_for(TINY, 8, rng)
    u8, hw = _feed(rng)
    tmodel = torch_model(tree)
    out = []
    for accum in (1, 2):
        cfg = configs(grad_accum_steps=accum)[1]
        state = torch_step.create_train_state(tmodel, torch_step.model_params(tmodel), cfg)
        _, m = torch_step.train_step(state, tmodel, (torch.from_numpy(u8), torch.from_numpy(hw)),
                                     torch.from_numpy(tokens).long(), torch.from_numpy(weak), cfg)
        out.append(float(m["loss"]))
    np.testing.assert_allclose(out[1], out[0], rtol=1e-5)


# -- quantized towers --------------------------------------------------------------------


def test_int8_model_refuses_training_like_jax(jax_pair):
    jax_model, tree = jax_pair
    tmodel = torch_model(tree, quant="int8")
    with pytest.raises(ValueError, match="int8_qat"):
        torch_step.create_train_state(tmodel, torch_step.model_params(tmodel),
                                      torch_config.TrainConfig())
    jq = JaxCLIP(variant=TINY, use_quick_gelu=True, compute_dtype=jnp.float32, quant="int8")
    with pytest.raises(ValueError, match="int8_qat"):
        jax_step.create_train_state(jq, tree, JaxTrainConfig())


def test_int8_qat_step_trains_like_jax(jax_pair):
    """``int8_qat`` towers train through the straight-through estimator:
    the loss matches tpualign's int8_qat step (the fp32 product may sum in
    another order, so near a rounding boundary a code can differ: 1e-4),
    and every kernel of the blocks gets a gradient."""
    _, tree = jax_pair
    jq = JaxCLIP(variant=TINY, use_quick_gelu=True, compute_dtype=jnp.float32,
                 quant="int8_qat")
    images, tokens, weak = batch_for(TINY, 8, np.random.default_rng(31))
    history, _, tstate, _, tmodel = run_both(jq, tree, configs(), images, tokens, weak,
                                             steps=2, quant="int8_qat")
    for (jl, tl), (jg, tg) in history:
        np.testing.assert_allclose(tl, jl, rtol=1e-4)
        np.testing.assert_allclose(tg, jg, rtol=1e-3)
    state = torch_step.create_train_state(tmodel, torch_step.model_params(tmodel),
                                          configs()[1])
    grads = torch_grads(tmodel, state, *torch_batch(images, tokens, weak), configs()[1])
    for k, g in grads.items():
        if k.endswith("_kernel") and "resblocks" in k:
            assert float(g.abs().max()) > 0, k


@pytest.mark.parametrize("fsdp", [False, True])
def test_sharded_step_and_fsdp_raise(jax_pair, fsdp):
    """(Named for the refusal it held before the sharded step existed.) The
    port's sharded step on a (4, 2) CPU mesh, replicated and with
    TRAIN_FSDP, against its one-device step: loss and grad_norm rel 1e-5,
    params by ``assert_params_close``; a mesh that is not the port's still
    raises (``tests/test_torch_train_mesh.py`` holds it against tpualign)."""
    from tpualign_torch.parallel.mesh import create_mesh

    _, tree = jax_pair
    images, tokens, weak = torch_batch(*batch_for(TINY, 8, np.random.default_rng(3)))
    tcfg = configs(fsdp=fsdp)[1]
    model = torch_model(tree)
    one = torch_step.create_train_state(model, torch_step.model_params(model), tcfg)
    grads = torch_grads(model, one, images, tokens, weak, tcfg)
    one, m1 = torch_step.train_step(one, model, images, tokens, weak, tcfg)
    run, shard_state = torch_step.make_sharded_train_step(
        model, create_mesh(4, 2, devices=["cpu"] * 8), tcfg)
    state = shard_state(torch_step.create_train_state(model, torch_step.model_params(model),
                                                      tcfg))
    state, m2 = run(state, images, tokens, weak)
    assert state.params["text.token_embedding"].data_dim == (0 if fsdp else None)
    np.testing.assert_allclose(float(m2["loss"]), float(m1["loss"]), rtol=1e-5)
    np.testing.assert_allclose(float(m2["grad_norm"]), float(m1["grad_norm"]), rtol=1e-5)
    assert_params_close(to_jax_layout(torch_step.export_params(state)),
                        to_jax_layout(torch_step.export_params(one)), to_jax_layout(grads))
    with pytest.raises(TypeError, match="tpualign_torch Mesh"):
        torch_step.make_sharded_train_step(model, object(), tcfg)


# -- the autograd of the card's paths, checked on the CPU ---------------------------------


def test_matmul_f32acc_transpose_rule(monkeypatch):
    """``_MatmulF32Acc`` (the CUDA route: cuBLAS bf16 with an fp32 output)
    with its product stood in by the widened fp32 product, which is what
    cuBLAS's fp32 accumulation gives on exact bf16 products: the forward is
    the fp32 product, dA = bf16(bf16(dC)·Bᵀ), dB = bf16(Aᵀ·bf16(dC)), as
    JAX's transpose of ``dot_general`` at the TPU's default precision."""
    from tpualign_torch.ops import dense

    monkeypatch.setattr(dense, "_mm_f32", lambda a, b: torch.matmul(a.float(), b.float()))
    gen = torch.Generator().manual_seed(0)
    for a_shape, b_shape in (((2, 5, 8), (8, 3)), ((2, 3, 5, 8), (2, 3, 8, 4))):
        a = torch.randn(a_shape, generator=gen).bfloat16().requires_grad_()
        b = torch.randn(b_shape, generator=gen).bfloat16().requires_grad_()
        out = dense._MatmulF32Acc.apply(a, b)
        assert out.dtype == torch.float32
        g = torch.randn(out.shape, generator=gen)
        da, db = torch.autograd.grad(out, (a, b), g)
        assert da.dtype == db.dtype == torch.bfloat16
        gb = g.bfloat16().float()
        want_a = torch.matmul(gb, b.detach().float().transpose(-1, -2)).bfloat16()
        if b.dim() == 2:
            want_b = torch.matmul(a.detach().float().reshape(-1, 8).t(),
                                  gb.reshape(-1, gb.shape[-1])).bfloat16()
        else:
            want_b = torch.matmul(a.detach().float().transpose(-1, -2), gb).bfloat16()
        assert torch.equal(da, want_a) and torch.equal(db, want_b)


@pytest.mark.parametrize("mask_grad", [False, True])
def test_fused_mha_backward_recomputes_the_plain_path(monkeypatch, mask_grad):
    """``_FusedMHA`` (the CUDA route) with the kernel launch stood in by the
    plain version: its gradients equal the plain version's autograd, the
    mask gets one only when it needs one, and each backward counts one
    recompute."""
    from tpualign_torch.models.text import causal_mask
    from tpualign_torch.ops import attention

    monkeypatch.setattr(attention, "_launch", lambda qkv, h, m: attention.fused_mha_reference(
        qkv, h, m))
    gen = torch.Generator().manual_seed(1)
    qkv = torch.randn(3, 7, 3 * 32, generator=gen, requires_grad=True)
    mask = causal_mask(7).requires_grad_(mask_grad)
    before = attention.fused_mha.backward_recomputes
    out = attention._FusedMHA.apply(qkv, mask, 4)
    g = torch.randn(out.shape, generator=gen)
    got = torch.autograd.grad(out, [qkv] + ([mask] if mask_grad else []), g)
    ref = attention.fused_mha_reference(qkv, 4, mask)
    want = torch.autograd.grad(ref, [qkv] + ([mask] if mask_grad else []), g)
    for x, y in zip(got, want):
        torch.testing.assert_close(x, y, rtol=0, atol=0)
    assert attention.fused_mha.backward_recomputes == before + 1
