"""The port's LoRA (``tpualign_torch.train.lora``) against tpualign's on the
CPU. ``lora_init``'s ``jax.random`` draws cannot be reproduced, so the
tests carry tpualign's adapter tree across with ``lora_from_jax`` (B made
non-zero, so the merge is not the identity) and compare from there: the
merge (fp32 and bf16 base), the trainable count, and LoRA train steps
(losses, ``grad_norm``, adapters after three steps), with the tolerances
of ``tests/test_torch_train.py``."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import tpualign_torch.config as torch_config
from tests.test_models import TINY
from tests.test_torch_train import (  # noqa: F401  (jax_pair is a fixture)
    LR, assert_history, assert_params_close, configs, flat, jax_pair, run_both, torch_model)
from tests.test_train import batch_for
from tpualign.train import lora as jax_lora
from tpualign_torch.models.convert import lora_from_jax, to_jax_layout
from tpualign_torch.train import lora as torch_lora
from tpualign_torch.train import step as torch_step

pytestmark = pytest.mark.fast

RANK, ALPHA = 4, 8.0


def jax_adapters(tree, seed=0):
    """tpualign's adapter tree with B drawn non-zero."""
    lora = jax_lora.lora_init(tree, RANK, seed=seed)
    rng = np.random.default_rng(seed + 100)

    def fill(node):
        if isinstance(node, dict):
            if set(node) == {"a", "b"}:
                return {"a": node["a"], "b": jnp.asarray(
                    rng.normal(scale=0.02, size=node["b"].shape), jnp.float32)}
            return {k: fill(v) for k, v in node.items()}
        return node

    return fill(lora)


def test_target_suffixes_match_jax():
    assert torch_lora.LORA_TARGET_SUFFIXES == tuple(
        s.replace("/", ".") for s in jax_lora.LORA_TARGET_SUFFIXES)


def test_lora_init_structure(jax_pair):
    """Same adapted kernels, shapes and count as tpualign's tree; B zero;
    A ~ N(0, 1/r) drawn on the base's device; the scale a real copy."""
    _, tree = jax_pair
    tmodel = torch_model(tree)
    params = torch_step.model_params(tmodel)
    lora = torch_lora.lora_init(params, RANK, seed=0)
    want = flat(jax.tree.map(np.asarray, jax_lora.lora_init(tree, RANK, seed=0)))
    got = flat(to_jax_layout(lora))
    assert got.keys() == want.keys()
    for k in want:
        assert got[k].shape == want[k].shape, k
        if k.endswith("/b"):
            assert not got[k].any()
    assert torch_lora.lora_param_count(lora) == jax_lora.lora_param_count(
        jax_lora.lora_init(tree, RANK, seed=0))
    a = np.concatenate([v.ravel() for k, v in got.items() if k.endswith("/a")])
    assert abs(a.std() - 1.0 / RANK) < 0.02
    assert lora["logit_scale"].data_ptr() != params["logit_scale"].data_ptr()
    torch.testing.assert_close(lora["logit_scale"], params["logit_scale"])
    assert not torch.equal(torch_lora.lora_init(params, RANK, seed=1)[
        "visual.transformer.resblocks.0.attn.in_proj_kernel.a"],
        lora["visual.transformer.resblocks.0.attn.in_proj_kernel.a"])
    with pytest.raises(ValueError, match="positive"):
        torch_lora.lora_init(params, 0)


@pytest.mark.parametrize("base_dtype", ["float32", "bfloat16"])
def test_lora_apply_matches_jax(jax_pair, base_dtype):
    _, tree = jax_pair
    lora = jax_adapters(tree)
    tmodel = torch_model(tree)
    adapters = lora_from_jax(tmodel, jax.tree.map(np.asarray, lora))
    base = torch_step.model_params(tmodel)
    jbase = tree
    if base_dtype == "bfloat16":
        base = {k: (v.bfloat16() if v.dim() >= 2 else v) for k, v in base.items()}
        jbase = jax.tree.map(lambda p: p.astype(jnp.bfloat16) if p.ndim >= 2 else p, tree)
    got = torch_lora.lora_apply(base, adapters, ALPHA / RANK)
    want = jax_lora.lora_apply(jbase, lora, ALPHA / RANK)
    got_flat, want_flat = flat(to_jax_layout(got)), flat(jax.tree.map(
        lambda x: np.asarray(x, np.float32), want))
    assert got_flat.keys() == want_flat.keys()
    for k in want_flat:
        # fp32: the rank-r product sums in another order (an ulp); bf16: the
        # merged kernel rounds to bf16, where that ulp may flip one step
        atol = 1e-6 if base_dtype == "float32" else 2**-8 * np.abs(want_flat[k]).max()
        np.testing.assert_allclose(got_flat[k], want_flat[k], rtol=0, atol=atol, err_msg=k)
    assert got["visual.transformer.resblocks.0.attn.in_proj_kernel"].dtype == getattr(
        torch, base_dtype)
    assert got["logit_scale"] is adapters["logit_scale"]


def test_zero_b_merge_is_identity(jax_pair):
    _, tree = jax_pair
    params = torch_step.model_params(torch_model(tree))
    merged = torch_lora.lora_apply(params, torch_lora.lora_init(params, RANK), ALPHA / RANK)
    for k, v in params.items():
        assert torch.equal(merged[k], v), k


def _lora_hook(tree):
    """Start both states from the same adapter tree."""
    lora = jax_adapters(tree)

    def hook(jstate, tstate, tmodel):
        jstate = jstate.replace(params=lora, opt_state=jstate.tx.init(lora))
        adapters = lora_from_jax(tmodel, jax.tree.map(np.asarray, lora))
        tstate.params = adapters
        tstate.opt_state = tstate.tx.init(adapters)
        return jstate, tstate

    return hook


@pytest.mark.parametrize("base_dtype,accum", [("float32", 1), ("bfloat16", 1),
                                              ("float32", 2)])
def test_lora_train_steps_match_jax(jax_pair, base_dtype, accum):
    """Three LoRA steps from one adapter tree: loss and grad_norm per step,
    the adapters (and the trainable logit scale) after them, the frozen
    base untouched, and the exported merge."""
    jax_model, tree = jax_pair
    images, tokens, weak = batch_for(TINY, 8, np.random.default_rng(3))
    cfgs = configs(lora_rank=RANK, lora_alpha=ALPHA, lora_base_dtype=base_dtype,
                   grad_accum_steps=accum)
    history, jstate, tstate, grads, tmodel = run_both(
        jax_model, tree, cfgs, images, tokens, weak, state_hook=_lora_hook(tree))
    # a bf16 base: the merged kernels round to bf16, where the packages'
    # ulp-apart rank-r products may land a bf16 step apart. That moves the
    # loss (rel 1e-4) and an adapter gradient by up to 2^-8 of its leaf's
    # max: near a floor of 1e-2 x the max that is a sizeable part of the
    # element's own gradient, which Adam's normalised step passes on. So a
    # bf16 base compares where |g| >= 1e-2 x the max, within 5e-2 x lr
    # (the fp32 base: 1e-3 and 1e-2 x lr)
    bf16 = base_dtype == "bfloat16"
    assert_history(history, rtol=1e-4 if bf16 else 1e-5)
    assert_params_close(to_jax_layout(tstate.params), jax.tree.map(np.asarray, jstate.params),
                        jax.tree.map(np.asarray, grads), extra=4e-2 * LR if bf16 else 0.0,
                        floor=1e-2 if bf16 else 1e-3)
    base = torch_step.model_params(tmodel)
    for k, v in tstate.frozen_params.items():
        assert torch.equal(v, base[k].to(v.dtype)), k
    assert tstate.frozen_params["visual.proj"].dtype == getattr(torch, base_dtype)
    assert tstate.frozen_params["visual.ln_pre.scale"].dtype == torch.float32
    merged = torch_step.export_params(tstate)
    assert set(merged) == set(base)
    assert merged["visual.transformer.resblocks.0.attn.in_proj_kernel"].dtype == getattr(
        torch, base_dtype)


def test_lora_base_dtype_rejects_unknown(jax_pair):
    _, tree = jax_pair
    tmodel = torch_model(tree)
    with pytest.raises(ValueError, match="LORA_BASE_DTYPE"):
        torch_step.create_train_state(tmodel, torch_step.model_params(tmodel),
                                      torch_config.TrainConfig(lora_rank=4,
                                                               lora_base_dtype="int8"))


def test_adapter_tree_conversion_round_trip_and_errors(jax_pair):
    _, tree = jax_pair
    lora = jax.tree.map(np.asarray, jax_adapters(tree))
    tmodel = torch_model(tree)
    adapters = lora_from_jax(tmodel, lora)
    assert set(adapters) >= {"logit_scale",
                             "text.transformer.resblocks.1.mlp.c_proj_kernel.b"}
    back = flat(to_jax_layout(adapters))
    for k, v in flat(lora).items():
        np.testing.assert_array_equal(back[k], v, err_msg=k)
    bad = {"visual": {"proj": {"a": np.zeros((64, RANK), np.float32),
                               "b": np.zeros((RANK, 64), np.float32)}},
           "logit_scale": np.float32(1.0)}
    with pytest.raises(KeyError, match="matches no kernel"):
        lora_from_jax(tmodel, bad)
    blk = lora["visual"]["transformer"]["resblock_0"]["attn"]["in_proj_kernel"]
    wrong = {"visual": {"transformer": {"resblock_0": {"attn": {"in_proj_kernel": {
        "a": blk["a"][:-1], "b": blk["b"]}}}}}, "logit_scale": np.float32(1.0)}
    with pytest.raises(ValueError, match="shape"):
        lora_from_jax(tmodel, wrong)
