"""tpualign_torch's CLIP towers against the JAX package's, fp32, with the
JAX weights carried over by from_jax_params; the config tables; the
length-bucket exactness; the converter."""

import dataclasses

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from tests.test_models import TINY
from tpualign import config as jax_config
from tpualign.models.clip import CLIP as JaxCLIP
from tpualign.models.clip import init_clip_params as jax_init
from tpualign.parallel.embed import truncate_to_bucket as jax_truncate
from tpualign_torch import config as torch_config
from tpualign_torch.models import CLIP, build_clip, from_jax_params, init_clip_params
from tpualign_torch.parallel.embed import truncate_to_bucket

pytestmark = pytest.mark.fast

TORCH_TINY = torch_config.ClipVariant(**dataclasses.asdict(TINY))
# T=257 as at ViT-L/H-14 (112 / 7 = 16 patches a side + CLS), head dim 80
# as at ViT-H-14: the attention past T=128
TINY_LONG = dataclasses.replace(TINY, name="tiny_long", image_size=112, patch_size=7,
                                vision_width=160, vision_heads=2, vision_layers=2)
TORCH_TINY_LONG = torch_config.ClipVariant(**dataclasses.asdict(TINY_LONG))


@pytest.fixture(scope="module")
def jax_params():
    model = JaxCLIP(variant=TINY, use_quick_gelu=True, compute_dtype=jnp.float32)
    return jax_init(model, seed=0)


def _port(jax_params, fused=False):
    model = CLIP(TORCH_TINY, True, torch.float32, fused)
    return from_jax_params(model, jax.tree.map(np.asarray, jax_params))


def _tokens():
    toks = np.zeros((3, 16), np.int32)
    toks[0, :5] = [1, 17, 33, 501, 999]
    toks[1, :2] = [1, 999]
    toks[2, :] = np.arange(1, 17)
    toks[2, 15] = 999
    return toks


def test_variant_tables_match_jax():
    assert set(torch_config.CLIP_VARIANTS) == set(jax_config.CLIP_VARIANTS)
    for name, v in jax_config.CLIP_VARIANTS.items():
        assert dataclasses.asdict(torch_config.CLIP_VARIANTS[name]) == dataclasses.asdict(v)
    assert torch_config.ModelConfig(model_name="ViT-B/32").variant.name == "ViT-B-32"
    assert torch_config.ModelConfig(pretrained="openai").use_quick_gelu
    assert not torch_config.ModelConfig(pretrained="laion2b_s34b_b79k").use_quick_gelu
    with pytest.raises(ValueError, match="Unknown CLIP model"):
        torch_config.ModelConfig(model_name="ViT-Q-99").variant


@pytest.mark.parametrize("overrides", [
    {},
    {"CLIP_MODEL": "ViT-L/14", "COMPUTE_DTYPE": "float32", "PARITY_MODE": "1",
     "BATCH_SIZE": "64", "TEXT_BUCKETS": "off"},
    {"TEXT_BUCKETS": "8, 24", "PARITY_MODE": "no"},
])
def test_load_config_matches_jax(overrides):
    want = jax_config.load_config(env_file=None, overrides=overrides)
    got = torch_config.load_config(overrides)
    for field in ("model_name", "pretrained", "compute_dtype", "parity_mode"):
        assert getattr(got.model, field) == getattr(want.model, field)
    assert got.batch_size == want.batch_size
    assert got.text_buckets == want.text_buckets


@pytest.mark.parametrize("fused", [False, True])
@pytest.mark.parametrize("tower", ["image", "text"])
def test_tower_parity_fp32(jax_params, tower, fused):
    jmodel = JaxCLIP(variant=TINY, use_quick_gelu=True, compute_dtype=jnp.float32,
                     use_fused_attention=fused)
    port = _port(jax_params, fused)
    if tower == "image":
        x = np.random.default_rng(1).normal(size=(3, 32, 32, 3)).astype(np.float32)
        want = jmodel.apply({"params": jax_params}, jnp.asarray(x), normalize=True,
                            method=jmodel.encode_image)
        with torch.no_grad():
            got = port.encode_image(torch.from_numpy(x), normalize=True)
    else:
        toks = _tokens()
        want = jmodel.apply({"params": jax_params}, jnp.asarray(toks), normalize=True,
                            method=jmodel.encode_text)
        with torch.no_grad():
            got = port.encode_text(torch.from_numpy(toks), normalize=True)
    err = float(np.max(np.abs(got.numpy() - np.asarray(want))))
    assert err <= 1e-3, f"{tower} tower (fused={fused}) max abs error {err:.3g} > 1e-3"


@pytest.mark.parametrize("fused", [False, True])
def test_long_image_tower_parity_fp32(fused):
    """The whole image tower at T=257 (hd 80), the port's against
    tpualign's from the same params, fused attention on and off, within
    test_tower_parity_fp32's bound."""
    jmodel = JaxCLIP(variant=TINY_LONG, use_quick_gelu=True, compute_dtype=jnp.float32,
                     use_fused_attention=fused)
    params = jax_init(jmodel, seed=2)
    port = from_jax_params(CLIP(TORCH_TINY_LONG, True, torch.float32, fused),
                           jax.tree.map(np.asarray, params))
    assert port.visual.positional_embedding.shape[0] == 257
    x = np.random.default_rng(4).normal(size=(2, 112, 112, 3)).astype(np.float32)
    want = jmodel.apply({"params": params}, jnp.asarray(x), normalize=True,
                        method=jmodel.encode_image)
    with torch.no_grad():
        got = port.encode_image(torch.from_numpy(x), normalize=True)
    err = float(np.max(np.abs(got.numpy() - np.asarray(want))))
    assert err <= 1e-3, f"T=257 image tower (fused={fused}) max abs error {err:.3g} > 1e-3"


def test_joint_forward_and_logit_scale(jax_params):
    port = _port(jax_params)
    x = torch.zeros(2, 32, 32, 3)
    with torch.no_grad():
        img, txt, scale = port(x, torch.from_numpy(_tokens()))
    assert img.shape == (2, 64) and txt.shape == (3, 64)
    np.testing.assert_allclose(float(scale), 1 / 0.07, rtol=1e-6)


def test_bucket_truncation_exact(jax_params):
    """Under the causal mask, cutting the zero tail after every EOT leaves
    the text embedding unchanged."""
    port = _port(jax_params)
    toks = np.zeros((4, 16), np.int32)
    rng = np.random.default_rng(5)
    for i, ln in enumerate([4, 6, 8, 3]):
        toks[i, 0] = 998
        toks[i, 1:ln - 1] = rng.integers(1, 998, size=ln - 2)
        toks[i, ln - 1] = 999
    with torch.no_grad():
        full = port.encode_text(torch.from_numpy(toks))
        cut = port.encode_text(torch.from_numpy(truncate_to_bucket(toks, (8, 12))))
    np.testing.assert_allclose(cut.numpy(), full.numpy(), atol=1e-5)
    for buckets in [(8, 12), (2, 4), (16,), (20,)]:
        np.testing.assert_array_equal(truncate_to_bucket(toks, buckets),
                                      jax_truncate(toks, buckets))
    with pytest.raises(ValueError, match="context_length"):
        port.encode_text(torch.zeros(1, 17, dtype=torch.int32))


def test_from_jax_params_round_trip_and_errors(jax_params):
    tree = jax.tree.map(np.asarray, jax_params)
    port = _port(jax_params)
    state = {k: v.numpy() for k, v in port.state_dict().items()}
    assert len(state) == len(jax.tree.leaves(tree))
    np.testing.assert_array_equal(
        state["visual.transformer.resblocks.1.attn.in_proj_kernel"],
        tree["visual"]["transformer"]["resblock_1"]["attn"]["in_proj_kernel"])
    np.testing.assert_array_equal(state["visual.conv1_kernel"], tree["visual"]["conv1"]["kernel"])

    missing = jax.tree.map(lambda x: x, tree)
    del missing["text"]["ln_final"]
    with pytest.raises(KeyError, match="ln_final"):
        from_jax_params(CLIP(TORCH_TINY, True, torch.float32), missing)
    wrong = jax.tree.map(lambda x: x, tree)
    wrong["text"]["text_projection"] = np.zeros((3, 3), np.float32)
    with pytest.raises(ValueError, match="text_projection"):
        from_jax_params(CLIP(TORCH_TINY, True, torch.float32), wrong)


def test_seeded_init_and_build(monkeypatch):
    monkeypatch.setitem(torch_config.CLIP_VARIANTS, "tiny", TORCH_TINY)
    a = init_clip_params(CLIP(TORCH_TINY, True, torch.float32), seed=3)
    b = init_clip_params(CLIP(TORCH_TINY, True, torch.float32), seed=3)
    c = init_clip_params(CLIP(TORCH_TINY, True, torch.float32), seed=4)
    for (name, pa), pb, pc in zip(a.named_parameters(), b.parameters(), c.parameters()):
        assert torch.equal(pa, pb), name
        if name.endswith("kernel") or name.endswith("embedding"):
            assert not torch.equal(pa, pc), name
    assert torch.equal(a.visual.ln_pre.scale, torch.ones(64))
    built = build_clip(torch_config.ModelConfig("tiny", parity_mode=True), "cpu")
    assert built.visual.compute_dtype == torch.float32
    attn = built.visual.transformer.resblocks[0].attn
    assert not attn.use_fused_attention  # CPU and parity mode: plain path
    bf16 = build_clip(torch_config.ModelConfig("tiny"), "cpu")
    assert bf16.text.compute_dtype == torch.bfloat16
