"""The port's bf16 towers against tpualign's bf16 towers, ViT-B-32.

tpualign's towers are flax modules, and the machine with the GPU has JAX
but no flax, so the comparison is split in two. Both sides build one
parameter tree from a generator that gives the same numbers on every
machine and numpy version (splitmix64 over each parameter's name):

- ``python -m tests.test_torch_bf16_parity`` runs tpualign's ViT-B-32 in
  bf16 on JAX's CPU backend over four images and four texts and writes
  their embeddings to ``tests/fixtures/bf16_parity_vitb32.npz``;
- ``tests/test_torch_cuda.py::test_bf16_towers_against_tpualign_bf16``
  runs the port's bf16 towers on the card over the same inputs and holds
  them to that file.

The tests here check, on the CPU and at a tiny width, that the generator
is deterministic and fills every parameter of the port, and that the
file's inputs are the ones this module builds.
"""

import re
import zlib
from pathlib import Path

import numpy as np
import pytest
import torch

FIXTURE = Path(__file__).parent / "fixtures" / "bf16_parity_vitb32.npz"
TEXTS = ["replace the oil filter", "torque the drain bolt to 25 Nm",
         "vervang de pakking van de pomp", "check the valve hose for leaks"]
N_IMAGES = 4

pytestmark = pytest.mark.fast


def uniform(seed: int, n: int) -> np.ndarray:
    """n float32 values in [-1, 1): splitmix64 of (seed, i), the same on
    every machine and numpy version."""
    with np.errstate(over="ignore"):
        z = np.arange(n, dtype=np.uint64) * np.uint64(0x9E3779B97F4A7C15) + np.uint64(seed)
        z = (z ^ (z >> np.uint64(30))) * np.uint64(0xBF58476D1CE4E5B9)
        z = (z ^ (z >> np.uint64(27))) * np.uint64(0x94D049BB133111EB)
        z = z ^ (z >> np.uint64(31))
    return ((z >> np.uint64(11)).astype(np.float64) * 2.0**-52 - 1.0).astype(np.float32)


def _jax_name(torch_name: str) -> str:
    """The port's parameter name in the JAX tree (from_jax_params' renames,
    reversed)."""
    name = re.sub(r"\.resblocks\.(\d+)\.", r".resblock_\1.", torch_name)
    return "visual.conv1.kernel" if name == "visual.conv1_kernel" else name


def _value(name: str, shape) -> np.ndarray:
    """LayerNorms 1 and biases 0; embeddings of std 0.02; kernels and
    projections uniform with variance 1 / fan-in; logit scale log(1/0.07)."""
    if name.endswith(".scale"):
        return np.ones(shape, np.float32)
    if name.endswith("bias"):
        return np.zeros(shape, np.float32)
    if name == "logit_scale":
        return np.full(shape, np.log(1 / 0.07), np.float32)
    n = int(np.prod(shape))
    u = uniform(zlib.crc32(name.encode()), n).reshape(shape)
    fan_in = int(np.prod(shape[:-1])) if len(shape) > 1 else 1
    amp = 0.02 if "embedding" in name else 1 / np.sqrt(fan_in)
    return (u * np.float32(amp * np.sqrt(3.0))).astype(np.float32)


def seeded_tree(model) -> dict:
    """The JAX parameter tree (nested dicts of numpy arrays) for the port's
    ``model``, every value from :func:`uniform`."""
    tree: dict = {}
    for torch_name, p in model.named_parameters():
        name = _jax_name(torch_name)
        node = tree
        *path, leaf = name.split(".")
        for key in path:
            node = node.setdefault(key, {})
        node[leaf] = _value(name, tuple(p.shape))
    return tree


def parity_inputs():
    """Four images (224 x 224 x 3, values in [-1, 1)) and four texts' tokens."""
    from tpualign_torch.tokenizer import ClipTokenizer

    images = uniform(1, N_IMAGES * 224 * 224 * 3).reshape(N_IMAGES, 224, 224, 3)
    return images, np.asarray(ClipTokenizer()(TEXTS), np.int32)


def test_seeded_tree_fills_every_parameter_deterministically():
    import dataclasses

    from tests.test_models import TINY
    from tpualign_torch import config as torch_config
    from tpualign_torch.models import CLIP, from_jax_params

    variant = torch_config.ClipVariant(**dataclasses.asdict(TINY))
    a = from_jax_params(CLIP(variant, True, torch.float32), seeded_tree(CLIP(variant)))
    b = from_jax_params(CLIP(variant, True, torch.float32), seeded_tree(CLIP(variant)))
    for (name, pa), pb in zip(a.named_parameters(), b.parameters()):
        assert torch.equal(pa, pb), name
    kernel = a.visual.transformer.resblocks[0].attn.in_proj_kernel
    assert 0.5 < float(kernel.detach().std() * np.sqrt(kernel.shape[0])) < 1.5
    assert torch.equal(a.visual.ln_pre.scale, torch.ones_like(a.visual.ln_pre.scale))


def test_uniform_is_pinned():
    """The generator's first values, written down: a change to it would
    silently change the fixture's parameters."""
    np.testing.assert_array_equal(uniform(7, 3), np.array(
        [-0.8540592193603516, -0.22034050524234772, -0.9664233922958374], np.float32))


def test_fixture_holds_these_inputs():
    images, tokens = parity_inputs()
    saved = np.load(FIXTURE)
    np.testing.assert_array_equal(saved["tokens"], tokens)
    assert saved["image"].shape == (N_IMAGES, 512) and saved["text"].shape == (len(TEXTS), 512)
    assert float(saved["image_input_sum"]) == float(images.astype(np.float64).sum())


def write_fixture() -> None:
    """tpualign's ViT-B-32 in bf16 on JAX's CPU backend over
    parity_inputs(), from seeded_tree(); writes FIXTURE."""
    import jax

    jax.config.update("jax_platforms", "cpu")
    import jax.numpy as jnp

    from tpualign import config as jax_config
    from tpualign.models.clip import CLIP as JaxCLIP
    from tpualign_torch import config as torch_config
    from tpualign_torch.models import CLIP

    shapes = CLIP(torch_config.CLIP_VARIANTS["ViT-B-32"], True, torch.float32)
    params = jax.tree.map(jnp.asarray, seeded_tree(shapes))
    del shapes
    model = JaxCLIP(variant=jax_config.CLIP_VARIANTS["ViT-B-32"], use_quick_gelu=True,
                    compute_dtype=jnp.bfloat16)
    images, tokens = parity_inputs()
    out = {}
    for tower, x in (("image", images), ("text", tokens)):
        method = model.encode_image if tower == "image" else model.encode_text
        fn = jax.jit(lambda p, v, m=method: model.apply({"params": p}, v, normalize=True,
                                                         method=m))
        out[tower] = np.asarray(fn(params, jnp.asarray(x)), np.float32)
    np.savez_compressed(FIXTURE, image=out["image"], text=out["text"], tokens=tokens,
                        image_input_sum=np.float64(images.astype(np.float64).sum()))


if __name__ == "__main__":
    write_fixture()
