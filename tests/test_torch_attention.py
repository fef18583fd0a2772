"""tpualign_torch's fused_mha (CPU: its plain version) against the JAX
package's fused_mha (Pallas, interpret mode on the CPU) and
_xla_reference_mha, on the same seeded inputs."""

import numpy as np
import pytest

import jax.numpy as jnp
import torch

from tpualign.ops.pallas_attention import _xla_reference_mha
from tpualign.ops.pallas_attention import fused_mha as jax_fused_mha
from tpualign_torch.models.text import causal_mask
from tpualign_torch.ops.attention import fused_mha

pytestmark = pytest.mark.fast

HEADS, HD = 2, 64


def _qkv(t, seed=0, b=2):
    rng = np.random.default_rng(seed + t)
    return rng.normal(size=(b, t, 3 * HEADS * HD)).astype(np.float32)


def _mask(t, causal):
    return np.triu(np.full((t, t), -np.inf, np.float32), k=1) if causal else None


@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("t", [5, 16, 50, 77])
def test_fp32_matches_jax(t, causal):
    qkv, mask = _qkv(t), _mask(t, causal)
    jmask = None if mask is None else jnp.asarray(mask)
    pallas = np.asarray(jax_fused_mha(jnp.asarray(qkv), HEADS, jmask))
    xla = np.asarray(_xla_reference_mha(jnp.asarray(qkv), HEADS, jmask))
    got = fused_mha(torch.from_numpy(qkv), HEADS,
                    None if mask is None else torch.from_numpy(mask)).numpy()
    # fp32 on both sides: summation order only (tests/test_pallas.py's bound)
    np.testing.assert_allclose(got, pallas, atol=2e-5)
    np.testing.assert_allclose(got, xla, atol=2e-5)
    assert fused_mha.launches == 0  # the CPU takes the plain version


@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("t", [16, 77])
def test_bf16_matches_jax(t, causal):
    """Same fp32 draws rounded to bf16 on both sides. Bound: one bf16 ulp
    (2**-7 relative, outputs |x| < 2) from a probability or an output that
    rounds the other way after a different fp32 summation order."""
    qkv, mask = _qkv(t, seed=7), _mask(t, causal)
    jmask = None if mask is None else jnp.asarray(mask)
    want = np.asarray(
        _xla_reference_mha(jnp.asarray(qkv).astype(jnp.bfloat16), HEADS, jmask)
    ).astype(np.float32)
    got = fused_mha(torch.from_numpy(qkv).to(torch.bfloat16), HEADS,
                    None if mask is None else torch.from_numpy(mask))
    assert got.dtype == torch.bfloat16
    err = np.abs(got.float().numpy() - want)
    assert err.max() <= 2**-6, f"max abs error {err.max():.3g}"
    assert err.mean() <= 1e-3, f"mean abs error {err.mean():.3g}"


def _long_case(t, hd, causal, seed):
    rng = np.random.default_rng(seed + 10 * t + hd)
    qkv = rng.normal(size=(2, t, 3 * HEADS * hd)).astype(np.float32)
    return qkv, _mask(t, causal)


@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("hd", [64, 80])
@pytest.mark.parametrize("t", [129, 257])
def test_fp32_long_matches_jax(t, hd, causal):
    """Past T=128 (ViT-L/H-14's T=257 and the first length past the
    register path), head dims 64 and 80: the bound of test_fp32_matches_jax."""
    qkv, mask = _long_case(t, hd, causal, seed=3)
    jmask = None if mask is None else jnp.asarray(mask)
    pallas = np.asarray(jax_fused_mha(jnp.asarray(qkv), HEADS, jmask))
    xla = np.asarray(_xla_reference_mha(jnp.asarray(qkv), HEADS, jmask))
    got = fused_mha(torch.from_numpy(qkv), HEADS,
                    None if mask is None else torch.from_numpy(mask)).numpy()
    np.testing.assert_allclose(got, pallas, atol=2e-5)
    np.testing.assert_allclose(got, xla, atol=2e-5)


@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("hd", [64, 80])
@pytest.mark.parametrize("t", [129, 257])
def test_bf16_long_matches_jax(t, hd, causal):
    """The bf16 cases past T=128, against the Pallas kernel (interpret mode)
    and _xla_reference_mha, with the bounds of test_bf16_matches_jax."""
    qkv, mask = _long_case(t, hd, causal, seed=11)
    jmask = None if mask is None else jnp.asarray(mask)
    jqkv = jnp.asarray(qkv).astype(jnp.bfloat16)
    got = fused_mha(torch.from_numpy(qkv).to(torch.bfloat16), HEADS,
                    None if mask is None else torch.from_numpy(mask))
    assert got.dtype == torch.bfloat16
    for want in (jax_fused_mha(jqkv, HEADS, jmask), _xla_reference_mha(jqkv, HEADS, jmask)):
        err = np.abs(got.float().numpy() - np.asarray(want).astype(np.float32))
        assert err.max() <= 2**-6, f"max abs error {err.max():.3g}"
        assert err.mean() <= 1e-3, f"mean abs error {err.mean():.3g}"


def test_causal_mask_matches_jax():
    from tpualign.models.text import causal_mask as jax_causal_mask

    want = np.asarray(jax_causal_mask(9))[0, 0]
    np.testing.assert_array_equal(causal_mask(9).numpy(), want)
