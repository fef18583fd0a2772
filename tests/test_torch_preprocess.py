"""The port's device image feed (``tpualign_torch.ops.preprocess``) and K5's
plain version (``tpualign_torch.ops.normalize``) against the JAX package on
the CPU: the same seeded uint8 images through ``preprocess_device`` of both,
the host-side padding and crop sampling, the resampling weights, and
``normalize_u8`` (the Pallas kernel in interpret mode, as
``tests/test_pallas.py`` runs it)."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from tpualign.ops import preprocess as jax_pp
from tpualign.ops.pallas_kernels import normalize_u8 as jax_normalize_u8
from tpualign_torch.ops import preprocess as pp
from tpualign_torch.ops.normalize import normalize_u8, normalize_u8_reference

pytestmark = pytest.mark.fast

STD = np.asarray(jax_pp.CLIP_STD)


def _drift_ok(got: np.ndarray, want: np.ndarray) -> None:
    """The device feed's parity bounds (``tests/test_ops.py``), in raw
    [0, 1] units: at most two uint8 steps anywhere, at most 1e-4 of the
    pixels more than one step off, mean drift at most 1e-4."""
    draw = np.abs(got - want) * STD
    assert draw.max() <= 2.01 / 255.0, draw.max() * 255
    assert np.mean(draw * 255 > 1.01) <= 1e-4
    assert draw.mean() <= 1e-4, draw.mean()


def test_constants_match_jax():
    assert pp.CLIP_MEAN == jax_pp.CLIP_MEAN and pp.CLIP_STD == jax_pp.CLIP_STD


@pytest.mark.parametrize("h,w,bucket", [(30, 20, 64), (64, 64, 64), (200, 90, 64),
                                        (17, 300, 128), (1, 1, 8)])
def test_pad_to_bucket_matches_jax(h, w, bucket):
    arr = np.random.default_rng(h * w).integers(0, 256, (h, w, 3), dtype=np.uint8)
    got, hw = pp.pad_to_bucket(arr, bucket)
    want, jhw = jax_pp.pad_to_bucket(arr, bucket)
    assert hw == jhw
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("in_size,scale,offset", [(120.0, 120 / 224, 0.0), (300.0, 300 / 336, 56.0),
                                                  (640.0, 640 / 224, 0.0), (47.0, 47 / 224, 3.0)])
def test_resample_weights_match_jax(in_size, scale, offset):
    want = np.asarray(jax_pp._resample_weights(jnp.float32(in_size), jnp.float32(scale),
                                                jnp.float32(offset), 640, 224))
    got = pp._resample_weights(torch.tensor([in_size]), torch.tensor([scale], dtype=torch.float32),
                               torch.tensor([offset]), 640, 224)[0].numpy()
    np.testing.assert_allclose(got, want, atol=1e-6, rtol=0)


@pytest.mark.parametrize("start,length", [(0.0, 64.0), (13.0, 200.0), (5.0, 31.0), (100.0, 540.0)])
def test_resample_weights_box_match_jax(start, length):
    want = np.asarray(jax_pp._resample_weights_box(jnp.float32(start), jnp.float32(length),
                                                    640, 224))
    got = pp._resample_weights_box(torch.tensor([start]), torch.tensor([length]), 640, 224)[0]
    np.testing.assert_allclose(got.numpy(), want, atol=1e-6, rtol=0)


def test_sample_crop_boxes_match_jax():
    hw = np.asarray([[120, 180], [300, 200], [64, 640], [640, 64], [224, 224], [5, 3]])
    got = pp.sample_crop_boxes(np.random.default_rng(7), hw)
    want = jax_pp.sample_crop_boxes(np.random.default_rng(7), hw)
    np.testing.assert_array_equal(got[0], want[0])
    np.testing.assert_array_equal(got[1], want[1])


@pytest.mark.parametrize("shape", [(3, 16, 8, 3), (2, 224, 224, 3), (1, 5, 7, 3)])
def test_normalize_u8_reference_matches_jax_kernel(shape):
    imgs = np.random.default_rng(1).integers(0, 256, shape, dtype=np.uint8)
    want = np.asarray(jax_normalize_u8(jnp.asarray(imgs)))
    got = normalize_u8_reference(torch.from_numpy(imgs)).numpy()
    assert got.dtype == np.float32 and got.shape == shape
    np.testing.assert_allclose(got, want, atol=1e-6, rtol=0)
    # the CPU route of the wrapper is the plain version, without a launch
    before = normalize_u8.launches
    np.testing.assert_array_equal(normalize_u8(torch.from_numpy(imgs)).numpy(), got)
    assert normalize_u8.launches == before


def test_normalize_u8_rejects():
    with pytest.raises(TypeError, match="uint8"):
        normalize_u8(torch.zeros(1, 4, 4, 3))
    with pytest.raises(ValueError, match=r"\(B, H, W, 3\)"):
        normalize_u8(torch.zeros(4, 4, 3, dtype=torch.uint8))


@pytest.mark.parametrize("h,w", [(120, 180), (300, 200), (640, 480), (224, 224), (150, 640),
                                 (47, 251)])
def test_preprocess_device_matches_jax(h, w):
    rng = np.random.default_rng(h * 1000 + w)
    arr = rng.integers(0, 256, (h, w, 3), dtype=np.uint8)
    padded, hw = pp.pad_to_bucket(arr, 640)
    want = np.asarray(jax_pp.preprocess_device(jnp.asarray(padded[None]),
                                               jnp.asarray([hw], jnp.int32), 224))[0]
    got = pp.preprocess_device(torch.from_numpy(padded[None]), torch.tensor([hw]), 224)
    assert got.dtype == torch.float32 and got.shape == (1, 224, 224, 3)
    _drift_ok(got[0].numpy(), want)


def _batch(seed, sizes, bucket):
    rng = np.random.default_rng(seed)
    bufs, hws = [], []
    for h, w in sizes:
        buf, hw = pp.pad_to_bucket(rng.integers(0, 256, (h, w, 3), dtype=np.uint8), bucket)
        bufs.append(buf)
        hws.append(hw)
    return np.stack(bufs), np.asarray(hws, np.int32)


def test_preprocess_device_crop_boxes_with_flips_match_jax():
    u8, hw = _batch(3, [(120, 180), (300, 200), (96, 96), (250, 60)], 256)
    boxes, flips = pp.sample_crop_boxes(np.random.default_rng(11), hw)
    flips[:2] = (True, False)
    want = np.asarray(jax_pp.preprocess_device(jnp.asarray(u8), jnp.asarray(hw), 224,
                                               crop_boxes=jnp.asarray(boxes),
                                               flip=jnp.asarray(flips)))
    got = pp.preprocess_device(torch.from_numpy(u8), torch.from_numpy(hw), 224,
                               crop_boxes=torch.from_numpy(boxes), flip=torch.from_numpy(flips))
    _drift_ok(got.numpy(), want)


def test_preprocess_device_batch_matches_one_at_a_time():
    u8, hw = _batch(5, [(120, 180), (256, 100), (30, 40)], 256)
    whole = pp.preprocess_device(torch.from_numpy(u8), torch.from_numpy(hw), 64)
    for b in range(len(u8)):
        one = pp.preprocess_device(torch.from_numpy(u8[b:b + 1]), torch.from_numpy(hw[b:b + 1]), 64)
        np.testing.assert_allclose(whole[b:b + 1].numpy(), one.numpy(), atol=1e-6, rtol=0)


def test_preprocess_device_bilinear_matches_jax():
    u8, hw = _batch(9, [(120, 180), (300, 200), (47, 251), (256, 256)], 320)
    want = np.asarray(jax_pp.preprocess_device(jnp.asarray(u8), jnp.asarray(hw), 224,
                                               method="bilinear"))
    got = pp.preprocess_device(torch.from_numpy(u8), torch.from_numpy(hw), 224, method="bilinear")
    np.testing.assert_allclose(got.numpy(), want, atol=1e-5, rtol=0)


def test_preprocess_device_rejects():
    u8 = torch.zeros(1, 32, 32, 3, dtype=torch.uint8)
    hw = torch.tensor([[32, 32]])
    with pytest.raises(ValueError, match="method"):
        pp.preprocess_device(u8, hw, 16, method="area")
    with pytest.raises(ValueError, match="bicubic"):
        pp.preprocess_device(u8, hw, 16, method="bilinear", crop_boxes=torch.zeros(1, 4))
    with pytest.raises(ValueError, match="uint8"):
        pp.preprocess_device(u8.float(), hw, 16)
