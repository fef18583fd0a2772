"""CLIP image preprocessing (the port's copy of ``tpualign.ops.preprocess``).

Two paths:

- :func:`preprocess_host`: PIL bicubic on the host, torchvision's
  transform, one image at a time;
- :func:`preprocess_device`: the device feed. The host only decodes and
  pads each image into a fixed ``(bucket, bucket, 3)`` uint8 buffer
  (:func:`pad_to_bucket`); resize, crop and normalisation run on the
  device. The resize reproduces PIL's bicubic with antialias as two
  batched fp32 products per batch, with weight matrices built from each
  image's true ``(h, w)``; each pass ends on the uint8 grid, where PIL's
  fixed-point ``clip8`` does. The second pass emits the integer image as a
  uint8 tensor, which K5 (``ops/normalize.py``) normalises. A
  ``method="bilinear"`` arm keeps the cheaper gather path.

The products run at full fp32 on CUDA whatever the global TF32 flag says:
TF32 would move the result by about one uint8 step per pass.
"""

from __future__ import annotations

import contextlib
import math
import threading
from typing import Optional, Tuple

import numpy as np
import torch

from tpualign_torch.ops.normalize import CLIP_MEAN, CLIP_STD, normalize_u8

__all__ = [
    "CLIP_MEAN",
    "CLIP_STD",
    "preprocess_host",
    "preprocess_device",
    "normalize_images",
    "pad_to_bucket",
    "sample_crop_boxes",
]

_INV255 = float(np.float32(1.0 / 255.0))
# serialises the blocks that switch the process-wide TF32 flag off
_TF32_LOCK = threading.Lock()


def _div(x: torch.Tensor, v: float) -> torch.Tensor:
    """``x / v`` rounded as a division: on CUDA, torch divides by a Python
    scalar as a product with its reciprocal, which rounds differently, so
    the divisor goes in as a tensor on ``x``'s device."""
    return x / torch.tensor(v, dtype=x.dtype, device=x.device)


def normalize_images(images: torch.Tensor, dtype=torch.float32) -> torch.Tensor:
    """(…, H, W, 3) float in [0,1] -> CLIP-normalised, in ``dtype``."""
    mean = torch.tensor(CLIP_MEAN, dtype=dtype, device=images.device)
    std = torch.tensor(CLIP_STD, dtype=dtype, device=images.device)
    return ((images.to(dtype) - mean) / std).to(dtype)


# ---------------------------------------------------------------------------
# Host path (PIL, torchvision's transform)
# ---------------------------------------------------------------------------


def preprocess_host(pil_image, image_size: int = 224) -> np.ndarray:
    """PIL image -> (H, W, 3) float32 normalized array (NHWC).

    torchvision's Resize(short side, BICUBIC, antialias) + CenterCrop +
    ToTensor + Normalize, the OpenCLIP ``preprocess``.
    """
    from PIL import Image

    img = pil_image.convert("RGB")
    w, h = img.size
    if w < h:
        new_w, new_h = image_size, max(1, round(h * image_size / w))
    else:
        new_w, new_h = max(1, round(w * image_size / h)), image_size
    img = img.resize((new_w, new_h), Image.BICUBIC)
    left = (new_w - image_size) // 2
    top = (new_h - image_size) // 2
    img = img.crop((left, top, left + image_size, top + image_size))
    arr = np.asarray(img, np.float32) / 255.0
    mean = np.asarray(CLIP_MEAN, np.float32)
    std = np.asarray(CLIP_STD, np.float32)
    return (arr - mean) / std


# ---------------------------------------------------------------------------
# Device path
# ---------------------------------------------------------------------------


def bucket_hw(h: int, w: int, bucket: int) -> Tuple[int, int]:
    """The (h, w) that :func:`pad_to_bucket` gives an image of ``h`` x ``w``
    pixels: shrunk to ``int(side * bucket / max(h, w))`` where a side
    exceeds the bucket, else unchanged."""
    if h <= bucket and w <= bucket:
        return h, w
    scale = bucket / max(h, w)
    return max(1, int(h * scale)), max(1, int(w * scale))


def pad_to_bucket(decoded: np.ndarray, bucket: int) -> Tuple[np.ndarray, Tuple[int, int]]:
    """Pad a decoded (h, w, 3) uint8 image into a (bucket, bucket, 3) buffer.

    An image larger than the bucket is first shrunk on the host (PIL
    bicubic to ``int(side * bucket / max(h, w))``), so that every batch has
    one shape. Returns the buffer and the true (h, w) in its top-left
    corner.
    """
    h, w = decoded.shape[:2]
    if h > bucket or w > bucket:
        from PIL import Image

        h, w = bucket_hw(h, w, bucket)
        decoded = np.asarray(Image.fromarray(decoded).resize((w, h), Image.BICUBIC))
    out = np.zeros((bucket, bucket, 3), np.uint8)
    out[:h, :w] = decoded
    return out, (h, w)


@contextlib.contextmanager
def _full_fp32(device: torch.device):
    """fp32 products at full precision inside the block on CUDA (TF32 off),
    the global flag restored after. The flag is process-wide, so the
    blocks of concurrent threads run one at a time, and another thread's
    fp32 product launched meanwhile runs at full precision too."""
    if device.type != "cuda":
        yield
        return
    with _TF32_LOCK:
        prev = torch.backends.cuda.matmul.allow_tf32
        torch.backends.cuda.matmul.allow_tf32 = False
        try:
            yield
        finally:
            torch.backends.cuda.matmul.allow_tf32 = prev


def _output_geometry(true_hw: torch.Tensor, image_size: int):
    """The host path's resize-short-side + center-crop geometry per image:
    new sides by round half to even (Python's ``round``, which
    ``torch.round`` shares), crop offsets by floor division. ``true_hw``
    is ``(B, 2)``; each result is ``(B,)`` fp32."""
    h = true_hw[:, 0].to(torch.float32)
    w = true_hw[:, 1].to(torch.float32)
    s = torch.full_like(h, float(image_size))
    new_h = torch.where(w < h, torch.clamp_min(torch.round(h * s / w), 1.0), s)
    new_w = torch.where(w < h, s, torch.clamp_min(torch.round(w * s / h), 1.0))
    top = torch.floor((new_h - s) / 2.0)
    left = torch.floor((new_w - s) / 2.0)
    return h, w, new_h, new_w, top, left


def _bicubic_kernel(x: torch.Tensor) -> torch.Tensor:
    """PIL/torchvision bicubic filter (a = -0.5), support 2."""
    a = -0.5
    ax = x.abs()
    w1 = ((a + 2.0) * ax - (a + 3.0)) * ax * ax + 1.0
    w2 = (((ax - 5.0) * ax + 8.0) * ax - 4.0) * a
    return torch.where(ax < 1.0, w1, torch.where(ax < 2.0, w2, 0.0))


def _grid(image_size: int, bucket: int, device):
    i = torch.arange(image_size, dtype=torch.float32, device=device)[:, None]
    s = torch.arange(bucket, dtype=torch.float32, device=device)[None, :]
    return i, s


def _resample_weights(in_size: torch.Tensor, scale: torch.Tensor, offset: torch.Tensor,
                      bucket: int, image_size: int) -> torch.Tensor:
    """``(..., image_size, bucket)`` resampling weights of PIL's
    antialiased bicubic (``ImagingResampleHorizontal``) for images whose
    ``in_size``, ``scale`` and crop ``offset`` are ``(...)`` fp32: output
    pixel ``i`` has center ``(i + offset + 0.5) * scale`` in source space;
    on a downscale the filter dilates by ``max(scale, 1)``; taps outside
    ``[0, in_size)`` are dropped and the row renormalised."""
    in_size, scale, offset = (t[..., None, None] for t in (in_size, scale, offset))
    ss = torch.clamp_min(scale, 1.0)
    i, s = _grid(image_size, bucket, scale.device)
    center = (i + offset + 0.5) * scale
    w = _bicubic_kernel((s + 0.5 - center) / ss)
    w = torch.where(s < in_size, w, 0.0)
    return w / torch.clamp_min(w.sum(-1, keepdim=True), 1e-12)


def _resample_weights_box(start: torch.Tensor, length: torch.Tensor, bucket: int,
                          image_size: int) -> torch.Tensor:
    """Weights for integer crop segments ``[start, start + length)``
    (``(...)`` fp32) mapped onto the full output, PIL's crop-then-resize:
    taps clip to the box, and the filter dilates by the box's own scale."""
    start, length = start[..., None, None], length[..., None, None]
    scale = _div(length, float(image_size))
    ss = torch.clamp_min(scale, 1.0)
    i, s = _grid(image_size, bucket, scale.device)
    center = start + (i + 0.5) * scale
    w = _bicubic_kernel((s + 0.5 - center) / ss)
    w = torch.where((s >= start) & (s < start + length), w, 0.0)
    return w / torch.clamp_min(w.sum(-1, keepdim=True), 1e-12)


def _quantize_u8_grid(x: torch.Tensor) -> torch.Tensor:
    """Clamp and round to the uint8 grid in [0,1] units, PIL's ``clip8``
    with round half up."""
    return _quantize_u8(x).to(torch.float32) * _INV255


def _quantize_u8(x: torch.Tensor) -> torch.Tensor:
    """The integer image of :func:`_quantize_u8_grid`, as uint8."""
    return torch.clamp(torch.floor(x * 255.0 + 0.5), 0.0, 255.0).to(torch.uint8)


def _resize_two_pass(images_u8: torch.Tensor, wy: torch.Tensor, wx: torch.Tensor) -> torch.Tensor:
    """The separable resize of ``(B, bucket, bucket, 3)`` uint8 images by
    ``wx`` then ``wy`` (each ``(B, S, bucket)``), on ``u8 / 255`` in fp32,
    each pass ending on the uint8 grid. Returns the ``(B, S, S, 3)`` uint8
    image.

    The horizontal pass takes rows and channels together as one product
    per image, the vertical pass rows against columns and channels."""
    b, bucket, _, _ = images_u8.shape
    size = wx.shape[1]
    x = images_u8.permute(0, 1, 3, 2).reshape(b, bucket * 3, bucket)  # (b, s*c, t)
    x = _div(x.to(torch.float32), 255.0)
    with _full_fp32(images_u8.device):
        cols = torch.bmm(x, wx.transpose(1, 2))                       # (b, s*c, j)
        cols = _quantize_u8_grid(cols).view(b, bucket, 3 * size)     # (b, s, c*j)
        out = torch.bmm(wy, cols).view(b, size, 3, size)             # (b, o, c, j)
    return _quantize_u8(out).permute(0, 1, 3, 2).contiguous()       # (b, o, j, c)


def _resize_short_side_crop_bicubic(images_u8: torch.Tensor, true_hw: torch.Tensor,
                                    image_size: int) -> torch.Tensor:
    """PIL bicubic + antialias + center crop as two weight-matrix products,
    the crop fused into the weights. Matches PIL's uint8 pipeline to about
    one uint8 step. Returns ``(B, S, S, 3)`` uint8."""
    bucket = images_u8.shape[1]
    h, w, new_h, new_w, top, left = _output_geometry(true_hw, image_size)
    wy = _resample_weights(h, h / new_h, top, bucket, image_size)
    wx = _resample_weights(w, w / new_w, left, bucket, image_size)
    return _resize_two_pass(images_u8, wy, wx)


def _resize_crop_box_bicubic(images_u8: torch.Tensor, crop_boxes: torch.Tensor,
                             flip: torch.Tensor, image_size: int) -> torch.Tensor:
    """Each ``(cy, cx, ch, cw)`` source box resized to the full output
    (torchvision's RandomResizedCrop, crop then resize); a flip reverses
    the rows of the horizontal weights, which is the flip of the resized
    image. Returns ``(B, S, S, 3)`` uint8."""
    bucket = images_u8.shape[1]
    boxes = crop_boxes.to(torch.float32)
    wy = _resample_weights_box(boxes[:, 0], boxes[:, 2], bucket, image_size)
    wx = _resample_weights_box(boxes[:, 1], boxes[:, 3], bucket, image_size)
    wx = torch.where(flip.to(torch.bool)[:, None, None], wx.flip(1), wx)
    return _resize_two_pass(images_u8, wy, wx)


def _resize_short_side_crop(imgs: torch.Tensor, true_hw: torch.Tensor,
                            image_size: int) -> torch.Tensor:
    """Bilinear short-side resize + center crop of ``(B, bucket, bucket,
    3)`` fp32 images in [0, 1] units, by gathers (no antialias: the cheaper
    arm, not the parity one). Returns ``(B, S, S, 3)`` fp32."""
    bucket = imgs.shape[1]
    h = true_hw[:, 0].to(torch.float32)[:, None]
    w = true_hw[:, 1].to(torch.float32)[:, None]
    scale = _div(torch.minimum(h, w), float(image_size))
    out = torch.arange(image_size, dtype=torch.float32, device=imgs.device)[None, :] + 0.5
    src_y = (h - scale * float(image_size)) / 2.0 + out * scale - 0.5
    src_x = (w - scale * float(image_size)) / 2.0 + out * scale - 0.5

    y0 = torch.clamp(torch.floor(src_y), 0, bucket - 1)
    x0 = torch.clamp(torch.floor(src_x), 0, bucket - 1)
    y1 = torch.minimum(torch.clamp_min(y0 + 1, 0), h - 1)
    x1 = torch.minimum(torch.clamp_min(x0 + 1, 0), w - 1)
    wy = torch.clamp(src_y - y0, 0.0, 1.0)[:, :, None, None]
    wx = torch.clamp(src_x - x0, 0.0, 1.0)[:, None, :, None]
    y0i, y1i, x0i, x1i = (t.to(torch.int64) for t in (y0, y1, x0, x1))

    top = torch.take_along_dim(imgs, y0i[:, :, None, None], dim=1)   # (B, S, bucket, 3)
    bot = torch.take_along_dim(imgs, y1i[:, :, None, None], dim=1)
    rows = top * (1.0 - wy) + bot * wy
    left = torch.take_along_dim(rows, x0i[:, None, :, None], dim=2)  # (B, S, S, 3)
    right = torch.take_along_dim(rows, x1i[:, None, :, None], dim=2)
    return left * (1.0 - wx) + right * wx


def preprocess_device(images_u8: torch.Tensor, true_hw: torch.Tensor, image_size: int = 224,
                      dtype=torch.float32, method: str = "bicubic",
                      crop_boxes: Optional[torch.Tensor] = None,
                      flip: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Batched preprocess on the images' device.

    Args:
      images_u8: (B, bucket, bucket, 3) uint8, the valid region top-left.
      true_hw: (B, 2) integer true (h, w) per image.
      method: "bicubic" (PIL/torchvision antialias parity) or "bilinear"
        (cheaper gathers, no antialias).
      crop_boxes: optional (B, 4) integer-valued (cy, cx, ch, cw) boxes
        (see :func:`sample_crop_boxes`): each box resizes to the full
        output. Bicubic only.
      flip: optional (B,) bool horizontal flips (with ``crop_boxes``).

    Returns the (B, image_size, image_size, 3) CLIP-normalised ``dtype``
    tensor. The bicubic arms normalise their uint8 image through K5.
    """
    if method not in ("bicubic", "bilinear"):
        raise ValueError(f"method must be bicubic or bilinear, got {method!r}")
    if images_u8.dtype != torch.uint8 or images_u8.dim() != 4 or images_u8.shape[-1] != 3:
        raise ValueError("images_u8 must be (B, bucket, bucket, 3) uint8")
    dev = images_u8.device
    true_hw = true_hw.to(dev)
    if crop_boxes is not None:
        if method != "bicubic":
            raise ValueError("crop_boxes requires the bicubic path")
        if flip is None:
            flip = torch.zeros(images_u8.shape[0], dtype=torch.bool, device=dev)
        q = _resize_crop_box_bicubic(images_u8, crop_boxes.to(dev), flip.to(dev), image_size)
    elif method == "bicubic":
        q = _resize_short_side_crop_bicubic(images_u8, true_hw, image_size)
    else:
        imgs = _div(images_u8.to(torch.float32), 255.0)
        return normalize_images(_resize_short_side_crop(imgs, true_hw, image_size), dtype)
    return normalize_u8(q).to(dtype)


def sample_crop_boxes(rng, true_hw, scale_range=(0.6, 1.0),
                      ratio_range=(3.0 / 4.0, 4.0 / 3.0), flip_prob: float = 0.5):
    """Host-side RandomResizedCrop sampling (torchvision's algorithm: 10
    attempts of area and aspect jitter, center-crop fallback) from a numpy
    ``Generator``. Returns ``((B, 4) float32 integer boxes (cy, cx, ch,
    cw), (B,) bool flips)`` for :func:`preprocess_device`."""
    n = len(true_hw)
    boxes = np.zeros((n, 4), np.float32)
    for b in range(n):
        h, w = int(true_hw[b][0]), int(true_hw[b][1])
        area = h * w
        for _ in range(10):
            target = area * rng.uniform(*scale_range)
            logr = rng.uniform(math.log(ratio_range[0]), math.log(ratio_range[1]))
            r = math.exp(logr)
            cw = int(round(math.sqrt(target * r)))
            ch = int(round(math.sqrt(target / r)))
            if 0 < cw <= w and 0 < ch <= h:
                cy = int(rng.integers(0, h - ch + 1))
                cx = int(rng.integers(0, w - cw + 1))
                boxes[b] = (cy, cx, ch, cw)
                break
        else:  # center-crop fallback, torchvision's
            ratio = w / h
            if ratio < ratio_range[0]:
                cw, ch = w, min(h, int(round(w / ratio_range[0])))
            elif ratio > ratio_range[1]:
                cw, ch = min(w, int(round(h * ratio_range[1]))), h
            else:
                cw, ch = w, h
            boxes[b] = ((h - ch) // 2, (w - cw) // 2, ch, cw)
    flips = rng.random(n) < flip_prob
    return boxes, flips
