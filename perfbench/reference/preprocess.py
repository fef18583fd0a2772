"""Plain CLIP image preprocessing in float64: the benchmark's reference.

OpenCLIP's transform as the program's host path states it: resize the
short side to ``size`` (the long side to ``round(long * size / short)``)
with PIL's antialiased bicubic, crop the centre ``size`` x ``size``
(offsets floored), then ``(x / 255 - mean) / std``. The resize follows
PIL's ``ImagingResample``: a horizontal pass, then a vertical one, each
output pixel a normalised sum of bicubic taps (a = -0.5, support 2
widened by the scale on a downscale) around its centre
``(i + 0.5) * in / out``, each pass rounded to the uint8 grid. Every tap
and sum here is float64.
"""

from __future__ import annotations

from typing import Sequence, Tuple

import torch

__all__ = ["CLIP_MEAN", "CLIP_STD", "resize_crop", "preprocess"]

CLIP_MEAN = (0.48145466, 0.4578275, 0.40821073)
CLIP_STD = (0.26862954, 0.26130258, 0.27577711)


def _cubic(x: torch.Tensor) -> torch.Tensor:
    a = -0.5
    x = x.abs()
    near = ((a + 2.0) * x - (a + 3.0)) * x * x + 1.0
    far = (((x - 5.0) * x + 8.0) * x - 4.0) * a
    return torch.where(x < 1.0, near, torch.where(x < 2.0, far, torch.zeros_like(x)))


def _taps(in_size: int, out_size: int, keep: Tuple[int, int], device) -> torch.Tensor:
    """(kept outputs, in_size) float64 weights of a resize from
    ``in_size`` to ``out_size`` pixels, rows ``keep[0]:keep[1]`` only."""
    scale = in_size / out_size
    widen = max(scale, 1.0)
    i = torch.arange(keep[0], keep[1], dtype=torch.float64, device=device)[:, None]
    x = torch.arange(in_size, dtype=torch.float64, device=device)[None, :]
    centre = (i + 0.5) * scale
    w = _cubic((x + 0.5 - centre) / widen)
    return w / w.sum(dim=1, keepdim=True)


def _round_u8(x: torch.Tensor) -> torch.Tensor:
    return torch.clamp(torch.floor(x + 0.5), 0.0, 255.0)


def resize_crop(image: torch.Tensor, size: int) -> torch.Tensor:
    """(h, w, 3) uint8 -> (size, size, 3) float64 on the uint8 grid."""
    h, w = int(image.shape[0]), int(image.shape[1])
    if w < h:
        new_w, new_h = size, max(1, round(h * size / w))
    else:
        new_w, new_h = max(1, round(w * size / h)), size
    top, left = (new_h - size) // 2, (new_w - size) // 2
    x = image.to(torch.float64)
    wx = _taps(w, new_w, (left, left + size), image.device)     # (size, w)
    x = _round_u8(torch.einsum("jx,yxc->yjc", wx, x))           # (h, size, 3)
    wy = _taps(h, new_h, (top, top + size), image.device)      # (size, h)
    return _round_u8(torch.einsum("iy,yjc->ijc", wy, x))        # (size, size, 3)


def preprocess(buckets: torch.Tensor, hws: Sequence[Tuple[int, int]], size: int
               ) -> torch.Tensor:
    """uint8 buckets ``(B, bucket, bucket, 3)`` holding each image in their
    top-left ``hws[b]`` corner -> ``(B, size, size, 3)`` float32 CLIP input."""
    mean = torch.tensor(CLIP_MEAN, dtype=torch.float64, device=buckets.device)
    std = torch.tensor(CLIP_STD, dtype=torch.float64, device=buckets.device)
    out = torch.empty((len(hws), size, size, 3), dtype=torch.float32, device=buckets.device)
    for b, (h, w) in enumerate(hws):
        pixels = resize_crop(buckets[b, :int(h), :int(w)], size)
        out[b] = ((pixels / 255.0 - mean) / std).to(torch.float32)
    return out

