"""CLIP normalisation of uint8 images in one pass (kernel K5).

``normalize_u8`` replaces the Pallas TPU kernel
``tpualign/ops/pallas_kernels.py::normalize_u8`` and takes its signature:
``(B, H, W, 3)`` uint8 -> ``(x * fl(1/255) - mean) * fl(1/std)`` fp32, the
epilogue of the device image feed (``ops/preprocess.py``). On a CUDA tensor
it launches the hand-written kernel ``csrc/normalize_u8.cu``; on a CPU
tensor it runs :func:`normalize_u8_reference`, the plain PyTorch version,
which the kernel matches bit for bit (both round each of the three fp32
operations on its own).

Bound on the H100: bytes, 5 B per element (1 in, 4 out); at B=256,
224x224x3 that is 192.7 MB, about 0.058 ms at 3.35 TB/s.
"""

from __future__ import annotations

import numpy as np
import torch

from tpualign_torch.ops import build

__all__ = ["normalize_u8", "normalize_u8_reference", "CLIP_MEAN", "CLIP_STD"]

CLIP_MEAN = (0.48145466, 0.4578275, 0.40821073)
CLIP_STD = (0.26862954, 0.26130258, 0.27577711)

# the fp32 constants of the JAX kernel: fl(1/255), the means, fl(1/fl(std))
_INV255 = np.float32(1.0 / 255.0)
_MEAN = np.asarray(CLIP_MEAN, np.float32)
_INV_STD = np.float32(1.0) / np.asarray(CLIP_STD, np.float32)


def _check(images_u8: torch.Tensor) -> None:
    if images_u8.dtype != torch.uint8:
        raise TypeError(f"normalize_u8 takes uint8 images, got {images_u8.dtype}")
    if images_u8.dim() != 4 or images_u8.shape[-1] != 3:
        raise ValueError(f"normalize_u8 takes (B, H, W, 3) images, got {tuple(images_u8.shape)}")


def normalize_u8_reference(images_u8: torch.Tensor) -> torch.Tensor:
    """Plain version: ``(x * fl(1/255) - mean) * inv_std`` in fp32, one
    rounded operation at a time."""
    _check(images_u8)
    dev = images_u8.device
    x = images_u8.to(torch.float32) * torch.tensor(_INV255, device=dev)
    return (x - torch.from_numpy(_MEAN).to(dev)) * torch.from_numpy(_INV_STD).to(dev)


def normalize_u8(images_u8: torch.Tensor) -> torch.Tensor:
    """``(B, H, W, 3)`` uint8 -> CLIP-normalised ``(B, H, W, 3)`` fp32.

    A CUDA tensor must be contiguous (a view with an offset is fine: the
    kernel takes an unaligned base itself). A build or launch failure
    raises."""
    _check(images_u8)
    dev = images_u8.device
    if dev.type == "cpu":
        return normalize_u8_reference(images_u8)
    if dev.type != "cuda":
        raise ValueError(f"normalize_u8: unsupported device {dev}")
    if not images_u8.is_contiguous():
        raise ValueError("normalize_u8: images must be contiguous")
    out = torch.empty(images_u8.shape, dtype=torch.float32, device=dev)
    rc = build.call("normalize_u8", dev, images_u8.data_ptr(), out.data_ptr(),
                    images_u8.numel(), *map(float, _MEAN), *map(float, _INV_STD))
    if rc != 0:
        raise RuntimeError(f"normalize_u8 kernel launch failed: CUDA error {rc}")
    normalize_u8.launches += 1
    return out


normalize_u8.launches = 0
