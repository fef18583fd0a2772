"""CLIP image preprocessing on the host (the port's copy of
``tpualign.ops.preprocess``: the channel statistics and the PIL path).

The uint8-bucket device resize of the JAX package is a later slice.
"""

from __future__ import annotations

import numpy as np

CLIP_MEAN = (0.48145466, 0.4578275, 0.40821073)
CLIP_STD = (0.26862954, 0.26130258, 0.27577711)

__all__ = ["CLIP_MEAN", "CLIP_STD", "preprocess_host"]


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
