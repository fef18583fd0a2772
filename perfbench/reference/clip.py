"""Plain two-tower CLIP in float32: the benchmark's reference.

Written from the published architecture (Radford et al. 2021, open_clip's
``VisionTransformer`` and ``TextTransformer``), not from the program:
pre-LN residual blocks, LayerNorm with eps 1e-5, multi-head attention as
explicit products and a softmax, QuickGELU or exact GELU, the class token
through ``ln_post`` and the EOT token (the largest id) through
``ln_final``, then the projections and an L2 normalisation. Parameters
are a dict of tensors under the names of ``perfbench/weights.py``; every
product is a plain float32 ``matmul`` (run it with TF32 off).
"""

from __future__ import annotations

import math
from typing import Dict, Optional

import torch
import torch.nn.functional as F

__all__ = ["image_features", "text_features", "no_tf32"]

Params = Dict[str, torch.Tensor]


class no_tf32:
    """Full float32 products inside the block on CUDA (TF32 off in cuBLAS
    and cuDNN); the previous flags come back after."""

    def __enter__(self):
        self.prev = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32)
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        return self

    def __exit__(self, *exc):
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = self.prev
        return False


def _layer_norm(x: torch.Tensor, p: Params, name: str) -> torch.Tensor:
    mean = x.mean(dim=-1, keepdim=True)
    var = ((x - mean) ** 2).mean(dim=-1, keepdim=True)
    return (x - mean) / torch.sqrt(var + 1e-5) * p[f"{name}.scale"] + p[f"{name}.bias"]


def _attention(x: torch.Tensor, p: Params, name: str, heads: int,
               mask: Optional[torch.Tensor]) -> torch.Tensor:
    b, t, w = x.shape
    hd = w // heads
    qkv = x @ p[f"{name}.in_proj_kernel"] + p[f"{name}.in_proj_bias"]
    q, k, v = (z.reshape(b, t, heads, hd).transpose(1, 2) for z in qkv.split(w, dim=-1))
    scores = (q @ k.transpose(-1, -2)) / math.sqrt(hd)
    if mask is not None:
        scores = scores + mask
    ctx = torch.softmax(scores, dim=-1) @ v
    ctx = ctx.transpose(1, 2).reshape(b, t, w)
    return ctx @ p[f"{name}.out_proj_kernel"] + p[f"{name}.out_proj_bias"]


def _mlp(x: torch.Tensor, p: Params, name: str, quick_gelu: bool) -> torch.Tensor:
    h = x @ p[f"{name}.c_fc_kernel"] + p[f"{name}.c_fc_bias"]
    h = h * torch.sigmoid(1.702 * h) if quick_gelu else F.gelu(h)
    return h @ p[f"{name}.c_proj_kernel"] + p[f"{name}.c_proj_bias"]


def _blocks(x: torch.Tensor, p: Params, prefix: str, layers: int, heads: int,
            quick_gelu: bool, mask: Optional[torch.Tensor]) -> torch.Tensor:
    for i in range(layers):
        name = f"{prefix}.resblocks.{i}"
        x = x + _attention(_layer_norm(x, p, f"{name}.ln_1"), p, f"{name}.attn", heads, mask)
        x = x + _mlp(_layer_norm(x, p, f"{name}.ln_2"), p, f"{name}.mlp", quick_gelu)
    return x


def image_features(p: Params, cfg: dict, pixels: torch.Tensor) -> torch.Tensor:
    """(B, S, S, 3) normalised float32 pixels -> (B, E) unit rows."""
    v = cfg["vision_cfg"]
    b, s = pixels.shape[0], v["image_size"]
    ps, w = v["patch_size"], v["width"]
    g = s // ps
    # the patch convolution (stride = kernel = patch, no bias) as one product
    patches = pixels.reshape(b, g, ps, g, ps, 3).permute(0, 1, 3, 2, 4, 5)
    patches = patches.reshape(b, g * g, ps * ps * 3)
    x = patches @ p["visual.conv1_kernel"].reshape(ps * ps * 3, w)
    cls = p["visual.class_embedding"].expand(b, 1, w)
    x = torch.cat([cls, x], dim=1) + p["visual.positional_embedding"]
    x = _layer_norm(x, p, "visual.ln_pre")
    x = _blocks(x, p, "visual.transformer", v["layers"], w // v["head_width"],
                cfg["quick_gelu"], None)
    x = _layer_norm(x[:, 0], p, "visual.ln_post") @ p["visual.proj"]
    return x / x.norm(dim=-1, keepdim=True)


def text_features(p: Params, cfg: dict, tokens: torch.Tensor) -> torch.Tensor:
    """(B, T) token ids, zero after EOT -> (B, E) unit rows."""
    t = cfg["text_cfg"]
    n = tokens.shape[1]
    ids = tokens.long()
    x = p["text.token_embedding"][ids] + p["text.positional_embedding"][:n]
    mask = torch.full((n, n), float("-inf"), device=x.device).triu(1)
    x = _blocks(x, p, "text.transformer", t["layers"], t["heads"], cfg["quick_gelu"], mask)
    x = _layer_norm(x, p, "text.ln_final")
    x = x[torch.arange(x.shape[0], device=x.device), ids.argmax(dim=-1)]
    x = x @ p["text.text_projection"]
    return x / x.norm(dim=-1, keepdim=True)
