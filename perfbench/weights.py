"""Seeded CLIP weights, made on the device from the run's seed.

The benchmark, not the program, makes the weights: one draw of standard
normals for the whole model from a generator on the device, cut into the
leaves and scaled there. The same seed gives the same tensors, so the
reference draws them again after the window instead of keeping a copy.
Leaf names are the port's parameter names; the harness checks that the
program's model has exactly these leaves and shapes before it copies them
in.
"""

from __future__ import annotations

import hashlib
import math
from typing import Dict, List, Tuple

import torch

__all__ = ["sub_seed", "generator", "clip_param_spec", "make_weights", "tower_shapes"]


def sub_seed(seed: int, tag: str) -> int:
    """A 63-bit seed for one stream of the run (weights, inputs, batches)."""
    digest = hashlib.sha256(f"{int(seed)}:{tag}".encode()).digest()
    return int.from_bytes(digest[:8], "little") >> 1


def generator(seed: int, tag: str, device: torch.device) -> torch.Generator:
    return torch.Generator(device=device).manual_seed(sub_seed(seed, tag))


def tower_shapes(cfg: dict) -> dict:
    """Widths of both towers from a configuration file's dict."""
    v, t = cfg["vision_cfg"], cfg["text_cfg"]
    grid = v["image_size"] // v["patch_size"]
    return {
        "vision": {"width": v["width"], "layers": v["layers"],
                   "heads": v["width"] // v["head_width"],
                   "mlp": v["width"] * v["mlp_ratio"], "seq": grid * grid + 1,
                   "patch": v["patch_size"], "image_size": v["image_size"]},
        "text": {"width": t["width"], "layers": t["layers"], "heads": t["heads"],
                 "mlp": t["width"] * t["mlp_ratio"], "seq": t["context_length"],
                 "vocab": t["vocab_size"]},
        "embed_dim": cfg["embed_dim"],
    }


def _block(prefix: str, width: int, mlp: int) -> List[Tuple[str, tuple, float, float]]:
    """One pre-LN residual block: (name, shape, std, mean)."""
    def xavier(fan_in, fan_out):
        return math.sqrt(2.0 / (fan_in + fan_out))

    return [
        (f"{prefix}.ln_1.scale", (width,), 0.02, 1.0),
        (f"{prefix}.ln_1.bias", (width,), 0.02, 0.0),
        (f"{prefix}.attn.in_proj_kernel", (width, 3 * width), xavier(width, 3 * width), 0.0),
        (f"{prefix}.attn.in_proj_bias", (3 * width,), 0.02, 0.0),
        (f"{prefix}.attn.out_proj_kernel", (width, width), xavier(width, width), 0.0),
        (f"{prefix}.attn.out_proj_bias", (width,), 0.02, 0.0),
        (f"{prefix}.ln_2.scale", (width,), 0.02, 1.0),
        (f"{prefix}.ln_2.bias", (width,), 0.02, 0.0),
        (f"{prefix}.mlp.c_fc_kernel", (width, mlp), xavier(width, mlp), 0.0),
        (f"{prefix}.mlp.c_fc_bias", (mlp,), 0.02, 0.0),
        (f"{prefix}.mlp.c_proj_kernel", (mlp, width), xavier(mlp, width), 0.0),
        (f"{prefix}.mlp.c_proj_bias", (width,), 0.02, 0.0),
    ]


def clip_param_spec(cfg: dict) -> List[Tuple[str, tuple, float, float]]:
    """Every leaf of a two-tower CLIP: (name, shape, std, mean). Kernels
    are ``(in, out)``, the patch kernel HWIO, LayerNorms ``scale``/``bias``;
    ``logit_scale`` is log(1/0.07) (std 0)."""
    s = tower_shapes(cfg)
    v, t, e = s["vision"], s["text"], s["embed_dim"]
    p, w = v["patch"], v["width"]
    spec = [
        ("visual.conv1_kernel", (p, p, 3, w), 1.0 / math.sqrt(p * p * 3), 0.0),
        ("visual.class_embedding", (w,), w ** -0.5, 0.0),
        ("visual.positional_embedding", (v["seq"], w), w ** -0.5, 0.0),
        ("visual.ln_pre.scale", (w,), 0.02, 1.0),
        ("visual.ln_pre.bias", (w,), 0.02, 0.0),
    ]
    for i in range(v["layers"]):
        spec += _block(f"visual.transformer.resblocks.{i}", w, v["mlp"])
    spec += [
        ("visual.ln_post.scale", (w,), 0.02, 1.0),
        ("visual.ln_post.bias", (w,), 0.02, 0.0),
        ("visual.proj", (w, e), w ** -0.5, 0.0),
    ]
    tw = t["width"]
    spec += [
        ("text.token_embedding", (t["vocab"], tw), 0.02, 0.0),
        ("text.positional_embedding", (t["seq"], tw), 0.01, 0.0),
    ]
    for i in range(t["layers"]):
        spec += _block(f"text.transformer.resblocks.{i}", tw, t["mlp"])
    spec += [
        ("text.ln_final.scale", (tw,), 0.02, 1.0),
        ("text.ln_final.bias", (tw,), 0.02, 0.0),
        ("text.text_projection", (tw, e), tw ** -0.5, 0.0),
        ("logit_scale", (), 0.0, math.log(1.0 / 0.07)),
    ]
    return spec


@torch.no_grad()
def make_weights(cfg: dict, seed: int, device: torch.device) -> Dict[str, torch.Tensor]:
    """The model's fp32 leaves: one ``randn`` over every element on
    ``device``, cut into views and scaled in place (one storage)."""
    spec = clip_param_spec(cfg)
    total = sum(math.prod(shape) for _, shape, _, _ in spec)
    flat = torch.randn(total, generator=generator(seed, "weights", device), device=device,
                       dtype=torch.float32)
    out, off = {}, 0
    for name, shape, std, mean in spec:
        n = math.prod(shape)
        leaf = flat[off:off + n].view(shape)
        leaf.mul_(std).add_(mean)
        out[name] = leaf
        off += n
    return out
