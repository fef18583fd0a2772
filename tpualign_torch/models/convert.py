"""Weights from the JAX package's parameter tree.

The port's parameters keep the JAX layouts (HWIO patch kernel, ``(in,
out)`` projection kernels, LayerNorm ``scale``/``bias``), so a transfer is
a renaming and a copy. The caller turns the JAX tree into nested dicts of
numpy arrays (``jax.tree.map(np.asarray, params)``); nothing here imports
JAX.
"""

from __future__ import annotations

import re
from typing import Mapping

import numpy as np
import torch

from tpualign_torch.models.clip import CLIP

__all__ = ["from_jax_params"]

_RENAMES = (
    (re.compile(r"\.resblock_(\d+)\."), r".resblocks.\1."),
    (re.compile(r"^visual\.conv1\.kernel$"), "visual.conv1_kernel"),
)


def _flatten(tree: Mapping, prefix: str = "") -> dict:
    """Nested dicts -> {"visual.transformer.resblock_0.attn.in_proj_kernel":
    array, ...} in the JAX tree's names."""
    flat = {}
    for key, value in tree.items():
        name = f"{prefix}{key}"
        if isinstance(value, Mapping):
            flat.update(_flatten(value, name + "."))
        else:
            flat[name] = np.asarray(value)
    return flat


def _torch_name(jax_name: str) -> str:
    for pattern, repl in _RENAMES:
        jax_name = pattern.sub(repl, jax_name)
    return jax_name


@torch.no_grad()
def from_jax_params(model: CLIP, tree: Mapping) -> CLIP:
    """Load the JAX parameter tree ``tree`` into ``model``; every parameter
    must be matched, by name and shape, both ways."""
    params = dict(model.named_parameters())
    flat = {_torch_name(k): v for k, v in _flatten(tree).items()}
    missing = sorted(set(params) - set(flat))
    extra = sorted(set(flat) - set(params))
    if missing or extra:
        raise KeyError(f"parameter trees differ: missing {missing[:5]}, "
                       f"unexpected {extra[:5]}")
    for name, p in params.items():
        value = flat[name]
        if tuple(value.shape) != tuple(p.shape):
            raise ValueError(f"{name}: shape {value.shape} != {tuple(p.shape)}")
        p.copy_(torch.from_numpy(np.array(value, np.float32)))
    return model
