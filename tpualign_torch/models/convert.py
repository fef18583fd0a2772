"""Weights from the JAX package's parameter tree.

The port's parameters keep the JAX layouts (HWIO patch kernel, ``(in,
out)`` projection kernels, LayerNorm ``scale``/``bias``), so a transfer is
a renaming and a copy. The caller turns the JAX tree into nested dicts of
numpy arrays (``jax.tree.map(np.asarray, params)``); nothing here imports
JAX. :func:`lora_from_jax` carries a LoRA adapter tree across (``{"a",
"b"}`` under each adapted kernel, plus ``logit_scale``), and
:func:`to_jax_layout` goes back: a dict in the port's names (parameters, adapters, optimizer
moments) to nested numpy arrays under the JAX names.
"""

from __future__ import annotations

import re
from typing import Mapping

import numpy as np
import torch

from tpualign_torch.models.clip import CLIP

__all__ = ["from_jax_params", "lora_from_jax", "to_jax_layout"]

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


_INVERSE = (
    (re.compile(r"\.resblocks\.(\d+)\."), r".resblock_\1."),
    (re.compile(r"^visual\.conv1_kernel"), "visual.conv1.kernel"),
)


def _torch_name(jax_name: str) -> str:
    for pattern, repl in _RENAMES:
        jax_name = pattern.sub(repl, jax_name)
    return jax_name


def _jax_name(torch_name: str) -> str:
    for pattern, repl in _INVERSE:
        torch_name = pattern.sub(repl, torch_name)
    return torch_name


@torch.no_grad()
def lora_from_jax(model: CLIP, tree: Mapping) -> dict:
    """A JAX LoRA adapter tree as the port's adapter dict (``<name>.a``
    (d_in, r), ``<name>.b`` (r, d_out), ``logit_scale``; see
    ``train/lora.py``), fp32 on the model's device, checked against the
    model's adapted kernels. The model is left as it is."""
    from tpualign_torch.train.lora import LORA_TARGET_SUFFIXES

    flat = {_torch_name(k): v for k, v in _flatten(tree).items()}
    params = dict(model.named_parameters())
    device = params["logit_scale"].device
    out = {}
    for name, value in flat.items():
        base, _, part = name.rpartition(".")
        if name == "logit_scale":
            want = ()
        elif (part in ("a", "b") and base in params and params[base].dim() == 2
              and base.endswith(LORA_TARGET_SUFFIXES)):
            d_in, d_out = params[base].shape
            rank = value.shape[1] if part == "a" else value.shape[0]
            want = (d_in, rank) if part == "a" else (rank, d_out)
        else:
            raise KeyError(f"adapter tree entry {name!r} matches no kernel of the model")
        if tuple(value.shape) != want:
            raise ValueError(f"{name}: shape {value.shape} != {want}")
        out[name] = torch.from_numpy(np.array(value, np.float32)).to(device)
    if "logit_scale" not in out:
        raise KeyError("adapter tree has no logit_scale")
    return out


@torch.no_grad()
def from_jax_params(model: CLIP, tree: Mapping):
    """Load the JAX parameter tree ``tree`` into ``model`` (every parameter
    must be matched, by name and shape, both ways) and return the model."""
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


def to_jax_layout(params: Mapping[str, torch.Tensor]) -> dict:
    """A dict in the port's names (parameters, LoRA adapters, or optimizer
    moments of either) -> nested dicts of float32 numpy arrays under the
    JAX tree's names: the inverse of :func:`from_jax_params` and
    :func:`lora_from_jax`."""
    tree: dict = {}
    for name, value in params.items():
        node = tree
        *path, leaf = _jax_name(name).split(".")
        for part in path:
            node = node.setdefault(part, {})
        node[leaf] = value.detach().to(torch.float32).cpu().numpy()
    return tree
