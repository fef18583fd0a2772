"""LoRA adapters for contrastive fine-tuning (arXiv:2106.09685): the port's
``tpualign.train.lora``.

Every block kernel W ``(d_in, d_out)`` gains a trainable pair A ``(d_in,
r)``, B ``(r, d_out)``, applied as ``W + (alpha/r)·A@B``; the base stays
frozen. ``logit_scale`` stays trainable as a plain leaf that overrides the
frozen value. Trees are flat dicts in the port's parameter names: the
adapter of ``<name>`` is ``<name>.a`` and ``<name>.b``.

A is drawn from a ``torch.Generator`` seeded with ``seed`` on the base's
device: the same distribution as tpualign's ``jax.random`` draws (N(0, 1)
/ r), not the same numbers. To start both packages from one adapter tree,
carry tpualign's across with
:func:`tpualign_torch.models.convert.lora_from_jax`.
"""

from __future__ import annotations

from typing import Dict

import torch

__all__ = ["lora_init", "lora_apply", "lora_param_count", "LORA_TARGET_SUFFIXES"]

# the kernels that receive adapters: every transformer block matmul
LORA_TARGET_SUFFIXES = (
    "attn.in_proj_kernel",
    "attn.out_proj_kernel",
    "mlp.c_fc_kernel",
    "mlp.c_proj_kernel",
)


def _is_target(name: str, leaf: torch.Tensor) -> bool:
    return leaf.dim() == 2 and name.endswith(LORA_TARGET_SUFFIXES)


@torch.no_grad()
def lora_init(params: Dict[str, torch.Tensor], rank: int,
              seed: int = 0) -> Dict[str, torch.Tensor]:
    """The trainable adapter dict for a parameter dict: ``{"<name>.a":
    N(0, 1/r) (d_in, r), "<name>.b": zeros (r, d_out)}`` per targeted
    kernel (B = 0 makes the merged model exactly the base), plus a copy of
    ``logit_scale``."""
    if rank <= 0:
        raise ValueError(f"lora rank must be positive, got {rank}")
    device = params["logit_scale"].device
    gen = torch.Generator(device=device).manual_seed(seed)
    lora: Dict[str, torch.Tensor] = {}
    for name, leaf in params.items():
        if _is_target(name, leaf):
            d_in, d_out = leaf.shape
            lora[f"{name}.a"] = torch.randn(d_in, rank, generator=gen, device=device,
                                            dtype=torch.float32) / rank
            lora[f"{name}.b"] = torch.zeros(rank, d_out, device=device, dtype=torch.float32)
    # a real copy: the trainable scale must not share the frozen tree's storage
    lora["logit_scale"] = params["logit_scale"].detach().to(torch.float32).clone()
    return lora


def lora_apply(params: Dict[str, torch.Tensor], lora: Dict[str, torch.Tensor],
               scale: float) -> Dict[str, torch.Tensor]:
    """Merge adapters into the frozen dict: ``W + scale·A@B`` in W's dtype;
    plain leaves of ``lora`` (``logit_scale``) override the frozen value.
    Differentiable in ``lora``; the result has the base's names."""
    out = {}
    for name, p in params.items():
        a = lora.get(f"{name}.a")
        if a is not None:
            out[name] = (p + scale * torch.matmul(a, lora[f"{name}.b"])).to(p.dtype)
        else:
            out[name] = lora.get(name, p)
    return out


def lora_param_count(lora: Dict[str, torch.Tensor]) -> int:
    """Total trainable elements in an adapter dict."""
    return int(sum(x.numel() for x in lora.values()))
