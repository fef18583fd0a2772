"""The optimizer of the training step: the port's copy of what tpualign's
``make_optimizer`` builds with optax (``train/step.py``).

    optax.chain(clip_by_global_norm(1.0),
                adamw(warmup_cosine_decay_schedule(0 -> lr -> 0),
                      b1=0.9, b2=0.98, eps=1e-6, weight_decay, mu_dtype))

written out on tensor dicts, in place, in optax's order of operations and
roundings: the moments first, bias correction at ``count + 1``, then
``u = m̂ / (√v̂ + eps) + wd·p`` (every leaf decays: ``mask=None``), then
``p += -lr(count)·u`` with the schedule read at the count BEFORE the
increment (so a warmup's first step has lr 0: the moments move, the
params do not). A bf16 first moment is read into the fp32 update (``b1·mu``
in bf16 with ``b1`` itself rounded to bf16, as JAX's weak-typed product
is) and stored back in bf16. ``torch.optim.AdamW`` is not used: it applies the decay as a
separate multiply before the Adam step (another rounding order) and keeps
no bf16 first moment. The ``torch._foreach_*`` ops do the same elementwise
arithmetic as per-tensor ops, with one launch per list.
"""

from __future__ import annotations

import math
from typing import Dict, List

import numpy as np
import torch

__all__ = ["AdamW", "warmup_cosine_decay", "global_norm", "clip_by_global_norm"]

B1, B2, EPS = 0.9, 0.98, 1e-6
MAX_GRAD_NORM = 1.0


def warmup_cosine_decay(peak: float, warmup_steps: int, total_steps: int):
    """optax's ``warmup_cosine_decay_schedule(0, peak, warmup_steps,
    max(total_steps, warmup_steps + 1))`` in float32: a count -> lr map.
    ``warmup_steps=0`` takes the cosine arm from count 0 (optax's
    ``join_schedules`` at boundary 0)."""
    f32 = np.float32
    decay_steps = max(total_steps, warmup_steps + 1) - warmup_steps

    def schedule(count: int) -> float:
        if warmup_steps > 0 and count < warmup_steps:
            c = min(max(count, 0), warmup_steps)
            frac = f32(1) - f32(c) / f32(warmup_steps)
            return float(f32(-peak) * frac + f32(peak))
        c = f32(min(count - warmup_steps, decay_steps))
        cosine = f32(0.5) * (f32(1) + np.cos(f32(math.pi) * c / f32(decay_steps)))
        return float(f32(peak) * cosine)

    return schedule


def global_norm(tensors: List[torch.Tensor]) -> torch.Tensor:
    """``sqrt(Σ‖t‖²)`` over a list of tensors, an fp32 0-dim tensor."""
    norms = torch.stack([n.float() for n in torch._foreach_norm(tensors)])
    return torch.sqrt(torch.sum(norms * norms))


def clip_by_global_norm(grads: List[torch.Tensor], g_norm: torch.Tensor) -> List[torch.Tensor]:
    """optax's ``clip_by_global_norm(1.0)``: unchanged below 1, else
    ``(g / ‖g‖) · 1``. Below the limit the divisor is 1, which divides
    exactly, so the choice needs no read of ``g_norm`` on the host."""
    g_norm = g_norm.to(grads[0].device)
    divisor = torch.where(g_norm < MAX_GRAD_NORM, torch.ones_like(g_norm), g_norm)
    return torch._foreach_div(grads, divisor)


class AdamW:
    """The chain ``clip_by_global_norm(1.0) -> adamw`` over tensor dicts.

    ``init(params)`` gives the state ``{"count": 0, "mu": {...}, "nu":
    {...}}`` (``mu`` in ``mu_dtype``, ``nu`` fp32); ``update(params, grads,
    state, g_norm)`` writes the new params in place and returns the new
    state. ``g_norm`` is the raw gradients' global norm (the step reports
    it as ``grad_norm``)."""

    def __init__(self, learning_rate: float, warmup_steps: int, total_steps: int,
                 weight_decay: float, mu_dtype: torch.dtype = torch.float32):
        self.schedule = warmup_cosine_decay(learning_rate, warmup_steps, total_steps)
        self.weight_decay = weight_decay
        self.mu_dtype = mu_dtype

    def init(self, params: Dict[str, torch.Tensor]) -> dict:
        return {"count": 0,
                "mu": {k: torch.zeros(p.shape, dtype=self.mu_dtype, device=p.device)
                       for k, p in params.items()},
                "nu": {k: torch.zeros(p.shape, dtype=torch.float32, device=p.device)
                       for k, p in params.items()}}

    @torch.no_grad()
    def update(self, params: Dict[str, torch.Tensor], grads: Dict[str, torch.Tensor],
               state: dict, g_norm: torch.Tensor) -> dict:
        names = list(params)
        p = [params[k] for k in names]
        g = clip_by_global_norm([grads[k].float() for k in names], g_norm)
        mu = [state["mu"][k] for k in names]
        nu = [state["nu"][k] for k in names]
        count = int(state["count"])
        count_inc = count + 1
        f32 = np.float32
        bc1 = float(f32(1) - f32(B1) ** f32(count_inc))
        bc2 = float(f32(1) - f32(B2) ** f32(count_inc))
        # moments: (1 - b) * g**order + b * moment
        # JAX casts the weak-typed b1 to a bf16 moment's own dtype before the
        # product: bf16(0.9) = 0.8984375
        b1 = float(torch.tensor(B1, dtype=self.mu_dtype))
        mu32 = torch._foreach_add(torch._foreach_mul(g, 1 - B1), torch._foreach_mul(mu, b1))
        nu32 = torch._foreach_add(torch._foreach_mul(torch._foreach_mul(g, g), 1 - B2),
                                  torch._foreach_mul(nu, B2))
        mu_hat = torch._foreach_div(mu32, bc1)
        nu_hat = torch._foreach_div(nu32, bc2)
        denom = torch._foreach_sqrt(nu_hat)
        torch._foreach_add_(denom, EPS)
        u = torch._foreach_div(mu_hat, denom)
        torch._foreach_add_(u, torch._foreach_mul(p, self.weight_decay))
        step_size = float(f32(-self.schedule(count)))
        torch._foreach_mul_(u, step_size)
        torch._foreach_add_(p, u)
        if self.mu_dtype != torch.float32:
            mu32 = [m.to(self.mu_dtype) for m in mu32]
        return {"count": count_inc, "mu": dict(zip(names, mu32)), "nu": dict(zip(names, nu32))}
