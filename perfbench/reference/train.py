"""Plain fine-tuning steps in float32: the benchmark's reference.

The weighted symmetric InfoNCE of the weak-supervision fine-tune (each
pair weighted ``softmax(w / T) * B``), the global-norm clip, AdamW in
optax's order (moments, bias correction at ``count + 1``, ``u = m / (sqrt(v)
+ eps) + wd * p``, ``p -= lr(count) * u``) under a linear warmup and cosine
decay, and the clamp of the learned logit scale, over the plain towers of
``reference/clip.py`` with autograd.
"""

from __future__ import annotations

import math
from typing import Dict, List, Optional, Sequence

import torch
import torch.nn.functional as F

from .clip import image_features, text_features

__all__ = ["learning_rate", "contrastive_loss", "run_steps"]


def learning_rate(hp: dict, count: int) -> float:
    """Linear warmup from 0 to the peak over ``warmup_steps``, then a
    cosine to 0 at ``total_steps``."""
    peak, warm, total = hp["learning_rate"], hp["warmup_steps"], hp["total_steps"]
    if warm > 0 and count < warm:
        return peak * count / warm
    decay = max(total, warm + 1) - warm
    c = min(count - warm, decay)
    return peak * 0.5 * (1.0 + math.cos(math.pi * c / decay))


def contrastive_loss(img: torch.Tensor, txt: torch.Tensor, scale: torch.Tensor,
                     weak: torch.Tensor, hp: dict) -> torch.Tensor:
    b = img.shape[0]
    logits = scale * (img @ txt.t())
    targets = torch.eye(b, dtype=logits.dtype, device=logits.device)
    smooth = hp.get("label_smoothing", 0.0)
    if smooth:
        targets = targets * (1.0 - smooth) + smooth / b
    ce_i2t = -(targets * F.log_softmax(logits, dim=1)).sum(dim=1)
    ce_t2i = -(targets * F.log_softmax(logits.t(), dim=1)).sum(dim=1)
    weights = torch.softmax(weak / hp["weak_score_temperature"], dim=0) * b
    return (weights * 0.5 * (ce_i2t + ce_t2i)).mean()


def run_steps(params: Dict[str, torch.Tensor], cfg: dict, batches: Sequence[tuple],
              hp: dict, moments: Optional[tuple] = None, count: int = 0) -> dict:
    """Steps from ``params`` (left as they are) over ``batches`` of
    ``(pixels, tokens, weak_scores)``, from AdamW's ``moments`` ``(mu, nu)``
    at step ``count`` (zeros at 0 when None). Returns each step's loss, the
    first step's clipped gradient (``first_grads``) and every leaf's norm
    of it, every leaf's norm of the change of the parameters after the
    last step, and the parameters then (``params``)."""
    p = {k: v.detach().clone().requires_grad_(True) for k, v in params.items()}
    names = list(p)
    if moments is None:
        mu = {k: torch.zeros_like(v) for k, v in p.items()}
        nu = {k: torch.zeros_like(v) for k, v in p.items()}
    else:
        mu, nu = ({k: v.detach().float().clone() for k, v in m.items()} for m in moments)
    b1, b2, eps = hp["adam_b1"], hp["adam_b2"], hp["adam_eps"]
    losses: List[float] = []
    first: Dict[str, torch.Tensor] = {}
    for count, (pixels, tokens, weak) in enumerate(batches, start=count):
        img = image_features(p, cfg, pixels)
        txt = text_features(p, cfg, tokens)
        loss = contrastive_loss(img, txt, p["logit_scale"].exp(), weak, hp)
        grads = torch.autograd.grad(loss, [p[k] for k in names])
        losses.append(float(loss.detach()))
        with torch.no_grad():
            norm = torch.sqrt(sum((g * g).sum() for g in grads))
            if norm >= hp["max_grad_norm"]:
                grads = [g * (hp["max_grad_norm"] / norm) for g in grads]
            if not first:
                first = {k: g.detach().clone() for k, g in zip(names, grads)}
            lr = learning_rate(hp, count)
            t = count + 1
            for k, g in zip(names, grads):
                mu[k] = b1 * mu[k] + (1.0 - b1) * g
                nu[k] = b2 * nu[k] + (1.0 - b2) * g * g
                m_hat = mu[k] / (1.0 - b1 ** t)
                v_hat = nu[k] / (1.0 - b2 ** t)
                update = m_hat / (torch.sqrt(v_hat) + eps) + hp["weight_decay"] * p[k]
                p[k] -= lr * update
            p["logit_scale"].clamp_(max=hp["max_logit_scale"])
    with torch.no_grad():
        change = {k: float((p[k] - params[k]).norm()) for k in names}
    return {"losses": losses, "first_grads": first,
            "first_grad": {k: float(g.norm()) for k, g in first.items()}, "change": change,
            "params": {k: v.detach() for k, v in p.items()}}
