"""Contrastive losses with weak-supervision weighting (the port's
``tpualign.train.loss``).

Symmetric CLIP InfoNCE over the batch, where per-pair weak-supervision
scores w in [0, 1] reweight each pair as ``softmax(w / T) * B`` (so the
mean gradient scale does not depend on the score distribution); the
pairwise sigmoid loss of SigLIP; and relational distillation on the
``(B, B)`` logit matrix. Plain functions on tensors; the similarity
products are fp32, as tpualign's ``preferred_element_type=float32`` dots.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch
import torch.nn.functional as F

__all__ = ["clip_contrastive_loss", "siglip_loss", "distill_kl_loss"]


def _logits(img: torch.Tensor, txt: torch.Tensor) -> torch.Tensor:
    return torch.matmul(img.float(), txt.float().t())


def _accuracies(logits: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    target = torch.arange(logits.shape[0], device=logits.device)
    acc_i2t = (logits.argmax(dim=-1) == target).float().mean()
    acc_t2i = (logits.argmax(dim=0) == target).float().mean()
    return acc_i2t, acc_t2i


def _weights(weak_scores: Optional[torch.Tensor], b: int, temperature: float,
             device) -> torch.Tensor:
    if weak_scores is None:
        return torch.ones(b, dtype=torch.float32, device=device)
    return torch.softmax(weak_scores.float() / temperature, dim=0) * b


def distill_kl_loss(student_img: torch.Tensor, student_txt: torch.Tensor,
                    student_scale: torch.Tensor, teacher_img: torch.Tensor,
                    teacher_txt: torch.Tensor, teacher_scale: torch.Tensor,
                    temperature: float = 1.0) -> torch.Tensor:
    """Symmetric KL(teacher || student) over both retrieval directions'
    softmax rows of the ``(B, B)`` logits, times ``temperature**2``. The
    teacher's logits carry no gradient; the embedding widths may differ."""
    ls = student_scale * _logits(student_img, student_txt) / temperature
    lt = (teacher_scale * _logits(teacher_img, teacher_txt) / temperature).detach()

    def kl(lt_, ls_):
        pt = torch.softmax(lt_, dim=-1)
        return torch.sum(pt * (F.log_softmax(lt_, -1) - F.log_softmax(ls_, -1)), dim=-1)

    per_row = 0.5 * (kl(lt, ls) + kl(lt.t(), ls.t()))
    return per_row.mean() * (temperature ** 2)


def siglip_loss(image_embs: torch.Tensor, text_embs: torch.Tensor,
                logit_scale: torch.Tensor, logit_bias: torch.Tensor,
                weak_scores: Optional[torch.Tensor] = None,
                weight_temperature: float = 0.5) -> Tuple[torch.Tensor, dict]:
    """SigLIP pairwise sigmoid loss (arXiv:2303.15343): label +1 on the
    diagonal, -1 off it; weak scores weight each image's row."""
    b = image_embs.shape[0]
    logits = logit_scale * _logits(image_embs, text_embs) + logit_bias
    signs = 2.0 * torch.eye(b, dtype=torch.float32, device=logits.device) - 1.0
    pairwise = F.softplus(-signs * logits)  # -log sigmoid(sign * logit)
    if weak_scores is not None:
        pairwise = pairwise * _weights(weak_scores, b, weight_temperature, logits.device)[:, None]
    loss = pairwise.sum() / b
    acc_i2t, acc_t2i = _accuracies(logits)
    return loss, {"loss": loss, "acc_i2t": acc_i2t, "acc_t2i": acc_t2i,
                  "logit_scale": logit_scale}


def clip_contrastive_loss(image_embs: torch.Tensor, text_embs: torch.Tensor,
                          logit_scale: torch.Tensor,
                          weak_scores: Optional[torch.Tensor] = None,
                          weight_temperature: float = 0.5,
                          label_smoothing: float = 0.0) -> Tuple[torch.Tensor, dict]:
    """Weighted symmetric InfoNCE over ``(B, D)`` unit-norm rows (row i
    paired), ``logit_scale`` the exp'd temperature. Returns ``(loss,
    metrics)`` with the retrieval accuracies of both directions."""
    b = image_embs.shape[0]
    logits = logit_scale * _logits(image_embs, text_embs)  # image-major
    targets = torch.eye(b, dtype=torch.float32, device=logits.device)
    if label_smoothing > 0.0:
        targets = targets * (1.0 - label_smoothing) + label_smoothing / b
    ce_i2t = -torch.sum(targets * F.log_softmax(logits, dim=-1), dim=-1)
    ce_t2i = -torch.sum(targets * F.log_softmax(logits.t(), dim=-1), dim=-1)
    per_pair = 0.5 * (ce_i2t + ce_t2i)
    loss = torch.mean(_weights(weak_scores, b, weight_temperature, logits.device) * per_pair)
    acc_i2t, acc_t2i = _accuracies(logits)
    return loss, {"loss": loss, "acc_i2t": acc_i2t, "acc_t2i": acc_t2i,
                  "logit_scale": logit_scale}
