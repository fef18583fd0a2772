"""Positional (bounding-box) alignment scoring (the port's
``tpualign.weaksup.positional``).

Per pair:

- missing bbox, wrong arity, zero width or height (either box) -> 0;
- boxes intersect (strictly: x2 > x1 and y2 > y1) -> IoU (0 when the
  union is 0);
- disjoint -> ``max(0, 1 - centre_distance / 1000)``.

:func:`positional_scores` computes the whole (I, C) grid in torch, fp32,
on the device of its inputs (or ``device``), one rounded operation at a
time in tpualign's order, so its scores equal tpualign's bit for bit.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

__all__ = ["positional_scores", "positional_score_scalar", "MAX_CENTER_DISTANCE"]

MAX_CENTER_DISTANCE = 1000.0


def _as_f32(x, device: torch.device) -> torch.Tensor:
    if isinstance(x, torch.Tensor):
        return x.to(device=device, dtype=torch.float32)
    return torch.as_tensor(np.asarray(x, np.float32), device=device)


def positional_scores(img_bboxes, chunk_bboxes,
                      device: Optional[str | torch.device] = None) -> torch.Tensor:
    """(I, 4) x (C, 4) -> (I, C) float32 positional alignment scores.

    Inputs are arrays or tensors; the grid is computed on ``device``, else
    on the device of ``img_bboxes`` when it is a tensor, else on the CPU.
    Rows of zeros (or of zero width or height) score 0 against everything.
    """
    if device is None:
        device = img_bboxes.device if isinstance(img_bboxes, torch.Tensor) else "cpu"
    device = torch.device(device)
    a = _as_f32(img_bboxes, device)    # (I, 4)
    b = _as_f32(chunk_bboxes, device)  # (C, 4)

    aw = a[:, 2] - a[:, 0]
    ah = a[:, 3] - a[:, 1]
    bw = b[:, 2] - b[:, 0]
    bh = b[:, 3] - b[:, 1]
    valid = ((aw != 0) & (ah != 0))[:, None] & ((bw != 0) & (bh != 0))[None, :]

    x1 = torch.maximum(a[:, None, 0], b[None, :, 0])
    y1 = torch.maximum(a[:, None, 1], b[None, :, 1])
    x2 = torch.minimum(a[:, None, 2], b[None, :, 2])
    y2 = torch.minimum(a[:, None, 3], b[None, :, 3])
    intersects = (x2 > x1) & (y2 > y1)

    inter = torch.clamp_min(x2 - x1, 0.0) * torch.clamp_min(y2 - y1, 0.0)
    area_a = (aw * ah)[:, None]
    area_b = (bw * bh)[None, :]
    union = area_a + area_b - inter
    nonzero = union != 0
    iou = torch.where(nonzero, inter / torch.where(nonzero, union, 1.0), 0.0)

    acx = (a[:, 0] + a[:, 2]) * 0.5
    acy = (a[:, 1] + a[:, 3]) * 0.5
    bcx = (b[:, 0] + b[:, 2]) * 0.5
    bcy = (b[:, 1] + b[:, 3]) * 0.5
    dx = acx[:, None] - bcx[None, :]
    dy = acy[:, None] - bcy[None, :]
    # the square root in float64, rounded once to fp32: correctly rounded,
    # as XLA's is (torch's vectorised fp32 sqrt on the CPU is not always)
    dist = torch.sqrt((dx * dx + dy * dy).double()).float()
    # a tensor divisor: CUDA takes a Python scalar's reciprocal instead
    limit = torch.tensor(MAX_CENTER_DISTANCE, dtype=torch.float32, device=device)
    dist_score = torch.clamp_min(1.0 - dist / limit, 0.0)

    score = torch.where(intersects, iou, dist_score)
    return torch.where(valid, score, 0.0)


def positional_score_scalar(img_bbox, chunk_bbox) -> float:
    """The per-pair rule written out for one pair, in Python floats: the
    oracle the tests hold :func:`positional_scores` to."""
    if not img_bbox or not chunk_bbox:
        return 0.0
    if len(img_bbox) != 4 or len(chunk_bbox) != 4:
        return 0.0
    if (img_bbox[2] - img_bbox[0] == 0) or (img_bbox[3] - img_bbox[1] == 0):
        return 0.0
    if (chunk_bbox[2] - chunk_bbox[0] == 0) or (chunk_bbox[3] - chunk_bbox[1] == 0):
        return 0.0
    x1 = max(img_bbox[0], chunk_bbox[0])
    y1 = max(img_bbox[1], chunk_bbox[1])
    x2 = min(img_bbox[2], chunk_bbox[2])
    y2 = min(img_bbox[3], chunk_bbox[3])
    if x2 <= x1 or y2 <= y1:
        ic = ((img_bbox[0] + img_bbox[2]) / 2, (img_bbox[1] + img_bbox[3]) / 2)
        cc = ((chunk_bbox[0] + chunk_bbox[2]) / 2, (chunk_bbox[1] + chunk_bbox[3]) / 2)
        d = float(np.sqrt((ic[0] - cc[0]) ** 2 + (ic[1] - cc[1]) ** 2))
        return max(0.0, 1.0 - d / MAX_CENTER_DISTANCE)
    inter = max(0, x2 - x1) * max(0, y2 - y1)
    union = (
        (img_bbox[2] - img_bbox[0]) * (img_bbox[3] - img_bbox[1])
        + (chunk_bbox[2] - chunk_bbox[0]) * (chunk_bbox[3] - chunk_bbox[1])
        - inter
    )
    if union == 0:
        return 0.0
    return inter / union
