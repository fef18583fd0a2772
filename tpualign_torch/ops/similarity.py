"""Masked top-k over a similarity matrix (the port's copy of
``tpualign.ops.similarity``'s constants and ``masked_topk``)."""

from __future__ import annotations

from typing import Tuple

import torch

__all__ = ["NEG_INF", "WILDCARD_KEY", "masked_topk"]

NEG_INF = -1e30  # large-finite: avoids NaN from (-inf) - (-inf) in compares

# Query-side wildcard key: matches every real (>= 0) corpus key, the
# unrestricted search. Real keys are >= 0; -1 is corpus padding and -2 query
# padding (see tpualign_torch.parallel.retrieval).
WILDCARD_KEY = -3


def masked_topk(sims: torch.Tensor, mask: torch.Tensor,
                k: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """Top-k per row of ``sims`` over the ``mask``ed candidates.

    Order is value descending, then index ascending: a stable descending
    sort (``torch.topk`` promises no order among ties). Rows with fewer
    than k candidates fill with NEG_INF values. Returns ``(values,
    indices)``, both ``(Q, min(k, N))``.
    """
    masked = torch.where(mask, sims, torch.full_like(sims, NEG_INF))
    vals, idx = torch.sort(masked, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]
