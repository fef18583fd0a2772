"""Plain exact top-k search in float64: the benchmark's reference.

Scores are inner products of the float32 rows taken in float64; the k
winners of a query rank by value descending, then by index ascending.
"""

from __future__ import annotations

from typing import Tuple

import torch

__all__ = ["scores", "exact_topk"]


def scores(queries: torch.Tensor, corpus64: torch.Tensor) -> torch.Tensor:
    """(Q, N) float64 inner products; ``corpus64`` is the corpus in float64."""
    return queries.to(torch.float64) @ corpus64.t()


def exact_topk(s: torch.Tensor, k: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """The k best of each row of ``s`` by (value desc, index asc)."""
    # a margin of candidates, then an exact two-key order among them
    vals, idx = torch.topk(s, min(s.shape[1], k + 8), dim=1)
    order = torch.argsort(idx, dim=1, stable=True)
    vals, idx = vals.gather(1, order), idx.gather(1, order)
    order = torch.argsort(-vals, dim=1, stable=True)
    vals, idx = vals.gather(1, order), idx.gather(1, order)
    return vals[:, :k], idx[:, :k]
