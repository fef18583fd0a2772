"""Similarity and masked top-k in plain PyTorch (the port's copy of
``tpualign.ops.similarity``): the constants, ``l2_normalize``,
``cosine_similarity_matrix``, ``masked_topk`` and the single-device
``topk_similarity_search``. They run on the tensors' device; the searches
of the index go through K2/K3 (``ops/sim_topk.py``)."""

from __future__ import annotations

from typing import Tuple

import torch

from tpualign_torch.ops.dense import matmul_f32acc

__all__ = ["NEG_INF", "WILDCARD_KEY", "l2_normalize", "cosine_similarity_matrix", "masked_topk",
           "topk_similarity_search"]

NEG_INF = -1e30  # large-finite: avoids NaN from (-inf) - (-inf) in compares

# Query-side wildcard key: matches every real (>= 0) corpus key, the
# unrestricted search. Real keys are >= 0; -1 is corpus padding and -2 query
# padding (see tpualign_torch.parallel.retrieval).
WILDCARD_KEY = -3


def l2_normalize(x: torch.Tensor, axis: int = -1, eps: float = 1e-12) -> torch.Tensor:
    """Unit-normalise along ``axis`` (the norm floored at ``eps``)."""
    norm = torch.linalg.vector_norm(x, dim=axis, keepdim=True)
    return x / torch.clamp(norm, min=eps)


def cosine_similarity_matrix(queries: torch.Tensor, corpus: torch.Tensor,
                             normalized: bool = True,
                             compute_dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """``(Q, D) x (N, D) -> (Q, N)``: products in ``compute_dtype``
    accumulated in fp32. With ``normalized=True`` (unit rows, as stored)
    this is the plain product."""
    if not normalized:
        queries = l2_normalize(queries)
        corpus = l2_normalize(corpus)
    return matmul_f32acc(queries.to(compute_dtype), corpus.to(compute_dtype).T)


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


def topk_similarity_search(queries: torch.Tensor, corpus: torch.Tensor, mask: torch.Tensor,
                           k: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """Similarity and masked top-k on one device, unfused."""
    return masked_topk(cosine_similarity_matrix(queries, corpus), mask, k)
