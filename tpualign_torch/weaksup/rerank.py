"""Weak-supervision score fusion into retrieval reranking (the port's copy
of ``tpualign.weaksup.rerank``).

The reference stores weak-supervision scores in the alignments tables but
its retrieval/evaluation ranks by cosine similarity alone
(ref:src/evaluate_alignments.py:126-135 — the alignments table is only ever
histogrammed). This module closes that loop (the BASELINE north star's
"weak scores fuse into retrieval reranking"): candidates from a top-k search
are re-scored as

    combined = (1 - alpha) * cosine + alpha * weak_score

where weak_score comes from the schema's alignment rows (0 for pairs with no
row — below the weak thresholds) and alpha in [0, 1] controls the blend.
alpha=0 reproduces the pure-cosine reference ranking exactly.

Evaluation metrics stay pure-cosine for reference parity; reranking is an
opt-in at query time (``python -m tpualign_torch query --rerank ALPHA``,
the ``rerank`` field of ``POST /search_image``) and via this API.
"""

from __future__ import annotations

from typing import Dict, Iterable, Sequence, Tuple

import numpy as np

from tpualign_torch.ops.similarity import NEG_INF

__all__ = ["build_weak_lookup", "rerank_with_weak_scores"]


def build_weak_lookup(
    alignments: Iterable[Tuple[str, str, float, str]]
) -> Dict[Tuple[str, str], float]:
    """(image_id, chunk_id) -> weak_score. When a pair carries several
    alignment rows (lexical + positional in single-strategy schemas), the
    max survives — the strongest evidence."""
    lookup: Dict[Tuple[str, str], float] = {}
    for image_id, chunk_id, score, _ in alignments:
        key = (image_id, chunk_id)
        prev = lookup.get(key)
        if prev is None or score > prev:
            lookup[key] = float(score)
    return lookup


def rerank_with_weak_scores(
    vals: np.ndarray,
    idx: np.ndarray,
    query_ids: Sequence[str],
    corpus_ids: Sequence[str],
    weak_lookup: Dict[Tuple[str, str], float],
    alpha: float = 0.5,
) -> Tuple[np.ndarray, np.ndarray]:
    """Re-sort (Q, k) search results by the blended score.

    Args:
      vals/idx: output of a top-k search (cosine values, corpus indices;
        -1 = empty slot).
      query_ids: id per query row (image ids).
      corpus_ids: id per corpus position (chunk ids).
      weak_lookup: from :func:`build_weak_lookup`.
      alpha: weak-score weight; 0 = unchanged cosine ranking.

    Returns (combined_vals, idx) re-sorted per row, empty slots kept last.
    Ties break by ascending corpus index (matching the search tie-break).
    """
    if not 0.0 <= alpha <= 1.0:
        raise ValueError(f"alpha must be in [0, 1], got {alpha}")
    vals = np.asarray(vals, np.float32)
    idx = np.asarray(idx)
    q, k = vals.shape
    combined = np.full_like(vals, NEG_INF)
    for r in range(q):
        for j in range(k):
            c = idx[r, j]
            if c < 0:
                continue
            weak = weak_lookup.get((query_ids[r], corpus_ids[c]), 0.0)
            combined[r, j] = (1.0 - alpha) * vals[r, j] + alpha * weak
    # per-row stable re-sort: descending combined, ascending corpus index
    out_vals = np.full_like(vals, NEG_INF)
    out_idx = np.full_like(idx, -1)
    for r in range(q):
        order = np.lexsort((np.where(idx[r] < 0, 2**31 - 1, idx[r]), -combined[r]))
        out_vals[r] = combined[r][order]
        out_idx[r] = idx[r][order]
    return out_vals, out_idx
