"""Lexical alignment scoring (the port's copy of ``tpualign.weaksup.lexical``).

For a chunk, ``matching = #{term in vocabulary : term is a substring of
lower(chunk text)}`` and ``score = min(1, matching / max(0.1 * |vocab|,
1))``. The score depends on the chunk alone, so it is computed once per
chunk and broadcast across the images. Substring counting is host work
over strings: the native library's when it is available, else a Python
loop, as tpualign orders them. The two paths differ at the edges: the
native count skips an empty term (Python's ``"" in s`` holds) and ends a
text at its first NUL; each path gives tpualign's integers on the same
path.
"""

from __future__ import annotations

from typing import Sequence

import numpy as np

from tpualign_torch.native import lexical_counts

__all__ = ["lexical_match_counts", "lexical_scores"]


def lexical_match_counts(chunk_texts: Sequence[str], terms: Sequence[str]) -> np.ndarray:
    """(C,) int32: number of vocabulary terms substring-matching each chunk."""
    counts = lexical_counts(list(chunk_texts), list(terms))
    if counts is not None:
        return counts
    counts = np.zeros(len(chunk_texts), dtype=np.int32)
    for i, text in enumerate(chunk_texts):
        lower = text.lower()
        counts[i] = sum(1 for term in terms if term in lower)
    return counts


def lexical_scores(chunk_texts: Sequence[str], terms: Sequence[str]) -> np.ndarray:
    """(C,) float32 lexical alignment scores; zeros when the vocabulary is
    empty."""
    if not terms:
        return np.zeros(len(chunk_texts), dtype=np.float32)
    counts = lexical_match_counts(chunk_texts, terms).astype(np.float32)
    denom = max(len(terms) * 0.1, 1.0)
    return np.minimum(1.0, counts / denom).astype(np.float32)
