"""Weak supervision in the port: lexical-overlap and bbox-positional
alignment scoring over same-page (image, chunk) pairs (``lexical``,
``positional``, ``alignment``), and the rerank of search results by weak
scores (``rerank``). Calibration is a later slice."""

from tpualign_torch.weaksup.alignment import (
    COMBINED_THRESHOLD, LEXICAL_THRESHOLD, POSITIONAL_THRESHOLD, compute_alignments)
from tpualign_torch.weaksup.lexical import lexical_match_counts, lexical_scores
from tpualign_torch.weaksup.positional import positional_scores
from tpualign_torch.weaksup.rerank import build_weak_lookup, rerank_with_weak_scores

__all__ = ["COMBINED_THRESHOLD", "LEXICAL_THRESHOLD", "POSITIONAL_THRESHOLD",
           "build_weak_lookup", "compute_alignments", "lexical_match_counts", "lexical_scores",
           "positional_scores", "rerank_with_weak_scores"]
