"""Weak supervision in the port: lexical-overlap and bbox-positional
alignment scoring over same-page (image, chunk) pairs (``lexical``,
``positional``, ``alignment``), the rerank of search results by weak
scores (``rerank``), and the isotonic calibration of weak scores onto the
towers' cosine (``calibration``)."""

from tpualign_torch.weaksup.alignment import (
    COMBINED_THRESHOLD, LEXICAL_THRESHOLD, POSITIONAL_THRESHOLD, compute_alignments)
from tpualign_torch.weaksup.calibration import apply_calibration, calibrate_schema, fit_isotonic
from tpualign_torch.weaksup.lexical import lexical_match_counts, lexical_scores
from tpualign_torch.weaksup.positional import positional_scores
from tpualign_torch.weaksup.rerank import build_weak_lookup, rerank_with_weak_scores

__all__ = ["COMBINED_THRESHOLD", "LEXICAL_THRESHOLD", "POSITIONAL_THRESHOLD",
           "apply_calibration", "build_weak_lookup", "calibrate_schema", "compute_alignments",
           "fit_isotonic", "lexical_match_counts", "lexical_scores", "positional_scores",
           "rerank_with_weak_scores"]
