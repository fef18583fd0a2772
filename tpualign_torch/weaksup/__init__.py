"""Weak supervision in the port: the rerank of search results by weak
scores (``rerank``). Scoring alignments is a later slice."""

from tpualign_torch.weaksup.rerank import build_weak_lookup, rerank_with_weak_scores

__all__ = ["build_weak_lookup", "rerank_with_weak_scores"]
