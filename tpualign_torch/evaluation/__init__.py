"""Retrieval evaluation in the port: Top-K accuracy, MRR, mean similarity
(``metrics``, written to ``metrics.json``) and the three charts (``plots``).

The plot functions import matplotlib, and so are imported lazily: the
metrics path works without it.
"""

from tpualign_torch.evaluation.metrics import Evaluator, get_image_text_pairs

_PLOT_NAMES = (
    "plot_similarity_distributions",
    "plot_top_k_comparison",
    "plot_weak_supervision_scores",
)

__all__ = ["Evaluator", "get_image_text_pairs", *_PLOT_NAMES]


def __getattr__(name):
    if name in _PLOT_NAMES:
        from tpualign_torch.evaluation import plots

        return getattr(plots, name)
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
