"""Weak-supervision score calibration against the towers' similarities
(the port's copy of ``tpualign.weaksup.calibration``, host numpy).

The heuristic weak scores (lexical overlap, bbox IoU and distance) live on
an arbitrary [0, 1] scale. After the towers are (fine-)tuned, the cosine of
an aligned pair's embeddings is a better-grounded scale; calibrating the
weak scores onto it makes the ``--rerank ALPHA`` blend (weaksup/rerank.py)
a mixture of commensurable quantities.

Method: isotonic regression (pool-adjacent-violators) from weak score to
observed pair cosine: monotone by construction, so the weak ranking is
kept exactly and only the scale changes.
"""

from __future__ import annotations

from typing import Dict, Tuple

import numpy as np

from tpualign_torch.utils.logging import get_logger

log = get_logger("weaksup.calibration")

__all__ = ["fit_isotonic", "apply_calibration", "calibrate_schema"]


def fit_isotonic(
    x: np.ndarray, y: np.ndarray
) -> Tuple[np.ndarray, np.ndarray]:
    """Monotone non-decreasing fit of y on x (PAV), returned as the knot
    arrays ``(xs, ys)`` for ``np.interp``.

    Ties in x are pre-pooled (their y values averaged) so the fit is a
    function of x.
    """
    x = np.asarray(x, np.float64)
    y = np.asarray(y, np.float64)
    if len(x) == 0:
        return np.zeros(0), np.zeros(0)
    order = np.argsort(x, kind="stable")
    xs, ys = x[order], y[order]
    # pool exact ties in x
    ux, inv = np.unique(xs, return_inverse=True)
    sums = np.bincount(inv, weights=ys)
    cnts = np.bincount(inv).astype(np.float64)
    level = sums / cnts

    # pool adjacent violators (weighted)
    vals = list(level)
    wts = list(cnts)
    knots = list(range(len(vals)))
    i = 0
    while i < len(vals) - 1:
        if vals[i] > vals[i + 1] + 1e-15:
            merged = (vals[i] * wts[i] + vals[i + 1] * wts[i + 1]) / (
                wts[i] + wts[i + 1]
            )
            vals[i] = merged
            wts[i] += wts[i + 1]
            del vals[i + 1], wts[i + 1], knots[i + 1]
            if i > 0:
                i -= 1
        else:
            i += 1
    # each pooled block spans ux[knots[j]] .. ux[knots[j+1]-1]; expand back
    # to one (x, fitted) pair per unique x for exact interp behavior
    fit = np.empty(len(ux))
    for j, start in enumerate(knots):
        end = knots[j + 1] if j + 1 < len(knots) else len(ux)
        fit[start:end] = vals[j]
    return ux.astype(np.float64), fit


def apply_calibration(
    x: np.ndarray, knots: Tuple[np.ndarray, np.ndarray]
) -> np.ndarray:
    """Map raw weak scores through the fitted monotone curve."""
    xs, ys = knots
    if len(xs) == 0:
        return np.asarray(x, np.float32)
    return np.interp(np.asarray(x, np.float64), xs, ys).astype(np.float32)


def calibrate_schema(store, schema: str, write: bool = False) -> Dict:
    """Fit weak-score -> cosine calibration on one schema's alignments.

    Uses the stored embeddings (whatever tower produced them — frozen or
    fine-tuned). With ``write=True`` the alignment rows are upserted with
    calibrated scores (the triple-key upsert updates weak_score in place)
    and the schema is saved.

    Returns {"knots", "n_pairs", "raw_range", "calibrated_range"}; only
    "knots" and "n_pairs" when the schema holds no alignments.
    """
    alignments = store.alignments(schema)
    if not alignments:
        return {"knots": (np.zeros(0), np.zeros(0)), "n_pairs": 0}
    img_ids, img_emb = store.embedding_matrix(schema, "images")
    chunk_ids, chunk_emb = store.embedding_matrix(schema, "text_chunks")
    ipos = {k: i for i, k in enumerate(img_ids)}
    cpos = {k: i for i, k in enumerate(chunk_ids)}

    rows = [
        (image_id, chunk_id, float(score), a_type)
        for image_id, chunk_id, score, a_type in alignments
        if image_id in ipos and chunk_id in cpos
    ]
    ii = np.asarray([ipos[r[0]] for r in rows])
    cc = np.asarray([cpos[r[1]] for r in rows])
    sims = np.einsum("nd,nd->n", img_emb[ii], chunk_emb[cc]).astype(np.float64)
    raw = np.asarray([r[2] for r in rows])

    knots = fit_isotonic(raw, sims)
    calibrated = apply_calibration(raw, knots)

    if write:
        store.insert_alignments(
            schema,
            [
                (r[0], r[1], float(c), r[3])
                for r, c in zip(rows, calibrated)
            ],
        )
        store.save([schema])
        log.info(
            "wrote %d calibrated alignment scores to %s", len(rows), schema
        )

    # monotone map => ranking preserved exactly up to pooled plateaus
    return {
        "knots": knots,
        "n_pairs": len(rows),
        "raw_range": (float(raw.min()), float(raw.max())),
        "calibrated_range": (float(calibrated.min()), float(calibrated.max())),
    }
