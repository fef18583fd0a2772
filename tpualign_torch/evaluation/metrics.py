"""Evaluation metrics over the embedding store (the port's
``tpualign.evaluation.metrics``).

The metric definitions are tpualign's:

- ground truth = every same-page (image, chunk) combination;
- Top-K accuracy: the fraction of pairs whose chunk is in the image's
  top-K among its same-manual+page candidates;
- MRR with a top-100 candidate window, 0 when absent;
- average cosine similarity over the true pairs;
- weak-supervision score lists grouped by alignment type.

Each image is queried once for its top-100 candidates through the port's
``RetrievalIndex`` (the keyed k=100 search, K2 on the card), and every
per-pair metric reads that table. Ties rank by ascending chunk index.
"""

from __future__ import annotations

import json
from collections import defaultdict
from pathlib import Path
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

import torch

from tpualign_torch.parallel.mesh import one_process, shard_devices
from tpualign_torch.parallel.retrieval import RetrievalIndex
from tpualign_torch.store import EmbeddingStore
from tpualign_torch.utils.device import resolve_device
from tpualign_torch.utils.logging import get_logger

log = get_logger("evaluation")

__all__ = ["Evaluator", "get_image_text_pairs"]

MRR_WINDOW = 100


def get_image_text_pairs(
    images: Sequence[dict], chunks: Sequence[dict]
) -> List[Tuple[str, str, str, int]]:
    """All (image_id, chunk_id, manual_id, page) same-page combinations."""
    by_key: Dict[Tuple, List[dict]] = defaultdict(list)
    for c in chunks:
        by_key[(c["manual_id"], c.get("page"))].append(c)
    pairs = []
    for img in images:
        for c in by_key.get((img["manual_id"], img.get("page")), ()):
            pairs.append((img["image_id"], c["chunk_id"], img["manual_id"], img.get("page")))
    return pairs


def _join_keys(i_man, i_pg, c_man, c_pg) -> Tuple[np.ndarray, np.ndarray]:
    """(manual, page) -> one int64 code per row, shared across images and
    chunks (equal code <=> equal manual AND page; None == None). O(N log N)
    host work over ROWS, never over pairs."""
    n_i = len(i_man)
    man = np.asarray(list(i_man) + list(c_man), dtype=object)
    _, minv = np.unique(man, return_inverse=True)
    pg = np.fromiter(
        ((-1 if p is None else int(p)) for p in list(i_pg) + list(c_pg)),
        np.int64, len(man),
    )
    _, pinv = np.unique(pg, return_inverse=True)
    keys = minv.astype(np.int64) * (int(pinv.max()) + 1 if len(pinv) else 1) \
        + pinv.astype(np.int64)
    return keys[:n_i], keys[n_i:]


def _cartesian_positions(ikeys: np.ndarray, ckeys: np.ndarray):
    """Vectorized same-key join: position arrays (ii, cc) enumerating every
    (image, chunk) combination with equal (manual, page) code — the
    cartesian ground truth — with zero per-pair Python. Pair order matches the nested-loop
    definition: images outer (ascending), chunks inner in insertion order
    (stable sort)."""
    order = np.argsort(ckeys, kind="stable")
    cks = ckeys[order]
    lo = np.searchsorted(cks, ikeys, "left")
    hi = np.searchsorted(cks, ikeys, "right")
    counts = hi - lo
    total = int(counts.sum())
    ii = np.repeat(np.arange(len(ikeys)), counts)
    starts = np.cumsum(counts) - counts
    within = np.arange(total) - np.repeat(starts, counts)
    cc = order[np.repeat(lo, counts) + within]
    return ii, cc


def _id_index(ids: Sequence[str]):
    """Sorted-array index for vectorized string-id -> position lookup."""
    arr = np.asarray(list(ids), dtype=object)
    order = np.argsort(arr, kind="stable")
    return arr[order], order


def _lookup_positions(sorted_vals: np.ndarray, order: np.ndarray,
                      queries: Sequence[str]) -> np.ndarray:
    """Positions of ``queries`` in the original id list (-1 = absent);
    one searchsorted over the whole query batch, no per-item dict gets."""
    q = np.asarray(queries, dtype=object)
    if len(sorted_vals) == 0 or len(q) == 0:
        return np.full(len(q), -1, np.int64)
    pos = np.searchsorted(sorted_vals, q)
    pos_c = np.minimum(pos, len(sorted_vals) - 1)
    valid = sorted_vals[pos_c] == q
    return np.where(valid, order[pos_c], -1).astype(np.int64)


class Evaluator:
    """Computes the full metric suite for each schema from the store.

    The search runs on ``device``: CUDA by default (raises when it is
    absent), ``"cpu"`` for the plain path; or sharded over ``mesh``'s data
    axis (``parallel/mesh.py``), whose first device then takes the place of
    ``device``. A mesh across processes raises ``NotImplementedError``, as
    tpualign's Evaluator fails there (ROADMAP settled difference 24)."""

    def __init__(self, store: EmbeddingStore, output_dir: str = "evaluation_results",
                 device: str | torch.device = "cuda", mesh=None):
        self.store = store
        self.mesh = mesh
        devices = shard_devices(mesh)
        one_process(mesh, "Evaluator(mesh=)")
        self.device = resolve_device(device) if devices is None else devices[0]
        self.output_dir = Path(output_dir)
        self._cache: Dict[str, dict] = {}

    # -- core: one retrieval pass per schema ------------------------------------

    def _schema_state(self, schema: str) -> dict:
        """Build (once) the per-schema retrieval state: embeddings, pairs,
        and each image's top-100 ranked candidate list."""
        if schema in self._cache:
            return self._cache[schema]

        images = self.store.images(schema)
        chunks = self.store.chunks(schema)
        img_ids, img_emb = self.store.embedding_matrix(schema, "images")
        chunk_ids, chunk_emb = self.store.embedding_matrix(schema, "text_chunks")

        index = RetrievalIndex(
            chunk_emb,
            [c["manual_id"] for c in chunks],
            [c.get("page") for c in chunks],
            mesh=self.mesh,
            device=self.device,
        )
        if len(images):
            vals, idx = index.search(
                img_emb,
                [i["manual_id"] for i in images],
                [i.get("page") for i in images],
                k=MRR_WINDOW,
            )
        else:
            vals = np.zeros((0, MRR_WINDOW), np.float32)
            idx = np.full((0, MRR_WINDOW), -1, np.int64)

        # Vectorized id/metadata indexes: everything downstream works on
        # int position arrays — zero per-pair Python at corpus scale.
        # NOTE the embedding-matrix row order may
        # differ from the metadata row order, so the cartesian join runs
        # on metadata rows and then maps ids -> matrix positions.
        img_sorted, img_order = _id_index(img_ids)
        chunk_sorted, chunk_order = _id_index(chunk_ids)
        ikeys, ckeys = _join_keys(
            [i["manual_id"] for i in images], [i.get("page") for i in images],
            [c["manual_id"] for c in chunks], [c.get("page") for c in chunks],
        )
        meta_ii, meta_cc = _cartesian_positions(ikeys, ckeys)
        img_id_by_meta = np.asarray(
            [i["image_id"] for i in images], dtype=object
        )
        chunk_id_by_meta = np.asarray(
            [c["chunk_id"] for c in chunks], dtype=object
        )
        cart_ii = _lookup_positions(
            img_sorted, img_order, img_id_by_meta[meta_ii]
        ) if len(meta_ii) else np.zeros(0, np.int64)
        cart_cc = _lookup_positions(
            chunk_sorted, chunk_order, chunk_id_by_meta[meta_cc]
        ) if len(meta_cc) else np.zeros(0, np.int64)

        state = {
            "images": images,
            "chunks": chunks,
            "img_emb": img_emb,
            "chunk_emb": chunk_emb,
            "img_index": (img_sorted, img_order),
            "chunk_index": (chunk_sorted, chunk_order),
            "cart_ii": cart_ii,   # matrix-row positions per cartesian pair
            "cart_cc": cart_cc,
            "topk_idx": idx,  # (n_images, MRR_WINDOW) global chunk indices
            "rank_cache": {},
        }
        self._cache[schema] = state
        return state

    def _gt_positions(self, schema: str, gt: str):
        """(img_positions, chunk_positions) int arrays for the GT mode;
        -1 marks ids absent from the embedding matrices."""
        st = self._schema_state(schema)
        if gt == "cartesian":
            return st["cart_ii"], st["cart_cc"]
        if gt == "alignments":
            aligns = self.store.alignments(schema)
            if not aligns:
                return np.zeros(0, np.int64), np.zeros(0, np.int64)
            r = _lookup_positions(*st["img_index"], [a[0] for a in aligns])
            c = _lookup_positions(*st["chunk_index"], [a[1] for a in aligns])
            return r, c
        raise ValueError(f"unknown ground-truth mode {gt!r}")

    def _pair_ranks(self, schema: str, gt: str) -> np.ndarray:
        """1-based rank of each GT pair's chunk in its image's candidate
        list (0 = absent), fully vectorized: one (P, MRR_WINDOW) equality
        scan over precomputed position arrays — the host-side hot path at
        corpus scale (100k+ pairs)."""
        st = self._schema_state(schema)
        if gt in st["rank_cache"]:
            return st["rank_cache"][gt]
        r_arr, c_arr = self._gt_positions(schema, gt)
        ranks = np.zeros(len(r_arr), np.int64)
        valid = (r_arr >= 0) & (c_arr >= 0)
        if valid.any():
            rows = st["topk_idx"][r_arr[valid]]  # (V, W)
            hit = rows == c_arr[valid][:, None]
            found = hit.any(axis=1)
            pos = hit.argmax(axis=1) + 1
            ranks[valid] = np.where(found, pos, 0)
        st["rank_cache"][gt] = ranks
        return ranks

    # -- metrics -------------------------------------------------------------------
    #
    # Ground-truth modes:
    #
    # - "cartesian" (the default): true pairs = ALL same-page (image,
    #   chunk) combinations. NOTE this definition is
    #   degenerate with respect to model quality: because retrieval
    #   candidates are restricted to the same page AND every same-page chunk
    #   counts as true, Top-K accuracy is exactly min(k, C)/C for a page
    #   with C chunks and MRR is H(C)/C — both depend only on corpus shape,
    #   never on the embeddings. Reproduced faithfully for parity.
    # - "alignments": true pairs = the schema's weak-supervision alignment
    #   table. Ranking a specific aligned chunk among its same-page
    #   distractors DOES move with embedding quality — this is the mode that
    #   can show a fine-tuned tower beating the frozen one.

    def compute_top_k_accuracy(
        self, schema: str, k_values: Sequence[int] = (1, 5, 10),
        gt: str = "cartesian",
    ) -> Dict[int, float]:
        ranks = self._pair_ranks(schema, gt)
        if len(ranks) == 0:
            return {k: 0.0 for k in k_values}
        found = ranks > 0
        return {
            k: float(np.mean(found & (ranks <= k))) for k in k_values
        }

    def compute_mrr(self, schema: str, gt: str = "cartesian") -> float:
        ranks = self._pair_ranks(schema, gt)
        if len(ranks) == 0:
            return 0.0
        rr = np.where(ranks > 0, 1.0 / np.maximum(ranks, 1), 0.0)
        return float(np.mean(rr))

    def compute_average_similarity(self, schema: str) -> float:
        sims = self.pair_similarities(schema)
        if not len(sims):
            return 0.0
        return float(np.mean(sims))

    def pair_similarities(
        self, schema: str, limit: Optional[int] = None
    ) -> np.ndarray:
        """Cosine similarity per true pair (one fused gather + row dot over
        the precomputed position arrays — no per-pair Python)."""
        st = self._schema_state(schema)
        ii, cc = st["cart_ii"], st["cart_cc"]
        if limit:
            ii, cc = ii[:limit], cc[:limit]
        if not len(ii):
            return np.zeros(0, np.float32)
        ok = (ii >= 0) & (cc >= 0)
        sims = np.zeros(len(ii), np.float32)
        sims[ok] = np.einsum(
            "nd,nd->n", st["img_emb"][ii[ok]], st["chunk_emb"][cc[ok]]
        ).astype(np.float32)
        return sims

    def get_weak_supervision_scores(self, schema: str) -> Dict[str, List[float]]:
        scores: Dict[str, List[float]] = defaultdict(list)
        for _, _, score, a_type in self.store.alignments(schema):
            scores[a_type].append(float(score))
        return dict(scores)

    def num_pairs(self, schema: str) -> int:
        return len(self._schema_state(schema)["cart_ii"])

    # -- report ------------------------------------------------------------------

    def evaluate_schema(self, schema: str) -> dict:
        top_k = self.compute_top_k_accuracy(schema, (1, 5, 10))
        return {
            "top_k": top_k,
            "mrr": self.compute_mrr(schema),
            "avg_similarity": self.compute_average_similarity(schema),
            "num_pairs": self.num_pairs(schema),
        }

    def print_metrics_report(
        self, schemas: Sequence[str]
    ) -> Dict[str, dict]:
        """Per-schema report + metrics.json, in tpualign's layout."""
        all_metrics: Dict[str, dict] = {}
        print("\n" + "=" * 80)
        print("MULTIMODAL ALIGNMENT EVALUATION REPORT")
        print("=" * 80 + "\n")
        for schema in schemas:
            print(f"\nSchema: {schema.upper().replace('_', ' ')}")
            print("-" * 80)
            if not self.store.schema_exists(schema):
                print("  Schema not found in store")
                continue
            try:
                m = self.evaluate_schema(schema)
            except Exception as e:
                print(f"  Error evaluating schema: {e}")
                continue
            print(f"  Total Image-Text Pairs: {m['num_pairs']}")
            print(f"  Average Similarity: {m['avg_similarity']:.4f}")
            print(f"  Mean Reciprocal Rank (MRR): {m['mrr']:.4f}")
            for k in (1, 5, 10):
                v = m["top_k"][k]
                print(f"  Top-{k} Accuracy: {v:.4f} ({v * 100:.2f}%)")
            if schema in ("clip_lexical", "clip_positional", "clip_combined"):
                ws = self.get_weak_supervision_scores(schema)
                if ws:
                    print("  Weak Supervision Alignments:")
                    for a_type, scores in ws.items():
                        print(
                            f"    - {a_type}: {len(scores)} pairs, "
                            f"avg score: {np.mean(scores):.4f}"
                        )
            all_metrics[schema] = m

        self.output_dir.mkdir(parents=True, exist_ok=True)
        metrics_file = self.output_dir / "metrics.json"
        with open(metrics_file, "w") as f:
            json.dump(all_metrics, f, indent=2)
        print(f"\nMetrics saved to {metrics_file}")
        return all_metrics
