"""Exact same-page similarity search on one device (the port's
``tpualign.parallel.retrieval``, fp32 subset).

The corpus and its (manual, page) keys move to the device once, at
construction; each search moves only the query block there and the
``(Q, k)`` winners back. Ties rank by ascending corpus index, exactly:
searches with ``k <= 128`` go through the fused kernel K2
(``tpualign_torch.ops.sim_topk``), whose comparator is (value desc, index
asc); larger ``k`` takes the dense route, a matmul, the key mask and a
stable descending sort, in query slabs that bound the score matrix.
Both give the same results. Quantized precisions, ``recall_target``,
``refine``, mesh strategies and add/remove/compact are later slices.
"""

from __future__ import annotations

from typing import Dict, Optional, Sequence, Tuple

import numpy as np
import torch

from tpualign_torch.ops.sim_topk import MAX_K, masked_sim_topk, masked_sim_topk_reference
from tpualign_torch.ops.similarity import NEG_INF, WILDCARD_KEY
from tpualign_torch.utils.device import resolve_device

__all__ = ["RetrievalIndex", "encode_keys", "PAGE_MOD", "NONE_PAGE", "WILDCARD_KEY"]

# (manual, page) packing: key = manual_code * PAGE_MOD + page_code. Real
# pages sit in [0, NONE_PAGE); page None encodes as NONE_PAGE, so None
# matches only None. Negative keys are reserved: -1 corpus padding, -2
# query padding (match nothing), -3 the query-side wildcard.
PAGE_MOD = 100_000
NONE_PAGE = PAGE_MOD - 1

# bytes of the (Q, N) score matrix and its sort that one dense slab may take
DENSE_SLAB_BYTES = 2 * 1024**3


def encode_keys(
    manual_ids: Sequence[str], pages: Sequence[Optional[int]],
    vocab: Optional[Dict[str, int]] = None,
) -> Tuple[np.ndarray, Dict[str, int]]:
    """Encode (manual_id, page) into one non-negative int32 key per row.

    ``vocab`` maps manual ids to small ints; pass the same vocab for images
    and chunks so keys compare equal exactly when manual AND page match.
    Raises ``ValueError`` for pages outside [0, 99_999) or when the packed
    key space overflows int32.
    """
    if vocab is None:
        vocab = {}
    if len(manual_ids) == 0:
        return np.empty(0, np.int32), vocab

    uniq, inverse = np.unique(np.asarray(manual_ids, dtype=object), return_inverse=True)
    for m in uniq:
        if m not in vocab:
            vocab[m] = len(vocab)
    codes = np.asarray([vocab[m] for m in uniq], np.int64)
    mcodes = codes[inverse]

    pg = np.asarray([NONE_PAGE if p is None else int(p) for p in pages], np.int64)
    real = pg != NONE_PAGE
    bad = real & ((pg < 0) | (pg >= NONE_PAGE))
    if np.any(bad):
        raise ValueError(
            f"page {pg[bad][0]} outside the encodable range [0, {NONE_PAGE}); "
            f"re-map page numbers before indexing")
    keys = mcodes * PAGE_MOD + pg
    if keys.size and keys.max() > np.iinfo(np.int32).max:
        raise ValueError(
            f"(manual, page) key space overflow: {len(vocab)} manuals x "
            f"{PAGE_MOD} pages exceeds int32; shard the corpus by manual group")
    return keys.astype(np.int32), vocab


def _pad_results(vals: np.ndarray, idx: np.ndarray, k: int):
    if vals.shape[1] < k:
        pad = k - vals.shape[1]
        vals = np.pad(vals, ((0, 0), (0, pad)), constant_values=NEG_INF)
        idx = np.pad(idx, ((0, 0), (0, pad)), constant_values=-1)
    return vals, idx


def _sentinel(vals: np.ndarray, idx: np.ndarray):
    """Mark no-candidate slots as (NEG_INF, -1)."""
    bad = vals <= NEG_INF / 2
    return vals, np.where(bad, -1, idx).astype(np.int64)


class RetrievalIndex:
    """Device-resident exact index over a chunk corpus.

    ``search(query_embs, query_manuals, query_pages, k)`` ranks, for each
    query, the corpus rows of the same manual and page (or every row, with
    ``global_search``). ``device`` defaults to CUDA and raises when it is
    absent; pass ``device="cpu"`` for the plain path.
    """

    def __init__(
        self,
        corpus_embeddings: np.ndarray,
        corpus_manuals: Sequence[str],
        corpus_pages: Sequence[Optional[int]],
        mesh=None,
        precision: str = "fp32",
        recall_target: Optional[float] = None,
        refine: int = 0,
        refine_store: Optional[str] = None,
        device: str | torch.device = "cuda",
    ):
        if precision not in ("fp32", "int8", "int4", "int2"):
            raise ValueError(f"precision must be fp32, int8, int4 or int2, got {precision!r}")
        deferred = {
            "mesh": mesh is not None,
            f"precision={precision!r}": precision != "fp32",
            "recall_target": recall_target is not None,
            "refine": refine > 1,
            "refine_store": refine_store is not None,
        }
        asked = [name for name, on in deferred.items() if on]
        if asked:
            raise NotImplementedError(
                f"RetrievalIndex in tpualign_torch is exact fp32 on one device; "
                f"not yet ported: {', '.join(asked)}")
        self.device = resolve_device(device)
        corpus = np.asarray(corpus_embeddings, np.float32)
        self.vocab: Dict[str, int] = {}
        keys, self.vocab = encode_keys(corpus_manuals, corpus_pages, self.vocab)
        self.n = len(corpus)
        if self.n == 0:
            self._corpus = self._keys = None
            return
        self._corpus = torch.from_numpy(np.ascontiguousarray(corpus)).to(self.device)
        self._keys = torch.from_numpy(keys).to(self.device)

    def search(
        self,
        query_embeddings: np.ndarray,
        query_manuals: Optional[Sequence[str]] = None,
        query_pages: Optional[Sequence[Optional[int]]] = None,
        k: int = 10,
        strategy: str = "auto",
        global_search: bool = False,
    ) -> Tuple[np.ndarray, np.ndarray]:
        """Top-k per query as host arrays: values ``(Q, k)`` fp32 and global
        corpus indices ``(Q, k)`` int64, with ``(NEG_INF, -1)`` in slots
        without a candidate. ``global_search=True`` (or no manuals) lifts
        the same-manual+page restriction."""
        queries = np.asarray(query_embeddings, np.float32)
        if global_search or query_manuals is None:
            qk = np.full(len(queries), WILDCARD_KEY, np.int32)
        else:
            # encode against a copy of the vocab: unknown query manuals get
            # codes beyond the corpus range (match nothing) and the index's
            # vocab is never mutated
            qk, _ = encode_keys(query_manuals, query_pages, dict(self.vocab))
        return self._search_encoded_raw(queries, qk, k, strategy)

    def search_encoded(self, queries: np.ndarray, qk: np.ndarray, k: int,
                       strategy: str = "auto") -> Tuple[np.ndarray, np.ndarray]:
        """Host-array search with pre-encoded int32 keys (see
        :func:`encode_keys`; WILDCARD_KEY = unrestricted)."""
        return self._search_encoded_raw(queries, qk, k, strategy)

    def search_device(self, query_embeddings: torch.Tensor, query_keys: torch.Tensor,
                      k: int, strategy: str = "auto") -> Tuple[torch.Tensor, torch.Tensor]:
        """Device-resident search: takes and returns tensors on the index's
        device. Returns ``(vals (Q, min(k, n)) fp32, idx int32)``, where
        slots without a candidate hold ``(NEG_INF, SENTINEL_IDX)``."""
        self._check_strategy(strategy)
        kk = min(k, self.n)
        q = query_embeddings.to(self.device, torch.float32).contiguous()
        qk = query_keys.to(self.device, torch.int32).contiguous()
        if kk <= MAX_K:
            return masked_sim_topk(q, qk, self._corpus, self._keys, kk)
        # dense route, in query slabs that bound the (Q, N) matrix and its sort
        slab = max(1, DENSE_SLAB_BYTES // (16 * self.n))
        parts = [masked_sim_topk_reference(q[s:s + slab], qk[s:s + slab],
                                           self._corpus, self._keys, kk)
                 for s in range(0, len(q), slab)]
        return torch.cat([p[0] for p in parts]), torch.cat([p[1] for p in parts])

    @staticmethod
    def _check_strategy(strategy: str) -> None:
        if strategy in ("ring", "streaming"):
            raise NotImplementedError(f"strategy={strategy!r} needs a mesh; not yet ported")
        if strategy not in ("auto", "gather"):
            raise ValueError(f"strategy must be auto/gather/ring/streaming, got {strategy!r}")

    def _search_encoded_raw(self, queries: np.ndarray, qk: np.ndarray, k: int,
                            strategy: str = "auto") -> Tuple[np.ndarray, np.ndarray]:
        nq = len(queries)
        if nq == 0 or self.n == 0:
            return (np.full((nq, k), NEG_INF, np.float32),
                    np.full((nq, k), -1, np.int64))
        vals, idx = self.search_device(
            torch.from_numpy(np.ascontiguousarray(queries, np.float32)),
            torch.from_numpy(np.ascontiguousarray(qk, np.int32)), k, strategy)
        vals = vals.cpu().numpy()
        idx = idx.cpu().numpy().astype(np.int64)
        idx = np.where(idx >= self.n, -1, idx)
        vals, idx = _pad_results(vals, idx, k)
        return _sentinel(vals, idx)
