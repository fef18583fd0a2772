"""IVF (inverted-file) approximate index on one device (the port's
``tpualign.parallel.ivf``).

The pgvector IVFFlat equivalent: spherical k-means partitions the corpus
into ``n_lists`` clusters and a query scans the rows of the ``n_probes``
clusters whose centroids score highest, under the same (manual, page) key
mask as the exact index.

- **Build**: k-means on the device, deterministic: a strided init over real
  rows, then Lloyd steps whose centroid sums are one-hot matrix products
  (no atomics, so the same corpus gives the same centroids on every run;
  fp32 products, TF32 off as PyTorch's default leaves it). Clusters are
  packed into one flat layout of ``(n_lists + 1 + spill_blocks) * C`` rows:
  blocks ``0..L-1`` the clusters padded to capacity ``C``, block ``L`` an
  all-masked padding block, blocks ``L+1..`` the spill tail (rows beyond a
  cluster's capacity, which every query scans). Geometry, layout and
  artifact are tpualign's, so an artifact either package writes loads in
  the other.
- **Search**: the probe top-P of ``q @ centroids.T`` (in float64, so that a
  query's probes do not depend on its batch), the sorted union of
  the batch's probed blocks plus the spill blocks, and one K4 sweep
  (:func:`tpualign_torch.ops.ivf_topk.ivf_probe_topk`) for ``k <= 64``;
  full-probe searches (``n_probes == n_lists``, two-key tie-break equal to
  the dense oracle) and larger ``k`` take tpualign's union route
  (:func:`_ivf_union_search`), in plain torch.
- **Precisions**: fp32; int8 (s8 products against quantized queries, or
  dequantized with ``int8_mxu=False``); packed int4 and int2. A build takes
  fp32 rows, or pre-quantized int8/packed rows with their scales. ``refine``
  rescores over-fetched candidates exactly on the host, as
  :class:`~tpualign_torch.parallel.retrieval.RetrievalIndex` does.

Meshes and ``add``/``remove``/``compact`` are later slices of the port.
"""

from __future__ import annotations

import hashlib
import json
from typing import Dict, Optional, Sequence, Tuple

import numpy as np
import torch

from tpualign_torch.ops.ivf_topk import _membership, ivf_probe_topk
from tpualign_torch.ops.sim_topk import SENTINEL_IDX, _unpack_codes, key_mask
from tpualign_torch.ops.similarity import NEG_INF, WILDCARD_KEY
from tpualign_torch.parallel.retrieval import (
    _QUANTIZERS, _pad_results, _refine_rescore, _sentinel, _setup_refine, _tensor, encode_keys)
from tpualign_torch.utils.device import resolve_device
from tpualign_torch.utils.logging import get_logger

log = get_logger("parallel.ivf")

__all__ = ["IVFIndex"]

KMEANS_BLOCK = 1 << 14  # corpus rows per k-means step


def _corpus_fingerprint(rows, dtype=None) -> Tuple[str, str]:
    """tpualign's artifact check: sha256 over the shape (int64) and a
    strided sample of at most ~64 rows, in ``dtype`` (the build's), with
    that dtype's name. Only the sample is read and cast."""
    dtype = np.dtype(dtype or rows.dtype)
    h = hashlib.sha256()
    shape = tuple(int(s) for s in rows.shape)
    h.update(np.asarray(shape, np.int64).tobytes())
    if shape[0]:
        step = max(1, shape[0] // 64)
        h.update(np.ascontiguousarray(np.asarray(rows[::step], dtype)).tobytes())
    return h.hexdigest(), str(dtype)


def _round_up(x: int, m: int) -> int:
    return -(-x // m) * m


def _max_capacity(dim: int, itemsize: int, budget: int = 12 * 2**20,
                  int8_mxu: bool = False) -> int:
    """tpualign's capacity clamp, kept verbatim because the geometry and the
    artifact depend on it: the largest multiple of 128 rows whose TPU kernel
    block fit ~12 MB of the TPU's scoped vector memory (fp32 8 B/dim, int8
    dequant 6, int8 s8 2 + 512 per row, packed 4 + 512). K4 on the card has
    no such limit; the rule stays until K4 is redesigned."""
    if itemsize == 0:
        per_row = dim * 4 + 512
    elif int8_mxu and itemsize == 1:
        per_row = dim * 2 + 512
    else:
        per_row = dim * (8 if itemsize == 4 else 6)
    return max(128, (budget // per_row // 128) * 128)


def _packed_variant(cols: int, dim: int) -> str:
    if cols * 2 == dim:
        return "int4"
    if cols * 4 == dim:
        return "int2"
    raise ValueError(f"packed rows of {cols} bytes do not match dim {dim}")


def _dequant(emb: torch.Tensor, scales: Optional[torch.Tensor], dim: int) -> torch.Tensor:
    """fp32 rows of an fp32, int8 or packed int4/int2 layout slice."""
    if emb.dtype == torch.uint8:
        return _unpack_codes(emb, _packed_variant(emb.shape[1], dim)).to(torch.float32) \
            * scales[:, None]
    if scales is None:
        return emb
    return emb.to(torch.float32) * scales[:, None]


def _kmeans(corpus: torch.Tensor, scales: Optional[torch.Tensor], centroids: torch.Tensor,
            iters: int, dim: int, block: int = KMEANS_BLOCK):
    """Spherical k-means (tpualign's ``_kmeans``). ``corpus`` is (N, cols)
    fp32, or int8 / packed uint8 with ``scales`` (dequantized a block at a
    time). All-zero rows are not real rows: they take no cluster (assignment
    ``L``) and add nothing. Empty clusters keep their centroid. Returns
    ``(centroids (L, D), assignment (N,) int64, sizes (L,))``."""
    n = corpus.shape[0]
    n_lists = centroids.shape[0]
    lists = torch.arange(n_lists, device=corpus.device)

    def rows(s: int) -> torch.Tensor:
        return _dequant(corpus[s:s + block], None if scales is None else scales[s:s + block], dim)

    def assign(cent: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
        a = torch.argmax(x @ cent.T, dim=1)  # the first maximum, as jnp.argmax
        return torch.where((x * x).sum(dim=1) > 0.0, a, n_lists)

    for _ in range(iters):
        sums = torch.zeros((n_lists, dim), dtype=torch.float32, device=corpus.device)
        counts = torch.zeros((n_lists,), dtype=torch.float32, device=corpus.device)
        for s in range(0, n, block):
            x = rows(s)
            onehot = (assign(centroids, x)[:, None] == lists[None, :]).to(torch.float32)
            sums += onehot.T @ x
            counts += onehot.sum(dim=0)
        new = sums / torch.clamp_min(counts[:, None], 1.0)
        new = new / torch.clamp_min(torch.linalg.norm(new, dim=1, keepdim=True), 1e-12)
        centroids = torch.where(counts[:, None] > 0.0, new, centroids)
    assignment = torch.cat([assign(centroids, rows(s)) for s in range(0, n, block)])
    sizes = torch.bincount(assignment, minlength=n_lists + 1)[:n_lists]
    return centroids, assignment, sizes


def _pack(keys: torch.Tensor, assign: torch.Tensor, n_lists: int, capacity: int,
          spill_blocks: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """The flat block layout (tpualign's ``_pack``): rows sorted by cluster,
    stably, so a cluster keeps ascending corpus order; the first
    ``capacity`` rows of cluster c fill block c, the rest fill the spill
    blocks after the padding block ``L``, in sorted order. Rows without a
    cluster (assignment ``L``) are left out. Returns ``(ids, keys)`` of the
    layout, -1 in unused slots."""
    n = assign.shape[0]
    dev = assign.device
    order = torch.argsort(assign, stable=True)
    sa = assign[order]
    starts = torch.searchsorted(sa, torch.arange(n_lists, device=dev))
    rank = torch.arange(n, device=dev) - starts[sa.clamp(max=n_lists - 1)]
    in_main = (rank < capacity) & (sa < n_lists)
    spill_rank = torch.cumsum((~in_main).to(torch.int64), dim=0) - 1
    total = (n_lists + 1 + spill_blocks) * capacity
    dest = torch.where(in_main, sa.clamp(max=n_lists - 1) * capacity + rank,
                       (n_lists + 1) * capacity + spill_rank)
    keep = (sa < n_lists) & (dest < total)
    ids = torch.full((total,), -1, dtype=torch.int32, device=dev)
    pkeys = torch.full((total,), -1, dtype=torch.int32, device=dev)
    ids[dest[keep]] = order[keep].to(torch.int32)
    pkeys[dest[keep]] = keys[order[keep]]
    return ids, pkeys


def _probe(q: torch.Tensor, qk: torch.Tensor, centroids: torch.Tensor, n_probes: int,
           n_lists: int) -> torch.Tensor:
    """(B, P) int32 probes: each query's top-P centroids by score, ties by
    ascending list id (``lax.top_k``'s order); padding queries (key -2)
    probe ``n_lists``, which no union takes. The scores are float64
    products: an fp32 cuBLAS product of a row may round differently with
    the batch's size, and a query's probes must not depend on the requests
    the coalescer batched it with."""
    scores = q.to(torch.float64) @ centroids.to(torch.float64).T
    order = torch.sort(scores, dim=1, descending=True, stable=True).indices
    probe = order[:, :n_probes].to(torch.int32)
    return torch.where(qk[:, None] == -2, torch.full_like(probe, n_lists), probe)


def _union(probe: torch.Tensor, n_lists: int, spill_blocks: int) -> torch.Tensor:
    """The sorted, deduplicated probed blocks, then the spill blocks."""
    real = torch.unique(probe[probe != n_lists])
    spill = n_lists + 1 + torch.arange(spill_blocks, device=probe.device)
    return torch.cat([real.to(torch.int32), spill.to(torch.int32)])


def _two_key_topk(vals: torch.Tensor, idx: torch.Tensor, k: int):
    """Top-k by (value desc, index asc): two stable sorts."""
    o1 = torch.sort(idx, dim=1, stable=True).indices
    v1, i1 = torch.gather(vals, 1, o1), torch.gather(idx, 1, o1)
    o2 = torch.sort(v1, dim=1, descending=True, stable=True).indices[:, :k]
    return torch.gather(v1, 1, o2), torch.gather(i1, 1, o2)


def _ivf_union_search(q, qk, centroids, pemb, pkeys, pids, pscales, k: int, n_probes: int,
                      n_lists: int, capacity: int, spill_blocks: int, chunk: int,
                      exact_ties: bool):
    """tpualign's union route: scans the probed blocks and the spill blocks
    ``chunk`` blocks at a time, one dense fp32 product of the dequantized
    rows per chunk, the key mask and the probe membership, and a running
    top-k merged by (value desc, corpus id asc). With ``exact_ties`` every
    stage takes the two-key order, so a full-probe search equals the dense
    oracle, ties included; otherwise a chunk's candidates rank in packed
    order among ties. Returns device ``(vals (B, k), corpus ids (B, k))``,
    -1 in empty slots."""
    b = q.shape[0]
    dev = q.device
    probe = _probe(q, qk, centroids, n_probes, n_lists)
    uids = _union(probe, n_lists, spill_blocks).to(torch.int64)
    members = _membership(probe, uids, n_lists)  # (B, U)
    offsets = torch.arange(capacity, device=dev)
    best_v = torch.full((b, k), NEG_INF, dtype=torch.float32, device=dev)
    best_i = torch.full((b, k), -1, dtype=torch.int64, device=dev)
    for s in range(0, len(uids), chunk):
        cid = uids[s:s + chunk]
        member = members[:, s:s + chunk]
        rows = (cid[:, None] * capacity + offsets[None, :]).reshape(-1)
        emb = _dequant(pemb[rows], None if pscales is None else pscales[rows], q.shape[1])
        ids = pids[rows].to(torch.int64)
        sims = q @ emb.T
        mask = key_mask(qk, pkeys[rows]) & member.repeat_interleave(capacity, dim=1)
        sims = torch.where(mask, sims, torch.full_like(sims, NEG_INF))
        ids = ids[None, :].expand(b, -1)
        if exact_ties:
            cv, ci = _two_key_topk(sims, ids, k)
        else:
            cv, pos = torch.sort(sims, dim=1, descending=True, stable=True)
            cv, ci = cv[:, :k], torch.gather(ids, 1, pos[:, :k])
        best_v, best_i = _two_key_topk(torch.cat([best_v, cv], dim=1),
                                       torch.cat([best_i, ci], dim=1), k)
    return best_v, torch.where(best_v <= NEG_INF / 2, torch.full_like(best_i, -1), best_i)


def _ivf_kernel_search(q, qk, centroids, pemb, pkeys, pids, pscales, k: int, n_probes: int,
                       n_lists: int, capacity: int, spill_blocks: int, int8_mxu: bool = True):
    """The K4 route (tpualign's ``_ivf_kernel_search``): probes, the union
    (sorted probed blocks, then the spill blocks), one
    :func:`ivf_probe_topk` sweep, and the packed rows mapped to corpus ids
    on the device. Returns ``(vals (B, k), corpus ids (B, k) int64)``,
    ``(NEG_INF, -1)`` in empty slots."""
    probe = _probe(q, qk, centroids, n_probes, n_lists)
    uids = _union(probe, n_lists, spill_blocks)
    vals, pidx = ivf_probe_topk(q, qk, probe, uids, pemb, pkeys, k, capacity, n_lists,
                                packed_scales=pscales,
                                int8_mxu=int8_mxu and pscales is not None)
    empty = pidx >= SENTINEL_IDX
    ids = pids[pidx.clamp(max=pids.shape[0] - 1).to(torch.int64)].to(torch.int64)
    return (torch.where(empty, torch.full_like(vals, NEG_INF), vals),
            torch.where(empty, torch.full_like(ids, -1), ids))


def _probe_depths(q, nbr, centroids, positions, n_lists: int, capacity: int):
    """(S, k) probe depth at which each neighbour is found: the rank of its
    cluster among the query's centroid scores (float64, as :func:`_probe`
    ranks them), 0 for spilled rows (always scanned), -1 for empty slots."""
    qc = q.to(torch.float64) @ centroids.to(torch.float64).T
    block = positions[nbr.clamp(min=0)].to(torch.int64) // capacity
    s_c = torch.gather(qc, 1, block.clamp(max=n_lists - 1))
    rank = (qc[:, None, :] > s_c[:, :, None]).sum(dim=2)
    depth = torch.where(block > n_lists, torch.zeros_like(rank), rank)
    return torch.where(nbr >= 0, depth, torch.full_like(depth, -1))


class IVFIndex:
    """Cluster-probed approximate index on one device (pgvector IVFFlat).

    Build: ``IVFIndex(corpus, manuals, pages, n_lists=..., n_probes=...)``;
    search as :class:`~tpualign_torch.parallel.retrieval.RetrievalIndex`
    does, with the same candidate restriction, wildcard global mode and
    ``(NEG_INF, -1)`` sentinels; ``n_probes=n_lists`` is exact. Defaults
    follow IVFFlat practice: ``n_lists ~ sqrt(N)`` (rounded up to 8) and
    ``n_probes = n_lists // 8``. ``device`` defaults to CUDA and raises when
    it is absent; pass ``device="cpu"`` for the plain path. ``int8_mxu``
    defaults to the s8 route (as ``RetrievalIndex`` takes). ``use_kernel``
    forces (True) or refuses (False) the K4 route; ``query_block`` goes
    into the artifact and searches do not use it. Both keep tpualign's
    signature, so that one call builds either package's index; no caller
    in this package sets them.
    """

    def __init__(
        self,
        corpus_embeddings,
        corpus_manuals: Optional[Sequence[str]] = None,
        corpus_pages: Optional[Sequence[Optional[int]]] = None,
        n_lists: Optional[int] = None,
        n_probes: Optional[int] = None,
        iters: int = 10,
        capacity_factor: float = 1.5,
        keys: Optional[np.ndarray] = None,
        query_block: int = 64,
        cluster_chunk: int = 8,
        precision: str = "fp32",
        use_kernel: Optional[bool] = None,
        corpus_scales=None,
        int8_mxu: Optional[bool] = None,
        mesh=None,
        refine: int = 0,
        refine_store=None,
        device: str | torch.device = "cuda",
    ):
        if precision not in ("fp32", "int8", "int4", "int2"):
            raise ValueError(f"precision must be fp32|int8|int4|int2, got {precision}")
        _no_mesh(mesh)
        self.device = dev = resolve_device(device)
        self.vocab: Dict[str, int] = {}
        self.use_kernel = use_kernel
        self.int8_mxu = True if int8_mxu is None else bool(int8_mxu)
        corpus = np.asarray(corpus_embeddings)
        if corpus.dtype == np.int8:
            # pre-quantized rows: k-means dequantizes a block at a time and
            # the layout takes the codes as they are
            if corpus_scales is None:
                raise ValueError("int8 corpus needs corpus_scales")
            precision = "int8"
        elif corpus.dtype == np.uint8:
            # pre-packed int4 (N, D/2), or int2 (N, D/4) with precision="int2"
            if corpus_scales is None:
                raise ValueError("packed corpus needs corpus_scales")
            if precision != "int2":
                precision = "int4"
        else:
            corpus = np.asarray(corpus, np.float32)
        prequantized = corpus.dtype in (np.int8, np.uint8)
        self.precision = precision
        # (hexdigest, dtype) of the build corpus, written into the artifact
        # so that load() rejects a same-size corpus whose rows changed
        self._corpus_fp = _corpus_fingerprint(corpus)
        self.n, d_cols = corpus.shape
        self.dim = d_cols * (4 if precision == "int2" else 2) if corpus.dtype == np.uint8 \
            else d_cols
        if self.n == 0:
            raise ValueError("IVFIndex needs a non-empty corpus")
        self._refine_store = refine_store
        self.refine, self._refine_corpus = _setup_refine(
            refine, precision, corpus_embeddings, store=refine_store, prequantized=prequantized)
        if keys is not None:
            keys = np.asarray(keys, np.int32)
        elif corpus_manuals is not None:
            keys, self.vocab = encode_keys(corpus_manuals, corpus_pages, self.vocab)
        else:
            keys = np.zeros(self.n, np.int32)

        if n_lists is None:
            n_lists = max(8, min(_round_up(int(self.n ** 0.5), 8), self.n))
        max_cap = _max_capacity(self.dim, {"int8": 1, "int4": 0, "int2": 0}.get(precision, 4),
                                int8_mxu=self.int8_mxu and precision == "int8")
        min_lists = -(-int(np.ceil(capacity_factor * self.n)) // max_cap)
        if n_lists < min_lists:
            bumped = min(_round_up(min_lists, 8), self.n)
            log.info("IVF: n_lists %d would give cluster capacity ~%d > the %d-row bound at "
                     "d=%d; using %d lists", n_lists, int(capacity_factor * self.n / n_lists),
                     max_cap, self.dim, bumped)
            n_lists = bumped
        self.n_lists = int(n_lists)
        self.n_probes = (max(1, self.n_lists // 8) if n_probes is None
                         else min(int(n_probes), self.n_lists))
        self.query_block = int(query_block)
        self.cluster_chunk = max(1, int(cluster_chunk))

        # k-means over the device copy of the build corpus, from a strided
        # init over real rows
        rows = _tensor(corpus, dev)
        scales = (_tensor(np.asarray(corpus_scales, np.float32).reshape(-1), dev)
                  if prequantized else None)
        init = torch.from_numpy((np.arange(self.n_lists, dtype=np.int64) * self.n)
                                // self.n_lists).to(dev)
        init_cent = _dequant(rows[init], None if scales is None else scales[init], self.dim)
        self.centroids, assign, sizes = _kmeans(rows, scales, init_cent, int(iters), self.dim)
        sizes = sizes.cpu().numpy()
        avg = self.n / self.n_lists
        cap = _round_up(max(1, int(np.ceil(capacity_factor * avg))), 128)
        cap = min(cap, _round_up(int(sizes.max()), 128), max_cap)
        overflow = int(np.maximum(sizes - cap, 0).sum())
        self.capacity = cap
        self.spill = overflow
        self.spill_blocks = max(1, -(-overflow // cap))
        if overflow:
            log.info("IVF build: %d/%d rows spilled past cluster capacity %d (scanned exactly "
                     "by every query)", overflow, self.n, cap)
        self._ids, self._keys = _pack(_tensor(keys, dev), assign, self.n_lists, cap,
                                      self.spill_blocks)
        del assign
        if not prequantized and precision != "fp32":
            # per-row quantization commutes with the layout's gather: the
            # codes of the corpus, gathered, are the packed layout's codes
            del rows
            codes, row_scales = _QUANTIZERS[precision](corpus)
            rows, scales = _tensor(codes, dev), _tensor(row_scales, dev)
        self._emb, self._scales = self._gather(rows, scales)

    def _gather(self, rows: torch.Tensor, scales: Optional[torch.Tensor]):
        """The layout's rows (and scales) from the corpus's: unused slots
        take row 0, which their key -1 masks."""
        at = self._ids.clamp(min=0).to(torch.int64)
        return rows[at], None if scales is None else scales[at]

    # -- mutations and meshes: later slices ------------------------------------------

    def add(self, embeddings, manuals=None, pages=None) -> None:
        raise NotImplementedError("IVFIndex.add is not yet ported to tpualign_torch (the "
                                  "index-mutation slice); rebuild the index")

    def remove(self, corpus_ids) -> int:
        raise NotImplementedError("IVFIndex.remove is not yet ported to tpualign_torch (the "
                                  "index-mutation slice); rebuild the index")

    def compact(self) -> np.ndarray:
        raise NotImplementedError("IVFIndex.compact is not yet ported to tpualign_torch (the "
                                  "index-mutation slice); rebuild the index")

    # -- search ------------------------------------------------------------------------

    def _kernel_path(self, exact_ties: bool, k: int) -> bool:
        """K4 for probed searches with k <= 64, as tpualign routes on a TPU;
        full-probe searches keep the union route's two-key tie-break."""
        if exact_ties:
            return False
        if self.use_kernel is not None:
            return self.use_kernel
        return k <= 64

    def search(self, query_embeddings, query_manuals: Optional[Sequence[str]] = None,
               query_pages: Optional[Sequence[Optional[int]]] = None, k: int = 10,
               n_probes: Optional[int] = None, global_search: bool = False
               ) -> Tuple[np.ndarray, np.ndarray]:
        """Top-k per query as host arrays (values, corpus indices; -1 = no
        candidate). ``n_probes`` overrides the default; ``n_lists`` probes
        scan everything (exact)."""
        queries = np.asarray(query_embeddings, np.float32)
        if global_search or query_manuals is None:
            qk = np.full(len(queries), WILDCARD_KEY, np.int32)
        else:
            qk, _ = encode_keys(query_manuals, query_pages, dict(self.vocab))
        return self.search_encoded(queries, qk, k, n_probes)

    def search_encoded(self, queries: np.ndarray, qk: np.ndarray, k: int,
                       n_probes: Optional[int] = None) -> Tuple[np.ndarray, np.ndarray]:
        """Host-array search with pre-encoded keys (the serving coalescer's
        call). With ``refine`` it over-fetches ``k*refine`` candidates and
        rescores them exactly on the host."""
        if self.refine > 1 and k > 0 and len(queries):
            kf = min(max(k, k * self.refine), self.n)
            vals, idx = self._search_encoded_raw(queries, qk, kf, n_probes)
            return _refine_rescore(queries, vals, idx, self._refine_corpus, k)
        return self._search_encoded_raw(queries, qk, k, n_probes)

    def _search_encoded_raw(self, queries: np.ndarray, qk: np.ndarray, k: int,
                            n_probes: Optional[int] = None) -> Tuple[np.ndarray, np.ndarray]:
        """One dispatch for the whole batch: tpualign cuts batches into
        ``query_block`` dispatches to reuse compiled shapes, which eager
        PyTorch does not need; the results are the same."""
        nq = len(queries)
        if nq == 0:
            return np.full((0, k), NEG_INF, np.float32), np.full((0, k), -1, np.int64)
        vals, idx = self.search_device(_tensor(np.asarray(queries, np.float32), self.device),
                                       _tensor(np.asarray(qk, np.int32), self.device), k,
                                       n_probes)
        vals, idx = _pad_results(vals.cpu().numpy(), idx.cpu().numpy(), k)
        return _sentinel(vals, idx)

    def search_device(self, query_embeddings: torch.Tensor, query_keys: torch.Tensor, k: int,
                      n_probes: Optional[int] = None) -> Tuple[torch.Tensor, torch.Tensor]:
        """Device-resident probed search: tensors in, ``(vals (Q, k), corpus
        ids (Q, k) int64)`` out on the index's device, ``(NEG_INF, -1)`` in
        empty slots."""
        p = self.n_probes if n_probes is None else min(int(n_probes), self.n_lists)
        exact_ties = p == self.n_lists
        q = query_embeddings.to(self.device, torch.float32).contiguous()
        qk = query_keys.to(self.device, torch.int32).contiguous()
        args = (q, qk, self.centroids, self._emb, self._keys, self._ids, self._scales, k, p,
                self.n_lists, self.capacity, self.spill_blocks)
        if self._kernel_path(exact_ties, k):
            return _ivf_kernel_search(*args, int8_mxu=self.int8_mxu)
        return _ivf_union_search(*args, self.cluster_chunk, exact_ties)

    # -- probe calibration -------------------------------------------------------------

    def calibrate(self, recall_target: float, k: int = 10, sample: int = 256) -> int:
        """Set ``n_probes`` to the smallest count whose expected recall@k
        meets ``recall_target`` (tpualign's analytic calibration): one
        full-probe search over a strided sample of the corpus's own rows
        gives each true neighbour's probe depth, the rank of its cluster
        among the query's centroid scores (0 for spilled rows); recall(P) is
        the share of depths below P. Returns the count."""
        if not 0.0 < recall_target <= 1.0:
            raise ValueError(f"recall_target in (0, 1], got {recall_target}")
        s = min(int(sample), self.n)
        sel = torch.from_numpy((np.arange(s, dtype=np.int64) * self.n) // s).to(self.device)
        pos = self._positions[sel].to(torch.int64)
        q = _dequant(self._emb[pos], None if self._scales is None else self._scales[pos],
                     self.dim)
        qk = np.full(s, WILDCARD_KEY, np.int32)
        _, nbr = self.search_encoded(q.cpu().numpy(), qk, k, n_probes=self.n_lists)
        depth = _probe_depths(q, torch.from_numpy(nbr).to(self.device), self.centroids,
                              self._positions, self.n_lists, self.capacity).cpu().numpy()
        depths = np.sort(depth[depth >= 0])
        if depths.size == 0:
            return self.n_probes
        idx = min(int(np.ceil(recall_target * depths.size)) - 1, depths.size - 1)
        p = max(1, min(int(depths[idx]) + 1, self.n_lists))
        log.info("IVF calibration: n_probes=%d reaches recall@%d %.4f (target %.3f, %d sample "
                 "queries)", p, k, float(np.mean(depths < p)), recall_target, s)
        self.n_probes = p
        self.calibrated_target = float(recall_target)
        return p

    @property
    def _positions(self) -> torch.Tensor:
        """Packed row of each corpus id, built once."""
        cached = getattr(self, "_positions_cache", None)
        if cached is None:
            dest = torch.where(self._ids >= 0, self._ids, self.n).to(torch.int64)
            cached = torch.zeros(self.n + 1, dtype=torch.int32, device=self.device)
            cached[dest] = torch.arange(len(self._ids), dtype=torch.int32, device=self.device)
            cached = cached[:self.n]
            self._positions_cache = cached
        return cached

    # -- persistence ---------------------------------------------------------------------

    def save(self, path) -> None:
        """Write the index structure (centroids, the layout's ids and keys,
        geometry, vocab and the corpus fingerprint) in tpualign's ``.npz``
        format; the rows stay in the store."""
        meta = {
            "n": self.n, "dim": self.dim, "n_lists": self.n_lists,
            "n_probes": self.n_probes, "capacity": self.capacity,
            "spill": self.spill, "spill_blocks": self.spill_blocks,
            "precision": self.precision,
            "query_block": self.query_block,
            "cluster_chunk": self.cluster_chunk,
            "calibrated_target": getattr(self, "calibrated_target", None),
            "vocab": self.vocab,
            "fingerprint": self._corpus_fp,
        }
        np.savez_compressed(
            path,
            centroids=self.centroids.cpu().numpy().astype(np.float32),
            pids=self._ids.cpu().numpy().astype(np.int32),
            pkeys=self._keys.cpu().numpy().astype(np.int32),
            meta=np.frombuffer(json.dumps(meta).encode(), dtype=np.uint8),
        )

    @classmethod
    def load(cls, path, corpus_embeddings, corpus_scales=None,
             use_kernel: Optional[bool] = None, int8_mxu: Optional[bool] = None,
             refine: int = 0, mesh=None, refine_store=None,
             device: str | torch.device = "cuda") -> "IVFIndex":
        """Rebuild a saved index around the same corpus (row order as at
        the build; ids index into it): one gather replaces k-means.
        Precision follows the artifact (fp32 rows are quantized along the
        layout). Raises ValueError for an artifact of another corpus shape
        or content, or of a mesh."""
        _no_mesh(mesh)
        dev = resolve_device(device)
        z = np.load(path)
        meta = json.loads(bytes(z["meta"]).decode())
        if meta.get("ndev") is not None:
            raise ValueError(f"artifact is sharded over {meta['ndev']} devices; the multi-GPU "
                             f"slice of tpualign_torch is not yet ported: rebuild on one device")
        corpus = np.asarray(corpus_embeddings)
        prequantized = corpus.dtype in (np.int8, np.uint8)
        want_cols = (meta["dim"] // (4 if meta["precision"] == "int2" else 2)
                     if corpus.dtype == np.uint8 else meta["dim"])
        if corpus.shape != (meta["n"], want_cols):
            raise ValueError(f"corpus shape {corpus.shape} does not match saved index "
                             f"({meta['n']}, {want_cols})")
        saved_fp = meta.get("fingerprint")
        if saved_fp is not None:
            got_fp, got_dtype = _corpus_fingerprint(
                corpus, None if prequantized else np.float32)
            if got_dtype != saved_fp[1]:
                log.warning("IVF cache fingerprint skipped: artifact was built over %s rows "
                            "but the served corpus is %s — cross-precision loads get "
                            "shape-only validation", saved_fp[1], got_dtype)
            elif got_fp != saved_fp[0]:
                raise ValueError("IVF artifact was built over a different corpus (content "
                                 "fingerprint mismatch); rebuild the index")
        self = cls.__new__(cls)
        self.device = dev
        self.vocab = {k: int(v) for k, v in meta["vocab"].items()}
        self._corpus_fp = tuple(saved_fp) if saved_fp else None
        self.use_kernel = use_kernel
        self.int8_mxu = True if int8_mxu is None else bool(int8_mxu)
        self.n, self.dim = meta["n"], meta["dim"]
        self.n_lists = meta["n_lists"]
        self.n_probes = meta["n_probes"]
        self.capacity = meta["capacity"]
        self.spill = meta["spill"]
        self.spill_blocks = meta["spill_blocks"]
        self.precision = meta["precision"]
        self.query_block = meta["query_block"]
        self.cluster_chunk = meta["cluster_chunk"]
        if meta.get("calibrated_target") is not None:
            self.calibrated_target = meta["calibrated_target"]
        self._refine_store = refine_store
        self.refine, self._refine_corpus = _setup_refine(
            refine, self.precision, corpus_embeddings, store=refine_store,
            prequantized=prequantized)
        self.centroids = torch.from_numpy(np.asarray(z["centroids"], np.float32)).to(dev)
        self._ids = torch.from_numpy(np.asarray(z["pids"], np.int32)).to(dev)
        self._keys = torch.from_numpy(np.asarray(z["pkeys"], np.int32)).to(dev)
        scales = None
        if prequantized:
            if corpus_scales is None:
                raise ValueError(f"{'int8' if corpus.dtype == np.int8 else 'packed'} corpus "
                                 f"needs corpus_scales")
            if corpus.dtype == np.int8 and self.precision != "int8":
                raise ValueError("fp32 index cannot load an int8 corpus")
            if corpus.dtype == np.uint8 and self.precision not in ("int4", "int2"):
                raise ValueError(f"{self.precision} index cannot load a packed corpus")
            rows = corpus
            scales = _tensor(np.asarray(corpus_scales, np.float32).reshape(-1), dev)
        elif self.precision in _QUANTIZERS:
            rows, row_scales = _QUANTIZERS[self.precision](np.asarray(corpus, np.float32))
            scales = _tensor(row_scales, dev)
        else:
            rows = np.asarray(corpus, np.float32)
        self._emb, self._scales = self._gather(_tensor(rows, dev), scales)
        return self

    @property
    def memory_bytes(self) -> int:
        """Device bytes: packed rows, scales, keys, ids and centroids."""
        total = self._emb.shape[0]
        row = {"int8": self.dim, "int4": self.dim // 2, "int2": self.dim // 4}.get(
            self.precision, self.dim * 4)
        scale = 0 if self.precision == "fp32" else 4
        return total * (row + 8 + scale) + self.n_lists * self.dim * 4


def _no_mesh(mesh) -> None:
    if mesh is not None:
        raise NotImplementedError("IVFIndex(mesh=...) is the multi-GPU slice of tpualign_torch, "
                                  "not yet ported; build the index on one device")
