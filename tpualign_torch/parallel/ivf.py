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

- **Mutations**: ``add`` puts each new row after the used slots of its
  nearest centroid's block, or in the spill tail when the block is full
  (the tail grows by whole blocks); ``remove`` tombstones slots (key -2);
  ``compact`` re-packs the survivors around the existing centroids (no
  k-means; spilled rows go back to their nearest list) and renumbers them
  in ascending old-id order. As in ``RetrievalIndex``, each is
  copy-on-write: new key and id tensors, rows written in place only into
  slots every older key tensor masks (-1), and one ``__dict__`` update;
  searches run on a snapshot (:meth:`IVFIndex._snapshot`).

- **Sharded** (a mesh whose data axis is above 1; tpualign's FAISS-style
  sharded IVF): the rows split into contiguous shards of ``n_local`` rows
  (padded to the k-means block), one shard a data device; each shard runs
  its own k-means over its rows into ``n_lists_local`` lists and packs its
  own layout, with the capacity and spill blocks of the largest list over
  all shards (every shard has one geometry) and global corpus ids. A
  search runs K4 (or the union route) on every shard at ``n_probes`` per
  shard and merges the winners exactly on the first data device by
  (value desc, id asc). ``add`` routes each row to its globally nearest
  centroid's shard and list (a full tail grows every shard's by the same
  blocks), ``remove`` tombstones by global id, ``compact`` re-packs the
  survivors across the shards without requantization, and the artifact
  records the shard count. On a mesh across processes
  (``parallel/multihost.py``) each process builds and searches its own
  shards and the winners of every process merge through an all-gather;
  the mutations, calibration and the artifact there take one process, as
  in tpualign, which cannot build the index across processes at all
  (ROADMAP settled difference 24).
"""

from __future__ import annotations

import copy
import hashlib
import json
from typing import Dict, Optional, Sequence, Tuple

import numpy as np
import torch

from tpualign_torch.ops.ivf_topk import _membership, ivf_probe_topk
from tpualign_torch.ops.sim_topk import SENTINEL_IDX, _unpack_codes, key_mask
from tpualign_torch.ops.similarity import NEG_INF, WILDCARD_KEY
from tpualign_torch.parallel.mesh import ShardedRows, one_process, shard_devices
from tpualign_torch.parallel.retrieval import (
    _QUANTIZERS, _merge_processes, _pad_results, _padded, _refine_rescore, _round_up, _sentinel,
    _setup_refine, _tensor, _two_key_topk, encode_keys)
from tpualign_torch.utils.device import resolve_device
from tpualign_torch.utils.logging import get_logger

log = get_logger("parallel.ivf")

__all__ = ["IVFIndex"]

KMEANS_BLOCK = 1 << 14  # corpus rows per k-means step
# A packed int4 byte that decodes to (0, 0): the fill of grown spill blocks
# over packed layouts (tpualign's INT4_ZERO_BYTE)
INT4_ZERO_BYTE = 0x88


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


def _probe_depths(q, nbr, centroids, positions, n_lists: int, capacity: int, shards: int,
                  total_local: int):
    """(S, k) probe depth at which each neighbour is found: the rank of its
    cluster among the query's centroid scores (float64, as :func:`_probe`
    ranks them), 0 for spilled rows (always scanned), -1 for empty slots.
    Over ``shards`` shards of ``total_local`` packed rows and ``n_lists``
    lists each (tpualign's ``_probe_depths_sharded``), the rank is among
    the neighbour's own shard's centroids, since probes apply per shard."""
    qc = q.to(torch.float64) @ centroids.to(torch.float64).T
    pos = positions[nbr.clamp(min=0)].to(torch.int64)
    shard, block = pos // total_local, (pos % total_local) // capacity
    s_c = torch.gather(qc, 1, shard * n_lists + block.clamp(max=n_lists - 1))
    same = (torch.arange(shards * n_lists, device=q.device) // n_lists)[None, None, :] \
        == shard[:, :, None]
    rank = ((qc[:, None, :] > s_c[:, :, None]) & same).sum(dim=2)
    depth = torch.where(block > n_lists, torch.zeros_like(rank), rank)
    return torch.where(nbr >= 0, depth, torch.full_like(depth, -1))


def _shard_rows(n: int, shards: int) -> int:
    """tpualign's rows a shard: ``ceil(n / shards)`` padded to the k-means
    block it picks (the largest power of two up to 2**14 that the rows
    reach, at least 8)."""
    n_local = -(-n // shards)
    block = 1 << 14
    while block > n_local:
        block //= 2
    return _round_up(n_local, max(block, 8))


class IVFIndex:
    """Cluster-probed approximate index on one device (pgvector IVFFlat).

    Build: ``IVFIndex(corpus, manuals, pages, n_lists=..., n_probes=...)``;
    search as :class:`~tpualign_torch.parallel.retrieval.RetrievalIndex`
    does, with the same candidate restriction, wildcard global mode and
    ``(NEG_INF, -1)`` sentinels; ``n_probes=n_lists`` is exact. Defaults
    follow IVFFlat practice: ``n_lists ~ sqrt(N)`` (rounded up to 8) and
    ``n_probes = n_lists // 8``. ``device`` defaults to CUDA and raises when
    it is absent; pass ``device="cpu"`` for the plain path. A ``mesh`` with a
    data axis above 1 shards the index over it (the module notes); then
    ``n_lists_local`` lists a shard and ``n_probes`` apply per shard. ``int8_mxu``
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
        self.mesh = _sharding_mesh(mesh)
        self.device = dev = resolve_device(device) if self.mesh is None else self.mesh.home
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
        if self.mesh is not None:
            self._build_sharded(corpus, keys, corpus_scales if prequantized else None, n_lists,
                                n_probes, int(iters), capacity_factor, query_block, cluster_chunk)
            return

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

    def _build_sharded(self, corpus: np.ndarray, keys: np.ndarray,
                       scales_in: Optional[np.ndarray], n_lists: Optional[int],
                       n_probes: Optional[int], iters: int, capacity_factor: float,
                       query_block: int, cluster_chunk: int) -> None:
        """tpualign's ``_build_sharded``: ``n_local`` rows a shard (padded
        with zero rows keyed -1: the packed int4 zero byte, scale 0 for
        int2 and 1 otherwise), ``n_lists_local`` lists a shard (rounded to
        8, at least what the capacity clamp needs), each shard's k-means on
        its own device from its rows ``arange(ll) * n_local // ll``, then
        one global capacity and spill from the largest list of any shard,
        each shard packed with global ids and its own rows' scales; fp32
        rows are quantized along the layout."""
        mesh = self.mesh
        self._devices = devices = mesh.data_devices
        ndev, dim, precision = len(devices), self.dim, self.precision
        max_cap = _max_capacity(dim, {"int8": 1, "int4": 0, "int2": 0}.get(precision, 4),
                                int8_mxu=self.int8_mxu and precision == "int8")
        n_local = _shard_rows(self.n, ndev)
        if n_lists is None:
            n_lists = max(8 * ndev, min(_round_up(int(self.n ** 0.5), 8), self.n))
        ll = max(8, _round_up(-(-int(n_lists) // ndev), 8))
        ll = max(ll, _round_up(-(-int(np.ceil(capacity_factor * n_local)) // max_cap), 8))
        self.n_lists_local, self.n_lists = ll, ll * ndev
        self.n_probes = max(1, ll // 8) if n_probes is None else min(int(n_probes), ll)
        self.query_block = int(query_block)
        self.cluster_chunk = max(1, int(cluster_chunk))

        fill = INT4_ZERO_BYTE if corpus.dtype == np.uint8 else 0
        if scales_in is not None:
            scales_in = np.asarray(scales_in, np.float32).reshape(-1)
        init = torch.from_numpy((np.arange(ll, dtype=np.int64) * n_local) // ll)
        built = {}
        for s in mesh.local_rows:
            dev, sel = devices[s], slice(s * n_local, (s + 1) * n_local)
            rows_np = _padded(corpus[sel], n_local, fill)
            rows = _tensor(rows_np, dev)
            sc = (None if scales_in is None else
                  _tensor(_padded(scales_in[sel], n_local, 0.0 if precision == "int2" else 1.0),
                          dev))
            at = init.to(dev)
            cent, assign, sizes = _kmeans(rows, sc, _dequant(rows[at], None if sc is None
                                                             else sc[at], dim), iters, dim)
            built[s] = (rows_np, rows, sc, cent, assign, sizes)
        local_sizes = torch.stack([built[s][5].to(self.device) for s in mesh.local_rows])
        if mesh.distributed:
            from tpualign_torch.parallel.multihost import process_gather

            local_sizes = torch.cat(process_gather(mesh, local_sizes))
        sizes = local_sizes.cpu().numpy().reshape(ndev, ll)
        cap = _round_up(max(1, int(np.ceil(capacity_factor * n_local / ll))), 128)
        cap = min(cap, _round_up(int(sizes.max()), 128), max_cap)
        overflow = np.maximum(sizes - cap, 0).sum(axis=1)
        self.capacity = cap
        self.spill = int(overflow.sum())
        self.spill_blocks = max(1, -(-int(overflow.max()) // cap))
        if self.spill:
            log.info("sharded IVF build: %d/%d rows spilled past capacity %d (max %d on one "
                     "shard)", self.spill, self.n, cap, int(overflow.max()))
        parts: Dict[str, list] = {"centroids": [], "_ids": [], "_keys": [], "_emb": [],
                                  "_scales": []}
        for s in range(ndev):
            if s not in built:
                for p in parts.values():
                    p.append(None)
                continue
            rows_np, rows, sc, cent, assign, _ = built.pop(s)
            dev = devices[s]
            ids, pkeys = _pack(_tensor(_padded(keys[s * n_local:(s + 1) * n_local], n_local, -1),
                                       dev), assign, ll, cap, self.spill_blocks)
            if scales_in is None and precision != "fp32":
                codes, row_scales = _QUANTIZERS[precision](rows_np)
                rows, sc = _tensor(codes, dev), _tensor(row_scales, dev)
            at = ids.clamp(min=0).to(torch.int64)
            parts["centroids"].append(cent)
            parts["_ids"].append(torch.where(ids >= 0, ids + s * n_local, ids))
            parts["_keys"].append(pkeys)
            parts["_emb"].append(rows[at])
            parts["_scales"].append(None if sc is None else sc[at])
            del rows, sc, assign
        for name, p in parts.items():
            setattr(self, name, None if all(t is None for t in p) else ShardedRows(p))

    def _snapshot(self) -> "IVFIndex":
        """A shallow copy holding one consistent set of fields (see
        ``RetrievalIndex._snapshot``)."""
        return copy.copy(self)

    def _nearest_list(self, rows: torch.Tensor) -> np.ndarray:
        """Each row's nearest centroid, by the fp32 product and the first
        maximum, as the k-means assignment takes it; over every shard's
        centroids on a mesh (a global list id ``shard * n_lists_local +
        list``)."""
        cent = self.centroids if self.mesh is None else self.centroids.to(self.device)
        return torch.argmax(rows.to(self.device) @ cent.T, dim=1).cpu().numpy()

    # -- mutations --------------------------------------------------------------------

    def add(self, embeddings, manuals: Optional[Sequence[str]] = None,
            pages: Optional[Sequence[Optional[int]]] = None) -> None:
        """Append rows as IVFFlat does, without retraining: each joins its
        nearest centroid's block after the block's used slots (a block
        keeps ascending ids), rows that find their block full go to the
        spill tail (which every query scans, so a full-probe search stays
        exact over the combined corpus), and a full tail grows by whole
        blocks. New rows take ids ``n..n+m-1``."""
        rows = np.asarray(embeddings, np.float32)
        if rows.ndim != 2 or rows.shape[1] != self.dim:
            raise ValueError(f"embeddings must be (M, {self.dim}); got {rows.shape}")
        m = len(rows)
        if m == 0:
            return
        if manuals is not None:
            new_keys, _ = encode_keys(manuals, pages, self.vocab)
        else:
            new_keys = np.zeros((m,), np.int32)
        if self.mesh is not None:
            one_process(self.mesh, "IVFIndex.add on a mesh")
            self._add_sharded(rows, np.asarray(new_keys, np.int32))
            return
        dev, cap, n_lists = self.device, self.capacity, self.n_lists
        assign = self._nearest_list(_tensor(rows, dev))
        # used slots of each block, contiguous from slot 0
        used = (self._keys.reshape(-1, cap) != -1).sum(dim=1).cpu().numpy()
        order = np.argsort(assign, kind="stable")
        a_sorted = assign[order]
        starts = np.searchsorted(a_sorted, np.arange(n_lists), side="left")
        slot = used[a_sorted] + np.arange(m) - starts[a_sorted]
        in_main = slot < cap
        dest_sorted = a_sorted.astype(np.int64) * cap + slot
        emb, keys, ids, scales = self._emb, self._keys, self._ids, self._scales
        spill_blocks = self.spill_blocks
        n_over = int((~in_main).sum())
        if n_over:
            spill_start = (n_lists + 1) * cap
            spill_used = int(used[n_lists + 1:].sum())  # the tail fills contiguously
            need = spill_start + spill_used + n_over
            if need > ids.shape[0]:
                add_blocks = -(-(need - ids.shape[0]) // cap)
                grow = add_blocks * cap
                fill = INT4_ZERO_BYTE if emb.dtype == torch.uint8 else 0
                emb = torch.cat([emb, emb.new_full((grow, emb.shape[1]), fill)])
                keys = torch.cat([keys, keys.new_full((grow,), -1)])
                ids = torch.cat([ids, ids.new_full((grow,), -1)])
                if scales is not None:
                    scales = torch.cat([scales, scales.new_ones((grow,))])
                spill_blocks += add_blocks
                log.info("IVF add: the spill tail grew by %d block(s) to hold %d overflow "
                         "row(s)", add_blocks, n_over)
            dest_sorted[~in_main] = spill_start + spill_used + np.arange(n_over)
        dest = np.empty(m, np.int64)
        dest[order] = dest_sorted
        new_rows, new_scales = self._quantize_new_rows(rows)
        at = torch.from_numpy(dest).to(dev)
        keys = keys.clone() if keys is self._keys else keys
        ids = ids.clone() if ids is self._ids else ids
        # the destination slots are keyed -1 in every key tensor this layout
        # has had, so the in-place row writes are invisible until the new
        # keys go in
        emb[at] = _tensor(new_rows, dev)
        if scales is not None:
            scales[at] = _tensor(new_scales, dev)
        keys[at] = _tensor(np.asarray(new_keys, np.int32), dev)
        ids[at] = torch.arange(self.n, self.n + m, dtype=torch.int32, device=dev)
        state = {"_emb": emb, "_keys": keys, "_ids": ids, "_scales": scales, "n": self.n + m,
                 "spill": self.spill + n_over, "spill_blocks": spill_blocks,
                 "_positions_cache": None, "_corpus_fp": None}
        if self._refine_corpus is not None:
            state["_refine_corpus"] = self._refine_corpus.appended(rows)
        self.__dict__.update(state)

    def _add_sharded(self, rows: np.ndarray, new_keys: np.ndarray) -> None:
        """tpualign's ``_add_sharded``: each row goes to its globally
        nearest centroid's shard and list, after the block's used slots,
        and rows that find the block full go to that shard's spill tail
        (in ascending id order); when a tail overflows, every shard's tail
        grows by the same whole blocks (new tensors). Rows are written in
        place only into slots every older key tensor masks."""
        devices, ndev = self._devices, len(self._devices)
        ll, cap, m = self.n_lists_local, self.capacity, len(rows)
        assign = self._nearest_list(_tensor(rows, self.device))
        blocks = ll + 1 + self.spill_blocks
        used = np.stack([(k.reshape(-1, cap) != -1).sum(dim=1).cpu().numpy()
                         for k in self._keys.parts])
        order = np.argsort(assign, kind="stable")
        a_sorted = assign[order]
        sh_sorted, ls_sorted = a_sorted // ll, a_sorted % ll
        starts = np.searchsorted(a_sorted, np.arange(ndev * ll), side="left")
        slot = used[sh_sorted, ls_sorted] + np.arange(m) - starts[a_sorted]
        over = slot >= cap
        spill_used = used[:, ll + 1:].sum(axis=1)  # the tails fill contiguously
        n_over_sh = np.bincount(sh_sorted[over], minlength=ndev)
        spill_rank = np.zeros(m, np.int64)
        for s in np.flatnonzero(n_over_sh):
            spill_rank[over & (sh_sorted == s)] = np.arange(n_over_sh[s])
        emb, keys, ids, scales = (list(f.parts) if f is not None else None
                                  for f in (self._emb, self._keys, self._ids, self._scales))
        spill_blocks, fresh = self.spill_blocks, False
        need = int((spill_used + n_over_sh).max())
        if need > spill_blocks * cap:
            add_blocks = -(-(need - spill_blocks * cap) // cap)
            grow = add_blocks * cap
            fill = INT4_ZERO_BYTE if emb[0].dtype == torch.uint8 else 0
            emb = [torch.cat([t, t.new_full((grow, t.shape[1]), fill)]) for t in emb]
            keys = [torch.cat([t, t.new_full((grow,), -1)]) for t in keys]
            ids = [torch.cat([t, t.new_full((grow,), -1)]) for t in ids]
            if scales is not None:
                scales = [torch.cat([t, t.new_ones((grow,))]) for t in scales]
            spill_blocks += add_blocks
            blocks += add_blocks
            fresh = True
            log.info("sharded IVF add: the spill tails grew by %d block(s) a shard to hold %d "
                     "overflow row(s)", add_blocks, int(over.sum()))
        dest_sorted = ls_sorted.astype(np.int64) * cap + slot
        dest_sorted[over] = (ll + 1) * cap + spill_used[sh_sorted[over]] + spill_rank[over]
        dest = np.empty(m, np.int64)
        dest[order] = dest_sorted
        shard = np.empty(m, np.int64)
        shard[order] = sh_sorted
        new_rows, new_scales = self._quantize_new_rows(rows)
        new_ids = np.arange(self.n, self.n + m, dtype=np.int32)
        for s in np.unique(shard):
            sel, dev = np.flatnonzero(shard == s), devices[s]
            at = torch.from_numpy(dest[sel]).to(dev)
            if not fresh:
                keys[s], ids[s] = keys[s].clone(), ids[s].clone()
            emb[s][at] = _tensor(new_rows[sel], dev)
            if scales is not None:
                scales[s][at] = _tensor(new_scales[sel], dev)
            keys[s][at] = _tensor(new_keys[sel], dev)
            ids[s][at] = _tensor(new_ids[sel], dev)
        state = {"_emb": ShardedRows(emb), "_keys": ShardedRows(keys), "_ids": ShardedRows(ids),
                 "_scales": None if scales is None else ShardedRows(scales), "n": self.n + m,
                 "spill": self.spill + int(over.sum()), "spill_blocks": spill_blocks,
                 "_positions_cache": None, "_corpus_fp": None}
        if self._refine_corpus is not None:
            state["_refine_corpus"] = self._refine_corpus.appended(rows)
        self.__dict__.update(state)

    def _quantize_new_rows(self, rows: np.ndarray):
        """New fp32 rows on the build's per-row grid, so a full-probe search
        over an added index equals a fresh build over the combined corpus."""
        if self.precision in _QUANTIZERS:
            return _QUANTIZERS[self.precision](rows)
        return rows, None

    def remove(self, corpus_ids) -> int:
        """Tombstone rows by corpus id (pgvector's DELETE): the slot's key
        becomes -2, so the row is never returned, and the slot stays used
        (``!= -1``), which keeps a block's used slots contiguous for
        :meth:`add`. Returns the rows newly tombstoned; unknown and already
        removed ids are ignored."""
        ids = np.unique(np.asarray(corpus_ids, np.int64))
        ids = ids[(ids >= 0) & (ids < self.n)]
        if ids.size == 0:
            return 0
        if self.mesh is not None:
            return self._remove_sharded(ids)
        want = torch.from_numpy(ids).to(self.device)
        pos = self._positions[want].to(torch.int64)
        live = self._ids[pos] == want.to(torch.int32)
        removed = int((live & (self._keys[pos] != -2)).sum())
        keys = self._keys.clone()
        keys[pos[live]] = -2
        self.__dict__.update({"_keys": keys})
        return removed

    def _remove_sharded(self, ids: np.ndarray) -> int:
        """``remove`` on a mesh: the global ids find their shard and slot
        through :attr:`_positions`; each shard that changes gets new keys."""
        one_process(self.mesh, "IVFIndex.remove on a mesh")
        total = self._ids.rows_per_shard
        pos = self._positions[torch.from_numpy(ids).to(self.device)].cpu().numpy().astype(np.int64)
        keys, removed = list(self._keys.parts), 0
        for s in np.unique(pos // total):
            sel = pos // total == s
            at = torch.from_numpy(pos[sel] - s * total).to(keys[s].device)
            want = torch.from_numpy(ids[sel].astype(np.int32)).to(keys[s].device)
            live = self._ids.parts[s][at] == want
            removed += int((live & (keys[s][at] != -2)).sum())
            keys[s] = keys[s].clone()
            keys[s][at[live]] = -2
        self.__dict__.update({"_keys": ShardedRows(keys)})
        return removed

    @property
    def dead(self) -> int:
        """Tombstoned rows awaiting :meth:`compact`."""
        if self.mesh is not None:
            one_process(self.mesh, "IVFIndex.dead on a mesh")
            return sum(int((k == -2).sum()) for k in self._keys.parts)
        return int((self._keys == -2).sum())

    def compact(self) -> np.ndarray:
        """Reclaim tombstoned slots without k-means (pgvector's VACUUM for
        the IVF rung): the survivors re-pack around the existing centroids
        (a block's rows keep their list, spilled rows take their nearest
        centroid, so a shrunken corpus re-absorbs its spill), renumbered in
        ascending old-id order. Capacity stays; the spill tail re-sizes.
        Returns the ascending surviving old ids. Raises ValueError when it
        would empty the index (rebuild from the store instead)."""
        if self.mesh is not None:
            return self._compact_sharded()
        ids_h = self._ids.cpu().numpy()
        keys_h = self._keys.cpu().numpy()
        live_old = np.sort(ids_h[(ids_h >= 0) & (keys_h != -2)]).astype(np.int64)
        if live_old.size == 0:
            raise ValueError("compact would empty the index — rebuild from the store instead")
        dev, cap = self.device, self.capacity
        pos = self._positions[torch.from_numpy(live_old).to(dev)].to(torch.int64)
        pos_h = pos.cpu().numpy()
        emb_rows = self._emb[pos]  # ascending old-id order
        scale_rows = None if self._scales is None else self._scales[pos]
        key_rows = torch.from_numpy(keys_h[pos_h]).to(dev)
        blk = pos_h // cap
        assign = np.where(blk < self.n_lists, blk, -1).astype(np.int64)
        spill_sel = np.flatnonzero(assign < 0)
        if spill_sel.size:
            sel = torch.from_numpy(spill_sel).to(dev)
            assign[spill_sel] = self._nearest_list(_dequant(
                emb_rows[sel], None if scale_rows is None else scale_rows[sel], self.dim))
        sizes = np.bincount(assign, minlength=self.n_lists)
        overflow = int(np.maximum(sizes - cap, 0).sum())
        spill_blocks = max(1, -(-overflow // cap))
        pids, pkeys = _pack(key_rows, torch.from_numpy(assign).to(dev), self.n_lists, cap,
                            spill_blocks)
        # _pack's ids index emb_rows, whose order is the new numbering
        at = pids.clamp(min=0).to(torch.int64)
        state = {"_emb": emb_rows[at], "_keys": pkeys, "_ids": pids,
                 "_scales": None if scale_rows is None else scale_rows[at],
                 "n": int(live_old.size), "spill": overflow, "spill_blocks": spill_blocks,
                 "_positions_cache": None, "_corpus_fp": None}
        if self._refine_corpus is not None:
            state["_refine_corpus"] = self._refine_corpus.selected(live_old)
        self.__dict__.update(state)
        return live_old

    def _compact_sharded(self) -> np.ndarray:
        """tpualign's ``_compact_sharded``: the survivors in ascending old-id
        order keep their shard and list where they sat in a list, and spill
        rows go to their globally nearest centroid's shard and list; every
        shard's tail re-sizes to the largest overflow. One gather a shard
        (device-to-device copies where a row changes shard) moves the rows
        and scales unrequantized; unused slots take the shard's own padding
        block."""
        one_process(self.mesh, "IVFIndex.compact on a mesh")
        devices, ndev = self._devices, len(self._devices)
        ll, cap = self.n_lists_local, self.capacity
        total_old = self._ids.rows_per_shard
        ids_h = self._ids.cpu().numpy()
        keys_h = self._keys.cpu().numpy()
        live_slots = np.flatnonzero((ids_h >= 0) & (keys_h != -2))
        live_slots = live_slots[np.argsort(ids_h[live_slots])].astype(np.int64)
        live_old = ids_h[live_slots].astype(np.int64)
        n_new = int(live_old.size)
        if n_new == 0:
            raise ValueError("compact would empty the index — rebuild from the store instead")
        sh, lblk = live_slots // total_old, (live_slots % total_old) // cap
        assign = np.where(lblk < ll, sh * ll + lblk, -1).astype(np.int64)
        spill_sel = np.flatnonzero(assign < 0)
        if spill_sel.size:
            assign[spill_sel] = self._nearest_list(self._rows_at(live_slots[spill_sel]))
        order = np.argsort(assign, kind="stable")
        a_sorted = assign[order]
        starts = np.searchsorted(a_sorted, np.arange(ndev * ll), side="left")
        rank = np.arange(n_new) - starts[a_sorted]
        over = rank >= cap
        sh2 = a_sorted // ll
        overflow_sh = np.bincount(sh2[over], minlength=ndev)
        spill_blocks = max(1, -(-int(overflow_sh.max()) // cap))
        total_new = (ll + 1 + spill_blocks) * cap
        dest_sorted = sh2 * total_new + (a_sorted % ll) * cap + rank
        for s in np.flatnonzero(overflow_sh):
            sel = over & (sh2 == s)
            dest_sorted[sel] = s * total_new + (ll + 1) * cap + np.arange(int(overflow_sh[s]))
        dest = np.empty(n_new, np.int64)
        dest[order] = dest_sorted
        perm = np.repeat(np.arange(ndev, dtype=np.int64) * total_old + ll * cap, total_new)
        perm[dest] = live_slots
        keys_new = np.full(ndev * total_new, -1, np.int32)
        keys_new[dest] = keys_h[live_slots]
        ids_new = np.full(ndev * total_new, -1, np.int32)
        ids_new[dest] = np.arange(n_new, dtype=np.int32)

        def moved(field: ShardedRows) -> ShardedRows:
            parts = []
            for s, dev in enumerate(devices):
                src = perm[s * total_new:(s + 1) * total_new]
                owner = src // total_old
                out = torch.empty((total_new, *field.shape[1:]), dtype=field.dtype, device=dev)
                for o in np.unique(owner):
                    sel = np.flatnonzero(owner == o)
                    rows = field.parts[o][torch.from_numpy(src[sel] - o * total_old).to(
                        field.parts[o].device)]
                    out[torch.from_numpy(sel).to(dev)] = rows.to(dev)
                parts.append(out)
            return ShardedRows(parts)

        def placed(arr: np.ndarray) -> ShardedRows:
            return ShardedRows([_tensor(arr[s * total_new:(s + 1) * total_new], dev)
                                for s, dev in enumerate(devices)])

        state = {"_emb": moved(self._emb), "_keys": placed(keys_new), "_ids": placed(ids_new),
                 "_scales": None if self._scales is None else moved(self._scales),
                 "n": n_new, "spill": int(over.sum()), "spill_blocks": spill_blocks,
                 "_positions_cache": None, "_corpus_fp": None}
        if self._refine_corpus is not None:
            state["_refine_corpus"] = self._refine_corpus.selected(live_old)
        self.__dict__.update(state)
        return live_old

    def _rows_at(self, slots: np.ndarray) -> torch.Tensor:
        """fp32 rows of the global packed ``slots`` of a sharded layout, on
        the first device, in order."""
        total = self._emb.rows_per_shard
        out = torch.empty((len(slots), self.dim), dtype=torch.float32, device=self.device)
        for s in np.unique(slots // total):
            sel = np.flatnonzero(slots // total == s)
            part = self._emb.parts[s]
            at = torch.from_numpy(slots[sel] - s * total).to(part.device)
            rows = _dequant(part[at], None if self._scales is None else self._scales.parts[s][at],
                            self.dim)
            out[torch.from_numpy(sel).to(self.device)] = rows.to(self.device)
        return out

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
        snap = self._snapshot()
        if snap.refine > 1 and k > 0 and len(queries):
            kf = min(max(k, k * snap.refine), snap.n)
            vals, idx = snap._search_encoded_raw(queries, qk, kf, n_probes)
            return _refine_rescore(queries, vals, idx, snap._refine_corpus, k)
        return snap._search_encoded_raw(queries, qk, k, n_probes)

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
        empty slots. On a mesh ``n_probes`` applies per shard (at most
        ``n_lists_local``)."""
        snap = self._snapshot()
        if snap.mesh is not None:
            return snap._sharded_search(query_embeddings, query_keys, k, n_probes)
        p = snap.n_probes if n_probes is None else min(int(n_probes), snap.n_lists)
        exact_ties = p == snap.n_lists
        q = query_embeddings.to(snap.device, torch.float32).contiguous()
        qk = query_keys.to(snap.device, torch.int32).contiguous()
        args = (q, qk, snap.centroids, snap._emb, snap._keys, snap._ids, snap._scales, k, p,
                snap.n_lists, snap.capacity, snap.spill_blocks)
        if snap._kernel_path(exact_ties, k):
            return _ivf_kernel_search(*args, int8_mxu=snap.int8_mxu)
        return _ivf_union_search(*args, snap.cluster_chunk, exact_ties)

    def _sharded_search(self, query_embeddings: torch.Tensor, query_keys: torch.Tensor, k: int,
                        n_probes: Optional[int]) -> Tuple[torch.Tensor, torch.Tensor]:
        """tpualign's ``_sharded_search_fn``: the K4 (or union) route on every
        shard this process holds, each on its device's stream, then the
        winners merged on the first device by (value desc, id asc); across
        processes, every process's winners too."""
        ll = self.n_lists_local
        p = self.n_probes if n_probes is None else min(int(n_probes), ll)
        exact_ties = p == ll
        kernel = self._kernel_path(exact_ties, k)
        q = query_embeddings.to(self.device, torch.float32).contiguous()
        qk = query_keys.to(self.device, torch.int32).contiguous()
        vals, ids = [], []
        for s in self.mesh.local_rows:
            dev = self._devices[s]
            args = (q.to(dev, non_blocking=True), qk.to(dev, non_blocking=True),
                    self.centroids.parts[s], self._emb.parts[s], self._keys.parts[s],
                    self._ids.parts[s], None if self._scales is None else self._scales.parts[s],
                    k, p, ll, self.capacity, self.spill_blocks)
            v, i = (_ivf_kernel_search(*args, int8_mxu=self.int8_mxu) if kernel
                    else _ivf_union_search(*args, self.cluster_chunk, exact_ties))
            vals.append(v.to(self.device, non_blocking=True))
            ids.append(i.to(self.device, non_blocking=True))
        vals, ids = _two_key_topk(torch.cat(vals, dim=1), torch.cat(ids, dim=1), k)
        if self.mesh.distributed:
            vals, ids = _merge_processes(self.mesh, vals, ids, k)
        return vals, ids

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
        one_process(self.mesh, "IVFIndex.calibrate on a mesh")
        s = min(int(sample), self.n)
        sel = torch.from_numpy((np.arange(s, dtype=np.int64) * self.n) // s).to(self.device)
        pos = self._positions[sel].to(torch.int64)
        if self.mesh is None:
            q = _dequant(self._emb[pos], None if self._scales is None else self._scales[pos],
                         self.dim)
            cent, shards, ll, total = self.centroids, 1, self.n_lists, len(self._ids)
        else:
            q = self._rows_at(pos.cpu().numpy())
            cent, shards = self.centroids.to(self.device), len(self._devices)
            ll, total = self.n_lists_local, self._ids.rows_per_shard
        qk = np.full(s, WILDCARD_KEY, np.int32)
        _, nbr = self.search_encoded(q.cpu().numpy(), qk, k, n_probes=self.n_lists)
        depth = _probe_depths(q, torch.from_numpy(nbr).to(self.device), cent, self._positions,
                              ll, self.capacity, shards, total).cpu().numpy()
        depths = np.sort(depth[depth >= 0])
        if depths.size == 0:
            return self.n_probes
        idx = min(int(np.ceil(recall_target * depths.size)) - 1, depths.size - 1)
        p = max(1, min(int(depths[idx]) + 1, ll))
        log.info("IVF calibration: n_probes=%d reaches recall@%d %.4f (target %.3f, %d sample "
                 "queries)", p, k, float(np.mean(depths < p)), recall_target, s)
        self.n_probes = p
        self.calibrated_target = float(recall_target)
        return p

    @property
    def _positions(self) -> torch.Tensor:
        """Packed row of each corpus id, built once (on a mesh, the row of
        the shard-major layout: ``shard * rows_per_shard + slot``)."""
        cached = getattr(self, "_positions_cache", None)
        if cached is None:
            ids = self._ids if self.mesh is None else self._ids.to(self.device)
            dest = torch.where(ids >= 0, ids, self.n).to(torch.int64)
            cached = torch.zeros(self.n + 1, dtype=torch.int32, device=self.device)
            cached[dest] = torch.arange(len(ids), dtype=torch.int32, device=self.device)
            cached = cached[:self.n]
            self._positions_cache = cached
        return cached

    # -- persistence ---------------------------------------------------------------------

    def save(self, path) -> None:
        """Write the index structure (centroids, the layout's ids and keys,
        geometry, vocab and the corpus fingerprint) in tpualign's ``.npz``
        format; the rows stay in the store. A sharded index also records
        ``ndev`` and ``n_lists_local``, and its arrays are shard-major."""
        one_process(self.mesh, "IVFIndex.save on a mesh")
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
        if self.mesh is not None:
            meta["ndev"] = len(self._devices)
            meta["n_lists_local"] = self.n_lists_local
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
        layout). A sharded artifact loads onto a ``mesh`` whose data axis
        is its shard count, each shard's rows gathered onto its device.
        Raises ValueError for an artifact of another corpus shape or
        content, a sharded artifact without such a mesh, or a one-device
        artifact with a mesh (tpualign's messages)."""
        use_mesh = _sharding_mesh(mesh)
        one_process(use_mesh, "IVFIndex.load on a mesh")
        z = np.load(path)
        meta = json.loads(bytes(z["meta"]).decode())
        saved_ndev = meta.get("ndev")
        if saved_ndev is None and use_mesh is not None:
            raise ValueError("artifact is single-device; rebuild to shard it over a mesh")
        if saved_ndev is not None and (use_mesh is None
                                       or use_mesh.shape["data"] != saved_ndev):
            raise ValueError(f"artifact is sharded over {saved_ndev} devices; pass a mesh with "
                             f"a data axis of {saved_ndev}")
        dev = resolve_device(device) if use_mesh is None else use_mesh.home
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
        self.mesh = use_mesh
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
        centroids = np.asarray(z["centroids"], np.float32)
        pids, pkeys = np.asarray(z["pids"], np.int32), np.asarray(z["pkeys"], np.int32)
        scales = None
        if prequantized:
            if corpus_scales is None:
                raise ValueError(f"{'int8' if corpus.dtype == np.int8 else 'packed'} corpus "
                                 f"needs corpus_scales")
            if corpus.dtype == np.int8 and self.precision != "int8":
                raise ValueError("fp32 index cannot load an int8 corpus")
            if corpus.dtype == np.uint8 and self.precision not in ("int4", "int2"):
                raise ValueError(f"{self.precision} index cannot load a packed corpus")
            rows, scales = corpus, np.asarray(corpus_scales, np.float32).reshape(-1)
        elif self.precision in _QUANTIZERS:
            rows, scales = _QUANTIZERS[self.precision](np.asarray(corpus, np.float32))
        else:
            rows = np.asarray(corpus, np.float32)
        if use_mesh is None:
            self.centroids = torch.from_numpy(centroids).to(dev)
            self._ids, self._keys = _tensor(pids, dev), _tensor(pkeys, dev)
            self._emb, self._scales = self._gather(
                _tensor(rows, dev), None if scales is None else _tensor(scales, dev))
            return self
        # each shard's slots gather their rows (any shard's: adds route
        # rows across shards) from the host corpus onto the shard's device
        self._devices = use_mesh.data_devices
        self.n_lists_local = meta["n_lists_local"]
        ndev = len(self._devices)
        fields: Dict[str, list] = {"centroids": [], "_ids": [], "_keys": [], "_emb": [],
                                   "_scales": []}
        for s, d in enumerate(self._devices):
            ids = pids[s * len(pids) // ndev:(s + 1) * len(pids) // ndev]
            at = np.maximum(ids, 0)
            fields["centroids"].append(_tensor(centroids[s * self.n_lists_local:
                                                         (s + 1) * self.n_lists_local], d))
            fields["_ids"].append(_tensor(ids, d))
            fields["_keys"].append(_tensor(pkeys[s * len(pids) // ndev:
                                                 (s + 1) * len(pids) // ndev], d))
            fields["_emb"].append(_tensor(rows[at], d))
            fields["_scales"].append(None if scales is None else _tensor(scales[at], d))
        for name, parts in fields.items():
            setattr(self, name, None if parts[0] is None else ShardedRows(parts))
        return self

    @property
    def memory_bytes(self) -> int:
        """Device bytes: packed rows, scales, keys, ids and centroids."""
        total = self._emb.shape[0]
        row = {"int8": self.dim, "int4": self.dim // 2, "int2": self.dim // 4}.get(
            self.precision, self.dim * 4)
        scale = 0 if self.precision == "fp32" else 4
        return total * (row + 8 + scale) + self.n_lists * self.dim * 4


def _sharding_mesh(mesh):
    """``mesh`` where its data axis is above 1 (the sharded index), else
    None: a one-device mesh is no mesh, as tpualign keeps it."""
    devices = shard_devices(mesh)
    return mesh if devices is not None and len(devices) > 1 else None
