"""Exact and quantized same-page similarity search on one device (the
port's ``tpualign.parallel.retrieval``).

The corpus and its (manual, page) keys move to the device once, at
construction; each search moves only the query block there and the
``(Q, k)`` winners back. Ties rank by ascending corpus index, exactly.
Searches with ``k <= 128`` go through the fused kernels
(``tpualign_torch.ops.sim_topk``): K2 over an fp32 corpus, K3 over an
int8, packed-int4 or packed-int2 one (``precision=``). Larger ``k`` takes
the dense route, the plain version of the same kernel in query slabs that
bound the score matrix. Both routes give the same results.

``refine=R`` with a quantized precision over-fetches ``k*R`` candidates and
rescores them exactly, in float64 on the host, from a :class:`_RefineCorpus`
(RAM, fp16, or a disk memmap), as FAISS's refine stage does.
``recall_target`` keeps tpualign's meaning off the TPU: there
``jax.lax.approx_max_k`` lowers to an exact top-k, and so the port's top-k
is exact too. ``build_index`` also builds the IVF index
(``tpualign_torch.parallel.ivf``). Meshes, HNSW and add/remove/compact are
later slices.
"""

from __future__ import annotations

import os
import re
import tempfile
import weakref
from typing import Dict, Optional, Sequence, Tuple

import numpy as np
import torch

from tpualign_torch.ops.sim_topk import MAX_K, masked_sim_topk, masked_sim_topk_reference
from tpualign_torch.ops.similarity import NEG_INF, WILDCARD_KEY
from tpualign_torch.utils.device import resolve_device
from tpualign_torch.utils.logging import get_logger

log = get_logger("parallel.retrieval")

__all__ = ["RetrievalIndex", "build_index", "encode_keys", "PAGE_MOD", "NONE_PAGE",
           "WILDCARD_KEY"]

# (manual, page) packing: key = manual_code * PAGE_MOD + page_code. Real
# pages sit in [0, NONE_PAGE); page None encodes as NONE_PAGE, so None
# matches only None. Negative keys are reserved: -1 corpus padding, -2
# query padding (match nothing), -3 the query-side wildcard.
PAGE_MOD = 100_000
NONE_PAGE = PAGE_MOD - 1

# bytes of the (Q, N) score matrix and its sort that one dense slab may take
DENSE_SLAB_BYTES = 2 * 1024**3

# tpualign's beyond-HBM bound: past this (Q, N) fp32 score footprint its
# refine over-fetch is clamped to REFINE_MAX_STREAM_K; the port clamps at
# the same point so that both return the same candidates
STREAM_ONLY_SIM_BYTES = 4 * 1024**3
REFINE_MAX_STREAM_K = 64

_QUANTIZED = ("int8", "int4", "int2")


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


# -- quantizers (numpy, bit-identical to tpualign's) ------------------------


def _quantize_rows(x: np.ndarray):
    """Symmetric per-row int8 quantization: values in [-127, 127] plus an
    fp32 scale per row (dequantized dot = int32 accumulate x both scales)."""
    scale = np.abs(x).max(axis=1, keepdims=True) / 127.0
    scale = np.maximum(scale, 1e-12)
    q = np.clip(np.rint(x / scale), -127, 127).astype(np.int8)
    return q, scale.astype(np.float32)[:, 0]


def _quantize_rows_int4(x: np.ndarray):
    """Packed int4 quantization: per-row symmetric 4-bit values in [-7, 7],
    two per byte with offset-8 nibbles; LOW nibbles hold dims [0, D/2),
    HIGH nibbles [D/2, D). Requires even D. Returns ((N, D/2) uint8,
    (N,) fp32 scales)."""
    n, d = x.shape
    if d % 2:
        raise ValueError(f"int4 packing needs even embedding dim, got {d}")
    scale = np.abs(x).max(axis=1, keepdims=True) / 7.0
    scale = np.maximum(scale, 1e-12)
    q = np.clip(np.rint(x / scale), -7, 7).astype(np.int16) + 8  # [1, 15]
    packed = (q[:, : d // 2] | (q[:, d // 2:] << 4)).astype(np.uint8)
    return packed, scale.astype(np.float32)[:, 0]


def _quantize_rows_int2(x: np.ndarray):
    """Packed int2 quantization: per-row symmetric 4-level values in
    {-3, -1, +1, +3} scaled by s/3 (s = row max-abs), four codes per byte;
    plane p (bits [2p, 2p+1]) holds dims [p*D/4, (p+1)*D/4). Requires
    D % 4 == 0. Returns ((N, D/4) uint8, (N,) fp32 scales where dequant =
    v * scale)."""
    n, d = x.shape
    if d % 4:
        raise ValueError(f"int2 packing needs embedding dim divisible by 4, got {d}")
    s = np.maximum(np.abs(x).max(axis=1, keepdims=True), 1e-12)
    # nearest level in {-3,-1,1,3} of y = 3x/s: code = round((y+3)/2)
    code = np.clip(np.rint((x / s * 3.0 + 3.0) / 2.0), 0, 3).astype(np.uint8)
    q4 = d // 4
    packed = (
        code[:, :q4]
        | (code[:, q4: 2 * q4] << 2)
        | (code[:, 2 * q4: 3 * q4] << 4)
        | (code[:, 3 * q4:] << 6)
    ).astype(np.uint8)
    return packed, (s / 3.0).astype(np.float32)[:, 0]


_QUANTIZERS = {"int8": _quantize_rows, "int4": _quantize_rows_int4, "int2": _quantize_rows_int2}


def _tensor(arr: np.ndarray, device: torch.device) -> torch.Tensor:
    """``arr`` on ``device``; a read-only array (a store's memmap) is copied
    first, since torch tensors are writable."""
    return torch.from_numpy(np.require(arr, requirements=["C", "W"])).to(device)


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


# -- refine -------------------------------------------------------------------


def _refine_rescore(
    queries: np.ndarray,
    vals: np.ndarray,
    idx: np.ndarray,
    host_corpus: "Optional[_RefineCorpus]",
    k: int,
) -> Tuple[np.ndarray, np.ndarray]:
    """Exact rescoring of first-stage candidates (FAISS's refine stage).

    ``idx`` is (Q, C >= k) candidate corpus positions; with ``host_corpus``
    every valid candidate is rescored in float64 (so the order of
    near-ties does not depend on a summation order) and rounded to fp32,
    then candidates re-rank by (value desc, index asc) and trim to ``k``.
    Recall stays bounded by the first stage; the ranking inside the
    candidates becomes exact.
    """
    if host_corpus is not None and idx.size:
        safe = np.clip(idx, 0, len(host_corpus) - 1).astype(np.int64)
        rows = host_corpus.take(safe)  # (Q, C, D) fp32
        exact = np.einsum(
            "qd,qcd->qc", np.asarray(queries, np.float64),
            rows.astype(np.float64),
        ).astype(np.float32)
        vals = np.where(idx >= 0, exact, NEG_INF).astype(np.float32)
    # two stable argsorts = lexicographic (value desc, index asc); invalid
    # slots carry NEG_INF values so they sort last regardless of index
    key_idx = np.where(idx >= 0, idx, np.iinfo(np.int64).max)
    o1 = np.argsort(key_idx, axis=1, kind="stable")
    v1 = np.take_along_axis(vals, o1, axis=1)
    i1 = np.take_along_axis(idx, o1, axis=1)
    o2 = np.argsort(-v1, axis=1, kind="stable")
    v2 = np.take_along_axis(v1, o2, axis=1)[:, :k]
    i2 = np.take_along_axis(i1, o2, axis=1)[:, :k]
    v2, i2 = _pad_results(v2, i2, k)
    return _sentinel(v2, i2)


# The rescore rows live on the host (zero device memory). Storage modes:
# "ram" fp32 ndarray; "fp16" half the RAM (the rescore is exact over the
# fp16-rounded rows); "memmap" fp32 rows in a disk file, mapped read-only
# (~0 resident, bit-identical to "ram"); "memmap16" fp16 rows on disk;
# "auto" ram below REFINE_RAM_MAX_BYTES, memmap above. Knobs:
# RETRIEVAL_REFINE_STORE (mode) and RETRIEVAL_REFINE_DIR (memmap directory,
# default the system temp dir).
REFINE_STORE_MODES = ("auto", "ram", "fp16", "memmap", "memmap16")
REFINE_RAM_MAX_BYTES = 2 << 30
_REFINE_WRITE_CHUNK = 1 << 18  # rows per chunked memmap copy slice


def _refine_store_mode(store: Optional[str]) -> str:
    mode = store or os.environ.get("RETRIEVAL_REFINE_STORE") or "auto"
    if mode not in REFINE_STORE_MODES:
        raise ValueError(f"refine store must be one of {REFINE_STORE_MODES}, got {mode!r}")
    return mode


def _unlink_quiet(path: str) -> None:
    try:
        os.unlink(path)
    except OSError:
        pass


# memmap files carry the creating PID in their name, so a later process can
# tell orphans (creator dead, e.g. killed before its finalizer ran) from
# files a live process still maps
_REFINE_FILE_RE = re.compile(r"tpualign_refine_(\d+)_")
_swept_refine_dirs: set = set()


def _pid_alive(pid: int) -> bool:
    try:
        os.kill(pid, 0)
    except ProcessLookupError:
        return False
    except PermissionError:
        return True  # exists, owned by someone else
    return True


def _sweep_stale_refine_files(dirpath: str) -> int:
    """Unlink refine memmaps in ``dirpath`` whose creating process is dead.
    Files of a live PID, or not named by the scheme, stay."""
    removed = 0
    try:
        names = os.listdir(dirpath)
    except OSError:
        return 0
    for name in names:
        m = _REFINE_FILE_RE.match(name)
        if not m:
            continue
        pid = int(m.group(1))
        if pid == os.getpid() or _pid_alive(pid):
            continue
        path = os.path.join(dirpath, name)
        try:
            size = os.path.getsize(path)
        except OSError:
            size = 0
        _unlink_quiet(path)
        removed += 1
        log.info("reclaimed stale refine memmap %s (%.1f GB; creator pid %d is dead)",
                 path, size / 2**30, pid)
    return removed


def _sweep_once() -> str:
    """The memmap directory, swept of orphans on its first use."""
    dirpath = os.environ.get("RETRIEVAL_REFINE_DIR") or tempfile.gettempdir()
    if dirpath not in _swept_refine_dirs:
        _swept_refine_dirs.add(dirpath)
        _sweep_stale_refine_files(dirpath)
    return dirpath


class _MemmapFile:
    """A read-only row file (fp32 or fp16), unlinked when the last
    snapshot referencing it is garbage-collected."""

    def __init__(self, path: str, n: int, dim: int, dtype=np.float32):
        self.path = path
        self.arr = np.memmap(path, dtype, mode="r", shape=(n, dim))
        self._finalizer = weakref.finalize(self, _unlink_quiet, path)


def _write_refine_memmap(n: int, dim: int, get_rows, dtype=np.float32) -> _MemmapFile:
    """Stream rows into a fresh memmap file in bounded-RAM chunks;
    ``get_rows(start, stop)`` returns that fp32 slice."""
    dirpath = _sweep_once()
    os.makedirs(dirpath, exist_ok=True)
    fd, path = tempfile.mkstemp(
        prefix=f"tpualign_refine_{os.getpid()}_",
        suffix=".f16" if dtype == np.float16 else ".f32", dir=dirpath,
    )
    os.close(fd)
    mm = np.memmap(path, dtype, mode="w+", shape=(n, dim))
    try:
        for s in range(0, n, _REFINE_WRITE_CHUNK):
            e = min(n, s + _REFINE_WRITE_CHUNK)
            mm[s:e] = get_rows(s, e)
        mm.flush()
    except BaseException:
        # a failed write must not orphan the file
        del mm
        _unlink_quiet(path)
        raise
    del mm  # drop the writable mapping before the read-only one opens
    return _MemmapFile(path, n, dim, dtype)


class _RefineCorpus:
    """Host rows backing the refine rescore (see the storage notes above).
    Immutable; the port's index builds it once and never mutates it."""

    __slots__ = ("mode", "dim", "_base", "_file", "__weakref__")

    def __init__(self, mode: str, base, file=None):
        self.mode = mode
        self._base = base
        self._file = file
        self.dim = int(base.shape[1])

    @classmethod
    def build(cls, rows, store: Optional[str] = None) -> "_RefineCorpus":
        mode = _refine_store_mode(store)
        # reclaim orphans on every first build, whatever mode this lands on
        _sweep_once()
        rows = np.asarray(rows)
        if rows.ndim != 2:
            rows = rows.reshape(0, 1 if rows.size == 0 else rows.size)
        if mode == "auto":
            mode = ("ram" if rows.shape[0] * rows.shape[1] * 4 <= REFINE_RAM_MAX_BYTES
                    else "memmap")
        if mode.startswith("memmap") and rows.shape[0] == 0:
            # a 0-byte file cannot be memmapped
            mode = "fp16" if mode == "memmap16" else "ram"
        if mode == "fp16":
            return cls("fp16", np.asarray(rows, np.float32).astype(np.float16))
        if mode.startswith("memmap"):
            dt = np.float16 if mode == "memmap16" else np.float32
            f = _write_refine_memmap(rows.shape[0], rows.shape[1],
                                     lambda s, e: np.asarray(rows[s:e], np.float32), dtype=dt)
            log.info("refine corpus: %d x %d %s memmapped at %s (%.1f GB on disk, ~0 resident)",
                     rows.shape[0], rows.shape[1], np.dtype(dt).name, f.path,
                     rows.shape[0] * rows.shape[1] * np.dtype(dt).itemsize / 2**30)
            return cls(mode, f.arr, f)
        return cls("ram", np.array(rows, np.float32))

    def __len__(self) -> int:
        return int(self._base.shape[0])

    @property
    def nbytes_resident(self) -> int:
        """Host RAM pinned by this corpus (memmap pages ride the OS cache)."""
        return 0 if self.mode.startswith("memmap") else int(self._base.nbytes)

    def take(self, idx) -> np.ndarray:
        """Gather rows as fp32; ``idx`` keeps its shape + (D,)."""
        idx = np.asarray(idx, np.int64)
        out = np.asarray(self._base[idx.reshape(-1)], np.float32)
        return out.reshape(idx.shape + (self.dim,))


def _setup_refine(refine: int, precision: str, fp32_rows, keep_on_fp32: bool = False,
                  store: Optional[str] = None, prequantized: bool = False):
    """Validate the refine factor and build the host rescore corpus.
    Returns ``(refine, corpus_or_None)``: refine comes back 0 when there is
    nothing to refine (an exact fp32 first stage), and ``keep_on_fp32``
    keeps the factor with no copy when the first stage is approximate but
    exactly scored (recall_target over-fetch). A ``prequantized`` corpus
    (an IVF build from int8 or packed rows) has no fp32 rows to rescore
    with, and refine raises there."""
    if refine < 0:
        raise ValueError(f"refine must be a factor >= 0, got {refine}")
    refine = int(refine)
    _refine_store_mode(store)  # validate even when unused this call
    if refine <= 1:
        return refine, None
    if precision in _QUANTIZED:
        if prequantized:
            raise ValueError("refine needs fp32 rows for the exact rescore; this build received "
                             "a pre-quantized corpus — build from fp32 rows or drop refine")
        return refine, _RefineCorpus.build(fp32_rows, store)
    if keep_on_fp32:
        return refine, None
    log.warning("refine=%d on an exact fp32 index is a no-op (the first stage is "
                "already exact); disabling", refine)
    return 0, None


# -- the index ------------------------------------------------------------------


class RetrievalIndex:
    """Device-resident index over a chunk corpus, exact at fp32 and over
    per-row-quantized scores at int8/int4/int2.

    ``search(query_embs, query_manuals, query_pages, k)`` ranks, for each
    query, the corpus rows of the same manual and page (or every row, with
    ``global_search``). ``device`` defaults to CUDA and raises when it is
    absent; pass ``device="cpu"`` for the plain path. ``mesh`` is a later
    slice (multi-GPU) and raises.
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
        if mesh is not None:
            raise NotImplementedError(
                "RetrievalIndex(mesh=...) is the multi-GPU slice of tpualign_torch, "
                "not yet ported; build the index on one device")
        if precision not in ("fp32",) + _QUANTIZED:
            raise ValueError(f"precision must be fp32, int8, int4 or int2, got {precision!r}")
        if recall_target is not None and not 0.0 < recall_target <= 1.0:
            raise ValueError(f"recall_target must be in (0, 1], got {recall_target}")
        self.device = resolve_device(device)
        self.precision = precision
        self.recall_target = recall_target
        corpus = np.asarray(corpus_embeddings, np.float32)
        self.vocab: Dict[str, int] = {}
        keys, self.vocab = encode_keys(corpus_manuals, corpus_pages, self.vocab)
        self.n = len(corpus)
        self.dim = corpus.shape[1] if corpus.ndim == 2 else 0
        self.refine, self._refine_corpus = _setup_refine(
            refine, precision, corpus, keep_on_fp32=recall_target is not None,
            store=refine_store)
        self._corpus = self._keys = self._corpus_scales = None
        if self.n == 0:
            return
        if precision in _QUANTIZED:
            codes, scales = _QUANTIZERS[precision](corpus)
            self._corpus = _tensor(codes, self.device)
            self._corpus_scales = _tensor(scales, self.device)
        else:
            self._corpus = _tensor(corpus, self.device)
        self._keys = _tensor(keys, self.device)

    # -- mutations: a later slice ------------------------------------------------

    def add(self, embeddings, manuals=None, pages=None) -> None:
        raise NotImplementedError("RetrievalIndex.add is not yet ported to tpualign_torch "
                                  "(the index-mutation slice); rebuild the index")

    def remove(self, corpus_indices) -> int:
        raise NotImplementedError("RetrievalIndex.remove is not yet ported to tpualign_torch "
                                  "(the index-mutation slice); rebuild the index")

    def compact(self) -> np.ndarray:
        raise NotImplementedError("RetrievalIndex.compact is not yet ported to tpualign_torch "
                                  "(the index-mutation slice); rebuild the index")

    # -- search --------------------------------------------------------------------

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
        return self._search_encoded(queries, qk, k, strategy)

    def search_encoded(self, queries: np.ndarray, qk: np.ndarray, k: int,
                       strategy: str = "auto") -> Tuple[np.ndarray, np.ndarray]:
        """Host-array search with pre-encoded int32 keys (see
        :func:`encode_keys`; WILDCARD_KEY = unrestricted). The serving
        coalescer batches concurrent requests at this level."""
        return self._search_encoded(queries, qk, k, strategy)

    def search_device(self, query_embeddings: torch.Tensor, query_keys: torch.Tensor,
                      k: int, strategy: str = "auto") -> Tuple[torch.Tensor, torch.Tensor]:
        """Device-resident search: takes and returns tensors on the index's
        device. Returns ``(vals (Q, min(k, n)) fp32, idx int32)``, where
        slots without a candidate hold ``(NEG_INF, SENTINEL_IDX)``."""
        self._check_strategy(strategy)
        kk = min(k, self.n)
        q = query_embeddings.to(self.device, torch.float32).contiguous()
        qk = query_keys.to(self.device, torch.int32).contiguous()
        scored = dict(corpus_scales=self._corpus_scales, int8_mxu=True)
        if kk <= MAX_K:
            return masked_sim_topk(q, qk, self._corpus, self._keys, kk, **scored)
        # dense route, in query slabs that bound the (Q, N) matrix and its sort
        slab = max(1, DENSE_SLAB_BYTES // (16 * self.n))
        parts = [masked_sim_topk_reference(q[s:s + slab], qk[s:s + slab],
                                           self._corpus, self._keys, kk, **scored)
                 for s in range(0, len(q), slab)]
        return torch.cat([p[0] for p in parts]), torch.cat([p[1] for p in parts])

    @staticmethod
    def _check_strategy(strategy: str) -> None:
        if strategy in ("ring", "streaming"):
            raise NotImplementedError(f"strategy={strategy!r} needs a mesh; not yet ported")
        if strategy not in ("auto", "gather"):
            raise ValueError(f"strategy must be auto/gather/ring/streaming, got {strategy!r}")

    def _search_encoded(self, queries: np.ndarray, qk: np.ndarray, k: int,
                        strategy: str = "auto") -> Tuple[np.ndarray, np.ndarray]:
        if self.refine > 1 and self.n > 0 and k > 0:
            # over-fetch k*refine candidates from the first stage, rescore
            # them exactly on the host, trim to k
            kf = min(max(k, k * self.refine), self.n)
            if kf > REFINE_MAX_STREAM_K and 4 * len(queries) * self.n > STREAM_ONLY_SIM_BYTES:
                log.warning("refine over-fetch k*refine=%d clamped to %d, as tpualign "
                            "clamps it past %d bytes of scores", kf, REFINE_MAX_STREAM_K,
                            STREAM_ONLY_SIM_BYTES)
                kf = REFINE_MAX_STREAM_K
            # with a rescore corpus the first-stage values are never read
            vals, idx = self._search_encoded_raw(queries, qk, kf, strategy,
                                                 skip_vals=self._refine_corpus is not None)
            return _refine_rescore(queries, vals, idx, self._refine_corpus, k)
        return self._search_encoded_raw(queries, qk, k, strategy)

    def _search_encoded_raw(self, queries: np.ndarray, qk: np.ndarray, k: int,
                            strategy: str = "auto", skip_vals: bool = False
                            ) -> Tuple[np.ndarray, np.ndarray]:
        nq = len(queries)
        if nq == 0 or self.n == 0:
            return (np.full((nq, k), NEG_INF, np.float32),
                    np.full((nq, k), -1, np.int64))
        vals, idx = self.search_device(_tensor(np.asarray(queries, np.float32), self.device),
                                       _tensor(np.asarray(qk, np.int32), self.device), k,
                                       strategy)
        idx = idx.cpu().numpy().astype(np.int64)
        idx = np.where(idx >= self.n, -1, idx)
        if skip_vals:
            # every empty slot carries SENTINEL_IDX (>= n), so the indices
            # alone say which slots hold a candidate: fetch half the bytes
            vals = np.where(idx >= 0, 0.0, NEG_INF).astype(np.float32)
        else:
            vals = vals.cpu().numpy()
        vals, idx = _pad_results(vals, idx, k)
        return _sentinel(vals, idx)


def build_index(
    corpus_embeddings: np.ndarray,
    corpus_manuals: Sequence[str],
    corpus_pages: Sequence[Optional[int]],
    mesh=None,
    precision: str = "fp32",
    recall_target: Optional[float] = None,
    index_type: str = "exact",
    ivf_lists: Optional[int] = None,
    ivf_probes: Optional[int] = None,
    ivf_cache: Optional[str] = None,
    refine: int = 0,
    refine_store: Optional[str] = None,
    hnsw_m: int = 16,
    hnsw_ef_construction: int = 64,
    hnsw_ef_search: Optional[int] = None,
    hnsw_cache: Optional[str] = None,
    device: str | torch.device = "cuda",
):
    """Index factory honoring the ``RETRIEVAL_INDEX`` knob, with tpualign's
    signature. ``"exact"`` builds a :class:`RetrievalIndex`; ``refine`` and
    ``refine_store`` (the ``RETRIEVAL_REFINE``/``RETRIEVAL_REFINE_STORE``
    knobs) set its refine stage. ``"ivf"`` builds an
    :class:`~tpualign_torch.parallel.ivf.IVFIndex` with ``ivf_lists`` and
    ``ivf_probes``; ``ivf_cache`` (``IVF_CACHE``) is its artifact: loaded
    when it matches the corpus and precision (and recalibrated and saved
    again when ``recall_target`` changed), else built, calibrated to
    ``recall_target`` unless ``ivf_probes`` is set, and saved. An empty
    corpus serves the exact index. ``"hnsw"`` is a later slice of the port
    and raises ``NotImplementedError``; its arguments are accepted."""
    if index_type == "ivf" and len(corpus_embeddings) == 0:
        # an empty schema serves the exact index, as tpualign does
        index_type = "exact"
    if index_type == "ivf":
        return _build_ivf(corpus_embeddings, corpus_manuals, corpus_pages, mesh, precision,
                          recall_target, ivf_lists, ivf_probes, ivf_cache, refine,
                          refine_store, device)
    if index_type == "hnsw":
        raise NotImplementedError(
            "RETRIEVAL_INDEX=hnsw is not yet ported to tpualign_torch (the HNSW slice); "
            "use RETRIEVAL_INDEX=exact or ivf")
    if index_type != "exact":
        raise ValueError(f"retrieval_index must be 'exact', 'ivf' or 'hnsw', got {index_type!r}")
    return RetrievalIndex(
        corpus_embeddings, corpus_manuals, corpus_pages, mesh=mesh,
        precision=precision, recall_target=recall_target, refine=refine,
        refine_store=refine_store, device=device,
    )


def _build_ivf(corpus_embeddings, corpus_manuals, corpus_pages, mesh, precision, recall_target,
               ivf_lists, ivf_probes, ivf_cache, refine, refine_store, device):
    """``build_index``'s IVF branch, tpualign's: the artifact first, a build
    when it is missing or unusable."""
    from tpualign_torch.parallel.ivf import IVFIndex

    if ivf_cache and os.path.exists(ivf_cache):
        try:
            loaded = IVFIndex.load(ivf_cache, corpus_embeddings, refine=refine, mesh=mesh,
                                   refine_store=refine_store, device=device)
            if loaded.precision != precision:
                raise ValueError(f"cache precision {loaded.precision} != requested {precision}")
            if (recall_target is not None and ivf_probes is None
                    and getattr(loaded, "calibrated_target", None) != recall_target):
                # the target changed since the artifact was written
                loaded.calibrate(recall_target)
                loaded.save(ivf_cache)
            return loaded
        except Exception as e:  # a stale or mismatched artifact: rebuild
            log.warning("IVF cache %s unusable (%s); rebuilding", ivf_cache, e)
    index = IVFIndex(corpus_embeddings, corpus_manuals, corpus_pages, n_lists=ivf_lists,
                     n_probes=ivf_probes, precision=precision, mesh=mesh, refine=refine,
                     refine_store=refine_store, device=device)
    if recall_target is not None and ivf_probes is None:
        # RETRIEVAL_RECALL_TARGET means "this recall, whatever the index":
        # the smallest probe count that meets it
        index.calibrate(recall_target)
    if ivf_cache:
        index.save(ivf_cache)
        log.info("IVF index structure cached to %s", ivf_cache)
    return index
