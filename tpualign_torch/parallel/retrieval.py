"""Exact and quantized same-page similarity search, on one device or
sharded over a mesh's data axis (the port's ``tpualign.parallel.retrieval``).

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
(``tpualign_torch.parallel.ivf``) and the host HNSW graph
(``tpualign_torch.parallel.hnsw``).

The corpus, its keys and scales are
:class:`~tpualign_torch.parallel.mesh.ShardedRows`: one shard on one
device, and on a mesh (``parallel/mesh.py``) with a data axis above 1 one
shard a data device, each padded to ``n_local = ceil(N / shards)`` rows
(pad rows keyed -1). A search over several shards runs K2 or
K3 on every shard at ``min(k, n_local)``, the shard's winners offset by
``shard * n_local``, copies the winners to the first device and merges
them there by (value desc, index asc) with two stable sorts, exact at any
scale. The strategies are tpualign's: "gather" and "streaming" both run
the kernel per shard (tpualign's gather is a dense XLA top-k, exact off the
TPU, so the two coincide in the port), and "ring" (``parallel/ring.py``)
shards the queries too and moves each block with its running top-k from
card to card. ``_pick_strategy`` is tpualign's router, with "on the card"
for its "on a TPU"; ``ring`` over a quantized corpus warns once and runs
gather. Growth keeps whole shards: an add past the capacity re-splits the
rows into larger shards, and ``compact`` re-splits the survivors evenly.
On a mesh across processes (``parallel/multihost.py``) every process is
given the whole corpus and keeps only its own rows' shards; gather and
streaming merge each process's winners, then all-gather every process's
``(Q, k)`` winners and merge them again, so that every process holds the
global answer; the ring hands a block from the last card of one process to
the first of the next point to point. Every process applies the same
mutations with the same arguments: each writes only its own shards' rows,
keys and scales, the tombstone counts are summed over the processes, and
where rows change shard (growth past the capacity, ``compact``) an old
shard that another process's new shard takes rows from is broadcast, one
shard at a time, and each process takes its new shards' rows.

``add``, ``remove`` and ``compact`` change the corpus in place of a
rebuild, as pgvector's INSERT, DELETE and VACUUM do: appended rows take the
next ids (capacity grows by ``GROWTH``, its slack rows keyed -1), removed
rows are keyed -2 (tombstones no query matches), and ``compact`` drops both
and renumbers the survivors in ascending old-id order. Every mutation is
copy-on-write: it builds new key tensors (rows are written in place only
into capacity slack, which every older key tensor masks) and swaps its
fields in with one ``__dict__`` update; a search works on a shallow copy
taken in one step (:meth:`RetrievalIndex._snapshot`), so it sees the corpus
before or after a mutation, never a mix.
"""

from __future__ import annotations

import copy
import os
import re
import tempfile
import weakref
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from tpualign_torch.ops.sim_topk import (
    MAX_K, SENTINEL_IDX, masked_sim_topk, masked_sim_topk_reference)
from tpualign_torch.ops.similarity import NEG_INF, WILDCARD_KEY
from tpualign_torch.parallel.mesh import ShardedRows, shard_devices
from tpualign_torch.utils.device import resolve_device
from tpualign_torch.utils.logging import get_logger

log = get_logger("parallel.retrieval")

__all__ = ["RetrievalIndex", "build_index", "encode_keys", "sharded_topk_search", "PAGE_MOD",
           "NONE_PAGE", "WILDCARD_KEY"]

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


def _round_up(x: int, m: int) -> int:
    return -(-x // m) * m


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


# -- search on one device, and the pieces of the sharded search ----------------


def _device_topk(q: torch.Tensor, qk: torch.Tensor, corpus: torch.Tensor, keys: torch.Tensor,
                 scales: Optional[torch.Tensor], k: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """One device's masked top-k over its rows: K2 (fp32) or K3 (with
    ``scales``; int8 as s8, as tpualign routes on a TPU) for ``k <= 128``,
    else the dense route, the plain version in query slabs that bound the
    (Q, N) matrix and its sort. Slots without a candidate hold
    ``(NEG_INF, SENTINEL_IDX)``."""
    scored = dict(corpus_scales=scales, int8_mxu=True)
    if k <= MAX_K:
        return masked_sim_topk(q, qk, corpus, keys, k, **scored)
    slab = max(1, DENSE_SLAB_BYTES // (16 * int(corpus.shape[0])))
    parts = [masked_sim_topk_reference(q[s:s + slab], qk[s:s + slab], corpus, keys, k, **scored)
             for s in range(0, len(q), slab)]
    return torch.cat([p[0] for p in parts]), torch.cat([p[1] for p in parts])


def _two_key_topk(vals: torch.Tensor, idx: torch.Tensor, k: int):
    """Exact top-k along the last dimension by (value desc, index asc): a
    stable sort by index, then a stable descending sort by value
    (tpualign's lexicographic ``lax.sort`` on ``(-value, index)``)."""
    by_idx = torch.sort(idx, dim=-1, stable=True).indices
    vals, idx = vals.gather(-1, by_idx), idx.gather(-1, by_idx)
    by_val = torch.sort(vals, dim=-1, descending=True, stable=True).indices[..., :k]
    return vals.gather(-1, by_val), idx.gather(-1, by_val)


def _merge_processes(mesh, vals: torch.Tensor, idx: torch.Tensor, k: int):
    """The winners of every process of ``mesh`` (equal widths), gathered on
    this process's home device and merged by (value desc, index asc): the
    global top-k, the same on every process."""
    from tpualign_torch.parallel.multihost import process_gather

    return _two_key_topk(torch.cat(process_gather(mesh, vals), dim=-1),
                         torch.cat(process_gather(mesh, idx), dim=-1), k)


def _offset(idx: torch.Tensor, offset: int) -> torch.Tensor:
    """A shard's local winners as global corpus indices; the empty slots
    keep SENTINEL_IDX."""
    return torch.where(idx >= SENTINEL_IDX, idx, idx + offset)


def _padded(rows: np.ndarray, n: int, fill) -> np.ndarray:
    """``rows`` with ``fill`` rows after them up to ``n``."""
    if len(rows) >= n:
        return rows
    return np.concatenate([rows, np.full((n - len(rows), *rows.shape[1:]), fill, rows.dtype)])


def _process_rows(sharded: ShardedRows, mesh) -> torch.Tensor:
    """Every shard of ``sharded`` across the processes of ``mesh``, whole on
    this process's home device (one all-gather: each process holds as many
    shards, and the processes hold the rows in order)."""
    from tpualign_torch.parallel.multihost import process_gather

    own = torch.cat([p.to(mesh.home) for p in sharded.parts if p is not None])
    return torch.cat(process_gather(mesh, own))


def _select_rows(sharded: ShardedRows, sel: np.ndarray, n_local: int,
                 fill, mesh=None) -> ShardedRows:
    """New shards of ``n_local`` rows on the same devices holding the rows
    at global positions ``sel`` (ascending), in order, and ``fill`` after
    them: growth (``sel`` every live position) and compaction (the
    survivors). Rows move between cards as device-to-device copies; on a
    ``mesh`` across processes each process builds only its own new shards,
    and an old shard that a new shard of another process takes rows from is
    broadcast by its process, one shard at a time."""
    across = mesh is not None and mesh.distributed
    devices = mesh.data_devices if across else sharded.devices
    old, shards = sharded.rows_per_shard, len(devices)
    # per new shard: the old shards it takes rows from, ascending, and the rows
    takes = []
    for s in range(shards):
        chunk = sel[s * n_local:(s + 1) * n_local]
        owner = chunk // old
        takes.append({int(o): chunk[owner == o] - o * old for o in np.unique(owner)})
    pieces: List[list] = [[] for _ in range(shards)]
    for o in range(shards):
        users = [s for s in range(shards) if o in takes[s]]
        src = sharded.parts[o]
        if across and any(mesh.processes[s] != mesh.processes[o] for s in users):
            from tpualign_torch.parallel.multihost import process_broadcast

            src = process_broadcast(mesh, src, (old, *sharded.shape[1:]), sharded.dtype,
                                    mesh.processes[o])
        for s in users:
            if across and not mesh.is_local(s):
                continue
            at = torch.from_numpy(takes[s][o]).to(src.device)
            pieces[s].append(src[at].to(devices[s]))
    parts = []
    for s, dev in enumerate(devices):
        if across and not mesh.is_local(s):
            parts.append(None)
            continue
        filled = sum(len(rows) for rows in takes[s].values())
        if filled < n_local:
            pieces[s].append(torch.full((n_local - filled, *sharded.shape[1:]), fill,
                                        dtype=sharded.dtype, device=dev))
        parts.append(torch.cat(pieces[s]))
    return ShardedRows(parts)


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
    Immutable: ``appended`` and ``selected`` return new corpora, so a search
    keeps rescoring against the snapshot it captured. memmap snapshots share
    one file; appends go to a RAM tail (fp32, or fp16 for ``memmap16``);
    ``selected`` streams the selection into a fresh file."""

    __slots__ = ("mode", "dim", "_base", "_tail", "_file", "__weakref__")

    def __init__(self, mode: str, base, tail=None, file=None):
        self.mode = mode
        self._base = base
        self._tail = tail
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
            return cls(mode, f.arr, None, f)
        return cls("ram", np.array(rows, np.float32))

    def __len__(self) -> int:
        return int(self._base.shape[0]) + (0 if self._tail is None else int(self._tail.shape[0]))

    @property
    def nbytes_resident(self) -> int:
        """Host RAM pinned by this corpus (memmap pages ride the OS cache)."""
        n = 0 if self.mode.startswith("memmap") else int(self._base.nbytes)
        return n + (0 if self._tail is None else int(self._tail.nbytes))

    def take(self, idx) -> np.ndarray:
        """Gather rows as fp32; ``idx`` keeps its shape + (D,)."""
        idx = np.asarray(idx, np.int64)
        flat = idx.reshape(-1)
        nb = int(self._base.shape[0])
        if self._tail is None or flat.size == 0 or int(flat.max(initial=0)) < nb:
            out = np.asarray(self._base[flat], np.float32)
        else:
            out = np.empty((flat.size, self.dim), np.float32)
            m = flat < nb
            out[m] = self._base[flat[m]]
            out[~m] = self._tail[flat[~m] - nb]
        return out.reshape(idx.shape + (self.dim,))

    def appended(self, rows) -> "_RefineCorpus":
        """This corpus with ``rows`` after its last row."""
        rows = np.asarray(rows, np.float32)
        if self.mode.startswith("memmap"):
            if self.mode == "memmap16":
                rows = rows.astype(np.float16)
            tail = rows if self._tail is None else np.concatenate([self._tail, rows])
            return _RefineCorpus(self.mode, self._base, np.ascontiguousarray(tail), self._file)
        return _RefineCorpus(self.mode, np.concatenate([self._base,
                                                        rows.astype(self._base.dtype)]))

    def selected(self, sel) -> "_RefineCorpus":
        """The rows at ``sel`` (indices or a boolean mask), in the same mode
        (``compact``'s counterpart); memmap streams into a fresh file."""
        sel = np.asarray(sel)
        if sel.dtype == bool:
            sel = np.flatnonzero(sel)
        sel = sel.astype(np.int64)
        if self.mode.startswith("memmap"):
            if sel.size == 0:
                return self.empty()
            f = _write_refine_memmap(sel.size, self.dim, lambda s, e: self.take(sel[s:e]),
                                     dtype=np.float16 if self.mode == "memmap16" else np.float32)
            return _RefineCorpus(self.mode, f.arr, None, f)
        rows = self.take(sel)
        if self.mode == "fp16":
            return _RefineCorpus("fp16", rows.astype(np.float16))
        return _RefineCorpus("ram", rows)

    def empty(self) -> "_RefineCorpus":
        """No rows, in this corpus's RAM mode."""
        mode = {"memmap": "ram", "memmap16": "fp16"}.get(self.mode, self.mode)
        return _RefineCorpus(mode, np.zeros((0, self.dim),
                                            np.float16 if mode == "fp16" else np.float32))


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
    absent; pass ``device="cpu"`` for the plain path. A ``mesh``
    (``parallel/mesh.py``) names the devices instead: with a data axis
    above 1 the corpus is sharded over it (see the module notes), and a
    mesh of one data device holds the corpus on its first device.
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
        devices = shard_devices(mesh)
        if precision not in ("fp32",) + _QUANTIZED:
            raise ValueError(f"precision must be fp32, int8, int4 or int2, got {precision!r}"
                             + (" (fp16/halfvec is the RETRIEVAL_INDEX=hnsw rung)"
                                if precision == "fp16" else ""))
        if recall_target is not None and not 0.0 < recall_target <= 1.0:
            raise ValueError(f"recall_target must be in (0, 1], got {recall_target}")
        self.device = resolve_device(device) if devices is None else mesh.home
        # tpualign keeps the mesh only where it shards (a data axis above 1)
        self.mesh = mesh if devices is not None and len(devices) > 1 else None
        self._devices = devices if self.mesh is not None else [self.device]
        self.precision = precision
        self.recall_target = recall_target
        self._refine_store = refine_store
        self._warned: set = set()
        corpus = np.asarray(corpus_embeddings, np.float32)
        self.vocab: Dict[str, int] = {}
        keys, self.vocab = encode_keys(corpus_manuals, corpus_pages, self.vocab)
        self.__dict__.update(self._fields(corpus, keys, refine))

    def _fields(self, corpus: np.ndarray, keys: np.ndarray, refine: int) -> dict:
        """The corpus fields of an index over ``corpus``: its size, the
        refine stage, and the device rows (quantized at int8/int4/int2),
        scales and keys (None when empty), each a :class:`ShardedRows` of
        ``_n_local`` rows a shard: one shard on one device."""
        n = len(corpus)
        refine, rc = _setup_refine(refine, self.precision, corpus,
                                   keep_on_fp32=self.recall_target is not None,
                                   store=self._refine_store)
        out = {"n": n, "dim": corpus.shape[1] if corpus.ndim == 2 else 0, "refine": refine,
               "_refine_corpus": rc, "_corpus": None, "_keys": None, "_corpus_scales": None,
               "_n_local": 0}
        if n == 0:
            return out
        keys = np.asarray(keys, np.int32)
        n_local = -(-n // len(self._devices))
        fields = {"_corpus": [], "_keys": [], "_corpus_scales": []}
        for s, dev in enumerate(self._devices):
            if self.mesh is not None and not self.mesh.is_local(s):
                # another process's shard
                for name in fields if self.precision in _QUANTIZED else ("_corpus", "_keys"):
                    fields[name].append(None)
                continue
            rows = slice(s * n_local, (s + 1) * n_local)
            shard = _padded(corpus[rows], n_local, 0.0)
            if self.precision in _QUANTIZED:
                # quantized after padding, as tpualign does: every shard is
                # quantized rows and their scales
                shard, scales = _QUANTIZERS[self.precision](shard)
                fields["_corpus_scales"].append(_tensor(scales, dev))
            fields["_corpus"].append(_tensor(shard, dev))
            fields["_keys"].append(_tensor(_padded(keys[rows], n_local, -1), dev))
        for name, parts in fields.items():
            if parts:
                out[name] = ShardedRows(parts)
        out["_n_local"] = n_local
        return out

    def _snapshot(self) -> "RetrievalIndex":
        """A shallow copy holding one consistent set of fields. Mutations
        swap their fields in with one ``__dict__`` update and the copy
        takes the dict in one step, so a search on the copy sees the
        corpus before or after a mutation, never a mix."""
        return copy.copy(self)

    # -- mutations -------------------------------------------------------------------

    # Capacity growth: an add past the allocated rows reallocates to GROWTH x
    # the rows needed, rounded up to 1024 (and to whole shards on a mesh);
    # slack rows carry key -1 (masked by every scorer), so most adds write
    # into slack and reallocate nothing.
    GROWTH = 1.25

    def add(self, embeddings, manuals: Optional[Sequence[str]] = None,
            pages: Optional[Sequence[Optional[int]]] = None) -> None:
        """Append rows (pgvector's INSERT): they take corpus indices
        ``n..n+m-1`` and the index's per-row quantization, so results equal
        (ties included) those of an index built over the combined corpus in
        one go. New manual ids extend the vocab; without ``manuals`` the
        rows take key 0. An empty index is built by its first add."""
        rows = np.asarray(embeddings, np.float32)
        if rows.ndim != 2:
            raise ValueError(f"embeddings must be (M, D); got {rows.shape}")
        m = len(rows)
        if m == 0:
            return
        if manuals is not None:
            keys, _ = encode_keys(manuals, pages, self.vocab)  # extends the vocab
        else:
            keys = np.zeros((m,), np.int32)
        keys = np.asarray(keys, np.int32)
        if self.n == 0:
            self.__dict__.update(self._fields(rows, keys, self.refine))
            return
        if rows.shape[1] != self.dim:
            raise ValueError(f"embedding dim {rows.shape[1]} != index dim {self.dim}")
        if self.precision in _QUANTIZED:
            new_rows, new_scales = _QUANTIZERS[self.precision](rows)
        else:
            new_rows, new_scales = rows, None
        fields = self._add_rows(new_rows, new_scales, keys)
        if self._refine_corpus is not None:
            fields["_refine_corpus"] = self._refine_corpus.appended(rows)
        self.__dict__.update(fields)

    @property
    def _across(self):
        """The mesh when it spans processes, else None."""
        return self.mesh if self.mesh is not None and self.mesh.distributed else None

    def _grown_capacity(self, cap: int, total: int, shards: int) -> int:
        return -(-_round_up(max(total, int(cap * self.GROWTH)), 1024) // shards) * shards

    def _add_rows(self, new_rows, new_scales, keys) -> dict:
        """The rows go to global positions ``n..total``, in the last
        shard(s); past the capacity every field is re-split into larger
        whole shards first (fresh tensors), else only the key shards that
        change are copied (the row slack they write is keyed -1 in the
        older keys). Across processes each writes its own shards only."""
        shards, n_local = len(self._devices), self._n_local
        total = self.n + len(new_rows)
        corpus, ckeys, scales = self._corpus, self._keys, self._corpus_scales
        fresh = total > n_local * shards
        if fresh:
            n_local = self._grown_capacity(n_local * shards, total, shards) // shards
            live = np.arange(self.n)
            corpus = _select_rows(corpus, live, n_local, 0, self._across)
            ckeys = _select_rows(ckeys, live, n_local, -1, self._across)
            if scales is not None:
                scales = _select_rows(scales, live, n_local, 1.0, self._across)
        key_parts = list(ckeys.parts)
        for s in range(self.n // n_local, (total - 1) // n_local + 1):
            if key_parts[s] is None:  # another process's shard
                continue
            lo, hi = max(self.n, s * n_local), min(total, (s + 1) * n_local)
            src, dst = slice(lo - self.n, hi - self.n), slice(lo - s * n_local, hi - s * n_local)
            dev = self._devices[s]
            corpus.parts[s][dst] = _tensor(new_rows[src], dev)
            if scales is not None:
                scales.parts[s][dst] = _tensor(new_scales[src], dev)
            if not fresh:
                key_parts[s] = key_parts[s].clone()
            key_parts[s][dst] = _tensor(keys[src], dev)
        return {"_corpus": corpus, "_keys": ShardedRows(key_parts), "_corpus_scales": scales,
                "n": total, "_n_local": n_local}

    def remove(self, corpus_indices) -> int:
        """Tombstone rows (pgvector's DELETE): their keys become -2, which
        no query key equals, so they are never returned; the slots stay
        until :meth:`compact`. Returns the rows newly tombstoned (across
        processes, summed over them); out-of-range and already removed
        indices are ignored."""
        idx = np.unique(np.asarray(corpus_indices, np.int64))
        idx = idx[(idx >= 0) & (idx < self.n)]
        if idx.size == 0 or self.n == 0:
            return 0
        n_local, parts, removed = self._n_local, list(self._keys.parts), 0
        for s in np.unique(idx // n_local):
            if parts[s] is None:  # another process's shard
                continue
            at = torch.from_numpy(idx[idx // n_local == s] - s * n_local).to(parts[s].device)
            removed += int((parts[s][at] != -2).sum())
            parts[s] = parts[s].clone()
            parts[s][at] = -2
        self.__dict__.update({"_keys": ShardedRows(parts)})
        return self._summed(removed)

    def _summed(self, count: int) -> int:
        """A count of this process's shards, summed over the processes."""
        if self._across is None:
            return count
        from tpualign_torch.parallel.multihost import process_sum

        return int(process_sum(self.mesh, [torch.tensor(count, dtype=torch.int64,
                                                        device=self.mesh.home)])[0])

    @property
    def dead(self) -> int:
        """Tombstoned rows awaiting :meth:`compact` (``/stats``' dead_rows).
        Across processes it is a collective: every process reads it
        together, or the readers wait."""
        if self.n == 0:
            return 0
        return self._summed(sum(int((p == -2).sum()) for p in self._keys.parts
                                if p is not None))

    def compact(self) -> np.ndarray:
        """Drop the tombstoned rows and the capacity slack (pgvector's
        VACUUM), renumber the survivors ``0..L-1`` in ascending old-id
        order, and return those old ids (the caller remaps its id-aligned
        state with them). Quantized rows move as they are, so the rankings
        over the survivors do not change. The survivors are re-split evenly
        over the shards."""
        if self.n == 0:
            return np.zeros((0,), np.int64)
        across = self._across
        keys = (self._keys.cpu() if across is None
                else _process_rows(self._keys, across).cpu()).numpy()[:self.n]
        live = np.flatnonzero(keys != -2).astype(np.int64)
        if live.size == self.n and int(self._keys.shape[0]) == self.n:
            return live  # no tombstones and no slack
        fields = {"n": int(live.size), "_corpus": None, "_keys": None, "_corpus_scales": None,
                  "_n_local": 0}
        if live.size:
            n_local = -(-live.size // len(self._devices))
            fields.update(_corpus=_select_rows(self._corpus, live, n_local, 0, across),
                          _keys=_select_rows(self._keys, live, n_local, -1, across),
                          _n_local=n_local,
                          _corpus_scales=(None if self._corpus_scales is None else
                                          _select_rows(self._corpus_scales, live, n_local, 1.0,
                                                       across)))
        if self._refine_corpus is not None:
            fields["_refine_corpus"] = (self._refine_corpus.selected(live) if live.size
                                        else self._refine_corpus.empty())
        self.__dict__.update(fields)
        return live

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
        without a candidate. ``strategy`` is "auto" (the router), "gather",
        "ring" or "streaming"; on one device every strategy is the one
        search. ``global_search=True`` (or no manuals) lifts the
        same-manual+page restriction."""
        queries = np.asarray(query_embeddings, np.float32)
        if global_search or query_manuals is None:
            qk = np.full(len(queries), WILDCARD_KEY, np.int32)
        else:
            # encode against a copy of the vocab: unknown query manuals get
            # codes beyond the corpus range (match nothing) and the index's
            # vocab is never mutated
            qk, _ = encode_keys(query_manuals, query_pages, dict(self.vocab))
        return self._snapshot()._search_encoded(queries, qk, k, strategy)

    def search_encoded(self, queries: np.ndarray, qk: np.ndarray, k: int,
                       strategy: str = "auto") -> Tuple[np.ndarray, np.ndarray]:
        """Host-array search with pre-encoded int32 keys (see
        :func:`encode_keys`; WILDCARD_KEY = unrestricted). The serving
        coalescer batches concurrent requests at this level."""
        return self._snapshot()._search_encoded(queries, qk, k, strategy)

    # Per-device (Q, N / shards) fp32 score budget above which "auto" leaves
    # gather for the streaming sweep (k <= 16 on the card) or the ring
    # (tpualign's value, calibrated on its CPU mesh)
    RING_THRESHOLD_BYTES = 2 * 1024**3

    def _pick_strategy(self, nq: int, strategy: str, k: int = 10) -> str:
        """tpualign's router, with "on the card" for its "on a TPU"."""
        if strategy not in ("auto", "gather", "ring", "streaming"):
            raise ValueError(f"strategy must be auto/gather/ring/streaming, got {strategy!r}")
        if strategy != "auto":
            return strategy
        if self.mesh is None:
            return "gather"
        if 4 * nq * self._n_local <= self.RING_THRESHOLD_BYTES:
            return "gather"
        if k <= 16 and self.device.type == "cuda":
            return "streaming"
        if self.precision in _QUANTIZED:
            return "gather"  # the ring has no quantized path
        return "ring"

    def search_device(self, query_embeddings: torch.Tensor, query_keys: torch.Tensor,
                      k: int, strategy: str = "auto") -> Tuple[torch.Tensor, torch.Tensor]:
        """Device-resident search: takes tensors (moved to the index's
        first device) and returns tensors there: ``(vals (Q, min(k, n))``
        fp32 on one device, ``(Q, min(k, shards * n_local))`` on a mesh,
        ``idx`` int32), where slots without a candidate hold ``(NEG_INF,
        SENTINEL_IDX)``; on a mesh, pad rows may appear as indices >= n
        when a query has fewer than k candidates. The ring strategy needs Q
        divisible by the data axis. One shard is searched alone, without
        the offset and the merge."""
        snap = self._snapshot()
        strategy = snap._pick_strategy(query_embeddings.shape[0], strategy, k)
        q = query_embeddings.to(snap.device, torch.float32).contiguous()
        qk = query_keys.to(snap.device, torch.int32).contiguous()
        scales = snap._corpus_scales
        if len(snap._devices) == 1:
            return _device_topk(q, qk, snap._corpus.parts[0], snap._keys.parts[0],
                                None if scales is None else scales.parts[0], min(k, snap.n))
        if strategy == "ring" and snap.precision in _QUANTIZED:
            if "ring-quantized" not in self._warned:
                self._warned.add("ring-quantized")
                log.warning("strategy='ring' has no %s path; routing to 'gather' (same "
                            "results, the integer kernel; 'streaming' is the same sweep)",
                            snap.precision)
            strategy = "gather"
        if strategy == "ring":
            from tpualign_torch.parallel.ring import ring_search_fn

            if q.shape[0] % len(snap._devices):
                raise ValueError("ring strategy needs Q divisible by the data axis; pad "
                                 "queries or use search()")
            return ring_search_fn(snap.mesh, k)(q, qk, snap._corpus, snap._keys)
        # gather and streaming: the kernel on every shard, launched in turn
        # (each on its card's stream), the winners merged on the first card
        # (and across processes, every process's merged winners again)
        k_local = min(k, snap._n_local)
        vals, idx = [], []
        for s in snap.mesh.local_rows:
            dev = snap._devices[s]
            v, i = _device_topk(q.to(dev, non_blocking=True), qk.to(dev, non_blocking=True),
                                snap._corpus.parts[s], snap._keys.parts[s],
                                None if scales is None else scales.parts[s], k_local)
            vals.append(v.to(snap.device, non_blocking=True))
            idx.append(_offset(i, s * snap._n_local).to(snap.device, non_blocking=True))
        vals, idx = _two_key_topk(torch.cat(vals, dim=1), torch.cat(idx, dim=1), k)
        if snap.mesh.distributed:
            vals, idx = _merge_processes(snap.mesh, vals, idx, k)
        return vals, idx

    def _search_encoded(self, queries: np.ndarray, qk: np.ndarray, k: int,
                        strategy: str = "auto") -> Tuple[np.ndarray, np.ndarray]:
        if self.refine > 1 and self.n > 0 and k > 0:
            # over-fetch k*refine candidates from the first stage, rescore
            # them exactly on the host, trim to k
            kf = min(max(k, k * self.refine), self.n)
            # tpualign's beyond-HBM bound, per device on a mesh
            big = (4 * len(queries) * self.n > STREAM_ONLY_SIM_BYTES if self.mesh is None
                   else 4 * len(queries) * self._n_local > self.RING_THRESHOLD_BYTES)
            if kf > REFINE_MAX_STREAM_K and big:
                log.warning("refine over-fetch k*refine=%d clamped to %d, as tpualign "
                            "clamps it past its bound of scores", kf, REFINE_MAX_STREAM_K)
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
        queries = np.asarray(queries, np.float32)
        qk = np.asarray(qk, np.int32)
        if self._pick_strategy(nq, strategy, k) == "ring":
            # the ring shards the queries: pad them to whole blocks, keyed -2
            strategy, pad = "ring", -nq % len(self._devices)
            queries = _padded(queries, nq + pad, 0.0)
            qk = _padded(qk, nq + pad, -2)
        vals, idx = self.search_device(_tensor(queries, self.device), _tensor(qk, self.device),
                                       k, strategy)
        idx = idx[:nq].cpu().numpy().astype(np.int64)
        idx = np.where(idx >= self.n, -1, idx)
        if skip_vals:
            # every empty slot carries SENTINEL_IDX (>= n), so the indices
            # alone say which slots hold a candidate: fetch half the bytes
            vals = np.where(idx >= 0, 0.0, NEG_INF).astype(np.float32)
        else:
            vals = vals[:nq].cpu().numpy()
        vals, idx = _pad_results(vals, idx, k)
        return _sentinel(vals, idx)


def sharded_topk_search(queries: np.ndarray, query_keys: np.ndarray, corpus: np.ndarray,
                        corpus_keys: np.ndarray, k: int, mesh=None,
                        device: str | torch.device = "cuda") -> Tuple[np.ndarray, np.ndarray]:
    """One-shot top-k search over pre-encoded int32 keys (tpualign's
    function of the same name): a transient fp32 :class:`RetrievalIndex` on
    ``device``, or sharded over ``mesh``'s data axis. Returns ``(values,
    indices)``, both ``(Q, k)``; slots without a candidate hold
    ``(NEG_INF, -1)``."""
    corpus = np.asarray(corpus, np.float32)
    index = RetrievalIndex(np.zeros((0, corpus.shape[1]), np.float32), [], [], mesh=mesh,
                           device=device)
    index.__dict__.update(index._fields(corpus, np.asarray(corpus_keys, np.int32), 0))
    return index._search_encoded(np.asarray(queries, np.float32),
                                 np.asarray(query_keys, np.int32), k)


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
    signature. ``"exact"`` builds a :class:`RetrievalIndex`, sharded over
    ``mesh``'s data axis when it is above 1; ``refine`` and
    ``refine_store`` (the ``RETRIEVAL_REFINE``/``RETRIEVAL_REFINE_STORE``
    knobs) set its refine stage. ``"ivf"`` builds an
    :class:`~tpualign_torch.parallel.ivf.IVFIndex` with ``ivf_lists`` and
    ``ivf_probes``; ``ivf_cache`` (``IVF_CACHE``) is its artifact: loaded
    when it matches the corpus and precision (and recalibrated and saved
    again when ``recall_target`` changed), else built, calibrated to
    ``recall_target`` unless ``ivf_probes`` is set, and saved. An empty
    corpus serves the exact index. ``"hnsw"`` builds a host-side
    :class:`~tpualign_torch.parallel.hnsw.HNSWIndex` (``device`` is not
    used) with ``hnsw_m``, ``hnsw_ef_construction`` and ``hnsw_ef_search``
    (``None``: 40, or calibrated to ``recall_target``); ``hnsw_cache``
    (``HNSW_CACHE``) is its artifact, handled as IVF's."""
    if index_type == "ivf" and len(corpus_embeddings) == 0:
        # an empty schema serves the exact index, as tpualign does
        index_type = "exact"
    if index_type == "ivf":
        return _build_ivf(corpus_embeddings, corpus_manuals, corpus_pages, mesh, precision,
                          recall_target, ivf_lists, ivf_probes, ivf_cache, refine,
                          refine_store, device)
    if index_type == "hnsw":
        return _build_hnsw(corpus_embeddings, corpus_manuals, corpus_pages, mesh, precision,
                           recall_target, refine, hnsw_m, hnsw_ef_construction, hnsw_ef_search,
                           hnsw_cache)
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


def _build_hnsw(corpus_embeddings, corpus_manuals, corpus_pages, mesh, precision, recall_target,
                refine, hnsw_m, hnsw_ef_construction, hnsw_ef_search, hnsw_cache):
    """``build_index``'s HNSW branch, tpualign's: a host graph, single
    process; a mesh with a data axis above 1 or an int precision is warned
    about and ignored."""
    from tpualign_torch.parallel.hnsw import HNSWIndex

    devices = shard_devices(mesh)
    if devices is not None and len(devices) > 1:
        log.warning("RETRIEVAL_INDEX=hnsw is a host-native single-process index; the mesh is "
                    "ignored (use 'exact' or 'ivf' to shard the corpus across devices)")
    hnsw_precision = precision
    if precision not in ("fp32", "fp16"):
        log.warning("RETRIEVAL_INDEX=hnsw stores fp32 ('vector') or fp16 ('halfvec') graph "
                    "entries, as pgvector does; RETRIEVAL_PRECISION=%s is ignored (the int "
                    "rungs live on the exact/IVF device paths)", precision)
        hnsw_precision = "fp32"
    # HNSW_EF_SEARCH=None means auto: pgvector's 40, or calibrated to
    # RETRIEVAL_RECALL_TARGET when it is set; an explicit ef wins, loudly
    auto_ef = hnsw_ef_search is None
    eff_ef = 40 if auto_ef else int(hnsw_ef_search)
    calibrate = recall_target is not None and auto_ef
    if recall_target is not None and not auto_ef:
        log.warning("HNSW_EF_SEARCH=%d overrides RETRIEVAL_RECALL_TARGET calibration; unset "
                    "it to auto-pick ef for the target", eff_ef)
    if hnsw_cache and os.path.exists(hnsw_cache):
        try:
            loaded = HNSWIndex.load(hnsw_cache, corpus_embeddings, ef_search=hnsw_ef_search,
                                    refine=refine)
            if loaded.precision != hnsw_precision:
                raise ValueError(f"cache precision {loaded.precision} != requested "
                                 f"{hnsw_precision}")
            if calibrate and getattr(loaded, "calibrated_target", None) != recall_target:
                # the target changed since the artifact was written
                loaded.calibrate(recall_target)
                loaded.save(hnsw_cache)
            elif (recall_target is None and auto_ef
                  and getattr(loaded, "calibrated_target", None) is not None):
                # auto without a target means pgvector's default, not a
                # calibration nobody asked for
                log.info("HNSW cache held ef=%d calibrated for target %.3f, but "
                         "RETRIEVAL_RECALL_TARGET is unset; serving the default ef=40",
                         loaded.ef_search, loaded.calibrated_target)
                loaded.ef_search = 40
                loaded.calibrated_target = None
            return loaded
        except Exception as e:  # a stale or mismatched artifact: rebuild
            log.warning("HNSW cache %s unusable (%s); rebuilding", hnsw_cache, e)
    index = HNSWIndex(corpus_embeddings, corpus_manuals, corpus_pages, m=hnsw_m,
                      ef_construction=hnsw_ef_construction, ef_search=eff_ef, refine=refine,
                      precision=hnsw_precision)
    if calibrate:
        index.calibrate(recall_target)
    if hnsw_cache:
        index.save(hnsw_cache)
        log.info("HNSW graph cached to %s", hnsw_cache)
    return index
