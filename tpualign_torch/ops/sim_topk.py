"""Fused masked similarity + running top-k (kernels K2 and K3).

``masked_sim_topk`` replaces the Pallas TPU kernel
``tpualign/ops/pallas_kernels.py::masked_sim_topk`` and takes its
signature. It dispatches, as the JAX function does, on the corpus:

- fp32 rows, no scales: K2 (``_score_fp32``), ``csrc/masked_sim_topk.cu``;
- int8 rows with ``corpus_scales`` and ``int8_mxu``: K3's s8 variant
  (``_score_int8_mxu``); without ``int8_mxu``, K3's dequant variant
  (``_score_fp32`` with row scales);
- uint8 ``(N, D/2)`` with scales: K3's int4 variant (``_score_int4_mxu``);
  uint8 ``(N, D/4)`` with scales: K3's int2 variant (``_score_int2_mxu``).

K3 is :func:`masked_sim_topk_quant` (``csrc/masked_sim_topk_quant.cu``).
On CUDA tensors each launches its hand-written kernel; on CPU tensors the
call runs :func:`masked_sim_topk_reference`, the plain PyTorch version of
every variant. The integer variants quantize the queries first, exactly as
tpualign does outside its kernel (:func:`quantize_queries`).

Bounds on the H100 (Q=1,024, D=512): K2 at N=100,000 is bound by
operations, 105 GFLOP of fp32 against a 205 MB corpus read; K3 at
N=1,000,000 by bytes, a 512/256/128 MB int8/int4/int2 corpus read, since
the pairs a key mask admits need little of the tensor cores' integer rate.
Both stream the corpus with O(Q*k) state and never write the (Q, N) score
matrix (see the sources' notes). Both read only the corpus tiles that some
query of a block admits (:func:`admitted_tiles` is the plain version of
that prologue); the wrapper groups the queries by key first
(:func:`group_by_key`) and puts the rows back after
(:func:`ungroup_rows`), so where a key's corpus rows lie together, as the
Evaluator's same-page search and serving's ``/search_image`` find them,
most tiles go unread. K3 quantizes the queries inside the call (the
kernel's codes and scales are :func:`quantize_queries`' bit for bit) and
takes its integer products on the tensor cores; a batch of at most 16
queries takes 16-query blocks (:func:`query_tile`).
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from tpualign_torch.ops import build
from tpualign_torch.ops.similarity import NEG_INF, WILDCARD_KEY, masked_topk

__all__ = ["masked_sim_topk", "masked_sim_topk_quant", "masked_sim_topk_reference",
           "quant_variant", "quantize_queries", "key_mask", "group_by_key", "ungroup_rows",
           "admitted_tiles", "query_tile", "SENTINEL_IDX", "MAX_K"]

# Empty top-k slots carry this index (values carry NEG_INF).
SENTINEL_IDX = 2**30
MAX_K = 128
_MAX_SPLITS = 4096  # corpus ranges the kernels' cross-range merge takes
_BN = 64            # K3's and K4's corpus tile (K4's fp32 sweep: _K2_BN)
_K2_BN = 128        # K2's corpus tile
_SMALL_Q = 16       # integer batches up to this size take 16-query blocks
# K3's variant codes (csrc/masked_sim_topk_quant.cu) and codes per byte
_VARIANT_CODE = {"s8": 0, "int4": 1, "int2": 2, "dequant": 3}
_PLANES = {"s8": 1, "int4": 2, "int2": 4}


def key_mask(query_keys: torch.Tensor, corpus_keys: torch.Tensor) -> torch.Tensor:
    """(Q, N) candidate mask: same key or a wildcard query, real rows only."""
    qk = query_keys[:, None]
    ck = corpus_keys[None, :]
    return ((qk == ck) | (qk == WILDCARD_KEY)) & (ck >= 0)


def quant_variant(corpus: torch.Tensor, d: int, corpus_scales: Optional[torch.Tensor],
                  int8_mxu: bool = False) -> Optional[str]:
    """The scorer tpualign's masked_sim_topk picks for this corpus: None
    (fp32, K2), "s8", "dequant", "int4" or "int2" (K3). An unsigned-byte
    corpus with scales is packed: (N, D/2) int4, (N, D/4) int2."""
    if corpus_scales is None:
        return None
    if corpus.dtype == torch.uint8:
        if corpus.shape[1] * 2 == d:
            return "int4"
        if corpus.shape[1] * 4 == d:
            return "int2"
        raise ValueError(f"packed corpus must be (N, D/2) int4 or (N, D/4) int2; "
                         f"got {tuple(corpus.shape)} for D={d}")
    if corpus.dtype != torch.int8:
        raise TypeError(f"a corpus with scales must be int8 or packed uint8, got {corpus.dtype}")
    return "s8" if int8_mxu else "dequant"


def quantize_queries(queries: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per-row symmetric int8 queries, bit-identical to tpualign's
    ``qs = max(max|q| / 127, 1e-12)``, ``qq = clip(rint(q / qs), -127, 127)``
    in fp32 (``torch.round`` rounds half to even, like ``jnp.rint``).
    Returns ``(qq (Q, D) int8, qs (Q,) fp32)``."""
    # the divisor goes in as a tensor: on CUDA torch divides by a Python
    # scalar as a product with its reciprocal, which rounds differently
    div = torch.full((), 127.0, dtype=torch.float32, device=queries.device)
    qs = torch.clamp_min(queries.abs().amax(dim=1, keepdim=True) / div, 1e-12)
    qq = torch.clamp(torch.round(queries / qs), -127, 127).to(torch.int8)
    return qq, qs[:, 0]


def _unpack_codes(corpus: torch.Tensor, variant: str) -> torch.Tensor:
    """(N, D) int32 codes of an s8, packed-int4 or packed-int2 corpus."""
    b = corpus.to(torch.int32)
    if variant == "s8":
        return b
    if variant == "int4":
        return torch.cat([(b & 15) - 8, (b >> 4) - 8], dim=1)
    return torch.cat([((b >> (2 * p)) & 3) * 2 - 3 for p in range(4)], dim=1)


def _int_product(qq: torch.Tensor, codes: torch.Tensor) -> torch.Tensor:
    """Exact ``qq @ codes.T`` as fp32: int32 on the CPU; on CUDA, which has
    no integer matmul, a float64 product, exact for these integer sums."""
    if qq.device.type == "cpu":
        return torch.matmul(qq.to(torch.int32), codes.T).to(torch.float32)
    return torch.matmul(qq.to(torch.float64), codes.to(torch.float64).T).to(torch.float32)


def _scores(queries, corpus, corpus_scales, variant: Optional[str]) -> torch.Tensor:
    """(Q, N) fp32 scores of the plain version, per variant."""
    if variant is None:
        return torch.matmul(queries, corpus.T)
    if variant == "dequant":
        return torch.matmul(queries, (corpus.to(torch.float32) * corpus_scales[:, None]).T)
    qq, qs = quantize_queries(queries)
    acc = _int_product(qq, _unpack_codes(corpus, variant))
    return acc * qs[:, None] * corpus_scales[None, :]


def masked_sim_topk_reference(queries, query_keys, corpus, corpus_keys, k: int,
                              corpus_scales: Optional[torch.Tensor] = None,
                              int8_mxu: bool = False) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain version of every variant: the variant's scores (fp32 matmul;
    the exact integer product rescaled as ``(float(acc) * qs) * cs``; or
    the fp32 product of dequantized rows), the key mask, a stable
    descending sort, the first k, and ``(NEG_INF, SENTINEL_IDX)`` in every
    slot without a candidate."""
    variant = quant_variant(corpus, queries.shape[1], corpus_scales, int8_mxu)
    sims = _scores(queries, corpus, corpus_scales, variant)
    mask = key_mask(query_keys, corpus_keys)
    vals, idx = masked_topk(sims, mask, k)
    empty = ~torch.gather(mask, 1, idx)
    vals = vals.masked_fill(empty, NEG_INF)
    idx = idx.to(torch.int32).masked_fill(empty, SENTINEL_IDX)
    if vals.shape[1] < k:  # k > N
        pad = k - vals.shape[1]
        vals = torch.nn.functional.pad(vals, (0, pad), value=NEG_INF)
        idx = torch.nn.functional.pad(idx, (0, pad), value=SENTINEL_IDX)
    return vals, idx


def query_tile(variant: Optional[str], nq: int) -> int:
    """Queries a block of K3's or K4's sweep takes: 64 for fp32 (K2's
    sweep, K4's copy), 32 for dequant, and for the integer variants 16
    (the tensor-core product's M) when the batch fits one such block, else
    64."""
    if variant is None:
        return 64
    if variant == "dequant":
        return 32
    return 16 if nq <= _SMALL_Q else 64


def _blocks_per_sm(variant: Optional[str], bq: int) -> int:
    """Blocks of a sweep one SM runs at once, as their shared memory allows
    (csrc/quant_sweep.cuh), times the waves the grid may take: the skip
    leaves blocks uneven work, and later waves fill the SMs that finish
    first. K2's sweep and K4's copy: one, in one wave."""
    if variant is None:
        return 1
    if variant == "dequant":
        return 2
    return 3 if bq == 16 else 4


def _splits(nq: int, n_tiles: int, device: torch.device, bq: int, per_sm: int = 1) -> int:
    """Corpus ranges per query tile: ``per_sm`` blocks a SM over the grid,
    at least one corpus tile per range, within the merge's bound."""
    sms = torch.cuda.get_device_properties(device).multi_processor_count
    q_tiles = -(-nq // bq)
    return max(1, min(per_sm * sms // q_tiles, max(1, n_tiles), _MAX_SPLITS))


def group_by_key(query_keys: torch.Tensor) -> torch.Tensor:
    """The order that groups the queries by key: a stable ascending sort,
    so the wildcard queries (WILDCARD_KEY < 0) come first, together, and
    queries of one key keep their order. K2 takes the queries in this
    order, so that a query tile admits few corpus tiles when the corpus
    rows of a key lie together."""
    return torch.sort(query_keys, stable=True).indices


def admitted_tiles(query_keys: torch.Tensor, corpus_keys: torch.Tensor, bq: int,
                   bn: int) -> torch.Tensor:
    """Plain version of the kernels' admit prologue: a ``(ceil(Q / bq),
    ceil(N / bn))`` bool matrix, true where some query of query tile i
    admits some row of corpus tile j (:func:`key_mask`). The sweeps read
    only those tiles; every other tile holds masked candidates alone. Pass
    the keys in the order the kernel takes them (grouped by key)."""
    nq, n = query_keys.shape[0], corpus_keys.shape[0]
    q_tiles, n_tiles = -(-nq // bq), -(-n // bn)
    qk = torch.nn.functional.pad(query_keys, (0, q_tiles * bq - nq), value=-2)
    ck = torch.nn.functional.pad(corpus_keys, (0, n_tiles * bn - n), value=-1)
    out = torch.zeros((q_tiles, n_tiles), dtype=torch.bool, device=query_keys.device)
    for i in range(q_tiles):
        out[i] = key_mask(qk[i * bq:(i + 1) * bq], ck).any(dim=0).view(n_tiles, bn).any(dim=1)
    return out


def ungroup_rows(rows: torch.Tensor, order: torch.Tensor) -> torch.Tensor:
    """Puts the rows computed for ``queries[order]`` back in the queries'
    own order: ``out[order[i]] = rows[i]``."""
    out = torch.empty_like(rows)
    out[order] = rows
    return out


def _check(queries, query_keys, corpus, corpus_keys, corpus_scales):
    """Types and shapes every variant takes; returns the common device."""
    if queries.dtype != torch.float32:
        raise TypeError("queries must be float32")
    if corpus_scales is None and corpus.dtype != torch.float32:
        raise TypeError("a corpus without scales must be float32")
    if query_keys.dtype != torch.int32 or corpus_keys.dtype != torch.int32:
        raise TypeError("query_keys and corpus_keys must be int32")
    if queries.dim() != 2 or corpus.dim() != 2:
        raise ValueError(f"shapes {tuple(queries.shape)} and {tuple(corpus.shape)} "
                         "must be (Q, D) and (N, D) (or packed (N, D/2), (N, D/4))")
    if corpus_scales is None and queries.shape[1] != corpus.shape[1]:
        raise ValueError(f"shapes {tuple(queries.shape)} and {tuple(corpus.shape)} "
                         "must be (Q, D) and (N, D)")
    nq, n = queries.shape[0], corpus.shape[0]
    if query_keys.shape != (nq,) or corpus_keys.shape != (n,):
        raise ValueError("one key per query row and per corpus row")
    tensors = [queries, query_keys, corpus, corpus_keys]
    if corpus_scales is not None:
        if corpus_scales.dtype != torch.float32 or corpus_scales.shape != (n,):
            raise ValueError("corpus_scales must be (N,) float32")
        tensors.append(corpus_scales)
    dev = queries.device
    if any(t.device != dev for t in tensors):
        raise ValueError("masked_sim_topk: all inputs must be on one device")
    if dev.type not in ("cpu", "cuda"):
        raise ValueError(f"masked_sim_topk: unsupported device {dev}")
    return dev, tensors


def _sweep_scratch(dev, nq: int, d: int, k: int, splits: int, bq: int, n_tiles: int,
                   quantized: bool, *extra: int):
    """A sweep's scratch in one byte buffer, each region 256-byte aligned:
    quantized queries and scales (K3's and K4's integer variants), ``extra``
    regions, the admit bits of (ceil(nq / bq), words) query and corpus
    tiles, and the (nq, splits, k) partial lists (none when splits == 1).
    Returns ``(buffer, addresses)``, None for an empty region; the caller
    keeps the buffer until the launch is queued, and the allocator reuses
    it in stream order."""
    words = -(-max(1, n_tiles) // 32)
    part = nq * splits * k * 4 if splits > 1 else 0
    sizes = (nq * d if quantized else 0, nq * 4 if quantized else 0, *extra,
             -(-nq // bq) * words * 4, part, part)
    addrs, total = [], 0
    for size in sizes:
        addrs.append(total if size else None)
        total += -(-size // 256) * 256
    buf = torch.empty(max(total, 1), dtype=torch.uint8, device=dev)
    base = buf.data_ptr()
    return buf, [None if a is None else base + a for a in addrs]


def masked_sim_topk(queries: torch.Tensor, query_keys: torch.Tensor,
                    corpus: torch.Tensor, corpus_keys: torch.Tensor, k: int,
                    corpus_scales: Optional[torch.Tensor] = None,
                    int8_mxu: bool = False) -> Tuple[torch.Tensor, torch.Tensor]:
    """Top-k of the similarity of each query to the corpus rows whose key
    matches (see :func:`key_mask`), by value descending then index
    ascending.

    Args: queries ``(Q, D)`` fp32, query_keys ``(Q,)`` int32, corpus
    ``(N, D)`` fp32, or, with ``corpus_scales`` ``(N,)`` fp32, ``(N, D)``
    int8 or packed ``(N, D/2)``/``(N, D/4)`` uint8 (see the module notes),
    corpus_keys ``(N,)`` int32, ``1 <= k <= 128``; ``int8_mxu`` scores an
    int8 corpus as s8 x s8 -> s32 against quantized queries instead of
    dequantizing it. Returns ``(values (Q, k) fp32, indices (Q, k) int32)``;
    empty slots are ``(NEG_INF, SENTINEL_IDX)``.
    """
    dev, tensors = _check(queries, query_keys, corpus, corpus_keys, corpus_scales)
    variant = quant_variant(corpus, queries.shape[1], corpus_scales, int8_mxu)
    if dev.type == "cpu":
        return masked_sim_topk_reference(queries, query_keys, corpus, corpus_keys, k,
                                         corpus_scales, int8_mxu)
    if not 1 <= k <= MAX_K:
        raise ValueError(f"k must be in 1..{MAX_K}, got {k}")
    if not all(t.is_contiguous() for t in tensors):
        raise ValueError("inputs must be contiguous")
    if variant is not None:
        return masked_sim_topk_quant(queries, query_keys, corpus, corpus_keys, k,
                                     corpus_scales, variant)
    nq, d = queries.shape
    n = corpus.shape[0]
    vals = torch.empty((nq, k), dtype=torch.float32, device=dev)
    idx = torch.empty((nq, k), dtype=torch.int32, device=dev)
    if nq == 0:
        return vals, idx
    order = group_by_key(query_keys)
    q, qk = queries[order], query_keys[order]
    bq, n_tiles = query_tile(None, nq), -(-n // _K2_BN)
    splits = _splits(nq, n_tiles, dev, bq)
    buf, (_, _, admitted, part_v, part_i) = _sweep_scratch(dev, nq, d, k, splits, bq, n_tiles,
                                                           False)
    rc = build.call(
        "masked_sim_topk", dev, q.data_ptr(), qk.data_ptr(), corpus.data_ptr(), corpus_keys.data_ptr(), nq, n, d, k,
        splits, admitted, part_v, part_i, vals.data_ptr(), idx.data_ptr(),
    )
    if rc != 0:
        raise RuntimeError(f"masked_sim_topk kernel launch failed: CUDA error {rc}")
    masked_sim_topk.launches += 1
    return ungroup_rows(vals, order), ungroup_rows(idx, order)


masked_sim_topk.launches = 0


def masked_sim_topk_quant(queries: torch.Tensor, query_keys: torch.Tensor,
                          corpus: torch.Tensor, corpus_keys: torch.Tensor, k: int,
                          corpus_scales: torch.Tensor, variant: str
                          ) -> Tuple[torch.Tensor, torch.Tensor]:
    """K3 on CUDA tensors: :func:`masked_sim_topk` over a quantized corpus,
    ``variant`` as :func:`quant_variant` names it. The integer variants
    need D a multiple of 4 (s8), 8 (int4) or 16 (int2), the word layout of
    the kernel's unpack. A batch larger than one block goes in grouped by
    key, and its rows come back in the queries' order."""
    dev = queries.device
    if dev.type != "cuda":
        raise ValueError(f"masked_sim_topk_quant runs on CUDA tensors, got {dev}")
    nq, d = queries.shape
    n = corpus.shape[0]
    quantized = variant in _PLANES
    if quantized and d % (4 * _PLANES[variant]):
        raise ValueError(f"the {variant} kernel needs D a multiple of "
                         f"{4 * _PLANES[variant]}, got {d}")
    vals = torch.empty((nq, k), dtype=torch.float32, device=dev)
    idx = torch.empty((nq, k), dtype=torch.int32, device=dev)
    if nq == 0:
        return vals, idx
    bq = query_tile(variant, nq)
    order = group_by_key(query_keys) if nq > bq else None
    q, qk = (queries, query_keys) if order is None else (queries[order], query_keys[order])
    n_tiles = -(-n // _BN)
    splits = _splits(nq, n_tiles, dev, bq, _blocks_per_sm(variant, bq))
    buf, (qq, qs, admitted, part_v, part_i) = _sweep_scratch(dev, nq, d, k, splits, bq,
                                                             n_tiles, quantized)
    rc = build.call(
        "masked_sim_topk_quant", dev, _VARIANT_CODE[variant], q.data_ptr(), qk.data_ptr(), corpus.data_ptr(),
        corpus_scales.data_ptr(), corpus_keys.data_ptr(), nq, n, d, k, splits, bq, qq, qs,
        admitted, part_v, part_i, vals.data_ptr(), idx.data_ptr(),
    )
    if rc != 0:
        raise RuntimeError(f"masked_sim_topk_quant kernel launch failed: CUDA error {rc}")
    masked_sim_topk_quant.launches += 1
    if order is None:
        return vals, idx
    return ungroup_rows(vals, order), ungroup_rows(idx, order)


masked_sim_topk_quant.launches = 0
