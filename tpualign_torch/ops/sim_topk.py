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
matrix (see the sources' notes). K2 reads only the corpus tiles that some
query of a 64-query tile admits; the wrapper groups the queries by key
first (:func:`group_by_key`) and puts the rows back after
(:func:`ungroup_rows`), so where a key's corpus rows lie together, as the
Evaluator's same-page search finds them, most tiles go unread.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from tpualign_torch.ops import build
from tpualign_torch.ops.similarity import NEG_INF, WILDCARD_KEY, masked_topk

__all__ = ["masked_sim_topk", "masked_sim_topk_quant", "masked_sim_topk_reference",
           "quant_variant", "quantize_queries", "key_mask", "group_by_key", "ungroup_rows",
           "SENTINEL_IDX", "MAX_K"]

# Empty top-k slots carry this index (values carry NEG_INF).
SENTINEL_IDX = 2**30
MAX_K = 128
_MERGE_MAX = 4096   # splits * k bound of the kernels' cross-range merge
_BN = 64            # K3's and K4's corpus tile
_K2_BN = 128        # K2's corpus tile
_BQ = {None: 64, "dequant": 32, "s8": 64, "int4": 64, "int2": 64}  # query tiles
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


def _splits(nq: int, n: int, k: int, device: torch.device, bq: int) -> int:
    """Corpus ranges per query tile: enough blocks for two per SM, at
    least one corpus tile per range, within the merge's bound."""
    sms = torch.cuda.get_device_properties(device).multi_processor_count
    q_tiles = -(-nq // bq)
    n_tiles = max(1, -(-n // _BN))
    want = -(-2 * sms // q_tiles)
    return max(1, min(want, n_tiles, _MERGE_MAX // k))


def _k2_splits(nq: int, n: int, k: int, device: torch.device) -> int:
    """K2's corpus ranges per query tile: one block per SM (its running
    lists take most of an SM's shared memory), rounded down so that the
    grid is one wave, at least one corpus tile per range, within the
    merge's bound."""
    sms = torch.cuda.get_device_properties(device).multi_processor_count
    q_tiles = -(-nq // _BQ[None])
    n_tiles = max(1, -(-n // _K2_BN))
    return max(1, min(sms // q_tiles, n_tiles, _MERGE_MAX // k))


def group_by_key(query_keys: torch.Tensor) -> torch.Tensor:
    """The order that groups the queries by key: a stable ascending sort,
    so the wildcard queries (WILDCARD_KEY < 0) come first, together, and
    queries of one key keep their order. K2 takes the queries in this
    order, so that a query tile admits few corpus tiles when the corpus
    rows of a key lie together."""
    return torch.sort(query_keys, stable=True).indices


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


def _launch_args(nq: int, k: int, splits: int, dev: torch.device):
    """Outputs and the (nq, splits, k) scratch of a sweep with splits ranges."""
    vals = torch.empty((nq, k), dtype=torch.float32, device=dev)
    idx = torch.empty((nq, k), dtype=torch.int32, device=dev)
    part_v = part_i = None
    if splits > 1:
        part_v = torch.empty((nq, splits, k), dtype=torch.float32, device=dev)
        part_i = torch.empty((nq, splits, k), dtype=torch.int32, device=dev)
    return vals, idx, part_v, part_i


def _ptr(t: Optional[torch.Tensor]):
    return None if t is None else t.data_ptr()


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
    splits = _k2_splits(nq, n, k, dev) if nq else 1
    vals, idx, part_v, part_i = _launch_args(nq, k, splits, dev)
    if nq == 0:
        return vals, idx
    order = group_by_key(query_keys)
    q, qk = queries[order], query_keys[order]
    words = -(-max(1, -(-n // _K2_BN)) // 32)
    admitted = torch.zeros((-(-nq // _BQ[None]), words), dtype=torch.int32, device=dev)
    rc = build.load("masked_sim_topk")(
        q.data_ptr(), qk.data_ptr(), corpus.data_ptr(), corpus_keys.data_ptr(), nq, n, d, k,
        splits, admitted.data_ptr(), _ptr(part_v), _ptr(part_i), vals.data_ptr(),
        idx.data_ptr(), dev.index or 0, torch.cuda.current_stream(dev).cuda_stream,
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
    the kernel's unpack."""
    dev = queries.device
    if dev.type != "cuda":
        raise ValueError(f"masked_sim_topk_quant runs on CUDA tensors, got {dev}")
    nq, d = queries.shape
    n = corpus.shape[0]
    if variant in _PLANES:
        if d % (4 * _PLANES[variant]):
            raise ValueError(f"the {variant} kernel needs D a multiple of "
                             f"{4 * _PLANES[variant]}, got {d}")
        qq, qs = quantize_queries(queries)
    else:
        qq, qs = queries, None
    splits = _splits(nq, n, k, dev, _BQ[variant]) if nq else 1
    vals, idx, part_v, part_i = _launch_args(nq, k, splits, dev)
    if nq == 0:
        return vals, idx
    rc = build.load("masked_sim_topk_quant")(
        _VARIANT_CODE[variant], qq.data_ptr(), _ptr(qs), query_keys.data_ptr(),
        corpus.data_ptr(), corpus_scales.data_ptr(), corpus_keys.data_ptr(),
        nq, n, d, k, splits, _ptr(part_v), _ptr(part_i), vals.data_ptr(), idx.data_ptr(),
        dev.index or 0, torch.cuda.current_stream(dev).cuda_stream,
    )
    if rc != 0:
        raise RuntimeError(f"masked_sim_topk_quant kernel launch failed: CUDA error {rc}")
    masked_sim_topk_quant.launches += 1
    return vals, idx


masked_sim_topk_quant.launches = 0
