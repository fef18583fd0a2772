"""Fused masked similarity + running top-k over an fp32 corpus (kernel K2).

``masked_sim_topk`` replaces the Pallas TPU kernel
``tpualign/ops/pallas_kernels.py::masked_sim_topk`` at fp32
(``_make_sim_topk_kernel`` with ``_score_fp32`` and
``_merge_running_topk``). On CUDA tensors it launches the hand-written
kernel in ``csrc/masked_sim_topk.cu``; on CPU tensors it runs
:func:`masked_sim_topk_reference`, the plain PyTorch version.

Bound on the H100 (Q=1,024, N=100,000, D=512): operations, 105 GFLOP of
fp32 for the dense score (about 1.6 ms at 67 TFLOP/s) against a 205 MB
corpus read; the kernel streams the corpus with O(Q*k) state and never
writes the (Q, N) score matrix (see the source's notes). The quantized
scorers (int8/int4/int2) are a later slice.
"""

from __future__ import annotations

from typing import Tuple

import torch

from tpualign_torch.ops import build
from tpualign_torch.ops.similarity import NEG_INF, WILDCARD_KEY, masked_topk

__all__ = ["masked_sim_topk", "masked_sim_topk_reference", "key_mask",
           "SENTINEL_IDX", "MAX_K"]

# Empty top-k slots carry this index (values carry NEG_INF).
SENTINEL_IDX = 2**30
MAX_K = 128
_MERGE_MAX = 4096   # splits * k bound of the kernel's cross-range merge
_BQ, _BN = 32, 64   # the kernel's query and corpus tiles


def key_mask(query_keys: torch.Tensor, corpus_keys: torch.Tensor) -> torch.Tensor:
    """(Q, N) candidate mask: same key or a wildcard query, real rows only."""
    qk = query_keys[:, None]
    ck = corpus_keys[None, :]
    return ((qk == ck) | (qk == WILDCARD_KEY)) & (ck >= 0)


def masked_sim_topk_reference(queries, query_keys, corpus, corpus_keys,
                              k: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain version: fp32 matmul, key mask, stable descending sort, first
    k, and ``(NEG_INF, SENTINEL_IDX)`` in every slot without a candidate."""
    sims = torch.matmul(queries, corpus.T)
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


def _splits(nq: int, n: int, k: int, device: torch.device) -> int:
    """Corpus ranges per query tile: enough blocks for two per SM, at
    least one corpus tile per range, within the merge's bound."""
    sms = torch.cuda.get_device_properties(device).multi_processor_count
    q_tiles = -(-nq // _BQ)
    n_tiles = max(1, -(-n // _BN))
    want = -(-2 * sms // q_tiles)
    return max(1, min(want, n_tiles, _MERGE_MAX // k))


def masked_sim_topk(queries: torch.Tensor, query_keys: torch.Tensor,
                    corpus: torch.Tensor, corpus_keys: torch.Tensor,
                    k: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """Top-k of ``queries @ corpus.T`` per query over the rows whose key
    matches (see :func:`key_mask`), by value descending then index
    ascending.

    Args: queries ``(Q, D)`` fp32, query_keys ``(Q,)`` int32, corpus
    ``(N, D)`` fp32, corpus_keys ``(N,)`` int32, ``1 <= k <= 128``.
    Returns ``(values (Q, k) fp32, indices (Q, k) int32)``; empty slots are
    ``(NEG_INF, SENTINEL_IDX)``.
    """
    tensors = (queries, query_keys, corpus, corpus_keys)
    if queries.dtype != torch.float32 or corpus.dtype != torch.float32:
        raise TypeError("queries and corpus must be float32")
    if query_keys.dtype != torch.int32 or corpus_keys.dtype != torch.int32:
        raise TypeError("query_keys and corpus_keys must be int32")
    if queries.dim() != 2 or corpus.dim() != 2 or queries.shape[1] != corpus.shape[1]:
        raise ValueError(f"shapes {tuple(queries.shape)} and {tuple(corpus.shape)} "
                         "must be (Q, D) and (N, D)")
    nq, d = queries.shape
    n = corpus.shape[0]
    if query_keys.shape != (nq,) or corpus_keys.shape != (n,):
        raise ValueError("one key per query row and per corpus row")
    dev = queries.device
    if any(t.device != dev for t in tensors):
        raise ValueError("masked_sim_topk: all inputs must be on one device")
    if dev.type == "cpu":
        return masked_sim_topk_reference(queries, query_keys, corpus, corpus_keys, k)
    if dev.type != "cuda":
        raise ValueError(f"masked_sim_topk: unsupported device {dev}")
    if not 1 <= k <= MAX_K:
        raise ValueError(f"k must be in 1..{MAX_K}, got {k}")
    if not all(t.is_contiguous() for t in tensors):
        raise ValueError("inputs must be contiguous")
    vals = torch.empty((nq, k), dtype=torch.float32, device=dev)
    idx = torch.empty((nq, k), dtype=torch.int32, device=dev)
    if nq == 0:
        return vals, idx
    splits = _splits(nq, n, k, dev)
    part_v = part_i = None
    if splits > 1:
        part_v = torch.empty((nq, splits, k), dtype=torch.float32, device=dev)
        part_i = torch.empty((nq, splits, k), dtype=torch.int32, device=dev)
    rc = build.load("masked_sim_topk")(
        queries.data_ptr(), query_keys.data_ptr(), corpus.data_ptr(),
        corpus_keys.data_ptr(), nq, n, d, k, splits,
        None if part_v is None else part_v.data_ptr(),
        None if part_i is None else part_i.data_ptr(),
        vals.data_ptr(), idx.data_ptr(), dev.index or 0,
        torch.cuda.current_stream(dev).cuda_stream,
    )
    if rc != 0:
        raise RuntimeError(f"masked_sim_topk kernel launch failed: CUDA error {rc}")
    masked_sim_topk.launches += 1
    return vals, idx


masked_sim_topk.launches = 0
