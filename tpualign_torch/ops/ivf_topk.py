"""IVF probed top-k over a packed cluster layout (kernel K4).

``ivf_probe_topk`` replaces the Pallas TPU kernel
``tpualign/ops/pallas_kernels.py::ivf_probe_topk`` (body
``_make_ivf_topk_kernel``) and takes its signature. The layout holds
cluster blocks of ``capacity`` rows (block ``b`` is packed rows
``b*C .. b*C + C - 1``); the call visits the blocks listed in ``uids``.
Query ``q`` takes a row of block ``b`` when

    key_mask(q, row)  and  (q probed b  or  b > n_lists)

so spill blocks (``b > n_lists``) are scanned by every query, and entries
``b == n_lists`` (padding) are skipped. Per query it returns the top-k by
value descending, then packed row ascending, with ``(NEG_INF,
SENTINEL_IDX)`` in empty slots. Like the JAX function it dispatches on the
layout over the five scorers of K2 and K3 (``ops/sim_topk.py``): fp32; int8
with row scales, dequantized, or as s8 products with ``int8_mxu``; packed
int4 ``(rows, D/2)``; packed int2 ``(rows, D/4)``.

On CUDA tensors it launches ``csrc/ivf_probe_topk.cu``; on CPU tensors it
runs :func:`ivf_probe_topk_reference`, the plain version of every variant.
The JAX kernel has no backward, and neither has this one.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from tpualign_torch.ops import build
from tpualign_torch.ops.sim_topk import (
    _BN, _BQ, _PLANES, MAX_K, SENTINEL_IDX, _check, _launch_args, _ptr, _scores, _splits,
    key_mask, quant_variant, quantize_queries)
from tpualign_torch.ops.similarity import NEG_INF, masked_topk

__all__ = ["ivf_probe_topk", "ivf_probe_topk_reference", "union_rows"]

# K4's variant codes (csrc/ivf_probe_topk.cu)
_VARIANT_CODE = {"s8": 0, "int4": 1, "int2": 2, "dequant": 3, None: 4}


def union_rows(uids: torch.Tensor, capacity: int, n_lists: int
               ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The blocks ``uids`` lists, padding dropped, ascending, and their
    packed rows in ascending order: ``(blocks (U',), rows (U' * C,))``."""
    blocks = torch.sort(uids[(uids >= 0) & (uids != n_lists)].to(torch.int64)).values
    rows = blocks[:, None] * capacity + torch.arange(capacity, device=uids.device)
    return blocks, rows.reshape(-1)


def _membership(probes: torch.Tensor, blocks: torch.Tensor, n_lists: int) -> torch.Tensor:
    """(Q, U') bool: query q takes block j, because it probed it or it spilled."""
    nq = probes.shape[0]
    probed = torch.zeros((nq, n_lists + 1), dtype=torch.bool, device=probes.device)
    real = (probes >= 0) & (probes < n_lists)
    probed.scatter_(1, torch.where(real, probes, n_lists).to(torch.int64), True)
    probed[:, n_lists] = False
    return probed[:, blocks.clamp(max=n_lists)] | (blocks > n_lists)[None, :]


def ivf_probe_topk_reference(queries, query_keys, probes, uids, packed_emb, packed_keys,
                             k: int, capacity: int, n_lists: int,
                             packed_scales: Optional[torch.Tensor] = None,
                             int8_mxu: bool = False) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain version of every variant: scores the union's rows densely with
    the variant's scorer (the integer product exact: int32 on the CPU,
    float64 on the card), applies the key mask and the probe membership with
    the spill rule, and takes a stable top-k by value descending, then
    packed row ascending."""
    qk = query_keys.reshape(-1)
    ck = packed_keys.reshape(-1)
    variant = quant_variant(packed_emb, queries.shape[1], packed_scales, int8_mxu)
    blocks, rows = union_rows(uids, capacity, n_lists)
    rows = rows[rows < packed_emb.shape[0]]
    scales = packed_scales[rows] if packed_scales is not None else None
    sims = _scores(queries, packed_emb[rows], scales, variant)
    member = _membership(probes, blocks, n_lists).repeat_interleave(capacity, dim=1)
    mask = key_mask(qk, ck[rows]) & member[:, :len(rows)]
    vals, pos = masked_topk(sims, mask, k)
    empty = ~torch.gather(mask, 1, pos)
    vals = vals.masked_fill(empty, NEG_INF)
    idx = rows[pos].to(torch.int32).masked_fill(empty, SENTINEL_IDX)
    if vals.shape[1] < k:  # fewer union rows than k
        pad = k - vals.shape[1]
        vals = torch.nn.functional.pad(vals, (0, pad), value=NEG_INF)
        idx = torch.nn.functional.pad(idx, (0, pad), value=SENTINEL_IDX)
    return vals, idx


def ivf_probe_topk(queries: torch.Tensor, query_keys: torch.Tensor, probes: torch.Tensor,
                   uids: torch.Tensor, packed_emb: torch.Tensor, packed_keys: torch.Tensor,
                   k: int, capacity: int, n_lists: int, block_q: int = 64,
                   packed_scales: Optional[torch.Tensor] = None,
                   int8_mxu: bool = False) -> Tuple[torch.Tensor, torch.Tensor]:
    """Top-k over the probed blocks of an IVF packed layout (see the module
    notes).

    Args: queries ``(Q, D)`` fp32; query_keys ``(Q,)`` or ``(Q, 1)`` int32
    (-2 padding, -3 wildcard); probes ``(Q, P)`` int32 cluster ids; uids
    ``(U,)`` int32 block ids, each at most once; packed_emb ``(rows, D)``
    fp32, or with ``packed_scales`` ``(rows,)`` fp32 ``(rows, D)`` int8 or
    packed ``(rows, D/2)``/``(rows, D/4)`` uint8; packed_keys ``(rows,)`` or
    ``(1, rows)`` int32, -1 for unused slots; ``1 <= k <= 128``.
    ``block_q`` is accepted for tpualign's signature: the kernel picks its
    own query tiles, and Q need not be a multiple of it. Returns
    ``(values (Q, k) fp32, packed rows (Q, k) int32)``.
    """
    qk = query_keys.reshape(-1)
    ck = packed_keys.reshape(-1)
    dev, tensors = _check(queries, qk, packed_emb, ck, packed_scales)
    nq = queries.shape[0]
    if probes.dtype != torch.int32 or uids.dtype != torch.int32:
        raise TypeError("probes and uids must be int32")
    if probes.dim() != 2 or probes.shape[0] != nq or uids.dim() != 1:
        raise ValueError(f"probes must be (Q, P) and uids (U,); got {tuple(probes.shape)} "
                         f"and {tuple(uids.shape)} for Q={nq}")
    if probes.device != dev or uids.device != dev:
        raise ValueError("ivf_probe_topk: all inputs must be on one device")
    if dev.type == "cpu":
        return ivf_probe_topk_reference(queries, qk, probes, uids, packed_emb, ck, k, capacity,
                                        n_lists, packed_scales, int8_mxu)
    if not 1 <= k <= MAX_K:
        raise ValueError(f"k must be in 1..{MAX_K}, got {k}")
    if capacity < 1 or n_lists < 1:
        raise ValueError(f"capacity and n_lists must be positive, got {capacity}, {n_lists}")
    if not all(t.is_contiguous() for t in tensors + [probes, uids]):
        raise ValueError("inputs must be contiguous")
    variant = quant_variant(packed_emb, queries.shape[1], packed_scales, int8_mxu)
    d = queries.shape[1]
    if variant in _PLANES:
        if d % (4 * _PLANES[variant]):
            raise ValueError(f"the {variant} kernel needs D a multiple of "
                             f"{4 * _PLANES[variant]}, got {d}")
        qq, qs = quantize_queries(queries)
    else:
        qq, qs = queries, None
    per_block = -(-capacity // _BN)
    splits = _splits(nq, len(uids) * per_block * _BN, k, dev, _BQ[variant]) if nq else 1
    vals, idx, part_v, part_i = _launch_args(nq, k, splits, dev)
    if nq == 0:
        return vals, idx
    bits = torch.empty((nq, -(-n_lists // 32)), dtype=torch.int32, device=dev)
    rc = build.load("ivf_probe_topk")(
        _VARIANT_CODE[variant], qq.data_ptr(), _ptr(qs), qk.data_ptr(), probes.data_ptr(),
        probes.shape[1], uids.data_ptr(), len(uids), packed_emb.data_ptr(), _ptr(packed_scales),
        ck.data_ptr(), packed_emb.shape[0], capacity, n_lists, nq, d, k, splits,
        bits.data_ptr(), _ptr(part_v), _ptr(part_i), vals.data_ptr(), idx.data_ptr(),
        dev.index or 0, torch.cuda.current_stream(dev).cuda_stream,
    )
    if rc != 0:
        raise RuntimeError(f"ivf_probe_topk kernel launch failed: CUDA error {rc}")
    ivf_probe_topk.launches += 1
    return vals, idx


ivf_probe_topk.launches = 0
