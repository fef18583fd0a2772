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
The kernel reads only the union tiles that some query of a block admits,
by key and probe (:func:`admitted_union_tiles` is the plain version of
that prologue); the wrapper groups the queries by key for it, as K3's
does. The JAX kernel has no backward, and neither has this one.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from tpualign_torch.ops import build
from tpualign_torch.ops.sim_topk import (
    _BN, _K2_BN, _PLANES, MAX_K, SENTINEL_IDX, _blocks_per_sm, _check, _scores, _splits,
    _sweep_scratch, group_by_key, key_mask, quant_variant, query_tile, ungroup_rows)
from tpualign_torch.ops.similarity import NEG_INF, masked_topk

__all__ = ["ivf_probe_topk", "ivf_probe_topk_reference", "union_rows", "admitted_union_tiles"]

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


def admitted_union_tiles(query_keys, probes, uids, packed_keys, capacity: int, n_lists: int,
                         bq: int, bn: int) -> torch.Tensor:
    """Plain version of K4's admit prologue: a ``(ceil(Q / bq), U *
    ceil(C / bn))`` bool matrix over the union's tiles (tile t is the
    ``bn``-row slice ``t mod ceil(C / bn)`` of block ``uids[t //
    ceil(C / bn)]``), true where some query of query tile i probed the
    tile's block (or it spilled) and admits one of its rows by key. Padding
    entries and rows past the layout hold nothing. Pass the queries in the
    order the kernel takes them (grouped by key)."""
    qk = query_keys.reshape(-1)
    ck = packed_keys.reshape(-1)
    nq, per_block = qk.shape[0], -(-capacity // bn)
    q_tiles = -(-nq // bq)
    offset = torch.arange(per_block * bn, device=ck.device)
    blocks = uids.to(torch.int64)
    rows = blocks[:, None] * capacity + offset[None, :]
    real = ((blocks >= 0) & (blocks != n_lists))[:, None] & (offset < capacity)[None, :] \
        & (rows < ck.shape[0])
    keys = torch.where(real, ck[rows.clamp(0, ck.shape[0] - 1)], -1).reshape(-1)
    member = _membership(probes, blocks.clamp(min=0), n_lists) & (blocks >= 0)[None, :]
    out = torch.zeros((q_tiles, len(uids) * per_block), dtype=torch.bool, device=ck.device)
    for i in range(q_tiles):
        s = slice(i * bq, (i + 1) * bq)
        m = key_mask(qk[s], keys) & member[s].repeat_interleave(per_block * bn, dim=1)
        out[i] = m.any(dim=0).view(-1, bn).any(dim=1)
    return out


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
    quantized = variant in _PLANES
    if quantized and d % (4 * _PLANES[variant]):
        raise ValueError(f"the {variant} kernel needs D a multiple of "
                         f"{4 * _PLANES[variant]}, got {d}")
    vals = torch.empty((nq, k), dtype=torch.float32, device=dev)
    idx = torch.empty((nq, k), dtype=torch.int32, device=dev)
    if nq == 0:
        return vals, idx
    bq = query_tile(variant, nq)
    order = group_by_key(qk) if nq > bq else None
    if order is not None:
        queries, qk, probes = queries[order], qk[order], probes[order]
    bn = _K2_BN if variant is None else _BN
    n_tiles = len(uids) * -(-capacity // bn)
    splits = _splits(nq, n_tiles, dev, bq, _blocks_per_sm(variant, bq))
    buf, (qq, qs, bits, admitted, part_v, part_i) = _sweep_scratch(
        dev, nq, d, k, splits, bq, n_tiles, quantized, nq * -(-n_lists // 32) * 4)
    rc = build.call(
        "ivf_probe_topk", dev, _VARIANT_CODE[variant], queries.data_ptr(), qk.data_ptr(), probes.data_ptr(),
        probes.shape[1], uids.data_ptr(), len(uids), packed_emb.data_ptr(),
        None if packed_scales is None else packed_scales.data_ptr(), ck.data_ptr(),
        packed_emb.shape[0], capacity, n_lists, nq, d, k, splits, bq, qq, qs, bits, admitted,
        part_v, part_i, vals.data_ptr(), idx.data_ptr(),
    )
    if rc != 0:
        raise RuntimeError(f"ivf_probe_topk kernel launch failed: CUDA error {rc}")
    ivf_probe_topk.launches += 1
    if order is None:
        return vals, idx
    return ungroup_rows(vals, order), ungroup_rows(idx, order)


ivf_probe_topk.launches = 0
