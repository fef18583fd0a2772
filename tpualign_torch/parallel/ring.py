"""Ring-scheduled corpus-scale retrieval (the port's
``tpualign.parallel.ring``).

The corpus shards stay resident, one per data device of the mesh, and the
queries are sharded too: block ``b`` of ``Q / D`` queries starts on device
``b``. At each of the D steps every device scores the block it holds with
K2 against its resident shard (``min(k, n_local)`` winners, offset to
global indices), merges them into that block's running top-k by (value
desc, index asc), and the block, its keys and its running state move to
the next device with a ``.to(next_device, non_blocking=True)`` copy, which
is ordered on both cards' streams. After D steps every block has met every
shard once, and one more move brings it home. The results are then
gathered on the first device: bit-identical to the gather strategy, since
the two-key order is a total order on distinct indices.

On a mesh of one process, one process drives every card (see
``parallel/mesh.py``); a device that a mesh repeats moves nothing. On a
mesh across processes (``parallel/multihost.py``) every process holds the
blocks of its own cards: a block moves between its cards with ``.to()``,
and from the last card of one process to the first card of the next as its
running state by point-to-point messages through the process group
(``dist.batch_isend_irecv``: each process posts its send and its receive
of a step together, so that none waits on another; the receiver takes the
block's queries from its own copy, since every process is given them all).
The blocks are then all-gathered, so every process holds every query's
answer.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np
import torch
import torch.distributed as dist

from tpualign_torch.ops.sim_topk import SENTINEL_IDX
from tpualign_torch.ops.similarity import NEG_INF
from tpualign_torch.parallel.mesh import Mesh, ShardedRows, shard_devices
from tpualign_torch.parallel.retrieval import (
    _device_topk, _offset, _padded, _tensor, _two_key_topk)

__all__ = ["ring_topk_search", "ring_search_fn"]


def _merge_topk(run_vals, run_idx, vals, idx, k: int):
    """Merges the (Qb, k) running state with (Qb, m) candidates into the
    new (Qb, k), exactly: the two-key (value desc, index asc) top-k."""
    return _two_key_topk(torch.cat([run_vals, vals], dim=1), torch.cat([run_idx, idx], dim=1), k)


def ring_search_fn(mesh: Mesh, k: int):
    """The ring search over ``mesh``'s data axis: a function of queries
    ``(Q, D)`` fp32 and their keys ``(Q,)`` int32 (Q a multiple of the data
    axis) and the corpus and its keys as :class:`ShardedRows` over that
    axis (the sharded index's layout), returning ``(values, indices)`` of
    shape ``(Q, k)`` on the first device; empty slots hold ``(NEG_INF,
    SENTINEL_IDX)``, and pad rows may appear when a query has fewer than k
    candidates."""
    devices = shard_devices(mesh)
    local = mesh.local_rows

    def run(queries: torch.Tensor, query_keys: torch.Tensor, corpus: ShardedRows,
            corpus_keys: ShardedRows) -> Tuple[torch.Tensor, torch.Tensor]:
        n_dev, n_local = len(devices), corpus.rows_per_shard
        if queries.shape[0] % n_dev:
            raise ValueError(f"ring: {queries.shape[0]} queries is not a multiple of the "
                             f"data axis ({n_dev})")
        qb, k_local = queries.shape[0] // n_dev, min(k, n_local)

        def block_inputs(b: int, dev) -> list:
            rows = slice(b * qb, (b + 1) * qb)
            return [queries[rows].to(dev, non_blocking=True),
                    query_keys[rows].to(dev, non_blocking=True)]

        # held[d]: the block on device d, as [queries, keys, running values,
        # running indices]; block b starts on device b
        held = {b: block_inputs(b, devices[b])
                + [torch.full((qb, k), NEG_INF, dtype=torch.float32, device=devices[b]),
                   torch.full((qb, k), SENTINEL_IDX, dtype=torch.int32, device=devices[b])]
                for b in local}
        # D steps: device d scores block (d - step) mod D against its shard,
        # then hands the block on; the last move brings every block home
        for step in range(n_dev):
            for d in local:
                q, qk, run_v, run_i = held[d]
                vals, idx = _device_topk(q, qk, corpus.parts[d], corpus_keys.parts[d], None,
                                         k_local)
                held[d][2:] = _merge_topk(run_v, run_i, vals, _offset(idx, d * n_local), k)
            held = _hand_on(mesh, held, step, block_inputs, qb, k)
        blocks = [held[b] for b in local]  # every block is back where it started
        home = mesh.home
        vals = torch.cat([b[2].to(home, non_blocking=True) for b in blocks])
        idx = torch.cat([b[3].to(home, non_blocking=True) for b in blocks])
        if mesh.distributed:
            from tpualign_torch.parallel.multihost import process_gather

            vals, idx = torch.cat(process_gather(mesh, vals)), torch.cat(process_gather(mesh, idx))
        return vals, idx

    return run


def _hand_on(mesh: Mesh, held: dict, step: int, block_inputs, qb: int, k: int) -> dict:
    """Every held block moved to the next data device: by ``.to()`` where
    this process holds it, else its running state sent to the process that
    does, while the block coming from the previous device of another
    process is received (both posted in one ``batch_isend_irecv``, through
    the home device)."""
    devices, n_dev = mesh.data_devices, len(mesh.data_devices)
    out, ops, incoming = {}, [], []
    for d in sorted(held):
        block = held[d]
        nxt = (d + 1) % n_dev
        if mesh.is_local(nxt):
            out[nxt] = [t.to(devices[nxt], non_blocking=True) for t in block]
        else:
            ops += [dist.P2POp(dist.isend, t.to(mesh.home).contiguous(), mesh.processes[nxt])
                    for t in block[2:]]
        prev = (d - 1) % n_dev
        if not mesh.is_local(prev):
            bufs = [torch.empty((qb, k), dtype=torch.float32, device=mesh.home),
                    torch.empty((qb, k), dtype=torch.int32, device=mesh.home)]
            ops += [dist.P2POp(dist.irecv, t, mesh.processes[prev]) for t in bufs]
            incoming.append((d, bufs))
    if ops:
        for work in dist.batch_isend_irecv(ops):
            work.wait()
    for d, bufs in incoming:
        b = (d - step - 1) % n_dev  # the block that device d holds next
        out[d] = block_inputs(b, devices[d]) + [t.to(devices[d]) for t in bufs]
    return out


def ring_topk_search(queries: np.ndarray, query_keys: np.ndarray, corpus: np.ndarray,
                     corpus_keys: np.ndarray, k: int, mesh: Mesh
                     ) -> Tuple[np.ndarray, np.ndarray]:
    """Ring-scheduled top-k search over a ``(data, model)`` mesh's data
    axis, with :func:`~tpualign_torch.parallel.retrieval.sharded_topk_search`'s
    contract: ``(values, indices)`` of shape ``(Q, k)``, ``(NEG_INF, -1)``
    in slots without a candidate."""
    queries = np.asarray(queries, np.float32)
    corpus = np.asarray(corpus, np.float32)
    nq, n = len(queries), len(corpus)
    devices = shard_devices(mesh)
    shards = len(devices)
    if nq == 0 or n == 0:
        return np.full((nq, k), NEG_INF, np.float32), np.full((nq, k), -1, np.int64)
    n_local = -(-n // shards)
    corpus = _padded(corpus, n_local * shards, 0.0)
    corpus_keys = _padded(np.asarray(corpus_keys, np.int32), n_local * shards, -1)
    rows = ShardedRows([_tensor(corpus[s * n_local:(s + 1) * n_local], dev)
                        if mesh.is_local(s) else None for s, dev in enumerate(devices)])
    keys = ShardedRows([_tensor(corpus_keys[s * n_local:(s + 1) * n_local], dev)
                        if mesh.is_local(s) else None for s, dev in enumerate(devices)])
    q_pad = -(-nq // shards) * shards  # pad queries keyed -2 (they match nothing)
    q = _tensor(_padded(queries, q_pad, 0.0), mesh.home)
    qk = _tensor(_padded(np.asarray(query_keys, np.int32), q_pad, -2), mesh.home)
    vals, idx = ring_search_fn(mesh, k)(q, qk, rows, keys)
    vals, idx = vals[:nq].cpu().numpy(), idx[:nq].cpu().numpy().astype(np.int64)
    bad = (vals <= NEG_INF / 2) | (idx >= n)
    return np.where(bad, NEG_INF, vals).astype(np.float32), np.where(bad, -1, idx)
