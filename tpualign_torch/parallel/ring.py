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

One process drives every card (see ``parallel/mesh.py``); a device that a
mesh repeats moves nothing.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np
import torch

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

    def run(queries: torch.Tensor, query_keys: torch.Tensor, corpus: ShardedRows,
            corpus_keys: ShardedRows) -> Tuple[torch.Tensor, torch.Tensor]:
        n_dev, n_local = len(devices), corpus.rows_per_shard
        if queries.shape[0] % n_dev:
            raise ValueError(f"ring: {queries.shape[0]} queries is not a multiple of the "
                             f"data axis ({n_dev})")
        qb, k_local = queries.shape[0] // n_dev, min(k, n_local)
        blocks = []
        for b, dev in enumerate(devices):
            rows = slice(b * qb, (b + 1) * qb)
            blocks.append([queries[rows].to(dev, non_blocking=True),
                           query_keys[rows].to(dev, non_blocking=True),
                           torch.full((qb, k), NEG_INF, dtype=torch.float32, device=dev),
                           torch.full((qb, k), SENTINEL_IDX, dtype=torch.int32, device=dev)])
        # D steps: device d scores block (d - step) mod D against its shard,
        # then hands the block on; the last move brings every block home
        for step in range(n_dev):
            for d, dev in enumerate(devices):
                block = blocks[(d - step) % n_dev]
                q, qk, run_v, run_i = block
                vals, idx = _device_topk(q, qk, corpus.parts[d], corpus_keys.parts[d], None,
                                         k_local)
                run_v, run_i = _merge_topk(run_v, run_i, vals, _offset(idx, d * n_local), k)
                nxt = devices[(d + 1) % n_dev]
                block[:] = [t.to(nxt, non_blocking=True) for t in (q, qk, run_v, run_i)]
        home = devices[0]
        return (torch.cat([b[2].to(home, non_blocking=True) for b in blocks]),
                torch.cat([b[3].to(home, non_blocking=True) for b in blocks]))

    return run


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
                        for s, dev in enumerate(devices)])
    keys = ShardedRows([_tensor(corpus_keys[s * n_local:(s + 1) * n_local], dev)
                        for s, dev in enumerate(devices)])
    q_pad = -(-nq // shards) * shards  # pad queries keyed -2 (they match nothing)
    q = _tensor(_padded(queries, q_pad, 0.0), devices[0])
    qk = _tensor(_padded(np.asarray(query_keys, np.int32), q_pad, -2), devices[0])
    vals, idx = ring_search_fn(mesh, k)(q, qk, rows, keys)
    vals, idx = vals[:nq].cpu().numpy(), idx[:nq].cpu().numpy().astype(np.int64)
    bad = (vals <= NEG_INF / 2) | (idx >= n)
    return np.where(bad, NEG_INF, vals).astype(np.float32), np.where(bad, -1, idx)
