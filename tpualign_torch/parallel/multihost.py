"""Processes across hosts (the port's ``tpualign.parallel.multihost``).

One process drives every card it can see; several processes, on one host
or on several, join one ``torch.distributed`` process group and lay one
``(data, model)`` mesh over all their cards, process-major, as
``jax.devices()`` orders a multi-process runtime. A ``model`` row lies
inside one process (its tensor-parallel parts exchange by ``.to()``), so
only the ``data`` axis crosses processes, and it does so through
collectives on each process's first device (:attr:`Mesh.home`): the
sharded search all-gathers every process's ``(Q, k)`` winners and merges
them; the sharded train step all-gathers the features of every data row
and sums the gradients over the processes, and under FSDP all-gathers the
parameter slices before use (:func:`process_gather_all`) and
reduce-scatters their gradients (:func:`process_reduce_scatter`); the
index's mutations broadcast the shards whose rows change process; the ring
hands its blocks from process to process point to point. NCCL runs the
collectives on the cards and gloo on the CPU; gloo has no reduce-scatter,
so there every process all-reduces and keeps its own part.

Start each process with ``COORDINATOR_ADDRESS`` (``host:port`` of process
0), ``NUM_PROCESSES`` and ``PROCESS_ID`` in its environment, and, on a
host with several processes, ``CUDA_VISIBLE_DEVICES`` naming its cards;
then :func:`initialize_distributed` and :func:`hybrid_mesh`.
"""

from __future__ import annotations

import os
from typing import List, Optional, Sequence

import numpy as np
import torch
import torch.distributed as dist

from tpualign_torch.parallel.mesh import Mesh
from tpualign_torch.utils.logging import get_logger

log = get_logger("parallel.multihost")

__all__ = ["initialize_distributed", "hybrid_mesh", "hybrid_device_order", "process_gather",
           "process_gather_all", "process_broadcast", "process_sum", "process_reduce_scatter",
           "process_barrier"]


def initialize_distributed(
    coordinator_address: Optional[str] = None,
    num_processes: Optional[int] = None,
    process_id: Optional[int] = None,
) -> bool:
    """Join the process group from the arguments or the environment
    (``COORDINATOR_ADDRESS`` / ``NUM_PROCESSES`` / ``PROCESS_ID``), with the
    ``tcp://`` init method at the coordinator's address: NCCL where this
    process sees CUDA cards, gloo elsewhere. Returns True when a process group was started, False when
    no coordinator is named (one process)."""
    coordinator_address = coordinator_address or os.environ.get("COORDINATOR_ADDRESS")
    if not coordinator_address:
        return False
    num_processes = num_processes or int(os.environ.get("NUM_PROCESSES", "1"))
    process_id = process_id if process_id is not None else int(
        os.environ.get("PROCESS_ID", "0"))
    backend = "nccl" if torch.cuda.is_available() and torch.cuda.device_count() else "gloo"
    address = (coordinator_address if "://" in coordinator_address
               else f"tcp://{coordinator_address}")
    dist.init_process_group(backend, init_method=address, world_size=num_processes,
                            rank=process_id)
    log.info("process group up (%s): process %d/%d", backend, process_id, num_processes)
    return True


def hybrid_device_order(
    slice_ids: Sequence[int], model_parallel: int
) -> np.ndarray:
    """(data, model) index grid over devices with the given slice ids.

    The invariant that makes the layout DCN-safe: every ``model`` row is
    ``model_parallel`` devices from ONE slice (TP activation collectives
    ride ICI, never DCN); the ``data`` axis is slice-major, so the only
    collective that crosses DCN is the once-per-step gradient psum —
    exactly the axis that tolerates DCN latency (scaling-book recipe).

    Pure function of the slice assignment so the layout rule is testable
    without pod hardware. Raises when any slice's device count is not
    divisible by ``model_parallel``.
    """
    ids = np.asarray(slice_ids)
    n = len(ids)
    if n % model_parallel:
        raise ValueError(
            f"{n} devices not divisible by model={model_parallel}"
        )
    order = []
    for s in sorted(set(int(i) for i in ids)):
        members = np.flatnonzero(ids == s)
        if len(members) % model_parallel:
            raise ValueError(
                f"slice {s} has {len(members)} devices, not divisible by "
                f"model={model_parallel} — a TP group would straddle DCN"
            )
        order.append(members.reshape(-1, model_parallel))
    return np.concatenate(order, axis=0)


def hybrid_mesh(
    model_parallel: int = 1,
    axis_names: Sequence[str] = ("data", "model"),
    devices: Optional[Sequence] = None,
) -> Mesh:
    """The ``(data, model)`` mesh over every process's devices, process-major
    (:func:`hybrid_device_order` with the process as the slice: a model
    row never spans two processes). A process contributes ``devices``, by
    default every CUDA card it sees; ``["cpu"] * 2`` stands in for two
    devices; every process brings as many. Without a process group it is
    the mesh of this process alone. A process's first card becomes its
    current card (NCCL's collectives run there)."""
    local = [torch.device(d) for d in (devices if devices is not None else
                                       [f"cuda:{i}" for i in range(torch.cuda.device_count())])]
    if not local:
        raise ValueError("hybrid_mesh: this process has no device")
    if local[0].type == "cuda":
        torch.cuda.set_device(local[0])
    if dist.is_available() and dist.is_initialized():
        rank, world = dist.get_rank(), dist.get_world_size()
        names: List[Optional[list]] = [None] * world
        dist.all_gather_object(names, [str(d) for d in local])
    else:
        rank, world, names = 0, 1, [[str(d) for d in local]]
    if len({len(ds) for ds in names}) > 1:
        raise ValueError(f"every process must bring as many devices; they bring "
                         f"{[len(ds) for ds in names]}")
    flat = [(p, torch.device(d) if p != rank else local[k])
            for p, ds in enumerate(names) for k, d in enumerate(ds)]
    order = hybrid_device_order([p for p, _ in flat], model_parallel)
    grid = np.empty(order.shape, dtype=object)
    for idx, at in np.ndenumerate(order):
        grid[idx] = flat[at][1]
    processes = [flat[row[0]][0] for row in order]
    return Mesh(grid, axis_names, processes=processes if world > 1 else None, rank=rank)


def _ranks(mesh: Mesh) -> List[int]:
    return sorted(set(mesh.processes))


def process_gather(mesh: Mesh, t: torch.Tensor) -> List[torch.Tensor]:
    """``t`` of every process of ``mesh`` (equal shapes), in process order,
    on this process's home device; this process's entry is ``t`` itself
    (so autograd sees through it, and through nothing else)."""
    t = t.to(mesh.home)
    out = [torch.empty_like(t) for _ in _ranks(mesh)]
    dist.all_gather(out, t.detach().contiguous())
    out[_ranks(mesh).index(mesh.rank)] = t
    return out


def _by_dtype(tensors: List[torch.Tensor]) -> List[List[int]]:
    """The positions of ``tensors`` grouped by dtype, in a fixed order."""
    groups: dict = {}
    for n, t in enumerate(tensors):
        groups.setdefault(t.dtype, []).append(n)
    return [groups[d] for d in sorted(groups, key=str)]


def process_gather_all(mesh: Mesh, tensors: List[torch.Tensor]) -> List[List[torch.Tensor]]:
    """Every process's ``tensors`` (each process passes the same shapes and
    dtypes in the same order), in process order, on this process's home
    device: one :func:`process_gather` a dtype over the flattened tensors.
    This process's entry is its own list; the others' are new tensors."""
    ranks = _ranks(mesh)
    out: List[List[Optional[torch.Tensor]]] = [[None] * len(tensors) for _ in ranks]
    out[ranks.index(mesh.rank)] = list(tensors)
    for at in _by_dtype(tensors):
        flat = torch.cat([tensors[n].detach().reshape(-1).to(mesh.home) for n in at])
        for p, buf in enumerate(process_gather(mesh, flat)):
            if ranks[p] == mesh.rank:
                continue
            start = 0
            for n in at:
                size = tensors[n].numel()
                out[p][n] = buf[start:start + size].reshape(tensors[n].shape)
                start += size
    return out


def process_broadcast(mesh: Mesh, t: Optional[torch.Tensor], shape, dtype: torch.dtype,
                      src: int) -> torch.Tensor:
    """Process ``src``'s ``t`` on every process of ``mesh``, on this
    process's home device; the other processes pass its ``shape`` and
    ``dtype`` (``t`` is not read there)."""
    buf = (t.to(mesh.home).contiguous() if mesh.rank == src
           else torch.empty(shape, dtype=dtype, device=mesh.home))
    dist.broadcast(buf, src=src)
    return buf


def process_reduce_scatter(mesh: Mesh, parts: List[List[torch.Tensor]]) -> List[torch.Tensor]:
    """``parts[p]`` is what this process adds to process ``p``'s tensors
    (process order; every process passes the same shapes): returns this
    process's tensors summed over every process, on its home device. NCCL
    reduce-scatters one buffer a dtype; gloo has no reduce-scatter, so
    there the buffer is all-reduced and each process keeps its part."""
    ranks = _ranks(mesh)
    mine = parts[ranks.index(mesh.rank)]
    out: List[Optional[torch.Tensor]] = [None] * len(mine)
    for at in _by_dtype(mine):
        chunks = [torch.cat([parts[p][n].reshape(-1).to(mesh.home) for n in at])
                  for p in range(len(ranks))]
        if dist.get_backend() == "nccl":
            flat = torch.empty_like(chunks[0])
            dist.reduce_scatter_tensor(flat, torch.cat(chunks))
        else:
            whole = torch.cat(chunks)
            dist.all_reduce(whole)
            size = chunks[0].numel()
            flat = whole[ranks.index(mesh.rank) * size:(ranks.index(mesh.rank) + 1) * size]
        start = 0
        for n in at:
            size = mine[n].numel()
            out[n] = flat[start:start + size].reshape(mine[n].shape)
            start += size
    return out


def process_barrier(mesh: Mesh) -> None:
    """Wait until every process of ``mesh`` arrives (on its home card
    under NCCL)."""
    if dist.get_backend() == "nccl":
        dist.barrier(device_ids=[mesh.home.index])
    else:
        dist.barrier()


def process_sum(mesh: Mesh, tensors: List[torch.Tensor]) -> List[torch.Tensor]:
    """Each tensor summed over the processes of ``mesh`` (one all-reduce a
    dtype, flattened on the home device); returns new tensors on the
    tensors' own devices. Every process passes the same shapes in the same
    order."""
    out: List[Optional[torch.Tensor]] = [None] * len(tensors)
    for at in _by_dtype(tensors):
        flat = torch.cat([tensors[n].reshape(-1).to(mesh.home) for n in at])
        dist.all_reduce(flat)
        start = 0
        for n in at:
            size = tensors[n].numel()
            out[n] = flat[start:start + size].reshape(tensors[n].shape).to(tensors[n].device)
            start += size
    return out
