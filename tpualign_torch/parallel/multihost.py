"""Processes across hosts (the port's ``tpualign.parallel.multihost``).

One process drives every card it can see; several processes, on one host
or on several, join one ``torch.distributed`` process group and lay one
``(data, model)`` mesh over all their cards, process-major, as
``jax.devices()`` orders a multi-process runtime. A ``model`` row lies
inside one process (its tensor-parallel parts exchange by ``.to()``), so
only the ``data`` axis crosses processes, and it does so through
collectives on each process's first device (:attr:`Mesh.home`): the
sharded search all-gathers every process's ``(Q, k)`` winners and merges
them, and the sharded train step all-gathers the features of every data
row and sums the gradients over the processes.

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
           "process_sum"]


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


def process_sum(mesh: Mesh, tensors: List[torch.Tensor]) -> List[torch.Tensor]:
    """Each tensor summed over the processes of ``mesh`` (one all-reduce a
    dtype, flattened on the home device); returns new tensors on the
    tensors' own devices. Every process passes the same shapes in the same
    order."""
    out: List[Optional[torch.Tensor]] = [None] * len(tensors)
    by_dtype: dict = {}
    for n, t in enumerate(tensors):
        by_dtype.setdefault(t.dtype, []).append(n)
    for dtype in sorted(by_dtype, key=str):
        at = by_dtype[dtype]
        flat = torch.cat([tensors[n].reshape(-1).to(mesh.home) for n in at])
        dist.all_reduce(flat)
        start = 0
        for n in at:
            size = tensors[n].numel()
            out[n] = flat[start:start + size].reshape(tensors[n].shape).to(tensors[n].device)
            start += size
    return out
