"""The device mesh of one host (the port's ``tpualign.parallel.mesh``).

Axes: ``data`` (the corpus of exact retrieval, the batches of the
embedding engine and of the train step are split over it) and ``model``
(tensor parallelism for the towers, ``parallel/sharding.py``). A
:class:`Mesh` is a ``(data, model)`` grid of ``torch.device``s that one
process drives, as one JAX controller drives the chips ``jax.devices()``
lists on a TPU host. Each data row is a model row of devices: the row's
first device holds its corpus shard and its slice of a batch, and each
device of the row holds one tensor-parallel part of the towers
(``ShardedTensor`` gathers parts to one device and scatters a tensor back
into them). Kernels launch on each device's current stream, which runs
asynchronously across the cards, and results are gathered on the first
device. A mesh whose rows span processes (on one host or several) is built
by ``parallel/multihost.py``'s ``hybrid_mesh``: each process then holds
its own rows, and the data axis crosses processes through collectives.

Without ``devices`` a mesh takes the visible CUDA cards in order and never
repeats one. An explicit list may repeat a device: ``[torch.device("cpu")]
* 8`` stands in for tpualign's eight virtual CPU devices in the tests, and
``[cuda:0] * 4`` runs four shards on one card.

:class:`ShardedRows` is a tensor split by rows over a mesh's data devices,
the layout of the sharded index (``parallel/retrieval.py``).
"""

from __future__ import annotations

from typing import List, Optional, Sequence

import numpy as np
import torch

from tpualign_torch.config import MeshConfig

__all__ = ["Mesh", "ShardedRows", "create_mesh", "default_mesh", "one_process",
           "shard_devices"]


class Mesh:
    """A ``(data, model)`` grid of devices: ``devices`` (an object array of
    that shape), ``axis_names`` and ``shape`` (axis name -> size, as
    ``mesh.shape["data"]`` is read throughout tpualign). ``processes`` (one
    rank a data row, ascending) and ``rank`` make it a mesh across
    processes; None is one process holding every row."""

    def __init__(self, devices: np.ndarray, axis_names: Sequence[str] = ("data", "model"),
                 processes: Optional[Sequence[int]] = None, rank: int = 0):
        if devices.ndim != 2 or len(axis_names) != 2:
            raise ValueError(f"a mesh is a 2-D grid with two axis names, got shape "
                             f"{devices.shape} and {tuple(axis_names)}")
        self.devices = devices
        self.axis_names = tuple(axis_names)
        self.shape = dict(zip(self.axis_names, devices.shape))
        self.processes = None if processes is None else [int(p) for p in processes]
        self.rank = int(rank)
        if self.processes is not None:
            if len(self.processes) != devices.shape[0] or self.processes != sorted(self.processes):
                raise ValueError(f"processes {self.processes} must name each of the "
                                 f"{devices.shape[0]} data rows, in ascending order")
            if self.rank not in self.processes:
                raise ValueError(f"process {self.rank} holds no row of the mesh")
        self.local_rows = [i for i in range(devices.shape[0]) if self.is_local(i)]

    @property
    def distributed(self) -> bool:
        """True when the rows span more than one process."""
        return self.processes is not None and len(set(self.processes)) > 1

    def is_local(self, i: int) -> bool:
        """Whether this process holds data row ``i``."""
        return self.processes is None or self.processes[i] == self.rank

    @property
    def home(self) -> torch.device:
        """The first device of this process's first row: where its results
        gather and its collectives run."""
        return self.devices[self.local_rows[0], 0]

    @property
    def data_devices(self) -> List[torch.device]:
        """The home of each data shard: the first device of each model row."""
        return [self.devices[i, 0] for i in range(self.devices.shape[0])]

    def row(self, i: int) -> List[torch.device]:
        """Data row ``i``'s model row: the devices its tensor-parallel parts
        lie on, its home first."""
        return list(self.devices[i])


def _visible_cards() -> List[torch.device]:
    return [torch.device("cuda", i) for i in range(torch.cuda.device_count())]


def create_mesh(data: int, model: int = 1, devices: Optional[Sequence] = None,
                axis_names: Sequence[str] = ("data", "model")) -> Mesh:
    """A ``(data, model)`` mesh of the first ``data * model`` of ``devices``,
    by default the visible CUDA cards in order; raises ``ValueError`` when
    there are fewer."""
    devices = [torch.device(d) for d in (devices if devices is not None else _visible_cards())]
    need = data * model
    if data < 1 or model < 1:
        raise ValueError(f"mesh {data}x{model}: both axes must be at least 1")
    if len(devices) < need:
        raise ValueError(f"mesh {data}x{model} needs {need} devices, have {len(devices)}")
    grid = np.empty((data, model), dtype=object)
    for i, dev in enumerate(devices[:need]):
        grid[i // model, i % model] = dev
    return Mesh(grid, axis_names)


def default_mesh(config: Optional[MeshConfig] = None) -> Mesh:
    """The mesh of ``config``; without one, every visible card on the data
    axis."""
    if config is not None and config.data * config.model > 1:
        return create_mesh(config.data, config.model)
    if config is not None and config.num_devices == 1:
        return create_mesh(1, 1)
    return create_mesh(max(len(_visible_cards()), 1), 1)


def shard_devices(mesh: Optional[Mesh]) -> Optional[List[torch.device]]:
    """The data devices of ``mesh`` (None for no mesh); refuses anything
    that is not the port's :class:`Mesh` (a JAX mesh, say)."""
    if mesh is None:
        return None
    if not isinstance(mesh, Mesh):
        raise TypeError(f"mesh must be a tpualign_torch Mesh (create_mesh), got "
                        f"{type(mesh).__name__}")
    return mesh.data_devices


def one_process(mesh: Optional[Mesh], what: str) -> None:
    """Raise ``NotImplementedError`` naming ``what`` when ``mesh`` spans
    processes: the parts that tpualign cannot run across processes either
    (the embedding engine and what embeds through it, the Evaluator, the
    IVF index's mutations, calibration and artifact; ROADMAP settled
    difference 24)."""
    if mesh is not None and getattr(mesh, "distributed", False):
        raise NotImplementedError(f"{what} across processes is not supported: tpualign cannot "
                                  f"run it across processes either, and it takes a mesh of "
                                  f"one process here (ROADMAP settled difference 24)")


class ShardedRows:
    """A ``(shards * rows_per_shard, ...)`` tensor split by rows over a
    mesh's data axis: ``parts[s]`` holds rows ``[s * rows_per_shard,
    (s + 1) * rows_per_shard)`` on ``devices[s]``. ``spec`` names the mesh
    axis of each dimension, as a JAX ``PartitionSpec`` does; one shard lies
    whole on its device and has no spec. On a mesh across processes the
    shards of the other processes' rows are None."""

    def __init__(self, parts: List[Optional[torch.Tensor]]):
        held = [p for p in parts if p is not None]
        rows = {int(p.shape[0]) for p in held}
        if not held or len(rows) != 1:
            raise ValueError(f"shards must be non-empty and of equal rows, got {sorted(rows)}")
        self.parts = parts
        self.rows_per_shard = rows.pop()
        self.spec = (("data",) + (None,) * (held[0].dim() - 1)) if len(parts) > 1 else None

    @property
    def _held(self) -> torch.Tensor:
        return next(p for p in self.parts if p is not None)

    @property
    def devices(self) -> List[Optional[torch.device]]:
        return [None if p is None else p.device for p in self.parts]

    @property
    def shape(self) -> tuple:
        return (self.rows_per_shard * len(self.parts), *self._held.shape[1:])

    @property
    def dtype(self) -> torch.dtype:
        return self._held.dtype

    def to(self, device) -> torch.Tensor:
        """The whole tensor on ``device`` (every shard must be held here)."""
        if any(p is None for p in self.parts):
            raise NotImplementedError("the shards of other processes are not held here")
        return torch.cat([p.to(device) for p in self.parts])

    def cpu(self) -> torch.Tensor:
        """The whole tensor on the host."""
        return self.to("cpu")
