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
device. Processes on several hosts (``torch.distributed``) are a later
slice.

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

__all__ = ["Mesh", "ShardedRows", "create_mesh", "default_mesh", "shard_devices"]


class Mesh:
    """A ``(data, model)`` grid of devices: ``devices`` (an object array of
    that shape), ``axis_names`` and ``shape`` (axis name -> size, as
    ``mesh.shape["data"]`` is read throughout tpualign)."""

    def __init__(self, devices: np.ndarray, axis_names: Sequence[str] = ("data", "model")):
        if devices.ndim != 2 or len(axis_names) != 2:
            raise ValueError(f"a mesh is a 2-D grid with two axis names, got shape "
                             f"{devices.shape} and {tuple(axis_names)}")
        self.devices = devices
        self.axis_names = tuple(axis_names)
        self.shape = dict(zip(self.axis_names, devices.shape))

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


class ShardedRows:
    """A ``(shards * rows_per_shard, ...)`` tensor split by rows over a
    mesh's data axis: ``parts[s]`` holds rows ``[s * rows_per_shard,
    (s + 1) * rows_per_shard)`` on ``devices[s]``. ``spec`` names the mesh
    axis of each dimension, as a JAX ``PartitionSpec`` does; one shard lies
    whole on its device and has no spec."""

    def __init__(self, parts: List[torch.Tensor]):
        rows = {int(p.shape[0]) for p in parts}
        if not parts or len(rows) != 1:
            raise ValueError(f"shards must be non-empty and of equal rows, got {sorted(rows)}")
        self.parts = parts
        self.rows_per_shard = rows.pop()
        self.spec = (("data",) + (None,) * (parts[0].dim() - 1)) if len(parts) > 1 else None

    @property
    def devices(self) -> List[torch.device]:
        return [p.device for p in self.parts]

    @property
    def shape(self) -> tuple:
        return (self.rows_per_shard * len(self.parts), *self.parts[0].shape[1:])

    @property
    def dtype(self) -> torch.dtype:
        return self.parts[0].dtype

    def cpu(self) -> torch.Tensor:
        """The whole tensor on the host."""
        return torch.cat([p.cpu() for p in self.parts])
