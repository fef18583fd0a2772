"""Debug-mode numerical and sharding checks (the port's
``tpualign.utils.debugging``).

- :func:`check_finite`: a host-side finite check over nested dicts, lists
  and tuples of tensors and arrays;
- :func:`debug_mode`: within its scope, a forward pass raises at the first
  floating operation that produces a NaN, as ``jax_debug_nans`` makes JAX
  do. It is a ``TorchDispatchMode`` that checks each floating output;
  ``torch.autograd.set_detect_anomaly`` would check the backward only. The
  kernels' ctypes launches write their outputs outside the dispatcher, so a
  NaN they produce is caught at the first operation that reads it;
- :func:`assert_sharded`: that a sharded index tensor
  (:class:`~tpualign_torch.parallel.mesh.ShardedRows`) really is split over
  a mesh axis along a dimension, and not whole on one device.
"""

from __future__ import annotations

import contextlib
from typing import Iterator

import numpy as np
import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_flatten

__all__ = ["check_finite", "debug_mode", "assert_sharded"]


def _leaves(tree, path: str = ""):
    """(path, leaf) pairs of nested dicts, lists and tuples, paths written
    as JAX's ``keystr`` writes them (``['key'][0]``)."""
    if isinstance(tree, dict):
        for key, value in tree.items():
            yield from _leaves(value, f"{path}[{key!r}]")
    elif isinstance(tree, (list, tuple)):
        for i, value in enumerate(tree):
            yield from _leaves(value, f"{path}[{i}]")
    else:
        yield path, tree


def check_finite(tree, name: str = "tensor") -> None:
    """Raises ``FloatingPointError`` naming the first floating leaf of
    ``tree`` (a tensor or array, or nested dicts, lists and tuples of them)
    that holds a NaN or an infinity."""
    for path, leaf in _leaves(tree):
        if isinstance(leaf, torch.Tensor):
            bad = leaf.is_floating_point() and not bool(torch.isfinite(leaf).all())
        elif isinstance(leaf, np.ndarray):
            bad = np.issubdtype(leaf.dtype, np.floating) and not bool(np.isfinite(leaf).all())
        else:
            continue
        if bad:
            raise FloatingPointError(f"non-finite values in {name}{path}")


class _NanCheck(TorchDispatchMode):
    """Runs each operation, then raises when a floating output holds a NaN
    (the mode is off while its own handler runs, so the check itself is not
    checked)."""

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        for t in tree_flatten(out)[0]:
            if (isinstance(t, torch.Tensor) and t.is_floating_point() and t.numel()
                    and bool(torch.isnan(t).any())):
                raise FloatingPointError(f"invalid value (nan) encountered in {func}")
        return out


@contextlib.contextmanager
def debug_mode() -> Iterator[None]:
    """Within this scope an operation that produces a NaN raises
    ``FloatingPointError`` instead of handing it on."""
    with _NanCheck():
        yield


def assert_sharded(x, mesh_axis: str, dim: int = 0) -> None:
    """Asserts that ``x`` is sharded over ``mesh_axis`` along ``dim``: a
    tensor that lies whole on one device, or a sharding of another axis or
    dimension, raises ``AssertionError``."""
    spec = getattr(x, "spec", None)
    if spec is None:
        where = f" (it lies whole on {x.device})" if isinstance(x, torch.Tensor) else ""
        raise AssertionError(f"array has no sharding{where}")
    entry = spec[dim] if dim < len(spec) else None
    names = entry if isinstance(entry, tuple) else (entry,)
    if mesh_axis not in names:
        raise AssertionError(f"expected dim {dim} sharded over {mesh_axis!r}, got spec {spec}")
