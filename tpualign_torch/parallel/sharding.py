"""Partition specs for the CLIP towers, tensor parallelism over ``model``
and optional FSDP over ``data`` (the port's ``tpualign.parallel.sharding``).

The specs are tpualign's, as tuples equal to ``tuple(PartitionSpec)``,
keyed by the port's parameter names:

- attention ``in_proj_kernel`` (d, 3d) and MLP ``c_fc_kernel`` (d, 4d) are
  column-split (``(None, "model")``), their biases with them
  (``("model",)``);
- attention ``out_proj_kernel`` (d, d) and MLP ``c_proj_kernel`` (4d, d)
  are row-split (``("model", None)``): each card's partial product is
  summed on the row's first card, then the replicated bias is added (in
  the int8 towers the int32 partials, and the bias in the epilogue there);
- everything else (embeddings, layernorms, projections, the other biases)
  is replicated (``()``).

With ``fsdp > 1`` (the data axis) every parameter of two dimensions or
more also splits its largest TP-free dimension that the axis divides over
``data`` (the first on a tie), as tpualign's ``_with_fsdp`` does.

A :class:`ShardedTensor` holds one part a device of the mesh. A part has
the shape JAX's ``NamedSharding(mesh, spec).shard_shape`` gives, and parts
that the spec replicates are separate tensors (a mesh that repeats a
device never aliases them). One layout differs from GSPMD's (ROADMAP
settled difference 22): ``in_proj`` splits by heads, not by contiguous
columns. Card ``j`` of a row holds the q, k and v columns of heads ``[j·H/m,
(j+1)·H/m)``, so that K1 runs on whole heads there; JAX's contiguous
blocks would put q and half of k on one card at m=2. ``perm`` records that
column order; gathering a tensor undoes it, so the values agree.

On a mesh across processes (``parallel/multihost.py``) a process holds
the parts of its own rows only (the others are None) and
:meth:`ShardedTensor.positions` lists those. A tensor that FSDP splits
over ``data`` needs the other processes' slices wherever it is used
whole: :func:`with_remote` all-gathers them once (one collective a dtype
for a whole parameter dict) into :attr:`ShardedTensor.remote`, where
:meth:`ShardedTensor.local` and :meth:`ShardedTensor.full` find them;
:func:`gather_full` gathers a dict whole.

:class:`RowTowers` runs the towers of one data row: the replicated
parameters on the row's first card, each model-split parameter as its
parts on the row's cards.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence

import torch
from torch.func import functional_call

from tpualign_torch.parallel.mesh import Mesh

__all__ = ["clip_param_specs", "shard_params", "data_spec", "ShardedTensor", "RowTowers",
           "row_params", "model_slices", "check_model_split", "with_remote", "gather_full"]

Spec = tuple

_COLUMN_SPLIT = ("attn.in_proj_kernel", "mlp.c_fc_kernel")
_COLUMN_BIAS = ("attn.in_proj_bias", "mlp.c_fc_bias")
_ROW_SPLIT = ("attn.out_proj_kernel", "mlp.c_proj_kernel")


def _leaf_spec(name: str) -> Spec:
    """The spec of one parameter, keyed on its name."""
    if name.endswith(_COLUMN_SPLIT):
        return (None, "model")
    if name.endswith(_COLUMN_BIAS):
        return ("model",)
    if name.endswith(_ROW_SPLIT):
        return ("model", None)
    # out_proj_bias, c_proj_bias, layernorms, embeddings, projections
    return ()


def _with_fsdp(spec: Spec, shape, fsdp: int, axis: str = "data") -> Spec:
    """``axis`` on the largest TP-free dim of ``shape`` that ``fsdp``
    divides (the first on a tie); ``spec`` unchanged when none does."""
    entries = list(spec) + [None] * (len(shape) - len(spec))
    best: Optional[int] = None
    for i, (n, s) in enumerate(zip(shape, entries)):
        if s is None and n % fsdp == 0 and (best is None or n > shape[best]):
            best = i
    if best is None:
        return spec
    entries[best] = axis
    return tuple(entries)


def clip_param_specs(params: Dict[str, object], fsdp: int = 1) -> Dict[str, Spec]:
    """The spec of every entry of a parameter dict in the port's names
    (anything with ``.shape``: tensors, meta tensors). ``fsdp``: the data
    axis to split every parameter of two dimensions or more over as well
    (1 = the plain TP specs, replicated over ``data``)."""
    out = {}
    for name, p in params.items():
        spec = _leaf_spec(name)
        if fsdp > 1 and len(p.shape) >= 2:
            spec = _with_fsdp(spec, tuple(p.shape), fsdp)
        out[name] = spec
    return out


def data_spec(ndim: int) -> Spec:
    """Batch-leading data-parallel spec: dim 0 over ``data``."""
    return ("data",) + (None,) * (ndim - 1)


def _head_order(name: str, shape, m: int) -> Optional[torch.Tensor]:
    """The column order that puts each card's heads together: for
    ``in_proj`` (``(d, 3d)`` kernel, ``(3d,)`` bias), the q, k and v columns
    of head group 0, then of group 1, ...; None for every other tensor."""
    if m == 1 or not name.endswith(("attn.in_proj_kernel", "attn.in_proj_bias")):
        return None
    width = shape[-1] // 3
    return torch.arange(3 * width).reshape(3, m, width // m).transpose(0, 1).reshape(-1)


class ShardedTensor:
    """A tensor of ``shape`` laid out over ``mesh`` by ``spec``:
    ``parts[i][j]`` lies on ``mesh.devices[i, j]`` and holds the slice the
    spec gives that device (split over ``data`` by ``i`` where the spec
    names it, over ``model`` by ``j`` in ``perm``'s order where it names
    ``model``, whole elsewhere); None where another process holds row
    ``i``. ``remote`` (set by :func:`with_remote`) maps ``(i, c)`` to the
    data slice of another process's row ``i`` for column group ``c``."""

    def __init__(self, parts: List[List[torch.Tensor]], spec: Spec, shape, mesh: Mesh,
                 perm: Optional[torch.Tensor] = None):
        self.parts, self.spec, self.shape = parts, tuple(spec), tuple(shape)
        self.mesh, self.perm = mesh, perm
        self.remote: Optional[Dict[tuple, torch.Tensor]] = None
        entries = list(self.spec) + [None] * (len(self.shape) - len(self.spec))
        self.data_dim = entries.index("data") if "data" in entries else None
        self.model_dim = entries.index("model") if "model" in entries else None

    @property
    def needs_remote(self) -> bool:
        """Whether using this tensor whole takes other processes' slices:
        it is split over a data axis that spans processes."""
        return self.data_dim is not None and self.mesh.distributed

    def columns(self) -> range:
        """The column groups of a row: one a model position where the spec
        splits over ``model``, else one for the whole row."""
        return range(self.mesh.devices.shape[1] if self.model_dim is not None else 1)

    @classmethod
    def from_full(cls, t: torch.Tensor, mesh: Mesh, spec: Spec,
                  perm: Optional[torch.Tensor] = None,
                  dtype: Optional[torch.dtype] = None) -> "ShardedTensor":
        """Fresh parts of ``t`` (never a view or the tensor itself)."""
        st = cls([], spec, t.shape, mesh, perm)
        d, m = mesh.devices.shape
        src = t.detach()
        if perm is not None:
            src = src.index_select(st.model_dim, perm.to(src.device))
        st.parts = [[st._fresh(src, i, j, dtype or t.dtype) if mesh.is_local(i) else None
                     for j in range(m)] for i in range(d)]
        return st

    def _fresh(self, src: torch.Tensor, i: int, j: int, dtype: torch.dtype) -> torch.Tensor:
        d, m = self.mesh.devices.shape
        piece = src
        for dim, k, n in ((self.data_dim, i, d), (self.model_dim, j, m)):
            if dim is not None:
                size = src.shape[dim] // n
                piece = piece.narrow(dim, k * size, size)
        out = torch.empty(piece.shape, dtype=dtype, device=self.mesh.devices[i, j])
        return out.copy_(piece)

    def like(self, parts: List[List[torch.Tensor]]) -> "ShardedTensor":
        """Other parts in this layout."""
        return ShardedTensor(parts, self.spec, self.shape, self.mesh, self.perm)

    def map(self, fn) -> "ShardedTensor":
        return self.like([[None if p is None else fn(p) for p in row] for row in self.parts])

    @property
    def dtype(self) -> torch.dtype:
        i, j = self.positions()[0]
        return self.parts[i][j].dtype

    def positions(self):
        """The grid positions whose parts this process holds."""
        m = self.mesh.devices.shape[1]
        return [(i, j) for i in self.mesh.local_rows for j in range(m)]

    def group(self, i: int, j: int) -> tuple:
        """The key shared by the positions that hold the same slice."""
        return (i if self.data_dim is not None else 0, j if self.model_dim is not None else 0)

    def _slice(self, i: int, j: int) -> torch.Tensor:
        """Row ``i``'s data slice for column ``j``: its part, or the slice
        :func:`with_remote` fetched from the process holding it."""
        part = self.parts[i][j]
        if part is not None:
            return part
        if self.remote is None:
            raise RuntimeError("the data slices of other processes are not fetched here: "
                               "call with_remote (or gather_full) first")
        return self.remote[self.group(i, j)]

    def local(self, i: int, j: int) -> torch.Tensor:
        """What device ``(i, j)`` computes with: its part, gathered over
        ``data`` (differentiably) where the spec splits it there."""
        if self.data_dim is None:
            return self.parts[i][j]
        dev = self.mesh.row(i)[j]
        return torch.cat([self._slice(r, j).to(dev) for r in range(len(self.parts))],
                         dim=self.data_dim)

    def full(self, device=None) -> torch.Tensor:
        """The whole tensor on ``device`` (default: this process's first
        device); across processes, after :func:`with_remote`."""
        dev = torch.device(device) if device is not None else self.mesh.home
        d, m = self.mesh.devices.shape
        cols = []
        for j in self.columns():
            rows = [self._slice(i, j).to(dev) for i in (range(d) if self.data_dim is not None
                                                        else self.mesh.local_rows[:1])]
            cols.append(torch.cat(rows, self.data_dim) if len(rows) > 1 else rows[0])
        t = torch.cat(cols, self.model_dim) if len(cols) > 1 else cols[0]
        if self.perm is not None:
            t = t.index_select(self.model_dim, torch.argsort(self.perm).to(dev))
        return t


def with_remote(tree: Dict[str, object], grad: bool = False) -> Dict[str, object]:
    """``tree`` with a copy of every :class:`ShardedTensor` that is split
    over a data axis across processes, holding the other processes' slices
    in ``remote``: every process passes the same dict (its own parts), and
    one all-gather a dtype carries them all. With ``grad`` the fetched
    slices are fresh autograd leaves (their gradients are what this
    process's rows add to the other processes' slices). Entries that need
    nothing, or hold their slices already, pass through."""
    todo = [k for k, v in tree.items()
            if isinstance(v, ShardedTensor) and v.needs_remote and v.remote is None]
    if not todo:
        return tree
    from tpualign_torch.parallel.multihost import _ranks, process_gather_all

    mesh = tree[todo[0]].mesh
    order = [(k, c, n) for k in todo for c in tree[k].columns()
             for n in range(len(mesh.local_rows))]
    got = process_gather_all(mesh, [tree[k].parts[mesh.local_rows[n]][c] for k, c, n in order])
    out = dict(tree)
    for k in todo:
        out[k] = tree[k].like(tree[k].parts)
        out[k].remote = {}
    for p, rank in enumerate(_ranks(mesh)):
        if rank == mesh.rank:
            continue
        rows = [i for i, q in enumerate(mesh.processes) if q == rank]
        for (k, c, n), t in zip(order, got[p]):
            out[k].remote[(rows[n], c)] = t.clone().requires_grad_(True) if grad else t
    return out


def gather_full(tree: Dict[str, object], device=None) -> Dict[str, object]:
    """Every :class:`ShardedTensor` of ``tree`` whole on ``device`` (default:
    this process's first device); across processes every process calls it
    on the same dict, and FSDP's slices are all-gathered once. Other
    entries pass through."""
    tree = with_remote(tree)
    return {k: (v.full(device) if isinstance(v, ShardedTensor) else v) for k, v in tree.items()}


def shard_params(params: Dict[str, torch.Tensor], mesh: Mesh, fsdp: bool = False,
                 dtype: Optional[torch.dtype] = None) -> Dict[str, ShardedTensor]:
    """A parameter dict (port names) placed on ``mesh`` by the TP(+FSDP)
    specs: fresh parts on the mesh's devices (``dtype``: theirs, default
    each tensor's own)."""
    specs = clip_param_specs(params, fsdp=mesh.shape["data"] if fsdp else 1)
    m = mesh.shape["model"]
    return {k: ShardedTensor.from_full(v, mesh, specs[k], _head_order(k, v.shape, m), dtype)
            for k, v in params.items()}


def model_slices(t: torch.Tensor, spec: Spec, perm: Optional[torch.Tensor],
                 m: int) -> List[torch.Tensor]:
    """``t`` cut into the ``m`` model parts of a tensor of layout ``spec``
    and ``perm`` (views; ``t`` whole over ``data``): a LoRA factor's slices
    for the parts of its kernel."""
    dim = list(spec).index("model")
    if perm is not None:
        t = t.index_select(dim, perm.to(t.device))
    return list(t.chunk(m, dim))


def row_params(sharded: Dict[str, ShardedTensor], i: int) -> Dict[str, object]:
    """What data row ``i`` runs the towers on: every parameter that the
    model axis does not split, whole on the row's first device, and each
    one it splits as the list of its parts on the row's devices (gathered
    over ``data`` where FSDP split them there). With a model axis of 1
    every entry is a tensor."""
    m = next(iter(sharded.values())).mesh.shape["model"]
    out: Dict[str, object] = {}
    for name, st in sharded.items():
        if st.model_dim is None or m == 1:
            out[name] = st.local(i, 0)
        else:
            out[name] = [st.local(i, j) for j in range(m)]
    return out


def _sub(params: Dict[str, object], prefix: str) -> Dict[str, object]:
    n = len(prefix)
    return {k[n:]: v for k, v in params.items() if k.startswith(prefix)}


def _tp_blocks(parts: Dict[str, object], prefix: str, layers: int) -> list:
    """Per block of a tower: the parts of its attention ``[(in_proj_kernel,
    in_proj_bias, out_proj_kernel) per card]`` and of its MLP ``[(c_fc_kernel,
    c_fc_bias, c_proj_kernel) per card]``."""
    blocks = []
    for k in range(layers):
        p = f"{prefix}transformer.resblocks.{k}."
        blocks.append({
            "attn": list(zip(parts[p + "attn.in_proj_kernel"], parts[p + "attn.in_proj_bias"],
                             parts[p + "attn.out_proj_kernel"])),
            "mlp": list(zip(parts[p + "mlp.c_fc_kernel"], parts[p + "mlp.c_fc_bias"],
                            parts[p + "mlp.c_proj_kernel"]))})
    return blocks


def check_model_split(model, m: int) -> None:
    """Raise ``ValueError`` unless ``model``'s towers split over a model
    axis of ``m``: every tower's heads divide by it. The int8 towers split
    too: their row-split products take the row and column maxima over the
    cards of a row (``ops/quant.py``'s split forms)."""
    if m == 1:
        return
    v = model.variant
    for tower, heads in (("vision", v.vision_heads), ("text", v.text_heads)):
        if heads % m:
            raise ValueError(f"the {tower} tower's {heads} heads do not split over a "
                             f"model axis of {m}")


class RowTowers:
    """The towers of one data row over ``params`` from :func:`row_params`:
    ``model`` run (``functional_call``) on the replicated entries, with the
    model-split entries passed to every block as ``tp`` parts. ``model``'s
    own parameters are not read. Call it like ``CLIP.forward``; it has
    ``encode_image`` and ``encode_text`` like ``CLIP``."""

    def __init__(self, model, params: Dict[str, object]):
        self.model = model
        self.replicated = {k: v for k, v in params.items() if torch.is_tensor(v)}
        parts = {k: v for k, v in params.items() if not torch.is_tensor(v)}
        self.tp = None
        if parts:
            check_model_split(model, len(next(iter(parts.values()))))
            v = model.variant
            self.tp = {"visual": _tp_blocks(parts, "visual.", v.vision_layers),
                       "text": _tp_blocks(parts, "text.", v.text_layers)}
        self.device = self.replicated["logit_scale"].device

    def _tower(self, name: str):
        tp = None if self.tp is None else self.tp[name]
        return getattr(self.model, name), _sub(self.replicated, name + "."), tp

    def encode_image(self, images: torch.Tensor, normalize: bool = False,
                     patch_indices: Optional[torch.Tensor] = None) -> torch.Tensor:
        tower, params, tp = self._tower("visual")
        feats = functional_call(tower, params, (images, patch_indices), {"tp": tp})
        return feats / torch.linalg.norm(feats, dim=-1, keepdim=True) if normalize else feats

    def encode_text(self, tokens: torch.Tensor, normalize: bool = False) -> torch.Tensor:
        tower, params, tp = self._tower("text")
        feats = functional_call(tower, params, (tokens,), {"tp": tp})
        return feats / torch.linalg.norm(feats, dim=-1, keepdim=True) if normalize else feats

    def __call__(self, images: torch.Tensor, tokens: torch.Tensor,
                 patch_indices: Optional[torch.Tensor] = None):
        return (self.encode_image(images, normalize=True, patch_indices=patch_indices),
                self.encode_text(tokens, normalize=True),
                self.replicated["logit_scale"].exp())


def split_rows(x, n: int) -> Sequence:
    """A batch leaf (or a device-feed tuple, leaf by leaf) cut into ``n``
    equal row slices."""
    if isinstance(x, (tuple, list)):
        return list(zip(*(split_rows(v, n) for v in x)))
    if x.shape[0] % n:
        raise ValueError(f"a batch of {x.shape[0]} rows does not split over a data axis of {n}")
    return list(torch.chunk(x, n))
