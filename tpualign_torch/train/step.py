"""Train state and the training step (the port's ``tpualign.train.step``).

One step: both towers forward on the batch (run on a parameter dict with
``torch.func.functional_call``, so LoRA merges and the two accumulation
phases need no second model), the weighted contrastive loss, gradients by
autograd, then :class:`tpualign_torch.train.optim.AdamW` in place, the
logit-scale clamp (``ln 100``) and the EMA. On the card the towers' bf16
projections are cuBLAS products with a gradient
(``ops/dense.py::matmul_f32acc``), attention is K1 forward with the
recomputing backward (``ops/attention.py``), and a device-feed batch goes
through ``ops/preprocess.py::preprocess_device`` (K5) first.

:func:`make_sharded_train_step` runs the same step over a mesh of one
process (``parallel/mesh.py``): the state's tensors are
``ShardedTensor``s laid out by ``parallel/sharding.py``'s specs (TP over
``model``, FSDP over ``data`` with ``TRAIN_FSDP``); each data row runs the
towers on its slice of the batch, tensor parallel inside its row (K1 on
each card's heads, K5 on the row's first card), the features are gathered
on the mesh's first card with a differentiable copy and the loss is taken
there as on one device; each gradient is summed over the positions that
hold the same slice, and every device updates its own parts.

Over a mesh across processes (``parallel/multihost.py``) every process
passes the same global batch and runs its own rows on their slices; the
features of every row are all-gathered on each process's first card (the
process's own rows stay in the autograd graph, and the logit scale counts
on the process holding row 0 only), every process takes the same loss, and
each replicated gradient is summed over the processes (one all-reduce a
dtype), so every process applies the same update and reports the same
loss and ``grad_norm``. Under FSDP a process holds its own rows' slices of
the parameters, moments and EMA: the other processes' slices are
all-gathered before the towers run (``sharding.with_remote``, as fresh
autograd leaves), the gradient each process finds for every slice is
reduce-scattered so that each keeps the sum for its own slices, and the
squared norms of the slices are summed over the processes.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Tuple

import numpy as np
import torch
from torch.func import functional_call

from tpualign_torch.config import TrainConfig
from tpualign_torch.models.clip import CLIP
from tpualign_torch.parallel.mesh import shard_devices
from tpualign_torch.parallel.sharding import (
    RowTowers, ShardedTensor, check_model_split, gather_full, model_slices, row_params,
    shard_params, split_rows, with_remote)
from tpualign_torch.train.loss import clip_contrastive_loss, distill_kl_loss, siglip_loss
from tpualign_torch.train.optim import AdamW, global_norm

__all__ = ["TrainState", "create_train_state", "train_step", "make_sharded_train_step",
           "sample_patch_indices", "export_params", "make_optimizer", "model_params"]

MAX_LOGIT_SCALE = 4.6052  # ln(100)

Params = Dict[str, torch.Tensor]


def model_params(model: CLIP) -> Params:
    """The model's parameters as a dict of detached tensors (port names)."""
    return {k: p.detach() for k, p in model.named_parameters()}


def _as_pixels(images, model: CLIP) -> torch.Tensor:
    """An image batch as (B, S, S, 3) float pixels: a device-feed ``(u8,
    hw)`` pair (or the augmentation arm's ``(u8, hw, crop_boxes, flip)``)
    goes through ``preprocess_device``, which ends in K5; float pixels
    pass through."""
    if isinstance(images, (tuple, list)):
        from tpualign_torch.ops.preprocess import preprocess_device

        size = model.variant.image_size
        if len(images) == 4:
            u8, hw, boxes, flips = images
            return preprocess_device(u8, hw, size, crop_boxes=boxes, flip=flips)
        u8, hw = images
        return preprocess_device(u8, hw, size)
    return images


def _flat(tree: dict) -> list:
    """The tensors of a dict of tensors or of ``ShardedTensor``s (every
    part), in a fixed order."""
    out = []
    for v in tree.values():
        if isinstance(v, ShardedTensor):
            out.extend(p for row in v.parts for p in row if p is not None)
        else:
            out.append(v)
    return out


def _unflat(tree: dict, tensors: list) -> dict:
    """``tensors`` (in :func:`_flat`'s order) back into ``tree``'s layout."""
    it = iter(tensors)
    return {k: (v.map(lambda _: next(it)) if isinstance(v, ShardedTensor) else next(it))
            for k, v in tree.items()}


@dataclasses.dataclass
class TrainState:
    """``params`` are trained in place; ``ema_params`` (None = off) is what
    export and evaluation prefer; under LoRA ``params`` is the adapter dict
    and ``frozen_params`` the base, merged with ``lora_scale``. On a mesh
    (``mesh`` set, by :func:`make_sharded_train_step`'s ``shard_state``)
    every tensor dict holds ``ShardedTensor``s."""

    step: int
    params: Params
    opt_state: dict
    tx: AdamW
    ema_params: Optional[Params] = None
    frozen_params: Optional[Params] = None
    lora_scale: float = 0.0
    mesh: object = None

    @torch.no_grad()
    def apply_gradients(self, grads: Params, g_norm: torch.Tensor) -> "TrainState":
        if self.mesh is None:
            self.opt_state = self.tx.update(self.params, grads, self.opt_state, g_norm)
        else:
            self.opt_state = _sharded_update(self.tx, self.params, grads, self.opt_state, g_norm)
        # clamp the learned temperature (CLIP standard); trainable under LoRA too
        for scale in _flat({"s": self.params["logit_scale"]}):
            scale.clamp_(max=MAX_LOGIT_SCALE)
        self.step += 1
        return self

    def effective_params(self, trainable: Optional[Params] = None) -> Params:
        """The full parameter dict the towers run on: the trainable dict,
        or (LoRA) the frozen base merged with the adapters."""
        trainable = self.params if trainable is None else trainable
        if self.frozen_params is None:
            return trainable
        from tpualign_torch.train.lora import lora_apply

        return lora_apply(self.frozen_params, trainable, self.lora_scale)


def make_optimizer(config: TrainConfig) -> AdamW:
    if config.moments_dtype not in ("float32", "bfloat16"):
        raise ValueError(f"moments_dtype must be float32/bfloat16, "
                         f"got {config.moments_dtype!r}")
    mu_dtype = torch.bfloat16 if config.moments_dtype == "bfloat16" else torch.float32
    return AdamW(config.learning_rate, config.warmup_steps, config.total_steps,
                 config.weight_decay, mu_dtype)


def _reject_quantized_model(model: CLIP) -> None:
    if getattr(model, "quant", "none") == "int8":
        raise ValueError(
            "Training a quant='int8' model is not supported: the serving "
            "path's round() has zero gradient. For quantization-aware "
            "training use CLIP_QUANT=int8_qat (straight-through surrogate "
            "— same rounding grid, trainable), then serve the result with "
            "CLIP_QUANT=int8."
        )


def create_train_state(model: CLIP, params: Params, config: TrainConfig) -> TrainState:
    """A fresh state over a copy of ``params`` (a dict in the port's names,
    e.g. :func:`model_params`)."""
    _reject_quantized_model(model)
    tx = make_optimizer(config)
    params = {k: v.detach().to(torch.float32).clone() for k, v in params.items()}
    frozen = None
    lora_scale = 0.0
    if config.lora_rank > 0:
        from tpualign_torch.train.lora import lora_init, lora_param_count
        from tpualign_torch.utils.logging import get_logger

        frozen = params
        if config.lora_base_dtype == "bfloat16":
            # the frozen base takes no updates: kernels and embeddings
            # (ndim >= 2, nearly all the bytes) in bf16, vectors in fp32
            frozen = {k: (p.to(torch.bfloat16) if p.dim() >= 2 else p)
                      for k, p in frozen.items()}
        elif config.lora_base_dtype != "float32":
            raise ValueError(f"LORA_BASE_DTYPE must be float32 or bfloat16, "
                             f"got {config.lora_base_dtype!r}")
        params = lora_init(params, config.lora_rank, seed=config.seed)
        lora_scale = config.lora_alpha / config.lora_rank
        get_logger("train.step").info(
            "LoRA rank=%d alpha=%.1f: %d trainable params (base frozen)",
            config.lora_rank, config.lora_alpha, lora_param_count(params))
    return TrainState(
        step=0, params=params, opt_state=tx.init(params), tx=tx,
        ema_params=({k: v.clone() for k, v in params.items()}
                    if config.ema_decay > 0.0 else None),
        frozen_params=frozen, lora_scale=lora_scale)


@torch.no_grad()
def _update_ema(state: TrainState, config: TrainConfig) -> TrainState:
    """``ema = ema·d + (1 - d)·params`` over the NEW params (on a mesh,
    part by part)."""
    if state.ema_params is None or config.ema_decay <= 0.0:
        return state
    d = config.ema_decay
    ema = _flat(state.ema_params)
    new = torch._foreach_add(torch._foreach_mul(ema, d),
                             torch._foreach_mul(_flat({k: state.params[k]
                                                       for k in state.ema_params}), 1.0 - d))
    state.ema_params = _unflat(state.ema_params, [n.to(e.dtype) for n, e in zip(new, ema)])
    return state


@torch.no_grad()
def export_params(state: TrainState) -> Params:
    """The dict to embed and serve with: the EMA when tracked, else the
    params; under LoRA merged into the frozen base. A mesh state is
    gathered to its first device (across processes, on every process: each
    calls it alike)."""
    trainable = state.ema_params if state.ema_params is not None else state.params
    if state.mesh is not None:
        trainable = gather_full(trainable)
        if state.frozen_params is not None:
            from tpualign_torch.train.lora import lora_apply

            base = gather_full(state.frozen_params)
            trainable = lora_apply(base, trainable, state.lora_scale)
        return trainable
    return {k: v.detach() for k, v in state.effective_params(trainable).items()}


def _compose_loss(img, txt, scale, weak_scores, config: TrainConfig,
                  teacher) -> Tuple[torch.Tensor, dict]:
    """The configured contrastive objective, mixed with relational KD when
    ``teacher = (t_img, t_txt, t_scale)`` is given: ``(1-w)·base + w·KL``."""
    if config.loss_type == "siglip":
        bias = torch.tensor(config.siglip_bias, dtype=torch.float32, device=img.device)
        base, metrics = siglip_loss(img, txt, scale, bias, weak_scores=weak_scores,
                                    weight_temperature=config.weak_score_temperature)
    else:
        base, metrics = clip_contrastive_loss(
            img, txt, scale, weak_scores=weak_scores,
            weight_temperature=config.weak_score_temperature,
            label_smoothing=config.label_smoothing)
    if teacher is None:
        return base, metrics
    t_img, t_txt, t_scale = teacher
    kd = distill_kl_loss(img, txt, scale, t_img, t_txt, t_scale,
                         temperature=config.distill_temperature)
    w = config.distill_weight
    loss = (1.0 - w) * base + w * kd
    metrics = dict(metrics)
    metrics["distill_kl"] = kd
    metrics["loss"] = loss
    return loss, metrics


def _leaves(params: Params) -> Params:
    """Fresh autograd leaves sharing the params' storage (a mesh state's:
    every part, and across processes the other processes' FSDP slices as
    leaves of their own)."""
    def leaf(v):
        return v.detach().requires_grad_(True)

    out = {k: (v.map(leaf) if isinstance(v, ShardedTensor) else leaf(v))
           for k, v in params.items()}
    return with_remote(out, grad=True)


def _encode(state: TrainState, model: CLIP, params: Params, images, tokens, patch_indices):
    if state.mesh is not None:
        return _mesh_encode(state, model, params, images, tokens, patch_indices)
    return functional_call(model, state.effective_params(params),
                           (_as_pixels(images, model), tokens, patch_indices))


def _grads(loss: torch.Tensor, leaves: Params) -> Params:
    if leaves and isinstance(next(iter(leaves.values())), ShardedTensor):
        return _mesh_grads(loss, leaves)
    return dict(zip(leaves, torch.autograd.grad(loss, list(leaves.values()))))


def _finish(state: TrainState, grads: Params, config: TrainConfig,
            metrics: dict) -> Tuple[TrainState, dict]:
    g_norm = (global_norm(list(grads.values())) if state.mesh is None
              else _sharded_norm(grads, state.mesh.home))
    state = _update_ema(state.apply_gradients(grads, g_norm), config)
    metrics = {k: (v.detach() if torch.is_tensor(v) else v) for k, v in metrics.items()}
    metrics["grad_norm"] = g_norm
    return state, metrics


def train_step(state: TrainState, model: CLIP, images, token_ids: torch.Tensor,
               weak_scores: Optional[torch.Tensor], config: TrainConfig,
               patch_indices: Optional[torch.Tensor] = None,
               teacher: Optional[Tuple] = None) -> Tuple[TrainState, dict]:
    """One optimisation step; updates ``state`` in place and returns it
    with the metrics (0-dim tensors on the device, ``grad_norm`` the raw
    gradients' global norm, before the clip).

    ``patch_indices`` (B, K): FLIP visible patches (see
    :func:`sample_patch_indices`); ``teacher``: ``(t_img, t_txt, t_scale)``
    precomputed teacher embeddings for the batch. With
    ``config.grad_accum_steps > 1`` the step runs
    :func:`_accum_train_step`.
    """
    if config.grad_accum_steps > 1:
        return _accum_train_step(state, model, images, token_ids, weak_scores, config,
                                 patch_indices, teacher)
    leaves = _leaves(state.params)
    img, txt, scale = _encode(state, model, leaves, images, token_ids, patch_indices)
    loss, metrics = _compose_loss(img, txt, scale, weak_scores, config, teacher)
    return _finish(state, _grads(loss, leaves), config, metrics)


def _split(x, a: int, m: int):
    """Microbatches of a batch leaf, a device-feed tuple leaf by leaf."""
    if x is None:
        return [None] * a
    if isinstance(x, (tuple, list)):
        return list(zip(*(_split(v, a, m) for v in x)))
    return [x[i * m:(i + 1) * m] for i in range(a)]


def _accum_train_step(state: TrainState, model: CLIP, images, token_ids: torch.Tensor,
                      weak_scores: Optional[torch.Tensor], config: TrainConfig,
                      patch_indices: Optional[torch.Tensor] = None,
                      teacher: Optional[Tuple] = None) -> Tuple[TrainState, dict]:
    """Exact gradient accumulation with full-batch negatives (the
    cached-feature schedule): phase 1 encodes every microbatch without
    gradients; phase 2 re-encodes each with gradients, splices its rows
    into the cached full-batch features and differentiates the FULL-batch
    loss. The sum of the passes' gradients is the full-batch gradient,
    except ``logit_scale``, which enters every pass directly: its sum is
    divided by the number of passes."""
    a = config.grad_accum_steps
    b = (images[0] if isinstance(images, (tuple, list)) else images).shape[0]
    if b % a:
        raise ValueError(f"batch size {b} not divisible by grad_accum_steps={a}")
    m = b // a
    imgs, toks, pidx = _split(images, a, m), _split(token_ids, a, m), _split(patch_indices, a, m)

    with torch.no_grad():
        cached = [_encode(state, model, state.params, imgs[i], toks[i], pidx[i])[:2]
                  for i in range(a)]
    img_all = torch.stack([c[0] for c in cached])  # (A, m, D)
    txt_all = torch.stack([c[1] for c in cached])

    grads: Optional[Params] = None
    metrics: dict = {}
    for i in range(a):
        leaves = _leaves(state.params)
        img_i, txt_i, scale = _encode(state, model, leaves, imgs[i], toks[i], pidx[i])
        img_full = torch.cat([img_all[:i], img_i[None], img_all[i + 1:]]).reshape(b, -1)
        txt_full = torch.cat([txt_all[:i], txt_i[None], txt_all[i + 1:]]).reshape(b, -1)
        loss, metrics = _compose_loss(img_full, txt_full, scale, weak_scores, config, teacher)
        g = _grads(loss, leaves)
        if grads is None:
            grads = g
        else:
            torch._foreach_add_(_flat(grads), _flat(g))
    for t in _flat({"s": grads["logit_scale"]}):
        t.div_(torch.tensor(float(a), dtype=t.dtype, device=t.device))
    # every pass computes the same full-batch loss; report the last
    return _finish(state, grads, config, metrics)


def _to(x, device):
    """A batch leaf (or a device-feed tuple) on ``device``."""
    if isinstance(x, (tuple, list)):
        return tuple(_to(v, device) for v in x)
    return None if x is None else x.to(device)


def _row_params(state: TrainState, params: Params, frozen, i: int) -> dict:
    """What data row ``i`` runs the towers on (``row_params``); under LoRA
    the frozen base ``frozen`` (``state.frozen_params`` with its remote
    slices) merged with the replicated adapters, each part with its
    kernel's slice of the adapter (``W_j + scale·A_j@B_j``)."""
    rows = row_params(params, i)
    if frozen is None:
        return rows
    out = {}
    for name, base in row_params(frozen, i).items():
        if f"{name}.a" not in rows:
            out[name] = rows.get(name, base)
            continue
        a, b = rows[f"{name}.a"], rows[f"{name}.b"]
        if torch.is_tensor(base):
            out[name] = (base + state.lora_scale * torch.matmul(a, b)).to(base.dtype)
            continue
        layout = state.frozen_params[name]
        m = len(base)
        if layout.model_dim == 0:
            a_parts, b_parts = model_slices(a, layout.spec, None, m), [b] * m
        else:
            a_parts, b_parts = [a] * m, model_slices(b, layout.spec, layout.perm, m)
        out[name] = [(w + state.lora_scale * torch.matmul(aj.to(w.device), bj.to(w.device)))
                     .to(w.dtype) for w, aj, bj in zip(base, a_parts, b_parts)]
    return out


def _mesh_encode(state: TrainState, model: CLIP, params: Params, images, tokens,
                 patch_indices):
    """Each data row's towers on its slice of the batch (moved to the row's
    first device); the features gathered on the mesh's first device, the
    logit scale row 0's. Across processes each process runs its own rows
    and all-gathers the others' features (process_gather: only its own
    stay in its graph); a process without row 0 takes its scale detached,
    so that the scale's gradient is counted once in the sum over the
    processes."""
    mesh = state.mesh
    d, first = mesh.shape["data"], mesh.home
    imgs, toks = split_rows(images, d), split_rows(tokens, d)
    pidx = [None] * d if patch_indices is None else split_rows(patch_indices, d)
    params = with_remote(params)
    frozen = None if state.frozen_params is None else with_remote(state.frozen_params)
    img_all, txt_all, scale = [], [], None
    for i in mesh.local_rows:
        home = mesh.row(i)[0]
        towers = RowTowers(model, _row_params(state, params, frozen, i))
        img, txt, s = towers(_as_pixels(_to(imgs[i], home), model), toks[i].to(home),
                             _to(pidx[i], home))
        img_all.append(img.to(first))
        txt_all.append(txt.to(first))
        scale = s if scale is None else scale
    img, txt = torch.cat(img_all), torch.cat(txt_all)
    if mesh.distributed:
        from tpualign_torch.parallel.multihost import process_gather

        img, txt = torch.cat(process_gather(mesh, img)), torch.cat(process_gather(mesh, txt))
        if not mesh.is_local(0):
            scale = scale.detach()
    return img, txt, scale


def _mesh_grads(loss: torch.Tensor, leaves: Dict[str, ShardedTensor]) -> Dict[str, ShardedTensor]:
    """The gradient of every part: the sum (in row order, on the first
    position's device) of the gradients that the positions holding the same
    slice received, copied to each of them. A replicated parameter sums
    over the data rows; an FSDP slice has its sum over the rows from
    autograd already (its gather's backward). Across processes each
    replicated slice's sum over this process's positions is then summed
    over the processes (process_sum), and each FSDP slice's gradient, from
    its own part or its remote leaf, is reduce-scattered to the process
    that holds it (:func:`_scatter_fsdp`)."""
    order = [(name, i, j) for name, st in leaves.items() for i, j in st.positions()]
    remote = [(name, key) for name, st in leaves.items() for key in (st.remote or {})]
    got = torch.autograd.grad(
        loss, [leaves[n].parts[i][j] for n, i, j in order]
        + [leaves[n].remote[key] for n, key in remote], allow_unused=True)
    remote_got = dict(zip(remote, got[len(order):]))
    got = dict(zip(order, got[:len(order)]))
    out = {}
    for name, st in leaves.items():
        groups: dict = {}
        for i, j in st.positions():
            groups.setdefault(st.group(i, j), []).append((i, j))
        parts = [[None] * len(row) for row in st.parts]
        totals = []
        for pos in groups.values():
            head = st.parts[pos[0][0]][pos[0][1]]
            total = None
            for i, j in pos:
                g = got[(name, i, j)]
                if g is not None:
                    g = g.to(head.device)
                    total = g if total is None else total + g
            totals.append(torch.zeros_like(head) if total is None else total)
        out[name] = (st, groups, parts, totals)
    mesh = next(iter(leaves.values())).mesh
    if mesh.distributed:
        from tpualign_torch.parallel.multihost import process_sum

        summed = iter(process_sum(mesh, [t for st, *_, totals in out.values()
                                         if not st.needs_remote for t in totals]))
        scattered = _scatter_fsdp(mesh, out, remote_got)
        out = {name: (st, groups, parts,
                      scattered[name] if st.needs_remote else [next(summed) for _ in totals])
               for name, (st, groups, parts, totals) in out.items()}
    grads = {}
    for name, (st, groups, parts, totals) in out.items():
        for pos, total in zip(groups.values(), totals):
            for n, (i, j) in enumerate(pos):
                parts[i][j] = total if n == 0 else total.to(st.parts[i][j].device, copy=True)
        grads[name] = st.like(parts)
    return grads


def _scatter_fsdp(mesh, out: dict, remote_got: dict) -> Dict[str, list]:
    """Across processes, the gradient of every FSDP slice summed over the
    processes, each process keeping its own: what this process found for
    every data row's slice (its own rows' from ``out``'s local totals, the
    other rows' from their remote leaves, zeros where autograd found none)
    goes into one reduce-scatter a dtype, in process order. Returns each
    FSDP tensor's totals in ``out``'s group order."""
    from tpualign_torch.parallel.multihost import _ranks, process_reduce_scatter

    fsdp = [(name, st, groups, totals) for name, (st, groups, _, totals) in out.items()
            if st.needs_remote]
    if not fsdp:
        return {}
    mine = {name: dict(zip(groups, totals)) for name, _, groups, totals in fsdp}
    parts = []
    for rank in _ranks(mesh):
        rows = [i for i, q in enumerate(mesh.processes) if q == rank]
        row = []
        for name, st, groups, _ in fsdp:
            for c in st.columns():
                for i in rows:
                    key = (i, c)
                    g = mine[name].get(key) if rank == mesh.rank else remote_got.get((name, key))
                    if g is None:
                        g = torch.zeros_like(st.remote[key])
                    row.append(g)
        parts.append(row)
    summed = iter(process_reduce_scatter(mesh, parts))
    got = {(name, (i, c)): next(summed) for name, st, _, _ in fsdp for c in st.columns()
           for i in mesh.local_rows}
    return {name: [got[(name, key)].to(st.parts[key[0]][key[1]].device) for key in groups]
            for name, st, groups, _ in fsdp}


def _sharded_norm(grads: Dict[str, ShardedTensor], first: torch.device) -> torch.Tensor:
    """``global_norm`` over every distinct slice once, summed on ``first``;
    across processes each FSDP slice's square is summed over the processes
    that hold them (the replicated ones are equal on every process)."""
    heads, split = [], []
    for st in grads.values():
        seen = set()
        for i, j in st.positions():
            if st.group(i, j) not in seen:
                seen.add(st.group(i, j))
                (split if st.needs_remote else heads).append(st.parts[i][j])
    sq = [n.float().to(first) ** 2 for n in torch._foreach_norm(heads + split)]
    if not split:
        return torch.sqrt(torch.sum(torch.stack(sq)))
    from tpualign_torch.parallel.multihost import process_sum

    mesh = next(iter(grads.values())).mesh
    own = process_sum(mesh, [torch.sum(torch.stack(sq[len(heads):]))])[0]
    return torch.sqrt((torch.sum(torch.stack(sq[:len(heads)])) if heads else 0.0) + own)


def _sharded_update(tx: AdamW, params, grads, opt_state: dict, g_norm: torch.Tensor) -> dict:
    """AdamW on every device's own parts (its slice of the moments with
    them); the parts that repeat a slice get the same update from the same
    values, so they stay equal."""
    by_device: dict = {}
    for name, st in params.items():
        for i, j in st.positions():
            by_device.setdefault(st.parts[i][j].device, []).append((name, i, j))
    mu, nu = opt_state["mu"], opt_state["nu"]
    for dev, keys in by_device.items():
        def pick(tree):
            return {(n, i, j): tree[n].parts[i][j] for n, i, j in keys}

        new = tx.update(pick(params), pick(grads),
                        {"count": opt_state["count"], "mu": pick(mu), "nu": pick(nu)},
                        g_norm.to(dev))
        for n, i, j in keys:
            mu[n].parts[i][j] = new["mu"][(n, i, j)]
            nu[n].parts[i][j] = new["nu"][(n, i, j)]
    return {"count": opt_state["count"] + 1, "mu": mu, "nu": nu}


def _as_tensor(x):
    if x is None or torch.is_tensor(x):
        return x
    if isinstance(x, (tuple, list)):
        return tuple(_as_tensor(v) for v in x)
    return torch.from_numpy(np.ascontiguousarray(x))


def make_sharded_train_step(model: CLIP, mesh, config: TrainConfig, state_sharding=None):
    """The step over ``mesh``: the batch split over ``data``, the towers
    tensor parallel over ``model`` by ``clip_param_specs``; with
    ``config.fsdp`` every parameter of two dimensions or more, its moments
    and its EMA also split over ``data`` (gathered before use, their
    gradients summed back to their owners). Under LoRA the adapters
    replicate and the frozen base takes the full TP(+FSDP) layout.

    Returns ``(step_fn, shard_state)``: ``shard_state`` lays a one-device
    ``TrainState`` out on the mesh (fresh tensors: a mesh that repeats a
    device never aliases the caller's params or one part with another);
    ``step_fn(state, images, token_ids, weak_scores, patch_indices=None,
    teacher=None)`` takes numpy arrays or tensors on any device, runs one
    step and returns the state and the metrics (on the first device, where
    the loss is taken with the teacher's rows). ``state_sharding`` is
    tpualign's argument and is not used.
    """
    _reject_quantized_model(model)
    shard_devices(mesh)  # refuses anything but the port's Mesh
    check_model_split(model, mesh.shape["model"])
    first = mesh.home

    def laid_out(tree: Params, like: Dict[str, ShardedTensor]) -> Dict[str, ShardedTensor]:
        return {k: ShardedTensor.from_full(v, mesh, like[k].spec, like[k].perm)
                for k, v in tree.items()}

    def shard_state(state: TrainState) -> TrainState:
        lora = state.frozen_params is not None
        params = shard_params(state.params, mesh, fsdp=config.fsdp and not lora)
        opt = state.opt_state
        return TrainState(
            step=int(state.step), params=params,
            opt_state={"count": int(opt["count"]), "mu": laid_out(opt["mu"], params),
                       "nu": laid_out(opt["nu"], params)},
            tx=state.tx,
            ema_params=(None if state.ema_params is None
                        else laid_out(state.ema_params, params)),
            frozen_params=(shard_params(state.frozen_params, mesh, fsdp=config.fsdp)
                           if lora else None),
            lora_scale=state.lora_scale, mesh=mesh)

    def run(state: TrainState, images, token_ids, weak_scores, patch_indices=None,
            teacher=None):
        weak = _as_tensor(weak_scores)
        pidx = _as_tensor(patch_indices)
        if teacher is not None:
            teacher = tuple(_as_tensor(t).to(first) for t in teacher)
        return train_step(state, model, _as_tensor(images), _as_tensor(token_ids).long(),
                          None if weak is None else weak.to(first), config,
                          None if pidx is None else pidx.long(), teacher)

    return run, shard_state


def sample_patch_indices(rng: np.random.Generator, batch: int, num_patches: int,
                         mask_ratio: float):
    """(batch, K) visible-patch indices for FLIP masking, K fixed by
    ``mask_ratio``; None when the ratio is <= 0. tpualign's draws: the
    same numpy ``rng`` gives the same indices."""
    if mask_ratio <= 0.0:
        return None
    keep = max(1, int(round(num_patches * (1.0 - mask_ratio))))
    idx = np.empty((batch, keep), np.int32)
    for i in range(batch):
        idx[i] = rng.permutation(num_patches)[:keep]
    return idx
