"""Train state and the training step (the port's ``tpualign.train.step``).

One step: both towers forward on the batch (run on a parameter dict with
``torch.func.functional_call``, so LoRA merges and the two accumulation
phases need no second model), the weighted contrastive loss, gradients by
autograd, then :class:`tpualign_torch.train.optim.AdamW` in place, the
logit-scale clamp (``ln 100``) and the EMA. On the card the towers' bf16
projections are cuBLAS products with a gradient
(``ops/dense.py::matmul_f32acc``), attention is K1 forward with the
recomputing backward (``ops/attention.py``), and a device-feed batch goes
through ``ops/preprocess.py::preprocess_device`` (K5) first. One device:
the sharded step is multi-GPU work and raises.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Tuple

import numpy as np
import torch
from torch.func import functional_call

from tpualign_torch.config import TrainConfig
from tpualign_torch.models.clip import CLIP
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


@dataclasses.dataclass
class TrainState:
    """``params`` are trained in place; ``ema_params`` (None = off) is what
    export and evaluation prefer; under LoRA ``params`` is the adapter dict
    and ``frozen_params`` the base, merged with ``lora_scale``."""

    step: int
    params: Params
    opt_state: dict
    tx: AdamW
    ema_params: Optional[Params] = None
    frozen_params: Optional[Params] = None
    lora_scale: float = 0.0

    @torch.no_grad()
    def apply_gradients(self, grads: Params, g_norm: torch.Tensor) -> "TrainState":
        self.opt_state = self.tx.update(self.params, grads, self.opt_state, g_norm)
        # clamp the learned temperature (CLIP standard); trainable under LoRA too
        self.params["logit_scale"].clamp_(max=MAX_LOGIT_SCALE)
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
    """``ema = ema·d + (1 - d)·params`` over the NEW params."""
    if state.ema_params is None or config.ema_decay <= 0.0:
        return state
    d = config.ema_decay
    names = list(state.ema_params)
    ema = [state.ema_params[k] for k in names]
    new = torch._foreach_add(torch._foreach_mul(ema, d),
                             torch._foreach_mul([state.params[k] for k in names], 1.0 - d))
    state.ema_params = {k: n.to(e.dtype) for k, n, e in zip(names, new, ema)}
    return state


@torch.no_grad()
def export_params(state: TrainState) -> Params:
    """The dict to embed and serve with: the EMA when tracked, else the
    params; under LoRA merged into the frozen base."""
    trainable = state.ema_params if state.ema_params is not None else state.params
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
    """Fresh autograd leaves sharing the params' storage."""
    return {k: v.detach().requires_grad_(True) for k, v in params.items()}


def _encode(state: TrainState, model: CLIP, params: Params, images, tokens, patch_indices):
    return functional_call(model, state.effective_params(params),
                           (_as_pixels(images, model), tokens, patch_indices))


def _finish(state: TrainState, grads: Params, config: TrainConfig,
            metrics: dict) -> Tuple[TrainState, dict]:
    g_norm = global_norm(list(grads.values()))
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
    grads = dict(zip(leaves, torch.autograd.grad(loss, list(leaves.values()))))
    return _finish(state, grads, config, metrics)


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
        g = torch.autograd.grad(loss, list(leaves.values()))
        if grads is None:
            grads = dict(zip(leaves, g))
        else:
            torch._foreach_add_(list(grads.values()), list(g))
    grads["logit_scale"] = grads["logit_scale"] / torch.tensor(
        float(a), dtype=grads["logit_scale"].dtype, device=grads["logit_scale"].device)
    # every pass computes the same full-batch loss; report the last
    return _finish(state, grads, config, metrics)


def make_sharded_train_step(model: CLIP, mesh, config: TrainConfig, state_sharding=None):
    """The mesh step (data and tensor parallel, FSDP) shards the towers
    (tpualign's ``parallel/sharding.py``), a later slice: not yet ported."""
    raise NotImplementedError(
        "the sharded train step (a mesh, TRAIN_FSDP) needs tpualign's parallel/sharding.py, "
        "multi-GPU work of a later slice of tpualign_torch, not yet ported; it trains on one "
        "device")


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
