"""Two-tower CLIP, ``build_clip`` and the seeded initialisation (the port's
``tpualign.models.clip``)."""

from __future__ import annotations

import math
from typing import Optional

import torch
from torch import nn

from tpualign_torch.config import ClipVariant, ModelConfig
from tpualign_torch.models.text import TextTransformer
from tpualign_torch.models.vit import VisionTransformer
from tpualign_torch.utils.device import resolve_device

__all__ = ["CLIP", "build_clip", "init_clip_params"]

_DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32}


class CLIP(nn.Module):
    """``encode_image`` / ``encode_text`` / joint forward."""

    def __init__(self, variant: ClipVariant, use_quick_gelu: bool = True,
                 compute_dtype: torch.dtype = torch.bfloat16,
                 use_fused_attention: bool = False, quant: str = "none",
                 remat: bool = False):
        super().__init__()
        v = variant
        self.variant = v
        self.quant = quant
        self.visual = VisionTransformer(
            v.image_size, v.patch_size, v.vision_width, v.vision_layers,
            v.vision_heads, v.embed_dim, use_quick_gelu, compute_dtype,
            use_fused_attention, v.vision_mlp_dim, quant, remat)
        self.text = TextTransformer(
            v.context_length, v.vocab_size, v.text_width, v.text_layers,
            v.text_heads, v.embed_dim, use_quick_gelu, compute_dtype,
            use_fused_attention, v.text_mlp_dim, quant, remat)
        self.logit_scale = nn.Parameter(torch.tensor(math.log(1.0 / 0.07)))

    def encode_image(self, images: torch.Tensor, normalize: bool = False,
                     patch_indices: Optional[torch.Tensor] = None) -> torch.Tensor:
        feats = self.visual(images, patch_indices)
        if normalize:
            feats = feats / torch.linalg.norm(feats, dim=-1, keepdim=True)
        return feats

    def encode_text(self, token_ids: torch.Tensor, normalize: bool = False) -> torch.Tensor:
        feats = self.text(token_ids)
        if normalize:
            feats = feats / torch.linalg.norm(feats, dim=-1, keepdim=True)
        return feats

    def forward(self, images: torch.Tensor, token_ids: torch.Tensor,
                patch_indices: Optional[torch.Tensor] = None):
        return (self.encode_image(images, normalize=True, patch_indices=patch_indices),
                self.encode_text(token_ids, normalize=True),
                self.logit_scale.exp())


def build_clip(config: ModelConfig, device: str | torch.device = "cuda") -> CLIP:
    """The CLIP described by ``config``, its parameters uninitialised, on
    ``device``.

    ``fused_attention=None`` takes the attention kernel (K1) on CUDA and
    the plain path on the CPU; ``parity_mode`` keeps the plain path, runs
    fp32 and turns TF32 off for CUDA matmuls. ``quant`` is read as the JAX
    package reads it (``parity_mode`` forces ``"none"``): ``"int8"`` and
    ``"int8_qat"`` route every projection of both towers' blocks through
    ``tpualign_torch.ops.quant``. ``remat`` (``CLIP_REMAT``) checkpoints
    every residual block of both towers while autograd records.
    """
    quant = "none" if config.parity_mode else config.quant
    if quant not in ("none", "int8", "int8_qat"):
        raise ValueError(f"Unknown CLIP_QUANT mode {config.quant!r}; "
                         "expected 'none', 'int8' or 'int8_qat' "
                         "(QAT: trainable straight-through surrogate)")
    dev = resolve_device(device)
    if config.parity_mode:
        compute_dtype = torch.float32
        torch.backends.cuda.matmul.allow_tf32 = False
    elif config.compute_dtype in _DTYPES:
        compute_dtype = _DTYPES[config.compute_dtype]
    else:
        raise ValueError(f"COMPUTE_DTYPE must be one of {sorted(_DTYPES)}, "
                         f"got {config.compute_dtype!r}")
    fused = config.fused_attention
    if fused is None:
        fused = (not config.parity_mode) and dev.type == "cuda"
    model = CLIP(config.variant, config.use_quick_gelu, compute_dtype, fused, quant,
                 config.remat)
    return model.to(dev)


def _xavier_uniform(p: torch.Tensor, g: torch.Generator) -> None:
    fan_in, fan_out = p.shape
    limit = math.sqrt(6.0 / (fan_in + fan_out))
    p.uniform_(-limit, limit, generator=g)


@torch.no_grad()
def init_clip_params(model: CLIP, seed: int = 0) -> CLIP:
    """Seeded random weights: the no-checkpoint mode.

    The distributions follow the JAX package's initialisers (Xavier-uniform
    projections, zero biases, unit LayerNorms, normal embeddings and
    projections, LeCun-normal patch kernel, logit scale log(1/0.07)), drawn
    from a ``torch.Generator`` seeded with ``seed``. They do NOT reproduce
    JAX's numbers for the same seed; to run both packages on the same
    weights, convert the JAX tree with
    :func:`tpualign_torch.models.convert.from_jax_params`.
    """
    g = torch.Generator().manual_seed(seed)
    for name, p in model.named_parameters():
        leaf = name.rsplit(".", 1)[-1]
        host = torch.empty(p.shape, dtype=torch.float32)
        if leaf.endswith("_kernel") and leaf != "conv1_kernel":
            _xavier_uniform(host, g)
        elif leaf.endswith("bias"):
            host.zero_()
        elif leaf == "scale":
            host.fill_(1.0)
        elif leaf == "conv1_kernel":
            # LeCun normal: truncated at 2 sigma, rescaled to unit variance
            std = math.sqrt(1.0 / (p.shape[0] * p.shape[1] * p.shape[2])) / 0.87962566103423978
            nn.init.trunc_normal_(host, std=std, a=-2 * std, b=2 * std, generator=g)
        elif leaf == "token_embedding":
            host.normal_(0.0, 0.02, generator=g)
        elif name == "text.positional_embedding":
            host.normal_(0.0, 0.01, generator=g)
        elif leaf in ("class_embedding", "positional_embedding"):  # width last
            host.normal_(0.0, p.shape[-1] ** -0.5, generator=g)
        elif leaf in ("proj", "text_projection"):  # (width, embed_dim)
            host.normal_(0.0, p.shape[0] ** -0.5, generator=g)
        elif leaf == "logit_scale":
            host.fill_(math.log(1.0 / 0.07))
        else:
            raise KeyError(f"no initialiser for parameter {name}")
        p.copy_(host)
    return model
