"""Typed configuration for the PyTorch port.

The subset of ``tpualign.config`` that the embed-and-search path reads:
the CLIP variant table, :class:`ModelConfig`, and the environment keys
``CLIP_MODEL``, ``COMPUTE_DTYPE``, ``PARITY_MODE``, ``BATCH_SIZE`` and
``TEXT_BUCKETS``. The values are copied, not imported, so the port loads
without JAX; ``tests/test_torch_models.py`` holds the two tables equal.
"""

from __future__ import annotations

import os
from dataclasses import dataclass
from typing import Mapping, Optional

__all__ = [
    "ClipVariant",
    "CLIP_VARIANTS",
    "ModelConfig",
    "EmbedConfig",
    "normalize_model_name",
    "load_config",
]


@dataclass(frozen=True)
class ClipVariant:
    """Architecture hyper-parameters of one CLIP model size."""

    name: str
    embed_dim: int
    # vision tower
    image_size: int
    patch_size: int
    vision_width: int
    vision_layers: int
    vision_heads: int
    # text tower
    context_length: int
    vocab_size: int
    text_width: int
    text_layers: int
    text_heads: int
    # MLP hidden dims; None = the standard 4x width
    vision_mlp_dim: Optional[int] = None
    text_mlp_dim: Optional[int] = None

    @property
    def grid_size(self) -> int:
        return self.image_size // self.patch_size

    @property
    def num_patches(self) -> int:
        return self.grid_size * self.grid_size


CLIP_VARIANTS: dict = {
    "ViT-B-32": ClipVariant(
        name="ViT-B-32", embed_dim=512,
        image_size=224, patch_size=32, vision_width=768, vision_layers=12, vision_heads=12,
        context_length=77, vocab_size=49408, text_width=512, text_layers=12, text_heads=8,
    ),
    "ViT-B-16": ClipVariant(
        name="ViT-B-16", embed_dim=512,
        image_size=224, patch_size=16, vision_width=768, vision_layers=12, vision_heads=12,
        context_length=77, vocab_size=49408, text_width=512, text_layers=12, text_heads=8,
    ),
    "ViT-L-14": ClipVariant(
        name="ViT-L-14", embed_dim=768,
        image_size=224, patch_size=14, vision_width=1024, vision_layers=24, vision_heads=16,
        context_length=77, vocab_size=49408, text_width=768, text_layers=12, text_heads=12,
    ),
    "ViT-H-14": ClipVariant(
        name="ViT-H-14", embed_dim=1024,
        image_size=224, patch_size=14, vision_width=1280, vision_layers=32, vision_heads=16,
        context_length=77, vocab_size=49408, text_width=1024, text_layers=24, text_heads=16,
    ),
    "ViT-g-14": ClipVariant(
        name="ViT-g-14", embed_dim=1024,
        image_size=224, patch_size=14, vision_width=1408, vision_layers=40, vision_heads=16,
        context_length=77, vocab_size=49408, text_width=1024, text_layers=24, text_heads=16,
        vision_mlp_dim=6144,
    ),
    "ViT-bigG-14": ClipVariant(
        name="ViT-bigG-14", embed_dim=1280,
        image_size=224, patch_size=14, vision_width=1664, vision_layers=48, vision_heads=16,
        context_length=77, vocab_size=49408, text_width=1280, text_layers=32, text_heads=20,
        vision_mlp_dim=8192,
    ),
}


def normalize_model_name(name: str) -> str:
    """``ViT-B/32`` -> ``ViT-B-32``."""
    return name.replace("/", "-")


@dataclass(frozen=True)
class ModelConfig:
    """Model and numerics configuration.

    OpenAI checkpoints use QuickGELU and LAION checkpoints exact GELU, so
    ``quick_gelu=None`` derives the activation from ``pretrained``.
    ``parity_mode`` runs everything in fp32 with the plain attention path.
    ``fused_attention=None`` uses the hand-written attention kernel on CUDA
    unless ``parity_mode`` is set.
    """

    model_name: str = "ViT-B-32"
    pretrained: str = "openai"
    quick_gelu: Optional[bool] = None
    compute_dtype: str = "bfloat16"
    parity_mode: bool = False
    fused_attention: Optional[bool] = None

    @property
    def variant(self) -> ClipVariant:
        name = normalize_model_name(self.model_name)
        if name not in CLIP_VARIANTS:
            raise ValueError(
                f"Unknown CLIP model {self.model_name!r}; "
                f"available: {sorted(CLIP_VARIANTS)}"
            )
        return CLIP_VARIANTS[name]

    @property
    def use_quick_gelu(self) -> bool:
        if self.quick_gelu is not None:
            return self.quick_gelu
        return self.pretrained == "openai"


@dataclass(frozen=True)
class EmbedConfig:
    """What the embed-and-search slice reads from the environment."""

    model: ModelConfig
    batch_size: int = 256
    text_buckets: Optional[tuple] = (16, 32, 77)


def _env(env: Mapping[str, str], key: str, default: str) -> str:
    return env.get(key, os.environ.get(key, default))


def _env_bool(env: Mapping[str, str], key: str, default: bool) -> bool:
    return str(_env(env, key, str(default))).strip().lower() in (
        "true", "1", "yes", "on")


def _parse_buckets(raw: str) -> Optional[tuple]:
    """\"16,32,77\" -> (16, 32, 77); \"off\"/\"none\"/\"\" -> None."""
    raw = str(raw).strip().lower()
    if raw in ("", "off", "none", "false", "0"):
        return None
    return tuple(int(b.strip()) for b in raw.split(",") if b.strip())


def load_config(overrides: Optional[Mapping[str, str]] = None) -> EmbedConfig:
    """Build an :class:`EmbedConfig` from defaults, the process environment
    and ``overrides`` (same keys and defaults as ``tpualign.load_config``)."""
    env = {k: str(v) for k, v in (overrides or {}).items()}
    model = ModelConfig(
        model_name=normalize_model_name(_env(env, "CLIP_MODEL", "ViT-B-32")),
        pretrained=_env(env, "CLIP_PRETRAINED", "openai"),
        compute_dtype=_env(env, "COMPUTE_DTYPE", "bfloat16"),
        parity_mode=_env_bool(env, "PARITY_MODE", False),
    )
    return EmbedConfig(
        model=model,
        batch_size=int(_env(env, "BATCH_SIZE", "256")),
        text_buckets=_parse_buckets(_env(env, "TEXT_BUCKETS", "16,32,77")),
    )
