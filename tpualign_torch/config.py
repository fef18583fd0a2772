"""Typed configuration for the PyTorch port.

The subset of ``tpualign.config`` that the port's paths read: the CLIP
variant table, :class:`ModelConfig`, :class:`StoreConfig`, and a
:class:`PipelineConfig` with the embed, store, retrieval and serving keys
(``CLIP_MODEL``, ``BATCH_SIZE``, ``TEXT_BUCKETS``, ``STORE_DIR``,
``RETRIEVAL_*``, ``IVF_*``, ``SERVE_*``, ...). The values are copied, not imported,
so the port loads without JAX; ``tests/test_torch_models.py`` and
``tests/test_torch_serving.py`` hold the two packages' tables and configs
equal.
"""

from __future__ import annotations

import os
import re
from dataclasses import dataclass, field
from pathlib import Path
from typing import Mapping, Optional

__all__ = [
    "ClipVariant",
    "CLIP_VARIANTS",
    "ModelConfig",
    "StoreConfig",
    "PipelineConfig",
    "normalize_model_name",
    "load_env_file",
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
    # a CLIP_CHECKPOINT path; loading checkpoints is not yet ported
    checkpoint_path: Optional[str] = None

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
class StoreConfig:
    """Embedding-store configuration: the store's root directory."""

    root: str = "data/store"


@dataclass(frozen=True)
class PipelineConfig:
    """What the port's entry points read: the embed batch, the store, and
    the retrieval and serving knobs of ``serve`` and ``query``, under
    tpualign's names and defaults (see ``tpualign.config.PipelineConfig``
    for what each knob does)."""

    model: ModelConfig = field(default_factory=ModelConfig)
    store: StoreConfig = field(default_factory=StoreConfig)
    batch_size: int = 256
    seed: int = 0
    retrieval_recall_target: Optional[float] = None
    retrieval_index: str = "exact"
    retrieval_precision: str = "fp32"
    retrieval_refine: int = 0
    retrieval_refine_store: str = "auto"
    # IVF geometry (None = sqrt(N) lists, lists//8 probes) and the artifact
    # path (None = rebuild at each serve start)
    ivf_lists: Optional[int] = None
    ivf_probes: Optional[int] = None
    ivf_cache: Optional[str] = None
    text_buckets: Optional[tuple] = (16, 32, 77)
    serve_coalesce_ms: Optional[float] = 2.0
    serve_query_cache: int = 1024
    serve_token: Optional[str] = None
    serve_idle_timeout: float = 60.0
    serve_max_body_bytes: int = 64 * 2**20
    serve_max_connections: int = 128
    serve_request_deadline: float = 30.0
    serve_auto_compact: Optional[float] = None


def load_env_file(path: str = ".env") -> dict:
    """Minimal ``.env`` parser, tpualign's: lines of ``KEY=VALUE``, ``#``
    comments and blank lines ignored, values optionally quoted. Does not
    override variables already in ``os.environ``."""
    out: dict = {}
    p = Path(path)
    if not p.exists():
        return out
    for raw in p.read_text(encoding="utf-8").splitlines():
        line = raw.strip()
        if not line or line.startswith("#") or "=" not in line:
            continue
        key, _, rhs = line.partition("=")
        key = key.strip()
        stripped = rhs.strip()
        if stripped[:1] in ("\"", "'"):
            # quoted: closes at the last matching quote; what follows is dropped
            m = re.match(r"^(['\"])(.*)\1", stripped)
            value = m.group(2) if m else stripped
        else:
            # an inline comment is '#' preceded by whitespace
            value = re.sub(r"\s+#.*", "", rhs).strip()
        out[key] = value
        os.environ.setdefault(key, value)
    return out


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


def _optional(env: Mapping[str, str], key: str, cast, off=("",)):
    raw = _env(env, key, "")
    return None if raw.strip().lower() in off else cast(raw)


def load_config(overrides: Optional[Mapping[str, str]] = None,
                env_file: Optional[str] = None) -> PipelineConfig:
    """Build a :class:`PipelineConfig` from defaults, ``env_file`` (a
    ``.env``, when given), the process environment and ``overrides``, with
    tpualign's keys, defaults and validation (``tpualign.load_config``)."""
    env: dict = {}
    if env_file:
        env.update(load_env_file(env_file))
    env.update({k: str(v) for k, v in (overrides or {}).items()})
    model = ModelConfig(
        model_name=normalize_model_name(_env(env, "CLIP_MODEL", "ViT-B-32")),
        pretrained=_env(env, "CLIP_PRETRAINED", "openai"),
        checkpoint_path=_env(env, "CLIP_CHECKPOINT", "") or None,
        compute_dtype=_env(env, "COMPUTE_DTYPE", "bfloat16"),
        parity_mode=_env_bool(env, "PARITY_MODE", False),
    )
    serve_auto_compact = _optional(env, "SERVE_AUTO_COMPACT", float, ("", "off", "none"))
    if serve_auto_compact is not None and not 0.0 < serve_auto_compact <= 1.0:
        raise ValueError(
            f"SERVE_AUTO_COMPACT must be a fraction in (0, 1] (postgres' "
            f"autovacuum scale factor analogue), got {serve_auto_compact}")
    return PipelineConfig(
        model=model,
        store=StoreConfig(root=_env(env, "STORE_DIR", "data/store")),
        batch_size=int(_env(env, "BATCH_SIZE", "256")),
        seed=int(_env(env, "SEED", "0")),
        retrieval_recall_target=_optional(env, "RETRIEVAL_RECALL_TARGET", float),
        retrieval_index=_env(env, "RETRIEVAL_INDEX", "exact"),
        retrieval_precision=_env(env, "RETRIEVAL_PRECISION", "fp32"),
        retrieval_refine=int(_env(env, "RETRIEVAL_REFINE", "0")),
        retrieval_refine_store=_env(env, "RETRIEVAL_REFINE_STORE", "auto"),
        ivf_lists=_optional(env, "IVF_LISTS", int),
        ivf_probes=_optional(env, "IVF_PROBES", int),
        ivf_cache=_env(env, "IVF_CACHE", "") or None,
        text_buckets=_parse_buckets(_env(env, "TEXT_BUCKETS", "16,32,77")),
        serve_coalesce_ms=(
            float(_env(env, "SERVE_COALESCE_MS", "2.0"))
            if _env(env, "SERVE_COALESCE_MS", "2.0").lower() not in ("off", "none", "")
            else None),
        serve_query_cache=int(_env(env, "SERVE_QUERY_CACHE", "1024")),
        serve_token=_env(env, "SERVE_TOKEN", "") or None,
        serve_idle_timeout=float(_env(env, "SERVE_IDLE_TIMEOUT", "60")),
        serve_max_body_bytes=int(_env(env, "SERVE_MAX_BODY_BYTES", str(64 * 2**20))),
        serve_max_connections=int(_env(env, "SERVE_MAX_CONNECTIONS", "128")),
        serve_request_deadline=float(_env(env, "SERVE_REQUEST_DEADLINE", "30")),
        serve_auto_compact=serve_auto_compact,
    )
