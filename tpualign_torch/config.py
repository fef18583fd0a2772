"""Typed configuration for the PyTorch port.

The subset of ``tpualign.config`` that the port's paths read: the CLIP
variant table, :class:`ModelConfig`, :class:`DataConfig`,
:class:`StoreConfig`, and a :class:`PipelineConfig` with the pipeline,
document-processing, embed, store, retrieval and serving keys
(``CLIP_MODEL``, ``CLIP_CHECKPOINT*``, ``BATCH_SIZE``, ``TEXT_BUCKETS``,
``IMAGE_PREPROCESS*``, ``INPUT_DIR``, ``LANGUAGE``, ``OUTPUT_DIR``,
``EXCLUDE_TERMS_FILE``, ``EVAL_OUTPUT_DIR``, ``STORE_DIR``,
``RETRIEVAL_*``, ``IVF_*``, ``SERVE_*``, ...), and :class:`TrainConfig`
with the training keys (``LEARNING_RATE`` ... ``DISTILL_TEMPERATURE``,
``TRAIN_*``, ``LORA_*``). The values are copied, not
imported, so the port loads without JAX; ``tests/test_torch_models.py``,
``tests/test_torch_pipeline.py`` and ``tests/test_torch_serving.py`` hold
the two packages' tables and configs equal.
"""

from __future__ import annotations

import os
import re
from dataclasses import dataclass, field
from pathlib import Path
from typing import Mapping, Optional, Sequence

__all__ = [
    "ClipVariant",
    "CLIP_VARIANTS",
    "ModelConfig",
    "MeshConfig",
    "DataConfig",
    "StoreConfig",
    "TrainConfig",
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
    # a CLIP_CHECKPOINT file (OpenCLIP or HuggingFace layout) that
    # EmbedEngine loads in place of the seeded weights
    checkpoint_path: Optional[str] = None
    # CLIP_CHECKPOINT_ALLOW_PICKLE: unpickle a .pt/.bin file that
    # torch.load(weights_only=True) refuses (runs code from the file)
    checkpoint_allow_pickle: bool = False
    # CLIP_QUANT: "none", or "int8"/"int8_qat": every projection of both
    # towers' blocks through ops/quant.py ("int8" serves, "int8_qat" trains)
    quant: str = "none"
    # CLIP_REMAT: under autograd each residual block runs under
    # torch.utils.checkpoint (activations recomputed in the backward)
    remat: bool = False

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
class MeshConfig:
    """The ``MESH_DATA`` x ``MESH_MODEL`` device mesh, tpualign's fields:
    ``data`` shards the corpus of exact retrieval and splits embedding and
    training batches across the cards of one host (``parallel/mesh.py``);
    ``model`` splits the towers' heads and MLP columns over the cards of
    each data row (``parallel/sharding.py``)."""

    data: int = 1
    model: int = 1
    axis_names: Sequence[str] = ("data", "model")

    @property
    def num_devices(self) -> int:
        return self.data * self.model


@dataclass(frozen=True)
class DataConfig:
    """Document processing (stages 1-2) and where stages 3-5 read its
    outputs (``image_metadata.json``, ``text_chunks.json``, the lexical
    components and ``images/``): tpualign's fields and defaults."""

    input_dir: str = "data/raw/manuals"
    output_dir: str = "data/processed"
    language: str = "nl"
    use_ocr_fallback: bool = False
    max_file_size_mb: int = 50
    allowed_file_types: Sequence[str] = ("pdf", "docx", "doc")
    soffice_path: str = "soffice"
    word_to_pdf_timeout_seconds: int = 120
    min_image_size: int = 5  # a vector figure's least width and height
    exclude_terms_file: Optional[str] = None  # the operator's exclusion list
    # chunk-length bounds in characters; None keeps every chunk
    min_chunk_length: Optional[int] = None
    max_chunk_length: Optional[int] = None
    # caption -> image: "first_image" (the reference's rule) or "spatial"
    caption_linking: str = "first_image"

    @property
    def images_dir(self) -> str:
        return str(Path(self.output_dir) / "images")


@dataclass(frozen=True)
class StoreConfig:
    """Embedding-store configuration: the store's root directory."""

    root: str = "data/store"


@dataclass(frozen=True)
class TrainConfig:
    """Weak-supervision-weighted contrastive fine-tuning: tpualign's
    fields and defaults (see ``tpualign.config.TrainConfig`` for each)."""

    learning_rate: float = 1e-5
    weight_decay: float = 0.2
    batch_size: int = 256
    warmup_steps: int = 200
    total_steps: int = 2000
    weak_score_temperature: float = 0.5
    label_smoothing: float = 0.0
    # FLIP visible-patch ratio to MASK during training (0 = off)
    patch_mask_ratio: float = 0.0
    loss_type: str = "clip"          # "clip" (InfoNCE) or "siglip"
    siglip_bias: float = -10.0
    # cached-feature accumulation microsteps per optimizer step (1 = off)
    grad_accum_steps: int = 1
    ema_decay: float = 0.0           # 0 = no EMA
    moments_dtype: str = "float32"   # AdamW's first moment: float32/bfloat16
    lora_rank: int = 0               # > 0: frozen base, low-rank adapters
    lora_alpha: float = 16.0
    seed: int = 0
    distill_checkpoint: str = ""
    distill_model: str = ""
    distill_weight: float = 0.5
    distill_temperature: float = 1.0
    feed_workers: int = 0            # decode pool (0 = min(8, cores))
    feed_cache_mb: int = 2048
    image_feed: str = "host"         # "host" pixels or "device" uint8 buckets
    augment: str = "none"            # "rrc": device feed only
    lora_base_dtype: str = "float32"
    # TRAIN_FSDP: on a mesh, params, moments and EMA also split over ``data``
    fsdp: bool = False


@dataclass(frozen=True)
class PipelineConfig:
    """What the port's entry points read: the pipeline's directories, the
    embed batch and image feed, the store, and the retrieval and serving
    knobs of ``serve`` and ``query``, under tpualign's names and defaults
    (see ``tpualign.config.PipelineConfig`` for what each knob does)."""

    model: ModelConfig = field(default_factory=ModelConfig)
    mesh: MeshConfig = field(default_factory=MeshConfig)
    data: DataConfig = field(default_factory=DataConfig)
    store: StoreConfig = field(default_factory=StoreConfig)
    train: TrainConfig = field(default_factory=TrainConfig)
    eval_output_dir: str = "evaluation_results"
    batch_size: int = 256
    # image feed: "host" (PIL bicubic per image) or "device" (uint8
    # buckets, resize and normalisation on the device), and the bucket edge
    image_preprocess: str = "host"
    image_preprocess_bucket: int = 256
    seed: int = 0
    retrieval_recall_target: Optional[float] = None
    retrieval_index: str = "exact"
    # fp32, int8, int4 or int2; RETRIEVAL_INDEX=hnsw takes fp32 or fp16
    # (pgvector's vector and halfvec) and warns on the int rungs
    retrieval_precision: str = "fp32"
    retrieval_refine: int = 0
    retrieval_refine_store: str = "auto"
    # IVF geometry (None = sqrt(N) lists, lists//8 probes) and the artifact
    # path (None = rebuild at each serve start)
    ivf_lists: Optional[int] = None
    ivf_probes: Optional[int] = None
    ivf_cache: Optional[str] = None
    # HNSW geometry, pgvector's defaults; ef_search None = auto (40, or
    # calibrated to RETRIEVAL_RECALL_TARGET); the graph's artifact path
    hnsw_m: int = 16
    hnsw_ef_construction: int = 64
    hnsw_ef_search: Optional[int] = None
    hnsw_cache: Optional[str] = None
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


def _train_config(env: Mapping[str, str]) -> TrainConfig:
    """The training keys, with tpualign's defaults and validation errors."""
    train = TrainConfig(
        learning_rate=float(_env(env, "LEARNING_RATE", "1e-5")),
        weight_decay=float(_env(env, "WEIGHT_DECAY", "0.2")),
        batch_size=int(_env(env, "TRAIN_BATCH_SIZE", "")
                       or _env(env, "BATCH_SIZE", "256") or "256"),
        warmup_steps=int(_env(env, "WARMUP_STEPS", "200")),
        total_steps=int(_env(env, "TOTAL_STEPS", "2000")),
        weak_score_temperature=float(_env(env, "WEAK_SCORE_TEMPERATURE", "0.5")),
        label_smoothing=float(_env(env, "LABEL_SMOOTHING", "0.0")),
        patch_mask_ratio=float(_env(env, "PATCH_MASK_RATIO", "0.0")),
        loss_type=_env(env, "LOSS_TYPE", "clip"),
        siglip_bias=float(_env(env, "SIGLIP_BIAS", "-10.0")),
        grad_accum_steps=int(_env(env, "GRAD_ACCUM_STEPS", "1")),
        ema_decay=float(_env(env, "EMA_DECAY", "0.0")),
        moments_dtype=_env(env, "MOMENTS_DTYPE", "float32"),
        fsdp=_env_bool(env, "TRAIN_FSDP", False),
        seed=int(_env(env, "SEED", "0")),
        feed_workers=int(_env(env, "TRAIN_FEED_WORKERS", "0")),
        feed_cache_mb=int(_env(env, "TRAIN_FEED_CACHE_MB", "2048")),
        image_feed=_env(env, "TRAIN_IMAGE_FEED", "host"),
        augment=_env(env, "TRAIN_AUGMENT", "none"),
        lora_rank=int(_env(env, "LORA_RANK", "0")),
        lora_alpha=float(_env(env, "LORA_ALPHA", "16.0")),
        lora_base_dtype=_env(env, "LORA_BASE_DTYPE", "float32"),
        distill_checkpoint=_env(env, "DISTILL_CHECKPOINT", ""),
        distill_model=_env(env, "DISTILL_MODEL", ""),
        distill_weight=float(_env(env, "DISTILL_WEIGHT", "0.5")),
        distill_temperature=float(_env(env, "DISTILL_TEMPERATURE", "1.0")),
    )
    if not 0.0 <= train.distill_weight <= 1.0:
        raise ValueError(f"DISTILL_WEIGHT must be in [0, 1], got {train.distill_weight}")
    if train.distill_temperature <= 0.0:
        raise ValueError(f"DISTILL_TEMPERATURE must be > 0, got {train.distill_temperature}")
    if train.distill_model and not train.distill_checkpoint:
        raise ValueError(
            "DISTILL_MODEL is set but DISTILL_CHECKPOINT is not — a teacher "
            "needs weights (set DISTILL_CHECKPOINT to the teacher checkpoint)")
    if train.image_feed not in ("host", "device"):
        raise ValueError(f"TRAIN_IMAGE_FEED must be host|device, got {train.image_feed!r}")
    if train.augment not in ("none", "rrc"):
        raise ValueError(f"TRAIN_AUGMENT must be none|rrc, got {train.augment!r}")
    if train.augment == "rrc" and train.image_feed != "device":
        raise ValueError(
            "TRAIN_AUGMENT=rrc needs TRAIN_IMAGE_FEED=device (crop boxes "
            "fold into the on-device resize weights)")
    return train


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
        checkpoint_allow_pickle=_env_bool(env, "CLIP_CHECKPOINT_ALLOW_PICKLE", False),
        compute_dtype=_env(env, "COMPUTE_DTYPE", "bfloat16"),
        parity_mode=_env_bool(env, "PARITY_MODE", False),
        quant=_env(env, "CLIP_QUANT", "none"),
        remat=_env_bool(env, "CLIP_REMAT", False),
    )
    mesh = MeshConfig(data=int(_env(env, "MESH_DATA", "1")),
                      model=int(_env(env, "MESH_MODEL", "1")))
    train = _train_config(env)
    serve_auto_compact = _optional(env, "SERVE_AUTO_COMPACT", float, ("", "off", "none"))
    if serve_auto_compact is not None and not 0.0 < serve_auto_compact <= 1.0:
        raise ValueError(
            f"SERVE_AUTO_COMPACT must be a fraction in (0, 1] (postgres' "
            f"autovacuum scale factor analogue), got {serve_auto_compact}")
    return PipelineConfig(
        model=model,
        mesh=mesh,
        data=DataConfig(
            input_dir=_env(env, "INPUT_DIR", "data/raw/manuals"),
            output_dir=_env(env, "OUTPUT_DIR", "data/processed"),
            language=_env(env, "LANGUAGE", "nl"),
            use_ocr_fallback=_env_bool(env, "USE_OCR_FALLBACK", False),
            max_file_size_mb=int(_env(env, "MAX_FILE_SIZE_MB", "50")),
            caption_linking=_env(env, "CAPTION_LINKING", "first_image"),
            allowed_file_types=tuple(t.strip() for t in _env(
                env, "ALLOWED_FILE_TYPES", "pdf,docx,doc").split(",") if t.strip()),
            soffice_path=_env(env, "SOFFICE_PATH", "soffice"),
            word_to_pdf_timeout_seconds=int(_env(env, "WORD_TO_PDF_TIMEOUT_SECONDS", "120")),
            exclude_terms_file=_env(env, "EXCLUDE_TERMS_FILE", "") or None,
        ),
        store=StoreConfig(root=_env(env, "STORE_DIR", "data/store")),
        train=train,
        eval_output_dir=_env(env, "EVAL_OUTPUT_DIR", "evaluation_results"),
        batch_size=int(_env(env, "BATCH_SIZE", "256")),
        image_preprocess=_env(env, "IMAGE_PREPROCESS", "host"),
        image_preprocess_bucket=int(_env(env, "IMAGE_PREPROCESS_BUCKET", "256")),
        seed=int(_env(env, "SEED", "0")),
        retrieval_recall_target=_optional(env, "RETRIEVAL_RECALL_TARGET", float),
        retrieval_index=_env(env, "RETRIEVAL_INDEX", "exact"),
        retrieval_precision=_env(env, "RETRIEVAL_PRECISION", "fp32"),
        retrieval_refine=int(_env(env, "RETRIEVAL_REFINE", "0")),
        retrieval_refine_store=_env(env, "RETRIEVAL_REFINE_STORE", "auto"),
        ivf_lists=_optional(env, "IVF_LISTS", int),
        ivf_probes=_optional(env, "IVF_PROBES", int),
        ivf_cache=_env(env, "IVF_CACHE", "") or None,
        hnsw_m=int(_env(env, "HNSW_M", "16")),
        hnsw_ef_construction=int(_env(env, "HNSW_EF_CONSTRUCTION", "64")),
        hnsw_ef_search=_optional(env, "HNSW_EF_SEARCH", int),
        hnsw_cache=_env(env, "HNSW_CACHE", "") or None,
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
