"""Checkpoint loading: OpenCLIP / HuggingFace CLIP state dicts -> the JAX
package's parameter layout (the port's copy of ``tpualign.models.loader``).

``CLIP_CHECKPOINT`` names a local file: an OpenCLIP/OpenAI ``state_dict``
(``.pt`` / ``.bin`` through torch, ``.safetensors`` through safetensors)
or a HuggingFace ``CLIPModel`` state dict, or a training run's checkpoint
directory (``train/checkpoint.py``). It is converted into nested
dicts of float32 numpy arrays in the JAX tree's names and layouts, which
:func:`tpualign_torch.models.convert.from_jax_params` loads into the
port's towers. Without a checkpoint, ``EmbedEngine`` draws seeded random
weights instead.
"""

from __future__ import annotations

import os
from typing import Any, Dict, Mapping

import numpy as np

from tpualign_torch.config import ClipVariant, ModelConfig
from tpualign_torch.utils.logging import get_logger

log = get_logger("models.loader")

__all__ = ["convert_openclip_state_dict", "convert_hf_clip_state_dict", "load_checkpoint_params"]

Params = Dict[str, Any]


def _np(t) -> np.ndarray:
    """torch tensor / array-like -> float32 numpy."""
    if hasattr(t, "detach"):
        t = t.detach().cpu().numpy()
    return np.asarray(t, dtype=np.float32)


def _ln(sd: Mapping[str, Any], name: str) -> Params:
    return {"scale": _np(sd[f"{name}.weight"]), "bias": _np(sd[f"{name}.bias"])}


# -- OpenCLIP (OpenAI layout) ------------------------------------------------------


def _convert_tower_blocks(sd: Mapping[str, Any], prefix: str, num_layers: int) -> Params:
    """``{prefix}.resblocks.{i}.*`` -> the JAX tree's ``resblock_{i}``."""
    out: Params = {}
    for i in range(num_layers):
        p = f"{prefix}.resblocks.{i}"
        out[f"resblock_{i}"] = {
            "ln_1": _ln(sd, f"{p}.ln_1"),
            "attn": {
                # torch in_proj_weight: (3d, d); the tree's: (d, 3d)
                "in_proj_kernel": _np(sd[f"{p}.attn.in_proj_weight"]).T,
                "in_proj_bias": _np(sd[f"{p}.attn.in_proj_bias"]),
                "out_proj_kernel": _np(sd[f"{p}.attn.out_proj.weight"]).T,
                "out_proj_bias": _np(sd[f"{p}.attn.out_proj.bias"]),
            },
            "ln_2": _ln(sd, f"{p}.ln_2"),
            "mlp": {
                "c_fc_kernel": _np(sd[f"{p}.mlp.c_fc.weight"]).T,
                "c_fc_bias": _np(sd[f"{p}.mlp.c_fc.bias"]),
                "c_proj_kernel": _np(sd[f"{p}.mlp.c_proj.weight"]).T,
                "c_proj_bias": _np(sd[f"{p}.mlp.c_proj.bias"]),
            },
        }
    return out


def convert_openclip_state_dict(sd: Mapping[str, Any], variant: ClipVariant) -> Params:
    """OpenCLIP/OpenAI ``state_dict`` -> the JAX tree's layout."""
    visual: Params = {
        # torch conv weight: (out, in, kh, kw); the tree's: (kh, kw, in, out)
        "conv1": {"kernel": _np(sd["visual.conv1.weight"]).transpose(2, 3, 1, 0)},
        "class_embedding": _np(sd["visual.class_embedding"]),
        "positional_embedding": _np(sd["visual.positional_embedding"]),
        "ln_pre": _ln(sd, "visual.ln_pre"),
        "transformer": _convert_tower_blocks(sd, "visual.transformer", variant.vision_layers),
        "ln_post": _ln(sd, "visual.ln_post"),
        "proj": _np(sd["visual.proj"]),
    }
    text: Params = {
        "token_embedding": _np(sd["token_embedding.weight"]),
        "positional_embedding": _np(sd["positional_embedding"]),
        "transformer": _convert_tower_blocks(sd, "transformer", variant.text_layers),
        "ln_final": _ln(sd, "ln_final"),
        "text_projection": _np(sd["text_projection"]),
    }
    return {"visual": visual, "text": text, "logit_scale": _np(sd["logit_scale"]).reshape(())}


# -- HuggingFace CLIPModel -------------------------------------------------------------


def _convert_hf_blocks(sd: Mapping[str, Any], prefix: str, num_layers: int) -> Params:
    """``{prefix}.layers.{i}.*`` -> ``resblock_{i}``; HF's separate q/k/v
    projections are concatenated into ``in_proj``."""
    out: Params = {}
    for i in range(num_layers):
        p = f"{prefix}.layers.{i}"
        qkv = [f"{p}.self_attn.{n}_proj" for n in "qkv"]
        out[f"resblock_{i}"] = {
            "ln_1": _ln(sd, f"{p}.layer_norm1"),
            "attn": {
                "in_proj_kernel": np.concatenate([_np(sd[f"{n}.weight"]) for n in qkv],
                                                 axis=0).T,
                "in_proj_bias": np.concatenate([_np(sd[f"{n}.bias"]) for n in qkv], axis=0),
                "out_proj_kernel": _np(sd[f"{p}.self_attn.out_proj.weight"]).T,
                "out_proj_bias": _np(sd[f"{p}.self_attn.out_proj.bias"]),
            },
            "ln_2": _ln(sd, f"{p}.layer_norm2"),
            "mlp": {
                "c_fc_kernel": _np(sd[f"{p}.mlp.fc1.weight"]).T,
                "c_fc_bias": _np(sd[f"{p}.mlp.fc1.bias"]),
                "c_proj_kernel": _np(sd[f"{p}.mlp.fc2.weight"]).T,
                "c_proj_bias": _np(sd[f"{p}.mlp.fc2.bias"]),
            },
        }
    return out


def convert_hf_clip_state_dict(sd: Mapping[str, Any], variant: ClipVariant) -> Params:
    """HuggingFace ``CLIPModel.state_dict()`` -> the JAX tree's layout."""
    emb = "vision_model.embeddings"
    visual: Params = {
        "conv1": {"kernel": _np(sd[f"{emb}.patch_embedding.weight"]).transpose(2, 3, 1, 0)},
        "class_embedding": _np(sd[f"{emb}.class_embedding"]),
        "positional_embedding": _np(sd[f"{emb}.position_embedding.weight"]),
        "ln_pre": _ln(sd, "vision_model.pre_layrnorm"),
        "transformer": _convert_hf_blocks(sd, "vision_model.encoder", variant.vision_layers),
        "ln_post": _ln(sd, "vision_model.post_layernorm"),
        "proj": _np(sd["visual_projection.weight"]).T,
    }
    text: Params = {
        "token_embedding": _np(sd["text_model.embeddings.token_embedding.weight"]),
        "positional_embedding": _np(sd["text_model.embeddings.position_embedding.weight"]),
        "transformer": _convert_hf_blocks(sd, "text_model.encoder", variant.text_layers),
        "ln_final": _ln(sd, "text_model.final_layer_norm"),
        "text_projection": _np(sd["text_projection.weight"]).T,
    }
    return {"visual": visual, "text": text, "logit_scale": _np(sd["logit_scale"]).reshape(())}


# -- files ------------------------------------------------------------------------------


def _read_state_dict(path: str, allow_pickle: bool = False) -> Mapping[str, Any]:
    """Read a checkpoint's state dict, through the safe loaders first.

    ``.safetensors`` reads through ``safetensors.numpy``. A torch
    ``.pt``/``.bin`` file is read with ``torch.load(weights_only=True)``,
    which refuses to run pickled code; full unpickling (which runs code
    from the file) happens only with ``allow_pickle=True``
    (``CLIP_CHECKPOINT_ALLOW_PICKLE``). A ``state_dict`` entry, a module,
    and a ``module.``/``model.`` prefix on every key are unwrapped.
    """
    if path.endswith(".safetensors"):
        from safetensors.numpy import load_file

        return load_file(path)
    import torch

    try:
        obj = torch.load(path, map_location="cpu", weights_only=True)
    except Exception as safe_err:
        if not allow_pickle:
            raise ValueError(
                f"Checkpoint {path!r} is not loadable with "
                f"torch.load(weights_only=True) ({safe_err}). If you trust "
                f"its source, re-export it as .safetensors or opt in to "
                f"full unpickling with allow_pickle=True / "
                f"CLIP_CHECKPOINT_ALLOW_PICKLE=true."
            ) from safe_err
        obj = torch.load(path, map_location="cpu", weights_only=False)
    if isinstance(obj, dict) and "state_dict" in obj:
        obj = obj["state_dict"]
    if hasattr(obj, "state_dict"):
        obj = obj.state_dict()
    keys = list(obj.keys())
    for prefix in ("module.", "model."):
        if keys and all(k.startswith(prefix) for k in keys):
            obj = {k[len(prefix):]: v for k, v in obj.items()}
            keys = list(obj.keys())
    return obj


def load_checkpoint_params(config: ModelConfig, path: str | None = None) -> Params:
    """Load and convert the checkpoint file ``path`` (default:
    ``config.checkpoint_path``) for ``config``'s variant. The layout is
    detected from the keys: ``visual.`` is OpenCLIP, ``vision_model.`` is
    HuggingFace. A directory is a training run's checkpoints
    (``python -m tpualign_torch train --ckpt-dir``): its newest step's
    params load through ``train.checkpoint.load_trained_params`` (the EMA
    when tracked, LoRA merged)."""
    path = path or config.checkpoint_path
    if not path:
        raise FileNotFoundError("No checkpoint path configured (set CLIP_CHECKPOINT or "
                                "ModelConfig.checkpoint_path)")
    if os.path.isdir(path):
        from tpualign_torch.train.checkpoint import load_trained_params

        log.info("Loading trained params from checkpoint directory %s", path)
        return load_trained_params(path)
    sd = _read_state_dict(path, allow_pickle=config.checkpoint_allow_pickle)
    keys = set(sd.keys())
    variant = config.variant
    if any(k.startswith("visual.") for k in keys):
        log.info("Loading OpenCLIP-layout checkpoint from %s", path)
        return convert_openclip_state_dict(sd, variant)
    if any(k.startswith("vision_model.") for k in keys):
        log.info("Loading HuggingFace-layout checkpoint from %s", path)
        return convert_hf_clip_state_dict(sd, variant)
    raise ValueError(f"Unrecognized checkpoint layout in {path}")
