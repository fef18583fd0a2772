"""Training checkpoints in the port's own format (the port's
``tpualign.train.checkpoint``; tpualign writes orbax).

A checkpoint directory holds one ``<step>/`` per save, each with one
``state.pt``: a ``torch.save`` of ``{params, opt_state, step}`` and, when
the state has them, ``ema_params``, ``frozen_params`` and ``lora_scale``
(tensors on the CPU, plain ints and floats; ``torch.load(weights_only=True)``
reads it). The newest three saves are kept. A mesh state's sharded
tensors are gathered whole into the same file; a restore lays them back out
in the receiving state's layout (TP and FSDP). Across processes every
process calls :func:`save_checkpoint` alike: the FSDP slices are
all-gathered, process 0 alone writes the file (the one a one-process run of
the same mesh writes), and every process waits for it at a barrier; a
restore on every process keeps its own parts. A tpualign orbax directory
cannot be read here: orbax does not import without JAX, so it raises one
clear error.
"""

from __future__ import annotations

import os
import shutil
from pathlib import Path
from typing import Optional

import torch

from tpualign_torch.parallel.sharding import ShardedTensor, gather_full
from tpualign_torch.utils.logging import get_logger

log = get_logger("train.checkpoint")

__all__ = ["save_checkpoint", "restore_checkpoint", "latest_step", "load_trained_params"]

STATE_FILE = "state.pt"
MAX_TO_KEEP = 3


def _to_cpu(obj):
    if torch.is_tensor(obj):
        return obj.detach().cpu()
    if isinstance(obj, dict):
        return {k: _to_cpu(v) for k, v in gather_full(obj).items()}
    return obj


def _to_device(obj, like):
    """``obj``'s tensors on the device (and in the dtype) of the matching
    tensors of ``like``; into ``like``'s layout where it is sharded."""
    if torch.is_tensor(obj) and isinstance(like, ShardedTensor):
        return ShardedTensor.from_full(obj, like.mesh, like.spec, like.perm, like.dtype)
    if torch.is_tensor(obj):
        if torch.is_tensor(like):
            return obj.to(device=like.device, dtype=like.dtype)
        return obj
    if isinstance(obj, dict):
        return {k: _to_device(v, like.get(k) if isinstance(like, dict) else None)
                for k, v in obj.items()}
    return obj


def _steps(directory: Path) -> list:
    if not directory.is_dir():
        return []
    return sorted(int(p.name) for p in directory.iterdir()
                  if p.is_dir() and p.name.isdigit() and (p / STATE_FILE).exists())


def _refuse_orbax(directory: Path) -> None:
    """A directory of numbered steps without ``state.pt`` (or with
    orbax's metadata) is tpualign's orbax format."""
    if not directory.is_dir():
        return
    numbered = [p for p in directory.iterdir() if p.is_dir() and p.name.isdigit()]
    orbax = (any(not (p / STATE_FILE).exists() for p in numbered)
             or any((directory / n).exists() for n in ("_CHECKPOINT_METADATA", "checkpoint")))
    if orbax and not _steps(directory):
        raise ValueError(
            f"{directory} holds tpualign (orbax) checkpoints, which tpualign_torch cannot "
            "read: orbax does not import without JAX. Export the params with tpualign "
            "(e.g. to an OpenCLIP state dict) or train with tpualign_torch")


def latest_step(directory: str | Path) -> Optional[int]:
    """The newest saved step in ``directory``, or None."""
    d = Path(directory)
    _refuse_orbax(d)
    steps = _steps(d)
    return steps[-1] if steps else None


def save_checkpoint(directory: str | Path, state, step: Optional[int] = None) -> int:
    """Save ``state`` under ``<directory>/<step>/state.pt`` (written to a
    temporary name, then renamed) and keep the newest three saves; across
    processes every process calls it, and process 0 writes."""
    d = Path(directory).absolute()
    step = int(state.step) if step is None else int(step)
    payload = {"params": state.params, "opt_state": state.opt_state, "step": step}
    if getattr(state, "ema_params", None) is not None:
        payload["ema_params"] = state.ema_params
    if getattr(state, "frozen_params", None) is not None:
        # LoRA: params is the adapter dict; the base and the merge scale keep
        # the checkpoint self-contained for params-only loading
        payload["frozen_params"] = state.frozen_params
        payload["lora_scale"] = float(state.lora_scale)
    payload = _to_cpu(payload)
    mesh = getattr(state, "mesh", None)
    if mesh is None or not mesh.distributed or mesh.rank == mesh.processes[0]:
        target = d / str(step)
        target.mkdir(parents=True, exist_ok=True)
        tmp = target / (STATE_FILE + ".tmp")
        torch.save(payload, tmp)
        os.replace(tmp, target / STATE_FILE)
        for old in _steps(d)[:-MAX_TO_KEEP]:
            shutil.rmtree(d / str(old), ignore_errors=True)
        log.info("saved checkpoint step=%d -> %s", step, directory)
    if mesh is not None and mesh.distributed:
        from tpualign_torch.parallel.multihost import process_barrier

        process_barrier(mesh)
    return step


def _load(directory: str | Path, step: Optional[int]):
    d = Path(directory)
    step = latest_step(d) if step is None else step
    if step is None:
        return None, None
    return step, torch.load(d / str(step) / STATE_FILE, map_location="cpu", weights_only=True)


def load_trained_params(directory: str | Path, step: Optional[int] = None) -> dict:
    """Params-only restore for embedding and serving: the EMA when the
    checkpoint tracked one, under LoRA merged into the frozen base, as
    nested float32 numpy arrays in the JAX tree's layout (what
    ``models.loader.load_checkpoint_params`` returns, so a training
    directory serves as ``CLIP_CHECKPOINT``)."""
    from tpualign_torch.models.convert import to_jax_layout

    step, restored = _load(directory, step)
    if restored is None:
        raise FileNotFoundError(f"no checkpoint steps in {directory}")
    params = restored.get("ema_params") or restored["params"]
    if restored.get("frozen_params") is not None:
        from tpualign_torch.train.lora import lora_apply

        params = lora_apply(restored["frozen_params"], params, float(restored["lora_scale"]))
    log.info("loaded trained params (step=%d, ema=%s, lora=%s) from %s", step,
             restored.get("ema_params") is not None,
             restored.get("frozen_params") is not None, directory)
    return to_jax_layout(params)


def restore_checkpoint(directory: str | Path, state, step: Optional[int] = None):
    """Restore into ``state`` (a ``TrainState``, its tensors' devices and
    dtypes kept); returns it, or None when there is no checkpoint. A state
    that tracks an EMA restored from a checkpoint saved without one
    restarts the average from the restored params."""
    step, restored = _load(directory, step)
    if restored is None:
        return None
    state.params = _to_device(restored["params"], state.params)
    state.opt_state = _to_device(restored["opt_state"], state.opt_state)
    state.step = int(restored["step"])
    if getattr(state, "ema_params", None) is not None:
        ema = restored.get("ema_params")
        state.ema_params = ({k: (v.map(torch.clone) if isinstance(v, ShardedTensor) else v.clone())
                             for k, v in state.params.items()} if ema is None
                            else _to_device(ema, state.ema_params))
    if state.frozen_params is not None and restored.get("frozen_params") is not None:
        state.frozen_params = _to_device(restored["frozen_params"], state.frozen_params)
    saved_scale = restored.get("lora_scale")
    if saved_scale is not None and abs(float(saved_scale) - float(state.lora_scale)) > 1e-9:
        log.warning("checkpoint lora scale %.4f != configured %.4f (LORA_RANK/LORA_ALPHA "
                    "changed since save); the configured value applies",
                    float(saved_scale), float(state.lora_scale))
    log.info("restored checkpoint step=%d from %s", step, directory)
    return state
