"""Builds and loads the port's CUDA kernels.

Each ``csrc/<name>.cu`` is compiled by ``nvcc`` into a shared library with
a plain C interface (``-gencode arch=compute_90a,code=sm_90a``), under
``tpualign_torch/_build/`` and keyed by a hash of the sources and flags, at
first use; ``ctypes`` loads it. Nothing here runs when the package is
imported, and nothing builds on a machine without ``nvcc``: the CPU path
never calls in.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import threading
from pathlib import Path
from typing import Dict, Iterable

import torch

__all__ = ["KERNELS", "build", "build_all", "call", "load"]

_PKG = Path(__file__).resolve().parent.parent
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG / "_build"
KERNELS = ("fused_mha", "masked_sim_topk", "masked_sim_topk_quant", "ivf_probe_topk",
           "normalize_u8")
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC",
)

_P = ctypes.c_void_p
_I = ctypes.c_int
_F = ctypes.c_float
# C signatures: (argtypes, restype) of each kernel's entry point
_SIGNATURES = {
    "fused_mha": ("tpualign_fused_mha",
                  [_P, _P, _P, _I, _I, _I, _I, ctypes.c_float, _I, _I, _P]),
    "masked_sim_topk": ("tpualign_masked_sim_topk",
                        [_P, _P, _P, _P, _I, _I, _I, _I, _I, _P, _P, _P, _P, _P, _I, _P]),
    "masked_sim_topk_quant": ("tpualign_masked_sim_topk_quant",
                              [_I, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _P, _P, _P, _P,
                               _P, _P, _P, _I, _P]),
    "ivf_probe_topk": ("tpualign_ivf_probe_topk",
                       [_I, _P, _P, _P, _I, _P, _I, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _I,
                        _P, _P, _P, _P, _P, _P, _P, _P, _I, _P]),
    "normalize_u8": ("tpualign_normalize_u8",
                     [_P, _P, ctypes.c_longlong, _F, _F, _F, _F, _F, _F, _I, _P]),
}

_lock = threading.Lock()
_loaded: Dict[str, object] = {}


def _nvcc() -> str:
    found = os.environ.get("NVCC") or shutil.which("nvcc")
    if found:
        return found
    toolkit = Path(os.environ.get("CUDA_HOME", "/usr/local/cuda")) / "bin" / "nvcc"
    if toolkit.exists():
        return str(toolkit)
    raise RuntimeError("nvcc not found: set NVCC or CUDA_HOME, or put nvcc on PATH")


def _library_path(name: str) -> Path:
    h = hashlib.sha256()
    for src in sorted(CSRC.glob("*.cuh")) + [CSRC / f"{name}.cu"]:
        h.update(src.name.encode())
        h.update(src.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"lib{name}-{h.hexdigest()[:16]}.so"


def _start(name: str):
    """Starts nvcc for one kernel unless its library exists; returns
    (process or None, temporary output, final path)."""
    lib = _library_path(name)
    if lib.exists():
        return None, None, lib
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
    os.close(fd)
    cmd = [_nvcc(), *NVCC_FLAGS, "-o", tmp, str(CSRC / f"{name}.cu")]
    proc = subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    return proc, tmp, lib


def _finish(name: str, proc, tmp, lib: Path) -> Path:
    if proc is None:
        return lib
    out, _ = proc.communicate()
    if proc.returncode != 0:
        os.unlink(tmp)
        raise RuntimeError(f"nvcc failed for {name} (exit {proc.returncode}):\n{out}")
    os.replace(tmp, lib)
    return lib


def build_all(names: Iterable[str] = KERNELS) -> Dict[str, Path]:
    """Compiles every named kernel, one nvcc each, all started together;
    waits for every nvcc before raising the failures."""
    started = [(n, *_start(n)) for n in names]
    libs, errors = {}, []
    for n, proc, tmp, lib in started:
        try:
            libs[n] = _finish(n, proc, tmp, lib)
        except RuntimeError as e:
            errors.append(str(e))
    if errors:
        raise RuntimeError("\n".join(errors))
    return libs


def build(name: str) -> Path:
    return build_all([name])[name]


def load(name: str):
    """The ctypes entry point of kernel ``name``, built on first use."""
    with _lock:
        fn = _loaded.get(name)
        if fn is None:
            symbol, argtypes = _SIGNATURES[name]
            fn = getattr(ctypes.CDLL(str(build(name))), symbol)
            fn.argtypes = argtypes
            fn.restype = ctypes.c_int
            _loaded[name] = fn
        return fn


def call(name: str, device: torch.device, *args) -> int:
    """Calls kernel ``name``'s entry point with ``args``, then the index of
    the card ``device`` names (the current card for a bare ``cuda``) and
    that card's current stream. The entry point makes the card current
    (``cudaSetDevice``); the caller's current card is restored after.
    Returns the entry point's ``cudaError_t``."""
    index = torch.cuda.current_device() if device.index is None else device.index
    with torch.cuda.device(index):
        return load(name)(*args, index, torch.cuda.current_stream(index).cuda_stream)
