"""tpualign_torch stands alone: importing every module of it loads no JAX,
Flax or tpualign module, and its entry points run on CUDA unless the caller
asks for the CPU."""

import subprocess
import sys
import textwrap

import numpy as np
import pytest
import torch

from tpualign_torch.config import ModelConfig
from tpualign_torch.ops.attention import fused_mha
from tpualign_torch.ops.sim_topk import masked_sim_topk
from tpualign_torch.parallel import EmbedEngine, RetrievalIndex

pytestmark = pytest.mark.fast


def test_imports_nothing_of_jax_or_tpualign():
    code = textwrap.dedent("""
        import importlib, pkgutil, sys
        import tpualign_torch
        names = [m.name for m in pkgutil.walk_packages(tpualign_torch.__path__,
                                                       "tpualign_torch.")]
        for name in names:
            importlib.import_module(name)
        bad = sorted(m for m in sys.modules
                     if m.split(".")[0] in ("jax", "jaxlib", "flax", "tpualign"))
        print(len(names), bad)
        sys.exit(1 if bad else 0)
    """)
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         timeout=120)
    assert out.returncode == 0, out.stdout + out.stderr
    assert int(out.stdout.split()[0]) >= 15  # every module was imported


def test_entry_points_need_cuda_unless_cpu_is_asked(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    emb = np.eye(4, dtype=np.float32)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        RetrievalIndex(emb, ["m"] * 4, [1] * 4)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        EmbedEngine(ModelConfig())
    index = RetrievalIndex(emb, ["m"] * 4, [1] * 4, device="cpu")
    assert index.search(emb[:1], ["m"], [1], k=2)[1].tolist() == [[0, 1]]


def test_cpu_tensors_take_the_plain_versions():
    before = (fused_mha.launches, masked_sim_topk.launches)
    fused_mha(torch.zeros(1, 3, 3 * 64), 1)
    masked_sim_topk(torch.zeros(2, 4), torch.zeros(2, dtype=torch.int32),
                    torch.zeros(5, 4), torch.zeros(5, dtype=torch.int32), 3)
    assert (fused_mha.launches, masked_sim_topk.launches) == before
    with pytest.raises(TypeError):
        masked_sim_topk(torch.zeros(2, 4, dtype=torch.float64), torch.zeros(2, dtype=torch.int32),
                        torch.zeros(5, 4), torch.zeros(5, dtype=torch.int32), 3)
