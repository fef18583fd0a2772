"""tpualign_torch stands alone: importing every module of it loads no JAX,
Flax or tpualign module, and its entry points (the IVF index's too) run on
CUDA unless the caller asks for the CPU."""

import subprocess
import sys
import textwrap

import numpy as np
import pytest
import torch

from tpualign_torch.config import ModelConfig
from tpualign_torch.ops.attention import fused_mha
from tpualign_torch.ops.ivf_topk import ivf_probe_topk
from tpualign_torch.ops.sim_topk import masked_sim_topk
from tpualign_torch.parallel import EmbedEngine, RetrievalIndex, build_index
from tpualign_torch.parallel.ivf import IVFIndex
from tpualign_torch.serving import RetrievalService

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
                     if m.split(".")[0] in ("jax", "jaxlib", "flax", "optax", "tpualign"))
        print(len(names), bad)
        print(" ".join(names))
        sys.exit(1 if bad else 0)
    """)
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         timeout=120)
    assert out.returncode == 0, out.stdout + out.stderr
    assert int(out.stdout.split()[0]) >= 15  # every module was imported
    imported = set(out.stdout.splitlines()[1].split())
    for name in ("data.backends", "data.captions", "data.chunking", "data.filtering",
                 "data.lexical", "data.ocr", "data.processor", "data.word", "models.loader",
                 "utils.checks", "pipeline", "cli", "ops.quant", "train.loss", "train.optim",
                 "train.step", "train.lora", "train.checkpoint", "train.trainer",
                 "utils.profiling", "utils.flops", "native.build", "native.bindings",
                 "parallel.hnsw", "weaksup.calibration", "parallel.mesh", "parallel.ring",
                 "utils.debugging", "parallel.sharding", "parallel.multihost"):
        assert f"tpualign_torch.{name}" in imported, name


def test_no_source_line_imports_jax_flax_optax_or_tpualign():
    """No ``import``/``from`` line of the package or ``chip_smoke.py``
    names JAX, Flax, optax or tpualign, lazy imports inside functions
    included."""
    import re
    from pathlib import Path

    root = Path(__file__).resolve().parent.parent
    pattern = re.compile(r"^\s*(import|from) (jax|flax|optax|tpualign)\b")
    files = sorted((root / "tpualign_torch").rglob("*.py")) + [root / "chip_smoke.py"]
    hits = [f"{f.relative_to(root)}:{i}" for f in files
            for i, line in enumerate(f.read_text(encoding="utf-8").splitlines(), 1)
            if pattern.match(line)]
    assert len(files) > 60 and not hits, hits


def test_multihost_imports_torch_distributed_and_nothing_of_jax():
    """``parallel/multihost.py`` imports torch and ``torch.distributed`` (and
    the port's own mesh) and nothing of JAX or tpualign; importing it joins
    no process group."""
    import ast
    from pathlib import Path

    import tpualign_torch.parallel.multihost as multihost

    tree = ast.parse(Path(multihost.__file__).read_text(encoding="utf-8"))
    roots = {(node.module if isinstance(node, ast.ImportFrom) else alias.name)
             for node in ast.walk(tree) if isinstance(node, (ast.Import, ast.ImportFrom))
             for alias in node.names}
    assert {"torch", "torch.distributed"} <= roots
    assert {r.split(".")[0] for r in roots} <= {"__future__", "os", "typing", "numpy", "torch",
                                                "tpualign_torch"}, roots
    code = textwrap.dedent("""
        import sys
        import torch.distributed as dist
        import tpualign_torch.parallel.multihost
        bad = sorted(m for m in sys.modules
                     if m.split(".")[0] in ("jax", "jaxlib", "flax", "optax", "tpualign"))
        print(bad)
        sys.exit(1 if bad or dist.is_initialized() else 0)
    """)
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         timeout=120)
    assert out.returncode == 0, out.stdout + out.stderr


def test_entry_points_need_cuda_unless_cpu_is_asked(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    emb = np.eye(4, dtype=np.float32)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        RetrievalIndex(emb, ["m"] * 4, [1] * 4)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        EmbedEngine(ModelConfig())
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        build_index(emb, ["m"] * 4, [1] * 4, precision="int8", refine=2)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        RetrievalService(emb, list("abcd"), ["m"] * 4, [1] * 4)
    from tpualign_torch.config import load_config
    from tpualign_torch.train.trainer import Trainer

    with pytest.raises(RuntimeError, match="CUDA is not available"):
        Trainer(load_config({"CLIP_MODEL": "ViT-B-32"}))
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


def test_ivf_entry_points_need_cuda_unless_cpu_is_asked(monkeypatch, tmp_path):
    emb = np.random.default_rng(0).normal(size=(64, 8)).astype(np.float32)
    emb /= np.linalg.norm(emb, axis=1, keepdims=True)
    cpu = IVFIndex(emb, n_lists=8, iters=2, device="cpu")
    cpu.save(tmp_path / "a.npz")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        IVFIndex(emb, n_lists=8)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        IVFIndex.load(tmp_path / "a.npz", emb)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        build_index(emb, ["m"] * 64, [1] * 64, index_type="ivf", ivf_cache=str(tmp_path / "a.npz"))
    assert cpu.search(emb[:2], k=1)[1].tolist() == [[0], [1]]


def test_ivf_cpu_tensors_take_the_plain_version():
    before = ivf_probe_topk.launches
    vals, idx = ivf_probe_topk(torch.zeros(2, 4), torch.zeros(2, dtype=torch.int32),
                               torch.zeros((2, 1), dtype=torch.int32),
                               torch.zeros(1, dtype=torch.int32), torch.ones(8, 4),
                               torch.zeros(8, dtype=torch.int32), 3, 4, 1)
    assert ivf_probe_topk.launches == before
    assert idx.tolist() == [[0, 1, 2]] * 2 and vals.dtype == torch.float32


def test_int8_dot_on_cpu_tensors_takes_the_plain_product():
    from tpualign_torch.ops.quant import int8_dot

    before = int8_dot.int_mm_calls
    out = int8_dot(torch.ones(2, 8), torch.ones(8, 8))
    assert int8_dot.int_mm_calls == before
    assert torch.equal(out, torch.full((2, 8), 8.0))


def test_native_modules_load_nothing_of_jax_or_tpualign():
    """Building and loading the native library, and an HNSW graph over it,
    load no JAX or tpualign module; the graph is host work, so it needs no
    CUDA card and ``device`` is accepted and unused."""
    code = textwrap.dedent("""
        import shutil, sys
        import numpy as np
        import torch
        torch.cuda.is_available = lambda: False
        import tpualign_torch.native.bindings as bindings
        import tpualign_torch.native.build as build
        from tpualign_torch.parallel import build_index
        ok = bindings.native_available()
        assert ok == (shutil.which("g++") is not None), ok
        if ok:
            assert bindings.lexical_counts(["oil filter"], ["filter", ""]).tolist() == [1]
            emb = np.eye(8, dtype=np.float32)
            index = build_index(emb, ["m"] * 8, [1] * 8, index_type="hnsw")
            assert index.search(emb[:1], ["m"], [1], k=2)[1].tolist() == [[0, 1]]
        bad = sorted(m for m in sys.modules
                     if m.split(".")[0] in ("jax", "jaxlib", "flax", "optax", "tpualign"))
        print(bad)
        sys.exit(1 if bad else 0)
    """)
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         timeout=300)
    assert out.returncode == 0, out.stdout + out.stderr


def _exports(mod) -> set:
    import types

    if hasattr(mod, "__all__"):
        return set(mod.__all__)
    return {n for n, v in vars(mod).items()
            if not n.startswith("_") and not isinstance(v, types.ModuleType)}


def test_package_exports_match_tpualign():
    """Every package ``__init__`` of tpualign has a twin in the port that
    exports each of its names (in ``__all__`` where the port's declares
    one), ``create_mesh``, ``default_mesh``, ``clip_param_specs`` and
    ``shard_params`` included."""
    import importlib
    import pkgutil

    import tpualign

    pairs = [(tpualign, importlib.import_module("tpualign_torch"))]
    for info in pkgutil.walk_packages(tpualign.__path__, "tpualign."):
        if info.ispkg:
            pairs.append((importlib.import_module(info.name), importlib.import_module(
                "tpualign_torch" + info.name[len("tpualign"):])))
    assert len(pairs) >= 13
    missing = {}
    for jax_pkg, port_pkg in pairs:
        port_names = _exports(port_pkg)
        lacking = sorted(n for n in _exports(jax_pkg)
                         if not hasattr(port_pkg, n) or n not in port_names)
        if lacking:
            missing[port_pkg.__name__] = lacking
    assert not missing, missing
    parallel = importlib.import_module("tpualign_torch.parallel")
    assert {"clip_param_specs", "shard_params"} <= set(parallel.__all__)
    import tpualign_torch.parallel as port_parallel

    assert {"create_mesh", "default_mesh"} <= set(port_parallel.__all__)
