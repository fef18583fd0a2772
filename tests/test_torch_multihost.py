"""The port's processes across hosts (``tpualign_torch.parallel.multihost``)
against tpualign's on the CPU.

``hybrid_device_order`` runs its four cases in both packages and
``hybrid_mesh`` lays out ``["cpu"] * 8`` as tpualign lays out its eight
virtual CPU devices. Three tests start two OS processes as
``tests/test_multihost.py`` starts them (a free port, ``COORDINATOR_ADDRESS``,
``NUM_PROCESSES`` and ``PROCESS_ID``), each with two CPU devices
(``hybrid_mesh(devices=["cpu"] * 2)``) and the gloo backend; the workers
import nothing of JAX or tpualign. They run a sum across the processes, the
exact sharded search (gather and streaming, fp32 and int8; both processes'
answers equal to tpualign's one-process sharded index on the same corpus,
indices identical, values within 1e-6) and one TP+DP train step on
``hybrid_mesh(model_parallel=2)`` (both processes report the same loss and
``grad_norm``, within ``tests/test_torch_train_mesh.py``'s bounds of
tpualign's (2, 2) sharded step on the same converted tree and batch: loss
rel 1e-4, ``grad_norm`` rel 1e-3, params within 1e-2 x lr where the
gradient is not negligible).
"""

import json
import os
import socket
import subprocess
import sys

import numpy as np
import pytest
import torch

from tests.test_models import TINY
from tests.test_torch_train import (  # noqa: F401  (jax_pair is a fixture)
    assert_params_close, configs, jax_pair)
from tests.test_torch_train_mesh import host
from tests.test_train import batch_for
from tpualign.parallel import ivf as jax_ivf
from tpualign.parallel import mesh as jax_mesh_mod
from tpualign.parallel import multihost as jax_multihost
from tpualign.parallel import retrieval as jax_retrieval
from tpualign_torch.models.convert import to_jax_layout
from tpualign_torch.parallel import multihost
from tpualign_torch.parallel.mesh import Mesh

pytestmark = pytest.mark.fast

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

# every worker: join the group, and prove it imported nothing of JAX
_PROLOGUE = r"""
import json, os, sys
import numpy as np
import torch
torch.set_num_threads(2)
from tpualign_torch.parallel.multihost import hybrid_mesh, initialize_distributed, process_sum
import torch.distributed as dist

assert initialize_distributed() is True
pid = dist.get_rank()
assert dist.get_world_size() == 2 and dist.get_backend() == "gloo"
out = sys.argv[1]
"""

_EPILOGUE = r"""
jaxy = [m for m in sys.modules if m.split(".")[0] in ("jax", "jaxlib", "flax", "tpualign")]
assert not jaxy, jaxy
dist.destroy_process_group()
"""


def run_workers(body: str, out_dir, timeout: float = 180) -> list:
    """``body`` in two processes of one gloo group; returns each one's
    standard output (a failure shows its standard error). Each process is
    killed past ``timeout`` seconds."""
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    procs = []
    for pid in range(2):
        env = {k: v for k, v in os.environ.items() if k not in ("XLA_FLAGS", "JAX_PLATFORMS")}
        env.update(COORDINATOR_ADDRESS=f"127.0.0.1:{port}", NUM_PROCESSES="2",
                   PROCESS_ID=str(pid), PYTHONPATH=REPO, OMP_NUM_THREADS="2",
                   CUDA_VISIBLE_DEVICES="")  # gloo on any host, a card or none
        procs.append(subprocess.Popen(
            [sys.executable, "-c", _PROLOGUE + body + _EPILOGUE, str(out_dir)], cwd=REPO,
            env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True))
    outs = []
    try:
        for p in procs:
            outs.append(p.communicate(timeout=timeout))
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
    for p, (out, err) in zip(procs, outs):
        assert p.returncode == 0, f"worker failed:\n{out}\n{err[-3000:]}"
    return [out for out, _ in outs]


# -- the layout rule, in one process --------------------------------------------------


@pytest.mark.parametrize("slice_ids,model", [
    ([0, 1, 0, 1, 0, 1, 0, 1], 2),   # two slices, interleaved
    ([0, 0, 0, 1], 2),               # a TP group would straddle
    ([0, 0, 0], 2),                  # indivisible
    ([0] * 8, 2),                    # one slice
])
def test_hybrid_device_order_matches_tpualign(slice_ids, model):
    """tests/test_multihost.py:192-233: the same grids and the same errors."""
    try:
        want = jax_multihost.hybrid_device_order(slice_ids, model)
    except ValueError as e:
        with pytest.raises(ValueError, match=str(e).split(" — ")[0]):
            multihost.hybrid_device_order(slice_ids, model)
        return
    got = multihost.hybrid_device_order(slice_ids, model)
    np.testing.assert_array_equal(got, want)
    if len(set(slice_ids)) > 1:
        assert all(len({slice_ids[i] for i in row}) == 1 for row in got)


def test_hybrid_mesh_on_cpu_devices():
    """tests/test_multihost.py:227: without a process group the mesh is this
    process's devices, contiguous model groups, as tpualign's over its eight
    virtual CPU devices; no collective is called."""
    import jax

    mesh = multihost.hybrid_mesh(model_parallel=2, devices=["cpu"] * 8)
    want = jax_multihost.hybrid_mesh(model_parallel=2)
    assert isinstance(mesh, Mesh) and mesh.shape == dict(want.shape)
    assert mesh.shape == {"data": len(jax.devices()) // 2, "model": 2}
    assert not mesh.distributed and mesh.local_rows == [0, 1, 2, 3]
    assert mesh.home == torch.device("cpu")
    assert multihost.initialize_distributed() is False  # no COORDINATOR_ADDRESS


# -- two processes -------------------------------------------------------------------


def test_two_process_distributed_psum(tmp_path):
    """tests/test_multihost.py:63: a (2, 2) mesh over two processes; every
    position adds its process's id + 1, summed across them: 6.0."""
    outs = run_workers(r"""
mesh = hybrid_mesh(model_parallel=2, devices=["cpu"] * 2)
assert mesh.shape == {"data": 2, "model": 2} and mesh.distributed
assert mesh.processes == [0, 1] and mesh.local_rows == [pid]
local = torch.tensor(float(sum(pid + 1 for _ in mesh.row(pid))))
total = float(process_sum(mesh, [local])[0])
assert total == 6.0, total
print(f"worker {pid} psum ok: {total}")
""", tmp_path)
    for pid, out in enumerate(outs):
        assert f"worker {pid} psum ok: 6.0" in out


def _corpus(seed=0, n=203, d=16):
    """tests/test_multihost.py:281's corpus, with duplicated rows (exact
    ties across shards and processes)."""
    rng = np.random.default_rng(seed)
    c = rng.normal(size=(n, d)).astype(np.float32)
    c[-6:] = c[:6]
    c /= np.linalg.norm(c, axis=1, keepdims=True)
    man = [f"m{i % 2}" for i in range(n)]
    page = [1 + i % 3 for i in range(n)]
    return c, man, page


def test_two_process_sharded_retrieval(tmp_path):
    """tests/test_multihost.py:281: the exact index sharded over a (4, 1)
    data axis that spans the two processes (each holds two shards), gather
    and streaming at fp32 and int8, keyed and wildcard, and the sharded IVF
    index (each process builds and searches its own shards), probed and at
    full probe: both processes' answers equal tpualign's one-process
    sharded indexes."""
    c, man, page = _corpus()
    np.savez(tmp_path / "corpus.npz", c=c)
    (tmp_path / "keys.json").write_text(json.dumps({"man": man, "page": page}))
    run_workers(r"""
from tpualign_torch.parallel.retrieval import RetrievalIndex

mesh = hybrid_mesh(model_parallel=1, devices=["cpu"] * 2)
assert mesh.shape == {"data": 4, "model": 1} and mesh.local_rows == [2 * pid, 2 * pid + 1]
c = np.load(os.path.join(out, "corpus.npz"))["c"]
keys = json.load(open(os.path.join(out, "keys.json")))
man, page = keys["man"], keys["page"]
got = {}
for prec in ("fp32", "int8"):
    index = RetrievalIndex(c, man, page, mesh=mesh, precision=prec)
    held = [p is not None for p in index._corpus.parts]
    assert held == [s in mesh.local_rows for s in range(4)], held
    for strat in ("gather", "streaming"):
        for k in (4, 10):
            v, i = index.search(c[:24], man[:24], page[:24], k=k, strategy=strat)
            assert (i[:, 0] == np.arange(24)).all() or k == 4
            got[f"{prec}-{strat}-{k}-keyed"] = (v, i)
            got[f"{prec}-{strat}-{k}-global"] = index.search(c[:24], k=k, strategy=strat,
                                                             global_search=True)
from tpualign_torch.parallel.ivf import IVFIndex

ivf = IVFIndex(c, man, page, n_lists=16, iters=3, mesh=mesh, use_kernel=True)
assert [p is not None for p in ivf._emb.parts] == [s in mesh.local_rows for s in range(4)]
for p in (1, ivf.n_lists_local):
    got[f"ivf-{p}-keyed"] = ivf.search(c[:24], man[:24], page[:24], k=6, n_probes=p)
    got[f"ivf-{p}-global"] = ivf.search(c[:24], k=6, n_probes=p, global_search=True)
np.savez(os.path.join(out, f"retrieval-{pid}.npz"),
         **{f"{name}-{part}": arr for name, pair in got.items()
            for part, arr in zip(("v", "i"), pair)})
print(f"worker {pid} retrieval ok")
""", tmp_path)
    mesh = jax_mesh_mod.create_mesh(4, 1)
    for prec in ("fp32", "int8"):
        want = jax_retrieval.RetrievalIndex(c, man, page, mesh=mesh, precision=prec)
        for pid in range(2):
            got = np.load(tmp_path / f"retrieval-{pid}.npz")
            for strat in ("gather", "streaming"):
                for k in (4, 10):
                    for what, kw in (("keyed", dict(query_manuals=man[:24],
                                                    query_pages=page[:24])),
                                     ("global", dict(global_search=True))):
                        jv, ji = want.search(c[:24], k=k, strategy="gather", **kw)
                        name = f"{prec}-{strat}-{k}-{what}"
                        np.testing.assert_array_equal(got[f"{name}-i"], ji, err_msg=name)
                        has = ji >= 0
                        np.testing.assert_allclose(got[f"{name}-v"][has], jv[has], rtol=0,
                                                   atol=1e-6, err_msg=name)
    # the sharded IVF index: each process builds and searches its shards
    ivf = jax_ivf.IVFIndex(c, man, page, n_lists=16, iters=3, mesh=mesh, use_kernel=True)
    for pid in range(2):
        got = np.load(tmp_path / f"retrieval-{pid}.npz")
        for p in (1, ivf.n_lists_local):
            for what, kw in (("keyed", dict(query_manuals=man[:24], query_pages=page[:24])),
                             ("global", dict(global_search=True))):
                jv, ji = ivf.search(c[:24], k=6, n_probes=p, **kw)
                name = f"ivf-{p}-{what}"
                np.testing.assert_array_equal(got[f"{name}-i"], ji, err_msg=name)
                np.testing.assert_allclose(got[f"{name}-v"], jv, rtol=0, atol=1e-6,
                                           err_msg=name)


def test_two_process_sharded_train_step(jax_pair, tmp_path):
    """tests/test_multihost.py:159: one TP+DP step on hybrid_mesh(2) over two
    processes (data across them, model inside each): the processes agree on
    loss and grad_norm, which lie within bounds of tpualign's (2, 2) sharded
    step on the same tree and batch, and so do the updated params (the
    elements compared are those the port's one-device gradient does not
    find negligible)."""
    import jax.numpy as jnp

    from tests.test_torch_train import torch_grads, torch_model
    from tpualign.train import step as jax_step
    from tpualign_torch.train import step as torch_step

    jax_model, tree = jax_pair
    images, tokens, weak = batch_for(TINY, 8, np.random.default_rng(1))
    jcfg, tcfg = configs()
    jrun, jshard = jax_step.make_sharded_train_step(jax_model, jax_mesh_mod.create_mesh(2, 2),
                                                    jcfg)
    js, jm = jrun(jshard(jax_step.create_train_state(jax_model, tree, jcfg)), images, tokens,
                  weak, None, None)
    tmodel = torch_model(tree)
    params = torch_step.model_params(tmodel)
    grads = torch_grads(tmodel, torch_step.create_train_state(tmodel, params, tcfg),
                        torch.from_numpy(images), torch.from_numpy(tokens).long(),
                        torch.from_numpy(weak), tcfg)
    torch.save(params, tmp_path / "params.pt")
    torch.save({"images": images, "tokens": tokens, "weak": weak}, tmp_path / "batch.pt")
    variant = json.dumps({f: getattr(TINY, f) for f in TINY.__dataclass_fields__})
    outs = run_workers(r"""
from tpualign_torch.config import ClipVariant, TrainConfig
from tpualign_torch.models.clip import CLIP
from tpualign_torch.train.step import create_train_state, make_sharded_train_step

mesh = hybrid_mesh(model_parallel=2, devices=["cpu"] * 2)
assert mesh.shape == {"data": 2, "model": 2} and mesh.local_rows == [pid]
variant = ClipVariant(**json.loads(%r))
model = CLIP(variant, True, torch.float32, False, "none").requires_grad_(False)
params = torch.load(os.path.join(out, "params.pt"))
batch = torch.load(os.path.join(out, "batch.pt"), weights_only=False)
config = TrainConfig(learning_rate=1e-3, warmup_steps=0, total_steps=100)
step_fn, shard_state = make_sharded_train_step(model, mesh, config)
state = shard_state(create_train_state(model, params, config))
state, metrics = step_fn(state, batch["images"], batch["tokens"], batch["weak"])
loss, gn = float(metrics["loss"]), float(metrics["grad_norm"])
assert np.isfinite(loss) and np.isfinite(gn) and state.step == 1
torch.save({k: v.full() for k, v in state.params.items()}, os.path.join(out, f"params-{pid}.pt"))
print(f"worker {pid} train ok: loss={loss!r} grad_norm={gn!r}")
""" % variant, tmp_path)
    reported = [(float(o.split("loss=")[1].split()[0]), float(o.split("grad_norm=")[1].split()[0]))
                for o in outs]
    assert reported[0] == reported[1]  # both processes agree
    np.testing.assert_allclose(reported[0][0], float(jm["loss"]), rtol=1e-4)
    np.testing.assert_allclose(reported[0][1], float(jm["grad_norm"]), rtol=1e-3)
    want = host(js.params)
    for pid in range(2):
        got = torch.load(tmp_path / f"params-{pid}.pt")
        assert_params_close(to_jax_layout(got), want, to_jax_layout(grads))
