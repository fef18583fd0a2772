"""What the port runs on a mesh across processes, against tpualign on the
CPU: the FSDP train step, ``Trainer(mesh=)`` with its checkpoints, the
exact index's mutations and the ring; and the refusals tpualign shares.

Each multi-process test starts two OS processes as
``tests/test_torch_multihost.py`` does (gloo, two CPU devices each,
``PYTHONPATH`` at the repository, ``CUDA_VISIBLE_DEVICES=""``, no JAX in
the workers), once for every case of the file (the ``workers`` module
fixture), and compares what they wrote with tpualign's one-process mesh of
the same shape on its virtual CPU devices:

- (a) FSDP steps on ``hybrid_mesh(2)`` ((2, 2): data across the
  processes, model inside each) against tpualign's one-process (2, 2)
  ``make_sharded_train_step(fsdp=True)`` on the same converted tree and
  batch, and with accumulation and EMA, LoRA, distillation and
  ``CLIP_REMAT`` against the port's one-process (2, 2) mesh (which
  ``tests/test_torch_train_mesh.py`` holds to tpualign): loss rel 1e-4,
  ``grad_norm`` rel 1e-3, params within 1e-2 x lr where |g| >= 1e-3 x the
  leaf's max (that file's bounds); each process holds only its own rows'
  parts;
- (b) ``Trainer(mesh=hybrid_mesh(2))``, 3 steps with ``TRAIN_FSDP=1``,
  ``GRAD_ACCUM_STEPS=2`` and ``EMA_DECAY=0.5`` over
  ``tests/test_trainer.py``'s store, against tpualign's one-process
  ``Trainer(mesh=)`` of the same shape (the same bounds; held-out metrics
  equal), both processes reporting the same; and with random resized
  crops on the device feed, the same crops and losses as the port's
  one-process (2, 2) Trainer;
- (c) its checkpoint, written by process 0, loads in one process equal to
  the port's one-process run's, and a resume across processes continues
  from it as a one-process resume does;
- (d) the exact index over ``hybrid_mesh(1)`` ((4, 1), two shards a
  process) at fp32, int8 and int8 with refine 4 (its host refine corpus
  growing and compacting alike) through an add past the capacity, an add into
  the slack, a remove of a quarter and a compact: after each, every search
  (gather and streaming, keyed and wildcard) equal to tpualign's
  one-process sharded index after the same mutations (indices identical,
  values within 1e-6), and the same tombstone counts and compact
  permutation;
- (e) the fp32 ring across the processes, equal to gather and to
  tpualign's one-process ring (bit-equal on the card, where K2 sums each
  product in one order whatever the query block; the CPU's plain product
  may round by the block's rows).
"""

import dataclasses
import json
import os
import shutil

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from PIL import Image

import tpualign.config as jax_config
import tpualign_torch.config as torch_config
from tests.test_distill import _teacher_embs
from tests.test_models import TINY
from tests.test_torch_lora import ALPHA, RANK, jax_adapters
from tests.test_torch_multihost import _corpus, run_workers
from tests.test_torch_train import (  # noqa: F401  (jax_pair is a fixture)
    assert_params_close, configs, flat, jax_pair, torch_grads, torch_model)
from tests.test_torch_trainer import TRAIN_KEYS, overrides
from tests.test_torch_train_mesh import host
from tests.test_train import batch_for
from tpualign.parallel import mesh as jax_mesh
from tpualign.parallel import retrieval as jax_retrieval
from tpualign.store import EmbeddingStore as JaxStore
from tpualign.train import step as jax_step
from tpualign.train import trainer as jax_trainer
from tpualign_torch.models.convert import lora_from_jax, to_jax_layout
from tpualign_torch.parallel import create_mesh
from tpualign_torch.parallel.mesh import Mesh
from tpualign_torch.store import EmbeddingStore
from tpualign_torch.train import checkpoint as ckpt
from tpualign_torch.train import step as torch_step
from tpualign_torch.train import trainer as torch_trainer

pytestmark = pytest.mark.fast

KERNEL = "visual.transformer.resblocks.0.attn.in_proj_kernel"
VARIANT = json.dumps(dataclasses.asdict(TINY))

# the FSDP step's cases: TrainConfig keys beside fsdp=True; "distill" steps
# with a teacher bank, "remat" checkpoints the towers' blocks
STEP_CASES = {
    "fsdp": {},
    "fsdp_accum_ema": {"grad_accum_steps": 2, "ema_decay": 0.5},
    "fsdp_lora": {"lora_rank": RANK, "lora_alpha": ALPHA, "total_steps": 10},
    "fsdp_distill": {"distill_weight": 0.5},
    "fsdp_remat": {},
}


def _pair_of(cfg: dict) -> tuple:
    return configs(fsdp=True, **cfg)


# -- the workers: one start for every multi-process case ----------------------------

_STEPS = r"""
import dataclasses
from tpualign_torch.config import ClipVariant, TrainConfig
from tpualign_torch.models.clip import CLIP
from tpualign_torch.parallel.sharding import gather_full
from tpualign_torch.train.step import create_train_state, make_sharded_train_step

mesh = hybrid_mesh(model_parallel=2, devices=["cpu"] * 2)
assert mesh.shape == {"data": 2, "model": 2} and mesh.local_rows == [pid]
variant = ClipVariant(**json.loads(%r))
inputs = torch.load(os.path.join(out, "steps.pt"), weights_only=False)
batch = (inputs["images"], inputs["tokens"], inputs["weak"])
results = {}
for name, case in inputs["cases"].items():
    model = CLIP(variant, True, torch.float32, False, "none", remat=name.endswith("remat"))
    config = dataclasses.replace(TrainConfig(learning_rate=1e-3, warmup_steps=0,
                                             total_steps=100, fsdp=True), **case)
    step_fn, shard_state = make_sharded_train_step(model.requires_grad_(False), mesh, config)
    state = create_train_state(model, inputs["params"], config)
    if config.lora_rank:
        state.params = inputs["adapters"]
        state.opt_state = state.tx.init(state.params)
    state = shard_state(state)
    split = state.frozen_params if config.lora_rank else state.params
    st = split["visual.transformer.resblocks.0.mlp.c_fc_kernel"]
    assert st.spec == ("data", "model"), st.spec
    for i in range(2):
        held = [p is not None for p in st.parts[i]]
        assert held == [i == pid] * 2, (name, i, held)
    assert tuple(st.parts[pid][0].shape) == (32, 128), st.parts[pid][0].shape
    teacher = inputs["teacher"] if name.endswith("distill") else None
    losses, norms = [], []
    for step in range(2):
        state, metrics = step_fn(state, *batch, None, teacher)
        losses.append(float(metrics["loss"]))
        norms.append(float(metrics["grad_norm"]))
        if step == 0:
            params = {k: v.detach().clone() for k, v in gather_full(state.params).items()}
    results[name] = {"loss": losses, "grad_norm": norms, "params": params}
torch.save(results, os.path.join(out, f"steps-{pid}.pt"))
print(f"worker {pid} steps ok")
""" % VARIANT

_TRAINER = r"""
import shutil
import tpualign_torch.config as config_mod
from tpualign_torch.store import EmbeddingStore
from tpualign_torch.train.trainer import Trainer

tout = os.path.join(out, "trainer")
inputs = torch.load(os.path.join(tout, "inputs.pt"), weights_only=False)
for key in inputs["keys"]:
    os.environ.pop(key, None)
config_mod.CLIP_VARIANTS["tiny"] = config_mod.ClipVariant(**json.loads(%r))
mesh = hybrid_mesh(model_parallel=2, devices=["cpu"] * 2)
config = config_mod.load_config(inputs["overrides"])
assert config.train.fsdp and config.train.grad_accum_steps == 2
ck = os.path.join(tout, "ck")
store = EmbeddingStore(config.store.root, embed_dim=16)
reported = {}
trainer = Trainer(config, store=store, mesh=mesh, params=inputs["tree"])
assert trainer.state.params["visual.transformer.resblocks.0.mlp.c_fc_kernel"].parts[1 - pid][0] is None
reported["first"] = trainer.train(steps=3, ckpt_dir=ck,
                                  metrics_file=os.path.join(tout, f"metrics-first-{pid}.jsonl"),
                                  **inputs["run"])
if pid == 0:
    shutil.copytree(os.path.join(ck, "3"), os.path.join(tout, "ck_at3", "3"))
dist.barrier()
resumed = Trainer(config, store=store, mesh=mesh, params=inputs["tree"])
reported["resumed"] = resumed.train(steps=5, ckpt_dir=ck,
                                    metrics_file=os.path.join(tout, f"metrics-resumed-{pid}.jsonl"),
                                    **inputs["run"])
assert resumed.state.step == 5
# random resized crops: every row's size (the other process's rows' as
# that process decoded them) goes into the crops' sampling, recorded here
import numpy as np
import tpualign_torch.train.trainer as trainer_mod
sampled, sample = [], trainer_mod.sample_crop_boxes
def recording(rng, hw):
    boxes, flips = sample(rng, hw)
    sampled.append((np.array(hw), boxes.copy(), flips.copy()))
    return boxes, flips
trainer_mod.sample_crop_boxes = recording
rrc_config = config_mod.load_config(inputs["rrc_overrides"])
rrc = Trainer(rrc_config, store=EmbeddingStore(rrc_config.store.root, embed_dim=16), mesh=mesh,
              params=inputs["tree"])
reported["rrc"] = rrc.train(steps=3, metrics_file=os.path.join(tout, f"metrics-rrc-{pid}.jsonl"),
                            **inputs["rrc_run"])
torch.save(sampled, os.path.join(tout, f"rrc-crops-{pid}.pt"))
for run in reported.values():
    run.pop("wall_seconds")
print("REPORTED " + json.dumps(reported))
""" % VARIANT

_INDEX = r"""
from tpualign_torch.parallel.retrieval import RetrievalIndex

mesh = hybrid_mesh(model_parallel=1, devices=["cpu"] * 2)
assert mesh.shape == {"data": 4, "model": 1} and mesh.local_rows == [2 * pid, 2 * pid + 1]
s = torch.load(os.path.join(out, "index.pt"), weights_only=False)
got = {}

def searches(index, tag):
    for strat in ("gather", "streaming"):
        for k in s["k"]:
            got[f"{tag}-{strat}-{k}-keyed"] = index.search(s["q"], s["qman"], s["qpage"], k=k,
                                                           strategy=strat)
            got[f"{tag}-{strat}-{k}-global"] = index.search(s["q"], k=k, strategy=strat,
                                                            global_search=True)

for prec, (precision, refine) in s["indexes"].items():
    index = RetrievalIndex(s["rows"], s["man"], s["page"], mesh=mesh, precision=precision,
                           refine=refine)
    index.add(s["add"][:40], s["add_man"][:40], s["add_page"][:40])  # past the capacity
    grown = index._n_local
    index.add(s["add"][40:], s["add_man"][40:], s["add_page"][40:])  # into the slack
    assert index._n_local == grown and index.n == len(s["rows"]) + len(s["add"])
    assert [p is not None for p in index._corpus.parts] == [i // 2 == pid for i in range(4)]
    searches(index, f"{prec}-add")
    got[f"{prec}-counts"] = (np.array([index.remove(s["remove"]), index.dead,
                                       index.remove(s["remove"][:5])]),)
    searches(index, f"{prec}-remove")
    got[f"{prec}-perm"] = (index.compact(),)
    got[f"{prec}-dead"] = (np.array([index.dead, index.n, index._n_local]),)
    searches(index, f"{prec}-compact")
    for what, kw in (("keyed", (s["qman"], s["qpage"])), ("global", (None, None))):
        ring = index.search(s["q"], *kw, k=10, strategy="ring")
        gather = index.search(s["q"], *kw, k=10, strategy="gather")
        # the plain product's rounding may follow the query block's rows on
        # the CPU; K2's (one fmaf a depth step) does not
        assert np.array_equal(ring[1], gather[1]), (prec, what)
        assert np.abs(ring[0] - gather[0]).max() <= 1e-6, (prec, what)
        got[f"{prec}-ring-{what}"] = ring
np.savez(os.path.join(out, f"index-{pid}.npz"),
         **{f"{name}-{n}": arr for name, arrs in got.items() for n, arr in enumerate(arrs)})
print(f"worker {pid} index ok")
"""


def _plain_image(i):
    return Image.new("RGB", (40, 30), (i * 30 % 255, 50, 80))


def _noise_image(i):
    """Seeded noise, a size for each pair (the larger ones past a 64-pixel
    bucket): its crops differ wherever the boxes do."""
    rng = np.random.default_rng(100 + i)
    return Image.fromarray(rng.integers(0, 256, (30 + 9 * i, 40 + 13 * i, 3), np.uint8))


# the rrc store's image whose header reads but whose pixels do not decode
TRUNCATED = 5


def _truncate(path):
    """Keep the first half of an image file: its header still reads (a
    size), its pixels no longer decode."""
    data = path.read_bytes()
    path.write_bytes(data[:len(data) // 2])
    with Image.open(path) as im:
        assert im.size == (40 + 13 * TRUNCATED, 30 + 9 * TRUNCATED)
        with pytest.raises(OSError):
            im.convert("RGB")


def _store(root, pairs=6, image=_plain_image):
    """tests/test_trainer.py's store (six aligned pairs on one page), or
    ``pairs`` pairs with ``image(i)``'s images."""
    images_dir = root / "processed/images"
    images_dir.mkdir(parents=True)
    store = JaxStore(root / "store", embed_dim=16)
    store.setup(["clip_combined", "vanilla_clip"])
    rng = np.random.default_rng(0)
    img_rows, chunk_rows = [], []
    for i in range(pairs):
        fname = f"m_p1_img{i}.png"
        image(i).save(images_dir / fname)
        img_rows.append({"image_id": f"m_p1_img{i}", "manual_id": "m", "page": 1,
                         "bbox": [0, 0, 10, 10], "bbox_source": "native", "caption": None,
                         "filename": fname, "image_type": "raster_image"})
        chunk_rows.append({"chunk_id": f"m_p1_c{i}", "manual_id": "m", "page": 1,
                           "bbox": [0, 20, 30, 30], "text": f"instructie {i} voor de filter"})
    emb = rng.normal(size=(pairs, 16)).astype(np.float32)
    for schema in ("clip_combined", "vanilla_clip"):
        store.insert_images(schema, img_rows, emb)
        store.insert_chunks(schema, chunk_rows, emb)
    store.insert_alignments("clip_combined", [(f"m_p1_img{i}", f"m_p1_c{i}", 0.5 + 0.05 * i,
                                               "combined") for i in range(pairs)])
    store.save()
    return store, images_dir


TRAIN_RUN = dict(schema="clip_combined", batch_size=4, log_every=1, eval_every=3,
                 eval_fraction=0.34)
# the device feed with random resized crops over eight noise images
RRC_RUN = dict(schema="clip_combined", batch_size=4, log_every=1)
RRC_OVERRIDES = dict(TRAIN_FSDP=1, GRAD_ACCUM_STEPS=2, LEARNING_RATE=1e-4,
                     TRAIN_IMAGE_FEED="device", TRAIN_AUGMENT="rrc", IMAGE_PREPROCESS_BUCKET=64)

MUTATIONS = ("add", "remove", "compact")
INDEX_K = (4, 10)
# name: (precision, refine); the refine corpus (on the host of every
# process) grows and compacts with the index
INDEXES = {"fp32": ("fp32", 0), "int8": ("int8", 0), "int8_refine": ("int8", 4)}


def _mutation_inputs():
    """tests/test_torch_multihost.py's corpus (203 rows, ties across shards),
    rows to add (on a new manual and on stored pages), a quarter of the
    ids to remove, keyed queries (stored and added rows) and their keys."""
    c, man, page = _corpus()
    rng = np.random.default_rng(5)
    add = rng.normal(size=(48, c.shape[1])).astype(np.float32)
    add[:4] = c[10:14]  # ties with stored rows
    add /= np.linalg.norm(add, axis=1, keepdims=True)
    add_man = [f"m{i % 3}" for i in range(48)]  # m2 is new: the vocab grows
    add_page = [1 + i % 3 for i in range(48)]
    remove = np.sort(rng.choice(len(c) + len(add), (len(c) + len(add)) // 4, replace=False))
    q = np.concatenate([c[:12], add[:12]])
    return {"rows": c, "man": man, "page": page, "add": add, "add_man": add_man,
            "add_page": add_page, "remove": remove, "q": q,
            "qman": man[:12] + add_man[:12], "qpage": page[:12] + add_page[:12]}


@pytest.fixture(scope="module")
def workers(jax_pair, tmp_path_factory):
    """The inputs of every multi-process case written, then two workers
    started once: the index's mutations and ring, the FSDP step's cases,
    the Trainer and its resume. Returns the directory and the workers'
    standard outputs."""
    root = tmp_path_factory.mktemp("multihost_train")
    jax_model, tree = jax_pair
    images, tokens, weak = batch_for(TINY, 8, np.random.default_rng(1))
    teacher = tuple(np.array(t) for t in _teacher_embs(images, tokens))
    lora = jax_adapters(tree)
    tmodel = torch_model(tree)
    torch.save({"params": torch_step.model_params(tmodel),
                "adapters": lora_from_jax(tmodel, jax.tree.map(np.asarray, lora)),
                "images": images, "tokens": tokens, "weak": weak, "teacher": teacher,
                "cases": STEP_CASES, "lora": jax.tree.map(np.asarray, lora)}, root / "steps.pt")
    torch.save({**_mutation_inputs(), "k": INDEX_K, "indexes": INDEXES}, root / "index.pt")
    store, images_dir = _store(root / "trainer")
    ov = overrides(store, images_dir, TRAIN_FSDP=1, GRAD_ACCUM_STEPS=2, EMA_DECAY=0.5,
                   LEARNING_RATE=1e-4)
    rrc_store, rrc_images = _store(root / "rrc", pairs=8, image=_noise_image)
    _truncate(rrc_images / f"m_p1_img{TRUNCATED}.png")
    torch.save({"tree": host(tree), "overrides": ov, "run": TRAIN_RUN,
                "rrc_overrides": overrides(rrc_store, rrc_images, **RRC_OVERRIDES),
                "rrc_run": RRC_RUN, "keys": list(TRAIN_KEYS)}, root / "trainer" / "inputs.pt")
    outs = run_workers(_INDEX + _STEPS + _TRAINER, root, timeout=600)
    return root, outs


# -- (a) the FSDP step ---------------------------------------------------------------


@pytest.fixture(scope="module")
def step_runs(workers, jax_pair):
    """Per case of STEP_CASES the workers' losses, grad_norms and gathered
    params after the first step; the same from tpualign's one-process (2, 2)
    FSDP step (the plain case) and from the port's one-process (2, 2) mesh
    (every case)."""
    root, outs = workers
    assert all("steps ok" in o for o in outs)
    jax_model, tree = jax_pair
    inputs = torch.load(root / "steps.pt", weights_only=False)
    images, tokens, weak, teacher = (inputs[k] for k in ("images", "tokens", "weak", "teacher"))
    got = [torch.load(root / f"steps-{pid}.pt", weights_only=False) for pid in range(2)]
    # tpualign's one-process (2, 2) FSDP step, for the plain case
    jcfg, _ = _pair_of(STEP_CASES["fsdp"])
    jrun, jshard = jax_step.make_sharded_train_step(jax_model, jax_mesh.create_mesh(2, 2), jcfg)
    js = jshard(jax_step.create_train_state(jax_model, tree, jcfg))
    tpualign = {"loss": [], "grad_norm": []}
    for step in range(2):
        js, jm = jrun(js, images, tokens, weak, None, None)
        tpualign["loss"].append(float(jm["loss"]))
        tpualign["grad_norm"].append(float(jm["grad_norm"]))
        if step == 0:
            tpualign["params"] = host(js.params)
    # every case on the port's one-process (2, 2) mesh (itself held to
    # tpualign's by tests/test_torch_train_mesh.py), and the port's
    # one-device gradient of its first step, which picks the elements
    # compared
    from tpualign_torch.models.clip import CLIP

    tmodel = torch_model(tree)
    tv = torch_config.ClipVariant(**dataclasses.asdict(TINY))
    one, port = create_mesh(2, 2, devices=["cpu"] * 4), {}
    for name, case in STEP_CASES.items():
        _, tcfg = _pair_of(case)
        model = CLIP(tv, True, torch.float32, False, "none", remat=name.endswith("remat"))
        model.load_state_dict(tmodel.state_dict())
        model.requires_grad_(False)
        state = torch_step.create_train_state(model, torch_step.model_params(model), tcfg)
        if tcfg.lora_rank:
            state.params = lora_from_jax(model, inputs["lora"])
            state.opt_state = state.tx.init(state.params)
        t = teacher if name.endswith("distill") else None
        grads = torch_grads(model, state, torch.from_numpy(images),
                            torch.from_numpy(tokens).long(), torch.from_numpy(weak), tcfg, None,
                            None if t is None else tuple(torch.from_numpy(x) for x in t))
        run, shard_state = torch_step.make_sharded_train_step(model, one, tcfg)
        state = shard_state(state)
        row = {"loss": [], "grad_norm": [], "grads": to_jax_layout(grads)}
        for step in range(2):
            state, m = run(state, images, tokens, weak, None, t)
            row["loss"].append(float(m["loss"]))
            row["grad_norm"].append(float(m["grad_norm"]))
            if step == 0:
                row["params"] = to_jax_layout({k: v.full().clone()
                                               for k, v in state.params.items()})
        port[name] = row
    return got, tpualign, port


@pytest.mark.parametrize("case", list(STEP_CASES))
def test_fsdp_step_across_processes(step_runs, case):
    """Two steps of each case: both processes report the same loss and
    grad_norm, within rel 1e-4 / 1e-3 of the port's one-process (2, 2)
    step, and the params after the first step (gathered from both
    processes' slices) within 1e-2 x lr where the gradient is not
    negligible; the plain FSDP case also against tpualign's one-process
    (2, 2) ``make_sharded_train_step(fsdp=True)`` by the same bounds."""
    workers_, tpualign, port = step_runs
    got = [w[case] for w in workers_]
    assert got[0]["loss"] == got[1]["loss"] and got[0]["grad_norm"] == got[1]["grad_norm"]
    for want in [port[case]] + ([tpualign] if case == "fsdp" else []):
        np.testing.assert_allclose(got[0]["loss"], want["loss"], rtol=1e-4)
        np.testing.assert_allclose(got[0]["grad_norm"], want["grad_norm"], rtol=1e-3)
        for w in got:
            assert_params_close(to_jax_layout(w["params"]), want["params"],
                                port[case]["grads"])


# -- (b), (c) the Trainer and its checkpoints ------------------------------------------


def _rows(path) -> list:
    return [json.loads(x) for x in path.read_text().splitlines()]


@pytest.fixture(scope="module")
def trainer_runs(workers, jax_pair):
    """The workers' ``Trainer(mesh=hybrid_mesh(2))`` ran 3 steps into a
    checkpoint directory, then (process 0 keeping a copy of step 3) resumed
    to step 5; here tpualign's one-process ``Trainer(mesh=)`` of the same
    shape, the port's one-process (2, 2) Trainer over the same steps, and
    its resume from the copy of step 3."""
    root, outs = workers
    reported = [json.loads(o.split("REPORTED ")[1].splitlines()[0]) for o in outs]
    root = root / "trainer"
    _, tree = jax_pair
    inputs = torch.load(root / "inputs.pt", weights_only=False)
    ov = inputs["overrides"]
    with pytest.MonkeyPatch.context() as mp:
        mp.setitem(jax_config.CLIP_VARIANTS, "tiny", TINY)
        mp.setitem(torch_config.CLIP_VARIANTS, "tiny",
                   torch_config.ClipVariant(**dataclasses.asdict(TINY)))
        for key in TRAIN_KEYS:
            mp.delenv(key, raising=False)
        jt = jax_trainer.Trainer(jax_config.load_config(env_file=None, overrides=ov),
                                 store=JaxStore(root / "store", embed_dim=16),
                                 mesh=jax_mesh.create_mesh(2, 2),
                                 params=jax.tree.map(lambda x: jnp.array(x, copy=True), tree))
        jt.train(steps=3, metrics_file=str(root / "jax.jsonl"), **TRAIN_RUN)
        port_store = EmbeddingStore(root / "store", embed_dim=16)
        one = create_mesh(2, 2, devices=["cpu"] * 4)
        config = torch_config.load_config(ov)
        tt = torch_trainer.Trainer(config, store=port_store, params=host(tree), mesh=one)
        tt.train(steps=3, ckpt_dir=str(root / "ck_one"), metrics_file=str(root / "one.jsonl"),
                 **TRAIN_RUN)
        shutil.copytree(root / "ck_at3", root / "ck_resume")
        resumed = torch_trainer.Trainer(config, store=port_store, params=host(tree), mesh=one)
        resumed.train(steps=5, ckpt_dir=str(root / "ck_resume"),
                      metrics_file=str(root / "one-resumed.jsonl"), **TRAIN_RUN)
        sampled, sample = [], torch_trainer.sample_crop_boxes

        def recording(rng, hw):
            boxes, flips = sample(rng, hw)
            sampled.append((np.array(hw), boxes.copy(), flips.copy()))
            return boxes, flips

        mp.setattr(torch_trainer, "sample_crop_boxes", recording)
        rrc_config = torch_config.load_config(inputs["rrc_overrides"])
        rrc = torch_trainer.Trainer(rrc_config, params=host(tree), mesh=one,
                                    store=EmbeddingStore(rrc_config.store.root, embed_dim=16))
        rrc.train(steps=3, metrics_file=str(root / "rrc-one.jsonl"), **RRC_RUN)
        torch.save(sampled, root / "rrc-crops-one.pt")
    return root, reported


def test_trainer_across_processes_matches_tpualign(trainer_runs):
    """(b) Process 0 alone writes the metrics file; its per-step loss and
    grad_norm within rel 1e-4 / 1e-3 of tpualign's one-process
    ``Trainer(mesh=create_mesh(2, 2))`` with FSDP, accumulation and EMA, the
    held-out metrics equal; both processes report the same final metrics
    and held-out trajectory."""
    root, reported = trainer_runs
    assert not (root / "metrics-first-1.jsonl").exists()
    got, want = _rows(root / "metrics-first-0.jsonl"), _rows(root / "jax.jsonl")
    assert [r["kind"] for r in got] == [r["kind"] for r in want]
    for g, w in zip(got, want):
        assert g["step"] == w["step"]
        if g["kind"] == "train":
            np.testing.assert_allclose(g["loss"], w["loss"], rtol=1e-4)
            np.testing.assert_allclose(g["grad_norm"], w["grad_norm"], rtol=1e-3)
        elif g["kind"] == "heldout":
            assert g == w
    assert reported[0] == reported[1]
    assert [h["step"] for h in reported[0]["first"]["heldout"]] == [0, 3]


def test_trainer_rrc_across_processes_matches_one_process(trainer_runs):
    """(b) Random resized crops on the device feed over images of eight
    sizes (four shrunk into the 64-pixel bucket), one of them truncated (its
    header reads, its pixels do not decode, so the process that decodes its
    row keeps a full bucket, as one process does): each process decodes
    only its own rows' images, yet both sample every step's crops from the
    sizes of the process that decodes each row, so they draw the
    one-process (2, 2) Trainer's sizes, boxes and flips, and process 0's
    per-step loss and grad_norm are within rel 1e-4 / 1e-3 of its."""
    root, reported = trainer_runs
    want = torch.load(root / "rrc-crops-one.pt", weights_only=False)
    assert len(want) == 3 and {tuple(hw) for w in want for hw in w[0]} > {(30, 40)}
    assert any(max(hw) == 64 for w in want for hw in w[0])
    assert any(tuple(hw) == (64, 64) for w in want for hw in w[0])  # the truncated file
    for pid in range(2):
        got = torch.load(root / f"rrc-crops-{pid}.pt", weights_only=False)
        assert len(got) == len(want)
        for g, w in zip(got, want):
            for a, b in zip(g, w):
                np.testing.assert_array_equal(a, b)
    assert not (root / "metrics-rrc-1.jsonl").exists()
    got, want = _rows(root / "metrics-rrc-0.jsonl"), _rows(root / "rrc-one.jsonl")
    assert [(r["kind"], r["step"]) for r in got] == [(r["kind"], r["step"]) for r in want]
    assert [r["step"] for r in got if r["kind"] == "train"] == [1, 2, 3]
    for g, w in zip(got, want):
        if g["kind"] == "train":
            np.testing.assert_allclose(g["loss"], w["loss"], rtol=1e-4)
            np.testing.assert_allclose(g["grad_norm"], w["grad_norm"], rtol=1e-3)
    assert reported[0]["rrc"] == reported[1]["rrc"]


def test_checkpoint_across_processes_loads_in_one_process(trainer_runs):
    """(c) The checkpoint of step 3, written across processes, holds whole
    tensors as the one-process run's does (the FSDP slices gathered), and
    ``load_trained_params`` (the EMA) gives the one-process run's params
    within 1e-2 x lr."""
    root, _ = trainer_runs
    two = torch.load(root / "ck_at3" / "3" / "state.pt", weights_only=True)
    one = torch.load(root / "ck_one" / "3" / "state.pt", weights_only=True)
    assert two.keys() == one.keys() and two["step"] == one["step"] == 3
    for tree_name in ("params", "ema_params"):
        assert {k: tuple(v.shape) for k, v in two[tree_name].items()} == {
            k: tuple(v.shape) for k, v in one[tree_name].items()}
    assert tuple(two["params"][KERNEL].shape) == (64, 192)
    got = flat(ckpt.load_trained_params(root / "ck_at3"))
    want = flat(ckpt.load_trained_params(root / "ck_one"))
    assert got.keys() == want.keys()
    for k, v in want.items():
        np.testing.assert_allclose(got[k], v, rtol=0, atol=2e-6 + 1e-2 * 1e-4, err_msg=k)


def test_resume_across_processes_continues_the_checkpoint(trainer_runs):
    """(c) Both processes resume from step 3 and run steps 4-5: per-step
    loss and grad_norm within rel 1e-4 / 1e-3 of a one-process (2, 2)
    Trainer resumed from the same checkpoint, and the same final metrics
    on both processes."""
    root, reported = trainer_runs
    got, want = _rows(root / "metrics-resumed-0.jsonl"), _rows(root / "one-resumed.jsonl")
    assert [(r["kind"], r["step"]) for r in got] == [(r["kind"], r["step"]) for r in want]
    assert [r["step"] for r in got if r["kind"] == "train"] == [4, 5]
    for g, w in zip(got, want):
        if g["kind"] == "train":
            np.testing.assert_allclose(g["loss"], w["loss"], rtol=1e-4)
            np.testing.assert_allclose(g["grad_norm"], w["grad_norm"], rtol=1e-3)
    assert reported[0]["resumed"] == reported[1]["resumed"]
    assert sorted(os.listdir(root / "ck")) == ["3", "5"]


# -- (d), (e) the exact index's mutations and the ring -----------------------------------


@pytest.fixture(scope="module")
def index_runs(workers):
    """Each worker's answers, and tpualign's one-process sharded index
    (create_mesh(4, 1)) of each INDEXES entry through the same mutations,
    its searches after each, the counts, the compact permutation and the
    ring."""
    root, outs = workers
    assert all("index ok" in o for o in outs)
    spec = torch.load(root / "index.pt", weights_only=False)
    want = {}
    for prec, (precision, refine) in INDEXES.items():
        index = jax_retrieval.RetrievalIndex(spec["rows"], spec["man"], spec["page"],
                                             mesh=jax_mesh.create_mesh(4, 1),
                                             precision=precision, refine=refine)
        index.add(spec["add"][:40], spec["add_man"][:40], spec["add_page"][:40])
        index.add(spec["add"][40:], spec["add_man"][40:], spec["add_page"][40:])
        for upto in MUTATIONS:
            if upto == "remove":
                want[prec, "counts"] = [index.remove(spec["remove"]), index.dead,
                                        index.remove(spec["remove"][:5])]
            if upto == "compact":
                want[prec, "perm"] = index.compact()
                want[prec, "dead"] = [index.dead, index.n]
            for strat_k in INDEX_K:
                for what, kw in (("keyed", dict(query_manuals=spec["qman"],
                                                query_pages=spec["qpage"])),
                                 ("global", dict(global_search=True))):
                    want[prec, upto, strat_k, what] = index.search(spec["q"], k=strat_k,
                                                                   strategy="gather", **kw)
        for what, kw in (("keyed", dict(query_manuals=spec["qman"], query_pages=spec["qpage"])),
                         ("global", dict(global_search=True))):
            want[prec, "ring", what] = index.search(spec["q"], k=10, strategy="ring", **kw)
    return want, [np.load(root / f"index-{pid}.npz") for pid in range(2)]


def _same(got, name, jv, ji):
    np.testing.assert_array_equal(got[f"{name}-1"], ji, err_msg=name)
    has = ji >= 0
    np.testing.assert_allclose(got[f"{name}-0"][has], jv[has], rtol=0, atol=1e-6, err_msg=name)


@pytest.mark.parametrize("prec,upto", [(p, m) for p in INDEXES for m in MUTATIONS])
def test_index_mutations_across_processes_match_tpualign(index_runs, prec, upto):
    """(d) After each mutation both processes' searches (gather and
    streaming, keyed and wildcard, k=4 and 10) equal tpualign's one-process
    sharded index's gather after the same mutations (settled difference
    21), refined ones too; the tombstone counts and the compact permutation
    equal."""
    want, workers_ = index_runs
    for got in workers_:
        for strat in ("gather", "streaming"):
            for k in INDEX_K:
                for what in ("keyed", "global"):
                    _same(got, f"{prec}-{upto}-{strat}-{k}-{what}", *want[prec, upto, k, what])
        if upto != "add":
            assert got[f"{prec}-counts-0"].tolist() == want[prec, "counts"]
        if upto == "compact":
            np.testing.assert_array_equal(got[f"{prec}-perm-0"], want[prec, "perm"])
            assert got[f"{prec}-dead-0"].tolist()[:2] == want[prec, "dead"]


@pytest.mark.parametrize("what", ["keyed", "global"])
def test_ring_across_processes_matches_gather_and_tpualign(index_runs, what):
    """(e) The fp32 ring over the compacted index across the processes:
    equal to gather in each worker (indices identical, values within
    1e-6), and to tpualign's one-process ring; int8 routes to gather, as
    tpualign's does."""
    want, workers_ = index_runs
    for prec in ("fp32", "int8"):
        for got in workers_:
            _same(got, f"{prec}-ring-{what}", *want[prec, "ring", what])


# -- the refusals tpualign shares ------------------------------------------------------


def _ivf_on(mesh):
    """An IVF index sharded over four CPU devices in this process, then
    handed a mesh whose rows span two processes."""
    from tpualign_torch.parallel.ivf import IVFIndex

    c, man, page = _corpus()
    index = IVFIndex(c, man, page, n_lists=16, iters=2,
                     mesh=create_mesh(4, devices=["cpu"] * 4), use_kernel=True)
    index.mesh = mesh
    return index, c


def _refuse_engine(mesh, tmp_path):
    from tpualign_torch.parallel.embed import EmbedEngine

    EmbedEngine(torch_config.load_config({}).model, mesh=mesh)


def _refuse_evaluator(mesh, tmp_path):
    from tpualign_torch.evaluation.metrics import Evaluator

    Evaluator(None, output_dir=str(tmp_path), mesh=mesh)


def _refuse_pipeline(mesh, tmp_path):
    from tpualign_torch.pipeline import Pipeline

    Pipeline(torch_config.load_config({}), mesh=mesh)


def _refuse_ivf(method):
    def call(mesh, tmp_path):
        from tpualign_torch.parallel.ivf import IVFIndex

        index, c = _ivf_on(mesh)
        {"add": lambda: index.add(c[:4], ["m0"] * 4, [1] * 4),
         "remove": lambda: index.remove([0, 1]),
         "dead": lambda: index.dead,
         "compact": lambda: index.compact(),
         "calibrate": lambda: index.calibrate(0.9),
         "save": lambda: index.save(tmp_path / "ivf.npz"),
         "load": lambda: IVFIndex.load(tmp_path / "absent.npz", c, mesh=mesh, device="cpu"),
         }[method]()
    return call


REFUSALS = {"EmbedEngine": _refuse_engine, "Evaluator": _refuse_evaluator,
            "Pipeline": _refuse_pipeline,
            **{f"IVFIndex.{m}": _refuse_ivf(m)
               for m in ("add", "remove", "dead", "compact", "calibrate", "save", "load")}}


@pytest.mark.parametrize("what", list(REFUSALS))
def test_refusals_tpualign_shares(what, tmp_path):
    """On a mesh whose data rows name two processes (no process group
    needed: the guards come first), what tpualign cannot run across
    processes either raises ``NotImplementedError`` saying so (ROADMAP
    settled difference 24)."""
    grid = np.empty((4, 1), dtype=object)
    grid[:, 0] = [torch.device("cpu")] * 4
    mesh = Mesh(grid, processes=[0, 0, 1, 1], rank=0)
    assert mesh.distributed
    with pytest.raises(NotImplementedError, match="tpualign cannot run it across processes"):
        REFUSALS[what](mesh, tmp_path)
