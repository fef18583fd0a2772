"""Drives tpualign_torch on the card: embed and search, pipeline, training, serving, HNSW, mesh.

    python3 chip_smoke.py [--seed 0] [--mesh-only]

Run from the root of a checkout, on a machine with one CUDA card or more
(an H100 for the numbers in PERF.md; the mesh phase takes four distinct
cards where the host has four). ``--mesh-only`` runs 1., 8.-10., 16., 17.,
11. and 15. alone, with no kernels line: the four-card run; it skips the
checks that the one-card run makes (the stored embeddings against the
seeded engine, the serve phase's int4 and int2 rungs). Phases, one JSON
line each:

0. the card (``nvidia-smi`` name and power limit) and the torch/CUDA versions;
1. build: the five kernels compiled from ``tpualign_torch/csrc/``, in
   parallel, and the native host library (``tpualign_torch/native``, g++)
   beside them; on threads beside the build, the host work of 8.-10.:
   the checkpoint, the device_feed files and the pipeline's manuals, and
   (one card) h14_embed's seeded ViT-H-14 engine;
2. K1 ``fused_mha`` against its plain version at ViT-B-32's shapes (B=256:
   vision T=50 D=768 H=12 unmasked; text T=16/32/77 D=512 H=8 causal) and at
   ViT-H-14's vision (B=32, T=257, D=1280, H=16, hd 80) whole and as one
   card's part of a 4-way model axis (H=4), ViT-H-14's vision whole at
   B=256 (the h14_embed phase's shape), and ViT-B-32's vision and text
   T=77 as one card's part of a 2-way model axis (H=6 and 4, B=256), fp32
   (the CUDA-core kernel) and bf16 (the tensor-core kernel): eighteen rows,
   with times for the kernel, the plain version and
   ``F.scaled_dot_product_attention`` (a yardstick only; the port never
   calls it), the kernel's and the yardstick's over a CUDA graph of 64
   launches and with events around 20 launches (both printed);
3. K2 ``masked_sim_topk`` against its plain version at Q=1,024, N=100,000,
   D=512 (1,000 page keys, 1/8 wildcard queries, queries without
   candidates, 16 duplicated corpus rows), k=10 and k=100, with times for
   the kernel, the plain version and ``torch.matmul`` + ``torch.topk``,
   and the corpus tiles its key-aware skip reads;
4. the slice: ``EmbedEngine`` (ViT-B-32, seeded weights, bf16) embeds 2,048
   images and 8,192 chunk records, ``RetrievalIndex`` runs the Evaluator's
   keyed k=100 search and the ``query --text`` global k=10 search; the
   kernels' launch counters are read around this phase alone;
   fp32_towers: the same towers at COMPUTE_DTYPE=float32 (K1's fp32
   kernel in every attention) over 1,024 images and 4,096 texts, images/s,
   chunks/s and K1's launches, the embeddings against the plain attention
   within 1e-4;
   h14_embed: ``EmbedEngine`` with ViT-H-14 at its full widths and depth
   (vision 1280 / 32 layers / 16 heads / hd 80, T=257; text 1024 / 24 /
   16), seeded, bf16, B=256, over 512 seeded images and 512 chunk texts
   (the 16/32/77 buckets): images/s, chunks/s, peak memory, K1's launches
   by sequence length (all 64 of the image tower's at T=257), the
   embeddings finite and unit-norm, and 64 image and 64 text rows against
   the same towers on the plain attention within 2e-2;
   int8_towers: the same towers at ``CLIP_QUANT=int8`` (every projection
   through ``torch._int_mm``, every attention through K1) against the bf16
   towers over 1,024 images and 4,096 chunks (images/s, chunks/s, largest
   gap, smallest cosine), and one batch's first projection against the
   CPU ``int8_dot`` on its first 32 images' rows (the same codes, an ulp
   at most); then the int8 towers
   tensor parallel on card 0 twice as a (1, 2) mesh (each row-split
   product's maxima over the row's cards, its int32 partials summed on the
   first), images and chunks bit-equal to the one-card int8 engine, K1 once
   and ``_int_mm`` four times a part, block and forward, images/s and
   chunks/s beside one card's;
5. K3 ``masked_sim_topk_quant`` against its plain version at Q=1,024,
   N=1,000,000, D=512 (10,000 page keys, the mix of 3.), for int8 (s8),
   int8 (dequant), int4 and int2, k=10 and k=40, with times for the kernel,
   the plain version and ``torch._int_mm`` (or a dequantized matmul) +
   ``torch.topk``, and the corpus tiles its key-aware skip reads;
6. K4 ``ivf_probe_topk`` against its plain version: an ``IVFIndex`` built
   on the card over 1,000,000 seeded unit rows around 10,000 page topics
   (default geometry: 1,000 lists of capacity 1,536, 125 probes), each
   batch's own probes and union; s8 at Q=2/64/1,024 and k=10/40, fp32,
   dequant, int4 and int2 at Q=64, k=10; with times for the kernel, the
   plain version and a gather + ``torch._int_mm``/``matmul`` +
   ``torch.topk`` yardstick, the union size and the union tiles it reads;
7. K5 ``normalize_u8`` against its plain version, bit for bit, at one
   device-feed batch (B=256, 224x224x3 uint8 -> fp32), with times for the
   kernel and the plain version and its bound (no single PyTorch call
   computes it);
8. checkpoint: ViT-B-32's seeded tree (the weights the port draws without
   a checkpoint) written as an OpenCLIP-layout ``.pt`` file (a plain
   tensor dict, ``torch.load(weights_only=True)`` reads it), read back by
   the port's loader bit for bit (and as ``.safetensors`` where that
   package is installed); the pipeline, serve and serve_ivf phases load
   their towers from it;
9. device_feed: 1,536 seeded smooth PNG/JPEG files (96-1,200 px per side,
   about a third above the 256 bucket) through ``embed_image_records``
   with the host feed, then the device feed: images/s of each, K5's
   launches, the profile of one batch of each, and 64 images' pixels on
   the card against the port's CPU path;
10. pipeline: 256 ``*.synthdoc.json`` manuals x 8 pages (one raster image,
    a device_feed file's bytes, and eight word lines per page: 2,048
    images and 16,384 chunks) written by the port's
    ``write_synthetic_document``, through ``python -m tpualign_torch
    process``, ``filter``, ``setup-db``, ``embed`` (IMAGE_PREPROCESS=device,
    CLIP_CHECKPOINT) and ``evaluate`` as subprocesses, their kernel launch
    counters written at exit; stage 1's records against what the writer
    placed, the stored embeddings against ``EmbedEngine`` with the seeded
    tree and no checkpoint, bit for bit; metrics.json's four schemas,
    vanilla_clip's metrics against a float64 recount from the stored
    embeddings, and every schema's alignment records against the CPU
    ``compute_alignments``. The cartesian metrics cannot see the ranking
    (every same-page chunk is true), so K2 is held against its plain
    version at the Evaluator's own search (Q=2,048, N=16,384, 2,048 page
    keys, k=100), timed beside the plain version and the library yardstick
    (``torch.where(key_mask, q @ c.T, NEG_INF)`` + ``torch.topk``) with its
    bound and the corpus tiles it reads, and the weak-supervision schemas'
    ``gt="alignments"`` ranks, top-k and MRR, which move with the ranking,
    against a float64 recount over the stored alignments. Beside those five
    stages and checks: ``python -m tpualign_torch run --non-interactive``
    over 32 of the manuals into fresh directories, its metrics against its own recount, and the same
    command again, which must skip stages 1-4 and write the same metrics;
    beside it, over a copy of the first run's store: ``ingest`` once,
    ``serve`` as a subprocess, 16 new manuals and ``ingest --notify
    <daemon>``; the
    daemon's ``/stats`` must show the new chunks and images, and its
    answers must equal those of a service freshly built over the store;
11. serve: the port's store (1,000,000 chunks on 125,000 pages, 20,000
    images, 100,000 weak alignments) is written to a temporary directory and
    served by ``build_service`` + ``serve_schemas`` at int8 with refine 4 and
    the ViT-B-32 towers from the checkpoint (``/stats`` must report it);
    eight clients send 32 requests each over /search_text, /search_image
    (with and without rerank), /search_image_bytes, /stats and /healthz,
    and every answer is held against the plain path; then int4 and int2
    rebuilds, recall@10 of each rung against exact fp32, and ``python -m
    tpualign_torch query --image-id`` against the service (its process runs beside the
    rung builds, here and in 12.); K3 at the shapes serving gives it
    (the ``/search_image`` profile's two keyed image queries, and one
    wildcard text query, k=40) against its plain version and the library
    yardstick; the launch counters are read around the clients' run alone;
12. serve_ivf, over the same store: ``python -m tpualign_torch index``
    (RETRIEVAL_INDEX=ivf, int8, refine 4, recall target 0.95) as a
    subprocess, the same build and calibration timed in this process (the
    same structure), ``build_service`` loading the artifact, the clients of
    11. with every answer against the plain path (plain K4, exact rescore),
    recall@10 of int8/int4/int2 at the calibrated and default probe counts,
    and ``query --image-id`` through the artifact; the counters are read
    around the clients' run alone;
    live, over the same store: the int8 exact service and its IVF twin
    behind HTTP with SERVE_AUTO_COMPACT=0.2: /add of 12,000 rows by
    embeddings and 128 by text, /remove of 25 % in four requests (the
    last compacts automatically), /remove of 1 % and /compact, /sync of a
    snapshot with 4,096 new chunks and 1,024 gone; after each step the
    served answers against a fresh int8 index over the live rows (exact),
    the plain K4 version on the grown layout and a dense search at full
    probe (IVF); /search_image p50 and the tiles K3 and K4 read, before
    and after;
13. train, over the pipeline phase's store (``clip_combined``'s weak pairs,
    the towers from the checkpoint, ViT-B-32 bf16, B=256): K1 forward with
    the autograd backward (the plain path's recompute) against the plain
    version's autograd (vision T=50, text T=77 causal; fp32 and bf16: dqkv
    identical) and the recompute's time; ``matmul_f32acc``'s bf16 gradients
    against the widened fp32 product; one train step with K1 against the
    plain attention, and GRAD_ACCUM_STEPS=4 against the full batch (loss,
    grad_norm, every gradient leaf); one step with CLIP_REMAT (every block
    under torch.utils.checkpoint) against one without: both peaks, K1's
    launches (48 a step with the recompute, 24 without), loss and
    gradients within K1's step bounds; timed steps in this process with the
    device feed, then the host feed (step ms, the feed's wait, pairs/s,
    peak memory, the model-FLOP share); then ``python -m tpualign_torch
    train`` as processes side by side: 6 steps (device feed, held-out
    evaluation every 3), 3 with LORA_RANK=8 and 3 at CLIP_QUANT=int8_qat
    (those two at B=64),
    their K1, K1 backward and K5 counts; each checkpoint directory
    as CLIP_CHECKPOINT of ``embed`` (the int8_qat one at CLIP_QUANT=int8;
    the three processes side by side) over the run subset, the stored
    embeddings against the trainer's export params bit for bit;
14. hnsw, over the pipeline phase's store after ``train`` (which reads the
    weak scores ``calibrate --write`` rewrites): the native library
    (built by g++ in 1.) times the tokenizer with and without its BPE
    merge core (8,192 texts of the slice's generator, then 1,024 texts of
    unseen words; identical ids) and the lexical counts native and in
    Python over the store's 16,384 chunks and vocabulary; ``python -m
    tpualign_torch index`` with RETRIEVAL_INDEX=hnsw, a 0.95 recall target
    and HNSW_CACHE as a subprocess (build and calibration seconds, the ef
    and recall it reached, memory); ``build_service`` loading the artifact
    with the towers from the checkpoint, the clients of 11., every answer
    against a direct ``HNSWIndex.search_encoded`` call, keyed answers
    against the exact fp32 index (K2), every score against the unit rows'
    dot; /add of 4,096 rows by embeddings and 64 by text, /remove of 25 %
    and /compact, each step's keyed answers against an exact index over
    the live rows; the fp16 rung against fp32 over 4,096 rows (memory,
    recall@10, keyed answers against the fp16-rounded exact index); and
    ``calibrate --schema clip_combined``, a dry run through the CLI's
    ``main`` in this process, then ``--write`` as a subprocess (the pairs,
    the written scores against a float64 fit: equal after the float32
    cast, monotone, the fit's sum that of the pair cosines);
15. mesh, a 4-way data mesh of ``tpualign_torch.parallel.create_mesh``
    (four distinct cards where the host has them, else card 0 four times;
    it prints which): after hnsw, ``Evaluator(mesh=)`` on the pipeline
    store, its metrics.json against the one-device Evaluator's; after live,
    over the serve phase's store, the sharded exact index against the
    one-device index (int8 and int4 over 1,000,000 rows with gather and
    streaming, fp32 over 100,000 with gather, streaming and ring; 256
    keyed and 256 wildcard queries at k=10 and k=100: indices identical,
    values within 1e-6) and the search ms of each, /add of 4,096 rows, a
    remove of 25 % and compact against fresh indexes, the sharded IVF index
    (int8 over the 1,000,000 rows, 256 lists a shard: build and calibration
    to a 0.95 target; at full probe every answer against the sharded exact
    index over the int8 rows' dequantization, at the calibrated probes every
    answer against the per-shard plain K4 version merged alike, a save and
    load round trip, add, remove and compact against a fresh sharded build;
    recall@10 and ms a search at Q=2, k=40 beside a one-device index's),
    ``EmbedEngine(mesh=)``
    over the slice's images and chunks and one device-feed batch (images/s,
    chunks/s) within 1e-5 of the one-device engine, and
    the int8 engine (ViT-B-32, bf16) on a (2, 2) mesh over 256 images and
    256 texts, bit-equal to card 0's int8 engine at the batch of one data
    row, ``build_service(mesh=)`` behind HTTP, its /search_image and
    /search_text answers against the one-device service's; the kernels'
    counts around the mesh runs alone; each part's seconds. With four cards
    or more also: each
    card's idle share while the replicated and the one-device engines
    embed the slice's images (``torch.profiler``), ``python -m
    tpualign_torch serve`` as a process on card 0 and with ``--mesh-data
    4`` (the three daemons of this part started side by side, then each
    driven alone: start, p50 of each route alone, requests/s under the
    clients of 11., every serial answer equal), the same ``--mesh-data 4`` daemon under
    RETRIEVAL_INDEX=ivf (its /search_image and /search_text answers, serial
    and the clients', against the per-shard plain K4 version over the
    artifact it wrote, with the exact rescore), and, in the pipeline phase,
    ``embed
    --mesh-data 4`` over stage 1's records into a fresh store (seconds,
    images/s, every stored embedding within 1e-5 of the one-card store's);
16. mesh_train, after hnsw over the pipeline phase's store (a line a part):
    ViT-B-32 at full width, seeded, COMPUTE_DTYPE=float32, B=64: one step
    of ``make_sharded_train_step`` on each of (4, 1), (2, 2), (1, 4) and
    (4, 1) with TRAIN_FSDP against the one-card step on the same batch and
    params (loss within 1e-4, grad_norm within 1e-3 relative, params within
    1e-2 x lr where |g| >= 1e-3 x the leaf's max; FSDP against replicated
    within 1e-5 and 2e-6), each card's peak; then 2 bf16 steps of
    ``Trainer(mesh=)`` with TRAIN_FSDP on (2, 2) over the store with the
    device feed, after one warm-up (step ms, the feed's wait, every step's
    loss, every card's peak; K1 forward and recompute on every part of
    every block, K5 once a data row and step); one CLIP_QUANT=int8_qat
    fp32 step of ``Trainer(mesh=)`` on (1, 2) at B=64 against one card's
    Trainer on the same batch (loss within 1e-4, grad_norm within 1e-3
    relative). Four distinct cards where
    the host has them, else card 0 repeated; without ``--mesh-only`` also
    the (2, 2) Trainer without FSDP and a bf16 step's host time by part
    (forward, backward, update; one card and (2, 2)); with ``--mesh-only``
    on four cards also (4, 1) and (4, 1) FSDP Trainers in process with each card's
    idle share (``torch.profiler``, the feed included; the FSDP one over
    the pairs the multihost quad trains on), ``python -m tpualign_torch
    train`` as processes with ``--mesh-data 4`` and with ``TRAIN_FSDP=1
    --mesh-data 4`` (2 steps each: the loop's ms a step, pairs/s, each
    card's peak), and ViT-H-14 at its full widths, seeded (one fp32 step on
    (1, 4) and on (4, 1) FSDP against one card's at 4 blocks a tower, B=8;
    2 timed bf16 steps at full depth on (2, 2), B=64);
17. multihost, with four cards and ``--mesh-only`` only: processes across
    the cards (``tpualign_torch.parallel.multihost``, NCCL), each started
    with COORDINATOR_ADDRESS, NUM_PROCESSES, PROCESS_ID and its
    CUDA_VISIBLE_DEVICES: two processes of two cards (the sum across them;
    the exact index at int8 and fp32 over 100,000 seeded rows, sharded over
    hybrid_mesh(1), built, after 256 keyed rows added past its capacity,
    after a remove of a quarter and after a compact, gather and streaming,
    every answer, tombstone count and compact permutation equal to this
    process's one-process mesh on the same four cards, and the fp32 ring
    bit-equal to gather; one ViT-B-32 fp32 step on hybrid_mesh(2) at B=64
    against mesh_train's one-process (2, 2) step, the two processes' loss
    equal; ``Trainer(mesh=hybrid_mesh(2))`` with TRAIN_FSDP, 2 bf16 steps
    at B=256 with the device feed, its losses equal on both processes and
    within 1e-4 of mesh_train's in-process (2, 2) FSDP Trainer, its
    checkpoint read here bit-equal to process 0's export), then four
    processes of one card running ``Trainer(mesh=hybrid_mesh(1))`` with
    TRAIN_FSDP for 10 steps with held-out evaluation at the start and the
    end (losses equal across the processes and within 1e-4 of mesh_train's
    in-process (4, 1) FSDP Trainer, held-out metrics equal; step ms,
    pairs/s, the feed's share, each card's idle share and peak), and each
    process's K1, K2, K3 and K5 launches;
18. the timing line: the seconds of each phase, each phase's seconds split
    into the kernel build, model builds (every ``EmbedEngine`` and
    ``Trainer`` built in this process, ``build_clip``, the checkpoint's
    tree), child-process starts (from the spawn to the child's first
    line, which it prints once torch and the port's CLI are imported;
    where no build overlaps) and the rest, their sums, and each child
    process's start and life; then the kernels line, the card line, and
    ``{"ok": true, ...}`` last.

Any failed check raises, and the script exits non-zero without the last
line. It needs CUDA and the repository's ``tpualign_torch`` package; it
imports nothing of JAX or ``tpualign``.
"""

from __future__ import annotations

import argparse
import contextlib
import dataclasses
import functools
import json
import multiprocessing
import shutil
import subprocess
import sys
import tempfile
import threading
import time

import numpy as np
import torch

# H100 SXM data sheet (dense): HBM rate and peak arithmetic rates
HBM_BYTES_PER_S = 3.35e12
PEAK_FLOPS = {torch.float32: 67e12, torch.bfloat16: 989e12}

B = 256  # BATCH_SIZE default
K1_SHAPES = [("vision", 50, 768, 12, False), ("text16", 16, 512, 8, True),
             ("text32", 32, 512, 8, True), ("text77", 77, 512, 8, True)]
# ViT-H-14's vision attention (hd 80) whole and as one card's part of a
# 4-way model axis (tensor parallel: H/4 heads), at the train batch of a row,
# and whole at the embed batch (the h14_embed phase's shape);
# ViT-B-32's as one card's part of a 2-way model axis (the int8 towers'
# (1, 2) check), at the embed batch
K1_LARGE_SHAPES = [("h14_vision", 32, 257, 1280, 16, False),
                   ("h14_vision_tp4", 32, 257, 320, 4, False),
                   ("h14_vision_b256", B, 257, 1280, 16, False),
                   ("vision_tp2", B, 50, 384, 6, False), ("text77_tp2", B, 77, 256, 4, True)]
K1_TOL = {torch.float32: (2e-5, 0.0), torch.bfloat16: (2**-6, 2**-7)}  # (atol, rtol)
K2_TOL_VALUES = 1e-5
K2_TIE_GAP = 1e-6


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def check(ok: bool, what: str) -> None:
    if not ok:
        raise AssertionError(what)


# Where a run's seconds go (the timing line's split): spans on the host's
# wall clock, ``(kind, label, start, end)``. Kinds: "kernel_build" (phase
# 1), "model_build" (towers built or loaded in this process: every
# ``EmbedEngine`` and ``Trainer``, ``build_clip``, the checkpoint's seeded
# tree), "child_start" (a child process from its spawn to its first line,
# which it prints once torch and the port's CLI are imported: ``READY``),
# "child" (a child's whole life).
SPANS: list = []
READY = ("import sys, time, torch, tpualign_torch.cli\n"
         "print('chip_smoke-ready', repr(time.time()), file=sys.stderr, flush=True)\n")
# ``python -m tpualign_torch <argv>`` that prints the ready line first
CLI = READY + ("import runpy\nsys.argv = ['tpualign_torch'] + sys.argv[1:]\n"
               "runpy.run_module('tpualign_torch', run_name='__main__', alter_sys=True)\n")


@contextlib.contextmanager
def span(kind: str, label: str = ""):
    start = time.time()
    try:
        yield
    finally:
        SPANS.append((kind, label, start, time.time()))


def child_done(label: str, spawned: float, stderr: str) -> None:
    """Records a child process's life from ``spawned`` (``time.time()``)
    to now, and its start up to the ready line in ``stderr`` (its text)."""
    SPANS.append(("child", label, spawned, time.time()))
    for line in stderr.splitlines():
        if line.startswith("chip_smoke-ready "):
            SPANS.append(("child_start", label, spawned, float(line.split()[1])))
            return


def _covered(kinds, a: float, b: float) -> float:
    """Seconds of ``[a, b]`` inside a span of one of ``kinds``."""
    total, end = 0.0, a
    for s, e in sorted((max(s, a), min(e, b)) for k, _, s, e in SPANS if k in kinds):
        s = max(s, end)
        if e > s:
            total, end = total + e - s, e
    return total


def time_split(a: float, b: float) -> dict:
    """``[a, b]`` (wall clock) split into the kernel build, model builds,
    child starts (where no build overlaps them) and the rest."""
    kinds = ["kernel_build", "model_build", "child_start"]
    covered = [_covered(kinds[:i + 1], a, b) for i in range(3)]
    return {"kernel_build": covered[0], "model_build": covered[1] - covered[0],
            "child_start": covered[2] - covered[1], "rest": (b - a) - covered[2],
            "children": sum(1 for k, _, s, _ in SPANS if k == "child" and a <= s < b)}


def children(begin: float) -> list:
    """Each child process in spawn order: its label, when it was spawned
    (seconds after ``begin``, wall clock), its start (spawn to ready line)
    and its life, in seconds."""
    starts = {(label, a): b - a for k, label, a, b in SPANS if k == "child_start"}
    return [{"child": label, "at_s": a - begin, "start_s": starts.get((label, a)),
             "life_s": b - a}
            for k, label, a, b in sorted(SPANS, key=lambda sp: sp[2]) if k == "child"]


def _time_model_builds() -> None:
    """Every ``EmbedEngine`` and ``Trainer`` built in this process counts
    as a model build in the timing line's split."""
    from tpualign_torch.parallel.embed import EmbedEngine
    from tpualign_torch.train.trainer import Trainer

    for cls in (EmbedEngine, Trainer):
        def timed(self, *args, _init=cls.__init__, _label=cls.__name__, **kwargs):
            with span("model_build", _label):
                _init(self, *args, **kwargs)
        cls.__init__ = timed


def time_ms(fn, iters: int) -> float:
    """Mean device time of ``fn`` over ``iters`` calls (CUDA events, after
    one warm-up call)."""
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def graph_ms(fn, launches: int = 64, replays: int = 10) -> float:
    """Mean device time of one ``fn`` call captured ``launches`` times in a
    CUDA graph, over ``replays`` replays (CUDA events around the replays).
    Unlike events around a loop of launches it does not count the host's
    gaps between sub-0.1 ms kernels."""
    fn()
    torch.cuda.synchronize()
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()  # a warm-up on a side stream, as torch.cuda.graphs asks
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    # relaxed: the kernels' C entry points call cudaSetDevice while captured
    with torch.cuda.graph(graph, capture_error_mode="relaxed"):
        for _ in range(launches):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(replays):
        graph.replay()
    end.record()
    torch.cuda.synchronize()
    ms = start.elapsed_time(end) / (replays * launches)
    del graph
    return ms


def bound_ms(nbytes: float, flops: float, peak: float):
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / peak * 1e3
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else "operations")


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


def phase_build():
    """The five kernels (one nvcc each, all started together) and, on a
    thread beside them, the native host library (g++)."""
    from tpualign_torch.native import build as native_build
    from tpualign_torch.ops import build

    native = {}

    def build_native():
        t0 = time.perf_counter()
        native["path"] = native_build.build()
        native["s"] = time.perf_counter() - t0

    thread = threading.Thread(target=build_native)
    t0 = time.perf_counter()
    thread.start()
    libs = build.build_all()
    thread.join()
    secs = time.perf_counter() - t0
    check(native["path"] is not None, "the native library did not build (g++)")
    emit({"phase": "build", "seconds": secs, "libraries": {k: v.name for k, v in libs.items()},
          "native_library": native["path"].name, "native_build_s": native["s"]})


def phase_k1(dev, gen):
    import torch.nn.functional as F

    from tpualign_torch.models.text import causal_mask
    from tpualign_torch.ops.attention import fused_mha, fused_mha_reference

    rows = []
    for name, b, t, d, heads, causal in ([(n, B, *rest) for n, *rest in K1_SHAPES]
                                         + K1_LARGE_SHAPES):
        for dtype in (torch.float32, torch.bfloat16):
            qkv = torch.randn(b, t, 3 * d, generator=gen, device=dev).to(dtype)
            mask = causal_mask(t, dev) if causal else None
            got = fused_mha(qkv, heads, mask)
            want = fused_mha_reference(qkv, heads, mask)
            torch.cuda.synchronize()
            err = (got.float() - want.float()).abs()
            atol, rtol = K1_TOL[dtype]
            check(bool(torch.isfinite(got).all()), f"K1 {name} {dtype}: non-finite output")
            check(bool((err <= atol + rtol * want.float().abs()).all()),
                  f"K1 {name} {dtype}: max abs error {err.max().item():.3g}")
            hd = d // heads
            q, k, v = (x.reshape(b, t, heads, hd).transpose(1, 2).contiguous()
                       for x in qkv.split(d, dim=-1))
            kernel = functools.partial(fused_mha, qkv, heads, mask)
            library = functools.partial(F.scaled_dot_product_attention, q, k, v, is_causal=causal)
            ms_events = time_ms(kernel, 20)
            lib_events = time_ms(library, 20)
            # a graph of 64 launches where events would count the host's gaps;
            # 16 for kernels of a millisecond or more (B=256 at T=257)
            reps = {} if ms_events < 1.0 else {"launches": 16, "replays": 4}
            ms = graph_ms(kernel, **reps)
            lib_ms = graph_ms(library, **reps)
            plain_ms = time_ms(lambda: fused_mha_reference(qkv, heads, mask), 10)
            item = qkv.element_size()
            nbytes = qkv.numel() * item + b * t * d * item + (t * t * 4 if causal else 0)
            flops = 4.0 * b * heads * t * t * hd  # Q.K^T and P.V
            bms, by = bound_ms(nbytes, flops, PEAK_FLOPS[dtype])
            rows.append({"shape": name, "dtype": str(dtype).split(".")[-1], "B": b, "T": t,
                         "D": d, "heads": heads, "causal": causal,
                         "max_abs_err": err.max().item(), "atol": atol, "rtol": rtol,
                         "ms": ms, "plain_ms": plain_ms, "library_ms": lib_ms,
                         "bound_ms": bms, "bound_by": by, "bound_share": bms / ms,
                         "ms_events": ms_events, "library_ms_events": lib_events})
    emit({"phase": "k1_fused_mha", "timing": "ms and library_ms: a CUDA graph of 64 launches, "
                                             "10 replays (16 and 4 where the events read 1 ms or "
                                             "more); *_events: events around 20 launches",
          "results": rows})
    return rows


def _sim_inputs(gen, dev, q, n, d, keys):
    queries = torch.randn(q, d, generator=gen, device=dev)
    corpus = torch.randn(n, d, generator=gen, device=dev)
    corpus[n - 16:] = corpus[:16]                       # exact ties
    queries /= queries.norm(dim=1, keepdim=True)
    corpus /= corpus.norm(dim=1, keepdim=True)
    qk = torch.randint(0, keys, (q,), generator=gen, device=dev, dtype=torch.int32)
    ck = torch.randint(0, keys, (n,), generator=gen, device=dev, dtype=torch.int32)
    qk[::8] = -3                                        # wildcard queries
    qk[3::64] = keys + 7                                # no candidates
    return queries, qk, corpus, ck


def compare_topk(vals, idx, rvals, ridx, what: str) -> float:
    """Empty slots identical; other indices identical except inside runs of
    the plain version's values within K2_TIE_GAP of a neighbour; values
    within K2_TOL_VALUES. Returns the largest value difference."""
    vals, idx, rvals, ridx = (x.cpu().numpy() for x in (vals, idx, rvals, ridx))
    empty = rvals <= -1e30 / 2
    check(bool((idx[empty] == ridx[empty]).all() and (vals[empty] == rvals[empty]).all()),
          f"{what}: empty slots differ")
    close = np.abs(np.diff(rvals, axis=1)) <= K2_TIE_GAP
    near = np.zeros(ridx.shape, bool)
    near[:, 1:] |= close
    near[:, :-1] |= close
    check(bool((idx[~near] == ridx[~near]).all()), f"{what}: indices differ")
    err = float(np.abs(vals - rvals).max())
    check(err <= K2_TOL_VALUES, f"{what}: max abs value error {err:.3g}")
    return err


def admitted_tile_count(qk, ck, variant):
    """(admitted, all) pairs of a query tile and corpus tile for these keys
    at the tiles of K2 (variant None) or K3, the queries grouped by key as
    the wrappers group them: the corpus tiles the kernel reads (it skips
    the rest unread)."""
    from tpualign_torch.ops.sim_topk import (
        _BN, _K2_BN, admitted_tiles, group_by_key, query_tile)

    bq, bn = query_tile(variant, len(qk)), _K2_BN if variant is None else _BN
    if len(qk) > bq:
        qk = qk[group_by_key(qk)]
    admitted = admitted_tiles(qk, ck, bq, bn)
    return int(admitted.sum().item()), admitted.numel()


def phase_k2(dev, gen):
    from tpualign_torch.ops.sim_topk import (
        key_mask, masked_sim_topk, masked_sim_topk_reference)

    q, n, d = 1024, 100_000, 512
    args = _sim_inputs(gen, dev, q, n, d, 1000)
    queries, qk, corpus, ck = args
    valid_pairs = int(key_mask(qk, ck).sum().item())
    admitted, tiles = admitted_tile_count(qk, ck, None)
    rows = []
    for k in (10, 100):
        vals, idx = masked_sim_topk(*args, k)
        rvals, ridx = masked_sim_topk_reference(*args, k)
        torch.cuda.synchronize()
        err = compare_topk(vals, idx, rvals, ridx, f"K2 k={k}")

        def library():
            sims = torch.where(key_mask(qk, ck), queries @ corpus.T, -1e30)
            return torch.topk(sims, k, dim=1)

        ms = time_ms(lambda: masked_sim_topk(*args, k), 5)
        plain_ms = time_ms(lambda: masked_sim_topk_reference(*args, k), 3)
        lib_ms = time_ms(library, 5)
        nbytes = (q * d + n * d) * 4 + (q + n) * 4 + q * k * 8
        bms, by = bound_ms(nbytes, 2.0 * d * valid_pairs, PEAK_FLOPS[torch.float32])
        dense_bms, _ = bound_ms(nbytes, 2.0 * d * q * n, PEAK_FLOPS[torch.float32])
        rows.append({"Q": q, "N": n, "D": d, "k": k, "valid_pairs": valid_pairs,
                     "admitted_tiles": admitted, "tiles": tiles,
                     "empty_slots": int((ridx == 2**30).sum().item()),
                     "max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
                     "library_ms": lib_ms, "bound_ms": bms, "bound_by": by,
                     "dense_bound_ms": dense_bms})
    emit({"phase": "k2_masked_sim_topk", "results": rows})
    return rows


INT_PEAK_OPS = 1979e12  # H100 SXM dense int8 tensor-core rate
K3_SHAPE = (1024, 1_000_000, 512, 10_000)  # Q, N, D, page keys
K3_KS = (10, 40)  # k, and the refine over-fetch of k=10 at RETRIEVAL_REFINE=4
K3_SLAB = 128  # queries per slab of the plain version at N=1M


def _side_by_side(calls: dict) -> dict:
    """``{key: fn(*args)}`` for ``calls = {key: (fn, *args)}``, each on a
    thread of its own (numpy's whole-array operations release the GIL)."""
    from concurrent.futures import ThreadPoolExecutor

    with ThreadPoolExecutor(len(calls)) as pool:
        futures = {key: pool.submit(*call) for key, call in calls.items()}
        return {key: f.result() for key, f in futures.items()}


def _k3_variants():
    from tpualign_torch.parallel.retrieval import (
        _quantize_rows, _quantize_rows_int2, _quantize_rows_int4)

    # (name, quantizer, int8_mxu, kernel variant)
    return [("int8", _quantize_rows, True, "s8"),
            ("int8_dequant", _quantize_rows, False, "dequant"),
            ("int4", _quantize_rows_int4, True, "int4"),
            ("int2", _quantize_rows_int2, True, "int2")]


def _in_slabs(fn, queries, qk, *rest, slab=K3_SLAB):
    parts = [fn(queries[s:s + slab], qk[s:s + slab], *rest)
             for s in range(0, len(queries), slab)]
    return torch.cat([p[0] for p in parts]), torch.cat([p[1] for p in parts])


def _k3_library(variant, queries, qk, corpus, ck, scales, k):
    """One PyTorch call per step for the same function: torch._int_mm (after
    an unpack to s8 for int4/int2; queries padded to its 17-row minimum) or
    a dequantized matmul, the rescale, the mask and torch.topk. A yardstick
    only; the port never calls it."""
    from tpualign_torch.ops.sim_topk import _unpack_codes, key_mask, quantize_queries

    if variant == "dequant":
        sims = queries @ (corpus.float() * scales[:, None]).T
    else:
        qq, qs = quantize_queries(queries)
        codes = corpus if variant == "s8" else _unpack_codes(corpus, variant).to(torch.int8)
        qq = torch.nn.functional.pad(qq, (0, 0, 0, max(0, 32 - len(qq))))
        sims = (torch._int_mm(qq, codes.T)[:len(queries)].float() * qs[:, None]
                * scales[None, :])
    return torch.topk(torch.where(key_mask(qk, ck), sims, -1e30), k, dim=1)


def phase_k3(dev, gen):
    """K3 against its plain version: every variant at Q=1,024, N=1,000,000,
    D=512 over _sim_inputs' mix, k=10 and k=40."""
    q, n, d, keys = K3_SHAPE
    queries, qk, corpus, ck = _sim_inputs(gen, dev, q, n, d, keys)
    host = corpus.cpu().numpy()
    del corpus
    variants = _k3_variants()
    # each quantizer once (int8's codes serve two variants), side by side
    quantized = _side_by_side({quantize: (quantize, host) for _, quantize, _, _ in variants})
    del host
    rows = []
    for name, quantize, mxu, variant in variants:
        codes, scales = (torch.from_numpy(a).to(dev) for a in quantized[quantize])
        for k in K3_KS:
            rows.append({"variant": name, "Q": q, "N": n, "D": d, "k": k,
                         **_k3_measure(f"K3 {name} k={k}", queries, qk, codes, ck, scales, mxu,
                                       k)})
        del codes, scales
    del quantized
    emit({"phase": "k3_masked_sim_topk_quant", "results": rows})
    return rows


def _k3_measure(what, queries, qk, codes, ck, scales, mxu, k) -> dict:
    """One K3 launch against its plain version on the same inputs, then its
    time, the plain version's, the library yardstick's, the bound and the
    corpus tiles it reads.

    The bound's bytes, as K4's: the corpus keys (4 B a row: every row's key
    is read to admit it), the row and scale of each distinct row that some
    query admits, the fp32 queries and their keys, and the outputs. Its
    operations: 2·D for each admitted (query, row) pair."""
    from tpualign_torch.ops.sim_topk import (
        key_mask, masked_sim_topk, masked_sim_topk_quant, masked_sim_topk_reference,
        quant_variant)

    q, d = queries.shape
    n = ck.shape[0]
    variant = quant_variant(codes, d, scales, mxu)
    kw = dict(corpus_scales=scales, int8_mxu=mxu)
    before = masked_sim_topk_quant.launches
    vals, idx = masked_sim_topk(queries, qk, codes, ck, k, **kw)
    torch.cuda.synchronize()
    check(masked_sim_topk_quant.launches == before + 1, f"{what}: no launch")

    def plain():
        return _in_slabs(lambda a, b: masked_sim_topk_reference(a, b, codes, ck, k, **kw),
                         queries, qk)

    rvals, ridx = plain()
    if variant == "dequant":
        err = compare_topk(vals, idx, rvals, ridx, what)
    else:
        check(bool(torch.equal(idx, ridx)), f"{what}: indices differ")
        check(bool(torch.equal(vals, rvals)), f"{what}: values differ")
        err = 0.0
    ms = time_ms(lambda: masked_sim_topk(queries, qk, codes, ck, k, **kw), 5 if q > 16 else 50)
    plain_ms = time_ms(plain, 1)
    lib_ms = time_ms(lambda: _k3_library(variant, queries, qk, codes, ck, scales, k), 3)
    pairs = 0
    rows = torch.zeros(n, dtype=torch.bool, device=ck.device)
    for s0 in range(0, q, K3_SLAB):
        m = key_mask(qk[s0:s0 + K3_SLAB], ck)
        pairs += int(m.sum().item())
        rows |= m.any(dim=0)
    distinct = int(rows.sum().item())
    nbytes = n * 4 + distinct * (codes.shape[1] + 4) + q * d * 4 + q * 4 + q * k * 8
    peak = PEAK_FLOPS[torch.float32] if variant == "dequant" else INT_PEAK_OPS
    bms, by = bound_ms(nbytes, 2.0 * d * pairs, peak)
    admitted, tiles = admitted_tile_count(qk, ck, variant)
    return {"kernel_variant": variant, "corpus_bytes": codes.numel(), "admitted_rows": distinct,
            "admitted_pairs": pairs, "admitted_tiles": admitted, "tiles": tiles,
            "empty_slots": int((ridx == 2**30).sum().item()), "max_abs_err": err, "ms": ms,
            "plain_ms": plain_ms, "library_ms": lib_ms, "bound_ms": bms, "bound_by": by,
            "tolerance": ({"values_atol": K2_TOL_VALUES, "tie_gap": K2_TIE_GAP}
                          if variant == "dequant" else "identical")}


K4_SHAPE = (1_000_000, 512, 10_000)  # N, D, page topics (the serve store's scale)
# (name, layout, int8_mxu, Q, k): s8 at serving and batch sizes, k=10 and the
# refine over-fetch k=40; the other variants at Q=64, k=10
K4_CASES = ([("int8", "int8", True, q, k) for q in (2, 64, 1024) for k in (10, 40)]
            + [("fp32", "fp32", False, 64, 10), ("int8_dequant", "int8", False, 64, 10),
               ("int4", "int4", True, 64, 10), ("int2", "int2", True, 64, 10)])
K4_SLAB = 64  # queries per slab of the plain version and of the pair count


def _k4_queries(gen, dev, topics, q):
    """Queries around page topics, keyed to their page; 1/8 wildcard, some
    keyed to a page that does not exist (no candidates)."""
    n_pages = topics.shape[0]
    page = torch.randint(0, n_pages, (q,), generator=gen, device=dev, dtype=torch.int32)
    qv = topics[page] + 1.5 * torch.randn(q, topics.shape[1], generator=gen, device=dev)
    qv /= qv.norm(dim=1, keepdim=True)
    qk = page.clone()
    qk[::8] = -3
    qk[3::64] = n_pages + 7
    return qv, qk


def _k4_slabs(fn, q, qk, probe):
    parts = [fn(q[s:s + K4_SLAB], qk[s:s + K4_SLAB], probe[s:s + K4_SLAB])
             for s in range(0, len(q), K4_SLAB)]
    return torch.cat([p[0] for p in parts]), torch.cat([p[1] for p in parts])


def _k4_library(variant, q, qk, probe, uids, emb, ck, scales, k, cap, n_lists):
    """One PyTorch call per step for the same function: the union's rows
    gathered, torch.matmul (dequantized rows for dequant) or torch._int_mm
    (after an unpack to s8 for int4/int2; queries padded to its 17-row
    minimum), the rescale, the key and membership mask, torch.topk. A
    yardstick only; the port never calls it."""
    from tpualign_torch.ops.ivf_topk import _membership, union_rows
    from tpualign_torch.ops.sim_topk import _unpack_codes, key_mask, quantize_queries

    blocks, rows = union_rows(uids, cap, n_lists)
    mask = key_mask(qk, ck[rows]) & _membership(probe, blocks, n_lists).repeat_interleave(
        cap, dim=1)
    c = emb[rows]
    if variant is None:
        sims = q @ c.T
    elif variant == "dequant":
        sims = q @ (c.float() * scales[rows][:, None]).T
    else:
        qq, qs = quantize_queries(q)
        codes = c if variant == "s8" else _unpack_codes(c, variant).to(torch.int8)
        qq = torch.nn.functional.pad(qq, (0, 0, 0, max(0, 32 - len(qq))))
        sims = (torch._int_mm(qq, codes.T)[:len(q)].float() * qs[:, None]
                * scales[rows][None, :])
    vals, pos = torch.topk(torch.where(mask, sims, -1e30), k, dim=1)
    return vals, rows[pos]


def phase_k4(dev, gen):
    """K4 against its plain version: an IVFIndex built on the card over
    K4_SHAPE (default geometry: 1,000 lists, capacity 1,536, 125 probes),
    the union and probes of each query batch, every variant (K4_CASES)."""
    from tpualign_torch.parallel.ivf import IVFIndex, _probe, _union
    from tpualign_torch.parallel.retrieval import _QUANTIZERS, _tensor

    n, d, n_pages = K4_SHAPE
    topics = torch.randn(n_pages, d, generator=gen, device=dev)
    page = torch.randint(0, n_pages, (n,), generator=gen, device=dev, dtype=torch.int32)
    rows = topics[page] + 1.5 * torch.randn(n, d, generator=gen, device=dev)
    host = (rows / rows.norm(dim=1, keepdim=True)).cpu().numpy()
    del rows
    t0 = time.perf_counter()
    index = IVFIndex(host, keys=page.cpu().numpy(), device=dev)
    torch.cuda.synchronize()
    build_s = time.perf_counter() - t0
    cap, n_lists = index.capacity, index.n_lists
    check(n_lists == 1000 and cap <= 1536 and index.n_probes == 125,
          f"K4 geometry: {n_lists} lists, capacity {cap}, {index.n_probes} probes")
    layouts = {"fp32": (index._emb, None)}
    quantized = _side_by_side({name: (_QUANTIZERS[name], host) for name in ("int8", "int4", "int2")})
    del host
    for name, (codes, scales) in quantized.items():
        layouts[name] = index._gather(_tensor(codes, dev), _tensor(scales, dev))
    del quantized
    ck = index._keys
    rows_total = index._emb.shape[0]
    queries = {q: _k4_queries(gen, dev, topics, q) for q in (2, 64, 1024)}
    rows_out = []
    for name, layout, mxu, q, k in K4_CASES:
        qv, qk = queries[q]
        emb, scales = layouts[layout]
        probe = _probe(qv, qk, index.centroids, index.n_probes, n_lists)
        row = _k4_measure(f"K4 {name} Q={q} k={k}", qv, qk, probe,
                          _union(probe, n_lists, index.spill_blocks), emb, ck, scales, mxu, k,
                          cap, n_lists)
        rows_out.append({"variant": name, "Q": q, "k": k, "N": n, "D": d, "n_lists": n_lists,
                         "capacity": cap, "n_probes": index.n_probes,
                         "spill_blocks": index.spill_blocks, "layout_rows": rows_total, **row})
    emit({"phase": "k4_ivf_probe_topk", "index_build_s": build_s, "results": rows_out})
    return rows_out


def _k4_measure(what, qv, qk, probe, uids, emb, ck, scales, mxu, k, cap, n_lists) -> dict:
    """One K4 launch against its plain version on the same inputs, then its
    time, the plain version's, the library yardstick's and the bound.

    The bound's bytes: the union's keys (4 B a row: every row's key is read
    to admit it), the embedding row and scale of each distinct row that
    some query admits (rows none admits, empty slots included, need not be
    read), the queries, probes, uids and outputs. Its operations: 2·D for
    each admitted (query, row) pair."""
    from tpualign_torch.ops.ivf_topk import (
        _membership, admitted_union_tiles, ivf_probe_topk, ivf_probe_topk_reference, union_rows)
    from tpualign_torch.ops.sim_topk import (
        _BN, _K2_BN, group_by_key, key_mask, quant_variant, query_tile)

    q, d = qv.shape
    variant = quant_variant(emb, d, scales, mxu)
    args = (uids, emb, ck, k, cap, n_lists)
    kw = dict(packed_scales=scales, int8_mxu=mxu)
    before = ivf_probe_topk.launches
    vals, idx = ivf_probe_topk(qv, qk, probe, *args, **kw)
    torch.cuda.synchronize()
    check(ivf_probe_topk.launches == before + 1, f"{what}: no launch")

    def plain():
        return _k4_slabs(lambda a, b, c: ivf_probe_topk_reference(a, b, c, *args, **kw),
                         qv, qk, probe)

    rvals, ridx = plain()
    if variant in (None, "dequant"):
        err = compare_topk(vals, idx, rvals, ridx, what)
    else:
        check(bool(torch.equal(idx, ridx)), f"{what}: indices differ")
        check(bool(torch.equal(vals, rvals)), f"{what}: values differ")
        err = 0.0
    ms = time_ms(lambda: ivf_probe_topk(qv, qk, probe, *args, **kw), 20 if q < 1024 else 3)
    plain_ms = time_ms(plain, 1)
    lib_ms = time_ms(lambda: _k4_library(variant, qv, qk, probe, uids, emb, ck, scales, k,
                                         cap, n_lists), 3)
    blocks, urows = union_rows(uids, cap, n_lists)
    pairs = 0
    admitted = torch.zeros(len(urows), dtype=torch.bool, device=urows.device)
    for s0 in range(0, q, K4_SLAB):
        member = _membership(probe[s0:s0 + K4_SLAB], blocks, n_lists)
        m = key_mask(qk[s0:s0 + K4_SLAB], ck[urows]) & member.repeat_interleave(cap, dim=1)
        pairs += int(m.sum().item())
        admitted |= m.any(dim=0)
    distinct = int(admitted.sum().item())
    bq = query_tile(variant, q)
    order = group_by_key(qk) if q > bq else torch.arange(q, device=qk.device)
    tiles = admitted_union_tiles(qk[order], probe[order], uids, ck, cap, n_lists, bq,
                                 _K2_BN if variant is None else _BN)
    row_bytes = emb.shape[1] * emb.element_size() + (4 if scales is not None else 0)
    qbytes = q * d * (1 if variant in ("s8", "int4", "int2") else 4) + q * 8
    nbytes = (len(urows) * 4 + distinct * row_bytes + qbytes + probe.numel() * 4
              + len(uids) * 4 + q * k * 8)
    peak = INT_PEAK_OPS if variant in ("s8", "int4", "int2") else PEAK_FLOPS[torch.float32]
    bms, by = bound_ms(nbytes, 2.0 * d * pairs, peak)
    return {"kernel_variant": variant or "fp32", "union_blocks": len(blocks),
            "union_rows": len(urows), "admitted_rows": distinct, "admitted_pairs": pairs,
            "admitted_tiles": int(tiles.sum().item()), "tiles": tiles.numel(),
            "empty_slots": int((ridx == 2**30).sum().item()), "max_abs_err": err, "ms": ms,
            "plain_ms": plain_ms, "library_ms": lib_ms, "bound_ms": bms, "bound_by": by,
            "tolerance": ({"values_atol": K2_TOL_VALUES, "tie_gap": K2_TIE_GAP}
                          if variant in (None, "dequant") else "identical")}


def _chunk_texts(rng, count, empty_every=97):
    """Texts whose byte-level token counts fill the 16, 32 and 77 buckets,
    with every ``empty_every``-th text empty (a placeholder; 0: none)."""
    words = np.array(["oil", "filter", "bolt", "pakking", "vervang", "draai",
                      "los", "torque", "25", "Nm", "check", "peil", "pump",
                      "de", "het", "seal", "valve", "hose", "zie", "fig"])
    texts = []
    for i in range(count):
        if empty_every and i % empty_every == 0:
            texts.append("")
            continue
        n_words = (2, 5, 14)[i % 3] + int(rng.integers(0, 3))
        texts.append(" ".join(rng.choice(words, n_words)))
    return texts


SLICE_PAGES, SLICE_TEXT_QUERIES = 1024, 256


@functools.lru_cache(maxsize=1)  # the slice's and the mesh phase's
def _slice_inputs(seed):
    """The slice's 2,048 normalised images (fp32 NHWC), 8,192 chunk records
    and 256 text queries, from ``seed``; returns (images, chunks, queries,
    the images' manuals, their pages)."""
    from tpualign_torch.ops.preprocess import CLIP_MEAN, CLIP_STD

    rng = np.random.default_rng(seed)
    n_img, n_chunk = 2048, 8192
    u8 = rng.integers(0, 256, (n_img, 224, 224, 3), dtype=np.uint8)
    images = ((u8 / np.float32(255.0) - np.asarray(CLIP_MEAN, np.float32))
              / np.asarray(CLIP_STD, np.float32)).astype(np.float32)
    del u8
    page_of_img = rng.integers(0, SLICE_PAGES, n_img)
    img_man = [f"manual-{p // 8}" for p in page_of_img]
    img_pg = [int(p % 8) for p in page_of_img]
    page_of_chunk = rng.integers(0, SLICE_PAGES, n_chunk)
    texts = _chunk_texts(rng, n_chunk)
    chunks = [{"chunk_id": f"c{i}", "text": texts[i], "manual_id": f"manual-{p // 8}",
               "page": int(p % 8)} for i, p in enumerate(page_of_chunk)]
    queries = [" ".join(rng.choice(["replace", "the", "oil", "filter", "bolt", "pump"], 4))
               for _ in range(SLICE_TEXT_QUERIES)]
    return images, chunks, queries, img_man, img_pg


def phase_slice(dev, seed):
    from tpualign_torch.config import ModelConfig
    from tpualign_torch.models.layers import MultiHeadAttention
    from tpualign_torch.ops.attention import fused_mha
    from tpualign_torch.ops.sim_topk import masked_sim_topk, masked_sim_topk_reference
    from tpualign_torch.parallel import EmbedEngine, RetrievalIndex
    from tpualign_torch.parallel.retrieval import encode_keys

    images, chunks, queries, img_man, img_pg = _slice_inputs(seed)
    texts = [c["text"] for c in chunks]
    n_img, n_chunk, n_text_q = len(images), len(chunks), len(queries)

    engine = EmbedEngine(ModelConfig("ViT-B-32"), device=dev, seed=seed)
    bucket_of = np.searchsorted(engine.text_buckets,
                                np.argmax(engine.tokenizer(texts), axis=1) + 1)
    buckets = {int(engine.text_buckets[b]): int((bucket_of == b).sum())
               for b in np.unique(bucket_of)}
    check(set(buckets) == {16, 32, 77}, f"chunk texts fill buckets {buckets}")

    # warm-up, untimed: the caching allocator's first blocks and cuBLAS's
    # first calls at these shapes, which a long run pays once
    engine.encode_image_batch(images[:engine.batch_size])
    engine.encode_text_batch(texts[:engine.batch_size])

    fused_mha.launches = masked_sim_topk.launches = 0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    img_emb = engine.encode_image_batch(images)
    t_img = time.perf_counter() - t0
    t0 = time.perf_counter()
    chunk_emb = engine.embed_chunk_records(chunks)
    t_txt = time.perf_counter() - t0

    t0 = time.perf_counter()
    index = RetrievalIndex(chunk_emb, [c["manual_id"] for c in chunks],
                           [c["page"] for c in chunks], device=dev)
    t_build = time.perf_counter() - t0
    t0 = time.perf_counter()
    vals, idx = index.search(img_emb, img_man, img_pg, k=100)
    t_eval = time.perf_counter() - t0

    img_index = RetrievalIndex(img_emb, img_man, img_pg, device=dev)
    t0 = time.perf_counter()
    q_emb = engine.encode_text_batch(queries)
    t1 = time.perf_counter()
    qvals, qidx = img_index.search(q_emb, k=10, global_search=True)
    t_query = time.perf_counter() - t0
    t_query_search = time.perf_counter() - t1
    torch.cuda.synchronize()
    launches = {"fused_mha": fused_mha.launches, "masked_sim_topk": masked_sim_topk.launches}

    for name, emb in (("images", img_emb), ("chunks", chunk_emb), ("queries", q_emb)):
        check(bool(np.isfinite(emb).all()), f"{name}: non-finite embeddings")
        norm_err = float(np.abs(np.linalg.norm(emb, axis=1) - 1.0).max())
        check(norm_err <= 1e-5, f"{name}: norms off by {norm_err:.3g}")
    check(vals.shape == (n_img, 100) and qidx.shape == (n_text_q, 10), "search shapes")

    # each search against the plain version on the same embeddings and keys
    errs = {}
    qk, _ = encode_keys(img_man, img_pg, dict(index.vocab))
    for what, ix, q, keys, k, (v, i) in (
            ("keyed_k100", index, img_emb, qk, 100, (vals, idx)),
            ("global_k10", img_index, q_emb, np.full(n_text_q, -3, np.int32), 10, (qvals, qidx))):
        qt = torch.from_numpy(q).to(dev)
        kt = torch.from_numpy(keys).to(dev)
        rv, ri = masked_sim_topk_reference(qt, kt, *_rows(ix)[:2], k)
        ri = torch.where(rv <= -1e30 / 2, torch.full_like(ri, -1), ri)
        errs[what] = compare_topk(torch.from_numpy(v), torch.from_numpy(i), rv, ri.long(), what)

    # the bf16 towers with K1 against the same towers on the plain path
    attn = [m for m in engine.model.modules() if isinstance(m, MultiHeadAttention)]
    fused_img, fused_txt = img_emb[:64], engine.encode_text_batch(queries[:64])
    for m in attn:
        m.use_fused_attention = False
    plain_img = engine.encode_image_batch(images[:64])
    plain_txt = engine.encode_text_batch(queries[:64])
    for m in attn:
        m.use_fused_attention = True
    tower_err = {"image": float(np.abs(fused_img - plain_img).max()),
                 "text": float(np.abs(fused_txt - plain_txt).max())}
    for tower, e in tower_err.items():
        check(e <= 2e-2, f"{tower} tower, K1 against the plain path: max abs {e:.3g}")

    emit({"phase": "slice", "model": "ViT-B-32", "dtype": "bfloat16", "batch_size": engine.batch_size,
          "images": n_img, "chunks": n_chunk, "chunk_buckets": buckets,
          "placeholders": sum(1 for t in texts if not t),
          "image_s": t_img, "chunk_s": t_txt,
          "images_per_s": n_img / t_img, "chunks_per_s": n_chunk / t_txt,
          "pairs_per_s": 1.0 / (t_img / n_img + t_txt / n_chunk),
          "index_build_s": t_build, "eval_search_s": t_eval,
          "eval_qps": n_img / t_eval,
          "text_query_s": t_query, "text_query_qps": n_text_q / t_query,
          "text_query_search_qps": n_text_q / t_query_search,
          "search_value_err": errs, "tower_fused_vs_plain_max_abs": tower_err,
          "launches": launches})
    for name, count in launches.items():
        check(count > 0, f"{name} was not launched on the main path")
    phase_profile(engine, images, texts)
    return launches


H14_IMAGES, H14_TEXTS, H14_CHECK_ROWS = 512, 512, 64
H14_TOWER_TOL = 2e-2  # the slice's bound: K1 against the plain attention, bf16 towers


def _h14_engine(dev, seed):
    """The h14_embed phase's ``EmbedEngine`` (ViT-H-14 seeded at full size,
    bf16) and the seconds it took: built on a thread beside the kernels'
    build, where its host-side draws of about 1e9 weights overlap nvcc."""
    from tpualign_torch.config import ModelConfig
    from tpualign_torch.parallel import EmbedEngine

    t0 = time.perf_counter()
    engine = EmbedEngine(ModelConfig("ViT-H-14"), device=dev, seed=seed)
    return engine, time.perf_counter() - t0


def phase_h14_embed(dev, seed, built) -> dict:
    """ViT-H-14 at its full widths and depth (vision 1280 / 32 layers / 16
    heads / hd 80, T=257; text 1024 / 24 / 16), seeded, bf16, at the
    engine's batch of 256 (``built``: ``_h14_engine``'s future): 512 seeded
    images at 224 px and 512 chunk texts over the 16/32/77 buckets.
    Images/s, chunks/s and peak memory; the embeddings finite and
    unit-norm; 64 image and 64 text rows against the same towers on the
    plain attention; K1's launches around the timed pass, by sequence
    length (a tally around the wrapper's launch)."""
    import collections

    from tpualign_torch.models.layers import MultiHeadAttention
    from tpualign_torch.ops import attention

    rng = np.random.default_rng(seed + 14)
    images = rng.standard_normal((H14_IMAGES, 224, 224, 3), dtype=np.float32)
    texts = _chunk_texts(rng, H14_TEXTS, empty_every=0)
    engine, t_build = built.result()
    attn = [m for m in engine.model.modules() if isinstance(m, MultiHeadAttention)]
    check(engine.batch_size == B and engine.model.visual.compute_dtype == torch.bfloat16
          and all(m.use_fused_attention for m in attn), "ViT-H-14: not the bf16 K1 towers at B=256")
    bucket_of = np.searchsorted(engine.text_buckets,
                                np.argmax(engine.tokenizer(texts), axis=1) + 1)
    buckets = {int(engine.text_buckets[b]): int((bucket_of == b).sum())
               for b in np.unique(bucket_of)}
    check(set(buckets) == {16, 32, 77}, f"ViT-H-14 chunk texts fill buckets {buckets}")
    engine.encode_image_batch(images[:B])  # warm-up, untimed
    engine.encode_text_batch(texts[:B])

    by_t = collections.Counter()
    launch = attention._launch

    def tallied(qkv, num_heads, mask):
        before = attention.fused_mha.launches
        out = launch(qkv, num_heads, mask)
        by_t[int(qkv.shape[1])] += attention.fused_mha.launches - before
        return out

    attention._launch = tallied
    try:
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats(dev)
        attention.fused_mha.launches = 0
        t0 = time.perf_counter()
        img = engine.encode_image_batch(images)
        t_img = time.perf_counter() - t0
        t0 = time.perf_counter()
        txt = engine.encode_text_batch(texts)
        t_txt = time.perf_counter() - t0
        torch.cuda.synchronize()
        launches = attention.fused_mha.launches
    finally:
        attention._launch = launch
    peak_gb = torch.cuda.max_memory_allocated(dev) / 2**30
    for name, emb, n in (("images", img, H14_IMAGES), ("texts", txt, H14_TEXTS)):
        check(emb.shape == (n, engine.variant.embed_dim), f"ViT-H-14 {name}: shape {emb.shape}")
        check(bool(np.isfinite(emb).all()), f"ViT-H-14 {name}: non-finite embeddings")
        norm_err = float(np.abs(np.linalg.norm(emb, axis=1) - 1.0).max())
        check(norm_err <= 1e-5, f"ViT-H-14 {name}: norms off by {norm_err:.3g}")
    for m in attn:
        m.use_fused_attention = False
    plain_img = engine.encode_image_batch(images[:H14_CHECK_ROWS])
    plain_txt = engine.encode_text_batch(texts[:H14_CHECK_ROWS])
    for m in attn:
        m.use_fused_attention = True
    gap = {"images": float(np.abs(img[:H14_CHECK_ROWS] - plain_img).max()),
           "texts": float(np.abs(txt[:H14_CHECK_ROWS] - plain_txt).max())}
    for name, e in gap.items():
        check(e <= H14_TOWER_TOL, f"ViT-H-14 {name}, K1 against the plain attention: max abs "
                                  f"{e:.3g} > {H14_TOWER_TOL}")
    vision_launches = engine.variant.vision_layers * -(-H14_IMAGES // engine.batch_size)
    check(by_t[257] == vision_launches,
          f"K1 at T=257 launched {by_t[257]} times in ViT-H-14's image tower "
          f"(want {vision_launches})")
    emit({"phase": "h14_embed", "model": "ViT-H-14", "dtype": "bfloat16",
          "batch_size": engine.batch_size, "images": H14_IMAGES, "texts": H14_TEXTS,
          "chunk_buckets": buckets, "engine_build_s_beside_kernel_build": t_build,
          "image_s": t_img,
          "chunk_s": t_txt, "images_per_s": H14_IMAGES / t_img,
          "chunks_per_s": H14_TEXTS / t_txt, "peak_memory_gb": peak_gb,
          "k1_launches": launches, "k1_launches_by_t": dict(sorted(by_t.items())),
          "max_abs_gap_to_plain_attention": gap, "tolerance": H14_TOWER_TOL,
          "checked_rows": H14_CHECK_ROWS})
    del engine, built
    torch.cuda.empty_cache()
    return {"launches": launches, "t257": by_t[257]}


FP32_IMAGES, FP32_TEXTS = 1024, 4096
FP32_TOWER_TOL = 1e-4  # K1 fp32 (2e-5 a launch) through 12 blocks, unit embeddings


def phase_fp32_towers(dev, seed) -> int:
    """The slice's towers at COMPUTE_DTYPE=float32 (ViT-B-32, seeded
    weights, fp32 projections without TF32), every attention through K1's
    fp32 kernel: 1,024 images and 4,096 texts, images/s and chunks/s, K1's
    launches (counted around this pass alone), and the embeddings against
    the same towers with the plain attention (``fused_attention=False``)."""
    from tpualign_torch.config import ModelConfig
    from tpualign_torch.models.layers import MultiHeadAttention
    from tpualign_torch.ops.attention import fused_mha
    from tpualign_torch.parallel import EmbedEngine

    rng = np.random.default_rng(seed + 11)
    images = rng.normal(size=(FP32_IMAGES, 224, 224, 3)).astype(np.float32)
    texts = _chunk_texts(rng, FP32_TEXTS, empty_every=0)
    engine = EmbedEngine(ModelConfig("ViT-B-32", compute_dtype="float32"), device=dev, seed=seed)
    attn = [m for m in engine.model.modules() if isinstance(m, MultiHeadAttention)]
    check(all(m.use_fused_attention for m in attn) and engine.model.visual.compute_dtype
          == torch.float32, "the fp32 towers do not take K1")
    engine.encode_image_batch(images[:B])  # warm-up, untimed
    engine.encode_text_batch(texts[:B])
    fused_mha.launches = 0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    img = engine.encode_image_batch(images)
    t_img = time.perf_counter() - t0
    t0 = time.perf_counter()
    txt = engine.encode_text_batch(texts)
    t_txt = time.perf_counter() - t0
    torch.cuda.synchronize()
    launches = fused_mha.launches
    vision_launches = 12 * (FP32_IMAGES // B)
    check(launches > vision_launches, f"K1 fp32 launched {launches} times in the fp32 towers")
    for m in attn:
        m.use_fused_attention = False
    plain_img = engine.encode_image_batch(images)
    plain_txt = engine.encode_text_batch(texts)
    for m in attn:
        m.use_fused_attention = True
    gap = {"images": float(np.abs(img - plain_img).max()),
           "texts": float(np.abs(txt - plain_txt).max())}
    for name, e in gap.items():
        check(e <= FP32_TOWER_TOL, f"fp32 {name} tower, K1 against the plain attention: max abs "
                                   f"{e:.3g} > {FP32_TOWER_TOL}")
    emit({"phase": "fp32_towers", "model": "ViT-B-32", "dtype": "float32", "batch_size": B,
          "images": FP32_IMAGES, "texts": FP32_TEXTS, "image_s": t_img, "chunk_s": t_txt,
          "images_per_s": FP32_IMAGES / t_img, "chunks_per_s": FP32_TEXTS / t_txt,
          "k1_fp32_launches": launches, "k1_fp32_launches_vision": vision_launches,
          "max_abs_gap_to_plain_attention": gap, "tolerance": FP32_TOWER_TOL})
    del engine
    torch.cuda.empty_cache()
    return launches


INT8_IMAGES, INT8_CHUNKS = 1024, 4096
INT8_CPU_IMAGES = 32  # images of one batch whose first projection the CPU repeats (of 256)


def _int8_split(one, tp, images, texts) -> dict:
    """``tp``, an ``EmbedEngine`` at CLIP_QUANT=int8 over a mesh whose model
    axis is above 1 (each row's int8 products split over its cards: the
    row and column maxima taken over the cards, the int32 partials summed
    on the row's first card), against ``one``, one card's int8 engine at the
    batch of one data row (the same products at the same shapes): images
    and chunks bit for bit; images/s and chunks/s of each; the launches,
    counted around each engine's runs alone (the mesh's: K1 once a part,
    block and forward, ``m`` times one card's; ``_int_mm`` four times a
    part, block and forward)."""
    from tpualign_torch.ops import quant
    from tpualign_torch.ops.attention import fused_mha

    m = tp.mesh.shape["model"]
    out, got = {}, {}
    for name, eng in (("one_card", one), ("mesh", tp)):
        eng.encode_image_batch(images[:tp.batch_size])  # warm-up, untimed
        eng.encode_text_batch(texts[:tp.batch_size])
        _sync_all()
        fused_mha.launches = quant.int8_dot.int_mm_calls = 0
        t0 = time.perf_counter()
        img = eng.encode_image_batch(images)
        t_img = time.perf_counter() - t0
        t0 = time.perf_counter()
        txt = eng.encode_text_batch(texts)
        t_txt = time.perf_counter() - t0
        _sync_all()
        got[name] = (img, txt)
        out[name] = {"images_per_s": len(images) / t_img, "chunks_per_s": len(texts) / t_txt,
                     "batch_size": eng.batch_size,
                     "launches": {"fused_mha": fused_mha.launches,
                                  "int_mm": quant.int8_dot.int_mm_calls}}
    for k, what in enumerate(("images", "chunks")):
        a, b = got["mesh"][k], got["one_card"][k]
        check(np.array_equal(a, b), f"int8 towers on {tp.mesh.shape}: {what} differ from one "
                                    f"card's by {float(np.abs(a - b).max()):.3g}")
    lm, l1 = out["mesh"]["launches"], out["one_card"]["launches"]
    check(lm["fused_mha"] == m * l1["fused_mha"] > 0 and lm["int_mm"] == 4 * lm["fused_mha"],
          f"int8 towers on {tp.mesh.shape}: launches {lm} against one card's {l1} (K1 once a "
          "part, _int_mm four times a part, block and forward)")
    return {"on": {"shape": tp.mesh.shape, "devices": [str(d) for d in tp.mesh.devices.flat]},
            "images": len(images), "chunks": len(texts), "bit_equal": True, **out}


def phase_int8_towers(dev, seed):
    """CLIP_QUANT=int8: ViT-B-32's towers (seeded weights, bf16 stream) with
    every projection of every block through ``int8_dot`` (``torch._int_mm``)
    and every attention through K1, against the bf16 towers on the same
    inputs: images/s, chunks/s, the largest gap and the smallest cosine;
    the launches (one K1 and four ``_int_mm`` per block and forward); one
    batch's first projection on the card against the CPU ``int8_dot`` on
    the same input (its first INT8_CPU_IMAGES images' rows): the same
    codes, outputs within an ulp; then the same
    int8 towers tensor parallel on ``[dev] * 2`` as a (1, 2) mesh against
    the one-card int8 engine, bit for bit (_int8_split). Returns the
    one-card int8 launches and the (1, 2) engine's."""
    from tpualign_torch.config import ModelConfig
    from tpualign_torch.models.layers import MultiHeadAttention
    from tpualign_torch.ops import quant
    from tpualign_torch.ops.attention import fused_mha
    from tpualign_torch.parallel import EmbedEngine, create_mesh

    rng = np.random.default_rng(seed + 7)
    images = rng.normal(size=(INT8_IMAGES, 224, 224, 3)).astype(np.float32)
    texts = _chunk_texts(rng, INT8_CHUNKS, empty_every=0)
    engines = {q: EmbedEngine(ModelConfig("ViT-B-32", quant=q), device=dev, seed=seed)
               for q in ("none", "int8")}
    check(engines["int8"].model.quant == "int8", "the int8 towers were not built")
    for eng in engines.values():  # warm-up, untimed
        eng.encode_image_batch(images[:B])
        eng.encode_text_batch(texts[:B])
    out, launches = {}, {}
    for q, eng in engines.items():
        fused_mha.launches = quant.int8_dot.int_mm_calls = 0
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        img = eng.encode_image_batch(images)
        t_img = time.perf_counter() - t0
        t0 = time.perf_counter()
        txt = eng.encode_text_batch(texts)
        t_txt = time.perf_counter() - t0
        torch.cuda.synchronize()
        launches[q] = {"fused_mha": fused_mha.launches, "int_mm": quant.int8_dot.int_mm_calls}
        for name, emb in (("images", img), ("chunks", txt)):
            check(bool(np.isfinite(emb).all()), f"{q} {name}: non-finite embeddings")
        out[q] = {"images_per_s": INT8_IMAGES / t_img, "chunks_per_s": INT8_CHUNKS / t_txt,
                  "image_s": t_img, "chunk_s": t_txt, "img": img, "txt": txt}
    l8 = launches["int8"]
    check(l8["fused_mha"] > 0 and l8["int_mm"] == 4 * l8["fused_mha"],
          f"int8 towers: {l8} (one K1 and four _int_mm per block and forward)")
    check(launches["none"]["int_mm"] == 0, f"bf16 towers called _int_mm: {launches['none']}")
    gap, cos = {}, {}
    for name in ("img", "txt"):
        a, b = out["int8"][name], out["none"][name]
        gap[name] = float(np.abs(a - b).max())
        cos[name] = float((a * b).sum(axis=1).min())
        check(cos[name] > 0.99, f"int8 {name} tower: smallest cosine to bf16 {cos[name]:.5f}")

    # one batch's first vision projection, the card against the CPU on the
    # first INT8_CPU_IMAGES images' rows (each row is quantized and
    # multiplied on its own; the CPU's int32 product is slow)
    attn = next(m for m in engines["int8"].model.visual.modules()
                if isinstance(m, MultiHeadAttention))
    seen = {}
    hook = attn.register_forward_pre_hook(lambda m, args: seen.setdefault("x", args[0]))
    engines["int8"].encode_image_batch(images[:B])
    hook.remove()
    x = seen["x"].float()
    kernel, bias = attn.in_proj_kernel.detach(), attn.in_proj_bias.detach()
    few = x[:INT8_CPU_IMAGES]
    card = quant.int8_dot(few, kernel, bias)
    cpu = quant.int8_dot(few.cpu(), kernel.cpu(), bias.cpu())
    codes = torch.equal(quant._quantize_rows(few.reshape(-1, x.shape[-1]))[0].cpu(),
                        quant._quantize_rows(few.cpu().reshape(-1, x.shape[-1]))[0])
    ulps = int((card.cpu().view(torch.int32).long() - cpu.view(torch.int32).long()).abs().max())
    check(codes and ulps <= 1, f"int8_dot on the card against the CPU: codes equal {codes}, "
                               f"{ulps} ulps")
    x2 = x.reshape(-1, x.shape[-1])
    k_bf = kernel.to(torch.bfloat16)
    dot_ms = time_ms(lambda: quant.int8_dot(x2, kernel, bias), 20)
    bf16_ms = time_ms(lambda: torch.mm(x2.to(torch.bfloat16), k_bf,
                                       out_dtype=torch.float32) + bias, 20)
    del engines["none"]
    tp = EmbedEngine(ModelConfig("ViT-B-32", quant="int8"), seed=seed,
                     mesh=create_mesh(1, 2, devices=[dev] * 2))
    split = _int8_split(engines["int8"], tp, images, texts)
    del tp
    emit({"phase": "int8_towers", "model": "ViT-B-32", "quant": "int8", "batch_size": B,
          "images": INT8_IMAGES, "chunks": INT8_CHUNKS,
          **{f"{q}_{k}": out[q][k] for q in ("int8", "none")
             for k in ("images_per_s", "chunks_per_s", "image_s", "chunk_s")},
          "max_abs_gap_to_bf16": gap, "min_cosine_to_bf16": cos, "launches": launches,
          "int8_dot_vs_cpu": {"shape": [few.shape[0] * few.shape[1], x2.shape[1],
                                        kernel.shape[1]],
                              "codes_equal": codes, "max_ulps": ulps},
          "in_proj_ms": {"int8_dot": dot_ms, "bf16_mm": bf16_ms}, "split_1x2": split})
    return launches["int8"], split["mesh"]["launches"]


def profile_window(fn, top: int = 8) -> dict:
    """One call of ``fn`` under torch.profiler (CUPTI): wall time, device
    busy time (the sum of the device-side events: kernels and copies) and
    the events that took most."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3
    kernels = sorted(((e.key, e.self_device_time_total / 1e3, e.count)
                      for e in prof.key_averages()
                      if e.device_type == torch.autograd.DeviceType.CUDA
                      and e.self_device_time_total > 0),
                     key=lambda x: -x[1])
    busy = sum(ms for _, ms, _ in kernels)
    return {"wall_ms": wall, "device_busy_ms": busy, "idle_share": 1.0 - busy / wall,
            "top_kernels": [{"name": n[:90], "ms": ms, "count": c} for n, ms, c in kernels[:top]]}


def phase_profile(engine, images, texts) -> None:
    """Where one batch's time goes (profiler overhead included in wall)."""
    from tpualign_torch.tokenizer import ClipTokenizer

    long_texts = [t for t in texts if len(t) > 60][:engine.batch_size]
    t0 = time.perf_counter()
    ClipTokenizer()(texts)  # a cold tokenizer: no word cache
    tok_s = time.perf_counter() - t0
    emit({"phase": "profile",
          "tokenize_cold_s_per_1k_texts": tok_s / len(texts) * 1e3,
          "image_batch": profile_window(lambda: engine.encode_image_batch(images[:engine.batch_size])),
          "text_batch": profile_window(lambda: engine.encode_text_batch(long_texts))})


# the serve phase's store (vanilla_clip): 1,000 manuals x 125 pages, 8
# chunks per page, 20,000 stored images on distinct pages, 5 weak
# alignments per image
SERVE_MANUALS, SERVE_PAGES, SERVE_CHUNKS_PER_PAGE = 1000, 125, 8
SERVE_IMAGES, SERVE_ALIGNS = 20_000, 5
SERVE_CLIENTS, SERVE_REQUESTS = 8, 32
SERVE_RECALL_QUERIES = 1024
SERVE_KINDS = ("search_text", "search_image", "search_image_bytes", "search_image_rerank",
               "stats", "healthz")
SERVE_TEXTS = ["replace the oil filter", "torque the drain bolt to 25 Nm", "check the pump seal",
               "vervang de pakking", "draai de bout los", "zie figuur 3",
               "hydraulic hose routing", "valve clearance check"]


def _serve_store(root, dev, seed):
    """Writes the serve phase's store with the port's EmbeddingStore. Rows
    are seeded unit vectors around a topic per page (the tower is not run
    on 1M chunks): chunks and images of a page share its topic."""
    from tpualign_torch.store import EmbeddingStore

    gen = torch.Generator(device=dev).manual_seed(seed + 1)
    n_pages = SERVE_MANUALS * SERVE_PAGES
    d = 512
    topics = torch.randn(n_pages, d, generator=gen, device=dev)
    page_of_chunk = torch.arange(n_pages, device=dev).repeat_interleave(SERVE_CHUNKS_PER_PAGE)
    chunk = topics[page_of_chunk] + 1.5 * torch.randn(len(page_of_chunk), d, generator=gen,
                                                       device=dev)
    chunk = (chunk / chunk.norm(dim=1, keepdim=True)).cpu().numpy()
    rng = np.random.default_rng(seed)
    img_pages = np.sort(rng.choice(n_pages, SERVE_IMAGES, replace=False))
    img = topics[torch.from_numpy(img_pages).to(dev)]
    img = img + 1.5 * torch.randn(img.shape, generator=gen, device=dev)
    img = (img / img.norm(dim=1, keepdim=True)).cpu().numpy()

    def where(page):
        return f"manual-{page // SERVE_PAGES:04d}", int(page % SERVE_PAGES)

    chunk_recs = []
    for page in range(n_pages):
        manual, pg = where(page)
        for c in range(SERVE_CHUNKS_PER_PAGE):
            chunk_recs.append({"chunk_id": f"{manual}-p{pg:03d}-c{c}", "manual_id": manual,
                               "page": pg, "text": f"step {c} on page {pg} of {manual}"})
    img_recs, aligns = [], []
    for i, page in enumerate(img_pages):
        manual, pg = where(int(page))
        img_recs.append({"image_id": f"img{i:05d}", "manual_id": manual, "page": pg,
                         "caption": f"figure {i}", "filename": None})
        for c in rng.choice(SERVE_CHUNKS_PER_PAGE, SERVE_ALIGNS, replace=False):
            aligns.append((f"img{i:05d}", f"{manual}-p{pg:03d}-c{c}", float(rng.random()),
                           "positional"))
    store = EmbeddingStore(root, embed_dim=d)
    store.setup(["vanilla_clip"])
    store.insert_chunks("vanilla_clip", chunk_recs, chunk)
    store.insert_images("vanilla_clip", img_recs, img)
    store.insert_alignments("vanilla_clip", aligns)
    store.save(["vanilla_clip"])
    return img_recs


def _png(rng, w=320, h=240) -> bytes:
    import io

    from PIL import Image

    buf = io.BytesIO()
    Image.fromarray(rng.integers(0, 256, (h, w, 3), dtype=np.uint8)).save(buf, format="PNG")
    return buf.getvalue()


class _Recorder:
    """Wraps an encoder and keeps every row it returned, by input, so that
    each answer can be held against the embedding the service used."""

    def __init__(self, fn):
        self.fn = fn
        self.seen = {}
        self.lock = threading.Lock()

    def __call__(self, items):
        out = self.fn(items)
        with self.lock:
            for item, row in zip(items, out):
                self.seen.setdefault(item, []).append(np.array(row))
        return out


def _rows(index):
    """A one-device exact index's corpus, keys and scales (None at fp32):
    its one shard."""
    scales = index._corpus_scales
    return (index._corpus.parts[0], index._keys.parts[0],
            None if scales is None else scales.parts[0])


def _plain_refined(index, emb, keys, k=10):
    """The plain path of a refined quantized search: the plain K3 version
    over the index's codes for k*refine candidates, then the exact host
    rescore. Returns host (vals, idx) as ``index.search`` does."""
    from tpualign_torch.ops.sim_topk import masked_sim_topk_reference
    from tpualign_torch.parallel.retrieval import NEG_INF, _refine_rescore

    kf = min(k * index.refine, index.n)
    q = torch.from_numpy(np.ascontiguousarray(emb, np.float32)).to(index.device)
    qk = torch.from_numpy(np.asarray(keys, np.int32)).to(index.device)
    corpus, ck, scales = _rows(index)
    _, idx = _in_slabs(lambda a, b: masked_sim_topk_reference(
        a, b, corpus, ck, kf, corpus_scales=scales, int8_mxu=True), q, qk)
    idx = idx.cpu().numpy().astype(np.int64)
    idx = np.where(idx >= index.n, -1, idx)
    vals = np.where(idx >= 0, 0.0, NEG_INF).astype(np.float32)
    return _refine_rescore(np.asarray(emb, np.float32), vals, idx, index._refine_corpus, k)


def _plain_refined_ivf(index, emb, keys, k=10, n_probes=None):
    """The plain path of a refined IVF search: the index's probes and union,
    the plain K4 version over its layout for k*refine candidates, the
    packed rows mapped to corpus ids, then the exact host rescore."""
    from tpualign_torch.ops.ivf_topk import ivf_probe_topk_reference
    from tpualign_torch.parallel.ivf import _probe, _union
    from tpualign_torch.parallel.retrieval import NEG_INF, _refine_rescore

    kf = min(k * max(1, index.refine), index.n)
    q = torch.from_numpy(np.ascontiguousarray(emb, np.float32)).to(index.device)
    qk = torch.from_numpy(np.asarray(keys, np.int32)).to(index.device)
    probe = _probe(q, qk, index.centroids, n_probes or index.n_probes, index.n_lists)
    uids = _union(probe, index.n_lists, index.spill_blocks)
    _, pidx = _k4_slabs(lambda a, b, c: ivf_probe_topk_reference(
        a, b, c, uids, index._emb, index._keys, kf, index.capacity, index.n_lists,
        packed_scales=index._scales, int8_mxu=index.int8_mxu), q, qk, probe)
    empty = pidx >= 2**30
    idx = index._ids[pidx.clamp(max=len(index._ids) - 1).long()].long()
    idx = torch.where(empty, -1, idx).cpu().numpy()
    vals = np.where(idx >= 0, 0.0, NEG_INF).astype(np.float32)
    return _refine_rescore(np.asarray(emb, np.float32), vals, idx, index._refine_corpus, k)


def _pairs(vals, idx, chunk_ids):
    """(chunk_id, score) rows, as the service formats its winners."""
    return [[(chunk_ids[j], float(v)) for v, j in zip(vr, ir) if j >= 0]
            for vr, ir in zip(vals, idx)]


def _as_pairs(rows):
    return [[(h["chunk_id"], h["score"]) for h in row] for row in rows]


def _client(port, thread, images, pngs, out, errors, count=None):
    """One client thread: ``count`` requests on one keep-alive connection,
    cycling through SERVE_KINDS from its own offset."""
    import base64
    import http.client

    rng = np.random.default_rng(1000 + thread)
    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=120)
    try:
        for j in range(SERVE_REQUESTS if count is None else count):
            kind = SERVE_KINDS[(thread + j) % len(SERVE_KINDS)]
            body = None
            if kind == "search_text":
                start = int(rng.integers(0, len(SERVE_TEXTS)))
                body = {"texts": [SERVE_TEXTS[(start + t) % len(SERVE_TEXTS)] for t in range(4)],
                        "k": 10, "global": True}
            elif kind.startswith("search_image") and kind != "search_image_bytes":
                body = {"image_ids": [images[int(i)]["image_id"]
                                      for i in rng.integers(0, len(images), 2)], "k": 10}
                if kind == "search_image_rerank":
                    body["rerank"] = 0.3
            elif kind == "search_image_bytes":
                body = {"images_b64": [base64.b64encode(pngs[j % len(pngs)]).decode()], "k": 10}
            t0 = time.perf_counter()
            if body is None:
                conn.request("GET", "/" + kind)
            else:
                path = "/search_image" if kind == "search_image_rerank" else "/" + kind
                conn.request("POST", path, json.dumps(body),
                             {"Content-Type": "application/json"})
            resp = conn.getresponse()
            payload = json.loads(resp.read())
            out.append({"kind": kind, "status": resp.status, "s": time.perf_counter() - t0,
                        "request": body, "response": payload,
                        "png": j % len(pngs) if kind == "search_image_bytes" else None})
    except Exception as e:  # handed to the phase, which fails on it
        errors.append(repr(e))
    finally:
        conn.close()


def _load(port, image_ids, pngs, clients, count, conn):
    """The load: ``clients`` threads of _client, ``count`` requests each,
    started together; sends back (answers, errors, wall seconds)."""
    images = [{"image_id": i} for i in image_ids]
    results, errors = [], []
    clients = [threading.Thread(target=_client,
                                args=(port, t, images, pngs, results, errors, count))
               for t in range(clients)]
    t0 = time.perf_counter()
    for c in clients:
        c.start()
    for c in clients:
        c.join()
    conn.send((results, errors, time.perf_counter() - t0))
    conn.close()


def _pct(xs, p):
    xs = sorted(xs)
    return xs[min(len(xs) - 1, int(p * len(xs)))] * 1e3


def _drive(service, images, pngs, counters, nagle: bool = False) -> dict:
    """Serves ``service`` over HTTP: a warm-up request of each kind, then
    SERVE_CLIENTS clients (in a process of their own, so that the server's
    process and its interpreter lock serve the requests alone) with
    ``counters`` (functions with a ``launches`` count) set to 0 just before
    and read just after, /stats, and a serial pass from one client (again
    with Nagle's algorithm on, as tpualign's server has it, with
    ``nagle``)."""
    import urllib.request

    from tpualign_torch.serving.server import _ServiceBox, serve_schemas

    httpd = serve_schemas({"vanilla_clip": _ServiceBox(service)}, "vanilla_clip",
                          "127.0.0.1", 0)
    server = threading.Thread(target=httpd.serve_forever, daemon=True)
    server.start()
    port = httpd.server_address[1]
    ids = [im["image_id"] for im in images]
    out = {"serial": [], "nagle": []}
    try:
        warm = []
        _client(port, 0, images, pngs, warm, [], count=len(SERVE_KINDS))
        check(all(r["status"] == 200 for r in warm), f"warm-up: {warm[0]['response']}")
        torch.cuda.synchronize()
        for fn in counters:
            fn.launches = 0
        ctx = multiprocessing.get_context("spawn")
        recv, send = ctx.Pipe(duplex=False)
        load = ctx.Process(target=_load, args=(port, ids, pngs, SERVE_CLIENTS, SERVE_REQUESTS,
                                               send))
        load.start()
        check(recv.poll(600), "the clients' process sent no answers within 600 s")
        results, errors, wall = recv.recv()
        load.join()
        torch.cuda.synchronize()
        out["launches"] = {fn.__name__: fn.launches for fn in counters}
        out["stats"] = json.loads(urllib.request.urlopen(f"http://127.0.0.1:{port}/stats",
                                                         timeout=60).read())
        _client(port, 0, images, pngs, out["serial"], [], count=4 * len(SERVE_KINDS))
        if nagle:
            httpd.RequestHandlerClass.disable_nagle_algorithm = False
            _client(port, 0, images, pngs, out["nagle"], [], count=4 * len(SERVE_KINDS))
            httpd.RequestHandlerClass.disable_nagle_algorithm = True
    finally:
        httpd.shutdown()
        httpd.server_close()
        server.join()
    check(not errors, f"client errors: {errors[:3]}")
    check(len(results) == SERVE_CLIENTS * SERVE_REQUESTS, f"{len(results)} answers")
    bad = [r for r in results + out["serial"] + out["nagle"] if r["status"] != 200]
    check(not bad, f"{len(bad)} requests failed, e.g. {bad[:1]}")
    out.update(results=results, warm=warm, wall=wall)
    out["endpoints"] = {}
    for kind in SERVE_KINDS:
        lat = [r["s"] for r in results if r["kind"] == kind]
        out["endpoints"][kind] = {"requests": len(lat), "p50_ms": _pct(lat, 0.5),
                                  "p99_ms": _pct(lat, 0.99), "qps": len(lat) / wall}
    out["serial_p50_ms"] = {name: {kind: _pct([r["s"] for r in rs if r["kind"] == kind], 0.5)
                                   for kind in SERVE_KINDS}
                            for name, rs in (("nodelay", out["serial"]), ("nagle", out["nagle"]))
                            if rs}
    return out


def _check_answers(run, service, images, pngs, text_enc, image_enc, plain_refined) -> int:
    """Every search answer of ``run`` against the plain path, all rows in
    one batch: ``plain_refined(index, rows, keys)`` gives host (vals, idx)
    as ``index.search`` does. Returns the number of answers checked."""
    from tpualign_torch.parallel.retrieval import WILDCARD_KEY, encode_keys
    from tpualign_torch.weaksup.rerank import rerank_with_weak_scores

    index = service.index
    img_emb = service._image_embs
    by_id = {im["image_id"]: (i, im) for i, im in enumerate(images)}
    row_of, rows, keys = {}, [], []
    for tag, seen in (("text", text_enc.seen), ("png", image_enc.seen)):
        for item, embs in seen.items():
            for e_no, e in enumerate(embs):
                row_of[(tag, item, e_no)] = len(rows)
                rows.append(e)
                keys.append(WILDCARD_KEY)
    answers = run["results"] + run["warm"] + run["serial"] + run["nagle"]
    asked = {i for r in answers if r["kind"].startswith("search_image")
             and r["kind"] != "search_image_bytes" for i in r["request"]["image_ids"]}
    for image_id in sorted(asked):
        i, im = by_id[image_id]
        row_of[("img", image_id)] = len(rows)
        rows.append(img_emb[i])
        keys.append(encode_keys([im["manual_id"]], [im["page"]], dict(index.vocab))[0][0])
    pv, pi = plain_refined(index, np.stack(rows), keys)

    def plain(*tags, rerank=None):
        sel = [row_of[t] for t in tags]
        v, i = pv[sel], pi[sel]
        if rerank is not None:
            v, i = rerank_with_weak_scores(v, i, [t[1] for t in tags], service.chunk_ids,
                                           service.weak_lookup, alpha=rerank)
        return _pairs(v, i, service.chunk_ids)

    checked = 0
    for r in answers:
        kind, req, got = r["kind"], r["request"], r["response"]
        if kind in ("stats", "healthz"):
            check(got.get("status") == "ok", f"/{kind}: {got}")
            continue
        got = _as_pairs(got["results"])
        if kind == "search_text":
            for text, ans in zip(req["texts"], got):
                cands = [plain(("text", text, e))[0] for e in range(len(text_enc.seen[text]))]
                check(ans in cands, f"/search_text {text!r}: differs from the plain path")
        elif kind == "search_image_bytes":
            blob = pngs[r["png"]]
            cands = [plain(("png", blob, e))[0] for e in range(len(image_enc.seen[blob]))]
            check(got[0] in cands, "/search_image_bytes differs from the plain path")
        else:
            want = plain(*[("img", i) for i in req["image_ids"]], rerank=req.get("rerank"))
            check(got == want, f"/search_image {req['image_ids']}: differs from the plain path")
        checked += 1
    return checked


def _beside(fn, *args):
    """``fn(*args)`` on a thread of its own; ``.result()`` of the returned
    future joins it. For calls that wait on a child process: on a host slow
    to start one (a 5-step ``train`` process took 42-45 s), their starts
    overlap the caller's work or each other."""
    from concurrent.futures import ThreadPoolExecutor

    pool = ThreadPoolExecutor(1)
    future = pool.submit(fn, *args)
    pool.shutdown(wait=False)
    return future


def _query_cli(env, image_id, service, dev):
    """``python -m tpualign_torch query --image-id`` as a subprocess; its ids
    must be the service's. Returns its wall seconds."""
    import os

    t0, spawned = time.perf_counter(), time.time()
    cli = subprocess.run([sys.executable, "-c", CLI, "query", "--image-id",
                          image_id, "--device", dev.type], capture_output=True, text=True,
                         timeout=600, env=dict(os.environ, **env))
    secs = time.perf_counter() - t0
    child_done("query", spawned, cli.stderr)
    check(cli.returncode == 0, f"query --image-id exited {cli.returncode}: {cli.stderr[-2000:]}")
    check("no prebuilt" not in cli.stdout, f"query did not use the artifact: {cli.stdout[:200]}")
    cli_ids = [line.split()[1] for line in cli.stdout.splitlines()[1:] if line.strip()]
    want_ids = [h["chunk_id"] for h in service.search_images([image_id], k=10)[0]]
    check(cli_ids == want_ids, f"query --image-id printed {cli_ids}, the service {want_ids}")
    return secs


def phase_serve(dev, seed, root, checkpoint, precisions=("int8", "int4", "int2"), ivf=True):
    """The serving path: the port's store, build_service + serve_schemas at
    int8 with refine 4 and ViT-B-32 towers loaded from the checkpoint
    (``/stats`` reports it), eight clients, every answer held against the
    plain path; then the index rebuilt standalone at each of
    ``precisions`` (the four-card run: int8 alone, the one-card run checks
    the int4 and int2 rungs), recall against exact fp32, and the ``query
    --image-id`` CLI; with ``ivf``, serve_ivf's ``index`` process beside
    the rebuilds. Returns the launches, and what serve_ivf reuses."""
    from tpualign_torch.config import load_config
    from tpualign_torch.ops.attention import fused_mha
    from tpualign_torch.ops.sim_topk import masked_sim_topk, masked_sim_topk_quant
    from tpualign_torch.parallel.retrieval import (
        WILDCARD_KEY, _refine_rescore, build_index, encode_keys)
    from tpualign_torch.serving.server import (
        build_service, index_kwargs, make_engine, make_image_bytes_encoder)
    from tpualign_torch.store import EmbeddingStore

    t0 = time.perf_counter()
    images = _serve_store(root, dev, seed)
    store_s = time.perf_counter() - t0
    emit({"phase": "serve_store", "store_write_s": store_s,
          "chunks": SERVE_MANUALS * SERVE_PAGES * SERVE_CHUNKS_PER_PAGE,
          "images": SERVE_IMAGES, "alignments": SERVE_IMAGES * SERVE_ALIGNS})

    config = load_config({"STORE_DIR": root, "RETRIEVAL_PRECISION": "int8",
                          "RETRIEVAL_REFINE": "4", "CLIP_MODEL": "ViT-B-32",
                          "SEED": str(seed), "CLIP_CHECKPOINT": checkpoint})
    t0 = time.perf_counter()
    engine = make_engine(config, dev)
    text_enc = _Recorder(engine.encode_text_batch)
    image_enc = _Recorder(make_image_bytes_encoder(engine))
    service = build_service(config, "vanilla_clip", encoder=text_enc, image_encoder=image_enc,
                            device=dev)
    build_s = time.perf_counter() - t0
    index = service.index
    rng = np.random.default_rng(seed)
    pngs = [_png(rng) for _ in range(4)]
    run = _drive(service, images, pngs, (fused_mha, masked_sim_topk, masked_sim_topk_quant),
                 nagle=True)
    launches = run["launches"]
    checked = _check_answers(run, service, images, pngs, text_enc, image_enc, _plain_refined)
    check(launches["masked_sim_topk_quant"] > 0, "K3 was not launched while serving")
    check(launches["fused_mha"] > 0, "K1 was not launched while serving")
    model = {"name": "ViT-B-32", "quant": "none", "checkpoint": checkpoint}
    check(run["stats"].get("model") == model, f"/stats reports the model {run['stats']}")

    # the refine share of one coalesced-size search (8 queries)
    img_emb = service._image_embs
    q8 = img_emb[:8]
    qk8 = np.full(8, WILDCARD_KEY, np.int32)
    first = refine = 0.0
    for _ in range(20):
        t0 = time.perf_counter()
        v, i = index._search_encoded_raw(q8, qk8, 40, skip_vals=True)
        t1 = time.perf_counter()
        _refine_rescore(q8, v, i, index._refine_corpus, 10)
        t2 = time.perf_counter()
        first, refine = first + t1 - t0, refine + t2 - t1

    # where one request's time goes (direct calls, uncached texts)
    profiles = _profiles(service, images, pngs)

    # K3 at the shapes serving gives it, k * refine candidates: the
    # /search_image profile's two keyed image queries, and one wildcard
    # /search_text query
    two = [images[1], images[2]]
    qv = torch.from_numpy(img_emb[[service._images[im["image_id"]] for im in two]]).to(dev)
    qk = torch.from_numpy(np.asarray(encode_keys(
        [im["manual_id"] for im in two], [im["page"] for im in two], dict(index.vocab))[0],
        np.int32)).to(dev)
    text_q = torch.from_numpy(engine.encode_text_batch(SERVE_TEXTS[:1])).to(dev)
    wild = torch.full((1,), WILDCARD_KEY, dtype=torch.int32, device=dev)
    kf = 10 * index.refine
    k3_serving = [{"query": what, "variant": "int8", "Q": len(qs), "k": kf, "N": index.n,
                   "D": index.dim,
                   **_k3_measure(f"K3 at the serving shape ({what})", qs, keys,
                                 *_rows(index), True, kf)}
                  for what, qs, keys in (("search_image", qv, qk), ("search_text", text_q, wild))]

    # the int8 index again, standalone (its build time), and the int4/int2
    # rebuilds; keyed and global searches of each against the plain path
    store = EmbeddingStore(root)
    chunk_ids, chunk_emb = store.embedding_matrix("vanilla_clip", "text_chunks")
    manuals = store.column("vanilla_clip", "text_chunks", "manual_id")
    pages = store.column("vanilla_clip", "text_chunks", "page")
    sample = np.arange(0, SERVE_IMAGES, max(1, SERVE_IMAGES // 256))[:256]
    q_img = img_emb[sample]
    qk_keyed, _ = encode_keys([images[i]["manual_id"] for i in sample],
                              [images[i]["page"] for i in sample], dict(index.vocab))
    exact_index = build_index(chunk_emb, manuals, pages, device=dev)
    q_rec = img_emb[:SERVE_RECALL_QUERIES]
    _, exact = exact_index.search(q_rec, k=10, global_search=True)
    del exact_index
    rungs = {}
    cli = _beside(_query_cli, {"STORE_DIR": root, "RETRIEVAL_PRECISION": "int8",
                               "RETRIEVAL_REFINE": "4"}, images[7]["image_id"], service, dev)
    # serve_ivf's index process reads the store alone: it starts here too
    ivf_index = _beside(_ivf_index_cli, root, dev) if ivf else None
    for precision in precisions:
        kw = dict(index_kwargs(config, "vanilla_clip"), precision=precision)
        t0 = time.perf_counter()
        rung = build_index(chunk_emb, manuals, pages, device=dev, **kw)
        torch.cuda.synchronize()
        rung_s = time.perf_counter() - t0
        for what, keys in (("keyed", qk_keyed), ("global", np.full(len(sample), WILDCARD_KEY,
                                                                   np.int32))):
            got = _pairs(*rung.search_encoded(q_img, keys, 10), chunk_ids)
            check(got == _pairs(*_plain_refined(rung, q_img, keys), chunk_ids),
                  f"{precision} {what}: differs from the plain path")
        recall = _recall(rung, q_rec, exact)
        rungs[precision] = {"index_build_s": rung_s, "recall_at_10": recall,
                            "corpus_bytes": int(_rows(rung)[0].numel())}
        del rung

    cli_s = cli.result()

    emit({"phase": "serve", "model": "ViT-B-32", "stats_model": run["stats"]["model"],
          "precision": "int8", "refine": 4,
          "store_write_s": store_s, "service_build_s": build_s,
          "clients": SERVE_CLIENTS, "requests": len(run["results"]), "answers_checked": checked,
          "wall_s": run["wall"], "qps": len(run["results"]) / run["wall"],
          "endpoints": run["endpoints"], "serial_p50_ms": run["serial_p50_ms"],
          "profiles": profiles, "refine_share_q8": refine / (first + refine),
          "first_stage_ms_q8": first / 20 * 1e3, "refine_ms_q8": refine / 20 * 1e3,
          "coalescer": run["stats"].get("coalescer"),
          "encode_coalescer": run["stats"].get("encode_coalescer"),
          "query_cache": run["stats"].get("query_cache"),
          "refine_store": run["stats"].get("refine_store"),
          "rungs": rungs, "cli_query_s": cli_s, "k3_serving_shape": k3_serving,
          "launches": launches})
    return launches, k3_serving, {"engine": engine, "images": images, "pngs": pngs,
                                  "exact": exact, "chunk_emb": chunk_emb, "manuals": manuals,
                                  "pages": pages, "ivf_index": ivf_index}


def _profiles(service, images, pngs) -> dict:
    fresh = iter(range(10**6))
    return {
        "search_image_bytes": profile_window(lambda: service.search_image_bytes([pngs[0]], k=10)),
        "search_image": profile_window(lambda: service.search_images(
            [images[1]["image_id"], images[2]["image_id"]], k=10)),
        "search_text_uncached": profile_window(lambda: service.search_text(
            [f"{t} {next(fresh)}" for t in SERVE_TEXTS[:4]], k=10)),
    }


def _recall(index, q_rec, exact, **kw) -> dict:
    """recall@10 of ``index`` against the exact fp32 top-10, unrefined (the
    first stage alone) and refined."""
    from tpualign_torch.parallel.retrieval import WILDCARD_KEY

    wild = np.full(len(q_rec), WILDCARD_KEY, np.int32)
    _, unref = index._search_encoded_raw(q_rec, wild, 10, **kw)
    _, ref = index.search_encoded(q_rec, wild, 10, **kw)
    recall = {name: float(np.mean([len(set(a) & set(b)) / 10 for a, b in zip(got, exact)]))
              for name, got in (("unrefined", unref), ("refined", ref))}
    check(recall["refined"] >= recall["unrefined"], f"refine lowered recall@10 {recall}")
    return recall


def _ivf_env(root) -> dict:
    """serve_ivf's settings over the serve store: int8, refine 4, recall
    target 0.95, the artifact in the store's directory."""
    import os

    return {"STORE_DIR": root, "RETRIEVAL_INDEX": "ivf", "RETRIEVAL_PRECISION": "int8",
            "RETRIEVAL_REFINE": "4", "RETRIEVAL_RECALL_TARGET": "0.95",
            "IVF_CACHE": os.path.join(root, "vanilla_clip.ivf.npz")}


def _ivf_index_cli(root, dev):
    """``python -m tpualign_torch index`` under serve_ivf's settings as a
    subprocess. Returns it and its wall seconds."""
    import os

    t0, spawned = time.perf_counter(), time.time()
    cli = subprocess.run([sys.executable, "-c", CLI, "index", "--device", dev.type],
                         capture_output=True, text=True, timeout=900,
                         env=dict(os.environ, **_ivf_env(root)))
    child_done("index", spawned, cli.stderr)
    return cli, time.perf_counter() - t0


def phase_serve_ivf(dev, seed, root, shared):
    """RETRIEVAL_INDEX=ivf over the serve phase's store: ``python -m
    tpualign_torch index`` as a subprocess (int8, refine 4, recall target
    0.95), beside it the same build and calibration timed in this process
    (the same structure), build_service loading the artifact, the clients' mix with
    every answer against the plain path (plain K4, exact rescore), recall
    of each rung against exact fp32, and ``query --image-id`` through the
    artifact."""
    import os

    from tpualign_torch.config import load_config
    from tpualign_torch.ops.attention import fused_mha
    from tpualign_torch.ops.ivf_topk import ivf_probe_topk
    from tpualign_torch.ops.sim_topk import masked_sim_topk, masked_sim_topk_quant
    from tpualign_torch.parallel.ivf import IVFIndex, _probe, _union
    from tpualign_torch.parallel.retrieval import encode_keys
    from tpualign_torch.serving.server import build_service, make_image_bytes_encoder

    env = _ivf_env(root)
    cache = env["IVF_CACHE"]
    # the index process (started by phase_serve beside its rung rebuilds)
    # runs beside the same build and calibration in this process: their
    # times, and the same structure as the subprocess's artifact (k-means is
    # deterministic)
    started = shared["ivf_index"]
    chunk_emb, manuals, pages = shared["chunk_emb"], shared["manuals"], shared["pages"]
    t0 = time.perf_counter()
    again = IVFIndex(chunk_emb, manuals, pages, precision="int8", refine=4, device=dev)
    torch.cuda.synchronize()
    build_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    again.calibrate(0.95)
    calibrate_s = time.perf_counter() - t0
    cli, index_cli_s = started.result()
    check(cli.returncode == 0, f"index exited {cli.returncode}: {cli.stderr[-2000:]}")
    info = json.loads(cli.stdout.strip().splitlines()[-1])
    check(info["n_lists"] == 1000 and info["capacity"] <= 1536
          and info["calibrated_target"] == 0.95 and os.path.exists(cache),
          f"index printed {info}")
    art = np.load(cache)
    check(np.array_equal(again._ids.cpu().numpy(), art["pids"])
          and np.array_equal(again.centroids.cpu().numpy(), art["centroids"])
          and again.n_probes == info["n_probes"], "two builds of one store differ")
    del again, art

    config = load_config({**env, "CLIP_MODEL": "ViT-B-32", "SEED": str(seed)})
    engine, images, pngs = shared["engine"], shared["images"], shared["pngs"]
    text_enc = _Recorder(engine.encode_text_batch)
    image_enc = _Recorder(make_image_bytes_encoder(engine))
    t0 = time.perf_counter()
    service = build_service(config, "vanilla_clip", encoder=text_enc, image_encoder=image_enc,
                            device=dev)
    torch.cuda.synchronize()
    load_s = time.perf_counter() - t0
    index = service.index
    check(isinstance(index, IVFIndex) and service.stats()["ivf"]["n_probes"] == info["n_probes"],
          f"the service did not load the artifact: {service.stats().get('ivf')}")
    run = _drive(service, images, pngs,
                 (fused_mha, masked_sim_topk, masked_sim_topk_quant, ivf_probe_topk))
    launches = run["launches"]
    checked = _check_answers(run, service, images, pngs, text_enc, image_enc,
                             _plain_refined_ivf)
    check(launches["ivf_probe_topk"] > 0, "K4 was not launched while serving")
    check(launches["fused_mha"] > 0, "K1 was not launched while serving")
    profiles = _profiles(service, images, pngs)

    # K4 at the shape serving gives it: the /search_image profile's two
    # keyed image queries, k * refine candidates, the calibrated probes
    two = [images[1], images[2]]
    qv = torch.from_numpy(service._image_embs[[service._images[im["image_id"]] for im in two]])
    qk = np.asarray(encode_keys([im["manual_id"] for im in two], [im["page"] for im in two],
                                dict(index.vocab))[0], np.int32)
    qv, qk = qv.to(dev), torch.from_numpy(qk).to(dev)
    probe = _probe(qv, qk, index.centroids, index.n_probes, index.n_lists)
    kf = 10 * index.refine
    k4_serving = {"variant": "int8", "Q": 2, "k": kf, "N": index.n, "D": index.dim,
                  "n_lists": index.n_lists, "capacity": index.capacity,
                  "n_probes": index.n_probes, "spill_blocks": index.spill_blocks,
                  **_k4_measure("K4 at the serving shape", qv, qk, probe,
                                _union(probe, index.n_lists, index.spill_blocks), index._emb,
                                index._keys, index._scales, index.int8_mxu, kf,
                                index.capacity, index.n_lists)}

    # recall@10 of each rung against exact fp32, at its calibrated and the
    # default probe counts, unrefined and refined
    q_rec = service._image_embs[:SERVE_RECALL_QUERIES]
    rungs = {}
    cli = _beside(_query_cli, env, images[7]["image_id"], service, dev)
    for precision in ("int8", "int4", "int2"):
        t0 = time.perf_counter()
        rung = index if precision == "int8" else IVFIndex(
            chunk_emb, manuals, pages, precision=precision, refine=4, device=dev)
        rung_s = time.perf_counter() - t0
        default_probes = rung.n_lists // 8
        calibrated = rung.n_probes if precision == "int8" else rung.calibrate(0.95)
        rungs[precision] = {
            "index_build_s": None if precision == "int8" else rung_s,
            "n_probes_calibrated": calibrated, "n_probes_default": default_probes,
            "recall_at_10": {f"probes_{p}": _recall(rung, q_rec, shared["exact"], n_probes=p)
                             for p in sorted({calibrated, default_probes})},
            "memory_bytes": rung.memory_bytes}
        del rung
    cli_s = cli.result()
    stats = run["stats"]
    emit({"phase": "serve_ivf", "model": "ViT-B-32", "precision": "int8", "refine": 4,
          "ivf": stats.get("ivf"), "index_cli_s": index_cli_s, "build_s": build_s,
          "calibrate_s": calibrate_s, "service_load_s": load_s,
          "clients": SERVE_CLIENTS, "requests": len(run["results"]), "answers_checked": checked,
          "wall_s": run["wall"], "qps": len(run["results"]) / run["wall"],
          "endpoints": run["endpoints"], "serial_p50_ms": run["serial_p50_ms"],
          "profiles": profiles, "coalescer": stats.get("coalescer"),
          "query_cache": stats.get("query_cache"), "rungs": rungs, "cli_query_s": cli_s,
          "k4_serving_shape": k4_serving, "launches": launches})
    return launches, k4_serving


# the live corpus (phase live): rows added by embeddings and by text, the
# share removed, the auto-compaction threshold, /sync's delta
LIVE_ADD, LIVE_ADD_BATCH, LIVE_TEXT, LIVE_TEXT_BATCH = 12_000, 4_000, 128, 64
LIVE_ADD_PAGES = 40  # the stored images whose pages take the added rows
LIVE_REMOVE, LIVE_REMOVE_BATCHES, LIVE_AUTO_COMPACT = 0.25, 4, 0.2
LIVE_SYNC_NEW, LIVE_SYNC_GONE, LIVE_CHECK_IMAGES, LIVE_P50_REQUESTS = 4096, 1024, 64, 64


class _LiveRows:
    """The rows a live service should hold: every row it was ever given
    (fp32, host), its chunk id, manual and page, and which are alive, in
    the service's order (ascending id; compactions keep it)."""

    def __init__(self, emb, ids, manuals, pages):
        self.emb, self.ids = [emb], list(ids)
        self.manuals, self.pages = list(manuals), list(pages)
        self.order = list(range(len(ids)))  # live rows in the service's order

    def add(self, emb, ids, manuals, pages):
        base = len(self.ids)
        self.emb.append(np.asarray(emb, np.float32))
        self.ids += list(ids)
        self.manuals += list(manuals)
        self.pages += list(pages)
        self.order += range(base, base + len(ids))

    def remove(self, ids):
        gone = set(ids)
        self.order = [r for r in self.order if self.ids[r] not in gone]

    def rows(self):
        return np.concatenate(self.emb) if len(self.emb) > 1 else self.emb[0]


class _LiveTake:
    """The live rows' fp32 copy as a refine corpus (``take``/``len``)."""

    def __init__(self, rows, order):
        self.rows, self.order = rows, np.asarray(order, np.int64)

    def __len__(self):
        return len(self.order)

    def take(self, idx):
        return self.rows[self.order[np.asarray(idx, np.int64)]]


def _live_check(dev, live, services, images, img_emb, step, counters) -> dict:
    """The served answers against fresh indexes over the live rows: the
    exact int8 service's /search_image and global /search answers equal a
    fresh ``RetrievalIndex`` (int8, refine 4) over the live rows; the IVF
    service's equal the plain K4 version over its own layout, and its
    full-probe search equals a dense search over the live rows' int8
    dequantization with the same exact rescore (the union route's
    function at full probe). The references' kernel launches are taken
    back out of ``counters``: only the served requests count."""
    from tpualign_torch.ops.sim_topk import masked_sim_topk_reference
    from tpualign_torch.parallel.retrieval import (
        WILDCARD_KEY, RetrievalIndex, _refine_rescore, encode_keys)

    t0 = time.perf_counter()
    sel = np.arange(0, len(images), len(images) // LIVE_CHECK_IMAGES)[:LIVE_CHECK_IMAGES]
    q_img, q_glob = img_emb[sel], img_emb[sel[:8]]
    image_ids = [images[i]["image_id"] for i in sel]
    served = {name: (_as_pairs(_post(services[name + "_url"], "/search_image",
                                     {"image_ids": image_ids, "k": 10})["results"]),
                     _as_pairs(_post(services[name + "_url"], "/search",
                                     {"embeddings": q_glob.tolist(), "k": 10,
                                      "global": True})["results"]))
              for name in ("exact", "ivf")}
    torch.cuda.synchronize()
    saved = [fn.launches for fn in counters]
    rows, order = live.rows(), live.order
    ids = [live.ids[r] for r in order]
    fresh = RetrievalIndex(rows[order], [live.manuals[r] for r in order],
                           [live.pages[r] for r in order], precision="int8", refine=4,
                           device=dev)
    alive = {name: services[name].index.n - services[name].index.dead for name in ("exact", "ivf")}
    check(fresh.n == alive["exact"] == alive["ivf"], f"{step}: live rows {fresh.n}, {alive}")
    want_img = _pairs(*fresh.search(q_img, [images[i]["manual_id"] for i in sel],
                                    [images[i]["page"] for i in sel], k=10), ids)
    want_glob = _pairs(*fresh.search(q_glob, k=10, global_search=True), ids)
    # the live rows' int8 dequantization: the fresh index's per-row codes
    codes, _, scales = _rows(fresh)
    deq = codes.float() * scales[:, None]
    del fresh
    check(served["exact"] == (want_img, want_glob),
          f"{step}: the exact service differs from a fresh index over the live rows")
    svc = services["ivf"]
    index = svc.index
    keys = encode_keys([images[i]["manual_id"] for i in sel],
                       [images[i]["page"] for i in sel], dict(index.vocab))[0]
    check(served["ivf"][0] == _pairs(*_plain_refined_ivf(index, q_img, keys), svc.chunk_ids),
          f"{step}: the IVF service differs from the plain K4 version on its layout")
    # full probe: the service's index against a dense search of the live rows
    wild = np.full(len(q_glob), WILDCARD_KEY, np.int32)
    full = _pairs(*index.search_encoded(q_glob, wild, 10, n_probes=index.n_lists),
                  svc.chunk_ids)
    _, cand = masked_sim_topk_reference(
        torch.from_numpy(q_glob).to(dev), torch.from_numpy(wild).to(dev), deq,
        torch.zeros(deq.shape[0], dtype=torch.int32, device=dev), 10 * index.refine)
    del deq
    cand = cand.cpu().numpy().astype(np.int64)
    v, i = _refine_rescore(q_glob, np.zeros(cand.shape, np.float32), cand,
                           _LiveTake(rows, order), 10)
    check(full == _pairs(v, i, ids),
          f"{step}: the IVF index at full probe differs from the dense search")
    torch.cuda.synchronize()
    for fn, n in zip(counters, saved):
        fn.launches = n
    return {"check_s": time.perf_counter() - t0, "live_rows": len(order),
            "ivf_spill": index.spill, "ivf_spill_blocks": index.spill_blocks,
            "ivf_dead": index.dead, "exact_dead": services["exact"].index.dead,
            "exact_capacity": int(services["exact"].index._corpus.shape[0])}


def _post(base, path, payload):
    """POST a JSON body; the JSON answer."""
    import urllib.request

    req = urllib.request.Request(f"{base}{path}", json.dumps(payload).encode(),
                                 {"Content-Type": "application/json"})
    with urllib.request.urlopen(req, timeout=600) as r:
        return json.loads(r.read())


def _timed_post(base, path, payload):
    """``_post`` and its wall seconds, the request's encoding included."""
    t0 = time.perf_counter()
    out = _post(base, path, payload)
    return out, time.perf_counter() - t0


def _search_image_p50(base, images, rng) -> float:
    """p50 ms of LIVE_P50_REQUESTS serial /search_image requests of two
    random stored images."""
    lat = []
    for _ in range(LIVE_P50_REQUESTS):
        ids = [images[int(i)]["image_id"] for i in rng.integers(0, len(images), 2)]
        lat.append(_timed_post(base, "/search_image", {"image_ids": ids, "k": 10})[1])
    return _pct(lat, 0.5)


def _live_kernels(dev, services, images):
    """K3 and K4 at the /search_image shape (two keyed image queries, k *
    refine) over the current corpora, each against its plain version: the
    times and the corpus tiles read."""
    from tpualign_torch.parallel.ivf import _probe, _union
    from tpualign_torch.parallel.retrieval import encode_keys

    out = {}
    two = [images[1], images[2]]
    for name in ("exact", "ivf"):
        svc = services[name]
        index = svc.index
        qv = torch.from_numpy(svc._image_embs[[svc._images[im["image_id"]] for im in two]]).to(dev)
        qk = torch.from_numpy(np.asarray(encode_keys(
            [im["manual_id"] for im in two], [im["page"] for im in two], dict(index.vocab))[0],
            np.int32)).to(dev)
        kf = 10 * index.refine
        if name == "exact":
            r = _k3_measure("K3 over the live corpus", qv, qk, *_rows(index), True, kf)
        else:
            probe = _probe(qv, qk, index.centroids, index.n_probes, index.n_lists)
            r = _k4_measure("K4 over the live layout", qv, qk, probe,
                            _union(probe, index.n_lists, index.spill_blocks), index._emb,
                            index._keys, index._scales, index.int8_mxu, kf, index.capacity,
                            index.n_lists)
        out[name] = {k: r[k] for k in ("ms", "plain_ms", "bound_ms", "admitted_tiles", "tiles")
                     if k in r}
        out[name]["N"] = index.n
        if name == "ivf":
            out[name]["spill_blocks"] = index.spill_blocks
    return out


def phase_live(dev, seed, root, shared):
    """The live corpus on the serve phase's 1M-chunk store: the int8
    (refine 4) exact service and its IVF twin (the serve_ivf artifact),
    each behind HTTP with SERVE_AUTO_COMPACT=0.2. /add 12,000 rows by
    embeddings and 128 by text, /remove 25 % of the corpus (the fourth of
    four requests crosses the threshold and compacts), /remove 1 % more
    and /compact, then /sync from a store snapshot with 4,096 new chunks
    and 1,024 gone. After each step the served answers are held against
    fresh indexes over the live rows (:func:`_live_check`); /search_image
    p50 and the tiles K3 and K4 read, before and after; the kernels'
    launches across the mutations and checks."""
    import os

    from tpualign_torch.config import load_config
    from tpualign_torch.ops.attention import fused_mha
    from tpualign_torch.ops.ivf_topk import ivf_probe_topk
    from tpualign_torch.ops.sim_topk import masked_sim_topk, masked_sim_topk_quant
    from tpualign_torch.serving.server import _ServiceBox, build_service, serve_schemas

    env = {"STORE_DIR": root, "RETRIEVAL_PRECISION": "int8", "RETRIEVAL_REFINE": "4",
           "CLIP_MODEL": "ViT-B-32", "SEED": str(seed),
           "SERVE_AUTO_COMPACT": str(LIVE_AUTO_COMPACT)}
    engine, images = shared["engine"], shared["images"]
    text_enc = _Recorder(engine.encode_text_batch)
    snapshot = {}
    services, servers = {}, []
    t0 = time.perf_counter()
    for name, extra in (("exact", {}), ("ivf", {
            "RETRIEVAL_INDEX": "ivf", "RETRIEVAL_RECALL_TARGET": "0.95",
            "IVF_CACHE": os.path.join(root, "vanilla_clip.ivf.npz")})):
        svc = build_service(load_config({**env, **extra}), "vanilla_clip", encoder=text_enc,
                            device=dev)
        check(svc.auto_compact == LIVE_AUTO_COMPACT, f"SERVE_AUTO_COMPACT: {svc.auto_compact}")
        httpd = serve_schemas({"vanilla_clip": _ServiceBox(
            svc, fetch=lambda: snapshot["chunks"])}, "vanilla_clip", "127.0.0.1", 0,
            max_body_bytes=256 * 2**20)
        threading.Thread(target=httpd.serve_forever, daemon=True).start()
        servers.append(httpd)
        services[name] = svc
        services[name + "_url"] = f"http://127.0.0.1:{httpd.server_address[1]}"
    build_s = time.perf_counter() - t0
    check(type(services["ivf"].index).__name__ == "IVFIndex", "the IVF twin is not IVF")
    img_emb = services["exact"]._image_embs
    live = _LiveRows(shared["chunk_emb"], services["exact"].chunk_ids, shared["manuals"],
                     shared["pages"])
    rng = np.random.default_rng(seed + 11)
    steps, timings = {}, {}
    try:
        before = {name: _search_image_p50(services[name + "_url"], images, rng)
                  for name in ("exact", "ivf")}
        kernels_before = _live_kernels(dev, services, images)
        spill_blocks = services["ivf"].index.spill_blocks
        counters = (fused_mha, masked_sim_topk, masked_sim_topk_quant, ivf_probe_topk)
        torch.cuda.synchronize()
        for fn in counters:
            fn.launches = 0

        def both(path, payload):
            outs = {}
            for name in ("exact", "ivf"):
                out, secs = _timed_post(services[name + "_url"], path, payload)
                timings.setdefault(f"{name}{path}", []).append(secs)
                outs[name] = out
            return outs

        # /add by embeddings: rows near the pages of 40 stored images, so
        # that the keyed searches meet them and their IVF lists overflow
        # into the spill tail
        pick = rng.choice(len(images), LIVE_ADD_PAGES, replace=False)[
            rng.integers(0, LIVE_ADD_PAGES, LIVE_ADD)]
        noise = rng.normal(size=(LIVE_ADD, img_emb.shape[1])).astype(np.float32)
        new = img_emb[pick] + 0.05 * noise / np.sqrt(img_emb.shape[1])
        new /= np.linalg.norm(new, axis=1, keepdims=True)
        new_ids = [f"live-{i:05d}" for i in range(LIVE_ADD)]
        new_man = [images[i]["manual_id"] for i in pick]
        new_pg = [images[i]["page"] for i in pick]
        for s0 in range(0, LIVE_ADD, LIVE_ADD_BATCH):
            sl = slice(s0, s0 + LIVE_ADD_BATCH)
            outs = both("/add", {"chunk_ids": new_ids[sl], "manuals": new_man[sl],
                                 "pages": new_pg[sl], "embeddings": new[sl].tolist()})
            check(all(o["added"] == LIVE_ADD_BATCH for o in outs.values()), f"/add: {outs}")
        live.add(new, new_ids, new_man, new_pg)
        check(services["ivf"].index.spill_blocks > spill_blocks,
              f"the IVF spill tail did not grow: {spill_blocks} blocks")
        # the grown corpora: /search_image p50, and K3 and K4 at its shape
        # (their comparisons with the plain versions are not counted)
        grown = {name: _search_image_p50(services[name + "_url"], images, rng)
                 for name in ("exact", "ivf")}
        torch.cuda.synchronize()
        saved = [fn.launches for fn in counters]
        kernels_grown = _live_kernels(dev, services, images)
        torch.cuda.synchronize()
        for fn, n in zip(counters, saved):
            fn.launches = n
        # /add by text: the daemon's text tower embeds them
        pick = rng.integers(0, len(images), LIVE_TEXT)
        texts = [f"{SERVE_TEXTS[i % len(SERVE_TEXTS)]} (live {i})" for i in range(LIVE_TEXT)]
        t_ids = [f"live-text-{i:03d}" for i in range(LIVE_TEXT)]
        t_man = [images[i]["manual_id"] for i in pick]
        t_pg = [images[i]["page"] for i in pick]
        for s0 in range(0, LIVE_TEXT, LIVE_TEXT_BATCH):
            sl = slice(s0, s0 + LIVE_TEXT_BATCH)
            both("/add", {"chunk_ids": t_ids[sl], "manuals": t_man[sl], "pages": t_pg[sl],
                          "texts": texts[sl]})
        t_emb = np.stack([text_enc.seen[t][0] for t in texts])
        check(all(len(text_enc.seen[t]) == 2 and np.array_equal(*text_enc.seen[t])
                  for t in texts), "the two services' text embeddings differ")
        live.add(t_emb, t_ids, t_man, t_pg)
        steps["added"] = _live_check(dev, live, services, images, img_emb, "after /add",
                                       counters)

        # /remove 25 % of the corpus in four requests; the fourth crosses
        # SERVE_AUTO_COMPACT and compacts
        n_now = len(live.order)
        victims = [live.ids[r] for r in rng.choice(live.order, int(LIVE_REMOVE * n_now),
                                                   replace=False)]
        parts = np.array_split(np.asarray(victims, dtype=object), LIVE_REMOVE_BATCHES)
        for j, part in enumerate(parts):
            outs = both("/remove", {"chunk_ids": list(part)})
            live.remove(part)
            last = j == len(parts) - 1
            check(all(("auto_compacted" in o) == last for o in outs.values()),
                  f"/remove {j}: auto-compaction {outs}")
            if j == len(parts) - 2:
                check(services["exact"].index.dead == services["ivf"].index.dead
                      == sum(len(p) for p in parts[:-1]), "tombstones")
                steps["tombstoned"] = _live_check(dev, live, services, images, img_emb,
                                                  "with tombstones", counters)
        steps["auto_compacted"] = _live_check(dev, live, services, images, img_emb,
                                              "after the auto-compaction", counters)
        # /remove 1 % more, then /compact
        victims = [live.ids[r] for r in rng.choice(live.order, len(live.order) // 100,
                                                   replace=False)]
        both("/remove", {"chunk_ids": victims})
        live.remove(victims)
        outs = both("/compact", {})
        check(all(o["compacted"] == len(victims) for o in outs.values()), f"/compact: {outs}")
        steps["compacted"] = _live_check(dev, live, services, images, img_emb,
                                         "after /compact", counters)

        # /sync from a store snapshot: 4,096 new chunks, 1,024 gone
        gone = set(live.ids[r] for r in rng.choice(live.order, LIVE_SYNC_GONE, replace=False))
        pick = rng.integers(0, len(images), LIVE_SYNC_NEW)
        s_new = img_emb[pick] + rng.normal(size=(LIVE_SYNC_NEW, img_emb.shape[1])).astype(
            np.float32) * 0.05
        s_new /= np.linalg.norm(s_new, axis=1, keepdims=True)
        s_ids = [f"sync-{i:04d}" for i in range(LIVE_SYNC_NEW)]
        s_man = [images[i]["manual_id"] for i in pick]
        s_pg = [images[i]["page"] for i in pick]
        keep = [r for r in live.order if live.ids[r] not in gone]
        rows = live.rows()
        snapshot["chunks"] = ([live.ids[r] for r in keep] + s_ids,
                              [live.manuals[r] for r in keep] + s_man,
                              [live.pages[r] for r in keep] + s_pg,
                              np.concatenate([rows[keep], s_new]))
        outs = both("/sync", {})
        check(all(o["synced"] and o["added"] == LIVE_SYNC_NEW and o["removed"] == LIVE_SYNC_GONE
                  for o in outs.values()), f"/sync: {outs}")
        live.remove(gone)
        live.add(s_new, s_ids, s_man, s_pg)
        steps["synced"] = _live_check(dev, live, services, images, img_emb, "after /sync",
                                      counters)
        torch.cuda.synchronize()
        launches = {fn.__name__: fn.launches for fn in counters}
        after = {name: _search_image_p50(services[name + "_url"], images, rng)
                 for name in ("exact", "ivf")}
        kernels_after = _live_kernels(dev, services, images)
        stats = {name: services[name].stats() for name in ("exact", "ivf")}
    finally:
        for httpd in servers:
            httpd.shutdown()
            httpd.server_close()
    for name in ("fused_mha", "masked_sim_topk_quant", "ivf_probe_topk"):
        check(launches[name] > 0, f"{name} was not launched on the live path")
    emit({"phase": "live", "model": "ViT-B-32", "precision": "int8", "refine": 4,
          "auto_compact": LIVE_AUTO_COMPACT, "services_build_s": build_s,
          "add_rows": LIVE_ADD, "add_text_rows": LIVE_TEXT,
          "removed_share": LIVE_REMOVE, "sync_new": LIVE_SYNC_NEW, "sync_gone": LIVE_SYNC_GONE,
          "timings_s": timings,
          "add_ms_per_1k_rows": {
              name: {"embeddings": 1e3 * sum(timings[f"{name}/add"][:LIVE_ADD // LIVE_ADD_BATCH])
                     / (LIVE_ADD / 1000),
                     "text": 1e3 * sum(timings[f"{name}/add"][LIVE_ADD // LIVE_ADD_BATCH:])
                     / (LIVE_TEXT / 1000)} for name in ("exact", "ivf")},
          "search_image_p50_ms": {"before": before, "after_adds": grown, "after": after},
          "kernels_at_search_image": {"before": kernels_before, "after_adds": kernels_grown,
                                      "after": kernels_after},
          "steps": steps, "launches": launches,
          "stats": {name: {k: st.get(k) for k in ("corpus_size", "dead_rows", "ivf")}
                    for name, st in stats.items()}})
    return launches


# K5 and the device image feed
K5_SHAPE = (256, 224, 224, 3)          # one device-feed batch at ViT-B-32
FEED_IMAGES, FEED_BUCKET = 1536, 256   # files of the device_feed phase; IMAGE_PREPROCESS_BUCKET
# 256 manuals and 1,536 feed files (cut from 512 and 2,048) keep the script
# inside its time limit on hosts slow to start a process
PIPE_MANUALS, PIPE_PAGES, PIPE_CHUNKS_PER_PAGE = 256, 8, 8
PIPE_EXCLUDE = "check"  # the operator's exclusion list for stage 2
PIPE_RUN_MANUALS = 32  # the one-command run's subset


def phase_k5(dev, gen):
    """K5 ``normalize_u8`` against its plain version, bit for bit, at one
    device-feed batch (and on an unaligned view with a tail)."""
    from tpualign_torch.ops.normalize import normalize_u8, normalize_u8_reference

    x = torch.randint(0, 256, K5_SHAPE, generator=gen, device=dev, dtype=torch.uint8)
    got, want = normalize_u8(x), normalize_u8_reference(x)
    torch.cuda.synchronize()
    check(bool(torch.equal(got, want)), "K5: not bit-identical to its plain version")
    odd = x.view(-1)[1:1 + 3 * 7 * 5 * 3].view(3, 7, 5, 3)  # unaligned base, a tail of 11
    check(bool(torch.equal(normalize_u8(odd), normalize_u8_reference(odd))),
          "K5: unaligned view not bit-identical")
    err = (got - want).abs().max().item()
    ms = time_ms(lambda: normalize_u8(x), 50)
    plain_ms = time_ms(lambda: normalize_u8_reference(x), 20)
    n = x.numel()
    bms, by = bound_ms(5.0 * n, 3.0 * n, PEAK_FLOPS[torch.float32])
    row = {"shape": list(K5_SHAPE), "max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
           "bound_ms": bms, "bound_by": by, "library_ms": None,
           "gb_per_s": 5.0 * n / ms / 1e6}
    emit({"phase": "k5_normalize_u8", **row})
    return row


def _feed_image(args):
    """One seeded smooth image file: a 6x6 random grid resized bicubic to
    (w, h), PNG for even indices, JPEG for odd ones."""
    from PIL import Image

    root, seed, i, h, w = args
    rng = np.random.default_rng([seed, i])
    small = Image.fromarray(rng.integers(0, 256, (6, 6, 3), dtype=np.uint8))
    img = small.resize((int(w), int(h)), Image.BICUBIC)
    name = f"feed{i:05d}.{'png' if i % 2 == 0 else 'jpg'}"
    if i % 2 == 0:
        img.save(f"{root}/{name}", format="PNG", compress_level=1)
    else:
        img.save(f"{root}/{name}", format="JPEG", quality=90)
    return name


def _feed_files(root, seed, n=FEED_IMAGES):
    """n seeded smooth PNG/JPEG files, 96-1,200 px per side, about a third
    with a side above the bucket (shrunk on the host by pad_to_bucket)."""
    from concurrent.futures import ThreadPoolExecutor

    rng = np.random.default_rng(seed)
    sides = rng.integers(96, FEED_BUCKET + 1, (n, 2))
    big = np.flatnonzero(rng.random(n) < 1 / 3)
    long_side = rng.integers(0, 2, len(big))
    sides[big, long_side] = rng.integers(FEED_BUCKET + 1, 1201, len(big))
    sides[big, 1 - long_side] = rng.integers(96, 1201, len(big))
    with ThreadPoolExecutor(8) as pool:
        names = list(pool.map(_feed_image, [(root, seed, i, h, w)
                                            for i, (h, w) in enumerate(sides)]))
    return names, sides


def _decode_padded(root, names):
    """The device feed's host half for these files: decode, pad into the
    bucket. Returns (stacked uint8 buffers, (n, 2) int32 true sizes)."""
    from concurrent.futures import ThreadPoolExecutor

    from PIL import Image

    from tpualign_torch.ops.preprocess import pad_to_bucket

    def one(name):
        with Image.open(f"{root}/{name}") as im:
            return pad_to_bucket(np.asarray(im.convert("RGB"), np.uint8), FEED_BUCKET)

    with ThreadPoolExecutor(8) as pool:
        bufs, hws = zip(*pool.map(one, names))
    return np.stack(bufs), np.asarray(hws, np.int32)


def check_drift(got: np.ndarray, want: np.ndarray, what: str) -> dict:
    """The device feed's parity bounds in raw [0, 1] units: at most two
    uint8 steps anywhere, at most 1e-4 of the pixels more than one step
    off, mean drift at most 1e-4."""
    from tpualign_torch.ops.preprocess import CLIP_STD

    draw = np.abs(got - want) * np.asarray(CLIP_STD)
    out = {"max_steps": float(draw.max() * 255), "share_over_1_step": float(np.mean(draw * 255 > 1.01)),
           "mean": float(draw.mean())}
    check(out["max_steps"] <= 2.01 and out["share_over_1_step"] <= 1e-4 and out["mean"] <= 1e-4,
          f"{what}: drift {out}")
    return out


def _host_corpus(root, seed) -> dict:
    """The host files of the device_feed and pipeline phases, written under
    ``root`` (beside the kernels' build): the feed's files, then the
    pipeline's raw manuals, which embed their bytes; with their seconds."""
    import os

    feed = os.path.join(root, "feed")
    os.makedirs(feed)
    t0 = time.perf_counter()
    names, sides = _feed_files(feed, seed)
    t_files = time.perf_counter() - t0
    work = os.path.join(root, "pipeline")
    os.makedirs(work)
    t0 = time.perf_counter()
    manuals = _manual_corpus(work, seed, feed, names)
    return {"names": names, "sides": sides, "files_s": t_files, "manuals": manuals,
            "manuals_s": time.perf_counter() - t0}


def phase_device_feed(dev, seed, root, corpus):
    """``embed_image_records`` over 1,536 files (``corpus``, from
    :func:`_host_corpus`) with the host feed, then the device feed
    (ViT-B-32, bf16, batch 256): images/s of each, the idle share of one
    batch of each, and 64 images' pixels on the card against the port's
    CPU path."""
    import os

    from PIL import Image

    from tpualign_torch.config import ModelConfig
    from tpualign_torch.ops import preprocess as pp
    from tpualign_torch.ops.normalize import normalize_u8
    from tpualign_torch.parallel import EmbedEngine

    feed = os.path.join(root, "feed")
    names, sides, t_files = corpus["names"], corpus["sides"], corpus["files_s"]
    records = [{"image_id": f"feed{i:05d}", "filename": name} for i, name in enumerate(names)]
    engine = EmbedEngine(ModelConfig("ViT-B-32"), device=dev, seed=seed,
                         preprocess_bucket=FEED_BUCKET)
    bs = engine.batch_size
    rates, launches, embs = {}, {}, {}
    for mode in ("host", "device"):
        engine.preprocess = mode
        engine.embed_image_records(records[:bs], feed)  # warm-up, untimed
        normalize_u8.launches = 0
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        embs[mode] = engine.embed_image_records(records, feed)
        rates[mode] = len(records) / (time.perf_counter() - t0)
        launches[mode] = normalize_u8.launches
        emb = embs[mode]
        check(bool(np.isfinite(emb).all()), f"{mode} feed: non-finite embeddings")
        norm_err = float(np.abs(np.linalg.norm(emb, axis=1) - 1.0).max())
        check(norm_err <= 1e-5, f"{mode} feed: norms off by {norm_err:.3g}")
    check(launches["host"] == 0, f"the host feed launched K5 {launches['host']} times")
    check(launches["device"] == -(-len(records) // bs),
          f"the device feed launched K5 {launches['device']} times for {len(records)} images")
    cos = np.sum(embs["host"] * embs["device"], axis=1)

    # the device feed's host half alone (decode + pad, 8 threads), and one
    # batch of each feed as the consumer runs it, its host work done
    t0 = time.perf_counter()
    _decode_padded(feed, names)
    decode_per_s = len(names) / (time.perf_counter() - t0)
    u8, hw = _decode_padded(feed, names[:bs])
    pinned = torch.empty((bs, FEED_BUCKET, FEED_BUCKET, 3), dtype=torch.uint8, pin_memory=True)
    host_imgs = []
    for name in names[:bs]:
        with Image.open(os.path.join(feed, name)) as im:
            host_imgs.append(pp.preprocess_host(im, 224))
    host_imgs = np.stack(host_imgs)
    profiles = {
        "device_batch": profile_window(lambda: engine._encode_image_u8(list(u8), hw, pinned)),
        "host_batch": profile_window(lambda: engine.encode_image_batch(host_imgs)),
    }

    hw_t = torch.from_numpy(hw[:64])
    got = pp.preprocess_device(torch.from_numpy(u8[:64]).to(dev), hw_t.to(dev), 224)
    want = pp.preprocess_device(torch.from_numpy(u8[:64]), hw_t, 224)
    drift = check_drift(got.cpu().numpy(), want.numpy(), "device_feed: card against CPU")
    emit({"phase": "device_feed", "images": len(records), "bucket": FEED_BUCKET,
          "above_bucket": int((sides.max(axis=1) > FEED_BUCKET).sum()),
          "files_s": t_files, "images_per_s": rates, "decode_pad_per_s": decode_per_s,
          "k5_launches": launches,
          "host_vs_device_cosine": {"min": float(cos.min()), "mean": float(cos.mean())},
          "pixels_card_vs_cpu": drift, "profile": profiles})


def _openclip_name(name: str, t: torch.Tensor):
    """The port's parameter name and tensor -> OpenCLIP's (the layout
    ``models.loader.convert_openclip_state_dict`` reads)."""
    if name.startswith("text."):
        name = name[len("text."):]
        if name == "token_embedding":
            return "token_embedding.weight", t
    if name == "visual.conv1_kernel":  # HWIO -> OIHW
        return "visual.conv1.weight", t.permute(3, 2, 0, 1)
    head, _, leaf = name.rpartition(".")
    if leaf == "in_proj_kernel":
        return f"{head}.in_proj_weight", t.T
    if leaf.endswith("_kernel"):
        return f"{head}.{leaf[:-len('_kernel')]}.weight", t.T
    if leaf.endswith("_bias") and leaf != "in_proj_bias":
        return f"{head}.{leaf[:-len('_bias')]}.bias", t
    if leaf == "scale":
        return f"{head}.weight", t
    return name, t


def phase_checkpoint(root, seed) -> str:
    """ViT-B-32's seeded tree (``init_clip_params(seed)``, the weights the
    port draws without a checkpoint) written as an OpenCLIP-layout ``.pt``
    file: a plain tensor dict that ``torch.load(weights_only=True)`` reads.
    The port's loader must read it back bit for bit; where ``safetensors``
    is installed, the same tree as ``.safetensors`` must load equal."""
    import os

    from tpualign_torch.config import ModelConfig
    from tpualign_torch.models import CLIP, from_jax_params, init_clip_params
    from tpualign_torch.models.loader import load_checkpoint_params

    mc = ModelConfig("ViT-B-32")
    t0 = time.perf_counter()
    with span("model_build", "checkpoint"):
        seeded = init_clip_params(CLIP(mc.variant, mc.use_quick_gelu), seed=seed)
    sd = dict(_openclip_name(n, p.detach()) for n, p in seeded.named_parameters())
    sd = {k: v.contiguous() for k, v in sd.items()}
    path = os.path.join(root, "vit-b-32-openclip.pt")
    torch.save(sd, path)
    export_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    tree = load_checkpoint_params(dataclasses.replace(mc, checkpoint_path=path))
    load_s = time.perf_counter() - t0
    with span("model_build", "checkpoint"):
        loaded = from_jax_params(CLIP(mc.variant, mc.use_quick_gelu), tree)
    for (name, want), got in zip(seeded.named_parameters(), loaded.parameters()):
        check(torch.equal(got, want), f"checkpoint round trip: {name} differs")
    out = {"phase": "checkpoint", "layout": "openclip", "file": os.path.basename(path),
           "bytes": os.path.getsize(path), "tensors": len(sd),
           "params": sum(v.numel() for v in sd.values()), "export_s": export_s,
           "load_s": load_s, "round_trip": "bit-identical"}
    try:
        from safetensors.torch import save_file
    except ImportError:
        out["safetensors"] = "not installed"
    else:
        st = os.path.join(root, "vit-b-32-openclip.safetensors")
        save_file(sd, st)
        other = load_checkpoint_params(dataclasses.replace(mc, checkpoint_path=st))
        check(all(np.array_equal(a, b) for a, b in zip(_leaves(other), _leaves(tree))),
              "the .safetensors file loads another tree than the .pt file")
        out["safetensors"] = "same tree as .pt"
    emit(out)
    return path


def _leaves(tree):
    for key in sorted(tree):
        if isinstance(tree[key], dict):
            yield from _leaves(tree[key])
        else:
            yield tree[key]


def _line_words(text, top):
    """One line of positioned words, 12 points high, left to right."""
    words, x = [], 50.0
    for t in text.split():
        words.append({"text": t, "x0": x, "x1": x + 7.0 * len(t), "top": top,
                      "bottom": top + 12.0})
        x += 7.0 * len(t) + 5.0
    return words


def _manual_corpus(root, seed, feed_dir, feed_names):
    """PIPE_MANUALS ``*.synthdoc.json`` manuals x 8 pages, written by the port's
    ``write_synthetic_document``. Each page holds one raster image (a
    device_feed file's bytes) with a native rect, or on every 53rd page
    only the page's image block (the processor's second bbox tier), and
    eight word lines that chunking turns into one chunk each. Returns the
    raw directory, what each page should give, and the corpus' bytes."""
    import os

    raw = os.path.join(root, "raw")
    os.makedirs(raw)
    pages_want = _write_manuals(raw, range(PIPE_MANUALS), np.random.default_rng(seed + 1),
                                feed_dir, feed_names)
    nbytes = sum(os.path.getsize(os.path.join(raw, n)) for n in os.listdir(raw))
    return raw, pages_want, nbytes


def _write_manuals(raw, numbers, rng, feed_dir, feed_names):
    """Manuals ``man<m>`` for each m of ``numbers``, as :func:`_manual_corpus`
    describes them; returns what each page should give."""
    import os

    from tpualign_torch.data import write_synthetic_document

    numbers = list(numbers)
    texts = _chunk_texts(rng, len(numbers) * PIPE_PAGES * PIPE_CHUNKS_PER_PAGE, empty_every=0)
    pages_want = []
    for i, m in enumerate(numbers):
        pages = []
        for p in range(PIPE_PAGES):
            page = m * PIPE_PAGES + p
            src = feed_names[page % len(feed_names)]
            with open(os.path.join(feed_dir, src), "rb") as fh:
                data = fh.read()
            x0, y0 = (int(v) for v in rng.integers(40, 400, 2))
            bbox = [x0, y0, x0 + 160, y0 + 120]
            native = page % 53 != 0
            at = (i * PIPE_PAGES + p) * PIPE_CHUNKS_PER_PAGE
            lines = texts[at:at + PIPE_CHUNKS_PER_PAGE]
            tops = 60.0 + 85.0 * np.arange(PIPE_CHUNKS_PER_PAGE) + rng.integers(0, 40, len(lines))
            pages.append({
                "width": 612, "height": 792,
                "images": [{"data": data, "ext": src.rsplit(".", 1)[1],
                            "rects": [bbox] if native else [],
                            "dict_bbox": None if native else bbox}],
                "drawings": [],
                "words": [w for text, top in zip(lines, tops)
                          for w in _line_words(text, float(top))],
            })
            pages_want.append({"manual_id": f"man{m:03d}", "page": p + 1, "bbox": bbox,
                               "bbox_source": "native" if native else "dict_fallback",
                               "src": src, "lines": lines})
        write_synthetic_document(os.path.join(raw, f"man{m:03d}.synthdoc.json"), pages)
    return pages_want


def _check_stage1(out, feed_dir, pages_want):
    """Stage 1's records against what the writer placed: one image per page
    with its manual, page, bbox and bytes, the page's eight lines as its
    eight chunks in order, and a vocabulary; stage 2's filtered
    vocabulary without the excluded term."""
    import json
    import os

    with open(os.path.join(out, "image_metadata.json")) as f:
        images = json.load(f)
    with open(os.path.join(out, "text_chunks.json")) as f:
        chunks = json.load(f)
    with open(os.path.join(out, "lexical_components.json")) as f:
        vocab = json.load(f)
    with open(os.path.join(out, "filtered_lexical_components.json")) as f:
        filtered = json.load(f)
    check(len(images) == len(pages_want), f"stage 1 kept {len(images)} of "
          f"{len(pages_want)} images")
    by_page = {}
    for c in chunks:
        by_page.setdefault((c["manual_id"], c["page"]), []).append(c["text"])
    for i, (img, want) in enumerate(zip(images, pages_want)):
        image_id = f"{want['manual_id']}_p{want['page']}_img0"
        check(img["image_id"] == image_id and img["manual_id"] == want["manual_id"]
              and img["page"] == want["page"] and img["bbox"] == want["bbox"]
              and img["bbox_source"] == want["bbox_source"]
              and img["filename"] == f"{image_id}.{want['src'].rsplit('.', 1)[1]}",
              f"stage 1 image {i}: {img} against {want}")
        check(by_page.get((want["manual_id"], want["page"])) == want["lines"],
              f"stage 1 chunks of {image_id}: {by_page.get((want['manual_id'], want['page']))}")
        if i % 64 == 0:
            with open(os.path.join(out, "images", img["filename"]), "rb") as a, \
                    open(os.path.join(feed_dir, want["src"]), "rb") as b:
                check(a.read() == b.read(), f"stage 1 image file {img['filename']} differs")
    check(len(chunks) == len(pages_want) * PIPE_CHUNKS_PER_PAGE,
          f"stage 1 wrote {len(chunks)} chunks")
    check(vocab["total_components"] > 0, "stage 1 found no vocabulary")
    terms = {c["term"] for c in filtered["components"]}
    check(PIPE_EXCLUDE in {c["term"] for c in vocab["components"]} and PIPE_EXCLUDE not in terms
          and filtered["excluded_terms"] == [PIPE_EXCLUDE],
          f"stage 2 kept {sorted(terms)} (excluded {filtered['excluded_terms']})")
    return ({"images": len(images), "chunks": len(chunks),
             "dict_fallback_bboxes": sum(i["bbox_source"] == "dict_fallback" for i in images),
             "captions": sum(i["caption"] is not None for i in images),
             "vocabulary": vocab["total_components"], "filtered": len(terms)},
            images, chunks, [c["term"] for c in filtered["components"]])


def _check_embeddings_bitwise(dev, env, store, images, chunks, images_dir) -> dict:
    """The embeddings that ``embed`` stored from the checkpoint against
    ``EmbedEngine`` with the seeded tree and no checkpoint, built as the
    stage builds it and run over the same records (so the same batches):
    bit for bit."""
    from tpualign_torch.config import load_config
    from tpualign_torch.pipeline import Pipeline

    engine = Pipeline(load_config({**env, "CLIP_CHECKPOINT": ""}), device=dev).engine
    out = {}
    for table, records, key, embed in (
            ("images", images, "image_id",
             lambda: engine.embed_image_records(images, images_dir)),
            ("text_chunks", chunks, "chunk_id", lambda: engine.embed_chunk_records(chunks))):
        ids, stored = store.embedding_matrix("vanilla_clip", table)
        row = {k: i for i, k in enumerate(ids)}
        stored = stored[[row[r[key]] for r in records]]
        want = embed()
        check(np.array_equal(stored, want),
              f"{table}: {int((stored != want).any(axis=1).sum())} stored embeddings differ "
              "from the seeded engine's")
        out[table] = len(records)
    return out


_STAGE = READY + """
import atexit, json, runpy, sys
from tpualign_torch.ops.attention import fused_mha
from tpualign_torch.ops.normalize import normalize_u8
from tpualign_torch.ops.sim_topk import masked_sim_topk, masked_sim_topk_quant
from tpualign_torch.ops.ivf_topk import ivf_probe_topk
path = sys.argv[1]
def _dump():
    with open(path, "w") as f:
        json.dump({"fused_mha": fused_mha.launches, "masked_sim_topk": masked_sim_topk.launches,
                   "masked_sim_topk_quant": masked_sim_topk_quant.launches,
                   "ivf_probe_topk": ivf_probe_topk.launches,
                   "normalize_u8": normalize_u8.launches,
                   "fused_mha_backward": fused_mha.backward_recomputes}, f)
    import torch
    if torch.cuda.is_available():
        with open(path + ".mem", "w") as f:
            json.dump([torch.cuda.max_memory_allocated(i) / 2**30
                       for i in range(torch.cuda.device_count())], f)
atexit.register(_dump)
sys.argv = ["tpualign_torch"] + sys.argv[2:]
runpy.run_module("tpualign_torch", run_name="__main__", alter_sys=True)
"""


def _run_stage(argv, env, cwd, tag=""):
    """``python -m tpualign_torch <argv>`` as a subprocess whose kernel
    launch counters are written at exit. Returns (wall s, counters)."""
    import json
    import os

    counters = os.path.join(cwd, f"counters-{argv[0]}{tag}.json")
    repo = os.path.dirname(os.path.abspath(__file__))
    path = os.pathsep.join(p for p in (repo, os.environ.get("PYTHONPATH")) if p)
    t0, spawned = time.perf_counter(), time.time()
    out = subprocess.run([sys.executable, "-c", _STAGE, counters, *argv], capture_output=True,
                         text=True, timeout=600, cwd=cwd,
                         env=dict(os.environ, PYTHONPATH=path, **env))
    secs = time.perf_counter() - t0
    child_done(argv[0] + tag, spawned, out.stderr)
    check(out.returncode == 0, f"{argv[0]} exited {out.returncode}: {out.stderr[-3000:]}")
    with open(counters) as f:
        return secs, json.load(f), out


def _recount(store, schema):
    """The cartesian metrics of one schema recounted in float64 numpy from
    the stored embeddings: each image's same-page chunks ranked by score
    descending, then corpus index."""
    img_ids, img_emb = store.embedding_matrix(schema, "images")
    chunk_ids, chunk_emb = store.embedding_matrix(schema, "text_chunks")
    img_row = {k: i for i, k in enumerate(img_ids)}
    chunk_row = {k: i for i, k in enumerate(chunk_ids)}
    by_page = {}
    for c in store.chunks(schema):
        by_page.setdefault((c["manual_id"], c.get("page")), []).append(chunk_row[c["chunk_id"]])
    img_emb, chunk_emb = img_emb.astype(np.float64), chunk_emb.astype(np.float64)
    ranks, sims = [], []
    for img in store.images(schema):
        truth = by_page.get((img["manual_id"], img.get("page")), [])
        if not truth:
            continue
        cand = np.asarray(sorted(truth))
        scores = chunk_emb[cand] @ img_emb[img_row[img["image_id"]]]
        order = cand[np.lexsort((cand, -scores))][:100]
        pos = {int(j): r + 1 for r, j in enumerate(order)}
        ranks += [pos.get(j, 0) for j in truth]
        sims += [float(chunk_emb[j] @ img_emb[img_row[img["image_id"]]]) for j in truth]
    ranks = np.asarray(ranks)
    return {"top_k": {str(k): float(np.mean((ranks > 0) & (ranks <= k))) for k in (1, 5, 10)},
            "mrr": float(np.mean(np.where(ranks > 0, 1.0 / np.maximum(ranks, 1), 0.0))),
            "avg_similarity": float(np.mean(sims)), "num_pairs": len(ranks)}


def _alignment_recount(store, schema, window):
    """Per stored alignment of ``schema``, in the store's order: the
    1-based rank of its chunk among its image's same-page chunks by
    float64 score descending, then corpus index (0 beyond ``window``), and
    whether another same-page chunk scores within K2_TIE_GAP of it."""
    img_ids, img_emb = store.embedding_matrix(schema, "images")
    chunk_ids, chunk_emb = store.embedding_matrix(schema, "text_chunks")
    img_row = {k: i for i, k in enumerate(img_ids)}
    chunk_row = {k: i for i, k in enumerate(chunk_ids)}
    page_of = {i["image_id"]: (i["manual_id"], i.get("page")) for i in store.images(schema)}
    by_page = {}
    for c in store.chunks(schema):
        by_page.setdefault((c["manual_id"], c.get("page")), []).append(chunk_row[c["chunk_id"]])
    img_emb, chunk_emb = img_emb.astype(np.float64), chunk_emb.astype(np.float64)
    ranked = {}
    ranks, near = [], []
    for image_id, chunk_id, _, _ in store.alignments(schema):
        if image_id not in ranked:
            cand = np.asarray(sorted(by_page.get(page_of[image_id], [])), np.int64)
            scores = chunk_emb[cand] @ img_emb[img_row[image_id]]
            order = cand[np.lexsort((cand, -scores))][:window]
            ranked[image_id] = ({int(j): r + 1 for r, j in enumerate(order)},
                                dict(zip(cand.tolist(), scores.tolist())))
        pos, score = ranked[image_id]
        j = chunk_row[chunk_id]
        ranks.append(pos.get(j, 0))
        near.append(j in score and any(abs(v - score[j]) <= K2_TIE_GAP
                                       for c, v in score.items() if c != j))
    return np.asarray(ranks, np.int64), np.asarray(near, bool)


def _check_evaluator_ranking(dev, store, eval_dir) -> dict:
    """What the cartesian metrics cannot show. K2 at the Evaluator's own
    search (vanilla_clip's images against its chunks, the page keys,
    k=MRR_WINDOW) against the same ``RetrievalIndex.search`` through the
    plain version; then each weak-supervision schema's alignment ranks
    from the Evaluator on the card against a float64 recount, and its
    top-1/5/10 and MRR against the recount's."""
    from unittest import mock

    from tpualign_torch.evaluation import Evaluator
    from tpualign_torch.evaluation.metrics import MRR_WINDOW
    from tpualign_torch.ops.sim_topk import key_mask, masked_sim_topk, masked_sim_topk_reference
    from tpualign_torch.parallel import retrieval

    schema = "vanilla_clip"
    images, chunks = store.images(schema), store.chunks(schema)
    _, img_emb = store.embedding_matrix(schema, "images")
    _, chunk_emb = store.embedding_matrix(schema, "text_chunks")
    index = retrieval.RetrievalIndex(chunk_emb, [c["manual_id"] for c in chunks],
                                     [c.get("page") for c in chunks], device=dev)
    manuals, pages = [i["manual_id"] for i in images], [i.get("page") for i in images]
    before = masked_sim_topk.launches
    vals, idx = index.search(img_emb, manuals, pages, k=MRR_WINDOW)
    check(masked_sim_topk.launches == before + 1,
          f"the Evaluator's search launched K2 {masked_sim_topk.launches - before} times")
    with mock.patch.object(retrieval, "masked_sim_topk", masked_sim_topk_reference):
        rvals, ridx = index.search(img_emb, manuals, pages, k=MRR_WINDOW)
    err = compare_topk(*(torch.from_numpy(x) for x in (vals, idx, rvals, ridx)),
                       "K2 at the Evaluator's search")
    ev = Evaluator(store, output_dir=eval_dir, device=dev)
    check(np.array_equal(ev._schema_state(schema)["topk_idx"], idx),
          "the Evaluator's top-100 table differs from RetrievalIndex.search's")
    qk = torch.from_numpy(retrieval.encode_keys(manuals, pages, dict(index.vocab))[0]).to(dev)
    q = torch.from_numpy(img_emb).to(dev)
    corpus, ck, _ = _rows(index)
    mask = key_mask(qk, ck)
    pairs = int(mask.sum().item())
    rows_read = int(mask.any(dim=0).sum().item())
    admitted, tiles = admitted_tile_count(qk, ck, None)
    del mask
    nq, d = q.shape

    def library():
        sims = torch.where(key_mask(qk, ck), q @ corpus.T, -1e30)
        return torch.topk(sims, MRR_WINDOW, dim=1)

    # each query, key and output once, and the corpus rows some query admits
    nbytes = (nq + rows_read) * d * 4 + (nq + len(ck)) * 4 + nq * MRR_WINDOW * 8
    bms, by = bound_ms(nbytes, 2.0 * d * pairs, PEAK_FLOPS[torch.float32])
    k2 = {"Q": nq, "N": len(chunks), "page_keys": len(set(zip(manuals, pages))),
          "k": MRR_WINDOW, "max_abs_err": err, "valid_pairs": pairs,
          "admitted_tiles": admitted, "tiles": tiles,
          "empty_slots": int((idx < 0).sum()),
          "ms": time_ms(lambda: masked_sim_topk(q, qk, corpus, ck, MRR_WINDOW), 20),
          "plain_ms": time_ms(lambda: masked_sim_topk_reference(q, qk, corpus, ck, MRR_WINDOW),
                              3),
          "library_ms": time_ms(library, 5), "bound_ms": bms, "bound_by": by}

    aligned = {}
    for schema in ("clip_lexical", "clip_positional", "clip_combined"):
        want, near = _alignment_recount(store, schema, MRR_WINDOW)
        got = ev._pair_ranks(schema, "alignments")
        check(len(got) == len(want) > 0, f"{schema}: {len(got)} alignment ranks, {len(want)}")
        check(bool((got[~near] == want[~near]).all()),
              f"{schema}: {(got[~near] != want[~near]).sum()} alignment ranks differ "
              "from the float64 recount")
        tol = 1e-6 + near.sum() / len(want)
        top = ev.compute_top_k_accuracy(schema, (1, 5, 10), gt="alignments")
        mrr = ev.compute_mrr(schema, gt="alignments")
        want_top = {k: float(np.mean((want > 0) & (want <= k))) for k in (1, 5, 10)}
        want_mrr = float(np.mean(np.where(want > 0, 1.0 / np.maximum(want, 1), 0.0)))
        for k in (1, 5, 10):
            check(abs(top[k] - want_top[k]) <= tol,
                  f"{schema} alignments top-{k} {top[k]} against {want_top[k]}")
        check(abs(mrr - want_mrr) <= tol, f"{schema} alignments MRR {mrr} against {want_mrr}")
        check(len(set(want_top.values())) > 1,
              f"{schema}: the alignment ranks do not move with k ({want_top})")
        aligned[schema] = {"pairs": len(want), "near_ties": int(near.sum()),
                           "top_k": top, "mrr": mrr, "recount_top_k": want_top,
                           "recount_mrr": want_mrr}
    return {"k2_at_evaluator_search": k2, "alignments_gt": aligned}


def _run_twice(dev, env, work, after_first=lambda: None) -> dict:
    """``python -m tpualign_torch run --non-interactive`` over a fresh
    output, store and evaluation directory: its metrics.json against its
    own float64 recount. Then the same command again, which must skip
    stages 1-4 through their completion checks (the manifest's input
    fingerprint for stage 1) and launch no tower kernel; evaluation has no
    completion check (as in tpualign), re-runs and must write the same
    metrics. ``after_first`` is called between the two."""
    import json
    import os

    from tpualign_torch.store import SCHEMAS, EmbeddingStore

    out = {}
    for attempt in ("first", "second"):
        if attempt == "second":
            after_first()
        secs, launches, done = _run_stage(["run", "--non-interactive", "--device", dev.type],
                                          env, work)
        with open(os.path.join(env["EVAL_OUTPUT_DIR"], "metrics.json")) as f:
            metrics = json.load(f)
        skipped = [line.split(": ", 1)[1] for line in done.stderr.splitlines()
                   if "Skipping..." in line]
        out[attempt] = {"s": secs, "launches": launches, "skipped": skipped,
                        "metrics": metrics}
    first, second = out["first"], out["second"]
    check(sorted(first["metrics"]) == sorted(SCHEMAS), f"run wrote {sorted(first['metrics'])}")
    check(first["launches"]["fused_mha"] > 0 and first["launches"]["normalize_u8"] > 0
          and first["launches"]["masked_sim_topk"] > 0 and not first["skipped"],
          f"the first run: launches {first['launches']}, skipped {first['skipped']}")
    store = EmbeddingStore(env["STORE_DIR"], embed_dim=512)
    want = _recount(store, "vanilla_clip")
    got = first["metrics"]["vanilla_clip"]
    check(got["num_pairs"] == want["num_pairs"] > 0
          and all(abs(got["top_k"][k] - want["top_k"][k]) <= 1e-6 for k in ("1", "5", "10"))
          and abs(got["mrr"] - want["mrr"]) <= 1e-6
          and abs(got["avg_similarity"] - want["avg_similarity"]) <= 1e-5,
          f"run's metrics {got} against the recount {want}")
    stages = ["Document processing already completed. Skipping...",
              "Lexical components already filtered. Skipping...",
              "Store schemas already set up. Skipping..."] + [
        f"{schema} already has embeddings. Skipping..." for schema in SCHEMAS]
    check(second["skipped"] == stages, f"the second run skipped {second['skipped']}")
    check(second["launches"]["fused_mha"] == 0 and second["launches"]["normalize_u8"] == 0,
          f"the second run launched {second['launches']}")
    check(second["metrics"] == first["metrics"], "the second run's metrics differ")
    return {"manuals": PIPE_RUN_MANUALS, "images": want["num_pairs"] // PIPE_CHUNKS_PER_PAGE,
            "first": {k: first[k] for k in ("s", "launches")}, "recount": want,
            "metrics_vanilla_clip": got,
            "second": {"s": second["s"], "launches": second["launches"],
                       "skipped": len(second["skipped"]),
                       "evaluate": "re-run: no completion check, as in tpualign",
                       "metrics_identical": True}}


def phase_pipeline(dev, seed, root, corpus, checkpoint, bitwise: bool = True):
    """The pipeline as a user runs it, from raw manuals: ``python -m
    tpualign_torch process``, ``filter``, ``setup-db`` (beside the first
    two), ``embed`` (IMAGE_PREPROCESS=device) and ``evaluate`` as
    subprocesses over 256
    synthdoc manuals (2,048 images, 16,384 chunks), the towers loaded from
    the OpenCLIP checkpoint; stage 1's records against what the writer
    placed, the stored embeddings against the seeded engine bit for bit,
    metrics.json against a float64 recount, the alignment records against
    the CPU ``compute_alignments``; beside them, ``run`` in one command
    over 32 of the manuals, twice, and ``ingest`` over a copy of the
    first run's store beside the second (``_ingest_notify``); with
    MESH_SHARDS cards or more, ``embed --mesh-data`` (_mesh_embed_cli).
    The manuals are written beside the kernels' build (_host_corpus).
    Without ``bitwise`` (the four-card
    run: the one-card run checks it) the stored embeddings are not held
    against the seeded engine. Returns the launches of the five
    stages, K2 at the Evaluator's search, ingest's launches and the mesh
    embed's record (None on fewer cards)."""
    import json
    import os

    from tpualign_torch.pipeline import SCHEMA_FLAGS
    from tpualign_torch.store import SCHEMAS, EmbeddingStore
    from tpualign_torch.weaksup import compute_alignments

    work = os.path.join(root, "pipeline")
    feed_dir = os.path.join(root, "feed")
    feed_names = corpus["names"]
    (raw, pages_want, raw_bytes), write_s = corpus["manuals"], corpus["manuals_s"]
    exclude = os.path.join(work, "exclude_terms.txt")
    with open(exclude, "w") as f:
        f.write(f"# the operator's exclusion list\n{PIPE_EXCLUDE}\n")
    out = os.path.join(work, "processed")
    env = {"INPUT_DIR": raw, "OUTPUT_DIR": out, "EXCLUDE_TERMS_FILE": exclude,
           "STORE_DIR": os.path.join(work, "store"), "LANGUAGE": "nl",
           "EVAL_OUTPUT_DIR": os.path.join(work, "eval"), "IMAGE_PREPROCESS": "device",
           "IMAGE_PREPROCESS_BUCKET": str(FEED_BUCKET), "SEED": str(seed),
           "CLIP_MODEL": "ViT-B-32", "CLIP_CHECKPOINT": checkpoint}
    # run in one command over a subset of the manuals, into fresh
    # directories, then ingest over its store: beside the five stages
    sub = os.path.join(work, "run")
    os.makedirs(os.path.join(sub, "raw"))
    for name in sorted(os.listdir(raw))[:PIPE_RUN_MANUALS]:
        os.link(os.path.join(raw, name), os.path.join(sub, "raw", name))
    sub_env = {**env, "INPUT_DIR": os.path.join(sub, "raw"),
               "OUTPUT_DIR": os.path.join(sub, "processed"),
               "STORE_DIR": os.path.join(sub, "store"), "EVAL_OUTPUT_DIR": os.path.join(sub, "eval")}

    def run_then_ingest():
        started = {}

        def ingest_beside():
            # ingest on a copy of the first run's directories, beside the
            # second run (which must find stages 1-4 done in its own)
            copy = os.path.join(work, "run-ingest")
            shutil.copytree(sub, copy)
            copy_env = {**sub_env, **{k: sub_env[k].replace(sub, copy, 1) for k in (
                "INPUT_DIR", "OUTPUT_DIR", "STORE_DIR", "EVAL_OUTPUT_DIR")}}
            started["ingest"] = _beside(_ingest_notify, dev, copy_env, copy, feed_dir,
                                        feed_names, seed)

        one = _run_twice(dev, sub_env, sub, after_first=ingest_beside)
        return one, started["ingest"].result()

    chain = _beside(run_then_ingest)
    secs, launches, logs = {}, {}, {}
    # setup-db reads nothing stages 1-2 write: its processes run beside them
    setup = _beside(_run_stage, ["setup-db", "--device", dev.type], env, work)
    four = torch.cuda.device_count() >= MESH_SHARDS
    mesh_setup = _mesh_setup_db(env, work) if four else None
    for argv in (["process"], ["filter"], ["setup-db"], ["embed"], ["evaluate"]):
        device = [] if argv[0] in ("process", "filter") else ["--device", dev.type]
        if argv[0] == "setup-db":
            secs[argv[0]], launches[argv[0]], logs[argv[0]] = setup.result()
            continue
        secs[argv[0]], launches[argv[0]], logs[argv[0]] = _run_stage(argv + device, env, work)
        if argv[0] == "filter":
            stage1, images, chunks, terms = _check_stage1(out, feed_dir, pages_want)
        if argv[0] == "embed" and bitwise:
            # the stored embeddings against the seeded engine, beside evaluate
            def held_to_seeded():
                t0 = time.perf_counter()
                held = _check_embeddings_bitwise(
                    dev, env, EmbeddingStore(env["STORE_DIR"], embed_dim=512), images, chunks,
                    os.path.join(out, "images"))
                return {**held, "s": time.perf_counter() - t0}

            bitwise = _beside(held_to_seeded)
    check(not any(launches["process"].values()) and not any(launches["filter"].values()),
          f"stages 1-2 launched {launches['process']}, {launches['filter']}")
    check(f"Loading OpenCLIP-layout checkpoint from {checkpoint}" in logs["embed"].stderr,
          "embed did not load the checkpoint")
    total = {k: sum(c[k] for c in launches.values()) for k in launches["embed"]}
    check(launches["embed"]["normalize_u8"] == -(-len(images) // B),
          f"embed launched K5 {launches['embed']['normalize_u8']} times")

    with open(os.path.join(work, "eval", "metrics.json")) as f:
        metrics = json.load(f)
    check(sorted(metrics) == sorted(SCHEMAS), f"metrics.json holds {sorted(metrics)}")
    store = EmbeddingStore(env["STORE_DIR"], embed_dim=512)
    if bitwise:
        bitwise = bitwise.result()
    # on a host of MESH_SHARDS cards or more: the same stage on the mesh
    mesh_embed = (_mesh_embed_cli(mesh_setup, work, store, secs["embed"], len(images))
                  if four else None)
    want = _recount(store, "vanilla_clip")
    got = metrics["vanilla_clip"]
    check(got["num_pairs"] == want["num_pairs"] == len(images) * PIPE_CHUNKS_PER_PAGE,
          f"num_pairs {got['num_pairs']} against {want['num_pairs']}")
    for k in ("1", "5", "10"):
        check(abs(got["top_k"][k] - want["top_k"][k]) <= 1e-6, f"top-{k} {got} against {want}")
    check(abs(got["mrr"] - want["mrr"]) <= 1e-6, f"mrr {got['mrr']} against {want['mrr']}")
    check(abs(got["avg_similarity"] - want["avg_similarity"]) <= 1e-5,
          f"avg_similarity {got['avg_similarity']} against {want['avg_similarity']}")

    ranking = _check_evaluator_ranking(dev, store, os.path.join(work, "eval_check"))

    t0 = time.perf_counter()
    n_records = {}
    for schema in SCHEMAS:
        records = compute_alignments(images, chunks, terms, *SCHEMA_FLAGS[schema], device="cpu")
        check(store.alignments(schema) == records,
              f"{schema}: stored alignments differ from the CPU compute_alignments")
        n_records[schema] = len(records)
    t_cpu_align = time.perf_counter() - t0
    check(n_records["clip_combined"] > 0 and n_records["clip_positional"] > 0
          and n_records["clip_lexical"] > 0, f"weak supervision produced {n_records}")

    one, ingest = chain.result()
    emit({"phase": "pipeline", "model": "ViT-B-32", "manuals": PIPE_MANUALS,
          "pages": PIPE_MANUALS * PIPE_PAGES, "raw_corpus_bytes": raw_bytes,
          "corpus_write_s": write_s, "checkpoint": os.path.basename(checkpoint),
          "images": len(images), "chunks": len(chunks), "stage1": stage1,
          "process_s": secs["process"], "filter_s": secs["filter"], "stage_s": secs,
          "launches": launches, "embeddings_vs_seeded_engine": bitwise,
          "alignments": n_records, "cpu_compute_alignments_s": t_cpu_align,
          "metrics": metrics, "recount": want, **ranking, "run": one, "ingest": ingest,
          "evaluate_warnings": [line for line in logs["evaluate"].stderr.splitlines()
                                if "WARNING" in line][:3]})
    return total, ranking["k2_at_evaluator_search"], ingest["launches"]["ingest"], mesh_embed


INGEST_MANUALS = 16  # manuals added to the run subset for ingest --notify


class _Daemon:
    """``python -m tpualign_torch serve --port 0`` as a subprocess, through
    the stage wrapper (its kernel counters are written when SIGINT ends
    it); ``url`` once it prints its address."""

    def __init__(self, env, cwd, name, device, args=()):
        import os
        import queue
        import re

        self.name = name
        self.counters = os.path.join(cwd, f"counters-{name}.json")
        repo = os.path.dirname(os.path.abspath(__file__))
        path = os.pathsep.join(p for p in (repo, os.environ.get("PYTHONPATH")) if p)
        self.log = open(os.path.join(cwd, f"{name}.err"), "w")
        t0, self.spawned = time.perf_counter(), time.time()
        self.proc = subprocess.Popen(
            [sys.executable, "-c", _STAGE, self.counters, "serve", "--device", device,
             "--port", "0", *args], stdout=subprocess.PIPE, stderr=self.log, text=True, cwd=cwd,
            env=dict(os.environ, PYTHONPATH=path, **env))
        lines = queue.Queue()
        threading.Thread(target=lambda: [lines.put(x) for x in self.proc.stdout],
                         daemon=True).start()
        self.url = None
        deadline = time.monotonic() + 300
        while self.url is None and time.monotonic() < deadline and self.proc.poll() is None:
            try:
                m = re.search(r"on (http://127\.0\.0\.1:\d+)", lines.get(timeout=1.0))
            except queue.Empty:
                continue
            self.url = m.group(1) if m else None
        self.start_s = time.perf_counter() - t0
        if self.url is None:
            self.stop()
            raise AssertionError(f"serve did not start: {open(self.log.name).read()[-2000:]}")

    def get(self, path):
        import urllib.request

        with urllib.request.urlopen(self.url + path, timeout=60) as r:
            return json.loads(r.read())

    def stop(self) -> dict:
        import signal

        if self.proc.poll() is None:
            self.proc.send_signal(signal.SIGINT)
            try:
                self.proc.wait(timeout=60)
            except subprocess.TimeoutExpired:
                self.proc.kill()
                self.proc.wait()
        if not self.log.closed:
            self.log.close()
            with open(self.log.name) as f:
                child_done(f"serve:{self.name}", self.spawned, f.read())
        try:
            with open(self.counters) as f:
                return json.load(f)
        except OSError:
            return {}


class _FreshService:
    """A service built in this process over ``env``'s store with the towers
    from its checkpoint, behind HTTP: :class:`_Daemon`'s ``url``, ``get``
    and ``stop``, without a process's start."""

    def __init__(self, env, device):
        from tpualign_torch.config import load_config
        from tpualign_torch.serving.server import _ServiceBox, build_service, serve_schemas

        t0 = time.perf_counter()
        service = build_service(load_config(env), "vanilla_clip", device=device)
        self.httpd = serve_schemas({"vanilla_clip": _ServiceBox(service)}, "vanilla_clip",
                                   "127.0.0.1", 0)
        threading.Thread(target=self.httpd.serve_forever, daemon=True).start()
        self.url = f"http://127.0.0.1:{self.httpd.server_address[1]}"
        self.start_s = time.perf_counter() - t0

    get = _Daemon.get

    def stop(self) -> None:
        self.httpd.shutdown()
        self.httpd.server_close()


def _ingest_notify(dev, env, work, feed_dir, feed_names, seed) -> dict:
    """The live pipeline on the run subset's store: ``ingest`` once (the
    first cycle after ``run`` reprocesses every manual, as tpualign's does,
    and records the ingest manifest), ``serve`` as a subprocess, 16 new
    manuals, then ``ingest --notify <daemon>``: the daemon's /stats must
    show the new chunks and images, and its /search_text and /search_image
    answers must equal those of a service freshly built over the same store
    (in this process, behind HTTP: _FreshService)."""
    import os

    from tpualign_torch.store import EmbeddingStore

    warm_s, _, warm = _run_stage(["ingest", "--device", dev.type], env, work)
    check(f"ingested {PIPE_RUN_MANUALS} file(s); 0 unchanged" in warm.stdout,
          f"the first ingest printed {warm.stdout[-300:]}")
    store_before = EmbeddingStore(env["STORE_DIR"], embed_dim=512)
    ids_before, emb_before = store_before.embedding_matrix("vanilla_clip", "text_chunks")
    daemon = _Daemon(env, work, "daemon", dev.type)
    try:
        before = daemon.get("/stats")
        _write_manuals(env["INPUT_DIR"], range(PIPE_MANUALS, PIPE_MANUALS + INGEST_MANUALS),
                       np.random.default_rng(seed + 5), feed_dir, feed_names)
        seen = {}

        def poll():
            while "t" not in seen and "stop" not in seen:
                if daemon.get("/stats")["corpus_size"] > before["corpus_size"]:
                    seen["t"] = time.perf_counter()
                time.sleep(0.02)

        poller = threading.Thread(target=poll, daemon=True)
        t0 = time.perf_counter()
        poller.start()
        secs, launches, out = _run_stage(["ingest", "--notify", daemon.url, "--device",
                                          dev.type], env, work)
        poller.join(timeout=30)
        seen["stop"] = True
        check(f"ingested {INGEST_MANUALS} file(s); {PIPE_RUN_MANUALS} unchanged" in out.stdout,
              f"ingest printed {out.stdout[-300:]}")
        check("serve sync: +" in out.stderr, f"ingest did not sync: {out.stderr[-2000:]}")
        after = daemon.get("/stats")
        grew = (after["corpus_size"] - before["corpus_size"],
                after["num_images"] - before["num_images"])
        want = (INGEST_MANUALS * PIPE_PAGES * PIPE_CHUNKS_PER_PAGE, INGEST_MANUALS * PIPE_PAGES)
        check(grew == want and "t" in seen, f"/stats grew by {grew}, want {want}")
        store = EmbeddingStore(env["STORE_DIR"], embed_dim=512)
        ids_after, emb_after = store.embedding_matrix("vanilla_clip", "text_chunks")
        check(list(ids_after[:len(ids_before)]) == list(ids_before), "the store reordered chunks")
        same_old = bool(np.array_equal(emb_after[:len(ids_before)], emb_before))
        new_images = [im["image_id"] for im in store.images("vanilla_clip")
                      if int(im["manual_id"][3:]) >= PIPE_MANUALS][:16]
        fresh = _FreshService(env, dev)
        try:
            answers, gap = [], 0.0
            for path, body in (("/search_text", {"texts": SERVE_TEXTS, "k": 10, "global": True}),
                               ("/search_image", {"image_ids": new_images, "k": 10})):
                got, want_rows = (_post(d.url, path, body)["results"] for d in (daemon, fresh))
                check([[h["chunk_id"] for h in r] for r in got]
                      == [[h["chunk_id"] for h in r] for r in want_rows],
                      f"{path}: the synced daemon's ids differ from a fresh service's")
                gap = max([gap] + [abs(a["score"] - b["score"]) for ra, rb in zip(got, want_rows)
                                   for a, b in zip(ra, rb)])
                answers.append(len(got))
            check(gap <= (0.0 if same_old else 1e-5), f"scores differ by {gap}")
            check(fresh.get("/stats")["corpus_size"] == after["corpus_size"], "corpus sizes")
        finally:
            fresh.stop()
    finally:
        daemon_launches = daemon.stop()
    return {"manuals_added": INGEST_MANUALS, "first_ingest_s": warm_s, "ingest_s": secs,
            "ingest_to_stats_s": seen["t"] - t0, "daemon_start_s": daemon.start_s,
            "fresh_service_build_s": fresh.start_s, "stats_growth": {"chunks": grew[0],
                                                                      "images": grew[1]},
            "old_chunk_embeddings_unchanged": same_old, "max_score_gap_to_fresh": gap,
            "answers_compared": answers, "launches": {"ingest": launches,
                                                      "daemon": daemon_launches},
            "dir": os.path.basename(work)}


# steps of the train process and of the LoRA and int8_qat runs (cut from 40
# and 10, then from 10 and 5, to keep the script within its time limit as
# phases were added), and the LoRA and int8_qat runs' batch (B until PR 17:
# three processes at B=256 fill the card's 80 GB, at 27 GB a step each)
TRAIN_STEPS, TRAIN_SIDE_STEPS, TRAIN_SIDE_B = 6, 3, 64
TRAIN_TIMED_STEPS = 2                    # in-process steps timed per feed, after one warm-up
TRAIN_GRAD_REL, TRAIN_LOSS_REL = 5e-2, 1e-2  # bf16 towers: K1 against plain, accumulation
K1_TRAIN_SHAPES = [("vision", 50, 768, 12, False), ("text77", 77, 512, 8, True)]


def _train_env(root, checkpoint, seed, **extra) -> dict:
    import os

    work = os.path.join(root, "pipeline")
    env = {"STORE_DIR": os.path.join(work, "store"), "OUTPUT_DIR": os.path.join(work, "processed"),
           "CLIP_MODEL": "ViT-B-32", "CLIP_CHECKPOINT": checkpoint, "SEED": str(seed),
           "IMAGE_PREPROCESS_BUCKET": str(FEED_BUCKET), "TRAIN_IMAGE_FEED": "device",
           "LEARNING_RATE": "1e-5", "WARMUP_STEPS": "4", "TOTAL_STEPS": str(TRAIN_STEPS)}
    env.update({k: str(v) for k, v in extra.items()})
    return env


def _k1_backward(dev, gen) -> list:
    """K1 forward under autograd against the plain version at ViT-B-32's
    shapes, B=256, within K1's bound; the recompute's time. The backward
    recomputes ``fused_mha_reference`` by design, so its dqkv equal to the
    plain autograd's is a check of the wiring (the mask and the cotangent
    reach the recompute, which runs and is counted once per backward), not
    of a kernel: the whole step against plain is held in ``_step_grads``."""
    from tpualign_torch.models.text import causal_mask
    from tpualign_torch.ops.attention import fused_mha, fused_mha_reference

    rows = []
    for name, t, d, heads, causal in K1_TRAIN_SHAPES:
        for dtype in (torch.float32, torch.bfloat16):
            qkv = torch.randn(B, t, 3 * d, generator=gen, device=dev).to(dtype).requires_grad_()
            g = torch.randn(B, t, d, generator=gen, device=dev).to(dtype)
            mask = causal_mask(t, dev) if causal else None
            out = fused_mha(qkv, heads, mask)
            before = fused_mha.backward_recomputes
            (got,) = torch.autograd.grad(out, qkv, g)
            check(fused_mha.backward_recomputes == before + 1,
                  f"K1 {name} {dtype}: the backward did not recompute once")
            ref = fused_mha_reference(qkv, heads, mask)
            (want,) = torch.autograd.grad(ref, qkv, g)
            atol, rtol = K1_TOL[dtype]
            err = (out.float() - ref.float()).abs()
            check(bool((err <= atol + rtol * ref.float().abs()).all()),
                  f"K1 {name} {dtype} forward under autograd: max abs error {err.max().item():.3g}")
            check(torch.equal(got, want), f"K1 {name} {dtype}: the backward's wiring: dqkv "
                  f"differs from the plain autograd's (max "
                  f"{(got.float() - want.float()).abs().max().item():.3g})")
            bwd_ms = time_ms(lambda: torch.autograd.grad(
                fused_mha_reference(qkv, heads, mask), qkv, g), 10)
            fwd_ms = time_ms(lambda: fused_mha(qkv.detach(), heads, mask), 20)
            rows.append({"shape": name, "dtype": str(dtype).split(".")[-1], "B": B, "T": t,
                         "fwd_ms": fwd_ms, "backward_recompute_ms": bwd_ms,
                         "max_abs_err_fwd": err.max().item(),
                         "dqkv": "the plain autograd's (wiring)"})
    return rows


def _matmul_grads(dev, gen) -> dict:
    """``matmul_f32acc``'s bf16 gradients at the vision in_proj's shape
    against the fp32 product of the widened operands."""
    from tpualign_torch.ops.dense import matmul_f32acc

    a = torch.randn(B * 50, 768, generator=gen, device=dev).bfloat16().requires_grad_()
    b = (torch.randn(768, 2304, generator=gen, device=dev) * 0.03).bfloat16().requires_grad_()
    g = torch.randn(B * 50, 2304, generator=gen, device=dev)
    da, db = torch.autograd.grad(matmul_f32acc(a, b), (a, b), g)
    a32, b32 = a.detach().float().requires_grad_(), b.detach().float().requires_grad_()
    wa, wb = torch.autograd.grad(a32 @ b32, (a32, b32), g)
    out = {"shape": "(12800, 768) x (768, 2304) bf16", "bound": "2^-7 x max |value|"}
    for name, got, want in (("dA", da, wa), ("dB", db, wb)):
        err = (got.float() - want).abs().max().item()
        check(got.dtype == torch.bfloat16 and err <= 2**-7 * want.abs().max().item(),
              f"matmul_f32acc {name}: {got.dtype}, max abs error {err:.3g}")
        out[f"{name}_max_abs_err"] = err
    return out


def _step_grads(trainer, cfg, batch, fused: bool, remat: bool = False):
    """One train step from the trainer's starting params with K1 or the
    plain attention, every block checkpointed when ``remat``
    (``CLIP_REMAT``): (loss, grad_norm, {name: fp32 gradient})."""
    from tpualign_torch.train import step as S

    model = trainer.model
    for tower in (model.visual, model.text):
        tower.transformer.remat = remat
    for blk in list(model.visual.transformer.resblocks) + list(model.text.transformer.resblocks):
        blk.attn.use_fused_attention = fused
    state = S.create_train_state(model, S.model_params(model), cfg)
    grads = {}
    real = state.apply_gradients

    def keep(g, n):
        grads.update({k: v.float().clone() for k, v in g.items()})
        return real(g, n)

    state.apply_gradients = keep
    _, m = S.train_step(state, model, *batch, cfg)
    out = (float(m["loss"]), float(m["grad_norm"]), grads)
    for blk in list(model.visual.transformer.resblocks) + list(model.text.transformer.resblocks):
        blk.attn.use_fused_attention = True
    for tower in (model.visual, model.text):
        tower.transformer.remat = trainer.config.model.remat
    del state
    return out


def _remat_step(trainer, cfg, batch) -> dict:
    """CLIP_REMAT: one step with every block under ``torch.utils.checkpoint``
    against one without, from the same params and batch: peak memory
    (``max_memory_allocated`` from a reset before each), K1's launches
    (forward 24 a step, and 24 more in the remat recompute; 24 backward
    recomputes either way), and loss, grad_norm and every gradient leaf
    within K1's step bounds. (``tests/test_torch_remat.py`` holds that
    CLIP_REMAT reaches both towers.)"""
    from tpualign_torch.ops.attention import fused_mha

    blocks = len(trainer.model.visual.transformer.resblocks) + len(
        trainer.model.text.transformer.resblocks)
    runs, out = {}, {}
    for remat in (False, True):
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        fused_mha.launches = fused_mha.backward_recomputes = 0
        runs[remat] = _step_grads(trainer, cfg, batch, fused=True, remat=remat)
        torch.cuda.synchronize()
        tag = "remat" if remat else "plain"
        out[f"{tag}_peak_memory_gb"] = torch.cuda.max_memory_allocated() / 2**30
        out[f"{tag}_launches"] = {"fused_mha": fused_mha.launches,
                                  "fused_mha_backward": fused_mha.backward_recomputes}
        want = (2 if remat else 1) * blocks
        check(fused_mha.launches == want and fused_mha.backward_recomputes == blocks,
              f"{tag} step: K1 launched {fused_mha.launches} times (want {want}: forward"
              f"{' and the remat recompute' if remat else ''}), {fused_mha.backward_recomputes} "
              f"backward recomputes (want {blocks})")
    check(out["remat_peak_memory_gb"] < out["plain_peak_memory_gb"],
          f"CLIP_REMAT=1 peak {out['remat_peak_memory_gb']:.2f} GB is not below "
          f"{out['plain_peak_memory_gb']:.2f} GB")
    out["remat_vs_plain"] = _compare_steps("CLIP_REMAT=1 against the plain step", runs[True],
                                           runs[False])
    return out


def _compare_steps(what, a, b) -> dict:
    (la, na, ga), (lb, nb, gb) = a, b
    check(abs(la - lb) <= TRAIN_LOSS_REL * abs(lb) and abs(na - nb) <= TRAIN_LOSS_REL * abs(nb),
          f"{what}: loss {la} / {lb}, grad_norm {na} / {nb}")
    worst = 0.0
    for k, want in gb.items():
        rel = (ga[k] - want).abs().max().item() / max(want.abs().max().item(), 1e-30)
        check(rel <= TRAIN_GRAD_REL, f"{what}: gradient {k} off by {rel:.3g} of its max")
        worst = max(worst, rel)
    return {"loss": [la, lb], "grad_norm": [na, nb], "worst_leaf_rel": worst,
            "leaves": len(gb), "bounds": {"loss_grad_norm_rel": TRAIN_LOSS_REL,
                                          "leaf_rel_to_max": TRAIN_GRAD_REL}}


def _device_batch(trainer, item):
    imgs, tokens, weights = item[:3]
    dev = trainer.device
    if isinstance(imgs, tuple):
        imgs = tuple(torch.from_numpy(x).to(dev) for x in imgs)
    else:
        imgs = torch.from_numpy(imgs).to(dev)
    return imgs, torch.from_numpy(tokens).long().to(dev), torch.from_numpy(weights).to(dev)


def _sync_all():
    for i in range(torch.cuda.device_count()):
        torch.cuda.synchronize(i)


def _timed_steps(trainer, it, steps=TRAIN_TIMED_STEPS) -> dict:
    """One warm-up step, then ``steps`` steps at B=256 through the feed
    ``it`` (``trainer.batches``; the caller closes it): the wait for each
    batch (decode, upload) and the step on the cards (synchronised), every
    step's loss (the warm-up's first), peak memory (the current card's, and
    every card's), and the kernels' launches."""
    from tpualign_torch.ops.attention import fused_mha
    from tpualign_torch.ops.normalize import normalize_u8

    feed_s, step_s, losses = [], [], []
    for i in range(steps + 1):
        if i == 1:
            _sync_all()
            for card in range(torch.cuda.device_count()):
                torch.cuda.reset_peak_memory_stats(card)
            fused_mha.launches = fused_mha.backward_recomputes = normalize_u8.launches = 0
        t0 = time.perf_counter()
        batch = _device_batch(trainer, next(it))
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        trainer.state, m = trainer._step(trainer.state, *batch)
        loss = float(m["loss"])
        losses.append(loss)
        _sync_all()
        t2 = time.perf_counter()
        check(np.isfinite(loss), f"timed step {i}: loss {loss}")
        if i:
            feed_s.append(t1 - t0)
            step_s.append(t2 - t1)
    step_ms = 1e3 * float(np.mean(step_s))
    feed_ms = 1e3 * float(np.mean(feed_s))
    return {"step_ms": step_ms, "feed_wait_ms": feed_ms, "step_ms_each": [1e3 * x for x in step_s],
            "losses": losses,
            "feed_share": feed_ms / (feed_ms + step_ms),
            "pairs_per_s_device": B / (step_ms / 1e3),
            "pairs_per_s_with_feed": B / ((step_ms + feed_ms) / 1e3),
            "peak_memory_gb": torch.cuda.max_memory_allocated() / 2**30,
            "peak_memory_gb_by_card": [torch.cuda.max_memory_allocated(i) / 2**30
                                       for i in range(torch.cuda.device_count())],
            "launches": {"fused_mha": fused_mha.launches,
                         "fused_mha_backward": fused_mha.backward_recomputes,
                         "normalize_u8": normalize_u8.launches}}


def _embed_env(env, ckpt_dir, quant, work, tag) -> dict:
    """The settings of ``embed`` from ``ckpt_dir`` (and ``CLIP_QUANT=quant``)
    into a fresh store of its own."""
    import os

    return {**env, "STORE_DIR": os.path.join(work, f"store-{tag}"), "CLIP_CHECKPOINT": ckpt_dir,
            "CLIP_QUANT": quant, "IMAGE_PREPROCESS": "device"}


def _embed_process(dev, embed_env, work, tag) -> tuple:
    """``embed vanilla_clip`` as a process under ``embed_env`` (from
    :func:`_embed_env`): (its wall s, launches)."""
    from tpualign_torch.store import SCHEMAS, EmbeddingStore

    EmbeddingStore(embed_env["STORE_DIR"], embed_dim=512).setup(SCHEMAS)
    secs, launches, done = _run_stage(["embed", "vanilla_clip", "--device", dev.type],
                                      embed_env, work, tag=f"-{tag}")
    check("Loading trained params from checkpoint directory" in done.stderr,
          f"embed ({tag}) did not load the checkpoint directory")
    return secs, launches


def _export_embeddings(dev, embed_env, train_env, ckpt_dir, records, images_dir,
                       tag) -> dict:
    """The embeddings of ``records`` by the stage's own engine (``embed_env``)
    carrying the export params of a trainer (configured by ``train_env``)
    restored from ``ckpt_dir``: ``{table: (key, records, embeddings)}``."""
    from tpualign_torch.config import load_config
    from tpualign_torch.models.convert import from_jax_params, to_jax_layout
    from tpualign_torch.pipeline import Pipeline
    from tpualign_torch.train.checkpoint import restore_checkpoint
    from tpualign_torch.train.trainer import Trainer

    trainer = Trainer(load_config(train_env), device=dev)
    check(restore_checkpoint(ckpt_dir, trainer.state) is not None, f"{tag}: nothing to restore")
    export = to_jax_layout(trainer.export_params)
    del trainer
    engine = Pipeline(load_config({**embed_env, "CLIP_CHECKPOINT": ""}), device=dev).engine
    from_jax_params(engine.model, export)
    images, chunks = records
    return {"images": ("image_id", images, engine.embed_image_records(images, images_dir)),
            "text_chunks": ("chunk_id", chunks, engine.embed_chunk_records(chunks))}


def _stored_like_export(embed_env, embedded, want, quant, tag) -> dict:
    """The store an ``_embed_process`` wrote against the export params'
    embeddings (:func:`_export_embeddings`), bit for bit."""
    from tpualign_torch.store import EmbeddingStore

    secs, launches = embedded
    store = EmbeddingStore(embed_env["STORE_DIR"], embed_dim=512)
    for table, (key, recs, embeddings) in want.items():
        ids, stored = store.embedding_matrix("vanilla_clip", table)
        row = {k: i for i, k in enumerate(ids)}
        stored = stored[[row[r[key]] for r in recs]]
        check(np.array_equal(stored, embeddings),
              f"{tag}: {int((stored != embeddings).any(axis=1).sum())} stored {table} "
              "embeddings differ from the export params'")
    return {"embed_s": secs, "images": len(want["images"][1]),
            "chunks": len(want["text_chunks"][1]), "quant": quant, "launches": launches,
            "bit_identical_to_export_params": True}


def _train_process(dev, env, work, tag, steps, extra_args=(), batch=B) -> tuple:
    import json
    import os

    ckpt_dir = os.path.join(work, f"ckpt-{tag}")
    metrics = os.path.join(work, f"metrics-{tag}.jsonl")
    argv = ["train", "--device", dev.type, "--steps", str(steps), "--train-batch-size", str(batch),
            "--ckpt-dir", ckpt_dir, "--metrics-file", metrics, "--log-every", "10",
            *extra_args]
    secs, launches, done = _run_stage(argv, env, work, tag=f"-{tag}")
    with open(metrics) as f:
        rows = [json.loads(line) for line in f]
    losses = [r["loss"] for r in rows if r["kind"] in ("train", "final")]
    check(losses and all(np.isfinite(losses)), f"train ({tag}): losses {losses}")
    final = rows[-1]
    check(final["kind"] == "final" and final["step"] == steps, f"train ({tag}): {final}")
    check(launches["fused_mha_backward"] == 24 * steps,
          f"train ({tag}): {launches['fused_mha_backward']} K1 backward recomputes in {steps} "
          "steps of 24 blocks (CLIP_REMAT off: one forward launch a block and step)")
    check(launches["normalize_u8"] == steps, f"train ({tag}): K5 launched "
          f"{launches['normalize_u8']} times in {steps} device-feed steps")
    return ckpt_dir, {"s": secs, "steps": steps, "losses": losses, "launches": launches,
                      "heldout": [r for r in rows if r["kind"] == "heldout"],
                      "final": final}


def phase_train(dev, seed, root, checkpoint, card) -> tuple:
    """Training on the pipeline phase's store (``clip_combined``'s weak
    pairs over its 2,048 images), the towers from the checkpoint: the card
    checks (K1's backward, ``matmul_f32acc``'s gradients, one step with K1
    against the plain attention, GRAD_ACCUM_STEPS=4 against the full
    batch), timed in-process steps with the host and the device feed, then
    ``python -m tpualign_torch train`` as processes side by side (6 steps
    with held-out evaluation, 3 with LORA_RANK=8 and 3 at
    CLIP_QUANT=int8_qat, those two at B=64), each checkpoint directory as
    ``CLIP_CHECKPOINT``
    for ``embed`` against the trainer's export params, bit for bit; beside
    the processes, the hnsw phase's ``index`` process. Returns its record
    and that process's future."""
    import dataclasses as dc
    import os

    from tpualign_torch.config import load_config
    from tpualign_torch.pipeline import Pipeline
    from tpualign_torch.train.trainer import Trainer, build_pair_dataset
    from tpualign_torch.utils.flops import clip_pair_flops, device_peak_flops

    work = os.path.join(root, "pipeline")
    env = _train_env(root, checkpoint, seed)
    gen = torch.Generator(device=dev).manual_seed(seed)
    out = {"phase": "train", "card": card, "model": "ViT-B-32", "batch": B}
    out["k1_backward"] = _k1_backward(dev, gen)
    out["matmul_f32acc_grads"] = _matmul_grads(dev, gen)

    trainer = Trainer(load_config(env), device=dev)
    triples = build_pair_dataset(trainer.store, "clip_combined", trainer.config.data.images_dir)
    check(len(triples) >= 4 * B, f"clip_combined has {len(triples)} trainable pairs")
    out["pairs"] = len(triples)
    it = trainer.batches(triples, B, seed=seed)
    try:
        batch = _device_batch(trainer, next(it))
    finally:
        it.close()
    cfg = trainer.config.train
    k1_step = _step_grads(trainer, cfg, batch, fused=True)
    out["step_k1_vs_plain"] = _compare_steps("one step, K1 against plain", k1_step,
                                             _step_grads(trainer, cfg, batch, fused=False))
    accum = _step_grads(trainer, dc.replace(cfg, grad_accum_steps=4), batch, fused=True)
    out["accum4_vs_full_batch"] = _compare_steps("GRAD_ACCUM_STEPS=4 against the full batch",
                                                 accum, k1_step)
    del k1_step, accum
    out["remat"] = _remat_step(trainer, cfg, batch)
    # a fresh feed: the timed steps wait on the first epoch's decode
    it = trainer.batches(triples, B, seed=seed)
    try:
        timed = {"device": _timed_steps(trainer, it)}
    finally:
        it.close()
    del trainer
    host = Trainer(load_config({**env, "TRAIN_IMAGE_FEED": "host"}), device=dev)
    it = host.batches(triples, B, seed=seed)
    try:
        timed["host"] = _timed_steps(host, it)
    finally:
        it.close()
    del host
    torch.cuda.empty_cache()
    peak = device_peak_flops(torch.cuda.get_device_name(0))
    step_flops = 3 * clip_pair_flops(load_config(env).model.variant) * B
    for row in timed.values():
        row["model_flop_share"] = (None if peak is None
                                   else step_flops / (row["step_ms"] / 1e3) / peak)
    out["timed"] = timed
    out["model_flops"] = {"per_step": step_flops, "peak": peak,
                          "peak_source": "NVIDIA H100 SXM data sheet, dense bf16 989 TFLOP/s "
                                         "(utils/flops.py)"}

    # (tag, training env, steps, extra flags, CLIP_QUANT for embed, batch)
    cases = (("full", env, TRAIN_STEPS, ("--eval-fraction", "0.05", "--eval-every",
                                         str(TRAIN_STEPS // 2)), "none", B),
             ("lora", {**env, "LORA_RANK": "8"}, TRAIN_SIDE_STEPS, (), "none", TRAIN_SIDE_B),
             ("int8_qat", {**env, "CLIP_QUANT": "int8_qat"}, TRAIN_SIDE_STEPS, (), "int8",
              TRAIN_SIDE_B))
    # the three processes side by side (a short run is mostly its process's
    # start), and beside them the hnsw phase's index process, which reads
    # vanilla_clip, which training leaves alone
    hnsw_index = _beside(_hnsw_index_cli, dev, _hnsw_env(root, seed, checkpoint), work)
    started = {tag: _beside(_train_process, dev, case_env, work, tag, steps, flags, batch)
               for tag, case_env, steps, flags, _, batch in cases}
    runs, ckpts = {}, {}
    for tag, run in started.items():
        ckpts[tag], runs[tag] = run.result()
    check(len(runs["full"]["heldout"]) == 3, f"held-out evaluations {runs['full']['heldout']}")
    out["processes"] = runs

    sub = {"OUTPUT_DIR": os.path.join(work, "run", "processed")}
    images, chunks, _ = Pipeline(load_config({**env, **sub}), device=dev)._load_processed()
    images_dir = os.path.join(sub["OUTPUT_DIR"], "images")
    embed_envs = {tag: _embed_env({**env, **sub}, ckpts[tag], quant, work, tag)
                  for tag, _, _, _, quant, _ in cases}
    embedded = {tag: _beside(_embed_process, dev, embed_envs[tag], work, tag)
                for tag, *_ in cases}
    # the export params' embeddings in this process while the processes run
    want = {tag: _export_embeddings(dev, embed_envs[tag], case_env, ckpts[tag],
                                    (images, chunks), images_dir, tag)
            for tag, case_env, *_ in cases}
    out["embed_from_checkpoint_dir"] = {
        tag: _stored_like_export(embed_envs[tag], embedded[tag].result(), want[tag], quant, tag)
        for tag, _, _, _, quant, _ in cases}
    emit(out)
    return out, hnsw_index


HNSW_TARGET = 0.95      # RETRIEVAL_RECALL_TARGET of the hnsw phase's index
HNSW_FP16_ROWS = 4096   # rows of the fp16 rung against fp32
HNSW_ADD_ROWS, HNSW_ADD_TEXTS = 4096, 64
HNSW_REMOVE_SHARE = 0.25
HNSW_CHECK_QUERIES = 256  # keyed image queries held against the exact index per step
HNSW_BPE_WORDS = 1500   # words whose letter chains make the tokenizer's merges table
HNSW_COLD_TEXTS = 1024  # texts of 8 words each, unseen by the tokenizer's caches


def _host_cpu() -> str:
    """The host CPU as /proc/cpuinfo names it (vendor, family and model
    where a virtual machine hides the model name), and the CPUs visible."""
    import os

    fields = {}
    try:
        with open("/proc/cpuinfo") as f:
            for line in f:
                key, _, value = line.partition(":")
                fields.setdefault(key.strip(), value.strip())
    except OSError:
        pass
    name = fields.get("model name", "unknown")
    if name == "unknown":
        name = (f"{fields.get('vendor_id', 'unknown')} family {fields.get('cpu family', '?')} "
                f"model {fields.get('model', '?')}")
    return f"{name}, {os.cpu_count()} CPUs"


def _words(rng, count):
    """Lower-case words of 3-12 letters, drawn by a Dutch-like frequency."""
    letters = np.array(list("eeeaaanrrtoodsilgkvhmubpwjzcf"))
    return ["".join(rng.choice(letters, int(n))) for n in rng.integers(3, 13, count)]


def _bpe_merges(path, words) -> int:
    """A merges table of letter chains: each word's letters merged left to
    right (the last one with ``</w>``), ranked by chain length, so that the
    greedy merge of one word meets other words' chains on its way."""
    from tpualign_torch.tokenizer.bpe import bytes_to_unicode

    enc = bytes_to_unicode()
    merges = set()
    for w in words:
        b = "".join(enc[x] for x in w.encode())
        for i in range(2, len(b) + 1):
            merges.add((i, b[:i - 1], b[i - 1] + ("</w>" if i == len(b) else "")))
    with open(path, "w", encoding="utf-8") as f:
        f.write("#version: letter chains\n")
        f.writelines(f"{left} {right}\n" for _, left, right in sorted(merges))
    return len(merges)


def _tokenizer_speed(merges, texts, rounds=2) -> dict:
    """Seconds per 1k texts of a fresh tokenizer (empty caches) with the
    native merge core and without it, best of ``rounds`` rounds in turns
    (native first, then Python first); the ids must be identical."""
    from tpualign_torch.tokenizer.bpe import ClipTokenizer

    best, ids = {}, {}
    for r in range(rounds):
        for path in (("native", "python") if r % 2 == 0 else ("python", "native")):
            tok = ClipTokenizer(bpe_path=merges)
            check(tok._bpe_core is not None, "the native BPE core did not load")
            if path == "python":
                tok._bpe_core = None
            t0 = time.perf_counter()
            ids[path] = tok(texts)
            secs = time.perf_counter() - t0
            best[path] = min(best.get(path, secs), secs)
    check(np.array_equal(ids["native"], ids["python"]), "native and Python BPE ids differ")
    return {"texts": len(texts), "native_s_per_1k": best["native"] / len(texts) * 1e3,
            "python_s_per_1k": best["python"] / len(texts) * 1e3,
            "speedup": best["python"] / best["native"]}


def _native_speedups(seed, work, chunk_texts, terms) -> dict:
    """The native library on the card's host: the tokenizer with and
    without its BPE merge core (the slice's texts, then texts of words no
    cache has seen), the lexical counts native and in Python over the
    store's chunks and vocabulary."""
    import os

    import tpualign_torch.weaksup.lexical as lexical
    from tpualign_torch.native import bindings

    check(bindings.native_available(), "the native library did not build or load")
    rng = np.random.default_rng(seed + 10)
    merges = os.path.join(work, "letter_chains.merges.txt")
    slice_texts = _chunk_texts(np.random.default_rng(seed), 8192)
    slice_words = sorted({w for t in slice_texts for w in t.lower().split()})
    out = {"merges": _bpe_merges(merges, _words(rng, HNSW_BPE_WORDS) + slice_words)}
    cold = [" ".join(_words(rng, 8)) for _ in range(HNSW_COLD_TEXTS)]
    out["tokenizer_slice_texts"] = _tokenizer_speed(merges, slice_texts)
    out["tokenizer_cold_words"] = _tokenizer_speed(merges, cold)

    t0 = time.perf_counter()
    native = lexical.lexical_match_counts(chunk_texts, terms)
    native_s = time.perf_counter() - t0
    real = lexical.lexical_counts
    lexical.lexical_counts = lambda texts, terms: None  # the Python loop
    try:
        t0 = time.perf_counter()
        python = lexical.lexical_match_counts(chunk_texts, terms)
        python_s = time.perf_counter() - t0
    finally:
        lexical.lexical_counts = real
    differ = np.flatnonzero(native != python)
    out["lexical"] = {"chunks": len(chunk_texts), "terms": len(terms), "native_s": native_s,
                      "python_s": python_s, "speedup": python_s / native_s,
                      "native_sum": int(native.sum()), "python_sum": int(python.sum()),
                      "texts_that_differ": len(differ),
                      "first_differences": [{"text": chunk_texts[i], "native": int(native[i]),
                                             "python": int(python[i])} for i in differ[:3]]}
    return out


_TIMED_INDEX = READY + """
import atexit, json, runpy, sys, time
from tpualign_torch.parallel import hnsw
spans = {"build_s": 0.0, "calibrate_s": 0.0}
def timed(fn, key):
    def wrapper(*args, **kwargs):
        t0 = time.perf_counter()
        try:
            return fn(*args, **kwargs)
        finally:
            spans[key] += time.perf_counter() - t0
    return wrapper
hnsw.HNSWIndex.__init__ = timed(hnsw.HNSWIndex.__init__, "build_s")
hnsw.HNSWIndex.calibrate = timed(hnsw.HNSWIndex.calibrate, "calibrate_s")
path = sys.argv[1]
def _dump():
    with open(path, "w") as f:
        json.dump(spans, f)
atexit.register(_dump)
sys.argv = ["tpualign_torch"] + sys.argv[2:]
runpy.run_module("tpualign_torch", run_name="__main__", alter_sys=True)
"""


def _hnsw_index_cli(dev, env, work) -> dict:
    """``python -m tpualign_torch index`` under RETRIEVAL_INDEX=hnsw as a
    subprocess, the graph's build and its calibration timed inside it.
    Returns its JSON line with the times and the recall the calibration
    logged."""
    import os
    import re

    spans = os.path.join(work, "hnsw_index_spans.json")
    repo = os.path.dirname(os.path.abspath(__file__))
    path = os.pathsep.join(p for p in (repo, os.environ.get("PYTHONPATH")) if p)
    t0, spawned = time.perf_counter(), time.time()
    out = subprocess.run([sys.executable, "-c", _TIMED_INDEX, spans, "index", "--schema",
                          "vanilla_clip", "--device", dev.type], capture_output=True, text=True,
                         timeout=900, cwd=work, env=dict(os.environ, PYTHONPATH=path, **env))
    wall = time.perf_counter() - t0
    child_done("index_hnsw", spawned, out.stderr)
    check(out.returncode == 0, f"index exited {out.returncode}: {out.stderr[-3000:]}")
    line = json.loads(out.stdout.strip().splitlines()[-1])
    with open(spans) as f:
        line.update(json.load(f))
    got = re.search(r"HNSW calibration: (?:ef_search=\d+ reaches recall@\d+ ([0-9.]+)"
                    r"|recall@\d+ ([0-9.]+) at the ef cap)", out.stderr)
    check(got is not None, f"index logged no calibration: {out.stderr[-2000:]}")
    line.update(achieved_recall=float(got.group(1) or got.group(2)),
                target_reached=got.group(1) is not None, wall_s=wall)
    return line


def _unit64(x):
    x = np.asarray(x, np.float64)
    return x / np.maximum(np.linalg.norm(x, axis=-1, keepdims=True), 1e-12)


def _score_error(index, queries, vals, idx) -> float:
    """Largest gap between a returned score and the float64 dot of the unit
    query and the unit stored row."""
    err = 0.0
    for q, v, i in zip(_unit64(queries), vals, idx):
        keep = i >= 0
        if keep.any():
            want = _unit64(index._corpus[i[keep]].astype(np.float32)) @ q
            err = max(err, float(np.abs(want - v[keep]).max()))
    return err


def _against_exact(dev, got, queries, qk, rows, manuals, pages, what) -> float:
    """Keyed results ``got`` (values, row indices into ``rows``) against a
    fresh exact fp32 ``RetrievalIndex`` over ``rows`` (K2 on the card):
    indices identical outside value ties, values within K2_TOL_VALUES.
    Returns the largest value gap."""
    from tpualign_torch.parallel import RetrievalIndex

    vals, idx = got
    exact = RetrievalIndex(rows, manuals, pages, device=dev)
    rvals, ridx = exact.search_encoded(np.asarray(queries, np.float32),
                                       np.asarray(qk, np.int32), idx.shape[1])
    return compare_topk(*(torch.from_numpy(np.ascontiguousarray(a))
                          for a in (vals, idx, rvals, ridx)), what)


def _hnsw_live(dev, service, images, img_emb, rows, manuals, pages, seed) -> list:
    """/add by embeddings and by text, /remove of a quarter of the rows and
    /compact on the HNSW service behind HTTP; after each step the served
    keyed answers equal the index's own, and an exact index's over the
    live rows."""
    import urllib.request

    from tpualign_torch.parallel.retrieval import encode_keys
    from tpualign_torch.serving.server import _ServiceBox, serve_schemas

    rng = np.random.default_rng(seed + 20)
    live = _LiveRows(rows, service.chunk_ids, manuals, pages)
    sel = rng.choice(len(images), HNSW_ADD_ROWS)
    noise = rng.normal(size=(HNSW_ADD_ROWS, img_emb.shape[1])) / np.sqrt(img_emb.shape[1])
    add_emb = _unit64(img_emb[sel] + 0.3 * noise).astype(np.float32)
    text_sel = rng.choice(len(images), HNSW_ADD_TEXTS)
    texts = [f"vervang onderdeel {i} van de pomp" for i in range(HNSW_ADD_TEXTS)]
    probe = np.concatenate([rng.choice(len(images), HNSW_CHECK_QUERIES - 64, replace=False),
                            sel[:32], text_sel[:32]])
    probe_ids = [images[i]["image_id"] for i in probe]
    httpd = serve_schemas({"vanilla_clip": _ServiceBox(service)}, "vanilla_clip",
                          "127.0.0.1", 0)
    server = threading.Thread(target=httpd.serve_forever, daemon=True)
    server.start()
    base = f"http://127.0.0.1:{httpd.server_address[1]}"
    steps = []

    def step(name, path, payload, apply):
        got, secs = _timed_post(base, path, payload)
        apply()
        index = service.index
        q = img_emb[probe]
        qk = encode_keys([images[i]["manual_id"] for i in probe],
                         [images[i]["page"] for i in probe], dict(index.vocab))[0]
        vals, idx = index.search_encoded(q, np.asarray(qk, np.int64), 10)
        served = _post(base, "/search_image", {"image_ids": probe_ids, "k": 10})["results"]
        check(_as_pairs(served) == _pairs(vals, idx, service.chunk_ids),
              f"hnsw {name}: /search_image differs from the index's search")
        # the index's rows (tombstones included until /compact) mapped to
        # positions among the live rows, by chunk id
        at = {live.ids[r]: j for j, r in enumerate(live.order)}
        live_idx = np.asarray([[at[service.chunk_ids[i]] if i >= 0 else -1 for i in row]
                               for row in idx], np.int64)
        err = _against_exact(dev, (vals, live_idx), q, qk, live.rows()[live.order],
                             [live.manuals[r] for r in live.order],
                             [live.pages[r] for r in live.order], f"hnsw {name}")
        steps.append({"step": name, "s": secs, "answer": got, "n": index.n,
                      "dead": index.dead, "max_abs_err_vs_exact": err})

    try:
        step("add_embeddings", "/add",
             {"chunk_ids": [f"hnsw-add-{i}" for i in range(HNSW_ADD_ROWS)],
              "manuals": [images[i]["manual_id"] for i in sel],
              "pages": [images[i]["page"] for i in sel], "embeddings": add_emb.tolist()},
             lambda: live.add(add_emb, [f"hnsw-add-{i}" for i in range(HNSW_ADD_ROWS)],
                              [images[i]["manual_id"] for i in sel],
                              [images[i]["page"] for i in sel]))
        step("add_texts", "/add",
             {"chunk_ids": [f"hnsw-text-{i}" for i in range(HNSW_ADD_TEXTS)],
              "manuals": [images[i]["manual_id"] for i in text_sel],
              "pages": [images[i]["page"] for i in text_sel], "texts": texts},
             lambda: live.add(np.stack([service.text_encoder.seen[t][-1] for t in texts]),
                              [f"hnsw-text-{i}" for i in range(HNSW_ADD_TEXTS)],
                              [images[i]["manual_id"] for i in text_sel],
                              [images[i]["page"] for i in text_sel]))
        ids_now = [live.ids[r] for r in live.order]
        gone = [ids_now[i] for i in rng.choice(len(ids_now), int(HNSW_REMOVE_SHARE
                                                                 * len(ids_now)), replace=False)]
        step("remove", "/remove", {"chunk_ids": gone}, lambda: live.remove(gone))
        step("compact", "/compact", {}, lambda: None)
        stats = json.loads(urllib.request.urlopen(f"{base}/stats", timeout=60).read())
    finally:
        httpd.shutdown()
        httpd.server_close()
        server.join()
    check(steps[-1]["dead"] == 0 and stats["hnsw"]["live"] == stats["corpus_size"]
          == len(live.order), f"after /compact: {stats['hnsw']}")
    return steps


def _hnsw_fp16(dev, rows, manuals, pages, images, img_emb) -> dict:
    """The fp16 rung (pgvector's halfvec) against fp32 over the first
    HNSW_FP16_ROWS rows: memory, wildcard recall@10 of both against the
    exact top-10, and keyed answers against an exact index over the
    fp16-rounded rows."""
    from tpualign_torch.parallel.hnsw import HNSWIndex, _normalize
    from tpualign_torch.parallel.retrieval import WILDCARD_KEY, encode_keys

    n = HNSW_FP16_ROWS
    rows, manuals, pages = rows[:n], manuals[:n], pages[:n]
    out = {"rows": n}
    built = {}
    for precision in ("fp32", "fp16"):
        t0 = time.perf_counter()
        built[precision] = HNSWIndex(rows, manuals, pages, precision=precision)
        out[f"{precision}_build_s"] = time.perf_counter() - t0
        out[f"{precision}_memory_bytes"] = built[precision].memory_bytes()
    kept = set(manuals)
    mine = [i for i, im in enumerate(images) if im["manual_id"] in kept][:HNSW_CHECK_QUERIES]
    q = _normalize(img_emb[mine])
    exact = np.argsort(-(q @ _normalize(rows).T), axis=1, kind="stable")[:, :10]
    wild = np.full(len(q), WILDCARD_KEY, np.int64)
    for precision, index in built.items():
        _, idx = index.search_encoded(q, wild, 10)
        out[f"{precision}_recall_at_10"] = float(np.mean(
            [len(set(a) & set(b)) / 10 for a, b in zip(idx, exact)]))
    qk = encode_keys([images[i]["manual_id"] for i in mine], [images[i]["page"] for i in mine],
                     dict(built["fp16"].vocab))[0]
    rounded = _normalize(rows).astype(np.float16).astype(np.float32)
    out["keyed_max_abs_err_vs_rounded_exact"] = _against_exact(
        dev, built["fp16"].search_encoded(q, np.asarray(qk, np.int64), 10), q, qk, rounded,
        manuals, pages, "hnsw fp16 keyed")
    return out


def _calibrate_cli(dev, env, store_dir) -> dict:
    """``calibrate --schema clip_combined``: a dry run through the CLI's
    ``main`` in this process, then ``python -m tpualign_torch calibrate
    --write`` as a subprocess; the pairs each counts, the written scores
    against an in-process float64 fit of the same pairs (bit-equal after
    the float32 cast; monotone in the raw scores; the fit keeps the sum of
    the pair cosines)."""
    import contextlib
    import io
    import os

    from tpualign_torch.cli import main as cli_main

    from tpualign_torch.store import EmbeddingStore
    from tpualign_torch.weaksup.calibration import apply_calibration, fit_isotonic

    schema = "clip_combined"
    store = EmbeddingStore(store_dir, embed_dim=512)
    raw_rows = store.alignments(schema)
    img_ids, img = store.embedding_matrix(schema, "images")
    chunk_ids, chunk = store.embedding_matrix(schema, "text_chunks")
    ipos = {k: i for i, k in enumerate(img_ids)}
    cpos = {k: i for i, k in enumerate(chunk_ids)}
    pairs = [(a, b, s) for a, b, s, _ in raw_rows if a in ipos and b in cpos]
    raw = np.asarray([s for _, _, s in pairs])
    cos = np.einsum("nd,nd->n", img[[ipos[a] for a, _, _ in pairs]],
                    chunk[[cpos[b] for _, b, _ in pairs]]).astype(np.float64)
    knots = fit_isotonic(raw, cos)
    fit64 = np.interp(raw, *knots)
    out = {"pairs": len(pairs)}
    printed = io.StringIO()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(printed):
        code = cli_main(["calibrate", "--schema", schema, "--store-dir", store_dir,
                         "--env-file", ""])
    out["dry_run_in_process_s"] = time.perf_counter() - t0
    t0, spawned = time.perf_counter(), time.time()
    cli = subprocess.run([sys.executable, "-c", CLI, "calibrate", "--schema",
                          schema, "--write"], capture_output=True, text=True, timeout=600,
                         env=dict(os.environ, **env))
    out["write_process_s"] = time.perf_counter() - t0
    child_done("calibrate", spawned, cli.stderr)
    check(code == 0 and cli.returncode == 0,
          f"calibrate exited {code}, with --write {cli.returncode}: {cli.stderr[-2000:]}")
    for tag, line in (("dry_run", printed.getvalue()), ("write", cli.stdout)):
        check(line.startswith(f"calibrated {len(pairs)} pairs: "),
              f"calibrate printed {line!r}, the store holds {len(pairs)} pairs")
        out[f"{tag}_line"] = line.strip()
    written = {(a, b): s for a, b, s, _ in EmbeddingStore(store_dir, embed_dim=512)
               .alignments(schema)}
    new = np.asarray([written[(a, b)] for a, b, _ in pairs])
    check(np.array_equal(new.astype(np.float32), apply_calibration(raw, knots)),
          "the written scores differ from the float64 fit cast to float32")
    order = np.argsort(raw, kind="stable")
    check(bool(np.all(np.diff(new[order]) >= 0)), "written scores are not monotone in raw")
    rel = abs(fit64.sum() - cos.sum()) / abs(cos.sum())
    check(rel <= 1e-9, f"the fit's sum is {rel:.3g} off the pair cosines' (relative)")
    out.update(knots=len(knots[0]), fit_sum_rel_err=rel,
               written_sum_rel_err=abs(new.sum() - cos.sum()) / abs(cos.sum()),
               raw_levels=len(np.unique(raw)), fitted_levels=len(np.unique(fit64)))
    return out


def _hnsw_env(root, seed, checkpoint) -> dict:
    """The hnsw phase's settings over the pipeline store."""
    import os

    store_dir = os.path.join(root, "pipeline", "store")
    return {"STORE_DIR": store_dir, "RETRIEVAL_INDEX": "hnsw",
            "HNSW_CACHE": os.path.join(root, "pipeline", "vanilla_clip.hnsw.npz"),
            "RETRIEVAL_RECALL_TARGET": str(HNSW_TARGET), "CLIP_MODEL": "ViT-B-32",
            "SEED": str(seed), "CLIP_CHECKPOINT": checkpoint}


def phase_hnsw(dev, seed, root, checkpoint, card, index_cli) -> dict:
    """RETRIEVAL_INDEX=hnsw over the pipeline phase's store (after
    ``train``, which reads the weak scores ``calibrate --write`` rewrites):
    the native library (tokenizer and lexical counts, native against
    Python), ``index`` as a subprocess (build, calibration to
    HNSW_TARGET, artifact; ``index_cli``, the future of
    :func:`_hnsw_index_cli`, started beside the train processes), the
    service loading it with the towers from
    the checkpoint and every served answer against a direct search, the
    exact index and the unit rows' dots, the mutations, the fp16 rung, and
    ``calibrate``. Returns K1's launches around the clients' run."""
    import os

    import tpualign_torch.parallel.hnsw as hnsw_mod
    from tpualign_torch.config import load_config
    from tpualign_torch.ops.attention import fused_mha
    from tpualign_torch.parallel.retrieval import WILDCARD_KEY, encode_keys
    from tpualign_torch.serving.server import build_service, make_engine, make_image_bytes_encoder
    from tpualign_torch.store import EmbeddingStore

    work = os.path.join(root, "pipeline")
    store_dir = os.path.join(work, "store")
    out = {"phase": "hnsw", "card": card, "host_cpu": _host_cpu(), "model": "ViT-B-32"}
    store = EmbeddingStore(store_dir, embed_dim=512)
    chunks = store.chunks("vanilla_clip")
    with open(os.path.join(work, "processed", "filtered_lexical_components.json")) as f:
        terms = [c["term"] for c in json.load(f)["components"]]
    env = _hnsw_env(root, seed, checkpoint)
    out["native"] = _native_speedups(seed, work, [c["text"] for c in chunks], terms)
    config = load_config(env)
    engine = make_engine(config, dev)
    line = index_cli.result()
    check(line["index"] == "hnsw" and line["n"] == len(chunks) and line["precision"] == "fp32",
          f"index printed {line}")
    line["build_s_per_1k_rows"] = line["build_s"] / line["n"] * 1e3
    line["calibrate_s_per_1k_rows"] = line["calibrate_s"] / line["n"] * 1e3
    out["index"] = line

    builds = []
    make_core = hnsw_mod.make_hnsw_core
    hnsw_mod.make_hnsw_core = lambda *a, **k: builds.append(1) or make_core(*a, **k)
    try:
        text_enc = _Recorder(engine.encode_text_batch)
        image_enc = _Recorder(make_image_bytes_encoder(engine))
        t0 = time.perf_counter()
        service = build_service(config, "vanilla_clip", encoder=text_enc,
                                image_encoder=image_enc, device=dev)
        out["service_load_s"] = time.perf_counter() - t0
    finally:
        hnsw_mod.make_hnsw_core = make_core
    index = service.index
    check(not builds and type(index).__name__ == "HNSWIndex"
          and index.ef_search == line["ef_search"] and index.calibrated_target == HNSW_TARGET,
          f"the service did not load the artifact ({len(builds)} graph builds)")
    images = store.images("vanilla_clip")
    img_emb = service._image_embs
    rng = np.random.default_rng(seed)
    pngs = [_png(rng) for _ in range(4)]
    run = _drive(service, images, pngs, (fused_mha,))
    check(run["stats"].get("hnsw", {}).get("ef_search") == index.ef_search,
          f"/stats has no hnsw block: {sorted(run['stats'])}")
    check(run["launches"]["fused_mha"] > 0, "K1 was not launched while serving hnsw")

    def direct(ix, emb, keys):
        return ix.search_encoded(np.asarray(emb, np.float32), np.asarray(keys, np.int64), 10)

    out["answers_checked"] = _check_answers(run, service, images, pngs, text_enc, image_enc,
                                            direct)
    _, rows = store.embedding_matrix("vanilla_clip", "text_chunks")
    manuals = store.column("vanilla_clip", "text_chunks", "manual_id")
    pages = store.column("vanilla_clip", "text_chunks", "page")
    qk = np.asarray(encode_keys([im["manual_id"] for im in images],
                                [im["page"] for im in images], dict(index.vocab))[0], np.int64)
    keyed = index.search_encoded(img_emb, qk, 10)
    out["keyed_max_abs_err_vs_exact"] = _against_exact(dev, keyed, img_emb, qk, rows, manuals,
                                                       pages, "hnsw keyed image queries")
    text_q = np.stack([e for embs in text_enc.seen.values() for e in embs])
    few = img_emb[:HNSW_CHECK_QUERIES]
    errs = [_score_error(index, img_emb, *keyed)] + [
        _score_error(index, q, *index.search_encoded(q, np.full(len(q), WILDCARD_KEY), 10))
        for q in (few, text_q)]
    check(max(errs) <= 1e-5, f"returned scores off the unit rows' dots by {max(errs):.3g}")
    out["score_max_abs_err"] = max(errs)
    serial = {kind: [r["s"] for r in run["serial"] if r["kind"] == kind]
              for kind in SERVE_KINDS}
    out.update(clients=SERVE_CLIENTS, requests=len(run["results"]), wall_s=run["wall"],
               qps=len(run["results"]) / run["wall"], endpoints=run["endpoints"],
               alone={kind: {"p50_ms": _pct(lat, 0.5), "p99_ms": _pct(lat, 0.99)}
                      for kind, lat in serial.items() if lat},
               stats_hnsw=run["stats"]["hnsw"], launches=run["launches"])

    out["live"] = _hnsw_live(dev, service, images, img_emb, rows, manuals, pages, seed)
    del service
    # calibrate (its dry run, then its --write process) beside the fp16 rung:
    # neither reads what the other writes
    calibrate = _beside(_calibrate_cli, dev, {"STORE_DIR": store_dir, "CLIP_MODEL": "ViT-B-32"},
                        store_dir)
    out["fp16"] = _hnsw_fp16(dev, rows, manuals, pages, images, img_emb)
    out["calibrate"] = calibrate.result()
    emit(out)
    return run["launches"]


# the mesh phase: a 4-way data mesh (four distinct cards where the host has
# them, else the first card four times) over the serve phase's store
MESH_SHARDS = 4
MESH_QUERIES = 256        # keyed image queries, and as many wildcard ones
MESH_FP32_ROWS = 100_000  # the fp32 index: the first rows of the store
MESH_ADD = 4096
MESH_REMOVE_SHARE = 0.25
MESH_REQUESTS = 16        # serial /search_image and /search_text requests a service
MESH_PROBE_REQUESTS = 32  # serial requests a route, each serve daemon (four cards)
MESH_IVF_TARGET = 0.95    # the sharded IVF index's recall target (RETRIEVAL_RECALL_TARGET)
# replicas run the same kernels on the same weights: their embeddings read
# 0 (images) and 1.5e-8 (chunks) from one device's on one card and on four
MESH_REPLICA_ATOL = 1e-5


def _mesh(dev):
    """The mesh phase's mesh and what it stands on."""
    from tpualign_torch.parallel import create_mesh

    if torch.cuda.device_count() >= MESH_SHARDS:
        return create_mesh(MESH_SHARDS), f"{MESH_SHARDS} distinct cards"
    return (create_mesh(MESH_SHARDS, devices=[dev] * MESH_SHARDS),
            f"card 0 repeated {MESH_SHARDS} times (one card visible)")


def _counters():
    from tpualign_torch.ops.attention import fused_mha
    from tpualign_torch.ops.ivf_topk import ivf_probe_topk
    from tpualign_torch.ops.normalize import normalize_u8
    from tpualign_torch.ops.sim_topk import masked_sim_topk, masked_sim_topk_quant

    return (fused_mha, masked_sim_topk, masked_sim_topk_quant, ivf_probe_topk, normalize_u8)


def _on_mesh(tally, fn, *args, **kw):
    """``fn`` on the mesh path, the kernels' counts set to 0 just before and
    read just after into ``tally``; returns fn's result and its seconds
    (host clock, ended by a synchronize of every card)."""
    torch.cuda.synchronize()
    for f in _counters():
        f.launches = 0
    t0 = time.perf_counter()
    out = fn(*args, **kw)
    for i in range(torch.cuda.device_count()):
        torch.cuda.synchronize(i)
    s = time.perf_counter() - t0
    for f in _counters():
        tally[f.__name__] = tally.get(f.__name__, 0) + f.launches
    return out, s


def _same_search(got, want, what) -> float:
    """Indices identical, values within 1e-6 (equal expected); returns the
    largest value gap."""
    (v, i), (wv, wi) = got, want
    check(np.array_equal(i, wi), f"{what}: indices differ from the one-device index "
                                 f"({int((i != wi).sum())} slots)")
    has = wi >= 0
    gap = float(np.abs(v[has] - wv[has]).max()) if has.any() else 0.0
    check(gap <= 1e-6, f"{what}: values differ by {gap:.3g}")
    return gap


def phase_mesh_evaluator(dev, store_dir, work, schemas, mesh, tally) -> dict:
    """Evaluator(mesh=) over ``schemas`` of the store in ``store_dir`` (the
    pipeline phase's: 4 schemas, 2,048 images, 16,384 chunks): its
    metrics.json (written under ``work``) against the one-device
    Evaluator's, equal."""
    import contextlib
    import io
    import os

    from tpualign_torch.evaluation import Evaluator
    from tpualign_torch.store import EmbeddingStore

    store = EmbeddingStore(store_dir, embed_dim=512)
    metrics, seconds = {}, {}
    for name, kw in (("one_device", dict(device=dev)), ("mesh", dict(mesh=mesh))):
        out = os.path.join(work, f"eval-{name}")

        def report():
            with contextlib.redirect_stdout(io.StringIO()):
                Evaluator(store, output_dir=out, **kw).print_metrics_report(list(schemas))

        if name == "mesh":
            seconds[name] = _on_mesh(tally, report)[1]
        else:
            t0 = time.perf_counter()
            report()
            seconds[name] = time.perf_counter() - t0
        with open(os.path.join(out, "metrics.json")) as f:
            metrics[name] = json.load(f)
    check(metrics["mesh"] == metrics["one_device"],
          "Evaluator(mesh=)'s metrics.json differs from the one-device Evaluator's")
    check(set(metrics["mesh"]) == set(schemas), f"metrics for {sorted(metrics['mesh'])}")
    return {"schemas": len(metrics["mesh"]), "metrics_equal": True, "seconds": seconds}


def _mesh_indexes(dev, mesh, tally, shared, queries) -> dict:
    """The sharded index against the one-device index over the 1M-chunk
    store: int8 and int4 (gather, streaming) over every row, fp32 (gather,
    streaming, ring) over the first MESH_FP32_ROWS; keyed and wildcard
    queries at k=10 and k=100; the search ms of each strategy. Returns
    those rows and the sharded int8 index (the mutations' start)."""
    from tpualign_torch.parallel.retrieval import RetrievalIndex

    chunk_emb, manuals, pages = shared["chunk_emb"], shared["manuals"], shared["pages"]
    (q_img, qman, qpg), q_wild = queries
    out, gap = {}, 0.0
    for precision, rows, strategies in (("int8", None, ("gather", "streaming")),
                                        ("int4", None, ("gather", "streaming")),
                                        ("fp32", MESH_FP32_ROWS, ("gather", "streaming", "ring"))):
        sel = slice(None, rows)
        t0 = time.perf_counter()
        one = RetrievalIndex(chunk_emb[sel], manuals[sel], pages[sel], precision=precision,
                             device=dev)
        torch.cuda.synchronize()
        one_s = time.perf_counter() - t0
        sharded, mesh_s = _on_mesh(tally, RetrievalIndex, chunk_emb[sel], manuals[sel],
                                   pages[sel], precision=precision, mesh=mesh)
        check(sharded._corpus.devices == mesh.data_devices, f"{precision}: shards misplaced")
        ms = {}
        for k in (10, 100):
            for what, q, kw in (("keyed", q_img, dict(query_manuals=qman, query_pages=qpg)),
                                ("wildcard", q_wild, dict(global_search=True))):
                one.search(q, k=k, **kw)  # warm-up, untimed
                t0 = time.perf_counter()
                want = one.search(q, k=k, **kw)
                ms.setdefault("one_device", {})[f"{what}_k{k}"] = (time.perf_counter() - t0) * 1e3
                for strategy in strategies:
                    sharded.search(q, k=k, strategy=strategy, **kw)  # warm-up, untimed
                    got, s = _on_mesh(tally, sharded.search, q, k=k, strategy=strategy, **kw)
                    ms.setdefault(strategy, {})[f"{what}_k{k}"] = s * 1e3
                    gap = max(gap, _same_search(got, want, f"{precision} {strategy} {what} k={k}"))
        out[precision] = {"N": sharded.n, "n_local": sharded._n_local, "build_s": mesh_s,
                          "one_device_build_s": one_s, "search_ms": ms}
        if precision == "int8":
            int8_index = sharded
        del one, sharded
    out["max_value_gap"] = gap
    return out, int8_index


def _mesh_mutations(dev, sharded, tally, shared, queries, seed) -> dict:
    """add of MESH_ADD rows (past the capacity: the shards regrow), remove
    of a quarter and compact on ``sharded`` (the int8 mesh index over the
    store), each step's searches against a fresh one-device index over the
    live rows."""
    from tpualign_torch.parallel.retrieval import RetrievalIndex

    chunk_emb, manuals, pages = shared["chunk_emb"], shared["manuals"], shared["pages"]
    q_img, qman, qpg = queries[0]
    rng = np.random.default_rng(seed + 7)
    new = chunk_emb[rng.choice(len(chunk_emb), MESH_ADD, replace=False)]
    new = new + 0.05 * rng.normal(size=new.shape).astype(np.float32)
    new /= np.linalg.norm(new, axis=1, keepdims=True)
    new_pages = rng.integers(0, SERVE_PAGES, MESH_ADD)
    new_man = [manuals[int(i)] for i in rng.integers(0, len(manuals), MESH_ADD)]
    rows = np.concatenate([chunk_emb, new])
    man, pg = list(manuals) + new_man, list(pages) + [int(p) for p in new_pages]
    _, add_s = _on_mesh(tally, sharded.add, new, new_man, [int(p) for p in new_pages])
    steps = {"add": {"N": sharded.n, "n_local": sharded._n_local, "s": add_s}}

    def against_fresh(live, what):
        """The mesh index (its ids are positions in ``live``) against a
        fresh one-device index over the live rows."""
        fresh = RetrievalIndex(rows[live], [man[i] for i in live], [pg[i] for i in live],
                               precision="int8", device=dev)
        for k in (10, 100):
            for kw in (dict(query_manuals=qman, query_pages=qpg), dict(global_search=True)):
                got, _ = _on_mesh(tally, sharded.search, q_img, k=k, **kw)
                _same_search(got, fresh.search(q_img, k=k, **kw), f"int8 mesh after {what}, "
                                                                  f"k={k}")

    against_fresh(np.arange(len(rows)), "add")
    gone = rng.choice(len(rows), int(MESH_REMOVE_SHARE * len(rows)), replace=False)
    removed, remove_s = _on_mesh(tally, sharded.remove, gone)
    check(removed == len(gone) and sharded.dead == len(gone), f"removed {removed}")
    live, compact_s = _on_mesh(tally, sharded.compact)
    check(np.array_equal(live, np.setdiff1d(np.arange(len(rows)), gone)), "compact's survivors")
    against_fresh(live, "remove and compact")
    steps["remove"] = {"rows": int(removed), "s": remove_s}
    steps["compact"] = {"N": sharded.n, "n_local": sharded._n_local, "s": compact_s}
    return steps


def _plain_sharded_ivf(index, q, qk, k, n_probes):
    """The plain path of a sharded IVF search: on every shard its probes
    and union, the plain K4 version over its layout (query slabs of
    K4_SLAB), the packed rows mapped to global ids, then the shards'
    winners merged by (value desc, id asc) on the first device, as the
    index merges them. Returns device (vals, ids), (NEG_INF, -1) empty."""
    from tpualign_torch.ops.ivf_topk import ivf_probe_topk_reference
    from tpualign_torch.ops.similarity import NEG_INF
    from tpualign_torch.parallel.ivf import _probe, _union
    from tpualign_torch.parallel.retrieval import _two_key_topk

    ll, vals, ids = index.n_lists_local, [], []
    for s, dev in enumerate(index._devices):
        qs, qks = q.to(dev), qk.to(dev)
        probe = _probe(qs, qks, index.centroids.parts[s], n_probes, ll)
        uids = _union(probe, ll, index.spill_blocks)
        emb, keys, pids = index._emb.parts[s], index._keys.parts[s], index._ids.parts[s]
        scales = None if index._scales is None else index._scales.parts[s]
        v, pidx = _k4_slabs(lambda a, b, c: ivf_probe_topk_reference(
            a, b, c, uids, emb, keys, k, index.capacity, ll, packed_scales=scales,
            int8_mxu=index.int8_mxu and scales is not None), qs, qks, probe)
        empty = pidx >= 2**30
        i = pids[pidx.clamp(max=len(pids) - 1).long()].long()
        vals.append(torch.where(empty, torch.full_like(v, NEG_INF), v).to(index.device))
        ids.append(torch.where(empty, torch.full_like(i, -1), i).to(index.device))
    return _two_key_topk(torch.cat(vals, dim=1), torch.cat(ids, dim=1), k)


def _plain_sharded_refined(index, emb, keys, k=10):
    """_plain_sharded_ivf for k*refine candidates at the index's probes,
    then the exact host rescore: host (vals, idx) as ``index.search``."""
    from tpualign_torch.parallel.retrieval import NEG_INF, _refine_rescore

    kf = min(k * max(1, index.refine), index.n)
    q = torch.from_numpy(np.ascontiguousarray(emb, np.float32)).to(index.device)
    qk = torch.from_numpy(np.asarray(keys, np.int32)).to(index.device)
    _, idx = _plain_sharded_ivf(index, q, qk, kf, index.n_probes)
    idx = idx.cpu().numpy()
    vals = np.where(idx >= 0, 0.0, NEG_INF).astype(np.float32)
    return _refine_rescore(np.asarray(emb, np.float32), vals, idx, index._refine_corpus, k)


def _host_topk(got, want, what) -> float:
    """compare_topk over host (vals, idx) pairs."""
    return compare_topk(*(torch.from_numpy(np.asarray(x)) for x in (*got, *want)), what)


def _mesh_ivf(dev, mesh, tally, shared, queries, seed, root) -> dict:
    """The sharded IVF index (int8, the default geometry: MESH_SHARDS
    shards of 256 lists) over the store's 1,000,000 chunks on the mesh:
    build and calibration to MESH_IVF_TARGET (the K4 counts around them and
    every mesh search); at full probe every answer equals the sharded exact
    index over the int8 rows' dequantization (K2; compare_topk's
    tolerance: the union route's cuBLAS product sums in another order); at
    the calibrated probes every answer equals the per-shard plain K4
    version merged the same way, bit for bit (s8 integer products); a
    save and load round trip; add of MESH_ADD rows, remove of a quarter and
    compact, then every full-probe answer against a fresh sharded build
    over the live rows; recall@10 against exact fp32 and ms a search at
    the serving shape (Q=2, k=40) beside a one-device index's."""
    from tpualign_torch.parallel.ivf import IVFIndex
    from tpualign_torch.parallel.retrieval import _QUANTIZERS, RetrievalIndex, encode_keys

    chunk_emb, manuals, pages = shared["chunk_emb"], shared["manuals"], shared["pages"]
    (q_img, qman, qpg), q_wild = queries
    searches = (("keyed", q_img, dict(query_manuals=qman, query_pages=qpg)),
                ("wildcard", q_wild, dict(global_search=True)))
    index, build_s = _on_mesh(tally, IVFIndex, chunk_emb, manuals, pages, precision="int8",
                              mesh=mesh)
    check(index.n_lists_local == 256 and index.n_lists == 256 * MESH_SHARDS
          and [p.device for p in index._emb.parts] == mesh.data_devices,
          f"sharded IVF geometry: {index.n_lists_local} lists a shard, capacity "
          f"{index.capacity}")
    probes, calibrate_s = _on_mesh(tally, index.calibrate, MESH_IVF_TARGET)
    out = {"N": index.n, "shards": MESH_SHARDS, "n_lists_local": index.n_lists_local,
           "capacity": index.capacity, "spill_blocks": index.spill_blocks,
           "build_s": build_s, "calibrate_s": calibrate_s, "target": MESH_IVF_TARGET,
           "n_probes": probes}

    # full probe against the sharded exact index over the dequantized rows
    codes, scales = _QUANTIZERS["int8"](chunk_emb)
    exact = RetrievalIndex(codes.astype(np.float32) * scales[:, None], manuals, pages,
                           mesh=mesh)
    del codes, scales
    gap = 0.0
    for what, q, kw in searches:
        got, _ = _on_mesh(tally, index.search, q, k=10, n_probes=index.n_lists_local, **kw)
        gap = max(gap, _host_topk(got, exact.search(q, k=10, **kw),
                                  f"sharded IVF full probe {what}"))
    del exact
    out["full_probe_vs_exact"] = {"queries": 2 * MESH_QUERIES, "k": 10, "max_abs_err": gap,
                                  "tolerance": {"values_atol": K2_TOL_VALUES,
                                                "tie_gap": K2_TIE_GAP}}

    # the calibrated probes: K4 on every shard against its plain version
    for what, q, kw in searches:
        qk = (encode_keys(qman, qpg, dict(index.vocab))[0] if what == "keyed"
              else np.full(len(q), -3, np.int32))
        qt = torch.from_numpy(np.ascontiguousarray(q)).to(index.device)
        qkt = torch.from_numpy(np.asarray(qk, np.int32)).to(index.device)
        (v, i), _ = _on_mesh(tally, index.search_device, qt, qkt, 40)
        pv, pi = _plain_sharded_ivf(index, qt, qkt, 40, index.n_probes)
        check(torch.equal(i, pi) and torch.equal(v, pv),
              f"sharded IVF {what} at {index.n_probes} probes: K4 differs from its plain "
              f"version ({int((i != pi).sum())} slots)")
    out["probed_vs_plain"] = {"k": 40, "tolerance": "identical"}

    # save and load onto the same mesh
    import os

    path = os.path.join(root, "mesh-ivf.npz")
    index.save(path)
    loaded = IVFIndex.load(path, chunk_emb, mesh=mesh)
    # unused slots (id -1) hold inert rows, another one after a load
    same = all(torch.equal(a, b) for a, b in zip(loaded._ids.parts + loaded._keys.parts,
                                                 index._ids.parts + index._keys.parts))
    same = same and all(torch.equal(a[i >= 0], b[i >= 0]) for a, b, i in zip(
        loaded._emb.parts, index._emb.parts, index._ids.parts))
    check(same and loaded.n_probes == index.n_probes, "the sharded artifact loads another layout")
    for what, q, kw in searches:
        a, b = loaded.search(q, k=10, **kw), index.search(q, k=10, **kw)
        check(np.array_equal(a[1], b[1]) and np.array_equal(a[0], b[0]),
              f"sharded IVF {what}: the loaded artifact answers otherwise")
    del loaded

    # the serving shape: Q=2 keyed image queries, k = 10 x refine 4
    q2 = torch.from_numpy(np.ascontiguousarray(q_img[1:3])).to(dev)
    k2 = torch.from_numpy(encode_keys(qman[1:3], qpg[1:3], dict(index.vocab))[0]).to(dev)
    t0 = time.perf_counter()
    one = IVFIndex(chunk_emb, manuals, pages, precision="int8", device=dev)
    torch.cuda.synchronize()
    one_build_s = time.perf_counter() - t0
    one.calibrate(MESH_IVF_TARGET)
    (_, _), _ = _on_mesh(tally, index.search_device, q2, k2, 40)
    out["serving_shape"] = {"Q": 2, "k": 40,
                            "ms": time_ms(lambda: index.search_device(q2, k2, 40), 20),
                            "one_device_ms": time_ms(lambda: one.search_device(q2, k2, 40), 20),
                            "one_device_n_probes": one.n_probes,
                            "one_device_build_s": one_build_s}
    q_rec = shared["img_emb"][:SERVE_RECALL_QUERIES]
    wild = np.full(len(q_rec), -3, np.int32)
    out["recall_at_10"] = {}
    for name, ix in (("sharded", index), ("one_device", one)):
        _, got = (_on_mesh(tally, ix.search_encoded, q_rec, wild, 10)[0] if ix is index
                  else ix.search_encoded(q_rec, wild, 10))
        out["recall_at_10"][name] = float(np.mean([len(set(a) & set(b)) / 10
                                                   for a, b in zip(got, shared["exact"])]))
    del one

    # add, remove a quarter, compact; then full probe against a fresh build
    rng = np.random.default_rng(seed + 13)
    new = chunk_emb[rng.choice(len(chunk_emb), MESH_ADD, replace=False)]
    new = new + 0.05 * rng.normal(size=new.shape).astype(np.float32)
    new /= np.linalg.norm(new, axis=1, keepdims=True)
    new_pages = [int(p) for p in rng.integers(0, SERVE_PAGES, MESH_ADD)]
    new_man = [manuals[int(i)] for i in rng.integers(0, len(manuals), MESH_ADD)]
    _, add_s = _on_mesh(tally, index.add, new, new_man, new_pages)
    rows = np.concatenate([chunk_emb, new])
    man, pg = list(manuals) + new_man, list(pages) + new_pages
    gone = rng.choice(len(rows), int(MESH_REMOVE_SHARE * len(rows)), replace=False)
    removed, remove_s = _on_mesh(tally, index.remove, gone)
    check(removed == len(gone) and index.dead == len(gone), f"sharded IVF removed {removed}")
    live, compact_s = _on_mesh(tally, index.compact)
    check(np.array_equal(live, np.setdiff1d(np.arange(len(rows)), gone)),
          "sharded IVF compact's survivors")
    fresh = IVFIndex(rows[live], [man[i] for i in live], [pg[i] for i in live],
                     precision="int8", mesh=mesh)
    gap = 0.0
    for what, q, kw in searches:
        got, _ = _on_mesh(tally, index.search, q, k=10, n_probes=index.n_lists_local, **kw)
        gap = max(gap, _host_topk(got, fresh.search(q, k=10, n_probes=fresh.n_lists_local,
                                                    **kw), f"sharded IVF after mutations {what}"))
    out["mutations"] = {"add_s": add_s, "remove_s": remove_s, "compact_s": compact_s,
                        "N": index.n, "spill_blocks": index.spill_blocks,
                        "full_probe_vs_fresh_max_abs_err": gap}
    return out


def _mesh_engine(dev, mesh, tally, seed, distinct) -> dict:
    """EmbedEngine(mesh=) over the slice's 2,048 images and 8,192 chunk
    records, and one device-feed batch (K5 on every replica), against the
    one-device engine with the same seeded weights, within
    MESH_REPLICA_ATOL; on ``distinct`` cards, each card's idle share while
    each engine embeds the images (_card_idle)."""
    from tpualign_torch.config import ModelConfig
    from tpualign_torch.parallel import EmbedEngine

    images, chunks = _slice_inputs(seed)[:2]
    one = EmbedEngine(ModelConfig("ViT-B-32"), device=dev, seed=seed, preprocess="device")
    sharded = EmbedEngine(ModelConfig("ViT-B-32"), mesh=mesh, seed=seed, preprocess="device")
    check(sharded.batch_size % mesh.shape["data"] == 0, f"batch {sharded.batch_size}")
    sharded.encode_image_batch(images[:sharded.batch_size])  # warm-up, untimed
    sharded.encode_text_batch([c["text"] for c in chunks[:sharded.batch_size]])
    img, img_s = _on_mesh(tally, sharded.encode_image_batch, images)
    txt, txt_s = _on_mesh(tally, sharded.embed_chunk_records, chunks)
    rng = np.random.default_rng(seed)
    u8 = [rng.integers(0, 256, (FEED_BUCKET, FEED_BUCKET, 3), dtype=np.uint8)
          for _ in range(sharded.batch_size)]
    hws = rng.integers(FEED_BUCKET // 2, FEED_BUCKET + 1, (len(u8), 2)).astype(np.int32)
    feed, _ = _on_mesh(tally, sharded._encode_image_u8, u8, hws, None)
    t0 = time.perf_counter()
    want_img = one.encode_image_batch(images)
    one_img_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    want_txt = one.embed_chunk_records(chunks)
    one_txt_s = time.perf_counter() - t0
    gaps = {"images": float(np.abs(img - want_img).max()),
            "chunks": float(np.abs(txt - want_txt).max()),
            "device_feed": float(np.abs(feed - one._encode_image_u8(u8, hws, None)).max())}
    for what, g in gaps.items():
        check(g <= MESH_REPLICA_ATOL,
              f"EmbedEngine(mesh=) {what}: {g:.3g} from the one-device engine")
    out = {"images": len(images), "chunks": len(chunks), "batch_size": sharded.batch_size,
           "images_per_s": len(images) / img_s, "chunks_per_s": len(chunks) / txt_s,
           "one_device_images_per_s": len(images) / one_img_s,
           "one_device_chunks_per_s": len(chunks) / one_txt_s, "max_abs_gap": gaps,
           "tolerance": MESH_REPLICA_ATOL}
    if distinct:
        out["idle"] = {}
        for name, engine in (("one_device", one), ("mesh", sharded)):
            idle = _card_idle(lambda: engine.encode_image_batch(images))
            out["idle"][name] = {**idle, "images_per_s": len(images) / idle["window_ms"] * 1e3}
    return out


def _mesh_int8(dev, seed, tally) -> dict:
    """CLIP_QUANT=int8 (ViT-B-32, seeded, bf16) on a (2, 2) mesh, four
    distinct cards where the host has them (a ``.to()`` between distinct
    cards is where a misplaced scale or partial would show; on card 0
    repeated it moves nothing), over B seeded images and B texts of one
    length bucket, against card 0's int8 engine at the batch of one data
    row (_int8_split: bit for bit); the mesh engine's K1 launches count on
    the mesh path."""
    from tpualign_torch.config import ModelConfig
    from tpualign_torch.parallel import EmbedEngine

    config = ModelConfig("ViT-B-32", quant="int8")
    one = EmbedEngine(config, device=dev, seed=seed, batch_size=B // 2)
    tp = EmbedEngine(config, mesh=_mesh_of(dev, 2, 2), seed=seed)
    images = np.random.default_rng(seed + 9).normal(size=(B, 224, 224, 3)).astype(np.float32)
    texts = [f"vervang het filter {i}" for i in range(B)]  # one bucket: 16 tokens
    row = _int8_split(one, tp, images, texts)
    tally["fused_mha"] = tally.get("fused_mha", 0) + row["mesh"]["launches"]["fused_mha"]
    return row


def _card_idle(fn) -> dict:
    """fn() under torch.profiler; each card's idle share of the host-clock
    window (1 - its merged kernel and copy time / the window; "not
    measured" where the trace holds no device time for the card)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    cards = range(torch.cuda.device_count())
    for i in cards:
        torch.cuda.synchronize(i)
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        for i in cards:
            torch.cuda.synchronize(i)
        window_us = (time.perf_counter() - t0) * 1e6
    spans = {}
    for e in prof.events():
        if e.device_type == DeviceType.CUDA:
            spans.setdefault(e.device_index, []).append((e.time_range.start, e.time_range.end))
    share = {}
    for i in cards:
        busy, end = 0.0, -np.inf
        for a, b in sorted(spans.get(i, [])):
            if b > end:
                busy += b - max(a, end)
                end = b
        share[f"cuda:{i}"] = (max(0.0, 1.0 - busy / window_us) if spans.get(i)
                              else "not measured")
    return {"window_ms": window_us / 1e3, "idle_share": share}


def _mesh_service(dev, mesh, tally, root, checkpoint, seed, shared) -> dict:
    """build_service(mesh=) over the 1M-chunk store (int8, refine 4, the
    checkpoint's towers replicated over the mesh) behind HTTP, against the
    one-device service (the serve phase's engine): MESH_REQUESTS serial
    /search_image and /search_text requests, answers equal; /stats reports
    the mesh; p50 of each route alone."""
    import urllib.request

    from tpualign_torch.config import load_config
    from tpualign_torch.serving.server import (
        _ServiceBox, build_service, make_image_bytes_encoder, serve_schemas)

    config = load_config({"STORE_DIR": root, "RETRIEVAL_PRECISION": "int8",
                          "RETRIEVAL_REFINE": "4", "CLIP_MODEL": "ViT-B-32", "SEED": str(seed),
                          "CLIP_CHECKPOINT": checkpoint, "SERVE_QUERY_CACHE": "0"})
    engine = shared["engine"]
    t0 = time.perf_counter()
    one = build_service(config, "vanilla_clip", encoder=engine.encode_text_batch,
                        image_encoder=make_image_bytes_encoder(engine), device=dev)
    one_s = time.perf_counter() - t0
    sharded, mesh_s = _on_mesh(tally, build_service, config, "vanilla_clip", mesh=mesh)
    images = shared["images"]
    rng = np.random.default_rng(seed + 11)
    asks = [("/search_image", {"image_ids": [images[int(i)]["image_id"]
                                             for i in rng.integers(0, len(images), 2)], "k": 10})
            for _ in range(MESH_REQUESTS)]
    asks += [("/search_text", {"texts": [SERVE_TEXTS[j % len(SERVE_TEXTS)]], "k": 10,
                               "global": True}) for j in range(MESH_REQUESTS)]
    answers, lat = {}, {}
    for name, service in (("one_device", one), ("mesh", sharded)):
        httpd = serve_schemas({"vanilla_clip": _ServiceBox(service)}, "vanilla_clip",
                              "127.0.0.1", 0)
        server = threading.Thread(target=httpd.serve_forever, daemon=True)
        server.start()
        base = f"http://127.0.0.1:{httpd.server_address[1]}"
        try:
            for path, body in asks[:2] + asks[MESH_REQUESTS:MESH_REQUESTS + 1]:
                _post(base, path, body)  # warm-up

            def drive():
                return [_timed_post(base, path, body) for path, body in asks]

            if name == "mesh":
                runs, _ = _on_mesh(tally, drive)
                stats = json.loads(urllib.request.urlopen(f"{base}/stats", timeout=60).read())
                check(stats.get("mesh") == mesh.shape, f"/stats mesh {stats.get('mesh')}")
            else:
                runs = drive()
        finally:
            httpd.shutdown()
            httpd.server_close()
            server.join()
        answers[name] = [r for r, _ in runs]
        lat[name] = {path: _pct([s for (p, _), (_, s) in zip(asks, runs) if p == path], 0.5)
                     for path in ("/search_image", "/search_text")}
    for (path, body), got, want in zip(asks, answers["mesh"], answers["one_device"]):
        check(got["results"] == want["results"], f"{path} {body}: the mesh service differs")
    return {"requests": len(asks), "answers_equal": True, "p50_ms": lat,
            "service_build_s": {"one_device": one_s, "mesh": mesh_s}}


def _mesh_daemon(daemon, images, pngs) -> dict:
    """One started ``serve`` process (a ``_Daemon``) over the serve phase's
    store, stopped at the end: its start, p50 of /search_image,
    /search_text (one fresh text a request, so that the mesh engine runs it
    on its first replica as one card does) and /search_image_bytes sent
    alone, requests/s under the serve phase's clients, /stats' mesh, its
    kernel counts and its serial answers (``pngs``: encoded image files)."""
    import base64

    name = daemon.name
    try:
        rng = np.random.default_rng(5)
        asks = {"/search_image": [{"image_ids": [images[int(i)]["image_id"]
                                                 for i in rng.integers(0, len(images), 2)],
                                   "k": 10} for _ in range(MESH_PROBE_REQUESTS)],
                "/search_text": [{"texts": [f"{SERVE_TEXTS[j % len(SERVE_TEXTS)]} {j}"], "k": 10,
                                  "global": True} for j in range(MESH_PROBE_REQUESTS)],
                "/search_image_bytes": [{"images_b64": [base64.b64encode(pngs[j % len(pngs)])
                                                        .decode()], "k": 10}
                                        for j in range(MESH_PROBE_REQUESTS)]}
        for path, bodies in asks.items():
            _post(daemon.url, path, bodies[0])  # warm-up
        answers, p50 = {}, {}
        for path, bodies in asks.items():
            runs = [_timed_post(daemon.url, path, b) for b in bodies]
            answers[path] = [r["results"] for r, _ in runs]
            p50[path] = _pct([s for _, s in runs], 0.5)
        ctx = multiprocessing.get_context("spawn")
        recv, send = ctx.Pipe(duplex=False)
        port = int(daemon.url.rsplit(":", 1)[1])
        load = ctx.Process(target=_load, args=(port, [im["image_id"] for im in images], pngs,
                                               SERVE_CLIENTS, SERVE_REQUESTS, send))
        load.start()
        check(recv.poll(600), f"{name}: the clients sent no answers within 600 s")
        results, errors, wall = recv.recv()
        load.join()
        check(not errors and all(r["status"] == 200 for r in results),
              f"{name}: client errors {errors[:2]}")
        stats = daemon.get("/stats")
    finally:
        counts = daemon.stop()
    return {"start_s": daemon.start_s, "p50_ms": p50, "clients": SERVE_CLIENTS,
            "requests": len(results), "requests_per_s": len(results) / wall,
            "mesh": stats.get("mesh"), "index": stats.get("index"), "ivf": stats.get("ivf"),
            "launches": counts, "answers": answers, "asks": asks, "load": results}


def _mesh_serve_cli(seed, root, checkpoint, images, mesh, shared) -> dict:
    """``python -m tpualign_torch serve`` as a process over the serve
    phase's store (int8, refine 4, the checkpoint's towers) on card 0, with
    ``--mesh-data`` over the mesh's cards, and with ``--mesh-data`` under
    RETRIEVAL_INDEX=ivf (the sharded IVF index, built, calibrated to
    MESH_IVF_TARGET and saved to IVF_CACHE by the daemon): the three start
    side by side (their ``start_s`` overlap), then each is driven alone
    (_mesh_daemon): every serial answer of the mesh daemon equal to the
    one-card daemon's, the IVF daemon's against the plain path
    (_mesh_ivf_daemon)."""
    import os

    work = os.path.join(root, "mesh-serve")
    os.makedirs(work)
    env = {"STORE_DIR": root, "RETRIEVAL_PRECISION": "int8", "RETRIEVAL_REFINE": "4",
           "CLIP_MODEL": "ViT-B-32", "SEED": str(seed), "CLIP_CHECKPOINT": checkpoint}
    cache = os.path.join(work, "vanilla_clip.ivf.npz")  # names its schema: used as it is
    ivf_env = {**env, "RETRIEVAL_INDEX": "ivf", "RETRIEVAL_RECALL_TARGET": str(MESH_IVF_TARGET),
               "IVF_CACHE": cache}
    on_mesh = ("--mesh-data", str(mesh.shape["data"]))
    starts = {name: _beside(_Daemon, case_env, work, name, "cuda", args)
              for name, case_env, args in (("one_card", env, ()), ("mesh", env, on_mesh),
                                           ("mesh-ivf", ivf_env, on_mesh))}
    started, failed = {}, []
    for name, future in starts.items():
        try:
            started[name] = future.result()
        except Exception as exc:  # noqa: BLE001 — raised below, once every daemon is stopped
            failed.append(exc)
    try:
        if failed:
            raise failed[0]
        rng = np.random.default_rng(seed)
        pngs = [_png(rng) for _ in range(4)]
        daemons = {name: _mesh_daemon(started[name], images, pngs)
                   for name in ("one_card", "mesh")}
        got, want = daemons["mesh"].pop("answers"), daemons["one_card"].pop("answers")
        for path in want:
            check(got[path] == want[path], f"serve --mesh-data {path}: answers differ from the "
                                           "one-card daemon's")
        check(daemons["mesh"]["mesh"] == mesh.shape, f"the mesh daemon's /stats: "
                                                     f"{daemons['mesh']['mesh']}")
        for d in daemons.values():
            del d["asks"], d["load"]
        daemons["mesh_ivf"] = _mesh_ivf_daemon(started["mesh-ivf"], root, cache, images, pngs,
                                               mesh, shared)
    finally:
        for daemon in started.values():
            daemon.stop()
    return {"answers_equal": True, "started_side_by_side": True, **daemons}


def _mesh_ivf_daemon(daemon, store_dir, cache, images, pngs, mesh, shared) -> dict:
    """The started ``serve --mesh-data`` daemon under RETRIEVAL_INDEX=ivf
    over ``store_dir``, through _mesh_daemon; its serial /search_image and
    /search_text answers and every /search_image answer of the clients' mix
    against the plain path (per-shard plain K4 at the daemon's probes, the
    exact rescore) over the artifact it wrote (``cache``), loaded here on
    the same cards; texts are encoded here by the one-card engine (the mesh
    engine encodes one text a request on its first replica, as one card
    does)."""
    import os

    from tpualign_torch.parallel.ivf import IVFIndex
    from tpualign_torch.parallel.retrieval import WILDCARD_KEY, encode_keys
    from tpualign_torch.store import EmbeddingStore

    run = _mesh_daemon(daemon, images, pngs)
    check(run["mesh"] == mesh.shape and run["index"] == "IVFIndex" and os.path.exists(cache),
          f"the IVF mesh daemon's /stats: {run['mesh']} {run['index']}")
    check(run["launches"].get("ivf_probe_topk", 0) > 0, "the IVF mesh daemon launched no K4")
    index = IVFIndex.load(cache, shared["chunk_emb"], refine=4, mesh=mesh)
    check(index.n_probes == run["ivf"]["n_probes"], f"artifact probes {index.n_probes}")
    chunk_ids = list(EmbeddingStore(store_dir).embedding_matrix("vanilla_clip", "text_chunks")[0])
    _, img_emb = EmbeddingStore(store_dir).embedding_matrix("vanilla_clip", "images")
    by_id = {im["image_id"]: (i, im) for i, im in enumerate(images)}

    def plain_images(image_ids):
        rows = np.stack([img_emb[by_id[i][0]] for i in image_ids])
        keys = encode_keys([by_id[i][1]["manual_id"] for i in image_ids],
                           [by_id[i][1]["page"] for i in image_ids], dict(index.vocab))[0]
        return _pairs(*_plain_sharded_refined(index, rows, keys), chunk_ids)

    answers, checked = run.pop("answers"), 0
    for body, got in zip(run["asks"]["/search_image"], answers["/search_image"]):
        check(_as_pairs(got) == plain_images(body["image_ids"]),
              f"serve --mesh-data (ivf) /search_image {body}: differs from the plain path")
        checked += 1
    texts = [b["texts"][0] for b in run["asks"]["/search_text"]]
    emb = np.concatenate([shared["engine"].encode_text_batch([t]) for t in texts])
    want = _pairs(*_plain_sharded_refined(index, emb, np.full(len(texts), WILDCARD_KEY,
                                                              np.int32)), chunk_ids)
    for text, got, w in zip(texts, answers["/search_text"], want):
        check(_as_pairs(got)[0] == w,
              f"serve --mesh-data (ivf) /search_text {text!r}: differs from the plain path")
        checked += 1
    for r in run.pop("load"):
        if r["kind"] == "search_image":
            check(_as_pairs(r["response"]["results"]) == plain_images(r["request"]["image_ids"]),
                  "serve --mesh-data (ivf): a client's /search_image differs from the plain path")
            checked += 1
    del run["asks"]
    run["answers_checked"] = checked
    return run


def _mesh_setup_db(env, work):
    """``setup-db`` of the fresh store ``embed --mesh-data`` fills, started
    on a thread of its own (it reads nothing the other stages write):
    ``(its env, the future)``."""
    import os

    mesh_env = {**env, "STORE_DIR": os.path.join(work, "store-mesh")}
    return mesh_env, _beside(_run_stage, ["setup-db", "--device", "cuda"], mesh_env, work,
                             "-mesh")


def _mesh_embed_cli(mesh_setup, work, store, one_card_s, n_images) -> dict:
    """``embed --mesh-data MESH_SHARDS`` into the fresh store of
    ``mesh_setup`` (_mesh_setup_db) over stage 1's records of the pipeline
    phase (the towers replicated on the first MESH_SHARDS cards, K5 on
    each): the process's seconds and images/s beside the one-card ``embed``
    process's, its launches, and every stored embedding of every schema
    against the one-card store's within MESH_REPLICA_ATOL."""
    from tpualign_torch.store import SCHEMAS, EmbeddingStore

    mesh_env, setup = mesh_setup
    setup.result()
    secs, launches, _ = _run_stage(["embed", "--device", "cuda", "--mesh-data",
                                    str(MESH_SHARDS)], mesh_env, work, "-mesh")
    check(launches["normalize_u8"] == MESH_SHARDS * -(-n_images // B),
          f"embed --mesh-data launched K5 {launches['normalize_u8']} times")
    mesh_store = EmbeddingStore(mesh_env["STORE_DIR"], embed_dim=512)
    gap = 0.0
    for schema in SCHEMAS:
        for table in ("images", "text_chunks"):
            ids, got = mesh_store.embedding_matrix(schema, table)
            want_ids, want = store.embedding_matrix(schema, table)
            check(list(ids) == list(want_ids) and got.shape == want.shape,
                  f"embed --mesh-data {schema}/{table}: other rows than one card's")
            gap = max(gap, float(np.abs(got - want).max()) if got.size else 0.0)
    check(gap <= MESH_REPLICA_ATOL, f"embed --mesh-data: {gap:.3g} from one card's store")
    return {"cards": MESH_SHARDS, "s": secs, "one_card_s": one_card_s,
            "images_per_s": n_images / secs, "one_card_images_per_s": n_images / one_card_s,
            "max_abs_gap": gap, "launches": launches}


def phase_mesh(dev, seed, root, checkpoint, shared, mesh, where, tally, evaluator,
               embed_cli) -> dict:
    """The one-host mesh over the serve phase's store (see _mesh_indexes,
    _mesh_mutations, _mesh_ivf, _mesh_engine and _mesh_service), with the
    Evaluator's check of the pipeline store (phase_mesh_evaluator, run
    while that store existed); on distinct cards also each card's idle
    share, ``serve --mesh-data`` as a process (_mesh_serve_cli) and the
    pipeline phase's ``embed --mesh-data`` (``embed_cli``)."""
    from tpualign_torch.store import EmbeddingStore

    images = shared["images"]
    _, img_emb = EmbeddingStore(root).embedding_matrix("vanilla_clip", "images")
    keyed = (img_emb[:MESH_QUERIES], [im["manual_id"] for im in images[:MESH_QUERIES]],
             [im["page"] for im in images[:MESH_QUERIES]])
    queries = (keyed, img_emb[MESH_QUERIES:2 * MESH_QUERIES])
    out = {"phase": "mesh", "mesh": {"shape": mesh.shape, "devices": [str(d) for d in
                                                                      mesh.devices.flat],
                                     "stands_on": where}}
    seconds = out["part_s"] = {}
    t0 = time.perf_counter()

    def lap(name):
        nonlocal t0
        seconds[name] = time.perf_counter() - t0
        t0 = time.perf_counter()

    out["indexes"], int8_index = _mesh_indexes(dev, mesh, tally, shared, queries)
    lap("indexes")
    out["mutations"] = _mesh_mutations(dev, int8_index, tally, shared, queries, seed)
    del int8_index
    lap("mutations")
    out["ivf"] = _mesh_ivf(dev, mesh, tally, {**shared, "img_emb": img_emb}, queries, seed, root)
    lap("ivf")
    distinct = len(set(mesh.devices.flat)) == mesh.devices.size
    out["engine"] = _mesh_engine(dev, mesh, tally, seed, distinct)
    lap("engine")
    out["int8_2x2"] = _mesh_int8(dev, seed, tally)
    lap("int8_2x2")
    out["service"] = _mesh_service(dev, mesh, tally, root, checkpoint, seed, shared)
    lap("service")
    out["evaluator"] = evaluator
    if distinct:
        out["serve_cli"] = _mesh_serve_cli(seed, root, checkpoint, images, mesh, shared)
        lap("serve_cli")
        out["embed_cli"] = embed_cli
    out["launches"] = dict(tally)
    emit(out)
    for name in ("fused_mha", "masked_sim_topk", "masked_sim_topk_quant", "ivf_probe_topk",
                 "normalize_u8"):
        check(tally.get(name, 0) > 0, f"{name} was not launched on the mesh path")
    return dict(tally)


# -- mesh_train: the sharded towers and the mesh train step ------------------------

MESH_TRAIN_B = 64                      # the fp32 checks' global batch
MESH_TRAIN_LR = 1e-3
MESH_TRAIN_SHAPES = ((4, 1, False), (2, 2, False), (1, 4, False), (4, 1, True))
MESH_LOSS_REL, MESH_NORM_REL = 1e-4, 1e-3    # tests/test_train.py:116's bounds
FSDP_LOSS_REL, FSDP_PARAM_ATOL = 1e-5, 2e-6  # tests/test_train.py:765's bounds
MESH_TRAIN_STEPS = 2                   # bf16 Trainer(mesh=) steps timed, after one warm-up
MESH_IDLE_STEPS = 1                    # Trainer steps under the profiler (four cards)
MESH_PROCESS_STEPS = 2                 # each `train` process (four cards)
H14_CUT_LAYERS, H14_CHECK_B = 4, 8     # ViT-H-14's fp32 checks: blocks a tower, batch
H14_TIMED_B = 64                       # ViT-H-14 bf16 at full depth on (2, 2)


def _mesh_of(dev, d, m):
    """A (d, m) mesh on the first d*m cards where the host has them, else
    on ``dev`` repeated."""
    from tpualign_torch.parallel import create_mesh

    if torch.cuda.device_count() >= d * m:
        return create_mesh(d, m)
    return create_mesh(d, m, devices=[dev] * (d * m))


def _counted(tally, fn, *args):
    """``fn(*args)`` on the mesh_train path: K1's and K5's counts set to 0
    just before and read just after (every card synchronised) into
    ``tally``; returns fn's result and its seconds."""
    from tpualign_torch.ops.attention import fused_mha
    from tpualign_torch.ops.normalize import normalize_u8

    _sync_all()
    fused_mha.launches = fused_mha.backward_recomputes = normalize_u8.launches = 0
    t0 = time.perf_counter()
    out = fn(*args)
    _sync_all()
    secs = time.perf_counter() - t0
    for key, n in (("fused_mha", fused_mha.launches),
                   ("fused_mha_backward", fused_mha.backward_recomputes),
                   ("normalize_u8", normalize_u8.launches)):
        tally[key] = tally.get(key, 0) + n
    return out, secs


def _card_peaks() -> list:
    return [torch.cuda.max_memory_allocated(i) / 2**30 for i in range(torch.cuda.device_count())]


def _reset_peaks():
    _sync_all()
    torch.cuda.empty_cache()
    for i in range(torch.cuda.device_count()):
        torch.cuda.reset_peak_memory_stats(i)


def _train_batch(dev, seed, b, image_size):
    """Seeded pixels, token rows of random lengths (EOT the largest id) and
    weak scores, on ``dev``."""
    rng = np.random.default_rng(seed)
    g = torch.Generator(device=dev).manual_seed(seed)
    images = torch.randn(b, image_size, image_size, 3, generator=g, device=dev)
    tokens = np.zeros((b, 77), np.int64)
    for i, n in enumerate(rng.integers(4, 77, b)):
        tokens[i, 0], tokens[i, n - 1] = 49406, 49407
        tokens[i, 1:n - 1] = rng.integers(1, 49000, n - 2)
    weak = torch.from_numpy(rng.random(b).astype(np.float32)).to(dev)
    return images, torch.from_numpy(tokens).to(dev), weak


def _one_card_step(model, cfg, batch):
    """One step on ``model``'s card from its params: loss, grad_norm, the
    gradients (fp32 copies) and the updated params."""
    from tpualign_torch.train import step as S

    state = S.create_train_state(model, S.model_params(model), cfg)
    grads = {}
    real = state.apply_gradients

    def keep(g, n):
        grads.update({k: v.float().clone() for k, v in g.items()})
        return real(g, n)

    state.apply_gradients = keep
    state, m = S.train_step(state, model, *batch, cfg)
    return float(m["loss"]), float(m["grad_norm"]), grads, S.export_params(state)


def _params_gap(got, want, grads, lr) -> float:
    """The largest |got - want| over the elements whose |g| is at least
    1e-3 of their leaf's largest (tests/test_torch_train.py's
    ``assert_params_close``: Adam's first step moves an element whose
    near-zero gradient two summation orders give opposite signs by a full
    lr either way); must be within 1e-2 x lr."""
    worst = 0.0
    for k, w in want.items():
        g = grads[k].abs()
        sel = g >= 1e-3 * g.max() if float(g.max()) > 0 else torch.ones_like(g, dtype=torch.bool)
        diff = (got[k].float().to(w.device) - w.float()).abs()[sel]
        worst = max(worst, float(diff.max()) if diff.numel() else 0.0)
    check(worst <= 1e-2 * lr, f"params {worst:.3g} from the one-card step (bound {1e-2 * lr:.3g})")
    return worst


def _mesh_step_checks(dev, model, batch, shapes, tally, what) -> dict:
    """One fp32 step on each mesh of ``shapes`` ((data, model, fsdp))
    against the one-card step on the same batch and params: loss within
    MESH_LOSS_REL, grad_norm within MESH_NORM_REL, params within the port's
    train tests' bound; FSDP against the replicated mesh of its shape
    within FSDP_LOSS_REL and FSDP_PARAM_ATOL. Per mesh: ms (host clock,
    every card synchronised), each card's peak memory."""
    import dataclasses as dc

    from tpualign_torch.config import TrainConfig
    from tpualign_torch.train import step as S

    cfg = TrainConfig(learning_rate=MESH_TRAIN_LR, warmup_steps=0, total_steps=10)
    _reset_peaks()
    loss1, norm1, grads1, params1 = _one_card_step(model, cfg, batch)
    out = {"one_card": {"loss": loss1, "grad_norm": norm1, "peak_memory_gb_by_card": _card_peaks()}}
    replicated = {}
    for d, m, fsdp in shapes:
        mesh = _mesh_of(dev, d, m)
        c = dc.replace(cfg, fsdp=fsdp)
        run, shard_state = S.make_sharded_train_step(model, mesh, c)
        _reset_peaks()
        state = shard_state(S.create_train_state(model, S.model_params(model), c))
        (state, metrics), secs = _counted(tally, run, state, *batch)
        loss, norm = float(metrics["loss"]), float(metrics["grad_norm"])
        tag = f"{d}x{m}" + ("_fsdp" if fsdp else "")
        check(abs(loss - loss1) <= MESH_LOSS_REL * abs(loss1)
              and abs(norm - norm1) <= MESH_NORM_REL * abs(norm1),
              f"{what} {tag}: loss {loss} / {loss1}, grad_norm {norm} / {norm1}")
        params = S.export_params(state)
        row = {"loss": loss, "grad_norm": norm, "ms": secs * 1e3,
               "params_gap": _params_gap(params, params1, grads1, MESH_TRAIN_LR),
               "peak_memory_gb_by_card": _card_peaks(),
               "devices": [str(x) for x in mesh.devices.flat]}
        if fsdp and (d, m) in replicated:
            rloss, rparams = replicated[(d, m)]
            gap = max(float((params[k] - rparams[k]).abs().max()) for k in rparams)
            check(abs(loss - rloss) <= FSDP_LOSS_REL * abs(rloss) and gap <= FSDP_PARAM_ATOL,
                  f"{what} {tag}: loss {loss} / {rloss} and params {gap:.3g} from replicated")
            row["vs_replicated"] = {"loss": [loss, rloss], "params_max_abs": gap}
        elif not fsdp:
            replicated[(d, m)] = (loss, params)
        out[tag] = row
        del state, params
    out["bounds"] = {"loss_rel": MESH_LOSS_REL, "grad_norm_rel": MESH_NORM_REL,
                     "params": "1e-2 x lr where |g| >= 1e-3 x the leaf's max",
                     "fsdp_vs_replicated": {"loss_rel": FSDP_LOSS_REL,
                                            "params_atol": FSDP_PARAM_ATOL}}
    return out


def _mesh_trainer(env, triples, seed, mesh, tally, idle: bool) -> dict:
    """``Trainer(mesh=)`` on the pipeline store's ``triples`` with the
    device feed, bf16, B=256: MESH_TRAIN_STEPS timed steps
    (``_timed_steps``: step ms, the feed's wait, every step's loss, every
    card's peak) and, with ``idle``, each card's idle share over
    MESH_IDLE_STEPS more steps, the feed included (``_card_idle``)."""
    from tpualign_torch.config import load_config
    from tpualign_torch.train.trainer import Trainer

    _reset_peaks()
    trainer = Trainer(load_config(env), mesh=mesh)
    it = trainer.batches(triples, B, seed=seed)  # one feed for the timed and the profiled steps
    try:
        row = _timed_steps(trainer, it, steps=MESH_TRAIN_STEPS)
        if idle:
            def steps():
                for _ in range(MESH_IDLE_STEPS):
                    trainer.state, m = trainer._step(trainer.state,
                                                     *_device_batch(trainer, next(it)))
                    float(m["loss"])

            row["idle"] = _card_idle(steps)
    finally:
        it.close()
    for key in ("fused_mha", "fused_mha_backward", "normalize_u8"):
        tally[key] = tally.get(key, 0) + row["launches"][key]
    d, m = mesh.shape["data"], mesh.shape["model"]
    v = trainer.variant
    blocks = (v.vision_layers + v.text_layers) * d * m * MESH_TRAIN_STEPS
    check(row["launches"]["fused_mha"] == blocks
          and row["launches"]["fused_mha_backward"] == blocks
          and row["launches"]["normalize_u8"] == d * MESH_TRAIN_STEPS,
          f"Trainer(mesh={d}x{m}): launches {row['launches']} in {MESH_TRAIN_STEPS} steps")
    row["mesh"] = {"shape": mesh.shape, "devices": [str(x) for x in mesh.devices.flat],
                   "fsdp": trainer.config.train.fsdp, "pairs": len(triples)}
    del trainer
    return row


def _int8_qat_step(dev, env, seed, tally) -> dict:
    """One CLIP_QUANT=int8_qat step (COMPUTE_DTYPE=float32, MESH_TRAIN_B
    seeded pairs, the checkpoint's weights) of ``Trainer(mesh=)`` on (1, 2)
    against one card's Trainer on the same batch: loss within
    MESH_LOSS_REL, grad_norm within MESH_NORM_REL (the row-split products
    fake-quantize each card's slices with the maxima over the row's cards;
    the fp32 partials sum in another order than one card's product); K1
    forward and recompute on each part of every block; ms of each step
    (host clock, every card synchronised)."""
    from tpualign_torch.config import load_config
    from tpualign_torch.train.trainer import Trainer

    config = load_config({**env, "CLIP_QUANT": "int8_qat", "COMPUTE_DTYPE": "float32"})
    batch = _train_batch(dev, seed, MESH_TRAIN_B, config.model.variant.image_size)
    one = Trainer(config, device=dev)
    (_, m1), one_s = _counted({}, one._step, one.state, *batch)
    del one
    mesh = _mesh_of(dev, 1, 2)
    trainer = Trainer(config, mesh=mesh)
    seen: dict = {}
    (_, m), secs = _counted(seen, trainer._step, trainer.state, *batch)
    del trainer
    for key, n in seen.items():
        tally[key] = tally.get(key, 0) + n
    loss, norm, loss1, norm1 = (float(x) for x in (m["loss"], m["grad_norm"], m1["loss"],
                                                   m1["grad_norm"]))
    check(abs(loss - loss1) <= MESH_LOSS_REL * abs(loss1)
          and abs(norm - norm1) <= MESH_NORM_REL * abs(norm1),
          f"int8_qat (1, 2): loss {loss} / {loss1}, grad_norm {norm} / {norm1}")
    blocks = (config.model.variant.vision_layers + config.model.variant.text_layers) * 2
    check(seen["fused_mha"] == blocks and seen["fused_mha_backward"] == blocks,
          f"int8_qat (1, 2): launches {seen}")
    return {"B": MESH_TRAIN_B, "dtype": "float32", "loss": [loss, loss1],
            "grad_norm": [norm, norm1], "ms": secs * 1e3, "one_card_ms": one_s * 1e3,
            "launches": seen, "devices": [str(x) for x in mesh.devices.flat],
            "bounds": {"loss_rel": MESH_LOSS_REL, "grad_norm_rel": MESH_NORM_REL}}


def _mesh_train_process(env, work, tag, d, m, extra_env=(), extra_args=()) -> dict:
    """``python -m tpualign_torch train`` over the pipeline store,
    MESH_PROCESS_STEPS steps at B=256 (device feed, bf16): the trainer's
    wall seconds of the loop (the feed's waits included), pairs/s, each
    card's peak memory (written at exit), the kernels' launches (K1 24 a
    block-part and step, forward and recompute; K5 one a data row and
    step) and the final loss."""
    import json
    import os

    metrics = os.path.join(work, f"metrics-{tag}.jsonl")
    argv = ["train", "--device", "cuda", "--steps", str(MESH_PROCESS_STEPS),
            "--train-batch-size", str(B), "--metrics-file", metrics, "--log-every", "5",
            *extra_args]
    secs, launches, _ = _run_stage(argv, {**env, **dict(extra_env)}, work, tag=f"-{tag}")
    with open(os.path.join(work, f"counters-train-{tag}.json.mem")) as f:
        peaks = json.load(f)
    with open(metrics) as f:
        final = [json.loads(line) for line in f][-1]
    check(final["kind"] == "final" and np.isfinite(final["loss"]), f"train ({tag}): {final}")
    steps = MESH_PROCESS_STEPS
    check(launches["fused_mha_backward"] == 24 * d * m * steps
          and launches["normalize_u8"] == d * steps,
          f"train ({tag}): launches {launches} in {steps} steps on {d}x{m}")
    wall = final["wall_seconds"]
    return {"process_s": secs, "steps": steps, "loop_s": wall, "step_ms": wall / steps * 1e3,
            "pairs_per_s": B * steps / wall, "peak_memory_gb_by_card": peaks,
            "launches": launches, "final_loss": final["loss"]}


def _h14(dev, seed, tally) -> dict:
    """ViT-H-14 at its full widths (vision 1280 / 16 heads / hd 80, text
    1024 / 16), seeded: one fp32 step on (1, 4) and on (4, 1) with FSDP
    against one card's at H14_CUT_LAYERS blocks a tower (B=H14_CHECK_B);
    then MESH_TRAIN_STEPS timed bf16 steps at full depth on (2, 2)
    (B=H14_TIMED_B), each card's peak memory."""
    import dataclasses as dc

    from tpualign_torch.config import CLIP_VARIANTS, TrainConfig
    from tpualign_torch.models.clip import CLIP, init_clip_params
    from tpualign_torch.train import step as S

    full = CLIP_VARIANTS["ViT-H-14"]
    cut = dc.replace(full, name="ViT-H-14-cut", vision_layers=H14_CUT_LAYERS,
                     text_layers=H14_CUT_LAYERS)
    model = init_clip_params(CLIP(cut, False, torch.float32, True), seed=seed)
    model = model.to(dev).requires_grad_(False)
    batch = _train_batch(dev, seed, H14_CHECK_B, full.image_size)
    out = {"cut": {"layers_a_tower": H14_CUT_LAYERS, "B": H14_CHECK_B, **_mesh_step_checks(
        dev, model, batch, ((1, 4, False), (4, 1, True)), tally, "ViT-H-14 (cut)")}}
    del model, batch
    model = init_clip_params(CLIP(full, False, torch.bfloat16, True), seed=seed)
    model = model.to(dev).requires_grad_(False)
    cfg = TrainConfig(learning_rate=1e-5, warmup_steps=0, total_steps=10)
    mesh = _mesh_of(dev, 2, 2)
    run, shard_state = S.make_sharded_train_step(model, mesh, cfg)
    state = shard_state(S.create_train_state(model, S.model_params(model), cfg))
    model.to("meta")
    batch = _train_batch(dev, seed + 1, H14_TIMED_B, full.image_size)
    _reset_peaks()
    state, m = run(state, *batch)  # warm-up
    ms, losses = [], [float(m["loss"])]
    for _ in range(MESH_TRAIN_STEPS):
        (state, m), secs = _counted(tally, run, state, *batch)
        ms.append(secs * 1e3)
        losses.append(float(m["loss"]))
    check(all(np.isfinite(losses)), f"ViT-H-14 (2, 2) bf16: losses {losses}")
    out["full_depth"] = {"mesh": "2x2", "B": H14_TIMED_B, "dtype": "bfloat16",
                         "step_ms_each": ms, "step_ms": float(np.mean(ms)),
                         "pairs_per_s": H14_TIMED_B / (float(np.mean(ms)) / 1e3),
                         "losses": losses, "peak_memory_gb_by_card": _card_peaks(),
                         "devices": [str(x) for x in mesh.devices.flat]}
    del state
    _reset_peaks()
    return out


def _step_parts(dev, seed) -> dict:
    """Where a train step's host time goes: ViT-B-32 bf16, B=256, a seeded
    batch, on one card, then on (2, 2) (distinct cards where the host has
    four, else card 0 repeated): the forward (towers and loss), the
    backward (autograd and the gradient sums) and the update (norm, AdamW),
    each ended by a synchronize of every card (host clock, the mean of
    MESH_TRAIN_STEPS after one warm-up), and the CUDA events of one profiled
    step with their summed device time."""
    from torch.profiler import ProfilerActivity, profile

    from tpualign_torch.config import TrainConfig, load_config
    from tpualign_torch.models.clip import build_clip, init_clip_params
    from tpualign_torch.train import step as S

    config = load_config({"CLIP_MODEL": "ViT-B-32"})
    with span("model_build", "build_clip"):
        model = init_clip_params(build_clip(config.model, dev), seed=seed).requires_grad_(False)
    images, tokens, weak = _train_batch(dev, seed, B, config.model.variant.image_size)
    cfg = TrainConfig(learning_rate=1e-5, warmup_steps=0, total_steps=10)

    def one_step(state):
        marks = [time.perf_counter()]
        leaves = S._leaves(state.params)
        img, txt, scale = S._encode(state, model, leaves, images, tokens, None)
        loss, metrics = S._compose_loss(img, txt, scale, weak, cfg, None)
        _sync_all()
        marks.append(time.perf_counter())
        grads = S._grads(loss, leaves)
        _sync_all()
        marks.append(time.perf_counter())
        state, m = S._finish(state, grads, cfg, metrics)
        float(m["loss"])
        _sync_all()
        marks.append(time.perf_counter())
        return state, [1e3 * (b - a) for a, b in zip(marks, marks[1:])]

    out = {}
    for name, shape in (("one_card", None), ("2x2", (2, 2))):
        state = S.create_train_state(model, S.model_params(model), cfg)
        if shape is not None:
            state = S.make_sharded_train_step(model, _mesh_of(dev, *shape), cfg)[1](state)
        _sync_all()
        state, _ = one_step(state)
        parts = []
        for _ in range(MESH_TRAIN_STEPS):
            state, ms = one_step(state)
            parts.append(ms)
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            state, _ = one_step(state)
        kernels = [e for e in prof.events() if e.device_type.name == "CUDA"]
        mean = np.mean(parts, axis=0)
        out[name] = {"forward_ms": mean[0], "backward_ms": mean[1], "update_ms": mean[2],
                     "step_ms": float(mean.sum()), "cuda_events_a_step": len(kernels),
                     "device_ms_a_step": sum(e.time_range.end - e.time_range.start
                                             for e in kernels) / 1e3}
        del state
        _reset_peaks()
    return out


def phase_mesh_train(dev, seed, root, checkpoint, card, four_cards: bool) -> tuple:
    """The sharded towers and the mesh train step (see _mesh_step_checks,
    _mesh_trainer): ViT-B-32 at full width, seeded, COMPUTE_DTYPE=float32,
    B=MESH_TRAIN_B, one step on each of (4, 1), (2, 2), (1, 4) and (4, 1)
    with TRAIN_FSDP against the one-card step; then MESH_TRAIN_STEPS bf16
    steps of ``Trainer(mesh=)`` with TRAIN_FSDP on (2, 2) over the pipeline
    store with the device feed. Four distinct cards where the host has them
    (else card 0 repeated). Without ``four_cards`` also the (2, 2) Trainer
    without FSDP and a step's host time by part (_step_parts). With
    ``four_cards`` also: (4, 1) and (4, 1) with TRAIN_FSDP in process (step
    ms, each card's idle share and peak; the FSDP one over the pairs the
    multihost phase's quad trains on), ``train`` as processes with
    ``--mesh-data 4`` and with ``TRAIN_FSDP=1 --mesh-data 4``, and ViT-H-14
    (_h14). Returns the launches, the fp32 checks and the Trainers' rows
    (the multihost phase holds its Trainers to the (2, 2) and (4, 1) FSDP
    ones)."""
    import os

    from tpualign_torch.config import load_config
    from tpualign_torch.models.clip import build_clip, init_clip_params
    from tpualign_torch.store import EmbeddingStore
    from tpualign_torch.train.trainer import build_pair_dataset, heldout_split

    tally: dict = {}
    head = {"phase": "mesh_train", "card": card, "model": "ViT-B-32"}
    t0 = time.perf_counter()

    def part(name, row):  # each part its own line: a later part's failure keeps it
        nonlocal t0
        now = time.perf_counter()
        emit({**head, "part": name, "s": now - t0, name: row})
        t0 = now

    config = load_config({"CLIP_MODEL": "ViT-B-32", "COMPUTE_DTYPE": "float32"})
    with span("model_build", "build_clip"):
        model = init_clip_params(build_clip(config.model, dev), seed=seed).requires_grad_(False)
    batch = _train_batch(dev, seed, MESH_TRAIN_B, config.model.variant.image_size)
    checks = _mesh_step_checks(dev, model, batch, MESH_TRAIN_SHAPES, tally, "ViT-B-32 fp32")
    part("fp32_checks", {"B": MESH_TRAIN_B, **checks})
    del model, batch
    env = _train_env(root, checkpoint, seed)
    store = EmbeddingStore(env["STORE_DIR"], embed_dim=512)
    triples = build_pair_dataset(store, "clip_combined",
                                 os.path.join(env["OUTPUT_DIR"], "images"))
    fsdp = {**env, "TRAIN_FSDP": "1"}
    runs = [("2x2_fsdp", _mesh_of(dev, 2, 2), fsdp, triples)]
    if four_cards:
        quad_triples = heldout_split(triples, seed, QUAD_EVAL_FRACTION)[1]
        runs = [("data4", _mesh_of(dev, 4, 1), env, triples),
                ("data4_fsdp", _mesh_of(dev, 4, 1), fsdp, quad_triples)] + runs
    else:
        runs = [("2x2", _mesh_of(dev, 2, 2), env, triples)] + runs
    trainers = {name: _mesh_trainer(case_env, case_triples, seed, mesh, tally, four_cards)
                for name, mesh, case_env, case_triples in runs}
    part("trainer", trainers)
    part("int8_qat", _int8_qat_step(dev, env, seed, tally))
    if not four_cards:
        part("step_parts", _step_parts(dev, seed))
    if four_cards:
        work = os.path.join(root, "pipeline")
        part("processes", {
            "data4": _mesh_train_process(env, work, "data4", 4, 1,
                                         extra_args=("--mesh-data", "4")),
            "data4_fsdp": _mesh_train_process(env, work, "data4-fsdp", 4, 1,
                                              extra_env={"TRAIN_FSDP": "1"},
                                              extra_args=("--mesh-data", "4"))})
        part("h14", _h14(dev, seed, tally))
    emit({**head, "launches": dict(tally)})
    for name in ("fused_mha", "fused_mha_backward", "normalize_u8"):
        check(tally.get(name, 0) > 0, f"{name} was not launched on the mesh_train path")
    return tally, checks, trainers


# -- multihost: processes across the cards of one host ---------------------------

MULTIHOST_ROWS = 100_000   # the seeded corpus every process builds alike
MULTIHOST_PAGES = 2_000
MULTIHOST_QUERIES = 512    # keyed queries, and as many wildcard ones
MULTIHOST_ADD = 256        # keyed rows added past the index's capacity
MULTIHOST_REMOVE_SHARE = 0.25
QUAD_STEPS = 10            # the (4, 1) FSDP Trainer's steps in four processes
QUAD_EVAL_FRACTION = 0.1   # its held-out share, evaluated at the start and the end


def _multihost_corpus(seed):
    """Unit rows around page topics (16 duplicated: exact ties across
    shards), their manuals and pages, keyed queries near stored rows and
    wildcard ones, MULTIHOST_ADD keyed rows to add (4 of them ties with
    stored rows) and the ids to remove after the add; numpy-seeded, so
    every process builds the same."""
    rng = np.random.default_rng(seed + 23)
    topics = rng.normal(size=(MULTIHOST_PAGES, 512)).astype(np.float32)
    page = rng.integers(0, MULTIHOST_PAGES, MULTIHOST_ROWS)
    rows = topics[page] + 1.5 * rng.normal(size=(MULTIHOST_ROWS, 512)).astype(np.float32)
    rows[-16:] = rows[:16]
    rows /= np.linalg.norm(rows, axis=1, keepdims=True)
    manuals = [f"m{p // 100}" for p in page]
    pages = [int(p % 100) for p in page]
    pick = rng.integers(0, MULTIHOST_ROWS, 2 * MULTIHOST_QUERIES)
    q = rows[pick] + 0.1 * rng.normal(size=(len(pick), 512)).astype(np.float32)
    q /= np.linalg.norm(q, axis=1, keepdims=True)
    keyed = (q[:MULTIHOST_QUERIES], [manuals[i] for i in pick[:MULTIHOST_QUERIES]],
             [pages[i] for i in pick[:MULTIHOST_QUERIES]])
    extra = rng.integers(0, MULTIHOST_PAGES, MULTIHOST_ADD)
    add = topics[extra] + 1.5 * rng.normal(size=(MULTIHOST_ADD, 512)).astype(np.float32)
    add[:4] = rows[16:20]
    add /= np.linalg.norm(add, axis=1, keepdims=True)
    added = (add, [f"m{p // 100}" for p in extra], [int(p % 100) for p in extra])
    total = MULTIHOST_ROWS + MULTIHOST_ADD
    remove = np.sort(rng.choice(total, int(total * MULTIHOST_REMOVE_SHARE), replace=False))
    return rows, manuals, pages, keyed, q[MULTIHOST_QUERIES:], added, remove


def _multihost_searches(mesh, seed) -> tuple:
    """The exact index over _multihost_corpus on ``mesh`` at int8 and fp32:
    built, after MULTIHOST_ADD keyed rows past its capacity, after a remove
    of MULTIHOST_REMOVE_SHARE of the ids and after a compact, each time
    gather and streaming, keyed and wildcard, k=10 and k=100; then the fp32
    ring over the keyed queries (Q a multiple of 4), bit-equal to gather.
    Returns the host answers by name, the tombstone counts and compact
    permutations by name, and the ms of each search (host clock)."""
    from tpualign_torch.parallel.retrieval import RetrievalIndex

    rows, manuals, pages, (qk, qman, qpg), qw, added, remove = _multihost_corpus(seed)
    answers, facts, ms = {}, {}, {}

    def searches(index, stage):
        for strategy in ("gather", "streaming"):
            for k in (10, 100):
                for what, q, kw in (("keyed", qk, dict(query_manuals=qman, query_pages=qpg)),
                                    ("wildcard", qw, dict(global_search=True))):
                    name = f"{index.precision}-{stage}-{strategy}-k{k}-{what}"
                    index.search(q, k=k, strategy=strategy, **kw)  # warm-up, untimed
                    t0 = time.perf_counter()
                    answers[name] = index.search(q, k=k, strategy=strategy, **kw)
                    ms[name] = (time.perf_counter() - t0) * 1e3

    for precision in ("int8", "fp32"):
        index = RetrievalIndex(rows, manuals, pages, precision=precision, mesh=mesh)
        searches(index, "built")
        capacity = index._n_local
        index.add(*added)
        check(index._n_local > capacity, f"{precision}: the add did not grow the capacity")
        searches(index, "add")
        facts[f"{precision}-counts"] = np.array([index.remove(remove), index.dead, index.n])
        searches(index, "remove")
        facts[f"{precision}-perm"] = index.compact()
        facts[f"{precision}-compacted"] = np.array([index.dead, index.n, index._n_local])
        searches(index, "compact")
        if precision == "fp32":
            ring = index.search(qk, qman, qpg, k=10, strategy="ring")
            gather = answers["fp32-compact-gather-k10-keyed"]
            check(all(np.array_equal(a, b) for a, b in zip(ring, gather)),
                  "the fp32 ring differs from gather")
            answers["fp32-compact-ring-k10-keyed"] = ring
        del index
    return answers, facts, ms


def _params_digest(tree, prefix="") -> dict:
    """sha256 of every leaf of a JAX-layout tree of arrays, by path."""
    import hashlib

    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_params_digest(v, f"{prefix}{k}/"))
        else:
            out[prefix + k] = hashlib.sha256(np.ascontiguousarray(v).tobytes()).hexdigest()
    return out


def _multihost_trainer(env, mesh, work, tag, steps, eval_fraction, idle: bool) -> dict:
    """``Trainer(mesh=)`` in this process of a mesh across processes, over
    the pipeline store (bf16, the device feed, B=256, ``env``'s
    TRAIN_FSDP): ``train`` for ``steps`` steps into ``<work>/<tag>-ck``
    (held-out evaluation at the start and the end when ``eval_fraction``
    > 0), through a wrapper around the Trainer's step: every step's loss,
    the step synchronised on this process's cards (host clock), the wait
    before it (the feed), with ``idle`` the last step under the profiler
    (this process's cards' idle share); the kernels' launches, each card's
    peak memory, the held-out trajectory, and process 0's digest of the
    export params (which every process gathers)."""
    import os

    from tpualign_torch.config import load_config
    from tpualign_torch.models.convert import to_jax_layout
    from tpualign_torch.ops.attention import fused_mha
    from tpualign_torch.ops.normalize import normalize_u8
    from tpualign_torch.train.trainer import Trainer

    trainer = Trainer(load_config(env), mesh=mesh)
    real = trainer._step
    losses, step_s, feed_s, ended, profiled = [], [], [], [], {}

    def timed(*args):
        _sync_all()
        t0 = time.perf_counter()
        if ended:
            feed_s.append(t0 - ended[-1])
        if idle and len(losses) == steps - 1:
            box = []
            profiled.update(_card_idle(lambda: box.append(real(*args))))
            result = box[0]
        else:
            result = real(*args)
        losses.append(float(result[1]["loss"]))
        _sync_all()
        ended.append(time.perf_counter())
        step_s.append(ended[-1] - t0)
        return result

    trainer._step = timed
    _reset_peaks()
    fused_mha.launches = fused_mha.backward_recomputes = normalize_u8.launches = 0
    t0 = time.perf_counter()
    out = trainer.train(schema="clip_combined", steps=steps, batch_size=B, log_every=1,
                        ckpt_dir=os.path.join(work, f"{tag}-ck"),
                        eval_every=steps if eval_fraction else 0, eval_fraction=eval_fraction,
                        metrics_file=os.path.join(work, f"{tag}-metrics.jsonl"))
    train_s = time.perf_counter() - t0
    launches = {"fused_mha": fused_mha.launches,
                "fused_mha_backward": fused_mha.backward_recomputes,
                "normalize_u8": normalize_u8.launches}
    rows, m = len(mesh.local_rows), mesh.shape["model"]
    v = trainer.variant
    check(launches["fused_mha_backward"] == (v.vision_layers + v.text_layers) * rows * m * steps
          and launches["normalize_u8"] == rows * steps and launches["fused_mha"] > 0,
          f"Trainer across processes ({tag}): launches {launches} in {steps} steps")
    export = trainer.export_params  # every process gathers; process 0 digests
    digest = (_params_digest(to_jax_layout({k: t.float().cpu() for k, t in export.items()}))
              if mesh.rank == mesh.processes[0] else None)
    timed = step_s[1:-1] if idle else step_s[1:]  # past the warm-up, not profiled
    step_ms = 1e3 * float(np.mean(timed))
    feed_ms = 1e3 * float(np.mean(feed_s[:len(timed)]))  # the waits before them
    return {"steps": steps, "losses": losses, "final": {k: out[k] for k in ("loss", "grad_norm")},
            "heldout": out.get("heldout"), "train_s": train_s,
            "step_ms_each": [1e3 * x for x in step_s], "step_ms": step_ms,
            "feed_wait_ms": feed_ms, "feed_share": feed_ms / (feed_ms + step_ms),
            "pairs_per_s_device": B / (step_ms / 1e3),
            "pairs_per_s_with_feed": B / ((step_ms + feed_ms) / 1e3),
            "idle": profiled or None, "peak_memory_gb_by_card": _card_peaks(),
            "launches": launches, "digest": digest}


def _multihost_worker(mode, work, seed, root, checkpoint) -> int:
    """One process of the multihost phase (its cards named by
    CUDA_VISIBLE_DEVICES, the group by COORDINATOR_ADDRESS, NUM_PROCESSES
    and PROCESS_ID): ``pair`` (two processes of two cards: the sum across
    them; the sharded searches and mutations on hybrid_mesh(1); one
    ViT-B-32 fp32 step on hybrid_mesh(2) at B=MESH_TRAIN_B; then
    ``Trainer(mesh=hybrid_mesh(2))`` with TRAIN_FSDP for MESH_TRAIN_STEPS
    steps into a checkpoint) or ``quad`` (four processes of one card:
    ``Trainer(mesh=hybrid_mesh(1))`` with TRAIN_FSDP for QUAD_STEPS steps
    with held-out evaluation, timed). Prints its results as one JSON
    line."""
    import os

    import torch.distributed as dist

    from tpualign_torch.config import load_config
    from tpualign_torch.models.clip import build_clip, init_clip_params
    from tpualign_torch.ops.attention import fused_mha
    from tpualign_torch.ops.sim_topk import masked_sim_topk, masked_sim_topk_quant
    from tpualign_torch.parallel.multihost import (
        hybrid_mesh, initialize_distributed, process_sum)

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    seed = int(seed)
    check(initialize_distributed(), "the worker was started without COORDINATOR_ADDRESS")
    pid, world = dist.get_rank(), dist.get_world_size()
    out = {"mode": mode, "process": pid, "processes": world, "backend": dist.get_backend(),
           "cards": os.environ.get("CUDA_VISIBLE_DEVICES")}
    fsdp_env = _train_env(root, checkpoint, seed, TRAIN_FSDP="1")
    if mode == "pair":
        mesh = hybrid_mesh(model_parallel=2)
        check(mesh.shape == {"data": 2, "model": 2} and mesh.local_rows == [pid],
              f"hybrid_mesh(2): {mesh.shape}, rows {mesh.local_rows}")
        # every position of this process's row adds its process's id + 1
        local = torch.tensor(float(len(mesh.row(pid)) * (pid + 1)), device=mesh.home)
        total = float(process_sum(mesh, [local])[0])
        check(total == 6.0, f"the sum across the processes is {total}, not 6.0")
        out["all_reduce"] = total
        data4 = hybrid_mesh(model_parallel=1)
        check(data4.shape == {"data": 4, "model": 1} and data4.local_rows == [2 * pid, 2 * pid + 1],
              f"hybrid_mesh(1): {data4.shape}, rows {data4.local_rows}")
        masked_sim_topk.launches = masked_sim_topk_quant.launches = 0
        t0 = time.perf_counter()
        answers, facts, out["search_ms"] = _multihost_searches(data4, seed)
        out["index_s"] = time.perf_counter() - t0
        out["index_launches"] = {"masked_sim_topk": masked_sim_topk.launches,
                                 "masked_sim_topk_quant": masked_sim_topk_quant.launches}
        check(masked_sim_topk.launches > 0 and masked_sim_topk_quant.launches > 0,
              f"the searches launched {out['index_launches']}")
        np.savez(os.path.join(work, f"multihost-{pid}.npz"),
                 **{f"{name}-{part}": arr for name, pair in answers.items()
                    for part, arr in zip(("v", "i"), pair)},
                 **{f"fact-{name}": arr for name, arr in facts.items()})
        del answers
        torch.cuda.empty_cache()
        config = load_config({"CLIP_MODEL": "ViT-B-32", "COMPUTE_DTYPE": "float32"})
        with span("model_build", "build_clip"):
            model = init_clip_params(build_clip(config.model, mesh.home), seed=seed)
        batch = _train_batch(mesh.home, seed, MESH_TRAIN_B, config.model.variant.image_size)
        from tpualign_torch.config import TrainConfig
        from tpualign_torch.train import step as S

        cfg = TrainConfig(learning_rate=MESH_TRAIN_LR, warmup_steps=0, total_steps=10)
        run, shard_state = S.make_sharded_train_step(model.requires_grad_(False), mesh, cfg)
        state = shard_state(S.create_train_state(model, S.model_params(model), cfg))
        _sync_all()
        fused_mha.launches = 0
        t0 = time.perf_counter()
        state, m = run(state, *batch)
        _sync_all()
        out["step"] = {"loss": float(m["loss"]), "grad_norm": float(m["grad_norm"]),
                       "ms": (time.perf_counter() - t0) * 1e3, "k1_launches": fused_mha.launches}
        del state, model, batch, run, shard_state
        torch.cuda.empty_cache()
        out["trainer"] = _multihost_trainer(fsdp_env, mesh, work, "pair", MESH_TRAIN_STEPS, 0.0,
                                            idle=False)
    else:
        mesh = hybrid_mesh(model_parallel=1)
        check(mesh.shape == {"data": world, "model": 1} and mesh.local_rows == [pid],
              f"hybrid_mesh(1): {mesh.shape}, rows {mesh.local_rows}")
        out["trainer"] = _multihost_trainer(fsdp_env, mesh, work, "quad", QUAD_STEPS,
                                            QUAD_EVAL_FRACTION, idle=True)
    dist.barrier()
    dist.destroy_process_group()
    emit(out)
    return 0


def _multihost_run(mode, visible, work, seed, root, checkpoint, timeout=600) -> list:
    """_multihost_worker(``mode``) in ``len(visible)`` processes, process i
    on the cards ``visible[i]`` (CUDA_VISIBLE_DEVICES), one NCCL group at a
    free local port; every process is waited for (killed past
    ``timeout``). Returns each process's JSON line."""
    import os
    import socket

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    repo = os.path.dirname(os.path.abspath(__file__))
    path = os.pathsep.join(p for p in (repo, os.environ.get("PYTHONPATH")) if p)
    procs = []
    for pid, cards in enumerate(visible):
        env = dict(os.environ, PYTHONPATH=path, COORDINATOR_ADDRESS=f"127.0.0.1:{port}",
                   NUM_PROCESSES=str(len(visible)), PROCESS_ID=str(pid),
                   CUDA_VISIBLE_DEVICES=cards)
        err = open(os.path.join(work, f"multihost-{mode}-{pid}.err"), "w")
        procs.append((subprocess.Popen(
            [sys.executable, "-c", READY + "import chip_smoke\n"
             "sys.exit(chip_smoke._multihost_worker(*sys.argv[1:]))", mode, work, str(seed),
             root, checkpoint],
            stdout=subprocess.PIPE, stderr=err, text=True, cwd=work, env=env), err,
            time.time()))
    outs = []
    try:
        deadline = time.monotonic() + timeout
        for p, _, _ in procs:
            outs.append(p.communicate(timeout=max(1.0, deadline - time.monotonic()))[0])
    finally:
        for pid, (p, err, spawned) in enumerate(procs):
            if p.poll() is None:
                p.kill()
                p.wait()
            err.close()
            with open(err.name) as f:
                child_done(f"multihost-{mode}-{pid}", spawned, f.read())
    for pid, ((p, err, _), out) in enumerate(zip(procs, outs)):
        check(p.returncode == 0 and out.strip(), f"multihost {mode} process {pid} exited "
                                                 f"{p.returncode}: {open(err.name).read()[-3000:]}")
    return [json.loads(out.strip().splitlines()[-1]) for out in outs]


def _same_losses(got, want, what) -> float:
    """Every process's per-step losses equal, and within MESH_LOSS_REL of
    ``want`` (an in-process Trainer's, step for step); returns the largest
    relative gap."""
    check(all(g == got[0] for g in got), f"{what}: the processes report {got}")
    n = min(len(got[0]), len(want))
    gap = max(abs(a - b) / abs(b) for a, b in zip(got[0][:n], want[:n]))
    check(gap <= MESH_LOSS_REL, f"{what}: losses {got[0][:n]} against in-process {want[:n]}")
    return gap


def phase_multihost(dev, seed, root, card, checkpoint, mesh_train_checks, trainers) -> dict:
    """Processes across the four cards (parallel/multihost.py, NCCL): two
    processes of two cards (_multihost_worker ``pair``) against this
    process's one-process mesh on the same four cards: every search answer
    of the built, grown, tombstoned and compacted index equal (indices
    identical, values within 1e-6), its tombstone counts and compact
    permutation equal, the fp32 ring equal; the (2, 2) fp32 step's loss
    within MESH_LOSS_REL and grad_norm within MESH_NORM_REL of the
    one-process (2, 2) step of mesh_train's fp32 checks, the two processes'
    equal; the (2, 2) FSDP Trainer's losses equal on both processes and
    within MESH_LOSS_REL of mesh_train's in-process (2, 2) FSDP Trainer
    step for step, and its checkpoint, read here by ``load_trained_params``,
    bit-equal to the params process 0 exported. Then four processes of one
    card (``quad``): the (4, 1) FSDP Trainer with held-out evaluation, its
    losses equal across the processes and within MESH_LOSS_REL of
    mesh_train's in-process (4, 1) FSDP Trainer over the same pairs, the
    held-out metrics equal; step ms, pairs/s, the feed's share, each card's
    idle share and peak beside the in-process Trainer's."""
    import os

    from tpualign_torch.parallel import create_mesh
    from tpualign_torch.train.checkpoint import load_trained_params

    work = os.path.join(root, "multihost")
    os.makedirs(work)
    out = {"phase": "multihost", "card": card}
    t0 = time.perf_counter()
    pair = _multihost_run("pair", ["0,1", "2,3"], work, seed, root, checkpoint)
    out["pair_s"] = time.perf_counter() - t0
    want, facts, _ = _multihost_searches(create_mesh(4), seed)
    gap = 0.0
    for pid in range(2):
        got = np.load(os.path.join(work, f"multihost-{pid}.npz"))
        for name, pair_want in want.items():
            gap = max(gap, _same_search((got[f"{name}-v"], got[f"{name}-i"]), pair_want,
                                        f"multihost process {pid} {name}"))
        for name, fact in facts.items():
            check(np.array_equal(got[f"fact-{name}"], fact),
                  f"multihost process {pid} {name}: {got[f'fact-{name}']} against {fact}")
    one = mesh_train_checks["2x2"]
    losses = [p["step"]["loss"] for p in pair]
    norms = [p["step"]["grad_norm"] for p in pair]
    check(losses[0] == losses[1] and norms[0] == norms[1],
          f"the two processes report loss {losses} and grad_norm {norms}")
    check(abs(losses[0] - one["loss"]) <= MESH_LOSS_REL * abs(one["loss"])
          and abs(norms[0] - one["grad_norm"]) <= MESH_NORM_REL * abs(one["grad_norm"]),
          f"the two-process (2, 2) step: loss {losses[0]} / {one['loss']}, grad_norm "
          f"{norms[0]} / {one['grad_norm']}")
    in_2x2 = trainers["2x2_fsdp"]
    pair_gap = _same_losses([p["trainer"]["losses"] for p in pair], in_2x2["losses"],
                            "the two-process (2, 2) FSDP Trainer")
    saved = _params_digest(load_trained_params(os.path.join(work, "pair-ck")))
    check(saved == pair[0]["trainer"]["digest"],
          "the two-process checkpoint differs from the params process 0 exported")
    out["pair"] = {
        "processes": [{k: v for k, v in p.items() if k not in ("trainer",)} for p in pair],
        "searches": len(want), "search_max_abs_gap": gap, "facts": {
            k: v.tolist() if v.size < 8 else int(v.size) for k, v in facts.items()},
        "one_process_2x2": {"loss": one["loss"], "grad_norm": one["grad_norm"],
                            "ms": one["ms"]},
        "trainer": {"losses": pair[0]["trainer"]["losses"], "loss_max_rel_gap": pair_gap,
                    "in_process_2x2_fsdp_losses": in_2x2["losses"],
                    "checkpoint_bit_equal": True, "leaves": len(saved),
                    "launches_by_process": [p["trainer"]["launches"] for p in pair],
                    "train_s": [p["trainer"]["train_s"] for p in pair],
                    "peak_memory_gb_by_process": [p["trainer"]["peak_memory_gb_by_card"]
                                                  for p in pair]}}
    t0 = time.perf_counter()
    quad = _multihost_run("quad", ["0", "1", "2", "3"], work, seed, root, checkpoint)
    out["quad_s"] = time.perf_counter() - t0
    in_4x1 = trainers["data4_fsdp"]
    rows = [p["trainer"] for p in quad]
    quad_gap = _same_losses([r["losses"] for r in rows], in_4x1["losses"],
                            "the four-process (4, 1) FSDP Trainer")
    check(all(r["heldout"] == rows[0]["heldout"] for r in rows) and rows[0]["heldout"],
          f"the four processes' held-out metrics: {[r['heldout'] for r in rows]}")
    step_ms = max(r["step_ms"] for r in rows)
    feed_ms = max(r["feed_wait_ms"] for r in rows)
    out["quad"] = {
        "B": B, "dtype": "bfloat16", "fsdp": True, "steps": QUAD_STEPS,
        "eval_fraction": QUAD_EVAL_FRACTION, "heldout": rows[0]["heldout"],
        "losses": rows[0]["losses"], "loss_max_rel_gap": quad_gap,
        "step_ms": step_ms, "feed_wait_ms": feed_ms, "feed_share": feed_ms / (feed_ms + step_ms),
        "pairs_per_s_device": B / (step_ms / 1e3),
        "pairs_per_s_with_feed": B / ((step_ms + feed_ms) / 1e3),
        "by_process": [{k: r[k] for k in ("step_ms", "step_ms_each", "feed_wait_ms", "idle",
                                          "peak_memory_gb_by_card", "launches", "train_s")}
                       for r in rows],
        "in_process_4x1_fsdp": {k: in_4x1[k] for k in (
            "step_ms", "feed_wait_ms", "feed_share", "pairs_per_s_device",
            "pairs_per_s_with_feed", "losses", "peak_memory_gb_by_card")}
        | {"idle": in_4x1.get("idle")}}
    out["launches_by_process"] = {
        "pair": [{**p["index_launches"], **p["trainer"]["launches"],
                  "fused_mha_fp32_step": p["step"]["k1_launches"]} for p in pair],
        "quad": [r["launches"] for r in rows]}
    emit(out)
    return out


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--seed", type=int, default=0)
    parser.add_argument("--mesh-only", action="store_true",
                        help="only the phases the mesh phase stands on (build, checkpoint, "
                             "device_feed, pipeline, serve) and the mesh phase; no kernels line")
    args = parser.parse_args()
    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available", file=sys.stderr)
        return 2
    import os

    import tpualign_torch  # noqa: F401  (fails outside a checkout)
    from tpualign_torch.store import SCHEMAS

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda", 0)
    card = card_line()
    emit({"phase": "card", "nvidia_smi": card, "torch": torch.__version__,
          "cuda": torch.version.cuda, "device": torch.cuda.get_device_name(0),
          "count": torch.cuda.device_count()})
    _time_model_builds()
    seconds, split = {}, {}
    t_start = t0 = time.perf_counter()
    w_start = w0 = time.time()

    def lap(name):
        nonlocal t0, w0
        now, wall = time.perf_counter(), time.time()
        seconds[name], split[name] = now - t0, time_split(w0, wall)
        t0, w0 = now, wall

    with tempfile.TemporaryDirectory(prefix="tpualign_ckpt_") as ckpt_dir:
        feed = tempfile.TemporaryDirectory(prefix="tpualign_feed_")
        # host work beside the kernels' build: the seeded tree's checkpoint,
        # the device_feed phase's files and the pipeline phase's manuals
        written = _beside(phase_checkpoint, ckpt_dir, args.seed)
        host_corpus = _beside(_host_corpus, feed.name, args.seed)
        h14_engine = None if args.mesh_only else _beside(_h14_engine, dev, args.seed)
        with span("kernel_build"):
            phase_build()
        lap("build")
        checkpoint, corpus = written.result(), host_corpus.result()
        if h14_engine is not None:
            h14_engine.result()  # built before the timed phases start
        lap("checkpoint")
        if not args.mesh_only:
            gen = torch.Generator(device=dev).manual_seed(args.seed)
            k1 = phase_k1(dev, gen)
            lap("k1")
            k2 = phase_k2(dev, gen)
            lap("k2")
            launches = phase_slice(dev, args.seed)
            fp32_launches = phase_fp32_towers(dev, args.seed)
            lap("slice")
            h14 = phase_h14_embed(dev, args.seed, h14_engine)
            del h14_engine
            lap("h14_embed")
            int8_launches, int8_split_launches = phase_int8_towers(dev, args.seed)
            lap("int8_towers")
            k3 = phase_k3(dev, gen)
            lap("k3")
            k4 = phase_k4(dev, gen)
            lap("k4")
            k5 = phase_k5(dev, gen)
            lap("k5")
        with feed as root:
            phase_device_feed(dev, args.seed, root, corpus)
            lap("device_feed")
            pipe_launches, k2_eval, ingest_launches, mesh_embed = phase_pipeline(
                dev, args.seed, root, corpus, checkpoint, bitwise=not args.mesh_only)
            lap("pipeline")
            if not args.mesh_only:
                train, hnsw_index = phase_train(dev, args.seed, root, checkpoint, card)
                lap("train")
                hnsw_launches = phase_hnsw(dev, args.seed, root, checkpoint, card, hnsw_index)
                lap("hnsw")
            four_cards = args.mesh_only and torch.cuda.device_count() >= 4
            mesh_train, train_checks, trainers = phase_mesh_train(
                dev, args.seed, root, checkpoint, card, four_cards)
            lap("mesh_train")
            if four_cards:
                phase_multihost(dev, args.seed, root, card, checkpoint, train_checks, trainers)
                lap("multihost")
            mesh, mesh_on = _mesh(dev)
            mesh_tally = {}
            mesh_eval = phase_mesh_evaluator(dev, os.path.join(root, "pipeline", "store"),
                                             os.path.join(root, "pipeline"), SCHEMAS, mesh,
                                             mesh_tally)
            lap("mesh_evaluator")
        with tempfile.TemporaryDirectory(prefix="tpualign_serve_") as root:
            serve_launches, k3_serve, shared = phase_serve(
                dev, args.seed, root, checkpoint,
                precisions=("int8",) if args.mesh_only else ("int8", "int4", "int2"),
                ivf=not args.mesh_only)
            lap("serve")
            if not args.mesh_only:
                ivf_launches, k4_head = phase_serve_ivf(dev, args.seed, root, shared)
                lap("serve_ivf")
                live_launches = phase_live(dev, args.seed, root, shared)
                lap("live")
            mesh_launches = phase_mesh(dev, args.seed, root, checkpoint, shared, mesh, mesh_on,
                                       mesh_tally, mesh_eval, mesh_embed)
            lap("mesh")
            del shared
    emit({"phase": "timing", "seconds": seconds, "total_s": time.perf_counter() - t_start,
          "split": split,
          "split_total": {k: sum(v[k] for v in split.values())
                          for k in ("kernel_build", "model_build", "child_start", "rest",
                                    "children")},
          "children": children(w_start)})
    if args.mesh_only:
        print(card, flush=True)
        emit({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                     "count": torch.cuda.device_count()}})
        return 0

    k1_head = next(r for r in k1 if r["shape"] == "vision" and r["dtype"] == "bfloat16")
    k1_fp32 = next(r for r in k1 if r["shape"] == "vision" and r["dtype"] == "float32")
    train_launches = train["processes"]["full"]["launches"]
    k2_head = next(r for r in k2 if r["k"] == 100)
    k3_head = next(r for r in k3 if r["variant"] == "int8" and r["k"] == 40)
    k4_125 = next(r for r in k4 if r["variant"] == "int8" and r["Q"] == 2 and r["k"] == 40)
    keys = ("max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by", "library_ms")
    emit({"kernels": [
        {"name": "fused_mha", "route": "cuda", "source": "tpualign_torch/csrc/fused_mha.cu",
         "replaces": "tpualign/ops/pallas_attention.py:162",
         "launches": launches["fused_mha"], **{k: k1_head[k] for k in keys},
         "launches_by_phase": {"slice": launches["fused_mha"],
                               "slice_fp32_towers": fp32_launches,
                               "h14_embed": h14["launches"],
                               "h14_embed_t257": h14["t257"],
                               "int8_towers": int8_launches["fused_mha"],
                               "int8_towers_1x2": int8_split_launches["fused_mha"],
                               "serve": serve_launches["fused_mha"],
                               "serve_ivf": ivf_launches["fused_mha"],
                               "pipeline": pipe_launches["fused_mha"],
                               "ingest": ingest_launches["fused_mha"],
                               "live": live_launches["fused_mha"],
                               "train": train_launches["fused_mha"],
                               "hnsw": hnsw_launches["fused_mha"],
                               "mesh": mesh_launches["fused_mha"],
                               "mesh_train": mesh_train["fused_mha"]},
         "train_backward_recomputes": train_launches["fused_mha_backward"],
         "mesh_train_backward_recomputes": mesh_train["fused_mha_backward"],
         "training": {"backward": "recomputes the plain attention (as tpualign's custom_vjp)",
                      "rows": train["k1_backward"],
                      "launches_in_process_steps": train["timed"]["device"]["launches"]},
         "tolerance": {"atol": k1_head["atol"], "rtol": k1_head["rtol"]},
         "at": "ViT-B-32 vision, B=256 T=50 D=768 H=12, bf16; ms and library_ms over a CUDA "
               "graph of 64 launches",
         "fp32_vision": {**{k: k1_fp32[k] for k in keys}, "launches": fp32_launches,
                         "ms_events": k1_fp32["ms_events"],
                         "tolerance": {"atol": k1_fp32["atol"], "rtol": k1_fp32["rtol"]},
                         "at": "ViT-B-32 vision, B=256 T=50 D=768 H=12, fp32 (CUDA cores); "
                               "launches from the slice's fp32 towers"}},
        {"name": "masked_sim_topk", "route": "cuda",
         "source": "tpualign_torch/csrc/masked_sim_topk.cu",
         "replaces": "tpualign/ops/pallas_kernels.py:329",
         "launches": launches["masked_sim_topk"], **{k: k2_head[k] for k in keys},
         "launches_by_phase": {"slice": launches["masked_sim_topk"],
                               "pipeline": pipe_launches["masked_sim_topk"],
                               "live": live_launches["masked_sim_topk"],
                               "mesh": mesh_launches["masked_sim_topk"]},
         "tolerance": {"values_atol": K2_TOL_VALUES, "tie_gap": K2_TIE_GAP},
         "at": (f"fp32 Q=1024 N=100000 D=512 k=100, {k2_head['admitted_tiles']} of "
                f"{k2_head['tiles']} tiles admitted; at the "
                f"Evaluator's search (pipeline phase: Q={k2_eval['Q']} N={k2_eval['N']} "
                f"k={k2_eval['k']}, {k2_eval['admitted_tiles']} of {k2_eval['tiles']} tiles "
                f"admitted) {k2_eval['ms']:.4f} ms, library {k2_eval['library_ms']:.4f} ms, "
                f"bound {k2_eval['bound_ms']:.4f} ms ({k2_eval['bound_by']})")},
        {"name": "masked_sim_topk_quant", "route": "cuda",
         "source": "tpualign_torch/csrc/masked_sim_topk_quant.cu",
         "replaces": "tpualign/ops/pallas_kernels.py:523",
         "launches": serve_launches["masked_sim_topk_quant"], **{k: k3_head[k] for k in keys},
         "launches_by_phase": {"serve": serve_launches["masked_sim_topk_quant"],
                               "serve_ivf": ivf_launches["masked_sim_topk_quant"],
                               "live": live_launches["masked_sim_topk_quant"],
                               "mesh": mesh_launches["masked_sim_topk_quant"]},
         "tolerance": k3_head["tolerance"],
         "at": (f"int8 (s8) Q=1024 N=1000000 D=512 k=40, {k3_head['admitted_tiles']} of "
                f"{k3_head['tiles']} tiles admitted; launches from the serve phase; at the "
                f"serving shape (serve phase, N={k3_serve[0]['N']} k={k3_serve[0]['k']}): "
                + "; ".join(
                    f"{r['query']} Q={r['Q']} {r['ms']:.4f} ms, library {r['library_ms']:.4f} "
                    f"ms, bound {r['bound_ms']:.5f} ms ({r['bound_by']}), "
                    f"{r['admitted_tiles']} of {r['tiles']} tiles admitted" for r in k3_serve))},
        {"name": "ivf_probe_topk", "route": "cuda",
         "source": "tpualign_torch/csrc/ivf_probe_topk.cu",
         "replaces": "tpualign/ops/pallas_kernels.py:778",
         "launches": ivf_launches["ivf_probe_topk"], **{k: k4_head[k] for k in keys},
         "launches_by_phase": {"serve_ivf": ivf_launches["ivf_probe_topk"],
                               "live": live_launches["ivf_probe_topk"],
                               "mesh": mesh_launches["ivf_probe_topk"]},
         "tolerance": k4_head["tolerance"],
         "at": (f"int8 (s8) Q=2 k={k4_head['k']}, the serve_ivf store's two keyed image "
                f"queries at its calibrated {k4_head['n_probes']} probes, N={k4_head['N']} "
                f"D={k4_head['D']}, {k4_head['union_blocks']} of {k4_head['n_lists']} lists "
                f"+ spill; launches from the serve_ivf phase; at the default 125 probes "
                f"(phase k4) {k4_125['ms']:.4f} ms, bound {k4_125['bound_ms']:.4f} ms")},
        {"name": "normalize_u8", "route": "cuda", "source": "tpualign_torch/csrc/normalize_u8.cu",
         "replaces": "tpualign/ops/pallas_kernels.py:805",
         "launches": pipe_launches["normalize_u8"], **{k: k5[k] for k in keys},
         "launches_by_phase": {"pipeline": pipe_launches["normalize_u8"],
                               "ingest": ingest_launches["normalize_u8"],
                               "train": train_launches["normalize_u8"],
                               "mesh": mesh_launches["normalize_u8"],
                               "mesh_train": mesh_train["normalize_u8"]},
         "tolerance": "bit-identical",
         "at": "u8 (256, 224, 224, 3) -> fp32, one device-feed batch of ViT-B-32; launches "
               "from the pipeline phase's embed stage (IMAGE_PREPROCESS=device)"},
    ]})
    print(card, flush=True)
    emit({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
