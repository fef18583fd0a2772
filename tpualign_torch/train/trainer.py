"""Training loop: weak-supervision-weighted contrastive fine-tuning over the
store's aligned pairs (the port's ``tpualign.train.trainer``).

Pairs come from a schema's alignment table, ``(image, chunk, weak_score)``,
or for vanilla_clip from the same-page cartesian pairs with weight 1;
images decode in a worker process's thread pool ahead of the step (host feed: PIL bicubic
pixels; device feed: uint8 buckets that the step resizes on the card and
normalises through K5), texts tokenize to the 77-token context with the
length buckets; the step runs on one device, or over a mesh
(``Trainer(mesh=)``, ``make_sharded_train_step``: the batch split over
``data``, the towers tensor parallel over ``model``, ``TRAIN_FSDP``), of
one process or across processes (``parallel/multihost.py``): there every
process builds the same pairs and the same seeded batches, decodes only
its own data rows' images (under ``TRAIN_AUGMENT=rrc`` the rows' sizes
are all-reduced, so every process samples the crops alike), and runs its own
rows; process 0 writes the log lines, the metrics file and the
checkpoints; checkpoints go to
``train/checkpoint.py``. The numpy RNG streams are tpualign's (``seed``
the shuffle, ``seed+1`` the patch masks, ``seed+2`` the crops, ``seed+3``
the held-out split), so one seed gives both packages the same batches.
"""

from __future__ import annotations

import json
import os
import queue
import time
from concurrent.futures import ThreadPoolExecutor
from dataclasses import replace
from pathlib import Path
from typing import Iterator, List, Optional, Tuple

import numpy as np
import torch
from torch.func import functional_call

from tpualign_torch.config import PipelineConfig
from tpualign_torch.models.clip import CLIP, build_clip, init_clip_params
from tpualign_torch.models.convert import from_jax_params
from tpualign_torch.models.loader import load_checkpoint_params
from tpualign_torch.ops.preprocess import (
    pad_to_bucket, preprocess_host, sample_crop_boxes)
from tpualign_torch.parallel.embed import truncate_to_bucket
from tpualign_torch.parallel.mesh import shard_devices
from tpualign_torch.parallel.sharding import RowTowers, row_params, shard_params
from tpualign_torch.store import EmbeddingStore
from tpualign_torch.tokenizer import ClipTokenizer
from tpualign_torch.train.step import (
    create_train_state,
    export_params,
    make_sharded_train_step,
    model_params,
    sample_patch_indices,
    train_step,
)
from tpualign_torch.utils.device import resolve_device
from tpualign_torch.utils.logging import get_logger
from tpualign_torch.utils.profiling import ThroughputMeter

log = get_logger("train.trainer")

__all__ = ["Trainer", "build_pair_dataset"]


def build_pair_dataset(store: EmbeddingStore, schema: str,
                       images_dir: str | Path) -> List[Tuple[Optional[str], str, float]]:
    """(image_path, chunk_text, weak_score) triples for one schema: the
    alignment table when populated, else the same-page cartesian pairs with
    weight 1.0; only pairs whose image file exists."""
    images_dir = Path(images_dir)
    images = {r["image_id"]: r for r in store.images(schema)}
    chunks = {r["chunk_id"]: r for r in store.chunks(schema)}

    triples: List[Tuple[Optional[str], str, float]] = []
    alignments = store.alignments(schema)
    if alignments:
        for image_id, chunk_id, score, _ in alignments:
            img = images.get(image_id)
            chunk = chunks.get(chunk_id)
            if img is None or chunk is None:
                continue
            fname = img.get("filename")
            path = str(images_dir / fname) if fname else None
            triples.append((path, chunk["text"], float(score)))
    else:
        from tpualign_torch.evaluation.metrics import get_image_text_pairs

        for image_id, chunk_id, _, _ in get_image_text_pairs(
                list(images.values()), list(chunks.values())):
            img = images[image_id]
            fname = img.get("filename")
            path = str(images_dir / fname) if fname else None
            triples.append((path, chunks[chunk_id]["text"], 1.0))
    return [t for t in triples if t[0] and Path(t[0]).exists()]


def _sub(params, prefix: str) -> dict:
    n = len(prefix)
    return {k[n:]: v for k, v in params.items() if k.startswith(prefix)}


@torch.no_grad()
def _encode_with(model: CLIP, params, images=None, tokens=None) -> torch.Tensor:
    """Unit-norm embeddings of an image batch (or a token batch) through
    ``model``'s tower run on the parameter dict ``params``."""
    if images is not None:
        feats = functional_call(model.visual, _sub(params, "visual."), (images,))
    else:
        feats = functional_call(model.text, _sub(params, "text."), (tokens,))
    return feats / torch.linalg.norm(feats, dim=-1, keepdim=True)


class Trainer:
    """Fine-tunes the CLIP towers on store pairs, on one device or over
    ``mesh``.

    ``params``: the JAX package's tree as nested numpy dicts (see
    ``models/convert.py``); None loads ``CLIP_CHECKPOINT`` when it is set,
    else draws the seeded weights. ``device`` defaults to CUDA and raises
    when it is absent. With ``mesh`` (``parallel/mesh.py``; it names the
    devices, and ``device`` is then not used) the state is laid out on the
    mesh (``TRAIN_FSDP`` splits parameters, moments and EMA over ``data``
    too), each step splits its batch over the data rows (the device feed's
    resize and K5 on each row's first card), held-out evaluation runs the
    towers data and tensor parallel over the mesh, and the model's own
    parameters are released (the mesh holds the weights). ``TRAIN_FSDP``
    without a mesh changes nothing, as in tpualign. On a mesh across
    processes every process constructs the Trainer and calls ``train``
    alike; batches stay on the host until the step moves each row's slice
    to its card, and held-out evaluation runs on this process's rows.
    """

    def __init__(self, config: PipelineConfig, store: Optional[EmbeddingStore] = None,
                 mesh=None, params=None, device: str | torch.device = "cuda"):
        self.config = config
        self.mesh = mesh
        devices = shard_devices(mesh)
        self.device = resolve_device(device) if devices is None else mesh.home
        distributed = devices is not None and mesh.distributed
        # across processes the step moves each row's slice from the host
        self._host_batches = distributed
        self._primary = not distributed or mesh.rank == mesh.processes[0]
        self.variant = config.model.variant
        self.store = store or EmbeddingStore(config.store.root,
                                             embed_dim=self.variant.embed_dim)
        self.model = build_clip(config.model, self.device)
        self.tokenizer = ClipTokenizer(context_length=self.variant.context_length)
        if params is None and config.model.checkpoint_path:
            params = load_checkpoint_params(config.model)
        if params is None:
            log.warning("training from seeded random init (no checkpoint)")
            init_clip_params(self.model, seed=config.seed)
        else:
            from_jax_params(self.model, params)
        self.model.requires_grad_(False)
        self.state = create_train_state(self.model, model_params(self.model), config.train)
        model, tc = self.model, config.train
        if mesh is not None:
            self._step, shard_state = make_sharded_train_step(model, mesh, tc)
            self.state = shard_state(self.state)
            model.to("meta")
            return

        def _single_step(state, images, token_ids, weak_scores, patch_indices=None,
                         teacher=None):
            return train_step(state, model, images, token_ids, weak_scores, tc,
                              patch_indices, teacher)

        self._step = _single_step

    @property
    def export_params(self):
        """The dict to embed and serve with after training (port names):
        the EMA when ``EMA_DECAY`` > 0, else the params; LoRA merged."""
        return export_params(self.state)

    # -- data -----------------------------------------------------------------

    def batches(self, triples, batch_size: int, seed: int = 0,
                epochs: Optional[int] = None, prefetch: int = 2,
                extras: Optional[Tuple[np.ndarray, ...]] = None,
                ) -> Iterator[Tuple[np.ndarray, ...]]:
        """Shuffled, decoded, fixed-shape numpy batches ``(images, tokens,
        weights, *extras)``, cycling over the dataset, as tpualign's:

        - a decode pool (``TRAIN_FEED_WORKERS``, 0 = min(8, cores)) fills
          each batch; a background producer keeps ``prefetch`` batches ahead;
        - decoded images are cached across epochs up to
          ``TRAIN_FEED_CACHE_MB``; a failed decode gives a zero image (its
          weight still applies) and is not cached;
        - texts are cut to the smallest ``TEXT_BUCKETS`` length holding
          every row (exact under the causal mask);
        - ``TRAIN_IMAGE_FEED=device``: images are ``(uint8 buckets, (B, 2)
          true sizes)`` for the step's device preprocess;
        - ``extras``: per-triple arrays sliced with the same selection (the
          distillation teacher bank).

        The producer is a spawned worker process (tpualign's is a thread):
        its decoding and tokenizing then hold no lock the step's kernel
        launches wait for (with a thread, the GIL made a ViT-B-32 step 3x
        slower, PERF.md). An error in the producer surfaces in the
        consuming thread; closing the generator stops the producer.
        """
        if extras is not None:
            for e in extras:
                if len(e) != len(triples):
                    raise ValueError(f"extras rows ({len(e)}) must match triples "
                                     f"({len(triples)})")
        tcfg = self.config.train
        source = _BatchSource(
            triples, batch_size, seed, epochs, extras, self.variant.image_size,
            self.variant.context_length, tcfg.image_feed == "device",
            int(self.config.image_preprocess_bucket),
            int(tcfg.feed_workers) or min(8, os.cpu_count() or 1),
            int(tcfg.feed_cache_mb) * 2**20, self.config.text_buckets,
            self._decoded_rows(batch_size))
        feed = _ProcessFeed(source, prefetch)
        try:
            while True:
                item = feed.get()
                if item is None:
                    return
                if isinstance(item, tuple) and len(item) == 2 and item[0] == "__feed_error__":
                    raise RuntimeError("training feed producer failed") from item[1]
                yield item
        finally:
            feed.close()

    def _decoded_rows(self, batch_size: int) -> Optional[np.ndarray]:
        """On a mesh across processes, the positions of a global batch that
        this process's data rows run (``GRAD_ACCUM_STEPS`` microbatches in
        turn, each split over the data axis): the only images it decodes.
        None (every row) elsewhere, or where the batch does not split (the
        step raises then)."""
        mesh = self.mesh
        if mesh is None or not mesh.distributed:
            return None
        a, d = max(1, int(self.config.train.grad_accum_steps)), mesh.shape["data"]
        if batch_size % (a * d):
            return None
        micro, rows = batch_size // a, batch_size // (a * d)
        keep = np.zeros(batch_size, bool)
        for s in range(a):
            for i in mesh.local_rows:
                keep[s * micro + i * rows: s * micro + (i + 1) * rows] = True
        return keep

    def _row_sizes(self, hws: np.ndarray, decoded: np.ndarray) -> np.ndarray:
        """Across processes, every row's (h, w) as the process that decodes
        it has it (a file that fails to decode keeps the full bucket there,
        as in one process), so that ``sample_crop_boxes`` draws alike on
        every process: this process's rows (``decoded``) and zeros elsewhere,
        summed over the processes, one ``(B, 2)`` int32 all-reduce."""
        from tpualign_torch.parallel.multihost import process_sum

        own = torch.from_numpy(np.where(decoded[:, None], hws, 0).astype(np.int32))
        return process_sum(self.mesh, [own])[0].numpy()

    # -- distillation ----------------------------------------------------------

    def set_teacher(self, model: CLIP, params=None) -> None:
        """Install a distillation teacher: a port CLIP (any variant) and
        its JAX-layout tree (None = the module's own weights). The config
        path (``DISTILL_CHECKPOINT``/``DISTILL_MODEL``) builds one itself."""
        self._teacher = (model, params)

    def _teacher_from_config(self):
        if getattr(self, "_teacher", None) is not None:
            return self._teacher
        tc = self.config.train
        if not tc.distill_checkpoint:
            return None
        mcfg = replace(self.config.model,
                       model_name=tc.distill_model or self.config.model.model_name,
                       checkpoint_path=tc.distill_checkpoint)
        log.info("distillation teacher: %s from %s", mcfg.model_name, tc.distill_checkpoint)
        self._teacher = (build_clip(mcfg, self.device), load_checkpoint_params(mcfg))
        return self._teacher

    def _teacher_bank(self, triples, batch_size: int = 64,
                      ) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
        """Per-triple teacher embeddings, computed once before the loop
        (unique images and texts embed once, then scatter to their
        triples). Returns ``(t_img (N, Dt), t_txt (N, Dt), t_scale ())``."""
        from PIL import Image

        teacher_model, teacher_params = self._teacher_from_config()
        teacher_model = teacher_model.to(self.device)
        if teacher_params is not None:
            from_jax_params(teacher_model, teacher_params)
        params = model_params(teacher_model)
        tv = teacher_model.variant
        tok = (self.tokenizer if tv.context_length == self.variant.context_length
               else ClipTokenizer(context_length=tv.context_length))
        paths = sorted({t[0] for t in triples})
        texts = sorted({t[1] for t in triples})
        path_pos = {p: i for i, p in enumerate(paths)}
        text_pos = {t: i for i, t in enumerate(texts)}
        imgs = np.zeros((len(paths), tv.image_size, tv.image_size, 3), np.float32)
        for i, p in enumerate(paths):
            try:
                with Image.open(p) as im:
                    imgs[i] = preprocess_host(im, tv.image_size)
            except Exception:
                pass  # zero image: the teacher scores it as the student sees it
        tokens = np.asarray(tok(texts))
        uimg = self._embed(teacher_model, params, imgs, None, batch_size)
        utxt = self._embed(teacher_model, params, None, tokens, batch_size)
        t_img = uimg[[path_pos[t[0]] for t in triples]]
        t_txt = utxt[[text_pos[t[1]] for t in triples]]
        scale = float(np.exp(params["logit_scale"].float().cpu().numpy()))
        t_scale = np.asarray(min(scale, 100.0), np.float32)
        log.info("teacher bank: %d images + %d texts embedded (dim %d)",
                 len(paths), len(texts), uimg.shape[1])
        return t_img, t_txt, t_scale

    @torch.no_grad()
    def _embed(self, model: CLIP, params, images: Optional[np.ndarray],
               tokens: Optional[np.ndarray], batch_size: int) -> np.ndarray:
        """Unit-norm embeddings in batches; ``params`` a parameter dict, or
        one ``RowTowers`` for each of this process's data rows of the mesh
        (each batch's rows split over every data row, the results gathered
        in order: across processes each embeds its rows' parts, and the
        parts are all-gathered)."""
        data = images if images is not None else tokens
        out = []
        for s0 in range(0, len(data), batch_size):
            chunk = torch.from_numpy(np.ascontiguousarray(data[s0: s0 + batch_size]))
            if isinstance(params, list):
                parts = torch.tensor_split(chunk, self.mesh.shape["data"])
                embs = {i: (towers.encode_image(parts[i].to(towers.device), normalize=True)
                            if images is not None
                            else towers.encode_text(parts[i].to(towers.device), normalize=True))
                        .float().to(self.device)
                        for i, towers in zip(self.mesh.local_rows, params) if len(parts[i])}
                if self.mesh.distributed:
                    embs = self._gather_rows(embs, [len(p) for p in parts],
                                             model.variant.embed_dim)
                emb = torch.cat([embs[i] for i in range(len(parts)) if len(parts[i])])
            else:
                chunk = chunk.to(self.device)
                emb = (_encode_with(model, params, images=chunk) if images is not None
                       else _encode_with(model, params, tokens=chunk))
            out.append(emb.float().cpu().numpy())
        if not out:
            return np.zeros((0, model.variant.embed_dim), np.float32)
        return np.concatenate(out)

    def _gather_rows(self, embs: dict, sizes: List[int], dim: int) -> dict:
        """Every data row's embeddings (``sizes[i]`` rows of ``dim`` for row
        i) from this process's ``embs`` (row -> tensor): one all-gather over
        the processes, each process's rows padded to the largest part."""
        from tpualign_torch.parallel.multihost import process_gather

        mesh, width = self.mesh, max(sizes)
        buf = torch.zeros((len(mesh.local_rows), width, dim), device=self.device)
        for k, i in enumerate(mesh.local_rows):
            if i in embs:
                buf[k, :sizes[i]] = embs[i]
        got = process_gather(mesh, buf)
        ranks = sorted(set(mesh.processes))
        out = {}
        for p, rows in zip(ranks, got):
            for k, i in enumerate(r for r in range(len(sizes)) if mesh.processes[r] == p):
                out[i] = rows[k, :sizes[i]]
        return out

    # -- held-out evaluation ---------------------------------------------------

    def _prepare_heldout(self, triples, batch_size: int = 64):
        """Decode, preprocess and tokenize a held-out set once (keyed on
        the triples' ids); every evaluation over it reuses the arrays."""
        from PIL import Image

        key = (tuple(id(t) for t in triples), batch_size)
        cached = getattr(self, "_heldout_prepared", None)
        if cached is not None and cached[0] == key:
            return cached[1]
        size = self.variant.image_size
        texts = sorted({t[1] for t in triples})
        text_pos = {t: i for i, t in enumerate(texts)}
        tokens = np.asarray(self.tokenizer(texts))
        imgs = np.zeros((len(triples), size, size, 3), np.float32)
        gt = np.zeros(len(triples), np.int64)
        for i, (path, text, _w) in enumerate(triples):
            gt[i] = text_pos[text]
            try:
                with Image.open(path) as im:
                    imgs[i] = preprocess_host(im, size)
            except Exception:
                pass  # zero image, counted like any other query
        prepared = (imgs, tokens, gt, len(triples), len(texts))
        self._heldout_prepared = (key, prepared)
        return prepared

    def evaluate_heldout(self, triples, k=(1, 5), batch_size: int = 64) -> dict:
        """Retrieval metrics of the current export params over held-out
        ``(image_path, text, weight)`` triples: each image queries the
        distinct held-out texts, its own text the ground truth. Returns
        ``{"top1": ..., "top{k}": ..., "mrr": ..., "pairs": N}``; the ranks
        are taken on the host (ties: ascending index). Across processes
        every process calls it alike (the export params are gathered), each
        embeds its data rows' part of the set, and the parts are gathered,
        so all report the same."""
        params = self.export_params
        imgs, tokens, gt, _n_pairs, _n_texts = self._prepare_heldout(triples, batch_size)
        if self.mesh is not None:
            sharded = shard_params(params, self.mesh)
            del params
            params = [RowTowers(self.model, row_params(sharded, i))
                      for i in self.mesh.local_rows]
        ie = self._embed(self.model, params, imgs, None, batch_size)
        te = self._embed(self.model, params, None, tokens, batch_size)
        sims = ie @ te.T  # (P, T)
        order = np.argsort(-sims, axis=1, kind="stable")
        ranks = np.argmax(order == gt[:, None], axis=1) + 1
        out = {"pairs": len(triples), "mrr": float(np.mean(1.0 / ranks))}
        for kk in k:
            out[f"top{kk}"] = float(np.mean(ranks <= kk))
        return out

    # -- loop -----------------------------------------------------------------

    def _to_device(self, x, dtype=None) -> torch.Tensor:
        t = torch.from_numpy(np.ascontiguousarray(x))
        if self._host_batches:
            return t if dtype is None else t.to(dtype)
        return t.to(self.device, dtype=dtype, non_blocking=True)

    def train(self, schema: str = "clip_combined", steps: int = 100,
              batch_size: Optional[int] = None, ckpt_dir: Optional[str] = None,
              ckpt_every: int = 100, log_every: int = 10, eval_every: int = 0,
              eval_fraction: float = 0.0, metrics_file: Optional[str] = None) -> dict:
        """Run ``steps`` optimisation steps; returns the final metrics.

        ``eval_fraction`` > 0 holds out a deterministic fraction of the
        pairs and evaluates them every ``eval_every`` steps (and at the
        start and end; the trajectory under ``"heldout"``).
        ``metrics_file`` gets one JSON line per ``log_every`` interval, per
        held-out evaluation and at the end. With ``ckpt_dir`` the state
        resumes from its newest save and is saved every ``ckpt_every``
        steps and at the end. Across processes every process calls it with
        the same arguments; process 0 logs and writes ``metrics_file``.
        """
        batch_size = batch_size or self.config.train.batch_size
        triples = build_pair_dataset(self.store, schema, self.config.data.images_dir)
        if not triples:
            raise ValueError(f"no trainable pairs in schema {schema} (need image files)")
        heldout: list = []
        heldout_history: list = []
        if (eval_fraction > 0.0) != (eval_every > 0):
            raise ValueError(
                "--eval-fraction and --eval-every must be set together "
                f"(got eval_fraction={eval_fraction}, eval_every={eval_every})")
        if eval_fraction > 0.0:
            if not 0.0 < eval_fraction < 1.0:
                raise ValueError(f"eval_fraction must be in (0, 1), got {eval_fraction}")
            heldout, triples = heldout_split(triples, self.config.seed, eval_fraction)
            log.info("held out %d/%d pairs for validation",
                     len(heldout), len(heldout) + len(triples))
        if batch_size > len(triples):
            batch_size = max(2, len(triples))
        log.info("training on %d pairs from %s (batch=%d, steps=%d)",
                 len(triples), schema, batch_size, steps)

        if ckpt_dir:
            from tpualign_torch.train.checkpoint import restore_checkpoint

            restored = restore_checkpoint(ckpt_dir, self.state)
            if restored is not None:
                self.state = restored

        meter = ThroughputMeter()
        metrics: dict = {}
        t_scale = None
        extras = None
        if self.config.train.distill_checkpoint or getattr(self, "_teacher", None) is not None:
            t_img, t_txt, t_scale = self._teacher_bank(triples)
            t_scale = self._to_device(t_scale)
            extras = (t_img, t_txt)
        mask_rng = np.random.default_rng(self.config.seed + 1)
        start_step = int(self.state.step)
        if metrics_file:
            Path(metrics_file).parent.mkdir(parents=True, exist_ok=True)

        def emit(record: dict) -> None:
            # open-append-close per record: a crash never loses flushed lines
            if metrics_file and self._primary:
                with open(metrics_file, "a", encoding="utf-8") as fh:
                    fh.write(json.dumps(record) + "\n")

        def run_eval(step_i):
            m = self.evaluate_heldout(heldout)
            heldout_history.append({"step": step_i, **m})
            if self._primary:
                log.info("heldout@%d: top1=%.3f mrr=%.3f (%d pairs)",
                         step_i, m.get("top1", 0.0), m["mrr"], m["pairs"])
            emit({"kind": "heldout", "step": step_i, **m})

        augment = self.config.train.augment
        if augment not in ("none", "rrc"):
            raise ValueError(f"TRAIN_AUGMENT must be none|rrc, got {augment}")
        if augment == "rrc" and self.config.train.image_feed != "device":
            raise ValueError("TRAIN_AUGMENT=rrc needs TRAIN_IMAGE_FEED=device (crops "
                             "fold into the on-device resize weights)")
        if heldout and eval_every > 0:
            run_eval(start_step)
        t0 = time.perf_counter()
        aug_rng = np.random.default_rng(self.config.seed + 2)
        decoded = self._decoded_rows(batch_size)
        it = self.batches(triples, batch_size, seed=self.config.seed, extras=extras)
        try:
            for step_i in range(start_step, steps):
                imgs, tokens, weights, *extra = next(it)
                if isinstance(imgs, tuple):  # device feed: (u8, hw)
                    if decoded is not None and augment == "rrc":
                        imgs = (imgs[0], self._row_sizes(imgs[1], decoded))
                    if augment == "rrc":
                        boxes, flips = sample_crop_boxes(aug_rng, imgs[1])
                        imgs = imgs + (boxes, flips)
                    imgs = tuple(self._to_device(x) for x in imgs)
                else:
                    imgs = self._to_device(imgs)
                teacher = None
                if extra:
                    teacher = (self._to_device(extra[0]), self._to_device(extra[1]), t_scale)
                patch_idx = sample_patch_indices(
                    mask_rng, batch_size,
                    (self.variant.image_size // self.variant.patch_size) ** 2,
                    self.config.train.patch_mask_ratio)
                with meter.measure("train_pairs", batch_size):
                    self.state, metrics = self._step(
                        self.state, imgs, self._to_device(tokens, torch.int64),
                        self._to_device(weights),
                        None if patch_idx is None else self._to_device(patch_idx, torch.int64),
                        teacher)
                if (step_i + 1) % log_every == 0 and self._primary:
                    kd = ("" if "distill_kl" not in metrics
                          else " distill_kl=%.4f" % float(metrics["distill_kl"]))
                    log.info("step %d: loss=%.4f acc_i2t=%.3f grad_norm=%.3f%s",
                             step_i + 1, float(metrics["loss"]), float(metrics["acc_i2t"]),
                             float(metrics["grad_norm"]), kd)
                    emit({"kind": "train", "step": step_i + 1,
                          **{k: float(v) for k, v in metrics.items()}})
                if (heldout and eval_every > 0 and (step_i + 1) % eval_every == 0
                        and step_i + 1 != steps):
                    run_eval(step_i + 1)
                if ckpt_dir and (step_i + 1) % ckpt_every == 0:
                    from tpualign_torch.train.checkpoint import save_checkpoint

                    save_checkpoint(ckpt_dir, self.state)
        finally:
            it.close()
        if ckpt_dir:
            from tpualign_torch.train.checkpoint import save_checkpoint

            save_checkpoint(ckpt_dir, self.state)
        if self._primary:
            meter.report()
        out = {k: float(v) for k, v in metrics.items()}
        out["wall_seconds"] = time.perf_counter() - t0
        if heldout and eval_every > 0:
            run_eval(steps)
            out["heldout"] = heldout_history
        # always a final record: runs shorter than log_every log nothing else
        emit({"kind": "final", "step": steps,
              **{k: v for k, v in out.items() if isinstance(v, (int, float))}})
        return out


def heldout_split(triples: list, seed: int, fraction: float) -> Tuple[list, list]:
    """``Trainer.train``'s held-out split of ``triples``: ``fraction`` of
    them (rounded, at least one) by the ``seed + 3`` stream, independent of
    the shuffle. Returns ``(held out, trained on)``, each in the triples'
    order."""
    ho_rng = np.random.default_rng(seed + 3)
    n_ho = max(1, int(round(len(triples) * fraction)))
    if n_ho >= len(triples):
        raise ValueError(f"eval_fraction={fraction} leaves no training "
                         f"pairs ({len(triples)} total)")
    ho_set = set(int(i) for i in ho_rng.permutation(len(triples))[:n_ho])
    return ([t for i, t in enumerate(triples) if i in ho_set],
            [t for i, t in enumerate(triples) if i not in ho_set])


class _BatchSource:
    """The feed's batches for one seed, in tpualign's order and content;
    picklable, so that a worker process can build them. ``run(put,
    stop)`` produces every batch (then None) through ``put``, which
    returns False when the consumer has gone."""

    def __init__(self, triples, batch_size, seed, epochs, extras, image_size,
                 context_length, device_feed, bucket, workers, cache_budget, text_buckets,
                 decoded=None):
        self.triples, self.batch_size, self.seed, self.epochs = triples, batch_size, seed, epochs
        self.extras, self.size, self.ctx = extras, image_size, context_length
        self.device_feed, self.bucket, self.workers = device_feed, bucket, workers
        self.cache_budget, self.text_buckets = cache_budget, text_buckets
        # the batch positions whose images are decoded (None: all); the
        # others stay zero, their texts and weights kept, and under the
        # device feed a full bucket's size (under rrc, Trainer.train takes
        # every row's from the process that decodes it)
        self.decoded = decoded

    def run(self, put, stop) -> None:
        from PIL import Image

        triples, batch_size, size, bucket = self.triples, self.batch_size, self.size, self.bucket
        device_feed = self.device_feed
        item_bytes = bucket * bucket * 3 + 8 if device_feed else size * size * 3 * 4
        tokenizer = ClipTokenizer(context_length=self.ctx)
        buckets = self.text_buckets
        cache: dict = {}

        def load_one(j: int, decode: bool = True):
            path, text, w = triples[j]
            if not decode:
                return None, text, w
            arr = cache.get(path)
            if arr is None:
                try:
                    with Image.open(path) as im:
                        if device_feed:
                            decoded = np.asarray(im.convert("RGB"), np.uint8)
                            padded, hw = pad_to_bucket(decoded, bucket)
                            arr = (padded, np.asarray(hw, np.int32))
                        else:
                            arr = preprocess_host(im, size)
                    # the budget check races across pool threads by at most
                    # workers - 1 items: bounded and correctness-neutral
                    if (len(cache) + 1) * item_bytes <= self.cache_budget:
                        cache[path] = arr
                except Exception:
                    arr = None  # zero image; the weight still applies
            return arr, text, w

        rng = np.random.default_rng(self.seed)
        epoch = 0
        with ThreadPoolExecutor(max_workers=self.workers) as pool:
            while not stop.is_set() and (self.epochs is None or epoch < self.epochs):
                order = rng.permutation(len(triples))
                for start in range(0, len(order) - batch_size + 1, batch_size):
                    if stop.is_set():
                        return
                    sel = order[start: start + batch_size]
                    if device_feed:
                        imgs = np.zeros((batch_size, bucket, bucket, 3), np.uint8)
                        # a failed decode keeps a full-bucket "size" so the
                        # device resize maps zeros to zeros
                        hws = np.full((batch_size, 2), bucket, np.int32)
                    else:
                        imgs = np.zeros((batch_size, size, size, 3), np.float32)
                        hws = None
                    texts = [""] * batch_size
                    weights = np.zeros(batch_size, np.float32)
                    loads = (pool.map(load_one, sel) if self.decoded is None
                             else pool.map(load_one, sel, self.decoded))
                    for i, (arr, text, w) in enumerate(loads):
                        if arr is not None:
                            if device_feed:
                                imgs[i], hws[i] = arr
                            else:
                                imgs[i] = arr
                        texts[i] = text
                        weights[i] = w
                    tokens = tokenizer(texts)
                    if buckets:
                        tokens = truncate_to_bucket(
                            tokens, tuple(sorted({min(int(b), self.ctx) for b in buckets}
                                                 | {self.ctx})))
                    item = ((imgs, hws) if device_feed else imgs, tokens, weights)
                    if self.extras is not None:
                        item = item + tuple(e[sel] for e in self.extras)
                    if not put(item):
                        return
                epoch += 1
        put(None)


def _to_shared(item):
    """numpy arrays -> CPU tensors, which torch.multiprocessing's queue
    hands over in shared memory (a pipe would copy every batch through
    64 KiB writes at the consumer's pace)."""
    if isinstance(item, np.ndarray):
        return torch.from_numpy(np.ascontiguousarray(item))
    if isinstance(item, tuple):
        return tuple(_to_shared(x) for x in item)
    return item


def _from_shared(item):
    if torch.is_tensor(item):
        return item.numpy()
    if isinstance(item, tuple):
        return tuple(_from_shared(x) for x in item)
    return item


def _feed_worker(source: _BatchSource, out, stop) -> None:
    """The worker process: run the source, every batch into ``out``."""
    def put(item) -> bool:
        item = _to_shared(item)
        while not stop.is_set():
            try:
                out.put(item, timeout=0.2)
                return True
            except queue.Full:
                continue
        return False

    try:
        source.run(put, stop)
    except BaseException as exc:  # noqa: BLE001 — re-raised by the consumer
        import traceback

        put(("__feed_error__", RuntimeError("".join(traceback.format_exception(exc)))))
    # the consumer maps queued batches' shared memory through this process's
    # file descriptors: stay until it is done
    stop.wait()


class _ProcessFeed:
    """The source in a spawned worker process (torch.multiprocessing: the
    batches' arrays come back as shared-memory tensors)."""

    def __init__(self, source: _BatchSource, prefetch: int):
        import torch.multiprocessing as mp

        ctx = mp.get_context("spawn")
        self.queue = ctx.Queue(maxsize=max(1, prefetch))
        self.stop = ctx.Event()
        self.proc = ctx.Process(target=_feed_worker, args=(source, self.queue, self.stop),
                                daemon=True)
        self.proc.start()

    def get(self):
        while True:
            try:
                return _from_shared(self.queue.get(timeout=1.0))
            except queue.Empty:
                if not self.proc.is_alive():
                    return ("__feed_error__", RuntimeError(
                        f"the feed worker process exited with {self.proc.exitcode}"))

    def close(self) -> None:
        self.stop.set()
        deadline = time.monotonic() + 10.0
        while self.proc.is_alive() and time.monotonic() < deadline:
            try:  # drain, so that a worker blocked on a full queue sees the stop
                self.queue.get(timeout=0.1)
            except Exception:  # noqa: BLE001 — empty, or a batch of a worker already gone
                pass
        if self.proc.is_alive():
            self.proc.terminate()
        self.proc.join(timeout=5.0)
