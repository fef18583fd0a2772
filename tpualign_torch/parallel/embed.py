"""Batched embedding engine, on one device or data-parallel over a mesh
(the port's ``tpualign.parallel.embed``).

Images are decoded by a thread pool, in a background thread that keeps
batches ahead of the device. The image feed is ``preprocess="host"`` (PIL
bicubic per image on the host, fp32 batches go up) or ``"device"`` (the
host only decodes and pads into uint8 buckets, which go up from a pinned
buffer; resize, crop and normalisation run on the device through
``ops.preprocess.preprocess_device``, whose bicubic arm ends in K5). Text
is tokenized and grouped into length buckets (16/32/77 by default), exact
under the causal mask. Items that cannot be embedded (no file, a missing
or corrupt file, empty text) get deterministic unit-norm placeholders
derived from their ids. PyTorch runs eagerly, so the last batch is not
padded.

On a mesh (``parallel/mesh.py``) the batch is rounded to a multiple of the
data axis as tpualign rounds it, and each batch's rows are split over the
data rows: each slice runs the towers on its row (K1, and K5 in the device
feed on the row's first device), the rows launched in turn without a
synchronize, and the outputs are gathered in order on the first device.
With a model axis of 1 the towers are replicated on each data device (one
replica a distinct device; int8 towers too); above 1 they are laid out by
``parallel/sharding.py``'s TP specs and each row runs them tensor parallel
over its devices (``RowTowers``: K1 on each card's heads; the int8 towers
bit-equal to one device's, their maxima taken over the row's cards). The
host decode pool stays one pool. A mesh
across processes raises ``NotImplementedError``: tpualign's embedding
jits refuse numpy inputs with shardings across processes too (ROADMAP
settled difference 24).
"""

from __future__ import annotations

import hashlib
import queue
import threading
from pathlib import Path
from typing import Callable, List, Optional, Sequence

import numpy as np
import torch

from tpualign_torch.config import ModelConfig
from tpualign_torch.models.clip import CLIP, build_clip, init_clip_params
from tpualign_torch.models.convert import from_jax_params
from tpualign_torch.models.loader import load_checkpoint_params
from tpualign_torch.ops.preprocess import pad_to_bucket, preprocess_device, preprocess_host
from tpualign_torch.parallel.mesh import one_process, shard_devices
from tpualign_torch.parallel.sharding import RowTowers, row_params, shard_params
from tpualign_torch.tokenizer import ClipTokenizer
from tpualign_torch.utils.device import resolve_device
from tpualign_torch.utils.logging import get_logger

log = get_logger("parallel.embed")

__all__ = ["EmbedEngine", "placeholder_embedding", "truncate_to_bucket"]


def truncate_to_bucket(tokens: np.ndarray, buckets: Sequence[int]) -> np.ndarray:
    """Truncate a zero-padded token batch to the smallest bucket holding
    every row's EOT (EOT has the largest id, so length = argmax + 1)."""
    tokens = np.asarray(tokens)
    if tokens.shape[0] == 0:
        return tokens
    max_len = int(tokens.argmax(axis=1).max()) + 1
    for b in sorted(int(b) for b in buckets):
        if b >= max_len:
            return tokens[:, :b]
    return tokens


def placeholder_embedding(item_id: str, dim: int) -> np.ndarray:
    """Deterministic unit-norm placeholder derived from the item id."""
    seed = int.from_bytes(hashlib.sha256(item_id.encode()).digest()[:8], "little")
    v = np.random.default_rng(seed).random(dim, dtype=np.float32)
    return v / np.linalg.norm(v)


class EmbedEngine:
    """CLIP embedding engine on one device, or data-parallel over ``mesh``'s
    data axis (see the module notes; a mesh names the devices, and
    ``device`` is then not used).

    ``params``: the JAX package's parameter tree as nested dicts of numpy
    arrays (see ``tpualign_torch.models.convert``); None loads
    ``model_config.checkpoint_path`` when it is set (an OpenCLIP or
    HuggingFace file, ``models.loader``; a file that fails to load raises),
    else draws seeded random weights (``init_clip_params``). ``preprocess`` is the image
    feed, ``"host"`` or ``"device"``; ``preprocess_bucket`` the edge of the
    device feed's uint8 buffers (larger images are shrunk on the host).
    ``device`` defaults to CUDA and raises when it is absent; pass
    ``device="cpu"`` for the plain path.
    """

    def __init__(
        self,
        model_config: ModelConfig,
        batch_size: int = 256,
        params=None,
        tokenizer: Optional[ClipTokenizer] = None,
        seed: int = 0,
        decode_workers: int = 8,
        text_buckets: Optional[Sequence[int]] = (16, 32, 77),
        preprocess: str = "host",
        preprocess_bucket: int = 256,
        device: str | torch.device = "cuda",
        mesh=None,
    ):
        if preprocess not in ("host", "device"):
            raise ValueError(f"preprocess must be host|device, got {preprocess!r}")
        devices = shard_devices(mesh)
        one_process(mesh, "EmbedEngine(mesh=)")
        self.device = resolve_device(device) if devices is None else devices[0]
        self.mesh = mesh
        self._devices = devices or [self.device]
        self.decode_workers = decode_workers
        self.preprocess = preprocess
        self.preprocess_bucket = int(preprocess_bucket)
        self.variant = model_config.variant
        # the full context is always an implicit last bucket
        if text_buckets:
            ctx = self.variant.context_length
            self.text_buckets = tuple(sorted({min(int(b), ctx) for b in text_buckets} | {ctx}))
        else:
            self.text_buckets = None
        self.tokenizer = tokenizer or ClipTokenizer(context_length=self.variant.context_length)
        # a batch splits evenly over the data axis
        dp = len(self._devices)
        self.batch_size = max(dp, int(batch_size) // dp * dp)

        if params is None and model_config.checkpoint_path:
            params = load_checkpoint_params(model_config)
        self.model: CLIP = build_clip(model_config, self.device)
        if params is None:
            log.warning("No checkpoint configured: using seeded random weights "
                        "(deterministic placeholder-tower mode)")
            init_clip_params(self.model, seed=seed)
        else:
            from_jax_params(self.model, params)
        self.model.eval().requires_grad_(False)
        if mesh is not None and mesh.shape["model"] > 1:
            # each data row runs the towers tensor parallel over its devices
            sharded = shard_params(dict(self.model.named_parameters()), mesh)
            self._towers = [RowTowers(self.model, row_params(sharded, i))
                            for i in range(len(self._devices))]
            return
        # one replica of the towers on each distinct data device
        replicas = {self.device: self.model}
        for dev in self._devices:
            if dev not in replicas:
                replica = build_clip(model_config, dev)
                replica.load_state_dict(self.model.state_dict())
                replicas[dev] = replica.eval().requires_grad_(False)
        self._towers = [replicas[dev] for dev in self._devices]

    # -- batching -------------------------------------------------------------

    def _data_parallel(self, fn: Callable[..., torch.Tensor], *inputs: torch.Tensor,
                       non_blocking: bool = False) -> torch.Tensor:
        """``fn(model, *inputs)`` with the inputs on the engine's device; on
        a mesh, the inputs' rows split evenly over the data rows, each slice
        through ``fn`` with that row's towers on its first device (launched
        in turn, no synchronize between), the outputs gathered in order on
        the first device."""
        n_dev = len(self._devices)
        outs = []
        for s, dev in enumerate(self._devices):
            rows = [torch.tensor_split(t, n_dev)[s] for t in inputs]
            if len(rows[0]):
                out = fn(self._towers[s], *(t.to(dev, non_blocking=non_blocking)
                                            for t in rows))
                outs.append(out.to(self.device, non_blocking=True))
        return outs[0] if len(outs) == 1 else torch.cat(outs)

    def _run_batched(self, fn: Callable[[CLIP, torch.Tensor], torch.Tensor],
                     data: np.ndarray) -> np.ndarray:
        n = len(data)
        if n == 0:
            return np.zeros((0, self.variant.embed_dim), np.float32)
        outs = []
        with torch.inference_mode():
            for start in range(0, n, self.batch_size):
                batch = torch.from_numpy(np.ascontiguousarray(data[start:start + self.batch_size]))
                outs.append(self._data_parallel(fn, batch))
            # device -> host once at the end
            return torch.cat(outs).float().cpu().numpy()

    @staticmethod
    def _encode_text(model: CLIP, tokens: torch.Tensor) -> torch.Tensor:
        return model.encode_text(tokens, normalize=True)

    @staticmethod
    def _encode_image(model: CLIP, images: torch.Tensor) -> torch.Tensor:
        return model.encode_image(images, normalize=True)

    # -- public API -------------------------------------------------------------

    def encode_text_batch(self, texts: Sequence[str]) -> np.ndarray:
        """Tokenize + encode texts -> (N, D) unit-norm float32.

        With ``text_buckets`` set, rows are grouped by token length into
        the smallest bucket that holds them (EOT inclusive) and each group
        runs at that sequence length, which is exact under the causal mask.
        """
        if not len(texts):
            return np.zeros((0, self.variant.embed_dim), np.float32)
        tokens = np.asarray(self.tokenizer(list(texts)))
        if not self.text_buckets or len(self.text_buckets) == 1:
            return self._run_batched(self._encode_text, tokens)
        lengths = np.argmax(tokens, axis=1) + 1
        buckets = np.asarray(self.text_buckets)
        which = np.searchsorted(buckets, lengths)  # smallest bucket >= length
        out = np.empty((len(tokens), self.variant.embed_dim), np.float32)
        for bi in np.unique(which):
            rows = np.flatnonzero(which == bi)
            out[rows] = self._run_batched(self._encode_text, tokens[rows, : int(buckets[bi])])
        return out

    def encode_image_batch(self, images_nhwc: np.ndarray) -> np.ndarray:
        """Preprocessed (N, S, S, 3) float32 -> (N, D) unit-norm float32."""
        return self._run_batched(self._encode_image, np.asarray(images_nhwc, np.float32))

    def _encode_image_u8(self, images_u8: Sequence[np.ndarray], hws: np.ndarray,
                         pinned: Optional[torch.Tensor]) -> np.ndarray:
        """One device-feed batch: n (bucket, bucket, 3) uint8 buffers and
        their true (h, w) up (stacked into the pinned buffer on CUDA), then
        preprocess and the image tower on the device (on a mesh, each data
        device its slice of the rows)."""
        size = self.variant.image_size

        def encode(model: CLIP, u8: torch.Tensor, hw: torch.Tensor) -> torch.Tensor:
            return model.encode_image(preprocess_device(u8, hw, size), normalize=True)

        with torch.inference_mode():
            if pinned is not None:
                host = pinned[:len(images_u8)]
                np.stack(images_u8, out=host.numpy())
            else:
                host = torch.from_numpy(np.stack(images_u8))
            return self._data_parallel(encode, host, torch.from_numpy(hws),
                                       non_blocking=pinned is not None).float().cpu().numpy()

    def embed_image_records(
        self,
        records: Sequence[dict],
        images_dir: str | Path,
        prefetch: int = 2,
    ) -> np.ndarray:
        """Embed image records: decode (and, with the host feed,
        preprocess) on the host in a background thread, encode on the
        device. Records without a decodable file get deterministic
        placeholders."""
        images_dir = Path(images_dir)
        dim = self.variant.embed_dim
        size = self.variant.image_size
        out = np.zeros((len(records), dim), np.float32)

        decode_idx: List[int] = []
        for i, rec in enumerate(records):
            fname = rec.get("filename")
            if fname and (images_dir / fname).exists():
                decode_idx.append(i)
            else:
                out[i] = placeholder_embedding(rec["image_id"], dim)
        if not decode_idx:
            return out

        bs = self.batch_size
        batches: "queue.Queue" = queue.Queue(maxsize=prefetch)
        failure: List[BaseException] = []
        device_mode = self.preprocess == "device"
        bucket = self.preprocess_bucket

        def decode_one(i: int) -> Optional[tuple]:
            from PIL import Image

            rec = records[i]
            try:
                with Image.open(images_dir / rec["filename"]) as im:
                    if device_mode:
                        padded, hw = pad_to_bucket(np.asarray(im.convert("RGB"), np.uint8),
                                                   bucket)
                        return i, padded, hw
                    return i, preprocess_host(im, size)
            except Exception as e:  # any undecodable file: skip and continue
                log.warning("decode failed for %s: %r", rec.get("filename"), e)
                out[i] = placeholder_embedding(rec["image_id"], dim)
                return None

        def producer():
            from concurrent.futures import ThreadPoolExecutor

            buf: List[tuple] = []
            try:
                with ThreadPoolExecutor(max_workers=self.decode_workers) as pool:
                    for item in pool.map(decode_one, decode_idx, chunksize=8):
                        if item is None:
                            continue
                        buf.append(item)
                        if len(buf) == bs:
                            batches.put(buf)
                            buf = []
                if buf:
                    batches.put(buf)
            except Exception as e:  # handed to the consumer, re-raised there
                failure.append(e)
            finally:
                batches.put(None)

        # the device feed's uint8 batches go up from one pinned buffer:
        # each batch's embeddings reach the host before the next is written
        pinned = None
        if device_mode and self.device.type == "cuda":
            pinned = torch.empty((bs, bucket, bucket, 3), dtype=torch.uint8, pin_memory=True)
        thread = threading.Thread(target=producer, daemon=True)
        thread.start()
        try:
            while True:
                item = batches.get()
                if item is None:
                    break
                idxs = [it[0] for it in item]
                if device_mode:
                    hws = np.asarray([it[2] for it in item], np.int32)
                    out[idxs] = self._encode_image_u8([it[1] for it in item], hws, pinned)
                else:
                    out[idxs] = self._run_batched(self._encode_image,
                                                  np.stack([it[1] for it in item]))
        finally:
            # drain so a producer blocked on a full queue can finish
            while thread.is_alive():
                try:
                    batches.get(timeout=0.1)
                except queue.Empty:
                    pass
            thread.join()
        if failure:
            raise failure[0]
        return out

    def embed_chunk_records(self, records: Sequence[dict]) -> np.ndarray:
        """Embed text chunks; records without text get placeholders."""
        texts = []
        fallback_idx = []
        for i, rec in enumerate(records):
            text = rec.get("text")
            if isinstance(text, str) and text:
                texts.append(text)
            else:
                texts.append("")
                fallback_idx.append(i)
        embs = self.encode_text_batch(texts)
        for i in fallback_idx:
            embs[i] = placeholder_embedding(records[i]["chunk_id"], embs.shape[1])
        return embs
