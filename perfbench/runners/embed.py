"""The ``embed`` runner: a corpus slice through ``EmbedEngine``'s device path.

Set-up makes ``groups`` groups, each of ``images_per_group`` uint8 image
buckets with their true sizes and ``chunks_per_image`` token rows an
image, with the same count of rows in every length bucket for every seed.
A group is one image call, ``EmbedEngine._encode_image_u8`` (the engine's
pinned buffer, upload, ``preprocess_device`` with K5, the image tower,
the host copy), then one text call a length bucket,
``EmbedEngine._run_batched(EmbedEngine._encode_text, ...)`` at the bucket
``encode_text_batch`` picks from the engine's ``text_buckets``. The window
runs whole groups, cycling over the slice, until ``--seconds`` have
passed. A seeded sample of the calls is kept and checked against the
reference once the window has closed.
"""

from __future__ import annotations

import contextlib
import time
from typing import List

import numpy as np
import torch

from perfbench.runners.common import (
    Reservoir, bucket_counts, free_cuda, image_buckets, load_weights, model_config, token_ids)
from perfbench.e2e import Call
from perfbench.reference import clip as ref_clip
from perfbench.reference import preprocess as ref_pre
from perfbench.weights import make_weights, tower_shapes

__all__ = ["Runner"]


class Runner:
    """``control=True`` runs the program's int8 towers (``CLIP_QUANT=int8``),
    the precision below the configuration's bf16, in its place."""

    def __init__(self, cfg: dict, mix: dict, seed: int, device: torch.device,
                 control: bool = False):
        self.cfg, self.mix, self.seed, self.device = cfg, mix, seed, device
        self.control = control
        self.shapes = tower_shapes(cfg)

    # -- set-up ----------------------------------------------------------------

    def build(self) -> None:
        from tpualign_torch.parallel import embed as embed_mod

        mix, dev = self.mix, self.device
        mc = model_config(self.cfg, "int8" if self.control else "none")
        weights = make_weights(self.cfg, self.seed, dev)

        def seeded(model, seed=0):  # the benchmark's weights, in place of the engine's own
            load_weights(model, weights)
            return model

        own, embed_mod.init_clip_params = embed_mod.init_clip_params, seeded
        try:
            with torch.device(dev):
                self.engine = embed_mod.EmbedEngine(
                    mc, batch_size=mix["batch_size"], text_buckets=mix["text_buckets"],
                    preprocess="device", preprocess_bucket=mix["image_bucket"], device=dev)
        finally:
            embed_mod.init_clip_params = own
        del weights
        free_cuda(dev)

        groups, per = mix["groups"], mix["images_per_group"]
        u8, hw = image_buckets(groups * per, mix["image_bucket"], mix["image_side_range"],
                               self.seed, "images", dev)
        self.images = u8.cpu().numpy()
        self.hws = hw.cpu().numpy()
        del u8, hw
        chunks = per * mix["chunks_per_image"]
        counts = bucket_counts(chunks, mix["text_bucket_shares"])
        ctx = self.shapes["text"]["seq"]
        self.tokens = [token_ids(counts, mix["text_buckets"], mix["text_length_floor"], ctx,
                                 self.seed, f"tokens{g}", dev).cpu().numpy()
                       for g in range(groups)]
        # each group's rows by the bucket encode_text_batch would give them
        buckets = np.asarray(self.engine.text_buckets)
        self.text_calls = []
        for g, tokens in enumerate(self.tokens):
            which = np.searchsorted(buckets, np.argmax(tokens, axis=1) + 1)
            self.text_calls.append([(int(buckets[b]), np.flatnonzero(which == b))
                                    for b in np.unique(which)])
        self.pinned = None
        if dev.type == "cuda":
            b = mix["image_bucket"]
            self.pinned = torch.empty((self.engine.batch_size, b, b, 3), dtype=torch.uint8,
                                      pin_memory=True)
        free_cuda(dev)

    def warmup(self) -> None:
        for g in range(self.mix["warmup_groups"]):
            self._group(g % self.mix["groups"], None, None)

    # -- the window ------------------------------------------------------------

    def _group(self, g: int, calls, span) -> None:
        engine, per = self.engine, self.mix["images_per_group"]
        rows = slice(g * per, (g + 1) * per)
        t_img = self.shapes["vision"]["seq"]
        bs = engine.batch_size
        span = span or (lambda name: contextlib.nullcontext())
        t0 = time.perf_counter()
        with span("image_call"):
            out = engine._encode_image_u8(list(self.images[rows]), self.hws[rows], self.pinned)
        t1 = time.perf_counter()
        if calls is not None:
            calls.append(Call("image_call", t0, t1, per, [("vision", per, t_img)]))
            self.sample.offer("image", (g, None, out))
        for bucket, idx in self.text_calls[g]:
            tokens = self.tokens[g][idx, :bucket]
            t0 = time.perf_counter()
            with span("text_call"):
                out = engine._run_batched(engine._encode_text, tokens)
            t1 = time.perf_counter()
            if calls is not None:
                n = len(idx)
                passes = [("text", min(bs, n - s), bucket) for s in range(0, n, bs)]
                calls.append(Call("text_call", t0, t1, n, passes))
                self.sample.offer(("text", bucket), (g, idx, out))

    def window(self, seconds: float, span=None) -> List[Call]:
        check = self.mix["check"]
        self.sample = Reservoir(lambda stratum: check["image_calls"] if stratum == "image"
                                else check["text_calls_per_bucket"], self.seed, "sample")
        calls: List[Call] = []
        start, g = time.perf_counter(), self.mix["warmup_groups"]
        while True:
            self._group(g % self.mix["groups"], calls, span)
            g += 1
            if time.perf_counter() - start >= seconds:
                break
        return calls

    def release(self) -> None:
        del self.engine, self.pinned
        free_cuda(self.device)

    # -- the check -------------------------------------------------------------

    def check(self) -> dict:
        """Each kept call's rows against the reference, for images and for
        chunks: the largest L2 gap between the program's unit embedding
        and the reference's."""
        dev, cfg = self.device, self.cfg
        weights = make_weights(cfg, self.seed, dev)
        size = self.shapes["vision"]["image_size"]
        per = self.mix["images_per_group"]
        gaps = {"image": [], "text": []}
        block = 64
        with ref_clip.no_tf32(), torch.no_grad():
            for stratum, kept in self.sample.kept.items():
                for g, idx, out in kept:
                    got = torch.from_numpy(out).to(dev)
                    if stratum == "image":
                        for s in range(0, per, block):
                            sel = np.arange(g * per + s, g * per + min(per, s + block))
                            u8 = torch.from_numpy(self.images[sel]).to(dev)
                            pixels = ref_pre.preprocess(u8, self.hws[sel].tolist(), size)
                            want = ref_clip.image_features(weights, cfg, pixels)
                            gaps["image"].append((got[s:s + block] - want).norm(dim=1))
                    else:
                        for s in range(0, len(idx), block):
                            tok = torch.from_numpy(self.tokens[g][idx[s:s + block]]).to(dev)
                            want = ref_clip.text_features(weights, cfg, tok)
                            gaps["text"].append((got[s:s + block] - want).norm(dim=1))
        out = {}
        for name, parts in gaps.items():
            gap = torch.cat(parts).double()
            out[f"{name}_gap_max"] = float(gap.max())
            out[f"{name}_rows_checked"] = int(gap.numel())
        return out

