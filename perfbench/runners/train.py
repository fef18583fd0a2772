"""The ``train`` runner: weak-supervision fine-tuning through ``train_step``.

Set-up builds the model from the benchmark's weights and one train state
(``create_train_state`` with the mix's ``TrainConfig``), then drives that
state through the first ``checked_steps`` steps by the window's own call
and feed, reading what the reference follows: each step's loss, the first
step's gradient as AdamW got it (its first moment over ``1 - b1``) and the
parameters' change after the last checked step. The same state goes on
into the window. There one step, drawn from the seed uniformly over the
window's steps (a reservoir of one), is kept: the state before it, its
loss and the parameters after it; the reference follows that step from
the kept state. Every step gets a new batch made on the card from the
seed and the step's number: uint8 image buckets with their true sizes
(the device feed, ``preprocess_device`` with K5), token ids of the length
mix, weak scores.
"""

from __future__ import annotations

import contextlib
import itertools
import math
import time
from typing import List

import numpy as np
import torch

from perfbench.runners.common import (
    bucket_counts, free_cuda, image_buckets, load_weights, model_config, token_ids)
from perfbench.e2e import Call
from perfbench.reference import clip as ref_clip
from perfbench.reference import preprocess as ref_pre
from perfbench.reference import train as ref_train
from perfbench.weights import generator, make_weights, sub_seed, tower_shapes

__all__ = ["Runner"]

# TrainConfig fields the mix's "train" block sets
_TRAIN_FIELDS = ("loss_type", "learning_rate", "weight_decay", "warmup_steps", "total_steps",
                 "weak_score_temperature", "label_smoothing", "moments_dtype")


class Runner:
    """``control=True`` trains the program's int8 towers
    (``CLIP_QUANT=int8_qat``), the precision below the configuration's
    bf16, in its place."""

    def __init__(self, cfg: dict, mix: dict, seed: int, device: torch.device,
                 control: bool = False):
        self.cfg, self.mix, self.seed, self.device = cfg, mix, seed, device
        self.control = control
        self.shapes = tower_shapes(cfg)
        self.hp = mix["train"]

    def batch(self, step: int):
        """Step ``step``'s batch, made on the card: ``((u8, hw), tokens,
        weak)``."""
        mix, dev, b = self.mix, self.device, self.mix["batch_size"]
        u8, hw = image_buckets(b, mix["image_bucket"], mix["image_side_range"], self.seed,
                               f"batch{step}.images", dev)
        counts = bucket_counts(b, mix["text_bucket_shares"])
        tokens = token_ids(counts, mix["text_buckets"], mix["text_length_floor"],
                           self.shapes["text"]["seq"], self.seed, f"batch{step}.tokens", dev)
        lo, hi = mix["weak_score_range"]
        g = generator(self.seed, f"batch{step}.weak", dev)
        weak = lo + (hi - lo) * torch.rand(b, generator=g, device=dev)
        return (u8, hw), tokens, weak

    # -- set-up ----------------------------------------------------------------

    def build(self) -> None:
        from tpualign_torch.config import TrainConfig
        from tpualign_torch.models.clip import build_clip
        from tpualign_torch.train.step import create_train_state, model_params

        dev = self.device
        mc = model_config(self.cfg, "int8_qat" if self.control else "none")
        with torch.device(dev):
            self.model = build_clip(mc, dev)
        weights = make_weights(self.cfg, self.seed, dev)
        load_weights(self.model, weights)
        del weights
        self.model.requires_grad_(False)
        self.tc = TrainConfig(batch_size=self.mix["batch_size"], image_feed="device",
                              **{k: self.hp[k] for k in _TRAIN_FIELDS})
        self.state = create_train_state(self.model, model_params(self.model), self.tc)
        free_cuda(dev)

    def _step(self, step: int, calls, span) -> float:
        from tpualign_torch.train import step as step_mod

        span = span or (lambda name: contextlib.nullcontext())
        b = self.mix["batch_size"]
        t0 = time.perf_counter()
        with span("batch"):
            images, tokens, weak = self.batch(step)
        with span("train_step"):
            self.state, metrics = step_mod.train_step(self.state, self.model, images, tokens,
                                                      weak, self.tc)
            loss = float(metrics["loss"])
        t1 = time.perf_counter()
        if calls is not None:
            calls.append(Call("train_step", t0, t1, b,
                              [("vision", b, self.shapes["vision"]["seq"]),
                               ("text", b, tokens.shape[1])]))
        return loss

    def warmup(self) -> None:
        """The checked steps, read for the reference, then the rest of the
        warm-up; the same state goes on into the window."""
        b1 = self.hp["adam_b1"]
        self.losses = []
        for step in range(self.mix["checked_steps"]):
            self.losses.append(self._step(step, None, None))
            if step == 0:
                # AdamW's first moment after one step is (1 - b1) times the clipped gradient
                self.first_grads = {k: (v.float() / (1.0 - b1)).cpu()
                                    for k, v in self.state.opt_state["mu"].items()}
        start = make_weights(self.cfg, self.seed, self.device)
        self.change = {k: float((p - start[k]).norm()) for k, p in self.state.params.items()}
        del start
        free_cuda(self.device)
        self.next_step = self.mix["checked_steps"]
        for _ in range(self.mix["warmup_steps_extra"]):
            self._step(self.next_step, None, None)
            self.next_step += 1
        # the window's kept step is copied into buffers made here, so that
        # keeping it allocates nothing inside the window
        opt = self.state.opt_state
        self.kept = {"before": {"params": _empty_like(self.state.params),
                                "mu": _empty_like(opt["mu"]), "nu": _empty_like(opt["nu"])},
                     "after": _empty_like(self.state.params)}

    # -- the window ------------------------------------------------------------

    def window(self, seconds: float, span=None) -> List[Call]:
        calls: List[Call] = []
        rng = np.random.default_rng(sub_seed(self.seed, "window_step"))
        kept = self.kept
        start = time.perf_counter()
        for i in itertools.count():
            # the window's i-th step replaces the kept one with probability 1 / (i + 1)
            keep = int(rng.integers(0, i + 1)) == 0
            if keep:
                opt = self.state.opt_state
                for name, tree in (("params", self.state.params), ("mu", opt["mu"]),
                                   ("nu", opt["nu"])):
                    _copy_into(kept["before"][name], tree)
                kept["before"]["count"] = int(opt["count"])
            loss = self._step(self.next_step, calls, span)
            if keep:
                _copy_into(kept["after"], self.state.params)
                kept["step"], kept["loss"] = self.next_step, loss
            self.next_step += 1
            if time.perf_counter() - start >= seconds:
                break
        return calls

    def release(self) -> None:
        del self.state, self.model
        free_cuda(self.device)

    # -- the check -------------------------------------------------------------

    def check(self) -> dict:
        """The checked steps and the window's kept step against the
        reference from the same weights and batches. The largest relative
        gap of a step's loss. Of the checked steps, by the worst leaf, the
        gap between the program's and the reference's norm of the first
        clipped gradient and of the change after the last checked step,
        each over the larger of the reference leaf's norm and the median
        leaf's; over the same, the median leaf's norm of the first
        gradient's difference (``grad_diff_median``, the number the
        int8_qat control fails). Of the kept step, which the reference
        follows from the program's state before it, by the worst leaf the
        norm of the difference of the two changes, element by element,
        over the larger of the reference leaf's change and the median
        leaf's (``window_change_gap``). Leaves whose reference gradient is
        under a thousandth of the median leaf's are left out of the
        changes and the medians."""
        dev, cfg = self.device, self.cfg
        size = self.shapes["vision"]["image_size"]

        def ref_batch(step: int):
            (u8, hw), tokens, weak = self.batch(step)
            return ref_pre.preprocess(u8, hw.tolist(), size), tokens, weak

        with ref_clip.no_tf32():
            batches = [ref_batch(step) for step in range(self.mix["checked_steps"])]
            ref = ref_train.run_steps(make_weights(cfg, self.seed, dev), cfg, batches, self.hp)
        del ref["params"], batches
        grad_floor = _median(ref["first_grad"].values())
        moved = [k for k, v in ref["first_grad"].items() if v >= 1e-3 * grad_floor]
        change_floor = _median(ref["change"][k] for k in moved)
        got_norm, diff = {}, {}
        for k, want in ref["first_grads"].items():
            got = self.first_grads[k].to(dev)
            got_norm[k] = float(got.norm())
            diff[k] = float((got - want).norm()) / max(ref["first_grad"][k], grad_floor)
        del ref["first_grads"]
        free_cuda(dev)

        kept, before = self.kept, self.kept["before"]
        with ref_clip.no_tf32():
            follow = ref_train.run_steps(before["params"], cfg, [ref_batch(kept["step"])],
                                         self.hp, moments=(before["mu"], before["nu"]),
                                         count=before["count"])
        w_floor = _median(follow["first_grad"].values())
        w_moved = [k for k, v in follow["first_grad"].items() if v >= 1e-3 * w_floor]
        want = {k: follow["params"][k] - before["params"][k] for k in w_moved}
        want_norm = {k: float(v.norm()) for k, v in want.items()}
        w_change_floor = _median(want_norm.values())
        window_change_gap = max(
            _ratio(float((kept["after"][k] - before["params"][k] - want[k]).norm()),
                   max(want_norm[k], w_change_floor)) for k in w_moved)
        losses = self.losses + [kept["loss"]]
        ref_losses = ref["losses"] + follow["losses"]
        return {
            "loss_gap": max(abs(a - b) / abs(b) for a, b in zip(losses, ref_losses)),
            "grad_norm_gap": max(abs(got_norm[k] - v) / max(v, grad_floor)
                                 for k, v in ref["first_grad"].items()),
            "grad_diff_median": _median(diff[k] for k in moved),
            "change_norm_gap": max(abs(self.change[k] - ref["change"][k])
                                   / max(ref["change"][k], change_floor) for k in moved),
            "window_change_gap": window_change_gap,
            "window_step": kept["step"],
            "leaves_left_out": len(ref["first_grad"]) - len(moved),
            "losses": losses,
            "reference_losses": ref_losses,
        }


def _empty_like(tree: dict) -> dict:
    return {k: torch.empty_like(v) for k, v in tree.items()}


def _copy_into(dst: dict, src: dict) -> None:
    torch._foreach_copy_([dst[k] for k in src], list(src.values()))


def _ratio(gap: float, scale: float) -> float:
    """``gap / scale``; where the reference moved nothing (a learning rate
    of 0), 0 for no gap and infinity for any."""
    if scale > 0:
        return gap / scale
    return 0.0 if gap == 0 else math.inf


def _median(values) -> float:
    v = sorted(values)
    n = len(v)
    return 0.5 * (v[(n - 1) // 2] + v[n // 2])
