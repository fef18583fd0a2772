"""Faults planted in the program under a run, to show that the check
that decides ``correct`` catches them: each patches one call of the timed
path for the length of a ``with`` block and restores it after.

- ``altered_answer`` (embed, search): every call's first answer is
  changed where it is produced (an embedding negated; a returned row
  moved to its neighbour);
- ``state_unchanged`` (train): the step computes its loss and hands back
  the state as it was (parameters, moments and count);
- ``half_batch`` (train): the step sees the first half of the batch and
  takes its mean over those rows;
- ``state_unchanged_in_window``, ``update_flipped_in_window`` (train):
  from the window's first step on, the state handed back as it was, or
  the parameters moved by the step's update with its sign flipped; the
  steps of set-up are sound.

``perfbench/tests/test_perfbench_faults.py`` drives a run under each at a
small size on the CPU; ``perfbench/readings.py --fault`` reads one at a
cell's own size on the card.
"""

from __future__ import annotations

import contextlib
from typing import Dict, Tuple

import torch

__all__ = ["FAULTS", "planted"]

# the faults each runner's cells can have
FAULTS: Dict[str, Tuple[str, ...]] = {
    "embed": ("altered_answer",),
    "train": ("state_unchanged", "half_batch", "state_unchanged_in_window",
              "update_flipped_in_window"),
    "search": ("altered_answer",),
}


@contextlib.contextmanager
def _patched(owner, name: str, make):
    original = getattr(owner, name)
    setattr(owner, name, make(original))
    try:
        yield
    finally:
        setattr(owner, name, original)


def _negate_first(out):
    out = out.copy()
    out[0] = -out[0]
    return out


def _embed_altered():
    from tpualign_torch.parallel.embed import EmbedEngine

    def run_batched(orig):
        return lambda self, fn, data: _negate_first(orig(self, fn, data))

    def image_u8(orig):
        return lambda self, images, hws, pinned: _negate_first(orig(self, images, hws, pinned))

    stack = contextlib.ExitStack()
    stack.enter_context(_patched(EmbedEngine, "_run_batched", run_batched))
    stack.enter_context(_patched(EmbedEngine, "_encode_image_u8", image_u8))
    return stack


def _search_altered():
    from tpualign_torch.parallel.retrieval import RetrievalIndex

    def search(orig):
        def altered(self, *args, **kwargs):
            vals, idx = orig(self, *args, **kwargs)
            idx = idx.copy()
            idx[0, 0] = (idx[0, 0] + 1) % self.n
            return vals, idx
        return altered

    return _patched(RetrievalIndex, "search", search)


def _unchanged(orig):
    def step(state, *args, **kwargs):
        params = {k: v.clone() for k, v in state.params.items()}
        opt = {"count": state.opt_state["count"],
               "mu": {k: v.clone() for k, v in state.opt_state["mu"].items()},
               "nu": {k: v.clone() for k, v in state.opt_state["nu"].items()}}
        count = state.step
        state, metrics = orig(state, *args, **kwargs)
        with torch.no_grad():
            for k, v in params.items():
                state.params[k].copy_(v)
        state.opt_state, state.step = opt, count
        return state, metrics
    return step


def _flipped(orig):
    def step(state, *args, **kwargs):
        params = {k: v.clone() for k, v in state.params.items()}
        state, metrics = orig(state, *args, **kwargs)
        with torch.no_grad():
            for k, v in params.items():
                # before - (after - before)
                state.params[k].mul_(-1.0).add_(v, alpha=2.0)
        return state, metrics
    return step


def _half(orig):
    def step(state, model, images, tokens, weak, config, *args, **kwargs):
        h = tokens.shape[0] // 2
        images = tuple(t[:h] for t in images) if isinstance(images, tuple) else images[:h]
        return orig(state, model, images, tokens[:h], weak[:h], config, *args, **kwargs)
    return step


def _train_fault(make, window_only: bool = False):
    """``train_step`` wrapped by ``make``; with ``window_only``, only while
    the train runner's window runs."""
    from perfbench.runners.train import Runner
    from tpualign_torch.train import step as step_mod

    if not window_only:
        return _patched(step_mod, "train_step", make)
    in_window = [False]

    def window(orig):
        def timed(self, *args, **kwargs):
            in_window[0] = True
            try:
                return orig(self, *args, **kwargs)
            finally:
                in_window[0] = False
        return timed

    def train_step(orig):
        faulty = make(orig)
        return lambda *args, **kwargs: (faulty if in_window[0] else orig)(*args, **kwargs)

    stack = contextlib.ExitStack()
    stack.enter_context(_patched(Runner, "window", window))
    stack.enter_context(_patched(step_mod, "train_step", train_step))
    return stack


_PLANTERS = {
    ("embed", "altered_answer"): _embed_altered,
    ("search", "altered_answer"): _search_altered,
    ("train", "state_unchanged"): lambda: _train_fault(_unchanged),
    ("train", "half_batch"): lambda: _train_fault(_half),
    ("train", "state_unchanged_in_window"): lambda: _train_fault(_unchanged, True),
    ("train", "update_flipped_in_window"): lambda: _train_fault(_flipped, True),
}


def planted(runner: str, fault: str):
    """A context manager under which ``runner``'s timed path has ``fault``."""
    if (runner, fault) not in _PLANTERS:
        raise KeyError(f"no fault {fault!r} for the {runner} runner: {FAULTS.get(runner)}")
    return _PLANTERS[(runner, fault)]()
