"""Arithmetic that several per-layer metrics share. Each metric's own
reader in ``metrics/`` calls one of these; a reader that finds nothing to
read returns None and the metric is left out of the line."""

from __future__ import annotations

import statistics
import sys
from typing import Optional

from perfbench.device import PEAK_FLOPS, bound_s
from perfbench.flops import k1_bytes_ops, k1_launches, k2_bytes_ops, pass_flops

__all__ = ["span_share", "mfu", "search_mfu", "idle_share", "k1_roofline", "k2_roofline",
           "median_call_ms"]

K1_KERNELS = ("mha_bf16", "mha_f32")
K2_KERNELS = ("sweep_kernel", "admit_kernel", "merge_kernel")
_ITEM = {"bfloat16": 2, "float32": 4}


def span_share(run, span: str) -> Optional[float]:
    """The share of the window, in %, that calls of ``span`` took."""
    hit = [c.t1 - c.t0 for c in run.calls if c.span == span]
    return 100.0 * sum(hit) / run.window_s if hit else None


def mfu(run, passes_per_forward: float = 1.0) -> Optional[float]:
    """Model FLOPs of the window's tower passes at the shapes they ran,
    times ``passes_per_forward`` (3 for a training step), over the window
    and the peak of the configuration's compute dtype, in %."""
    flops = sum(pass_flops(run.cfg, tower, rows, seq) for c in run.calls
                for tower, rows, seq in c.passes if tower in ("vision", "text"))
    if not flops:
        return None
    return 100.0 * passes_per_forward * flops / run.window_s / PEAK_FLOPS[run.cfg["compute_dtype"]]


def search_mfu(run) -> Optional[float]:
    """The window's searches as exact float32 products, 2·Q·N·D a call
    (every pair: a global search), over the window and the float32 peak,
    in %: what the whole call makes of the card, whichever kernel runs."""
    # a K2 pass is ("k2", queries, rows, dim, k)
    flops = sum(2.0 * p[1] * p[2] * p[3] for c in run.calls for p in c.passes if p[0] == "k2")
    if not flops:
        return None
    return 100.0 * flops / run.window_s / PEAK_FLOPS["float32"]


def idle_share(run) -> Optional[float]:
    """The traced window's share, in %, in which nothing ran on the card."""
    if run.trace is None:
        return None
    return 100.0 * max(0.0, 1.0 - run.trace.busy_s / run.trace.window_s)


def _note(msg: str) -> None:
    print(msg, file=sys.stderr)


def k1_roofline(run) -> Optional[float]:
    """Summed bounds of the window's K1 launches over their summed device
    time, in %. Each forward tower pass launches K1 once a layer; the
    launches the trace holds must be as many."""
    if run.trace is None:
        return None
    dtype = run.cfg["compute_dtype"]
    bound, launches = 0.0, 0
    for c in run.calls:
        for tower, rows, seq in c.passes:
            if tower not in ("vision", "text"):
                continue
            r, t, w, h, causal, count = k1_launches(run.cfg, tower, rows, seq)
            nbytes, ops = k1_bytes_ops(r, t, w, h, causal, _ITEM[dtype])
            bound += count * bound_s(nbytes, ops, PEAK_FLOPS[dtype])
            launches += count
    secs, seen = run.trace.device_time(K1_KERNELS)
    if not seen:
        return None
    if seen != launches or run.counters.get("fused_mha", launches) != launches:
        _note(f"k1_roofline: {seen} K1 kernels traced, {launches} launches expected, "
              f"{run.counters.get('fused_mha')} counted: not read")
        return None
    return 100.0 * bound / secs


def k2_roofline(run) -> Optional[float]:
    """Summed bounds of the window's K2 calls (every pair admitted: a
    global search) over the summed device time of K2's prologue, sweep and
    merge, in %."""
    if run.trace is None:
        return None
    bound = 0.0
    calls = 0
    for c in run.calls:
        for p in c.passes:
            if p[0] == "k2":
                _, q, n, d, k = p
                nbytes, ops = k2_bytes_ops(q, n, d, k, q * n)
                bound += bound_s(nbytes, ops, PEAK_FLOPS["float32"])
                calls += 1
    secs, seen = run.trace.device_time(K2_KERNELS)
    if not seen or not calls:
        return None
    if run.counters.get("masked_sim_topk", calls) != calls:
        _note(f"k2_roofline: {run.counters.get('masked_sim_topk')} K2 launches counted, "
              f"{calls} calls: not read")
        return None
    return 100.0 * bound / secs


def median_call_ms(run, span: str) -> Optional[float]:
    lat = [(c.t1 - c.t0) * 1e3 for c in run.calls if c.span == span]
    return statistics.median(lat) if lat else None
