"""The card: its published peaks, roofline bounds, what a run reports
about the device, and the reduction of a profiler trace to busy time,
idle gaps and device time by kernel.

Peaks are NVIDIA's H100 SXM data sheet at 700 W, dense: 989 TFLOP/s in
bf16, 67 TFLOP/s in fp32 outside the tensor cores, 3.35 TB/s of HBM.
"""

from __future__ import annotations

import bisect
import subprocess
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Sequence, Tuple

import torch

__all__ = ["HBM_BYTES_PER_S", "PEAK_FLOPS", "bound_s", "Trace", "Profiler", "reduce_trace",
           "device_info", "card_line", "SPANS"]

HBM_BYTES_PER_S = 3.35e12
PEAK_FLOPS = {"bfloat16": 989e12, "float32": 67e12}

# the benchmark's own host spans, around each call into the program
SPANS = ("image_call", "text_call", "batch", "train_step", "search_call")


def bound_s(nbytes: float, ops: float, peak: float) -> float:
    """The least time the card could take: the larger of the bytes over
    the HBM rate and the operations over the peak."""
    return max(nbytes / HBM_BYTES_PER_S, ops / peak)


@dataclass
class Trace:
    """A traced window reduced: device intervals (kernels, copies, sets)
    clipped to the window, in seconds from its start."""

    window_s: float
    kernels: List[Tuple[str, float, float]]        # (name, start, end)
    busy_s: float = 0.0
    gaps: List[Tuple[str, float]] = field(default_factory=list)  # (span, seconds)

    def device_time(self, match: Sequence[str]) -> Tuple[float, int]:
        """Summed device seconds and count of the kernels whose name holds
        any of ``match``."""
        hits = [e - s for name, s, e in self.kernels if any(m in name for m in match)]
        return sum(hits), len(hits)

    def top_ops(self, n: int = 10) -> List[list]:
        by_name: Dict[str, float] = {}
        for name, s, e in self.kernels:
            by_name[name] = by_name.get(name, 0.0) + (e - s)
        top = sorted(by_name.items(), key=lambda kv: -kv[1])[:n]
        return [[name[:120], secs] for name, secs in top]

    def top_gaps(self, n: int = 10) -> List[list]:
        return [[name, secs] for name, secs in sorted(self.gaps, key=lambda g: -g[1])[:n]]


def _times(event) -> Tuple[int, int]:
    return event.start_ns(), event.end_ns()


class Profiler:
    """Kineto over a window: every device activity (kernels, copies,
    sets, through CUPTI) and, on the host, only the ``record_function``
    spans (the benchmark's own). The program's operators are not recorded
    on the host, which would slow a step of many small operators by half
    or more. ``results`` holds the kineto results after the block."""

    def __init__(self, device: torch.device):
        self.device, self.results = device, None

    def __enter__(self):
        import torch.autograd.profiler as autograd_profiler
        from torch._C._autograd import _enable_profiler, _prepare_profiler
        from torch._C._profiler import ProfilerActivity, RecordScope

        acts = {ProfilerActivity.CPU}
        if self.device.type == "cuda":
            acts.add(ProfilerActivity.CUDA)
        config = autograd_profiler.profile(use_kineto=True).config(create_trace_id=False)
        _prepare_profiler(config, acts)
        _enable_profiler(config, acts, {RecordScope.USER_SCOPE})
        return self

    def __exit__(self, *exc):
        from torch._C._autograd import _disable_profiler

        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        self.results = _disable_profiler()
        return False


def reduce_trace(results, window_name: str = "window") -> Optional[Trace]:
    """The ``window_name`` annotation's span, every device interval inside
    it (kernels, copies, sets; the device copies of annotations left
    out), their merged busy time, and each idle gap named after the
    innermost benchmark span the host was in when it began. None when
    the trace holds no device time."""
    from torch.autograd import DeviceType

    events = results.events()
    window = None
    spans: List[Tuple[int, int, str]] = []
    device: List[Tuple[int, int, str]] = []
    for ev in events:
        name = ev.name()
        if ev.device_type() == DeviceType.CUDA:
            # the device copies of the benchmark's annotations span kernels: left out
            if not ev.is_user_annotation():
                device.append((*_times(ev), name))
        elif name == window_name:
            window = _times(ev)
        elif name in SPANS:
            spans.append((*_times(ev), name))
    if window is None or not device:
        return None
    w0, w1 = window
    device = [(max(a, w0), min(b, w1), n) for a, b, n in device if b > w0 and a < w1]
    if not device:
        return None
    device.sort()
    merged: List[List[int]] = []
    for a, b, _ in device:
        if merged and a <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], b)
        else:
            merged.append([a, b])
    busy = sum(b - a for a, b in merged)
    spans.sort()
    starts = [a for a, _, _ in spans]

    def host_span(t: int) -> str:
        # the benchmark's spans do not nest: the last one begun holds t or none does
        i = bisect.bisect_right(starts, t) - 1
        return spans[i][2] if i >= 0 and t < spans[i][1] else "between_calls"

    gaps, last = [], w0
    for a, b in merged + [[w1, w1]]:
        if a > last:
            gaps.append((host_span(last), (a - last) * 1e-9))
        last = max(last, b)
    kernels = [(n, (a - w0) * 1e-9, (b - w0) * 1e-9) for a, b, n in device]
    return Trace(window_s=(w1 - w0) * 1e-9, kernels=kernels, busy_s=busy * 1e-9, gaps=gaps)


def card_line() -> str:
    """``nvidia-smi``'s name and power limit of the first card, or why not."""
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True, text=True,
                             timeout=30, check=True)
        return out.stdout.strip().splitlines()[0]
    except (OSError, subprocess.SubprocessError, IndexError) as e:
        return f"nvidia-smi unavailable: {e!r}"


def device_info(device: torch.device, count: int = 1) -> dict:
    if device.type == "cuda":
        return {"platform": "gpu", "kind": torch.cuda.get_device_name(device),
                "count": count,
                "memory_peak_bytes": int(torch.cuda.max_memory_allocated(device))}
    return {"platform": "cpu", "kind": "cpu", "count": count, "memory_peak_bytes": 0}
