"""Tracing and throughput observability (the port's
``tpualign.utils.profiling``).

``annotate`` marks a span in a ``torch.profiler`` trace
(``record_function``) and logs its wall time; ``start_trace`` /
``stop_trace`` capture a trace to a directory (TensorBoard/Perfetto);
``device_barrier`` waits for the card; ``ThroughputMeter`` counts items
per second per stage (the trainer's pairs/s).
"""

from __future__ import annotations

import contextlib
import time
from dataclasses import dataclass, field
from typing import Dict, Iterator, Optional

import torch

from tpualign_torch.utils.logging import get_logger

log = get_logger("profiling")

__all__ = ["annotate", "start_trace", "stop_trace", "ThroughputMeter", "device_barrier"]

_PROFILER: list = []


@contextlib.contextmanager
def annotate(name: str) -> Iterator[None]:
    """Named trace span (``torch.profiler.record_function``) + a debug log
    of its wall time."""
    t0 = time.perf_counter()
    with torch.profiler.record_function(name):
        yield
    log.debug("%s: %.3fs", name, time.perf_counter() - t0)


def start_trace(log_dir: str) -> None:
    """Start a ``torch.profiler`` trace (CPU and, where present, CUDA
    activity) that :func:`stop_trace` writes under ``log_dir``."""
    activities = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    prof = torch.profiler.profile(
        activities=activities,
        on_trace_ready=torch.profiler.tensorboard_trace_handler(log_dir))
    prof.start()
    _PROFILER.append(prof)
    log.info("profiler trace started -> %s", log_dir)


def stop_trace() -> None:
    if _PROFILER:
        _PROFILER.pop().stop()
    log.info("profiler trace stopped")


def device_barrier(x=None) -> None:
    """Wait for the queued work on the card (a no-op without CUDA)."""
    if torch.cuda.is_available():
        torch.cuda.synchronize()


@dataclass
class ThroughputMeter:
    """Counts items/s across stages (the pairs/s headline)."""

    counts: Dict[str, int] = field(default_factory=dict)
    times: Dict[str, float] = field(default_factory=dict)

    @contextlib.contextmanager
    def measure(self, stage: str, items: int) -> Iterator[None]:
        t0 = time.perf_counter()
        yield
        dt = time.perf_counter() - t0
        self.counts[stage] = self.counts.get(stage, 0) + items
        self.times[stage] = self.times.get(stage, 0.0) + dt

    def rate(self, stage: str) -> Optional[float]:
        if stage not in self.counts or self.times.get(stage, 0.0) <= 0:
            return None
        return self.counts[stage] / self.times[stage]

    def report(self) -> Dict[str, float]:
        out = {}
        for stage in self.counts:
            r = self.rate(stage)
            if r is not None:
                out[stage] = round(r, 1)
                log.info("%s: %d items in %.2fs (%.1f items/s)",
                         stage, self.counts[stage], self.times[stage], r)
        return out
