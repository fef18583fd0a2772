"""End-to-end arithmetic: what a user of the system would see, from the
host clock around the benchmark's calls.

A call record holds its host-clock start and end, the items it finished
(images and chunks back on the host, pairs of a step whose loss was read
back, queries answered) and the tower or kernel passes it ran. The window
is the time from the first timed call's start to the last call's end;
only whole calls count.
"""

from __future__ import annotations

import statistics
from dataclasses import dataclass, field
from typing import Callable, Dict, List, Optional

__all__ = ["Call", "window_s", "METRICS", "metric", "describe"]


@dataclass
class Call:
    span: str
    t0: float
    t1: float
    items: int
    passes: List[tuple] = field(default_factory=list)


def window_s(calls: List[Call]) -> float:
    return calls[-1].t1 - calls[0].t0


def _rate(calls: List[Call]) -> float:
    return sum(c.items for c in calls) / window_s(calls)


def _p95_ms(calls: List[Call]) -> float:
    lat = sorted((c.t1 - c.t0) * 1e3 for c in calls)
    return statistics.quantiles(lat, n=100, method="inclusive")[94]


# every end-to-end metric by the part of its name before the first dot
# (``embed_items_per_s.h14_embed`` is ``embed_items_per_s`` in its own
# cell, under a bound of its own): calls -> value
METRICS: Dict[str, Callable[[List[Call]], Optional[float]]] = {
    "embed_items_per_s": _rate,
    "train_pairs_per_s": _rate,
    "search_queries_per_s": _rate,
    "search_p95_ms": _p95_ms,
}


def metric(name: str) -> Callable[[List[Call]], Optional[float]]:
    return METRICS[name.split(".")[0]]


def describe(calls: List[Call]) -> str:
    """The calls' milliseconds (quartiles and the largest) and the items a
    second of each half of the window, to tell drift within a run from
    spread between runs."""
    ms = sorted((c.t1 - c.t0) * 1e3 for c in calls)
    q = statistics.quantiles(ms, n=4) if len(ms) > 1 else ms * 3
    mid = len(calls) // 2
    halves = [_rate(part) for part in (calls[:mid], calls[mid:]) if part]
    return (f"ms quartiles {q[0]:.2f} {q[1]:.2f} {q[2]:.2f}, max {ms[-1]:.2f}; "
            f"rate by half {', '.join(f'{r:.1f}' for r in halves)}")
