"""One run of one cell: set-up, warm-up, the measured window, the traced
window's reduction, the check against the reference, and the result line.

Everything is found by name. ``BENCHMARK.json`` names the cell's
configuration and traffic mix; the configuration is the file it names,
the mix is ``traffic/<traffic>.json``, whose ``runner`` names the general
runner that generates it (``runners/<runner>.py``), the limits of the
check are ``limits/<workload>.json`` and each per-layer metric is read by
``metrics/<metric>.py``. A later cell, mix or metric is new files and
entries, with no edit to a file here.
"""

from __future__ import annotations

import gzip
import importlib
import importlib.util
import json
import math
import tempfile
import time
from dataclasses import dataclass, field
from pathlib import Path
from typing import Dict, List, Optional

import torch

from perfbench import e2e
from perfbench.device import Profiler, Trace, device_info, reduce_trace

__all__ = ["ROOT", "CHECKOUT", "manifest", "Cell", "load_cell", "RunContext", "run"]

ROOT = Path(__file__).resolve().parent
CHECKOUT = ROOT.parent


def _json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def manifest() -> dict:
    return _json(CHECKOUT / "BENCHMARK.json")


def _applies(metric: dict, workload: str) -> bool:
    return "workloads" not in metric or workload in metric["workloads"]


@dataclass
class Cell:
    name: str
    cfg: dict
    mix: dict
    limits: dict
    chips: int
    end_to_end: List[str]
    per_layer: List[str]
    units: Dict[str, str]


def load_cell(workload: str, bench: Optional[dict] = None) -> Cell:
    bench = bench or manifest()
    cells = {w["name"]: w for w in bench["workloads"]}
    if workload not in cells:
        raise KeyError(f"no workload {workload!r} in BENCHMARK.json: {sorted(cells)}")
    w = cells[workload]
    config = {c["name"]: c for c in bench["configs"]}[w["config"]]
    return Cell(
        name=workload,
        cfg=_json(CHECKOUT / config["file"]),
        mix=_json(ROOT / "traffic" / f"{w['traffic']}.json"),
        limits=_json(ROOT / "limits" / f"{workload}.json"),
        chips=int(w["chips"]),
        end_to_end=[m["name"] for m in bench["end_to_end"] if _applies(m, workload)],
        per_layer=[m["name"] for m in bench["per_layer"] if _applies(m, workload)],
        units={m["name"]: m["unit"] for m in bench["end_to_end"] + bench["per_layer"]},
    )


@dataclass
class RunContext:
    """What a per-layer metric's reader reads: the configuration and mix,
    the window's calls, the reduced trace (traced runs only) and the
    program's own launch counters over the window."""

    cfg: dict
    mix: dict
    calls: List[e2e.Call]
    window_s: float
    trace: Optional[Trace] = None
    counters: Dict[str, int] = field(default_factory=dict)


def _reader(name: str):
    path = ROOT / "metrics" / f"{name}.py"
    spec = importlib.util.spec_from_file_location(f"perfbench_metric:{name}", path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module.read


def _counters() -> Dict[str, int]:
    """The program's launch counters of the kernels the cells drive."""
    from tpualign_torch.ops.attention import fused_mha
    from tpualign_torch.ops.normalize import normalize_u8
    from tpualign_torch.ops.sim_topk import masked_sim_topk

    return {"fused_mha": fused_mha.launches, "masked_sim_topk": masked_sim_topk.launches,
            "normalize_u8": normalize_u8.launches}


def runner_for(cell: Cell):
    return importlib.import_module(f"perfbench.runners.{cell.mix['runner']}").Runner


def judge(numbers: dict, limits: dict) -> Dict[str, dict]:
    """Each compared number beside its limit; a number with no limit set
    has the limit None."""
    return {name: {"value": numbers.get(name), "limit": spec.get("limit")}
            for name, spec in limits["numbers"].items()}


def is_correct(checks: Dict[str, dict]) -> bool:
    return bool(checks) and all(
        c["value"] is not None and c["limit"] is not None and math.isfinite(c["value"])
        and c["value"] <= c["limit"] for c in checks.values())


def _write_trace(cell: Cell, seed: int, trace: Trace) -> str:
    path = Path(tempfile.gettempdir()) / f"perfbench.{cell.name}.{seed}.trace.json.gz"
    with gzip.open(path, "wt") as f:
        json.dump({"window_s": trace.window_s, "busy_s": trace.busy_s,
                   "kernels": trace.kernels, "gaps": trace.gaps}, f)
    return str(path)


def run(cell: Cell, seed: int, seconds: float, trace: bool, device: torch.device,
        t_start: float, control: bool = False, log=print,
        numbers_out: Optional[dict] = None) -> dict:
    """One run; returns the result line's object (``checks`` last).
    ``control`` puts the runner's control in the program's place;
    ``numbers_out`` receives every number the check read."""
    runner = runner_for(cell)(cell.cfg, cell.mix, seed, device, control=control)
    runner.build()
    if device.type == "cuda":
        torch.cuda.reset_peak_memory_stats(device)
    runner.warmup()
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    before = _counters()
    prof = None
    if trace:
        from torch.profiler import record_function

        with Profiler(device) as prof:
            with record_function("window"):
                calls = runner.window(seconds, record_function)
    else:
        calls = runner.window(seconds)
    counters = {k: v - before[k] for k, v in _counters().items()}
    dev_info = device_info(device, cell.chips)
    reduced = reduce_trace(prof.results) if prof is not None else None
    del prof
    runner.release()
    t_check = time.perf_counter()
    numbers = runner.check()
    log(f"check: {time.perf_counter() - t_check:.1f} s, {numbers}")
    if numbers_out is not None:
        numbers_out.update(numbers)

    ctx = RunContext(cell.cfg, cell.mix, calls, e2e.window_s(calls), reduced, counters)
    metrics = {}
    if trace:
        for name in cell.per_layer:
            value = _reader(name)(ctx)
            if value is not None:
                metrics[name] = {"value": value, "unit": cell.units[name]}
        if reduced is not None:
            dev_info["busy_s"] = reduced.busy_s
            dev_info["window_s"] = reduced.window_s
    else:
        for name in cell.end_to_end:
            if name == "setup_s":
                metrics[name] = {"value": calls[0].t0 - t_start, "unit": "s"}
            else:
                metrics[name] = {"value": e2e.metric(name)(calls), "unit": cell.units[name]}
    checks = judge(numbers, cell.limits)
    result = {"correct": is_correct(checks), "attempted": len(calls), "failed": 0,
              "metrics": metrics, "device": dev_info}
    if reduced is not None:
        result["breakdown"] = {"device_ops": reduced.top_ops(), "idle_gaps": reduced.top_gaps()}
        log(f"trace: {_write_trace(cell, seed, reduced)}")
    log(f"window: {ctx.window_s:.3f} s, {len(calls)} calls, counters {counters}")
    log(f"calls: {e2e.describe(calls)}")
    result["checks"] = checks
    return result
