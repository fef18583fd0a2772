"""Reads the numbers that decide a cell's ``correct`` over many seeds in
one process: the program's, the control's (the runner's lower precision
in the program's place) and, with ``--fault``, the program's with a
planted fault (``perfbench/faults.py``). The limits in
``perfbench/limits/<cell>.json`` are set from these readings (PERF.md
gives them). The benchmark's own runs never run it.

    python3 perfbench/readings.py --workload b32_embed --seeds 1,2,3 \\
        --control-seeds 4,5,6 [--fault-seeds 7,8,9] [--seconds 3] [--out FILE]

Each run prints one JSON line: its kind, seed and every number the check
read. It needs a CUDA card, as a run of the benchmark does.
"""

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import contextlib  # noqa: E402
import json  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))


def _seeds(text: str) -> list:
    return [int(s) for s in text.split(",") if s.strip()]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", default="")
    ap.add_argument("--control-seeds", default="")
    ap.add_argument("--fault-seeds", default="", help="each of the runner's faults on these")
    ap.add_argument("--seconds", type=float, default=3.0)
    ap.add_argument("--out", default="")
    args = ap.parse_args(argv)

    import torch

    from perfbench import harness
    from perfbench.faults import FAULTS, planted

    if not torch.cuda.is_available():
        print("no CUDA card", file=sys.stderr)
        return 2
    cell = harness.load_cell(args.workload)
    runner = cell.mix["runner"]
    plan = [("program", s, None) for s in _seeds(args.seeds)]
    plan += [("control", s, None) for s in _seeds(args.control_seeds)]
    plan += [(f"fault:{f}", s, f) for f in FAULTS[runner] for s in _seeds(args.fault_seeds)]
    out = open(args.out, "a") if args.out else None
    try:
        for kind, seed, fault in plan:
            numbers: dict = {}
            t0 = time.perf_counter()
            with planted(runner, fault) if fault else contextlib.nullcontext():
                result = harness.run(cell, seed, args.seconds, False, torch.device("cuda", 0),
                                     time.perf_counter(), control=kind == "control",
                                     log=lambda m: print(m, file=sys.stderr, flush=True),
                                     numbers_out=numbers)
            line = json.dumps({"workload": cell.name, "kind": kind, "seed": seed,
                               "seconds": time.perf_counter() - t0,
                               "attempted": result["attempted"],
                               "memory_peak_bytes": result["device"]["memory_peak_bytes"],
                               "numbers": numbers})
            print(line, flush=True)
            if out:
                out.write(line + "\n")
                out.flush()
    finally:
        if out:
            out.close()
    return 0


if __name__ == "__main__":
    sys.exit(main())
