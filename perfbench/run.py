"""Runs one cell of the benchmark of tpualign_torch once, on the card.

    python3 perfbench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout. It builds the cell's program objects and
inputs from the seed, warms up the cell's own shapes, measures for
``--seconds``, checks what the window produced against the plain
reference, and prints one JSON line last on standard output: the cell's
end-to-end metrics (``--trace 0``) or its per-layer metrics read from a
profiled window (``--trace 1``). Each number compared with the reference
is printed beside its limit, last on standard error and last in the line.
Without a CUDA card, or with fewer cards than the cell asks for, it exits
with 2 and prints no result; with JAX or the JAX package loaded once the
window has closed, with 3.
"""

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

CHECKOUT = Path(__file__).resolve().parent.parent
# the program's build and kernel caches stay inside the checkout, at fixed paths
os.environ["TRITON_CACHE_DIR"] = str(CHECKOUT / "perfbench" / ".cache" / "triton")
os.environ["TORCH_EXTENSIONS_DIR"] = str(CHECKOUT / "perfbench" / ".cache" / "torch_extensions")
sys.path.insert(0, str(CHECKOUT))

FORBIDDEN = ("jax", "jaxlib", "flax", "tpualign")


def _err(msg: str) -> None:
    print(msg, file=sys.stderr, flush=True)


def forbidden_modules() -> list:
    """Loaded modules whose top-level name (before the first dot) is one
    of ``FORBIDDEN``, compared whole."""
    return sorted({name for name in sys.modules if name.split(".")[0] in FORBIDDEN})


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    import torch

    from perfbench import harness
    from perfbench.device import card_line

    cell = harness.load_cell(args.workload)
    if not torch.cuda.is_available():
        _err("no CUDA card: the benchmark measures the program on the card only")
        return 2
    if torch.cuda.device_count() < cell.chips:
        _err(f"{args.workload} needs {cell.chips} cards, {torch.cuda.device_count()} present")
        return 2
    import tpualign_torch

    if CHECKOUT not in Path(tpualign_torch.__file__).resolve().parents:
        _err(f"tpualign_torch loaded from {tpualign_torch.__file__}, outside {CHECKOUT}")
        return 2
    result = harness.run(cell, args.seed, args.seconds, bool(args.trace),
                         torch.device("cuda", 0), T_START, log=_err)
    bad = forbidden_modules()
    if bad:
        _err(f"loaded in this process after the window: {bad}")
        return 3
    _err(f"card: {card_line()}")
    for name, c in result["checks"].items():
        _err(f"{name} {c['value']!r} limit {c['limit']!r}")
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
