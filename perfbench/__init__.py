"""The benchmark of tpualign_torch on NVIDIA H100 cards.

``python3 perfbench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>``
runs one cell of ``BENCHMARK.json`` once. Everything is found by name:

- ``configs/<config>.json``: a model configuration as run (widths, dtype,
  what was assumed), with the source it follows;
- ``traffic/<mix>.json``: a traffic mix's parameters; its ``runner`` names
  the general runner that generates and drives it (``runners/<runner>.py``:
  ``embed``, ``train``, ``search``);
- ``limits/<cell>.json``: the numbers that decide ``correct``, each with its
  limit and the readings it was set from;
- ``metrics/<metric>.py``: one reader per per-layer metric.

``e2e.py`` holds the end-to-end arithmetic, ``device.py`` the card's peaks
and the reduction of a profiler trace, ``flops.py`` the operations and
bytes of what a call runs, ``weights.py`` the seeded weights,
``reference/`` the plain reference that decides ``correct``, ``faults.py``
and ``readings.py`` the faults and the readings the limits were set from,
``tests/`` the benchmark's own tests (``python -m pytest perfbench/tests``).
"""
