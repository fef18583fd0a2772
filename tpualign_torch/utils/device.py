"""Device selection for the port's entry points.

Entry points run on the card by default. A caller that wants the CPU asks
for it with ``device="cpu"``; nothing moves to the CPU on its own.
"""

from __future__ import annotations

import torch


def resolve_device(device: str | torch.device = "cuda") -> torch.device:
    """The ``torch.device`` to run on; raises when CUDA is asked for and
    absent."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "CUDA is not available: tpualign_torch runs on an NVIDIA GPU by "
            "default; pass device='cpu' to run the plain PyTorch path on the CPU"
        )
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"device must be cuda or cpu, got {device!r}")
    return dev
