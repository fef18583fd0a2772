"""Three times the forward model FLOPs of the window's steps over the window and the bf16 peak, in %."""

from perfbench.readers import mfu


def read(run):
    return mfu(run, 3.0)
