"""Model FLOPs of the h14_embed window's tower passes over the window and the bf16 peak, in %."""

from perfbench.readers import mfu


def read(run):
    return mfu(run)
