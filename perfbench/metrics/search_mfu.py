"""The window's exact searches as float32 products over the window and the float32 peak, in %."""

from perfbench.readers import search_mfu


def read(run):
    return search_mfu(run)
