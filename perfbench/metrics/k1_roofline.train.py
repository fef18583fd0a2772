"""K1's share of its roofline over the training steps' forward launches, in %, from the device trace."""

from perfbench.readers import k1_roofline


def read(run):
    return k1_roofline(run)
