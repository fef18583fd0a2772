"""K1's share of its roofline over the h14_embed window's launches, in %, from the device trace."""

from perfbench.readers import k1_roofline


def read(run):
    return k1_roofline(run)
