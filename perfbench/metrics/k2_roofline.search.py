"""K2's share of its roofline over the window's searches, in %, from the device trace."""

from perfbench.readers import k2_roofline


def read(run):
    return k2_roofline(run)
