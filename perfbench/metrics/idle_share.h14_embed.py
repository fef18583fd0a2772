"""The card's idle share of the traced h14_embed window, in %."""

from perfbench.readers import idle_share


def read(run):
    return idle_share(run)
