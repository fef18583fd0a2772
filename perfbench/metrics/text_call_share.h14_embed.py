"""The engine's text calls' share of the h14_embed window, in %, from the benchmark's host spans."""

from perfbench.readers import span_share


def read(run):
    return span_share(run, "text_call")
