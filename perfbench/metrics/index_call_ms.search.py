"""The median host-clock time of one RetrievalIndex.search call of the window, in ms."""

from perfbench.readers import median_call_ms


def read(run):
    return median_call_ms(run, "search_call")
