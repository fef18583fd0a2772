"""Native (C++) acceleration for host-side hot loops: substring counts of
the lexical score, the BPE merge core, the HNSW graph and a top-k merge.

``build.py`` compiles ``tpualign_native.cpp`` (a byte-identical copy of
tpualign's) with g++ at first use into ``tpualign_torch/_build/``;
``bindings.py`` loads it through ctypes. Every entry point has a
pure-Python fallback, so the package works without a toolchain.
"""

from tpualign_torch.native.bindings import (
    lexical_counts, make_bpe_core, native_available, topk_merge)

__all__ = ["lexical_counts", "make_bpe_core", "native_available", "topk_merge"]
