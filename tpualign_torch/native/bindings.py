"""ctypes bindings over the native library (the port's copy of
``tpualign.native.bindings``: the same C ABI, argtypes and ``None``
contract).

Every function returns ``None`` when the native library is unavailable so
callers fall back to their pure-Python implementations.
"""

from __future__ import annotations

import ctypes
import threading
from typing import List, Optional, Tuple

import numpy as np

_LIB = None
_TRIED = False
_LOCK = threading.Lock()


def _load():
    with _LOCK:
        return _load_locked()


def _load_locked():
    global _LIB, _TRIED
    if _TRIED:
        return _LIB
    _TRIED = True
    try:
        from tpualign_torch.native.build import build

        path = build()
        if path is None:
            return None
        lib = ctypes.CDLL(str(path))
        lib.tpua_lexical_counts.argtypes = [
            ctypes.POINTER(ctypes.c_char_p), ctypes.c_int32,
            ctypes.POINTER(ctypes.c_char_p), ctypes.c_int32,
            ctypes.POINTER(ctypes.c_int32),
        ]
        lib.tpua_topk_merge.argtypes = [
            ctypes.POINTER(ctypes.c_float), ctypes.POINTER(ctypes.c_int64),
            ctypes.c_int32, ctypes.c_int32, ctypes.c_int32,
            ctypes.POINTER(ctypes.c_float), ctypes.POINTER(ctypes.c_int64),
        ]
        lib.tpua_bpe_create.argtypes = [
            ctypes.POINTER(ctypes.c_int32), ctypes.POINTER(ctypes.c_int32),
            ctypes.POINTER(ctypes.c_int32), ctypes.c_int32,
        ]
        lib.tpua_bpe_create.restype = ctypes.c_void_p
        lib.tpua_bpe_destroy.argtypes = [ctypes.c_void_p]
        lib.tpua_bpe_word.argtypes = [
            ctypes.c_void_p, ctypes.POINTER(ctypes.c_int32), ctypes.c_int32,
        ]
        lib.tpua_bpe_word.restype = ctypes.c_int32
        lib.tpua_hnsw_create.argtypes = [
            ctypes.c_int32, ctypes.c_int32, ctypes.c_int32, ctypes.c_uint64,
            ctypes.c_int32,
        ]
        lib.tpua_hnsw_create.restype = ctypes.c_void_p
        lib.tpua_hnsw_destroy.argtypes = [ctypes.c_void_p]
        lib.tpua_hnsw_count.argtypes = [ctypes.c_void_p]
        lib.tpua_hnsw_count.restype = ctypes.c_int64
        lib.tpua_hnsw_live_count.argtypes = [ctypes.c_void_p]
        lib.tpua_hnsw_live_count.restype = ctypes.c_int64
        lib.tpua_hnsw_add.argtypes = [
            ctypes.c_void_p, ctypes.POINTER(ctypes.c_float),
            ctypes.POINTER(ctypes.c_int64), ctypes.c_int64,
        ]
        lib.tpua_hnsw_add.restype = ctypes.c_int64
        lib.tpua_hnsw_mark_deleted.argtypes = [
            ctypes.c_void_p, ctypes.POINTER(ctypes.c_int64), ctypes.c_int64,
        ]
        lib.tpua_hnsw_search.argtypes = [
            ctypes.c_void_p, ctypes.POINTER(ctypes.c_float),
            ctypes.POINTER(ctypes.c_int64), ctypes.c_int64, ctypes.c_int32,
            ctypes.c_int32, ctypes.POINTER(ctypes.c_float),
            ctypes.POINTER(ctypes.c_int64),
        ]
        lib.tpua_hnsw_serialize_size.argtypes = [ctypes.c_void_p]
        lib.tpua_hnsw_serialize_size.restype = ctypes.c_int64
        lib.tpua_hnsw_serialize.argtypes = [ctypes.c_void_p, ctypes.c_char_p]
        lib.tpua_hnsw_deserialize.argtypes = [
            ctypes.c_char_p, ctypes.c_int64, ctypes.c_uint64,
        ]
        lib.tpua_hnsw_deserialize.restype = ctypes.c_void_p
        _LIB = lib
    except Exception:
        _LIB = None
    return _LIB


def native_available() -> bool:
    return _load() is not None


def lexical_counts(texts: List[str], terms: List[str]) -> Optional[np.ndarray]:
    """Substring-match counts per text; None if native lib unavailable."""
    lib = _load()
    if lib is None:
        return None
    enc_texts = [t.lower().encode("utf-8") for t in texts]
    enc_terms = [t.encode("utf-8") for t in terms]
    c_texts = (ctypes.c_char_p * len(enc_texts))(*enc_texts)
    c_terms = (ctypes.c_char_p * len(enc_terms))(*enc_terms)
    out = np.zeros(len(texts), dtype=np.int32)
    lib.tpua_lexical_counts(
        c_texts, len(enc_texts), c_terms, len(enc_terms),
        out.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
    )
    return out


class BpeCore:
    """Native greedy-merge BPE over symbol ids; None-safe factory below.

    The Python tokenizer precomputes merge triples as vocab ids
    (left, right, merged); per word it passes the initial byte-level symbol
    ids and gets the merged id sequence back (see
    tpualign_torch.tokenizer.bpe.ClipTokenizer).
    """

    def __init__(self, lefts, rights, merged):
        lib = _load()
        if lib is None:
            raise ImportError("native library unavailable")
        self._lib = lib
        l = np.ascontiguousarray(lefts, dtype=np.int32)
        r = np.ascontiguousarray(rights, dtype=np.int32)
        m = np.ascontiguousarray(merged, dtype=np.int32)
        self._handle = lib.tpua_bpe_create(
            l.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
            r.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
            m.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
            len(l),
        )

    def word(self, symbols) -> List[int]:
        buf = np.ascontiguousarray(symbols, dtype=np.int32)
        n = self._lib.tpua_bpe_word(
            self._handle,
            buf.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
            len(buf),
        )
        return buf[:n].tolist()

    def __del__(self):
        try:
            if getattr(self, "_handle", None):
                self._lib.tpua_bpe_destroy(self._handle)
        except Exception:
            pass


def make_bpe_core(lefts, rights, merged) -> Optional[BpeCore]:
    """BpeCore or None when the native library is unavailable."""
    try:
        return BpeCore(lefts, rights, merged)
    except ImportError:
        return None


class HnswCore:
    """Thin ctypes wrapper over the native HNSW graph (see
    tpualign_native.cpp for the algorithm and the pgvector-parity
    rationale). Vectors must be caller-normalized fp32; keys are the
    encoded (manual, page) int keys from
    :func:`tpualign_torch.parallel.retrieval.encode_keys`, widened to int64.
    Not thread-safe — callers serialize (HNSWIndex holds the lock)."""

    def __init__(self, dim: int, m: int, ef_construction: int, seed: int,
                 half: bool = False, _handle=None):
        lib = _load()
        if lib is None:
            raise ImportError("native library unavailable")
        self._lib = lib
        self.dim = int(dim)
        self._handle = _handle if _handle is not None else lib.tpua_hnsw_create(
            dim, m, ef_construction, seed, 1 if half else 0)
        if not self._handle:  # native side rejected the geometry
            raise ValueError(f"invalid HNSW geometry (dim={dim}, m={m})")

    def __len__(self) -> int:
        return int(self._lib.tpua_hnsw_count(self._handle))

    def live_count(self) -> int:
        return int(self._lib.tpua_hnsw_live_count(self._handle))

    def add(self, vecs: np.ndarray, keys: np.ndarray) -> int:
        vecs = np.ascontiguousarray(vecs, np.float32)
        keys = np.ascontiguousarray(keys, np.int64)
        return int(self._lib.tpua_hnsw_add(
            self._handle,
            vecs.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
            keys.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
            len(vecs),
        ))

    def mark_deleted(self, positions: np.ndarray) -> None:
        pos = np.ascontiguousarray(positions, np.int64)
        self._lib.tpua_hnsw_mark_deleted(
            self._handle,
            pos.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)), len(pos),
        )

    def search(self, queries: np.ndarray, qkeys: np.ndarray, k: int,
               ef: int) -> Tuple[np.ndarray, np.ndarray]:
        queries = np.ascontiguousarray(queries, np.float32)
        qkeys = np.ascontiguousarray(qkeys, np.int64)
        nq = len(queries)
        vals = np.empty((nq, k), np.float32)
        idx = np.empty((nq, k), np.int64)
        self._lib.tpua_hnsw_search(
            self._handle,
            queries.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
            qkeys.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
            nq, k, ef,
            vals.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
            idx.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
        )
        return vals, idx

    def serialized_size(self) -> int:
        """Blob size in bytes WITHOUT building the blob (an O(n) link
        walk; used for memory reporting in hot stats paths)."""
        return int(self._lib.tpua_hnsw_serialize_size(self._handle))

    def serialize(self) -> bytes:
        size = self.serialized_size()
        buf = ctypes.create_string_buffer(size)
        self._lib.tpua_hnsw_serialize(self._handle, buf)
        return buf.raw

    def __del__(self):
        try:
            if getattr(self, "_handle", None):
                self._lib.tpua_hnsw_destroy(self._handle)
        except Exception:
            pass


def make_hnsw_core(dim: int, m: int, ef_construction: int,
                   seed: int, half: bool = False) -> Optional[HnswCore]:
    """HnswCore or None when the native library is unavailable.
    ``half``: store fp16 graph entries (pgvector's halfvec analogue;
    half the host RAM, queries stay fp32)."""
    try:
        return HnswCore(dim, m, ef_construction, seed, half=half)
    except ImportError:
        return None


def load_hnsw_core(blob: bytes, dim: int, seed: int) -> Optional[HnswCore]:
    """Deserialize a core from :meth:`HnswCore.serialize` output; None
    when the native library is unavailable or the blob is corrupt."""
    lib = _load()
    if lib is None:
        return None
    handle = lib.tpua_hnsw_deserialize(blob, len(blob), seed)
    if not handle:
        return None
    return HnswCore(dim, 0, 0, seed, _handle=handle)


def topk_merge(
    vals: np.ndarray, idx: np.ndarray, k: int
) -> Optional[Tuple[np.ndarray, np.ndarray]]:
    """Merge (rows, cols) candidates into (rows, k) top-k; None if no native lib."""
    lib = _load()
    if lib is None:
        return None
    vals = np.ascontiguousarray(vals, dtype=np.float32)
    idx = np.ascontiguousarray(idx, dtype=np.int64)
    rows, cols = vals.shape
    out_vals = np.empty((rows, k), dtype=np.float32)
    out_idx = np.empty((rows, k), dtype=np.int64)
    lib.tpua_topk_merge(
        vals.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
        idx.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
        rows, cols, k,
        out_vals.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
        out_idx.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
    )
    return out_vals, out_idx
