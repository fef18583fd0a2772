"""HNSW index, the reference's primary pgvector index, on the host (the
port's copy of ``tpualign.parallel.hnsw``).

A graph walk branches on the data at every hop: CPU work, not the card's.
The graph lives in the native C++ core (``tpualign_torch/native``, the same
source as tpualign's, so the same inputs build a byte-equal graph), and
this wrapper gives it the surface of
:class:`~tpualign_torch.parallel.retrieval.RetrievalIndex` (``search``,
``search_encoded``, ``add``, ``remove``, ``compact``, ``save``/``load``).
Its artifact (``.npz``: the serialized graph, the keys, the tombstones and
a JSON meta) loads in either package.

Parameter defaults match pgvector's: ``m=16``, ``ef_construction=64``,
``ef_search=40``.

Filtered search (the same-manual+page restriction) runs a small query
planner, the way postgres picks a seq or an index plan by selectivity:

- **Selective keys** (live row count <= ``max(4k, ef_search)``: every
  same-page candidate set in this workload) take an exact scan over the
  key's rows: exact results at O(count·d) per query, where pgvector's
  WHERE + HNSW can return fewer than *k* rows under a selective filter.
- **Non-selective keys** walk the graph and post-filter by key
  (pgvector's strategy); a per-key live count detects any under-fill and
  finishes those queries with the exact scan, so keyed results always
  hold min(k, count) rows.

Wildcard (global) queries stay approximate at the configured
``ef_search``, as in pgvector.
"""

from __future__ import annotations

import hashlib
import json
import threading
from contextlib import contextmanager
from collections import Counter
from typing import Dict, Optional, Sequence, Tuple

import numpy as np

from tpualign_torch.native.bindings import load_hnsw_core, make_hnsw_core
from tpualign_torch.ops.similarity import NEG_INF, WILDCARD_KEY
from tpualign_torch.utils.logging import get_logger

log = get_logger("parallel.hnsw")

__all__ = ["HNSWIndex"]


def _normalize(rows: np.ndarray) -> np.ndarray:
    rows = np.asarray(rows, np.float32)
    if rows.size == 0:
        return rows.reshape(rows.shape)
    norms = np.linalg.norm(rows, axis=1, keepdims=True)
    return rows / np.maximum(norms, 1e-12)


class _RWLock:
    """Readers-writer lock (writer preference): searches take the read
    side and run CONCURRENTLY — the native core gives every in-flight
    search its own visited-set scratch and ctypes releases the GIL
    during the walk, so a multi-client daemon does not serialize every
    graph walk onto one core. Mutations
    (add/remove/compact) take the write side and exclude everything.
    Writer preference: once a writer is waiting, new readers queue
    behind it, so a steady search load cannot starve a DELETE."""

    def __init__(self):
        self._cond = threading.Condition()
        self._readers = 0
        self._writer = False
        self._writers_waiting = 0

    def acquire_read(self) -> None:
        with self._cond:
            while self._writer or self._writers_waiting:
                self._cond.wait()
            self._readers += 1

    def release_read(self) -> None:
        with self._cond:
            self._readers -= 1
            if self._readers == 0:
                self._cond.notify_all()

    def acquire_write(self) -> None:
        with self._cond:
            self._writers_waiting += 1
            try:
                while self._writer or self._readers:
                    self._cond.wait()
            finally:
                self._writers_waiting -= 1
            self._writer = True

    def release_write(self) -> None:
        with self._cond:
            self._writer = False
            self._cond.notify_all()

    @contextmanager
    def read(self):
        self.acquire_read()
        try:
            yield
        finally:
            self.release_read()

    @contextmanager
    def write(self):
        self.acquire_write()
        try:
            yield
        finally:
            self.release_write()


def _corpus_fingerprint(rows: np.ndarray) -> str:
    """Cheap content hash for cache validation: shape + strided sample.

    A stale on-disk graph silently serving an old corpus would be a
    correctness bug (the blob embeds its own vectors), so loads verify
    the passed corpus against this fingerprint.
    """
    h = hashlib.sha256()
    h.update(np.asarray(rows.shape, np.int64).tobytes())
    if len(rows):
        step = max(1, len(rows) // 64)
        h.update(np.ascontiguousarray(rows[::step], np.float32).tobytes())
    return h.hexdigest()


class HNSWIndex:
    """pgvector-HNSW equivalent over the native graph core.

    Same public surface as :class:`RetrievalIndex` (search /
    search_encoded / add / remove / save / load, ``n`` / ``dim`` /
    ``vocab`` / ``precision`` / ``mesh`` attributes) so the serving
    daemon, CLI, and evaluator drive it interchangeably. Host-side and
    single-process by design. ``precision``: "fp32" (pgvector's
    ``vector`` type) or "fp16" (its ``halfvec``) — fp16 halves the
    host RAM of both the graph entries and the exact-scan copy;
    queries stay fp32 and scores are fp32 dots against the rounded
    stored vectors, exactly halfvec's semantics.
    """

    mesh = None

    def __init__(
        self,
        corpus_embeddings: np.ndarray,
        corpus_manuals: Optional[Sequence[str]] = None,
        corpus_pages: Optional[Sequence[Optional[int]]] = None,
        m: int = 16,
        ef_construction: int = 64,
        ef_search: int = 40,
        seed: int = 0,
        refine: int = 0,
        precision: str = "fp32",
        _core=None,
        _vocab: Optional[Dict[str, int]] = None,
        _keys: Optional[np.ndarray] = None,
    ):
        from tpualign_torch.parallel.retrieval import encode_keys

        if precision not in ("fp32", "fp16"):
            raise ValueError(
                f"HNSW precision must be 'fp32' or 'fp16' (pgvector's "
                f"vector/halfvec); got {precision!r} — the int rungs "
                f"live on the exact/IVF device paths"
            )
        self.precision = precision
        self._dtype = np.float16 if precision == "fp16" else np.float32
        rows = np.asarray(corpus_embeddings, np.float32)
        if rows.ndim != 2:
            rows = rows.reshape(0, rows.shape[-1] if rows.size else 1)
        self.dim = int(rows.shape[1]) if rows.size else int(rows.shape[1] or 0)
        self.m = int(m)
        self.ef_construction = int(ef_construction)
        self.ef_search = int(ef_search)
        self.seed = int(seed)
        self.refine = int(refine)
        self._rw = _RWLock()

        if _core is not None:  # load() path: graph already built
            self._core = _core
            self.vocab = dict(_vocab or {})
            self._keys = np.asarray(_keys, np.int64)
            self._dead = np.zeros(len(self._keys), bool)
            # load() already normalized (and rounded to the stored
            # dtype); renormalizing is NOT bit-idempotent (unit norms
            # land at 1±eps), and a changed corpus would break the
            # fingerprint on save-after-load
            self._corpus = np.asarray(corpus_embeddings, self._dtype)
            self.n = len(self._keys)
        else:
            if corpus_manuals is not None:
                keys32, self.vocab = encode_keys(
                    corpus_manuals, corpus_pages, {})
                keys = keys32.astype(np.int64)
            else:
                self.vocab = {}
                keys = np.zeros(len(rows), np.int64)
            core = make_hnsw_core(self.dim, m, ef_construction, seed,
                                  half=precision == "fp16")
            if core is None:
                raise RuntimeError(
                    "RETRIEVAL_INDEX=hnsw needs the native library "
                    "(g++); build failed or unavailable — use 'exact' "
                    "or 'ivf'"
                )
            self._core = core
            normalized = _normalize(rows)
            self._corpus = normalized.astype(self._dtype)
            self._keys = keys
            self._dead = np.zeros(len(rows), bool)
            if len(rows):
                core.add(normalized, keys)
            self.n = len(rows)
        self._rebuild_key_counts()

    # -- bookkeeping -------------------------------------------------------------

    def _rebuild_key_counts(self) -> None:
        live = self._keys[~self._dead] if self.n else self._keys
        self._key_counts: Counter = Counter(live.tolist())

    @property
    def live(self) -> int:
        return int((~self._dead).sum())

    @property
    def dead(self) -> int:
        """Tombstoned rows awaiting :meth:`compact` (pgvector's dead
        tuples; /stats reports this so operators know when to VACUUM)."""
        return int(self._dead.sum())

    def memory_bytes(self) -> int:
        """Host-RAM footprint: the graph (vectors + links, sized
        without materializing the blob — /stats polls this) plus the
        scan copy used for exact filtered completion."""
        with self._rw.read():
            blob = self._core.serialized_size() if self.n else 0
        return blob + self._corpus.nbytes

    # -- mutation (pgvector INSERT/DELETE parity) ---------------------------------

    def add(
        self,
        embeddings: np.ndarray,
        manuals: Optional[Sequence[str]] = None,
        pages: Optional[Sequence[Optional[int]]] = None,
    ) -> None:
        """Incremental insert — HNSW's native operation (pgvector's
        index absorbs INSERTs without a rebuild). New rows get positions
        ``n..n+m-1``; new manual ids extend the vocab."""
        from tpualign_torch.parallel.retrieval import encode_keys

        rows = np.asarray(embeddings, np.float32)
        if rows.ndim != 2:
            raise ValueError(f"embeddings must be (M, D); got {rows.shape}")
        if len(rows) == 0:
            return
        if self.n and rows.shape[1] != self.dim:
            raise ValueError(
                f"embedding dim {rows.shape[1]} != index dim {self.dim}")
        if manuals is not None:
            keys32, _ = encode_keys(manuals, pages, self.vocab)  # extends
            keys = keys32.astype(np.int64)
        else:
            keys = np.zeros(len(rows), np.int64)
        rows = _normalize(rows)
        stored = rows.astype(self._dtype)
        with self._rw.write():
            if self.n == 0 and self.dim != rows.shape[1]:
                # empty-index bootstrap: adopt the first batch's dim
                self.dim = int(rows.shape[1])
                self._core = make_hnsw_core(
                    self.dim, self.m, self.ef_construction, self.seed,
                    half=self.precision == "fp16")
                self._corpus = stored
            else:
                self._corpus = (stored if self.n == 0 else
                                np.concatenate([self._corpus, stored]))
            self._core.add(rows, keys)
            self._keys = np.concatenate([self._keys, keys])
            self._dead = np.concatenate(
                [self._dead, np.zeros(len(rows), bool)])
            self.n += len(rows)
            self._key_counts.update(keys.tolist())

    def remove(self, corpus_indices) -> int:
        """Tombstone rows by position (pgvector DELETE parity): removed
        rows stop matching immediately but stay traversable in the graph
        (the standard HNSW delete — cutting nodes would tear navigation
        paths; pgvector likewise keeps dead tuples until VACUUM).
        Returns the number newly tombstoned."""
        idx = np.unique(np.asarray(corpus_indices, np.int64))
        idx = idx[(idx >= 0) & (idx < self.n)]
        if idx.size == 0:
            return 0
        with self._rw.write():
            fresh = idx[~self._dead[idx]]
            if fresh.size == 0:
                return 0
            self._core.mark_deleted(fresh)
            self._dead[fresh] = True
            self._key_counts.subtract(self._keys[fresh].tolist())
        return int(fresh.size)

    def __copy__(self):
        """Shallow copy with a PRIVATE readers-writer lock: the serving
        layer compacts on a copy so in-flight searches keep the old
        snapshot — sharing the lock would make the copy's whole-graph
        rebuild block every reader of the original. The native core and
        row arrays are still shared (compact() replaces them with fresh
        ones on the copy; mutating BOTH objects through add()/remove()
        is outside the snapshot discipline)."""
        new = object.__new__(type(self))
        new.__dict__.update(self.__dict__)
        new._rw = _RWLock()
        return new

    def compact(self) -> np.ndarray:
        """Reclaim tombstoned rows — pgvector's VACUUM analogue for the
        HNSW rung: dead nodes stay traversable in the graph (they cost
        memory AND hop budget) until the graph is rewritten over the
        survivors, exactly like pgvector's dead index tuples. Rebuilds
        the native graph from live rows only (HNSW has no cheaper
        reclamation — deleting nodes tears navigation paths), renumbers
        survivors ``0..L-1`` in ascending old order, and returns the
        surviving old positions for the caller to remap id-aligned
        state. Stored-precision rows move untouched (fp16 entries stay
        fp16-rounded)."""
        with self._rw.write():
            live = np.flatnonzero(~self._dead).astype(np.int64)
            if live.size == self.n:
                return live  # nothing dead — keep the existing graph
            stored = self._corpus[live]
            keys = self._keys[live]
            # a fresh core even when everything died: the old graph's
            # node positions would misalign a later add()
            core = make_hnsw_core(
                self.dim, self.m, self.ef_construction, self.seed,
                half=self.precision == "fp16")
            if live.size:
                core.add(stored.astype(np.float32), keys)
            self._core = core
            self._corpus = stored
            self._keys = keys
            self._dead = np.zeros(live.size, bool)
            self.n = int(live.size)
            self._rebuild_key_counts()
        return live

    # -- search ------------------------------------------------------------------

    def search(
        self,
        query_embeddings: np.ndarray,
        query_manuals: Optional[Sequence[str]] = None,
        query_pages: Optional[Sequence[Optional[int]]] = None,
        k: int = 10,
        strategy: str = "auto",
        global_search: bool = False,
    ) -> Tuple[np.ndarray, np.ndarray]:
        """Top-k per query (values, corpus positions); same contract as
        :meth:`RetrievalIndex.search`, ``strategy`` ignored (host graph
        walk is the only strategy)."""
        from tpualign_torch.parallel.retrieval import encode_keys

        queries = np.asarray(query_embeddings, np.float32)
        if global_search or query_manuals is None:
            qk = np.full(len(queries), WILDCARD_KEY, np.int64)
        else:
            qk32, _ = encode_keys(query_manuals, query_pages,
                                  dict(self.vocab))
            qk = qk32.astype(np.int64)
        return self.search_encoded(queries, qk, k)

    def search_encoded(
        self, queries: np.ndarray, qk: np.ndarray, k: int,
        strategy: str = "auto",
        ef: Optional[int] = None,
    ) -> Tuple[np.ndarray, np.ndarray]:
        """Host-array search with pre-encoded keys (the serving
        coalescer's level). Results: similarity desc, position asc on
        ties, ``-1`` / ``NEG_INF`` padding — the device paths'
        contract. ``ef`` overrides the instance beam width for one call
        (the calibration ladder's hook)."""
        queries = _normalize(queries)
        qk = np.asarray(qk, np.int64)
        nq = len(queries)
        if nq == 0 or self.n == 0 or k <= 0:
            return (np.full((nq, max(k, 0)), NEG_INF, np.float32),
                    np.full((nq, max(k, 0)), -1, np.int64))
        kf = min(max(k, k * max(self.refine, 1)), self.n)
        ef = max(self.ef_search if ef is None else int(ef), kf)
        cutoff = max(4 * kf, self.ef_search)

        def _exact_keyed(i: int, key: int) -> None:
            rows = np.flatnonzero((self._keys == key) & ~self._dead)
            if rows.size == 0:
                return
            # fp16 corpora upcast the (small) selected slice: scores are
            # fp32 dots over the rounded stored vectors, matching the
            # graph walk's arithmetic
            sims = (self._corpus[rows].astype(np.float32, copy=False)
                    @ queries[i])
            take = np.lexsort((rows, -sims))[:kf]
            idx[i, : len(take)] = rows[take]
            vals[i, : len(take)] = sims[take]

        with self._rw.read():
            # plan per query, postgres-style: selective keys take the
            # exact scan (cheap + EXACT); everything else walks the graph
            counts = np.array(
                [self._key_counts.get(int(key), 0) for key in qk], np.int64)
            keyed = qk != WILDCARD_KEY
            exact_plan = keyed & (counts <= cutoff)
            graph_plan = np.flatnonzero(~exact_plan)
            vals = np.full((nq, kf), NEG_INF, np.float32)
            idx = np.full((nq, kf), -1, np.int64)
            if graph_plan.size:
                gvals, gidx = self._core.search(
                    queries[graph_plan], qk[graph_plan], kf, ef)
                vals[graph_plan] = gvals
                idx[graph_plan] = gidx
            for i in np.flatnonzero(exact_plan):
                _exact_keyed(i, int(qk[i]))
            # under-fill insurance for non-selective keyed queries: a
            # beam that found fewer matches than the per-key live count
            # promises gets finished exactly (rare — a huge key almost
            # always fills the beam)
            for i in graph_plan:
                key = int(qk[i])
                if key == WILDCARD_KEY:
                    continue
                if int((idx[i] >= 0).sum()) < min(kf, counts[i]):
                    idx[i] = -1
                    vals[i] = NEG_INF
                    _exact_keyed(i, key)
        if kf > k:  # refine over-fetch: scores are already exact, trim
            vals, idx = vals[:, :k], idx[:, :k]
        return vals, idx

    # -- calibration ---------------------------------------------------------------

    # pgvector caps hnsw.ef_search at 1000; same ceiling here so the
    # ladder can't degenerate into a full scan (use 'exact' for that).
    EF_MAX = 1000

    def calibrate(self, recall_target: float, k: int = 10,
                  sample: int = 128) -> int:
        """Pick the smallest ``ef_search`` whose measured recall@k meets
        ``recall_target``, and set it as the default. pgvector makes the
        user guess ``hnsw.ef_search``; this measures it:
        a doubling ef ladder over a deterministic in-corpus sample of
        wildcard queries, scored against the exact brute-force top-k of
        the live rows (the same protocol as :meth:`IVFIndex.calibrate`,
        but empirical — graph recall has no closed form). Unlike IVF's
        analytic pass this walks the graph once per rung, which is cheap
        (S·ef·log n distance evals); the exact ground truth is the
        O(S·n·d) term, done once.

        If the target is unreachable at ``EF_MAX`` (uniform random
        high-d corpora — the known proximity-graph worst case), the cap
        is kept and the achieved recall logged; callers wanting exact
        guarantees should use the 'exact' index. Returns the chosen ef.
        """
        if not 0.0 < recall_target <= 1.0:
            raise ValueError(f"recall_target in (0, 1], got {recall_target}")
        live_pos = np.flatnonzero(~self._dead)
        n_live = live_pos.size
        if n_live == 0:
            return self.ef_search
        s = min(int(sample), n_live)
        sel = live_pos[(np.arange(s, dtype=np.int64) * n_live) // s]
        q = self._corpus[sel].astype(np.float32, copy=False)
        kk = min(k, n_live)
        # exact ground truth over live rows, blockwise so an fp16
        # corpus never upcasts whole (argpartition: ties across the
        # k-th boundary shift measured recall by <1/k, irrelevant for
        # picking an ef rung)
        sims = np.empty((s, n_live), np.float32)
        for lo in range(0, n_live, 65536):
            block = live_pos[lo:lo + 65536]
            sims[:, lo:lo + len(block)] = (
                q @ self._corpus[block].astype(np.float32, copy=False).T)
        part = np.argpartition(-sims, kk - 1, axis=1)[:, :kk]
        truth = [set(live_pos[row].tolist()) for row in part]
        qk = np.full(s, WILDCARD_KEY, np.int64)
        # Ladder restarts from pgvector's default, NOT the instance ef:
        # a recalibration after the target was LOWERED must be able to
        # come back down (the instance ef may hold a previous, larger
        # calibration loaded from the cache).
        ef, achieved = max(kk, min(40, self.EF_MAX)), 0.0
        while True:
            _, idx = self.search_encoded(q, qk, kk, ef=ef)
            achieved = float(np.mean(
                [len(truth[i] & set(idx[i].tolist())) / kk
                 for i in range(s)]))
            if achieved >= recall_target or ef >= self.EF_MAX:
                break
            ef = min(ef * 2, self.EF_MAX)
        if achieved < recall_target:
            log.warning(
                "HNSW calibration: recall@%d %.4f at the ef cap %d — "
                "target %.3f unreachable on this corpus (graph-hostile "
                "geometry); use RETRIEVAL_INDEX=exact for guarantees",
                kk, achieved, ef, recall_target,
            )
        else:
            log.info(
                "HNSW calibration: ef_search=%d reaches recall@%d %.4f "
                "(target %.3f, %d sample queries)",
                ef, kk, achieved, recall_target, s,
            )
        self.ef_search = int(ef)
        self.calibrated_target = float(recall_target)
        return int(ef)

    # -- persistence (pgvector's on-disk index analogue) --------------------------

    def save(self, path) -> None:
        """Persist the graph + metadata; ``load`` verifies the corpus
        fingerprint so a stale file can never serve old vectors."""
        with self._rw.read():
            blob = np.frombuffer(self._core.serialize(), np.uint8)
            meta = json.dumps({
                "dim": self.dim, "m": self.m,
                "ef_construction": self.ef_construction,
                "ef_search": self.ef_search, "seed": self.seed,
                "n": self.n, "vocab": self.vocab,
                "precision": self.precision,
                "fingerprint": _corpus_fingerprint(self._corpus),
                "calibrated_target": getattr(self, "calibrated_target",
                                             None),
            })
            np.savez_compressed(
                path, blob=blob, meta=np.frombuffer(
                    meta.encode("utf-8"), np.uint8),
                keys=self._keys, dead=self._dead,
            )

    @classmethod
    def load(cls, path, corpus_embeddings: np.ndarray,
             ef_search: Optional[int] = None, refine: int = 0):
        """Rehydrate from :meth:`save`; raises ``ValueError`` when the
        file does not match the passed corpus (the caller rebuilds)."""
        with np.load(path) as z:
            meta = json.loads(bytes(z["meta"]).decode("utf-8"))
            blob = bytes(z["blob"])
            keys = z["keys"]
            dead = z["dead"]
        precision = meta.get("precision", "fp32")
        rows = _normalize(np.asarray(corpus_embeddings, np.float32))
        if precision == "fp16":
            # the cache fingerprints the fp16-ROUNDED corpus (that is
            # what it stores); round the same way before comparing
            rows = rows.astype(np.float16)
        if meta["n"] != len(rows) or meta["dim"] != rows.shape[1]:
            raise ValueError(
                f"HNSW cache holds n={meta['n']} dim={meta['dim']}, "
                f"corpus is n={len(rows)} dim={rows.shape[1]}")
        if meta["fingerprint"] != _corpus_fingerprint(rows):
            raise ValueError("HNSW cache fingerprint does not match the "
                             "corpus; rebuilding")
        core = load_hnsw_core(blob, meta["dim"], meta["seed"])
        if core is None:
            raise ValueError("HNSW cache blob unreadable (or native "
                             "library unavailable)")
        index = cls(
            rows, m=meta["m"], ef_construction=meta["ef_construction"],
            ef_search=int(ef_search if ef_search is not None
                          else meta["ef_search"]),
            seed=meta["seed"], refine=refine, precision=precision,
            _core=core, _vocab=meta["vocab"], _keys=keys,
        )
        index._dead = np.asarray(dead, bool)
        index._rebuild_key_counts()
        if meta.get("calibrated_target") is not None and ef_search is None:
            index.calibrated_target = meta["calibrated_target"]
        return index
