"""Persistent retrieval serving daemon (the query half of
``tpualign.serving.server``).

The corpus stays resident on the GPU inside a long-lived process
(:class:`~tpualign_torch.parallel.retrieval.RetrievalIndex`, or
:class:`~tpualign_torch.parallel.ivf.IVFIndex` under
``RETRIEVAL_INDEX=ivf``) behind a
dependency-free JSON/HTTP front (stdlib ``http.server``), with tpualign's
endpoints and transport limits:

- ``GET /healthz`` (auth-exempt) and ``GET /stats``;
- ``POST /search``: raw embeddings, keyed to (manual, page) or global;
- ``POST /search_image``: stored image ids, keyed to their page, with an
  optional ``rerank`` alpha that blends weak-supervision scores in;
- ``POST /search_image_bytes``: base64 PNG/JPEG, decoded and preprocessed
  on the host, then encoded by the image tower;
- ``POST /search_text``: encoded by the text tower, with an LRU cache.

Concurrent requests coalesce: :class:`BatchCoalescer` merges searches and
:class:`TextEncodeCoalescer` text encodes into one device dispatch each.
The mutating routes (``/add``, ``/remove``, ``/sync``, ``/compact``,
``/reload``) belong to a later slice of the port and answer 501.

Threads and the card: the handler runs one thread per connection and a
coalescer's leader runs its batch on whichever thread leads. Every kernel
launches on the device's current stream, so tower encodes and searches
from different threads queue in one order on the card, and each result is
copied to the host (which waits for it) before it is formatted.
"""

from __future__ import annotations

import json
import threading
import time
from collections import OrderedDict, deque
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Callable, Dict, List, Optional, Sequence

import numpy as np

from tpualign_torch.parallel.retrieval import WILDCARD_KEY, build_index, encode_keys
from tpualign_torch.store import EmbeddingStore
from tpualign_torch.utils.logging import get_logger
from tpualign_torch.weaksup.rerank import build_weak_lookup, rerank_with_weak_scores

log = get_logger("serving")

__all__ = ["RetrievalService", "BatchCoalescer", "TextEncodeCoalescer", "RequestMetrics",
           "build_index_artifact", "build_service", "index_kwargs", "make_image_bytes_encoder",
           "schema_cache_path", "serve", "serve_schemas"]

_LATER = "not yet ported to tpualign_torch (the index-mutation slice)"


class RequestMetrics:
    """Thread-safe request counters and a bounded latency window, exposed
    at ``GET /stats``."""

    def __init__(self, window: int = 2048):
        self._lock = threading.Lock()
        self._lat = deque(maxlen=window)
        self.requests: dict = {}
        self.queries_total = 0
        self.errors = 0

    def record(self, endpoint: str, n_queries: int, seconds: float) -> None:
        with self._lock:
            self.requests[endpoint] = self.requests.get(endpoint, 0) + 1
            self.queries_total += n_queries
            self._lat.append(seconds)

    def record_error(self) -> None:
        with self._lock:
            self.errors += 1

    def snapshot(self) -> dict:
        with self._lock:
            lats = sorted(self._lat)
            n = len(lats)

            def pct(p: float):
                if not n:
                    return None
                return round(lats[min(n - 1, int(p * n))] * 1e3, 3)

            return {
                "requests": dict(self.requests),
                "queries_total": self.queries_total,
                "errors": self.errors,
                "latency_ms": {"p50": pct(0.5), "p95": pct(0.95), "p99": pct(0.99),
                               "window": n},
            }


class _LeaderFollowerBatcher:
    """Leader/follower batching core.

    The first request in becomes the leader, collects followers for
    ``window_ms``, then dispatches ONE batched call. At most ``pipeline``
    dispatches run at once; while they run, the next batch keeps filling
    (a batch stays open until its leader holds a dispatch slot).
    Backpressure: a batch never exceeds ``max_batch`` rows (excess rolls
    into the next batch) and at most ``max_queue`` rows wait across
    batches; beyond that callers get RuntimeError.

    Subclasses implement ``_dispatch(items) -> results`` (items in arrival
    order); callers slice their rows from the row-aligned results.
    """

    def __init__(self, window_ms: float = 2.0, max_batch: int = 256, max_queue: int = 4096,
                 pipeline: int = 2):
        self.window_s = max(0.0, float(window_ms)) / 1e3
        self.max_batch = int(max_batch)
        self.max_queue = int(max_queue)
        self._lock = threading.Lock()
        self._dispatch_sem = threading.BoundedSemaphore(max(1, int(pipeline)))
        self._open = None
        self._queued_rows = 0
        self.dispatches = 0
        self.batched_queries = 0

    class _Batch:
        __slots__ = ("items", "rows", "done", "results", "error")

        def __init__(self):
            self.items = []
            self.rows = 0
            self.done = threading.Event()
            self.results = None
            self.error = None

    def _dispatch(self, items):  # pragma: no cover - abstract
        raise NotImplementedError

    def _run(self, item, n: int):
        """Join or lead a batch; returns (row-aligned results, my row start)."""
        with self._lock:
            if self._queued_rows + n > self.max_queue:
                raise RuntimeError(f"request queue full ({self._queued_rows} rows waiting); "
                                   f"retry later")
            batch = self._open
            leader = batch is None or batch.rows + n > self.max_batch
            if leader:
                batch = self._open = self._Batch()
            start = batch.rows
            batch.items.append(item)
            batch.rows += n
            self._queued_rows += n

        if leader:
            if self.window_s:
                time.sleep(self.window_s)
            self._dispatch_sem.acquire()
            try:
                with self._lock:
                    if self._open is batch:
                        self._open = None
                    self._queued_rows -= batch.rows
                try:
                    batch.results = self._dispatch(batch.items)
                    with self._lock:
                        self.dispatches += 1
                        self.batched_queries += batch.rows
                except Exception as e:  # surfaced to every waiter
                    batch.error = e
                batch.done.set()
            finally:
                self._dispatch_sem.release()
        elif not batch.done.wait(timeout=60.0):
            raise RuntimeError("coalesced dispatch timed out")
        if batch.error is not None:
            raise batch.error
        return batch.results, start

    def stats(self) -> dict:
        d = max(1, self.dispatches)
        return {"dispatches": self.dispatches, "batched_queries": self.batched_queries,
                "avg_batch": round(self.batched_queries / d, 2),
                "window_ms": self.window_s * 1e3}


class BatchCoalescer(_LeaderFollowerBatcher):
    """Coalesces retrieval searches. Requests may carry different ``k``: the
    batch searches max(k) once and each caller trims its rows."""

    def __init__(self, search_fn, window_ms: float = 2.0, max_batch: int = 256,
                 max_queue: int = 4096, pipeline: int = 4):
        super().__init__(window_ms, max_batch, max_queue, pipeline)
        self._search_fn = search_fn

    def _dispatch(self, items):
        embs, keys, ks = zip(*items)
        q = np.concatenate(embs)
        qk = np.concatenate(keys)
        # pad to a power-of-two row count, as tpualign does for its compiled
        # shapes; padding rows carry key -2 (matches nothing)
        n = len(q)
        n_pad = 8
        while n_pad < n:
            n_pad *= 2
        if n_pad > n:
            q = np.concatenate([q, np.zeros((n_pad - n, q.shape[1]), np.float32)])
            qk = np.concatenate([qk, np.full(n_pad - n, -2, np.int32)])
        vals, idx = self._search_fn(q, qk, max(ks))
        return vals[:n], idx[:n]

    def search(self, embeddings: np.ndarray, keys: np.ndarray, k: int):
        """(n, D) queries + encoded keys -> (vals, idx) host arrays (n, k)."""
        n = len(embeddings)
        item = (np.asarray(embeddings, np.float32), np.asarray(keys, np.int32), int(k))
        (vals, idx), start = self._run(item, n)
        return vals[start:start + n, :k], idx[start:start + n, :k]


class TextEncodeCoalescer(_LeaderFollowerBatcher):
    """Coalesces text-tower encodes: concurrent /search_text requests pay
    one bucketed encode dispatch instead of one each."""

    def __init__(self, encode_fn, window_ms: float = 2.0, max_batch: int = 256,
                 max_queue: int = 4096, pipeline: int = 4):
        super().__init__(window_ms, max_batch, max_queue, pipeline)
        self._encode_fn = encode_fn

    def _dispatch(self, items):
        flat: List[str] = [t for ts in items for t in ts]
        return np.asarray(self._encode_fn(flat), np.float32)

    def encode(self, texts: List[str]) -> np.ndarray:
        out, start = self._run(list(texts), len(texts))
        return out[start:start + len(texts)]


class _CorpusSnapshot:
    """One consistent (index, chunk_ids, coalescer) view of the served
    corpus: a request captures it once, and dispatch and format use that
    capture."""

    __slots__ = ("index", "chunk_ids", "coalescer")

    def __init__(self, index, chunk_ids, coalescer):
        self.index = index
        self.chunk_ids = chunk_ids
        self.coalescer = coalescer


class RetrievalService:
    """Device-resident retrieval over one schema's chunk corpus."""

    def __init__(
        self,
        chunk_embeddings: np.ndarray,
        chunk_ids: Sequence[str],
        chunk_manuals: Sequence[str],
        chunk_pages: Sequence[Optional[int]],
        schema: str = "vanilla_clip",
        mesh=None,
        text_encoder: Optional[Callable[[List[str]], np.ndarray]] = None,
        image_encoder: Optional[Callable[[Sequence[bytes]], np.ndarray]] = None,
        images: Optional[Sequence[dict]] = None,
        image_embeddings: Optional[np.ndarray] = None,
        weak_lookup: Optional[dict] = None,
        recall_target: Optional[float] = None,
        coalesce_window_ms: Optional[float] = 2.0,
        index_type: str = "exact",
        ivf_lists: Optional[int] = None,
        ivf_probes: Optional[int] = None,
        precision: str = "fp32",
        ivf_cache: Optional[str] = None,
        refine: int = 0,
        refine_store=None,
        query_cache: int = 1024,
        model_info: Optional[dict] = None,
        hnsw_m: int = 16,
        hnsw_ef_construction: int = 64,
        hnsw_ef_search: Optional[int] = None,
        hnsw_cache: Optional[str] = None,
        auto_compact: Optional[float] = None,
        device="cuda",
    ):
        self.schema = schema
        self.metrics = RequestMetrics()
        self.model_info = model_info
        # text-query LRU keyed on (text, manual, page, k, global)
        self._qc_cap = int(query_cache)
        self._query_cache: "OrderedDict" = OrderedDict()
        self._qc_lock = threading.Lock()
        self._qc_hits = 0
        self._qc_misses = 0
        index = build_index(
            chunk_embeddings, chunk_manuals, chunk_pages, mesh=mesh,
            recall_target=recall_target, index_type=index_type, ivf_lists=ivf_lists,
            ivf_probes=ivf_probes, precision=precision, ivf_cache=ivf_cache, refine=refine,
            refine_store=refine_store, hnsw_m=hnsw_m, hnsw_ef_construction=hnsw_ef_construction,
            hnsw_ef_search=hnsw_ef_search, hnsw_cache=hnsw_cache, device=device,
        )
        self._coalesce_window_ms = coalesce_window_ms
        coalescer = (BatchCoalescer(index.search_encoded, window_ms=coalesce_window_ms)
                     if coalesce_window_ms is not None else None)
        self._snap = _CorpusSnapshot(index, list(chunk_ids), coalescer)
        self._encode_coalescer = (
            TextEncodeCoalescer(text_encoder, window_ms=coalesce_window_ms)
            if (coalesce_window_ms is not None and text_encoder is not None) else None)
        self.text_encoder = text_encoder
        self.image_encoder = image_encoder
        self._images = {img["image_id"]: i for i, img in enumerate(images or [])}
        self._image_meta = list(images or [])
        self._image_embs = (np.asarray(image_embeddings, np.float32)
                            if image_embeddings is not None else None)
        self.weak_lookup = weak_lookup or {}
        # tpualign's autovacuum threshold; compaction is a later slice here
        self.auto_compact = auto_compact

    @property
    def index(self):
        return self._snap.index

    @property
    def chunk_ids(self):
        return self._snap.chunk_ids

    @property
    def coalescer(self):
        return self._snap.coalescer

    # -- mutations: a later slice ----------------------------------------------------

    def add_chunks(self, chunk_ids, manuals, pages, embeddings) -> dict:
        raise NotImplementedError(f"adding chunks to a served index is {_LATER}")

    def remove_chunks(self, chunk_ids: Sequence[str]) -> dict:
        raise NotImplementedError(f"removing chunks from a served index is {_LATER}")

    def compact(self) -> dict:
        raise NotImplementedError(f"compacting a served index is {_LATER}")

    # -- queries ---------------------------------------------------------------------

    def _format(self, snap: _CorpusSnapshot, vals, idx) -> List[List[dict]]:
        """Winners as (chunk_id, score) rows against the snapshot that
        produced them."""
        chunk_ids = snap.chunk_ids
        out: List[List[dict]] = []
        for r in range(len(vals)):
            row = []
            for v, j in zip(vals[r], idx[r]):
                if j < 0:
                    break
                row.append({"chunk_id": chunk_ids[j], "score": float(v)})
            out.append(row)
        return out

    def search_embeddings(
        self,
        embeddings: np.ndarray,
        manuals: Optional[Sequence[str]],
        pages: Optional[Sequence[Optional[int]]],
        k: int = 10,
        global_search: bool = False,
    ) -> List[List[dict]]:
        embeddings = np.asarray(embeddings, np.float32)
        if embeddings.ndim == 1:
            embeddings = embeddings[None]
        snap = self._snap  # ONE capture: dispatch + format agree
        vals, idx = self._search_keyed(snap, embeddings, manuals, pages, k,
                                       global_search or manuals is None)
        return self._format(snap, vals, idx)

    def _search_keyed(self, snap: _CorpusSnapshot, embeddings, manuals, pages, k,
                      global_search):
        """Index search against ``snap``, through its coalescer when enabled."""
        if snap.coalescer is None:
            return snap.index.search(embeddings, manuals, pages, k,
                                     global_search=global_search)
        if global_search or manuals is None:
            qk = np.full(len(embeddings), WILDCARD_KEY, np.int32)
        else:
            qk, _ = encode_keys(manuals, pages, dict(snap.index.vocab))
        return snap.coalescer.search(embeddings, qk, k)

    def search_images(
        self,
        image_ids: Sequence[str],
        k: int = 10,
        rerank_alpha: Optional[float] = None,
        global_search: bool = False,
    ) -> List[List[dict]]:
        """Top chunks for STORED images, with optional weak-supervision
        reranking: combined = (1-alpha)*cosine + alpha*weak_score."""
        if self._image_embs is None:
            raise RuntimeError("service built without image embeddings")
        unknown = [i for i in image_ids if i not in self._images]
        if unknown:
            raise KeyError(f"unknown image ids: {unknown[:5]}")
        rows = [self._images[i] for i in image_ids]
        embs = self._image_embs[rows]
        manuals = [self._image_meta[r]["manual_id"] for r in rows]
        pages = [self._image_meta[r].get("page") for r in rows]
        snap = self._snap
        vals, idx = self._search_keyed(snap, embs, manuals, pages, k, global_search)
        if rerank_alpha is not None:
            vals, idx = rerank_with_weak_scores(vals, idx, list(image_ids), snap.chunk_ids,
                                                self.weak_lookup, alpha=rerank_alpha)
        return self._format(snap, vals, idx)

    def search_image_bytes(
        self,
        images: Sequence[bytes],
        manual: Optional[str] = None,
        page: Optional[int] = None,
        k: int = 10,
        global_search: bool = True,
    ) -> List[List[dict]]:
        """Top chunks for NEW images given as encoded bytes (PNG/JPEG):
        decode and preprocess on the host, encode on the image tower,
        search."""
        if self.image_encoder is None:
            raise RuntimeError("no image encoder loaded (serve --no-text-tower?)")
        q = np.asarray(self.image_encoder(list(images)), np.float32)
        manuals = None if global_search else [manual] * len(q)
        pages = None if global_search else [page] * len(q)
        return self.search_embeddings(q, manuals, pages, k, global_search)

    def search_text(
        self,
        texts: List[str],
        manual: Optional[str] = None,
        page: Optional[int] = None,
        k: int = 10,
        global_search: bool = True,
    ) -> List[List[dict]]:
        if self.text_encoder is None:
            raise RuntimeError("no text encoder loaded (serve --no-text-tower?)")

        def run(batch: List[str]) -> List[List[dict]]:
            if self._encode_coalescer is not None:
                q = self._encode_coalescer.encode(list(batch))
            else:
                q = np.asarray(self.text_encoder(list(batch)), np.float32)
            manuals = None if global_search else [manual] * len(batch)
            pages = None if global_search else [page] * len(batch)
            return self.search_embeddings(q, manuals, pages, k, global_search)

        if self._qc_cap <= 0:
            return run(list(texts))

        keys = [(t, manual, page, k, global_search) for t in texts]
        results: List[Optional[List[dict]]] = [None] * len(texts)
        misses: List[int] = []
        with self._qc_lock:
            for i, key in enumerate(keys):
                hit = self._query_cache.get(key)
                if hit is not None:
                    self._query_cache.move_to_end(key)
                    self._qc_hits += 1
                    results[i] = [dict(r) for r in hit]  # callers can't mutate the cache
                else:
                    self._qc_misses += 1
                    misses.append(i)
        if misses:
            fresh = run([texts[i] for i in misses])
            with self._qc_lock:
                for i, res in zip(misses, fresh):
                    results[i] = res
                    self._query_cache[keys[i]] = [dict(r) for r in res]
                while len(self._query_cache) > self._qc_cap:
                    self._query_cache.popitem(last=False)
        return results  # type: ignore[return-value]

    def stats(self) -> dict:
        rc = self.index._refine_corpus
        out = {
            "status": "ok",
            "schema": self.schema,
            "corpus_size": self.index.n,
            "dim": self.index.dim,
            "text_search": self.text_encoder is not None,
            "image_search": self._image_embs is not None,
            "image_query": self.image_encoder is not None,
            "num_images": len(self._image_meta),
            "mesh": None,
            "index": type(self.index).__name__,
            "precision": self.index.precision,
            "refine": self.index.refine,
            "refine_store": ({"mode": rc.mode, "rows": len(rc),
                              "resident_bytes": rc.nbytes_resident}
                             if rc is not None else None),
            "dead_rows": 0,  # no tombstones until the index-mutation slice
            "auto_compact": self.auto_compact,
        }
        if hasattr(self.index, "n_lists"):  # IVF geometry
            out["ivf"] = {
                "n_lists": self.index.n_lists,
                "n_probes": self.index.n_probes,
                "capacity": self.index.capacity,
                "spill": self.index.spill,
                "precision": self.index.precision,
                "calibrated_target": getattr(self.index, "calibrated_target", None),
            }
        if self.coalescer is not None:
            out["coalescer"] = self.coalescer.stats()
        if self._encode_coalescer is not None:
            out["encode_coalescer"] = self._encode_coalescer.stats()
        if self._qc_cap > 0:
            with self._qc_lock:
                out["query_cache"] = {"size": len(self._query_cache), "capacity": self._qc_cap,
                                      "hits": self._qc_hits, "misses": self._qc_misses}
        if self.model_info:
            out["model"] = self.model_info
        return out


def schema_cache_path(path: Optional[str], schema: str) -> Optional[str]:
    """Namespace an index-cache path by schema, inserting it before the
    extension (``g.hnsw.npz`` -> ``g.hnsw.<schema>.npz``); paths already
    naming the schema pass through."""
    if not path:
        return path
    import os

    base = os.path.basename(path)
    if schema in base:
        return path
    root, ext = os.path.splitext(base)
    new = f"{root}.{schema}{ext}" if ext else f"{base}.{schema}"
    return os.path.join(os.path.dirname(path), new)


def index_kwargs(config, schema: str) -> dict:
    """The config -> :func:`build_index` kwargs, assembled once for
    ``build_service`` and the CLI's one-shot query."""
    return dict(
        recall_target=getattr(config, "retrieval_recall_target", None),
        index_type=getattr(config, "retrieval_index", "exact"),
        ivf_lists=getattr(config, "ivf_lists", None),
        ivf_probes=getattr(config, "ivf_probes", None),
        precision=getattr(config, "retrieval_precision", "fp32"),
        ivf_cache=schema_cache_path(getattr(config, "ivf_cache", None), schema),
        refine=getattr(config, "retrieval_refine", 0),
        refine_store=getattr(config, "retrieval_refine_store", None),
        hnsw_m=getattr(config, "hnsw_m", 16),
        hnsw_ef_construction=getattr(config, "hnsw_ef_construction", 64),
        hnsw_ef_search=getattr(config, "hnsw_ef_search", None),
        hnsw_cache=schema_cache_path(getattr(config, "hnsw_cache", None), schema),
    )


def build_index_artifact(config, schema: str, cache_path: str,
                         index_type: Optional[str] = None, device="cuda"):
    """The offline index build of ``tpualign_torch index``: the configured
    ``RETRIEVAL_INDEX`` over the schema's chunk corpus, built (k-means, and
    probe calibration when ``RETRIEVAL_RECALL_TARGET`` is set) or loaded
    when a matching artifact exists, and saved to ``cache_path``, where
    ``serve`` and ``query`` find it through ``IVF_CACHE``. ``exact`` has no
    artifact and builds the IVF one, as tpualign does."""
    if index_type is None:
        index_type = getattr(config, "retrieval_index", "exact")
    if index_type == "exact":
        index_type = "ivf"
    store = EmbeddingStore(config.store.root, embed_dim=config.model.variant.embed_dim)
    if not store.has_embeddings(schema):
        raise ValueError(f"schema {schema} has no embeddings in {config.store.root}")
    _, chunk_emb = store.embedding_matrix(schema, "text_chunks")
    kw = index_kwargs(config, schema)
    kw.update(index_type=index_type,
              ivf_cache=cache_path if index_type == "ivf" else None,
              hnsw_cache=cache_path if index_type == "hnsw" else None)
    return build_index(chunk_emb, store.column(schema, "text_chunks", "manual_id"),
                       store.column(schema, "text_chunks", "page"), device=device, **kw)


def make_image_bytes_encoder(engine) -> Callable:
    """PNG/JPEG bytes -> host decode + preprocess -> image tower. An
    undecodable blob raises ValueError (a 400 at the HTTP layer)."""
    import io

    from tpualign_torch.ops.preprocess import preprocess_host

    size = engine.variant.image_size

    def encode(blobs: Sequence[bytes]) -> np.ndarray:
        from PIL import Image

        arrs = []
        for i, blob in enumerate(blobs):
            try:
                with Image.open(io.BytesIO(blob)) as im:
                    arrs.append(preprocess_host(im, size))
            except Exception as e:
                raise ValueError(f"undecodable query image [{i}]: {e}")
        return engine.encode_image_batch(np.stack(arrs))

    return encode


def make_engine(config, device="cuda"):
    """The towers ``serve`` and ``query --text`` encode with: the configured
    CLIP variant with seeded weights (checkpoint loading is a later slice)."""
    from tpualign_torch.parallel.embed import EmbedEngine

    if config.model.checkpoint_path:
        raise NotImplementedError("CLIP_CHECKPOINT: loading checkpoints is not yet ported to "
                                  "tpualign_torch; unset it to serve seeded weights")
    return EmbedEngine(config.model, batch_size=64,
                       text_buckets=getattr(config, "text_buckets", (16, 32, 77)),
                       seed=getattr(config, "seed", 0), device=device)


def build_service(config, schema: str, mesh=None, text_tower: bool = True,
                  encoder: Optional[Callable] = None,
                  image_encoder: Optional[Callable] = None,
                  device="cuda") -> RetrievalService:
    """Service over the store configured in ``config`` (the CLI's entry).

    ``encoder`` / ``image_encoder``: encode callables to share across the
    services of several schemas (one tower pair for all of them)."""
    store = EmbeddingStore(config.store.root, embed_dim=config.model.variant.embed_dim)
    if not store.has_embeddings(schema):
        raise ValueError(f"schema {schema} has no embeddings in {config.store.root}")
    chunk_ids, chunk_emb = store.embedding_matrix(schema, "text_chunks")
    if encoder is None and text_tower:
        engine = make_engine(config, device)
        encoder = engine.encode_text_batch
        if image_encoder is None:
            image_encoder = make_image_bytes_encoder(engine)

    images = store.images(schema)
    img_ids, img_emb = store.embedding_matrix(schema, "images")
    by_id = {im["image_id"]: im for im in images}  # align with the matrix rows
    image_meta = [by_id[i] for i in img_ids]

    return RetrievalService(
        chunk_emb, chunk_ids,
        store.column(schema, "text_chunks", "manual_id"),
        store.column(schema, "text_chunks", "page"),
        schema=schema, mesh=mesh, text_encoder=encoder, image_encoder=image_encoder,
        images=image_meta, image_embeddings=img_emb,
        weak_lookup=build_weak_lookup(store.alignments(schema)),
        coalesce_window_ms=getattr(config, "serve_coalesce_ms", 2.0),
        query_cache=getattr(config, "serve_query_cache", 1024),
        auto_compact=getattr(config, "serve_auto_compact", None),
        **index_kwargs(config, schema),
        model_info={"name": config.model.model_name, "weights": "seeded"},
        device=device,
    )


class _ServiceBox:
    """Holder of the live service; reloading it and syncing it with the
    store are a later slice."""

    def __init__(self, service: RetrievalService):
        self.service = service

    def reload(self) -> dict:
        raise NotImplementedError(f"POST /reload is {_LATER}")

    def sync(self) -> dict:
        raise NotImplementedError(f"POST /sync is {_LATER}")


class _ServiceRegistry:
    """Schema -> :class:`_ServiceBox` routing: requests carry an optional
    ``"schema"`` field (``?schema=`` on GET); omitted means the default."""

    def __init__(self, boxes: Dict[str, _ServiceBox], default: str):
        if default not in boxes:
            raise ValueError(f"default schema {default!r} not in {sorted(boxes)}")
        self.boxes = dict(boxes)
        self.default = default

    def get(self, schema: Optional[str]) -> _ServiceBox:
        name = schema or self.default
        try:
            return self.boxes[name]
        except KeyError:
            raise ValueError(f"schema {name!r} is not served "
                             f"(available: {sorted(self.boxes)})") from None


def _make_handler(registry: _ServiceRegistry, token: Optional[str] = None,
                  idle_timeout: float = 60.0, max_body_bytes: int = 64 * 2**20,
                  request_deadline: float = 30.0):
    class Handler(BaseHTTPRequestHandler):
        # HTTP/1.1 keep-alive: Content-Length on every reply, and every
        # request body read before the reply (or the connection closed)
        protocol_version = "HTTP/1.1"
        # idle keep-alive sockets close after this (SERVE_IDLE_TIMEOUT)
        timeout = idle_timeout
        # TCP_NODELAY: a reply goes out as two writes (headers, then body),
        # and with Nagle's algorithm the body would wait for the client's
        # delayed ACK of the headers, about 40 ms on a keep-alive connection
        disable_nagle_algorithm = True

        def log_message(self, fmt, *args):
            log.debug("http: " + fmt, *args)

        def handle(self):
            # connection cap (SERVE_MAX_CONNECTIONS): shed with one bounded
            # write, never enter the keep-alive loop
            if not self.server._conn_admit(self):
                self.close_connection = True
                body = b'{"error": "too many connections"}'
                try:
                    self.wfile.write(
                        b"HTTP/1.1 503 Service Unavailable\r\n"
                        b"Content-Type: application/json\r\n"
                        b"Content-Length: " + str(len(body)).encode()
                        + b"\r\nConnection: close\r\n\r\n" + body)
                except OSError:
                    pass
                return
            try:
                super().handle()
            except ConnectionError:
                # peer vanished, or the deadline watchdog cut the socket
                self.close_connection = True
            finally:
                self.server._conn_release(self)

        def handle_one_request(self):
            # total READ deadline (idle wait + request transfer), enforced
            # by the server's watchdog; disarmed once the request is read
            self._read_deadline = time.monotonic() + idle_timeout + request_deadline
            try:
                super().handle_one_request()
            finally:
                self._read_deadline = None

        def _reply(self, code: int, payload: dict) -> None:
            body = json.dumps(payload).encode("utf-8")
            self.send_response(code)
            self.send_header("Content-Type", "application/json")
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)

        def _authorized(self) -> bool:
            """Bearer-token check (SERVE_TOKEN), constant-time, on bytes."""
            if token is None:
                return True
            import hmac

            got = self.headers.get("Authorization", "")
            return hmac.compare_digest(got.encode("latin-1", "replace"),
                                       f"Bearer {token}".encode("utf-8"))

        def do_GET(self):
            from urllib.parse import parse_qs, urlsplit

            self._read_deadline = None  # request fully read (no body)
            parts = urlsplit(self.path)
            if parts.path != "/healthz" and not self._authorized():
                self._reply(401, {"error": "missing or bad bearer token"})
                return
            try:
                box = registry.get((parse_qs(parts.query).get("schema") or [None])[0])
            except ValueError as e:
                self._reply(400, {"error": str(e)})
                return
            service = box.service
            if parts.path == "/healthz":
                # minimal: auth-exempt, so it leaks no corpus metadata
                self._reply(200, {"status": "ok", "schema": service.schema})
            elif parts.path == "/stats":
                payload = service.stats()
                payload["metrics"] = service.metrics.snapshot()
                if len(registry.boxes) > 1:
                    payload["schemas"] = sorted(registry.boxes)
                self._reply(200, payload)
            else:
                self._reply(404, {"error": f"unknown path {parts.path}"})

        def do_POST(self):
            t0 = time.perf_counter()
            # every rejection before the body is read closes the connection,
            # so no rejected request ever buffers a body
            if self.headers.get("Transfer-Encoding"):
                self.close_connection = True
                self._reply(411, {"error": "chunked bodies unsupported; send Content-Length"})
                return
            try:
                length = int(self.headers.get("Content-Length", "0"))
            except ValueError:
                length = -1
            if length < 0:
                self.close_connection = True
                self._reply(400, {"error": "bad Content-Length"})
                return
            if not self._authorized():
                self.close_connection = True
                self._reply(401, {"error": "missing or bad bearer token"})
                return
            if length > max_body_bytes:
                self.close_connection = True
                self._reply(413, {"error": f"request body {length} bytes exceeds "
                                           f"SERVE_MAX_BODY_BYTES={max_body_bytes}"})
                return
            body = self.rfile.read(length)
            self._read_deadline = None  # fully read: never cut processing
            if len(body) < length:
                self.close_connection = True
                return
            try:
                req = json.loads(body or b"{}")
                if not isinstance(req, dict):
                    raise ValueError(f"request body must be a JSON object, got "
                                     f"{type(req).__name__}")
                box = registry.get(req.get("schema"))
            except (ValueError, TypeError) as e:
                self._reply(400, {"error": str(e)})
                return
            service = box.service
            mutations = {
                "/add": lambda: service.add_chunks(req.get("chunk_ids"), req.get("manuals"),
                                                   req.get("pages"), req.get("embeddings")),
                "/remove": lambda: service.remove_chunks(req.get("chunk_ids", [])),
                "/compact": service.compact, "/reload": box.reload, "/sync": box.sync,
            }
            if self.path in mutations:
                try:
                    mutations[self.path]()
                except NotImplementedError as e:
                    self._reply(501, {"error": str(e)})
                return
            try:
                k = int(req.get("k", 10))
                if self.path == "/search":
                    results = service.search_embeddings(
                        np.asarray(req["embeddings"], np.float32), req.get("manuals"),
                        req.get("pages"), k=k, global_search=bool(req.get("global", False)))
                elif self.path == "/search_image":
                    results = service.search_images(
                        req["image_ids"], k=k, rerank_alpha=req.get("rerank"),
                        global_search=bool(req.get("global", False)))
                elif self.path == "/search_image_bytes":
                    import base64

                    blobs = [base64.b64decode(s) for s in req["images_b64"]]
                    results = service.search_image_bytes(
                        blobs, manual=req.get("manual"), page=req.get("page"), k=k,
                        global_search=bool(req.get("global", True)))
                elif self.path == "/search_text":
                    results = service.search_text(
                        req["texts"], manual=req.get("manual"), page=req.get("page"), k=k,
                        global_search=bool(req.get("global", True)))
                else:
                    self._reply(404, {"error": f"unknown path {self.path}"})
                    return
                service.metrics.record(self.path, len(results), time.perf_counter() - t0)
                self._reply(200, {"results": results})
            except (KeyError, ValueError, TypeError, RuntimeError) as e:
                service.metrics.record_error()
                self._reply(400, {"error": str(e)})
            except Exception as e:  # pragma: no cover - defensive
                service.metrics.record_error()
                log.exception("request failed")
                self._reply(500, {"error": str(e)})

    return Handler


class _Server(ThreadingHTTPServer):
    # a deep accept queue: many clients connecting at once must not lose SYNs
    request_queue_size = 128
    daemon_threads = True

    def __init__(self, addr, handler, max_connections: int = 128):
        super().__init__(addr, handler)
        self.max_connections = max_connections
        self._conns: set = set()
        self._conns_lock = threading.Lock()
        self._watchdog_stop = threading.Event()
        # cuts sockets whose handler is still READING past its deadline
        self._watchdog = threading.Thread(target=self._watch_deadlines, daemon=True,
                                          name="tpualign-torch-serve-watchdog")
        self._watchdog.start()

    def _conn_admit(self, handler) -> bool:
        with self._conns_lock:
            if len(self._conns) >= self.max_connections:
                return False
            self._conns.add(handler)
            return True

    def _conn_release(self, handler) -> None:
        with self._conns_lock:
            self._conns.discard(handler)

    def _watch_deadlines(self) -> None:
        import socket as _socket

        while not self._watchdog_stop.wait(1.0):
            now = time.monotonic()
            with self._conns_lock:
                stale = [h for h in self._conns
                         if (getattr(h, "_read_deadline", None) or now) < now]
            for h in stale:
                log.warning("read deadline exceeded; cutting connection %s",
                            getattr(h, "client_address", "?"))
                try:
                    h.connection.shutdown(_socket.SHUT_RDWR)
                except OSError:
                    pass

    def server_close(self):
        self._watchdog_stop.set()
        super().server_close()


def serve(service: RetrievalService, host: str = "127.0.0.1", port: int = 8321,
          token: Optional[str] = None, idle_timeout: float = 60.0,
          max_body_bytes: int = 64 * 2**20, max_connections: int = 128,
          request_deadline: float = 30.0) -> ThreadingHTTPServer:
    """Create (but do not start) the HTTP server for one service; call
    ``serve_forever`` on the result, or run it in a thread."""
    return serve_schemas({service.schema: _ServiceBox(service)}, service.schema, host, port,
                         token=token, idle_timeout=idle_timeout,
                         max_body_bytes=max_body_bytes, max_connections=max_connections,
                         request_deadline=request_deadline)


def serve_schemas(boxes: Dict[str, _ServiceBox], default: str, host: str = "127.0.0.1",
                  port: int = 8321, token: Optional[str] = None, idle_timeout: float = 60.0,
                  max_body_bytes: int = 64 * 2**20, max_connections: int = 128,
                  request_deadline: float = 30.0) -> ThreadingHTTPServer:
    """One endpoint serving several schemas: requests route by their
    optional ``"schema"`` field (``?schema=`` on GET), omitted = ``default``."""
    return _Server(
        (host, port),
        _make_handler(_ServiceRegistry(boxes, default), token=token,
                      idle_timeout=idle_timeout, max_body_bytes=max_body_bytes,
                      request_deadline=request_deadline),
        max_connections=max_connections,
    )
