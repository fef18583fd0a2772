"""Serving: the persistent device-resident retrieval daemon (HTTP/JSON)."""

from tpualign_torch.serving.server import (
    BatchCoalescer,
    RetrievalService,
    TextEncodeCoalescer,
    build_index_artifact,
    build_service,
    fetch_chunks,
    fetch_snapshot,
    serve,
    serve_schemas,
)

__all__ = ["BatchCoalescer", "RetrievalService", "TextEncodeCoalescer", "build_index_artifact",
           "build_service", "fetch_chunks", "fetch_snapshot", "serve", "serve_schemas"]
