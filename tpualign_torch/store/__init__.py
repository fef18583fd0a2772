"""Embedding store: four schemas (vanilla_clip, clip_lexical,
clip_positional, clip_combined), each with images, text_chunks and
alignments tables, as ``.npy`` matrices beside Parquet metadata (the port's
copy of ``tpualign.store``; pyarrow is imported lazily)."""

from tpualign_torch.store.embedding_store import SCHEMAS, EmbeddingStore

__all__ = ["EmbeddingStore", "SCHEMAS"]
