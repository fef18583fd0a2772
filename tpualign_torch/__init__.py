"""tpualign_torch: the PyTorch/CUDA port of tpualign for NVIDIA Hopper.

The port processes manuals, embeds images and text chunks with the CLIP
towers, scores weak supervision, fills and evaluates the store, searches
exactly or over quantized corpora, and serves a store, on one GPU:

- ``tpualign_torch.parallel.EmbedEngine``: ``encode_text_batch``,
  ``encode_image_batch``, ``embed_image_records`` (host or device image
  feed), ``embed_chunk_records``;
- ``tpualign_torch.pipeline.Pipeline``: the five stages from raw manuals
  (document processing and lexical filtering on the host,
  ``tpualign_torch.data``; store setup; one embedding pass with weak
  supervision for the four schemas; evaluation to ``metrics.json``), and
  ``python -m tpualign_torch run`` / ``process`` / ``filter`` /
  ``setup-db`` / ``embed`` / ``evaluate`` / ``check``;
- ``tpualign_torch.models.loader``: OpenCLIP and HuggingFace checkpoint
  files (``CLIP_CHECKPOINT``) for the towers;
- ``tpualign_torch.parallel.RetrievalIndex`` / ``build_index``: ``search``
  at fp32, int8, int4 or int2, with ``refine``, or over an IVF index;
- ``tpualign_torch.store.EmbeddingStore``: tpualign's on-disk store format;
- ``tpualign_torch.serving``: the HTTP daemon's query routes, and
  ``python -m tpualign_torch serve`` / ``query`` / ``index``.

Five hand-written CUDA kernels carry the device work: ``fused_mha`` (K1,
``ops/attention.py``) in every residual block, ``masked_sim_topk`` (K2,
fp32) and ``masked_sim_topk_quant`` (K3, int8/int4/int2) behind the search
(``ops/sim_topk.py``), ``ivf_probe_topk`` (K4, ``ops/ivf_topk.py``) behind
the IVF index, and ``normalize_u8`` (K5, ``ops/normalize.py``) at the end
of the device image feed. The package imports neither JAX nor
``tpualign``; it runs on CUDA unless the caller passes ``device="cpu"``,
where every kernel's plain PyTorch version runs instead.
"""

from tpualign_torch.config import (
    CLIP_VARIANTS, ClipVariant, DataConfig, MeshConfig, ModelConfig, PipelineConfig, StoreConfig,
    load_config)
from tpualign_torch.store.embedding_store import SCHEMAS

__all__ = ["CLIP_VARIANTS", "SCHEMAS", "ClipVariant", "DataConfig", "MeshConfig", "ModelConfig",
           "PipelineConfig", "StoreConfig", "load_config"]
