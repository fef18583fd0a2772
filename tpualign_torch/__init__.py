"""tpualign_torch: the PyTorch/CUDA port of tpualign for NVIDIA Hopper.

The port embeds images and text chunks with the CLIP towers, searches
exactly or over quantized corpora, and serves a store, on one GPU:

- ``tpualign_torch.parallel.EmbedEngine``: ``encode_text_batch``,
  ``encode_image_batch``, ``embed_image_records``, ``embed_chunk_records``;
- ``tpualign_torch.parallel.RetrievalIndex`` / ``build_index``: ``search``
  at fp32, int8, int4 or int2, with ``refine``;
- ``tpualign_torch.store.EmbeddingStore``: tpualign's on-disk store format;
- ``tpualign_torch.serving``: the HTTP daemon's query routes, and
  ``python -m tpualign_torch serve`` / ``query``.

Three hand-written CUDA kernels carry the device work: ``fused_mha`` (K1,
``ops/attention.py``) in every residual block, ``masked_sim_topk`` (K2,
fp32) and ``masked_sim_topk_quant`` (K3, int8/int4/int2) behind the search
(``ops/sim_topk.py``). The package imports neither JAX nor ``tpualign``;
it runs on CUDA unless the caller passes ``device="cpu"``, where every
kernel's plain PyTorch version runs instead.
"""

from tpualign_torch.config import CLIP_VARIANTS, ClipVariant, ModelConfig, load_config

__all__ = ["CLIP_VARIANTS", "ClipVariant", "ModelConfig", "load_config"]
