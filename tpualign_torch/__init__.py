"""tpualign_torch: the PyTorch/CUDA port of tpualign for NVIDIA Hopper.

This slice embeds images and text chunks with the CLIP towers and runs the
exact same-page search, on one GPU:

- ``tpualign_torch.parallel.EmbedEngine``: ``encode_text_batch``,
  ``encode_image_batch``, ``embed_image_records``, ``embed_chunk_records``;
- ``tpualign_torch.parallel.RetrievalIndex``: ``search``.

Two hand-written CUDA kernels carry the device work: ``fused_mha`` (K1,
``ops/attention.py``) in every residual block, and ``masked_sim_topk`` (K2,
``ops/sim_topk.py``) behind the search. The package imports neither JAX
nor ``tpualign``; it runs on CUDA unless the caller passes
``device="cpu"``, where every kernel's plain PyTorch version runs instead.
"""

from tpualign_torch.config import CLIP_VARIANTS, ClipVariant, ModelConfig, load_config

__all__ = ["CLIP_VARIANTS", "ClipVariant", "ModelConfig", "load_config"]
