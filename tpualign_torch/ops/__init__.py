"""Device ops of the port: the hand-written CUDA kernels (``attention``:
K1 ``fused_mha``; ``sim_topk``: K2 ``masked_sim_topk`` and K3
``masked_sim_topk_quant``; ``ivf_topk``: K4 ``ivf_probe_topk``;
``normalize``: K5 ``normalize_u8``), each beside its plain PyTorch version,
their build (``build``), and image preprocessing on the host and the
device (``preprocess``)."""

from tpualign_torch.ops.preprocess import (
    CLIP_MEAN, CLIP_STD, normalize_images, preprocess_device, preprocess_host)
from tpualign_torch.ops.similarity import cosine_similarity_matrix, l2_normalize, masked_topk

__all__ = ["CLIP_MEAN", "CLIP_STD", "preprocess_host", "preprocess_device", "normalize_images",
           "l2_normalize", "cosine_similarity_matrix", "masked_topk"]
