"""Device ops of the port: the hand-written CUDA kernels (``attention``:
K1 ``fused_mha``; ``sim_topk``: K2 ``masked_sim_topk`` and K3
``masked_sim_topk_quant``; ``ivf_topk``: K4 ``ivf_probe_topk``;
``normalize``: K5 ``normalize_u8``), each beside its plain PyTorch version,
their build (``build``), and image preprocessing on the host and the
device (``preprocess``)."""
