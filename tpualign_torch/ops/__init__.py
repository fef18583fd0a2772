"""Device ops of the port: the hand-written CUDA kernels (``attention``:
K1 ``fused_mha``; ``sim_topk``: K2 ``masked_sim_topk`` and K3
``masked_sim_topk_quant``), each beside its plain PyTorch version, their
build (``build``), and host preprocessing."""
