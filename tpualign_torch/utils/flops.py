"""Analytic forward FLOP counts of the CLIP towers (the port's
``tpualign.utils.flops``), and the card's peak rate, for the model-FLOP
share of a step.

Counts follow the usual convention: a (M, K) x (K, N) matmul costs
2·M·K·N FLOPs; elementwise ops, norms and the softmax are not counted.
"""

from __future__ import annotations

from typing import Optional

from tpualign_torch.config import ClipVariant

__all__ = ["vision_tower_flops", "text_tower_flops", "clip_pair_flops", "device_peak_flops"]


def _transformer_flops(seq: int, width: int, layers: int,
                       mlp_hidden: Optional[int] = None) -> int:
    """Per-item forward FLOPs of a pre-LN transformer stack
    (``mlp_hidden`` None = 4x width)."""
    qkv = 2 * seq * width * (3 * width)
    attn_out = 2 * seq * width * width
    # scores (S, W) x (W, S) per head sums to 2*S*S*W across heads; the same
    # for the attention-weighted value combine
    scores = 2 * seq * seq * width
    combine = 2 * seq * seq * width
    mlp = 2 * (2 * seq * width * (mlp_hidden or 4 * width))
    return layers * (qkv + attn_out + scores + combine + mlp)


def vision_tower_flops(v: ClipVariant) -> int:
    """Forward FLOPs for one image through the ViT tower."""
    grid = v.image_size // v.patch_size
    seq = grid * grid + 1  # patches + CLS
    patch_dim = v.patch_size * v.patch_size * 3
    patch_embed = 2 * (grid * grid) * patch_dim * v.vision_width
    proj = 2 * v.vision_width * v.embed_dim  # CLS token -> embed dim
    return patch_embed + _transformer_flops(
        seq, v.vision_width, v.vision_layers, v.vision_mlp_dim) + proj


def text_tower_flops(v: ClipVariant) -> int:
    """Forward FLOPs for one text through the transformer tower."""
    proj = 2 * v.text_width * v.embed_dim  # EOT token -> embed dim
    return _transformer_flops(
        v.context_length, v.text_width, v.text_layers, v.text_mlp_dim) + proj


def clip_pair_flops(v: ClipVariant) -> int:
    """Forward FLOPs for one (image, text) pair through both towers."""
    return vision_tower_flops(v) + text_tower_flops(v)


# Dense bf16 tensor-core peak per card, FLOP/s, from NVIDIA's H100 data sheet
# (SXM5: 989.4 TFLOP/s without sparsity; PCIe: 756).
_PEAKS = (
    ("h100 80gb hbm3", 989e12),
    ("h100 sxm", 989e12),
    ("h100 pcie", 756e12),
)


def device_peak_flops(device_name: str) -> Optional[float]:
    """Peak dense bf16 FLOP/s for a ``torch.cuda.get_device_name()``
    string, or None if the card is not in the table."""
    name = device_name.lower().replace("nvidia", "").strip()
    for key, peak in _PEAKS:
        if name.startswith(key):
            return peak
    return None
