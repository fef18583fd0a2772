"""CLIP vision tower (the port's ``tpualign.models.vit``).

Images are NHWC, as in the JAX package. The patch embedding is the
convolution's arithmetic written as a matmul over (h, w, c)-ordered
patches, so no cuDNN convolution (TF32 by default in fp32) is involved.
FLIP patch masking (training only): ``patch_indices`` keeps the visible
patches and their positional rows, as tpualign's ``take_along_axis``.
"""

from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from tpualign_torch.models.layers import LayerNorm, Transformer
from tpualign_torch.ops.dense import matmul_f32acc

__all__ = ["VisionTransformer"]


class VisionTransformer(nn.Module):
    """Conv patch embed (no bias) -> class token -> positional embedding ->
    ln_pre -> transformer -> ln_post on the class token -> projection."""

    def __init__(self, image_size: int, patch_size: int, width: int,
                 num_layers: int, num_heads: int, embed_dim: int,
                 use_quick_gelu: bool = True,
                 compute_dtype: torch.dtype = torch.bfloat16,
                 use_fused_attention: bool = False,
                 mlp_hidden: Optional[int] = None, quant: str = "none",
                 remat: bool = False):
        super().__init__()
        self.image_size = image_size
        self.patch_size = patch_size
        self.width = width
        self.compute_dtype = compute_dtype
        grid = image_size // patch_size
        self.conv1_kernel = nn.Parameter(torch.empty(patch_size, patch_size, 3, width))  # HWIO
        self.class_embedding = nn.Parameter(torch.empty(width))
        self.positional_embedding = nn.Parameter(torch.empty(grid * grid + 1, width))
        self.ln_pre = LayerNorm(width)
        self.transformer = Transformer(width, num_layers, num_heads, mlp_hidden,
                                       use_quick_gelu, compute_dtype, use_fused_attention,
                                       quant, remat)
        self.ln_post = LayerNorm(width)
        self.proj = nn.Parameter(torch.empty(width, embed_dim))

    def forward(self, images: torch.Tensor,
                patch_indices: Optional[torch.Tensor] = None,
                tp: Optional[list] = None) -> torch.Tensor:
        """images: (B, H, W, 3) float, already normalized -> (B, embed) fp32.

        ``patch_indices``: optional (B, K) integer indices of the VISIBLE
        patches (FLIP masking, arXiv:2212.00794): the transformer runs on
        the class token and those K patches only. None keeps them all.
        ``tp``: the blocks' tensor-parallel parts (``parallel/sharding.py``)."""
        b, h, w, ch = images.shape
        p, s = self.patch_size, self.image_size
        if (h, w, ch) != (s, s, 3):
            raise ValueError(f"images must be (B, {s}, {s}, 3); got {tuple(images.shape)}")
        cdt = self.compute_dtype
        g = s // p
        x = images.to(cdt).reshape(b, g, p, g, p, 3).permute(0, 1, 3, 2, 4, 5)
        x = x.reshape(b, g * g, p * p * 3)
        kernel = self.conv1_kernel.reshape(p * p * 3, self.width).to(cdt)
        x = matmul_f32acc(x, kernel).to(cdt)
        cls = self.class_embedding.to(cdt).expand(b, 1, self.width)
        pos = self.positional_embedding.to(cdt)
        if patch_indices is not None:
            # gather the visible patches and their positional rows (row 0 is CLS)
            idx = patch_indices.long()
            x = torch.take_along_dim(x, idx[..., None], dim=1)
            x = torch.cat([cls + pos[None, :1], x + pos[1:][idx]], dim=1)
        else:
            x = torch.cat([cls, x], dim=1) + pos[None]
        x = self.ln_pre(x)
        x = self.transformer(x, None, tp)
        x = self.ln_post(x[:, 0, :])
        return matmul_f32acc(x.to(cdt), self.proj.to(cdt))
