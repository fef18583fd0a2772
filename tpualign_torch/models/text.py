"""CLIP text tower (the port's ``tpualign.models.text``).

Causal attention, features at the EOT token (the first position of the
largest id, since ``<|endoftext|>`` has the largest id), projected to
``embed_dim``. A batch may be shorter than the 77-token context: under the
causal mask, positions after EOT never reach the EOT feature, so cutting
the zero tail leaves the embedding unchanged (the embed engine's length
buckets rely on it).
"""

from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from tpualign_torch.models.layers import LayerNorm, Transformer
from tpualign_torch.ops.dense import matmul_f32acc

__all__ = ["TextTransformer", "causal_mask"]


def causal_mask(length: int, device: torch.device | str = "cpu") -> torch.Tensor:
    """Additive (T, T) fp32 mask with -inf above the diagonal."""
    full = torch.full((length, length), float("-inf"), dtype=torch.float32, device=device)
    return torch.triu(full, diagonal=1)


class TextTransformer(nn.Module):
    def __init__(self, context_length: int, vocab_size: int, width: int,
                 num_layers: int, num_heads: int, embed_dim: int,
                 use_quick_gelu: bool = True,
                 compute_dtype: torch.dtype = torch.bfloat16,
                 use_fused_attention: bool = False,
                 mlp_hidden: Optional[int] = None, quant: str = "none",
                 remat: bool = False):
        super().__init__()
        self.context_length = context_length
        self.compute_dtype = compute_dtype
        self.token_embedding = nn.Parameter(torch.empty(vocab_size, width))
        self.positional_embedding = nn.Parameter(torch.empty(context_length, width))
        self.transformer = Transformer(width, num_layers, num_heads, mlp_hidden,
                                       use_quick_gelu, compute_dtype, use_fused_attention,
                                       quant, remat)
        self.ln_final = LayerNorm(width)
        self.text_projection = nn.Parameter(torch.empty(width, embed_dim))

    def forward(self, token_ids: torch.Tensor, tp: Optional[list] = None) -> torch.Tensor:
        """token_ids: (B, T) int, zero-padded after EOT, T <= context_length;
        ``tp``: the blocks' tensor-parallel parts (``parallel/sharding.py``)."""
        t = token_ids.shape[1]
        if t > self.context_length:
            raise ValueError(
                f"sequence length {t} exceeds context_length={self.context_length}")
        cdt = self.compute_dtype
        ids = token_ids.long()
        x = self.token_embedding[ids].to(cdt)
        x = x + self.positional_embedding.to(cdt)[None, :t]
        x = self.transformer(x, causal_mask(t, x.device), tp)
        x = self.ln_final(x)
        eot = ids.argmax(dim=-1)  # first maximum
        x = x[torch.arange(x.shape[0], device=x.device), eot]
        return matmul_f32acc(x.to(cdt), self.text_projection.to(cdt))
