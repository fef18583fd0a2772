"""Transformer building blocks of the CLIP towers (the port's
``tpualign.models.layers``).

Parameters keep the JAX package's layouts and names (projection kernels
``(in, out)``, LayerNorm ``scale``/``bias``) so weights carry over as
copies (``tpualign_torch.models.convert``). The casts follow the JAX
towers: the residual stream stays in the compute dtype, LayerNorm
statistics are fp32 and cast back, projections take products in the
compute dtype with fp32 accumulation and add the bias in fp32, and QKV is
cast to the compute dtype before attention. Under ``quant="int8"`` (or
``"int8_qat"``) the four projections of a block go through
``tpualign_torch.ops.quant.int8_dot`` (``int8_dot_qat``), which hands back
the stream's dtype, as tpualign's layers do; attention stays K1. On a
model axis above 1 they take the split forms of ``ops/quant.py``: the row
and column maxima over the cards of the row, the row-split products'
partials summed on the row's first card, where the bias goes into the
epilogue.
"""

from __future__ import annotations

from typing import Callable, Optional

import torch
import torch.nn.functional as F
from torch import nn
from torch.func import functional_call
from torch.utils.checkpoint import checkpoint

from tpualign_torch.ops.attention import fused_mha, fused_mha_reference
from tpualign_torch.ops.dense import matmul_f32acc
from tpualign_torch.ops.quant import (
    int8_dot, int8_dot_columns, int8_dot_qat, int8_dot_qat_columns, int8_dot_qat_rows,
    int8_dot_rows)

__all__ = ["quick_gelu", "get_activation", "LayerNorm", "MultiHeadAttention",
           "MLP", "ResidualBlock", "Transformer", "dense"]


def quick_gelu(x: torch.Tensor) -> torch.Tensor:
    """QuickGELU: x * sigmoid(1.702 x), used by OpenAI CLIP checkpoints."""
    return x * torch.sigmoid(1.702 * x)


def get_activation(use_quick_gelu: bool) -> Callable[[torch.Tensor], torch.Tensor]:
    if use_quick_gelu:
        return quick_gelu
    return lambda x: F.gelu(x, approximate="none")


_QUANT_DOTS = {"int8": int8_dot, "int8_qat": int8_dot_qat}
# the tensor-parallel forms: (column-split, row-split)
_SPLIT_DOTS = {"int8": (int8_dot_columns, int8_dot_rows),
               "int8_qat": (int8_dot_qat_columns, int8_dot_qat_rows)}


def dense(x: torch.Tensor, kernel: torch.Tensor, bias: Optional[torch.Tensor],
          compute_dtype: torch.dtype, quant: str = "none") -> torch.Tensor:
    """``x @ kernel (+ bias)``: products in ``compute_dtype``, fp32 out; or,
    with ``quant``, tpualign's int8 product in ``x``'s dtype."""
    if quant != "none":
        return _QUANT_DOTS[quant](x, kernel, bias)
    out = matmul_f32acc(x.to(compute_dtype), kernel.to(compute_dtype))
    return out if bias is None else out + bias


class LayerNorm(nn.Module):
    """LayerNorm computed in fp32 whatever the input dtype."""

    def __init__(self, dim: int, eps: float = 1e-5):
        super().__init__()
        self.eps = eps
        self.scale = nn.Parameter(torch.ones(dim))
        self.bias = nn.Parameter(torch.zeros(dim))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        orig = x.dtype
        x = x.float()
        mean = x.mean(dim=-1, keepdim=True)
        var = (x - mean).square().mean(dim=-1, keepdim=True)
        y = (x - mean) * torch.rsqrt(var + self.eps)
        return (y * self.scale + self.bias).to(orig)


class MultiHeadAttention(nn.Module):
    """Fused-QKV multi-head attention; the core is ``fused_mha`` (K1) when
    ``use_fused_attention``, else its plain version."""

    def __init__(self, width: int, num_heads: int, compute_dtype: torch.dtype,
                 use_fused_attention: bool = False, quant: str = "none"):
        super().__init__()
        if width % num_heads:
            raise ValueError("width must divide heads")
        self.num_heads = num_heads
        self.compute_dtype = compute_dtype
        self.use_fused_attention = use_fused_attention
        self.quant = quant
        self.in_proj_kernel = nn.Parameter(torch.empty(width, 3 * width))
        self.in_proj_bias = nn.Parameter(torch.zeros(3 * width))
        self.out_proj_kernel = nn.Parameter(torch.empty(width, width))
        self.out_proj_bias = nn.Parameter(torch.zeros(width))

    def forward(self, x: torch.Tensor, mask: Optional[torch.Tensor] = None,
                tp: Optional[list] = None) -> torch.Tensor:
        """``tp``: this block's parts on the cards of a model row,
        ``[(in_proj_kernel, in_proj_bias, out_proj_kernel)]`` (see
        ``parallel/sharding.py``): each card runs its heads, K1 included, and
        its rows of ``out_proj``; the partial products are summed on ``x``'s
        card, then the replicated bias is added (int8: the split forms of
        ``ops/quant.py``, the bias in the epilogue)."""
        cdt = self.compute_dtype
        attend = fused_mha if self.use_fused_attention else fused_mha_reference
        if tp is not None:
            heads = self.num_heads // len(tp)
            if self.quant != "none":
                columns, rows = _SPLIT_DOTS[self.quant]
                in_kernels, in_biases, out_kernels = zip(*tp)
                ctxs = [attend(qkv.to(cdt), heads, None if mask is None else mask.to(qkv.device))
                        for qkv in columns(x, in_kernels, in_biases)]
                return rows(ctxs, out_kernels, self.out_proj_bias, x.device).to(x.dtype)
            total = None
            for in_kernel, in_bias, out_kernel in tp:
                dev = in_kernel.device
                qkv = dense(x.to(dev), in_kernel, in_bias, cdt).to(cdt)
                ctx = attend(qkv, heads, None if mask is None else mask.to(dev))
                part = dense(ctx, out_kernel, None, cdt).to(x.device)
                total = part if total is None else total + part
            return (total + self.out_proj_bias).to(x.dtype)
        qkv = dense(x, self.in_proj_kernel, self.in_proj_bias, cdt, self.quant).to(cdt)
        ctx = attend(qkv, self.num_heads, mask)
        return dense(ctx, self.out_proj_kernel, self.out_proj_bias, cdt,
                     self.quant).to(x.dtype)


class MLP(nn.Module):
    """c_fc (``hidden``, 4x width by default) -> activation -> c_proj."""

    def __init__(self, width: int, hidden: int, use_quick_gelu: bool,
                 compute_dtype: torch.dtype, quant: str = "none"):
        super().__init__()
        self.compute_dtype = compute_dtype
        self.quant = quant
        self.act = get_activation(use_quick_gelu)
        self.c_fc_kernel = nn.Parameter(torch.empty(width, hidden))
        self.c_fc_bias = nn.Parameter(torch.zeros(hidden))
        self.c_proj_kernel = nn.Parameter(torch.empty(hidden, width))
        self.c_proj_bias = nn.Parameter(torch.zeros(width))

    def forward(self, x: torch.Tensor, tp: Optional[list] = None) -> torch.Tensor:
        """``tp``: ``[(c_fc_kernel, c_fc_bias, c_proj_kernel)]`` per card of a
        model row, summed as :class:`MultiHeadAttention`'s parts are."""
        cdt = self.compute_dtype
        if tp is not None:
            if self.quant != "none":
                columns, rows = _SPLIT_DOTS[self.quant]
                fc_kernels, fc_biases, proj_kernels = zip(*tp)
                ys = [self.act(y) for y in columns(x, fc_kernels, fc_biases)]
                return rows(ys, proj_kernels, self.c_proj_bias, x.device).to(x.dtype)
            total = None
            for fc_kernel, fc_bias, proj_kernel in tp:
                y = self.act(dense(x.to(fc_kernel.device), fc_kernel, fc_bias, cdt))
                part = dense(y, proj_kernel, None, cdt).to(x.device)
                total = part if total is None else total + part
            return (total + self.c_proj_bias).to(x.dtype)
        y = self.act(dense(x, self.c_fc_kernel, self.c_fc_bias, cdt, self.quant))
        y = dense(y, self.c_proj_kernel, self.c_proj_bias, cdt, self.quant)
        return y.to(x.dtype)


class ResidualBlock(nn.Module):
    """Pre-LN block: x + attn(ln_1(x)); x + mlp(ln_2(x))."""

    def __init__(self, width: int, num_heads: int, mlp_hidden: int,
                 use_quick_gelu: bool, compute_dtype: torch.dtype,
                 use_fused_attention: bool, quant: str = "none"):
        super().__init__()
        self.ln_1 = LayerNorm(width)
        self.attn = MultiHeadAttention(width, num_heads, compute_dtype,
                                       use_fused_attention, quant)
        self.ln_2 = LayerNorm(width)
        self.mlp = MLP(width, mlp_hidden, use_quick_gelu, compute_dtype, quant)

    def forward(self, x: torch.Tensor, mask: Optional[torch.Tensor] = None,
                tp: Optional[dict] = None) -> torch.Tensor:
        x = x + self.attn(self.ln_1(x), mask, None if tp is None else tp["attn"])
        return x + self.mlp(self.ln_2(x), None if tp is None else tp["mlp"])


# the block parameters a model axis splits: with ``tp`` their parts are used
TP_SPLIT = ("attn.in_proj_kernel", "attn.in_proj_bias", "attn.out_proj_kernel",
            "mlp.c_fc_kernel", "mlp.c_fc_bias", "mlp.c_proj_kernel")


def _run_block(block: ResidualBlock, names, x: torch.Tensor, mask: Optional[torch.Tensor],
               tp: Optional[dict], *tensors: torch.Tensor) -> torch.Tensor:
    return functional_call(block, dict(zip(names, tensors)), (x, mask, tp))


class Transformer(nn.Module):
    """Stack of residual blocks (``resblocks.<i>`` here, ``resblock_<i>``
    in the JAX tree).

    ``remat`` (``CLIP_REMAT``, tpualign's ``nn.remat`` of each block): while
    autograd records, each block runs under ``torch.utils.checkpoint``, so
    its activations are recomputed in the backward instead of kept; the
    recompute runs the block's forward again (K1 launches twice a block).
    The block's parameter tensors are inputs of the checkpointed call, so
    the recompute uses the tensors of the forward even when the step
    supplied them through ``functional_call``, whose swap has ended by the
    backward. Without autograd nothing changes. A block's tensor-parallel
    parts reach the recompute as the same tensors (an argument of the
    checkpointed call), so the int8 split forms take their cross-card
    maxima again over the same tensors."""

    def __init__(self, width: int, num_layers: int, num_heads: int,
                 mlp_hidden: Optional[int], use_quick_gelu: bool,
                 compute_dtype: torch.dtype, use_fused_attention: bool,
                 quant: str = "none", remat: bool = False):
        super().__init__()
        hidden = mlp_hidden or 4 * width
        self.remat = remat
        self.resblocks = nn.ModuleList(
            ResidualBlock(width, num_heads, hidden, use_quick_gelu,
                          compute_dtype, use_fused_attention, quant)
            for _ in range(num_layers)
        )

    def forward(self, x: torch.Tensor, mask: Optional[torch.Tensor] = None,
                tp: Optional[list] = None) -> torch.Tensor:
        """``tp``: one dict of tensor-parallel parts a block (see
        :class:`ResidualBlock`), or None."""
        remat = self.remat and torch.is_grad_enabled()
        for k, block in enumerate(self.resblocks):
            parts = None if tp is None else tp[k]
            if remat:
                names, tensors = zip(*((n, p) for n, p in block.named_parameters()
                                       if parts is None or not n.endswith(TP_SPLIT)))
                x = checkpoint(_run_block, block, names, x, mask, parts, *tensors,
                               use_reentrant=False)
            else:
                x = block(x, mask, parts)
        return x
