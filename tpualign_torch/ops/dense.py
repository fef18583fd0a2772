"""Matrix products with fp32 accumulation, as the JAX towers take them
(``jnp.dot(..., preferred_element_type=jnp.float32)``)."""

from __future__ import annotations

import torch

__all__ = ["matmul_f32acc"]


def _mm_f32(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """cuBLAS ``a @ b`` of two bf16 CUDA tensors with an fp32 output
    (``out_dtype``, no autograd of its own); ``b`` 2-D or batched like ``a``."""
    if b.dim() == 2:
        out = torch.mm(a.reshape(-1, a.shape[-1]), b, out_dtype=torch.float32)
        return out.reshape(*a.shape[:-1], b.shape[-1])
    batch = a.shape[:-2]
    out = torch.bmm(a.reshape(-1, *a.shape[-2:]), b.reshape(-1, *b.shape[-2:]),
                    out_dtype=torch.float32)
    return out.reshape(*batch, a.shape[-2], b.shape[-1])


class _MatmulF32Acc(torch.autograd.Function):
    """The bf16 product with an fp32 output on CUDA, and its transpose
    rule: ``dA = dC·Bᵀ`` and ``dB = Aᵀ·dC``, each a bf16 product with fp32
    accumulation returned in the operand's dtype, as JAX's transpose of
    ``dot_general`` gives them (``_dot_general_transpose_lhs/rhs``) at the
    TPU's default precision, where the fp32 cotangent enters the product
    as bf16."""

    @staticmethod
    def forward(ctx, a, b):
        ctx.save_for_backward(a, b)
        return _mm_f32(a, b)

    @staticmethod
    def backward(ctx, grad):
        a, b = ctx.saved_tensors
        g = grad.to(a.dtype)
        da = db = None
        if ctx.needs_input_grad[0]:
            da = _mm_f32(g, b.transpose(-1, -2)).to(a.dtype)
        if ctx.needs_input_grad[1]:
            if b.dim() == 2:
                a2 = a.reshape(-1, a.shape[-1])
                db = _mm_f32(a2.t(), g.reshape(-1, g.shape[-1])).to(b.dtype)
            else:
                db = _mm_f32(a.transpose(-1, -2), g).to(b.dtype)
        return da, db


def matmul_f32acc(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``a @ b`` with products in the operands' dtype, accumulated and
    returned in fp32.

    fp32 operands take a plain fp32 product. bf16 operands on CUDA take
    cuBLAS's bf16 product with an fp32 output (``out_dtype``), through
    :class:`_MatmulF32Acc` so that it has a gradient; on the CPU they are
    widened to fp32 first, which is exact (a product of two bf16 values
    fits fp32) and so gives the same sum of the same products, and
    autograd differentiates the widened product (the cotangent stays fp32).
    """
    if a.dtype == torch.float32 and b.dtype == torch.float32:
        return torch.matmul(a, b)
    if a.dtype != b.dtype:
        raise TypeError(f"operand dtypes differ: {a.dtype} and {b.dtype}")
    if a.device.type != "cuda":
        return torch.matmul(a.float(), b.float())
    if torch.is_grad_enabled() and (a.requires_grad or b.requires_grad):
        return _MatmulF32Acc.apply(a, b)
    return _mm_f32(a, b)
