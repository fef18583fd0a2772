"""Matrix products with fp32 accumulation, as the JAX towers take them
(``jnp.dot(..., preferred_element_type=jnp.float32)``)."""

from __future__ import annotations

import torch

__all__ = ["matmul_f32acc"]


def matmul_f32acc(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``a @ b`` with products in the operands' dtype, accumulated and
    returned in fp32.

    fp32 operands take a plain fp32 product. bf16 operands on CUDA take
    cuBLAS's bf16 product with an fp32 output (``out_dtype``); on the CPU
    they are widened to fp32 first, which is exact (a product of two bf16
    values fits fp32) and so gives the same sum of the same products.
    """
    if a.dtype == torch.float32 and b.dtype == torch.float32:
        return torch.matmul(a, b)
    if a.dtype != b.dtype:
        raise TypeError(f"operand dtypes differ: {a.dtype} and {b.dtype}")
    if a.device.type != "cuda":
        return torch.matmul(a.float(), b.float())
    if b.dim() == 2:
        out = torch.mm(a.reshape(-1, a.shape[-1]), b, out_dtype=torch.float32)
        return out.reshape(*a.shape[:-1], b.shape[-1])
    batch = a.shape[:-2]
    out = torch.bmm(a.reshape(-1, *a.shape[-2:]), b.reshape(-1, *b.shape[-2:]),
                    out_dtype=torch.float32)
    return out.reshape(*batch, a.shape[-2], b.shape[-1])
