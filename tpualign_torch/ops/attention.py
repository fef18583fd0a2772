"""Fused short-sequence multi-head attention (kernel K1).

``fused_mha`` replaces the Pallas TPU kernel
``tpualign/ops/pallas_attention.py::fused_mha`` (``_mha_kernel``). On a
CUDA tensor it launches the hand-written kernel in ``csrc/fused_mha.cu``;
on a CPU tensor it runs :func:`fused_mha_reference`, the plain PyTorch
version with the numerics of ``_xla_reference_mha``.

Bound on the H100 (ViT-B-32, B=256): memory, one read of the packed QKV
and one write of the context per launch, about 24 us at 3.35 TB/s. bf16
runs on the tensor cores (``mma.sync``, the scores in registers), fp32 on
the CUDA cores (see the source's notes).

Under autograd (training) the forward still launches K1 and the backward
recomputes through :func:`fused_mha_reference`, as ``pallas_attention.py``'s
``custom_vjp`` (``_fused_mha_bwd``) recomputes through
``_xla_reference_mha``: tpualign has no backward kernel either.
``fused_mha.launches`` counts K1's launches, ``fused_mha.backward_recomputes``
the backward passes.
"""

from __future__ import annotations

from typing import Optional

import torch

from tpualign_torch.ops import build
from tpualign_torch.ops.dense import matmul_f32acc

__all__ = ["fused_mha", "fused_mha_reference", "MAX_SEQ", "HEAD_DIMS"]

MAX_SEQ = 257                   # ViT-L/H-14 at 224: 16 x 16 patches + CLS
HEAD_DIMS = (64, 80, 88, 104)   # B/L (64), H (80), g (88), bigG (104)
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}


def fused_mha_reference(qkv: torch.Tensor, num_heads: int,
                        mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Plain attention over packed QKV ``(B, T, 3D)`` -> ``(B, T, D)``.

    Scores are products in the input dtype with fp32 accumulation, scaled
    by ``hd**-0.5`` in fp32 and offset by the additive ``(T, T)`` mask; the
    softmax is fp32; the probabilities are rounded to the input dtype
    before P.V, which accumulates in fp32; the output is in the input dtype.
    """
    b, t, three_d = qkv.shape
    d = three_d // 3
    hd = d // num_heads
    q, k, v = qkv.split(d, dim=-1)

    def heads(x):
        return x.reshape(b, t, num_heads, hd).transpose(1, 2)  # (B, H, T, hd)

    q, k, v = heads(q), heads(k), heads(v)
    scores = matmul_f32acc(q, k.transpose(-1, -2)) * (1.0 / (hd ** 0.5))
    if mask is not None:
        scores = scores + mask.reshape(t, t).to(torch.float32)
    probs = torch.softmax(scores, dim=-1).to(qkv.dtype)
    ctx = matmul_f32acc(probs, v)  # (B, H, T, hd) fp32
    return ctx.transpose(1, 2).reshape(b, t, d).to(qkv.dtype)


class _FusedMHA(torch.autograd.Function):
    """K1 forward; the backward recomputes the plain attention under
    autograd and takes its vector-Jacobian product, as ``_fused_mha_bwd``
    does."""

    @staticmethod
    def forward(ctx, qkv, mask, num_heads):
        ctx.num_heads = num_heads
        ctx.save_for_backward(qkv, mask)
        return _launch(qkv, num_heads, mask)

    @staticmethod
    def backward(ctx, grad):
        qkv, mask = ctx.saved_tensors
        with torch.enable_grad():
            q = qkv.detach().requires_grad_(True)
            m = None
            if mask is not None:
                m = mask.detach().requires_grad_(ctx.needs_input_grad[1])
            out = fused_mha_reference(q, ctx.num_heads, m)
            wrt = [q] + ([m] if m is not None and m.requires_grad else [])
            grads = torch.autograd.grad(out, wrt, grad)
        fused_mha.backward_recomputes += 1
        dmask = grads[1] if len(grads) > 1 else None
        return grads[0], dmask, None


def fused_mha(qkv: torch.Tensor, num_heads: int,
              mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Attention over packed QKV ``(B, T, 3D)`` -> context ``(B, T, D)``.

    ``mask``: optional additive ``(T, T)`` (or ``(1, 1, T, T)``) fp32 mask,
    e.g. the text tower's causal mask. CUDA tensors launch K1 (fp32 or
    bf16, T <= 257, head dim in ``HEAD_DIMS``, a bf16 ``qkv`` starting on a
    16-byte boundary) and raise on anything it does not take; under
    autograd the backward recomputes through :func:`fused_mha_reference`.
    CPU tensors take :func:`fused_mha_reference`.
    """
    if qkv.dim() != 3 or qkv.shape[2] % 3:
        raise ValueError(f"qkv must be (B, T, 3*D); got {tuple(qkv.shape)}")
    if qkv.dtype not in _DTYPES:
        raise TypeError(f"fused_mha takes float32 or bfloat16, got {qkv.dtype}")
    b, t, three_d = qkv.shape
    d = three_d // 3
    hd = d // num_heads
    if hd * num_heads != d:
        raise ValueError(f"width {d} does not divide into {num_heads} heads")
    if mask is not None:
        if mask.numel() != t * t or mask.dtype != torch.float32:
            raise ValueError(f"mask must be {t}x{t} float32; got "
                             f"{tuple(mask.shape)} {mask.dtype}")
        if mask.device != qkv.device:
            raise ValueError("mask must be on the qkv's device")
    if qkv.device.type == "cpu":
        return fused_mha_reference(qkv, num_heads, mask)
    if qkv.device.type != "cuda":
        raise ValueError(f"fused_mha: unsupported device {qkv.device}")
    if hd not in HEAD_DIMS:
        raise ValueError(f"head dim {hd}: the kernel takes {HEAD_DIMS}")
    if not 0 < t <= MAX_SEQ:
        raise ValueError(f"sequence length {t} outside 1..{MAX_SEQ}")
    if not qkv.is_contiguous() or (mask is not None and not mask.is_contiguous()):
        raise ValueError("qkv and mask must be contiguous")
    if qkv.dtype == torch.bfloat16 and qkv.data_ptr() % 16:
        raise ValueError("bf16 qkv must start on a 16-byte boundary (the kernel copies "
                         "16 bytes at a time)")
    if torch.is_grad_enabled() and (qkv.requires_grad
                                    or (mask is not None and mask.requires_grad)):
        return _FusedMHA.apply(qkv, mask, num_heads)
    return _launch(qkv, num_heads, mask)


def _launch(qkv: torch.Tensor, num_heads: int, mask: Optional[torch.Tensor]) -> torch.Tensor:
    """One K1 launch on checked CUDA inputs."""
    b, t, three_d = qkv.shape
    d = three_d // 3
    hd = d // num_heads
    out = torch.empty((b, t, d), dtype=qkv.dtype, device=qkv.device)
    if b == 0:
        return out
    rc = build.call(
        "fused_mha", qkv.device, qkv.data_ptr(), None if mask is None else mask.data_ptr(),
        out.data_ptr(), b, t, num_heads, hd, 1.0 / (hd ** 0.5), _DTYPES[qkv.dtype],
    )
    if rc != 0:
        raise RuntimeError(f"fused_mha kernel launch failed: CUDA error {rc}")
    fused_mha.launches += 1
    return out


fused_mha.launches = 0
fused_mha.backward_recomputes = 0
