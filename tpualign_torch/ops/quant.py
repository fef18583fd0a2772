"""Dynamic int8 matmul of the towers under ``CLIP_QUANT=int8`` (the port's
``tpualign.ops.quant``).

The scheme is tpualign's dynamic W8A8:

- weights: symmetric per-output-channel absmax scales, quantized on every
  call from the fp32 parameters (so a checkpoint load or
  ``load_state_dict`` needs no second copy to refresh);
- activations: symmetric per-row absmax scales, the absmax taken on the
  input's own dtype;
- the product: int8 x int8 with int32 accumulation, then the rank-1
  dequant ``acc * (row_scale x col_scale)`` and the bias, cast back to the
  input's dtype.

On CUDA the integer product is ``torch._int_mm`` (tpualign takes it from
``lax.dot_general`` outside any Pallas kernel); on the CPU it is the plain
int32 product. The scales follow the JAX package's *jitted* functions,
which the towers run: XLA turns ``max|x| / 127`` into ``max|x| *
fl(1/127)`` and contracts the epilogue's product and bias add into one
FMA. The port computes the scale as that product and, on the CPU, the
epilogue in float64 (one rounding to fp32, as the FMA has), so that its
int8 codes equal tpualign's and its outputs agree to an ulp.

``int8_dot_qat`` is the trainable surrogate: the forward rounds on the
same grid, and the straight-through estimator passes gradients to the
unquantized operands.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

__all__ = ["quantize_weight", "int8_dot", "int8_dot_qat"]

_INV_127 = 1.0 / 127.0  # fl(1/127), the factor XLA's rewrite multiplies by
_MIN_ROWS = 17          # torch._int_mm on CUDA takes more than 16 rows


def _absmax_scale(x: torch.Tensor, dim: int) -> torch.Tensor:
    """``max(max|x| * fl(1/127), 1e-12)`` along ``dim`` in fp32."""
    amax = x.abs().amax(dim=dim, keepdim=True).to(torch.float32)
    inv = torch.full((), _INV_127, dtype=torch.float32, device=x.device)
    return torch.clamp_min(amax * inv, 1e-12)


def quantize_weight(w: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Symmetric per-output-channel int8 quantization of a ``(K, N)``
    kernel. Returns ``(w_q (K, N) int8, scales (1, N) fp32)`` with
    ``w ~= w_q * scales``."""
    w = w.to(torch.float32)
    scales = _absmax_scale(w, 0)
    return torch.round(w / scales).to(torch.int8), scales


def _quantize_rows(x2: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per-row int8 codes and ``(M, 1)`` fp32 scales of ``(M, K)``
    activations, the absmax taken in their own dtype."""
    scales = _absmax_scale(x2, -1)
    return torch.round(x2.to(torch.float32) / scales).to(torch.int8), scales


def _int_matmul(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Exact ``(M, K) @ (K, N)`` int8 product, int32 out. On CUDA,
    ``torch._int_mm``, whose rows are padded past 16 with zeros (K and N
    must be multiples of 8); on the CPU, the plain int32 product."""
    if a.device.type != "cuda":
        return torch.matmul(a.to(torch.int32), b.to(torch.int32))
    m = a.shape[0]
    if m < _MIN_ROWS:
        a = torch.cat([a, a.new_zeros((_MIN_ROWS - m, a.shape[1]))])
    int8_dot.int_mm_calls += 1
    return torch._int_mm(a, b)[:m]


def _epilogue(acc: torch.Tensor, scale: torch.Tensor,
              bias: Optional[torch.Tensor]) -> torch.Tensor:
    """``float(acc) * scale (+ bias)`` in fp32. With a bias, one rounding
    of the exact value, as XLA's FMA gives it: float64 on the CPU (the
    product of two fp32 values is exact there), ``addcmul`` on CUDA."""
    accf = acc.to(torch.float32)
    if bias is None:
        return accf * scale
    bias = bias.to(torch.float32)
    if acc.device.type != "cuda":
        return (accf.double() * scale.double() + bias.double()).to(torch.float32)
    return torch.addcmul(bias, accf, scale)


def _out_dtype(x: torch.Tensor) -> torch.dtype:
    return x.dtype if x.is_floating_point() else torch.float32


def int8_dot(x: torch.Tensor, kernel: torch.Tensor,
             bias: Optional[torch.Tensor] = None) -> torch.Tensor:
    """``x @ kernel (+ bias)`` through int8: ``x`` ``(..., K)`` in any
    float dtype, ``kernel`` ``(K, N)`` fp32 (quantized here, per call).
    Returns ``(..., N)`` in ``x``'s dtype."""
    lead = x.shape[:-1]
    w_q, w_s = quantize_weight(kernel)
    x_q, x_s = _quantize_rows(x.reshape(-1, x.shape[-1]))
    out = _epilogue(_int_matmul(x_q, w_q), x_s * w_s, bias)
    return out.reshape(*lead, kernel.shape[1]).to(_out_dtype(x))


# torch._int_mm calls on CUDA (a library product, not a kernel of the port)
int8_dot.int_mm_calls = 0


def _ste(real: torch.Tensor, quantized: torch.Tensor) -> torch.Tensor:
    """Forward ``quantized``, backward the identity on ``real``."""
    return real + (quantized - real).detach()


def int8_dot_qat(x: torch.Tensor, kernel: torch.Tensor,
                 bias: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Quantization-aware surrogate of :func:`int8_dot`: the operands
    rounded on the same int8 grid (fake-quantized in fp32), an fp32
    product, and straight-through gradients to ``x`` and ``kernel``."""
    w = kernel.to(torch.float32)
    w_s = _absmax_scale(w, 0)
    w_fq = _ste(w, torch.round(w / w_s) * w_s)
    xf = x.to(torch.float32)
    x_s = _absmax_scale(xf, -1)
    x_fq = _ste(xf, torch.round(xf / x_s) * x_s)
    out = torch.matmul(x_fq, w_fq)
    if bias is not None:
        out = out + bias
    return out.to(_out_dtype(x))
