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

On a model axis above 1 (``models/layers.py``'s tensor-parallel parts) the
products split over the cards of a row, and the split forms below take
lists of per-card tensors:

- column-split (``in_proj``, ``c_fc``: ``*_columns``): every card sees the
  whole ``x``, so its row scales are the one-device ones, and each
  column's scale is a max over K, which the card holds whole;
- row-split (``out_proj``, ``c_proj``: ``*_rows``): each card holds a
  K-slice of ``x`` and of the kernel. The row scale is the max of the
  cards' row maxima and each column's scale the max of the cards' column
  maxima, so every card quantizes its slice with the whole operands'
  scales. ``int8_dot_rows`` sums the int32 partial products exactly on
  the row's first card and applies the epilogue, bias included, once
  there; ``int8_dot_qat_rows`` sums the fp32 partial products there.

So ``int8_dot``'s split forms give the one-device result bit for bit.
"""

from __future__ import annotations

import functools
from typing import List, Optional, Sequence, Tuple

import torch

__all__ = ["quantize_weight", "int8_dot", "int8_dot_qat", "int8_dot_columns", "int8_dot_rows",
           "int8_dot_qat_columns", "int8_dot_qat_rows"]

_INV_127 = 1.0 / 127.0  # fl(1/127), the factor XLA's rewrite multiplies by
_MIN_ROWS = 17          # torch._int_mm on CUDA takes more than 16 rows


def _scale(amax: torch.Tensor) -> torch.Tensor:
    """``max(amax * fl(1/127), 1e-12)`` in fp32."""
    inv = torch.full((), _INV_127, dtype=torch.float32, device=amax.device)
    return torch.clamp_min(amax.to(torch.float32) * inv, 1e-12)


def _absmax_scale(x: torch.Tensor, dim: int) -> torch.Tensor:
    """``max(max|x| * fl(1/127), 1e-12)`` along ``dim`` in fp32, the absmax
    taken in ``x``'s dtype."""
    return _scale(x.abs().amax(dim=dim, keepdim=True))


def _split_scale(parts: Sequence[torch.Tensor], dim: int, device) -> torch.Tensor:
    """:func:`_absmax_scale` of the tensor that ``parts`` (on their cards)
    cut along ``dim``: the largest of the parts' absmaxes, on ``device``.
    Scales carry no gradient."""
    with torch.no_grad():
        amaxes = [p.abs().amax(dim=dim, keepdim=True).to(device) for p in parts]
        return _scale(functools.reduce(torch.maximum, amaxes))


def _codes(t: torch.Tensor, scales: torch.Tensor) -> torch.Tensor:
    """``round(t / scales)`` as int8, the division in fp32."""
    return torch.round(t.to(torch.float32) / scales).to(torch.int8)


def quantize_weight(w: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Symmetric per-output-channel int8 quantization of a ``(K, N)``
    kernel. Returns ``(w_q (K, N) int8, scales (1, N) fp32)`` with
    ``w ~= w_q * scales``."""
    w = w.to(torch.float32)
    scales = _absmax_scale(w, 0)
    return _codes(w, scales), scales


def _quantize_rows(x2: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per-row int8 codes and ``(M, 1)`` fp32 scales of ``(M, K)``
    activations, the absmax taken in their own dtype."""
    scales = _absmax_scale(x2, -1)
    return _codes(x2, scales), scales


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
    Returns ``(..., N)`` in ``x``'s dtype: :func:`int8_dot_rows` on one
    part."""
    return int8_dot_rows([x], [kernel], bias, x.device)


# torch._int_mm calls on CUDA (a library product, not a kernel of the port)
int8_dot.int_mm_calls = 0


def _ste(real: torch.Tensor, quantized: torch.Tensor) -> torch.Tensor:
    """Forward ``quantized``, backward the identity on ``real``."""
    return real + (quantized - real).detach()


def _fake_quant(t: torch.Tensor, scales: torch.Tensor) -> torch.Tensor:
    """``t`` (fp32) rounded on the int8 grid of ``scales``, straight through."""
    return _ste(t, torch.round(t / scales) * scales)


def int8_dot_qat(x: torch.Tensor, kernel: torch.Tensor,
                 bias: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Quantization-aware surrogate of :func:`int8_dot`: the operands
    rounded on the same int8 grid (fake-quantized in fp32), an fp32
    product, and straight-through gradients to ``x`` and ``kernel``
    (:func:`int8_dot_qat_rows` on one part)."""
    return int8_dot_qat_rows([x], [kernel], bias, x.device)


# -- the tensor-parallel forms: lists of per-card tensors -----------------------


def int8_dot_columns(x: torch.Tensor, kernels: Sequence[torch.Tensor],
                     biases: Sequence[Optional[torch.Tensor]]) -> List[torch.Tensor]:
    """Column-split :func:`int8_dot`: ``x`` sent to each card, each card's
    columns as ``int8_dot`` gives them (the row scales are the whole
    ``x``'s on every card)."""
    return [int8_dot(x.to(kernel.device), kernel, bias)
            for kernel, bias in zip(kernels, biases)]


def int8_dot_rows(xs: Sequence[torch.Tensor], kernels: Sequence[torch.Tensor],
                  bias: Optional[torch.Tensor], device) -> torch.Tensor:
    """Row-split :func:`int8_dot`: ``xs[j]`` ``(..., K_j)`` and ``kernels[j]``
    ``(K_j, N)`` on card j, ``bias`` on ``device`` (the row's first card).
    Each card quantizes its slices with the whole operands' scales (the
    max over the cards of the row and column absmaxes, gathered on
    ``device``) and forms its int32 partial product; the partials are
    summed exactly on ``device``, where the epilogue adds ``bias`` in its
    one rounding. Returns ``(..., N)`` in ``xs[0]``'s dtype on ``device``:
    ``int8_dot`` of the whole operands bit for bit."""
    lead = xs[0].shape[:-1]
    x2 = [x.reshape(-1, x.shape[-1]) for x in xs]
    ws = [kernel.to(torch.float32) for kernel in kernels]
    x_s, w_s = _split_scale(x2, -1, device), _split_scale(ws, 0, device)
    acc = None
    for x, w in zip(x2, ws):
        dev = w.device
        part = _int_matmul(_codes(x, x_s.to(dev)), _codes(w, w_s.to(dev))).to(device)
        acc = part if acc is None else acc + part
    out = _epilogue(acc, x_s * w_s, bias)
    return out.reshape(*lead, ws[0].shape[1]).to(_out_dtype(xs[0]))


def int8_dot_qat_columns(x: torch.Tensor, kernels: Sequence[torch.Tensor],
                         biases: Sequence[Optional[torch.Tensor]]) -> List[torch.Tensor]:
    """Column-split :func:`int8_dot_qat`: ``x`` sent to each card (its
    gradient comes back through the copy), each card's columns as
    ``int8_dot_qat`` gives them."""
    return [int8_dot_qat(x.to(kernel.device), kernel, bias)
            for kernel, bias in zip(kernels, biases)]


def int8_dot_qat_rows(xs: Sequence[torch.Tensor], kernels: Sequence[torch.Tensor],
                      bias: Optional[torch.Tensor], device) -> torch.Tensor:
    """Row-split :func:`int8_dot_qat`: each card's slices fake-quantized
    with the whole operands' scales (as :func:`int8_dot_rows` takes them,
    without a gradient), the fp32 partial products summed on ``device``,
    then ``bias``; straight-through gradients reach every card's slices."""
    xf = [x.to(torch.float32) for x in xs]
    ws = [kernel.to(torch.float32) for kernel in kernels]
    x_s, w_s = _split_scale(xf, -1, device), _split_scale(ws, 0, device)
    total = None
    for x, w in zip(xf, ws):
        dev = w.device
        part = torch.matmul(_fake_quant(x, x_s.to(dev)), _fake_quant(w, w_s.to(dev))).to(device)
        total = part if total is None else total + part
    if bias is not None:
        total = total + bias
    return total.to(_out_dtype(xs[0]))
