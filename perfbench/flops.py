"""Operations and bytes of what a call runs, from the shapes it ran at.

A tower pass is ``(tower, rows, seq)``: a batch of ``rows`` through one
tower at sequence length ``seq`` (the image tower's patches and class
token, or the text bucket). A (M, K) x (K, N) product costs 2·M·K·N;
norms, the softmax and elementwise work are not counted; attention counts
the whole T x T score matrix, as the kernel computes it.
"""

from __future__ import annotations

from perfbench.weights import tower_shapes

__all__ = ["pass_flops", "k1_launches", "k1_bytes_ops", "k2_bytes_ops"]


def _stack_flops(seq: int, width: int, mlp: int, layers: int) -> float:
    dense = 2.0 * seq * width * (3 * width + width + 2 * mlp)
    attention = 4.0 * seq * seq * width
    return layers * (dense + attention)


def pass_flops(cfg: dict, tower: str, rows: int, seq: int) -> float:
    """Forward FLOPs of one tower pass."""
    s = tower_shapes(cfg)
    t, e = s[tower], s["embed_dim"]
    body = _stack_flops(seq, t["width"], t["mlp"], t["layers"]) + 2.0 * t["width"] * e
    if tower == "vision":
        body += 2.0 * (seq - 1) * (t["patch"] ** 2 * 3) * t["width"]
    return rows * body


def k1_launches(cfg: dict, tower: str, rows: int, seq: int):
    """The K1 launches of one forward tower pass: one a layer, as
    ``(rows, seq, width, heads, causal, count)``."""
    t = tower_shapes(cfg)[tower]
    return (rows, seq, t["width"], t["heads"], tower == "text", t["layers"])


def k1_bytes_ops(rows: int, seq: int, width: int, heads: int, causal: bool,
                 item: int) -> tuple:
    """One launch: packed QKV read once, the context written once, the
    additive mask read once; Q·Kᵀ and P·V over every head."""
    nbytes = rows * seq * 3 * width * item + rows * seq * width * item
    if causal:
        nbytes += seq * seq * 4
    ops = 4.0 * rows * seq * seq * width
    return nbytes, ops


def k2_bytes_ops(queries: int, rows: int, dim: int, k: int, valid_pairs: int) -> tuple:
    """One K2 call: queries, corpus and both keys read once, (Q, k) values
    and indices written once; 2·D operations for each pair the keys admit."""
    nbytes = (queries * dim + rows * dim) * 4 + (queries + rows) * 4 + queries * k * 8
    return nbytes, 2.0 * dim * valid_pairs
