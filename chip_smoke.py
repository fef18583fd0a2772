"""Drives tpualign_torch's embed-and-search and serving paths on one NVIDIA GPU.

    python3 chip_smoke.py [--seed 0]

Run from the root of a checkout, on a machine with one CUDA card (an H100
for the numbers in PERF.md). Phases, one JSON line each:

0. the card (``nvidia-smi`` name and power limit) and the torch/CUDA versions;
1. build: the four kernels compiled from ``tpualign_torch/csrc/``, in
   parallel;
2. K1 ``fused_mha`` against its plain version at ViT-B-32's shapes (B=256:
   vision T=50 D=768 H=12 unmasked; text T=16/32/77 D=512 H=8 causal), fp32
   and bf16, with times for the kernel, the plain version and
   ``F.scaled_dot_product_attention`` (a yardstick only; the port never
   calls it);
3. K2 ``masked_sim_topk`` against its plain version at Q=1,024, N=100,000,
   D=512 (1,000 page keys, 1/8 wildcard queries, queries without
   candidates, 16 duplicated corpus rows), k=10 and k=100, with times for
   the kernel, the plain version and ``torch.matmul`` + ``torch.topk``;
4. the slice: ``EmbedEngine`` (ViT-B-32, seeded weights, bf16) embeds 2,048
   images and 8,192 chunk records, ``RetrievalIndex`` runs the Evaluator's
   keyed k=100 search and the ``query --text`` global k=10 search; the
   kernels' launch counters are read around this phase alone;
5. K3 ``masked_sim_topk_quant`` against its plain version at Q=1,024,
   N=1,000,000, D=512 (10,000 page keys, the mix of 3.), for int8 (s8),
   int8 (dequant), int4 and int2, k=10 and k=40, with times for the kernel,
   the plain version and ``torch._int_mm`` (or a dequantized matmul) +
   ``torch.topk``;
6. K4 ``ivf_probe_topk`` against its plain version: an ``IVFIndex`` built
   on the card over 1,000,000 seeded unit rows around 10,000 page topics
   (default geometry: 1,000 lists of capacity 1,536, 125 probes), each
   batch's own probes and union; s8 at Q=2/64/1,024 and k=10/40, fp32,
   dequant, int4 and int2 at Q=64, k=10; with times for the kernel, the
   plain version and a gather + ``torch._int_mm``/``matmul`` +
   ``torch.topk`` yardstick, and the union size;
7. serve: the port's store (1,000,000 chunks on 125,000 pages, 20,000
   images, 100,000 weak alignments) is written to a temporary directory and
   served by ``build_service`` + ``serve_schemas`` at int8 with refine 4 and
   the ViT-B-32 towers; eight clients send 32 requests each over
   /search_text, /search_image (with and without rerank),
   /search_image_bytes, /stats and /healthz, and every answer is held
   against the plain path; then int4 and int2 rebuilds, recall@10 of each
   rung against exact fp32, and ``python -m tpualign_torch query
   --image-id`` against the service; the launch counters are read around
   the clients' run alone;
8. serve_ivf, over the same store: ``python -m tpualign_torch index``
   (RETRIEVAL_INDEX=ivf, int8, refine 4, recall target 0.95) as a
   subprocess, the same build and calibration timed in this process (the
   same structure), ``build_service`` loading the artifact, the clients of
   7. with every answer against the plain path (plain K4, exact rescore),
   recall@10 of int8/int4/int2 at the calibrated and default probe counts,
   and ``query --image-id`` through the artifact; the counters are read
   around the clients' run alone;
9. the kernels line, the card line, and ``{"ok": true, ...}`` last.

Any failed check raises, and the script exits non-zero without the last
line. It needs CUDA and the repository's ``tpualign_torch`` package; it
imports nothing of JAX or ``tpualign``.
"""

from __future__ import annotations

import argparse
import json
import multiprocessing
import subprocess
import sys
import tempfile
import threading
import time

import numpy as np
import torch

# H100 SXM data sheet (dense): HBM rate and peak arithmetic rates
HBM_BYTES_PER_S = 3.35e12
PEAK_FLOPS = {torch.float32: 67e12, torch.bfloat16: 989e12}

B = 256  # BATCH_SIZE default
K1_SHAPES = [("vision", 50, 768, 12, False), ("text16", 16, 512, 8, True),
             ("text32", 32, 512, 8, True), ("text77", 77, 512, 8, True)]
K1_TOL = {torch.float32: (2e-5, 0.0), torch.bfloat16: (2**-6, 2**-7)}  # (atol, rtol)
K2_TOL_VALUES = 1e-5
K2_TIE_GAP = 1e-6


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def check(ok: bool, what: str) -> None:
    if not ok:
        raise AssertionError(what)


def time_ms(fn, iters: int) -> float:
    """Mean device time of ``fn`` over ``iters`` calls (CUDA events, after
    one warm-up call)."""
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def bound_ms(nbytes: float, flops: float, peak: float):
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / peak * 1e3
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else "operations")


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


def phase_build():
    from tpualign_torch.ops import build

    t0 = time.perf_counter()
    libs = build.build_all()
    secs = time.perf_counter() - t0
    emit({"phase": "build", "seconds": secs, "libraries": {k: v.name for k, v in libs.items()}})


def phase_k1(dev, gen):
    import torch.nn.functional as F

    from tpualign_torch.models.text import causal_mask
    from tpualign_torch.ops.attention import fused_mha, fused_mha_reference

    rows = []
    for name, t, d, heads, causal in K1_SHAPES:
        for dtype in (torch.float32, torch.bfloat16):
            qkv = torch.randn(B, t, 3 * d, generator=gen, device=dev).to(dtype)
            mask = causal_mask(t, dev) if causal else None
            got = fused_mha(qkv, heads, mask)
            want = fused_mha_reference(qkv, heads, mask)
            torch.cuda.synchronize()
            err = (got.float() - want.float()).abs()
            atol, rtol = K1_TOL[dtype]
            check(bool(torch.isfinite(got).all()), f"K1 {name} {dtype}: non-finite output")
            check(bool((err <= atol + rtol * want.float().abs()).all()),
                  f"K1 {name} {dtype}: max abs error {err.max().item():.3g}")
            hd = d // heads
            q, k, v = (x.reshape(B, t, heads, hd).transpose(1, 2).contiguous()
                       for x in qkv.split(d, dim=-1))
            ms = time_ms(lambda: fused_mha(qkv, heads, mask), 20)
            plain_ms = time_ms(lambda: fused_mha_reference(qkv, heads, mask), 10)
            lib_ms = time_ms(lambda: F.scaled_dot_product_attention(q, k, v, is_causal=causal), 20)
            item = qkv.element_size()
            nbytes = qkv.numel() * item + B * t * d * item + (t * t * 4 if causal else 0)
            flops = 4.0 * B * heads * t * t * hd  # Q.K^T and P.V
            bms, by = bound_ms(nbytes, flops, PEAK_FLOPS[dtype])
            rows.append({"shape": name, "dtype": str(dtype).split(".")[-1], "B": B, "T": t,
                         "D": d, "heads": heads, "causal": causal,
                         "max_abs_err": err.max().item(), "atol": atol, "rtol": rtol,
                         "ms": ms, "plain_ms": plain_ms, "library_ms": lib_ms,
                         "bound_ms": bms, "bound_by": by})
    emit({"phase": "k1_fused_mha", "results": rows})
    return rows


def _sim_inputs(gen, dev, q, n, d, keys):
    queries = torch.randn(q, d, generator=gen, device=dev)
    corpus = torch.randn(n, d, generator=gen, device=dev)
    corpus[n - 16:] = corpus[:16]                       # exact ties
    queries /= queries.norm(dim=1, keepdim=True)
    corpus /= corpus.norm(dim=1, keepdim=True)
    qk = torch.randint(0, keys, (q,), generator=gen, device=dev, dtype=torch.int32)
    ck = torch.randint(0, keys, (n,), generator=gen, device=dev, dtype=torch.int32)
    qk[::8] = -3                                        # wildcard queries
    qk[3::64] = keys + 7                                # no candidates
    return queries, qk, corpus, ck


def compare_topk(vals, idx, rvals, ridx, what: str) -> float:
    """Empty slots identical; other indices identical except inside runs of
    the plain version's values within K2_TIE_GAP of a neighbour; values
    within K2_TOL_VALUES. Returns the largest value difference."""
    vals, idx, rvals, ridx = (x.cpu().numpy() for x in (vals, idx, rvals, ridx))
    empty = rvals <= -1e30 / 2
    check(bool((idx[empty] == ridx[empty]).all() and (vals[empty] == rvals[empty]).all()),
          f"{what}: empty slots differ")
    close = np.abs(np.diff(rvals, axis=1)) <= K2_TIE_GAP
    near = np.zeros(ridx.shape, bool)
    near[:, 1:] |= close
    near[:, :-1] |= close
    check(bool((idx[~near] == ridx[~near]).all()), f"{what}: indices differ")
    err = float(np.abs(vals - rvals).max())
    check(err <= K2_TOL_VALUES, f"{what}: max abs value error {err:.3g}")
    return err


def phase_k2(dev, gen):
    from tpualign_torch.ops.sim_topk import (
        key_mask, masked_sim_topk, masked_sim_topk_reference)

    q, n, d = 1024, 100_000, 512
    args = _sim_inputs(gen, dev, q, n, d, 1000)
    queries, qk, corpus, ck = args
    valid_pairs = int(key_mask(qk, ck).sum().item())
    rows = []
    for k in (10, 100):
        vals, idx = masked_sim_topk(*args, k)
        rvals, ridx = masked_sim_topk_reference(*args, k)
        torch.cuda.synchronize()
        err = compare_topk(vals, idx, rvals, ridx, f"K2 k={k}")

        def library():
            sims = torch.where(key_mask(qk, ck), queries @ corpus.T, -1e30)
            return torch.topk(sims, k, dim=1)

        ms = time_ms(lambda: masked_sim_topk(*args, k), 5)
        plain_ms = time_ms(lambda: masked_sim_topk_reference(*args, k), 3)
        lib_ms = time_ms(library, 5)
        nbytes = (q * d + n * d) * 4 + (q + n) * 4 + q * k * 8
        bms, by = bound_ms(nbytes, 2.0 * d * valid_pairs, PEAK_FLOPS[torch.float32])
        dense_bms, _ = bound_ms(nbytes, 2.0 * d * q * n, PEAK_FLOPS[torch.float32])
        rows.append({"Q": q, "N": n, "D": d, "k": k, "valid_pairs": valid_pairs,
                     "empty_slots": int((ridx == 2**30).sum().item()),
                     "max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
                     "library_ms": lib_ms, "bound_ms": bms, "bound_by": by,
                     "dense_bound_ms": dense_bms})
    emit({"phase": "k2_masked_sim_topk", "results": rows})
    return rows


INT_PEAK_OPS = 1979e12  # H100 SXM dense int8 tensor-core rate
K3_SHAPE = (1024, 1_000_000, 512, 10_000)  # Q, N, D, page keys
K3_KS = (10, 40)  # k, and the refine over-fetch of k=10 at RETRIEVAL_REFINE=4
K3_SLAB = 128  # queries per slab of the plain version at N=1M


def _k3_variants():
    from tpualign_torch.parallel.retrieval import (
        _quantize_rows, _quantize_rows_int2, _quantize_rows_int4)

    # (name, quantizer, int8_mxu, kernel variant)
    return [("int8", _quantize_rows, True, "s8"),
            ("int8_dequant", _quantize_rows, False, "dequant"),
            ("int4", _quantize_rows_int4, True, "int4"),
            ("int2", _quantize_rows_int2, True, "int2")]


def _in_slabs(fn, queries, qk, *rest, slab=K3_SLAB):
    parts = [fn(queries[s:s + slab], qk[s:s + slab], *rest)
             for s in range(0, len(queries), slab)]
    return torch.cat([p[0] for p in parts]), torch.cat([p[1] for p in parts])


def _k3_library(variant, queries, qk, corpus, ck, scales, k):
    """One PyTorch call per step for the same function: torch._int_mm (after
    an unpack to s8 for int4/int2) or a dequantized matmul, the rescale, the
    mask and torch.topk. A yardstick only; the port never calls it."""
    from tpualign_torch.ops.sim_topk import _unpack_codes, key_mask, quantize_queries

    if variant == "dequant":
        sims = queries @ (corpus.float() * scales[:, None]).T
    else:
        qq, qs = quantize_queries(queries)
        codes = corpus if variant == "s8" else _unpack_codes(corpus, variant).to(torch.int8)
        sims = torch._int_mm(qq, codes.T).float() * qs[:, None] * scales[None, :]
    return torch.topk(torch.where(key_mask(qk, ck), sims, -1e30), k, dim=1)


def phase_k3(dev, gen):
    """K3 against its plain version: every variant at Q=1,024, N=1,000,000,
    D=512 over _sim_inputs' mix, k=10 and k=40."""
    from tpualign_torch.ops.sim_topk import (
        key_mask, masked_sim_topk, masked_sim_topk_quant, masked_sim_topk_reference)

    q, n, d, keys = K3_SHAPE
    queries, qk, corpus, ck = _sim_inputs(gen, dev, q, n, d, keys)
    host = corpus.cpu().numpy()
    del corpus
    valid_pairs = int(sum(key_mask(qk[s:s + K3_SLAB], ck).sum().item()
                          for s in range(0, q, K3_SLAB)))
    rows = []
    for name, quantize, mxu, variant in _k3_variants():
        codes, scales = (torch.from_numpy(a).to(dev) for a in quantize(host))
        kw = dict(corpus_scales=scales, int8_mxu=mxu)
        for k in K3_KS:
            before = masked_sim_topk_quant.launches
            vals, idx = masked_sim_topk(queries, qk, codes, ck, k, **kw)
            torch.cuda.synchronize()
            check(masked_sim_topk_quant.launches == before + 1, f"K3 {name}: no launch")
            rvals, ridx = _in_slabs(
                lambda a, b: masked_sim_topk_reference(a, b, codes, ck, k, **kw), queries, qk)
            if variant == "dequant":
                err = compare_topk(vals, idx, rvals, ridx, f"K3 {name} k={k}")
            else:
                check(bool(torch.equal(idx, ridx)), f"K3 {name} k={k}: indices differ")
                check(bool(torch.equal(vals, rvals)), f"K3 {name} k={k}: values differ")
                err = 0.0
            ms = time_ms(lambda: masked_sim_topk(queries, qk, codes, ck, k, **kw), 5)
            plain_ms = time_ms(lambda: _in_slabs(
                lambda a, b: masked_sim_topk_reference(a, b, codes, ck, k, **kw),
                queries, qk), 1)
            lib_ms = time_ms(lambda: _k3_library(variant, queries, qk, codes, ck, scales, k), 3)
            qbytes = q * d * (4 if variant == "dequant" else 1) + q * 4
            nbytes = qbytes + codes.numel() + n * 4 + (q + n) * 4 + q * k * 8
            peak = PEAK_FLOPS[torch.float32] if variant == "dequant" else INT_PEAK_OPS
            bms, by = bound_ms(nbytes, 2.0 * d * valid_pairs, peak)
            dense_bms, _ = bound_ms(nbytes, 2.0 * d * q * n, peak)
            rows.append({"variant": name, "kernel_variant": variant, "Q": q, "N": n, "D": d,
                         "k": k, "corpus_bytes": codes.numel(), "valid_pairs": valid_pairs,
                         "empty_slots": int((ridx == 2**30).sum().item()),
                         "max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
                         "library_ms": lib_ms, "bound_ms": bms, "bound_by": by,
                         "dense_bound_ms": dense_bms,
                         "tolerance": ({"values_atol": K2_TOL_VALUES, "tie_gap": K2_TIE_GAP}
                                       if variant == "dequant" else "identical")})
        del codes, scales
    emit({"phase": "k3_masked_sim_topk_quant", "results": rows})
    return rows


K4_SHAPE = (1_000_000, 512, 10_000)  # N, D, page topics (the serve store's scale)
# (name, layout, int8_mxu, Q, k): s8 at serving and batch sizes, k=10 and the
# refine over-fetch k=40; the other variants at Q=64, k=10
K4_CASES = ([("int8", "int8", True, q, k) for q in (2, 64, 1024) for k in (10, 40)]
            + [("fp32", "fp32", False, 64, 10), ("int8_dequant", "int8", False, 64, 10),
               ("int4", "int4", True, 64, 10), ("int2", "int2", True, 64, 10)])
K4_SLAB = 64  # queries per slab of the plain version and of the pair count


def _k4_queries(gen, dev, topics, q):
    """Queries around page topics, keyed to their page; 1/8 wildcard, some
    keyed to a page that does not exist (no candidates)."""
    n_pages = topics.shape[0]
    page = torch.randint(0, n_pages, (q,), generator=gen, device=dev, dtype=torch.int32)
    qv = topics[page] + 1.5 * torch.randn(q, topics.shape[1], generator=gen, device=dev)
    qv /= qv.norm(dim=1, keepdim=True)
    qk = page.clone()
    qk[::8] = -3
    qk[3::64] = n_pages + 7
    return qv, qk


def _k4_slabs(fn, q, qk, probe):
    parts = [fn(q[s:s + K4_SLAB], qk[s:s + K4_SLAB], probe[s:s + K4_SLAB])
             for s in range(0, len(q), K4_SLAB)]
    return torch.cat([p[0] for p in parts]), torch.cat([p[1] for p in parts])


def _k4_library(variant, q, qk, probe, uids, emb, ck, scales, k, cap, n_lists):
    """One PyTorch call per step for the same function: the union's rows
    gathered, torch.matmul (dequantized rows for dequant) or torch._int_mm
    (after an unpack to s8 for int4/int2; queries padded to its 17-row
    minimum), the rescale, the key and membership mask, torch.topk. A
    yardstick only; the port never calls it."""
    from tpualign_torch.ops.ivf_topk import _membership, union_rows
    from tpualign_torch.ops.sim_topk import _unpack_codes, key_mask, quantize_queries

    blocks, rows = union_rows(uids, cap, n_lists)
    mask = key_mask(qk, ck[rows]) & _membership(probe, blocks, n_lists).repeat_interleave(
        cap, dim=1)
    c = emb[rows]
    if variant is None:
        sims = q @ c.T
    elif variant == "dequant":
        sims = q @ (c.float() * scales[rows][:, None]).T
    else:
        qq, qs = quantize_queries(q)
        codes = c if variant == "s8" else _unpack_codes(c, variant).to(torch.int8)
        qq = torch.nn.functional.pad(qq, (0, 0, 0, max(0, 32 - len(qq))))
        sims = (torch._int_mm(qq, codes.T)[:len(q)].float() * qs[:, None]
                * scales[rows][None, :])
    vals, pos = torch.topk(torch.where(mask, sims, -1e30), k, dim=1)
    return vals, rows[pos]


def phase_k4(dev, gen):
    """K4 against its plain version: an IVFIndex built on the card over
    K4_SHAPE (default geometry: 1,000 lists, capacity 1,536, 125 probes),
    the union and probes of each query batch, every variant (K4_CASES)."""
    from tpualign_torch.parallel.ivf import IVFIndex, _probe, _union
    from tpualign_torch.parallel.retrieval import _QUANTIZERS, _tensor

    n, d, n_pages = K4_SHAPE
    topics = torch.randn(n_pages, d, generator=gen, device=dev)
    page = torch.randint(0, n_pages, (n,), generator=gen, device=dev, dtype=torch.int32)
    rows = topics[page] + 1.5 * torch.randn(n, d, generator=gen, device=dev)
    host = (rows / rows.norm(dim=1, keepdim=True)).cpu().numpy()
    del rows
    t0 = time.perf_counter()
    index = IVFIndex(host, keys=page.cpu().numpy(), device=dev)
    torch.cuda.synchronize()
    build_s = time.perf_counter() - t0
    cap, n_lists = index.capacity, index.n_lists
    check(n_lists == 1000 and cap <= 1536 and index.n_probes == 125,
          f"K4 geometry: {n_lists} lists, capacity {cap}, {index.n_probes} probes")
    layouts = {"fp32": (index._emb, None)}
    for name in ("int8", "int4", "int2"):
        codes, scales = _QUANTIZERS[name](host)
        layouts[name] = index._gather(_tensor(codes, dev), _tensor(scales, dev))
    del host
    ck = index._keys
    rows_total = index._emb.shape[0]
    queries = {q: _k4_queries(gen, dev, topics, q) for q in (2, 64, 1024)}
    rows_out = []
    for name, layout, mxu, q, k in K4_CASES:
        qv, qk = queries[q]
        emb, scales = layouts[layout]
        probe = _probe(qv, qk, index.centroids, index.n_probes, n_lists)
        row = _k4_measure(f"K4 {name} Q={q} k={k}", qv, qk, probe,
                          _union(probe, n_lists, index.spill_blocks), emb, ck, scales, mxu, k,
                          cap, n_lists)
        rows_out.append({"variant": name, "Q": q, "k": k, "N": n, "D": d, "n_lists": n_lists,
                         "capacity": cap, "n_probes": index.n_probes,
                         "spill_blocks": index.spill_blocks, "layout_rows": rows_total, **row})
    emit({"phase": "k4_ivf_probe_topk", "index_build_s": build_s, "results": rows_out})
    return rows_out


def _k4_measure(what, qv, qk, probe, uids, emb, ck, scales, mxu, k, cap, n_lists) -> dict:
    """One K4 launch against its plain version on the same inputs, then its
    time, the plain version's, the library yardstick's and the bound.

    The bound's bytes: the union's keys (4 B a row: every row's key is read
    to admit it), the embedding row and scale of each distinct row that
    some query admits (rows none admits, empty slots included, need not be
    read), the queries, probes, uids and outputs. Its operations: 2·D for
    each admitted (query, row) pair."""
    from tpualign_torch.ops.ivf_topk import (
        _membership, ivf_probe_topk, ivf_probe_topk_reference, union_rows)
    from tpualign_torch.ops.sim_topk import key_mask, quant_variant

    q, d = qv.shape
    variant = quant_variant(emb, d, scales, mxu)
    args = (uids, emb, ck, k, cap, n_lists)
    kw = dict(packed_scales=scales, int8_mxu=mxu)
    before = ivf_probe_topk.launches
    vals, idx = ivf_probe_topk(qv, qk, probe, *args, **kw)
    torch.cuda.synchronize()
    check(ivf_probe_topk.launches == before + 1, f"{what}: no launch")

    def plain():
        return _k4_slabs(lambda a, b, c: ivf_probe_topk_reference(a, b, c, *args, **kw),
                         qv, qk, probe)

    rvals, ridx = plain()
    if variant in (None, "dequant"):
        err = compare_topk(vals, idx, rvals, ridx, what)
    else:
        check(bool(torch.equal(idx, ridx)), f"{what}: indices differ")
        check(bool(torch.equal(vals, rvals)), f"{what}: values differ")
        err = 0.0
    ms = time_ms(lambda: ivf_probe_topk(qv, qk, probe, *args, **kw), 20 if q < 1024 else 3)
    plain_ms = time_ms(plain, 1)
    lib_ms = time_ms(lambda: _k4_library(variant, qv, qk, probe, uids, emb, ck, scales, k,
                                         cap, n_lists), 3)
    blocks, urows = union_rows(uids, cap, n_lists)
    pairs = 0
    admitted = torch.zeros(len(urows), dtype=torch.bool, device=urows.device)
    for s0 in range(0, q, K4_SLAB):
        member = _membership(probe[s0:s0 + K4_SLAB], blocks, n_lists)
        m = key_mask(qk[s0:s0 + K4_SLAB], ck[urows]) & member.repeat_interleave(cap, dim=1)
        pairs += int(m.sum().item())
        admitted |= m.any(dim=0)
    distinct = int(admitted.sum().item())
    row_bytes = emb.shape[1] * emb.element_size() + (4 if scales is not None else 0)
    qbytes = q * d * (1 if variant in ("s8", "int4", "int2") else 4) + q * 8
    nbytes = (len(urows) * 4 + distinct * row_bytes + qbytes + probe.numel() * 4
              + len(uids) * 4 + q * k * 8)
    peak = INT_PEAK_OPS if variant in ("s8", "int4", "int2") else PEAK_FLOPS[torch.float32]
    bms, by = bound_ms(nbytes, 2.0 * d * pairs, peak)
    return {"kernel_variant": variant or "fp32", "union_blocks": len(blocks),
            "union_rows": len(urows), "admitted_rows": distinct, "admitted_pairs": pairs,
            "empty_slots": int((ridx == 2**30).sum().item()), "max_abs_err": err, "ms": ms,
            "plain_ms": plain_ms, "library_ms": lib_ms, "bound_ms": bms, "bound_by": by,
            "tolerance": ({"values_atol": K2_TOL_VALUES, "tie_gap": K2_TIE_GAP}
                          if variant in (None, "dequant") else "identical")}


def _chunk_texts(rng, count):
    """Texts whose byte-level token counts fill the 16, 32 and 77 buckets,
    with every 97th text empty (a placeholder)."""
    words = np.array(["oil", "filter", "bolt", "pakking", "vervang", "draai",
                      "los", "torque", "25", "Nm", "check", "peil", "pump",
                      "de", "het", "seal", "valve", "hose", "zie", "fig"])
    texts = []
    for i in range(count):
        if i % 97 == 0:
            texts.append("")
            continue
        n_words = (2, 5, 14)[i % 3] + int(rng.integers(0, 3))
        texts.append(" ".join(rng.choice(words, n_words)))
    return texts


def phase_slice(dev, seed):
    from tpualign_torch.config import ModelConfig
    from tpualign_torch.models.layers import MultiHeadAttention
    from tpualign_torch.ops.attention import fused_mha
    from tpualign_torch.ops.preprocess import CLIP_MEAN, CLIP_STD
    from tpualign_torch.ops.sim_topk import masked_sim_topk, masked_sim_topk_reference
    from tpualign_torch.parallel import EmbedEngine, RetrievalIndex
    from tpualign_torch.parallel.retrieval import encode_keys

    rng = np.random.default_rng(seed)
    n_img, n_chunk, n_pages, n_text_q = 2048, 8192, 1024, 256
    u8 = rng.integers(0, 256, (n_img, 224, 224, 3), dtype=np.uint8)
    images = ((u8 / np.float32(255.0) - np.asarray(CLIP_MEAN, np.float32))
              / np.asarray(CLIP_STD, np.float32)).astype(np.float32)
    del u8
    page_of_img = rng.integers(0, n_pages, n_img)
    img_man = [f"manual-{p // 8}" for p in page_of_img]
    img_pg = [int(p % 8) for p in page_of_img]
    page_of_chunk = rng.integers(0, n_pages, n_chunk)
    texts = _chunk_texts(rng, n_chunk)
    chunks = [{"chunk_id": f"c{i}", "text": texts[i], "manual_id": f"manual-{p // 8}",
               "page": int(p % 8)} for i, p in enumerate(page_of_chunk)]
    queries = [" ".join(rng.choice(["replace", "the", "oil", "filter", "bolt", "pump"], 4))
               for _ in range(n_text_q)]

    engine = EmbedEngine(ModelConfig("ViT-B-32"), device=dev, seed=seed)
    bucket_of = np.searchsorted(engine.text_buckets,
                                np.argmax(engine.tokenizer(texts), axis=1) + 1)
    buckets = {int(engine.text_buckets[b]): int((bucket_of == b).sum())
               for b in np.unique(bucket_of)}
    check(set(buckets) == {16, 32, 77}, f"chunk texts fill buckets {buckets}")

    # warm-up, untimed: the caching allocator's first blocks and cuBLAS's
    # first calls at these shapes, which a long run pays once
    engine.encode_image_batch(images[:engine.batch_size])
    engine.encode_text_batch(texts[:engine.batch_size])

    fused_mha.launches = masked_sim_topk.launches = 0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    img_emb = engine.encode_image_batch(images)
    t_img = time.perf_counter() - t0
    t0 = time.perf_counter()
    chunk_emb = engine.embed_chunk_records(chunks)
    t_txt = time.perf_counter() - t0

    t0 = time.perf_counter()
    index = RetrievalIndex(chunk_emb, [c["manual_id"] for c in chunks],
                           [c["page"] for c in chunks], device=dev)
    t_build = time.perf_counter() - t0
    t0 = time.perf_counter()
    vals, idx = index.search(img_emb, img_man, img_pg, k=100)
    t_eval = time.perf_counter() - t0

    img_index = RetrievalIndex(img_emb, img_man, img_pg, device=dev)
    t0 = time.perf_counter()
    q_emb = engine.encode_text_batch(queries)
    t1 = time.perf_counter()
    qvals, qidx = img_index.search(q_emb, k=10, global_search=True)
    t_query = time.perf_counter() - t0
    t_query_search = time.perf_counter() - t1
    torch.cuda.synchronize()
    launches = {"fused_mha": fused_mha.launches, "masked_sim_topk": masked_sim_topk.launches}

    for name, emb in (("images", img_emb), ("chunks", chunk_emb), ("queries", q_emb)):
        check(bool(np.isfinite(emb).all()), f"{name}: non-finite embeddings")
        norm_err = float(np.abs(np.linalg.norm(emb, axis=1) - 1.0).max())
        check(norm_err <= 1e-5, f"{name}: norms off by {norm_err:.3g}")
    check(vals.shape == (n_img, 100) and qidx.shape == (n_text_q, 10), "search shapes")

    # each search against the plain version on the same embeddings and keys
    errs = {}
    qk, _ = encode_keys(img_man, img_pg, dict(index.vocab))
    for what, ix, q, keys, k, (v, i) in (
            ("keyed_k100", index, img_emb, qk, 100, (vals, idx)),
            ("global_k10", img_index, q_emb, np.full(n_text_q, -3, np.int32), 10, (qvals, qidx))):
        qt = torch.from_numpy(q).to(dev)
        kt = torch.from_numpy(keys).to(dev)
        rv, ri = masked_sim_topk_reference(qt, kt, ix._corpus, ix._keys, k)
        ri = torch.where(rv <= -1e30 / 2, torch.full_like(ri, -1), ri)
        errs[what] = compare_topk(torch.from_numpy(v), torch.from_numpy(i), rv, ri.long(), what)

    # the bf16 towers with K1 against the same towers on the plain path
    attn = [m for m in engine.model.modules() if isinstance(m, MultiHeadAttention)]
    fused_img, fused_txt = img_emb[:64], engine.encode_text_batch(queries[:64])
    for m in attn:
        m.use_fused_attention = False
    plain_img = engine.encode_image_batch(images[:64])
    plain_txt = engine.encode_text_batch(queries[:64])
    for m in attn:
        m.use_fused_attention = True
    tower_err = {"image": float(np.abs(fused_img - plain_img).max()),
                 "text": float(np.abs(fused_txt - plain_txt).max())}
    for tower, e in tower_err.items():
        check(e <= 2e-2, f"{tower} tower, K1 against the plain path: max abs {e:.3g}")

    emit({"phase": "slice", "model": "ViT-B-32", "dtype": "bfloat16", "batch_size": engine.batch_size,
          "images": n_img, "chunks": n_chunk, "chunk_buckets": buckets,
          "placeholders": sum(1 for t in texts if not t),
          "image_s": t_img, "chunk_s": t_txt,
          "images_per_s": n_img / t_img, "chunks_per_s": n_chunk / t_txt,
          "pairs_per_s": 1.0 / (t_img / n_img + t_txt / n_chunk),
          "index_build_s": t_build, "eval_search_s": t_eval,
          "eval_qps": n_img / t_eval,
          "text_query_s": t_query, "text_query_qps": n_text_q / t_query,
          "text_query_search_qps": n_text_q / t_query_search,
          "search_value_err": errs, "tower_fused_vs_plain_max_abs": tower_err,
          "launches": launches})
    for name, count in launches.items():
        check(count > 0, f"{name} was not launched on the main path")
    phase_profile(engine, images, texts)
    return launches


def profile_window(fn, top: int = 8) -> dict:
    """One call of ``fn`` under torch.profiler (CUPTI): wall time, device
    busy time (the sum of the device-side events: kernels and copies) and
    the events that took most."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3
    kernels = sorted(((e.key, e.self_device_time_total / 1e3, e.count)
                      for e in prof.key_averages()
                      if e.device_type == torch.autograd.DeviceType.CUDA
                      and e.self_device_time_total > 0),
                     key=lambda x: -x[1])
    busy = sum(ms for _, ms, _ in kernels)
    return {"wall_ms": wall, "device_busy_ms": busy, "idle_share": 1.0 - busy / wall,
            "top_kernels": [{"name": n[:90], "ms": ms, "count": c} for n, ms, c in kernels[:top]]}


def phase_profile(engine, images, texts) -> None:
    """Where one batch's time goes (profiler overhead included in wall)."""
    from tpualign_torch.tokenizer import ClipTokenizer

    long_texts = [t for t in texts if len(t) > 60][:engine.batch_size]
    t0 = time.perf_counter()
    ClipTokenizer()(texts)  # a cold tokenizer: no word cache
    tok_s = time.perf_counter() - t0
    emit({"phase": "profile",
          "tokenize_cold_s_per_1k_texts": tok_s / len(texts) * 1e3,
          "image_batch": profile_window(lambda: engine.encode_image_batch(images[:engine.batch_size])),
          "text_batch": profile_window(lambda: engine.encode_text_batch(long_texts))})


# the serve phase's store (vanilla_clip): 1,000 manuals x 125 pages, 8
# chunks per page, 20,000 stored images on distinct pages, 5 weak
# alignments per image
SERVE_MANUALS, SERVE_PAGES, SERVE_CHUNKS_PER_PAGE = 1000, 125, 8
SERVE_IMAGES, SERVE_ALIGNS = 20_000, 5
SERVE_CLIENTS, SERVE_REQUESTS = 8, 32
SERVE_RECALL_QUERIES = 1024
SERVE_KINDS = ("search_text", "search_image", "search_image_bytes", "search_image_rerank",
               "stats", "healthz")
SERVE_TEXTS = ["replace the oil filter", "torque the drain bolt to 25 Nm", "check the pump seal",
               "vervang de pakking", "draai de bout los", "zie figuur 3",
               "hydraulic hose routing", "valve clearance check"]


def _serve_store(root, dev, seed):
    """Writes the serve phase's store with the port's EmbeddingStore. Rows
    are seeded unit vectors around a topic per page (the tower is not run
    on 1M chunks): chunks and images of a page share its topic."""
    from tpualign_torch.store import EmbeddingStore

    gen = torch.Generator(device=dev).manual_seed(seed + 1)
    n_pages = SERVE_MANUALS * SERVE_PAGES
    d = 512
    topics = torch.randn(n_pages, d, generator=gen, device=dev)
    page_of_chunk = torch.arange(n_pages, device=dev).repeat_interleave(SERVE_CHUNKS_PER_PAGE)
    chunk = topics[page_of_chunk] + 1.5 * torch.randn(len(page_of_chunk), d, generator=gen,
                                                       device=dev)
    chunk = (chunk / chunk.norm(dim=1, keepdim=True)).cpu().numpy()
    rng = np.random.default_rng(seed)
    img_pages = np.sort(rng.choice(n_pages, SERVE_IMAGES, replace=False))
    img = topics[torch.from_numpy(img_pages).to(dev)]
    img = img + 1.5 * torch.randn(img.shape, generator=gen, device=dev)
    img = (img / img.norm(dim=1, keepdim=True)).cpu().numpy()

    def where(page):
        return f"manual-{page // SERVE_PAGES:04d}", int(page % SERVE_PAGES)

    chunk_recs = []
    for page in range(n_pages):
        manual, pg = where(page)
        for c in range(SERVE_CHUNKS_PER_PAGE):
            chunk_recs.append({"chunk_id": f"{manual}-p{pg:03d}-c{c}", "manual_id": manual,
                               "page": pg, "text": f"step {c} on page {pg} of {manual}"})
    img_recs, aligns = [], []
    for i, page in enumerate(img_pages):
        manual, pg = where(int(page))
        img_recs.append({"image_id": f"img{i:05d}", "manual_id": manual, "page": pg,
                         "caption": f"figure {i}", "filename": None})
        for c in rng.choice(SERVE_CHUNKS_PER_PAGE, SERVE_ALIGNS, replace=False):
            aligns.append((f"img{i:05d}", f"{manual}-p{pg:03d}-c{c}", float(rng.random()),
                           "positional"))
    store = EmbeddingStore(root, embed_dim=d)
    store.setup(["vanilla_clip"])
    store.insert_chunks("vanilla_clip", chunk_recs, chunk)
    store.insert_images("vanilla_clip", img_recs, img)
    store.insert_alignments("vanilla_clip", aligns)
    store.save(["vanilla_clip"])
    return img_recs


def _png(rng, w=320, h=240) -> bytes:
    import io

    from PIL import Image

    buf = io.BytesIO()
    Image.fromarray(rng.integers(0, 256, (h, w, 3), dtype=np.uint8)).save(buf, format="PNG")
    return buf.getvalue()


class _Recorder:
    """Wraps an encoder and keeps every row it returned, by input, so that
    each answer can be held against the embedding the service used."""

    def __init__(self, fn):
        self.fn = fn
        self.seen = {}
        self.lock = threading.Lock()

    def __call__(self, items):
        out = self.fn(items)
        with self.lock:
            for item, row in zip(items, out):
                self.seen.setdefault(item, []).append(np.array(row))
        return out


def _plain_refined(index, emb, keys, k=10):
    """The plain path of a refined quantized search: the plain K3 version
    over the index's codes for k*refine candidates, then the exact host
    rescore. Returns host (vals, idx) as ``index.search`` does."""
    from tpualign_torch.ops.sim_topk import masked_sim_topk_reference
    from tpualign_torch.parallel.retrieval import NEG_INF, _refine_rescore

    kf = min(k * index.refine, index.n)
    q = torch.from_numpy(np.ascontiguousarray(emb, np.float32)).to(index.device)
    qk = torch.from_numpy(np.asarray(keys, np.int32)).to(index.device)
    _, idx = _in_slabs(lambda a, b: masked_sim_topk_reference(
        a, b, index._corpus, index._keys, kf, corpus_scales=index._corpus_scales,
        int8_mxu=True), q, qk)
    idx = idx.cpu().numpy().astype(np.int64)
    idx = np.where(idx >= index.n, -1, idx)
    vals = np.where(idx >= 0, 0.0, NEG_INF).astype(np.float32)
    return _refine_rescore(np.asarray(emb, np.float32), vals, idx, index._refine_corpus, k)


def _plain_refined_ivf(index, emb, keys, k=10, n_probes=None):
    """The plain path of a refined IVF search: the index's probes and union,
    the plain K4 version over its layout for k*refine candidates, the
    packed rows mapped to corpus ids, then the exact host rescore."""
    from tpualign_torch.ops.ivf_topk import ivf_probe_topk_reference
    from tpualign_torch.parallel.ivf import _probe, _union
    from tpualign_torch.parallel.retrieval import NEG_INF, _refine_rescore

    kf = min(k * max(1, index.refine), index.n)
    q = torch.from_numpy(np.ascontiguousarray(emb, np.float32)).to(index.device)
    qk = torch.from_numpy(np.asarray(keys, np.int32)).to(index.device)
    probe = _probe(q, qk, index.centroids, n_probes or index.n_probes, index.n_lists)
    uids = _union(probe, index.n_lists, index.spill_blocks)
    _, pidx = _k4_slabs(lambda a, b, c: ivf_probe_topk_reference(
        a, b, c, uids, index._emb, index._keys, kf, index.capacity, index.n_lists,
        packed_scales=index._scales, int8_mxu=index.int8_mxu), q, qk, probe)
    empty = pidx >= 2**30
    idx = index._ids[pidx.clamp(max=len(index._ids) - 1).long()].long()
    idx = torch.where(empty, -1, idx).cpu().numpy()
    vals = np.where(idx >= 0, 0.0, NEG_INF).astype(np.float32)
    return _refine_rescore(np.asarray(emb, np.float32), vals, idx, index._refine_corpus, k)


def _pairs(vals, idx, chunk_ids):
    """(chunk_id, score) rows, as the service formats its winners."""
    return [[(chunk_ids[j], float(v)) for v, j in zip(vr, ir) if j >= 0]
            for vr, ir in zip(vals, idx)]


def _as_pairs(rows):
    return [[(h["chunk_id"], h["score"]) for h in row] for row in rows]


def _client(port, thread, images, pngs, out, errors, count=None):
    """One client thread: ``count`` requests on one keep-alive connection,
    cycling through SERVE_KINDS from its own offset."""
    import base64
    import http.client

    rng = np.random.default_rng(1000 + thread)
    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=120)
    try:
        for j in range(SERVE_REQUESTS if count is None else count):
            kind = SERVE_KINDS[(thread + j) % len(SERVE_KINDS)]
            body = None
            if kind == "search_text":
                start = int(rng.integers(0, len(SERVE_TEXTS)))
                body = {"texts": [SERVE_TEXTS[(start + t) % len(SERVE_TEXTS)] for t in range(4)],
                        "k": 10, "global": True}
            elif kind.startswith("search_image") and kind != "search_image_bytes":
                body = {"image_ids": [images[int(i)]["image_id"]
                                      for i in rng.integers(0, len(images), 2)], "k": 10}
                if kind == "search_image_rerank":
                    body["rerank"] = 0.3
            elif kind == "search_image_bytes":
                body = {"images_b64": [base64.b64encode(pngs[j % len(pngs)]).decode()], "k": 10}
            t0 = time.perf_counter()
            if body is None:
                conn.request("GET", "/" + kind)
            else:
                path = "/search_image" if kind == "search_image_rerank" else "/" + kind
                conn.request("POST", path, json.dumps(body),
                             {"Content-Type": "application/json"})
            resp = conn.getresponse()
            payload = json.loads(resp.read())
            out.append({"kind": kind, "status": resp.status, "s": time.perf_counter() - t0,
                        "request": body, "response": payload,
                        "png": j % len(pngs) if kind == "search_image_bytes" else None})
    except Exception as e:  # handed to the phase, which fails on it
        errors.append(repr(e))
    finally:
        conn.close()


def _load(port, image_ids, pngs, clients, count, conn):
    """The load: ``clients`` threads of _client, ``count`` requests each,
    started together; sends back (answers, errors, wall seconds)."""
    images = [{"image_id": i} for i in image_ids]
    results, errors = [], []
    clients = [threading.Thread(target=_client,
                                args=(port, t, images, pngs, results, errors, count))
               for t in range(clients)]
    t0 = time.perf_counter()
    for c in clients:
        c.start()
    for c in clients:
        c.join()
    conn.send((results, errors, time.perf_counter() - t0))
    conn.close()


def _pct(xs, p):
    xs = sorted(xs)
    return xs[min(len(xs) - 1, int(p * len(xs)))] * 1e3


def _drive(service, images, pngs, counters, nagle: bool = False) -> dict:
    """Serves ``service`` over HTTP: a warm-up request of each kind, then
    SERVE_CLIENTS clients (in a process of their own, so that the server's
    process and its interpreter lock serve the requests alone) with
    ``counters`` (functions with a ``launches`` count) set to 0 just before
    and read just after, /stats, and a serial pass from one client (again
    with Nagle's algorithm on, as tpualign's server has it, with
    ``nagle``)."""
    import urllib.request

    from tpualign_torch.serving.server import _ServiceBox, serve_schemas

    httpd = serve_schemas({"vanilla_clip": _ServiceBox(service)}, "vanilla_clip",
                          "127.0.0.1", 0)
    server = threading.Thread(target=httpd.serve_forever, daemon=True)
    server.start()
    port = httpd.server_address[1]
    ids = [im["image_id"] for im in images]
    out = {"serial": [], "nagle": []}
    try:
        warm = []
        _client(port, 0, images, pngs, warm, [], count=len(SERVE_KINDS))
        check(all(r["status"] == 200 for r in warm), f"warm-up: {warm[0]['response']}")
        torch.cuda.synchronize()
        for fn in counters:
            fn.launches = 0
        ctx = multiprocessing.get_context("spawn")
        recv, send = ctx.Pipe(duplex=False)
        load = ctx.Process(target=_load, args=(port, ids, pngs, SERVE_CLIENTS, SERVE_REQUESTS,
                                               send))
        load.start()
        check(recv.poll(600), "the clients' process sent no answers within 600 s")
        results, errors, wall = recv.recv()
        load.join()
        torch.cuda.synchronize()
        out["launches"] = {fn.__name__: fn.launches for fn in counters}
        out["stats"] = json.loads(urllib.request.urlopen(f"http://127.0.0.1:{port}/stats",
                                                         timeout=60).read())
        _client(port, 0, images, pngs, out["serial"], [], count=4 * len(SERVE_KINDS))
        if nagle:
            httpd.RequestHandlerClass.disable_nagle_algorithm = False
            _client(port, 0, images, pngs, out["nagle"], [], count=4 * len(SERVE_KINDS))
            httpd.RequestHandlerClass.disable_nagle_algorithm = True
    finally:
        httpd.shutdown()
        httpd.server_close()
        server.join()
    check(not errors, f"client errors: {errors[:3]}")
    check(len(results) == SERVE_CLIENTS * SERVE_REQUESTS, f"{len(results)} answers")
    bad = [r for r in results + out["serial"] + out["nagle"] if r["status"] != 200]
    check(not bad, f"{len(bad)} requests failed, e.g. {bad[:1]}")
    out.update(results=results, warm=warm, wall=wall)
    out["endpoints"] = {}
    for kind in SERVE_KINDS:
        lat = [r["s"] for r in results if r["kind"] == kind]
        out["endpoints"][kind] = {"requests": len(lat), "p50_ms": _pct(lat, 0.5),
                                  "p99_ms": _pct(lat, 0.99), "qps": len(lat) / wall}
    out["serial_p50_ms"] = {name: {kind: _pct([r["s"] for r in rs if r["kind"] == kind], 0.5)
                                   for kind in SERVE_KINDS}
                            for name, rs in (("nodelay", out["serial"]), ("nagle", out["nagle"]))
                            if rs}
    return out


def _check_answers(run, service, images, pngs, text_enc, image_enc, plain_refined) -> int:
    """Every search answer of ``run`` against the plain path, all rows in
    one batch: ``plain_refined(index, rows, keys)`` gives host (vals, idx)
    as ``index.search`` does. Returns the number of answers checked."""
    from tpualign_torch.parallel.retrieval import WILDCARD_KEY, encode_keys
    from tpualign_torch.weaksup.rerank import rerank_with_weak_scores

    index = service.index
    img_emb = service._image_embs
    by_id = {im["image_id"]: (i, im) for i, im in enumerate(images)}
    row_of, rows, keys = {}, [], []
    for tag, seen in (("text", text_enc.seen), ("png", image_enc.seen)):
        for item, embs in seen.items():
            for e_no, e in enumerate(embs):
                row_of[(tag, item, e_no)] = len(rows)
                rows.append(e)
                keys.append(WILDCARD_KEY)
    answers = run["results"] + run["warm"] + run["serial"] + run["nagle"]
    asked = {i for r in answers if r["kind"].startswith("search_image")
             and r["kind"] != "search_image_bytes" for i in r["request"]["image_ids"]}
    for image_id in sorted(asked):
        i, im = by_id[image_id]
        row_of[("img", image_id)] = len(rows)
        rows.append(img_emb[i])
        keys.append(encode_keys([im["manual_id"]], [im["page"]], dict(index.vocab))[0][0])
    pv, pi = plain_refined(index, np.stack(rows), keys)

    def plain(*tags, rerank=None):
        sel = [row_of[t] for t in tags]
        v, i = pv[sel], pi[sel]
        if rerank is not None:
            v, i = rerank_with_weak_scores(v, i, [t[1] for t in tags], service.chunk_ids,
                                           service.weak_lookup, alpha=rerank)
        return _pairs(v, i, service.chunk_ids)

    checked = 0
    for r in answers:
        kind, req, got = r["kind"], r["request"], r["response"]
        if kind in ("stats", "healthz"):
            check(got.get("status") == "ok", f"/{kind}: {got}")
            continue
        got = _as_pairs(got["results"])
        if kind == "search_text":
            for text, ans in zip(req["texts"], got):
                cands = [plain(("text", text, e))[0] for e in range(len(text_enc.seen[text]))]
                check(ans in cands, f"/search_text {text!r}: differs from the plain path")
        elif kind == "search_image_bytes":
            blob = pngs[r["png"]]
            cands = [plain(("png", blob, e))[0] for e in range(len(image_enc.seen[blob]))]
            check(got[0] in cands, "/search_image_bytes differs from the plain path")
        else:
            want = plain(*[("img", i) for i in req["image_ids"]], rerank=req.get("rerank"))
            check(got == want, f"/search_image {req['image_ids']}: differs from the plain path")
        checked += 1
    return checked


def _query_cli(env, image_id, service, dev):
    """``python -m tpualign_torch query --image-id`` as a subprocess; its ids
    must be the service's. Returns its wall seconds."""
    import os

    t0 = time.perf_counter()
    cli = subprocess.run([sys.executable, "-m", "tpualign_torch", "query", "--image-id",
                          image_id, "--device", dev.type], capture_output=True, text=True,
                         timeout=600, env=dict(os.environ, **env))
    secs = time.perf_counter() - t0
    check(cli.returncode == 0, f"query --image-id exited {cli.returncode}: {cli.stderr[-2000:]}")
    check("no prebuilt" not in cli.stdout, f"query did not use the artifact: {cli.stdout[:200]}")
    cli_ids = [line.split()[1] for line in cli.stdout.splitlines()[1:] if line.strip()]
    want_ids = [h["chunk_id"] for h in service.search_images([image_id], k=10)[0]]
    check(cli_ids == want_ids, f"query --image-id printed {cli_ids}, the service {want_ids}")
    return secs


def phase_serve(dev, seed, root):
    """The serving path: the port's store, build_service + serve_schemas at
    int8 with refine 4 and ViT-B-32 towers, eight clients, every answer
    held against the plain path; then int4 and int2 rebuilds, recall
    against exact fp32, and the ``query --image-id`` CLI. Returns the
    launches, and what serve_ivf reuses."""
    from tpualign_torch.config import load_config
    from tpualign_torch.ops.attention import fused_mha
    from tpualign_torch.ops.sim_topk import masked_sim_topk, masked_sim_topk_quant
    from tpualign_torch.parallel.retrieval import (
        WILDCARD_KEY, _refine_rescore, build_index, encode_keys)
    from tpualign_torch.serving.server import (
        build_service, index_kwargs, make_engine, make_image_bytes_encoder)
    from tpualign_torch.store import EmbeddingStore

    t0 = time.perf_counter()
    images = _serve_store(root, dev, seed)
    store_s = time.perf_counter() - t0
    emit({"phase": "serve_store", "store_write_s": store_s,
          "chunks": SERVE_MANUALS * SERVE_PAGES * SERVE_CHUNKS_PER_PAGE,
          "images": SERVE_IMAGES, "alignments": SERVE_IMAGES * SERVE_ALIGNS})

    config = load_config({"STORE_DIR": root, "RETRIEVAL_PRECISION": "int8",
                          "RETRIEVAL_REFINE": "4", "CLIP_MODEL": "ViT-B-32",
                          "SEED": str(seed)})
    t0 = time.perf_counter()
    engine = make_engine(config, dev)
    text_enc = _Recorder(engine.encode_text_batch)
    image_enc = _Recorder(make_image_bytes_encoder(engine))
    service = build_service(config, "vanilla_clip", encoder=text_enc, image_encoder=image_enc,
                            device=dev)
    build_s = time.perf_counter() - t0
    index = service.index
    rng = np.random.default_rng(seed)
    pngs = [_png(rng) for _ in range(4)]
    run = _drive(service, images, pngs, (fused_mha, masked_sim_topk, masked_sim_topk_quant),
                 nagle=True)
    launches = run["launches"]
    checked = _check_answers(run, service, images, pngs, text_enc, image_enc, _plain_refined)
    check(launches["masked_sim_topk_quant"] > 0, "K3 was not launched while serving")
    check(launches["fused_mha"] > 0, "K1 was not launched while serving")

    # the refine share of one coalesced-size search (8 queries)
    img_emb = service._image_embs
    q8 = img_emb[:8]
    qk8 = np.full(8, WILDCARD_KEY, np.int32)
    first = refine = 0.0
    for _ in range(20):
        t0 = time.perf_counter()
        v, i = index._search_encoded_raw(q8, qk8, 40, skip_vals=True)
        t1 = time.perf_counter()
        _refine_rescore(q8, v, i, index._refine_corpus, 10)
        t2 = time.perf_counter()
        first, refine = first + t1 - t0, refine + t2 - t1

    # where one request's time goes (direct calls, uncached texts)
    profiles = _profiles(service, images, pngs)

    # the int8 index again, standalone (its build time), and the int4/int2
    # rebuilds; keyed and global searches of each against the plain path
    store = EmbeddingStore(root)
    chunk_ids, chunk_emb = store.embedding_matrix("vanilla_clip", "text_chunks")
    manuals = store.column("vanilla_clip", "text_chunks", "manual_id")
    pages = store.column("vanilla_clip", "text_chunks", "page")
    sample = np.arange(0, SERVE_IMAGES, max(1, SERVE_IMAGES // 256))[:256]
    q_img = img_emb[sample]
    qk_keyed, _ = encode_keys([images[i]["manual_id"] for i in sample],
                              [images[i]["page"] for i in sample], dict(index.vocab))
    exact_index = build_index(chunk_emb, manuals, pages, device=dev)
    q_rec = img_emb[:SERVE_RECALL_QUERIES]
    _, exact = exact_index.search(q_rec, k=10, global_search=True)
    del exact_index
    rungs = {}
    for precision in ("int8", "int4", "int2"):
        kw = dict(index_kwargs(config, "vanilla_clip"), precision=precision)
        t0 = time.perf_counter()
        rung = build_index(chunk_emb, manuals, pages, device=dev, **kw)
        torch.cuda.synchronize()
        rung_s = time.perf_counter() - t0
        for what, keys in (("keyed", qk_keyed), ("global", np.full(len(sample), WILDCARD_KEY,
                                                                   np.int32))):
            got = _pairs(*rung.search_encoded(q_img, keys, 10), chunk_ids)
            check(got == _pairs(*_plain_refined(rung, q_img, keys), chunk_ids),
                  f"{precision} {what}: differs from the plain path")
        recall = _recall(rung, q_rec, exact)
        rungs[precision] = {"index_build_s": rung_s, "recall_at_10": recall,
                            "corpus_bytes": int(rung._corpus.numel())}
        del rung

    cli_s = _query_cli({"STORE_DIR": root, "RETRIEVAL_PRECISION": "int8",
                        "RETRIEVAL_REFINE": "4"}, images[7]["image_id"], service, dev)

    emit({"phase": "serve", "model": "ViT-B-32", "precision": "int8", "refine": 4,
          "store_write_s": store_s, "service_build_s": build_s,
          "clients": SERVE_CLIENTS, "requests": len(run["results"]), "answers_checked": checked,
          "wall_s": run["wall"], "qps": len(run["results"]) / run["wall"],
          "endpoints": run["endpoints"], "serial_p50_ms": run["serial_p50_ms"],
          "profiles": profiles, "refine_share_q8": refine / (first + refine),
          "first_stage_ms_q8": first / 20 * 1e3, "refine_ms_q8": refine / 20 * 1e3,
          "coalescer": run["stats"].get("coalescer"),
          "encode_coalescer": run["stats"].get("encode_coalescer"),
          "query_cache": run["stats"].get("query_cache"),
          "refine_store": run["stats"].get("refine_store"),
          "rungs": rungs, "cli_query_s": cli_s, "launches": launches})
    return launches, {"engine": engine, "images": images, "pngs": pngs, "exact": exact,
                      "chunk_emb": chunk_emb, "manuals": manuals, "pages": pages}


def _profiles(service, images, pngs) -> dict:
    fresh = iter(range(10**6))
    return {
        "search_image_bytes": profile_window(lambda: service.search_image_bytes([pngs[0]], k=10)),
        "search_image": profile_window(lambda: service.search_images(
            [images[1]["image_id"], images[2]["image_id"]], k=10)),
        "search_text_uncached": profile_window(lambda: service.search_text(
            [f"{t} {next(fresh)}" for t in SERVE_TEXTS[:4]], k=10)),
    }


def _recall(index, q_rec, exact, **kw) -> dict:
    """recall@10 of ``index`` against the exact fp32 top-10, unrefined (the
    first stage alone) and refined."""
    from tpualign_torch.parallel.retrieval import WILDCARD_KEY

    wild = np.full(len(q_rec), WILDCARD_KEY, np.int32)
    _, unref = index._search_encoded_raw(q_rec, wild, 10, **kw)
    _, ref = index.search_encoded(q_rec, wild, 10, **kw)
    recall = {name: float(np.mean([len(set(a) & set(b)) / 10 for a, b in zip(got, exact)]))
              for name, got in (("unrefined", unref), ("refined", ref))}
    check(recall["refined"] >= recall["unrefined"], f"refine lowered recall@10 {recall}")
    return recall


def phase_serve_ivf(dev, seed, root, shared):
    """RETRIEVAL_INDEX=ivf over the serve phase's store: ``python -m
    tpualign_torch index`` as a subprocess (int8, refine 4, recall target
    0.95), the same build and calibration timed in this process (the same
    structure), build_service loading the artifact, the clients' mix with
    every answer against the plain path (plain K4, exact rescore), recall
    of each rung against exact fp32, and ``query --image-id`` through the
    artifact."""
    import os

    from tpualign_torch.config import load_config
    from tpualign_torch.ops.attention import fused_mha
    from tpualign_torch.ops.ivf_topk import ivf_probe_topk
    from tpualign_torch.ops.sim_topk import masked_sim_topk, masked_sim_topk_quant
    from tpualign_torch.parallel.ivf import IVFIndex, _probe, _union
    from tpualign_torch.parallel.retrieval import encode_keys
    from tpualign_torch.serving.server import build_service, make_image_bytes_encoder

    cache = os.path.join(root, "vanilla_clip.ivf.npz")
    env = {"STORE_DIR": root, "RETRIEVAL_INDEX": "ivf", "RETRIEVAL_PRECISION": "int8",
           "RETRIEVAL_REFINE": "4", "RETRIEVAL_RECALL_TARGET": "0.95", "IVF_CACHE": cache}
    t0 = time.perf_counter()
    cli = subprocess.run([sys.executable, "-m", "tpualign_torch", "index", "--device",
                          dev.type], capture_output=True, text=True, timeout=900,
                         env=dict(os.environ, **env))
    index_cli_s = time.perf_counter() - t0
    check(cli.returncode == 0, f"index exited {cli.returncode}: {cli.stderr[-2000:]}")
    info = json.loads(cli.stdout.strip().splitlines()[-1])
    check(info["n_lists"] == 1000 and info["capacity"] <= 1536
          and info["calibrated_target"] == 0.95 and os.path.exists(cache),
          f"index printed {info}")

    # the same build and calibration in this process: their times, and the
    # same structure as the subprocess's artifact (k-means is deterministic)
    chunk_emb, manuals, pages = shared["chunk_emb"], shared["manuals"], shared["pages"]
    t0 = time.perf_counter()
    again = IVFIndex(chunk_emb, manuals, pages, precision="int8", refine=4, device=dev)
    torch.cuda.synchronize()
    build_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    again.calibrate(0.95)
    calibrate_s = time.perf_counter() - t0
    art = np.load(cache)
    check(np.array_equal(again._ids.cpu().numpy(), art["pids"])
          and np.array_equal(again.centroids.cpu().numpy(), art["centroids"])
          and again.n_probes == info["n_probes"], "two builds of one store differ")
    del again, art

    config = load_config({**env, "CLIP_MODEL": "ViT-B-32", "SEED": str(seed)})
    engine, images, pngs = shared["engine"], shared["images"], shared["pngs"]
    text_enc = _Recorder(engine.encode_text_batch)
    image_enc = _Recorder(make_image_bytes_encoder(engine))
    t0 = time.perf_counter()
    service = build_service(config, "vanilla_clip", encoder=text_enc, image_encoder=image_enc,
                            device=dev)
    torch.cuda.synchronize()
    load_s = time.perf_counter() - t0
    index = service.index
    check(isinstance(index, IVFIndex) and service.stats()["ivf"]["n_probes"] == info["n_probes"],
          f"the service did not load the artifact: {service.stats().get('ivf')}")
    run = _drive(service, images, pngs,
                 (fused_mha, masked_sim_topk, masked_sim_topk_quant, ivf_probe_topk))
    launches = run["launches"]
    checked = _check_answers(run, service, images, pngs, text_enc, image_enc,
                             _plain_refined_ivf)
    check(launches["ivf_probe_topk"] > 0, "K4 was not launched while serving")
    check(launches["fused_mha"] > 0, "K1 was not launched while serving")
    profiles = _profiles(service, images, pngs)

    # K4 at the shape serving gives it: the /search_image profile's two
    # keyed image queries, k * refine candidates, the calibrated probes
    two = [images[1], images[2]]
    qv = torch.from_numpy(service._image_embs[[service._images[im["image_id"]] for im in two]])
    qk = np.asarray(encode_keys([im["manual_id"] for im in two], [im["page"] for im in two],
                                dict(index.vocab))[0], np.int32)
    qv, qk = qv.to(dev), torch.from_numpy(qk).to(dev)
    probe = _probe(qv, qk, index.centroids, index.n_probes, index.n_lists)
    kf = 10 * index.refine
    k4_serving = {"variant": "int8", "Q": 2, "k": kf, "N": index.n, "D": index.dim,
                  "n_lists": index.n_lists, "capacity": index.capacity,
                  "n_probes": index.n_probes, "spill_blocks": index.spill_blocks,
                  **_k4_measure("K4 at the serving shape", qv, qk, probe,
                                _union(probe, index.n_lists, index.spill_blocks), index._emb,
                                index._keys, index._scales, index.int8_mxu, kf,
                                index.capacity, index.n_lists)}

    # recall@10 of each rung against exact fp32, at its calibrated and the
    # default probe counts, unrefined and refined
    q_rec = service._image_embs[:SERVE_RECALL_QUERIES]
    rungs = {}
    for precision in ("int8", "int4", "int2"):
        t0 = time.perf_counter()
        rung = index if precision == "int8" else IVFIndex(
            chunk_emb, manuals, pages, precision=precision, refine=4, device=dev)
        rung_s = time.perf_counter() - t0
        default_probes = rung.n_lists // 8
        calibrated = rung.n_probes if precision == "int8" else rung.calibrate(0.95)
        rungs[precision] = {
            "index_build_s": None if precision == "int8" else rung_s,
            "n_probes_calibrated": calibrated, "n_probes_default": default_probes,
            "recall_at_10": {f"probes_{p}": _recall(rung, q_rec, shared["exact"], n_probes=p)
                             for p in sorted({calibrated, default_probes})},
            "memory_bytes": rung.memory_bytes}
        del rung
    cli_s = _query_cli(env, images[7]["image_id"], service, dev)
    stats = run["stats"]
    emit({"phase": "serve_ivf", "model": "ViT-B-32", "precision": "int8", "refine": 4,
          "ivf": stats.get("ivf"), "index_cli_s": index_cli_s, "build_s": build_s,
          "calibrate_s": calibrate_s, "service_load_s": load_s,
          "clients": SERVE_CLIENTS, "requests": len(run["results"]), "answers_checked": checked,
          "wall_s": run["wall"], "qps": len(run["results"]) / run["wall"],
          "endpoints": run["endpoints"], "serial_p50_ms": run["serial_p50_ms"],
          "profiles": profiles, "coalescer": stats.get("coalescer"),
          "query_cache": stats.get("query_cache"), "rungs": rungs, "cli_query_s": cli_s,
          "k4_serving_shape": k4_serving, "launches": launches})
    return launches, k4_serving


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--seed", type=int, default=0)
    args = parser.parse_args()
    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available", file=sys.stderr)
        return 2
    import tpualign_torch  # noqa: F401  (fails outside a checkout)

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda", 0)
    card = card_line()
    emit({"phase": "card", "nvidia_smi": card, "torch": torch.__version__,
          "cuda": torch.version.cuda, "device": torch.cuda.get_device_name(0),
          "count": torch.cuda.device_count()})
    phase_build()
    gen = torch.Generator(device=dev).manual_seed(args.seed)
    k1 = phase_k1(dev, gen)
    k2 = phase_k2(dev, gen)
    launches = phase_slice(dev, args.seed)
    k3 = phase_k3(dev, gen)
    k4 = phase_k4(dev, gen)
    with tempfile.TemporaryDirectory(prefix="tpualign_serve_") as root:
        serve_launches, shared = phase_serve(dev, args.seed, root)
        ivf_launches, k4_head = phase_serve_ivf(dev, args.seed, root, shared)
        del shared

    k1_head = next(r for r in k1 if r["shape"] == "vision" and r["dtype"] == "bfloat16")
    k2_head = next(r for r in k2 if r["k"] == 100)
    k3_head = next(r for r in k3 if r["variant"] == "int8" and r["k"] == 40)
    k4_125 = next(r for r in k4 if r["variant"] == "int8" and r["Q"] == 2 and r["k"] == 40)
    keys = ("max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by", "library_ms")
    emit({"kernels": [
        {"name": "fused_mha", "route": "cuda", "source": "tpualign_torch/csrc/fused_mha.cu",
         "replaces": "tpualign/ops/pallas_attention.py:162",
         "launches": launches["fused_mha"], **{k: k1_head[k] for k in keys},
         "tolerance": {"atol": k1_head["atol"], "rtol": k1_head["rtol"]},
         "at": "ViT-B-32 vision, B=256 T=50 D=768 H=12, bf16"},
        {"name": "masked_sim_topk", "route": "cuda",
         "source": "tpualign_torch/csrc/masked_sim_topk.cu",
         "replaces": "tpualign/ops/pallas_kernels.py:329",
         "launches": launches["masked_sim_topk"], **{k: k2_head[k] for k in keys},
         "tolerance": {"values_atol": K2_TOL_VALUES, "tie_gap": K2_TIE_GAP},
         "at": "fp32 Q=1024 N=100000 D=512 k=100"},
        {"name": "masked_sim_topk_quant", "route": "cuda",
         "source": "tpualign_torch/csrc/masked_sim_topk_quant.cu",
         "replaces": "tpualign/ops/pallas_kernels.py:523",
         "launches": serve_launches["masked_sim_topk_quant"], **{k: k3_head[k] for k in keys},
         "tolerance": k3_head["tolerance"],
         "at": "int8 (s8) Q=1024 N=1000000 D=512 k=40; launches from the serve phase"},
        {"name": "ivf_probe_topk", "route": "cuda",
         "source": "tpualign_torch/csrc/ivf_probe_topk.cu",
         "replaces": "tpualign/ops/pallas_kernels.py:778",
         "launches": ivf_launches["ivf_probe_topk"], **{k: k4_head[k] for k in keys},
         "tolerance": k4_head["tolerance"],
         "at": (f"int8 (s8) Q=2 k={k4_head['k']}, the serve_ivf store's two keyed image "
                f"queries at its calibrated {k4_head['n_probes']} probes, N={k4_head['N']} "
                f"D={k4_head['D']}, {k4_head['union_blocks']} of {k4_head['n_lists']} lists "
                f"+ spill; launches from the serve_ivf phase; at the default 125 probes "
                f"(phase k4) {k4_125['ms']:.4f} ms, bound {k4_125['bound_ms']:.4f} ms")},
    ]})
    print(card, flush=True)
    emit({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
