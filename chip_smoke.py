"""Drives tpualign_torch's embed-and-search path on one NVIDIA GPU.

    python3 chip_smoke.py [--seed 0]

Run from the root of a checkout, on a machine with one CUDA card (an H100
for the numbers in PERF.md). Phases, one JSON line each:

0. the card (``nvidia-smi`` name and power limit) and the torch/CUDA versions;
1. build: both kernels compiled from ``tpualign_torch/csrc/``, in parallel;
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
5. the kernels line, the card line, and ``{"ok": true, ...}`` last.

Any failed check raises, and the script exits non-zero without the last
line. It needs CUDA and the repository's ``tpualign_torch`` package; it
imports nothing of JAX or ``tpualign``.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
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

    k1_head = next(r for r in k1 if r["shape"] == "vision" and r["dtype"] == "bfloat16")
    k2_head = next(r for r in k2 if r["k"] == 100)
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
    ]})
    print(card, flush=True)
    emit({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
