// Fused masked similarity + running top-k over an fp32 corpus, for sm_90a.
//
// Replaces the Pallas TPU kernel tpualign/ops/pallas_kernels.py
// (masked_sim_topk -> _sim_topk_one_segment -> _make_sim_topk_kernel with
// _score_fp32 and _merge_running_topk). Per query it returns the top-k of
// q.c over the corpus rows with ((qk == ck) | (qk == WILDCARD)) & (ck >= 0),
// ordered by value descending then index ascending; empty slots are exactly
// (NEG_INF, SENTINEL_IDX).
//
// Bound on the H100: operations where the keys admit most pairs (a global
// search: at Q=1,024, N=100,000, D=512, 105 GFLOP of fp32, about 1.6 ms at
// 67 TFLOP/s outside the tensor cores, against a 205 MB corpus read, about
// 61 us at 3.35 TB/s); bytes where they admit few (the Evaluator's
// same-page search admits 8 chunks per image). Scores are full fp32 FMA
// chains, no TF32, each taken by one thread over D in ascending order, so
// identical corpus rows score bit-identically and ties resolve by index
// alone.
//
// Design:
// - Key-aware tile skip. A prologue kernel (admit_kernel) tests, for every
//   (query tile, corpus tile) pair, whether any query of the tile admits
//   any row of the corpus tile (one warp a pair, a ballot), and writes one
//   bit per pair. The sweep reads only the corpus tiles whose bit is set.
//   The skip is exact whatever the order: a skipped tile holds only masked
//   candidates, which are the empty slot itself and never displace one.
//   The wrapper groups the queries by key (a stable sort) and puts the
//   result rows back, so a query tile covers few keys; how many corpus
//   tiles it admits depends on the corpus keeping a key's rows together,
//   as the store's page-ordered chunks do.
// - The score product. A block holds 64 queries and sweeps corpus tiles of
//   128 rows; each of its 256 threads holds 8 x 4 scores in registers
//   (rows ty + 8i, columns tx + 32j). D goes in chunks of 32 through a ring
//   of three shared-memory stages, loaded by cp.async (16 bytes a copy,
//   zero-filled past the edges) two chunks ahead of the one being scored,
//   across tile boundaries. A thread reads 8 + 4 float4 per 4 depth steps
//   for 128 FMAs, taken depth step by depth step so that consecutive FMAs
//   are independent; a warp's reads hit 8 query rows and 4 corpus rows
//   (broadcast to the rest), and a row pitch of 36 floats keeps each read
//   conflict-free. (8 x 8 scores a thread over 128 threads needs 254
//   registers and leaves one warp a scheduler; it ran slower on the
//   H100.)
// - Merge work only for winners. Each query keeps a list of 256 slots in
//   shared memory: its running top-k, sorted, in [0, k), and then the
//   candidates that beat its k-th entry, appended as they come (one atomic
//   count per query and quad of lanes). Each thread tests its 32 scores
//   against the k-th entries in registers; the rest never reach shared
//   memory. Candidates enter in two rounds of 64 columns a tile; when a
//   list could not take another round's 64, one warp sorts it in
//   registers (a bitonic network over 8 slots a lane, by shuffles) and
//   the first k become the running top-k. A merge stops the block, so the
//   lists due are dealt across the 8 warps and the turns left over go to
//   lists more than half full. The k-th entry only rises, so a candidate
//   that fails the test of a stale threshold fails the current one too:
//   every step is exact.
// - Shared memory per block: three stages 3 x (64 + 128) x 36 x 4 =
//   82,944 B, lists 64 x 256 x 8 = 131,072 B, keys, counts and thresholds
//   1,536 B: 215,552 B of the 232,448 a block may take, so one block (8
//   warps) a SM. The wrapper cuts the corpus into `splits` ranges so that
//   the grid is one wave, each block writes its range's top-k, and the
//   cross-range merge of sim_topk_common.cuh joins them.
//
// K3's dequant variant (masked_sim_topk_quant.cu) keeps the previous sweep
// in sim_topk_common.cuh; K2 takes only its comparator, key test and
// cross-range merge from there.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -O3 -shared
//        -Xcompiler -fPIC (tpualign_torch/ops/build.py).

#include <cuda_runtime.h>
#include <stdint.h>

#include "sim_topk_common.cuh"

namespace {

using simtopk::better;
using simtopk::key_match;
using simtopk::kNegInf;
using simtopk::kSentinel;
using simtopk::kWildcard;

constexpr int kBQ = 64;       // queries per block
constexpr int kBN = 128;      // corpus rows per tile
constexpr int kDK = 32;       // depth per stage
constexpr int kLD = kDK + 4;  // row pitch of a stage, floats
constexpr int kTM = 8;        // query rows a thread scores
constexpr int kTN = 4;        // corpus rows a thread scores
constexpr int kNT = kBQ * kBN / (kTM * kTN);  // threads per block
constexpr int kTY = kBQ / kTM;  // threads across the query tile
constexpr int kTX = kBN / kTN;  // threads across the corpus tile
static_assert(kTY == 8 && kTX == 4 * (kNT / 32), "a warp is 8 query x 4 corpus threads");
constexpr int kSlots = 256;   // a query's list: running top-k, then candidates
constexpr int kAdmitWarps = 8;
constexpr int kStages = 3;    // depth chunks in flight: two loading while one is scored
constexpr int kStage = (kBQ + kBN) * kLD;  // floats per stage: query rows, then corpus rows
constexpr size_t kSmemBytes = sizeof(float) * kStages * kStage +
                              (sizeof(float) + sizeof(int)) * (size_t)kBQ * kSlots +
                              sizeof(int) * (3 * kBQ + kBN) + sizeof(float) * kBQ;

__device__ __forceinline__ void cp_async16(float* dst, const float* src, bool ok) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s), "l"(src),
               "r"(ok ? 16 : 0));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

template <int kPending>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(kPending) : "memory");
}

// One warp per (query tile, corpus tile): sets the pair's bit when any
// query of the tile admits any row of the corpus tile.
__global__ void __launch_bounds__(kAdmitWarps * 32)
admit_kernel(const int* __restrict__ qk, const int* __restrict__ ck, int nq, int n,
             int n_tiles, int words, unsigned* __restrict__ admitted) {
  const int lane = threadIdx.x & 31;
  const int tile = blockIdx.x * kAdmitWarps + (threadIdx.x >> 5);
  if (tile >= n_tiles) return;
  const int q0 = blockIdx.y * kBQ;
  const int qa = q0 + lane < nq ? qk[q0 + lane] : -2;  // -2 admits nothing
  const int qb = q0 + 32 + lane < nq ? qk[q0 + 32 + lane] : -2;
  const bool wild = __any_sync(0xffffffffu, qa == kWildcard || qb == kWildcard);
  int c[kBN / 32];
  bool real = false;
#pragma unroll
  for (int e = 0; e < kBN / 32; ++e) {
    const int row = tile * kBN + 32 * e + lane;
    c[e] = row < n ? ck[row] : -1;
    real |= c[e] >= 0;
  }
  bool hit = wild && real;
  for (int s = 0; s < 32; ++s) {
    const int ka = __shfl_sync(0xffffffffu, qa, s);
    const int kb = __shfl_sync(0xffffffffu, qb, s);
#pragma unroll
    for (int e = 0; e < kBN / 32; ++e) hit |= c[e] >= 0 && (c[e] == ka || c[e] == kb);
  }
  if (__any_sync(0xffffffffu, hit) && lane == 0)
    atomicOr(admitted + (size_t)blockIdx.y * words + tile / 32, 1u << (tile % 32));
}

// Copies depth chunk `chunk` of the block's queries and of corpus tile
// `tile` into a stage, zero past the last row and past D.
template <bool kVec>
__device__ __forceinline__ void load_stage(float* stage, const float* __restrict__ q,
                                           const float* __restrict__ c, int q0, int nq,
                                           int tile, int n, int d, int chunk) {
  constexpr int kSegs = kDK / 4;
  const int n0 = tile * kBN, x0 = chunk * kDK;
  for (int e = threadIdx.x; e < (kBQ + kBN) * kSegs; e += kNT) {
    const int row = e / kSegs, x = x0 + (e % kSegs) * 4;
    const bool is_q = row < kBQ;
    const int g = is_q ? q0 + row : n0 + row - kBQ;
    const bool ok = (is_q ? g < nq : g < n) && x < d;
    const float* src = (is_q ? q : c) + (ok ? (size_t)g * d + x : 0);
    float* dst = stage + row * kLD + (e % kSegs) * 4;
    if (kVec) {
      cp_async16(dst, src, ok);
    } else {
#pragma unroll
      for (int v = 0; v < 4; ++v) dst[v] = ok && x + v < d ? src[v] : 0.f;
    }
  }
}

// acc[i][j] += q[ty + kTY i] . c[tx + kTX j] over one stage's depth chunk,
// one fmaf per depth step in ascending order.
__device__ __forceinline__ void score_stage(const float* stage, int tx, int ty,
                                            float (&acc)[kTM][kTN]) {
  const float* qs = stage;
  const float* cs = stage + kBQ * kLD;
#pragma unroll
  for (int x = 0; x < kDK; x += 4) {
    float4 a[kTM], b[kTN];
#pragma unroll
    for (int i = 0; i < kTM; ++i)
      a[i] = *reinterpret_cast<const float4*>(qs + (ty + kTY * i) * kLD + x);
#pragma unroll
    for (int j = 0; j < kTN; ++j)
      b[j] = *reinterpret_cast<const float4*>(cs + (tx + kTX * j) * kLD + x);
    // depth step by depth step, so that consecutive fmafs are independent
#pragma unroll
    for (int e = 0; e < 4; ++e) {
#pragma unroll
      for (int i = 0; i < kTM; ++i) {
        const float av = reinterpret_cast<const float*>(&a[i])[e];
#pragma unroll
        for (int j = 0; j < kTN; ++j)
          acc[i][j] = fmaf(av, reinterpret_cast<const float*>(&b[j])[e], acc[i][j]);
      }
    }
  }
}

constexpr int kPer = kSlots / 32;  // list slots a lane holds while merging

// One step of the bitonic network inside a lane: slots r and r + S.
template <int S>
__device__ __forceinline__ void inlane_step(float (&rv)[kPer], int (&ri)[kPer], int size,
                                            int lane) {
#pragma unroll
  for (int r = 0; r < kPer; ++r) {
    if (r & S) continue;
    const bool desc = ((lane * kPer + r) & size) == 0;  // better first
    const int u = r + S;
    if (desc ? better(rv[u], ri[u], rv[r], ri[r]) : better(rv[r], ri[r], rv[u], ri[u])) {
      const float tv = rv[r];
      rv[r] = rv[u];
      rv[u] = tv;
      const int ti = ri[r];
      ri[r] = ri[u];
      ri[u] = ti;
    }
  }
}

// One warp sorts a query's list (kSlots slots, descending) in registers,
// keeps the first k as its running top-k, empties the rest, and publishes
// the k-th entry. Lane l holds slots kPer l .. kPer l + kPer - 1: the
// bitonic network's strides of kPer and more pair lanes by shuffles, the
// smaller ones stay in a lane. The network runs as loops, not unrolled:
// a merge runs once per call, so its instructions come from the
// instruction cache's slow levels, and an unrolled network (thousands of
// instructions) is bound by their fetch.
__device__ __forceinline__ void merge_list(float* v, int* x, int* cnt, float* thv, int* thi,
                                           int k, int lane) {
  static_assert(kPer == 8, "two float4 and two int4 a lane");
  float rv[kPer];
  int ri[kPer];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const float4 a = reinterpret_cast<const float4*>(v + lane * kPer)[h];
    const int4 b = reinterpret_cast<const int4*>(x + lane * kPer)[h];
    rv[4 * h] = a.x, rv[4 * h + 1] = a.y, rv[4 * h + 2] = a.z, rv[4 * h + 3] = a.w;
    ri[4 * h] = b.x, ri[4 * h + 1] = b.y, ri[4 * h + 2] = b.z, ri[4 * h + 3] = b.w;
  }
#pragma unroll 1
  for (int size = 2; size <= kSlots; size <<= 1) {
#pragma unroll 1
    for (int ls = size / (2 * kPer); ls > 0; ls >>= 1) {  // lane strides
      const bool lower = (lane & ls) == 0;
#pragma unroll
      for (int r = 0; r < kPer; ++r) {
        const bool desc = ((lane * kPer + r) & size) == 0;
        const float pv = __shfl_xor_sync(0xffffffffu, rv[r], ls);
        const int pi = __shfl_xor_sync(0xffffffffu, ri[r], ls);
        if (lower == desc ? better(pv, pi, rv[r], ri[r]) : better(rv[r], ri[r], pv, pi)) {
          rv[r] = pv;
          ri[r] = pi;
        }
      }
    }
    if (size >= 8) inlane_step<4>(rv, ri, size, lane);
    if (size >= 4) inlane_step<2>(rv, ri, size, lane);
    inlane_step<1>(rv, ri, size, lane);
  }
#pragma unroll
  for (int r = 0; r < kPer; ++r) {
    const bool keep = lane * kPer + r < k;
    rv[r] = keep ? rv[r] : kNegInf;
    ri[r] = keep ? ri[r] : kSentinel;
  }
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    reinterpret_cast<float4*>(v + lane * kPer)[h] =
        make_float4(rv[4 * h], rv[4 * h + 1], rv[4 * h + 2], rv[4 * h + 3]);
    reinterpret_cast<int4*>(x + lane * kPer)[h] =
        make_int4(ri[4 * h], ri[4 * h + 1], ri[4 * h + 2], ri[4 * h + 3]);
  }
  __syncwarp();
  if (lane == 0) {
    *cnt = 0;
    *thv = v[k - 1];
    *thi = x[k - 1];
  }
  __syncwarp();
}

// Candidates of columns tx + kTX j, j in half h, that beat their query's
// k-th entry join its list; the four lanes that hold a row (one quad) take
// their slots with one atomic. A padded query row has key -2, which admits
// nothing.
__device__ __forceinline__ void emit_half(const float (&acc)[kTM][kTN], int h, int n0, int n,
                                          int k, int tx, int ty, int lane, const int* qkeys,
                                          const int* ckeys, const float* thv, const int* thi,
                                          int* cnt, float* lv, int* li) {
  constexpr int kHalf = kTN / 2;
#pragma unroll
  for (int i = 0; i < kTM; ++i) {
    const int r = ty + kTY * i;
    const float tv = thv[r];
    const int ti = thi[r];
    const int qkey = qkeys[r];
    unsigned pass = 0;
#pragma unroll
    for (int j = h * kHalf; j < (h + 1) * kHalf; ++j) {
      const int g = n0 + tx + kTX * j;
      if (g < n && key_match(qkey, ckeys[tx + kTX * j]) && better(acc[i][j], g, tv, ti))
        pass |= 1u << j;
    }
    if (!__any_sync(0xffffffffu, pass != 0)) continue;
    const int mine = __popc(pass);
    int incl = mine;  // inclusive prefix over the quad
    int up = __shfl_up_sync(0xffffffffu, incl, 1, 4);
    if ((lane & 3) >= 1) incl += up;
    up = __shfl_up_sync(0xffffffffu, incl, 2, 4);
    if ((lane & 3) >= 2) incl += up;
    int base = 0;
    if ((lane & 3) == 3 && incl > 0) base = atomicAdd(cnt + r, incl);
    base = __shfl_sync(0xffffffffu, base, lane | 3);
    int p = k + base + incl - mine;
#pragma unroll
    for (int j = h * kHalf; j < (h + 1) * kHalf; ++j) {
      if (pass & (1u << j)) {
        lv[r * kSlots + p] = acc[i][j];
        li[r * kSlots + p] = n0 + tx + kTX * j;
        ++p;
      }
    }
  }
}

// The block's 64 lists whose count passes `pred`, one bit each; every
// warp computes the same mask.
template <typename Pred>
__device__ __forceinline__ unsigned long long list_mask(const int* cnt, int lane, Pred pred) {
  static_assert(kBQ == 64, "two ballots cover the block's lists");
  return __ballot_sync(0xffffffffu, pred(cnt[lane])) |
         (unsigned long long)__ballot_sync(0xffffffffu, pred(cnt[lane + 32])) << 32;
}

// Merges every list holding more than `limit` candidates, the lists dealt
// out in turn to the block's warps. A merge stops the block, so the warps
// that would wait fill their turn with lists more than half that full,
// which then merge later or never: the same merges in fewer stops. Every
// warp reads the same counts, and a barrier keeps the merges (which zero
// them) until all have read them. Called by every thread of the block.
__device__ __forceinline__ void merge_lists(int limit, int k, int warp, int lane, int* cnt,
                                            float* lv, int* li, float* thv, int* thi) {
  constexpr int kWarps = kNT / 32;
  const unsigned long long due = list_mask(cnt, lane, [&](int c) { return c > limit; });
  if (due == 0) return;
  const unsigned long long early =
      list_mask(cnt, lane, [&](int c) { return c > limit / 2; }) & ~due;
  const int turns = kWarps * ((__popcll(due) + kWarps - 1) / kWarps);
  __syncthreads();
  int seen = 0;
  for (unsigned long long m = due; m; m &= m - 1, ++seen) {
    if (seen % kWarps != warp) continue;
    const int r = __ffsll(static_cast<long long>(m)) - 1;
    merge_list(lv + r * kSlots, li + r * kSlots, cnt + r, thv + r, thi + r, k, lane);
  }
  for (unsigned long long m = early; m && seen < turns; m &= m - 1, ++seen) {
    if (seen % kWarps != warp) continue;
    const int r = __ffsll(static_cast<long long>(m)) - 1;
    merge_list(lv + r * kSlots, li + r * kSlots, cnt + r, thv + r, thi + r, k, lane);
  }
}

template <bool kVec>
__global__ void __launch_bounds__(kNT, 1)
sweep_kernel(const float* __restrict__ q, const int* __restrict__ qk,
             const float* __restrict__ c, const int* __restrict__ ck, int nq, int n, int d,
             int k, int tiles_per_split, int words, const unsigned* __restrict__ admitted,
             float* __restrict__ out_v, int* __restrict__ out_i) {
  extern __shared__ __align__(16) float smem[];
  float* lv = smem + kStages * kStage;              // [kBQ][kSlots] list values
  int* li = reinterpret_cast<int*>(lv + kBQ * kSlots);  // [kBQ][kSlots] list indices
  int* cnt = li + kBQ * kSlots;                     // [kBQ] candidates past k
  int* qkeys = cnt + kBQ;                           // [kBQ]
  int* thi = qkeys + kBQ;                           // [kBQ] k-th entry, index
  int* ckeys = thi + kBQ;                           // [kBN]
  float* thv = reinterpret_cast<float*>(ckeys + kBN);  // [kBQ] k-th entry, value

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int tx = warp * 4 + (lane & 3);  // columns tx + kTX j
  const int ty = lane >> 2;              // rows ty + kTY i
  const int q0 = blockIdx.x * kBQ;
  const int split = blockIdx.y, splits = gridDim.y;
  const int n_tiles = (n + kBN - 1) / kBN;
  const int t_begin = split * tiles_per_split;
  const int t_end = min(n_tiles, t_begin + tiles_per_split);
  const int n_chunks = (d + kDK - 1) / kDK;
  const unsigned* bits = admitted + (size_t)blockIdx.x * words;

  for (int e = tid; e < kBQ * kSlots; e += kNT) {
    lv[e] = kNegInf;
    li[e] = kSentinel;
  }
  if (tid < kBQ) {
    cnt[tid] = 0;
    thv[tid] = kNegInf;
    thi[tid] = kSentinel;
    qkeys[tid] = q0 + tid < nq ? qk[q0 + tid] : -2;
  }

  // the first admitted tile at or after t (t_end if none)
  auto next_tile = [&](int t) {
    while (t < t_end) {
      const unsigned w = __ldg(bits + (t >> 5)) >> (t & 31);
      if (w) return min(t + __ffs(static_cast<int>(w)) - 1, t_end);
      t = (t | 31) + 1;
    }
    return t_end;
  };

  // the issue cursor runs kStages - 1 chunks ahead of the one being
  // scored, across tile boundaries; stage i % kStages holds chunk i
  int tile = next_tile(t_begin);
  int it_tile = tile, it_chunk = 0;
  auto issue = [&](int stage) {
    if (it_tile < t_end) {
      load_stage<kVec>(smem + stage * kStage, q, c, q0, nq, it_tile, n, d, it_chunk);
      if (++it_chunk == n_chunks) {
        it_tile = next_tile(it_tile + 1);
        it_chunk = 0;
      }
    }
    cp_async_commit();
  };
  for (int i = 0; i < kStages - 1; ++i) issue(i);

  int step = 0;
  while (tile < t_end) {
    const int n0 = tile * kBN;
    if (tid < kBN) ckeys[tid] = n0 + tid < n ? ck[n0 + tid] : -1;
    float acc[kTM][kTN];
#pragma unroll
    for (int i = 0; i < kTM; ++i)
#pragma unroll
      for (int j = 0; j < kTN; ++j) acc[i][j] = 0.f;

    for (int ch = 0; ch < n_chunks; ++ch, ++step) {
      cp_async_wait<kStages - 2>();
      __syncthreads();  // chunk `step` landed; every thread is done with step - 1's stage
      issue((step + kStages - 1) % kStages);
      score_stage(smem + (step % kStages) * kStage, tx, ty, acc);
    }

    // the tile's candidates join the lists in two rounds of 64 columns,
    // so that a list merges only once it could not take another 64
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      emit_half(acc, h, n0, n, k, tx, ty, lane, qkeys, ckeys, thv, thi, cnt, lv, li);
      __syncthreads();
      merge_lists(kSlots - kBN / 2 - k, k, warp, lane, cnt, lv, li, thv, thi);
      __syncthreads();
    }
    tile = next_tile(tile + 1);
  }
  merge_lists(0, k, warp, lane, cnt, lv, li, thv, thi);
  __syncthreads();

  for (int e = tid; e < kBQ * k; e += kNT) {
    const int r = e / k, j = e % k;
    if (q0 + r < nq) {
      const size_t o = ((size_t)(q0 + r) * splits + split) * k + j;
      out_v[o] = lv[r * kSlots + j];
      out_i[o] = li[r * kSlots + j];
    }
  }
}

template <bool kVec>
cudaError_t launch_sweep(const float* q, const int* qk, const float* c, const int* ck, int nq,
                         int n, int d, int k, int splits, int words, const unsigned* admitted,
                         float* out_v, int* out_i, cudaStream_t stream) {
  static bool attr_set = false;
  if (!attr_set) {
    cudaError_t err = cudaFuncSetAttribute(
        sweep_kernel<kVec>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)kSmemBytes);
    if (err != cudaSuccess) return err;
    attr_set = true;
  }
  const int n_tiles = (n + kBN - 1) / kBN;
  const int tiles_per_split = (n_tiles + splits - 1) / splits;
  dim3 grid((nq + kBQ - 1) / kBQ, splits);
  sweep_kernel<kVec><<<grid, kNT, kSmemBytes, stream>>>(q, qk, c, ck, nq, n, d, k,
                                                        tiles_per_split, words, admitted,
                                                        out_v, out_i);
  return cudaGetLastError();
}

}  // namespace

// q, qk: the queries and their keys, grouped by key by the wrapper.
// admitted: (ceil(nq / 64), words) int32 scratch, words =
// ceil(max(1, ceil(n / 128)) / 32). part_v/part_i: (nq, splits, k) scratch,
// used when splits > 1. out_v/out_i: (nq, k). k <= 128; splits * k <= 4096.
// Returns a cudaError_t.
extern "C" int tpualign_masked_sim_topk(const void* q, const void* qk, const void* c,
                                        const void* ck, int nq, int n, int d, int k,
                                        int splits, void* admitted, void* part_v,
                                        void* part_i, void* out_v, void* out_i, int device,
                                        void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  if (simtopk::bad_args(nq, n, d, k, splits)) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* qf = static_cast<const float*>(q);
  const float* cf = static_cast<const float*>(c);
  const int* qki = static_cast<const int*>(qk);
  const int* cki = static_cast<const int*>(ck);
  unsigned* bits = static_cast<unsigned*>(admitted);
  const int n_tiles = (n + kBN - 1) / kBN;
  const int q_tiles = (nq + kBQ - 1) / kBQ;
  const int words = (max(n_tiles, 1) + 31) / 32;
  err = cudaMemsetAsync(bits, 0, sizeof(unsigned) * (size_t)q_tiles * words, s);
  if (err != cudaSuccess) return (int)err;
  if (n_tiles > 0) {
    admit_kernel<<<dim3((n_tiles + kAdmitWarps - 1) / kAdmitWarps, q_tiles), kAdmitWarps * 32,
                   0, s>>>(qki, cki, nq, n, n_tiles, words, bits);
    err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
  }
  float* sv = static_cast<float*>(splits > 1 ? part_v : out_v);
  int* si = static_cast<int*>(splits > 1 ? part_i : out_i);
  const bool vec = d % 4 == 0 && reinterpret_cast<uintptr_t>(q) % 16 == 0 &&
                   reinterpret_cast<uintptr_t>(c) % 16 == 0;
  err = vec ? launch_sweep<true>(qf, qki, cf, cki, nq, n, d, k, splits, words, bits, sv, si, s)
            : launch_sweep<false>(qf, qki, cf, cki, nq, n, d, k, splits, words, bits, sv, si, s);
  if (err != cudaSuccess || splits == 1) return (int)err;
  return (int)simtopk::launch_merge(part_v, part_i, nq, splits, k, out_v, out_i, s);
}
