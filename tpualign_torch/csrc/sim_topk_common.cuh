// What the masked similarity kernels share, for sm_90a: the order, the key
// test, the cross-range merge, cp.async, the key-aware admit prologue, the
// running lists merged in registers, and the query quantizer.
//
// K2 (masked_sim_topk.cu) takes the order, the admit prologue, the lists
// and the merge, and keeps its own sweep. K3 (masked_sim_topk_quant.cu) and
// K4 (ivf_probe_topk.cu) take everything here, and their integer and
// dequant sweeps from quant_sweep.cuh.
//
// Order is (value desc, index asc), a total order, so every step below is
// exact: the skip of a tile that no query of a block admits, the filter of
// candidates against a list's k-th entry, the bitonic sorts, and the
// cross-range merge of the corpus splits and its threshold. A masked candidate is the empty
// slot itself, (kNegInf, kSentinel), so it never displaces one.

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

#include "device_flags.cuh"

namespace simtopk {
// Internal linkage: every kernel library compiles its own copy, and no
// static of a launch template (the shared-memory attribute flags) is
// shared with another library loaded in the same process.
namespace {

constexpr float kNegInf = -1e30f;       // tpualign NEG_INF
constexpr int kSentinel = 1 << 30;      // tpualign SENTINEL_IDX
constexpr int kWildcard = -3;           // tpualign WILDCARD_KEY
constexpr int kMergeThreads = 256;
constexpr int kMaxK = 128;
constexpr int kMaxSplits = 4096;        // corpus ranges the cross-range merge takes

// (value desc, index asc): true when a ranks before b
__device__ __forceinline__ bool better(float av, int ai, float bv, int bi) {
  return av > bv || (av == bv && ai < bi);
}

// Orders slots i < j so that the better one sits at i (desc) or at j.
__device__ __forceinline__ void order(float* v, int* x, int i, int j, bool desc) {
  const bool swap = desc ? better(v[j], x[j], v[i], x[i]) : better(v[i], x[i], v[j], x[j]);
  if (swap) {
    const float tv = v[i]; v[i] = v[j]; v[j] = tv;
    const int ti = x[i]; x[i] = x[j]; x[j] = ti;
  }
}

// The candidate mask of tpualign's kernels: same key or a wildcard query,
// real corpus rows only. A padding query (key -2) admits nothing.
__device__ __forceinline__ bool key_match(int qkey, int ckey) {
  return ckey >= 0 && (qkey == ckey || qkey == kWildcard);
}

// -- the cross-range merge ------------------------------------------------------

// Block-wide bitonic sort of v/x[0, p2) (p2 a power of two), best first.
// Called by every thread of the block.
__device__ __forceinline__ void block_sort(float* v, int* x, int p2) {
  for (int size = 2; size <= p2; size <<= 1) {
    for (int stride = size >> 1; stride > 0; stride >>= 1) {
      for (int p = threadIdx.x; p < p2 / 2; p += kMergeThreads) {
        const int i = 2 * stride * (p / stride) + (p % stride);
        order(v, x, i, i + stride, (i & size) == 0);
      }
      __syncthreads();
    }
  }
}

__host__ __device__ inline int pow2_at_least(int n) {
  int p = 1;
  while (p < n) p <<= 1;
  return p;
}

// Entries of shared memory the merge of `splits` lists of k takes.
__host__ __device__ inline int merge_slots(int splits, int k) {
  return pow2_at_least(max(splits, min(splits, k) * k));
}

// One block per query: the top k of its splits' lists (each sorted, best
// first), exactly. Only entries no worse than a threshold T can rank:
// - the k-th best of the lists' heads has k entries at least as good (the
//   heads), and at most k lists reach it, so at most k * k entries do;
// - a list's k-th entry has k entries at least as good in that list.
// T is the better of the two; the block gathers the filled entries no
// worse than T (about 2k where many splits each hold a full list), sorts
// them and keeps the first k. Every filled slot names a distinct row, so
// the order in which they are gathered does not matter.
__global__ void __launch_bounds__(kMergeThreads)
merge_kernel(const float* __restrict__ part_v, const int* __restrict__ part_i, int splits,
             int slots, int k, float* __restrict__ out_v, int* __restrict__ out_i) {
  extern __shared__ float merge_smem[];
  __shared__ int filled;
  __shared__ float warp_v[kMergeThreads / 32];
  __shared__ int warp_i[kMergeThreads / 32];
  float* sv = merge_smem;  // [slots], then si [slots]
  int* si = reinterpret_cast<int*>(sv + slots);
  const int total = splits * k;
  const size_t base = (size_t)blockIdx.x * total;

  // the lists' heads, sorted: T2 is the k-th best
  const int heads = pow2_at_least(splits);
  for (int s = threadIdx.x; s < heads; s += kMergeThreads) {
    sv[s] = s < splits ? part_v[base + (size_t)s * k] : kNegInf;
    si[s] = s < splits ? part_i[base + (size_t)s * k] : kSentinel;
  }
  __syncthreads();
  block_sort(sv, si, heads);
  float tv = splits >= k ? sv[k - 1] : kNegInf;
  int ti = splits >= k ? si[k - 1] : kSentinel;
  // and the best of the lists' k-th entries
  for (int s = threadIdx.x; s < splits; s += kMergeThreads) {
    const float v = part_v[base + (size_t)s * k + k - 1];
    const int i = part_i[base + (size_t)s * k + k - 1];
    if (better(v, i, tv, ti)) tv = v, ti = i;
  }
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) {
    const float v = __shfl_xor_sync(0xffffffffu, tv, o);
    const int i = __shfl_xor_sync(0xffffffffu, ti, o);
    if (better(v, i, tv, ti)) tv = v, ti = i;
  }
  if ((threadIdx.x & 31) == 0) {
    warp_v[threadIdx.x / 32] = tv;
    warp_i[threadIdx.x / 32] = ti;
  }
  if (threadIdx.x == 0) filled = 0;
  __syncthreads();  // also: every thread has read the sorted heads
#pragma unroll
  for (int w = 0; w < kMergeThreads / 32; ++w)
    if (better(warp_v[w], warp_i[w], tv, ti)) tv = warp_v[w], ti = warp_i[w];

  // kBatch loads in flight a thread: one block may hold the whole card
  constexpr int kBatch = 8;
  for (int e0 = threadIdx.x; e0 < total; e0 += kMergeThreads * kBatch) {
    float v[kBatch];
    int i[kBatch];
#pragma unroll
    for (int b = 0; b < kBatch; ++b) {
      const int e = e0 + b * kMergeThreads;
      i[b] = e < total ? part_i[base + e] : kSentinel;
      v[b] = e < total ? part_v[base + e] : kNegInf;
    }
#pragma unroll
    for (int b = 0; b < kBatch; ++b) {
      if (i[b] != kSentinel && !better(tv, ti, v[b], i[b])) {
        const int at = atomicAdd(&filled, 1);
        sv[at] = v[b];
        si[at] = i[b];
      }
    }
  }
  __syncthreads();
  const int m = filled;
  const int p2 = pow2_at_least(m);
  for (int e = m + threadIdx.x; e < p2; e += kMergeThreads) {
    sv[e] = kNegInf;
    si[e] = kSentinel;
  }
  __syncthreads();
  block_sort(sv, si, p2);
  for (int j = threadIdx.x; j < k; j += kMergeThreads) {
    out_v[(size_t)blockIdx.x * k + j] = j < m ? sv[j] : kNegInf;
    out_i[(size_t)blockIdx.x * k + j] = j < m ? si[j] : kSentinel;
  }
}

// Merges (nq, splits, k) partial lists into (nq, k).
inline cudaError_t launch_merge(const void* part_v, const void* part_i, int nq, int splits,
                                int k, void* out_v, void* out_i, cudaStream_t stream) {
  const int slots = merge_slots(splits, k);
  const size_t smem = (sizeof(float) + sizeof(int)) * (size_t)slots;
  static devflags::PerDevice<size_t> smem_set(48 << 10);  // the default limit, per device
  size_t* limit = smem_set.current();
  if (limit == nullptr) return cudaErrorInvalidDevice;
  if (smem > *limit) {
    cudaError_t err = cudaFuncSetAttribute(merge_kernel,
                                           cudaFuncAttributeMaxDynamicSharedMemorySize,
                                           (int)smem);
    if (err != cudaSuccess) return err;
    *limit = smem;
  }
  merge_kernel<<<nq, kMergeThreads, smem, stream>>>(
      static_cast<const float*>(part_v), static_cast<const int*>(part_i), splits, slots, k,
      static_cast<float*>(out_v), static_cast<int*>(out_i));
  return cudaGetLastError();
}

// Arguments every entry point checks: k <= 128 and splits within the
// merge's bound.
inline bool bad_args(int nq, int n, int d, int k, int splits) {
  return nq <= 0 || n < 0 || d <= 0 || k <= 0 || k > kMaxK || splits <= 0 ||
         splits > kMaxSplits;
}

// -- cp.async -------------------------------------------------------------------

// 16 bytes from global to shared memory, zero-filled when !ok.
__device__ __forceinline__ void cp_async16(void* dst, const void* src, bool ok) {
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

// -- tiles and the key-aware admit prologue -------------------------------------

// A corpus tile: its first row, its valid rows (0: nothing to read) and
// the IVF block it lies in (-1 for a flat corpus).
struct Tile {
  int row0;
  int rows;
  int block;
};

// A flat corpus of n rows in tiles of BN rows (K2, K3). Every query may
// take every row its key admits.
template <int BN>
struct FlatTiles {
  static constexpr int kRows = BN;
  static constexpr bool kProbes = false;
  int n;
  __host__ __device__ int count() const { return (n + BN - 1) / BN; }
  __device__ __forceinline__ Tile locate(int t) const {
    return {t * BN, min(BN, n - t * BN), -1};
  }
  __device__ __forceinline__ bool member(int, int) const { return true; }
};

// Words of a query tile's row of admit bits.
__host__ __device__ inline int admit_words(int n_tiles) { return (max(n_tiles, 1) + 31) / 32; }

constexpr int kAdmitWarps = 8;

// One warp per (query tile, corpus tile): sets the pair's bit when some
// query of the tile admits some row of the corpus tile, that is, its key
// matches (or it is a wildcard, on a real row) and, for an IVF layout, it
// probed the tile's block or the block spilled. The sweeps read only the
// tiles whose bit is set: a skipped tile holds masked candidates alone,
// so the skip is exact in any row order.
template <int BQ, typename Tiles>
__global__ void __launch_bounds__(kAdmitWarps * 32)
admit_kernel(const int* __restrict__ qk, const int* __restrict__ ck, Tiles tiles, int nq,
             int words, unsigned* __restrict__ admitted) {
  constexpr int kQL = (BQ + 31) / 32;    // query keys a lane holds
  constexpr int kCL = Tiles::kRows / 32; // corpus keys a lane holds
  const int lane = threadIdx.x & 31;
  const int tile = blockIdx.x * kAdmitWarps + (threadIdx.x >> 5);
  if (tile >= tiles.count()) return;
  const Tile at = tiles.locate(tile);
  if (at.rows <= 0) return;
  const int q0 = blockIdx.y * BQ;
  int qv[kQL];
  bool wild = false;
#pragma unroll
  for (int e = 0; e < kQL; ++e) {
    const int r = 32 * e + lane;
    int key = r < BQ && q0 + r < nq ? qk[q0 + r] : -2;  // -2 admits nothing
    if (Tiles::kProbes && key != -2 && !tiles.member(q0 + r, at.block)) key = -2;
    qv[e] = key;
    wild |= key == kWildcard;
  }
  wild = __any_sync(0xffffffffu, wild);
  int c[kCL];
  bool real = false;
#pragma unroll
  for (int e = 0; e < kCL; ++e) {
    const int r = 32 * e + lane;
    c[e] = r < at.rows ? ck[at.row0 + r] : -1;
    real |= c[e] >= 0;
  }
  bool hit = wild && real;
  if (!__any_sync(0xffffffffu, hit)) {
    for (int s = 0; s < (BQ < 32 ? BQ : 32); ++s) {
#pragma unroll
      for (int e = 0; e < kQL; ++e) {
        const int key = __shfl_sync(0xffffffffu, qv[e], s);
#pragma unroll
        for (int j = 0; j < kCL; ++j) hit |= c[j] >= 0 && c[j] == key;
      }
    }
  }
  if (__any_sync(0xffffffffu, hit) && lane == 0)
    atomicOr(admitted + (size_t)blockIdx.y * words + tile / 32, 1u << (tile % 32));
}

// Clears the (ceil(nq / BQ), admit_words) bits and sets the admitted ones.
template <int BQ, typename Tiles>
cudaError_t launch_admit(const int* qk, const int* ck, Tiles tiles, int nq, unsigned* admitted,
                         cudaStream_t s) {
  const int n_tiles = tiles.count();
  const int q_tiles = (nq + BQ - 1) / BQ;
  const int words = admit_words(n_tiles);
  cudaError_t err = cudaMemsetAsync(admitted, 0, sizeof(unsigned) * (size_t)q_tiles * words, s);
  if (err != cudaSuccess || n_tiles == 0) return err;
  admit_kernel<BQ, Tiles><<<dim3((n_tiles + kAdmitWarps - 1) / kAdmitWarps, q_tiles),
                            kAdmitWarps * 32, 0, s>>>(qk, ck, tiles, nq, words, admitted);
  return cudaGetLastError();
}

// The first admitted tile at or after t, below end (end if none).
__device__ __forceinline__ int next_admitted(const unsigned* __restrict__ bits, int t, int end) {
  while (t < end) {
    const unsigned w = __ldg(bits + (t >> 5)) >> (t & 31);
    if (w) return min(t + __ffs(static_cast<int>(w)) - 1, end);
    t = (t | 31) + 1;
  }
  return end;
}

// -- the running lists ----------------------------------------------------------
//
// Each query of a block keeps a list of kSlots slots in shared memory: its
// running top-k, sorted, in [0, k), then the candidates that beat its k-th
// entry, appended as they come. A sweep tests its scores against the k-th
// entries in registers, so the rest never reach shared memory; when a list
// could not take another round of candidates, one warp sorts it in
// registers and the first k become the running top-k. The k-th entry only
// rises, so a candidate that fails a stale threshold fails the current one
// too: every step is exact.

constexpr int kSlots = 256;
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

// The block's BQ lists whose count passes `pred`, one bit each; every
// warp computes the same mask.
template <int BQ, typename Pred>
__device__ __forceinline__ unsigned long long list_mask(const int* cnt, int lane, Pred pred) {
  static_assert(BQ <= 64, "one bit a list");
  unsigned long long m = 0;
#pragma unroll
  for (int b = 0; b < BQ; b += 32)
    m |= (unsigned long long)__ballot_sync(0xffffffffu, lane + b < BQ && pred(cnt[lane + b]))
         << b;
  return m;
}

// Merges every list holding more than `limit` candidates, the lists dealt
// out in turn to the block's warps. A merge stops the block, so the warps
// that would wait fill their turn with lists more than half that full,
// which then merge later or never: the same merges in fewer stops. Every
// warp reads the same counts, and a barrier keeps the merges (which zero
// them) until all have read them. Called by every thread of the block.
template <int BQ, int kWarps>
__device__ __forceinline__ void merge_lists(int limit, int k, int warp, int lane, int* cnt,
                                            float* lv, int* li, float* thv, int* thi) {
  const unsigned long long due = list_mask<BQ>(cnt, lane, [&](int c) { return c > limit; });
  if (due == 0) return;
  const unsigned long long early =
      list_mask<BQ>(cnt, lane, [&](int c) { return c > limit / 2; }) & ~due;
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

// -- the query quantizer ----------------------------------------------------------

// One warp per query row: tpualign's per-row symmetric int8 queries,
// qs = max(max|q| / 127, 1e-12) and qq = clip(rint(q / qs), -127, 127),
// each step one IEEE fp32 operation as the wrapper's plain
// quantize_queries takes it, so codes and scales are its bit for bit.
__global__ void __launch_bounds__(256)
quantize_kernel(const float* __restrict__ q, int nq, int d, int8_t* __restrict__ qq,
                float* __restrict__ qs) {
  const int row = blockIdx.x * 8 + (threadIdx.x >> 5);
  const int lane = threadIdx.x & 31;
  if (row >= nq) return;
  const float* x = q + (size_t)row * d;
  float m = 0.f;
  for (int j = lane; j < d; j += 32) m = fmaxf(m, fabsf(x[j]));
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, o));
  const float s = fmaxf(__fdiv_rn(m, 127.f), 1e-12f);
  for (int j = lane; j < d; j += 32)
    qq[(size_t)row * d + j] =
        static_cast<int8_t>(fminf(fmaxf(rintf(__fdiv_rn(x[j], s)), -127.f), 127.f));
  if (lane == 0) qs[row] = s;
}

inline cudaError_t launch_quantize(const float* q, int nq, int d, int8_t* qq, float* qs,
                                   cudaStream_t s) {
  quantize_kernel<<<(nq + 7) / 8, 256, 0, s>>>(q, nq, d, qq, qs);
  return cudaGetLastError();
}

}  // namespace
}  // namespace simtopk
