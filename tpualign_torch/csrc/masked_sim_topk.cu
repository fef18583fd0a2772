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
// - Key-aware tile skip. A prologue kernel (admit_kernel, shared with K3
//   and K4 in sim_topk_common.cuh) tests, for every
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
// - Merge work only for winners (the running lists of
//   sim_topk_common.cuh). Each query keeps a list of 256 slots in
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
// K2 takes the comparator, key test, cp.async, admit prologue, running
// lists and cross-range merge from sim_topk_common.cuh; its sweep is its
// own. K3 and K4 have their own sweeps (quant_sweep.cuh, and K4's copy of
// this one for its fp32 variant).
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -O3 -shared
//        -Xcompiler -fPIC (tpualign_torch/ops/build.py).

#include <cuda_runtime.h>
#include <stdint.h>

#include "sim_topk_common.cuh"

namespace {

using simtopk::better;
using simtopk::cp_async16;
using simtopk::key_match;
using simtopk::kNegInf;
using simtopk::kSentinel;
using simtopk::kSlots;

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
constexpr int kStages = 3;    // depth chunks in flight: two loading while one is scored
constexpr int kStage = (kBQ + kBN) * kLD;  // floats per stage: query rows, then corpus rows
constexpr size_t kSmemBytes = sizeof(float) * kStages * kStage +
                              (sizeof(float) + sizeof(int)) * (size_t)kBQ * kSlots +
                              sizeof(int) * (3 * kBQ + kBN) + sizeof(float) * kBQ;

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
  auto next_tile = [&](int t) { return simtopk::next_admitted(bits, t, t_end); };

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
    simtopk::cp_async_commit();
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
      simtopk::cp_async_wait<kStages - 2>();
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
      simtopk::merge_lists<kBQ, kNT / 32>(kSlots - kBN / 2 - k, k, warp, lane, cnt, lv, li,
                                          thv, thi);
      __syncthreads();
    }
    tile = next_tile(tile + 1);
  }
  simtopk::merge_lists<kBQ, kNT / 32>(0, k, warp, lane, cnt, lv, li, thv, thi);
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
  static devflags::PerDevice<bool> attr_set(false);
  cudaError_t err = devflags::smem_limit_once(attr_set, sweep_kernel<kVec>, kSmemBytes);
  if (err != cudaSuccess) return err;
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
// used when splits > 1. out_v/out_i: (nq, k). k <= 128; splits <= 4096.
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
  const int words = simtopk::admit_words((n + kBN - 1) / kBN);
  err = simtopk::launch_admit<kBQ>(qki, cki, simtopk::FlatTiles<kBN>{n}, nq, bits, s);
  if (err != cudaSuccess) return (int)err;
  float* sv = static_cast<float*>(splits > 1 ? part_v : out_v);
  int* si = static_cast<int*>(splits > 1 ? part_i : out_i);
  const bool vec = d % 4 == 0 && reinterpret_cast<uintptr_t>(q) % 16 == 0 &&
                   reinterpret_cast<uintptr_t>(c) % 16 == 0;
  err = vec ? launch_sweep<true>(qf, qki, cf, cki, nq, n, d, k, splits, words, bits, sv, si, s)
            : launch_sweep<false>(qf, qki, cf, cki, nq, n, d, k, splits, words, bits, sv, si, s);
  if (err != cudaSuccess || splits == 1) return (int)err;
  return (int)simtopk::launch_merge(part_v, part_i, nq, splits, k, out_v, out_i, s);
}
