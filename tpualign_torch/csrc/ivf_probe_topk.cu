// IVF probed top-k over a packed cluster layout, for sm_90a.
//
// Replaces the Pallas TPU kernel tpualign/ops/pallas_kernels.py
// (ivf_probe_topk -> _make_ivf_topk_kernel, with the scorers _score_fp32,
// _score_int8_mxu, _score_int4_mxu, _score_int2_mxu and _score_fp32 with
// row scales). The layout holds cluster blocks of `capacity` rows: block b
// is packed rows b*C .. b*C + C - 1. The sweep visits the blocks listed in
// `uids`: an entry equal to n_lists is padding and is skipped, never read;
// an entry above n_lists is a spill block, which every query scans. Per
// query the candidates are the visited rows with
// ((qk == ck) | (qk == WILDCARD)) & (ck >= 0) whose block the query probed
// (or that spilled), and the result is their top-k by value descending,
// then packed row ascending (the JAX kernel's `col`), with empty slots
// exactly (NEG_INF, SENTINEL_IDX).
//
// Bound on the H100: bytes. At the serving geometry (N = 1M, D = 512,
// about 1,000 lists of up to 1,536 rows) a calibrated probe count takes
// most lists, about 1M union rows, yet two keyed image queries admit some
// 16 of them: the 4 MB of keys that say which, not the 512 MB of rows, is
// what the call must read.
//
// Design:
// - The union's tiles (UnionTiles): tile t is entry j = t / ceil(C / BN)
//   and the BN-row slice (t mod ceil(C / BN)) * BN inside block uids[j],
//   so its packed row index is uid*C + r, the index the lists rank ties
//   by. BN is 64 for the integer and dequant sweeps and 128 for the fp32
//   sweep; C is a multiple of 128 in every layout IVFIndex builds, and a
//   shorter last slice is masked row by row.
// - Probe membership: a prologue (probe_bits_kernel) writes a bitmask over
//   cluster ids, one (nq, ceil(n_lists / 32)) u32 row per query, from
//   `probes` (one atomicOr per probe), independent of the order of uids.
// - Key-aware tile skip: the admit prologue (sim_topk_common.cuh) marks a
//   (query tile, union tile) pair when some query of the tile probed the
//   tile's block (or it spilled) and admits one of its rows by key; the
//   sweeps read the marked tiles alone and mask the rest per query. The
//   wrapper groups the queries by key, so that a block covers few keys.
// - The integer variants (s8, int4, int2) and the dequant variant take
//   K3's sweeps (quant_sweep.cuh) with this locator: s8 products on the
//   tensor cores (mma.sync m16n8k32) from a cp.async ring, 16- or
//   64-query blocks; dequant by fp32 FMA chains.
// - The fp32 variant takes its own copy of K2's sweep
//   (masked_sim_topk.cu): 64 queries and 128 union rows a tile, 8 x 4
//   scores a thread over 256 threads, full fp32 fmaf chains over D in
//   ascending order (no TF32), a ring of three cp.async stages, and the
//   running lists of sim_topk_common.cuh. K4 keeps a copy because a sweep
//   template shared with K2 and K3 slowed K3 in a same-card A/B.
// Integer scores are (float(acc) * qs) * cs with one rounding per product,
// as in K3, so they equal the plain version's bit for bit.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -O3 -shared
//        -Xcompiler -fPIC (tpualign_torch/ops/build.py).

#include <cuda_runtime.h>
#include <stdint.h>

#include "quant_sweep.cuh"

namespace {

using simtopk::better;
using simtopk::key_match;
using simtopk::kNegInf;
using simtopk::kSentinel;
using simtopk::kSlots;
using simtopk::Tile;

// The BN-row tiles of the blocks listed in uids, and the probe bitmask.
template <int BN>
struct UnionTiles {
  static constexpr int kRows = BN;
  static constexpr bool kProbes = true;
  const int* uids;
  int n_uids;
  int per_block;                 // tiles per block, ceil(C / BN)
  int capacity;
  int n_lists;
  int n_rows;                    // rows of the packed layout
  const unsigned int* bits;      // (nq, words) probe bitmask over cluster ids
  int words;

  __host__ __device__ int count() const { return n_uids * per_block; }

  __device__ __forceinline__ Tile locate(int t) const {
    const int j = t / per_block;
    const int uid = __ldg(uids + j);
    const int r0 = (t - j * per_block) * BN;
    const long long row0 = (long long)uid * capacity + r0;
    int rows = 0;
    if (uid >= 0 && uid != n_lists && row0 < n_rows)
      rows = (int)min((long long)min(BN, capacity - r0), (long long)n_rows - row0);
    return {(int)row0, rows, uid};
  }

  __device__ __forceinline__ bool member(int q, int block) const {
    if (block > n_lists) return true;  // spill: every query scans it
    const unsigned int w = __ldg(bits + (size_t)q * words + block / 32);
    return (w >> (block % 32)) & 1u;
  }
};

template <int BN>
UnionTiles<BN> union_tiles(const void* uids, int n_uids, int capacity, int n_lists, int n_rows,
                           const unsigned* bits, int words) {
  return {static_cast<const int*>(uids), n_uids, (capacity + BN - 1) / BN, capacity, n_lists,
          n_rows, bits, words};
}

// One thread per (query, probe): sets the query's bit of each probed list.
__global__ void probe_bits_kernel(const int* __restrict__ probes, int nq, int p, int n_lists,
                                  int words, unsigned int* __restrict__ bits) {
  const long long e = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (e >= (long long)nq * p) return;
  const int q = (int)(e / p);
  const int l = probes[e];
  if (l >= 0 && l < n_lists) atomicOr(bits + (size_t)q * words + l / 32, 1u << (l % 32));
}

// -- the fp32 sweep: K2's, over the union's 128-row tiles ----------------------

constexpr int kBQ = 64;       // queries per block
constexpr int kBN = 128;      // union rows per tile
constexpr int kDK = 32;       // depth per stage
constexpr int kLD = kDK + 4;  // row pitch of a stage, floats
constexpr int kTM = 8;        // query rows a thread scores
constexpr int kTN = 4;        // rows a thread scores
constexpr int kNT = kBQ * kBN / (kTM * kTN);  // threads per block
constexpr int kTY = kBQ / kTM;  // threads across the query tile
constexpr int kTX = kBN / kTN;  // threads across the union tile
static_assert(kTY == 8 && kTX == 4 * (kNT / 32), "a warp is 8 query x 4 row threads");
constexpr int kStages = 3;    // depth chunks in flight: two loading while one is scored
constexpr int kStage = (kBQ + kBN) * kLD;  // floats per stage: query rows, then union rows
constexpr size_t kSmemBytes = sizeof(float) * kStages * kStage +
                              (sizeof(float) + sizeof(int)) * (size_t)kBQ * kSlots +
                              sizeof(int) * (4 * kBQ + kBN) + sizeof(float) * kBQ;

// Copies depth chunk `chunk` of the block's queries and of tile `at` into
// a stage, zero past the last row and past D.
template <bool kVec>
__device__ __forceinline__ void load_stage(float* stage, const float* __restrict__ q,
                                           const float* __restrict__ c, int q0, int nq,
                                           const Tile& at, int d, int chunk) {
  constexpr int kSegs = kDK / 4;
  const int x0 = chunk * kDK;
  for (int e = threadIdx.x; e < (kBQ + kBN) * kSegs; e += kNT) {
    const int row = e / kSegs, x = x0 + (e % kSegs) * 4;
    const bool is_q = row < kBQ;
    const bool ok = (is_q ? q0 + row < nq : row - kBQ < at.rows) && x < d;
    const float* src = ok ? (is_q ? q + (size_t)(q0 + row) * d
                                  : c + (size_t)(at.row0 + row - kBQ) * d) + x
                          : q;
    float* dst = stage + row * kLD + (e % kSegs) * 4;
    if (kVec) {
      simtopk::cp_async16(dst, src, ok);
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
// nothing; a query that did not probe the tile's block takes none.
__device__ __forceinline__ void emit_half(const float (&acc)[kTM][kTN], int h, const Tile& at,
                                          int k, int tx, int ty, int lane, const int* qkeys,
                                          const int* qmem, const int* ckeys, const float* thv,
                                          const int* thi, int* cnt, float* lv, int* li) {
  constexpr int kHalf = kTN / 2;
#pragma unroll
  for (int i = 0; i < kTM; ++i) {
    const int r = ty + kTY * i;
    const float tv = thv[r];
    const int ti = thi[r];
    const int qkey = qmem[r] ? qkeys[r] : -2;
    unsigned pass = 0;
#pragma unroll
    for (int j = h * kHalf; j < (h + 1) * kHalf; ++j) {
      const int col = tx + kTX * j;
      if (col < at.rows && key_match(qkey, ckeys[col]) &&
          better(acc[i][j], at.row0 + col, tv, ti))
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
        li[r * kSlots + p] = at.row0 + tx + kTX * j;
        ++p;
      }
    }
  }
}

template <bool kVec>
__global__ void __launch_bounds__(kNT, 1)
fp32_sweep_kernel(const float* __restrict__ q, const int* __restrict__ qk,
                  const float* __restrict__ c, const int* __restrict__ ck,
                  UnionTiles<kBN> tiles, int nq, int d, int k, int tiles_per_split, int words,
                  const unsigned* __restrict__ admitted, float* __restrict__ out_v,
                  int* __restrict__ out_i) {
  extern __shared__ __align__(16) float smem[];
  float* lv = smem + kStages * kStage;              // [kBQ][kSlots] list values
  int* li = reinterpret_cast<int*>(lv + kBQ * kSlots);  // [kBQ][kSlots] list rows
  int* cnt = li + kBQ * kSlots;                     // [kBQ] candidates past k
  int* qkeys = cnt + kBQ;                           // [kBQ]
  int* thi = qkeys + kBQ;                           // [kBQ] k-th entry, row
  int* qmem = thi + kBQ;                            // [kBQ] takes the tile's block
  int* ckeys = qmem + kBQ;                          // [kBN]
  float* thv = reinterpret_cast<float*>(ckeys + kBN);  // [kBQ] k-th entry, value

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int tx = warp * 4 + (lane & 3);  // columns tx + kTX j
  const int ty = lane >> 2;              // rows ty + kTY i
  const int q0 = blockIdx.x * kBQ;
  const int split = blockIdx.y, splits = gridDim.y;
  const int t_begin = split * tiles_per_split;
  const int t_end = min(tiles.count(), t_begin + tiles_per_split);
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

  // the issue cursor runs kStages - 1 chunks ahead of the one being
  // scored, across tile boundaries; stage i % kStages holds chunk i
  int tile = simtopk::next_admitted(bits, t_begin, t_end);
  int it_tile = tile, it_chunk = 0;
  Tile it_at = tile < t_end ? tiles.locate(tile) : Tile{0, 0, -1};
  auto issue = [&](int stage) {
    if (it_tile < t_end) {
      load_stage<kVec>(smem + stage * kStage, q, c, q0, nq, it_at, d, it_chunk);
      if (++it_chunk == n_chunks) {
        it_tile = simtopk::next_admitted(bits, it_tile + 1, t_end);
        it_chunk = 0;
        if (it_tile < t_end) it_at = tiles.locate(it_tile);
      }
    }
    simtopk::cp_async_commit();
  };
  for (int i = 0; i < kStages - 1; ++i) issue(i);

  int step = 0;
  while (tile < t_end) {
    const Tile at = tiles.locate(tile);
    if (tid < kBN) ckeys[tid] = tid < at.rows ? ck[at.row0 + tid] : -1;
    if (tid < kBQ) qmem[tid] = q0 + tid < nq && tiles.member(q0 + tid, at.block);
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
      emit_half(acc, h, at, k, tx, ty, lane, qkeys, qmem, ckeys, thv, thi, cnt, lv, li);
      __syncthreads();
      simtopk::merge_lists<kBQ, kNT / 32>(kSlots - kBN / 2 - k, k, warp, lane, cnt, lv, li,
                                          thv, thi);
      __syncthreads();
    }
    tile = simtopk::next_admitted(bits, tile + 1, t_end);
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
cudaError_t launch_fp32_sweep(const float* q, const int* qk, const float* c, const int* ck,
                              UnionTiles<kBN> tiles, int nq, int d, int k, int splits,
                              const unsigned* admitted, float* out_v, int* out_i,
                              cudaStream_t stream) {
  static devflags::PerDevice<bool> attr_set(false);
  cudaError_t err = devflags::smem_limit_once(attr_set, fp32_sweep_kernel<kVec>, kSmemBytes);
  if (err != cudaSuccess) return err;
  const int tiles_per_split = (tiles.count() + splits - 1) / splits;
  dim3 grid((nq + kBQ - 1) / kBQ, splits);
  fp32_sweep_kernel<kVec><<<grid, kNT, kSmemBytes, stream>>>(
      q, qk, c, ck, tiles, nq, d, k, tiles_per_split, simtopk::admit_words(tiles.count()),
      admitted, out_v, out_i);
  return cudaGetLastError();
}

// The fp32 search: the admit prologue (64-query, 128-row tiles), the
// sweep, the cross-range merge.
cudaError_t fp32_search(const float* q, const int* qk, const float* c, const int* ck,
                        UnionTiles<kBN> tiles, int nq, int d, int k, int splits,
                        unsigned* admitted, void* part_v, void* part_i, void* out_v,
                        void* out_i, cudaStream_t s) {
  cudaError_t err = simtopk::launch_admit<kBQ>(qk, ck, tiles, nq, admitted, s);
  if (err != cudaSuccess) return err;
  float* sv = static_cast<float*>(splits > 1 ? part_v : out_v);
  int* si = static_cast<int*>(splits > 1 ? part_i : out_i);
  const bool vec = d % 4 == 0 && reinterpret_cast<uintptr_t>(q) % 16 == 0 &&
                   reinterpret_cast<uintptr_t>(c) % 16 == 0;
  err = vec ? launch_fp32_sweep<true>(q, qk, c, ck, tiles, nq, d, k, splits, admitted, sv, si, s)
            : launch_fp32_sweep<false>(q, qk, c, ck, tiles, nq, d, k, splits, admitted, sv, si,
                                       s);
  if (err != cudaSuccess || splits == 1) return err;
  return simtopk::launch_merge(part_v, part_i, nq, splits, k, out_v, out_i, s);
}

}  // namespace

// variant: 0 s8, 1 int4, 2 int2 (q: (nq, d) fp32 queries, quantized into
//   qq ((nq, d) int8 scratch) and qs ((nq,) fp32 scratch); c: (n_rows, d)
//   int8, (n_rows, d/2) or (n_rows, d/4) uint8 with d a multiple of 4, 8 or
//   16; bq 16 or 64); 3 dequant (q: (nq, d) fp32, c: (n_rows, d) int8;
//   32-query blocks); 4 fp32 (q and c fp32, cs unused; 64-query blocks).
//   cs: (n_rows,) fp32 row scales; ck: (n_rows,) int32 keys, -1 unused.
// qk: (nq,) int32 keys, the queries grouped by key by the wrapper.
// probes: (nq, p) int32 cluster ids; uids: (n_uids,) int32 block ids.
// bits: (nq, ceil(n_lists / 32)) u32 scratch. admitted: (ceil(nq / bq),
// words) u32 scratch, bq as above, words = ceil(max(1, n_uids * ceil(C /
// BN)) / 32) with BN 128 for fp32, 64 otherwise. part_v/part_i: (nq,
// splits, k) scratch, used when splits > 1. out_v/out_i: (nq, k). k <= 128;
// splits <= 4096. Returns a cudaError_t.
extern "C" int tpualign_ivf_probe_topk(int variant, const void* q, const void* qk,
                                       const void* probes, int p, const void* uids, int n_uids,
                                       const void* c, const void* cs, const void* ck,
                                       int n_rows, int capacity, int n_lists, int nq, int d,
                                       int k, int splits, int bq, void* qq, void* qs,
                                       void* bits, void* admitted, void* part_v, void* part_i,
                                       void* out_v, void* out_i, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  if (simtopk::bad_args(nq, n_rows, d, k, splits) || variant < 0 || variant > 4 || p < 0 ||
      n_uids < 0 || capacity <= 0 || n_lists <= 0 ||
      (variant <= 2 && (d % (4 << variant) || (bq != 16 && bq != 64))))
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int words = (n_lists + 31) / 32;
  unsigned* b = static_cast<unsigned*>(bits);
  err = cudaMemsetAsync(b, 0, sizeof(unsigned) * (size_t)nq * words, s);
  if (err != cudaSuccess) return (int)err;
  const long long pairs = (long long)nq * p;
  if (pairs > 0) {
    probe_bits_kernel<<<(unsigned int)((pairs + 255) / 256), 256, 0, s>>>(
        static_cast<const int*>(probes), nq, p, n_lists, words, b);
    err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
  }
  const float* qf = static_cast<const float*>(q);
  const int* qki = static_cast<const int*>(qk);
  const float* csf = static_cast<const float*>(cs);
  const int* cki = static_cast<const int*>(ck);
  unsigned* adm = static_cast<unsigned*>(admitted);
  if (variant == 4)
    return (int)fp32_search(qf, qki, static_cast<const float*>(c), cki,
                            union_tiles<kBN>(uids, n_uids, capacity, n_lists, n_rows, b, words),
                            nq, d, k, splits, adm, part_v, part_i, out_v, out_i, s);
  const auto tiles =
      union_tiles<simtopk::kIN>(uids, n_uids, capacity, n_lists, n_rows, b, words);
  if (variant == 3)
    return (int)simtopk::dequant_search(qf, qki, static_cast<const int8_t*>(c), csf, cki, tiles,
                                        nq, d, k, splits, adm, part_v, part_i, out_v, out_i, s);
  int8_t* qqi = static_cast<int8_t*>(qq);
  float* qsf = static_cast<float*>(qs);
#define TPUALIGN_K4_INT(P)                                                                  \
  simtopk::int_search<P>(qf, qki, c, csf, cki, tiles, nq, d, k, splits, bq, qqi, qsf, adm, \
                         part_v, part_i, out_v, out_i, s)
  if (variant == 0) return (int)TPUALIGN_K4_INT(1);
  if (variant == 1) return (int)TPUALIGN_K4_INT(2);
  return (int)TPUALIGN_K4_INT(4);
#undef TPUALIGN_K4_INT
}
