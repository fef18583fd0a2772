// The sweeps of the quantized kernels, K3 (masked_sim_topk_quant.cu, a flat
// corpus) and K4 (ivf_probe_topk.cu, the probed blocks of an IVF layout),
// for sm_90a. Each sweep is a template on the tile locator (FlatTiles, or
// K4's UnionTiles), so the flat instance carries no IVF arithmetic.
//
// Both keep tpualign's semantics (sim_topk_common.cuh): per query the
// top-k of the admitted rows by value descending, then row ascending,
// empty slots exactly (NEG_INF, SENTINEL_IDX).
//
// The integer sweep (s8 x s8 -> s32, for int8, packed int4 and packed int2
// rows). Bound on the H100: bytes. At Q=1,024, N=1M, D=512 the int8 rows
// are 512 MB (0.153 ms at 3.35 TB/s) against 1 TOP of dense products
// (0.54 ms at 1,979 TOP/s, far less where the keys admit few pairs); at a
// serving batch (Q = 1 or 2) the products are nothing and the bytes are
// all. The design:
// - Key-aware tile skip: a prologue (admit_kernel) marks the corpus tiles
//   that some query of a block admits, and the sweep walks the marked ones
//   only (next_admitted), so a keyed batch reads a few tiles of a
//   page-ordered corpus.
// - The products on the tensor cores: mma.sync m16n8k32 s8, the queries as
//   A (row-major, BQ x 32 per step) and the corpus rows as B (K-contiguous,
//   the "col" operand), both read from shared memory by ldmatrix without a
//   transpose. The int32 sums are exact in any order, and the epilogue
//   rescales each as (float(acc) * qs) * cs with one rounding per product,
//   tpualign's order, so every score equals the plain version's bit for
//   bit. BQ is 64 (8 warps, 4 x 2, 16 x 32 scores a warp) or, for batches
//   of at most 16 queries, 16 (4 warps, 16 x 16 a warp): the mma's M.
// - Loads: a ring of stages, each the block's queries and a 64-row corpus
//   tile over 128 s8 of depth, filled by cp.async 16 bytes at a time (zero
//   past the edges) kStages - 1 stages ahead of the one being scored,
//   across tile boundaries. int4 and int2 rows arrive packed (64 and 32
//   bytes a row a stage) and are unpacked to s8 in shared memory before the
//   products (Hopper has no int4 tensor-core product); the queries' depth
//   is gathered plane by plane to meet them. Row pitches of 144 bytes keep
//   ldmatrix free of bank conflicts.
// - Candidates: each thread tests its scores against its rows' k-th
//   entries in registers and appends the winners to the running lists
//   (sim_topk_common.cuh), merged by warps in registers when full.
// - Shared memory at BQ = 64: four stages of (64 + 64) x 144 bytes, 64
//   lists of 256 slots (128 KB), keys and scales: 206,848 bytes, one block
//   a SM. At BQ = 16: three stages of (16 + 64) x 144 bytes and 16 lists,
//   68,224 bytes, three blocks a SM (two for int4/int2, whose unpacked
//   tile takes 9,216 more). A block's rate, not the card's, bounds a
//   small batch's scan: three blocks of two stages in flight each beat
//   one or two blocks of up to ten stages on an H100 (PERF.md).
//
// The dequant sweep (int8 rows with row scales, fp32 queries: tpualign's
// _score_fp32 with row scales): each code is dequantized as float(c) * cs,
// then scored by fp32 FMA chains over D in ascending order (no TF32), 32
// queries and 64 rows a tile, 2 x 4 scores a thread, each tile merged by a
// warp a query (merge_tile). It walks the admitted tiles only, as the
// integer sweep does.

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

#include "sim_topk_common.cuh"

namespace simtopk {
// Internal linkage: every kernel library compiles its own copy, and no
// static of a launch template (the shared-memory attribute flags) is
// shared with another library loaded in the same process.
namespace {

// -- the integer sweep ----------------------------------------------------------

constexpr int kIN = 64;         // corpus rows per tile

// P: codes per byte (1 int8, 2 int4, 4 int2); BQ: queries per block.
template <int BQ, int P>
struct IntSweep {
  static constexpr int kWarps = BQ == 64 ? 8 : 4;
  static constexpr int kThreads = kWarps * 32;
  static constexpr int kWM = BQ / 16;               // warps across the queries
  static constexpr int kWN = kWarps / kWM;          // warps across the corpus tile
  static constexpr int kNT = kIN / (8 * kWN);       // n8 tiles a warp scores
  static constexpr int kStages = BQ == 64 ? 4 : 3;
  static constexpr int kKC = 128;                   // s8 depth per stage
  static constexpr int kKLD = kKC + 16;             // pitch of query rows, unpacked rows
  static constexpr int kCB = kKC / P;               // packed bytes of a row a stage
  static constexpr int kCLD = kCB + 16;             // their pitch
  static constexpr int kStage = BQ * kKLD + kIN * kCLD;
  static constexpr int kUnpacked = P > 1 ? kIN * kKLD : 0;
  static constexpr size_t kSmem = (size_t)kStages * kStage + kUnpacked +
                                  (sizeof(float) + sizeof(int)) * (size_t)BQ * kSlots +
                                  sizeof(int) * 6 * BQ + sizeof(int) * 2 * kIN;
  static_assert(BQ == 16 || BQ == 64, "a 16- or 64-query tile");
  static_assert(kNT % 2 == 0 && kStage % 16 == 0, "B by pairs of n8 tiles, aligned stages");
};

// Plane p of a packed word as four s8 values: P = 1 int8, 2 int4
// (offset-8 nibbles: the low nibble of byte j is dim j, the high one dim
// j + D/2), 4 int2 (bits 2p..2p+1 of byte j are dim j + pD/4, value 2c - 3).
template <int P>
__device__ __forceinline__ int plane_word(unsigned int w, int p) {
  if (P == 1) return (int)w;
  if (P == 2) return (int)__vsub4((p == 0 ? w : w >> 4) & 0x0F0F0F0Fu, 0x08080808u);
  return (int)__vsub4(((w >> (2 * p)) & 0x03030303u) << 1, 0x03030303u);
}

__device__ __forceinline__ void ldmatrix_x4(unsigned (&r)[4], const void* p) {
  const unsigned a = static_cast<unsigned>(__cvta_generic_to_shared(p));
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(a));
}

// c += a (16 x 32 s8, row) . b (32 x 8 s8, col), s32 sums
__device__ __forceinline__ void mma_s8(int (&c)[4], const unsigned (&a)[4], unsigned b0,
                                       unsigned b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+r"(c[0]), "+r"(c[1]), "+r"(c[2]), "+r"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// Copies stage `chunk` of the block's queries and of corpus tile `at` into
// `stage`. Query row r, unpacked depth u (plane p = u / kCB) holds query
// byte p * D/P + chunk * kCB + u % kCB, the dim that meets plane p of the
// tile's packed byte chunk * kCB + u % kCB. Zero past the last row and past
// D/P bytes; kVec: 16-byte cp.async (D/P a multiple of 16, aligned bases).
template <int BQ, int P, bool kVec>
__device__ __forceinline__ void int_load_stage(uint8_t* stage, const int8_t* __restrict__ qq,
                                               const uint8_t* __restrict__ c, int q0, int nq,
                                               const Tile& at, int d, int chunk) {
  using S = IntSweep<BQ, P>;
  constexpr int kQSeg = S::kKC / 16, kCSeg = S::kCB / 16;
  const int rowb = d / P;          // bytes of a packed row, and of a query plane
  const int b0 = chunk * S::kCB;   // the chunk's first packed byte
  for (int e = threadIdx.x; e < BQ * kQSeg + kIN * kCSeg; e += S::kThreads) {
    uint8_t* dst;
    const uint8_t* src;
    int valid;  // bytes of the segment inside the row
    if (e < BQ * kQSeg) {
      const int r = e / kQSeg, u = (e % kQSeg) * 16;
      const int o = b0 + u % S::kCB;
      dst = stage + r * S::kKLD + u;
      src = reinterpret_cast<const uint8_t*>(qq) + (size_t)(q0 + r) * d + (u / S::kCB) * rowb +
            o;
      valid = q0 + r < nq ? min(16, rowb - o) : 0;
    } else {
      const int f = e - BQ * kQSeg;
      const int r = f / kCSeg, o = b0 + (f % kCSeg) * 16;
      dst = stage + BQ * S::kKLD + r * S::kCLD + (f % kCSeg) * 16;
      src = c + (size_t)(at.row0 + r) * rowb + o;
      valid = r < at.rows ? min(16, rowb - o) : 0;
    }
    if (kVec) {
      cp_async16(dst, valid > 0 ? src : c, valid > 0);
    } else {
#pragma unroll
      for (int v = 0; v < 16; ++v) dst[v] = v < valid ? src[v] : 0;
    }
  }
}

// The stage's packed corpus rows as s8 rows of S::kKC values: plane p of
// packed byte j goes to depth p * kCB + j, where the queries' plane p sits.
template <int BQ, int P>
__device__ __forceinline__ void unpack_stage(const uint8_t* stage, uint8_t* un) {
  using S = IntSweep<BQ, P>;
  constexpr int kW = S::kCB / 4;  // packed words of a row
  const uint8_t* cs = stage + BQ * S::kKLD;
  for (int e = threadIdx.x; e < kIN * kW; e += S::kThreads) {
    const int r = e / kW, x = e % kW;
    const unsigned w = *reinterpret_cast<const unsigned*>(cs + r * S::kCLD + 4 * x);
#pragma unroll
    for (int p = 0; p < P; ++p)
      *reinterpret_cast<int*>(un + r * S::kKLD + p * S::kCB + 4 * x) = plane_word<P>(w, p);
  }
}

// acc[j] += this warp's 16 queries . corpus rows (wn * kNT + j) * 8 .. + 7
// over one stage's S::kKC depth.
template <int BQ, int P>
__device__ __forceinline__ void mma_stage(const uint8_t* qs, const uint8_t* cs, int cld, int wm,
                                          int wn, int lane, int (&acc)[IntSweep<BQ, P>::kNT][4]) {
  using S = IntSweep<BQ, P>;
#pragma unroll
  for (int ks = 0; ks < S::kKC / 32; ++ks) {
    unsigned a[4];
    ldmatrix_x4(a, qs + (wm * 16 + (lane & 15)) * S::kKLD + ks * 32 + (lane >> 4) * 16);
#pragma unroll
    for (int jp = 0; jp < S::kNT / 2; ++jp) {
      unsigned b[4];
      const int row = (wn * S::kNT + 2 * jp + (lane >> 4)) * 8 + (lane & 7);
      ldmatrix_x4(b, cs + row * cld + ks * 32 + ((lane >> 3) & 1) * 16);
      mma_s8(acc[2 * jp], a, b[0], b[1]);
      mma_s8(acc[2 * jp + 1], a, b[2], b[3]);
    }
  }
}

template <int P, int BQ, typename Tiles, bool kVec>
__global__ void __launch_bounds__(IntSweep<BQ, P>::kThreads)
int_sweep_kernel(const int8_t* __restrict__ qq, const float* __restrict__ qscale,
                 const int* __restrict__ qk, const uint8_t* __restrict__ c,
                 const float* __restrict__ cscale, const int* __restrict__ ck, Tiles tiles,
                 int nq, int d, int k, int tiles_per_split, int words,
                 const unsigned* __restrict__ admitted, float* __restrict__ out_v,
                 int* __restrict__ out_i) {
  using S = IntSweep<BQ, P>;
  static_assert(Tiles::kRows == kIN, "64-row tiles");
  extern __shared__ __align__(16) uint8_t ismem[];
  uint8_t* un = ismem + S::kStages * S::kStage;                // [kIN][S::kKLD] unpacked (P > 1)
  float* lv = reinterpret_cast<float*>(un + S::kUnpacked);     // [BQ][kSlots] list values
  int* li = reinterpret_cast<int*>(lv + BQ * kSlots);          // [BQ][kSlots] list rows
  int* cnt = li + BQ * kSlots;                                 // [BQ] candidates past k
  int* qkeys = cnt + BQ;                                       // [BQ]
  int* thi = qkeys + BQ;                                       // [BQ] k-th entry, row
  int* qmem = thi + BQ;                                        // [BQ] takes the tile's block
  float* thv = reinterpret_cast<float*>(qmem + BQ);            // [BQ] k-th entry, value
  float* qsc = thv + BQ;                                       // [BQ] query scales
  int* ckeys = reinterpret_cast<int*>(qsc + BQ);               // [kIN]
  float* csc = reinterpret_cast<float*>(ckeys + kIN);          // [kIN] row scales

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int wm = warp / S::kWN, wn = warp % S::kWN;
  const int q0 = blockIdx.x * BQ;
  const int split = blockIdx.y, splits = gridDim.y;
  const int t_begin = split * tiles_per_split;
  const int t_end = min(tiles.count(), t_begin + tiles_per_split);
  const int n_chunks = (d / P + S::kCB - 1) / S::kCB;
  const unsigned* bits = admitted + (size_t)blockIdx.x * words;

  for (int e = tid; e < BQ * kSlots; e += S::kThreads) {
    lv[e] = kNegInf;
    li[e] = kSentinel;
  }
  if (tid < BQ) {
    cnt[tid] = 0;
    thv[tid] = kNegInf;
    thi[tid] = kSentinel;
    qkeys[tid] = q0 + tid < nq ? qk[q0 + tid] : -2;
    qsc[tid] = q0 + tid < nq ? qscale[q0 + tid] : 0.f;
  }

  // the issue cursor runs kStages - 1 stages ahead of the one being
  // scored, across admitted tiles; stage i % kStages holds step i
  int tile = next_admitted(bits, t_begin, t_end);
  int it_tile = tile, it_chunk = 0;
  Tile it_at = tile < t_end ? tiles.locate(tile) : Tile{0, 0, -1};
  auto issue = [&](int stage) {
    if (it_tile < t_end) {
      int_load_stage<BQ, P, kVec>(ismem + stage * S::kStage, qq, c, q0, nq, it_at, d,
                                  it_chunk);
      if (++it_chunk == n_chunks) {
        it_tile = next_admitted(bits, it_tile + 1, t_end);
        it_chunk = 0;
        if (it_tile < t_end) it_at = tiles.locate(it_tile);
      }
    }
    cp_async_commit();
  };
  for (int i = 0; i < S::kStages - 1; ++i) issue(i);

  const int g = lane >> 2, tig = lane & 3;
  int step = 0;
  while (tile < t_end) {
    const Tile at = tiles.locate(tile);
    if (tid < kIN) {
      ckeys[tid] = tid < at.rows ? ck[at.row0 + tid] : -1;
      csc[tid] = tid < at.rows ? cscale[at.row0 + tid] : 0.f;
    }
    if (Tiles::kProbes && tid < BQ) qmem[tid] = q0 + tid < nq && tiles.member(q0 + tid, at.block);
    int acc[S::kNT][4];
#pragma unroll
    for (int j = 0; j < S::kNT; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[j][e] = 0;

    for (int ch = 0; ch < n_chunks; ++ch, ++step) {
      cp_async_wait<S::kStages - 2>();
      __syncthreads();  // step's stage landed; every thread is done with step - 1's
      issue((step + S::kStages - 1) % S::kStages);
      const uint8_t* st = ismem + (step % S::kStages) * S::kStage;
      if (P > 1) {
        unpack_stage<BQ, P>(st, un);
        __syncthreads();
        mma_stage<BQ, P>(st, un, S::kKLD, wm, wn, lane, acc);
      } else {
        mma_stage<BQ, P>(st, st + BQ * S::kKLD, S::kCLD, wm, wn, lane, acc);
      }
    }

    // the epilogue: rescale, mask, and the winners join their lists (the
    // four lanes of a quad hold one row: one atomic a quad and row)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int r = wm * 16 + g + 8 * h;
      const float tv = thv[r];
      const int ti = thi[r];
      const int qkey = qkeys[r];
      const float s_q = qsc[r];
      const bool takes = !Tiles::kProbes || qmem[r];
      float sc[2 * S::kNT];
      unsigned pass = 0;
#pragma unroll
      for (int j = 0; j < S::kNT; ++j)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int col = (wn * S::kNT + j) * 8 + tig * 2 + e;
          const float v =
              __fmul_rn(__fmul_rn(__int2float_rn(acc[j][2 * h + e]), s_q), csc[col]);
          sc[2 * j + e] = v;
          if (takes && col < at.rows && key_match(qkey, ckeys[col]) &&
              better(v, at.row0 + col, tv, ti))
            pass |= 1u << (2 * j + e);
        }
      if (!__any_sync(0xffffffffu, pass != 0)) continue;
      const int mine = __popc(pass);
      int incl = mine;  // inclusive prefix over the quad
      int up = __shfl_up_sync(0xffffffffu, incl, 1, 4);
      if (tig >= 1) incl += up;
      up = __shfl_up_sync(0xffffffffu, incl, 2, 4);
      if (tig >= 2) incl += up;
      int base = 0;
      if (tig == 3 && incl > 0) base = atomicAdd(cnt + r, incl);
      base = __shfl_sync(0xffffffffu, base, lane | 3);
      int p = k + base + incl - mine;
#pragma unroll
      for (int j = 0; j < S::kNT; ++j)
#pragma unroll
        for (int e = 0; e < 2; ++e)
          if (pass & (1u << (2 * j + e))) {
            lv[r * kSlots + p] = sc[2 * j + e];
            li[r * kSlots + p] = at.row0 + (wn * S::kNT + j) * 8 + tig * 2 + e;
            ++p;
          }
    }
    __syncthreads();
    merge_lists<BQ, S::kWarps>(kSlots - kIN - k, k, warp, lane, cnt, lv, li, thv, thi);
    __syncthreads();
    tile = next_admitted(bits, tile + 1, t_end);
  }
  merge_lists<BQ, S::kWarps>(0, k, warp, lane, cnt, lv, li, thv, thi);
  __syncthreads();

  for (int e = tid; e < BQ * k; e += S::kThreads) {
    const int r = e / k, j = e % k;
    if (q0 + r < nq) {
      const size_t o = ((size_t)(q0 + r) * splits + split) * k + j;
      out_v[o] = lv[r * kSlots + j];
      out_i[o] = li[r * kSlots + j];
    }
  }
}

template <int P, int BQ, typename Tiles, bool kVec>
cudaError_t launch_int_sweep(const int8_t* qq, const float* qs, const int* qk, const uint8_t* c,
                             const float* cs, const int* ck, Tiles tiles, int nq, int d, int k,
                             int splits, const unsigned* admitted, float* out_v, int* out_i,
                             cudaStream_t stream) {
  using S = IntSweep<BQ, P>;
  static devflags::PerDevice<bool> attr_set(false);
  cudaError_t err =
      devflags::smem_limit_once(attr_set, int_sweep_kernel<P, BQ, Tiles, kVec>, S::kSmem);
  if (err != cudaSuccess) return err;
  const int tiles_per_split = (tiles.count() + splits - 1) / splits;
  const int words = admit_words(tiles.count());
  dim3 grid((nq + BQ - 1) / BQ, splits);
  int_sweep_kernel<P, BQ, Tiles, kVec><<<grid, S::kThreads, S::kSmem, stream>>>(
      qq, qs, qk, c, cs, ck, tiles, nq, d, k, tiles_per_split, words, admitted, out_v, out_i);
  return cudaGetLastError();
}

// The whole integer search: the queries quantized into qq/qs, the admit
// prologue, the sweep into (nq, splits, k) partial lists (straight into
// out_* when splits == 1), the cross-range merge. bq: 16 or 64.
template <int P, typename Tiles>
cudaError_t int_search(const float* q, const int* qk, const void* c, const float* cs,
                       const int* ck, Tiles tiles, int nq, int d, int k, int splits, int bq,
                       int8_t* qq, float* qs, unsigned* admitted, void* part_v, void* part_i,
                       void* out_v, void* out_i, cudaStream_t s) {
  cudaError_t err = launch_quantize(q, nq, d, qq, qs, s);
  if (err != cudaSuccess) return err;
  const uint8_t* cb = static_cast<const uint8_t*>(c);
  float* sv = static_cast<float*>(splits > 1 ? part_v : out_v);
  int* si = static_cast<int*>(splits > 1 ? part_i : out_i);
  const bool vec = (d / P) % 16 == 0 && reinterpret_cast<uintptr_t>(qq) % 16 == 0 &&
                   reinterpret_cast<uintptr_t>(cb) % 16 == 0;
#define TPUALIGN_INT_SWEEP(BQ, V) \
  launch_int_sweep<P, BQ, Tiles, V>(qq, qs, qk, cb, cs, ck, tiles, nq, d, k, splits, admitted, \
                                    sv, si, s)
  if (bq == 16) {
    err = launch_admit<16>(qk, ck, tiles, nq, admitted, s);
    if (err == cudaSuccess) err = vec ? TPUALIGN_INT_SWEEP(16, true) : TPUALIGN_INT_SWEEP(16, false);
  } else {
    err = launch_admit<64>(qk, ck, tiles, nq, admitted, s);
    if (err == cudaSuccess) err = vec ? TPUALIGN_INT_SWEEP(64, true) : TPUALIGN_INT_SWEEP(64, false);
  }
#undef TPUALIGN_INT_SWEEP
  if (err != cudaSuccess || splits == 1) return err;
  return launch_merge(part_v, part_i, nq, splits, k, out_v, out_i, s);
}

// -- the dequant sweep ----------------------------------------------------------

namespace dequant {

constexpr int kBQ = 32;    // queries per block
constexpr int kBN = 64;    // corpus rows per tile
constexpr int kDK = 32;    // depth per shared-memory chunk
constexpr int kNT = 256;   // threads per block
constexpr int kQLD = kBQ + 4;
constexpr int kCLD = kBN + 4;

// One warp merges one query's tile of kBN candidates (tv/ti, in shared
// memory, clobbered) into its running list of KP slots (rv/ri, sorted).
// Skips the tile when no candidate beats the k-th entry.
template <int KP>
__device__ __forceinline__ void merge_tile(float* tv, int* ti, float* rv, int* ri, int k,
                                           int lane) {
  static_assert(kBN == 64, "one bitonic pair per lane");
  const float th_v = rv[k - 1];
  const int th_i = ri[k - 1];
  bool beats = false;
  for (int j = lane; j < kBN; j += 32) beats |= better(tv[j], ti[j], th_v, th_i);
  if (!__any_sync(0xffffffffu, beats)) return;

  // bitonic sort of the tile, descending (kBN / 2 == 32 pairs, one per lane)
  for (int size = 2; size <= kBN; size <<= 1) {
    for (int stride = size >> 1; stride > 0; stride >>= 1) {
      const int i = 2 * stride * (lane / stride) + (lane % stride);
      order(tv, ti, i, i + stride, (i & size) == 0);
      __syncwarp();
    }
  }
  // best of running[i] and tile[KP-1-i]: a bitonic sequence holding the
  // top KP of both lists
  for (int i = lane; i < KP; i += 32) {
    const int j = KP - 1 - i;
    const float bv = j < kBN ? tv[j] : kNegInf;
    const int bi = j < kBN ? ti[j] : kSentinel;
    if (better(bv, bi, rv[i], ri[i])) {
      rv[i] = bv;
      ri[i] = bi;
    }
  }
  __syncwarp();
  for (int stride = KP >> 1; stride > 0; stride >>= 1) {
    for (int p = lane; p < KP / 2; p += 32) {
      const int i = 2 * stride * (p / stride) + (p % stride);
      order(rv, ri, i, i + stride, true);
    }
    __syncwarp();
  }
}

template <typename Tiles, int KP>
__global__ void __launch_bounds__(kNT)
sweep_kernel(const float* __restrict__ q, const int* __restrict__ qk,
             const int8_t* __restrict__ c, const float* __restrict__ cscale,
             const int* __restrict__ ck, Tiles tiles, int nq, int d, int k,
             int tiles_per_split, int words, const unsigned* __restrict__ admitted,
             float* __restrict__ out_v, int* __restrict__ out_i) {
  static_assert(Tiles::kRows == kBN, "64-row tiles");
  extern __shared__ float smem[];
  float* qs = smem;                           // [kDK][kQLD] query chunk, transposed
  float* cs = qs + kDK * kQLD;                // [kDK][kCLD] corpus chunk, transposed
  float* tv = cs + kDK * kCLD;                // [kBQ][kBN] tile candidates
  int* ti = reinterpret_cast<int*>(tv + kBQ * kBN);
  float* rv = reinterpret_cast<float*>(ti + kBQ * kBN);  // [kBQ][KP] running top-k
  int* ri = reinterpret_cast<int*>(rv + kBQ * KP);
  int* qkeys = ri + kBQ * KP;                 // [kBQ]
  int* qmem = qkeys + kBQ;                    // [kBQ] takes the tile's block
  int* ckeys = qmem + kBQ;                    // [kBN]
  float* csc = reinterpret_cast<float*>(ckeys + kBN);  // [kBN]

  const int tid = threadIdx.x;
  const int warp = tid / 32, lane = tid % 32;
  const int tx = tid % 16;   // corpus columns tx*4 .. tx*4+3
  const int ty = tid / 16;   // query rows ty*2, ty*2+1
  const int q0 = blockIdx.x * kBQ;
  const int split = blockIdx.y;
  const int splits = gridDim.y;
  const int t_begin = split * tiles_per_split;
  const int t_end = min(tiles.count(), t_begin + tiles_per_split);
  const unsigned* bits = admitted + (size_t)blockIdx.x * words;

  for (int e = tid; e < kBQ * KP; e += kNT) {
    rv[e] = kNegInf;
    ri[e] = kSentinel;
  }
  if (tid < kBQ) qkeys[tid] = (q0 + tid < nq) ? qk[q0 + tid] : -2;

  for (int tile = next_admitted(bits, t_begin, t_end); tile < t_end;
       tile = next_admitted(bits, tile + 1, t_end)) {
    const Tile at = tiles.locate(tile);
    const int n0 = at.row0;
    if (tid < kBN) {
      ckeys[tid] = (tid < at.rows) ? ck[n0 + tid] : -1;
      csc[tid] = (tid < at.rows) ? cscale[n0 + tid] : 0.f;
    }
    if (tid < kBQ) qmem[tid] = !Tiles::kProbes || (q0 + tid < nq && tiles.member(q0 + tid, at.block));

    float acc[2][4];
#pragma unroll
    for (int a = 0; a < 2; ++a)
#pragma unroll
      for (int b = 0; b < 4; ++b) acc[a][b] = 0.f;

    for (int d0 = 0; d0 < d; d0 += kDK) {
      __syncthreads();
      for (int e = tid; e < kBQ * kDK; e += kNT) {
        const int r = e / kDK, x = e % kDK;
        qs[x * kQLD + r] =
            (q0 + r < nq && d0 + x < d) ? q[(size_t)(q0 + r) * d + d0 + x] : 0.f;
      }
      for (int e = tid; e < kBN * kDK; e += kNT) {
        const int r = e / kDK, x = e % kDK;
        cs[x * kCLD + r] = (r < at.rows && d0 + x < d)
                               ? __fmul_rn((float)__ldg(c + (size_t)(n0 + r) * d + d0 + x),
                                           csc[r])
                               : 0.f;
      }
      __syncthreads();
#pragma unroll 8
      for (int x = 0; x < kDK; ++x) {
        const float2 a = *reinterpret_cast<const float2*>(qs + x * kQLD + ty * 2);
        const float4 b = *reinterpret_cast<const float4*>(cs + x * kCLD + tx * 4);
        acc[0][0] = fmaf(a.x, b.x, acc[0][0]);
        acc[0][1] = fmaf(a.x, b.y, acc[0][1]);
        acc[0][2] = fmaf(a.x, b.z, acc[0][2]);
        acc[0][3] = fmaf(a.x, b.w, acc[0][3]);
        acc[1][0] = fmaf(a.y, b.x, acc[1][0]);
        acc[1][1] = fmaf(a.y, b.y, acc[1][1]);
        acc[1][2] = fmaf(a.y, b.z, acc[1][2]);
        acc[1][3] = fmaf(a.y, b.w, acc[1][3]);
      }
    }

    // key mask and membership; a masked slot is the sentinel itself
#pragma unroll
    for (int a = 0; a < 2; ++a) {
      const int r = ty * 2 + a;
      const int qkey = qkeys[r];
      const bool takes = qmem[r];
#pragma unroll
      for (int b = 0; b < 4; ++b) {
        const int col = tx * 4 + b;
        const bool valid = takes && col < at.rows && key_match(qkey, ckeys[col]);
        tv[r * kBN + col] = valid ? acc[a][b] : kNegInf;
        ti[r * kBN + col] = valid ? n0 + col : kSentinel;
      }
    }
    __syncthreads();

    // merge: one warp per query row
    for (int r = warp; r < kBQ; r += kNT / 32) {
      if (q0 + r >= nq) break;
      merge_tile<KP>(tv + r * kBN, ti + r * kBN, rv + r * KP, ri + r * KP, k, lane);
    }
  }
  __syncthreads();

  for (int e = tid; e < kBQ * k; e += kNT) {
    const int r = e / k, j = e % k;
    if (q0 + r < nq) {
      const size_t o = ((size_t)(q0 + r) * splits + split) * k + j;
      out_v[o] = rv[r * KP + j];
      out_i[o] = ri[r * KP + j];
    }
  }
}

template <typename Tiles, int KP>
cudaError_t launch_sweep(const float* q, const int* qk, const int8_t* c, const float* cs,
                         const int* ck, Tiles tiles, int nq, int d, int k, int splits,
                         const unsigned* admitted, float* out_v, int* out_i,
                         cudaStream_t stream) {
  const size_t smem = sizeof(float) * ((size_t)kDK * kQLD + (size_t)kDK * kCLD) +
                      (sizeof(float) + sizeof(int)) * ((size_t)kBQ * kBN + (size_t)kBQ * KP) +
                      sizeof(int) * (2 * kBQ + kBN) + sizeof(float) * kBN;
  static devflags::PerDevice<bool> attr_set(false);
  cudaError_t err = devflags::smem_limit_once(attr_set, sweep_kernel<Tiles, KP>, smem);
  if (err != cudaSuccess) return err;
  const int tiles_per_split = (tiles.count() + splits - 1) / splits;
  const int words = admit_words(tiles.count());
  dim3 grid((nq + kBQ - 1) / kBQ, splits);
  sweep_kernel<Tiles, KP><<<grid, kNT, smem, stream>>>(q, qk, c, cs, ck, tiles, nq, d, k,
                                                       tiles_per_split, words, admitted, out_v,
                                                       out_i);
  return cudaGetLastError();
}

}  // namespace dequant

// The whole dequant search: the admit prologue (32-query tiles), the
// sweep, the cross-range merge.
template <typename Tiles>
cudaError_t dequant_search(const float* q, const int* qk, const int8_t* c, const float* cs,
                           const int* ck, Tiles tiles, int nq, int d, int k, int splits,
                           unsigned* admitted, void* part_v, void* part_i, void* out_v,
                           void* out_i, cudaStream_t s) {
  cudaError_t err = launch_admit<dequant::kBQ>(qk, ck, tiles, nq, admitted, s);
  if (err != cudaSuccess) return err;
  float* sv = static_cast<float*>(splits > 1 ? part_v : out_v);
  int* si = static_cast<int*>(splits > 1 ? part_i : out_i);
#define TPUALIGN_DEQUANT(KP) \
  dequant::launch_sweep<Tiles, KP>(q, qk, c, cs, ck, tiles, nq, d, k, splits, admitted, sv, si, s)
  if (k <= 16) err = TPUALIGN_DEQUANT(16);
  else if (k <= 32) err = TPUALIGN_DEQUANT(32);
  else if (k <= 64) err = TPUALIGN_DEQUANT(64);
  else err = TPUALIGN_DEQUANT(128);
#undef TPUALIGN_DEQUANT
  if (err != cudaSuccess || splits == 1) return err;
  return launch_merge(part_v, part_i, nq, splits, k, out_v, out_i, s);
}

}  // namespace
}  // namespace simtopk
