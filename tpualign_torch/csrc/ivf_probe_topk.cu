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
// Design. The scorers, the running top-k (merge_tile), the cross-range
// merge and the corpus readers are K2's and K3's (sim_topk_common.cuh, and
// K3's integer tile and unpack, masked_sim_topk_quant.cu); the two sweeps
// below are theirs with the corpus walked as the union's tiles. K2 and K3
// keep their own sweeps: sharing one template changed their code and cost
// K3's int4 variant a quarter of its speed on an H100 (chip_ab.py).
// Tile t of the union is entry j = t / (C/64) and the 64-row offset
// (t mod C/64) * 64 inside block uids[j] (UnionTiles), so its packed row
// index is uid*C + r, the index the running list ranks ties by. Probe
// membership: a 64-query tile with P = 125 probes cannot keep its probe
// lists in shared memory beside the score tiles, so a prologue kernel
// writes a bitmask over cluster ids, one (nq, ceil(n_lists/32)) u32 row per
// query, from `probes` (one atomicOr per probe; equivalent to a mask over
// union positions, and independent of the order of `uids`). Each tile reads
// its block's bit for the block's queries into shared memory; a tile that
// no query of the block probed is skipped whole, the others are masked per
// query. Small batches (Q = 1..8 fill one query tile) cut the union's tiles
// into ranges across blocks, merged by K2's cross-range merge. Integer
// scores are (float(acc) * qs) * cs with one rounding per product, as in
// K3, so they equal the plain version's bit for bit.
//
// Bound on the H100: bytes. At the serving geometry (N = 1M, D = 512,
// 1,000 lists of up to 1,536 rows, 125 probes) a batch reads the union's
// blocks once: about 240 blocks (180 MB of int8 rows) for two queries, all
// 1,000 for 64 or more; the integer products the key mask admits are far
// below the tensor cores' rate. This first kernel takes the products on the
// CUDA cores as K3 does (__dp4a), and so is bound by them; wgmma with TMA
// loads of the listed blocks is the next step.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -O3 -shared
//        -Xcompiler -fPIC (tpualign_torch/ops/build.py).

#include <cuda_runtime.h>
#include <stdint.h>

#include "sim_topk_common.cuh"

namespace {

using namespace simtopk;

// One 64-row tile of the union: its first packed row, its valid rows (0 to
// skip it) and its block.
struct Tile {
  int row0;
  int rows;
  int block;
};

// The 64-row tiles of the blocks listed in uids, and the probe bitmask.
struct UnionTiles {
  const int* uids;
  int n_uids;
  int per_block;                 // tiles per block, ceil(C / 64)
  int capacity;
  int n_lists;
  int n_rows;                    // rows of the packed layout
  const unsigned int* bits;      // (nq, words) probe bitmask over cluster ids
  int words;

  __host__ __device__ int count() const { return n_uids * per_block; }

  __device__ __forceinline__ Tile locate(int t) const {
    const int j = t / per_block;
    const int uid = __ldg(uids + j);
    const int r0 = (t - j * per_block) * kBN;
    const long long row0 = (long long)uid * capacity + r0;
    int rows = 0;
    if (uid >= 0 && uid != n_lists && row0 < n_rows)
      rows = (int)min((long long)min(kBN, capacity - r0), (long long)n_rows - row0);
    return {(int)row0, rows, uid};
  }

  __device__ __forceinline__ bool member(int q, const Tile& at) const {
    if (at.block > n_lists) return true;  // spill: every query scans it
    const unsigned int w = __ldg(bits + (size_t)q * words + at.block / 32);
    return (w >> (at.block % 32)) & 1u;
  }
};

// One thread per (query, probe): sets the query's bit of each probed list.
__global__ void probe_bits_kernel(const int* __restrict__ probes, int nq, int p, int n_lists,
                                  int words, unsigned int* __restrict__ bits) {
  const long long e = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (e >= (long long)nq * p) return;
  const int q = (int)(e / p);
  const int l = probes[e];
  if (l >= 0 && l < n_lists) atomicOr(bits + (size_t)q * words + l / 32, 1u << (l % 32));
}

// -- the fp32 sweep (K2's fp32_sweep_kernel over the union's tiles) -----------

template <typename Corpus, int KP>
__global__ void __launch_bounds__(kNT)
ivf_fp32_kernel(const float* __restrict__ q, const int* __restrict__ qk, Corpus corpus,
                const int* __restrict__ ck, UnionTiles tiles, int nq, int d, int k,
                int tiles_per_split, float* __restrict__ out_v, int* __restrict__ out_i) {
  extern __shared__ float smem[];
  float* qs = smem;                           // [kDK][kQLD] query chunk, transposed
  float* cs = qs + kDK * kQLD;                // [kDK][kCLD] corpus chunk, transposed
  float* tv = cs + kDK * kCLD;                // [kBQ][kBN] tile candidates
  int* ti = reinterpret_cast<int*>(tv + kBQ * kBN);
  float* rv = reinterpret_cast<float*>(ti + kBQ * kBN);  // [kBQ][KP] running top-k
  int* ri = reinterpret_cast<int*>(rv + kBQ * KP);
  int* qkeys = ri + kBQ * KP;                 // [kBQ]
  int* ckeys = qkeys + kBQ;                   // [kBN]
  float* cscale = reinterpret_cast<float*>(ckeys + kBN);  // [kBN]
  int* qmem = reinterpret_cast<int*>(cscale + kBN);       // [kBQ] probe membership

  const int tid = threadIdx.x;
  const int warp = tid / 32, lane = tid % 32;
  const int tx = tid % 16;   // corpus columns tx*4 .. tx*4+3
  const int ty = tid / 16;   // query rows ty*2, ty*2+1
  const int q0 = blockIdx.x * kBQ;
  const int split = blockIdx.y;
  const int splits = gridDim.y;
  const int t_begin = split * tiles_per_split;
  const int t_end = min(tiles.count(), t_begin + tiles_per_split);

  for (int e = tid; e < kBQ * KP; e += kNT) {
    rv[e] = kNegInf;
    ri[e] = kSentinel;
  }
  if (tid < kBQ) qkeys[tid] = (q0 + tid < nq) ? qk[q0 + tid] : -2;

  for (int tile = t_begin; tile < t_end; ++tile) {
    const Tile at = tiles.locate(tile);
    if (at.rows <= 0) continue;  // padding: the same for every thread
    const bool m = tid < kBQ && q0 + tid < nq && tiles.member(q0 + tid, at);
    if (tid < kBQ) qmem[tid] = m;
    if (!__syncthreads_or(m)) continue;  // no query of the block probed it
    const int n0 = at.row0;
    if (tid < kBN) {
      ckeys[tid] = (tid < at.rows) ? ck[n0 + tid] : -1;
      if (Corpus::kScaled) cscale[tid] = (tid < at.rows) ? corpus.scale(n0 + tid) : 0.f;
    }

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
                               ? corpus.at(n0 + r, d0 + x, d, Corpus::kScaled ? cscale[r] : 1.f)
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
      merge_tile<kBN, KP>(tv + r * kBN, ti + r * kBN, rv + r * KP, ri + r * KP, k, lane);
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

template <typename Corpus, int KP>
cudaError_t launch_fp32_kp(const float* q, const int* qk, Corpus corpus, const int* ck,
                           UnionTiles tiles, int nq, int d, int k, int splits, float* out_v,
                           int* out_i, cudaStream_t stream) {
  const size_t smem = sizeof(float) * ((size_t)kDK * kQLD + (size_t)kDK * kCLD) +
                      (sizeof(float) + sizeof(int)) * ((size_t)kBQ * kBN + (size_t)kBQ * KP) +
                      sizeof(int) * (2 * kBQ + kBN) + sizeof(float) * kBN;
  static bool attr_set = false;
  if (!attr_set) {
    cudaError_t err = cudaFuncSetAttribute(ivf_fp32_kernel<Corpus, KP>,
                                           cudaFuncAttributeMaxDynamicSharedMemorySize,
                                           (int)smem);
    if (err != cudaSuccess) return err;
    attr_set = true;
  }
  const int tiles_per_split = (tiles.count() + splits - 1) / splits;
  dim3 grid((nq + kBQ - 1) / kBQ, splits);
  ivf_fp32_kernel<Corpus, KP><<<grid, kNT, smem, stream>>>(q, qk, corpus, ck, tiles, nq, d, k,
                                                           tiles_per_split, out_v, out_i);
  return cudaGetLastError();
}

template <typename Corpus>
cudaError_t launch_fp32(const float* q, const int* qk, Corpus corpus, const int* ck,
                        UnionTiles tiles, int nq, int d, int k, int splits, float* sv, int* si,
                        cudaStream_t s) {
#define TPUALIGN_IVF_FP32(KP) \
  launch_fp32_kp<Corpus, KP>(q, qk, corpus, ck, tiles, nq, d, k, splits, sv, si, s)
  if (k <= 16) return TPUALIGN_IVF_FP32(16);
  if (k <= 32) return TPUALIGN_IVF_FP32(32);
  if (k <= 64) return TPUALIGN_IVF_FP32(64);
  return TPUALIGN_IVF_FP32(128);
#undef TPUALIGN_IVF_FP32
}

// -- the integer sweep (K3's int_sweep_kernel over the union's tiles) ---------

constexpr int kIQ = 64;       // queries per block
constexpr int kIT = 256;      // threads per block
constexpr int kUW = 16;       // unpacked s8 words (64 dims) per chunk
constexpr int kILD = kBN + 4; // word stride of the transposed tiles

// Plane p of a packed corpus word as four s8 values (K3's unpack). P =
// codes per byte: 1 int8, 2 int4 (offset-8 nibbles), 4 int2 (c -> 2c - 3).
template <int P>
__device__ __forceinline__ int plane_word(unsigned int w, int p) {
  if (P == 1) return (int)w;
  if (P == 2) return (int)__vsub4((p == 0 ? w : w >> 4) & 0x0F0F0F0Fu, 0x08080808u);
  return (int)__vsub4(((w >> (2 * p)) & 0x03030303u) << 1, 0x03030303u);
}

template <int P, int KP>
__global__ void __launch_bounds__(kIT)
ivf_int_kernel(const int* __restrict__ qw, const float* __restrict__ qscale,
               const int* __restrict__ qk, const unsigned int* __restrict__ cw,
               const float* __restrict__ cscale, const int* __restrict__ ck, UnionTiles tiles,
               int nq, int d, int k, int tiles_per_split, float* __restrict__ out_v,
               int* __restrict__ out_i) {
  extern __shared__ int ismem[];
  int* qs = ismem;                                       // [kUW][kILD] query words
  int* cs = qs + kUW * kILD;                             // [kUW][kILD] corpus words
  float* tv = reinterpret_cast<float*>(cs + kUW * kILD); // [kIQ][kBN] tile candidates
  int* ti = reinterpret_cast<int*>(tv + kIQ * kBN);
  float* rv = reinterpret_cast<float*>(ti + kIQ * kBN);  // [kIQ][KP] running top-k
  int* ri = reinterpret_cast<int*>(rv + kIQ * KP);
  int* qkeys = ri + kIQ * KP;                            // [kIQ]
  float* qsc = reinterpret_cast<float*>(qkeys + kIQ);    // [kIQ]
  int* ckeys = reinterpret_cast<int*>(qsc + kIQ);        // [kBN]
  float* csc = reinterpret_cast<float*>(ckeys + kBN);    // [kBN]
  int* qmem = reinterpret_cast<int*>(csc + kBN);         // [kIQ] probe membership

  constexpr int kPW = kUW / P;   // packed words per row per chunk
  const int ww = d / (4 * P);    // packed words per corpus row
  const int qww = d / 4;         // words per query row
  const int tid = threadIdx.x;
  const int warp = tid / 32, lane = tid % 32;
  const int tx = tid % 16;   // corpus columns tx*4 .. tx*4+3
  const int ty = tid / 16;   // query rows ty*4 .. ty*4+3
  const int q0 = blockIdx.x * kIQ;
  const int split = blockIdx.y;
  const int splits = gridDim.y;
  const int t_begin = split * tiles_per_split;
  const int t_end = min(tiles.count(), t_begin + tiles_per_split);

  for (int e = tid; e < kIQ * KP; e += kIT) {
    rv[e] = kNegInf;
    ri[e] = kSentinel;
  }
  if (tid < kIQ) {
    qkeys[tid] = (q0 + tid < nq) ? qk[q0 + tid] : -2;
    qsc[tid] = (q0 + tid < nq) ? qscale[q0 + tid] : 0.f;
  }

  for (int tile = t_begin; tile < t_end; ++tile) {
    const Tile at = tiles.locate(tile);
    if (at.rows <= 0) continue;  // padding: the same for every thread
    const bool m = tid < kIQ && q0 + tid < nq && tiles.member(q0 + tid, at);
    if (tid < kIQ) qmem[tid] = m;
    if (!__syncthreads_or(m)) continue;  // no query of the block probed it
    const int n0 = at.row0;
    if (tid < kBN) {
      ckeys[tid] = (tid < at.rows) ? ck[n0 + tid] : -1;
      csc[tid] = (tid < at.rows) ? cscale[n0 + tid] : 0.f;
    }

    int acc[4][4];
#pragma unroll
    for (int a = 0; a < 4; ++a)
#pragma unroll
      for (int b = 0; b < 4; ++b) acc[a][b] = 0;

    for (int w0 = 0; w0 < ww; w0 += kPW) {
      __syncthreads();
      // query words: unpacked word u = p * kPW + x holds the query dims
      // that meet plane p of packed word w0 + x
      for (int e = tid; e < kIQ * kUW; e += kIT) {
        const int r = e / kUW, u = e % kUW;
        const int p = u / kPW, pw = w0 + u % kPW;
        qs[u * kILD + r] = (q0 + r < nq && pw < ww)
                               ? __ldg(qw + (size_t)(q0 + r) * qww + p * ww + pw)
                               : 0;
      }
      for (int e = tid; e < kBN * kPW; e += kIT) {
        const int r = e / kPW, x = e % kPW;
        const int pw = w0 + x;
        const bool in = r < at.rows && pw < ww;
        const unsigned int w = in ? __ldg(cw + (size_t)(n0 + r) * ww + pw) : 0u;
#pragma unroll
        for (int p = 0; p < P; ++p) cs[(p * kPW + x) * kILD + r] = in ? plane_word<P>(w, p) : 0;
      }
      __syncthreads();
#pragma unroll
      for (int u = 0; u < kUW; ++u) {
        const int4 a = *reinterpret_cast<const int4*>(qs + u * kILD + ty * 4);
        const int4 b = *reinterpret_cast<const int4*>(cs + u * kILD + tx * 4);
        const int av[4] = {a.x, a.y, a.z, a.w};
        const int bv[4] = {b.x, b.y, b.z, b.w};
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int j = 0; j < 4; ++j) acc[i][j] = __dp4a(av[i], bv[j], acc[i][j]);
      }
    }

    // rescale, (float(acc) * qs) * cs, the key mask and membership
#pragma unroll
    for (int a = 0; a < 4; ++a) {
      const int r = ty * 4 + a;
      const int qkey = qkeys[r];
      const float s_q = qsc[r];
      const bool takes = qmem[r];
#pragma unroll
      for (int b = 0; b < 4; ++b) {
        const int col = tx * 4 + b;
        const bool valid = takes && col < at.rows && key_match(qkey, ckeys[col]);
        tv[r * kBN + col] =
            valid ? __fmul_rn(__fmul_rn(__int2float_rn(acc[a][b]), s_q), csc[col]) : kNegInf;
        ti[r * kBN + col] = valid ? n0 + col : kSentinel;
      }
    }
    __syncthreads();

    // merge: one warp per query row
    for (int r = warp; r < kIQ; r += kIT / 32) {
      if (q0 + r >= nq) break;
      merge_tile<kBN, KP>(tv + r * kBN, ti + r * kBN, rv + r * KP, ri + r * KP, k, lane);
    }
  }
  __syncthreads();

  for (int e = tid; e < kIQ * k; e += kIT) {
    const int r = e / k, j = e % k;
    if (q0 + r < nq) {
      const size_t o = ((size_t)(q0 + r) * splits + split) * k + j;
      out_v[o] = rv[r * KP + j];
      out_i[o] = ri[r * KP + j];
    }
  }
}

template <int P, int KP>
cudaError_t launch_int_kp(const void* q, const void* qs, const void* qk, const void* c,
                          const void* cs, const void* ck, UnionTiles tiles, int nq, int d, int k,
                          int splits, float* out_v, int* out_i, cudaStream_t stream) {
  const size_t smem = sizeof(int) * 2 * kUW * kILD +
                      (sizeof(float) + sizeof(int)) * ((size_t)kIQ * kBN + (size_t)kIQ * KP) +
                      (sizeof(int) + sizeof(float)) * (kIQ + kBN) + sizeof(int) * kIQ;
  static bool attr_set = false;
  if (!attr_set) {
    cudaError_t err = cudaFuncSetAttribute(
        ivf_int_kernel<P, KP>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return err;
    attr_set = true;
  }
  const int tiles_per_split = (tiles.count() + splits - 1) / splits;
  dim3 grid((nq + kIQ - 1) / kIQ, splits);
  ivf_int_kernel<P, KP><<<grid, kIT, smem, stream>>>(
      static_cast<const int*>(q), static_cast<const float*>(qs), static_cast<const int*>(qk),
      static_cast<const unsigned int*>(c), static_cast<const float*>(cs),
      static_cast<const int*>(ck), tiles, nq, d, k, tiles_per_split, out_v, out_i);
  return cudaGetLastError();
}

template <int P>
cudaError_t launch_int(const void* q, const void* qs, const void* qk, const void* c,
                       const void* cs, const void* ck, UnionTiles tiles, int nq, int d, int k,
                       int splits, float* sv, int* si, cudaStream_t s) {
#define TPUALIGN_IVF_INT(KP) \
  launch_int_kp<P, KP>(q, qs, qk, c, cs, ck, tiles, nq, d, k, splits, sv, si, s)
  if (k <= 16) return TPUALIGN_IVF_INT(16);
  if (k <= 32) return TPUALIGN_IVF_INT(32);
  if (k <= 64) return TPUALIGN_IVF_INT(64);
  return TPUALIGN_IVF_INT(128);
#undef TPUALIGN_IVF_INT
}

}  // namespace

// variant: 0 s8, 1 int4, 2 int2 (q: (nq, d) int8 quantized queries, qs their
//   (nq,) fp32 scales; c: (n_rows, d) int8, (n_rows, d/2) or (n_rows, d/4)
//   uint8 with d a multiple of 4, 8 or 16); 3 dequant (q: (nq, d) fp32, c:
//   (n_rows, d) int8); 4 fp32 (q and c fp32, cs unused). cs: (n_rows,) fp32
//   row scales; ck: (n_rows,) int32 keys, -1 unused.
// probes: (nq, p) int32 cluster ids; uids: (n_uids,) int32 block ids.
// bits: (nq, ceil(n_lists / 32)) u32 scratch. part_v/part_i: (nq, splits,
// k) scratch, used when splits > 1. out_v/out_i: (nq, k). k <= 128;
// splits * k <= 4096. Returns a cudaError_t.
extern "C" int tpualign_ivf_probe_topk(int variant, const void* q, const void* qs,
                                       const void* qk, const void* probes, int p,
                                       const void* uids, int n_uids, const void* c,
                                       const void* cs, const void* ck, int n_rows,
                                       int capacity, int n_lists, int nq, int d, int k,
                                       int splits, void* bits, void* part_v, void* part_i,
                                       void* out_v, void* out_i, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  if (simtopk::bad_args(nq, n_rows, d, k, splits) || variant < 0 || variant > 4 || p < 0 ||
      n_uids < 0 || capacity <= 0 || n_lists <= 0 ||
      (variant <= 2 && d % (4 << variant)))
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int words = (n_lists + 31) / 32;
  unsigned int* b = static_cast<unsigned int*>(bits);
  err = cudaMemsetAsync(b, 0, sizeof(unsigned int) * (size_t)nq * words, s);
  if (err != cudaSuccess) return (int)err;
  const long long pairs = (long long)nq * p;
  if (pairs > 0) {
    probe_bits_kernel<<<(unsigned int)((pairs + 255) / 256), 256, 0, s>>>(
        static_cast<const int*>(probes), nq, p, n_lists, words, b);
    err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
  }
  const UnionTiles tiles{static_cast<const int*>(uids), n_uids,
                         (capacity + simtopk::kBN - 1) / simtopk::kBN,
                         capacity, n_lists, n_rows, b, words};
  float* sv = static_cast<float*>(splits > 1 ? part_v : out_v);
  int* si = static_cast<int*>(splits > 1 ? part_i : out_i);
  if (variant == 4)
    err = launch_fp32(static_cast<const float*>(q), static_cast<const int*>(qk),
                      simtopk::Fp32Corpus{static_cast<const float*>(c)},
                      static_cast<const int*>(ck),
                      tiles, nq, d, k, splits, sv, si, s);
  else if (variant == 3)
    err = launch_fp32(static_cast<const float*>(q), static_cast<const int*>(qk),
                      simtopk::Int8DequantCorpus{static_cast<const int8_t*>(c),
                                                 static_cast<const float*>(cs)},
                      static_cast<const int*>(ck), tiles, nq, d, k, splits, sv, si, s);
  else if (variant == 0)
    err = launch_int<1>(q, qs, qk, c, cs, ck, tiles, nq, d, k, splits, sv, si, s);
  else if (variant == 1)
    err = launch_int<2>(q, qs, qk, c, cs, ck, tiles, nq, d, k, splits, sv, si, s);
  else
    err = launch_int<4>(q, qs, qk, c, cs, ck, tiles, nq, d, k, splits, sv, si, s);
  if (err != cudaSuccess || splits == 1) return (int)err;
  return (int)simtopk::launch_merge(part_v, part_i, nq, splits, k, out_v, out_i, s);
}
