// Fused masked similarity + running top-k over a per-row-quantized corpus
// (int8, packed int4, packed int2), for sm_90a.
//
// Replaces the quantized scorers of the Pallas TPU kernel
// tpualign/ops/pallas_kernels.py (masked_sim_topk -> _sim_topk_one_segment
// -> _make_sim_topk_kernel with _score_int8_mxu, _score_int4_mxu,
// _score_int2_mxu, and _score_fp32 with row scales). The mask, order and
// empty slots are K2's (sim_topk_common.cuh): per query the top-k over the
// rows with ((qk == ck) | (qk == WILDCARD)) & (ck >= 0), by value
// descending then index ascending, empty slots exactly
// (NEG_INF, SENTINEL_IDX).
//
// Integer variants. Queries arrive quantized (qq int8 and a fp32 scale per
// row, computed by the wrapper exactly as tpualign does); the corpus is
// int8 (N, D), or int4 (N, D/2) bytes of two offset-8 nibbles (the low
// nibble of byte j is dim j, the high nibble dim j + D/2), or int2 (N, D/4)
// bytes of four 2-bit codes (plane p, bits 2p..2p+1 of byte j, is dim
// j + pD/4 with value 2c - 3). Each score is the int32 sum of qq * cq,
// exact in any order, rescaled as (float(acc) * qs) * cs with one rounding
// per product, the order of tpualign's epilogue, so every score equals the
// plain version's bit for bit.
//
// Bound on the H100: bytes at serving shapes. At Q=1,024, N=1,000,000,
// D=512 the int8 corpus is 512 MB (153 us at 3.35 TB/s; int4 and int2 a
// half and a quarter of that), and the pairs the key mask admits need far
// fewer integer operations than the tensor cores' 1,979 TOP/s could do in
// that time. This first kernel takes the products on the CUDA cores with
// __dp4a, four s8 products per instruction: a block holds 64 queries and
// sweeps corpus tiles of 64 rows, D in chunks of 64 dims through shared
// memory, where the int4 and int2 codes are unpacked to s8 words in
// registers on the way in (Hopper has no int4 tensor-core product) and the
// tile is stored transposed so that each thread reads its 4 queries' and 4
// rows' words with two 16-byte loads per 16 dp4a. The s8 tile is a quarter
// of K2's fp32 tile, so the block takes twice K2's queries (64) at the same
// shared memory. Tensor-core products (mma.sync or wgmma on s8, with TMA
// loads) are the next step.
//
// Dequant variant (int8 codes with row scales, fp32 queries): each code is
// dequantized as float(c) * cs, then K2's fp32 sweep scores it
// (sim_topk_common.cuh, Int8DequantCorpus), as tpualign's _score_fp32 does
// with row scales.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -O3 -shared
//        -Xcompiler -fPIC (tpualign_torch/ops/build.py).

#include <cuda_runtime.h>
#include <stdint.h>

#include "sim_topk_common.cuh"

namespace {

using simtopk::kNegInf;
using simtopk::kSentinel;

constexpr int kIQ = 64;       // queries per block
constexpr int kIN = 64;       // corpus rows per tile
constexpr int kIT = 256;      // threads per block
constexpr int kUW = 16;       // unpacked s8 words (64 dims) per chunk
constexpr int kILD = 64 + 4;  // word stride of the transposed tiles

// Plane p of a packed corpus word as four s8 values. P = codes per byte:
// 1 int8, 2 int4 (offset-8 nibbles), 4 int2 (codes c -> 2c - 3).
template <int P>
__device__ __forceinline__ int plane_word(unsigned int w, int p) {
  if (P == 1) return (int)w;
  if (P == 2) return (int)__vsub4((p == 0 ? w : w >> 4) & 0x0F0F0F0Fu, 0x08080808u);
  return (int)__vsub4(((w >> (2 * p)) & 0x03030303u) << 1, 0x03030303u);
}

template <int P, int KP>
__global__ void __launch_bounds__(kIT)
int_sweep_kernel(const int* __restrict__ qw, const float* __restrict__ qscale,
                 const int* __restrict__ qk, const unsigned int* __restrict__ cw,
                 const float* __restrict__ cscale, const int* __restrict__ ck, int nq, int n,
                 int d, int k, int tiles_per_split, float* __restrict__ out_v,
                 int* __restrict__ out_i) {
  extern __shared__ int ismem[];
  int* qs = ismem;                                       // [kUW][kILD] query words
  int* cs = qs + kUW * kILD;                             // [kUW][kILD] corpus words
  float* tv = reinterpret_cast<float*>(cs + kUW * kILD); // [kIQ][kIN] tile candidates
  int* ti = reinterpret_cast<int*>(tv + kIQ * kIN);
  float* rv = reinterpret_cast<float*>(ti + kIQ * kIN);  // [kIQ][KP] running top-k
  int* ri = reinterpret_cast<int*>(rv + kIQ * KP);
  int* qkeys = ri + kIQ * KP;                            // [kIQ]
  float* qsc = reinterpret_cast<float*>(qkeys + kIQ);    // [kIQ]
  int* ckeys = reinterpret_cast<int*>(qsc + kIQ);        // [kIN]
  float* csc = reinterpret_cast<float*>(ckeys + kIN);    // [kIN]

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
  const int n_tiles = (n + kIN - 1) / kIN;
  const int t_begin = split * tiles_per_split;
  const int t_end = min(n_tiles, t_begin + tiles_per_split);

  for (int e = tid; e < kIQ * KP; e += kIT) {
    rv[e] = kNegInf;
    ri[e] = kSentinel;
  }
  if (tid < kIQ) {
    qkeys[tid] = (q0 + tid < nq) ? qk[q0 + tid] : -2;
    qsc[tid] = (q0 + tid < nq) ? qscale[q0 + tid] : 0.f;
  }

  for (int tile = t_begin; tile < t_end; ++tile) {
    const int n0 = tile * kIN;
    if (tid < kIN) {
      ckeys[tid] = (n0 + tid < n) ? ck[n0 + tid] : -1;
      csc[tid] = (n0 + tid < n) ? cscale[n0 + tid] : 0.f;
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
      for (int e = tid; e < kIN * kPW; e += kIT) {
        const int r = e / kPW, x = e % kPW;
        const int pw = w0 + x;
        const bool in = n0 + r < n && pw < ww;
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

    // rescale, (float(acc) * qs) * cs, and the key mask
#pragma unroll
    for (int a = 0; a < 4; ++a) {
      const int r = ty * 4 + a;
      const int qkey = qkeys[r];
      const float s_q = qsc[r];
#pragma unroll
      for (int b = 0; b < 4; ++b) {
        const int col = tx * 4 + b;
        const bool valid = q0 + r < nq && n0 + col < n && simtopk::key_match(qkey, ckeys[col]);
        tv[r * kIN + col] =
            valid ? __fmul_rn(__fmul_rn(__int2float_rn(acc[a][b]), s_q), csc[col]) : kNegInf;
        ti[r * kIN + col] = valid ? n0 + col : kSentinel;
      }
    }
    __syncthreads();

    // merge: one warp per query row
    for (int r = warp; r < kIQ; r += kIT / 32) {
      if (q0 + r >= nq) break;
      simtopk::merge_tile<kIN, KP>(tv + r * kIN, ti + r * kIN, rv + r * KP, ri + r * KP, k,
                                   lane);
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
cudaError_t launch_int_sweep_kp(const void* q, const void* qs, const void* qk, const void* c,
                                const void* cs, const void* ck, int nq, int n, int d, int k,
                                int splits, float* out_v, int* out_i, cudaStream_t stream) {
  const size_t smem = sizeof(int) * 2 * kUW * kILD +
                      (sizeof(float) + sizeof(int)) * ((size_t)kIQ * kIN + (size_t)kIQ * KP) +
                      (sizeof(int) + sizeof(float)) * (kIQ + kIN);
  static bool attr_set = false;
  if (!attr_set) {
    cudaError_t err = cudaFuncSetAttribute(
        int_sweep_kernel<P, KP>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return err;
    attr_set = true;
  }
  const int n_tiles = (n + kIN - 1) / kIN;
  const int tiles_per_split = (n_tiles + splits - 1) / splits;
  dim3 grid((nq + kIQ - 1) / kIQ, splits);
  int_sweep_kernel<P, KP><<<grid, kIT, smem, stream>>>(
      static_cast<const int*>(q), static_cast<const float*>(qs), static_cast<const int*>(qk),
      static_cast<const unsigned int*>(c), static_cast<const float*>(cs),
      static_cast<const int*>(ck), nq, n, d, k, tiles_per_split, out_v, out_i);
  return cudaGetLastError();
}

template <int P>
cudaError_t int_sim_topk(const void* q, const void* qs, const void* qk, const void* c,
                         const void* cs, const void* ck, int nq, int n, int d, int k,
                         int splits, void* part_v, void* part_i, void* out_v, void* out_i,
                         cudaStream_t s) {
  float* sv = static_cast<float*>(splits > 1 ? part_v : out_v);
  int* si = static_cast<int*>(splits > 1 ? part_i : out_i);
  cudaError_t err;
  if (k <= 16)
    err = launch_int_sweep_kp<P, 16>(q, qs, qk, c, cs, ck, nq, n, d, k, splits, sv, si, s);
  else if (k <= 32)
    err = launch_int_sweep_kp<P, 32>(q, qs, qk, c, cs, ck, nq, n, d, k, splits, sv, si, s);
  else if (k <= 64)
    err = launch_int_sweep_kp<P, 64>(q, qs, qk, c, cs, ck, nq, n, d, k, splits, sv, si, s);
  else
    err = launch_int_sweep_kp<P, 128>(q, qs, qk, c, cs, ck, nq, n, d, k, splits, sv, si, s);
  if (err != cudaSuccess || splits == 1) return err;
  return simtopk::launch_merge(part_v, part_i, nq, splits, k, out_v, out_i, s);
}

}  // namespace

// variant 0 s8, 1 int4, 2 int2: q is the (nq, d) int8 quantized queries and
//   qs their (nq,) fp32 scales; c is (n, d) int8, (n, d/2) or (n, d/4)
//   uint8 with d a multiple of 4, 8 or 16 respectively.
// variant 3 dequant: q is (nq, d) fp32, qs unused, c is (n, d) int8.
// cs: (n,) fp32 row scales. part_v/part_i: (nq, splits, k) scratch, used
// when splits > 1. out_v/out_i: (nq, k). k <= 128; splits * k <= 4096.
// Returns a cudaError_t.
extern "C" int tpualign_masked_sim_topk_quant(int variant, const void* q, const void* qs,
                                              const void* qk, const void* c, const void* cs,
                                              const void* ck, int nq, int n, int d, int k,
                                              int splits, void* part_v, void* part_i,
                                              void* out_v, void* out_i, int device,
                                              void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  if (simtopk::bad_args(nq, n, d, k, splits) || variant < 0 || variant > 3)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (variant == 3)
    return (int)simtopk::fp32_sim_topk(
        static_cast<const float*>(q), static_cast<const int*>(qk),
        simtopk::Int8DequantCorpus{static_cast<const int8_t*>(c),
                                   static_cast<const float*>(cs)},
        static_cast<const int*>(ck), nq, n, d, k, splits, part_v, part_i, out_v, out_i, s);
  const int planes = 1 << variant;  // codes per byte
  if (d % (4 * planes)) return (int)cudaErrorInvalidValue;
  if (variant == 0)
    return (int)int_sim_topk<1>(q, qs, qk, c, cs, ck, nq, n, d, k, splits, part_v, part_i,
                                out_v, out_i, s);
  if (variant == 1)
    return (int)int_sim_topk<2>(q, qs, qk, c, cs, ck, nq, n, d, k, splits, part_v, part_i,
                                out_v, out_i, s);
  return (int)int_sim_topk<4>(q, qs, qk, c, cs, ck, nq, n, d, k, splits, part_v, part_i,
                              out_v, out_i, s);
}
