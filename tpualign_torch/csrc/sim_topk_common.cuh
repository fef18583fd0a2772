// The running top-k and the fp32 sweep shared by the masked similarity
// kernels (K2 fp32 in masked_sim_topk.cu, K3 quantized in
// masked_sim_topk_quant.cu), for sm_90a.
//
// Order is (value desc, index asc), a total order, so every step below is
// exact: the bitonic sort of a tile's candidates, the bitonic merge into a
// query's running list, the skip of a tile none of whose candidates beats
// the running k-th entry, and the cross-range merge of the corpus splits.
// A masked candidate is the empty slot itself, (kNegInf, kSentinel), so it
// never displaces one.

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace simtopk {

constexpr float kNegInf = -1e30f;       // tpualign NEG_INF
constexpr int kSentinel = 1 << 30;      // tpualign SENTINEL_IDX
constexpr int kWildcard = -3;           // tpualign WILDCARD_KEY
constexpr int kMergeThreads = 256;
constexpr int kMaxK = 128;
constexpr int kMergeMax = 4096;         // splits * k bound of the cross-range merge

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
// real corpus rows only.
__device__ __forceinline__ bool key_match(int qkey, int ckey) {
  return ckey >= 0 && (qkey == ckey || qkey == kWildcard);
}

// One warp merges one query's tile of BN candidates (tv/ti, in shared
// memory, clobbered) into its running list of KP slots (rv/ri, sorted).
// Skips the tile when no candidate beats the k-th entry.
template <int BN, int KP>
__device__ __forceinline__ void merge_tile(float* tv, int* ti, float* rv, int* ri, int k,
                                           int lane) {
  static_assert(BN == 64, "one bitonic pair per lane");
  const float th_v = rv[k - 1];
  const int th_i = ri[k - 1];
  bool beats = false;
  for (int j = lane; j < BN; j += 32) beats |= better(tv[j], ti[j], th_v, th_i);
  if (!__any_sync(0xffffffffu, beats)) return;

  // bitonic sort of the tile, descending (BN / 2 == 32 pairs, one per lane)
  for (int size = 2; size <= BN; size <<= 1) {
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
    const float bv = j < BN ? tv[j] : kNegInf;
    const int bi = j < BN ? ti[j] : kSentinel;
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

// One block per query: sorts the splits' lists (splits * k entries) and
// keeps the first k.
__global__ void __launch_bounds__(kMergeThreads)
merge_kernel(const float* __restrict__ part_v, const int* __restrict__ part_i,
             int total, int p2, int k, float* __restrict__ out_v,
             int* __restrict__ out_i) {
  extern __shared__ float merge_smem[];
  float* sv = merge_smem;
  int* si = reinterpret_cast<int*>(sv + p2);
  const size_t base = (size_t)blockIdx.x * total;
  for (int e = threadIdx.x; e < p2; e += kMergeThreads) {
    sv[e] = e < total ? part_v[base + e] : kNegInf;
    si[e] = e < total ? part_i[base + e] : kSentinel;
  }
  __syncthreads();
  for (int size = 2; size <= p2; size <<= 1) {
    for (int stride = size >> 1; stride > 0; stride >>= 1) {
      for (int p = threadIdx.x; p < p2 / 2; p += kMergeThreads) {
        const int i = 2 * stride * (p / stride) + (p % stride);
        order(sv, si, i, i + stride, (i & size) == 0);
      }
      __syncthreads();
    }
  }
  for (int j = threadIdx.x; j < k; j += kMergeThreads) {
    out_v[(size_t)blockIdx.x * k + j] = sv[j];
    out_i[(size_t)blockIdx.x * k + j] = si[j];
  }
}

// Merges (nq, splits, k) partial lists into (nq, k).
inline cudaError_t launch_merge(const void* part_v, const void* part_i, int nq, int splits,
                                int k, void* out_v, void* out_i, cudaStream_t stream) {
  const int total = splits * k;
  int p2 = 1;
  while (p2 < total) p2 <<= 1;
  const size_t smem = (sizeof(float) + sizeof(int)) * (size_t)p2;
  merge_kernel<<<nq, kMergeThreads, smem, stream>>>(
      static_cast<const float*>(part_v), static_cast<const int*>(part_i), total, p2, k,
      static_cast<float*>(out_v), static_cast<int*>(out_i));
  return cudaGetLastError();
}

// -- the fp32 sweep ------------------------------------------------------------
//
// A block holds a tile of 32 queries and sweeps corpus tiles of 64 rows,
// scoring them with a register-tiled product (2 x 4 scores per thread, D in
// chunks of 32 through shared memory) and merging each tile into a running
// top-k kept in shared memory, so the (Q, N) score matrix never reaches
// device memory. Scores are full fp32 FMA chains, no TF32, each taken by
// one thread over D in ascending order, so identical corpus rows score
// bit-identically and ties resolve by index alone. Block (x, y) sweeps the
// y-th of gridDim.y corpus ranges and writes that range's top-k.
//
// `Corpus` reads element (row, x) of the corpus as fp32: Fp32Corpus (K2)
// reads fp32 rows; Int8DequantCorpus (K3's dequant variant) multiplies an
// int8 code by its row's scale, exactly `float(c) * cs` as tpualign's
// _score_fp32 dequantizes, before the fp32 product.

constexpr int kBQ = 32;    // queries per block
constexpr int kBN = 64;    // corpus rows per tile
constexpr int kDK = 32;    // depth per shared-memory chunk
constexpr int kNT = 256;   // threads per block
constexpr int kQLD = kBQ + 4;
constexpr int kCLD = kBN + 4;

struct Fp32Corpus {
  static constexpr bool kScaled = false;
  const float* c;
  __device__ __forceinline__ float scale(int) const { return 1.f; }
  __device__ __forceinline__ float at(int row, int x, int d, float) const {
    return __ldg(c + (size_t)row * d + x);
  }
};

struct Int8DequantCorpus {
  static constexpr bool kScaled = true;
  const int8_t* c;
  const float* cs;
  __device__ __forceinline__ float scale(int row) const { return __ldg(cs + row); }
  __device__ __forceinline__ float at(int row, int x, int d, float s) const {
    return __fmul_rn((float)__ldg(c + (size_t)row * d + x), s);
  }
};

template <typename Corpus, int KP>
__global__ void __launch_bounds__(kNT)
fp32_sweep_kernel(const float* __restrict__ q, const int* __restrict__ qk, Corpus corpus,
                  const int* __restrict__ ck, int nq, int n, int d, int k,
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

  const int tid = threadIdx.x;
  const int warp = tid / 32, lane = tid % 32;
  const int tx = tid % 16;   // corpus columns tx*4 .. tx*4+3
  const int ty = tid / 16;   // query rows ty*2, ty*2+1
  const int q0 = blockIdx.x * kBQ;
  const int split = blockIdx.y;
  const int splits = gridDim.y;
  const int n_tiles = (n + kBN - 1) / kBN;
  const int t_begin = split * tiles_per_split;
  const int t_end = min(n_tiles, t_begin + tiles_per_split);

  for (int e = tid; e < kBQ * KP; e += kNT) {
    rv[e] = kNegInf;
    ri[e] = kSentinel;
  }
  if (tid < kBQ) qkeys[tid] = (q0 + tid < nq) ? qk[q0 + tid] : -2;

  for (int tile = t_begin; tile < t_end; ++tile) {
    const int n0 = tile * kBN;
    if (tid < kBN) {
      ckeys[tid] = (n0 + tid < n) ? ck[n0 + tid] : -1;
      if (Corpus::kScaled) cscale[tid] = (n0 + tid < n) ? corpus.scale(n0 + tid) : 0.f;
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
        cs[x * kCLD + r] = (n0 + r < n && d0 + x < d)
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

    // key mask; a masked slot is the sentinel itself
#pragma unroll
    for (int a = 0; a < 2; ++a) {
      const int r = ty * 2 + a;
      const int qkey = qkeys[r];
#pragma unroll
      for (int b = 0; b < 4; ++b) {
        const int col = tx * 4 + b;
        const bool valid = q0 + r < nq && n0 + col < n && key_match(qkey, ckeys[col]);
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
cudaError_t launch_fp32_sweep_kp(const float* q, const int* qk, Corpus corpus, const int* ck,
                                 int nq, int n, int d, int k, int splits, float* out_v,
                                 int* out_i, cudaStream_t stream) {
  const size_t smem = sizeof(float) * ((size_t)kDK * kQLD + (size_t)kDK * kCLD) +
                      (sizeof(float) + sizeof(int)) * ((size_t)kBQ * kBN + (size_t)kBQ * KP) +
                      sizeof(int) * (kBQ + kBN) + sizeof(float) * kBN;
  static bool attr_set = false;
  if (!attr_set) {
    cudaError_t err = cudaFuncSetAttribute(fp32_sweep_kernel<Corpus, KP>,
                                           cudaFuncAttributeMaxDynamicSharedMemorySize,
                                           (int)smem);
    if (err != cudaSuccess) return err;
    attr_set = true;
  }
  const int n_tiles = (n + kBN - 1) / kBN;
  const int tiles_per_split = (n_tiles + splits - 1) / splits;
  dim3 grid((nq + kBQ - 1) / kBQ, splits);
  fp32_sweep_kernel<Corpus, KP><<<grid, kNT, smem, stream>>>(q, qk, corpus, ck, nq, n, d, k,
                                                             tiles_per_split, out_v, out_i);
  return cudaGetLastError();
}

// The whole search over an fp32-scored corpus: the sweep into
// (nq, splits, k) partial lists (straight into out_* when splits == 1),
// then the cross-range merge.
template <typename Corpus>
cudaError_t fp32_sim_topk(const float* q, const int* qk, Corpus corpus, const int* ck, int nq,
                          int n, int d, int k, int splits, void* part_v, void* part_i,
                          void* out_v, void* out_i, cudaStream_t s) {
  float* sv = static_cast<float*>(splits > 1 ? part_v : out_v);
  int* si = static_cast<int*>(splits > 1 ? part_i : out_i);
  cudaError_t err;
  if (k <= 16)
    err = launch_fp32_sweep_kp<Corpus, 16>(q, qk, corpus, ck, nq, n, d, k, splits, sv, si, s);
  else if (k <= 32)
    err = launch_fp32_sweep_kp<Corpus, 32>(q, qk, corpus, ck, nq, n, d, k, splits, sv, si, s);
  else if (k <= 64)
    err = launch_fp32_sweep_kp<Corpus, 64>(q, qk, corpus, ck, nq, n, d, k, splits, sv, si, s);
  else
    err = launch_fp32_sweep_kp<Corpus, 128>(q, qk, corpus, ck, nq, n, d, k, splits, sv, si, s);
  if (err != cudaSuccess || splits == 1) return err;
  return launch_merge(part_v, part_i, nq, splits, k, out_v, out_i, s);
}

// Arguments every entry point checks: k <= 128 and splits * k within the
// merge's bound.
inline bool bad_args(int nq, int n, int d, int k, int splits) {
  return nq <= 0 || n < 0 || d <= 0 || k <= 0 || k > kMaxK || splits <= 0 ||
         splits * k > kMergeMax;
}

}  // namespace simtopk
