// Fused masked similarity + running top-k over an fp32 corpus, for sm_90a.
//
// Replaces the Pallas TPU kernel tpualign/ops/pallas_kernels.py
// (masked_sim_topk -> _sim_topk_one_segment -> _make_sim_topk_kernel with
// _score_fp32 and _merge_running_topk). Per query it returns the top-k of
// q.c over the corpus rows with ((qk == ck) | (qk == WILDCARD)) & (ck >= 0),
// ordered by value descending then index ascending; empty slots are exactly
// (NEG_INF, SENTINEL_IDX).
//
// Bound on the H100: operations. At Q=1,024, N=100,000, D=512 the dense
// score is 105 GFLOP of fp32 (about 1.6 ms at 67 TFLOP/s outside the tensor
// cores) against a 205 MB corpus read (about 61 us at 3.35 TB/s). Scores
// are taken in full fp32 FMA, no TF32, each by one thread over D in
// ascending order, so identical corpus rows score bit-identically and ties
// resolve by index alone. The design streams the corpus: a block holds a
// tile of 32 queries and sweeps corpus tiles of 64 rows, scoring them with
// a register-tiled product (2 x 4 scores per thread, D in chunks of 32
// through shared memory) and merging each tile into a running top-k kept
// in shared memory, so the (Q, N) score matrix never reaches device memory.
// A merge sorts the tile's candidates (bitonic, one warp per query) and
// merges them with the running list (bitonic merge); a query skips the
// merge when no candidate beats its current k-th entry, which is exact
// because the comparator is a total order. Masked candidates carry the
// sentinel itself and so never displace it. Blocks share no state, so to
// fill the 132 SMs the corpus is cut into `splits` ranges, each block
// writes its range's top-k, and a second kernel merges the ranges' lists
// per query with one bitonic sort.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -O3 -shared
//        -Xcompiler -fPIC (tpualign_torch/ops/build.py).

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kBQ = 32;    // queries per block
constexpr int kBN = 64;    // corpus rows per tile
constexpr int kDK = 32;    // depth per shared-memory chunk
constexpr int kNT = 256;   // threads per block
constexpr int kQLD = kBQ + 4;
constexpr int kCLD = kBN + 4;
constexpr float kNegInf = -1e30f;       // tpualign NEG_INF
constexpr int kSentinel = 1 << 30;      // tpualign SENTINEL_IDX
constexpr int kWildcard = -3;           // tpualign WILDCARD_KEY
constexpr int kMergeThreads = 256;

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

template <int KP>
__global__ void __launch_bounds__(kNT)
sim_topk_kernel(const float* __restrict__ q, const int* __restrict__ qk,
                const float* __restrict__ c, const int* __restrict__ ck,
                int nq, int n, int d, int k, int tiles_per_split,
                float* __restrict__ out_v, int* __restrict__ out_i) {
  extern __shared__ float smem[];
  float* qs = smem;                           // [kDK][kQLD] query chunk, transposed
  float* cs = qs + kDK * kQLD;                // [kDK][kCLD] corpus chunk, transposed
  float* tv = cs + kDK * kCLD;                // [kBQ][kBN] tile candidates
  int* ti = reinterpret_cast<int*>(tv + kBQ * kBN);
  float* rv = reinterpret_cast<float*>(ti + kBQ * kBN);  // [kBQ][KP] running top-k
  int* ri = reinterpret_cast<int*>(rv + kBQ * KP);
  int* qkeys = ri + kBQ * KP;                 // [kBQ]
  int* ckeys = qkeys + kBQ;                   // [kBN]

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
    if (tid < kBN) ckeys[tid] = (n0 + tid < n) ? ck[n0 + tid] : -1;

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
        cs[x * kCLD + r] =
            (n0 + r < n && d0 + x < d) ? c[(size_t)(n0 + r) * d + d0 + x] : 0.f;
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
        const int ckey = ckeys[col];
        const bool valid = q0 + r < nq && n0 + col < n && ckey >= 0 &&
                           (qkey == ckey || qkey == kWildcard);
        tv[r * kBN + col] = valid ? acc[a][b] : kNegInf;
        ti[r * kBN + col] = valid ? n0 + col : kSentinel;
      }
    }
    __syncthreads();

    // merge: one warp per query row
    for (int r = warp; r < kBQ; r += kNT / 32) {
      if (q0 + r >= nq) break;
      float* tvr = tv + r * kBN;
      int* tir = ti + r * kBN;
      float* rvr = rv + r * KP;
      int* rir = ri + r * KP;
      const float th_v = rvr[k - 1];
      const int th_i = rir[k - 1];
      bool beats = false;
      for (int j = lane; j < kBN; j += 32) beats |= better(tvr[j], tir[j], th_v, th_i);
      if (!__any_sync(0xffffffffu, beats)) continue;

      // bitonic sort of the tile, descending (kBN / 2 == 32 pairs, one per lane)
      for (int size = 2; size <= kBN; size <<= 1) {
        for (int stride = size >> 1; stride > 0; stride >>= 1) {
          const int i = 2 * stride * (lane / stride) + (lane % stride);
          order(tvr, tir, i, i + stride, (i & size) == 0);
          __syncwarp();
        }
      }
      // best of running[i] and tile[KP-1-i]: a bitonic sequence holding the
      // top KP of both lists
      for (int i = lane; i < KP; i += 32) {
        const int j = KP - 1 - i;
        const float bv = j < kBN ? tvr[j] : kNegInf;
        const int bi = j < kBN ? tir[j] : kSentinel;
        if (better(bv, bi, rvr[i], rir[i])) {
          rvr[i] = bv;
          rir[i] = bi;
        }
      }
      __syncwarp();
      for (int stride = KP >> 1; stride > 0; stride >>= 1) {
        for (int p = lane; p < KP / 2; p += 32) {
          const int i = 2 * stride * (p / stride) + (p % stride);
          order(rvr, rir, i, i + stride, true);
        }
        __syncwarp();
      }
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

// One block per query: sorts the splits' lists (splits * k entries) and
// keeps the first k.
__global__ void __launch_bounds__(kMergeThreads)
merge_kernel(const float* __restrict__ part_v, const int* __restrict__ part_i,
             int total, int p2, int k, float* __restrict__ out_v,
             int* __restrict__ out_i) {
  extern __shared__ float smem[];
  float* sv = smem;
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

template <int KP>
cudaError_t launch_sweep(const float* q, const int* qk, const float* c, const int* ck,
                         int nq, int n, int d, int k, int splits, float* out_v,
                         int* out_i, cudaStream_t stream) {
  const size_t smem = sizeof(float) * ((size_t)kDK * kQLD + (size_t)kDK * kCLD) +
                      (sizeof(float) + sizeof(int)) * ((size_t)kBQ * kBN + (size_t)kBQ * KP) +
                      sizeof(int) * (kBQ + kBN);
  static bool attr_set = false;
  if (!attr_set) {
    cudaError_t err = cudaFuncSetAttribute(
        sim_topk_kernel<KP>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return err;
    attr_set = true;
  }
  const int n_tiles = (n + kBN - 1) / kBN;
  const int tiles_per_split = (n_tiles + splits - 1) / splits;
  dim3 grid((nq + kBQ - 1) / kBQ, splits);
  sim_topk_kernel<KP><<<grid, kNT, smem, stream>>>(q, qk, c, ck, nq, n, d, k,
                                                   tiles_per_split, out_v, out_i);
  return cudaGetLastError();
}

}  // namespace

// part_v/part_i: (nq, splits, k) scratch, used when splits > 1.
// out_v/out_i: (nq, k). k <= 128; splits * k <= 4096. Returns a cudaError_t.
extern "C" int tpualign_masked_sim_topk(const void* q, const void* qk, const void* c,
                                        const void* ck, int nq, int n, int d, int k,
                                        int splits, void* part_v, void* part_i,
                                        void* out_v, void* out_i, int device,
                                        void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  if (nq <= 0 || n < 0 || d <= 0 || k <= 0 || k > 128 || splits <= 0 || splits * k > 4096)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* qf = static_cast<const float*>(q);
  const int* qki = static_cast<const int*>(qk);
  const float* cf = static_cast<const float*>(c);
  const int* cki = static_cast<const int*>(ck);
  float* sweep_v = static_cast<float*>(splits > 1 ? part_v : out_v);
  int* sweep_i = static_cast<int*>(splits > 1 ? part_i : out_i);
  if (k <= 16)
    err = launch_sweep<16>(qf, qki, cf, cki, nq, n, d, k, splits, sweep_v, sweep_i, s);
  else if (k <= 32)
    err = launch_sweep<32>(qf, qki, cf, cki, nq, n, d, k, splits, sweep_v, sweep_i, s);
  else if (k <= 64)
    err = launch_sweep<64>(qf, qki, cf, cki, nq, n, d, k, splits, sweep_v, sweep_i, s);
  else
    err = launch_sweep<128>(qf, qki, cf, cki, nq, n, d, k, splits, sweep_v, sweep_i, s);
  if (err != cudaSuccess || splits == 1) return (int)err;

  const int total = splits * k;
  int p2 = 1;
  while (p2 < total) p2 <<= 1;
  const size_t smem = (sizeof(float) + sizeof(int)) * (size_t)p2;
  merge_kernel<<<nq, kMergeThreads, smem, s>>>(
      static_cast<const float*>(part_v), static_cast<const int*>(part_i), total, p2, k,
      static_cast<float*>(out_v), static_cast<int*>(out_i));
  return (int)cudaGetLastError();
}
