// Fused short-sequence multi-head attention over packed QKV, for sm_90a.
//
// Replaces the Pallas TPU kernel tpualign/ops/pallas_attention.py
// (fused_mha -> _fused_mha_impl -> _mha_kernel / _mha_kernel_nomask).
// Per head it computes softmax(Q K^T * scale + mask) V, with the products
// in the input type accumulated in fp32, the scale and the softmax in fp32,
// the probabilities rounded to the input type before P.V (fp32
// accumulation), and the output in the input type.
//
// Bound on the H100: memory. At ViT-B-32, B=256, one launch reads the
// packed QKV once (59.0 MB vision, 60.6 MB text at T=77) and writes the
// context (19.7 / 20.2 MB): about 24 us at 3.35 TB/s, against about
// 2 GFLOP of work. The design keeps the T x T scores out of device memory:
// one block per (batch row, head, tile of 32 query rows) holds its query
// tile, one 32-row chunk of K or V at a time, and the tile's fp32 scores
// (32 x T) in shared memory, so device traffic is the QKV read and the
// context write (the K/V rows of a head are read once per query tile, from
// L2 after the first). The products run on the CUDA cores in fp32: a
// wgmma/TMA version is later work.
//
// Layout: qkv (B, T, 3*D) row-major, D = heads * HD; mask (T, T) fp32 or
// null; out (B, T, D). T <= 257, HD in {64, 80, 88, 104}.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -O3 -shared
//        -Xcompiler -fPIC (tpualign_torch/ops/build.py).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kQT = 32;    // query rows per block
constexpr int kKT = 32;    // K/V rows per shared-memory chunk
constexpr int kNT = 128;   // threads per block
constexpr int kMaxT = 257;

template <typename T>
__device__ __forceinline__ float to_f(T x);
template <>
__device__ __forceinline__ float to_f<float>(float x) { return x; }
template <>
__device__ __forceinline__ float to_f<__nv_bfloat16>(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

template <typename T>
__device__ __forceinline__ T from_f(float x);
template <>
__device__ __forceinline__ float from_f<float>(float x) { return x; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);  // round to nearest even
}

__device__ __forceinline__ float warp_max(float v) {
  for (int o = 16; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

__device__ __forceinline__ float warp_sum(float v) {
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// Copies rows [r0, r0 + rows) of one head's Q, K or V slice (column offset
// `col`) into a (kKT or kQT) x (HD+1) fp32 tile, zero past the last row.
template <typename T, int HD>
__device__ __forceinline__ void load_tile(float* dst, const T* __restrict__ base,
                                          int r0, int rows, int tile_rows, int ld3,
                                          int col) {
  constexpr int LD = HD + 1;
  for (int e = threadIdx.x; e < tile_rows * HD; e += kNT) {
    const int r = e / HD, c = e % HD;
    dst[r * LD + c] = r < rows ? to_f(base[(size_t)(r0 + r) * ld3 + col + c]) : 0.f;
  }
}

template <typename T, int HD>
__global__ void __launch_bounds__(kNT)
mha_kernel(const T* __restrict__ qkv, const float* __restrict__ mask,
           T* __restrict__ out, int t_len, int heads, float scale) {
  constexpr int LD = HD + 1;           // odd stride: conflict-free row reads
  constexpr int kAcc = kQT * HD / kNT; // context outputs per thread
  extern __shared__ float smem[];
  float* qs = smem;                // [kQT][LD]
  float* kv = qs + kQT * LD;       // [kKT][LD], K chunks then V chunks
  float* s = kv + kKT * LD;        // [kQT][t_len] scores, then probabilities

  const int b = blockIdx.x / heads;
  const int h = blockIdx.x % heads;
  const int q0 = blockIdx.y * kQT;
  const int d = heads * HD;
  const int ld3 = 3 * d;
  const T* base = qkv + (size_t)b * t_len * ld3;
  const int tid = threadIdx.x;
  const int nq = min(kQT, t_len - q0);

  load_tile<T, HD>(qs, base, q0, nq, kQT, ld3, h * HD);

  // scores = Q K^T * scale (+ mask), fp32
  for (int k0 = 0; k0 < t_len; k0 += kKT) {
    const int nk = min(kKT, t_len - k0);
    __syncthreads();
    load_tile<T, HD>(kv, base, k0, nk, kKT, ld3, d + h * HD);
    __syncthreads();
    for (int p = tid; p < kQT * kKT; p += kNT) {
      const int r = p / kKT, j = p % kKT;
      if (r < nq && j < nk) {
        float acc = 0.f;
#pragma unroll 8
        for (int c = 0; c < HD; ++c) acc = fmaf(qs[r * LD + c], kv[j * LD + c], acc);
        float v = acc * scale;
        if (mask != nullptr) v += mask[(size_t)(q0 + r) * t_len + k0 + j];
        s[r * t_len + k0 + j] = v;
      }
    }
  }
  __syncthreads();

  // row softmax in fp32, probabilities rounded to the input type
  const int warp = tid / 32, lane = tid % 32;
  for (int r = warp; r < nq; r += kNT / 32) {
    float* row = s + r * t_len;
    float m = -INFINITY;
    for (int j = lane; j < t_len; j += 32) m = fmaxf(m, row[j]);
    m = warp_max(m);
    float sum = 0.f;
    for (int j = lane; j < t_len; j += 32) {
      const float e = expf(row[j] - m);
      row[j] = e;
      sum += e;
    }
    sum = warp_sum(sum);
    for (int j = lane; j < t_len; j += 32) row[j] = to_f(from_f<T>(row[j] / sum));
  }

  // context = P V, fp32 accumulation
  float acc[kAcc];
#pragma unroll
  for (int i = 0; i < kAcc; ++i) acc[i] = 0.f;
  for (int k0 = 0; k0 < t_len; k0 += kKT) {
    const int nk = min(kKT, t_len - k0);
    __syncthreads();
    load_tile<T, HD>(kv, base, k0, nk, kKT, ld3, 2 * d + h * HD);
    __syncthreads();
#pragma unroll
    for (int i = 0; i < kAcc; ++i) {
      const int e = tid + i * kNT;
      const int r = e / HD, c = e % HD;
      const float* prow = s + r * t_len + k0;
      float a = acc[i];
      if (r < nq) {
        for (int j = 0; j < nk; ++j) a = fmaf(prow[j], kv[j * LD + c], a);
      }
      acc[i] = a;
    }
  }
#pragma unroll
  for (int i = 0; i < kAcc; ++i) {
    const int e = tid + i * kNT;
    const int r = e / HD, c = e % HD;
    if (r < nq) out[((size_t)b * t_len + q0 + r) * d + h * HD + c] = from_f<T>(acc[i]);
  }
}

template <typename T, int HD>
cudaError_t launch(const void* qkv, const void* mask, void* out, int batch,
                   int t_len, int heads, float scale, cudaStream_t stream) {
  constexpr int LD = HD + 1;
  const size_t smem = sizeof(float) * ((size_t)(kQT + kKT) * LD + (size_t)kQT * t_len);
  static bool attr_set = false;
  if (!attr_set) {
    const size_t most = sizeof(float) * ((size_t)(kQT + kKT) * LD + (size_t)kQT * kMaxT);
    cudaError_t err = cudaFuncSetAttribute(
        mha_kernel<T, HD>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)most);
    if (err != cudaSuccess) return err;
    attr_set = true;
  }
  dim3 grid(batch * heads, (t_len + kQT - 1) / kQT);
  mha_kernel<T, HD><<<grid, kNT, smem, stream>>>(
      static_cast<const T*>(qkv), static_cast<const float*>(mask),
      static_cast<T*>(out), t_len, heads, scale);
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch_hd(const void* qkv, const void* mask, void* out, int batch,
                        int t_len, int heads, int head_dim, float scale,
                        cudaStream_t stream) {
  switch (head_dim) {
    case 64: return launch<T, 64>(qkv, mask, out, batch, t_len, heads, scale, stream);
    case 80: return launch<T, 80>(qkv, mask, out, batch, t_len, heads, scale, stream);
    case 88: return launch<T, 88>(qkv, mask, out, batch, t_len, heads, scale, stream);
    case 104: return launch<T, 104>(qkv, mask, out, batch, t_len, heads, scale, stream);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16. Returns a cudaError_t (0 = success).
extern "C" int tpualign_fused_mha(const void* qkv, const void* mask, void* out,
                                  int batch, int t_len, int heads, int head_dim,
                                  float scale, int dtype, int device,
                                  void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  if (batch <= 0 || t_len <= 0 || t_len > kMaxT || heads <= 0) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    err = dispatch_hd<float>(qkv, mask, out, batch, t_len, heads, head_dim, scale, s);
  else if (dtype == 1)
    err = dispatch_hd<__nv_bfloat16>(qkv, mask, out, batch, t_len, heads, head_dim, scale, s);
  else
    err = cudaErrorInvalidValue;
  return (int)err;
}
