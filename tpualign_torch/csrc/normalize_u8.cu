// CLIP normalisation of a uint8 image batch, for sm_90a.
//
// Replaces the Pallas TPU kernel tpualign/ops/pallas_kernels.py
// (normalize_u8 -> _normalize_kernel): (B, H, W, 3) uint8 -> fp32,
// out[i] = (x[i] * fl(1/255) - mean[c]) * inv_std[c] with c = i mod 3 and
// inv_std = fl32(1 / fl32(CLIP_STD)), as the JAX wrapper builds its tiles.
// The arithmetic is written with __fmul_rn/__fsub_rn so that nvcc cannot
// contract it into an FMA: the result is bit-identical to the plain
// PyTorch version (three separately rounded fp32 operations).
//
// Bound on the H100: bytes. Each element is read once (1 B) and written
// once (4 B), and does three fp32 operations: at B=256, 224x224x3 that is
// 192.7 MB (about 0.058 ms at 3.35 TB/s) against 0.12 GFLOP. The design
// streams: a block of 256 threads takes 4,096 consecutive elements, each
// thread 16 of them with one 16-byte load. The thread's 64 output bytes go
// through shared memory, so that each of the block's four float4 store
// instructions writes 4 KB contiguous (a warp 512 B) rather than 16 B
// every 64. The channel of a thread's first element is (16 t) mod 3; the
// three statistics are rotated once by selects, so that the unrolled loop
// indexes them with constants. A base pointer that is not 16-byte aligned
// (a view with an offset) takes byte loads and scalar stores, and the
// last block, which may be partial, is done thread by thread with the
// tail element by element.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -O3 -shared
//        -Xcompiler -fPIC (tpualign_torch/ops/build.py).

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kPerThread = 16;
constexpr long long kPerBlock = (long long)kThreads * kPerThread;

struct Stats {
  float mean[3];
  float inv_std[3];
};

__device__ __forceinline__ float norm1(uint32_t v, float mean, float inv_std) {
  const float inv255 = 1.0f / 255.0f;  // fl32(1/255), a compile-time constant
  return __fmul_rn(__fsub_rn(__fmul_rn((float)v, inv255), mean), inv_std);
}

// v[(c + r) mod 3] without indexing a parameter array at run time
__device__ __forceinline__ float rotate(const float (&v)[3], int c, int r) {
  const int k = (c + r) % 3;
  return k == 0 ? v[0] : (k == 1 ? v[1] : v[2]);
}

__global__ void __launch_bounds__(kThreads)
normalize_u8_kernel(const uint8_t* __restrict__ x, float* __restrict__ out, long long n,
                    Stats st) {
  __shared__ float4 stage[kThreads * 4];
  const long long base = (long long)blockIdx.x * kPerBlock;
  const long long i0 = base + (long long)threadIdx.x * kPerThread;
  // statistics rotated so that element j of this thread has channel j mod 3
  const int c0 = (int)(i0 % 3);
  float m[3], s[3];
#pragma unroll
  for (int r = 0; r < 3; ++r) {
    m[r] = rotate(st.mean, c0, r);
    s[r] = rotate(st.inv_std, c0, r);
  }
  const bool aligned = ((reinterpret_cast<uintptr_t>(x) | reinterpret_cast<uintptr_t>(out))
                        & 15) == 0;
  if (aligned && base + kPerBlock <= n) {  // a full block: uniform across it
    const uint4 v = *reinterpret_cast<const uint4*>(x + i0);
    const uint32_t w[4] = {v.x, v.y, v.z, v.w};
    float r[kPerThread];
#pragma unroll
    for (int j = 0; j < kPerThread; ++j)
      r[j] = norm1((w[j >> 2] >> (8 * (j & 3))) & 0xffu, m[j % 3], s[j % 3]);
#pragma unroll
    for (int q = 0; q < 4; ++q)
      stage[threadIdx.x * 4 + q] = make_float4(r[4 * q], r[4 * q + 1], r[4 * q + 2], r[4 * q + 3]);
    __syncthreads();
    float4* o = reinterpret_cast<float4*>(out + base);
#pragma unroll
    for (int q = 0; q < 4; ++q) o[q * kThreads + threadIdx.x] = stage[q * kThreads + threadIdx.x];
    return;
  }
  if (i0 >= n) return;
  const long long end = i0 + kPerThread < n ? i0 + kPerThread : n;
  for (long long i = i0; i < end; ++i) {
    const int j = (int)(i - i0) % 3;
    out[i] = norm1(x[i], m[j], s[j]);
  }
}

}  // namespace

// x: n uint8 values, out: n fp32 values (n = B*H*W*3, the channel last).
// Returns a cudaError_t.
extern "C" int tpualign_normalize_u8(const void* x, void* out, long long n, float mean0,
                                     float mean1, float mean2, float inv_std0,
                                     float inv_std1, float inv_std2, int device,
                                     void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  if (n < 0) return (int)cudaErrorInvalidValue;
  if (n == 0) return (int)cudaSuccess;
  const Stats st{{mean0, mean1, mean2}, {inv_std0, inv_std1, inv_std2}};
  const long long blocks = (n + kPerBlock - 1) / kPerBlock;
  if (blocks > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  normalize_u8_kernel<<<(unsigned)blocks, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint8_t*>(x), static_cast<float*>(out), n, st);
  return (int)cudaGetLastError();
}
