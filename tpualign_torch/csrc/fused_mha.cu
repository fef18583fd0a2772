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
// 2 GFLOP of work (about 2 us on the bf16 tensor cores at 989 TFLOP/s).
//
// bf16 (the towers on the card): mha_bf16_kernel, on the tensor cores.
// - One block per (batch row, head); each warp owns 16 query rows, T is
//   padded to a multiple of 16 (50 -> 64, 77 -> 80). cp.async copies the
//   head's Q, K and V rows, 16 bytes at a time, straight from the packed
//   (B, T, 3D) rows into shared memory as bf16 (Q and K in one group, V in a
//   second that lands while the scores are taken), zero past the last row
//   and past the head's depth. Row strides (6D bytes) and head offsets
//   (2h*hd bytes) are multiples of 16 for every supported hd; the wrapper
//   checks the base. A row pitch of hd' + 8 bf16 keeps ldmatrix
//   conflict-free.
// - Q K^T: mma.sync.m16n8k16 (bf16 in, fp32 accumulate) over the depth
//   zero-padded to a multiple of 16 (88 -> 96, 104 -> 112); A from Q and B
//   from K by ldmatrix.
// - Softmax in fp32 registers: scale, then the caller's additive (T, T)
//   mask, padded keys set to -inf before the max. It is exact over the
//   whole row as fused_mha_reference takes it (max and sum over all T
//   keys, then e / sum rounded to bf16): no online rescaling. For T <= 128
//   the row of scores stays in registers (one pass), in 4, 8, 10 or 16
//   n8 tiles (T <= 32, 64, 80, 128), so that T=77 does not hold the
//   registers of 128 keys (it ran slower so on the H100: fewer blocks fit
//   a SM). For T up to 257 it
//   does not fit, and the block recomputes Q K^T in chunks of 64 keys in
//   three passes (max, sum, then P.V): T > 128 is ViT-L/H-14, off the main
//   path, and 3x a product that is 2 us at B=256 costs less than the
//   shared memory a (T x T) fp32 score array would take from the K/V tiles.
// - P.V: the rounded P fragments are the A operand straight from registers
//   (the m16n8 accumulator layout is the m16n8k16 A layout); V goes in
//   through ldmatrix.trans. The fp32 context is rounded to bf16, staged in
//   the warp's own Q rows and stored 16 bytes at a time.
// - Why not wgmma/TMA: the work is bound by bytes (24 us) and its 2 GFLOP
//   take about 2 us even at mma.sync's rate; a 64-row warpgroup tile would
//   also waste most of its rows at T=16/50/77.
//
// fp32 (the parity mode): mha_kernel, on the CUDA cores, so that no TF32
// rounding enters. One block per (batch row, head, tile of 32 query rows)
// holds its query tile, one 32-row chunk of K or V at a time, and the
// tile's fp32 scores (32 x T) in shared memory; products are scalar fmaf
// chains.
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

template <typename T>
__device__ __forceinline__ T from_f(float x);
template <>
__device__ __forceinline__ float from_f<float>(float x) { return x; }

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

// -- bf16 on the tensor cores -------------------------------------------------

using bf16 = __nv_bfloat16;

constexpr int kMaxWarps = (kMaxT + 15) / 16;  // 17: T=257 padded to 272
constexpr int kLongChunk = 8;                 // n8 key tiles a pass holds when T > 128

template <int HD>
struct Bf16Geometry {
  static constexpr int kHDP = (HD + 15) / 16 * 16;  // depth padded to the MMA's k of 16
  static constexpr int kPitch = kHDP + 8;           // shared row, bf16: conflict-free ldmatrix
  static constexpr int kSegs = HD / 8;              // 16-byte pieces of a head's row
  static constexpr int kSegsP = kHDP / 8;
};

__device__ __forceinline__ void cp_async16(void* dst, const void* src, bool ok) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s), "l"(src),
               "r"(ok ? 16 : 0));
}

__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], const bf16* p) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(p));
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(s));
}

__device__ __forceinline__ void ldsm_x4_trans(uint32_t (&r)[4], const bf16* p) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(p));
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(s));
}

// c += a (16 x 16, row) * b (16 x 8, col), bf16 in, fp32 accumulate
__device__ __forceinline__ void mma_bf16(float (&c)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);  // round to nearest even
  return *reinterpret_cast<uint32_t*>(&v);
}

// The warp's 16 query rows (from r0) against keys [kc0, kc0 + 8 nt):
// sc[j] is the m16n8 accumulator of key tile j, scaled in fp32, plus the
// mask; keys past T are -inf. Element e of a tile sits at row
// r0 + lane/4 + 8 (e/2), key kc0 + 8j + 2 (lane%4) + e%2.
template <int HD, int NT>
__device__ __forceinline__ void qk_scores(float (&sc)[NT][4], const bf16* qs, const bf16* ks,
                                          int r0, int kc0, int nt, int t_len,
                                          const float* __restrict__ mask, float scale,
                                          int lane) {
  using G = Bf16Geometry<HD>;
#pragma unroll
  for (int j = 0; j < NT; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) sc[j][e] = 0.f;
#pragma unroll
  for (int kk = 0; kk < G::kHDP / 16; ++kk) {
    uint32_t a[4];
    ldsm_x4(a, qs + (r0 + (lane & 15)) * G::kPitch + kk * 16 + (lane >> 4) * 8);
#pragma unroll
    for (int jp = 0; jp < NT / 2; ++jp) {
      if (2 * jp < nt) {
        uint32_t b[4];
        ldsm_x4(b, ks + (kc0 + 16 * jp + (lane & 7) + ((lane >> 4) << 3)) * G::kPitch +
                       kk * 16 + ((lane >> 3) & 1) * 8);
        mma_bf16(sc[2 * jp], a, b[0], b[1]);
        mma_bf16(sc[2 * jp + 1], a, b[2], b[3]);
      }
    }
  }
  const int row0 = r0 + (lane >> 2);
#pragma unroll
  for (int j = 0; j < NT; ++j) {
    if (j < nt) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int row = row0 + (e >> 1) * 8;
        const int col = kc0 + 8 * j + 2 * (lane & 3) + (e & 1);
        float v = sc[j][e] * scale;
        if (col >= t_len)
          v = -INFINITY;
        else if (mask != nullptr && row < t_len)
          v += __ldg(mask + (size_t)row * t_len + col);
        sc[j][e] = v;
      }
    }
  }
}

template <int NT>
__device__ __forceinline__ void row_max(const float (&sc)[NT][4], int nt, float (&m)[2]) {
#pragma unroll
  for (int j = 0; j < NT; ++j) {
    if (j < nt) {
      m[0] = fmaxf(m[0], fmaxf(sc[j][0], sc[j][1]));
      m[1] = fmaxf(m[1], fmaxf(sc[j][2], sc[j][3]));
    }
  }
}

// sc = exp(sc - m) in place; l += the row sums of this thread's entries
template <int NT>
__device__ __forceinline__ void exp_sum(float (&sc)[NT][4], int nt, const float (&m)[2],
                                        float (&l)[2]) {
#pragma unroll
  for (int j = 0; j < NT; ++j) {
    if (j < nt) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        sc[j][e] = expf(sc[j][e] - m[e >> 1]);
        l[e >> 1] += sc[j][e];
      }
    }
  }
}

// the row's max or sum over the four lanes that hold it
__device__ __forceinline__ float quad_max(float v) {
  v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 1));
  return fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 2));
}

__device__ __forceinline__ float quad_sum(float v) {
  v += __shfl_xor_sync(0xffffffffu, v, 1);
  return v + __shfl_xor_sync(0xffffffffu, v, 2);
}

// o += bf16(e / l) . V[kc0 : kc0 + 8 nt): P as the A operand from registers
template <int HD, int NT>
__device__ __forceinline__ void pv(const float (&sc)[NT][4], int nt, const float (&l)[2],
                                   float (&o)[Bf16Geometry<HD>::kHDP / 8][4], const bf16* vs,
                                   int kc0, int lane) {
  using G = Bf16Geometry<HD>;
#pragma unroll
  for (int s = 0; s < NT / 2; ++s) {
    if (2 * s < nt) {
      uint32_t a[4];
      a[0] = pack_bf16(sc[2 * s][0] / l[0], sc[2 * s][1] / l[0]);
      a[1] = pack_bf16(sc[2 * s][2] / l[1], sc[2 * s][3] / l[1]);
      a[2] = pack_bf16(sc[2 * s + 1][0] / l[0], sc[2 * s + 1][1] / l[0]);
      a[3] = pack_bf16(sc[2 * s + 1][2] / l[1], sc[2 * s + 1][3] / l[1]);
#pragma unroll
      for (int dp = 0; dp < G::kHDP / 16; ++dp) {
        uint32_t b[4];
        ldsm_x4_trans(b, vs + (kc0 + 16 * s + (lane & 7) + ((lane >> 3) & 1) * 8) * G::kPitch +
                             dp * 16 + (lane >> 4) * 8);
        mma_bf16(o[2 * dp], a, b[0], b[1]);
        mma_bf16(o[2 * dp + 1], a, b[2], b[3]);
      }
    }
  }
}

// NT: n8 key tiles held in registers; kLong: T > 128, three passes over
// chunks of NT tiles, else one pass over the whole row (T <= 8 NT).
template <int HD, int NT, bool kLong>
__global__ void __launch_bounds__(kLong ? kMaxWarps * 32 : NT * 16)
mha_bf16_kernel(const bf16* __restrict__ qkv, const float* __restrict__ mask,
                bf16* __restrict__ out, int t_len, int heads, float scale) {
  using G = Bf16Geometry<HD>;
  constexpr int P = G::kPitch;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int tp = (t_len + 15) & ~15;
  bf16* qs = reinterpret_cast<bf16*>(smem_raw);  // [tp][P] Q, then the output
  bf16* ks = qs + tp * P;                        // [tp][P]
  bf16* vs = ks + tp * P;                        // [tp][P]

  const int b = blockIdx.x / heads;
  const int h = blockIdx.x % heads;
  const int d = heads * HD;
  const int ld3 = 3 * d;
  const bf16* base = qkv + (size_t)b * t_len * ld3 + h * HD;
  const int tid = threadIdx.x, nthreads = blockDim.x;
  const int warp = tid >> 5, lane = tid & 31;

  // Q and K (one group), then V (a second): 16 bytes a copy, zero past
  // the last row and past the head's depth
  const int per = tp * G::kSegsP;
  for (int part = 0; part < 2; ++part) {
    for (int e = part * 2 * per + tid; e < (part + 2) * per; e += nthreads) {
      const int m = e / per, row = (e % per) / G::kSegsP, seg = e % G::kSegsP;
      const bool ok = row < t_len && seg < G::kSegs;
      cp_async16(qs + (m * tp + row) * P + seg * 8,
                 base + (ok ? (size_t)row * ld3 + m * d + seg * 8 : 0), ok);
    }
    asm volatile("cp.async.commit_group;\n" ::);
  }
  asm volatile("cp.async.wait_group 1;\n" ::: "memory");
  __syncthreads();

  const int r0 = warp * 16;
  float o[G::kHDP / 8][4];
#pragma unroll
  for (int j = 0; j < G::kHDP / 8; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) o[j][e] = 0.f;
  float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f};
  float sc[NT][4];
  if (!kLong) {
    const int nt = tp / 8;
    qk_scores<HD, NT>(sc, qs, ks, r0, 0, nt, t_len, mask, scale, lane);
    row_max<NT>(sc, nt, m);
    m[0] = quad_max(m[0]);
    m[1] = quad_max(m[1]);
    exp_sum<NT>(sc, nt, m, l);
    l[0] = quad_sum(l[0]);
    l[1] = quad_sum(l[1]);
    asm volatile("cp.async.wait_group 0;\n" ::: "memory");
    __syncthreads();  // V landed
    pv<HD, NT>(sc, nt, l, o, vs, 0, lane);
  } else {
    constexpr int kChunk = NT * 8;
    for (int kc0 = 0; kc0 < tp; kc0 += kChunk) {
      const int nt = min(kChunk, tp - kc0) / 8;
      qk_scores<HD, NT>(sc, qs, ks, r0, kc0, nt, t_len, mask, scale, lane);
      row_max<NT>(sc, nt, m);
    }
    m[0] = quad_max(m[0]);
    m[1] = quad_max(m[1]);
    for (int kc0 = 0; kc0 < tp; kc0 += kChunk) {
      const int nt = min(kChunk, tp - kc0) / 8;
      qk_scores<HD, NT>(sc, qs, ks, r0, kc0, nt, t_len, mask, scale, lane);
      exp_sum<NT>(sc, nt, m, l);
    }
    l[0] = quad_sum(l[0]);
    l[1] = quad_sum(l[1]);
    asm volatile("cp.async.wait_group 0;\n" ::: "memory");
    __syncthreads();  // V landed
    for (int kc0 = 0; kc0 < tp; kc0 += kChunk) {
      const int nt = min(kChunk, tp - kc0) / 8;
      float unused[2] = {0.f, 0.f};
      qk_scores<HD, NT>(sc, qs, ks, r0, kc0, nt, t_len, mask, scale, lane);
      exp_sum<NT>(sc, nt, m, unused);
      pv<HD, NT>(sc, nt, l, o, vs, kc0, lane);
    }
  }

  // the context, rounded to bf16, staged in the warp's own Q rows, then
  // stored 16 bytes at a time
  __syncwarp();
  const int row0 = r0 + (lane >> 2);
#pragma unroll
  for (int j = 0; j < G::kHDP / 8; ++j) {
    const int col = 8 * j + 2 * (lane & 3);
    *reinterpret_cast<uint32_t*>(qs + row0 * P + col) = pack_bf16(o[j][0], o[j][1]);
    *reinterpret_cast<uint32_t*>(qs + (row0 + 8) * P + col) = pack_bf16(o[j][2], o[j][3]);
  }
  __syncwarp();
  for (int e = lane; e < 16 * G::kSegs; e += 32) {
    const int row = r0 + e / G::kSegs, seg = e % G::kSegs;
    if (row < t_len)
      *reinterpret_cast<uint4*>(out + ((size_t)b * t_len + row) * d + h * HD + seg * 8) =
          *reinterpret_cast<const uint4*>(qs + row * P + seg * 8);
  }
}

template <int HD, int NT, bool kLong>
cudaError_t launch_bf16(const void* qkv, const void* mask, void* out, int batch, int t_len,
                        int heads, float scale, cudaStream_t stream) {
  using G = Bf16Geometry<HD>;
  const int tp = (t_len + 15) & ~15;
  const size_t smem = 3 * sizeof(bf16) * (size_t)tp * G::kPitch;
  static bool attr_set = false;
  if (!attr_set) {
    const size_t most = 3 * sizeof(bf16) * (size_t)(kLong ? kMaxWarps * 16 : NT * 8) * G::kPitch;
    cudaError_t err = cudaFuncSetAttribute(mha_bf16_kernel<HD, NT, kLong>,
                                           cudaFuncAttributeMaxDynamicSharedMemorySize, (int)most);
    if (err != cudaSuccess) return err;
    attr_set = true;
  }
  mha_bf16_kernel<HD, NT, kLong><<<batch * heads, (tp / 16) * 32, smem, stream>>>(
      static_cast<const bf16*>(qkv), static_cast<const float*>(mask), static_cast<bf16*>(out),
      t_len, heads, scale);
  return cudaGetLastError();
}

template <int HD>
cudaError_t launch_bf16_t(const void* qkv, const void* mask, void* out, int batch, int t_len,
                          int heads, float scale, cudaStream_t stream) {
  const int tp = (t_len + 15) & ~15;
  if (tp <= 32) return launch_bf16<HD, 4, false>(qkv, mask, out, batch, t_len, heads, scale, stream);
  if (tp <= 64) return launch_bf16<HD, 8, false>(qkv, mask, out, batch, t_len, heads, scale, stream);
  if (tp <= 80) return launch_bf16<HD, 10, false>(qkv, mask, out, batch, t_len, heads, scale, stream);
  if (tp <= 128)
    return launch_bf16<HD, 16, false>(qkv, mask, out, batch, t_len, heads, scale, stream);
  return launch_bf16<HD, kLongChunk, true>(qkv, mask, out, batch, t_len, heads, scale, stream);
}

cudaError_t dispatch_bf16(const void* qkv, const void* mask, void* out, int batch, int t_len,
                          int heads, int head_dim, float scale, cudaStream_t stream) {
  switch (head_dim) {
    case 64: return launch_bf16_t<64>(qkv, mask, out, batch, t_len, heads, scale, stream);
    case 80: return launch_bf16_t<80>(qkv, mask, out, batch, t_len, heads, scale, stream);
    case 88: return launch_bf16_t<88>(qkv, mask, out, batch, t_len, heads, scale, stream);
    case 104: return launch_bf16_t<104>(qkv, mask, out, batch, t_len, heads, scale, stream);
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
    err = dispatch_bf16(qkv, mask, out, batch, t_len, heads, head_dim, scale, s);
  else
    err = cudaErrorInvalidValue;
  return (int)err;
}
