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
// fp32 (COMPUTE_DTYPE=float32 without PARITY_MODE, which takes the plain
// path): mha_f32_kernel, on the CUDA cores, so that no TF32 rounding enters
// (the bound against fused_mha_reference is 2e-5).
// - Bound on the H100 at ViT-B-32, B=256: bytes, 0.047 ms for vision (118
//   MB of QKV read, 39 MB written) and 0.048 ms for text T=77; the FMAs of
//   all T^2 scores and of P.V take 0.029 and 0.046 ms at 67 TFLOP/s. The
//   first kernel (one block per 32 query rows) fed every fmaf from two
//   shared loads, so it ran at the shared-memory rate (0.395 / 0.603 ms),
//   and each query tile read K and V again.
// - One block per (batch row, head) for T <= 128: cp.async copies the
//   head's Q, K and V rows once into shared memory, 16 bytes at a time
//   (4 when the packed base is not 16-byte aligned; row strides and head
//   offsets are multiples of 16 bytes, so the base decides), Q and K in one
//   group, V in a second that lands while the scores are taken. Rows are
//   padded to a multiple of 8 with zeros; the row pitch HD + 4 floats is an
//   odd number of 16-byte units, so float4 reads of 8 consecutive rows hit
//   8 distinct bank groups. The loads hide behind the other blocks' work: a
//   build without the arithmetic ran at 87 % of the byte bound.
// - Q K^T from register tiles of 4 query rows (tr + i ceil(T/4), strided
//   so that a warp reads consecutive rows) by 8 or up to 8 keys, the depth
//   4 at a time in the order of a plain fmaf chain: float4 shared loads,
//   each feeding 16 FMAs. A warp-wide 16-byte load delivers 512 bytes at
//   128 bytes a clock, so larger tiles trade fewer loads for fewer threads:
//   8 x 8 tiles gained 12 % at vision and lost at T=16 and 32 on the H100.
// - Softmax, exact over the whole row as fused_mha_reference takes it (the
//   max over all T keys, the sum of exp(s - max), then e * (1 / sum); no
//   online rescaling), s = (q . k) * scale + mask rounded as two steps. A
//   warp a row in series cost more than Q K^T itself (0.065 of 0.168 ms at
//   vision), so:
//   - T <= 64 (kRegisters): each thread holds 4 rows x (T / 8) keys
//     tc + 8 u, the 8 threads of a row are one aligned lane group, and the
//     max and the sum take 3 shuffles each; P, normalised, goes over Q and
//     K in shared memory;
//   - T <= 128 (kPass): 4 x 8 tiles of q . k go to a (T x T) array P
//     (pitch T + 4), and a pass over P takes 8 lanes a row, 4 rows a warp
//     at once, reading the mask coalesced. At T=77 it beat the register
//     softmax (0.195 against 0.214 ms): 4 x 10 tiles leave 160 threads to
//     do the products.
// - P.V: each thread owns an 8 x 4 register tile of the context (rows
//   tr + i T/8, four adjacent columns): 12 float4 shared loads feed 128
//   FMAs, in key order; the output is stored 16 bytes at a time.
// - Shared memory and blocks per SM (228 KB an SM): T=16 13,056 bytes (16
//   blocks of 32 threads), T=32 26,112 (8 of 64), T=50 45,696 (4 of 128),
//   T=77 92,160 with P apart (2 of 256).
// - T from 129 to 257 (ViT-L/H-14, off the main path), and T <= 128 where
//   the resident layout would pass 227 KB (hd=104 at T=128; kChunked):
//   blocks of 64 query rows, K and then V streamed through one 64-row
//   buffer, the scores of the whole row kept in P; right, not tuned.
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

#include "device_flags.cuh"

namespace {

constexpr int kMaxT = 257;

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
  static devflags::PerDevice<bool> attr_set(false);
  const size_t most = 3 * sizeof(bf16) * (size_t)(kLong ? kMaxWarps * 16 : NT * 8) * G::kPitch;
  cudaError_t err = devflags::smem_limit_once(attr_set, mha_bf16_kernel<HD, NT, kLong>, most);
  if (err != cudaSuccess) return err;
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


// -- fp32 on the CUDA cores ---------------------------------------------------

constexpr int kF32Chunk = 64;         // query rows per block and keys per chunk, T > 128
constexpr int kSmemMax = 232448;      // shared memory a block may use on sm_90
constexpr int kLanes = 8;             // lanes that share a row of the softmax pass

template <int HD>
struct F32Geometry {
  static constexpr int kPitch = HD + 4;  // floats; kPitch / 4 is odd for every HD
  static constexpr int kSegs = HD / 4;   // 16-byte pieces of a head's row
};

__device__ __forceinline__ void cp_async4(void* dst, const void* src, bool ok) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(s), "l"(src),
               "r"(ok ? 4 : 0));
}

// Rows [r0, r0 + n) of one head's Q, K or V (`base` points at the head's
// columns of the batch row's first packed row) into an [n][kPitch] tile,
// zero past t_len: 16-byte copies when every row is 16-byte aligned, else
// 4-byte copies.
template <int HD, int NT>
__device__ __forceinline__ void load_rows_f32(float* dst, const float* __restrict__ base, int r0,
                                              int n, int t_len, int ld3, bool vec) {
  using G = F32Geometry<HD>;
  if (vec) {
    for (int e = threadIdx.x; e < n * G::kSegs; e += NT) {
      const int r = e / G::kSegs, s = e % G::kSegs;
      const bool ok = r0 + r < t_len;
      cp_async16(dst + r * G::kPitch + 4 * s,
                 base + (ok ? (size_t)(r0 + r) * ld3 + 4 * s : 0), ok);
    }
  } else {
    for (int e = threadIdx.x; e < n * HD; e += NT) {
      const int r = e / HD, c = e % HD;
      const bool ok = r0 + r < t_len;
      cp_async4(dst + r * G::kPitch + c, base + (ok ? (size_t)(r0 + r) * ld3 + c : 0), ok);
    }
  }
}

// Products of the resident query rows [0, 4 rs) with the resident keys
// [0, 8 ks) (sequence keys k0 + those): thread (tr, tc) owns rows tr + i rs
// and keys tc + u ks, and writes q . k to ps[row][k0 + key]; the scale and
// the mask are applied by softmax_rows_f32.
template <int HD, int NT>
__device__ __forceinline__ void qk_f32(const float* qs, const float* ks, float* ps, int pp, int rs,
                                       int kstride, int k0) {
  constexpr int P = F32Geometry<HD>::kPitch;
  for (int idx = threadIdx.x; idx < rs * kstride; idx += NT) {
    const int tr = idx / kstride, tc = idx % kstride;
    const float* qrow = qs + tr * P;
    const float* krow = ks + tc * P;
    float acc[4][8];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int u = 0; u < 8; ++u) acc[i][u] = 0.f;
#pragma unroll 2
    for (int c = 0; c < HD; c += 4) {
      float4 q[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) q[i] = *reinterpret_cast<const float4*>(qrow + i * rs * P + c);
#pragma unroll
      for (int u = 0; u < 8; ++u) {
        const float4 k = *reinterpret_cast<const float4*>(krow + u * kstride * P + c);
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          acc[i][u] = fmaf(q[i].x, k.x, acc[i][u]);
          acc[i][u] = fmaf(q[i].y, k.y, acc[i][u]);
          acc[i][u] = fmaf(q[i].z, k.z, acc[i][u]);
          acc[i][u] = fmaf(q[i].w, k.w, acc[i][u]);
        }
      }
    }
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int u = 0; u < 8; ++u) ps[(tr + i * rs) * pp + k0 + tc + u * kstride] = acc[i][u];
  }
}

// Rows [0, n) of ps (query rows q0 + r) hold q . k; they become the
// softmax of s = (q . k) * scale + mask over keys [0, t_len), exact over
// the whole row (the max, then the sum of exp(s - max), then e * (1 / sum),
// as torch.softmax takes it on the CPU), and 0 over [t_len, kp). kLanes
// lanes a row, 32 / kLanes rows a warp at once.
template <int NT>
__device__ __forceinline__ void softmax_rows_f32(float* ps, int pp, int n, int q0, int t_len,
                                                 int kp, const float* __restrict__ mask,
                                                 float scale) {
  const int lane = threadIdx.x & 31, s = lane % kLanes;
  // a warp's rows r - lane / kLanes + [0, 32 / kLanes) stay together for the shuffles
  for (int r = threadIdx.x / kLanes; r - lane / kLanes < n; r += NT / kLanes) {
    const bool live = r < n;
    float* row = ps + (live ? r : 0) * pp;
    const float* mrow = mask == nullptr ? nullptr : mask + (size_t)(q0 + r) * t_len;
    float m = -INFINITY;
    if (live) {
      for (int j = s; j < t_len; j += kLanes) {
        float v = __fmul_rn(row[j], scale);
        if (mrow != nullptr) v = __fadd_rn(v, __ldg(mrow + j));
        row[j] = v;
        m = fmaxf(m, v);
      }
    }
#pragma unroll
    for (int o = kLanes / 2; o > 0; o >>= 1) m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, o));
    float sum = 0.f;
    if (live) {
      for (int j = s; j < t_len; j += kLanes) {
        const float e = expf(row[j] - m);
        row[j] = e;
        sum += e;
      }
    }
#pragma unroll
    for (int o = kLanes / 2; o > 0; o >>= 1) sum += __shfl_xor_sync(0xffffffffu, sum, o);
    const float inv = 1.f / sum;
    if (live)
      for (int j = s; j < kp; j += kLanes) row[j] = j < t_len ? row[j] * inv : 0.f;
  }
}

// One score tile in registers for the resident path: query rows tr + i rs
// (i < 4) against keys tc + 8 u (u < kpt <= KMAX); the 8 threads of a row
// group are lanes 8 tr' .. 8 tr' + 7 of one warp. On return acc holds the
// probabilities: s = (q . k) * scale + mask, the row's max and sum of
// exp(s - max) over all t_len keys by shuffles within the lane group, then
// e * (1 / sum); 0 for keys past t_len.
template <int HD, int KMAX>
__device__ __forceinline__ void qk_softmax_regs_f32(float (&acc)[4][KMAX], const float* qs,
                                                    const float* ks, int tr, int tc, int rs,
                                                    int kpt, bool mine, int t_len,
                                                    const float* __restrict__ mask, float scale) {
  constexpr int P = F32Geometry<HD>::kPitch;
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int u = 0; u < KMAX; ++u) acc[i][u] = 0.f;
  if (mine) {
    const float* qrow = qs + tr * P;
    const float* krow = ks + tc * P;
#pragma unroll 2
    for (int c = 0; c < HD; c += 4) {
      float4 q[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) q[i] = *reinterpret_cast<const float4*>(qrow + i * rs * P + c);
#pragma unroll
      for (int u = 0; u < KMAX; ++u) {
        if (u < kpt) {
          const float4 k = *reinterpret_cast<const float4*>(krow + 8 * u * P + c);
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            acc[i][u] = fmaf(q[i].x, k.x, acc[i][u]);
            acc[i][u] = fmaf(q[i].y, k.y, acc[i][u]);
            acc[i][u] = fmaf(q[i].z, k.z, acc[i][u]);
            acc[i][u] = fmaf(q[i].w, k.w, acc[i][u]);
          }
        }
      }
    }
  }
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = tr + i * rs;
    const float* mrow = (mask != nullptr && mine && row < t_len) ? mask + (size_t)row * t_len
                                                                 : nullptr;
    float m = -INFINITY;
#pragma unroll
    for (int u = 0; u < KMAX; ++u) {
      const int key = tc + 8 * u;
      float v = -INFINITY;
      if (u < kpt && key < t_len) {
        v = __fmul_rn(acc[i][u], scale);
        if (mrow != nullptr) v = __fadd_rn(v, __ldg(mrow + key));
      }
      acc[i][u] = v;
      m = fmaxf(m, v);
    }
#pragma unroll
    for (int o = 4; o > 0; o >>= 1) m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, o));
    float sum = 0.f;
#pragma unroll
    for (int u = 0; u < KMAX; ++u) {
      const float e = (u < kpt && tc + 8 * u < t_len) ? expf(acc[i][u] - m) : 0.f;
      acc[i][u] = e;
      sum += e;
    }
#pragma unroll
    for (int o = 4; o > 0; o >>= 1) sum += __shfl_xor_sync(0xffffffffu, sum, o);
    const float inv = 1.f / sum;
#pragma unroll
    for (int u = 0; u < KMAX; ++u) acc[i][u] *= inv;
  }
}

__device__ __forceinline__ void fma4(float (&a)[4], float p, const float4& v) {
  a[0] = fmaf(p, v.x, a[0]);
  a[1] = fmaf(p, v.y, a[1]);
  a[2] = fmaf(p, v.z, a[2]);
  a[3] = fmaf(p, v.w, a[3]);
}

// acc[i] += P[tr + i rs8][j] * V[j][4 cg : 4 cg + 4) over keys j in [j0, j1)
// (multiples of 4); the resident V tile starts at key vbase.
template <int HD>
__device__ __forceinline__ void pv_f32(float (&acc)[8][4], const float* ps, int pp,
                                       const float* vs, int tr, int cg, int rs8, int j0, int j1,
                                       int vbase) {
  constexpr int P = F32Geometry<HD>::kPitch;
  const float* prow = ps + tr * pp;
  const float* vcol = vs + 4 * cg;
#pragma unroll 2
  for (int j = j0; j < j1; j += 4) {
    float4 v[4];
#pragma unroll
    for (int u = 0; u < 4; ++u)
      v[u] = *reinterpret_cast<const float4*>(vcol + (j - vbase + u) * P);
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      const float4 p = *reinterpret_cast<const float4*>(prow + i * rs8 * pp + j);
      fma4(acc[i], p.x, v[0]);
      fma4(acc[i], p.y, v[1]);
      fma4(acc[i], p.z, v[2]);
      fma4(acc[i], p.w, v[3]);
    }
  }
}

__device__ __forceinline__ void store_f32(float* __restrict__ out, const float (&acc)[8][4],
                                          size_t row0, int q0, int t_len, int d, int col,
                                          int tr, int rs8) {
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int row = q0 + tr + i * rs8;
    if (row < t_len)
      *reinterpret_cast<float4*>(out + (row0 + row) * d + col) =
          make_float4(acc[i][0], acc[i][1], acc[i][2], acc[i][3]);
  }
}

// The three layouts of mha_f32_kernel.
enum class F32Path {
  kRegisters,  // T <= 64: Q, K, V resident; the scores and softmax in registers
  kPass,       // T <= 128: Q, K, V and P resident; the softmax a pass over P
  kChunked,    // T <= 257: 64 query rows a block, K and V streamed, P resident
};

// One block per (batch row, head), or per (batch row, head, 64 query rows)
// on the chunked path. kRegisters: 8 (T + 3) / 4 <= NT threads hold 4 x
// (KMAX >= T / 8) score tiles and the row softmax in registers, and P goes
// over Q and K. kPass and kChunked: 4 x 8 score tiles into P, then
// softmax_rows_f32.
template <int HD, int NT, int KMAX, F32Path PATH>
__global__ void __launch_bounds__(NT)
mha_f32_kernel(const float* __restrict__ qkv, const float* __restrict__ mask,
               float* __restrict__ out, int t_len, int heads, float scale) {
  using G = F32Geometry<HD>;
  constexpr int P = G::kPitch;
  extern __shared__ __align__(16) float smem_f32[];
  const int b = blockIdx.x / heads;
  const int h = blockIdx.x % heads;
  const int d = heads * HD;
  const int ld3 = 3 * d;
  const float* base = qkv + (size_t)b * t_len * ld3 + h * HD;
  const bool vec = (reinterpret_cast<uintptr_t>(qkv) & 15) == 0;
  const int kn = (t_len + 3) & ~3;  // keys P.V runs over: P and V are 0 past t_len
  float acc[8][4];

  if constexpr (PATH != F32Path::kChunked) {
    const int tp = (t_len + 7) & ~7;
    const int pp = tp + 4;
    float* qs = smem_f32;  // [tp][P]
    float* ks = qs + tp * P;
    float* vs = ks + tp * P;
    // [tp][pp]: over Q and K once the scores are in registers, else apart
    float* ps = PATH == F32Path::kRegisters ? qs : vs + tp * P;
    load_rows_f32<HD, NT>(qs, base, 0, tp, t_len, ld3, vec);
    load_rows_f32<HD, NT>(ks, base + d, 0, tp, t_len, ld3, vec);
    asm volatile("cp.async.commit_group;\n" ::);
    load_rows_f32<HD, NT>(vs, base + 2 * d, 0, tp, t_len, ld3, vec);
    asm volatile("cp.async.commit_group;\n" ::);
    asm volatile("cp.async.wait_group 1;\n" ::: "memory");
    __syncthreads();
    if constexpr (PATH == F32Path::kRegisters) {
      const int rs = (t_len + 3) / 4;  // rows tr + i rs, keys tc + 8 u
      const int tr = threadIdx.x >> 3, tc = threadIdx.x & 7;
      const bool mine = tr < rs;
      float pr[4][KMAX];
      qk_softmax_regs_f32<HD, KMAX>(pr, qs, ks, tr, tc, rs, tp / 8, mine, t_len, mask, scale);
      __syncthreads();  // Q and K read: P goes over them
      if (mine) {
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int u = 0; u < KMAX; ++u)
            if (u < tp / 8) ps[(tr + i * rs) * pp + tc + 8 * u] = pr[i][u];
      }
    } else {
      qk_f32<HD, NT>(qs, ks, ps, pp, tp / 4, tp / 8, 0);
      __syncthreads();
      softmax_rows_f32<NT>(ps, pp, t_len, 0, t_len, tp, mask, scale);
    }
    asm volatile("cp.async.wait_group 0;\n" ::: "memory");
    __syncthreads();  // P normalised, V landed
    const int rs8 = tp / 8;
    for (int idx = threadIdx.x; idx < rs8 * G::kSegs; idx += NT) {
      const int tr = idx / G::kSegs, cg = idx % G::kSegs;
#pragma unroll
      for (int i = 0; i < 8; ++i)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[i][e] = 0.f;
      pv_f32<HD>(acc, ps, pp, vs, tr, cg, rs8, 0, kn, 0);
      store_f32(out, acc, (size_t)b * t_len, 0, t_len, d, h * HD + 4 * cg, tr, rs8);
    }
  } else {
    constexpr int C = kF32Chunk;
    const int q0 = blockIdx.y * C;
    const int tk = (t_len + C - 1) / C * C;
    const int pp = tk + 4;
    float* qs = smem_f32;    // [C][P]
    float* kv = qs + C * P;  // [C][P]: a chunk of K, later of V
    float* ps = kv + C * P;  // [C][pp]
    load_rows_f32<HD, NT>(qs, base, q0, C, t_len, ld3, vec);
    for (int k0 = 0; k0 < tk; k0 += C) {
      __syncthreads();  // the last chunk's readers are done
      load_rows_f32<HD, NT>(kv, base + d, k0, C, t_len, ld3, vec);
      asm volatile("cp.async.commit_group;\n" ::);
      asm volatile("cp.async.wait_group 0;\n" ::: "memory");
      __syncthreads();
      qk_f32<HD, NT>(qs, kv, ps, pp, C / 4, C / 8, k0);
    }
    __syncthreads();
    softmax_rows_f32<NT>(ps, pp, min(C, t_len - q0), q0, t_len, tk, mask, scale);
    // one context tile a thread: 8 x (HD / 4) <= NT
    const int tr = threadIdx.x / G::kSegs, cg = threadIdx.x % G::kSegs;
    const bool mine = threadIdx.x < (C / 8) * G::kSegs;
#pragma unroll
    for (int i = 0; i < 8; ++i)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][e] = 0.f;
    for (int k0 = 0; k0 < tk; k0 += C) {
      __syncthreads();
      load_rows_f32<HD, NT>(kv, base + 2 * d, k0, C, t_len, ld3, vec);
      asm volatile("cp.async.commit_group;\n" ::);
      asm volatile("cp.async.wait_group 0;\n" ::: "memory");
      __syncthreads();
      if (mine && k0 < kn) pv_f32<HD>(acc, ps, pp, kv, tr, cg, C / 8, k0, min(k0 + C, kn), k0);
    }
    if (mine)
      store_f32(out, acc, (size_t)b * t_len, q0, t_len, d, h * HD + 4 * cg, tr, C / 8);
  }
}

// shared memory of one block, in floats
template <int HD>
size_t f32_smem_floats(F32Path path, int t_len) {
  constexpr int P = F32Geometry<HD>::kPitch;
  const size_t tp = (t_len + 7) & ~7;
  if (path == F32Path::kRegisters) return 3 * tp * P;
  if (path == F32Path::kPass) return 3 * tp * P + tp * (tp + 4);
  const size_t tk = (t_len + kF32Chunk - 1) / kF32Chunk * kF32Chunk;
  return 2 * (size_t)kF32Chunk * P + (size_t)kF32Chunk * (tk + 4);
}

template <int HD, int NT, int KMAX, F32Path PATH>
cudaError_t launch_f32(const void* qkv, const void* mask, void* out, int batch, int t_len,
                       int heads, float scale, cudaStream_t stream) {
  static_assert(PATH != F32Path::kChunked || (kF32Chunk / 8) * F32Geometry<HD>::kSegs <= NT,
                "one context tile a thread when K and V are streamed");
  static devflags::PerDevice<bool> attr_set(false);
  cudaError_t err =
      devflags::smem_limit_once(attr_set, mha_f32_kernel<HD, NT, KMAX, PATH>, kSmemMax);
  if (err != cudaSuccess) return err;
  const int tiles = PATH == F32Path::kChunked ? (t_len + kF32Chunk - 1) / kF32Chunk : 1;
  mha_f32_kernel<HD, NT, KMAX, PATH><<<dim3(batch * heads, tiles), NT,
                                       sizeof(float) * f32_smem_floats<HD>(PATH, t_len),
                                       stream>>>(
      static_cast<const float*>(qkv), static_cast<const float*>(mask), static_cast<float*>(out),
      t_len, heads, scale);
  return cudaGetLastError();
}

template <int HD>
cudaError_t launch_f32_t(const void* qkv, const void* mask, void* out, int batch, int t_len,
                         int heads, float scale, cudaStream_t stream) {
  constexpr F32Path kRegs = F32Path::kRegisters;
  if (t_len <= 16)
    return launch_f32<HD, 32, 2, kRegs>(qkv, mask, out, batch, t_len, heads, scale, stream);
  if (t_len <= 32)
    return launch_f32<HD, 64, 4, kRegs>(qkv, mask, out, batch, t_len, heads, scale, stream);
  if (t_len <= 64)
    return launch_f32<HD, 128, 8, kRegs>(qkv, mask, out, batch, t_len, heads, scale, stream);
  if (t_len <= 128 && sizeof(float) * f32_smem_floats<HD>(F32Path::kPass, t_len) <= kSmemMax)
    return launch_f32<HD, 256, 1, F32Path::kPass>(qkv, mask, out, batch, t_len, heads, scale,
                                                  stream);
  return launch_f32<HD, 256, 1, F32Path::kChunked>(qkv, mask, out, batch, t_len, heads, scale,
                                                   stream);
}

cudaError_t dispatch_f32(const void* qkv, const void* mask, void* out, int batch, int t_len,
                         int heads, int head_dim, float scale, cudaStream_t stream) {
  switch (head_dim) {
    case 64: return launch_f32_t<64>(qkv, mask, out, batch, t_len, heads, scale, stream);
    case 80: return launch_f32_t<80>(qkv, mask, out, batch, t_len, heads, scale, stream);
    case 88: return launch_f32_t<88>(qkv, mask, out, batch, t_len, heads, scale, stream);
    case 104: return launch_f32_t<104>(qkv, mask, out, batch, t_len, heads, scale, stream);
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
    err = dispatch_f32(qkv, mask, out, batch, t_len, heads, head_dim, scale, s);
  else if (dtype == 1)
    err = dispatch_bf16(qkv, mask, out, batch, t_len, heads, head_dim, scale, s);
  else
    err = cudaErrorInvalidValue;
  return (int)err;
}
