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
//   mask, padded keys set to -inf before the max. P is rounded where
//   fused_mha_reference rounds it: bf16(exp(s - max) / sum), max and sum
//   over all T keys. For T <= 128 the row of scores stays in registers
//   (one pass), in 4, 8, 10 or 16 n8 tiles (T <= 32, 64, 80, 128), so that
//   T=77 does not hold the registers of 128 keys (it ran slower so on the
//   H100: fewer blocks fit a SM).
// - P.V: the rounded P fragments are the A operand straight from registers
//   (the m16n8 accumulator layout is the m16n8k16 A layout); V goes in
//   through ldmatrix.trans. The fp32 context is rounded to bf16, staged in
//   the warp's own Q rows and stored 16 bytes at a time.
// - Why not wgmma/TMA: the work is bound by bytes (24 us) and its 2 GFLOP
//   take about 2 us even at mma.sync's rate; a 64-row warpgroup tile would
//   also waste most of its rows at T=16/50/77.
//
// bf16 past T = 128 (ViT-L/H/g/bigG-14 at 224 px: T=257), mha_bf16_long_kernel.
// - Bound: bytes. ViT-H-14 at B=32 reads 63 MB of QKV and writes 21 MB
//   (25 us at 3.35 TB/s) against 5.4 GFLOP (5 us on the tensor cores).
//   Its first form, one block a (batch row, head) holding all 272 padded
//   rows of Q, K and V (143 KB at hd 80: one block of 17 warps an SM), no
//   copy overlapped with work and Q K^T taken three times, ran 0.232 ms.
//   What bounds the kernel on the card is not the bytes but the latency of
//   each warp's chain of ldmatrix, mma.sync, exp and barrier, so the design
//   buys warps an SM: measured on the H100, 8 warps an SM (the head's K
//   resident) ran 0.317 ms, 16 (64-key chunks) 0.242, 20 (32-key chunks)
//   0.214; two m16 tiles a warp (each K and V fragment read once for both)
//   took 164 registers, 12 warps an SM, and 0.228.
// - Grid: one block of 4 warps (16 query rows each, as above) per (batch
//   row, head, 64 query rows), the query tiles of a head adjacent in
//   blockIdx so that the head's K and V come from HBM once and from L2 for
//   the other tiles; at T=257, 5 tiles (2,560 blocks at B=32 H=16, 640 for
//   the 4-way part's H=4). A warp whose rows all lie past T only copies.
// - Shared memory: the Q tile and a ring of three stages, each a 32-row
//   chunk of K and one of V: (64 + 6 x 32) x (hd' + 8) bf16, 45,056 bytes
//   at hd 80, 96 registers: 5 blocks an SM (6 at hd 64, 4 at 88, 3 at 104).
//   Pass A streams K, pass B K and V; two chunks are in flight while one is
//   used, one __syncthreads a chunk.
// - Two passes. Pass A takes the row max and the sum of exp(s - max)
//   together: a running max, the sum rescaled by exp(m_old - m_new) when
//   it moves (a row masked so far adds 0), the four lanes of a row merged
//   at the end. Pass B recomputes the scores, forms P = bf16(exp(s - max)
//   * (1 / sum)), normalised before it is rounded as the reference rounds
//   it (one reciprocal a row: e / sum per score cost 10 % of the kernel;
//   the two differ by an fp32 ulp before the bf16 rounding), and
//   accumulates P.V. The one-pass flash form, which rounds P before
//   normalising, is not used.
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
// - T from 129 to 257, and T <= 128 where the resident layout would pass
//   227 KB (hd=104 at T=128): mha_f32_long_kernel. Bound: operations
//   (ViT-H-14 at B=32: 10.8 GFLOP of FMA, 0.162 ms at 67 TFLOP/s). Its
//   first form (64 query rows a block, K and then V through one 64-row
//   buffer with a __syncthreads before and after each copy, 126 KB: one
//   block an SM, half its threads idle in Q K^T, every padded key and row
//   computed) took 0.812 ms; this one 0.605 ms on the H100 (SDPA 0.611):
//   - one block of 256 threads per (batch row, head, 64 query rows), the
//     tiles of a head adjacent in blockIdx;
//   - K and then V stream through a two-stage ring of 32-row chunks (one
//     __syncthreads a chunk; chunk s + 1 copied while chunk s's products
//     run);
//   - Q K^T from 2 x 4 register tiles (rows tr + 32 i, keys tc + 8 u): a
//     64 x 32 chunk gives each of the 256 threads 8 scores, and a warp's 4 Q
//     rows and 8 K rows are one bank wavefront each, so 6 float4 loads
//     feed 32 FMAs, the depth in the order of a plain fmaf chain; rows and
//     keys past T are skipped (8-row tiles would leave 64 of the 256
//     threads a chunk);
//   - P (64 x pitch, pitch >= T rounded to 4 and 8 mod 32: conflict-free
//     writes and softmax reads) stays resident for the exact softmax pass
//     above; P.V in the 8 x 4 tiles above, chunk by chunk, a tile whose
//     rows all lie past T skipped (the same tiles spread over all 8 warps
//     ran 5 % slower);
//   - shared memory (64 + 64) x (HD + 4) + 64 x 264 floats at T=257:
//     110,592 bytes at hd 80 (2 blocks an SM; 2 at 64 and 88; 1 at 104;
//     a third stage or 64-row chunks would leave one block an SM).
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

// The warp's 16 query rows (shared rows from r0, sequence rows from
// q_off + r0) against shared keys [kc0, kc0 + 8 nt) (sequence keys k_off +
// those): sc[j] is the m16n8 accumulator of key tile j, scaled in fp32,
// plus the mask; keys past T are -inf. Element e of a tile sits at row
// q_off + r0 + lane/4 + 8 (e/2), key k_off + kc0 + 8j + 2 (lane%4) + e%2.
template <int HD, int NT>
__device__ __forceinline__ void qk_scores(float (&sc)[NT][4], const bf16* qs, const bf16* ks,
                                          int r0, int kc0, int nt, int t_len,
                                          const float* __restrict__ mask, float scale,
                                          int lane, int q_off = 0, int k_off = 0) {
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
  const int row0 = q_off + r0 + (lane >> 2);
#pragma unroll
  for (int j = 0; j < NT; ++j) {
    if (j < nt) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int row = row0 + (e >> 1) * 8;
        const int col = k_off + kc0 + 8 * j + 2 * (lane & 3) + (e & 1);
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

// o += bf16(e / l) . V[kc0 : kc0 + 8 nt): P as the A operand from registers.
// kRcp: l holds 1 / sum and P is bf16(e * l).
template <int HD, int NT, bool kRcp = false>
__device__ __forceinline__ void pv(const float (&sc)[NT][4], int nt, const float (&l)[2],
                                   float (&o)[Bf16Geometry<HD>::kHDP / 8][4], const bf16* vs,
                                   int kc0, int lane) {
  using G = Bf16Geometry<HD>;
  auto nrm = [&](float e, int r) { return kRcp ? e * l[r] : e / l[r]; };
#pragma unroll
  for (int s = 0; s < NT / 2; ++s) {
    if (2 * s < nt) {
      uint32_t a[4];
      a[0] = pack_bf16(nrm(sc[2 * s][0], 0), nrm(sc[2 * s][1], 0));
      a[1] = pack_bf16(nrm(sc[2 * s][2], 1), nrm(sc[2 * s][3], 1));
      a[2] = pack_bf16(nrm(sc[2 * s + 1][0], 0), nrm(sc[2 * s + 1][1], 0));
      a[3] = pack_bf16(nrm(sc[2 * s + 1][2], 1), nrm(sc[2 * s + 1][3], 1));
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

// The warp's context rows (shared rows r0 .. r0 + 15, sequence rows q0 +
// those), rounded to bf16, staged in the warp's own Q rows, then stored 16
// bytes at a time.
template <int HD>
__device__ __forceinline__ void store_context(const float (&o)[Bf16Geometry<HD>::kHDP / 8][4],
                                              bf16* qs, bf16* __restrict__ out, int r0, int q0,
                                              int t_len, int b, int d, int h, int lane) {
  using G = Bf16Geometry<HD>;
  constexpr int P = G::kPitch;
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
    if (q0 + row < t_len)
      *reinterpret_cast<uint4*>(out + ((size_t)b * t_len + q0 + row) * d + h * HD + seg * 8) =
          *reinterpret_cast<const uint4*>(qs + row * P + seg * 8);
  }
}

// NT: n8 key tiles held in registers, one pass over the whole row
// (T <= 8 NT <= 128).
template <int HD, int NT>
__global__ void __launch_bounds__(NT * 16)
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
  store_context<HD>(o, qs, out, r0, 0, t_len, b, d, h, lane);
}

// -- bf16 past T = 128 --------------------------------------------------------

constexpr int kLongRows = 64;   // query rows a block: 4 warps of 16
constexpr int kLongKeys = 32;   // keys a chunk: 4 n8 tiles
constexpr int kLongStages = 3;  // the ring's stages: 2 chunks in flight

// Rows [r0, r0 + n) of one head's Q, K or V (`src` at the head's columns of
// the batch row's first packed row) into [n][kPitch], 16 bytes a copy, zero
// past t_len and past the head's depth.
template <int HD>
__device__ __forceinline__ void copy_rows_bf16(bf16* dst, const bf16* src, int r0, int n,
                                               int t_len, int ld3) {
  using G = Bf16Geometry<HD>;
  for (int e = threadIdx.x; e < n * G::kSegsP; e += blockDim.x) {
    const int r = e / G::kSegsP, seg = e % G::kSegsP;
    const bool ok = r0 + r < t_len && seg < G::kSegs;
    cp_async16(dst + r * G::kPitch + seg * 8,
               src + (ok ? (size_t)(r0 + r) * ld3 + seg * 8 : 0), ok);
  }
}

// One block per (batch row, head, 64 query rows), the query tiles of a head
// adjacent in blockIdx. K, then K and V, stream through a ring of
// kLongStages stages of 32-row chunks. Pass A takes the row max and the
// sum of exp(s - max) together, rescaling the sum when the max moves; pass
// B recomputes the scores and accumulates bf16(exp(s - max) * (1 / sum)) .
// V, P normalised before it is rounded, as fused_mha_reference rounds it.
template <int HD>
__global__ void __launch_bounds__(kLongRows * 2)
mha_bf16_long_kernel(const bf16* __restrict__ qkv, const float* __restrict__ mask,
                     bf16* __restrict__ out, int t_len, int heads, int tiles, float scale) {
  using G = Bf16Geometry<HD>;
  constexpr int P = G::kPitch, C = kLongKeys, S = kLongStages;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int tp = (t_len + 15) & ~15;
  const int nc = (tp + C - 1) / C;
  bf16* qs = reinterpret_cast<bf16*>(smem_raw);  // [64][P]: the Q tile, then the output
  bf16* ring = qs + kLongRows * P;               // [S][K, V][C][P]

  const int head = blockIdx.x / tiles;
  const int q0 = (blockIdx.x % tiles) * kLongRows;
  const int b = head / heads, h = head % heads;
  const int d = heads * HD, ld3 = 3 * d;
  const bf16* base = qkv + (size_t)b * t_len * ld3 + h * HD;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  // step s < nc copies K chunk s (pass A), step nc + c K and V chunk c
  // (pass B), into stage s % S; past the last step a group stays empty
  auto fetch = [&](int s) {
    if (s < 2 * nc) {
      bf16* st = ring + (s % S) * 2 * C * P;
      const int k0 = (s % nc) * C, n = min(C, tp - k0);
      copy_rows_bf16<HD>(st, base + d, k0, n, t_len, ld3);
      if (s >= nc) copy_rows_bf16<HD>(st + C * P, base + 2 * d, k0, n, t_len, ld3);
    }
    asm volatile("cp.async.commit_group;\n" ::);
  };
  copy_rows_bf16<HD>(qs, base, q0, kLongRows, t_len, ld3);
#pragma unroll
  for (int s = 0; s < S - 1; ++s) fetch(s);  // the Q tile with step 0
  // step s landed, and step s - 1's readers are done with stage (s - 1) % S
  auto next = [&](int s) {
    asm volatile("cp.async.wait_group %0;\n" ::"n"(S - 2) : "memory");
    __syncthreads();
    fetch(s + S - 1);
    return ring + (s % S) * 2 * C * P;
  };

  const int r0 = warp * 16;
  const bool live = q0 + r0 < t_len;  // a warp past the last row only copies
  float sc[C / 8][4];
  float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f};
  for (int s = 0; s < nc; ++s) {
    const bf16* st = next(s);
    if (live) {
      const int k0 = s * C, nt = min(C, tp - k0) / 8;
      qk_scores<HD, C / 8>(sc, qs, st, r0, 0, nt, t_len, mask, scale, lane, q0, k0);
      float mc[2] = {m[0], m[1]}, mr[2];
      row_max<C / 8>(sc, nt, mc);
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        mr[r] = mc[r] == -INFINITY ? 0.f : mc[r];  // a row masked so far adds 0
        l[r] *= expf(m[r] - mr[r]);                // 1 when the max did not move
        m[r] = mc[r];
      }
      exp_sum<C / 8>(sc, nt, mr, l);
    }
  }
  // the row's max and 1 / sum over the four lanes that hold it
  float mx[2], inv[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    mx[r] = quad_max(m[r]);
    inv[r] = 1.f / quad_sum(l[r] * expf(m[r] - (mx[r] == -INFINITY ? 0.f : mx[r])));
  }

  float o[G::kHDP / 8][4];
#pragma unroll
  for (int j = 0; j < G::kHDP / 8; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) o[j][e] = 0.f;
  for (int s = nc; s < 2 * nc; ++s) {
    const bf16* st = next(s);
    if (live) {
      const int k0 = (s - nc) * C, nt = min(C, tp - k0) / 8;
      float unused[2] = {0.f, 0.f};
      qk_scores<HD, C / 8>(sc, qs, st, r0, 0, nt, t_len, mask, scale, lane, q0, k0);
      exp_sum<C / 8>(sc, nt, mx, unused);
      pv<HD, C / 8, true>(sc, nt, inv, o, st + C * P, 0, lane);
    }
  }
  if (live) store_context<HD>(o, qs, out, r0, q0, t_len, b, d, h, lane);
}

template <int HD, int NT>
cudaError_t launch_bf16(const void* qkv, const void* mask, void* out, int batch, int t_len,
                        int heads, float scale, cudaStream_t stream) {
  using G = Bf16Geometry<HD>;
  const int tp = (t_len + 15) & ~15;
  const size_t smem = 3 * sizeof(bf16) * (size_t)tp * G::kPitch;
  static devflags::PerDevice<bool> attr_set(false);
  const size_t most = 3 * sizeof(bf16) * (size_t)(NT * 8) * G::kPitch;
  cudaError_t err = devflags::smem_limit_once(attr_set, mha_bf16_kernel<HD, NT>, most);
  if (err != cudaSuccess) return err;
  mha_bf16_kernel<HD, NT><<<batch * heads, (tp / 16) * 32, smem, stream>>>(
      static_cast<const bf16*>(qkv), static_cast<const float*>(mask), static_cast<bf16*>(out),
      t_len, heads, scale);
  return cudaGetLastError();
}

// shared memory of a long-path block: the Q tile and the ring
template <int HD>
constexpr size_t bf16_long_smem() {
  return sizeof(bf16) * (kLongRows + 2 * kLongStages * kLongKeys) * Bf16Geometry<HD>::kPitch;
}

template <int HD>
cudaError_t launch_bf16_long(const void* qkv, const void* mask, void* out, int batch, int t_len,
                             int heads, float scale, cudaStream_t stream) {
  static devflags::PerDevice<bool> attr_set(false);
  cudaError_t err =
      devflags::smem_limit_once(attr_set, mha_bf16_long_kernel<HD>, bf16_long_smem<HD>());
  if (err != cudaSuccess) return err;
  const int tiles = (t_len + kLongRows - 1) / kLongRows;
  mha_bf16_long_kernel<HD><<<batch * heads * tiles, kLongRows * 2, bf16_long_smem<HD>(),
                             stream>>>(
      static_cast<const bf16*>(qkv), static_cast<const float*>(mask), static_cast<bf16*>(out),
      t_len, heads, tiles, scale);
  return cudaGetLastError();
}

template <int HD>
cudaError_t launch_bf16_t(const void* qkv, const void* mask, void* out, int batch, int t_len,
                          int heads, float scale, cudaStream_t stream) {
  const int tp = (t_len + 15) & ~15;
  if (tp <= 32) return launch_bf16<HD, 4>(qkv, mask, out, batch, t_len, heads, scale, stream);
  if (tp <= 64) return launch_bf16<HD, 8>(qkv, mask, out, batch, t_len, heads, scale, stream);
  if (tp <= 80) return launch_bf16<HD, 10>(qkv, mask, out, batch, t_len, heads, scale, stream);
  if (tp <= 128) return launch_bf16<HD, 16>(qkv, mask, out, batch, t_len, heads, scale, stream);
  return launch_bf16_long<HD>(qkv, mask, out, batch, t_len, heads, scale, stream);
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

constexpr int kSmemMax = 232448;      // shared memory a block may use on sm_90
constexpr int kLanes = 8;             // lanes that share a row of the softmax pass
constexpr int kF32Rows = 64;          // query rows a block on the streamed path
constexpr int kF32Keys = 32;          // keys a chunk of its ring
constexpr int kF32Threads = 256;

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

// The two resident layouts of mha_f32_kernel (mha_f32_long_kernel streams).
enum class F32Path {
  kRegisters,  // T <= 64: Q, K, V resident; the scores and softmax in registers
  kPass,       // T <= 128: Q, K, V and P resident; the softmax a pass over P
};

// One block per (batch row, head). kRegisters: 8 (T + 3) / 4 <= NT threads
// hold 4 x (KMAX >= T / 8) score tiles and the row softmax in registers,
// and P goes over Q and K. kPass: 4 x 8 score tiles into P, then
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
}

// q . k of the block's query rows [0, nr) against the chunk's keys [0, nk)
// (sequence keys k0 + those, nk a multiple of 4), written to
// ps[row][k0 + key]. Thread (tr, tc) of 32 x 8 owns rows tr + 32 i (i < 2)
// and keys tc + 8 u (u < 4), the depth in the order of a plain fmaf chain;
// a warp's 4 Q rows and 8 K rows are one bank wavefront a float4 step each.
template <int HD>
__device__ __forceinline__ void qk_chunk_f32(const float* qs, const float* ks, float* ps, int pp,
                                             int nr, int nk, int k0) {
  constexpr int P = F32Geometry<HD>::kPitch;
  const int tr = threadIdx.x >> 3, tc = threadIdx.x & 7;
  if (tr >= nr || tc >= nk) return;
  const float* qrow = qs + tr * P;
  const float* krow = ks + tc * P;
  float acc[2][4];
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int u = 0; u < 4; ++u) acc[i][u] = 0.f;
#pragma unroll 4
  for (int c = 0; c < HD; c += 4) {
    float4 q[2];
#pragma unroll
    for (int i = 0; i < 2; ++i) q[i] = *reinterpret_cast<const float4*>(qrow + 32 * i * P + c);
#pragma unroll
    for (int u = 0; u < 4; ++u) {
      const float4 k = *reinterpret_cast<const float4*>(krow + 8 * u * P + c);
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        acc[i][u] = fmaf(q[i].x, k.x, acc[i][u]);
        acc[i][u] = fmaf(q[i].y, k.y, acc[i][u]);
        acc[i][u] = fmaf(q[i].z, k.z, acc[i][u]);
        acc[i][u] = fmaf(q[i].w, k.w, acc[i][u]);
      }
    }
  }
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int u = 0; u < 4; ++u)
      if (tr + 32 * i < nr && tc + 8 * u < nk) ps[(tr + 32 * i) * pp + k0 + tc + 8 * u] = acc[i][u];
}

// Row pitch of the streamed path's scores: at least the keys P.V runs over
// (T rounded up to 4) and 8 mod 32 floats, so that 4 rows x 8 consecutive
// keys (the score writes, the softmax pass) fall in 32 distinct banks.
__host__ __device__ __forceinline__ int f32_long_pitch(int t_len) {
  const int kn = (t_len + 3) & ~3;
  return kn + ((8 - kn) % 32 + 32) % 32;
}

// One block per (batch row, head, 64 query rows), the query tiles of a head
// adjacent in blockIdx. K and then V stream through a two-stage ring of
// 32-row chunks, chunk s + 1 copied while chunk s's products run; the
// scores of the tile's rows stay in P for the exact softmax pass, then P.V
// in 8 x 4 register tiles.
template <int HD>
__global__ void __launch_bounds__(kF32Threads, 2)
mha_f32_long_kernel(const float* __restrict__ qkv, const float* __restrict__ mask,
                    float* __restrict__ out, int t_len, int heads, int tiles, float scale) {
  using G = F32Geometry<HD>;
  constexpr int P = G::kPitch, R = kF32Rows, C = kF32Keys, NT = kF32Threads;
  extern __shared__ __align__(16) float smem_f32[];
  const int head = blockIdx.x / tiles;
  const int q0 = (blockIdx.x % tiles) * R;
  const int b = head / heads, h = head % heads;
  const int d = heads * HD, ld3 = 3 * d;
  const float* base = qkv + (size_t)b * t_len * ld3 + h * HD;
  const bool vec = (reinterpret_cast<uintptr_t>(qkv) & 15) == 0;
  const int kn = (t_len + 3) & ~3;  // keys P.V runs over: P and V are 0 past t_len
  const int pp = f32_long_pitch(t_len);
  const int nr = min(R, t_len - q0);
  const int nc = (t_len + C - 1) / C;  // chunks of K, then as many of V
  float* qs = smem_f32;          // [R][P]
  float* ring = qs + R * P;      // [2][C][P]
  float* ps = ring + 2 * C * P;  // [R][pp]
  // step s < nc copies K chunk s, step nc + c V chunk c, into stage s % 2
  auto fetch = [&](int s) {
    load_rows_f32<HD, NT>(ring + (s & 1) * C * P, base + (s < nc ? d : 2 * d), (s % nc) * C, C,
                          t_len, ld3, vec);
    asm volatile("cp.async.commit_group;\n" ::);
  };
  load_rows_f32<HD, NT>(qs, base, q0, R, t_len, ld3, vec);
  fetch(0);  // with the Q tile

  // one context tile a thread: 8 x (HD / 4) <= NT
  const int tr = threadIdx.x / G::kSegs, cg = threadIdx.x % G::kSegs;
  const bool mine = threadIdx.x < (R / 8) * G::kSegs && tr < nr;  // some row before T
  float acc[8][4];
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[i][e] = 0.f;
  for (int s = 0; s < 2 * nc; ++s) {
    asm volatile("cp.async.wait_group 0;\n" ::: "memory");
    __syncthreads();  // step s landed; step s - 1's readers are done
    if (s + 1 < 2 * nc) fetch(s + 1);
    const float* cur = ring + (s & 1) * C * P;
    const int k0 = (s % nc) * C;
    if (s < nc) {
      qk_chunk_f32<HD>(qs, cur, ps, pp, nr, min(C, kn - k0), k0);
      continue;
    }
    if (s == nc) {
      softmax_rows_f32<NT>(ps, pp, nr, q0, t_len, kn, mask, scale);
      __syncthreads();
    }
    if (mine && k0 < kn) pv_f32<HD>(acc, ps, pp, cur, tr, cg, R / 8, k0, min(k0 + C, kn), k0);
  }
  if (mine) store_f32(out, acc, (size_t)b * t_len, q0, t_len, d, h * HD + 4 * cg, tr, R / 8);
}

// shared memory of one block, in floats
template <int HD>
size_t f32_smem_floats(F32Path path, int t_len) {
  constexpr int P = F32Geometry<HD>::kPitch;
  const size_t tp = (t_len + 7) & ~7;
  if (path == F32Path::kRegisters) return 3 * tp * P;
  return 3 * tp * P + tp * (tp + 4);
}

template <int HD>
size_t f32_long_smem_floats(int t_len) {
  constexpr int P = F32Geometry<HD>::kPitch;
  return (size_t)(kF32Rows + 2 * kF32Keys) * P + (size_t)kF32Rows * f32_long_pitch(t_len);
}

template <int HD, int NT, int KMAX, F32Path PATH>
cudaError_t launch_f32(const void* qkv, const void* mask, void* out, int batch, int t_len,
                       int heads, float scale, cudaStream_t stream) {
  static devflags::PerDevice<bool> attr_set(false);
  cudaError_t err =
      devflags::smem_limit_once(attr_set, mha_f32_kernel<HD, NT, KMAX, PATH>, kSmemMax);
  if (err != cudaSuccess) return err;
  mha_f32_kernel<HD, NT, KMAX, PATH><<<batch * heads, NT,
                                       sizeof(float) * f32_smem_floats<HD>(PATH, t_len),
                                       stream>>>(
      static_cast<const float*>(qkv), static_cast<const float*>(mask), static_cast<float*>(out),
      t_len, heads, scale);
  return cudaGetLastError();
}

template <int HD>
cudaError_t launch_f32_long(const void* qkv, const void* mask, void* out, int batch, int t_len,
                            int heads, float scale, cudaStream_t stream) {
  static_assert((kF32Rows / 8) * F32Geometry<HD>::kSegs <= kF32Threads,
                "one context tile a thread");
  static devflags::PerDevice<bool> attr_set(false);
  cudaError_t err = devflags::smem_limit_once(attr_set, mha_f32_long_kernel<HD>,
                                              sizeof(float) * f32_long_smem_floats<HD>(kMaxT));
  if (err != cudaSuccess) return err;
  const int tiles = (t_len + kF32Rows - 1) / kF32Rows;
  mha_f32_long_kernel<HD><<<batch * heads * tiles, kF32Threads,
                            sizeof(float) * f32_long_smem_floats<HD>(t_len), stream>>>(
      static_cast<const float*>(qkv), static_cast<const float*>(mask), static_cast<float*>(out),
      t_len, heads, tiles, scale);
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
  return launch_f32_long<HD>(qkv, mask, out, batch, t_len, heads, scale, stream);
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
