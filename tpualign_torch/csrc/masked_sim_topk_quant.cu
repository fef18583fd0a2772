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
// Integer variants. The queries arrive as fp32 and are quantized here
// exactly as tpualign does outside its kernel (quantize_kernel: an int8
// code and a fp32 scale a row); the corpus is int8 (N, D), or int4 (N, D/2)
// bytes of two offset-8 nibbles, or int2 (N, D/4) bytes of four 2-bit
// codes. Each score is the int32 sum of qq * cq, exact in any order,
// rescaled as (float(acc) * qs) * cs with one rounding per product, the
// order of tpualign's epilogue, so every score equals the plain version's
// bit for bit.
//
// Bound on the H100: bytes. At Q=1,024, N=1,000,000, D=512 the int8 corpus
// is 512 MB (0.153 ms at 3.35 TB/s; int4 and int2 a half and a quarter);
// a serving batch (one or two queries, often keyed to one page) needs a few
// of its rows and the 4 MB of keys that say which. The design
// (quant_sweep.cuh): a prologue marks the 64-row tiles that some query of a
// block admits and the sweep reads those alone; the products go to the
// tensor cores (mma.sync m16n8k32 s8, ldmatrix from a cp.async ring of
// stages, int4/int2 unpacked to s8 in shared memory); winners are filtered
// against each list's k-th entry in registers. The wrapper groups the
// queries by key so that a block covers few keys, and batches of up to 16
// queries take 16-query blocks.
//
// Dequant variant (int8 codes with row scales, fp32 queries): each code is
// dequantized as float(c) * cs and scored by fp32 FMA chains, as tpualign's
// _score_fp32 does with row scales, over the admitted tiles alone.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -O3 -shared
//        -Xcompiler -fPIC (tpualign_torch/ops/build.py).

#include <cuda_runtime.h>
#include <stdint.h>

#include "quant_sweep.cuh"

// variant 0 s8, 1 int4, 2 int2: q is the (nq, d) fp32 queries, quantized
//   into qq ((nq, d) int8 scratch) and qs ((nq,) fp32 scratch); c is (n, d)
//   int8, (n, d/2) or (n, d/4) uint8 with d a multiple of 4, 8 or 16; bq is
//   16 or 64, the queries of a block.
// variant 3 dequant: q is (nq, d) fp32 and c (n, d) int8; qq, qs and bq are
//   unused (32-query blocks).
// qk: (nq,) int32 keys, the queries grouped by key by the wrapper. cs: (n,)
// fp32 row scales; ck: (n,) int32 keys. admitted: (ceil(nq / bq), words)
// u32 scratch, words = ceil(max(1, ceil(n / 64)) / 32). part_v/part_i:
// (nq, splits, k) scratch, used when splits > 1. out_v/out_i: (nq, k).
// k <= 128; splits <= 4096. Returns a cudaError_t.
extern "C" int tpualign_masked_sim_topk_quant(int variant, const void* q, const void* qk,
                                              const void* c, const void* cs, const void* ck,
                                              int nq, int n, int d, int k, int splits, int bq,
                                              void* qq, void* qs, void* admitted, void* part_v,
                                              void* part_i, void* out_v, void* out_i,
                                              int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  if (simtopk::bad_args(nq, n, d, k, splits) || variant < 0 || variant > 3 ||
      (variant < 3 && (d % (4 << variant) || (bq != 16 && bq != 64))))
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* qf = static_cast<const float*>(q);
  const int* qki = static_cast<const int*>(qk);
  const float* csf = static_cast<const float*>(cs);
  const int* cki = static_cast<const int*>(ck);
  unsigned* bits = static_cast<unsigned*>(admitted);
  const simtopk::FlatTiles<simtopk::kIN> tiles{n};
  if (variant == 3)
    return (int)simtopk::dequant_search(qf, qki, static_cast<const int8_t*>(c), csf, cki, tiles,
                                        nq, d, k, splits, bits, part_v, part_i, out_v, out_i,
                                        s);
  int8_t* qqi = static_cast<int8_t*>(qq);
  float* qsf = static_cast<float*>(qs);
#define TPUALIGN_K3_INT(P)                                                                  \
  simtopk::int_search<P>(qf, qki, c, csf, cki, tiles, nq, d, k, splits, bq, qqi, qsf, bits, \
                         part_v, part_i, out_v, out_i, s)
  if (variant == 0) return (int)TPUALIGN_K3_INT(1);
  if (variant == 1) return (int)TPUALIGN_K3_INT(2);
  return (int)TPUALIGN_K3_INT(4);
#undef TPUALIGN_K3_INT
}
