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
// The sweep, the running top-k and the cross-range merge live in
// sim_topk_common.cuh (fp32_sim_topk with Fp32Corpus), shared with K3's
// dequant variant (masked_sim_topk_quant.cu).
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -O3 -shared
//        -Xcompiler -fPIC (tpualign_torch/ops/build.py).

#include <cuda_runtime.h>
#include <stdint.h>

#include "sim_topk_common.cuh"

// part_v/part_i: (nq, splits, k) scratch, used when splits > 1.
// out_v/out_i: (nq, k). k <= 128; splits * k <= 4096. Returns a cudaError_t.
extern "C" int tpualign_masked_sim_topk(const void* q, const void* qk, const void* c,
                                        const void* ck, int nq, int n, int d, int k,
                                        int splits, void* part_v, void* part_i,
                                        void* out_v, void* out_i, int device,
                                        void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  if (simtopk::bad_args(nq, n, d, k, splits)) return (int)cudaErrorInvalidValue;
  return (int)simtopk::fp32_sim_topk(
      static_cast<const float*>(q), static_cast<const int*>(qk),
      simtopk::Fp32Corpus{static_cast<const float*>(c)}, static_cast<const int*>(ck), nq, n,
      d, k, splits, part_v, part_i, out_v, out_i, static_cast<cudaStream_t>(stream));
}
