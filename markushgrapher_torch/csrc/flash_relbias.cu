// Forward flash attention with the UDOP relative bias computed in the
// kernel, for the VTL encoder's in-kernel-bias serving route: no
// [B, H, L, L] bias slab exists.
//
// Replaces markushgrapher_tpu/ops/flash_relbias.py:flash_attention_relbias.
// T5 semantics: no 1/sqrt(d). For query i and key j of head h of sample b:
//   bias = (t1[b1] + th[bh]) + tv[bv], with
//   b1 the T5 bucket of j - i (max distance max1),
//   bh the bucket of trunc((hx[b, j] - hx[b, i]) * scaling) (max distance
//   max2), bv the same over vy;
//   s = q_i . k_j + (mask[b, j] ? bias : -1e30)
// softmax over j online in float32 from the finite start -1e30, output
// (sum_j p_j v_j) / max(l, 1e-30) in bf16, so a row whose keys are all
// masked averages them uniformly, as the TPU kernel does.
//
// Bound: at B=8, H=16, L=1536, D=64 the call moves only q, k, v, the
// centres, the mask and the output (~100 MB: ~0.03 ms at 3.35 TB/s) and does
// 77 GFLOP of products (0.078 ms at the bf16 tensor rate): bound by
// operations. Beside the tensor cores, each of the 302 M scores costs about
// 17 FP32 / integer operations and 2-3 shared loads of bias on the CUDA
// cores (chip_smoke prints this floor beside the bound), as much again as
// the softmax.
// Design: the Hopper core of flash_fwd_sm90.cuh with the BiasRel policy:
// QK^T and PV on the tensor cores through wgmma, a producer warp keeping a
// ring of K / V tiles (TMA) with the keys' centres and mask in flight, and
// each consumer thread computing the bias at its accumulator-fragment
// positions as the accumulator's start value, from the bucket LUTs composed
// with the head's table columns in shared memory (the core's note says how).
// The LUTs are built on the CPU by the plain `relative_position_bucket`
// (distances clamped into +-max_distance, where buckets already saturate),
// and every float op of the bias uses an explicit rounding intrinsic, so
// the bias is bit-exact against the plain version's
// (relbias.centre_position_bias); mg_flash_relbias_scores, an instance
// that also stores those bias terms, lets the tests check that. No length
// has to be a multiple of the tile: ragged tiles are zero-filled and their
// keys excluded.

#include "flash_fwd_sm90.cuh"

namespace {

template <bool kDebug>
__global__ void __launch_bounds__(ffwd::kThreads, 1)
flash_relbias_kernel(const __grid_constant__ CUtensorMap tq,
                     const __grid_constant__ CUtensorMap tk,
                     const __grid_constant__ CUtensorMap tv,
                     const __grid_constant__ CUtensorMap tb,
                     const ffwd::Params p) {
  ffwd::flash_fwd<ffwd::BiasRel, kDebug>(tq, tk, tv, tb, p);
}

int run(const void* q, const void* k, const void* v, const float* hx,
        const float* vy, const int* mask, const float* tables,
        const int* lut1, const int* lut2, int B, int L, int H, int D, int nb,
        int max1, int max2, float scaling, void* out, float* scores,
        void* stream) {
  if (D != ffwd::kD) return (int)cudaErrorInvalidValue;
  ffwd::Params p{};
  p.key_mask = mask;
  p.out = (ffwd::bf16*)out;
  p.L = L;
  p.H = H;
  p.hx = hx;
  p.vy = vy;
  p.tables = tables;
  p.lut1 = lut1;
  p.lut2 = lut2;
  p.nb = nb;
  p.max1 = max1;
  p.max2 = max2;
  p.scaling = scaling;
  p.scores = scores;
  cudaStream_t s = (cudaStream_t)stream;
  if (scores)
    return ffwd::launch<ffwd::BiasRel>(flash_relbias_kernel<true>, q, k, v, p,
                                       B, s);
  return ffwd::launch<ffwd::BiasRel>(flash_relbias_kernel<false>, q, k, v, p,
                                     B, s);
}

}  // namespace

extern "C" int mg_flash_relbias(const void* q, const void* k, const void* v,
                                const float* hx, const float* vy,
                                const int* mask, const float* tables,
                                const int* lut1, const int* lut2, int B,
                                int L, int H, int D, int nb, int max1,
                                int max2, float scaling, void* out,
                                void* stream) {
  return run(q, k, v, hx, vy, mask, tables, lut1, lut2, B, L, H, D, nb, max1,
             max2, scaling, out, nullptr, stream);
}

// The same, also storing each score's bias term (float32 [B, H, L, L]) to
// `scores`: for the tests, on no serving path.
extern "C" int mg_flash_relbias_scores(
    const void* q, const void* k, const void* v, const float* hx,
    const float* vy, const int* mask, const float* tables, const int* lut1,
    const int* lut2, int B, int L, int H, int D, int nb, int max1, int max2,
    float scaling, void* out, float* scores, void* stream) {
  if (!scores) return (int)cudaErrorInvalidValue;
  return run(q, k, v, hx, vy, mask, tables, lut1, lut2, B, L, H, D, nb, max1,
             max2, scaling, out, scores, stream);
}
