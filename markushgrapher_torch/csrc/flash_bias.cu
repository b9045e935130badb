// Forward flash attention with an additive float bias, for the VTL encoder's
// training (and the float-bias serving branch).
//
// Replaces the forward of the stock Pallas TPU flash attention the reference
// trains with (jax/experimental/pallas/ops/tpu/flash_attention.py, called at
// markushgrapher_tpu/models/t5.py:376-385) and
// markushgrapher_tpu/ops/flash_attention.py:flash_attention_bias, which
// compute the same function. T5 semantics: no 1/sqrt(d). For query i and key
// j of head h: s = q_i . k_j + bias[b or 0, h, i, j] (bf16 or float32, the
// key mask already in it); softmax over j online in float32 from a finite
// start (-1e30, as flash_i8.cu), output bf16, and the float32 log-sum-exp
// m + log(l) of each row for the backward kernels.
//
// Bound: at B=8, H=16, L=1536, D=64 the call must read the 604 MB bf16 bias
// and q, k, v once and write the output and lse (705 MB, 0.211 ms at
// 3.35 TB/s); with P as a bf16 hi + lo pair its products are 116 GFLOP
// (0.117 ms at 989 TFLOP/s bf16). Design: the Hopper core of
// flash_fwd_sm90.cuh with the BiasBF16 / BiasF32 policy: QK^T and PV on the
// tensor cores through wgmma, the online softmax on the accumulator
// fragments in registers, a producer warp keeping a ring of K / V / bias
// stages in flight by TMA (128-byte swizzled bias rows; a float32 tile is
// two boxes of 32 keys), so the bias stream is never on a consumer's
// critical path. Bias rows whose stride is no multiple of 16 bytes (bf16:
// L % 8 != 0, float32: L % 4 != 0) are copied by the producer warp element
// by element with zero-fill. No length has to be a multiple of the tile:
// ragged tiles are zero-filled and their keys excluded.

#include "flash_fwd_sm90.cuh"

namespace {

template <class P>
__global__ void __launch_bounds__(ffwd::kThreads, 1)
flash_bias_fwd_kernel(const __grid_constant__ CUtensorMap tq,
                      const __grid_constant__ CUtensorMap tk,
                      const __grid_constant__ CUtensorMap tv,
                      const __grid_constant__ CUtensorMap tb,
                      const ffwd::Params p) {
  ffwd::flash_fwd<P>(tq, tk, tv, tb, p);
}

}  // namespace

extern "C" int mg_flash_bias_fwd(const void* q, const void* k, const void* v,
                                 const void* bias, int bias_f32,
                                 int bias_batched, int B, int L, int H, int D,
                                 void* out, void* lse, void* stream) {
  if (D != ffwd::kD) return (int)cudaErrorInvalidValue;
  ffwd::Params p{bias, nullptr, nullptr, (ffwd::bf16*)out, (float*)lse,
                 L, H, bias_batched, 0};
  cudaStream_t s = (cudaStream_t)stream;
  if (bias_f32)
    return ffwd::launch<ffwd::BiasF32>(flash_bias_fwd_kernel<ffwd::BiasF32>,
                                       q, k, v, p, B, s);
  return ffwd::launch<ffwd::BiasBF16>(flash_bias_fwd_kernel<ffwd::BiasBF16>,
                                      q, k, v, p, B, s);
}
