// Forward flash attention over an int8 bias slab, for the VTL encoder.
//
// Replaces markushgrapher_tpu/ops/flash_attention.py:flash_attention_bias_i8.
// T5 semantics: no 1/sqrt(d) scaling. For query i and key j of head h:
//   s = q_i . k_j + (bias_i8[b, h, i, j] * scale_h + (mask[b, j] ? 0 : -1e30))
// softmax over j online in float32, output (sum_j p_j v_j) / l in bf16.
// The running max starts at the finite -1e30, not -inf, so a tile whose keys
// are all masked yields no NaN (its weights are wiped by the next valid
// tile's rescale, exactly as in the TPU kernel).
//
// Bound: at B=2, H=16, L=1536, D=64 the call must read the 75.5 MB int8
// slab and q, k, v once and write the output (~100 MB, 0.030 ms at
// 3.35 TB/s); with P as a bf16 hi + lo pair its products are 29 GFLOP
// (0.029 ms at 989 TFLOP/s bf16), and 75 M exponentials run beside them on
// the CUDA cores. Design: the Hopper core of flash_fwd_sm90.cuh with the
// BiasI8 policy: QK^T and PV on the tensor cores through wgmma, the online
// softmax on the accumulator fragments in registers, a producer warp
// keeping a ring of K / V / int8-bias / key-mask stages in flight by TMA
// (64-byte swizzled bias rows), each code dequantised in registers at its
// fragment position. Rows whose stride is no multiple of 16 bytes (L % 16
// != 0) are copied by the producer warp element by element with zero-fill.
// No divisibility requirement on L: ragged tiles are masked.

#include "flash_fwd_sm90.cuh"

namespace {

__global__ void __launch_bounds__(ffwd::kThreads, 1)
flash_i8_kernel(const __grid_constant__ CUtensorMap tq,
                const __grid_constant__ CUtensorMap tk,
                const __grid_constant__ CUtensorMap tv,
                const __grid_constant__ CUtensorMap tb,
                const ffwd::Params p) {
  ffwd::flash_fwd<ffwd::BiasI8>(tq, tk, tv, tb, p);
}

}  // namespace

extern "C" int mg_flash_i8(const void* q, const void* k, const void* v,
                           const int8_t* bias, const float* scales,
                           const int* key_mask, int B, int L, int H, int D,
                           void* out, void* stream) {
  if (D != ffwd::kD) return (int)cudaErrorInvalidValue;
  ffwd::Params p{bias, scales, key_mask, (ffwd::bf16*)out, nullptr,
                 L, H, 1, 0};
  return ffwd::launch<ffwd::BiasI8>(flash_i8_kernel, q, k, v, p, B,
                                    (cudaStream_t)stream);
}
