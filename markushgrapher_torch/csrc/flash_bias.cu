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
// once (~0.18 ms at 3.35 TB/s); its 77 GFLOP of products take ~0.08 ms at
// the bf16 tensor rate. Design: one block of four warps per (b*h, 64-query
// tile); Q stays in shared memory, K/V tiles of 64 keys are staged per step;
// QK^T and PV are bf16 WMMA products with float32 accumulation; each warp
// owns 16 query rows, two threads per row doing the online softmax over 32
// keys each (the row's bias streamed from device memory in 16-byte loads
// where aligned) and holding 32 of the row's 64 output accumulators in
// registers. P enters the PV product as a bf16 hi + lo pair (two products),
// so the output keeps float32-level accuracy.
// No length has to be a multiple of the tile: ragged tiles are zero-filled
// and their keys excluded.

#include "flash_bias.cuh"

namespace fb {
namespace {

template <typename BT>
__global__ void __launch_bounds__(kThreads)
flash_bias_fwd_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                      const bf16* __restrict__ v, const BT* __restrict__ bias,
                      int bias_batched, int L, int H, bf16* __restrict__ out,
                      float* __restrict__ lse) {
  extern __shared__ __align__(128) unsigned char smem[];
  TileH* q_s = reinterpret_cast<TileH*>(smem);
  TileH* k_s = q_s + kT;
  TileH* v_s = k_s + kT;
  TileH* p_s = v_s + kT;   // P, high bf16 part
  TileH* p2_s = p_s + kT;  // P, low bf16 part
  TileF* s_f = reinterpret_cast<TileF*>(p2_s + kT);

  const int bh = blockIdx.y;
  const int b = bh / H;
  const int h = bh % H;
  const int q0 = blockIdx.x * kT;
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int r0 = warp * 16;
  const int row = r0 + lane / 2;  // this thread's query row in the tile
  const int c0 = (lane % 2) * 32;  // its 32 keys of a tile, and 32 of D
  const int i = q0 + row;
  const BT* brow = bias + (((size_t)(bias_batched ? b : 0) * H + h) * L +
                           min(i, L - 1)) * (size_t)L;
  const bool vec = (L % (16 / (int)sizeof(BT))) == 0;

  load_rows(q_s, q, b, h, q0, L, H);
  float acc[32];
#pragma unroll
  for (int d = 0; d < 32; ++d) acc[d] = 0.f;
  float m = kNegInf;
  float l = 0.f;
  FragC frag[4];

  for (int k0 = 0; k0 < L; k0 += kT) {
    __syncthreads();  // Q loaded; the previous tile's K/V reads are done
    load_rows(k_s, k, b, h, k0, L, H);
    load_rows(v_s, v, b, h, k0, L, H);
    __syncthreads();
    zero(frag);
    mma_abt(frag, q_s, r0, k_s);
    store(s_f, r0, frag);
    __syncwarp();

    const int n = L - (k0 + c0);  // keys of this thread's 32 that exist
    float s[32];
    load_bias32(brow + k0 + c0, n, vec, s);
    float tmax = kNegInf;
#pragma unroll
    for (int c = 0; c < 32; ++c) {
      s[c] = c < n ? s_f[row][c0 + c] + s[c] : kNegInf;
      tmax = fmaxf(tmax, s[c]);
    }
    tmax = fmaxf(tmax, __shfl_xor_sync(0xffffffffu, tmax, 1));
    const float m_new = fmaxf(m, tmax);
    const float alpha = expf(m - m_new);
    float psum = 0.f;
#pragma unroll
    for (int c = 0; c < 32; ++c) {
      const float p = c < n ? expf(s[c] - m_new) : 0.f;
      psum += p;
      split_bf16(p, &p_s[row][c0 + c], &p2_s[row][c0 + c]);
    }
    psum += __shfl_xor_sync(0xffffffffu, psum, 1);
    l = l * alpha + psum;
    m = m_new;
    __syncwarp();
    zero(frag);
    mma_ab(frag, p_s, r0, v_s);
    mma_ab(frag, p2_s, r0, v_s);
    store(s_f, r0, frag);
    __syncwarp();
#pragma unroll
    for (int d = 0; d < 32; ++d) acc[d] = fmaf(acc[d], alpha, s_f[row][c0 + d]);
    __syncwarp();
  }
  if (i >= L) return;
  const float den = fmaxf(l, 1e-30f);
  uint4* dst = reinterpret_cast<uint4*>(
      out + (((size_t)b * L + i) * H + h) * kD + c0);
#pragma unroll
  for (int c = 0; c < 4; ++c) {
    uint4 packed;
    __nv_bfloat162* p2 = reinterpret_cast<__nv_bfloat162*>(&packed);
#pragma unroll
    for (int e = 0; e < 4; ++e)
      p2[e] = __floats2bfloat162_rn(__fdiv_rn(acc[8 * c + 2 * e], den),
                                    __fdiv_rn(acc[8 * c + 2 * e + 1], den));
    dst[c] = packed;
  }
  if (c0 == 0) lse[(size_t)bh * L + i] = m + logf(den);
}

template <typename BT>
int launch(const void* q, const void* k, const void* v, const void* bias,
           int bias_batched, int B, int L, int H, void* out, void* lse,
           cudaStream_t s) {
  const int smem = 5 * kTileH * (int)sizeof(bf16) + kTileF * (int)sizeof(float);
  cudaError_t e = cudaFuncSetAttribute(
      flash_bias_fwd_kernel<BT>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      smem);
  if (e != cudaSuccess) return (int)e;
  dim3 grid((L + kT - 1) / kT, B * H);
  flash_bias_fwd_kernel<BT><<<grid, kThreads, smem, s>>>(
      (const bf16*)q, (const bf16*)k, (const bf16*)v, (const BT*)bias,
      bias_batched, L, H, (bf16*)out, (float*)lse);
  return (int)cudaGetLastError();
}

}  // namespace
}  // namespace fb

extern "C" int mg_flash_bias_fwd(const void* q, const void* k, const void* v,
                                 const void* bias, int bias_f32,
                                 int bias_batched, int B, int L, int H, int D,
                                 void* out, void* lse, void* stream) {
  if (D != fb::kD || B <= 0 || L <= 0 || H <= 0)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  if (bias_f32)
    return fb::launch<float>(q, k, v, bias, bias_batched, B, L, H, out, lse,
                             s);
  return fb::launch<fb::bf16>(q, k, v, bias, bias_batched, B, L, H, out, lse,
                              s);
}
