// Q=1 decode attention over int4-nibble K/V, for every decode-step
// attention (cross over the packed encoder slab, self over the ring).
//
// Replaces markushgrapher_tpu/ops/mxu_decode.py:cross_decode_mxu_int4 in its
// separate-K/V mode. For row b, head h, key k:
//   s_k = (q_bf16 . k_k) * ks[b, h, k] + bias[b?, h?, k]
//   p_k = exp(s_k - max s);  l = sum p_k
//   out = bf16( sum_k bf16(p_k * vs[b, h, k]) * v_k / l )
// keeping the TPU kernel's rounding points (q, p*vs and the output in bf16)
// so that greedy tokens match. No 1/sqrt(d) scaling (T5).
//
// Layout (pack_int4, column split): element e of the H*D row is the low
// nibble of byte e if e < H*D/2, else the high nibble of byte e - H*D/2;
// sign-extended with (n ^ 8) - 8.
//
// Bound: reading the slab, ~15 MB of packed K+V per call at B=8, Kp=1792
// (8 * 1792 * 512 bytes per tensor), 48 calls per decode step. Design: one
// block per (b, h) reads only its head's D nibbles (D bytes, one nibble
// each, since H is even) of each key row; pass 1 (thread per key, 4-byte
// loads) writes the scores to
// shared memory and finds the max, pass 2 turns them into bf16-rounded
// p * vs and sums l, pass 3 splits the D output columns over the threads
// and accumulates p * v down the keys (coalesced row reads).

#include <cstdint>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;

__device__ __forceinline__ float block_reduce(float v, float* red, bool is_max) {
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) {
    float other = __shfl_xor_sync(0xffffffffu, v, o);
    v = is_max ? fmaxf(v, other) : v + other;
  }
  if (lane == 0) red[warp] = v;
  __syncthreads();
  float r = red[0];
  for (int w = 1; w < kThreads / 32; ++w)
    r = is_max ? fmaxf(r, red[w]) : r + red[w];
  __syncthreads();
  return r;
}

__device__ __forceinline__ float nibble(uint32_t byte_val, int shift) {
  const int n = (int)((byte_val >> shift) & 15u);
  return (float)((n ^ 8) - 8);
}

__global__ void __launch_bounds__(kThreads)
decode_int4_kernel(const __nv_bfloat16* __restrict__ q,
                   const uint8_t* __restrict__ kq,
                   const __nv_bfloat16* __restrict__ ks,
                   const uint8_t* __restrict__ vq,
                   const __nv_bfloat16* __restrict__ vs,
                   const float* __restrict__ bias, int H, int D, int K,
                   int bias_bstride, int bias_hstride, int out_bf16,
                   void* __restrict__ out) {
  extern __shared__ float smem[];
  float* q_s = smem;                 // [D]
  float* red = q_s + D;              // [kThreads / 32]
  float* part = red + kThreads / 32; // [kThreads]
  float* s_s = part + kThreads;      // [K]

  const int bh = blockIdx.x;
  const int b = bh / H;
  const int h = bh % H;
  const int tid = threadIdx.x;
  const int half = H * D / 2;
  const int e0 = h * D;              // first element of this head's slice
  const int shift = e0 >= half ? 4 : 0;
  const int byte0 = e0 % half;       // D | half, so the slice shares a nibble

  for (int d = tid; d < D; d += kThreads)
    q_s[d] = __bfloat162float(q[(size_t)bh * D + d]);
  __syncthreads();

  const float* brow = bias + (size_t)b * bias_bstride + (size_t)h * bias_hstride;
  const __nv_bfloat16* ks_row = ks + (size_t)bh * K;
  const __nv_bfloat16* vs_row = vs + (size_t)bh * K;

  // pass 1: scores
  float lmax = -INFINITY;
  for (int k = tid; k < K; k += kThreads) {
    const uint8_t* row = kq + ((size_t)b * K + k) * half + byte0;
    float dot = 0.f;
    for (int d = 0; d < D; d += 4) {
      const uint32_t w = *reinterpret_cast<const uint32_t*>(row + d);
#pragma unroll
      for (int e = 0; e < 4; ++e)
        dot = fmaf(q_s[d + e], nibble((w >> (8 * e)) & 0xffu, shift), dot);
    }
    const float s = __fadd_rn(__fmul_rn(dot, __bfloat162float(ks_row[k])),
                              brow[k]);
    s_s[k] = s;
    lmax = fmaxf(lmax, s);
  }
  const float m = block_reduce(lmax, red, true);

  // pass 2: p, l and the bf16-rounded p * vs
  float lsum = 0.f;
  for (int k = tid; k < K; k += kThreads) {
    const float p = expf(s_s[k] - m);
    lsum += p;
    s_s[k] = __bfloat162float(
        __float2bfloat16_rn(__fmul_rn(p, __bfloat162float(vs_row[k]))));
  }
  const float l = block_reduce(lsum, red, false);

  // pass 3: out[d] = sum_k pv_k * v[k, d]
  const int groups = kThreads / D;
  const int d = tid % D;
  const int g = tid / D;
  float acc = 0.f;
  if (g < groups) {
    const uint8_t* col = vq + (size_t)b * K * half + byte0 + d;
    for (int k = g; k < K; k += groups)
      acc = fmaf(s_s[k], nibble(col[(size_t)k * half], shift), acc);
  }
  part[tid] = acc;
  __syncthreads();
  if (tid < D) {
    float o = 0.f;
    for (int gg = 0; gg < groups; ++gg) o += part[gg * D + tid];
    const __nv_bfloat16 ob = __float2bfloat16_rn(__fdiv_rn(o, fmaxf(l, 1e-30f)));
    if (out_bf16)
      reinterpret_cast<__nv_bfloat16*>(out)[(size_t)bh * D + tid] = ob;
    else
      reinterpret_cast<float*>(out)[(size_t)bh * D + tid] = __bfloat162float(ob);
  }
}

}  // namespace

extern "C" int mg_decode_int4(const void* q, const uint8_t* kq, const void* ks,
                              const uint8_t* vq, const void* vs,
                              const float* bias, int B, int H, int D, int K,
                              int bias_bstride, int bias_hstride, int out_bf16,
                              void* out, void* stream) {
  if (D % 4 != 0 || D > kThreads || kThreads % D != 0 || H % 2 != 0)
    return (int)cudaErrorInvalidValue;
  const size_t smem = (size_t)(D + kThreads / 32 + kThreads + K) * sizeof(float);
  if (smem > 48 * 1024) return (int)cudaErrorInvalidValue;
  decode_int4_kernel<<<B * H, kThreads, smem, (cudaStream_t)stream>>>(
      (const __nv_bfloat16*)q, kq, (const __nv_bfloat16*)ks, vq,
      (const __nv_bfloat16*)vs, bias, H, D, K, bias_bstride, bias_hstride,
      out_bf16, out);
  return (int)cudaGetLastError();
}
