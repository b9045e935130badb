// Q=1 decode attention over int8 K/V, for every decode-step attention under
// the int8 KV scheme: self over the ring, cross over the encoder slab, and
// the beam cross with all beams folded into the query rows.
//
// Replaces markushgrapher_tpu/ops/mxu_decode.py:cross_decode_mxu. For batch
// row b, query row r, kv column block g = head_map[r] (default grouped,
// r / (R / G)) and key k:
//   s_k = (q_bf16 . k[b, k, g*D : g*D+D]) * ks[b, r or g, k] + bias[b?, r?, k]
//   p_k = exp(s_k - max s);  l = sum p_k
//   out = bf16( sum_k bf16(p_k * vs[b, r or g, k]) * v[b, k, g*D + d] / l )
// keeping the TPU kernel's rounding points (q, p*vs and the output in bf16;
// scores and the sum in f32). No 1/sqrt(d) scaling (T5). Scales are f32,
// one row per query row ([B, R, K]) or per kv block ([B, G, K]).
//
// Bound: reading the K/V bytes, 2 * B * K * G*D int8 plus the f32 scales
// (31 MB per cross call at B=8, Kp=1792, G*D=1024). Design (simple first):
// one block per (b, r) reads only its block's D contiguous int8 bytes of
// each key row, in 16-byte loads when D and the row stride allow; pass 1
// (thread per key) writes the scores to shared memory and finds the max,
// pass 2 turns them into bf16-rounded p * vs and sums l, pass 3 splits the D
// output columns over the threads and accumulates p * v down the keys. The
// beams of one sample read the same slab columns, so the repeats hit L2.
// The self ring's unwritten tail has zero values and zero scales; its score
// is the finite causal bias (float32's lowest), so p = 0 there and nothing
// is NaN.

#include <cstdint>

#include "decode_common.cuh"

namespace {

using namespace mg_decode;

// byte e (0..3) of w, sign-extended
__device__ __forceinline__ float sbyte(uint32_t w, int e) {
  return (float)(((int)(w << (24 - 8 * e))) >> 24);
}

__device__ __forceinline__ float dot_word(uint32_t w, const float* q) {
  float acc = 0.f;
#pragma unroll
  for (int e = 0; e < 4; ++e) acc = fmaf(q[e], sbyte(w, e), acc);
  return acc;
}

template <bool kVec16>
__global__ void __launch_bounds__(kThreads)
decode_i8_kernel(const __nv_bfloat16* __restrict__ q,
                 const int8_t* __restrict__ kq, const float* __restrict__ ks,
                 const int8_t* __restrict__ vq, const float* __restrict__ vs,
                 const float* __restrict__ bias,
                 const int* __restrict__ head_map, int R, int G, int D, int K,
                 int scale_rows, int bias_bstride, int bias_rstride,
                 int out_bf16, void* __restrict__ out) {
  extern __shared__ float smem[];
  const Smem m = carve(smem, D);

  const int br = blockIdx.x;
  const int b = br / R;
  const int r = br % R;
  const int g = head_map != nullptr ? head_map[r] : r / (R / G);
  const int srow = scale_rows == R ? r : g;
  const int tid = threadIdx.x;
  const size_t row_stride = (size_t)G * D;

  for (int d = tid; d < D; d += kThreads)
    m.q[d] = __bfloat162float(q[(size_t)br * D + d]);
  __syncthreads();

  const float* brow = bias + (size_t)b * bias_bstride + (size_t)r * bias_rstride;
  const float* ks_row = ks + ((size_t)b * scale_rows + srow) * K;
  const float* vs_row = vs + ((size_t)b * scale_rows + srow) * K;
  const int8_t* kbase = kq + (size_t)b * K * row_stride + (size_t)g * D;

  // pass 1: scores
  float lmax = -INFINITY;
  for (int k = tid; k < K; k += kThreads) {
    const int8_t* row = kbase + (size_t)k * row_stride;
    float dot = 0.f;
    if (kVec16) {
      for (int d = 0; d < D; d += 16) {
        const uint4 w = *reinterpret_cast<const uint4*>(row + d);
        dot += dot_word(w.x, m.q + d) + dot_word(w.y, m.q + d + 4) +
               dot_word(w.z, m.q + d + 8) + dot_word(w.w, m.q + d + 12);
      }
    } else {
      for (int d = 0; d < D; d += 4)
        dot += dot_word(*reinterpret_cast<const uint32_t*>(row + d), m.q + d);
    }
    const float s = __fadd_rn(__fmul_rn(dot, ks_row[k]), brow[k]);
    m.s[k] = s;
    lmax = fmaxf(lmax, s);
  }

  // pass 2: p, l and the bf16-rounded p * vs
  const float l = softmax_pv(m, lmax, vs_row, K);

  // pass 3: out[d] = sum_k pv_k * v[k, g*D + d]
  const int groups = kThreads / D;
  const int8_t* col = vq + (size_t)b * K * row_stride + (size_t)g * D + tid % D;
  float acc = 0.f;
  for (int k = tid / D; k < K; k += groups)
    acc = fmaf(m.s[k], (float)col[(size_t)k * row_stride], acc);
  store_out(m, acc, l, D, br, out_bf16, out);
}

}  // namespace

extern "C" int mg_decode_i8(const void* q, const int8_t* kq, const float* ks,
                            const int8_t* vq, const float* vs,
                            const float* bias, const int* head_map, int B,
                            int R, int G, int D, int K, int scale_rows,
                            int bias_bstride, int bias_rstride, int out_bf16,
                            void* out, void* stream) {
  if (bad_shape(R, G, D, K, scale_rows, head_map))
    return (int)cudaErrorInvalidValue;
  const size_t smem = smem_bytes(D, K);
  const bool vec16 = D % 16 == 0 && ((size_t)G * D) % 16 == 0 &&
                     reinterpret_cast<uintptr_t>(kq) % 16 == 0;
  if (vec16)
    decode_i8_kernel<true><<<B * R, kThreads, smem, (cudaStream_t)stream>>>(
        (const __nv_bfloat16*)q, kq, ks, vq, vs, bias, head_map, R, G, D, K,
        scale_rows, bias_bstride, bias_rstride, out_bf16, out);
  else
    decode_i8_kernel<false><<<B * R, kThreads, smem, (cudaStream_t)stream>>>(
        (const __nv_bfloat16*)q, kq, ks, vq, vs, bias, head_map, R, G, D, K,
        scale_rows, bias_bstride, bias_rstride, out_bf16, out);
  return (int)cudaGetLastError();
}
