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
// one row per query row ([rows, R, K]) or per kv block ([rows, G, K]).
// The TPU kernel's options: row_map (key block k / block_k of output row b
// is read, values and scales, from physical row row_map[b, k / block_k]:
// beam search's copy-on-write rings) and the valid prefix (its block_map,
// whose one producer redirects the blocks past the decode index: here the
// key loops stop at `live`); with block_k < live the softmax runs online
// over blocks of block_k keys as the TPU kernel's K grid does
// (decode_common.cuh).
//
// Bound: reading the live keys' K/V bytes, 2 * B * live * G*D int8 plus
// the f32 scales (31 MB per cross call at B=8, Kp=1792, G*D=1024).
// Design (simple first): one block per (b, r) reads only its block's D
// contiguous int8 bytes of each live key row, in 16-byte loads when D and
// the row stride allow; pass 1 (thread per key) writes the scores to shared
// memory, pass 2 finds the running max of each key block and turns the
// scores into bf16-rounded p * vs and l, pass 3 splits the D output columns
// over the threads and accumulates p * v down the keys. The row map is read
// once per key in passes 1 and 3 (it stays in L1). The
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
                 const int* __restrict__ head_map,
                 const int* __restrict__ row_map, int R, int G, int D, int K,
                 int scale_rows, int bias_bstride, int bias_rstride,
                 int block_k, int live, int out_bf16, void* __restrict__ out) {
  extern __shared__ float smem[];
  const Smem m = carve(smem, D, live, block_k);

  const int br = blockIdx.x;
  const int b = br / R;
  const int r = br % R;
  const int g = head_map != nullptr ? head_map[r] : r / (R / G);
  const int srow = scale_rows == R ? r : g;
  const int tid = threadIdx.x;
  const int nkb = K / block_k;
  const size_t row_stride = (size_t)G * D;

  for (int d = tid; d < D; d += kThreads)
    m.q[d] = __bfloat162float(q[(size_t)br * D + d]);
  __syncthreads();

  const float* brow = bias + (size_t)b * bias_bstride + (size_t)r * bias_rstride;
  // key k of physical row p: values at p * K + k, scales at (p * scale_rows
  // + srow) * K + k
  auto scale_off = [&](int k) {
    return ((size_t)phys_row(row_map, b, k, block_k, nkb) * scale_rows +
            srow) * K + k;
  };
  auto key_off = [&](int k) {
    return ((size_t)phys_row(row_map, b, k, block_k, nkb) * K + k) *
           row_stride + (size_t)g * D;
  };

  // pass 1: scores of the live keys
  float lmax = -INFINITY;
  for (int k = tid; k < live; k += kThreads) {
    const int8_t* row = kq + key_off(k);
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
    const float s = __fadd_rn(__fmul_rn(dot, ks[scale_off(k)]), brow[k]);
    m.s[k] = s;
    lmax = fmaxf(lmax, s);
  }

  // pass 2: p, l and the bf16-rounded p * vs, block by block
  const float l = softmax_pv(m, lmax, live, block_k,
                             [&](int k) { return vs[scale_off(k)]; });

  // pass 3: out[d] = sum_k pv_k * v[k, g*D + d]
  const int groups = kThreads / D;
  const int c = tid % D;
  float acc = 0.f;
  for (int k = tid / D; k < live; k += groups)
    acc = fmaf(m.s[k], (float)vq[key_off(k) + c], acc);
  store_out(m, acc, l, D, br, out_bf16, out);
}

}  // namespace

extern "C" int mg_decode_i8(const void* q, const int8_t* kq, const float* ks,
                            const int8_t* vq, const float* vs,
                            const float* bias, const int* head_map,
                            const int* row_map, int B, int R, int G, int D,
                            int K, int scale_rows, int bias_bstride,
                            int bias_rstride, int block_k, int live,
                            int out_bf16, void* out, void* stream) {
  if (bad_shape(R, G, D, K, scale_rows, head_map, block_k, live))
    return (int)cudaErrorInvalidValue;
  const size_t smem = smem_bytes(D, live, blocks_of(live, block_k));
  const bool vec16 = D % 16 == 0 && ((size_t)G * D) % 16 == 0 &&
                     reinterpret_cast<uintptr_t>(kq) % 16 == 0;
  if (vec16)
    decode_i8_kernel<true><<<B * R, kThreads, smem, (cudaStream_t)stream>>>(
        (const __nv_bfloat16*)q, kq, ks, vq, vs, bias, head_map, row_map, R,
        G, D, K, scale_rows, bias_bstride, bias_rstride, block_k, live,
        out_bf16, out);
  else
    decode_i8_kernel<false><<<B * R, kThreads, smem, (cudaStream_t)stream>>>(
        (const __nv_bfloat16*)q, kq, ks, vq, vs, bias, head_map, row_map, R,
        G, D, K, scale_rows, bias_bstride, bias_rstride, block_k, live,
        out_bf16, out);
  return (int)cudaGetLastError();
}
