// Q=1 decode attention over int4-nibble K/V, for every decode-step
// attention under the int4 KV scheme (cross over the packed encoder slab,
// self over the ring, and the beam cross with the beams folded into the
// query rows).
//
// Replaces markushgrapher_tpu/ops/mxu_decode.py:cross_decode_mxu_int4 in its
// separate-K/V mode with its head_map option. For batch row b, query row r,
// kv column block g = head_map[r] (default grouped, r / (R / G)), key k:
//   s_k = (q_bf16 . k_k[g]) * ks[b, r or g, k] + bias[b?, r?, k]
//   p_k = exp(s_k - max s);  l = sum p_k
//   out = bf16( sum_k bf16(p_k * vs[b, r or g, k]) * v_k[g] / l )
// keeping the TPU kernel's rounding points (q, p*vs and the output in bf16)
// so that greedy tokens match. No 1/sqrt(d) scaling (T5). The options
// row_map and the valid prefix, and the online softmax over blocks of
// block_k keys, are those of decode_i8.cu: key k of output row b is read,
// nibbles and scales, from physical row row_map[b, k / block_k], and the key
// loops stop at `live`.
//
// Layout (pack_int4, column split): element e of the G*D row is the low
// nibble of byte e if e < G*D/2, else the high nibble of byte e - G*D/2;
// sign-extended with (n ^ 8) - 8.
//
// Bound: reading the slab, ~15 MB of packed K+V per call at B=8, Kp=1792
// (8 * 1792 * 512 bytes per tensor), 48 calls per decode step; a ring
// reads its live keys only. Design: one block per (b, r) reads only its
// block's D nibbles (D bytes, one nibble each) of each key row; pass 1
// (thread per key, 4-byte loads) writes the scores to shared memory, pass 2
// finds the running max of each key block and turns the scores into
// bf16-rounded p * vs and l, pass 3 splits the D output columns over the
// threads and accumulates p * v down the keys (coalesced row reads).
//
// Odd G (the OCR LM: 5 kv heads of D = 64, a 160-byte row): a block's slice
// [g*D, g*D + D) can straddle the split at G*D/2 (head 2: elements 128..191).
// Its first `split` elements are low nibbles of bytes g*D.., the rest high
// nibbles of bytes from 0; pass 1 reads the two runs in turn (split is a
// multiple of 4 when G*D/2 is), pass 3 picks each column's byte and nibble.
// With G even every slice lies in one half and the arithmetic is unchanged.

#include <cstdint>

#include "decode_common.cuh"

namespace {

using namespace mg_decode;

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
                   const float* __restrict__ bias,
                   const int* __restrict__ head_map,
                   const int* __restrict__ row_map, int R, int G, int D,
                   int K, int scale_rows, int bias_bstride, int bias_rstride,
                   int block_k, int live, int out_bf16,
                   void* __restrict__ out) {
  extern __shared__ float smem[];
  const Smem m = carve(smem, D, live, block_k);

  const int bh = blockIdx.x;
  const int b = bh / R;
  const int r = bh % R;
  const int g = head_map != nullptr ? head_map[r] : r / (R / G);
  const int srow = scale_rows == R ? r : g;
  const int tid = threadIdx.x;
  const int nkb = K / block_k;
  const int half = G * D / 2;
  const int e0 = g * D;              // first element of this block's slice
  // elements [0, split) of the slice are low nibbles of bytes e0 + d, the
  // rest high nibbles of bytes e0 + d - half
  const int split = min(max(half - e0, 0), D);
  const int lo0 = e0;
  const int hi0 = e0 + split - half;

  for (int d = tid; d < D; d += kThreads)
    m.q[d] = __bfloat162float(q[(size_t)bh * D + d]);
  __syncthreads();

  const float* brow = bias + (size_t)b * bias_bstride + (size_t)r * bias_rstride;
  // key k of physical row p: packed row at (p * K + k) * half, scales at
  // (p * scale_rows + srow) * K + k
  auto scale_off = [&](int k) {
    return ((size_t)phys_row(row_map, b, k, block_k, nkb) * scale_rows +
            srow) * K + k;
  };
  auto row_off = [&](int k) {
    return ((size_t)phys_row(row_map, b, k, block_k, nkb) * K + k) * half;
  };

  // pass 1: scores of the live keys
  float lmax = -INFINITY;
  for (int k = tid; k < live; k += kThreads) {
    const uint8_t* row = kq + row_off(k);
    float dot = 0.f;
    for (int d = 0; d < split; d += 4) {
      const uint32_t w = *reinterpret_cast<const uint32_t*>(row + lo0 + d);
#pragma unroll
      for (int e = 0; e < 4; ++e)
        dot = fmaf(m.q[d + e], nibble((w >> (8 * e)) & 0xffu, 0), dot);
    }
    for (int d = split; d < D; d += 4) {
      const uint32_t w =
          *reinterpret_cast<const uint32_t*>(row + hi0 + (d - split));
#pragma unroll
      for (int e = 0; e < 4; ++e)
        dot = fmaf(m.q[d + e], nibble((w >> (8 * e)) & 0xffu, 4), dot);
    }
    const float s = __fadd_rn(
        __fmul_rn(dot, __bfloat162float(ks[scale_off(k)])), brow[k]);
    m.s[k] = s;
    lmax = fmaxf(lmax, s);
  }

  // pass 2: p, l and the bf16-rounded p * vs, block by block
  const float l = softmax_pv(m, lmax, live, block_k,
                             [&](int k) { return vs[scale_off(k)]; });

  // pass 3: out[d] = sum_k pv_k * v[k, d]
  const int groups = kThreads / D;
  const int c = tid % D;
  const int col = c < split ? lo0 + c : hi0 + (c - split);
  const int shift = c < split ? 0 : 4;
  float acc = 0.f;
  for (int k = tid / D; k < live; k += groups)
    acc = fmaf(m.s[k], nibble(vq[row_off(k) + col], shift), acc);
  store_out(m, acc, l, D, bh, out_bf16, out);
}

}  // namespace

extern "C" int mg_decode_int4(const void* q, const uint8_t* kq, const void* ks,
                              const uint8_t* vq, const void* vs,
                              const float* bias, const int* head_map,
                              const int* row_map, int B, int R, int G, int D,
                              int K, int scale_rows, int bias_bstride,
                              int bias_rstride, int block_k, int live,
                              int out_bf16, void* out, void* stream) {
  // 4-byte loads of every row: the packed row G*D/2 is a multiple of 4
  if ((G * D) % 8 != 0 ||
      bad_shape(R, G, D, K, scale_rows, head_map, block_k, live))
    return (int)cudaErrorInvalidValue;
  decode_int4_kernel<<<B * R, kThreads,
                       smem_bytes(D, live, blocks_of(live, block_k)),
                       (cudaStream_t)stream>>>(
      (const __nv_bfloat16*)q, kq, (const __nv_bfloat16*)ks, vq,
      (const __nv_bfloat16*)vs, bias, head_map, row_map, R, G, D, K,
      scale_rows, bias_bstride, bias_rstride, block_k, live, out_bf16, out);
  return (int)cudaGetLastError();
}
