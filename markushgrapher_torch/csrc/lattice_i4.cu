// Beam self-attention over packed int4 rings read segment by segment
// through a row map, the dead segments never read.
//
// Replaces markushgrapher_tpu/ops/mxu_decode.py:lattice_self_int4. For
// output row b, query row r (kv column block g = r / (R / G)) and the first
// n_live segments of seg keys, segment s read from physical row
// p = row_map[b, s]:
//   s_k = (q_bf16 . k[p, k][g]) * ks[p, r or g, k] + bias[b?, r?, k]
// with the online softmax across segments: m_new = max(m, max_seg s),
// alpha = exp(m - m_new), p_k = exp(s_k - m_new), l = l * alpha + sum p_k,
// acc = acc * alpha + sum_k bf16(p_k * vs[p, r or g, k]) * v[p, k][g];
// out = bf16(acc / l). m starts at -1e30, as the TPU kernel's. The same
// function as decode_int4.cu with row_map and block_k = seg, whose dead
// segments the causal bias zeroes. No 1/sqrt(d) scaling (T5).
//
// Layout (pack_int4, column split): element e of the G*D row is the low
// nibble of byte e if e < G*D/2, else the high nibble of byte e - G*D/2.
// With G even a head's D elements are D contiguous bytes of one half.
//
// Bound: reading the live segments' bytes, 2 * rows * n_live * seg * G*D/2
// packed K/V plus the bf16 scales (2.6 MB per call at 40 rows, 4 live
// segments of 128, G*D = 1024). What the TPU design is for: the indirection
// costs one copy per segment, issued ahead, instead of a gathered ring. Here
// one block per (b, r) copies segment s+1's D nibble bytes per key of K and
// V and its scales into shared memory with cp.async while segment s
// computes (two buffers), then: scores with a thread per key, the segment
// max, p and the bf16-rounded p * vs, and the D output columns split over
// the threads (column partials rescaled by alpha per segment). K rows in
// shared memory are padded by 16 bytes against bank conflicts.

#include <cstdint>

#include "decode_common.cuh"

namespace {

using mg_decode::block_reduce;
using mg_decode::kNegInf;
using mg_decode::kThreads;

__device__ __forceinline__ float nibble(uint32_t byte_val, int shift) {
  const int n = (int)((byte_val >> shift) & 15u);
  return (float)((n ^ 8) - 8);
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s),
               "l"(src));
}

__device__ __forceinline__ void cp_async4(void* dst, const void* src) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(s),
               "l"(src));
}

__device__ __forceinline__ void cp_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

template <int N>
__device__ __forceinline__ void cp_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

struct Buffers {
  uint8_t* k[2];          // [seg][pitch] nibble bytes of this head
  uint8_t* v[2];
  __nv_bfloat16* ks[2];   // [seg]
  __nv_bfloat16* vs[2];
  float* q;               // [D]
  float* red;             // [kThreads / 32]
  float* part;            // [kThreads]
  float* s;               // [seg]
};

inline size_t smem_bytes(int seg, int D) {
  const int pitch = D + 16;
  return 2 * (2 * (size_t)seg * pitch + 2 * (size_t)seg * 2) +
         sizeof(float) * (D + kThreads / 32 + kThreads + seg);
}

__global__ void __launch_bounds__(kThreads)
lattice_i4_kernel(const __nv_bfloat16* __restrict__ q,
                  const uint8_t* __restrict__ kq,
                  const __nv_bfloat16* __restrict__ ks,
                  const uint8_t* __restrict__ vq,
                  const __nv_bfloat16* __restrict__ vs,
                  const float* __restrict__ bias,
                  const int* __restrict__ row_map, int R, int G, int D, int L,
                  int scale_rows, int bias_bstride, int bias_rstride, int seg,
                  int n_live, int out_bf16, void* __restrict__ out) {
  extern __shared__ __align__(16) uint8_t smem[];
  const int pitch = D + 16;
  Buffers m;
  uint8_t* p = smem;
  for (int i = 0; i < 2; ++i) {
    m.k[i] = p;
    p += (size_t)seg * pitch;
    m.v[i] = p;
    p += (size_t)seg * pitch;
  }
  for (int i = 0; i < 2; ++i) {
    m.ks[i] = reinterpret_cast<__nv_bfloat16*>(p);
    p += (size_t)seg * 2;
    m.vs[i] = reinterpret_cast<__nv_bfloat16*>(p);
    p += (size_t)seg * 2;
  }
  m.q = reinterpret_cast<float*>(p);
  m.red = m.q + D;
  m.part = m.red + kThreads / 32;
  m.s = m.part + kThreads;

  const int bh = blockIdx.x;
  const int b = bh / R;
  const int r = bh % R;
  const int g = r / (R / G);
  const int srow = scale_rows == R ? r : g;
  const int tid = threadIdx.x;
  const int half = G * D / 2;
  // this head's D elements: bytes [off, off + D) of the packed row, low
  // nibbles in the first half of the columns, high nibbles in the second
  const int off = g * D < half ? g * D : g * D - half;
  const int shift = g * D < half ? 0 : 4;
  const int n_seg = L / seg;
  const int chunks = D / 16;

  // start the copies of segment s into buffer `slot`
  auto issue = [&](int s, int slot) {
    const size_t prow = (size_t)row_map[(size_t)b * n_seg + s];
    const size_t key0 = prow * L + (size_t)s * seg;
    for (int i = tid; i < seg * chunks; i += kThreads) {
      const int k = i / chunks;
      const int c = (i % chunks) * 16;
      const size_t src = (key0 + k) * half + off + c;
      cp_async16(m.k[slot] + k * pitch + c, kq + src);
      cp_async16(m.v[slot] + k * pitch + c, vq + src);
    }
    const size_t sc0 = (prow * scale_rows + srow) * L + (size_t)s * seg;
    for (int i = tid; i < seg / 2; i += kThreads) {
      cp_async4(m.ks[slot] + 2 * i, ks + sc0 + 2 * i);
      cp_async4(m.vs[slot] + 2 * i, vs + sc0 + 2 * i);
    }
    cp_commit();
  };

  issue(0, 0);  // segment 0 is always live
  for (int d = tid; d < D; d += kThreads)
    m.q[d] = __bfloat162float(q[(size_t)bh * D + d]);

  const float* brow = bias + (size_t)b * bias_bstride + (size_t)r * bias_rstride;
  const int groups = kThreads / D;
  const int c = tid % D;
  float run_m = kNegInf, run_l = 0.f, acc = 0.f;

  for (int s = 0; s < n_live; ++s) {
    const int slot = s & 1;
    if (s + 1 < n_live) {
      issue(s + 1, slot ^ 1);
      cp_wait<1>();
    } else {
      cp_wait<0>();
    }
    __syncthreads();

    // scores of the segment's keys
    float lmax = -INFINITY;
    for (int k = tid; k < seg; k += kThreads) {
      const uint8_t* row = m.k[slot] + k * pitch;
      float dot = 0.f;
      for (int d = 0; d < D; d += 4) {
        const uint32_t w = *reinterpret_cast<const uint32_t*>(row + d);
#pragma unroll
        for (int e = 0; e < 4; ++e)
          dot = fmaf(m.q[d + e], nibble((w >> (8 * e)) & 0xffu, shift), dot);
      }
      const float sc = __fadd_rn(
          __fmul_rn(dot, __bfloat162float(m.ks[slot][k])),
          brow[(size_t)s * seg + k]);
      m.s[k] = sc;
      lmax = fmaxf(lmax, sc);
    }
    const float m_new = fmaxf(run_m, block_reduce(lmax, m.red, true));
    const float alpha = expf(run_m - m_new);

    // p, its sum and the bf16-rounded p * vs
    float lsum = 0.f;
    for (int k = tid; k < seg; k += kThreads) {
      const float pk = expf(m.s[k] - m_new);
      lsum += pk;
      m.s[k] = __bfloat162float(__float2bfloat16_rn(
          __fmul_rn(pk, __bfloat162float(m.vs[slot][k]))));
    }
    run_l = fmaf(run_l, alpha, block_reduce(lsum, m.red, false));
    run_m = m_new;

    // this thread's partial of column c over keys tid / D, + groups, ...
    float o = 0.f;
    for (int k = tid / D; k < seg; k += groups)
      o = fmaf(m.s[k], nibble(m.v[slot][k * pitch + c], shift), o);
    acc = fmaf(acc, alpha, o);
    __syncthreads();  // the buffer is refilled two segments on
  }

  m.part[tid] = acc;
  __syncthreads();
  if (tid < D) {
    float o = 0.f;
    for (int gg = 0; gg < groups; ++gg) o += m.part[gg * D + tid];
    const __nv_bfloat16 ob =
        __float2bfloat16_rn(__fdiv_rn(o, fmaxf(run_l, 1e-30f)));
    if (out_bf16)
      reinterpret_cast<__nv_bfloat16*>(out)[(size_t)bh * D + tid] = ob;
    else
      reinterpret_cast<float*>(out)[(size_t)bh * D + tid] =
          __bfloat162float(ob);
  }
}

}  // namespace

extern "C" int mg_lattice_i4(const void* q, const uint8_t* kq, const void* ks,
                             const uint8_t* vq, const void* vs,
                             const float* bias, const int* row_map, int B,
                             int R, int G, int D, int L, int scale_rows,
                             int bias_bstride, int bias_rstride, int seg,
                             int n_live, int out_bf16, void* out,
                             void* stream) {
  // 16-byte copies of one head's bytes (D a multiple of 16, no head across
  // the column split: G even), 4-byte copies of the scales (seg, L even)
  const int half = G * D / 2;
  if (D % 16 != 0 || D > kThreads || kThreads % D != 0 || R <= 0 || G <= 0 ||
      R % G != 0 || half % D != 0 || half % 16 != 0 ||
      (scale_rows != R && scale_rows != G) || seg <= 0 || seg % 2 != 0 ||
      L % seg != 0 || L % 2 != 0 || n_live <= 0 || n_live > L / seg ||
      reinterpret_cast<uintptr_t>(kq) % 16 != 0 ||
      reinterpret_cast<uintptr_t>(vq) % 16 != 0 ||
      reinterpret_cast<uintptr_t>(ks) % 4 != 0 ||
      reinterpret_cast<uintptr_t>(vs) % 4 != 0)
    return (int)cudaErrorInvalidValue;
  const size_t smem = smem_bytes(seg, D);
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        lattice_i4_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  lattice_i4_kernel<<<B * R, kThreads, smem, (cudaStream_t)stream>>>(
      (const __nv_bfloat16*)q, kq, (const __nv_bfloat16*)ks, vq,
      (const __nv_bfloat16*)vs, bias, row_map, R, G, D, L, scale_rows,
      bias_bstride, bias_rstride, seg, n_live, out_bf16, out);
  return (int)cudaGetLastError();
}
