// The parts of the Q=1 decode attention kernels (decode_i8.cu,
// decode_int4.cu) that do not depend on how K/V are stored: the shared
// memory layout of one block, the block reductions, pass 2 (softmax weights
// rounded as the TPU kernel rounds them) and the end of pass 3 (the column
// partials summed, divided by l and stored).

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace mg_decode {

constexpr int kThreads = 256;

// dynamic shared memory of one block: q [D] + warp partials + column
// partials + the K scores, all f32, within the default 48 KB
inline size_t smem_bytes(int D, int K) {
  return (size_t)(D + kThreads / 32 + kThreads + K) * sizeof(float);
}

// the launch arguments both kernels refuse
inline bool bad_shape(int R, int G, int D, int K, int scale_rows,
                      const int* head_map) {
  return D % 4 != 0 || D > kThreads || kThreads % D != 0 || R <= 0 ||
         G <= 0 || (head_map == nullptr && R % G != 0) ||
         (scale_rows != R && scale_rows != G) || smem_bytes(D, K) > 48 * 1024;
}

struct Smem {
  float* q;     // [D]
  float* red;   // [kThreads / 32]
  float* part;  // [kThreads]
  float* s;     // [K]
};

__device__ __forceinline__ Smem carve(float* smem, int D) {
  Smem m;
  m.q = smem;
  m.red = m.q + D;
  m.part = m.red + kThreads / 32;
  m.s = m.part + kThreads;
  return m;
}

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

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

// pass 2, after pass 1 left the scores in s and this thread's max in lmax:
// s_k becomes bf16(p_k * vs_k) with p_k = exp(s_k - max); returns l = sum p_k
template <class Scale>
__device__ __forceinline__ float softmax_pv(const Smem& m, float lmax,
                                            const Scale* vs_row, int K) {
  const float mx = block_reduce(lmax, m.red, true);
  float lsum = 0.f;
  for (int k = threadIdx.x; k < K; k += kThreads) {
    const float p = expf(m.s[k] - mx);
    lsum += p;
    m.s[k] = __bfloat162float(
        __float2bfloat16_rn(__fmul_rn(p, to_f32(vs_row[k]))));
  }
  return block_reduce(lsum, m.red, false);
}

// end of pass 3: acc is this thread's partial of output column tid % D;
// the partials are summed, divided by l, rounded to bf16 and stored at row
__device__ __forceinline__ void store_out(const Smem& m, float acc, float l,
                                          int D, size_t row, int out_bf16,
                                          void* out) {
  const int tid = threadIdx.x;
  m.part[tid] = acc;
  __syncthreads();
  if (tid < D) {
    float o = 0.f;
    for (int gg = 0; gg < kThreads / D; ++gg) o += m.part[gg * D + tid];
    const __nv_bfloat16 ob = __float2bfloat16_rn(__fdiv_rn(o, fmaxf(l, 1e-30f)));
    if (out_bf16)
      reinterpret_cast<__nv_bfloat16*>(out)[row * D + tid] = ob;
    else
      reinterpret_cast<float*>(out)[row * D + tid] = __bfloat162float(ob);
  }
}

}  // namespace mg_decode
