// The parts of the Q=1 decode attention kernels (decode_i8.cu,
// decode_int4.cu) that do not depend on how K/V are stored: the shared
// memory layout of one block, the block reductions, the physical row of a
// key under a row map, the running maxima of the key blocks, pass 2
// (softmax weights rounded as the TPU kernel rounds them) and the end of
// pass 3 (the column partials summed, divided by l and stored).
//
// The online softmax of the TPU kernel's K grid, over blocks of block_k
// keys: after block j the running max is M_j = max(M_{j-1}, max_j s) (M_{-1}
// = -1e30, the TPU kernel's initial m), its weights are p_k = exp(s_k - M_j)
// and bf16(p_k * vs_k), and acc and l are rescaled by exp(M_{j-1} - M_j) at
// each later block. Both are linear in the weights, so the kernels scale
// each block once by c_j = exp(M_j - M_last) instead: the same terms,
// rounded at the same points, up to float32 rounding of the scale. One
// block (block_k = live, the whole-slab read) is the two-pass softmax
// against the global max M_0, with no block scales.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace mg_decode {

constexpr int kThreads = 256;
constexpr float kNegInf = -1e30f;

// dynamic shared memory of one block: q [D] + warp partials + column
// partials + the live keys' scores + the running max and scale of each key
// block, all f32, within the default 48 KB
inline size_t smem_bytes(int D, int live, int n_blocks) {
  return (size_t)(D + kThreads / 32 + kThreads + live + 2 * n_blocks) *
         sizeof(float);
}

__host__ __device__ inline int blocks_of(int live, int block_k) {
  return (live + block_k - 1) / block_k;
}

// the launch arguments both kernels refuse
inline bool bad_shape(int R, int G, int D, int K, int scale_rows,
                      const int* head_map, int block_k, int live) {
  return D % 4 != 0 || D > kThreads || kThreads % D != 0 || R <= 0 ||
         G <= 0 || (head_map == nullptr && R % G != 0) ||
         (scale_rows != R && scale_rows != G) || block_k <= 0 ||
         K % block_k != 0 || live <= 0 || live > K ||
         smem_bytes(D, live, blocks_of(live, block_k)) > 48 * 1024;
}

struct Smem {
  float* q;     // [D]
  float* red;   // [kThreads / 32]
  float* part;  // [kThreads]
  float* s;     // [live]
  float* bmax;  // [n_blocks]: running max after each key block
  float* bfac;  // [n_blocks]: exp(bmax - the last running max)
};

__device__ __forceinline__ Smem carve(float* smem, int D, int live,
                                     int block_k) {
  Smem m;
  m.q = smem;
  m.red = m.q + D;
  m.part = m.red + kThreads / 32;
  m.s = m.part + kThreads;
  m.bmax = m.s + live;
  m.bfac = m.bmax + blocks_of(live, block_k);
  return m;
}

// physical row of key k of output row b: row_map[b, k / block_k], or b
__device__ __forceinline__ int phys_row(const int* row_map, int b, int k,
                                        int block_k, int n_kblocks) {
  return row_map != nullptr ? row_map[(size_t)b * n_kblocks + k / block_k]
                            : b;
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

// after pass 1 left the live keys' scores in s: the running max after each
// key block (one warp per block, then a scan by one thread) and each
// block's scale c_j
__device__ __forceinline__ void block_maxima(const Smem& m, int live,
                                             int block_k) {
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int nb = blocks_of(live, block_k);
  __syncthreads();
  for (int j = warp; j < nb; j += kThreads / 32) {
    const int end = min(live, (j + 1) * block_k);
    float v = -INFINITY;
    for (int k = j * block_k + lane; k < end; k += 32) v = fmaxf(v, m.s[k]);
#pragma unroll
    for (int o = 16; o > 0; o >>= 1)
      v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
    if (lane == 0) m.bmax[j] = v;
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    float run = kNegInf;
    for (int j = 0; j < nb; ++j) {
      run = fmaxf(run, m.bmax[j]);
      m.bmax[j] = run;
    }
    for (int j = 0; j < nb; ++j) m.bfac[j] = expf(m.bmax[j] - run);
  }
  __syncthreads();
}

// pass 2: s_k becomes c_j * bf16(p_k * vs_k) with p_k = exp(s_k - M_j) for
// key k of block j; returns l = sum_j c_j * sum_{k in j} p_k. lmax is this
// thread's max over its pass-1 scores; vs_at(k) is key k's value scale.
// One block (the whole-slab read) takes the block max of the threads'
// maxima and no block scales.
template <class ScaleAt>
__device__ __forceinline__ float softmax_pv(const Smem& m, float lmax,
                                            int live, int block_k,
                                            ScaleAt vs_at) {
  float lsum = 0.f;
  if (blocks_of(live, block_k) == 1) {
    const float mx = fmaxf(kNegInf, block_reduce(lmax, m.red, true));
    for (int k = threadIdx.x; k < live; k += kThreads) {
      const float p = expf(m.s[k] - mx);
      lsum += p;
      m.s[k] = __bfloat162float(
          __float2bfloat16_rn(__fmul_rn(p, to_f32(vs_at(k)))));
    }
    return block_reduce(lsum, m.red, false);
  }
  block_maxima(m, live, block_k);
  for (int k = threadIdx.x; k < live; k += kThreads) {
    const int j = k / block_k;
    const float c = m.bfac[j];
    const float p = expf(m.s[k] - m.bmax[j]);
    lsum = fmaf(p, c, lsum);
    m.s[k] = __fmul_rn(
        __bfloat162float(__float2bfloat16_rn(__fmul_rn(p, to_f32(vs_at(k))))),
        c);
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
