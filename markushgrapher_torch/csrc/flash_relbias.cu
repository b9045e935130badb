// Forward flash attention with the UDOP relative bias computed in the
// kernel, for the VTL encoder's in-kernel-bias serving route: no
// [B, H, L, L] bias slab exists.
//
// Replaces markushgrapher_tpu/ops/flash_relbias.py:flash_attention_relbias.
// T5 semantics: no 1/sqrt(d). For query i and key j of head h of sample b:
//   bias = (t1[b1] + th[bh]) + tv[bv], with
//   b1 the T5 bucket of j - i (max distance max1),
//   bh the bucket of trunc((hx[b, j] - hx[b, i]) * scaling) (max distance
//   max2), bv the same over vy;
//   s = q_i . k_j + (mask[b, j] ? bias : -1e30)
// softmax over j online in float32 from the finite start -1e30, output
// (sum_j p_j v_j) / max(l, 1e-30) in bf16, so a row whose keys are all
// masked averages them uniformly, as the TPU kernel does.
//
// Bound: at B=8, H=16, L=1536, D=64 the call moves only q, k, v and the
// output (~100 MB: ~0.03 ms at 3.35 TB/s) and does 77 GFLOP of products
// (~0.08 ms at the bf16 tensor rate): it is bound by operations, plus the
// bias arithmetic per score (two LUT reads, two table reads, a few float
// ops), which runs on the CUDA cores.
// Design: one block of four warps per (b*h, 64-query tile) on the WMMA
// helpers of flash_bias.cuh; QK^T and PV as bf16 WMMA products with float32
// accumulation, P entering PV as a bf16 hi + lo pair; two threads per query
// row run the online softmax over 32 keys each, with the bias of each
// score computed in registers instead of read from a slab. The head's three
// table columns and both bucket LUTs sit in shared memory; the key tile's
// centres and mask are staged there beside its K and V. The buckets come
// from lookup tables built on the CPU by the plain
// `relative_position_bucket` (distances clamped into +-max_distance, where
// buckets already saturate), and every float op of the bias uses an
// explicit round-to-nearest intrinsic, so the bias is bit-exact against the
// plain version's (relbias.centre_position_bias). No length has to be a
// multiple of the tile: ragged tiles are zero-filled and their keys
// excluded.

#include "flash_bias.cuh"

namespace fb {
namespace {

__global__ void __launch_bounds__(kThreads)
flash_relbias_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                     const bf16* __restrict__ v, const float* __restrict__ hx,
                     const float* __restrict__ vy,
                     const int* __restrict__ mask,
                     const float* __restrict__ tables,
                     const int* __restrict__ lut1,
                     const int* __restrict__ lut2, int L, int H, int nb,
                     int max1, int max2, float scaling,
                     bf16* __restrict__ out) {
  extern __shared__ __align__(128) unsigned char smem[];
  TileH* q_s = reinterpret_cast<TileH*>(smem);
  TileH* k_s = q_s + kT;
  TileH* v_s = k_s + kT;
  TileH* p_s = v_s + kT;   // P, high bf16 part
  TileH* p2_s = p_s + kT;  // P, low bf16 part
  TileF* s_f = reinterpret_cast<TileF*>(p2_s + kT);
  float* tab_s = reinterpret_cast<float*>(s_f + kT);  // [3][nb]: t1, th, tv
  float* hx_s = tab_s + 3 * nb;                        // the key tile's
  float* vy_s = hx_s + kT;                             // centres and mask
  int* mask_s = reinterpret_cast<int*>(vy_s + kT);
  int* lut1_s = mask_s + kT;                           // [2 * max1 + 1]
  int* lut2_s = lut1_s + 2 * max1 + 1;                 // [2 * max2 + 1]

  const int bh = blockIdx.y;
  const int b = bh / H;
  const int h = bh % H;
  const int q0 = blockIdx.x * kT;
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int r0 = warp * 16;
  const int row = r0 + lane / 2;   // this thread's query row in the tile
  const int c0 = (lane % 2) * 32;  // its 32 keys of a tile, and 32 of D
  const int i = q0 + row;
  const float* hrow = hx + (size_t)b * L;
  const float* vrow = vy + (size_t)b * L;
  const int* mrow = mask + (size_t)b * L;
  // rows at or past L compute on row L - 1 and are not stored
  const float hx_q = hrow[min(i, L - 1)];
  const float vy_q = vrow[min(i, L - 1)];

  // tables [3, nb, H] float32: this head's column of each
  for (int t = threadIdx.x; t < 3 * nb; t += kThreads)
    tab_s[t] = tables[(size_t)t * H + h];
  for (int t = threadIdx.x; t < 2 * max1 + 1; t += kThreads)
    lut1_s[t] = lut1[t];
  for (int t = threadIdx.x; t < 2 * max2 + 1; t += kThreads)
    lut2_s[t] = lut2[t];
  load_rows(q_s, q, b, h, q0, L, H);
  float acc[32];
#pragma unroll
  for (int d = 0; d < 32; ++d) acc[d] = 0.f;
  float m = kNegInf;
  float l = 0.f;
  FragC frag[4];
  const float lim = (float)max2;

  for (int k0 = 0; k0 < L; k0 += kT) {
    __syncthreads();  // tables / Q loaded; the previous tile's reads done
    load_rows(k_s, k, b, h, k0, L, H);
    load_rows(v_s, v, b, h, k0, L, H);
    for (int t = threadIdx.x; t < kT; t += kThreads) {
      const bool in = k0 + t < L;
      hx_s[t] = in ? hrow[k0 + t] : 0.f;
      vy_s[t] = in ? vrow[k0 + t] : 0.f;
      mask_s[t] = in ? mrow[k0 + t] : 0;
    }
    __syncthreads();
    zero(frag);
    mma_abt(frag, q_s, r0, k_s);
    store(s_f, r0, frag);
    __syncwarp();

    const int n = L - (k0 + c0);  // keys of this thread's 32 that exist
    float s[32];
    float tmax = kNegInf;
#pragma unroll
    for (int c = 0; c < 32; ++c) {
      const int kc = c0 + c;
      const int rel1 = min(max(k0 + kc - i, -max1), max1);
      // (c_j - c_i) * scaling in float32, then truncation toward zero
      const float dh = __fmul_rn(__fsub_rn(hx_s[kc], hx_q), scaling);
      const float dv = __fmul_rn(__fsub_rn(vy_s[kc], vy_q), scaling);
      int relh = __float2int_rz(fminf(fmaxf(dh, -lim - 1.f), lim + 1.f));
      int relv = __float2int_rz(fminf(fmaxf(dv, -lim - 1.f), lim + 1.f));
      relh = min(max(relh, -max2), max2);
      relv = min(max(relv, -max2), max2);
      const float bias = __fadd_rn(
          __fadd_rn(tab_s[lut1_s[rel1 + max1]],
                    tab_s[nb + lut2_s[relh + max2]]),
          tab_s[2 * nb + lut2_s[relv + max2]]);
      const float add = mask_s[kc] > 0 ? bias : kNegInf;
      s[c] = c < n ? __fadd_rn(s_f[row][kc], add) : kNegInf;
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
}

}  // namespace
}  // namespace fb

extern "C" int mg_flash_relbias(const void* q, const void* k, const void* v,
                                const float* hx, const float* vy,
                                const int* mask, const float* tables,
                                const int* lut1, const int* lut2, int B,
                                int L, int H, int D, int nb, int max1,
                                int max2, float scaling, void* out,
                                void* stream) {
  using namespace fb;
  if (D != kD || B <= 0 || L <= 0 || H <= 0 || nb <= 0 || max1 < 0 ||
      max2 < 0)
    return (int)cudaErrorInvalidValue;
  const int smem = 5 * kTileH * (int)sizeof(bf16) +
                   kTileF * (int)sizeof(float) +
                   (3 * nb + 3 * kT + 2 * max1 + 1 + 2 * max2 + 1) * 4;
  cudaError_t e = cudaFuncSetAttribute(
      flash_relbias_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      smem);
  if (e != cudaSuccess) return (int)e;
  dim3 grid((L + kT - 1) / kT, B * H);
  flash_relbias_kernel<<<grid, kThreads, smem, (cudaStream_t)stream>>>(
      (const bf16*)q, (const bf16*)k, (const bf16*)v, hx, vy, mask, tables,
      lut1, lut2, L, H, nb, max1, max2, scaling, (bf16*)out);
  return (int)cudaGetLastError();
}
