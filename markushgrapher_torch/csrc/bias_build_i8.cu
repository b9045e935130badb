// int8 encoder relative-position bias slab for the VTL encoder.
//
// Replaces markushgrapher_tpu/ops/bias_build.py:encoder_position_bias_kernel_i8
// (the TPU one-hot MXU builder). Computes, for every (b, h, i, j),
//   out = rint(((t1[b1] + th[bh]) + tv[bv]) / s_h)
// with b1 the T5 bucket of j - i (or of positions[b, j] - positions[b, i]),
// and bh / bv the buckets of trunc((c_j - c_i) * scaling) over bbox centres.
//
// Bound: the write of the int8 [B, H, L, L] slab (302 MB at B=8, H=16,
// L=1536); the reads (three [nb] table columns, two LUTs, two [L] centre
// rows) are tiny and cached. Design: one thread per output element, a block
// of 256 threads covers 256 consecutive j of one (b, h, i) row, so stores
// are coalesced; the head's table column and both LUTs sit in shared memory.
// Buckets come from lookup tables built by the plain PyTorch
// `relative_position_bucket` (distances clamped into +-max_distance, where
// buckets already saturate), so no logf runs here and the result is
// bit-exact against the plain gather builder. All float ops use explicit
// round-to-nearest intrinsics, so no FMA contraction changes a value.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;

__global__ void bias_build_i8_kernel(
    const float* __restrict__ t1, const float* __restrict__ th,
    const float* __restrict__ tv, const float* __restrict__ scales,
    const float* __restrict__ hx, const float* __restrict__ vy,
    const int* __restrict__ positions, const int* __restrict__ lut1,
    const int* __restrict__ lut2, int H, int L, int nb, int max1, int max2,
    float scaling, int8_t* __restrict__ out) {
  extern __shared__ unsigned char smem_raw[];
  float* s_t1 = reinterpret_cast<float*>(smem_raw);
  float* s_th = s_t1 + nb;
  float* s_tv = s_th + nb;
  int* s_lut1 = reinterpret_cast<int*>(s_tv + nb);
  int* s_lut2 = s_lut1 + (2 * max1 + 1);

  const int bh_idx = blockIdx.z;
  const int b = bh_idx / H;
  const int h = bh_idx % H;
  const int i = blockIdx.y;
  const int j = blockIdx.x * kThreads + threadIdx.x;

  for (int t = threadIdx.x; t < nb; t += kThreads) {
    s_t1[t] = t1[t * H + h];
    s_th[t] = th[t * H + h];
    s_tv[t] = tv[t * H + h];
  }
  for (int t = threadIdx.x; t < 2 * max1 + 1; t += kThreads) s_lut1[t] = lut1[t];
  for (int t = threadIdx.x; t < 2 * max2 + 1; t += kThreads) s_lut2[t] = lut2[t];
  __syncthreads();
  if (j >= L) return;

  int rel1 = positions ? positions[b * L + j] - positions[b * L + i] : j - i;
  rel1 = min(max(rel1, -max1), max1);
  const int b1 = s_lut1[rel1 + max1];

  const float* hrow = hx + (size_t)b * L;
  const float* vrow = vy + (size_t)b * L;
  // (c_j - c_i) * scaling in float32, then truncation toward zero
  float dh = __fmul_rn(__fsub_rn(hrow[j], hrow[i]), scaling);
  float dv = __fmul_rn(__fsub_rn(vrow[j], vrow[i]), scaling);
  const float lim = (float)max2;
  int relh = __float2int_rz(fminf(fmaxf(dh, -lim - 1.0f), lim + 1.0f));
  int relv = __float2int_rz(fminf(fmaxf(dv, -lim - 1.0f), lim + 1.0f));
  relh = min(max(relh, -max2), max2);
  relv = min(max(relv, -max2), max2);
  const int bh = s_lut2[relh + max2];
  const int bv = s_lut2[relv + max2];

  float val = __fadd_rn(__fadd_rn(s_t1[b1], s_th[bh]), s_tv[bv]);
  val = __fdiv_rn(val, scales[h]);
  int q = __float2int_rn(val);
  q = min(max(q, -128), 127);
  out[((size_t)bh_idx * L + i) * L + j] = (int8_t)q;
}

}  // namespace

extern "C" int mg_bias_build_i8(const float* t1, const float* th,
                                const float* tv, const float* scales,
                                const float* hx, const float* vy,
                                const int* positions, const int* lut1,
                                const int* lut2, int B, int H, int L, int nb,
                                int max1, int max2, float scaling,
                                int8_t* out, void* stream) {
  dim3 grid((L + kThreads - 1) / kThreads, L, B * H);
  size_t smem = 3 * nb * sizeof(float) +
                (size_t)(2 * max1 + 1 + 2 * max2 + 1) * sizeof(int);
  bias_build_i8_kernel<<<grid, kThreads, smem, (cudaStream_t)stream>>>(
      t1, th, tv, scales, hx, vy, positions, lut1, lut2, H, L, nb, max1, max2,
      scaling, out);
  return (int)cudaGetLastError();
}
