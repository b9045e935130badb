// Forward flash attention over an int8 bias slab, for the VTL encoder.
//
// Replaces markushgrapher_tpu/ops/flash_attention.py:flash_attention_bias_i8.
// T5 semantics: no 1/sqrt(d) scaling. For query i and key j of head h:
//   s = q_i . k_j + (bias_i8[b, h, i, j] * scale_h + (mask[b, j] ? 0 : -1e30))
// softmax over j online in float32, output (sum_j p_j v_j) / l in bf16.
// The running max starts at the finite -1e30, not -inf, so a tile whose keys
// are all masked yields no NaN (its weights are wiped by the next valid
// tile's rescale, exactly as in the TPU kernel).
//
// Bound: at B=8, H=16, L=1536, D=64 the 24 encoder layers do ~1.9 TFLOP of
// attention math and stream the int8 slab (302 MB) once per layer. This
// first version keeps the math on the CUDA cores in float32: one block per
// (b*h, 64-query tile), one thread per query row holding q and the output
// accumulator in registers, 64-key K/V tiles staged in shared memory and
// read as 16-byte broadcasts, scores of the tile kept in shared memory
// between the max pass and the exp/PV pass. It is limited by CUDA-core
// FLOPs; moving QK^T and PV to tensor cores (mma.sync / wgmma) is later
// work. No divisibility requirement on L: ragged tiles are masked.

#include <cstdint>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kBQ = 64;
constexpr int kBK = 64;
constexpr float kNegInf = -1e30f;

__device__ __forceinline__ void bf16x8_to_f32(const uint4& raw, float* f) {
  const __nv_bfloat162* p = reinterpret_cast<const __nv_bfloat162*>(&raw);
#pragma unroll
  for (int e = 0; e < 4; ++e) {
    float2 t = __bfloat1622float2(p[e]);
    f[2 * e] = t.x;
    f[2 * e + 1] = t.y;
  }
}

template <int D>
__global__ void __launch_bounds__(kBQ)
flash_i8_kernel(const __nv_bfloat16* __restrict__ q,
                const __nv_bfloat16* __restrict__ k,
                const __nv_bfloat16* __restrict__ v,
                const int8_t* __restrict__ bias,
                const float* __restrict__ scales,
                const int* __restrict__ key_mask, int L, int H,
                __nv_bfloat16* __restrict__ out) {
  __shared__ __align__(16) __nv_bfloat16 k_s[kBK][D];
  __shared__ __align__(16) __nv_bfloat16 v_s[kBK][D];
  __shared__ float s_s[kBQ][kBK + 1];
  __shared__ float mask_s[kBK];

  const int bh = blockIdx.y;
  const int b = bh / H;
  const int h = bh % H;
  const int t = threadIdx.x;
  const int i = blockIdx.x * kBQ + t;
  const bool q_valid = i < L;
  constexpr int kChunks = D / 8;  // 16-byte chunks per row

  float qr[D];
  float acc[D];
#pragma unroll
  for (int d = 0; d < D; ++d) acc[d] = 0.f;
  if (q_valid) {
    const uint4* src =
        reinterpret_cast<const uint4*>(q + (((size_t)b * L + i) * H + h) * D);
#pragma unroll
    for (int c = 0; c < kChunks; ++c) bf16x8_to_f32(src[c], qr + 8 * c);
  } else {
#pragma unroll
    for (int d = 0; d < D; ++d) qr[d] = 0.f;
  }
  const float scale = scales[h];
  const int8_t* brow = bias + ((size_t)bh * L + (q_valid ? i : 0)) * L;
  float m = kNegInf;
  float l = 0.f;

  for (int k0 = 0; k0 < L; k0 += kBK) {
    const int nk = min(kBK, L - k0);
    __syncthreads();
    for (int c = t; c < kBK * kChunks; c += kBQ) {
      const int row = c / kChunks;
      const int col = (c % kChunks) * 8;
      uint4 kz = make_uint4(0, 0, 0, 0), vz = kz;
      if (row < nk) {
        const size_t off = (((size_t)b * L + k0 + row) * H + h) * D + col;
        kz = *reinterpret_cast<const uint4*>(k + off);
        vz = *reinterpret_cast<const uint4*>(v + off);
      }
      *reinterpret_cast<uint4*>(&k_s[row][col]) = kz;
      *reinterpret_cast<uint4*>(&v_s[row][col]) = vz;
    }
    for (int c = t; c < kBK; c += kBQ)
      mask_s[c] = (c < nk && key_mask[(size_t)b * L + k0 + c] > 0) ? 0.f
                                                                  : kNegInf;
    __syncthreads();
    if (!q_valid) continue;

    float tmax = kNegInf;
    for (int j = 0; j < nk; ++j) {
      float dot = 0.f;
#pragma unroll
      for (int c = 0; c < kChunks; ++c) {
        float kf[8];
        bf16x8_to_f32(*reinterpret_cast<const uint4*>(&k_s[j][8 * c]), kf);
#pragma unroll
        for (int e = 0; e < 8; ++e) dot = fmaf(qr[8 * c + e], kf[e], dot);
      }
      const float bj = __fadd_rn(
          __fmul_rn((float)__ldg(brow + k0 + j), scale), mask_s[j]);
      const float s = __fadd_rn(dot, bj);
      s_s[t][j] = s;
      tmax = fmaxf(tmax, s);
    }
    const float m_new = fmaxf(m, tmax);
    const float alpha = expf(m - m_new);
    l *= alpha;
#pragma unroll
    for (int d = 0; d < D; ++d) acc[d] *= alpha;
    for (int j = 0; j < nk; ++j) {
      const float p = expf(s_s[t][j] - m_new);
      l += p;
#pragma unroll
      for (int c = 0; c < kChunks; ++c) {
        float vf[8];
        bf16x8_to_f32(*reinterpret_cast<const uint4*>(&v_s[j][8 * c]), vf);
#pragma unroll
        for (int e = 0; e < 8; ++e)
          acc[8 * c + e] = fmaf(p, vf[e], acc[8 * c + e]);
      }
    }
    m = m_new;
  }
  if (!q_valid) return;
  const float inv_den = fmaxf(l, 1e-30f);
  uint4* dst =
      reinterpret_cast<uint4*>(out + (((size_t)b * L + i) * H + h) * D);
#pragma unroll
  for (int c = 0; c < kChunks; ++c) {
    uint4 packed;
    __nv_bfloat162* p2 = reinterpret_cast<__nv_bfloat162*>(&packed);
#pragma unroll
    for (int e = 0; e < 4; ++e)
      p2[e] = __floats2bfloat162_rn(__fdiv_rn(acc[8 * c + 2 * e], inv_den),
                                    __fdiv_rn(acc[8 * c + 2 * e + 1], inv_den));
    dst[c] = packed;
  }
}

}  // namespace

extern "C" int mg_flash_i8(const void* q, const void* k, const void* v,
                           const int8_t* bias, const float* scales,
                           const int* key_mask, int B, int L, int H, int D,
                           void* out, void* stream) {
  dim3 grid((L + kBQ - 1) / kBQ, B * H);
  cudaStream_t s = (cudaStream_t)stream;
  if (D == 64) {
    flash_i8_kernel<64><<<grid, kBQ, 0, s>>>(
        (const __nv_bfloat16*)q, (const __nv_bfloat16*)k,
        (const __nv_bfloat16*)v, bias, scales, key_mask, L, H,
        (__nv_bfloat16*)out);
  } else {
    return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}
