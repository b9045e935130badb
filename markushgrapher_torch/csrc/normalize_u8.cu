// uint8 pixels -> (x / 255 - mean) / std in float32 or bf16, over the flat
// array of an image batch [B, H, W, C].
//
// Replaces markushgrapher_tpu/ops/preprocess.py:normalize_u8. The float32
// operations that XLA compiles the JAX function to, in its order, as the
// plain version: y = fma(x, f32(1/255), -mean), then y * f32(1/std), then
// round to nearest even for bf16; so the two are bit-exact.
//
// Bound: bytes, one read of the uint8 input and one write of the output
// (5 bytes a pixel channel for float32, 3 for bf16). Design: each thread
// takes 16 consecutive bytes with one 16-byte load and writes 16 outputs
// with 16-byte stores (four float4, or two of 8 bf16); the ragged end of the
// array, and inputs not 16-byte aligned, go a byte at a time.

#include <cstdint>

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;

// r = f32(1/255), inv_std = f32(1/std), both from the host
__device__ __forceinline__ float norm(uint32_t x, float r, float mean,
                                     float inv_std) {
  return __fmul_rn(__fmaf_rn((float)x, r, -mean), inv_std);
}

template <bool kBf16>
__device__ __forceinline__ void store1(void* out, long long i, float y) {
  if (kBf16)
    reinterpret_cast<__nv_bfloat16*>(out)[i] = __float2bfloat16_rn(y);
  else
    reinterpret_cast<float*>(out)[i] = y;
}

template <bool kBf16, bool kVec16>
__global__ void __launch_bounds__(kThreads)
normalize_u8_kernel(const uint8_t* __restrict__ in, long long n, float r,
                    float mean, float inv_std, void* __restrict__ out) {
  const long long i0 = ((long long)blockIdx.x * kThreads + threadIdx.x) * 16;
  if (i0 >= n) return;
  if (kVec16 && i0 + 16 <= n) {
    const uint4 w = *reinterpret_cast<const uint4*>(in + i0);
    const uint32_t words[4] = {w.x, w.y, w.z, w.w};
    float y[16];
#pragma unroll
    for (int j = 0; j < 16; ++j)
      y[j] = norm((words[j / 4] >> (8 * (j % 4))) & 0xffu, r, mean, inv_std);
    if (kBf16) {
      uint32_t packed[8];
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const __nv_bfloat162 h =
            __halves2bfloat162(__float2bfloat16_rn(y[2 * j]),
                               __float2bfloat16_rn(y[2 * j + 1]));
        packed[j] = *reinterpret_cast<const uint32_t*>(&h);
      }
      uint4* dst = reinterpret_cast<uint4*>(
          reinterpret_cast<__nv_bfloat16*>(out) + i0);
      dst[0] = make_uint4(packed[0], packed[1], packed[2], packed[3]);
      dst[1] = make_uint4(packed[4], packed[5], packed[6], packed[7]);
    } else {
      float4* dst = reinterpret_cast<float4*>(reinterpret_cast<float*>(out) + i0);
#pragma unroll
      for (int j = 0; j < 4; ++j)
        dst[j] = make_float4(y[4 * j], y[4 * j + 1], y[4 * j + 2], y[4 * j + 3]);
    }
    return;
  }
  const long long end = i0 + 16 < n ? i0 + 16 : n;
  for (long long i = i0; i < end; ++i)
    store1<kBf16>(out, i, norm(in[i], r, mean, inv_std));
}

}  // namespace

extern "C" int mg_normalize_u8(const uint8_t* in, long long n, float r,
                               float mean, float inv_std, int out_bf16,
                               void* out, void* stream) {
  if (n <= 0) return (int)cudaErrorInvalidValue;
  const long long threads = (n + 15) / 16;
  const unsigned grid = (unsigned)((threads + kThreads - 1) / kThreads);
  // the output of a fresh allocation is 256-byte aligned; the input may be
  // a view at any byte offset
  const bool vec16 = reinterpret_cast<uintptr_t>(in) % 16 == 0 &&
                     reinterpret_cast<uintptr_t>(out) % 16 == 0;
  cudaStream_t s = (cudaStream_t)stream;
  void (*kernel)(const uint8_t*, long long, float, float, float, void*) =
      out_bf16 ? (vec16 ? normalize_u8_kernel<true, true>
                        : normalize_u8_kernel<true, false>)
               : (vec16 ? normalize_u8_kernel<false, true>
                        : normalize_u8_kernel<false, false>);
  kernel<<<grid, kThreads, 0, s>>>(in, n, r, mean, inv_std, out);
  return (int)cudaGetLastError();
}
