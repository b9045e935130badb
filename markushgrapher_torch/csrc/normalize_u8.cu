// uint8 pixels -> (x / 255 - mean) / std in float32 or bf16, over the flat
// array of an image batch [B, H, W, C].
//
// Replaces markushgrapher_tpu/ops/preprocess.py:normalize_u8. The float32
// operations that XLA compiles the JAX function to, in its order, as the
// plain version: y = fma(x, f32(1/255), -mean), then y * f32(1/std), then
// round to nearest even for bf16; so the two are bit-exact.
//
// Bound: bytes, one read of the uint8 input and one write of the output
// (5 bytes a pixel channel for float32, 3 for bf16). Design: the array in
// warp tiles of 512 bytes. Lane l of a warp takes 16 bytes of a tile as 4
// words (float32) or 2 double words (bf16) spaced so that each of its
// 16-byte stores lands beside the other lanes': every load and store
// instruction of a warp covers a contiguous run (128 / 256 bytes in, 512
// out), every 32-byte sector written whole by one instruction. A warp
// takes kTiles consecutive tiles, all their loads issued before any store,
// and the grid has a CTA for every 8 warps' work: a grid of the card's
// resident CTAs, each warp looping, ran 6 % slower at [48, 512, 512, 3] ->
// bf16 and no faster at [8, ...] (bias_bench.py). Plain stores:
// preprocess_patchify reads the float32 output right away, from L2 where
// it fits. The ragged end (n % 512 values) goes a value a thread; an input
// or output not 16-byte aligned goes a byte a thread.

#include <cstdint>

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kTile = 512;  // bytes in of a warp tile
constexpr int kTiles = 2;   // consecutive tiles a warp has in flight

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

// lane's 16 bytes of the tile at byte t0: word k holds bytes at
// t0 + 128 k + 4 lane (float32) or, in pairs, t0 + 256 (k / 2) + 8 lane
template <bool kBf16>
__device__ __forceinline__ uint4 tile_load(const uint8_t* in, long long t0,
                                           int lane) {
  if (kBf16) {
    const uint2 a = __ldg(reinterpret_cast<const uint2*>(in + t0 + 8 * lane));
    const uint2 b =
        __ldg(reinterpret_cast<const uint2*>(in + t0 + 256 + 8 * lane));
    return make_uint4(a.x, a.y, b.x, b.y);
  }
  const uint32_t* w = reinterpret_cast<const uint32_t*>(in + t0) + lane;
  return make_uint4(__ldg(w), __ldg(w + 32), __ldg(w + 64), __ldg(w + 96));
}

template <bool kBf16>
__device__ __forceinline__ void tile_store(void* out, long long t0, int lane,
                                           uint4 x, float r, float mean,
                                           float inv_std) {
  const uint32_t words[4] = {x.x, x.y, x.z, x.w};
  float y[16];
#pragma unroll
  for (int j = 0; j < 16; ++j)
    y[j] = norm((words[j / 4] >> (8 * (j % 4))) & 0xffu, r, mean, inv_std);
  if (kBf16) {
    uint32_t packed[8];
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const __nv_bfloat162 h = __halves2bfloat162(
          __float2bfloat16_rn(y[2 * j]), __float2bfloat16_rn(y[2 * j + 1]));
      packed[j] = *reinterpret_cast<const uint32_t*>(&h);
    }
    __nv_bfloat16* o = reinterpret_cast<__nv_bfloat16*>(out) + t0 + 8 * lane;
    *reinterpret_cast<uint4*>(o) =
        make_uint4(packed[0], packed[1], packed[2], packed[3]);
    *reinterpret_cast<uint4*>(o + 256) =
        make_uint4(packed[4], packed[5], packed[6], packed[7]);
  } else {
    float* o = reinterpret_cast<float*>(out) + t0 + 4 * lane;
#pragma unroll
    for (int k = 0; k < 4; ++k)
      *reinterpret_cast<float4*>(o + 128 * k) =
          make_float4(y[4 * k], y[4 * k + 1], y[4 * k + 2], y[4 * k + 3]);
  }
}

template <bool kBf16>
__global__ void __launch_bounds__(kThreads)
normalize_u8_tiles(const uint8_t* __restrict__ in, long long n, float r,
                   float mean, float inv_std, void* __restrict__ out) {
  const long long tiles = n / kTile;
  const int lane = threadIdx.x & 31;
  const long long warps = (long long)gridDim.x * (kThreads / 32);
  const long long warp = ((long long)blockIdx.x * kThreads + threadIdx.x) / 32;
  for (long long t = warp * kTiles; t < tiles; t += warps * kTiles) {
    uint4 x[kTiles];
#pragma unroll
    for (int u = 0; u < kTiles; ++u)
      if (t + u < tiles) x[u] = tile_load<kBf16>(in, (t + u) * kTile, lane);
#pragma unroll
    for (int u = 0; u < kTiles; ++u)
      if (t + u < tiles)
        tile_store<kBf16>(out, (t + u) * kTile, lane, x[u], r, mean, inv_std);
  }
  const long long i = tiles * kTile + (long long)blockIdx.x * kThreads +
                      threadIdx.x;
  if (i < n) store1<kBf16>(out, i, norm(in[i], r, mean, inv_std));
}

template <bool kBf16>
__global__ void __launch_bounds__(kThreads)
normalize_u8_bytes(const uint8_t* __restrict__ in, long long n, float r,
                   float mean, float inv_std, void* __restrict__ out) {
  const long long stride = (long long)gridDim.x * kThreads;
  for (long long i = (long long)blockIdx.x * kThreads + threadIdx.x; i < n;
       i += stride)
    store1<kBf16>(out, i, norm(in[i], r, mean, inv_std));
}

using Kernel = void (*)(const uint8_t*, long long, float, float, float,
                        void*);

// CTAs for `threads` threads of work, at least two (the ragged end, under
// 512 values, takes a thread a value)
long long grid_for(long long threads) {
  const long long ctas = (threads + kThreads - 1) / kThreads;
  return ctas < 2 ? 2 : ctas;
}

}  // namespace

extern "C" int mg_normalize_u8(const uint8_t* in, long long n, float r,
                               float mean, float inv_std, int out_bf16,
                               void* out, void* stream) {
  if (n <= 0) return (int)cudaErrorInvalidValue;
  // the output of a fresh allocation is 256-byte aligned; the input may be
  // a view at any byte offset
  const bool vec16 = reinterpret_cast<uintptr_t>(in) % 16 == 0 &&
                     reinterpret_cast<uintptr_t>(out) % 16 == 0;
  Kernel kernel = vec16 ? (out_bf16 ? normalize_u8_tiles<true>
                                    : normalize_u8_tiles<false>)
                        : (out_bf16 ? normalize_u8_bytes<true>
                                    : normalize_u8_bytes<false>);
  // a warp for each kTiles tiles, or a thread for each byte
  const long long threads =
      vec16 ? (n / kTile + kTiles - 1) / kTiles * 32 : n;
  kernel<<<grid_for(threads), kThreads, 0, (cudaStream_t)stream>>>(
      in, n, r, mean, inv_std, out);
  return (int)cudaGetLastError();
}
