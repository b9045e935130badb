// Shared pieces of the float-bias flash attention kernels (flash_bias.cu,
// flash_bias_bwd.cu): 64-row tiles of a [B, L, H, 64] bf16 tensor staged in
// shared memory, bias reads, and the 64 x 64 x 64 tile products on the
// tensor cores (WMMA m16n16k16, bf16 operands, float32 accumulation). A
// block has four warps; warp w owns rows 16w .. 16w + 15 of every product
// it writes.

#pragma once

#include <cstdint>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <mma.h>

namespace fb {

using namespace nvcuda;
using bf16 = __nv_bfloat16;

constexpr int kD = 64;         // head dim
constexpr int kT = 64;         // query / key rows of a tile
constexpr int kThreads = 128;  // four warps
constexpr int kLdH = kD + 8;   // bf16 tile row pitch (elements): 144 bytes
constexpr int kLdF = kT + 4;   // float32 tile row pitch (elements)
constexpr int kTileH = kT * kLdH;
constexpr int kTileF = kT * kLdF;
constexpr float kNegInf = -1e30f;

typedef bf16 TileH[kLdH];
typedef float TileF[kLdF];

using FragA = wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major>;
using FragAT = wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::col_major>;
using FragB = wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::row_major>;
using FragBT = wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::col_major>;
using FragC = wmma::fragment<wmma::accumulator, 16, 16, 16, float>;

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(bf16 x) { return __bfloat162float(x); }
__device__ __forceinline__ void put(float* p, float x) { *p = x; }
__device__ __forceinline__ void put(bf16* p, float x) {
  *p = __float2bfloat16_rn(x);
}

__device__ __forceinline__ void bf16x8_to_f32(const uint4& raw, float* f) {
  const __nv_bfloat162* p = reinterpret_cast<const __nv_bfloat162*>(&raw);
#pragma unroll
  for (int e = 0; e < 4; ++e) {
    float2 t = __bfloat1622float2(p[e]);
    f[2 * e] = t.x;
    f[2 * e + 1] = t.y;
  }
}

// x as a pair of bf16 values hi + lo: ~16 significant bits, so a tile
// product of the pair against bf16 operands (two WMMA products into the same
// float32 accumulator) keeps P and dS at float32-level accuracy, where
// rounding them to one bf16 would cost ~2^-9 of |V| in every output.
__device__ __forceinline__ void split_bf16(float x, bf16* hi, bf16* lo) {
  const bf16 h = __float2bfloat16_rn(x);
  *hi = h;
  *lo = __float2bfloat16_rn(x - __bfloat162float(h));
}

// 32 consecutive bias values from p, of which the first n exist (n may be
// <= 0); 16-byte loads when `vec` (the row is 16-byte aligned) and all 32
// exist.
__device__ __forceinline__ void load_bias32(const float* p, int n, bool vec,
                                            float* out) {
  if (vec && n >= 32) {
#pragma unroll
    for (int c = 0; c < 8; ++c) {
      const float4 t = reinterpret_cast<const float4*>(p)[c];
      out[4 * c] = t.x;
      out[4 * c + 1] = t.y;
      out[4 * c + 2] = t.z;
      out[4 * c + 3] = t.w;
    }
  } else {
#pragma unroll
    for (int c = 0; c < 32; ++c) out[c] = c < n ? p[c] : 0.f;
  }
}

__device__ __forceinline__ void load_bias32(const bf16* p, int n, bool vec,
                                            float* out) {
  if (vec && n >= 32) {
#pragma unroll
    for (int c = 0; c < 4; ++c)
      bf16x8_to_f32(reinterpret_cast<const uint4*>(p)[c], out + 8 * c);
  } else {
#pragma unroll
    for (int c = 0; c < 32; ++c) out[c] = c < n ? __bfloat162float(p[c]) : 0.f;
  }
}

// Rows r0 .. r0 + 63 of head h of a [B, L, H, 64] bf16 tensor into a shared
// tile; rows at or past L are zero.
__device__ __forceinline__ void load_rows(TileH* dst,
                                          const bf16* __restrict__ src, int b,
                                          int h, int r0, int L, int H) {
  for (int c = threadIdx.x; c < kT * (kD / 8); c += kThreads) {
    const int row = c / (kD / 8);
    const int col = (c % (kD / 8)) * 8;
    uint4 val = make_uint4(0u, 0u, 0u, 0u);
    if (r0 + row < L)
      val = *reinterpret_cast<const uint4*>(
          src + (((size_t)b * L + r0 + row) * H + h) * kD + col);
    *reinterpret_cast<uint4*>(&dst[row][col]) = val;
  }
}

// A float32 [64][64] shared tile to rows r0 .. of head h of a [B, L, H, 64]
// bf16 tensor (rows at or past L are skipped).
__device__ __forceinline__ void store_rows(bf16* __restrict__ dst,
                                           const TileF* src, int b, int h,
                                           int r0, int L, int H) {
  for (int c = threadIdx.x; c < kT * (kD / 8); c += kThreads) {
    const int row = c / (kD / 8);
    const int col = (c % (kD / 8)) * 8;
    if (r0 + row >= L) continue;
    uint4 packed;
    __nv_bfloat162* p2 = reinterpret_cast<__nv_bfloat162*>(&packed);
#pragma unroll
    for (int e = 0; e < 4; ++e)
      p2[e] = __floats2bfloat162_rn(src[row][col + 2 * e],
                                    src[row][col + 2 * e + 1]);
    *reinterpret_cast<uint4*>(
        dst + (((size_t)b * L + r0 + row) * H + h) * kD + col) = packed;
  }
}

__device__ __forceinline__ void zero(FragC* acc) {
#pragma unroll
  for (int n = 0; n < 4; ++n) wmma::fill_fragment(acc[n], 0.f);
}

// acc[n] += (A B^T)[r0 .. r0 + 15][16n .. 16n + 15], A and B [64][64] tiles
// (B's rows are the columns of the product: q k^T, dO v^T).
__device__ __forceinline__ void mma_abt(FragC* acc, const TileH* a, int r0,
                                        const TileH* b) {
#pragma unroll
  for (int kk = 0; kk < 4; ++kk) {
    FragA fa;
    wmma::load_matrix_sync(fa, &a[r0][kk * 16], kLdH);
#pragma unroll
    for (int n = 0; n < 4; ++n) {
      FragBT fb;
      wmma::load_matrix_sync(fb, &b[n * 16][kk * 16], kLdH);
      wmma::mma_sync(acc[n], fa, fb, acc[n]);
    }
  }
}

// acc[n] += (A B)[r0 ..][16n ..] (P V, dS K).
__device__ __forceinline__ void mma_ab(FragC* acc, const TileH* a, int r0,
                                       const TileH* b) {
#pragma unroll
  for (int kk = 0; kk < 4; ++kk) {
    FragA fa;
    wmma::load_matrix_sync(fa, &a[r0][kk * 16], kLdH);
#pragma unroll
    for (int n = 0; n < 4; ++n) {
      FragB fb;
      wmma::load_matrix_sync(fb, &b[kk * 16][n * 16], kLdH);
      wmma::mma_sync(acc[n], fa, fb, acc[n]);
    }
  }
}

// acc[n] += (A^T B)[r0 ..][16n ..] (P^T dO, dS^T Q): A is given as stored,
// [64 q][64 keys], and the product's rows are A's columns.
__device__ __forceinline__ void mma_atb(FragC* acc, const TileH* a, int r0,
                                        const TileH* b) {
#pragma unroll
  for (int kk = 0; kk < 4; ++kk) {
    FragAT fa;
    wmma::load_matrix_sync(fa, &a[kk * 16][r0], kLdH);
#pragma unroll
    for (int n = 0; n < 4; ++n) {
      FragB fb;
      wmma::load_matrix_sync(fb, &b[kk * 16][n * 16], kLdH);
      wmma::mma_sync(acc[n], fa, fb, acc[n]);
    }
  }
}

__device__ __forceinline__ void store(TileF* c, int r0, const FragC* acc) {
#pragma unroll
  for (int n = 0; n < 4; ++n)
    wmma::store_matrix_sync(&c[r0][n * 16], acc[n], kLdF, wmma::mem_row_major);
}

}  // namespace fb
