// Shared pieces of the WMMA flash attention kernel flash_relbias.cu: 64-row
// tiles of a [B, L, H, 64] bf16 tensor staged in shared memory and the
// 64 x 64 x 64 tile products on the tensor cores (WMMA m16n16k16, bf16
// operands, float32 accumulation). A block has four warps; warp w owns rows
// 16w .. 16w + 15 of every product it writes.

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
using FragB = wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::row_major>;
using FragBT = wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::col_major>;
using FragC = wmma::fragment<wmma::accumulator, 16, 16, 16, float>;

// x as a pair of bf16 values hi + lo: ~16 significant bits, so a tile
// product of the pair against bf16 operands (two WMMA products into the same
// float32 accumulator) keeps P and dS at float32-level accuracy, where
// rounding them to one bf16 would cost ~2^-9 of |V| in every output.
__device__ __forceinline__ void split_bf16(float x, bf16* hi, bf16* lo) {
  const bf16 h = __float2bfloat16_rn(x);
  *hi = h;
  *lo = __float2bfloat16_rn(x - __bfloat162float(h));
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

__device__ __forceinline__ void store(TileF* c, int r0, const FragC* acc) {
#pragma unroll
  for (int n = 0; n < 4; ++n)
    wmma::store_matrix_sync(&c[r0][n * 16], acc[n], kLdF, wmma::mem_row_major);
}

}  // namespace fb
