// Hopper (sm_90a) building blocks shared by the flash-attention cores:
// the forward (flash_fwd_sm90.cuh: flash_i8.cu, flash_bias.cu) and the
// float-bias backward (flash_bias_bwd.cu).
//
// - mbarriers (the waits trap after ~2 s, so a fault in a ring fails the
//   launch instead of hanging the card), TMA tile loads and stores, wgmma
//   (bf16 operands, float32 accumulation, m64n64k16) from shared memory
//   and with A from registers;
// - the bias policies: element type, TMA box and swizzle, and the byte
//   offset of (row, key) in a bias tile as TMA lays it out;
// - the fragment helpers: the bias into the accumulator, e^x, the bf16
//   hi + lo split of a fragment into A operands;
// - the host side: tensor maps encoded by the CUDA driver API's
//   cuTensorMapEncodeTiled, fetched through the runtime (no -lcuda).
//
// Every operand tile is 64 rows of 64 bf16 (128 bytes, one swizzle atom)
// with the 128-byte swizzle, 1024-aligned. One descriptor form serves both
// operand orders: K-major (rows along M or N, the 64 values of a row along
// K: Q, K, dO, V in S = Q K^T and dP = dO V^T) and MN-major (rows along K:
// V in P V, K in dS K, dO and Q in P^T dO and dS^T Q), the 8-row groups
// 1024 bytes apart either way.

#pragma once

#include <cstdint>
#include <cstring>
#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace sm90 {

using bf16 = __nv_bfloat16;

constexpr int kD = 64;               // head dim: a 128-byte row
constexpr int kBN = 64;              // keys (or queries) of a ring stage
constexpr int kTile = kBN * kD * 2;  // one 64 x 64 bf16 tile: 8 KB
constexpr float kNegInf = -1e30f;

// ---- bias policies: element type, ring depth, TMA box and swizzle, and
// the byte offset of (row r, key c) in a stage's bias tile, as TMA lays it
// out (the swizzle XORs the 16-byte chunk index with address bits 7..9); a
// pair of keys (c even) is contiguous in every layout. offset(r + 8 j, c)
// = offset(r, c) + 1024 j in every layout.

struct BiasI8 {  // int8 codes * scale_h + key mask
  using T = int8_t;
  static constexpr bool kKeyMask = true;
  static constexpr bool kLse = false;
  static constexpr int kStages = 4;
  static constexpr int kBoxCols = 64;  // 64-byte rows, 64-byte swizzle
  static constexpr CUtensorMapDataType kType = CU_TENSOR_MAP_DATA_TYPE_UINT8;
  static constexpr CUtensorMapSwizzle kSwizzle = CU_TENSOR_MAP_SWIZZLE_64B;
  __device__ __forceinline__ static int offset(int r, int c) {
    return r * 64 + ((((c >> 4) ^ (r >> 1)) & 3) << 4 | (c & 15));
  }
  // offset(r, c + 8 j) from a = offset(r, c), c < 8 (a may carry a multiple
  // of 128 more, as every stage offset does)
  __device__ __forceinline__ static int at(int a, int j) {
    return (a ^ (j >> 1) << 4) + 8 * (j & 1);
  }
  __device__ __forceinline__ static float2 pair(const uint8_t* p) {
    const char2 v = *reinterpret_cast<const char2*>(p);
    return make_float2((float)v.x, (float)v.y);
  }
};

struct BiasBF16 {  // bf16 additive bias, mask included
  using T = bf16;
  static constexpr bool kKeyMask = false;
  static constexpr bool kLse = true;
  static constexpr int kStages = 3;
  static constexpr int kBoxCols = 64;  // 128-byte rows
  static constexpr CUtensorMapDataType kType =
      CU_TENSOR_MAP_DATA_TYPE_BFLOAT16;
  static constexpr CUtensorMapSwizzle kSwizzle = CU_TENSOR_MAP_SWIZZLE_128B;
  __device__ __forceinline__ static int offset(int r, int c) {
    return r * 128 + ((((c >> 3) ^ r) & 7) << 4 | (c & 7) << 1);
  }
  __device__ __forceinline__ static int at(int a, int j) {
    return a ^ j << 4;
  }
  __device__ __forceinline__ static float2 pair(const uint8_t* p) {
    return __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(p));
  }
  __device__ __forceinline__ static float one(const uint8_t* p) {
    return __bfloat162float(*reinterpret_cast<const bf16*>(p));
  }
  // round a pair to the bias dtype, as the plain version's .to(bias.dtype)
  __device__ __forceinline__ static void put_pair(uint8_t* p, float x,
                                                  float y) {
    *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(x, y);
  }
};

// float32 additive bias, mask included; a tile of Rows rows is two boxes of
// 32 keys (128-byte rows), the second Rows * 128 bytes after the first
template <int Rows>
struct BiasF32Rows {
  using T = float;
  static constexpr bool kKeyMask = false;
  static constexpr bool kLse = true;
  static constexpr int kStages = 3;
  static constexpr int kBoxCols = 32;  // two boxes of 128-byte rows
  static constexpr CUtensorMapDataType kType =
      CU_TENSOR_MAP_DATA_TYPE_FLOAT32;
  static constexpr CUtensorMapSwizzle kSwizzle = CU_TENSOR_MAP_SWIZZLE_128B;
  __device__ __forceinline__ static int offset(int r, int c) {
    return (c >> 5) * (Rows * 128) + r * 128 +
           (((((c & 31) >> 2) ^ r) & 7) << 4 | (c & 3) << 2);
  }
  __device__ __forceinline__ static int at(int a, int j) {
    return (a ^ (j & 3) << 5) + (j >> 2) * (Rows * 128);
  }
  __device__ __forceinline__ static float2 pair(const uint8_t* p) {
    return *reinterpret_cast<const float2*>(p);
  }
  __device__ __forceinline__ static float one(const uint8_t* p) {
    return *reinterpret_cast<const float*>(p);
  }
  __device__ __forceinline__ static void put_pair(uint8_t* p, float x,
                                                  float y) {
    *reinterpret_cast<float2*>(p) = make_float2(x, y);
  }
};

// ---- PTX: mbarriers, TMA, wgmma

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;" ::"r"(smem_u32(bar)),
               "r"(count)
               : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];" ::"r"(
                   smem_u32(bar))
               : "memory");
}

// arrive, and expect `bytes` more of transactions (TMA) in this phase
__device__ __forceinline__ void mbar_arrive_tx(uint64_t* bar, uint32_t bytes) {
  asm volatile(
      "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::"r"(
          smem_u32(bar)),
      "r"(bytes)
      : "memory");
}

// wait until the phase of parity `parity` has completed; a wait of more than
// 2^32 cycles (~2 s) traps, so a fault in the ring fails the launch instead
// of hanging the card
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  const uint32_t a = smem_u32(bar);
  uint32_t done = 0;
  long long t0 = 0;
  while (true) {
    asm volatile(
        "{\n\t.reg .pred p;\n\t"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n\t"
        "selp.u32 %0, 1, 0, p;\n\t}"
        : "=r"(done)
        : "r"(a), "r"(parity)
        : "memory");
    if (done) return;
    if (t0 == 0)
      t0 = clock64();
    else if (clock64() - t0 > (1ll << 32))
      __trap();
  }
}

__device__ __forceinline__ void tma_4d(void* dst, const CUtensorMap& map,
                                       uint64_t* bar, int c0, int c1, int c2,
                                       int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%3, %4, %5, %6}], [%2];" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(&map)), "r"(smem_u32(bar)), "r"(c0),
      "r"(c1), "r"(c2), "r"(c3)
      : "memory");
}

__device__ __forceinline__ void tma_3d(void* dst, const CUtensorMap& map,
                                       uint64_t* bar, int c0, int c1,
                                       int c2) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%3, %4, %5}], [%2];" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(&map)), "r"(smem_u32(bar)), "r"(c0),
      "r"(c1), "r"(c2)
      : "memory");
}

// A tile from shared memory to global memory by TMA (elements out of the
// tensor's bounds are not written), as one bulk group of this thread. The
// threads that wrote the tile first make their writes visible to the TMA
// unit (proxy_fence) and meet this one at a barrier.
__device__ __forceinline__ void tma_store_3d(const CUtensorMap& map,
                                             const void* src, int c0, int c1,
                                             int c2) {
  asm volatile(
      "cp.async.bulk.tensor.3d.global.shared::cta.bulk_group"
      " [%0, {%2, %3, %4}], [%1];" ::"l"(reinterpret_cast<uint64_t>(&map)),
      "r"(smem_u32(src)), "r"(c0), "r"(c1), "r"(c2)
      : "memory");
}
__device__ __forceinline__ void bulk_commit() {
  asm volatile("cp.async.bulk.commit_group;" ::: "memory");
}
// until at most N of this thread's bulk groups still read shared memory
template <int N>
__device__ __forceinline__ void bulk_wait_read() {
  asm volatile("cp.async.bulk.wait_group.read %0;" ::"n"(N) : "memory");
}
// until every bulk group of this thread has completed
__device__ __forceinline__ void bulk_wait_all() {
  asm volatile("cp.async.bulk.wait_group 0;" ::: "memory");
}
__device__ __forceinline__ void proxy_fence() {
  asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
}
// barrier `id` (1..15) over `threads` threads (a multiple of 32)
__device__ __forceinline__ void named_sync(int id, int threads) {
  asm volatile("bar.sync %0, %1;" ::"r"(id), "r"(threads) : "memory");
}

__device__ __forceinline__ void wg_fence() {
  asm volatile("wgmma.fence.sync.aligned;" ::: "memory");
}
__device__ __forceinline__ void wg_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;" ::: "memory");
}
// wait until at most N committed wgmma groups are pending
template <int N>
__device__ __forceinline__ void wg_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;" ::"n"(N) : "memory");
}

// Pin registers that an asynchronous wgmma reads or writes, so that the
// compiler moves no use of them across the fence or the wait.
template <int N>
__device__ __forceinline__ void pin(float (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(r[i])::"memory");
}
template <int N>
__device__ __forceinline__ void pin(uint32_t (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+r"(r[i])::"memory");
}

// Descriptor of a 128-byte-swizzled operand tile at a 1024-aligned address
// (+ 16-byte steps along the swizzled row): 8-row groups 1024 bytes apart.
__device__ __forceinline__ uint64_t desc_sw128(const void* tile) {
  return (uint64_t)((smem_u32(tile) & 0x3FFFF) >> 4) | (uint64_t)1 << 16 |
         (uint64_t)(1024 >> 4) << 32 | (uint64_t)1 << 62;
}

// d (+)= A B^T for A [64][16] and B [64][16], both K-major in shared memory
// (d is overwritten unless `accumulate`).
__device__ __forceinline__ void wgmma_ss(float (&d)[32], uint64_t a,
                                         uint64_t b, int accumulate) {
  asm volatile(
      "{\n\t.reg .pred p;\n\tsetp.ne.b32 p, %34, 0;\n\t"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
      "%15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, "
      "%29, %30, %31}, %32, %33, p, 1, 1, 0, 0;\n\t}"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31])
      : "l"(a), "l"(b), "r"(accumulate));
}

// d += A B for A [64][16] from registers (the m64k16 fragment, four packed
// bf16 pairs a) and B [16][64] MN-major in shared memory.
__device__ __forceinline__ void wgmma_rs(float (&d)[32], const uint32_t* a,
                                         uint64_t b) {
  asm volatile(
      "{\n\t.reg .pred p;\n\tsetp.ne.b32 p, %37, 0;\n\t"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
      "%15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, "
      "%29, %30, %31}, {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n\t}"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
}

// s += Q K^T of one tile (s holds the tile's bias terms): four k16 steps,
// +32 bytes along d each
__device__ __forceinline__ void qk(float (&s)[32], uint64_t dq, uint64_t dk) {
#pragma unroll
  for (int kk = 0; kk < 4; ++kk) wgmma_ss(s, dq + 2 * kk, dk + 2 * kk, 1);
}

// d = A B^T of one tile, both K-major (the accumulator's old values unread)
__device__ __forceinline__ void abt(float (&d)[32], uint64_t da, uint64_t db) {
#pragma unroll
  for (int kk = 0; kk < 4; ++kk) wgmma_ss(d, da + 2 * kk, db + 2 * kk, kk);
}

// acc += P V with P as its hi + lo pair: four k16 steps (+16 keys, 2048
// bytes of V each) per part
__device__ __forceinline__ void pv(float (&acc)[32], const uint32_t (&hi)[16],
                                   const uint32_t (&lo)[16], uint64_t dv) {
#pragma unroll
  for (int kk = 0; kk < 4; ++kk) wgmma_rs(acc, hi + 4 * kk, dv + kk * 128);
#pragma unroll
  for (int kk = 0; kk < 4; ++kk) wgmma_rs(acc, lo + 4 * kk, dv + kk * 128);
}

// ---- the fragments

// e^x as 2^(x log2 e); results below 2^-126 flush to 0
__device__ __forceinline__ float ex(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x * 1.4426950408889634f));
  return y;
}

// The bias terms of a thread's 32 scores into s, the accumulator that
// QK^T then adds to: key pairs 8 j + cq of the stage tile's rows at byte
// offsets a0 and a1 from smem (offsets of key cq); -1e30 for keys at or
// past L. BiasI8: __fmul_rn(code, scale), then __fadd_rn(., mask term) in
// a tile with a masked key (a 0 term changes nothing).
template <class P>
__device__ __forceinline__ void load_bias(float (&s)[32], const uint8_t* smem,
                                          int a0, int a1, const float* mask,
                                          bool masked, float scale, int cq,
                                          int k0, int L) {
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    float2 b0 = P::pair(smem + P::at(a0, j));
    float2 b1 = P::pair(smem + P::at(a1, j));
    if constexpr (P::kKeyMask) {
      b0.x = __fmul_rn(b0.x, scale);
      b0.y = __fmul_rn(b0.y, scale);
      b1.x = __fmul_rn(b1.x, scale);
      b1.y = __fmul_rn(b1.y, scale);
      if (masked) {
        const float2 mk = *reinterpret_cast<const float2*>(mask + 8 * j + cq);
        b0.x = __fadd_rn(b0.x, mk.x);
        b0.y = __fadd_rn(b0.y, mk.y);
        b1.x = __fadd_rn(b1.x, mk.x);
        b1.y = __fadd_rn(b1.y, mk.y);
      }
    }
    s[4 * j] = b0.x;
    s[4 * j + 1] = b0.y;
    s[4 * j + 2] = b1.x;
    s[4 * j + 3] = b1.y;
  }
  if (k0 + kBN > L) {
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int c = k0 + 8 * j + cq;
      if (c >= L) s[4 * j] = s[4 * j + 2] = kNegInf;
      if (c + 1 >= L) s[4 * j + 1] = s[4 * j + 3] = kNegInf;
    }
  }
}

// A fragment as the A operands of four k16 steps, pair e = (s[2e],
// s[2e+1]), each as bf16 hi = bf16(x) and lo = bf16(x - hi) (~16
// significant bits), packed low element first
__device__ __forceinline__ void split(const float (&s)[32],
                                      uint32_t (&hi)[16],
                                      uint32_t (&lo)[16]) {
#pragma unroll
  for (int e = 0; e < 16; ++e) {
    const __nv_bfloat162 h = __floats2bfloat162_rn(s[2 * e], s[2 * e + 1]);
    const float2 hf = __bfloat1622float2(h);
    const __nv_bfloat162 l =
        __floats2bfloat162_rn(s[2 * e] - hf.x, s[2 * e + 1] - hf.y);
    hi[e] = *reinterpret_cast<const uint32_t*>(&h);
    lo[e] = *reinterpret_cast<const uint32_t*>(&l);
  }
}

// A thread's two rows of a 64 x 64 float32 fragment (row i0 from f[4 j],
// f[4 j + 1], row i1 from f[4 j + 2], f[4 j + 3]) as bf16 pairs into rows
// of 64 at dst0 / dst1 (null: the row lies at or past L); cq = its column
// pair.
__device__ __forceinline__ void store_rows_bf16(const float (&f)[32],
                                                bf16* dst0, bf16* dst1,
                                                int cq) {
  if (dst0) {
    __nv_bfloat162* o = reinterpret_cast<__nv_bfloat162*>(dst0 + cq);
#pragma unroll
    for (int j = 0; j < 8; ++j)
      o[4 * j] = __floats2bfloat162_rn(f[4 * j], f[4 * j + 1]);
  }
  if (dst1) {
    __nv_bfloat162* o = reinterpret_cast<__nv_bfloat162*>(dst1 + cq);
#pragma unroll
    for (int j = 0; j < 8; ++j)
      o[4 * j] = __floats2bfloat162_rn(f[4 * j + 2], f[4 * j + 3]);
  }
}

// ---- host side: tensor maps

using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType,
                                 cuuint32_t, void*, const cuuint64_t*,
                                 const cuuint64_t*, const cuuint32_t*,
                                 const cuuint32_t*, CUtensorMapInterleave,
                                 CUtensorMapSwizzle, CUtensorMapL2promotion,
                                 CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled of the CUDA driver API, fetched through the
// runtime, so the library needs no -lcuda.
inline EncodeTiled encoder() {
  static const EncodeTiled fn = [] {
    void* f = nullptr;
    cudaDriverEntryPointQueryResult q;
    if (cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &f, 12000,
                                         cudaEnableDefault,
                                         &q) != cudaSuccess ||
        q != cudaDriverEntryPointSuccess)
      f = nullptr;
    return reinterpret_cast<EncodeTiled>(f);
  }();
  return fn;
}

inline bool aligned16(const void* p) {
  return (reinterpret_cast<uintptr_t>(p) & 15) == 0;
}

// q, k, v or dO [B, L, H, 64] bf16: boxes of 64 rows of one head (rows past
// L within a batch read as zero)
inline bool qkv_map(CUtensorMap* m, const void* ptr, int B, int L, int H) {
  const cuuint64_t dims[4] = {(cuuint64_t)kD, (cuuint64_t)H, (cuuint64_t)L,
                              (cuuint64_t)B};
  const cuuint64_t strides[3] = {(cuuint64_t)kD * 2,
                                 (cuuint64_t)H * kD * 2,
                                 (cuuint64_t)L * H * kD * 2};
  const cuuint32_t box[4] = {(cuuint32_t)kD, 1, (cuuint32_t)kBN, 1};
  const cuuint32_t one[4] = {1, 1, 1, 1};
  return encoder()(m, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4,
                   const_cast<void*>(ptr), dims, strides, box, one,
                   CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
                   CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
                   CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

// a bias (or d(bias)) [BH, L, L]: boxes of kBoxCols keys x `rows` rows
template <class P>
inline bool bias_map(CUtensorMap* m, const void* ptr, int BH, int L,
                     int rows) {
  const cuuint64_t es = sizeof(typename P::T);
  const cuuint64_t dims[3] = {(cuuint64_t)L, (cuuint64_t)L, (cuuint64_t)BH};
  const cuuint64_t strides[2] = {(cuuint64_t)L * es, (cuuint64_t)L * L * es};
  const cuuint32_t box[3] = {(cuuint32_t)P::kBoxCols, (cuuint32_t)rows, 1};
  const cuuint32_t one[3] = {1, 1, 1};
  return encoder()(m, P::kType, 3, const_cast<void*>(ptr), dims, strides,
                   box, one, CU_TENSOR_MAP_INTERLEAVE_NONE, P::kSwizzle,
                   CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
                   CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

// bias rows TMA can stride: a multiple of 16 bytes, from 16-aligned bases
template <class P>
inline bool bias_tma_ok(int L, const void* a, const void* b = nullptr) {
  return (L * (int)sizeof(typename P::T)) % 16 == 0 && aligned16(a) &&
         (b == nullptr || aligned16(b));
}

}  // namespace sm90
