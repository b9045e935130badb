// Quantised decode projections: y[r, n] = x[r, :] . W[n, :] under one of
// three weight forms, in one call (ops/wq_linear.py, the wrapper and the
// plain version):
//   mode 0, int8 weights W [N, K]:  y = bf16(f32(bf16(sum_k x q)) * s[n])
//   mode 1, int4 weights, packed two codes a byte along K (byte j: code 2j
//           in the low nibble, 2j + 1 in the high one), the same formula;
//   mode 2, W8A8: x quantised per row to int8 (s_x = amax / 127 + 1e-12,
//           codes round(x / s_x) half to even), then
//           y = bf16(f32(sum_k xq q) * s_x[r] * s[n]).
// x is bf16 [rows, K], K a multiple of 64; scales float32 [N].
//
// Replaces no Pallas kernel: the JAX package leaves these products to XLA,
// which fuses the convert into the dot (markushgrapher_tpu/models/t5.py
// `_deq`) or runs the s8 dot natively (`_dot8`). The port's plain form
// takes about five launches a projection (the cast of the whole weight,
// the product, three elementwise passes); this is one, or two under W8A8.
//
// Bound: bytes, the weight read once (N K or N K / 2 bytes) at decode's
// 8-240 rows, where the products are a few hundred operations a weight
// byte at most. Design, simple first: one CTA of 8 warps for each 16
// output channels (one m16 tile of mma.sync, the weights as the A operand
// and the rows of x as the n8 columns, so that a batch of 8 rows fills the
// tile). Each lane copies, with cp.async, exactly the weight bytes it will
// use into shared memory, all of them at once in four commit groups, and
// waits for a group just before it needs it: no barrier, and every byte of
// the CTA's weights in flight from the start. K goes in chunks of 64, dealt
// to the warps in turn; within a chunk lane t of a quad owns k in
// [16 t, 16 t + 16), so its weight bytes and its x values are each one
// contiguous 16- or 32-byte load, and the mma's k order is a permutation
// of the chunk's (the same for both operands, so the sum is the same).
// Codes become bf16 in registers, exactly: a code u placed in the mantissa
// of 2^23 + u as a float, 2^23 plus the offset subtracted, the upper half
// kept. The rows go in passes of up to kMaxTiles tiles of 8 rows, whose
// float32 (int32 under W8A8) sums stay in registers while the warp walks
// its chunks; each pass ends with the 8 warps' partial sums added in warp
// order through shared memory (deterministic) and the epilogue. So every
// weight byte leaves HBM once a call. W8A8's row quantiser is a launch of
// its own before the product, one CTA a row, with IEEE division
// (__fdiv_rn, no contraction) and round half to even (__float2int_rn), as
// the plain version and the JAX package (outside jit) compute it; the s8
// sums are exact, so W8A8 is bit for bit the plain version.

#include <cstdint>
#include <type_traits>

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kWarps = 8;
constexpr int kThreads = kWarps * 32;
constexpr int kChannels = 16;  // output channels of a CTA (the m16 tile)
constexpr int kChunk = 64;     // k values of a chunk; a lane owns 16
constexpr int kMaxTiles = 8;   // 8-row tiles of a pass
constexpr int kGroups = 4;     // cp.async commit groups of a lane's chunks

enum Mode { kI8 = 0, kI4 = 1, kW8A8 = 2 };

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// a copy of kBytes, zeros where !valid (src-size 0 reads nothing)
template <int kBytes>
__device__ __forceinline__ void cp_async(uint32_t dst, const void* src,
                                         bool valid) {
  const int n = valid ? kBytes : 0;
  if constexpr (kBytes == 16)
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst),
                 "l"(src), "r"(n)
                 : "memory");
  else
    asm volatile("cp.async.ca.shared.global [%0], [%1], %2, %3;\n" ::"r"(dst),
                 "l"(src), "n"(kBytes), "r"(n)
                 : "memory");
}

__device__ __forceinline__ void cp_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// wait until at most `pending` of this lane's groups are in flight
__device__ __forceinline__ void cp_wait(int pending) {
  switch (pending) {
    case 0: asm volatile("cp.async.wait_group 0;\n" ::: "memory"); break;
    case 1: asm volatile("cp.async.wait_group 1;\n" ::: "memory"); break;
    case 2: asm volatile("cp.async.wait_group 2;\n" ::: "memory"); break;
    default: asm volatile("cp.async.wait_group 3;\n" ::: "memory"); break;
  }
}

__device__ __forceinline__ void mma_bf16(float (&c)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0,%1,%2,%3}, "
      "{%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ void mma_s8(int (&c)[4], const uint32_t (&a)[4],
                                       uint32_t b0, uint32_t b1) {
  asm("mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 {%0,%1,%2,%3}, "
      "{%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+r"(c[0]), "+r"(c[1]), "+r"(c[2]), "+r"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// the bf16 pair (lo = a, hi = b) of two floats holding small integers,
// whose lower 16 bits are zero: the upper halves, exact
__device__ __forceinline__ uint32_t bf16_pair(float a, float b) {
  return __byte_perm(__float_as_uint(a), __float_as_uint(b), 0x7632);
}

// 4 int8 codes (byte i = code i) -> bf16 pairs (codes 0, 1) and (2, 3):
// 2^23 + (code + 128) as a float, less 2^23 + 128
__device__ __forceinline__ void deq_i8(uint32_t w, uint32_t& p01,
                                       uint32_t& p23) {
  const uint32_t u = w ^ 0x80808080u;
  const float off = 8388736.0f;
  const float f0 = __uint_as_float(__byte_perm(u, 0x4B000000u, 0x7440)) - off;
  const float f1 = __uint_as_float(__byte_perm(u, 0x4B000000u, 0x7441)) - off;
  const float f2 = __uint_as_float(__byte_perm(u, 0x4B000000u, 0x7442)) - off;
  const float f3 = __uint_as_float(__byte_perm(u, 0x4B000000u, 0x7443)) - off;
  p01 = bf16_pair(f0, f1);
  p23 = bf16_pair(f2, f3);
}

// 8 int4 codes (nibble i = code i) -> bf16 pairs p[m] = (codes 2m, 2m + 1)
__device__ __forceinline__ void deq_i4(uint32_t w, uint32_t (&p)[4]) {
  const uint32_t u = w ^ 0x88888888u;
  const float off = 8388616.0f;
#pragma unroll
  for (int m = 0; m < 4; ++m) {
    const float a =
        __uint_as_float(0x4B000000u | ((u >> (8 * m)) & 0xFu)) - off;
    const float b =
        __uint_as_float(0x4B000000u | ((u >> (8 * m + 4)) & 0xFu)) - off;
    p[m] = bf16_pair(a, b);
  }
}

// The A operands of one chunk for both channel rows of the lane (c = g and
// c = g + 8), and the product with one 8-row tile of x. bf16 modes: four
// m16n8k16 steps, step j over the lane's k 4j .. 4j + 3 (a0 / b0 the first
// pair, a2 / b1 the second); W8A8: two m16n8k32 steps over 8 bytes each.
template <int M>
struct Chunk {
  uint32_t a[M == kW8A8 ? 2 : 4][4];

  __device__ __forceinline__ void load(const uint8_t* lo, const uint8_t* hi) {
    if constexpr (M == kI4) {
      const uint2 wl = *reinterpret_cast<const uint2*>(lo);
      const uint2 wh = *reinterpret_cast<const uint2*>(hi);
      const uint32_t wls[2] = {wl.x, wl.y}, whs[2] = {wh.x, wh.y};
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        uint32_t pl[4], ph[4];
        deq_i4(wls[h], pl);
        deq_i4(whs[h], ph);
#pragma unroll
        for (int s = 0; s < 2; ++s) {
          uint32_t* f = a[2 * h + s];
          f[0] = pl[2 * s];
          f[1] = ph[2 * s];
          f[2] = pl[2 * s + 1];
          f[3] = ph[2 * s + 1];
        }
      }
    } else {
      const uint4 wl = *reinterpret_cast<const uint4*>(lo);
      const uint4 wh = *reinterpret_cast<const uint4*>(hi);
      const uint32_t wls[4] = {wl.x, wl.y, wl.z, wl.w};
      const uint32_t whs[4] = {wh.x, wh.y, wh.z, wh.w};
      if constexpr (M == kW8A8) {
#pragma unroll
        for (int j = 0; j < 2; ++j) {
          a[j][0] = wls[2 * j];
          a[j][1] = whs[2 * j];
          a[j][2] = wls[2 * j + 1];
          a[j][3] = whs[2 * j + 1];
        }
      } else {
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          deq_i8(wls[j], a[j][0], a[j][2]);
          deq_i8(whs[j], a[j][1], a[j][3]);
        }
      }
    }
  }
};

template <int M>
using Acc = typename std::conditional<M == kW8A8, int, float>::type;

// x of one tile row for the lane: 16 bf16 (two uint4) or 16 int8 (one)
template <int M>
struct XFrag {
  uint32_t v[M == kW8A8 ? 4 : 8];
};

template <int M>
__device__ __forceinline__ XFrag<M> load_x(const void* x, int row, int rows,
                                           int K, int k0) {
  XFrag<M> f;
  if (row >= rows) {
#pragma unroll
    for (auto& e : f.v) e = 0u;
    return f;
  }
  if constexpr (M == kW8A8) {
    const uint4 q = __ldg(reinterpret_cast<const uint4*>(
        static_cast<const int8_t*>(x) + (size_t)row * K + k0));
    f.v[0] = q.x, f.v[1] = q.y, f.v[2] = q.z, f.v[3] = q.w;
  } else {
    const uint4* p = reinterpret_cast<const uint4*>(
        static_cast<const __nv_bfloat16*>(x) + (size_t)row * K + k0);
    const uint4 q0 = __ldg(p), q1 = __ldg(p + 1);
    f.v[0] = q0.x, f.v[1] = q0.y, f.v[2] = q0.z, f.v[3] = q0.w;
    f.v[4] = q1.x, f.v[5] = q1.y, f.v[6] = q1.z, f.v[7] = q1.w;
  }
  return f;
}

// x: bf16 [rows, K], or under W8A8 its int8 codes, with s_x [rows]
template <int M, int kTiles>
__global__ void __launch_bounds__(kThreads)
    wq_linear_kernel(const void* __restrict__ x,
                     const uint8_t* __restrict__ w,
                     const float* __restrict__ ws,
                     const float* __restrict__ sx, int rows, int K, int N,
                     __nv_bfloat16* __restrict__ out) {
  // weight bytes a lane holds of one channel row of a chunk
  constexpr int kSeg = M == kI4 ? 8 : 16;
  extern __shared__ __align__(16) uint8_t smem[];
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane / 4, t = lane % 4;
  const int n0 = blockIdx.x * kChannels;
  const int chunks = K / kChunk;
  // this warp's chunks: warp, warp + kWarps, ...
  const int mine = chunks > warp ? (chunks - warp + kWarps - 1) / kWarps : 0;
  const size_t row_bytes = (size_t)chunks * 4 * kSeg;
  // the weight tile, chunk-major: [chunk][channel][lane t][kSeg bytes]
  uint8_t* tile = smem;
  Acc<M>* red = reinterpret_cast<Acc<M>*>(smem + chunks * kChannels * 4 *
                                          kSeg);  // [warp][tiles * 4][lane]

  for (int grp = 0; grp < kGroups; ++grp) {
    for (int j = grp * mine / kGroups; j < (grp + 1) * mine / kGroups; ++j) {
      const int c = warp + j * kWarps;
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int ch = g + 8 * h;
        const int n = n0 + ch;
        const uint8_t* src = w + (size_t)(n < N ? n : N - 1) * row_bytes +
                             (size_t)c * 4 * kSeg + t * kSeg;
        cp_async<kSeg>(smem_addr(tile + ((c * kChannels + ch) * 4 + t) * kSeg),
                       src, n < N);
      }
    }
    cp_commit();
  }

  const int tiles = (rows + 7) / 8;
  for (int tile0 = 0; tile0 < tiles; tile0 += kTiles) {
    Acc<M> acc[kTiles][4];
#pragma unroll
    for (int n = 0; n < kTiles; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[n][e] = 0;
    for (int grp = 0; grp < kGroups; ++grp) {
      cp_wait(kGroups - 1 - grp);
      for (int j = grp * mine / kGroups; j < (grp + 1) * mine / kGroups;
           ++j) {
        const int c = warp + j * kWarps;
        const uint8_t* lo = tile + ((c * kChannels + g) * 4 + t) * kSeg;
        Chunk<M> ch;
        ch.load(lo, lo + 8 * 4 * kSeg);
        const int k0 = c * kChunk + 16 * t;
        XFrag<M> xf[kTiles];
#pragma unroll
        for (int n = 0; n < kTiles; ++n)
          xf[n] = load_x<M>(x, (tile0 + n) * 8 + g, rows, K, k0);
#pragma unroll
        for (int n = 0; n < kTiles; ++n) {
          if constexpr (M == kW8A8) {
#pragma unroll
            for (int s = 0; s < 2; ++s)
              mma_s8(acc[n], ch.a[s], xf[n].v[2 * s], xf[n].v[2 * s + 1]);
          } else {
#pragma unroll
            for (int s = 0; s < 4; ++s)
              mma_bf16(acc[n], ch.a[s], xf[n].v[2 * s], xf[n].v[2 * s + 1]);
          }
        }
      }
    }
    // the warps' partial sums, added in warp order
#pragma unroll
    for (int n = 0; n < kTiles; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e)
        red[((warp * kTiles + n) * 4 + e) * 32 + lane] = acc[n][e];
    __syncthreads();
    for (int i = threadIdx.x; i < kTiles * 4 * 32; i += kThreads) {
      Acc<M> sum = red[i];
#pragma unroll
      for (int v = 1; v < kWarps; ++v) sum += red[v * kTiles * 4 * 32 + i];
      const int l = i % 32, ne = i / 32, e = ne % 4;
      const int ch = n0 + l / 4 + 8 * (e >> 1);
      const int r = (tile0 + ne / 4) * 8 + 2 * (l % 4) + (e & 1);
      if (ch < N && r < rows) {
        float y;
        if constexpr (M == kW8A8)
          y = __fmul_rn(__fmul_rn(__int2float_rn(sum), sx[r]), ws[ch]);
        else
          y = __fmul_rn(__bfloat162float(__float2bfloat16_rn(sum)), ws[ch]);
        out[(size_t)r * N + ch] = __float2bfloat16_rn(y);
      }
    }
    __syncthreads();
  }
}

// W8A8's row quantiser: one CTA a row of x [rows, K] (K a multiple of 8)
__global__ void __launch_bounds__(kThreads)
    wq_linear_act_q8(const __nv_bfloat16* __restrict__ x, int K,
                     int8_t* __restrict__ xq, float* __restrict__ sx) {
  __shared__ float part[kWarps];
  const int row = blockIdx.x;
  const uint4* xr = reinterpret_cast<const uint4*>(x + (size_t)row * K);
  float m = 0.0f;
  for (int i = threadIdx.x; i < K / 8; i += kThreads) {
    const uint4 v = __ldg(xr + i);
    const uint32_t ws[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
    for (int h = 0; h < 4; ++h)
      m = fmaxf(m, fmaxf(fabsf(__uint_as_float(ws[h] << 16)),
                         fabsf(__uint_as_float(ws[h] & 0xFFFF0000u))));
  }
#pragma unroll
  for (int o = 16; o > 0; o /= 2) m = fmaxf(m, __shfl_xor_sync(~0u, m, o));
  if (threadIdx.x % 32 == 0) part[threadIdx.x / 32] = m;
  __syncthreads();
  m = part[0];
#pragma unroll
  for (int v = 1; v < kWarps; ++v) m = fmaxf(m, part[v]);
  const float s = __fadd_rn(__fdiv_rn(m, 127.0f), 1e-12f);
  if (threadIdx.x == 0) sx[row] = s;
  uint2* qr = reinterpret_cast<uint2*>(xq + (size_t)row * K);
  for (int i = threadIdx.x; i < K / 8; i += kThreads) {
    const uint4 v = __ldg(xr + i);
    const uint32_t ws[4] = {v.x, v.y, v.z, v.w};
    uint32_t q[2] = {0u, 0u};
#pragma unroll
    for (int e = 0; e < 8; ++e) {
      const uint32_t bits = e % 2 ? ws[e / 2] & 0xFFFF0000u : ws[e / 2] << 16;
      const int c = __float2int_rn(__fdiv_rn(__uint_as_float(bits), s));
      q[e / 4] |= (uint32_t)(c & 0xFF) << (8 * (e % 4));
    }
    qr[i] = make_uint2(q[0], q[1]);
  }
}

using Kernel = void (*)(const void*, const uint8_t*, const float*,
                        const float*, int, int, int, __nv_bfloat16*);

template <int M>
Kernel kernel_for(int tiles) {
  switch (tiles) {
    case 1: return wq_linear_kernel<M, 1>;
    case 2: return wq_linear_kernel<M, 2>;
    case 3: return wq_linear_kernel<M, 3>;
    case 4: return wq_linear_kernel<M, 4>;
    case 5: return wq_linear_kernel<M, 5>;
    case 6: return wq_linear_kernel<M, 6>;
    case 7: return wq_linear_kernel<M, 7>;
    default: return wq_linear_kernel<M, 8>;
  }
}

}  // namespace

// x bf16 [rows, K]; w int8 [N, K] (modes 0, 2) or packed int4 [N, K / 2]
// (mode 1); ws float32 [N]; under mode 2 xq int8 [rows, K] and sx float32
// [rows] are scratch the row quantiser fills; out bf16 [rows, N]. All
// pointers 16-byte aligned.
extern "C" int mg_wq_linear(const void* x, const void* w, const float* ws,
                            int rows, int K, int N, int mode, void* xq,
                            float* sx, void* out, void* stream) {
  if (rows <= 0 || N <= 0 || K <= 0 || K % kChunk || mode < kI8 ||
      mode > kW8A8)
    return (int)cudaErrorInvalidValue;
  const void* ptrs[4] = {x, w, xq, out};
  for (const void* p : ptrs)
    if (reinterpret_cast<uintptr_t>(p) % 16) return (int)cudaErrorInvalidValue;
  const int tiles = (rows + 7) / 8;
  const int passes = (tiles + kMaxTiles - 1) / kMaxTiles;
  const int per_pass = (tiles + passes - 1) / passes;
  const int seg = mode == kI4 ? 8 : 16;
  const size_t smem = (size_t)(K / kChunk) * kChannels * 4 * seg +
                      (size_t)kWarps * per_pass * 4 * 32 * 4;
  if (smem > 232448) return (int)cudaErrorInvalidValue;
  const Kernel kernel = mode == kI8   ? kernel_for<kI8>(per_pass)
                        : mode == kI4 ? kernel_for<kI4>(per_pass)
                                      : kernel_for<kW8A8>(per_pass);
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const void* operand = x;
  if (mode == kW8A8) {
    wq_linear_act_q8<<<rows, kThreads, 0, st>>>(
        static_cast<const __nv_bfloat16*>(x), K, static_cast<int8_t*>(xq),
        sx);
    err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
    operand = xq;
  }
  kernel<<<(N + kChannels - 1) / kChannels, kThreads, smem, st>>>(
      operand, static_cast<const uint8_t*>(w), ws, sx, rows, K, N,
      static_cast<__nv_bfloat16*>(out));
  return (int)cudaGetLastError();
}
