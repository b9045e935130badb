// One ChemicalOCR LM decode step through every layer in one cooperative
// launch: RMSNorm, int8 QKV, RoPE, int8 quantisation of the new K/V (written
// into the rings at column p), grouped ring attention with the new token's
// column, O projection, SwiGLU, residuals.
//
// Replaces markushgrapher_tpu/ops/megastep.py:ocr_megastep (and the ring
// writes of ocr/vlm.py:ChemicalOCRModel.decode_step_mega). The arithmetic and
// its rounding points are spelled out in ops/megastep.py; plain_megastep there
// is the same function in PyTorch.
//
// Bound: bytes. Each step reads every layer's int8 weights once (~315 MB for
// OCRConfig(): 32 layers x (1600 + 960 + 5120 + 960) rows of 960 or 2560
// bytes) plus the ring prefix [0, p) of K and V with their scales; compute is
// ~2 x batch operations per weight byte, far below the card's ratio.
//
// Design (simple first): one persistent grid, every block resident
// (cudaLaunchCooperativeKernel; grid.sync() needs no -rdc since CUDA 11),
// five phases per layer separated by grid-wide barriers:
//   1. every block normalises the float32 residual rows x [B, Dm] into shared
//      memory (bf16-rounded; one warp per row for the statistics), then warps
//      split the Dq + 2 Dkv output rows of the QKV weights: one warp reads
//      one int8 row once (4-byte loads, the warp's lanes on consecutive
//      words, 8 loads in flight per lane) and serves all B batch rows;
//   2. one block per (batch row, query head): RoPE, the group's K/V
//      quantisation (the group's first head writes the ring column p), then
//      the three passes of the decode kernels (scores of ring columns < p,
//      bf16-rounded p * v_scale, p * V with a thread on 4 columns of every
//      16th key), and the new token's column folded in last;
//   3. the O projection added into x (warps over the Dm rows);
//   4. RMSNorm again, gate and up rows per warp, mid = bf16(silu(g) * u);
//   5. the down projection added into x.
// Scratch written in one phase and read in a later one by other blocks is
// read with __ldcg (L2, not a possibly stale L1 line). Weight prefetch of
// layer l+1 (TMA) and tensor-core GEMVs are later work.

#include <cooperative_groups.h>
#include <cstdint>

#include "decode_common.cuh"

namespace cg = cooperative_groups;

namespace {

using mg_decode::block_reduce;
using mg_decode::kThreads;

constexpr int kWarps = kThreads / 32;
constexpr int kMaxB = 16;

struct Args {
  const __nv_bfloat16* x;
  __nv_bfloat16* out;
  float* scratch;  // xs [B, Dm] | qkv [B, Dq + 2 Dkv] | attn [B, Dq] | mid [B, F]
  const float* rope;  // [P, D/2, 2] (cos, sin)
  int8_t* kq;
  float* ks;
  int8_t* vq;
  float* vs;
  const int8_t* wqkv;
  const float* sqkv;
  const int8_t* wo;
  const float* so;
  const int8_t* wgu;
  const float* sgu;
  const int8_t* wd;
  const float* sd;
  const float* ln_a;
  const float* ln_m;
  int L, B, S, Dm, H, G, D, F, pos;
  float eps, inv_sqrt_d;
};

__device__ __forceinline__ float bf16r(float v) {
  return __bfloat162float(__float2bfloat16_rn(v));
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// byte e (0..3) of w, sign-extended
__device__ __forceinline__ float sbyte(uint32_t w, int e) {
  return (float)(((int)(w << (24 - 8 * e))) >> 24);
}

// h[b][i] = bf16(x[b][i] * rsqrt(mean_i x[b]^2 + eps) * ln[i]) for all B
// rows: one warp per row for the statistics, then every element at once
__device__ void load_norm(float* h, const float* xs, const float* ln,
                          const Args& a, float* rstd) {
  const int lane = threadIdx.x & 31;
  for (int b = threadIdx.x >> 5; b < a.B; b += kWarps) {
    const float* row = xs + (size_t)b * a.Dm;
    float ss = 0.f;
    for (int i = lane; i < a.Dm; i += 32) {
      const float v = __ldcg(row + i);
      ss = fmaf(v, v, ss);
    }
    const float var = __fdiv_rn(warp_sum(ss), (float)a.Dm);
    if (lane == 0) rstd[b] = rsqrtf(__fadd_rn(var, a.eps));
  }
  __syncthreads();
  for (int i = threadIdx.x; i < a.B * a.Dm; i += kThreads) {
    const int b = i / a.Dm;
    h[i] = bf16r(__fmul_rn(__fmul_rn(__ldcg(xs + i), rstd[b]), ln[i - b * a.Dm]));
  }
  __syncthreads();
}

__device__ void load_rows(float* h, const float* src, int n) {
  for (int i = threadIdx.x; i < n; i += kThreads) h[i] = __ldcg(src + i);
  __syncthreads();
}

// acc[b] += W[row, c..c+3] . h[b][c..c+3] over this lane's words of the
// row; the words are loaded kUnroll at a time before they are used, so a
// warp keeps kUnroll loads in flight instead of waiting on each
constexpr int kUnroll = 8;

__device__ __forceinline__ void row_dot(const int8_t* row, const float* h,
                                        int in, int B, float* acc) {
  for (int base = (threadIdx.x & 31) * 4; base < in; base += 128 * kUnroll) {
    uint32_t w[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const int c = base + 128 * u;
      w[u] = c < in ? __ldg(reinterpret_cast<const unsigned int*>(row + c))
                    : 0u;
    }
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const int c = base + 128 * u;
      if (c >= in) break;
      const float w0 = sbyte(w[u], 0), w1 = sbyte(w[u], 1),
                  w2 = sbyte(w[u], 2), w3 = sbyte(w[u], 3);
#pragma unroll
      for (int b = 0; b < kMaxB; ++b) {
        if (b < B) {
          const float4 hv = *reinterpret_cast<const float4*>(h + b * in + c);
          acc[b] = fmaf(w3, hv.w, fmaf(w2, hv.z, fmaf(w1, hv.y,
                                                       fmaf(w0, hv.x, acc[b]))));
        }
      }
    }
  }
}

// y[b][j] = (h[b] . W[j]) * s[j] for the N rows of W [N, in]; stored into
// out[b * N + j], or added to it (the residual)
template <bool kAdd>
__device__ void gemv(const float* h, const int8_t* W, const float* s, int N,
                     int in, int B, float* out) {
  const int lane = threadIdx.x & 31;
  for (int j = blockIdx.x * kWarps + (threadIdx.x >> 5); j < N;
       j += gridDim.x * kWarps) {
    float acc[kMaxB];
#pragma unroll
    for (int b = 0; b < kMaxB; ++b) acc[b] = 0.f;
    row_dot(W + (size_t)j * in, h, in, B, acc);
    const float sj = s[j];
#pragma unroll
    for (int b = 0; b < kMaxB; ++b) {
      if (b < B) {
        const float v = warp_sum(acc[b]);
        if (lane == 0) {
          float* o = out + (size_t)b * N + j;
          const float y = __fmul_rn(v, sj);
          *o = kAdd ? __fadd_rn(__ldcg(o), y) : y;
        }
      }
    }
  }
}

// mid[b][j] = bf16(silu(g) * u), g / u from gate row j and up row F + j
__device__ void gemv_gate_up(const float* h, const int8_t* W, const float* s,
                             int F, int in, int B, float* mid) {
  const int lane = threadIdx.x & 31;
  for (int j = blockIdx.x * kWarps + (threadIdx.x >> 5); j < F;
       j += gridDim.x * kWarps) {
    float ag[kMaxB], au[kMaxB];
#pragma unroll
    for (int b = 0; b < kMaxB; ++b) ag[b] = au[b] = 0.f;
    row_dot(W + (size_t)j * in, h, in, B, ag);
    row_dot(W + (size_t)(F + j) * in, h, in, B, au);
    const float sg = s[j], su = s[F + j];
#pragma unroll
    for (int b = 0; b < kMaxB; ++b) {
      if (b < B) {
        const float g = __fmul_rn(warp_sum(ag[b]), sg);
        const float u = __fmul_rn(warp_sum(au[b]), su);
        if (lane == 0) {
          const float sig = __fdiv_rn(1.f, __fadd_rn(1.f, expf(-g)));
          mid[(size_t)b * F + j] = bf16r(__fmul_rn(__fmul_rn(sig, g), u));
        }
      }
    }
  }
}

// phase 2 for layer l: one task per (batch row, query head)
__device__ void attention(const Args& a, int l, float* sm) {
  const int D = a.D, Dq = a.H * a.D, Dkv = a.G * a.D;
  const int nqkv = Dq + 2 * Dkv, rep = a.H / a.G, half = a.D / 2, p = a.pos;
  const int tid = threadIdx.x;
  const float* qkv = a.scratch + (size_t)a.B * a.Dm;
  float* attn = a.scratch + (size_t)a.B * (a.Dm + nqkv);
  float* raw = sm;             // [3 D]: q, k, v of this head / group
  float* qs = raw + 3 * D;     // [D] bf16(q / sqrt(d))
  float* kdq = qs + D;         // [D] dequantised new k
  float* vdq = kdq + D;        // [D]
  float* red = vdq + D;        // [kWarps]
  float* part = red + kWarps;  // [4 kThreads] column partials of pass 3
  float* sc = part + 4 * kThreads;  // [S] scores, then bf16(p * v_scale)

  for (int t = blockIdx.x; t < a.B * a.H; t += gridDim.x) {
    const int b = t / a.H, h = t % a.H, g = h / rep;
    const size_t lb = (size_t)l * a.B + b;
    const float* row = qkv + (size_t)b * nqkv;
    if (tid < D) {
      raw[tid] = __ldcg(row + h * D + tid);
      raw[D + tid] = __ldcg(row + Dq + g * D + tid);
      raw[2 * D + tid] = __ldcg(row + Dq + Dkv + g * D + tid);
    }
    __syncthreads();
    // RoPE at p: the rotated half from the bf16-rounded values
    float qv = 0.f, kv = 0.f, vv = 0.f;
    if (tid < D) {
      const float* cs = a.rope + ((size_t)p * half + tid % half) * 2;
      const int other = tid < half ? tid + half : tid - half;
      const float sign = tid < half ? -1.f : 1.f;
      qv = __fadd_rn(__fmul_rn(raw[tid], cs[0]),
                     __fmul_rn(sign * bf16r(raw[other]), cs[1]));
      kv = __fadd_rn(__fmul_rn(raw[D + tid], cs[0]),
                     __fmul_rn(sign * bf16r(raw[D + other]), cs[1]));
      vv = raw[2 * D + tid];
    }
    // the group's new K/V row, int8 per (row, kv head)
    const float kscale =
        __fadd_rn(__fdiv_rn(block_reduce(fabsf(kv), red, true), 127.f), 1e-8f);
    const float vscale =
        __fadd_rn(__fdiv_rn(block_reduce(fabsf(vv), red, true), 127.f), 1e-8f);
    if (tid < D) {
      const float kc = fminf(fmaxf(rintf(__fdiv_rn(kv, kscale)), -127.f), 127.f);
      const float vc = fminf(fmaxf(rintf(__fdiv_rn(vv, vscale)), -127.f), 127.f);
      kdq[tid] = __fmul_rn(kc, kscale);
      vdq[tid] = __fmul_rn(vc, vscale);
      qs[tid] = bf16r(__fmul_rn(qv, a.inv_sqrt_d));
      if (h % rep == 0) {
        const size_t at = (lb * a.S + p) * Dkv + (size_t)g * D + tid;
        a.kq[at] = (int8_t)kc;
        a.vq[at] = (int8_t)vc;
        if (tid == 0) {
          const size_t si = (lb * a.G + g) * a.S + p;
          a.ks[si] = kscale;
          a.vs[si] = vscale;
        }
      }
    }
    __syncthreads();

    // pass 1: scores of ring columns < p
    const int8_t* kbase = a.kq + lb * a.S * Dkv + (size_t)g * D;
    const float* ks_row = a.ks + (lb * a.G + g) * a.S;
    const float* vs_row = a.vs + (lb * a.G + g) * a.S;
    float lmax = -INFINITY;
    for (int k = tid; k < p; k += kThreads) {
      const int8_t* kr = kbase + (size_t)k * Dkv;
      float dot = 0.f;
      for (int d0 = 0; d0 < D; d0 += 4 * kUnroll) {
        uint32_t w[kUnroll];
#pragma unroll
        for (int u = 0; u < kUnroll; ++u)
          w[u] = d0 + 4 * u < D
                     ? *reinterpret_cast<const uint32_t*>(kr + d0 + 4 * u)
                     : 0u;
#pragma unroll
        for (int u = 0; u < kUnroll; ++u) {
          const int d = d0 + 4 * u;
          if (d >= D) break;
          dot = fmaf(qs[d + 3], sbyte(w[u], 3), fmaf(qs[d + 2], sbyte(w[u], 2),
                fmaf(qs[d + 1], sbyte(w[u], 1), fmaf(qs[d], sbyte(w[u], 0),
                                                     dot))));
        }
      }
      const float s = __fmul_rn(dot, ks_row[k]);
      sc[k] = s;
      lmax = fmaxf(lmax, s);
    }
    const float m1 = block_reduce(lmax, red, true);
    // pass 2: w = exp(s - m), l = sum w, bf16(w * v_scale)
    float lsum = 0.f;
    for (int k = tid; k < p; k += kThreads) {
      const float e = expf(sc[k] - m1);
      lsum += e;
      sc[k] = bf16r(__fmul_rn(e, vs_row[k]));
    }
    const float l1 = block_reduce(lsum, red, false);
    const float s_new =
        block_reduce(tid < D ? __fmul_rn(qs[tid], kdq[tid]) : 0.f, red, false);
    // pass 3: sum_k pv_k * v[k, g*D + c]; a thread takes 4 columns (one
    // word) of every kgroups-th key, 4 keys' words loaded at a time
    const int quads = D / 4, kgroups = kThreads / quads;
    const int c4 = (tid % quads) * 4, kg = tid / quads;
    const int8_t* vcol = a.vq + lb * a.S * Dkv + (size_t)g * D + c4;
    float acc[4] = {0.f, 0.f, 0.f, 0.f};
    for (int k0 = kg; k0 < p; k0 += 4 * kgroups) {
      uint32_t w[4];
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        const int k = k0 + u * kgroups;
        w[u] = k < p ? *reinterpret_cast<const uint32_t*>(vcol + (size_t)k * Dkv)
                     : 0u;
      }
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        const int k = k0 + u * kgroups;
        if (k >= p) break;
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[e] = fmaf(sc[k], sbyte(w[u], e), acc[e]);
      }
    }
#pragma unroll
    for (int e = 0; e < 4; ++e) part[kg * D + c4 + e] = acc[e];
    __syncthreads();
    if (tid < D) {
      float o = 0.f;
      for (int gg = 0; gg < kgroups; ++gg) o += part[gg * D + tid];
      // the new token's column (m1 = -inf when p = 0: alpha = 0)
      const float m2 = fmaxf(m1, s_new);
      const float alpha = expf(m1 - m2);
      const float pn = expf(s_new - m2);
      const float den = __fadd_rn(__fmul_rn(l1, alpha), pn);
      const float num = __fadd_rn(__fmul_rn(o, alpha), __fmul_rn(pn, vdq[tid]));
      attn[(size_t)b * Dq + h * D + tid] =
          bf16r(__fdiv_rn(num, fmaxf(den, 1e-30f)));
    }
    __syncthreads();
  }
}

__global__ void __launch_bounds__(kThreads)
ocr_megastep_kernel(const Args a) {
  cg::grid_group grid = cg::this_grid();
  extern __shared__ __align__(16) float sm[];
  float* rstd = sm;              // [kMaxB] RMSNorm scales of the rows
  float* h = sm + kMaxB;         // activation rows [B][in], 16-byte aligned
  const int Dq = a.H * a.D, nqkv = Dq + 2 * a.G * a.D;
  float* xs = a.scratch;
  float* qkv = xs + (size_t)a.B * a.Dm;
  float* attn = qkv + (size_t)a.B * nqkv;
  float* mid = attn + (size_t)a.B * Dq;
  const size_t n = (size_t)a.B * a.Dm;
  const size_t gtid = (size_t)blockIdx.x * kThreads + threadIdx.x;
  const size_t gstride = (size_t)gridDim.x * kThreads;

  for (size_t i = gtid; i < n; i += gstride) xs[i] = __bfloat162float(a.x[i]);
  grid.sync();
  for (int l = 0; l < a.L; ++l) {
    load_norm(h, xs, a.ln_a + (size_t)l * a.Dm, a, rstd);
    gemv<false>(h, a.wqkv + (size_t)l * nqkv * a.Dm, a.sqkv + (size_t)l * nqkv,
                nqkv, a.Dm, a.B, qkv);
    grid.sync();
    attention(a, l, sm);
    grid.sync();
    load_rows(h, attn, a.B * Dq);
    gemv<true>(h, a.wo + (size_t)l * a.Dm * Dq, a.so + (size_t)l * a.Dm, a.Dm,
               Dq, a.B, xs);
    grid.sync();
    load_norm(h, xs, a.ln_m + (size_t)l * a.Dm, a, rstd);
    gemv_gate_up(h, a.wgu + (size_t)l * 2 * a.F * a.Dm,
                 a.sgu + (size_t)l * 2 * a.F, a.F, a.Dm, a.B, mid);
    grid.sync();
    load_rows(h, mid, a.B * a.F);
    gemv<true>(h, a.wd + (size_t)l * a.Dm * a.F, a.sd + (size_t)l * a.Dm, a.Dm,
               a.F, a.B, xs);
    grid.sync();
  }
  for (size_t i = gtid; i < n; i += gstride)
    a.out[i] = __float2bfloat16_rn(__ldcg(xs + i));
}

size_t smem_bytes(const Args& a) {
  const int widest = a.Dm > a.F ? (a.Dm > a.H * a.D ? a.Dm : a.H * a.D)
                                : (a.F > a.H * a.D ? a.F : a.H * a.D);
  const size_t gemv = kMaxB + (size_t)a.B * widest;
  const size_t att = 6 * (size_t)a.D + kWarps + 4 * kThreads + a.S;
  return (gemv > att ? gemv : att) * sizeof(float);
}

}  // namespace

extern "C" int mg_ocr_megastep(
    const void* x, void* out, float* scratch, const float* rope, int8_t* kq,
    float* ks, int8_t* vq, float* vs, const int8_t* wqkv, const float* sqkv,
    const int8_t* wo, const float* so, const int8_t* wgu, const float* sgu,
    const int8_t* wd, const float* sd, const float* ln_a, const float* ln_m,
    int L, int B, int S, int Dm, int H, int G, int D, int F, int pos,
    float eps, float inv_sqrt_d, void* stream) {
  if (L <= 0 || B <= 0 || B > kMaxB || H <= 0 || G <= 0 || H % G != 0 ||
      D <= 0 || D % 4 != 0 || D > kThreads || kThreads % D != 0 ||
      Dm % 4 != 0 || F % 4 != 0 || pos < 0 || pos >= S)
    return (int)cudaErrorInvalidValue;
  const Args a{(const __nv_bfloat16*)x, (__nv_bfloat16*)out, scratch, rope,
               kq, ks, vq, vs, wqkv, sqkv, wo, so, wgu, sgu, wd, sd, ln_a,
               ln_m, L, B, S, Dm, H, G, D, F, pos, eps, inv_sqrt_d};
  const size_t smem = smem_bytes(a);
  cudaError_t e = cudaFuncSetAttribute(
      ocr_megastep_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (e != cudaSuccess) return (int)e;
  int dev = 0, sms = 0, coop = 0, per_sm = 0;
  if ((e = cudaGetDevice(&dev)) != cudaSuccess ||
      (e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev)) !=
          cudaSuccess ||
      (e = cudaDeviceGetAttribute(&coop, cudaDevAttrCooperativeLaunch, dev)) !=
          cudaSuccess ||
      (e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
           &per_sm, ocr_megastep_kernel, kThreads, smem)) != cudaSuccess)
    return (int)e;
  if (!coop || per_sm < 1) return (int)cudaErrorCooperativeLaunchTooLarge;
  // two blocks per SM where they fit (264 on an H100)
  const int blocks = sms * (per_sm < 2 ? per_sm : 2);
  void* params[] = {(void*)&a};
  e = cudaLaunchCooperativeKernel((void*)ocr_megastep_kernel, dim3(blocks),
                                  dim3(kThreads), params, smem,
                                  (cudaStream_t)stream);
  if (e != cudaSuccess) return (int)e;
  return (int)cudaGetLastError();
}
