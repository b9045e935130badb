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
// bytes) plus the ring prefix [0, p) of K and V with their scales: 0.100 ms
// at B=8, p=103 and 0.121 ms at p=503 over 3.35 TB/s. The arithmetic is
// 2 B operations per weight byte, far below the card's ratio. What the step
// cannot avoid on this design is latency: five phases per layer, each
// reading what other SMs wrote in the phase before, behind a grid barrier.
//
// Design. One persistent block per SM (cudaLaunchCooperativeKernel keeps
// them all resident), five phases per layer between grid barriers: QKV,
// attention, O, gate + up, down. Each phase is one code path (a loop over
// the 5 L phases), so the code a layer runs is fetched once per layer.
//  - Weights never wait on a barrier. The output rows of each GEMV are cut
//    into tiles of 16 rows (gate + up: 8 gate rows over the same 8 up rows,
//    so that one thread holds g and u of a column); a block owns one
//    contiguous run of tiles per GEMV and keeps all four runs in shared
//    memory, with their row scales and the RMSNorm weights: one 1-D bulk
//    copy (TMA) per run. The next layer's runs are copied into the same rows
//    as soon as the next GEMV phase has queued its own copies, and land
//    while the other phases run.
//  - GEMVs on the tensor cores: mma.sync m16n8k16 bf16 with float32
//    accumulation, weight rows as M, batch rows as N (tiles of 8; any B is a
//    loop over groups of up to 48 rows), the activations as B. Each int8
//    weight word becomes two bf16x2 registers exactly (byte permute into
//    0x43XX halves, then 0x4300 | (x & 0x7f) - (0x4300 | (x & 0x80))). The
//    k order inside an MMA is free as long as A and B agree: a thread takes
//    16 consecutive bytes of its two rows (four k steps) and 16 consecutive
//    activations, so every operand load is 16 bytes. The warps split K and
//    add their partial tiles in shared memory in a fixed order; the epilogue
//    applies the row scale as the plain version does.
//  - Activations: h (RMSNorm output), attn and mid are bf16-valued, so attn
//    and mid live in scratch as bf16, in rows padded as they are staged:
//    one bulk copy brings a phase's rows, completed on an mbarrier (K in
//    chunks when the rows do not fit). The residual x stays float32; the
//    blocks that write x also write each row's sum of squares over their 16
//    columns, right after x in scratch, so one copy brings both, and the
//    RMSNorm statistic is 60 partial sums, a warp per row.
//  - Attention: one task per (batch row, kv head, chunk of its query heads:
//    the fewest, at most 4, whose tasks still fit on the grid), so the int8
//    K/V rows are read once per chunk. Its ring slice and q / k / v rows are
//    copied into shared memory (cp.async) at once; RoPE and the new row's
//    quantisation run while the slice arrives. Scores of 16 keys at a time
//    on the tensor cores (K rows as M, the chunk's bf16 queries as N); the
//    global max, exp and bf16(p * v_scale) as the TPU kernel rounds them;
//    P V on the CUDA cores with 16 columns per thread; the new token's
//    column folded in last from its dequantised K/V.
//  - The grid barrier is a release reduction per block on the launch's
//    arrival count (in its scratch, zeroed on the stream before the
//    launch) and an acquire poll (no returned value on the arriving side).
// Data written in the launch is read through L2 (bulk copies, cp.async.cg;
// the ring scales, whose only column written here is never read, by
// cp.async.ca).
//
// Measured on an NVIDIA H100 80GB HBM3 at 700 W (PERF.md): the phases' time
// goes to the barrier, each block's first read of what the phase before
// wrote, and the per-SM conversion and MMA work of the GEMVs, not to bytes.
//
// Instances, and what each buys (megastep_bench.py, OCRConfig() width,
// copies of this file with the pick replaced, timed in turns; the
// run-to-run spread of one build is under 0.1 %):
//  - the kernel on 1, 2 or 6 N tiles of 8 rows (B <= 8, <= 16, more): 6
//    tiles for every batch takes 2.0x the time at B = 8 and 1.6x at B = 16;
//  - attention<64> (the OCR model's head dim) beside attention<0> (any):
//    the generic one takes 0.9-1.2 % longer at B = 8, 2.9-4.8 % at B = 16
//    (p = 103 / 503);
//  - head dims that are no multiple of 16 (4, 8) stage keys by 4 bytes and
//    take scores and P V (pv_accumulate<4>) on the CUDA cores: a shape the
//    wrapper accepts, not a speed-up.
// tests/test_torch_kernels_cuda.py::test_megastep_matches_plain runs each.

#include <algorithm>
#include <cstdint>

#include "sm90.cuh"

namespace {

// Built with -DMEGASTEP_TRACE (megastep_bench.py --trace), thread 0 of
// each block stamps clock64 and %globaltimer at six events of each phase of
// the first 32 layers: GEMVs at entry, once the staging is queued and the
// weights have arrived, before the staged activations are waited for,
// before the first MMA, after the first round's MMA (behind a block
// barrier: event 4 of a GEMV phase, a block-uniform point), at the end; the
// attention at entry, once its q / k / v have arrived, before passes 1, 2
// and 3, at the end. mg_ocr_megastep_trace reads them: PERF.md's per-phase
// microseconds of a layer. Off, the hook compiles to nothing.
#ifdef MEGASTEP_TRACE
constexpr int kTraceBlocks = 132, kTraceLayers = 32;
__device__ unsigned long long g_trace[2][kTraceBlocks][kTraceLayers][5][6];
__device__ __forceinline__ void trace_stamp(int l, int phase, int ev) {
  if (ev == 4 && phase != 1) __syncthreads();
  if (threadIdx.x == 0 && l < kTraceLayers && blockIdx.x < kTraceBlocks) {
    unsigned long long t;
    asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
    g_trace[0][blockIdx.x][l][phase][ev] = clock64();
    g_trace[1][blockIdx.x][l][phase][ev] = t;
  }
}
#define MEGA_TRACE(l, phase, ev) trace_stamp(l, phase, ev)
#else
#define MEGA_TRACE(l, phase, ev) ((void)(l), (void)(phase), (void)(ev))
#endif

using sm90::mbar_arrive_tx;
using sm90::mbar_init;
using sm90::mbar_wait;
using sm90::smem_u32;

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kMaxMT = 3;  // weight tiles accumulated at once per block
constexpr int kMaxH = 4;   // query heads per attention task
constexpr int kSmemMax = 232448;
constexpr int kBars = 5;   // one per GEMV's weights, one for activations
enum { kQKV = 0, kO = 1, kGU = 2, kDown = 3, kAct = 4 };

struct Args {
  const __nv_bfloat16* x;
  __nv_bfloat16* out;
  const float* rope;  // [P, D/2, 2] (cos, sin)
  int8_t* kq;
  float* ks;
  int8_t* vq;
  float* vs;
  const int8_t* w[4];  // wqkv, wo, wgu, wd: [L, N, K]
  const float* s[4];   // their per-row scales [L, N]
  const float* ln_a;
  const float* ln_m;
  // scratch: the grid barrier's arrival count (alone in 256 bytes, zeroed
  // before each launch), x float32 [B, Dm], row sums of squares [B, ntsp], qkv
  // float32 [B, nqkv], attn bf16 [B, Dq + 8], mid bf16 [B, F + 8] (rows
  // padded by 16 bytes, as staged)
  unsigned long long* arrivals;
  float* xs;
  float* ssp;
  float* qkv;
  __nv_bfloat16* attn;
  __nv_bfloat16* mid;
  int L, B, S, Dm, H, G, D, F, pos;
  float eps, inv_sqrt_d;
  int Dq, Dkv, nqkv, ntsp;
  // per GEMV: output rows, K, tiles, block offset, most tiles of one block,
  // shared row stride of the weights, staged K chunk, staged row stride
  int N[4], K[4], T[4], off[4], maxt[4], KC[4], SA[4];
  int nb, NG, kH, hpt, tasks, PC;
  // shared memory byte offsets: the rope row at p, the residual's columns
  // of the O / down tiles, the RMSNorm weights, each GEMV's row scales and
  // weight tiles, the warps' partial tiles, and the region that holds a
  // phase's staged activations or an attention task's slice
  int o_rope, o_xo, o_lna, o_lnm, o_sw[4], o_w[4], o_red, o_reg, smem;
};

__device__ __forceinline__ float bf16r(float v) {
  return __bfloat162float(__float2bfloat16_rn(v));
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1)
    v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

// sum over the 16-lane half of the warp (fixed order)
__device__ __forceinline__ float half_sum(float v) {
#pragma unroll
  for (int o = 8; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// ---- int8 -> bf16 / float32, exact

// t = [x0, 0x43, x1, 0x43] -> bf16x2 (x0, x1): 0x43XX is 128 + (x & 0x7f)
// for the low seven bits; subtracting 0x4300 (128) or 0x4380 (256) by the
// sign bit leaves x exactly
__device__ __forceinline__ uint32_t bf16x2_of(uint32_t t) {
  const uint32_t a = t & 0xff7fff7fu;
  const uint32_t s = (t & 0x00800080u) | 0x43004300u;
  uint32_t d;
  asm("sub.rn.bf16x2 %0, %1, %2;" : "=r"(d) : "r"(a), "r"(s));
  return d;
}

// the four int8 of w as bf16x2 (bytes 0, 1) and (bytes 2, 3)
__device__ __forceinline__ void i8x4_bf16(uint32_t w, uint32_t& lo,
                                          uint32_t& hi) {
  lo = bf16x2_of(__byte_perm(w, 0x43u, 0x4140));
  hi = bf16x2_of(__byte_perm(w, 0x43u, 0x4342));
}

// byte E of w as float: 2^23 + (x + 128) from a byte permute, minus
// 2^23 + 128; wx = w ^ 0x80808080
template <int E>
__device__ __forceinline__ float i8_f32(uint32_t wx) {
  return __int_as_float(__byte_perm(wx, 0x4B000000u, 0x7440 | E)) -
         8388736.f;
}

// d += A B: A 16 x 16 bf16 (rows of weights or keys), B 16 x 8 bf16
__device__ __forceinline__ void mma_bf16(float (&c)[4], uint32_t a0,
                                         uint32_t a1, uint32_t a2,
                                         uint32_t a3, uint32_t b0,
                                         uint32_t b1) {
  asm("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0,%1,%2,%3}, "
      "{%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "r"(b0), "r"(b1));
}

// ---- cp.async: 16 bytes through L2 only (data written in this launch), or 4

__device__ __forceinline__ void cp16(void* dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;" ::"r"(
                   smem_u32(dst)),
               "l"(src)
               : "memory");
}
__device__ __forceinline__ void cp4(void* dst, const void* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;" ::"r"(smem_u32(dst)),
               "l"(src)
               : "memory");
}
__device__ __forceinline__ void cp_commit() {
  asm volatile("cp.async.commit_group;" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_wait() {
  asm volatile("cp.async.wait_group %0;" ::"n"(N) : "memory");
}

// ---- bulk copies

__device__ __forceinline__ void bulk_g2s(void* dst, const void* src,
                                         uint32_t bytes, uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];" ::"r"(smem_u32(dst)),
      "l"(src), "r"(bytes), "r"(smem_u32(bar))
      : "memory");
}

// global data written by other blocks' plain stores before a grid barrier,
// read here by the bulk-copy (async) proxy; and shared memory last touched
// by plain loads and stores, overwritten by it
__device__ __forceinline__ void async_proxy_fence() {
  asm volatile("fence.proxy.async.global;" ::: "memory");
  asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
}

__device__ __forceinline__ float* align16(float* p) {
  return reinterpret_cast<float*>((reinterpret_cast<uintptr_t>(p) + 15) &
                                  ~(uintptr_t)15);
}

// ---- the grid barrier

// The launch's arrival count lives in its scratch and starts at 0 (the C
// entry zeroes it on the launch's stream), so the grid's k-th barrier
// completes when the count reaches (k + 1) blocks: one release reduction
// per block (no returned value, so no round trip on the arriving side) and
// an acquire poll by thread 0 (`target`, its own copy; a relaxed poll with
// one acquire fence after it measured slower). A wait of more than ~2 s
// traps, as the mbarrier waits do.
__device__ __forceinline__ void grid_barrier(unsigned long long* arrivals,
                                             unsigned long long& target,
                                             int nb) {
  __syncthreads();
  if (threadIdx.x == 0) {
    target += nb;
    asm volatile("red.release.gpu.global.add.u64 [%0], 1;" ::"l"(arrivals)
                 : "memory");
    unsigned long long v;
    long long t0 = 0;
    while (true) {
      asm volatile("ld.acquire.gpu.global.u64 %0, [%1];"
                   : "=l"(v)
                   : "l"(arrivals)
                   : "memory");
      if (v >= target) break;
      if (t0 == 0)
        t0 = clock64();
      else if (clock64() - t0 > (1ll << 32))
        __trap();
    }
  }
  __syncthreads();
}

// ---- tiles of the GEMVs

// tile ranges: block (offset + i) % blocks takes the i-th of `blocks`
// consecutive ranges of T / blocks or T / blocks + 1 tiles, so that its
// rows of a matrix are one contiguous run
__device__ __forceinline__ int my_first(const Args& a, int P, int& count) {
  const int i = (blockIdx.x + a.nb - a.off[P] % a.nb) % a.nb;
  const int q = a.T[P] / a.nb, rem = a.T[P] % a.nb;
  count = q + (i < rem);
  return i * q + min(i, rem);
}

// layer l's rows of this block's tiles of phase P into shared memory, 16
// rows of K bytes per tile (gate + up: 8 gate rows, then the 8 up rows),
// with the RMSNorm weights of the two normalised phases: a few bulk copies
// from one thread
__device__ void load_weights(const Args& a, int P, int l, int j, int mine,
                             uint8_t* sm, uint64_t* bar) {
  const int K = a.K[P];
  const bool ln = P == kQKV || P == kGU;
  const int8_t* W = a.w[P] + (size_t)l * a.N[P] * K;
  uint8_t* dst = sm + a.o_w[P];
  // gate + up: the gate rows of the run, then (8 maxt rows on) its up rows
  const int rows = P == kGU ? min(8 * mine, a.F - 8 * j)
                            : min(16 * mine, a.N[P] - 16 * j);
  // and the rows' scales (gate + up: the gate scales, 8 maxt on the up's)
  const float* S = a.s[P] + (size_t)l * a.N[P];
  float* sd = reinterpret_cast<float*>(sm + a.o_sw[P]);
  mbar_arrive_tx(bar, (P == kGU ? 2 : 1) * rows * (K + 4) +
                          (ln ? a.Dm * 4 : 0));
  if (P == kGU) {
    bulk_g2s(dst, W + (size_t)8 * j * K, rows * K, bar);
    bulk_g2s(dst + (size_t)8 * a.maxt[P] * K, W + (size_t)(a.F + 8 * j) * K,
             rows * K, bar);
    bulk_g2s(sd, S + 8 * j, rows * 4, bar);
    bulk_g2s(sd + 8 * a.maxt[P], S + a.F + 8 * j, rows * 4, bar);
  } else {
    bulk_g2s(dst, W + (size_t)16 * j * K, rows * K, bar);
    bulk_g2s(sd, S + 16 * j, rows * 4, bar);
  }
  if (ln)
    bulk_g2s(sm + (P == kQKV ? a.o_lna : a.o_lnm),
             (P == kQKV ? a.ln_a : a.ln_m) + (size_t)l * a.Dm, a.Dm * 4, bar);
}

// Staging of a GEMV's activations, batch rows [n0, n0 + nr), columns
// [k0, k0 + kc), into act (row stride SA bytes), by bulk copies that warp 0
// queues (queue_stage) and every thread waits for (finish_stage). The
// normalised phases copy x and its rows' partial sums of squares into
// xf / sq at the start of the region, then form rstd and h = bf16(x * rstd
// * ln); attn and mid are copied as they are, one copy per row.
// where the staged partial sums start, in floats after x
__device__ __forceinline__ int sq_at(const Args& a, int n0, int nr, int kc) {
  return kc == a.Dm && nr == a.B ? nr * kc : a.NG * kc;
}

__device__ void queue_stage(const Args& a, int P, uint8_t* reg, uint8_t* act,
                            int SA, int n0, int nr, int k0, int kc,
                            uint64_t* bar) {
  if (threadIdx.x >= 32) return;
  const int lane = threadIdx.x;
  const bool norm = P == kQKV || P == kGU;
  if (lane == 0)
    mbar_arrive_tx(bar, (uint32_t)nr * (norm   ? (kc + a.ntsp) * 4
                                        : kc == a.K[P] ? 2 * kc + 16
                                                       : 2 * kc));
  __syncwarp();
  async_proxy_fence();
  if (norm) {
    float* xf = reinterpret_cast<float*>(reg);  // [nr][kc]
    float* sq = xf + sq_at(a, n0, nr, kc);      // [nr][ntsp]
    if (lane == 0) {
      if (kc == a.Dm && nr == a.B) {
        // x and the partial sums lie one after the other in scratch
        bulk_g2s(xf, a.xs, a.B * (a.Dm + a.ntsp) * 4, bar);
      } else {
        bulk_g2s(sq, a.ssp + (size_t)n0 * a.ntsp, nr * a.ntsp * 4, bar);
        if (kc == a.Dm)
          bulk_g2s(xf, a.xs + (size_t)n0 * a.Dm, nr * a.Dm * 4, bar);
      }
    }
    if (kc != a.Dm)
      for (int n = lane; n < nr; n += 32)
        bulk_g2s(xf + (size_t)n * kc, a.xs + (size_t)(n0 + n) * a.Dm + k0,
                 kc * 4, bar);
  } else {
    // attn and mid rows are padded to 2 K + 16 bytes in scratch, the
    // shared row stride of a whole row: one copy when the rows fit
    const __nv_bfloat16* src = P == kO ? a.attn : a.mid;
    const int K = a.K[P];
    if (kc == K) {
      if (lane == 0)
        bulk_g2s(act, src + (size_t)n0 * (K + 8), nr * (2 * K + 16), bar);
    } else {
      for (int n = lane; n < nr; n += 32)
        bulk_g2s(act + (size_t)n * SA, src + (size_t)(n0 + n) * (K + 8) + k0,
                 kc * 2, bar);
    }
  }
}

__device__ void finish_stage(const Args& a, int P, const float* ln,
                             uint8_t* reg, uint8_t* act, int SA, int n0,
                             int nr, int k0, int kc, uint64_t* bar,
                             uint32_t& par) {
  mbar_wait(bar, par);
  par ^= 1;
  if (P != kQKV && P != kGU) return;
  // a warp per batch row: its rstd from the row's partial sums, then h
  const float* xf = reinterpret_cast<const float*>(reg);
  const float* sq = xf + sq_at(a, n0, nr, kc);
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int nts = a.Dm / 16;
  for (int n = warp; n < nr; n += kWarps) {
    float ss = 0.f;
    for (int e = lane; e < nts; e += 32) ss += sq[n * a.ntsp + e];
    ss = warp_sum(ss);
    const float r = rsqrtf(__fadd_rn(__fdiv_rn(ss, (float)a.Dm), a.eps));
    const float* xr = xf + (size_t)n * kc;
    uint8_t* hr = act + (size_t)n * SA;
    for (int c = 4 * lane; c < kc; c += 128) {
      const float4 v = *reinterpret_cast<const float4*>(xr + c);
      const float4 w = *reinterpret_cast<const float4*>(ln + k0 + c);
      const __nv_bfloat162 h0 =
          __floats2bfloat162_rn(__fmul_rn(__fmul_rn(v.x, r), w.x),
                                __fmul_rn(__fmul_rn(v.y, r), w.y));
      const __nv_bfloat162 h1 =
          __floats2bfloat162_rn(__fmul_rn(__fmul_rn(v.z, r), w.z),
                                __fmul_rn(__fmul_rn(v.w, r), w.w));
      uint2 pk;
      pk.x = *reinterpret_cast<const uint32_t*>(&h0);
      pk.y = *reinterpret_cast<const uint32_t*>(&h1);
      *reinterpret_cast<uint2*>(hr + 2 * c) = pk;
    }
  }
  __syncthreads();
}

// The weights and scales of the phase last done (pend, at layer pend_l) are
// copied for its next layer once the next GEMV phase has queued its own
// copies, by warp 1 (warp 0 queues the staging): the refill then runs
// behind the barrier and the staging instead of delaying them.
__device__ __forceinline__ void refill(const Args& a, const int* first,
                                       const int* mine, uint8_t* sm,
                                       uint64_t* bars, int& pend,
                                       int pend_l) {
  if (pend >= 0 && threadIdx.x == 32 && pend_l < a.L)
    load_weights(a, pend, pend_l, first[pend], mine[pend], sm, bars + pend);
  pend = -1;
}

// acc[m][n] += W tile (m0 + m) x act chunk, over this warp's k steps of the
// staged columns [k0, k1): 64-column chunks c with c % kWarps == warp (each
// thread: 16 bytes of rows g and g + 8, 16 activations of batch row
// n * 8 + g; k step s takes bytes 4s..4s+3 of them), then the 16-column
// steps past the last full chunk. Row g of tile m is at W + (m rs + g) K
// bytes, row g + 8 `hi` bytes after it.
template <int NT>
__device__ __forceinline__ void mma_chunk(float (&acc)[kMaxMT][NT][4],
                                          const uint8_t* W, int rs, int hi,
                                          int m0, int mt, const uint8_t* act,
                                          int SA, int nt, int K, int k0,
                                          int k1) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int g = lane >> 2, t = lane & 3;
  const int full = K / 64;
  const int c_end = min(k1, full * 64) / 64;
  int c = k0 / 64;
  c += (warp - c % kWarps + kWarps) % kWarps;
  for (; c < c_end; c += kWarps) {
    uint4 bv[NT][2];
    const uint8_t* ab = act + (c * 64 - k0) * 2 + 32 * t;
#pragma unroll
    for (int n = 0; n < NT; ++n) {
      if (n < nt) {
        const uint8_t* p = ab + (size_t)(n * 8 + g) * SA;
        bv[n][0] = *reinterpret_cast<const uint4*>(p);
        bv[n][1] = *reinterpret_cast<const uint4*>(p + 16);
      }
    }
#pragma unroll
    for (int m = 0; m < kMaxMT; ++m) {
      if (m < mt) {
        const uint8_t* wp =
            W + (size_t)((m0 + m) * rs + g) * K + c * 64 + 16 * t;
        const uint4 w0 = *reinterpret_cast<const uint4*>(wp);
        const uint4 w1 = *reinterpret_cast<const uint4*>(wp + hi);
        uint32_t A[4][4];
        i8x4_bf16(w0.x, A[0][0], A[0][2]);
        i8x4_bf16(w1.x, A[0][1], A[0][3]);
        i8x4_bf16(w0.y, A[1][0], A[1][2]);
        i8x4_bf16(w1.y, A[1][1], A[1][3]);
        i8x4_bf16(w0.z, A[2][0], A[2][2]);
        i8x4_bf16(w1.z, A[2][1], A[2][3]);
        i8x4_bf16(w0.w, A[3][0], A[3][2]);
        i8x4_bf16(w1.w, A[3][1], A[3][3]);
#pragma unroll
        for (int n = 0; n < NT; ++n) {
          if (n < nt) {
#pragma unroll
            for (int s = 0; s < 4; ++s)
              mma_bf16(acc[m][n], A[s][0], A[s][1], A[s][2], A[s][3],
                       s < 2 ? (s ? bv[n][0].z : bv[n][0].x)
                             : (s == 3 ? bv[n][1].z : bv[n][1].x),
                       s < 2 ? (s ? bv[n][0].w : bv[n][0].y)
                             : (s == 3 ? bv[n][1].w : bv[n][1].y));
          }
        }
      }
    }
  }
  if (k1 < K) return;
  // 16-column steps past the last full chunk: bytes 4t..4t+3 of the step
  for (int kk = full * 64, u = 0; kk < k1; kk += 16, ++u) {
    if ((full + u) % kWarps != warp) continue;
#pragma unroll
    for (int m = 0; m < kMaxMT; ++m) {
      if (m < mt) {
        const uint8_t* wp = W + (size_t)((m0 + m) * rs + g) * K + kk + 4 * t;
        uint32_t a0, a1, a2, a3;
        i8x4_bf16(*reinterpret_cast<const uint32_t*>(wp), a0, a2);
        i8x4_bf16(*reinterpret_cast<const uint32_t*>(wp + hi), a1, a3);
#pragma unroll
        for (int n = 0; n < NT; ++n) {
          if (n < nt) {
            const uint2 b = *reinterpret_cast<const uint2*>(
                act + (size_t)(n * 8 + g) * SA + (kk - k0 + 4 * t) * 2);
            mma_bf16(acc[m][n], a0, a1, a2, a3, b.x, b.y);
          }
        }
      }
    }
  }
}

// tiles whose partial sums the warps add in one pass, and the epilogue
// items (tile, batch row, weight row) a thread takes in it
template <int NT>
struct Epi {
  static constexpr int kTiles = NT <= 2 ? kMaxMT : 1;
  static constexpr int kItems =
      (kTiles * 16 * NT * 8 + kThreads - 1) / kThreads;
};

// one GEMV phase of layer l for this block's tiles
template <int NT>
__device__ void gemv_phase(const Args& a, int P, int l, const int* firsts,
                           const int* mines, uint8_t* sm, uint64_t* bars,
                           uint32_t& apar, int& pend, int& pend_l) {
  const int mine = mines[P], j0 = firsts[P];
  const int tp = P == kQKV ? 0 : P + 1;  // the phase's place in the layer
  MEGA_TRACE(l, tp, 0);
  if (mine == 0) {
    refill(a, firsts, mines, sm, bars, pend, pend_l);
    return;
  }
  constexpr int NC = NT * 8, RT = Epi<NT>::kTiles, IT = Epi<NT>::kItems;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int g = lane >> 2, t = lane & 3;
  const int K = a.K[P], KC = a.KC[P], SA = a.SA[P];
  const int nchunks = (K + KC - 1) / KC;
  const float* scl = reinterpret_cast<const float*>(sm + a.o_sw[P]);
  float* xo = reinterpret_cast<float*>(sm + a.o_xo);  // [kMaxMT][NG][16]
  float* red = reinterpret_cast<float*>(sm + a.o_red);
  uint8_t* reg = sm + a.o_reg;
  const bool norm = P == kQKV || P == kGU;
  // normalised phases: x and its partial sums first in the region, h after
  uint8_t* act = norm ? reg + (size_t)a.NG * (KC + a.ntsp) * 4 : reg;
  const uint8_t* W = sm + a.o_w[P];
  const float* ln = reinterpret_cast<const float*>(
      sm + (P == kQKV ? a.o_lna : a.o_lnm));
  const bool resid = P == kO || P == kDown;
  // rows of the weight tiles: gate + up keep the gate rows of the run, then
  // its up rows
  const int rs = P == kGU ? 8 : 16;
  const int hi = (P == kGU ? 8 * a.maxt[P] : 8) * K;
  // the first staging is queued at once (the barrier that opened the phase
  // also ended every read of the region), then the refill, then the wait
  // for this phase's weights
  queue_stage(a, P, reg, act, SA, 0, min(a.NG, a.B), 0, min(KC, K),
              bars + kAct);
  refill(a, firsts, mines, sm, bars, pend, pend_l);
  mbar_wait(bars + P, l & 1);
  MEGA_TRACE(l, tp, 1);

  for (int n0 = 0; n0 < a.B; n0 += a.NG) {
    const int nr = min(a.NG, a.B - n0), nt = (nr + 7) / 8;
    for (int m0 = 0; m0 < mine; m0 += kMaxMT) {
      const int mt = min(kMaxMT, mine - m0);
      // the residual's columns of the round's tiles, copied while the tiles
      // are computed (a plain load here would hold the next barrier)
      if (resid) {
        if (m0 > 0 || n0 > 0) __syncthreads();
        for (int i = threadIdx.x; i < mt * nr * 4; i += kThreads) {
          const int tm = i / (nr * 4), n = (i >> 2) % nr;
          cp16(xo + (tm * a.NG + n) * 16 + 4 * (i & 3),
               a.xs + (size_t)(n0 + n) * a.Dm + (j0 + m0 + tm) * 16 +
                   4 * (i & 3));
        }
      }
      cp_commit();
      float acc[kMaxMT][NT][4];
#pragma unroll
      for (int m = 0; m < kMaxMT; ++m)
#pragma unroll
        for (int n = 0; n < NT; ++n)
#pragma unroll
          for (int e = 0; e < 4; ++e) acc[m][n][e] = 0.f;
      for (int ch = 0; ch < nchunks; ++ch) {
        const int k0 = ch * KC, kc = min(KC, K - k0);
        if (nchunks > 1 || m0 == 0) {
          if (n0 > 0 || m0 > 0 || ch > 0) {
            __syncthreads();
            queue_stage(a, P, reg, act, SA, n0, nr, k0, kc, bars + kAct);
          }
          if (ch == 0 && m0 == 0 && n0 == 0) MEGA_TRACE(l, tp, 2);
          finish_stage(a, P, ln, reg, act, SA, n0, nr, k0, kc, bars + kAct,
                       apar);
        }
        if (ch == 0 && m0 == 0 && n0 == 0) MEGA_TRACE(l, tp, 3);
        mma_chunk<NT>(acc, W, rs, hi, m0, mt, act, SA, nt, K, k0, k0 + kc);
      }
      if (m0 == 0 && n0 == 0) MEGA_TRACE(l, tp, 4);
      // the warps' partial tiles, RT tiles at a time, added in a fixed
      // order; then the epilogue
      for (int mb = 0; mb < mt; mb += RT) {
        const int tiles = min(RT, mt - mb);
        // the previous pass's epilogue is done with the partial tiles
        if (mb > 0 || m0 > 0 || n0 > 0) __syncthreads();
        if (mb == 0) cp_wait<0>();
#pragma unroll
        for (int m = 0; m < kMaxMT; ++m) {
          if (m >= mb && m < mb + tiles) {
#pragma unroll
            for (int n = 0; n < NT; ++n) {
              if (n < nt) {
                const float* c = acc[m][n];
                float* r0 = red + (((m - mb) * kWarps + warp) * 16 + g) * NC +
                            n * 8 + 2 * t;
                *reinterpret_cast<float2*>(r0) = make_float2(c[0], c[1]);
                *reinterpret_cast<float2*>(r0 + 8 * NC) =
                    make_float2(c[2], c[3]);
              }
            }
          }
        }
        __syncthreads();
        // item i: tile tm = i / (16 nr), batch row n, row r = i % 16 (gate
        // + up: 8 rows, each with its up row r + 8)
        const int per = (P == kGU ? 8 : 16) * nr;
#pragma unroll
        for (int u = 0; u < IT; ++u) {
          const int i = u * kThreads + threadIdx.x;
          if (u * kThreads >= tiles * per) break;
          const bool ok = i < tiles * per;
          const int tm = ok ? i / per : 0, rem = i - tm * per;
          const int r = P == kGU ? rem & 7 : rem & 15;
          const int n = P == kGU ? rem >> 3 : rem >> 4;
          const int j = j0 + m0 + mb + tm;
          const float* rr = red + (tm * kWarps * 16 + r) * NC + n;
          float v = 0.f, v2 = 0.f;
          if (ok) {
            for (int w = 0; w < kWarps; ++w) v += rr[w * 16 * NC];
            if (P == kGU)
              for (int w = 0; w < kWarps; ++w) v2 += rr[(w * 16 + 8) * NC];
          }
          const int tl = m0 + mb + tm;  // the tile's place in the run
          if (P == kGU) {
            const int f = j * 8 + r;
            if (ok && f < a.F) {
              const float gv = __fmul_rn(v, scl[tl * 8 + r]);
              const float uv =
                  __fmul_rn(v2, scl[8 * a.maxt[P] + tl * 8 + r]);
              const float sig = __fdiv_rn(1.f, __fadd_rn(1.f, expf(-gv)));
              a.mid[(size_t)(n0 + n) * (a.F + 8) + f] =
                  __float2bfloat16_rn(__fmul_rn(__fmul_rn(sig, gv), uv));
            }
          } else if (P == kQKV) {
            const int row = j * 16 + r;
            if (ok && row < a.nqkv)
              a.qkv[(size_t)(n0 + n) * a.nqkv + row] =
                  __fmul_rn(v, scl[tl * 16 + r]);
          } else {
            // x += y on the tile's 16 columns, with each row's sum of
            // squares over them (16 lanes, fixed order)
            float xn = 0.f;
            if (ok) {
              const size_t at = (size_t)(n0 + n) * a.Dm + j * 16 + r;
              xn = __fadd_rn(xo[((mb + tm) * a.NG + n) * 16 + r],
                             __fmul_rn(v, scl[tl * 16 + r]));
              a.xs[at] = xn;
              if (P == kDown && l == a.L - 1)
                a.out[at] = __float2bfloat16_rn(xn);
            }
            const float ss = half_sum(xn * xn);
            if (ok && r == 0) a.ssp[(size_t)(n0 + n) * a.ntsp + j] = ss;
          }
        }
      }
    }
  }
  // the next layer's tiles go into these rows once every warp is past its
  // last read of them: after the barrier that ends the phase
  pend = P;
  pend_l = l + 1;
}

// keys [k0, k0 + n) of a ring slice (rows of D int8 at stride Dkv) into
// shared rows of stride `stride`
__device__ __forceinline__ void stage_keys(int8_t* dst, int stride,
                                           const int8_t* src, int Dkv, int D,
                                           int k0, int n) {
  // D divides the block's threads: a thread copies piece c of every
  // (threads / pieces)-th key
  if (D % 16 == 0) {
    const int pieces = D / 16, c = threadIdx.x % pieces;
    for (int k = threadIdx.x / pieces; k < n; k += kThreads / pieces)
      cp16(dst + k * stride + 16 * c, src + (size_t)(k0 + k) * Dkv + 16 * c);
  } else {
    const int pieces = D / 4, c = threadIdx.x % pieces;
    for (int k = threadIdx.x / pieces; k < n; k += kThreads / pieces)
      cp4(dst + k * stride + 4 * c, src + (size_t)(k0 + k) * Dkv + 4 * c);
  }
}

// pass 3 for one head over one chunk of keys: sum_k pv_k * v[k, c], a
// thread on CW columns of every KL-th key; the key lanes of a warp that
// share columns are added, and the warp's sums stored into (or added to)
// out [D]
template <int CW>
__device__ __forceinline__ void pv_accumulate(const int8_t* vS,
                                              const float* pv, int pc, int D,
                                              float* out, bool add) {
  const int cpr = D / CW, KL = kThreads / cpr;
  const int c0 = (threadIdx.x % cpr) * CW, kl = threadIdx.x / cpr;
  float acc[CW];
#pragma unroll
  for (int e = 0; e < CW; ++e) acc[e] = 0.f;
  for (int k = kl; k < pc; k += KL) {
    const float pk = pv[k];
    uint32_t w[CW / 4];
    if constexpr (CW == 16) {
      const uint4 v = *reinterpret_cast<const uint4*>(vS + k * D + c0);
      w[0] = v.x;
      w[1] = v.y;
      w[2] = v.z;
      w[3] = v.w;
    } else {
      w[0] = *reinterpret_cast<const uint32_t*>(vS + k * D + c0);
    }
#pragma unroll
    for (int q = 0; q < CW / 4; ++q) {
      const uint32_t wx = w[q] ^ 0x80808080u;
      acc[4 * q] = fmaf(pk, i8_f32<0>(wx), acc[4 * q]);
      acc[4 * q + 1] = fmaf(pk, i8_f32<1>(wx), acc[4 * q + 1]);
      acc[4 * q + 2] = fmaf(pk, i8_f32<2>(wx), acc[4 * q + 2]);
      acc[4 * q + 3] = fmaf(pk, i8_f32<3>(wx), acc[4 * q + 3]);
    }
  }
  for (int o = cpr; o < 32; o <<= 1)
#pragma unroll
    for (int e = 0; e < CW; ++e)
      acc[e] += __shfl_xor_sync(0xffffffffu, acc[e], o);
  if ((threadIdx.x & 31) < cpr)
#pragma unroll
    for (int e = 0; e < CW; ++e)
      out[c0 + e] = add ? out[c0 + e] + acc[e] : acc[e];
}

// phase 2 of layer l: one task per (batch row, kv head, chunk of kH query
// heads). Its ring slice (K, V and their scales for columns < p, in chunks
// of PC keys when they do not fit) and its q / k / v rows are copied into
// shared memory at once, asynchronously; the RoPE and quantisation of the
// new row run while the ring slice arrives.
// DT: the head dim when it is known at compile time (the OCR model's 64),
// else 0 (any D the launch accepts)
template <int DT>
__device__ void attention(const Args& a, int l, uint8_t* smb) {
  MEGA_TRACE(l, 1, 0);
  const int D = DT ? DT : a.D, Dq = a.Dq, Dkv = a.Dkv, kH = a.kH, p = a.pos;
  const int rep = a.H / a.G, half = D / 2, QS = D + 16, KS = D + 16;
  const int dl = __ffs(D) - 1;  // D divides the block's threads: 2^dl
  const int PC = a.PC, nch = (p + PC - 1) / PC;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g8 = lane >> 2, t4 = lane & 3;
  int8_t* kS = reinterpret_cast<int8_t*>(smb);  // [PC][D + 16]
  int8_t* vS = kS + (size_t)PC * KS;             // [PC][D]
  float* ksS = reinterpret_cast<float*>(vS + (size_t)PC * D);  // [S]
  float* vsS = ksS + a.S;                        // [S]
  float* raw = align16(vsS + a.S);               // [(kH + 2) D]: q.., k, v
  float* kdq = raw + (kH + 2) * D;               // [D]
  float* vdq = kdq + D;                          // [D]
  float* red = vdq + D;                          // [kWarps][8]
  float* red2 = red + kWarps * 8;                // [kWarps][8]
  float* stat = red2 + kWarps * 8;               // [16]: s_new at 8 + h
  float* part = stat + 16;                       // [kWarps][kH][D]
  float* sc = part + kWarps * kH * D;            // [kH][S]: scores, then pv
  // [8][QS] bf16 queries, rows past kH zero
  __nv_bfloat16* qsb =
      reinterpret_cast<__nv_bfloat16*>(align16(sc + kH * a.S));
  const float* rope = reinterpret_cast<const float*>(
      smb - a.o_reg + a.o_rope);  // [D/2][2] (cos, sin) at p

  for (int task = blockIdx.x; task < a.tasks; task += a.nb) {
    const int b = task / (a.G * a.hpt), rem = task % (a.G * a.hpt);
    const int g = rem / a.hpt, hc = rem % a.hpt, h0 = g * rep + hc * kH;
    const size_t lb = (size_t)l * a.B + b;
    const float* row = a.qkv + (size_t)b * a.nqkv;
    const int8_t* kbase = a.kq + lb * a.S * Dkv + (size_t)g * D;
    const int8_t* vbase = a.vq + lb * a.S * Dkv + (size_t)g * D;
    const float* ks_row = a.ks + (lb * a.G + g) * a.S;
    const float* vs_row = a.vs + (lb * a.G + g) * a.S;
    __syncthreads();  // the previous task is done with the buffers
    for (int i = tid; i < (kH + 2) * D / 4; i += kThreads) {
      const int which = (4 * i) >> dl, d = (4 * i) & (D - 1);
      const int col = which < kH ? (h0 + which) * D + d
                                 : Dq + (which - kH) * Dkv + g * D + d;
      cp16(raw + 4 * i, row + col);
    }
    cp_commit();
    for (int k = tid; k < p; k += kThreads) {
      cp4(ksS + k, ks_row + k);
      cp4(vsS + k, vs_row + k);
    }
    stage_keys(kS, KS, kbase, Dkv, D, 0, min(p, PC));
    if (nch == 1) stage_keys(vS, D, vbase, Dkv, D, 0, p);
    cp_commit();
    for (int i = kH * QS + tid; i < 8 * QS; i += kThreads)
      qsb[i] = __float2bfloat16_rn(0.f);
    cp_wait<1>();
    __syncthreads();
    if (task == (int)blockIdx.x) MEGA_TRACE(l, 1, 1);
    // RoPE at p (the rotated half from the bf16-rounded values) and the
    // group's new K/V row, int8 per (row, kv head)
    const float* kr = raw + kH * D;
    const float* vr = kr + D;
    float kv = 0.f, vv = 0.f;
    if (tid < D) {
      const float* cs = rope + (tid % half) * 2;
      const int other = tid < half ? tid + half : tid - half;
      const float sign = tid < half ? -1.f : 1.f;
      kv = __fadd_rn(__fmul_rn(kr[tid], cs[0]),
                     __fmul_rn(sign * bf16r(kr[other]), cs[1]));
      vv = vr[tid];
    }
    const float mk = warp_max(fabsf(kv)), mv = warp_max(fabsf(vv));
    if (lane == 0) {
      red[warp * 8] = mk;
      red[warp * 8 + 1] = mv;
    }
    for (int i = tid; i < kH * D; i += kThreads) {
      const int h = i >> dl, d = i & (D - 1);
      const float* q = raw + h * D;
      const float* cs = rope + (d % half) * 2;
      const int other = d < half ? d + half : d - half;
      const float sign = d < half ? -1.f : 1.f;
      const float qv = __fadd_rn(__fmul_rn(q[d], cs[0]),
                                 __fmul_rn(sign * bf16r(q[other]), cs[1]));
      qsb[h * QS + d] = __float2bfloat16_rn(__fmul_rn(qv, a.inv_sqrt_d));
    }
    __syncthreads();
    float amk = 0.f, amv = 0.f;
    for (int w = 0; w < kWarps; ++w) {
      amk = fmaxf(amk, red[w * 8]);
      amv = fmaxf(amv, red[w * 8 + 1]);
    }
    const float kscale = __fadd_rn(__fdiv_rn(amk, 127.f), 1e-8f);
    const float vscale = __fadd_rn(__fdiv_rn(amv, 127.f), 1e-8f);
    if (tid < D) {
      const float kc =
          fminf(fmaxf(rintf(__fdiv_rn(kv, kscale)), -127.f), 127.f);
      const float vc =
          fminf(fmaxf(rintf(__fdiv_rn(vv, vscale)), -127.f), 127.f);
      kdq[tid] = __fmul_rn(kc, kscale);
      vdq[tid] = __fmul_rn(vc, vscale);
      if (hc == 0) {
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
    cp_wait<0>();
    __syncthreads();
    // the new token's score per head
    if (warp < kH) {
      float s = 0.f;
      for (int d = lane; d < D; d += 32)
        s = fmaf(__bfloat162float(qsb[warp * QS + d]), kdq[d], s);
      s = warp_sum(s);
      if (lane == 0) stat[8 + warp] = s;
    }

    if (task == (int)blockIdx.x) MEGA_TRACE(l, 1, 2);
    // pass 1: scores of ring columns < p, 16 keys per MMA
    float lmax[kMaxH];
#pragma unroll
    for (int h = 0; h < kMaxH; ++h) lmax[h] = -INFINITY;
    for (int ch = 0; ch < nch; ++ch) {
      const int kc0 = ch * PC, pc = min(PC, p - kc0);
      if (ch > 0) {
        __syncthreads();
        stage_keys(kS, KS, kbase, Dkv, D, kc0, pc);
        cp_commit();
        cp_wait<0>();
        __syncthreads();
      }
      if (D % 16 == 0) {
        for (int k0 = warp * 16; k0 < pc; k0 += kWarps * 16) {
          float c[4] = {0.f, 0.f, 0.f, 0.f};
          const int ka = k0 + g8, kb = k0 + g8 + 8;
          const int8_t* ra = kS + min(ka, pc - 1) * KS + 4 * t4;
          const int8_t* rb = kS + min(kb, pc - 1) * KS + 4 * t4;
          for (int d0 = 0; d0 < D; d0 += 16) {
            uint32_t a0, a1, a2, a3;
            i8x4_bf16(*reinterpret_cast<const uint32_t*>(ra + d0), a0, a2);
            i8x4_bf16(*reinterpret_cast<const uint32_t*>(rb + d0), a1, a3);
            const uint2 q = *reinterpret_cast<const uint2*>(
                qsb + g8 * QS + d0 + 4 * t4);
            mma_bf16(c, a0, a1, a2, a3, q.x, q.y);
          }
          // c: (key ka, heads 2t, 2t + 1), (key kb, the same heads)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int h = 2 * t4 + (e & 1), k = e < 2 ? ka : kb;
            if (h < kH && k < pc) {
              const float s = __fmul_rn(c[e], ksS[kc0 + k]);
              sc[h * a.S + kc0 + k] = s;
#pragma unroll
              for (int hh = 0; hh < kMaxH; ++hh)
                if (hh == h) lmax[hh] = fmaxf(lmax[hh], s);
            }
          }
        }
      } else {
        for (int k = tid; k < pc; k += kThreads) {
          const int8_t* kr8 = kS + k * KS;
          for (int h = 0; h < kH; ++h) {
            const __nv_bfloat16* q = qsb + h * QS;
            float dot = 0.f;
            for (int d = 0; d < D; d += 4) {
              const uint32_t wx =
                  *reinterpret_cast<const uint32_t*>(kr8 + d) ^ 0x80808080u;
              dot = fmaf(__bfloat162float(q[d + 3]), i8_f32<3>(wx),
                         fmaf(__bfloat162float(q[d + 2]), i8_f32<2>(wx),
                              fmaf(__bfloat162float(q[d + 1]), i8_f32<1>(wx),
                                   fmaf(__bfloat162float(q[d]), i8_f32<0>(wx),
                                        dot))));
            }
            const float s = __fmul_rn(dot, ksS[kc0 + k]);
            sc[h * a.S + kc0 + k] = s;
#pragma unroll
            for (int hh = 0; hh < kMaxH; ++hh)
              if (hh == h) lmax[hh] = fmaxf(lmax[hh], s);
          }
        }
      }
    }
#pragma unroll
    for (int h = 0; h < kMaxH; ++h) {
      const float m = warp_max(lmax[h]);
      if (lane == 0) red[warp * 8 + h] = m;
    }
    __syncthreads();
    float m1[kMaxH];
#pragma unroll
    for (int h = 0; h < kMaxH; ++h) {
      m1[h] = -INFINITY;
      for (int w = 0; w < kWarps; ++w) m1[h] = fmaxf(m1[h], red[w * 8 + h]);
    }
    if (task == (int)blockIdx.x) MEGA_TRACE(l, 1, 3);
    // pass 2: w = exp(s - m), l = sum w, bf16(w * v_scale)
    float lsum[kMaxH] = {0.f, 0.f, 0.f, 0.f};
    for (int k = tid; k < p; k += kThreads) {
      const float vsk = vsS[k];
#pragma unroll
      for (int h = 0; h < kMaxH; ++h) {
        if (h < kH) {
          const float e = expf(sc[h * a.S + k] - m1[h]);
          lsum[h] += e;
          sc[h * a.S + k] = bf16r(__fmul_rn(e, vsk));
        }
      }
    }
#pragma unroll
    for (int h = 0; h < kMaxH; ++h) {
      const float s = warp_sum(lsum[h]);
      if (lane == 0) red2[warp * 8 + h] = s;
    }
    __syncthreads();
    if (task == (int)blockIdx.x) MEGA_TRACE(l, 1, 4);
    // pass 3: sum_k pv_k * v[k, g*D + c], head by head
    for (int ch = 0; ch < nch; ++ch) {
      const int kc0 = ch * PC, pc = min(PC, p - kc0);
      if (nch > 1) {
        __syncthreads();
        stage_keys(vS, D, vbase, Dkv, D, kc0, pc);
        cp_commit();
        cp_wait<0>();
        __syncthreads();
      }
      for (int h = 0; h < kH; ++h) {
        if (D % 16 == 0)
          pv_accumulate<16>(vS, sc + h * a.S + kc0, pc, D,
                            part + (warp * kH + h) * D, ch > 0);
        else
          pv_accumulate<4>(vS, sc + h * a.S + kc0, pc, D,
                           part + (warp * kH + h) * D, ch > 0);
      }
    }
    __syncthreads();
    for (int i = tid; i < kH * D; i += kThreads) {
      const int h = i >> dl, d = i & (D - 1);
      float o = 0.f, l1 = 0.f, m = -INFINITY;
      for (int w = 0; w < kWarps; ++w) {
        if (p > 0) o += part[(w * kH + h) * D + d];
        l1 += red2[w * 8 + h];
        m = fmaxf(m, red[w * 8 + h]);
      }
      // the new token's column (m = -inf when p = 0: alpha = 0)
      const float s_new = stat[8 + h];
      const float m2 = fmaxf(m, s_new);
      const float alpha = expf(m - m2);
      const float pn = expf(s_new - m2);
      const float den = __fadd_rn(__fmul_rn(l1, alpha), pn);
      const float num = __fadd_rn(__fmul_rn(o, alpha), __fmul_rn(pn, vdq[d]));
      a.attn[(size_t)b * (Dq + 8) + (h0 + h) * D + d] =
          __float2bfloat16_rn(__fdiv_rn(num, fmaxf(den, 1e-30f)));
    }
  }
}

template <int NT>
__global__ void __launch_bounds__(kThreads, 1)
ocr_megastep_kernel(const Args a) {
  unsigned long long target = 0;  // this launch's barrier count
  extern __shared__ __align__(128) uint8_t sm[];
  uint64_t* bars = reinterpret_cast<uint64_t*>(sm);
  int first[4], mine[4];
#pragma unroll
  for (int P = 0; P < 4; ++P) first[P] = my_first(a, P, mine[P]);
  if (threadIdx.x == 0) {
    for (int i = 0; i < kBars; ++i) mbar_init(bars + i, 1);
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  float* rope = reinterpret_cast<float*>(sm + a.o_rope);
  for (int i = threadIdx.x; i < a.D; i += kThreads)
    rope[i] = a.rope[(size_t)a.pos * a.D + i];
  __syncthreads();
  if (threadIdx.x == 0)
    for (int P = 0; P < 4; ++P)
      if (mine[P]) load_weights(a, P, 0, first[P], mine[P], sm, bars + P);
  uint32_t apar = 0;
  int pend = -1, pend_l = 0;

  // x into float32 with its rows' sums of squares over 16-column tiles
  for (int j = blockIdx.x; j < a.Dm / 16; j += a.nb) {
    for (int base = 0; base < 16 * a.B; base += kThreads) {
      const int i = base + threadIdx.x, r = i & 15, n = i >> 4;
      const bool ok = i < 16 * a.B;
      float v = 0.f;
      if (ok) {
        v = __bfloat162float(a.x[(size_t)n * a.Dm + j * 16 + r]);
        a.xs[(size_t)n * a.Dm + j * 16 + r] = v;
      }
      const float ss = half_sum(v * v);
      if (ok && r == 0) a.ssp[(size_t)n * a.ntsp + j] = ss;
    }
  }
  // the bulk copies of later phases read what plain stores wrote
  asm volatile("fence.proxy.async.global;" ::: "memory");
  grid_barrier(a.arrivals, target, a.nb);
  // the five phases of each layer, one code path each: every call site
  // below is reached once per layer, so the code that runs per layer is
  // one copy of each phase (the instruction cache does not hold the
  // whole kernel)
#pragma unroll 1
  for (int step = 0; step < 5 * a.L; ++step) {
    const int l = step / 5, ph = step % 5;
    if (ph == 1) {
      if (a.D == 64)
        attention<64>(a, l, sm + a.o_reg);
      else
        attention<0>(a, l, sm + a.o_reg);
    } else {
      // QKV, then (after the attention) O, gate + up, down
      gemv_phase<NT>(a, ph == 0 ? kQKV : ph - 1, l, first, mine, sm, bars,
                     apar, pend, pend_l);
    }
    MEGA_TRACE(l, ph, 5);
    if (step + 1 < 5 * a.L) {
      // later bulk copies read what plain stores of this phase wrote
      asm volatile("fence.proxy.async.global;" ::: "memory");
      grid_barrier(a.arrivals, target, a.nb);
    }
  }
}

int round_up(int v, int m) { return (v + m - 1) / m * m; }

// the launch plan: tiles, offsets, shared layout; false if it cannot fit
bool plan(Args& a, int nb, int NT) {
  a.Dq = a.H * a.D;
  a.Dkv = a.G * a.D;
  a.nqkv = a.Dq + 2 * a.Dkv;
  a.ntsp = round_up(a.Dm / 16, 4);
  a.nb = nb;
  a.NG = NT * 8;
  const int rows[4] = {a.nqkv, a.Dm, 2 * a.F, a.Dm};
  const int ks[4] = {a.Dm, a.Dq, a.Dm, a.F};
  for (int P = 0; P < 4; ++P) {
    a.N[P] = rows[P];
    a.K[P] = ks[P];
    // 16 rows a tile (gate + up: 8 columns, 16 rows)
    a.T[P] = P == kGU ? (a.F + 7) / 8 : (rows[P] + 15) / 16;
    a.maxt[P] = (a.T[P] + nb - 1) / nb;
  }
  // O and QKV tiles from block 0, down after O, gate + up after down
  a.off[kQKV] = 0;
  a.off[kO] = 0;
  a.off[kDown] = a.T[kO] % nb;
  a.off[kGU] = (a.T[kO] + a.T[kDown]) % nb;
  // attention tasks: the fewest query heads per task (at most kMaxH,
  // dividing the group's) whose tasks still fit on the grid, else the most
  const int rep = a.H / a.G;
  int kh = 1;
  for (int c = 2; c <= kMaxH && c <= rep; ++c)
    if (rep % c == 0 && a.B * a.G * (rep / kh) > nb) kh = c;
  a.kH = kh;
  a.hpt = rep / kh;
  a.tasks = a.B * a.G * a.hpt;
  int o = 128;  // the mbarriers
  a.o_rope = o;
  o += round_up(a.D * 4, 128);
  a.o_xo = o;
  o += round_up(kMaxMT * a.NG * 16 * 4, 128);
  a.o_lna = o;
  o += round_up(a.Dm * 4, 128);
  a.o_lnm = o;
  o += round_up(a.Dm * 4, 128);
  for (int P = 0; P < 4; ++P) {
    a.o_sw[P] = o;
    o += round_up(a.maxt[P] * 16 * 4, 128);
    a.o_w[P] = o;
    o += round_up(a.maxt[P] * 16 * a.K[P], 128);
  }
  a.o_red = o;
  o += (NT <= 2 ? kMaxMT : 1) * kWarps * 16 * a.NG * 4;
  a.o_reg = o;
  // the region: staging of a GEMV's activations, or one attention task
  auto stage_bytes = [&](int P, int kc) {
    const int h = a.NG * (2 * kc + 16);
    return P == kQKV || P == kGU ? a.NG * (kc + a.ntsp) * 4 + h : h;
  };
  const int att_fixed = 2 * a.S * 4 + ((a.kH + 4) * a.D + 2 * kWarps * 8 +
                                       16 + kWarps * a.kH * a.D +
                                       a.kH * a.S) * 4 +
                        8 * (a.D + 16) * 2 + 32;
  int need = att_fixed + a.S * (2 * a.D + 16);
  for (int P = 0; P < 4; ++P) need = std::max(need, stage_bytes(P, a.K[P]));
  const int room = kSmemMax - o;
  const int reg = std::min(round_up(need, 16), room / 16 * 16);
  // keys of one attention chunk: all, or multiples of 16 that fit
  a.PC = std::min(a.S, (reg - att_fixed) / (2 * a.D + 16) / 16 * 16);
  if (a.PC < 16 && a.PC < a.S) return false;
  for (int P = 0; P < 4; ++P) {
    // K columns staged at once: all, or multiples of 64 that fit
    int kc = a.K[P];
    while (kc > 64 && stage_bytes(P, kc) > reg)
      kc = (kc - 1) / 64 * 64;
    if (stage_bytes(P, kc) > reg) return false;
    a.KC[P] = kc;
    a.SA[P] = 2 * kc + 16;
  }
  a.smem = o + reg;
  return true;
}

template <int NT>
int launch(Args& a, cudaStream_t stream) {
  const void* fn = (const void*)ocr_megastep_kernel<NT>;
  int dev = 0, sms = 0, coop = 0, per_sm = 0;
  cudaError_t e;
  if ((e = cudaGetDevice(&dev)) != cudaSuccess ||
      (e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount,
                                  dev)) != cudaSuccess ||
      (e = cudaDeviceGetAttribute(&coop, cudaDevAttrCooperativeLaunch,
                                  dev)) != cudaSuccess)
    return (int)e;
  if (!plan(a, sms, NT)) return (int)cudaErrorInvalidValue;
  if ((e = cudaFuncSetAttribute(fn,
                                cudaFuncAttributeMaxDynamicSharedMemorySize,
                                a.smem)) != cudaSuccess ||
      (e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
           &per_sm, fn, kThreads, a.smem)) != cudaSuccess)
    return (int)e;
  if (!coop || per_sm < 1) return (int)cudaErrorCooperativeLaunchTooLarge;
  void* params[] = {(void*)&a};
  e = cudaLaunchCooperativeKernel(fn, dim3(sms), dim3(kThreads), params,
                                  a.smem, stream);
  if (e != cudaSuccess) return (int)e;
  return (int)cudaGetLastError();
}

}  // namespace

#ifdef MEGASTEP_TRACE
// the stamps of the last launch: clock64 [132][32][5][6], then globaltimer
extern "C" int mg_ocr_megastep_trace(void* dst) {
  return (int)cudaMemcpyFromSymbol(dst, g_trace, sizeof(g_trace));
}
#endif

// scratch: barrier count u64 (alone in 256 bytes) | x float32 [B, Dm] | row sums of
// squares [B, ceil(Dm / 64) * 4] | qkv float32 [B, Dq + 2 G D] | attn bf16
// [B, Dq + 8] | mid bf16 [B, F + 8]
extern "C" int mg_ocr_megastep(
    const void* x, void* out, float* scratch, const float* rope, int8_t* kq,
    float* ks, int8_t* vq, float* vs, const int8_t* wqkv, const float* sqkv,
    const int8_t* wo, const float* so, const int8_t* wgu, const float* sgu,
    const int8_t* wd, const float* sd, const float* ln_a, const float* ln_m,
    int L, int B, int S, int Dm, int H, int G, int D, int F, int pos,
    float eps, float inv_sqrt_d, void* stream) {
  if (L <= 0 || B <= 0 || H <= 0 || G <= 0 || H % G != 0 || D <= 0 ||
      D % 4 != 0 || D > kThreads || kThreads % D != 0 || Dm % 16 != 0 ||
      (H * D) % 16 != 0 || F % 16 != 0 || pos < 0 || pos >= S)
    return (int)cudaErrorInvalidValue;
  Args a{};
  a.x = (const __nv_bfloat16*)x;
  a.out = (__nv_bfloat16*)out;
  a.rope = rope;
  a.kq = kq;
  a.ks = ks;
  a.vq = vq;
  a.vs = vs;
  a.w[kQKV] = wqkv;
  a.w[kO] = wo;
  a.w[kGU] = wgu;
  a.w[kDown] = wd;
  a.s[kQKV] = sqkv;
  a.s[kO] = so;
  a.s[kGU] = sgu;
  a.s[kDown] = sd;
  a.ln_a = ln_a;
  a.ln_m = ln_m;
  a.L = L;
  a.B = B;
  a.S = S;
  a.Dm = Dm;
  a.H = H;
  a.G = G;
  a.D = D;
  a.F = F;
  a.pos = pos;
  a.eps = eps;
  a.inv_sqrt_d = inv_sqrt_d;
  const int nqkv = H * D + 2 * G * D, ntsp = (Dm / 16 + 3) / 4 * 4;
  a.arrivals = reinterpret_cast<unsigned long long*>(scratch);
  a.xs = scratch + 64;
  a.ssp = a.xs + (size_t)B * Dm;
  a.qkv = a.ssp + (size_t)B * ntsp;
  a.attn = reinterpret_cast<__nv_bfloat16*>(a.qkv + (size_t)B * nqkv);
  a.mid = a.attn + (size_t)B * (H * D + 8);
  const cudaStream_t st = (cudaStream_t)stream;
  const cudaError_t e = cudaMemsetAsync(a.arrivals, 0, 8, st);
  if (e != cudaSuccess) return (int)e;
  if (B <= 8) return launch<1>(a, st);
  if (B <= 16) return launch<2>(a, st);
  return launch<6>(a, st);
}
