// One forward flash-attention core for Hopper (sm_90a), shared by the three
// encoder kernels: flash_i8.cu (an int8 bias slab times a per-head scale,
// plus a key mask), flash_bias.cu (a bf16 or float32 additive bias, and the
// float32 log-sum-exp of each row for the backward kernels) and
// flash_relbias.cu (the UDOP relative bias computed in the kernel, no slab).
//
// All compute, for bf16 q, k, v [B, L, H, 64] and query i, key j, head h
// (T5 convention, no 1/sqrt(d)):
//   s = q_i . k_j + bias(i, j),  out_i = sum_j p_j v_j / max(l, 1e-30)
// with the softmax online in float32 from the finite start -1e30 (a tile
// whose keys are all masked yields no NaN; the next valid tile's rescale
// wipes its weights), p = 0 exactly for keys at or past L, bf16 output.
//
// Design (a bias policy, BiasI8 / BiasBF16 / BiasF32 / BiasRel, is the
// only difference between the kernels; the PTX helpers, the slab policies
// and the tensor maps are sm90.cuh's, shared with the backward kernels):
// - One CTA per (b*h, tile of 192 query rows): three consumer warpgroups,
//   each owning 64 rows, and one producer warpgroup of which one warp
//   works. setmaxnreg moves registers from the producer (24) to the
//   consumers (160). One CTA per SM: Q 24 KB and the ring, 138 KB in all
//   (int8, four stages), 145 KB (bf16, three), 217 KB (float32, three) or
//   92 KB (BiasRel, four, with its tables at L = 1536).
// - The producer warp keeps the ring in flight. A stage holds a 64-key K
//   tile and V tile (TMA, 4-D tensor maps (D, H, L, B) so that rows past L
//   are zero-filled within each batch, 128-byte swizzle: one row of 64 bf16
//   is one swizzle atom), for the slab policies the bias tile of the CTA's
//   192 query rows for those keys (TMA where the bias row stride is a
//   multiple of 16 bytes, 3-D map (L, L, B*H) with the 64-byte (int8) or
//   128-byte swizzle; otherwise the producer warp copies it element by
//   element with zero-fill, into the same swizzled layout, since such rows
//   are only 1-, 2- or 4-byte aligned), for BiasI8 the 64 key-mask terms
//   (0 or -1e30) and for BiasRel the 64 keys' box centres and mask (768
//   bytes, no bias bytes), each with a flag saying whether any key is
//   masked or at or past L. Completion is signalled on the stage's `full`
//   mbarrier (32 producer arrivals plus the TMA bytes); the consumers
//   release it on its `empty` mbarrier.
// - S = bias + Q K^T: each thread puts the bias at its accumulator-fragment
//   positions into the accumulator registers (slab policies: read from the
//   stage; BiasI8: __fmul_rn(code, scale_h), then __fadd_rn(., mask_j) in
//   tiles with a masked key, the plain version's order, adding a 0 mask term
//   changes nothing; BiasRel: computed, below; -1e30 for keys at or past L),
//   then four wgmma.m64n64k16 (bf16 operands from shared memory, float32
//   accumulation) add the dots to it.
// - The online softmax runs on the accumulator fragments: each thread holds
//   16 scores of 2 rows, the 4 threads of a row meet by shuffles. e^x is
//   ex2.approx.ftz(x log2 e): weights below 2^-126 of the row's largest
//   flush to 0.
// - P enters PV from registers as the A operand of wgmma, as a bf16 hi + lo
//   pair (two products into the same float32 accumulator), so P keeps
//   float32-level accuracy; V is the B operand in MN-major form (the layout
//   TMA wrote, no transpose). No S, P or PV tile goes through shared memory.
// - Each warpgroup overlaps tile t's QK^T and softmax with tile t-1's PV on
//   the tensor cores; the output rescale by e^(m_old - m_new) waits for
//   that PV and is skipped by a warp whose row maxima did not move.
// - Epilogue: IEEE division by max(l, 1e-30), bf16 pairs straight from the
//   fragments to the output; lse = m + log(max(l, 1e-30)).
//
// BiasRel, bias = (t1[b1(j - i)] + th[bh]) + tv[bv] (mask_j ? bias : -1e30)
// with bh the bucket of trunc((hx_j - hx_i) * scaling), bv the same over
// vy, is bit-exact against relbias.centre_position_bias:
// - At the CTA's start every thread helps compose each bucket LUT with its
//   head's table column (pure indexing, no arithmetic) into shared memory:
//   t1 over distances -(max1 + 96) .. max1 + 96 (saturated past max1, where
//   the T5 buckets already are), th and tv over 0 .. max2 for each sign.
//   Each term is then one shared load, not a LUT load and a table load.
// - A thread keeps its two query rows' centres in registers and reads the
//   key centres from the stage. The 2d index: d = (c_j - c_i) * scaling by
//   __fsub_rn then __fmul_rn; n = floor(min(|d|, max2)) from the bits of
//   __fadd_rz(min(|d|, max2), 2^23) (no float-to-int conversion, which runs
//   at an eighth of the FP32 rate); the sign of d picks the table:
//   trunc(d) clamped to +-max2, as the plain version's int32 cast and LUT.
//   Then __fadd_rn(__fadd_rn(t1, th), tv) and the mask select, the plain
//   order. About 17 FP32 / integer operations and 2-3 shared loads a score.
// - The 1d term needs no arithmetic: on a tile whose keys are all at least
//   max1 from the warp's 16 rows (on one side) it is one constant per side;
//   on the others (about 5 of 24 tiles per warp at L = 1536) an immediate-
//   offset load from a per-row pointer into the widened t1 table.
// - Registers: the policy adds the rows' four centres, the two far-tile
//   constants and five table addresses to the core's state (ptxas report in
//   chip_smoke phase 2).
#pragma once

#include <type_traits>

#include "sm90.cuh"

namespace ffwd {

using namespace sm90;

constexpr int kBM = 64;              // query rows of a consumer warpgroup
constexpr int kWG = 3;               // consumer warpgroups per CTA
constexpr int kRows = kWG * kBM;     // query rows per CTA
constexpr int kThreads = (kWG + 1) * 128;
constexpr int kProducerRegs = 24, kConsumerRegs = 160;

// the float32 policy over the CTA's kRows-row bias tiles
using BiasF32 = BiasF32Rows<kRows>;

// the relative bias computed in the kernel: the stage carries the keys'
// centres and mask, no bias tile
struct BiasRel {
  using T = float;
  static constexpr bool kKeyMask = false;
  static constexpr bool kLse = false;
  static constexpr int kStages = 4;
};

// BiasRel's 1d table spans distances -(max1 + kRelPad) .. max1 + kRelPad:
// a tile that is not far from a warp's 16 rows holds distances within
// max1 + 15 + 63 of them
constexpr int kRelPad = 96;

// Shared memory of a CTA (byte offsets from a 1024-aligned base): the Q
// tiles of the warpgroups, the stages (K tile, V tile, bias tile), then per
// stage its keys' words (BiasI8: 64 float mask terms; BiasRel: 64 hx, 64
// vy, 64 int mask) and a flag; BiasRel's composed tables follow (their
// size depends on max1 and max2, rel_bytes).
template <class P>
struct Layout {
  static constexpr bool kRel = std::is_same_v<P, BiasRel>;
  static constexpr int kStages = P::kStages;
  static constexpr int kBiasBytes =
      kRel ? 0 : kRows * kBN * (int)sizeof(typename P::T);
  static constexpr int kStage0 = kWG * kTile;
  static constexpr int kStageBytes = 2 * kTile + kBiasBytes;
  static constexpr int kKeyWords = P::kKeyMask ? 1 : kRel ? 3 : 0;
  static constexpr int kMask = kStage0 + kStages * kStageBytes;
  static constexpr int kFlags = kMask + kStages * kBN * 4 * kKeyWords;
  static constexpr int kBytes = kFlags + (kKeyWords ? kStages * 4 : 0);
  static constexpr int kAlloc = kBytes + 1024;  // room to align the base
};

// BiasRel's tables: t1 [2 (max1 + kRelPad) + 1], th+ th- tv+ tv- [max2 + 1]
__host__ __device__ inline int rel_words(int max1, int max2) {
  return 2 * (max1 + kRelPad) + 1 + 4 * (max2 + 1);
}

struct Params {
  const void* bias;      // [B or 1, H, L, L]; copied by the producer warp
                         // when bias_tma == 0
  const float* scales;   // [H] (BiasI8)
  const int* key_mask;   // [B, L] (BiasI8, BiasRel)
  bf16* out;             // [B, L, H, 64]
  float* lse;            // [B, H, L] (BiasBF16, BiasF32)
  int L, H, bias_batched, bias_tma;
  // BiasRel: box centres [B, L], the tables [3, nb, H] (1d, horizontal,
  // vertical), the bucket LUTs [2 max1 + 1] and [2 max2 + 1]
  const float* hx;
  const float* vy;
  const float* tables;
  const int* lut1;
  const int* lut2;
  int nb, max1, max2;
  float scaling;
  float* scores;  // [B, H, L, L]: the debug instance stores each score's
                  // bias term (the accumulator's start) here
};

// ---- the online softmax on the fragments

// max and sum over a thread's 16 scores of row r (O = 0) or r + 8 (O = 2),
// as trees
template <int O>
__device__ __forceinline__ float row_max(const float (&s)[32]) {
  float t[8];
#pragma unroll
  for (int j = 0; j < 8; ++j) t[j] = fmaxf(s[4 * j + O], s[4 * j + O + 1]);
#pragma unroll
  for (int w = 4; w >= 1; w >>= 1)
#pragma unroll
    for (int j = 0; j < w; ++j) t[j] = fmaxf(t[j], t[j + w]);
  return t[0];
}
template <int O>
__device__ __forceinline__ float row_sum(const float (&s)[32]) {
  float t[8];
#pragma unroll
  for (int j = 0; j < 8; ++j) t[j] = s[4 * j + O] + s[4 * j + O + 1];
#pragma unroll
  for (int w = 4; w >= 1; w >>= 1)
#pragma unroll
    for (int j = 0; j < w; ++j) t[j] += t[j + w];
  return t[0];
}

// One online-softmax step over the tile of keys k0 .. k0 + 63: s = bias +
// dot (-1e30 at or past L) becomes p = e^(s - m_new) in place (p = 0 past
// L); m and l are updated; al = e^(m_old - m_new) rescales the output
// accumulator.
__device__ __forceinline__ void softmax_step(float (&s)[32], int k0, int L,
                                             int cq, float& m0, float& m1,
                                             float& l0, float& l1,
                                             float& al0, float& al1) {
  float mx0 = row_max<0>(s), mx1 = row_max<2>(s);
#pragma unroll
  for (int o = 1; o <= 2; o <<= 1) {
    mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, o));
    mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, o));
  }
  const float mn0 = fmaxf(m0, mx0), mn1 = fmaxf(m1, mx1);
  al0 = ex(m0 - mn0);
  al1 = ex(m1 - mn1);
  m0 = mn0;
  m1 = mn1;
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    s[4 * j] = ex(s[4 * j] - mn0);
    s[4 * j + 1] = ex(s[4 * j + 1] - mn0);
    s[4 * j + 2] = ex(s[4 * j + 2] - mn1);
    s[4 * j + 3] = ex(s[4 * j + 3] - mn1);
  }
  if (k0 + kBN > L) {
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int c = k0 + 8 * j + cq;
      if (c >= L) s[4 * j] = s[4 * j + 2] = 0.f;
      if (c + 1 >= L) s[4 * j + 1] = s[4 * j + 3] = 0.f;
    }
  }
  l0 = l0 * al0 + row_sum<0>(s);
  l1 = l1 * al1 + row_sum<2>(s);
}

// acc *= al per row; a warp whose rows' maxima all stayed skips it
__device__ __forceinline__ void rescale(float (&acc)[32], float al0,
                                        float al1) {
  if (!__any_sync(0xffffffffu, al0 != 1.f || al1 != 1.f)) return;
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    acc[4 * j] *= al0;
    acc[4 * j + 1] *= al0;
    acc[4 * j + 2] *= al1;
    acc[4 * j + 3] *= al1;
  }
}

// ---- BiasRel: the bias terms of a thread's 32 scores, computed

// a thread's state for BiasRel: its two rows' centres, its pointer into the
// 1d table, the far-tile constants, the 2d tables' addresses
struct RelRows {
  float hx0, hx1, vy0, vy1;  // rows r and r + 8
  const float* t1;           // t1 of key cq (+ k0) against row r
  float tpos, tneg;          // t1 at distance +max1 and -max1
  // th+, th-, tv+, tv-: shared addresses less 4 * 0x4B000000, so that the
  // bits of 2^23 + n shifted by 2 land on entry n
  uint32_t thp, thn, tvp, tvn;
  float scaling, lim;
};

// the 2d term of a key at centre ck against a row at ci: entry
// trunc((ck - ci) * scaling), clamped to +-max2, of the table pair (pos,
// neg) (the sign of the difference picks the table, its floor of |d| the
// entry)
__device__ __forceinline__ float rel2(float ck, float ci, float scaling,
                                      float lim, uint32_t pos, uint32_t neg) {
  const float d = __fmul_rn(__fsub_rn(ck, ci), scaling);
  const uint32_t n =
      __float_as_uint(__fadd_rz(fminf(fabsf(d), lim), 8388608.f));
  float v;
  asm("ld.shared.f32 %0, [%1];"
      : "=f"(v)
      : "r"((d < 0.f ? neg : pos) + (n << 2)));
  return v;
}

// the bias of the thread's 32 scores of the tile at k0 into s: key pairs
// 8 j + cq of the stage's centres kh / kv and mask km (masked: some key of
// the tile is masked or at or past L; such keys score -1e30). kNear: the
// 1d term from the table, else the constant t1c.
template <bool kNear>
__device__ __forceinline__ void rel_bias(float (&s)[32], const float* kh,
                                         const float* kv, const int* km,
                                         bool masked, int k0, int cq,
                                         const RelRows& R, float t1c) {
  const float* t1a = R.t1 + k0;  // row r
  const float* t1b = t1a - 8;    // row r + 8
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    const float2 ch = *reinterpret_cast<const float2*>(kh + 8 * j + cq);
    const float2 cv = *reinterpret_cast<const float2*>(kv + 8 * j + cq);
    float a0 = t1c, a1 = t1c, b0 = t1c, b1 = t1c;
    if constexpr (kNear) {
      a0 = t1a[8 * j];
      a1 = t1a[8 * j + 1];
      b0 = t1b[8 * j];
      b1 = t1b[8 * j + 1];
    }
    s[4 * j] = __fadd_rn(
        __fadd_rn(a0, rel2(ch.x, R.hx0, R.scaling, R.lim, R.thp, R.thn)),
        rel2(cv.x, R.vy0, R.scaling, R.lim, R.tvp, R.tvn));
    s[4 * j + 1] = __fadd_rn(
        __fadd_rn(a1, rel2(ch.y, R.hx0, R.scaling, R.lim, R.thp, R.thn)),
        rel2(cv.y, R.vy0, R.scaling, R.lim, R.tvp, R.tvn));
    s[4 * j + 2] = __fadd_rn(
        __fadd_rn(b0, rel2(ch.x, R.hx1, R.scaling, R.lim, R.thp, R.thn)),
        rel2(cv.x, R.vy1, R.scaling, R.lim, R.tvp, R.tvn));
    s[4 * j + 3] = __fadd_rn(
        __fadd_rn(b1, rel2(ch.y, R.hx1, R.scaling, R.lim, R.thp, R.thn)),
        rel2(cv.y, R.vy1, R.scaling, R.lim, R.tvp, R.tvn));
    if (masked) {
      const int2 m = *reinterpret_cast<const int2*>(km + 8 * j + cq);
      if (!m.x) s[4 * j] = s[4 * j + 2] = kNegInf;
      if (!m.y) s[4 * j + 1] = s[4 * j + 3] = kNegInf;
    }
  }
}

// ---- the kernel body

// kDebug: also store each score's bias term (the accumulator's start, before
// Q K^T adds to it) to p.scores; a separate instance, on no serving path
template <class P, bool kDebug = false>
__device__ __forceinline__ void flash_fwd(const CUtensorMap& tq,
                                          const CUtensorMap& tk,
                                          const CUtensorMap& tv,
                                          const CUtensorMap& tb,
                                          const Params& p) {
  using Lay = Layout<P>;
  using T = typename P::T;
  constexpr bool kRel = Lay::kRel;
  constexpr int S = Lay::kStages;
  extern __shared__ uint8_t smem_raw[];
  __shared__ uint64_t full[S], empty[S], qbar;
  uint8_t* smem = smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);

  const int L = p.L, H = p.H;
  const int bh = blockIdx.y, b = bh / H, h = bh % H;
  const int q0 = blockIdx.x * kRows;
  const int n_tiles = (L + kBN - 1) / kBN;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  auto stage_of = [&](int t) {
    return smem + Lay::kStage0 + (t % S) * Lay::kStageBytes;
  };
  float* rel_tab = reinterpret_cast<float*>(smem + Lay::kBytes);

  if (threadIdx.x == 0) {
#pragma unroll
    for (int s = 0; s < S; ++s) {
      mbar_init(&full[s], 32);
      mbar_init(&empty[s], kWG * 128);
    }
    mbar_init(&qbar, 1);
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  if constexpr (kRel) {
    // each bucket LUT composed with this head's table column
    const int E = p.max1 + kRelPad, n1 = 2 * E + 1, n2 = p.max2 + 1;
    for (int u = threadIdx.x; u < n1; u += kThreads) {
      const int rel = min(max(u - E, -p.max1), p.max1);
      rel_tab[u] = p.tables[(size_t)p.lut1[rel + p.max1] * H + h];
    }
    // th+, th-, tv+, tv-: entry n at distance +n or -n
    for (int u = threadIdx.x; u < 4 * n2; u += kThreads) {
      const int which = u / n2, n = u % n2;
      const int idx = p.max2 + ((which & 1) ? -n : n);
      rel_tab[n1 + u] =
          p.tables[((size_t)(1 + (which >> 1)) * p.nb + p.lut2[idx]) * H +
                   h];
    }
  }
  __syncthreads();

  if (warp >= kWG * 4) {
    // producer warpgroup; its first warp loads Q once, then keeps the ring
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;" ::"n"(kProducerRegs));
    if (warp != kWG * 4) return;
    const int bhb = (p.bias_batched ? b : 0) * H + h;
    if (lane == 0) {
      mbar_arrive_tx(&qbar, kWG * kTile);
#pragma unroll
      for (int w = 0; w < kWG; ++w)
        tma_4d(smem + w * kTile, tq, &qbar, 0, h, q0 + w * kBM, b);
    }
    const uint32_t tx = 2 * kTile + (p.bias_tma ? Lay::kBiasBytes : 0);
    for (int t = 0; t < n_tiles; ++t) {
      const int s = t % S;
      const int k0 = t * kBN;
      uint8_t* stage = stage_of(t);
      mbar_wait(&empty[s], ((t / S) & 1) ^ 1);
      if constexpr (Lay::kKeyWords > 0) {
        float* kd = reinterpret_cast<float*>(smem + Lay::kMask) +
                    s * kBN * Lay::kKeyWords;
        bool any = false;
        for (int c = lane; c < kBN; c += 32) {
          const int j = k0 + c;
          const size_t at = (size_t)b * L + (j < L ? j : 0);
          const bool on = j < L && p.key_mask[at] > 0;
          if constexpr (kRel) {
            // the keys' centres and mask (keys at or past L are masked)
            kd[c] = p.hx[at];
            kd[kBN + c] = p.vy[at];
            reinterpret_cast<int*>(kd)[2 * kBN + c] = on;
          } else {
            kd[c] = on ? 0.f : kNegInf;
          }
          any |= !on;
        }
        any = __any_sync(0xffffffffu, any);
        if (lane == 0) reinterpret_cast<int*>(smem + Lay::kFlags)[s] = any;
      }
      if constexpr (!kRel) {
        if (!p.bias_tma) {
          uint8_t* btile = stage + 2 * kTile;
          const T* src = static_cast<const T*>(p.bias) + (size_t)bhb * L * L;
          for (int e = lane; e < kRows * kBN; e += 32) {
            const int r = e / kBN, c = e % kBN;
            const int i = q0 + r, j = k0 + c;
            T val{};
            if (i < L && j < L) val = src[(size_t)i * L + j];
            *reinterpret_cast<T*>(btile + P::offset(r, c)) = val;
          }
        }
      }
      if (lane == 0) {
        mbar_arrive_tx(&full[s], tx);
        tma_4d(stage, tk, &full[s], 0, h, k0, b);
        tma_4d(stage + kTile, tv, &full[s], 0, h, k0, b);
        if constexpr (!kRel) {
          if (p.bias_tma) {
            uint8_t* btile = stage + 2 * kTile;
#pragma unroll
            for (int c = 0; c < kBN; c += P::kBoxCols)
              tma_3d(btile + (c / P::kBoxCols) * kRows * P::kBoxCols *
                                 (int)sizeof(T),
                     tb, &full[s], k0 + c, q0, bhb);
          }
        }
      } else {
        mbar_arrive(&full[s]);
      }
    }
    return;
  }

  // consumer warpgroup wg: query rows q0 + 64 wg .. + 63. This thread holds
  // rows r and r + 8 of them, keys 8 j + cq and 8 j + cq + 1 (j = 0 .. 7) of
  // each 64-key tile: s[4 j + {0, 1}] on row r, s[4 j + {2, 3}] on row r + 8
  // (the wgmma accumulator layout); acc the same over the 64 head dims.
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;" ::"n"(kConsumerRegs));
  const int wg = warp / 4;
  const int r = (warp % 4) * 16 + lane / 4;
  const int brow = wg * kBM + r;  // row in the CTA's bias tile
  const int cq = 2 * (lane % 4);
  const int i0 = q0 + brow, i1 = i0 + 8;
  float scale = 0.f;
  if constexpr (P::kKeyMask) scale = p.scales[h];
  const float* masks = reinterpret_cast<const float*>(smem + Lay::kMask);
  const int* flags = reinterpret_cast<const int*>(smem + Lay::kFlags);
  float acc[32], s[32];
  uint32_t hi[16], lo[16];
#pragma unroll
  for (int e = 0; e < 32; ++e) acc[e] = s[e] = 0.f;
  float m0 = kNegInf, m1 = kNegInf, l0 = 0.f, l1 = 0.f, al0, al1;
  const uint64_t dq = desc_sw128(smem + wg * kTile);
  auto wait_full = [&](int t) {
    mbar_wait(&full[t % S], (t / S) & 1);
    __syncwarp();
  };
  RelRows R{};
  const int iw = q0 + wg * kBM + (warp % 4) * 16;  // the warp's first row
  if constexpr (kRel) {
    const float* row_hx = p.hx + (size_t)b * L;
    const float* row_vy = p.vy + (size_t)b * L;
    R.hx0 = row_hx[min(i0, L - 1)];
    R.hx1 = row_hx[min(i1, L - 1)];
    R.vy0 = row_vy[min(i0, L - 1)];
    R.vy1 = row_vy[min(i1, L - 1)];
    const int E = p.max1 + kRelPad, n2 = p.max2 + 1;
    R.t1 = rel_tab + E + cq - i0;
    R.tpos = rel_tab[E + p.max1];
    R.tneg = rel_tab[E - p.max1];
    const uint32_t base = smem_u32(rel_tab + 2 * E + 1) - (0x4B000000u << 2);
    R.thp = base;
    R.thn = base + 4 * n2;
    R.tvp = base + 8 * n2;
    R.tvn = base + 12 * n2;
    R.scaling = p.scaling;
    R.lim = (float)p.max2;
  }
  auto bias_of = [&](int t) {  // into s
    const int k0 = t * kBN;
    if constexpr (kRel) {
      const float* kd = reinterpret_cast<const float*>(smem + Lay::kMask) +
                        (t % S) * 3 * kBN;
      const int* km = reinterpret_cast<const int*>(kd + 2 * kBN);
      const bool masked = flags[t % S];
      if (k0 - (iw + 15) >= p.max1)
        rel_bias<false>(s, kd, kd + kBN, km, masked, k0, cq, R, R.tpos);
      else if (k0 + kBN - 1 - iw <= -p.max1)
        rel_bias<false>(s, kd, kd + kBN, km, masked, k0, cq, R, R.tneg);
      else
        rel_bias<true>(s, kd, kd + kBN, km, masked, k0, cq, R, 0.f);
    } else {
      const int a0 = P::offset(brow, cq), a1 = P::offset(brow + 8, cq);
      const int tile = Lay::kStage0 + (t % S) * Lay::kStageBytes + 2 * kTile;
      load_bias<P>(s, smem, tile + a0, tile + a1, masks + (t % S) * kBN,
                   P::kKeyMask && flags[t % S], scale, cq, k0, L);
    }
    if constexpr (kDebug) {
#pragma unroll
      for (int j = 0; j < 8; ++j) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int i = e < 2 ? i0 : i1, c = k0 + 8 * j + cq + (e & 1);
          if (i < L && c < L)
            p.scores[((size_t)bh * L + i) * L + c] = s[4 * j + e];
        }
      }
    }
  };
  mbar_wait(&qbar, 0);
  __syncwarp();

  // tile 0: QK^T and softmax
  wait_full(0);
  bias_of(0);
  pin(s);
  wg_fence();
  qk(s, dq, desc_sw128(stage_of(0)));
  wg_commit();
  wg_wait<0>();
  pin(s);
  softmax_step(s, 0, L, cq, m0, m1, l0, l1, al0, al1);
  split(s, hi, lo);
  // tile t: its QK^T and softmax beside tile t - 1's PV
  for (int t = 1; t < n_tiles; ++t) {
    wait_full(t);
    bias_of(t);
    pin(s);
    pin(acc);
    pin(hi);
    pin(lo);
    wg_fence();
    qk(s, dq, desc_sw128(stage_of(t)));
    wg_commit();
    pv(acc, hi, lo, desc_sw128(stage_of(t - 1) + kTile));
    wg_commit();
    wg_wait<1>();
    pin(s);
    softmax_step(s, t * kBN, L, cq, m0, m1, l0, l1, al0, al1);
    wg_wait<0>();
    pin(acc);
    pin(hi);
    pin(lo);
    mbar_arrive(&empty[(t - 1) % S]);
    rescale(acc, al0, al1);
    split(s, hi, lo);
  }
  pin(acc);
  pin(hi);
  pin(lo);
  wg_fence();
  pv(acc, hi, lo, desc_sw128(stage_of(n_tiles - 1) + kTile));
  wg_commit();
  wg_wait<0>();
  pin(acc);
  mbar_arrive(&empty[(n_tiles - 1) % S]);

#pragma unroll
  for (int o = 1; o <= 2; o <<= 1) {
    l0 += __shfl_xor_sync(0xffffffffu, l0, o);
    l1 += __shfl_xor_sync(0xffffffffu, l1, o);
  }
  const float d0 = fmaxf(l0, 1e-30f), d1 = fmaxf(l1, 1e-30f);
  if (i0 < L) {
    __nv_bfloat162* o = reinterpret_cast<__nv_bfloat162*>(
        p.out + (((size_t)b * L + i0) * H + h) * kD + cq);
#pragma unroll
    for (int j = 0; j < 8; ++j)
      o[4 * j] = __floats2bfloat162_rn(__fdiv_rn(acc[4 * j], d0),
                                       __fdiv_rn(acc[4 * j + 1], d0));
  }
  if (i1 < L) {
    __nv_bfloat162* o = reinterpret_cast<__nv_bfloat162*>(
        p.out + (((size_t)b * L + i1) * H + h) * kD + cq);
#pragma unroll
    for (int j = 0; j < 8; ++j)
      o[4 * j] = __floats2bfloat162_rn(__fdiv_rn(acc[4 * j + 2], d1),
                                       __fdiv_rn(acc[4 * j + 3], d1));
  }
  if constexpr (P::kLse) {
    if (lane % 4 == 0) {
      if (i0 < L) p.lse[(size_t)bh * L + i0] = m0 + logf(d0);
      if (i1 < L) p.lse[(size_t)bh * L + i1] = m1 + logf(d1);
    }
  }
}

// ---- host side: the launch

using Kernel = void (*)(const CUtensorMap, const CUtensorMap,
                        const CUtensorMap, const CUtensorMap, const Params);

// Build the tensor maps (the bias by TMA only where its row stride and base
// allow it; BiasRel has none) and launch one CTA per (b*h, kRows query
// rows).
template <class P>
int launch(Kernel kernel, const void* q, const void* k, const void* v,
           Params p, int B, cudaStream_t stream) {
  if (B <= 0 || p.L <= 0 || p.H <= 0) return (int)cudaErrorInvalidValue;
  if (!encoder()) return (int)cudaErrorNotSupported;
  if (!aligned16(q) || !aligned16(k) || !aligned16(v))
    return (int)cudaErrorMisalignedAddress;
  CUtensorMap tq, tk, tv, tb;
  std::memset(&tb, 0, sizeof(tb));
  if (!qkv_map(&tq, q, B, p.L, p.H) || !qkv_map(&tk, k, B, p.L, p.H) ||
      !qkv_map(&tv, v, B, p.L, p.H))
    return (int)cudaErrorInvalidValue;
  int smem = Layout<P>::kAlloc;
  if constexpr (std::is_same_v<P, BiasRel>) {
    p.bias_tma = 0;
    if (p.nb <= 0 || p.max1 < 0 || p.max2 < 0)
      return (int)cudaErrorInvalidValue;
    smem += rel_words(p.max1, p.max2) * 4;
    if (smem > 227 * 1024) return (int)cudaErrorInvalidValue;
  } else {
    p.bias_tma = bias_tma_ok<P>(p.L, p.bias);
    if (p.bias_tma &&
        !bias_map<P>(&tb, p.bias, (p.bias_batched ? B : 1) * p.H, p.L,
                      kRows))
      return (int)cudaErrorInvalidValue;
  }
  cudaError_t e = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return (int)e;
  const dim3 grid((p.L + kRows - 1) / kRows, B * p.H);
  kernel<<<grid, kThreads, smem, stream>>>(tq, tk, tv, tb, p);
  return (int)cudaGetLastError();
}

}  // namespace ffwd
