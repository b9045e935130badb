// Backward of the float-bias flash attention (flash_bias.cu): dK / dV, and
// dQ with d(bias).
//
// Replaces _flash_attention_bwd_dkv and _flash_attention_bwd_dq of the stock
// Pallas TPU flash attention the reference trains with
// (jax/experimental/pallas/ops/tpu/flash_attention.py, called at
// markushgrapher_tpu/models/t5.py:376-385; scale 1). The split mirrors the
// stock one so that neither kernel needs atomics and the result is
// deterministic:
//   - dkv: one CTA per (b*h, 128 keys), looping over the query tiles;
//   - dq:  one CTA per (b*h, 128 queries), looping over the key tiles, and
//          writing dS as d(bias) in the bias dtype (float32 or bf16).
// Both recompute, per tile pair, s = q k^T + bias, P = e^(s - lse) (lse from
// the forward), dP = dO v^T and dS = P * (dP - di), di = sum(o * dO) over D
// from the wrapper. Then dV += P^T dO, dK += dS^T q (dkv) or dQ += dS k (dq).
//
// Bound: at B=8, H=16, L=1536, D=64 the two must read q, k, v, dO and the
// 604 MB bias and write dq, dk, dv and the 604 MB d(bias): dq moves ~1.2 GB
// (0.36 ms at 3.35 TB/s), dkv ~0.7 GB; their 10 bf16 products (P and dS as
// hi + lo pairs count twice) are ~387 GFLOP (0.39 ms at 989 TFLOP/s).
//
// Design: the Hopper pieces of sm90.cuh, as the forward core
// (flash_fwd_sm90.cuh) uses them.
// - Warp-specialised CTAs: two consumer warpgroups of 64 rows each and a
//   producer warpgroup of which one warp works; setmaxnreg moves registers
//   from the producer (24) to the consumers (240), since each consumer keeps
//   S, dP, the accumulators and two hi + lo pairs in registers. One CTA per
//   SM.
// - The producer keeps a ring of stages in flight by TMA (128-byte
//   swizzle, 4-D maps so that rows past L are zero-filled within each
//   batch): dq's stage is the key tile's K and V and the bias tile of the
//   CTA's 128 queries; dkv's is the query tile's Q and dO, the bias tile of
//   those queries against the CTA's 128 keys, and the tile's lse and di.
//   Bias rows TMA cannot stride (row bytes no multiple of 16) are copied by
//   the producer warp into the same swizzled layout.
// - Every product is wgmma m64n64k16 with float32 accumulation and every
//   shared operand is in the layout TMA wrote:
//     dq:  S = bias + Q K^T and dP = dO V^T (K-major), dQ += dS K (dS a
//          register A operand, K MN-major);
//     dkv: S^T = bias^T + K Q^T and dP^T = V dO^T, so that P^T and dS^T are
//          accumulator fragments of the key rows; then dV += P^T dO and
//          dK += dS^T Q with the pairs as register A operands and dO, Q
//          MN-major. The bias tile is read transposed out of its swizzled
//          stage (a thread's four (query, key) bases, +1024 bytes per 8
//          queries: no bank conflicts).
//   P and dS enter products as bf16 hi + lo pairs (a single bf16 fails the
//   in-model gate); no S, P or dS tile goes through shared memory, except
//   dq's float32 dS on its way out as d(bias).
// - Each warpgroup overlaps tile t's two score products and elementwise
//   step with tile t-1's gradient products on the tensor cores.
// - d(bias): each dq thread writes its dS pairs, rounded to the bias dtype,
//   over the bias values it read from the stage (the same swizzled
//   positions); the warpgroup meets at a named barrier and one thread stores
//   its 64 rows by TMA (out-of-bounds rows and keys are dropped). The stage
//   is released once the store has read it. Where TMA cannot stride the
//   rows, the warpgroup copies the tile out with coalesced stores.
// - lse and di are per query row: no online softmax and no rescale. e^x is
//   ex2.approx.ftz((s - lse) log2 e); p = 0 exactly for keys or queries at
//   or past L (their scores are -1e30 and their terms zeroed).

#include "sm90.cuh"

namespace {

using namespace sm90;

constexpr int kWG = 2;            // consumer warpgroups per CTA
constexpr int kBM = 64;           // rows of a consumer warpgroup
constexpr int kRows = kWG * kBM;  // keys (dkv) or queries (dq) per CTA
constexpr int kThreads = (kWG + 1) * 128;
constexpr int kProducerRegs = 24, kConsumerRegs = 240;

constexpr int align1024(int n) { return (n + 1023) / 1024 * 1024; }

struct Params {
  const void* bias;     // [B or 1, H, L, L]; copied by the producer warp
                        // when bias_tma == 0
  const float* lse;     // [B, H, L]
  const float* di;      // [B, H, L]
  bf16 *dq, *dk, *dv;   // [B, L, H, 64]
  void* dbias;          // [B, H, L, L]; stored by TMA when bias_tma
  int L, H, bias_batched, bias_tma;
};

// dkv's shared memory (byte offsets from a 1024-aligned base): the K tiles
// of the two warpgroups, their V tiles, then the stages: Q tile, dO tile,
// the bias tile as one 64-query x 64-key sub-tile per warpgroup, lse, di.
template <class P>
struct DkvLayout {
  static constexpr int kStages = sizeof(typename P::T) == 2 ? 4 : 3;
  static constexpr int kBiasWG = kBN * kBM * (int)sizeof(typename P::T);
  static constexpr int kBias = 2 * kTile;
  static constexpr int kLse = kBias + kWG * kBiasWG;
  static constexpr int kDi = kLse + kBN * 4;
  static constexpr int kStageBytes = align1024(kDi + kBN * 4);
  static constexpr int kStage0 = 2 * kWG * kTile;
  static constexpr int kAlloc = kStage0 + kStages * kStageBytes + 1024;
};

// dq's: the Q tiles of the two warpgroups, their dO tiles, then the stages:
// K tile, V tile, the bias tile of the CTA's 128 queries x 64 keys.
template <class P>
struct DqLayout {
  static constexpr int kStages = sizeof(typename P::T) == 2 ? 4 : 3;
  static constexpr int kBias = 2 * kTile;
  static constexpr int kBiasBytes = kRows * kBN * (int)sizeof(typename P::T);
  static constexpr int kStageBytes = kBias + kBiasBytes;
  static constexpr int kStage0 = 2 * kWG * kTile;
  static constexpr int kAlloc = kStage0 + kStages * kStageBytes + 1024;
};

template <int S>
__device__ __forceinline__ void init_ring(uint64_t (&full)[S],
                                          uint64_t (&empty)[S],
                                          uint64_t* once) {
  if (threadIdx.x == 0) {
#pragma unroll
    for (int s = 0; s < S; ++s) {
      mbar_init(&full[s], 32);
      mbar_init(&empty[s], kWG * 128);
    }
    mbar_init(once, 1);
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();
}

// ---- dK / dV: one CTA per (b*h, 128 keys)

template <class P>
__global__ void __launch_bounds__(kThreads, 1)
flash_bias_dkv_kernel(const __grid_constant__ CUtensorMap tq,
                      const __grid_constant__ CUtensorMap tk,
                      const __grid_constant__ CUtensorMap tv,
                      const __grid_constant__ CUtensorMap tdo,
                      const __grid_constant__ CUtensorMap tb,
                      const __grid_constant__ CUtensorMap tds,  // unused
                      const Params p) {
  using Lay = DkvLayout<P>;
  using T = typename P::T;
  constexpr int S = Lay::kStages;
  extern __shared__ uint8_t smem_raw[];
  __shared__ uint64_t full[S], empty[S], kvbar;
  uint8_t* smem = smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);

  const int L = p.L, H = p.H;
  const int bh = blockIdx.y, b = bh / H, h = bh % H;
  const int k0 = blockIdx.x * kRows;
  const int n_tiles = (L + kBN - 1) / kBN;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  auto stage_of = [&](int t) {
    return smem + Lay::kStage0 + (t % S) * Lay::kStageBytes;
  };
  init_ring(full, empty, &kvbar);

  if (warp >= kWG * 4) {
    // producer warpgroup; its first warp loads K and V once, then keeps
    // the ring
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;" ::"n"(kProducerRegs));
    if (warp != kWG * 4) return;
    const int bhb = (p.bias_batched ? b : 0) * H + h;
    if (lane == 0) {
      mbar_arrive_tx(&kvbar, 2 * kWG * kTile);
#pragma unroll
      for (int w = 0; w < kWG; ++w) {
        tma_4d(smem + w * kTile, tk, &kvbar, 0, h, k0 + w * kBM, b);
        tma_4d(smem + (kWG + w) * kTile, tv, &kvbar, 0, h, k0 + w * kBM, b);
      }
    }
    const uint32_t tx = 2 * kTile + (p.bias_tma ? kWG * Lay::kBiasWG : 0);
    for (int t = 0; t < n_tiles; ++t) {
      const int s = t % S;
      const int q0 = t * kBN;
      uint8_t* stage = stage_of(t);
      // the tile's lse and di, read before the slot frees
      float ls[2], dd[2];
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int i = q0 + lane + 32 * e;
        ls[e] = i < L ? p.lse[(size_t)bh * L + i] : 0.f;
        dd[e] = i < L ? p.di[(size_t)bh * L + i] : 0.f;
      }
      mbar_wait(&empty[s], ((t / S) & 1) ^ 1);
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        reinterpret_cast<float*>(stage + Lay::kLse)[lane + 32 * e] = ls[e];
        reinterpret_cast<float*>(stage + Lay::kDi)[lane + 32 * e] = dd[e];
      }
      if (!p.bias_tma) {
        const T* src = static_cast<const T*>(p.bias) + (size_t)bhb * L * L;
        for (int e = lane; e < kBN * kRows; e += 32) {
          const int r = e / kRows, c = e % kRows;  // query, key of the CTA
          const int i = q0 + r, j = k0 + c;
          T val{};
          if (i < L && j < L) val = src[(size_t)i * L + j];
          *reinterpret_cast<T*>(stage + Lay::kBias + (c / kBM) * Lay::kBiasWG +
                                P::offset(r, c % kBM)) = val;
        }
      }
      if (lane == 0) {
        mbar_arrive_tx(&full[s], tx);
        tma_4d(stage, tq, &full[s], 0, h, q0, b);
        tma_4d(stage + kTile, tdo, &full[s], 0, h, q0, b);
        if (p.bias_tma) {
#pragma unroll
          for (int c = 0; c < kRows; c += P::kBoxCols)
            tma_3d(stage + Lay::kBias + (c / kBM) * Lay::kBiasWG +
                       (c % kBM) / P::kBoxCols * kBN * P::kBoxCols *
                           (int)sizeof(T),
                   tb, &full[s], k0 + c, q0, bhb);
        }
      } else {
        mbar_arrive(&full[s]);
      }
    }
    return;
  }

  // consumer warpgroup wg: keys kw .. kw + 63 of the CTA. This thread holds
  // keys kr = kw + r and kr + 8, queries 8 j + cq and 8 j + cq + 1 of each
  // 64-query tile: s[4 j + {0, 1}] on key kr, s[4 j + {2, 3}] on kr + 8 (the
  // wgmma accumulator layout); dk and dv the same over the 64 head dims.
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;" ::"n"(kConsumerRegs));
  const int wg = warp / 4;
  const int r = (warp % 4) * 16 + lane / 4;
  const int cq = 2 * (lane % 4);
  const int kr = k0 + wg * kBM + r;
  // bias^T: (query 8 j + cq + e, key r + 8 f) of the warpgroup's sub-tile
  // lies at ta[e + 2 f] + 1024 j
  int ta[4];
#pragma unroll
  for (int f = 0; f < 2; ++f)
#pragma unroll
    for (int e = 0; e < 2; ++e)
      ta[e + 2 * f] =
          Lay::kBias + wg * Lay::kBiasWG + P::offset(cq + e, r + 8 * f);
  const uint64_t dkd = desc_sw128(smem + wg * kTile);
  const uint64_t dvd = desc_sw128(smem + (kWG + wg) * kTile);
  float dk[32], dv[32], s[32], dp[32];
  uint32_t ph[16], pl[16], sh[16], sl[16];
#pragma unroll
  for (int e = 0; e < 32; ++e) dk[e] = dv[e] = s[e] = dp[e] = 0.f;
  auto wait_full = [&](int t) {
    mbar_wait(&full[t % S], (t / S) & 1);
    __syncwarp();
  };
  auto bias_of = [&](int t) {  // bias^T into s; -1e30 on keys past L
    const uint8_t* st = stage_of(t);
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[4 * j + e] = P::one(st + ta[e] + 1024 * j);
    if (kr >= L) {
#pragma unroll
      for (int j = 0; j < 8; ++j) s[4 * j] = s[4 * j + 1] = kNegInf;
    }
    if (kr + 8 >= L) {
#pragma unroll
      for (int j = 0; j < 8; ++j) s[4 * j + 2] = s[4 * j + 3] = kNegInf;
    }
  };
  auto grads = [&](int t) {  // s: S^T -> P^T, dp: dP^T -> dS^T
    const uint8_t* st = stage_of(t);
    const float* lse = reinterpret_cast<const float*>(st + Lay::kLse);
    const float* di = reinterpret_cast<const float*>(st + Lay::kDi);
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const float2 l = *reinterpret_cast<const float2*>(lse + 8 * j + cq);
      const float2 d = *reinterpret_cast<const float2*>(di + 8 * j + cq);
      s[4 * j] = ex(s[4 * j] - l.x);
      s[4 * j + 1] = ex(s[4 * j + 1] - l.y);
      s[4 * j + 2] = ex(s[4 * j + 2] - l.x);
      s[4 * j + 3] = ex(s[4 * j + 3] - l.y);
      dp[4 * j] = s[4 * j] * (dp[4 * j] - d.x);
      dp[4 * j + 1] = s[4 * j + 1] * (dp[4 * j + 1] - d.y);
      dp[4 * j + 2] = s[4 * j + 2] * (dp[4 * j + 2] - d.x);
      dp[4 * j + 3] = s[4 * j + 3] * (dp[4 * j + 3] - d.y);
    }
    if ((t + 1) * kBN > L) {
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const int c = t * kBN + 8 * j + cq;
        if (c >= L) s[4 * j] = s[4 * j + 2] = dp[4 * j] = dp[4 * j + 2] = 0.f;
        if (c + 1 >= L)
          s[4 * j + 1] = s[4 * j + 3] = dp[4 * j + 1] = dp[4 * j + 3] = 0.f;
      }
    }
  };
  mbar_wait(&kvbar, 0);
  __syncwarp();

  // tile 0: S^T, dP^T and the elementwise step
  wait_full(0);
  bias_of(0);
  pin(s);
  wg_fence();
  qk(s, dkd, desc_sw128(stage_of(0)));
  abt(dp, dvd, desc_sw128(stage_of(0) + kTile));
  wg_commit();
  wg_wait<0>();
  pin(s);
  pin(dp);
  grads(0);
  split(s, ph, pl);
  split(dp, sh, sl);
  // tile t: its score products and elementwise step beside tile t - 1's
  // dV and dK products
  for (int t = 1; t < n_tiles; ++t) {
    wait_full(t);
    bias_of(t);
    pin(s);
    pin(dp);
    pin(dk);
    pin(dv);
    pin(ph);
    pin(pl);
    pin(sh);
    pin(sl);
    wg_fence();
    qk(s, dkd, desc_sw128(stage_of(t)));
    abt(dp, dvd, desc_sw128(stage_of(t) + kTile));
    wg_commit();
    pv(dv, ph, pl, desc_sw128(stage_of(t - 1) + kTile));
    pv(dk, sh, sl, desc_sw128(stage_of(t - 1)));
    wg_commit();
    wg_wait<1>();
    pin(s);
    pin(dp);
    grads(t);
    wg_wait<0>();
    pin(dk);
    pin(dv);
    pin(ph);
    pin(pl);
    pin(sh);
    pin(sl);
    mbar_arrive(&empty[(t - 1) % S]);
    split(s, ph, pl);
    split(dp, sh, sl);
  }
  pin(dk);
  pin(dv);
  pin(ph);
  pin(pl);
  pin(sh);
  pin(sl);
  wg_fence();
  pv(dv, ph, pl, desc_sw128(stage_of(n_tiles - 1) + kTile));
  pv(dk, sh, sl, desc_sw128(stage_of(n_tiles - 1)));
  wg_commit();
  wg_wait<0>();
  pin(dk);
  pin(dv);
  mbar_arrive(&empty[(n_tiles - 1) % S]);

  const size_t row0 = (((size_t)b * L + kr) * H + h) * kD;
  const size_t row1 = row0 + (size_t)8 * H * kD;
  store_rows_bf16(dk, kr < L ? p.dk + row0 : nullptr,
                  kr + 8 < L ? p.dk + row1 : nullptr, cq);
  store_rows_bf16(dv, kr < L ? p.dv + row0 : nullptr,
                  kr + 8 < L ? p.dv + row1 : nullptr, cq);
}

// ---- dQ and d(bias): one CTA per (b*h, 128 queries)

template <class P>
__global__ void __launch_bounds__(kThreads, 1)
flash_bias_dq_kernel(const __grid_constant__ CUtensorMap tq,
                     const __grid_constant__ CUtensorMap tk,
                     const __grid_constant__ CUtensorMap tv,
                     const __grid_constant__ CUtensorMap tdo,
                     const __grid_constant__ CUtensorMap tb,
                     const __grid_constant__ CUtensorMap tds,
                     const Params p) {
  using Lay = DqLayout<P>;
  using T = typename P::T;
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
  init_ring(full, empty, &qbar);

  if (warp >= kWG * 4) {
    // producer warpgroup; its first warp loads Q and dO once, then keeps
    // the ring
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;" ::"n"(kProducerRegs));
    if (warp != kWG * 4) return;
    const int bhb = (p.bias_batched ? b : 0) * H + h;
    if (lane == 0) {
      mbar_arrive_tx(&qbar, 2 * kWG * kTile);
#pragma unroll
      for (int w = 0; w < kWG; ++w) {
        tma_4d(smem + w * kTile, tq, &qbar, 0, h, q0 + w * kBM, b);
        tma_4d(smem + (kWG + w) * kTile, tdo, &qbar, 0, h, q0 + w * kBM, b);
      }
    }
    const uint32_t tx = 2 * kTile + (p.bias_tma ? Lay::kBiasBytes : 0);
    for (int t = 0; t < n_tiles; ++t) {
      const int s = t % S;
      const int k0 = t * kBN;
      uint8_t* stage = stage_of(t);
      mbar_wait(&empty[s], ((t / S) & 1) ^ 1);
      if (!p.bias_tma) {
        const T* src = static_cast<const T*>(p.bias) + (size_t)bhb * L * L;
        for (int e = lane; e < kRows * kBN; e += 32) {
          const int r = e / kBN, c = e % kBN;
          const int i = q0 + r, j = k0 + c;
          T val{};
          if (i < L && j < L) val = src[(size_t)i * L + j];
          *reinterpret_cast<T*>(stage + Lay::kBias + P::offset(r, c)) = val;
        }
      }
      if (lane == 0) {
        mbar_arrive_tx(&full[s], tx);
        tma_4d(stage, tk, &full[s], 0, h, k0, b);
        tma_4d(stage + kTile, tv, &full[s], 0, h, k0, b);
        if (p.bias_tma) {
#pragma unroll
          for (int c = 0; c < kBN; c += P::kBoxCols)
            tma_3d(stage + Lay::kBias +
                       (c / P::kBoxCols) * kRows * P::kBoxCols * (int)sizeof(T),
                   tb, &full[s], k0 + c, q0, bhb);
        }
      } else {
        mbar_arrive(&full[s]);
      }
    }
    return;
  }

  // consumer warpgroup wg: queries qw = q0 + 64 wg .. + 63. This thread
  // holds queries i0 = qw + r and i1 = i0 + 8, keys 8 j + cq and + 1 of each
  // 64-key tile (the wgmma accumulator layout); acc is dQ over the 64 head
  // dims.
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;" ::"n"(kConsumerRegs));
  const int wg = warp / 4;
  const int r = (warp % 4) * 16 + lane / 4;
  const int cq = 2 * (lane % 4);
  const int i0 = q0 + wg * kBM + r, i1 = i0 + 8;
  const bool leader = threadIdx.x % 128 == 0;
  const float lse0 = i0 < L ? p.lse[(size_t)bh * L + i0] : 0.f;
  const float lse1 = i1 < L ? p.lse[(size_t)bh * L + i1] : 0.f;
  const float di0 = i0 < L ? p.di[(size_t)bh * L + i0] : 0.f;
  const float di1 = i1 < L ? p.di[(size_t)bh * L + i1] : 0.f;
  // (row r of the warpgroup, key cq) of the stage's bias tile; the
  // warpgroup's 64 rows of each box start wg * 8 KB into it
  const int a0 = Lay::kBias + P::offset(wg * kBM + r, cq);
  const int a1 = Lay::kBias + P::offset(wg * kBM + r + 8, cq);
  const int own = Lay::kBias + wg * kBM * P::kBoxCols * (int)sizeof(T);
  const uint64_t dqd = desc_sw128(smem + wg * kTile);
  const uint64_t dod = desc_sw128(smem + (kWG + wg) * kTile);
  float acc[32], s[32], dp[32];
  uint32_t hi[16], lo[16];
#pragma unroll
  for (int e = 0; e < 32; ++e) acc[e] = s[e] = dp[e] = 0.f;
  auto wait_full = [&](int t) {
    mbar_wait(&full[t % S], (t / S) & 1);
    __syncwarp();
  };
  auto grads = [&](int t) {  // s: S -> P, dp: dP -> dS
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      s[4 * j] = ex(s[4 * j] - lse0);
      s[4 * j + 1] = ex(s[4 * j + 1] - lse0);
      s[4 * j + 2] = ex(s[4 * j + 2] - lse1);
      s[4 * j + 3] = ex(s[4 * j + 3] - lse1);
      dp[4 * j] = s[4 * j] * (dp[4 * j] - di0);
      dp[4 * j + 1] = s[4 * j + 1] * (dp[4 * j + 1] - di0);
      dp[4 * j + 2] = s[4 * j + 2] * (dp[4 * j + 2] - di1);
      dp[4 * j + 3] = s[4 * j + 3] * (dp[4 * j + 3] - di1);
    }
    if ((t + 1) * kBN > L) {
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const int c = t * kBN + 8 * j + cq;
        if (c >= L) dp[4 * j] = dp[4 * j + 2] = 0.f;
        if (c + 1 >= L) dp[4 * j + 1] = dp[4 * j + 3] = 0.f;
      }
    }
  };
  // dS of tile t over its bias in the stage, then out as d(bias)
  auto store_ds = [&](int t) {
    uint8_t* st = stage_of(t);
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      P::put_pair(st + P::at(a0, j), dp[4 * j], dp[4 * j + 1]);
      P::put_pair(st + P::at(a1, j), dp[4 * j + 2], dp[4 * j + 3]);
    }
    if (p.bias_tma) {
      proxy_fence();
      named_sync(1 + wg, 128);
      if (leader) {
#pragma unroll
        for (int c = 0; c < kBN; c += P::kBoxCols)
          tma_store_3d(tds,
                       st + own + (c / P::kBoxCols) * kRows * P::kBoxCols *
                                      (int)sizeof(T),
                       t * kBN + c, q0 + wg * kBM, bh);
        bulk_commit();
      }
    } else {
      named_sync(1 + wg, 128);
      T* dst = static_cast<T*>(p.dbias) + (size_t)bh * L * L;
      for (int e = threadIdx.x % 128; e < kBM * kBN; e += 128) {
        const int rr = e / kBN, c = e % kBN;
        const int i = q0 + wg * kBM + rr, j = t * kBN + c;
        if (i < L && j < L)
          dst[(size_t)i * L + j] = *reinterpret_cast<const T*>(
              st + Lay::kBias + P::offset(wg * kBM + rr, c));
      }
    }
  };
  auto release = [&](int t) {  // once the d(bias) store has read the stage
    if (leader && p.bias_tma) {
      if (t + 1 < n_tiles)
        bulk_wait_read<1>();
      else
        bulk_wait_read<0>();
    }
    mbar_arrive(&empty[t % S]);
  };
  mbar_wait(&qbar, 0);
  __syncwarp();

  // tile 0: S, dP, the elementwise step and d(bias)
  wait_full(0);
  load_bias<P>(s, stage_of(0), a0, a1, nullptr, false, 0.f, cq, 0, L);
  pin(s);
  wg_fence();
  qk(s, dqd, desc_sw128(stage_of(0)));
  abt(dp, dod, desc_sw128(stage_of(0) + kTile));
  wg_commit();
  wg_wait<0>();
  pin(s);
  pin(dp);
  grads(0);
  store_ds(0);
  split(dp, hi, lo);
  // tile t: its score products, elementwise step and d(bias) beside tile
  // t - 1's dQ product
  for (int t = 1; t < n_tiles; ++t) {
    wait_full(t);
    load_bias<P>(s, stage_of(t), a0, a1, nullptr, false, 0.f, cq, t * kBN,
                 L);
    pin(s);
    pin(dp);
    pin(acc);
    pin(hi);
    pin(lo);
    wg_fence();
    qk(s, dqd, desc_sw128(stage_of(t)));
    abt(dp, dod, desc_sw128(stage_of(t) + kTile));
    wg_commit();
    pv(acc, hi, lo, desc_sw128(stage_of(t - 1)));
    wg_commit();
    wg_wait<1>();
    pin(s);
    pin(dp);
    grads(t);
    store_ds(t);
    wg_wait<0>();
    pin(acc);
    pin(hi);
    pin(lo);
    release(t - 1);
    split(dp, hi, lo);
  }
  pin(acc);
  pin(hi);
  pin(lo);
  wg_fence();
  pv(acc, hi, lo, desc_sw128(stage_of(n_tiles - 1)));
  wg_commit();
  wg_wait<0>();
  pin(acc);
  release(n_tiles - 1);
  if (leader && p.bias_tma) bulk_wait_all();

  store_rows_bf16(acc,
                  i0 < L ? p.dq + (((size_t)b * L + i0) * H + h) * kD : nullptr,
                  i1 < L ? p.dq + (((size_t)b * L + i1) * H + h) * kD : nullptr,
                  cq);
}

// ---- host side

using Kernel = void (*)(const CUtensorMap, const CUtensorMap,
                        const CUtensorMap, const CUtensorMap,
                        const CUtensorMap, const CUtensorMap, const Params);

// Build the tensor maps (the bias, and for dq the d(bias), by TMA only where
// the row stride and bases allow it; bias boxes of `bias_rows` rows) and
// launch one CTA per (b*h, 128 rows).
template <class P>
int launch(Kernel kernel, int smem_bytes, int bias_rows, bool dbias,
           const void* q, const void* k, const void* v, const void* dout,
           Params p, int B, cudaStream_t stream) {
  if (B <= 0 || p.L <= 0 || p.H <= 0) return (int)cudaErrorInvalidValue;
  if (!encoder()) return (int)cudaErrorNotSupported;
  if (!aligned16(q) || !aligned16(k) || !aligned16(v) || !aligned16(dout))
    return (int)cudaErrorMisalignedAddress;
  CUtensorMap tq, tk, tv, tdo, tb, tds;
  std::memset(&tb, 0, sizeof(tb));
  std::memset(&tds, 0, sizeof(tds));
  if (!qkv_map(&tq, q, B, p.L, p.H) || !qkv_map(&tk, k, B, p.L, p.H) ||
      !qkv_map(&tv, v, B, p.L, p.H) || !qkv_map(&tdo, dout, B, p.L, p.H))
    return (int)cudaErrorInvalidValue;
  p.bias_tma = bias_tma_ok<P>(p.L, p.bias, dbias ? p.dbias : nullptr);
  if (p.bias_tma &&
      (!bias_map<P>(&tb, p.bias, (p.bias_batched ? B : 1) * p.H, p.L,
                    bias_rows) ||
       (dbias && !bias_map<P>(&tds, p.dbias, B * p.H, p.L, kBM))))
    return (int)cudaErrorInvalidValue;
  cudaError_t e = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem_bytes);
  if (e != cudaSuccess) return (int)e;
  const dim3 grid((p.L + kRows - 1) / kRows, B * p.H);
  kernel<<<grid, kThreads, smem_bytes, stream>>>(tq, tk, tv, tdo, tb, tds, p);
  return (int)cudaGetLastError();
}

template <class P>
int dkv(const void* q, const void* k, const void* v, const void* dout,
        const Params& p, int B, cudaStream_t s) {
  return launch<P>(flash_bias_dkv_kernel<P>, DkvLayout<P>::kAlloc, kBN, false,
                   q, k, v, dout, p, B, s);
}

template <class P>
int dq(const void* q, const void* k, const void* v, const void* dout,
       const Params& p, int B, cudaStream_t s) {
  return launch<P>(flash_bias_dq_kernel<P>, DqLayout<P>::kAlloc, kRows, true,
                   q, k, v, dout, p, B, s);
}

}  // namespace

extern "C" int mg_flash_bias_dkv(const void* q, const void* k, const void* v,
                                 const void* bias, int bias_f32,
                                 int bias_batched, const void* dout,
                                 const void* lse, const void* di, int B,
                                 int L, int H, int D, void* dk, void* dv,
                                 void* stream) {
  if (D != kD) return (int)cudaErrorInvalidValue;
  const Params p{bias, (const float*)lse, (const float*)di, nullptr,
                 (bf16*)dk, (bf16*)dv, nullptr, L, H, bias_batched, 0};
  cudaStream_t s = (cudaStream_t)stream;
  if (bias_f32) return dkv<BiasF32Rows<kBM>>(q, k, v, dout, p, B, s);
  return dkv<BiasBF16>(q, k, v, dout, p, B, s);
}

extern "C" int mg_flash_bias_dq(const void* q, const void* k, const void* v,
                                const void* bias, int bias_f32,
                                int bias_batched, const void* dout,
                                const void* lse, const void* di, int B, int L,
                                int H, int D, void* dq, void* dbias,
                                void* stream) {
  if (D != kD) return (int)cudaErrorInvalidValue;
  const Params p{bias, (const float*)lse, (const float*)di, (bf16*)dq,
                 nullptr, nullptr, dbias, L, H, bias_batched, 0};
  cudaStream_t s = (cudaStream_t)stream;
  if (bias_f32) return ::dq<BiasF32Rows<kRows>>(q, k, v, dout, p, B, s);
  return ::dq<BiasBF16>(q, k, v, dout, p, B, s);
}
