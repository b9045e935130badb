// Backward of the float-bias flash attention (flash_bias.cu): dK / dV, and
// dQ with d(bias).
//
// Replaces _flash_attention_bwd_dkv and _flash_attention_bwd_dq of the stock
// Pallas TPU flash attention the reference trains with
// (jax/experimental/pallas/ops/tpu/flash_attention.py, called at
// markushgrapher_tpu/models/t5.py:376-385; scale 1). The split mirrors the
// stock one so that neither kernel needs atomics:
//   - dkv: one block per (b*h, 64-key tile), looping over the query tiles;
//   - dq:  one block per (b*h, 64-query tile), looping over the key tiles,
//          and writing dS as d(bias) in the bias dtype (float32 or bf16).
// Both recompute, per tile pair, s = q k^T + bias, P = exp(s - lse) (lse from
// the forward), dP = dO v^T and dS = P * (dP - di), di = sum(o * dO) over D
// from the wrapper. Then dV += P^T dO, dK += dS^T q (dkv) or dQ += dS k (dq).
//
// Bound: at B=8, H=16, L=1536, D=64 the two must read q, k, v, o, dO and
// the 604 MB bias and write dq, dk, dv and the 604 MB d(bias): ~1.4 GB,
// ~0.42 ms at 3.35 TB/s; the split reads the bias twice. Design: the tile
// products are bf16 WMMA with float32 accumulation (P and dS enter them as
// bf16 hi + lo pairs, two products each, for float32-level accuracy;
// d(bias) is written from the float32 dS); the accumulators of
// dK / dV / dQ stay in WMMA fragments across the whole loop (each warp owns
// 16 of the tile's rows); the elementwise step walks each warp's 16 rows in
// 32-wide runs, so bias reads and d(bias) writes are coalesced. Ragged tiles
// are zero-filled and masked; no length has to be a multiple of 64.

#include "flash_bias.cuh"

namespace fb {
namespace {

template <typename BT>
__global__ void __launch_bounds__(kThreads)
flash_bias_dkv_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                      const bf16* __restrict__ v, const BT* __restrict__ bias,
                      int bias_batched, const bf16* __restrict__ dout,
                      const float* __restrict__ lse,
                      const float* __restrict__ di, int L, int H,
                      bf16* __restrict__ dk, bf16* __restrict__ dv) {
  extern __shared__ __align__(128) unsigned char smem[];
  TileH* k_s = reinterpret_cast<TileH*>(smem);
  TileH* v_s = k_s + kT;
  TileH* q_s = v_s + kT;
  TileH* do_s = q_s + kT;
  TileH* p_s = do_s + kT;    // P and dS as bf16 hi + lo pairs
  TileH* p2_s = p_s + kT;
  TileH* ds_s = p2_s + kT;
  TileH* ds2_s = ds_s + kT;
  TileF* s_f = reinterpret_cast<TileF*>(ds2_s + kT);
  TileF* dp_f = s_f + kT;
  float* lse_s = reinterpret_cast<float*>(dp_f + kT);
  float* di_s = lse_s + kT;

  const int bh = blockIdx.y;
  const int b = bh / H;
  const int h = bh % H;
  const int k0 = blockIdx.x * kT;
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int r0 = warp * 16;
  const BT* bmat = bias + ((size_t)(bias_batched ? b : 0) * H + h) *
                              (size_t)L * L;

  load_rows(k_s, k, b, h, k0, L, H);
  load_rows(v_s, v, b, h, k0, L, H);
  FragC dk_acc[4], dv_acc[4], frag[4];
  zero(dk_acc);
  zero(dv_acc);

  for (int q0 = 0; q0 < L; q0 += kT) {
    __syncthreads();  // the previous step's products are done with the tiles
    load_rows(q_s, q, b, h, q0, L, H);
    load_rows(do_s, dout, b, h, q0, L, H);
    if (threadIdx.x < kT) {
      const int i = q0 + threadIdx.x;
      lse_s[threadIdx.x] = i < L ? lse[(size_t)bh * L + i] : 0.f;
      di_s[threadIdx.x] = i < L ? di[(size_t)bh * L + i] : 0.f;
    }
    __syncthreads();
    zero(frag);
    mma_abt(frag, q_s, r0, k_s);
    store(s_f, r0, frag);
    zero(frag);
    mma_abt(frag, do_s, r0, v_s);
    store(dp_f, r0, frag);
    __syncwarp();
#pragma unroll 4
    for (int t = 0; t < 32; ++t) {
      const int row = r0 + t / 2;
      const int col = (t % 2) * 32 + lane;
      const int i = q0 + row;
      const int j = k0 + col;
      float p = 0.f, ds = 0.f;
      if (i < L && j < L) {
        p = expf(s_f[row][col] + to_f(bmat[(size_t)i * L + j]) - lse_s[row]);
        ds = p * (dp_f[row][col] - di_s[row]);
      }
      split_bf16(p, &p_s[row][col], &p2_s[row][col]);
      split_bf16(ds, &ds_s[row][col], &ds2_s[row][col]);
    }
    __syncthreads();  // every warp reads all 64 query rows of P and dS
    mma_atb(dv_acc, p_s, r0, do_s);
    mma_atb(dv_acc, p2_s, r0, do_s);
    mma_atb(dk_acc, ds_s, r0, q_s);
    mma_atb(dk_acc, ds2_s, r0, q_s);
  }
  __syncthreads();
  store(s_f, r0, dk_acc);
  store(dp_f, r0, dv_acc);
  __syncthreads();
  store_rows(dk, s_f, b, h, k0, L, H);
  store_rows(dv, dp_f, b, h, k0, L, H);
}

template <typename BT>
__global__ void __launch_bounds__(kThreads)
flash_bias_dq_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                     const bf16* __restrict__ v, const BT* __restrict__ bias,
                     int bias_batched, const bf16* __restrict__ dout,
                     const float* __restrict__ lse,
                     const float* __restrict__ di, int L, int H,
                     bf16* __restrict__ dq, BT* __restrict__ dbias) {
  extern __shared__ __align__(128) unsigned char smem[];
  TileH* q_s = reinterpret_cast<TileH*>(smem);
  TileH* do_s = q_s + kT;
  TileH* k_s = do_s + kT;
  TileH* v_s = k_s + kT;
  TileH* ds_s = v_s + kT;    // dS as a bf16 hi + lo pair
  TileH* ds2_s = ds_s + kT;
  TileF* s_f = reinterpret_cast<TileF*>(ds2_s + kT);
  TileF* dp_f = s_f + kT;
  float* lse_s = reinterpret_cast<float*>(dp_f + kT);
  float* di_s = lse_s + kT;

  const int bh = blockIdx.y;
  const int b = bh / H;
  const int h = bh % H;
  const int q0 = blockIdx.x * kT;
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int r0 = warp * 16;
  const BT* bmat = bias + ((size_t)(bias_batched ? b : 0) * H + h) *
                              (size_t)L * L;
  BT* dmat = dbias + (size_t)bh * L * L;

  load_rows(q_s, q, b, h, q0, L, H);
  load_rows(do_s, dout, b, h, q0, L, H);
  if (threadIdx.x < kT) {
    const int i = q0 + threadIdx.x;
    lse_s[threadIdx.x] = i < L ? lse[(size_t)bh * L + i] : 0.f;
    di_s[threadIdx.x] = i < L ? di[(size_t)bh * L + i] : 0.f;
  }
  FragC dq_acc[4], frag[4];
  zero(dq_acc);

  for (int k0 = 0; k0 < L; k0 += kT) {
    __syncthreads();  // Q / dO loaded; the previous K tile is done with
    load_rows(k_s, k, b, h, k0, L, H);
    load_rows(v_s, v, b, h, k0, L, H);
    __syncthreads();
    zero(frag);
    mma_abt(frag, q_s, r0, k_s);
    store(s_f, r0, frag);
    zero(frag);
    mma_abt(frag, do_s, r0, v_s);
    store(dp_f, r0, frag);
    __syncwarp();
#pragma unroll 4
    for (int t = 0; t < 32; ++t) {
      const int row = r0 + t / 2;
      const int col = (t % 2) * 32 + lane;
      const int i = q0 + row;
      const int j = k0 + col;
      float ds = 0.f;
      if (i < L && j < L) {
        const size_t ij = (size_t)i * L + j;
        const float p = expf(s_f[row][col] + to_f(bmat[ij]) - lse_s[row]);
        ds = p * (dp_f[row][col] - di_s[row]);
        put(dmat + ij, ds);
      }
      split_bf16(ds, &ds_s[row][col], &ds2_s[row][col]);
    }
    __syncwarp();  // dQ rows 16w.. need only this warp's rows of dS
    mma_ab(dq_acc, ds_s, r0, k_s);
    mma_ab(dq_acc, ds2_s, r0, k_s);
  }
  __syncthreads();
  store(s_f, r0, dq_acc);
  __syncthreads();
  store_rows(dq, s_f, b, h, q0, L, H);
}

constexpr int kSmemDkv =
    8 * kTileH * (int)sizeof(bf16) + 2 * kTileF * (int)sizeof(float) +
    2 * kT * (int)sizeof(float);
constexpr int kSmemDq =
    6 * kTileH * (int)sizeof(bf16) + 2 * kTileF * (int)sizeof(float) +
    2 * kT * (int)sizeof(float);

template <typename BT>
int launch_dkv(const void* q, const void* k, const void* v, const void* bias,
               int bias_batched, const void* dout, const void* lse,
               const void* di, int B, int L, int H, void* dk, void* dv,
               cudaStream_t s) {
  cudaError_t e = cudaFuncSetAttribute(
      flash_bias_dkv_kernel<BT>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      kSmemDkv);
  if (e != cudaSuccess) return (int)e;
  dim3 grid((L + kT - 1) / kT, B * H);
  flash_bias_dkv_kernel<BT><<<grid, kThreads, kSmemDkv, s>>>(
      (const bf16*)q, (const bf16*)k, (const bf16*)v, (const BT*)bias,
      bias_batched, (const bf16*)dout, (const float*)lse, (const float*)di, L,
      H, (bf16*)dk, (bf16*)dv);
  return (int)cudaGetLastError();
}

template <typename BT>
int launch_dq(const void* q, const void* k, const void* v, const void* bias,
              int bias_batched, const void* dout, const void* lse,
              const void* di, int B, int L, int H, void* dq, void* dbias,
              cudaStream_t s) {
  cudaError_t e = cudaFuncSetAttribute(
      flash_bias_dq_kernel<BT>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      kSmemDq);
  if (e != cudaSuccess) return (int)e;
  dim3 grid((L + kT - 1) / kT, B * H);
  flash_bias_dq_kernel<BT><<<grid, kThreads, kSmemDq, s>>>(
      (const bf16*)q, (const bf16*)k, (const bf16*)v, (const BT*)bias,
      bias_batched, (const bf16*)dout, (const float*)lse, (const float*)di, L,
      H, (bf16*)dq, (BT*)dbias);
  return (int)cudaGetLastError();
}

}  // namespace
}  // namespace fb

extern "C" int mg_flash_bias_dkv(const void* q, const void* k, const void* v,
                                 const void* bias, int bias_f32,
                                 int bias_batched, const void* dout,
                                 const void* lse, const void* di, int B,
                                 int L, int H, int D, void* dk, void* dv,
                                 void* stream) {
  if (D != fb::kD || B <= 0 || L <= 0 || H <= 0)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  if (bias_f32)
    return fb::launch_dkv<float>(q, k, v, bias, bias_batched, dout, lse, di,
                                 B, L, H, dk, dv, s);
  return fb::launch_dkv<fb::bf16>(q, k, v, bias, bias_batched, dout, lse, di,
                                  B, L, H, dk, dv, s);
}

extern "C" int mg_flash_bias_dq(const void* q, const void* k, const void* v,
                                const void* bias, int bias_f32,
                                int bias_batched, const void* dout,
                                const void* lse, const void* di, int B, int L,
                                int H, int D, void* dq, void* dbias,
                                void* stream) {
  if (D != fb::kD || B <= 0 || L <= 0 || H <= 0)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  if (bias_f32)
    return fb::launch_dq<float>(q, k, v, bias, bias_batched, dout, lse, di, B,
                                L, H, dq, dbias, s);
  return fb::launch_dq<fb::bf16>(q, k, v, bias, bias_batched, dout, lse, di,
                                 B, L, H, dq, dbias, s);
}
