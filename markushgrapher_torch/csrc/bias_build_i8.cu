// int8 encoder relative-position bias slab for the VTL encoder.
//
// Replaces markushgrapher_tpu/ops/bias_build.py:encoder_position_bias_kernel_i8
// (the TPU one-hot MXU builder). Computes, for every (b, h, i, j),
//   out = tc_i8[h, b1 + nb * bh + nb^2 * bv],
//   tc_i8[h, c] = rint(((t1[b1] + th[bh]) + tv[bv]) / s_h),
//   s_h = max over all bucket triples |(t1 + th) + tv| * f32(1/127) + 1e-12,
// with b1 the T5 bucket of j - i (or of positions[b, j] - positions[b, i])
// and bh / bv the buckets of trunc((c_j - c_i) * scaling) over the bbox
// centres c = (x0 + x2) / 2, (y0 + y2) / 2. Bit-exact against the plain
// version relbias.encoder_position_bias_chunked_i8 run on the card (whose
// division of the table maximum by the scalar 127 is a multiplication by
// f32(1/127)). Buckets come from lookup tables built by the plain
// `relative_position_bucket` (distances clamped into +-max_distance, where
// buckets already saturate), so no logf runs here. Every float operation is
// an explicit round-to-nearest intrinsic, so no FMA contraction moves a
// value.
//
// Bound: the write of the int8 [B, H, L, L] slab (302 MB at B=8, H=16,
// L=1536); the reads (three [nb, H] tables, two LUTs, the boxes) are tiny.
// Design, two launches a call:
//  - bias_build_table_kernel, a CTA per (group of 4 heads, bucket bv):
//    each finds its heads' maxima |(t1 + th) + tv| over the whole combined
//    table (nb^3 sums a head), so the scales are the plain version's, then
//    quantises the table's nb^2 entries of its bv with the plain version's
//    division into a work buffer: a word holds tc_i8 of the 4 heads, in rows
//    of nb + 1 words so that the lanes' words spread over the banks once
//    they are in shared memory.
//  - bias_build_i8_kernel, a persistent grid of one CTA an SM (the host's
//    plan asks the card): a CTA serves one head group, copies that group's
//    table (132 KB at nb = 32) from the work buffer into shared memory, and
//    walks a contiguous range of items, the host's split of the B * L *
//    ceil(L / 16) items over the group's CTAs, an item being (query row i,
//    16 keys j) of one sample. Per sample, a CTA stages the centres (and
//    positions) of all L keys, padded so that lanes 16 keys apart read
//    different banks.
//  - Per item: the buckets of each key (the 2d LUT held once per bank, so
//    each lane reads its own copy) and its combined index, one 4-byte
//    shared-memory load for the 4 heads' bytes, a 4 x 4 byte transpose per
//    4 keys, and one 16-byte store per head row: adjacent threads take
//    adjacent items, so a warp writes 512 contiguous bytes of a row. Ragged
//    rows (L not a multiple of 16) store byte by byte.
// The buckets are computed once per (b, i, j) and head group; the value
// arithmetic once per table entry, not per element.

#include <cstdint>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 1024;       // bias_build_i8_kernel
constexpr int kTableThreads = 256;   // bias_build_table_kernel
constexpr int kKeys = 16;            // keys j of one item
constexpr int kPadKeys = 20;         // their words in shared memory
constexpr int kBanks = 32;           // copies of the 2d LUT, one a bank

// Words of one head group's quantised table: nb^2 rows of nb + 1 words,
// rounded up to whole 16-byte units (ops/bias_build.py table_words mirrors
// it; the host entry refuses a work buffer of another size).
__host__ __device__ inline int table_words(int nb) {
  return (nb * nb * (nb + 1) + 3) / 4 * 4;
}

// bias_build_i8_kernel's shared memory, in 4-byte words (mirrored by
// ops/bias_build.py smem_bytes; the host entry refuses a plan whose bytes
// differ).
struct Layout {
  int tab, lut1, lut2, hx, vy, pos, words;
};

__host__ __device__ inline Layout layout(int L, int nb, int max1, int max2,
                                         bool packed) {
  Layout s;
  const int n1 = 2 * max1 + 1, n2 = 2 * max2 + 1;
  const int keys = (L + kKeys - 1) / kKeys * kPadKeys;
  int n = 0;
  s.tab = n;   n += table_words(nb);
  s.lut1 = n;  n += n1 + (n1 >> 4) + 1;   // index e at e + e / 16
  s.lut2 = n;  n += kBanks * n2;          // index e of bank k at 32 e + k
  n = (n + 3) / 4 * 4;
  s.hx = n;
  s.vy = s.hx + keys;
  s.pos = s.vy + keys;
  s.words = s.pos + (packed ? keys : 0);
  return s;
}

// the word of key j in a padded row of centres or positions
__device__ __forceinline__ int padded(int j) { return j + (j >> 4) * 4; }

__device__ __forceinline__ float table(const void* t, int i, int dtype) {
  if (dtype == 1) return __bfloat162float(static_cast<const __nv_bfloat16*>(t)[i]);
  return static_cast<const float*>(t)[i];
}

__device__ __forceinline__ float4 add4(float4 a, float4 b) {
  return make_float4(__fadd_rn(a.x, b.x), __fadd_rn(a.y, b.y),
                     __fadd_rn(a.z, b.z), __fadd_rn(a.w, b.w));
}

__device__ __forceinline__ float4 absmax4(float4 m, float4 v) {
  return make_float4(fmaxf(m.x, fabsf(v.x)), fmaxf(m.y, fabsf(v.y)),
                     fmaxf(m.z, fabsf(v.z)), fmaxf(m.w, fabsf(v.w)));
}

__device__ __forceinline__ float4 shfl_max4(float4 m, int o) {
  return make_float4(fmaxf(m.x, __shfl_xor_sync(0xffffffffu, m.x, o)),
                     fmaxf(m.y, __shfl_xor_sync(0xffffffffu, m.y, o)),
                     fmaxf(m.z, __shfl_xor_sync(0xffffffffu, m.z, o)),
                     fmaxf(m.w, __shfl_xor_sync(0xffffffffu, m.w, o)));
}

// rint(v / s) of the 4 heads as the bytes of a word
__device__ __forceinline__ uint32_t quantise4(float4 v, float4 s) {
  const float q[4] = {__fdiv_rn(v.x, s.x), __fdiv_rn(v.y, s.y),
                      __fdiv_rn(v.z, s.z), __fdiv_rn(v.w, s.w)};
  uint32_t word = 0;
#pragma unroll
  for (int k = 0; k < 4; ++k)
    word |= ((uint32_t)__float2int_rn(q[k]) & 0xffu) << (8 * k);
  return word;
}

// Head group g = blockIdx.y, bucket bv = blockIdx.x: the group's words of
// bv into work (table_words(nb) words a group) and, from the CTAs of
// bv = 0, the group's scales. Shared memory: the group's [3][nb] table
// entries as float4 (t1, th, tv; zero in heads past H).
__global__ void __launch_bounds__(kTableThreads)
bias_build_table_kernel(const void* t1, const void* th, const void* tv,
                        int dtype, int H, int nb, uint32_t* work,
                        float* scales) {
  extern __shared__ float4 raw[];
  __shared__ float4 part[kTableThreads / 32];
  const int tid = threadIdx.x, bv = blockIdx.x, g = blockIdx.y;
  const void* tabs[3] = {t1, th, tv};
  float* rawf = reinterpret_cast<float*>(raw);
  for (int e = tid; e < 3 * nb * 4; e += kTableThreads) {
    const int t = e / (4 * nb), b = (e >> 2) % nb, h = 4 * g + (e & 3);
    rawf[e] = h < H ? table(tabs[t], b * H + h, dtype) : 0.f;
  }
  __syncthreads();
  // max |(t1[b1] + th[bh]) + tv[c]| over every (b1, bh, c), the plain
  // version's add order
  float4 m = make_float4(0.f, 0.f, 0.f, 0.f);
  for (int e = tid; e < nb * nb; e += kTableThreads) {
    const float4 a = add4(raw[e % nb], raw[nb + e / nb]);
    for (int c = 0; c < nb; ++c) m = absmax4(m, add4(a, raw[2 * nb + c]));
  }
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) m = shfl_max4(m, o);
  if ((tid & 31) == 0) part[tid >> 5] = m;
  __syncthreads();
#pragma unroll
  for (int w = 0; w < kTableThreads / 32; ++w)
    m = make_float4(fmaxf(m.x, part[w].x), fmaxf(m.y, part[w].y),
                    fmaxf(m.z, part[w].z), fmaxf(m.w, part[w].w));
  // the plain version's amax / 127 runs on the card as amax * f32(1/127),
  // then + f32(1e-12)
  const float inv = 1.0f / 127.0f, eps = (float)1e-12;
  const float4 s = make_float4(__fadd_rn(__fmul_rn(m.x, inv), eps),
                               __fadd_rn(__fmul_rn(m.y, inv), eps),
                               __fadd_rn(__fmul_rn(m.z, inv), eps),
                               __fadd_rn(__fmul_rn(m.w, inv), eps));
  uint32_t* tab = work + (size_t)g * table_words(nb);
  for (int e = tid; e < nb * nb; e += kTableThreads) {
    const int b1 = e % nb, bh = e / nb;
    const float4 v = add4(add4(raw[b1], raw[nb + bh]), raw[2 * nb + bv]);
    tab[b1 + (nb + 1) * (bh + nb * bv)] = quantise4(v, s);
  }
  if (bv == 0 && tid < 4 && 4 * g + tid < H)
    scales[4 * g + tid] = tid == 0 ? s.x : tid == 1 ? s.y : tid == 2 ? s.z : s.w;
}

struct Args {
  const float* bbox;
  const int *pos, *lut1, *lut2;
  const uint4* work;
  int B, H, L, nb, max1, max2;
  float scaling;
  long long per_cta;
  int8_t* out;
};

// lut2: this lane's copy of the 2d LUT, shifted to distance 0
__device__ __forceinline__ int bucket2(const int* lut2, float cj, float ci,
                                       float scaling, float lim) {
  // trunc((c_j - c_i) * scaling) clamped into +-max2: clamping to integer
  // bounds before the truncation gives the same integer
  const float d = __fmul_rn(__fsub_rn(cj, ci), scaling);
  return lut2[kBanks * __float2int_rz(fminf(fmaxf(d, -lim), lim))];
}

// 4 x 4 byte transpose: x[e] holds the 4 heads' bytes of key e; w[k] gets
// head k's bytes of keys 0..3
__device__ __forceinline__ void transpose4(const uint32_t (&x)[4],
                                           uint32_t& w0, uint32_t& w1,
                                           uint32_t& w2, uint32_t& w3) {
  const uint32_t lo01 = __byte_perm(x[0], x[1], 0x5140);
  const uint32_t lo23 = __byte_perm(x[2], x[3], 0x5140);
  const uint32_t hi01 = __byte_perm(x[0], x[1], 0x7362);
  const uint32_t hi23 = __byte_perm(x[2], x[3], 0x7362);
  w0 = __byte_perm(lo01, lo23, 0x5410);
  w1 = __byte_perm(lo01, lo23, 0x7632);
  w2 = __byte_perm(hi01, hi23, 0x5410);
  w3 = __byte_perm(hi01, hi23, 0x7632);
}

// One item: query row i of sample b against keys 16 ch .. 16 ch + 15, for
// the group's heads 4g..4g+3 (those below H).
template <bool kAligned>
__device__ __forceinline__ void item(const Args& p, const Layout& s,
                                     const float* sm, int g, int b, int i,
                                     int ch) {
  const int* smi = reinterpret_cast<const int*>(sm);
  const uint32_t* tab = reinterpret_cast<const uint32_t*>(sm + s.tab);
  const int j0 = ch * kKeys, wi = padded(i);
  const float hi = sm[s.hx + wi], vi = sm[s.vy + wi];
  const int pi = p.pos ? smi[s.pos + wi] : i;
  const float lim = (float)p.max2;
  const int* lut2 = smi + s.lut2 + kBanks * p.max2 + (threadIdx.x & 31);
  uint32_t w[4][4];  // w[k][q]: head 4g + k, keys 4q..4q+3
#pragma unroll
  for (int q = 0; q < 4; ++q) {
    const int at = ch * kPadKeys + 4 * q;
    const float4 h4 = *reinterpret_cast<const float4*>(sm + s.hx + at);
    const float4 v4 = *reinterpret_cast<const float4*>(sm + s.vy + at);
    const int4 p4 = p.pos ? *reinterpret_cast<const int4*>(smi + s.pos + at)
                          : make_int4(j0 + 4 * q, j0 + 4 * q + 1,
                                      j0 + 4 * q + 2, j0 + 4 * q + 3);
    const float hj[4] = {h4.x, h4.y, h4.z, h4.w};
    const float vj[4] = {v4.x, v4.y, v4.z, v4.w};
    const int pj[4] = {p4.x, p4.y, p4.z, p4.w};
    uint32_t x[4];
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int r1 = min(max(pj[e] - pi, -p.max1), p.max1) + p.max1;
      const int b1 = smi[s.lut1 + r1 + (r1 >> 4)];
      const int bh = bucket2(lut2, hj[e], hi, p.scaling, lim);
      const int bv = bucket2(lut2, vj[e], vi, p.scaling, lim);
      x[e] = tab[b1 + (p.nb + 1) * (bh + p.nb * bv)];
    }
    transpose4(x, w[0][q], w[1][q], w[2][q], w[3][q]);
  }
  const size_t plane = (size_t)p.L * p.L;
  int8_t* dst = p.out + (((size_t)b * p.H + 4 * g) * p.L + i) * p.L + j0;
  const int heads = min(4, p.H - 4 * g), n_keys = min(kKeys, p.L - j0);
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    if (k >= heads) break;
    if (kAligned) {
      *reinterpret_cast<uint4*>(dst + k * plane) =
          make_uint4(w[k][0], w[k][1], w[k][2], w[k][3]);
    } else {
#pragma unroll
      for (int jj = 0; jj < kKeys; ++jj)
        if (jj < n_keys)
          dst[k * plane + jj] = (int8_t)(w[k][jj / 4] >> (8 * (jj % 4)));
    }
  }
}

// CTA blockIdx.x serves head group blockIdx.x % groups and the items
// [r * per_cta, (r + 1) * per_cta) of range r = blockIdx.x / groups.
template <bool kAligned>
__global__ void __launch_bounds__(kThreads, 1) bias_build_i8_kernel(Args p) {
  extern __shared__ float4 smem4[];
  float* sm = reinterpret_cast<float*>(smem4);
  int* smi = reinterpret_cast<int*>(smem4);
  const Layout s = layout(p.L, p.nb, p.max1, p.max2, p.pos != nullptr);
  const int tid = threadIdx.x, groups = (p.H + 3) / 4;
  const int g = blockIdx.x % groups, range = blockIdx.x / groups;

  // prologue: the group's quantised table (the word of (b1, bh, bv) at
  // b1 + (nb + 1) * (bh + nb * bv)) and the LUTs
  const int units = table_words(p.nb) / 4;
  const uint4* src = p.work + (size_t)g * units;
  uint4* tab = reinterpret_cast<uint4*>(sm + s.tab);
  for (int e = tid; e < units; e += kThreads) tab[e] = src[e];
  for (int e = tid; e < 2 * p.max1 + 1; e += kThreads)
    smi[s.lut1 + e + (e >> 4)] = p.lut1[e];
  for (int e = tid; e < kBanks * (2 * p.max2 + 1); e += kThreads)
    smi[s.lut2 + e] = p.lut2[e / kBanks];

  const int n_chunks = (p.L + kKeys - 1) / kKeys;
  const long long per_sample = (long long)p.L * n_chunks;
  const long long total = per_sample * p.B;
  const long long start = (long long)range * p.per_cta;
  const long long end = min(total, start + p.per_cta);
  for (long long s0 = start / per_sample * per_sample; s0 < end;
       s0 += per_sample) {
    const int b = (int)(s0 / per_sample);
    __syncthreads();  // the prologue is done; the last sample is read
    for (int j = tid; j < n_chunks * kKeys; j += kThreads) {
      float cx = 0.f, cy = 0.f;
      int pj = 0;
      if (j < p.L) {
        const float* bb = p.bbox + ((size_t)b * p.L + j) * 4;
        cx = __fmul_rn(__fadd_rn(bb[0], bb[2]), 0.5f);
        cy = __fmul_rn(__fadd_rn(bb[1], bb[3]), 0.5f);
        if (p.pos) pj = p.pos[(size_t)b * p.L + j];
      }
      sm[s.hx + padded(j)] = cx;
      sm[s.vy + padded(j)] = cy;
      if (p.pos) smi[s.pos + padded(j)] = pj;
    }
    __syncthreads();
    const int lo = (int)(max(start, s0) - s0);
    const int hi = (int)(min(end, s0 + per_sample) - s0);
    // item k = i * n_chunks + ch, stepped by kThreads without a division
    const int di = kThreads / n_chunks, dch = kThreads % n_chunks;
    int i = (lo + tid) / n_chunks, ch = (lo + tid) % n_chunks;
    for (int k = lo + tid; k < hi; k += kThreads) {
      item<kAligned>(p, s, sm, g, b, i, ch);
      i += di;
      ch += dch;
      if (ch >= n_chunks) {
        ch -= n_chunks;
        ++i;
      }
    }
  }
}

template <bool kAligned>
int set_smem(int bytes) {
  // the attribute is per kernel; above 48 KB it must be raised first
  return (int)cudaFuncSetAttribute(bias_build_i8_kernel<kAligned>,
                                   cudaFuncAttributeMaxDynamicSharedMemorySize,
                                   bytes);
}

}  // namespace

// Shared-memory bytes of one bias_build_i8_kernel CTA (ops/bias_build.py
// smem_bytes mirrors it).
extern "C" int mg_bias_build_i8_smem(int L, int nb, int max1, int max2,
                                     int packed) {
  return 4 * layout(L, nb, max1, max2, packed != 0).words;
}

// CTAs of `smem` bytes the current card holds at once (the fewer of the two
// instances'), or a negative cudaError_t.
extern "C" int mg_bias_build_i8_resident(int smem) {
  int dev = 0, sms = 0, per_sm[2] = {0, 0};
  cudaError_t e = cudaGetDevice(&dev);
  if (e == cudaSuccess)
    e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (e == cudaSuccess) e = (cudaError_t)set_smem<true>(smem);
  if (e == cudaSuccess) e = (cudaError_t)set_smem<false>(smem);
  if (e == cudaSuccess)
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &per_sm[0], bias_build_i8_kernel<true>, kThreads, smem);
  if (e == cudaSuccess)
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &per_sm[1], bias_build_i8_kernel<false>, kThreads, smem);
  if (e != cudaSuccess) return -(int)e;
  return sms * min(per_sm[0], per_sm[1]);
}

// t1, th, tv: [nb, H] tables of `dtype` (0 float32, 1 bf16); bbox: float32
// [B, L, 4]; positions: int32 [B, L] or null; lut1 / lut2: int32
// [2 max + 1]; work: ceil(H / 4) * table_words(nb) words (work_words);
// out: int8 [B, H, L, L]; scales: float32 [H]. The host's plan: `ranges`
// CTAs a head group, each serving `per_cta` consecutive items of the
// B * L * ceil(L / 16); smem: bias_build_i8_kernel's bytes.
extern "C" int mg_bias_build_i8(const void* t1, const void* th, const void* tv,
                                int dtype, const float* bbox,
                                const int* positions, const int* lut1,
                                const int* lut2, int B, int H, int L, int nb,
                                int max1, int max2, float scaling, int ranges,
                                long long per_cta, int smem, void* work,
                                long long work_words, int8_t* out,
                                float* scales, void* stream) {
  const int groups = (H + 3) / 4;
  const long long total = (long long)B * L * ((L + kKeys - 1) / kKeys);
  if (B < 1 || H < 1 || L < 1 || nb < 1 || ranges < 1 || per_cta < 1 ||
      (long long)ranges * per_cta < total || dtype < 0 || dtype > 1 ||
      work_words != (long long)groups * table_words(nb) ||
      smem != mg_bias_build_i8_smem(L, nb, max1, max2, positions != nullptr))
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  bias_build_table_kernel<<<dim3(nb, groups), kTableThreads,
                            3 * nb * sizeof(float4), st>>>(
      t1, th, tv, dtype, H, nb, static_cast<uint32_t*>(work), scales);
  if (cudaError_t e = cudaGetLastError()) return (int)e;
  Args p{bbox, positions, lut1, lut2, static_cast<const uint4*>(work), B, H,
         L, nb, max1, max2, scaling, per_cta, out};
  if (L % kKeys == 0) {
    if (int e = set_smem<true>(smem)) return e;
    bias_build_i8_kernel<true><<<ranges * groups, kThreads, smem, st>>>(p);
  } else {
    if (int e = set_smem<false>(smem)) return e;
    bias_build_i8_kernel<false><<<ranges * groups, kThreads, smem, st>>>(p);
  }
  return (int)cudaGetLastError();
}
