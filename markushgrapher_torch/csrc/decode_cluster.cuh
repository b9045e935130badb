// Q=1 decode attention over quantised K/V as one clustered launch a call:
// the core of decode_int4.cu (packed int4 K/V, bf16 scales; also the entry
// of ops/mxu_decode.py:lattice_self_int4) and decode_i8.cu (int8 K/V, f32
// scales), templated on the element policy (Int4Pair, Int8).
//
// The function, for batch row b, query row r, kv column block g =
// head_map[r] (default grouped, r / (R / G)), key k read from physical row
// p = row_map[b, k / block_k] (or p = b):
//   s_k = (q_bf16 . k_k[g]) * ks[p, r or g, k] + bias[b?, r?, k]
//   p_k = exp(s_k - M_j);  l = sum_j c_j sum_{k in j} p_k
//   out = bf16( sum_j c_j sum_{k in j} bf16(p_k * vs[p, r or g, k]) * v_k[g]
//               / l )
// with M_j the running max after key block j (from -1e30, the TPU kernel's
// initial m) and c_j = exp(M_j - M_last): the TPU kernel's online softmax
// over blocks of block_k keys, its rounding points kept (q, p * vs and the
// output in bf16). The TPU kernel rescales acc and l by exp(M_{j-1} - M_j)
// at each later block; both are linear in the weights, so scaling each
// block once by c_j gives the same terms, rounded at the same points, up to
// float32 rounding of the scale. One block (no block_k) is the softmax
// against the global max. Keys at or past `live` are not read. No
// 1/sqrt(d) scaling (T5).
//
// Element policies: a run of D bytes of a key's row holds
//  - Int4Pair (pack_int4, column split: element e of the G*D row is the
//    low nibble of byte e if e < G*D/2, else the high nibble of byte
//    e - G*D/2): with G even head c in the low nibbles of bytes
//    [c*D, c*D+D) and head c + G/2 in their high ones; with G odd (the OCR
//    LM's 5 x 64) a head can straddle the split, its first `split` elements
//    low nibbles of bytes c*D.., the rest high nibbles of bytes from 0;
//  - Int8: head g, bytes [g*D, g*D+D), one value a byte.
// Both turn bytes into bf16 tensor-core operands exactly: a nibble n by a
// byte permute under 0x43 (bf16 128 + (n ^ 8)) minus 136; a byte x by a
// permute under the exponent byte of 2^23 (float 2^23 + (x ^ 0x80)), minus
// 2^23 + 128, packed to bf16 (|x| <= 128 is exact there).
//
// Bound: the bytes (decode_int4.cu, decode_i8.cu give the sizes).
//
// Design: one launch per call, a thread-block cluster per (b, slot). A slot
// is one run of D bytes and up to kMaxRows query rows that read it (the
// host's inverse of head_map, ops/mxu_decode.py:int4_slots): under Int4Pair
// with G even the rows of both heads (2 under greedy, 10 under the beam
// fold), with G odd one head's (3 under the OCR GQA); under Int8 one head's
// (1 under greedy and the self ring, 5 under the beam fold, 3 under OCR).
// Rows past kMaxRows take further slots. So a CTA reads each byte once for
// all the rows that need it. The keys [0, live) are split over the
// cluster's `splits` CTAs (at most 8, the portable size) in ranges of
// `chunk` keys, whole blocks of block_k when the call has a block size
// (`aligned`), so every block lies in one CTA; the host's plan
// (ops/mxu_decode.py:int4_plan) picks splits so each CTA's shared memory
// fits and the grid takes the fewest waves of resident CTAs (Int8 counts
// them by max_clusters below: clusters of 3 or more hold fewer CTAs than
// the SMs' shared memory allows). Each CTA:
//  1. loads q, and issues cp.async copies of the bias rows and the scales
//     (16 bytes at a time where aligned, else 4) and its keys' K bytes,
//     then of its V bytes (two commit groups: V lands while the scores and
//     the softmax run);
//  2. scores: at head dim 32 or 64 on the tensor cores (mma.sync
//     m16n8k16, bf16), a warp per tile of 16 keys, the bytes made bf16
//     exactly and the high-nibble head against its own q operand; else a
//     thread per key on the CUDA cores;
//  3. the max of each of its key blocks per query row, and its own max,
//     which it writes into every CTA's shared memory (distributed shared
//     memory; barrier 0, arrived at on entry, ensures they all started);
//  cluster barrier 1; from the cluster's maxima: M_last, and the running
//     max before its first block, from which the running max M_j of each
//     of its blocks follows (a warp scan), exactly the sequential values
//     (max is exact); p_k and bf16(p_k * vs) are the plain version's
//     values; its partial l goes to every CTA;
//  4. P V: on the tensor cores P (bf16; c_j * bf16(p vs) as a hi + lo pair
//     over several blocks) times V by ldmatrix.trans of the byte tile, a
//     warp per tile of 16 keys; else each thread owns 4 columns of a group
//     of keys; the partials summed over the warps or groups, each output's
//     partial goes to the CTA that finishes it (output i to CTA i % splits);
//  cluster barrier 2; each CTA sums its outputs' partials in rank order,
//     divides by l, rounds to bf16 and stores. Nothing crosses CTAs after
//     barrier 2, so a CTA may leave.
// Every CTA arrives at every barrier, whatever its range holds. No scratch
// in device memory, no second kernel. The tensor-core instances keep to 64
// registers (4 CTAs a SM) and stage unpadded rows with swizzled 16-byte
// units; q shares its bytes with the cluster's partials (read before
// barrier 1, written after it).
//
// Built with -DDECODE_CLUSTER_TRACE (decode_bench.py --trace), thread 0 of
// each of the first kTraceCtas CTAs stamps clock64 and %globaltimer on
// entry, once its copies and loads are issued, once the K bytes landed,
// after the scores, after cluster barrier 1, after the running maxima, once
// the V bytes landed (after p and l), after P V, after cluster barrier 2
// and at the end; the entry's mg_decode_*_trace reads them. Off, the hook
// compiles to nothing.

#pragma once

#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

namespace {

namespace cg = cooperative_groups;

constexpr float kNegInf = -1e30f;    // the TPU kernel's initial running max
constexpr int kT = 256;              // threads per CTA
constexpr int kWarps = kT / 32;
constexpr int kMaxRows = 10;         // query rows one CTA serves
constexpr int kMaxSplits = 8;        // CTAs per cluster (portable size)
constexpr int kSlotInts = 3 + kMaxRows;  // c, rows, low rows, row ids
constexpr size_t kSmemCap = 227 * 1024;

__device__ __forceinline__ uint32_t bf16x2(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

// The element policies. x is a word of 4 bytes of a staged run (elements
// 4t..4t+3 of a 16-byte unit, or bytes (2g, 2g + 1) of keys 2t and 2t + 1
// after ldmatrix.trans); `shift` picks the nibbles (0: low, 4: high) and is
// 0 under Int8; c is kPerm, held in a register for the byte permutes.
//  floats:  the 4 values of x, for the CUDA cores;
//  pairs:   the bf16 pairs of (bytes 0, 1) and (2, 3), the scores' operand;
//  pv_pairs: the bf16 pairs of (bytes 0, 2) and (1, 3), P V's operand.
struct Int4Pair {
  using Scale = __nv_bfloat16;
  static constexpr int kPerByte = 2;
  static constexpr bool kTwoHeads = true;  // with G even
  static constexpr uint32_t kPerm = 0x4343u;

  // the nibbles at `shift` of x ^ 0x88..: bytes n ^ 8 in [0, 15]
  __device__ static uint32_t nib(uint32_t x, int shift) {
    return ((x ^ 0x88888888u) >> shift) & 0x0F0F0F0Fu;
  }
  // two of those bytes (picked by SEL) as a bf16 pair 128 + (n ^ 8) - 136
  template <uint32_t SEL>
  __device__ static uint32_t pair(uint32_t u, uint32_t c) {
    uint32_t d;
    asm("prmt.b32 %0, %1, %2, %3;\n" : "=r"(d) : "r"(u), "r"(c), "n"(SEL));
    asm("sub.rn.bf16x2 %0, %0, %1;\n" : "+r"(d) : "r"(0x43084308u));
    return d;
  }
  // n ^ 8 in [0, 15] permuted under the exponent byte of 2^23, minus
  // 2^23 + 8
  __device__ static void floats(uint32_t x, int shift, float* v) {
    const uint32_t u = nib(x, shift);
#pragma unroll
    for (int j = 0; j < 4; ++j)
      v[j] = __uint_as_float(__byte_perm(u, 0x4B000000u, 0x7540 + j)) -
             8388616.f;
  }
  __device__ static void pairs(uint32_t x, int shift, uint32_t c,
                               uint32_t& p01, uint32_t& p23) {
    const uint32_t u = nib(x, shift);
    p01 = pair<0x5140>(u, c);
    p23 = pair<0x5342>(u, c);
  }
  __device__ static void pv_pairs(uint32_t x, int shift, uint32_t c,
                                  uint32_t& p02, uint32_t& p13) {
    const uint32_t u = nib(x, shift);
    p02 = pair<0x5240>(u, c);
    p13 = pair<0x5341>(u, c);
  }
};

struct Int8 {
  using Scale = float;
  static constexpr int kPerByte = 1;
  static constexpr bool kTwoHeads = false;
  static constexpr uint32_t kPerm = 0x4B000000u;

  // byte B of u = x ^ 0x80.. (x + 128 in [0, 255]) under the exponent byte
  // of 2^23, minus 2^23 + 128: x, exactly
  template <int B>
  __device__ static float value(uint32_t u, uint32_t c) {
    return __uint_as_float(__byte_perm(u, c, 0x7540 + B)) - 8388736.f;
  }
  __device__ static void floats(uint32_t x, int, float* v) {
    const uint32_t u = x ^ 0x80808080u;
    v[0] = value<0>(u, kPerm);
    v[1] = value<1>(u, kPerm);
    v[2] = value<2>(u, kPerm);
    v[3] = value<3>(u, kPerm);
  }
  __device__ static void pairs(uint32_t x, int, uint32_t c, uint32_t& p01,
                               uint32_t& p23) {
    const uint32_t u = x ^ 0x80808080u;
    p01 = bf16x2(value<0>(u, c), value<1>(u, c));
    p23 = bf16x2(value<2>(u, c), value<3>(u, c));
  }
  __device__ static void pv_pairs(uint32_t x, int, uint32_t c, uint32_t& p02,
                                  uint32_t& p13) {
    const uint32_t u = x ^ 0x80808080u;
    p02 = bf16x2(value<0>(u, c), value<2>(u, c));
    p13 = bf16x2(value<1>(u, c), value<3>(u, c));
  }
};

// scale rows a CTA stages: one per query row, or one per head its bytes
// hold (c and c + G/2 under Int4Pair with G even)
template <class P>
__host__ __device__ inline int scale_rows_of(bool per_row, int rows, int G) {
  return per_row ? rows : (P::kTwoHeads && G % 2 == 0 ? 2 : 1);
}

// the staged scale row of query row r (`hi`: the rows of head c + G/2)
__device__ __forceinline__ int scale_row(bool per_row, int r, unsigned hi,
                                         int srows) {
  return per_row ? r : (srows == 2 && ((hi >> r) & 1u) ? 1 : 0);
}

__host__ __device__ inline size_t up16(size_t x) {
  return (x + 15) & ~(size_t)15;
}

// the tensor-core instances: D 32 or 64, where every head's runs are whole
// 16-byte units
__host__ __device__ inline bool tensor_cores(int D) {
  return D == 32 || D == 64;
}

// bytes per staged key row: D on the tensor cores, whose 16-byte units are
// swizzled (unit_at); else an odd number of 16-byte units (or of words when
// D is no multiple of 16), so a warp's rows fall in different banks
__host__ __device__ inline int pitch_of(int D) {
  if (tensor_cores(D)) return D;
  if (D % 16 == 0) return (D / 16) % 2 ? D : D + 16;
  return (D / 4) % 2 ? D : D + 4;
}

// byte offset of 16-byte unit u of staged row `row` on the tensor cores
// (2 or 4 units a row): the units of rows 4 or 2 apart trade places, so the
// 8 rows a warp's fragment or ldmatrix reads fall in distinct banks
__device__ __forceinline__ int unit_at(int row, int u, int D) {
  return (u ^ (D == 64 ? (row >> 1) & 3 : (row >> 2) & 1)) << 4;
}

// dynamic shared memory of one CTA: `keys` staged keys (min(chunk, live)),
// `rows` query rows, `srows` scale rows (scale_rows_of) of `sbytes` bytes a
// key, local key blocks of `seg` keys; mirrored by
// ops/mxu_decode.py:int4_smem
struct Layout {
  size_t k, v, q, recv, s, bmax, bfac, cmx, lrecv, red, ks, vs, total;
  int pitch, kp, nbl;
};

__host__ __device__ inline Layout layout(int D, int rows, int srows, int keys,
                                         int seg, int sbytes) {
  Layout L;
  L.pitch = pitch_of(D);
  // K / V tiles of whole tiles of 16 keys; rows of scores and scales 4
  // longer, so that they fall 4 banks apart
  const int kt = (keys + 15) / 16 * 16;
  L.kp = kt + 4;
  L.nbl = (keys + seg - 1) / seg;
  const size_t tile = (size_t)kt * L.pitch;
  // P V partials, over K: a warp's [rows, D] (tensor cores, D 32 or 64) or
  // a group's (CUDA cores: 4 kT / D groups)
  const size_t part = tensor_cores(D) ? (size_t)4 * kWarps * rows * D
                                         : (size_t)16 * kT * rows;
  size_t o = 0;
  L.k = o;    o += up16(tile > part ? tile : part);
  L.v = o;    o += up16(tile);
  // q (read by the scores) and the cluster's partials of this CTA's outputs
  // (written by the CTAs after barrier 1, which follows the scores) share
  // their bytes
  const size_t qbytes = (size_t)4 * (rows > 8 ? 16 : 8) * (D + 8);
  const size_t rbytes = up16((size_t)4 * (rows * D + kMaxSplits));
  L.q = L.recv = o;
  o += qbytes > rbytes ? qbytes : rbytes;
  L.s = o;    o += (size_t)4 * rows * L.kp;
  L.bmax = o; o += up16((size_t)4 * rows * L.nbl);
  L.bfac = o; o += up16((size_t)4 * rows * L.nbl);
  L.cmx = o;  o += up16((size_t)4 * kMaxSplits * rows);
  L.lrecv = o; o += up16((size_t)4 * kMaxSplits * rows);
  L.red = o;  o += up16((size_t)4 * kWarps * rows);
  L.ks = o;   o += up16((size_t)sbytes * srows * L.kp);
  L.vs = o;   o += up16((size_t)sbytes * srows * L.kp);
  L.total = o;
  return L;
}

// n / d for 0 <= n < 2^31 by a multiply (Granlund-Montgomery), d >= 1;
// made on the host
struct FastDiv {
  unsigned m;
  int l;
  explicit FastDiv(int d) : l(0) {
    while ((1ull << l) < (unsigned long long)d) ++l;
    m = (unsigned)((((1ull << l) - (unsigned)d) << 32) / (unsigned)d + 1);
  }
  __device__ int operator()(int n) const {
    return (int)((__umulhi(m, (unsigned)n) + (unsigned)n) >> l);
  }
};

__device__ __forceinline__ void cp_async(void* dst, const void* src,
                                         int bytes) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(dst);
  if (bytes == 16)
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s),
                 "l"(src) : "memory");
  else
    asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(s),
                 "l"(src) : "memory");
}

__device__ __forceinline__ void cp_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

#ifdef DECODE_CLUSTER_TRACE
constexpr int kTraceCtas = 4096, kTracePoints = 10;
__device__ unsigned long long g_trace[2][kTraceCtas][kTracePoints];
__device__ __forceinline__ void trace_stamp(int point) {
  const unsigned cta =
      (blockIdx.z * gridDim.y + blockIdx.y) * gridDim.x + blockIdx.x;
  if (threadIdx.x == 0 && cta < kTraceCtas) {
    unsigned long long t;
    asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
    g_trace[0][cta][point] = clock64();
    g_trace[1][cta][point] = t;
  }
}
#define DECODE_TRACE(point) trace_stamp(point)
inline int read_trace(void* dst) {
  return (int)cudaMemcpyFromSymbol(dst, g_trace, sizeof(g_trace));
}
#else
#define DECODE_TRACE(point) ((void)(point))
#endif

__device__ __forceinline__ void mma16816(float* c, const uint32_t* a,
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0,%1,%2,%3}, "
      "{%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ void ldsm_x4_trans(uint32_t* m, const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(m[0]), "=r"(m[1]), "=r"(m[2]), "=r"(m[3])
      : "r"((unsigned)__cvta_generic_to_shared(p)));
}

// dot[r] += q_r . x over 4 elements at e: rows in `hi` (a bit a row) take
// the high-nibble values xh, the others xl
template <int NR>
__device__ __forceinline__ void dot4(const float* xl, const float* xh,
                                     unsigned hi, const float* sq, int D,
                                     int e, float* dot) {
#pragma unroll
  for (int r = 0; r < NR; ++r) {
    const bool h = (hi >> r) & 1u;
    const float4 qq = *reinterpret_cast<const float4*>(sq + r * D + e);
    dot[r] = fmaf(qq.x, h ? xh[0] : xl[0], dot[r]);
    dot[r] = fmaf(qq.y, h ? xh[1] : xl[1], dot[r]);
    dot[r] = fmaf(qq.z, h ? xh[2] : xl[2], dot[r]);
    dot[r] = fmaf(qq.w, h ? xh[3] : xl[3], dot[r]);
  }
}

// TC: the scores and P V on the tensor cores (D 32 or 64, where every
// head's runs are whole 16-byte blocks), at most 64 registers so that 4
// CTAs share an SM; else on the CUDA cores
template <class P, int NR, bool TC>
__global__ void __launch_bounds__(kT, TC ? 4 : 2)
decode_cluster_kernel(const __nv_bfloat16* __restrict__ q,
                      const uint8_t* __restrict__ kq,
                      const typename P::Scale* __restrict__ ks,
                      const uint8_t* __restrict__ vq,
                      const typename P::Scale* __restrict__ vs,
                      const float* __restrict__ bias,
                      const int* __restrict__ slots,
                      const int* __restrict__ row_map, int R, int G, int D,
                      int K, int scale_rows, int bias_bstride,
                      int bias_rstride, int block_k, int live, int chunk,
                      int aligned, int out_bf16, void* __restrict__ out,
                      FastDiv by_block, FastDiv by_seg, FastDiv by_splits) {
  using Scale = typename P::Scale;
  cg::cluster_group cluster = cg::this_cluster();
  const int rank = (int)cluster.block_rank();
  const int splits = (int)cluster.num_blocks();
  // barrier 0, waited on before the first write to another CTA's shared
  // memory: every CTA of the cluster has started
  asm volatile("barrier.cluster.arrive.relaxed.aligned;\n" ::: "memory");
  DECODE_TRACE(0);
  const int b = blockIdx.z;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int* sl = slots + (size_t)blockIdx.y * kSlotInts;
  // run of bytes c (Int4Pair: the head of the low nibbles), the slot's
  // rows: the first nlo read head c, the rest (Int4Pair, G even) the high
  // nibbles' head c + G/2; padded past nr with a real row
  const int c = sl[0], nr = sl[1], nlo = sl[2];
  const int* rid = sl + 3;
  const unsigned hi = ((1u << nr) - 1u) & ~((1u << nlo) - 1u);
  const bool per_row = scale_rows == R;
  const int srows = scale_rows_of<P>(per_row, NR, G);
  const int keys = min(chunk, live);
  const int seg = aligned ? block_k : keys;
  const Layout L = layout(D, NR, srows, keys, seg, (int)sizeof(Scale));

  extern __shared__ __align__(16) unsigned char smem[];
  uint8_t* sK = smem + L.k;
  uint8_t* sV = smem + L.v;
  float* sq = reinterpret_cast<float*>(smem + L.q);
  __nv_bfloat16* sqb = reinterpret_cast<__nv_bfloat16*>(smem + L.q);
  float* recv = reinterpret_cast<float*>(smem + L.recv);
  float* s = reinterpret_cast<float*>(smem + L.s);
  float* bmax = reinterpret_cast<float*>(smem + L.bmax);
  float* bfac = reinterpret_cast<float*>(smem + L.bfac);
  float* cmx = reinterpret_cast<float*>(smem + L.cmx);
  float* lrecv = reinterpret_cast<float*>(smem + L.lrecv);
  float* red = reinterpret_cast<float*>(smem + L.red);
  Scale* sks = reinterpret_cast<Scale*>(smem + L.ks);
  Scale* svs = reinterpret_cast<Scale*>(smem + L.vs);
  const int pitch = L.pitch, kp = L.kp, nbl = L.nbl;

  const int k0 = rank * chunk;
  const int n = max(0, min(live, k0 + chunk) - k0);  // this CTA's keys
  const int nkb = K / block_k;
  const int wrow = G * D / P::kPerByte;  // bytes a key's row
  const int e0 = c * D;
  const int split = min(max(wrow - e0, 0), D);  // D but for a straddling head
  const int lo0 = e0, hi0 = e0 + split - wrow;
  constexpr bool tc = TC;

  // 1. staging by cp.async (16-byte copies where every run is 16-byte
  // aligned, else 4-byte), in two commit groups: the bias rows (where the
  // scores will be), the scales and the K bytes, then V, which lands while
  // the scores and the softmax run (issued once K has landed, V gained
  // nothing: the copies' issue then held the scores up as long). On the
  // tensor cores q's loads go first, into registers.
  const bool vec = D % 16 == 0 && wrow % 16 == 0 &&
                   ((uintptr_t)kq | (uintptr_t)vq) % 16 == 0;
  const int cw = vec ? 16 : 4;
  const int lcpr = __ffs(D / cw) - 1;  // copies a key: 2^lcpr (D a power of 2)
  const int ld = __ffs(D) - 1;
  // the physical row of key k (block k / block_k of row b under a row map)
  auto phys = [&](int k) {
    return row_map != nullptr ? row_map[(size_t)b * nkb + by_block(k)] : b;
  };
  // q on the tensor cores: QR rows (one or two n tiles) x D <= 4 a thread
  constexpr int QR = NR > 8 ? 16 : 8;
  __nv_bfloat16 qv[4];
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const int i = tid + j * kT, r = i >> ld;
    qv[j] = tc && i < QR * D && r < nr
                ? q[((size_t)b * R + rid[r]) * D + i - r * D]
                : __float2bfloat16_rn(0.f);
  }
  // the bias rows in 16-byte copies of 4 keys where K, k0 and the rows'
  // starts allow (the copy past a range's end lies inside the row; a score
  // past n is never read), else 4-byte
  const bool bias16 = K % 4 == 0 && k0 % 4 == 0 && (uintptr_t)bias % 16 == 0;
  const int bpc = bias16 ? 4 : 1;
#pragma unroll 1
  for (int r = 0; r < NR; ++r) {
    const float* brow =
        bias + (size_t)b * bias_bstride + (size_t)rid[r] * bias_rstride + k0;
    for (int kl = bpc * tid; kl < n; kl += bpc * kT)
      cp_async(s + r * kp + kl, brow + kl, 4 * bpc);
  }
  // scale row i of the CTA is query row i's (per_row) or head c + i G/2's;
  // copied 16 bytes (`kpc` keys) at a time where K, k0, the blocks, the
  // tensors and the staged rows allow (the copy past a range's end lies
  // inside the row and the block), else 4 bytes (one f32 key, or a pair of
  // bf16 ones where those are even), else loaded below
  constexpr int k16 = 16 / (int)sizeof(Scale);
  const bool s16 = K % k16 == 0 && k0 % k16 == 0 &&
                   (row_map == nullptr || block_k % k16 == 0) &&
                   ((uintptr_t)ks | (uintptr_t)vs) % 16 == 0 &&
                   (srows == 1 || (kp * (int)sizeof(Scale)) % 16 == 0);
  const int kpc = s16 ? k16 : 4 / (int)sizeof(Scale);
  const bool pairs = s16 || kpc == 1 ||
                     (K % 2 == 0 && k0 % 2 == 0 &&
                      (row_map == nullptr || block_k % 2 == 0) &&
                      ((uintptr_t)ks | (uintptr_t)vs) % 4 == 0);
#pragma unroll 1
  for (int r = 0; pairs && r < srows; ++r) {
    const int srow = per_row ? rid[r] : c + r * (G / 2);
    for (int kl = kpc * tid; kl < n; kl += kpc * kT) {
      const int k = k0 + kl;
      const size_t o = ((size_t)phys(k) * scale_rows + srow) * K + k;
      cp_async(sks + r * kp + kl, ks + o, s16 ? 16 : 4);
      cp_async(svs + r * kp + kl, vs + o, s16 ? 16 : 4);
    }
  }
  // one commit group of a tensor's bytes for this CTA's keys
  auto stage = [&](const uint8_t* src, uint8_t* dst) {
    for (int i = tid; i < n << lcpr; i += kT) {
      const int kl = i >> lcpr, e = (i & ((1 << lcpr) - 1)) * cw;
      const int k = k0 + kl;
      const size_t row = ((size_t)phys(k) * K + k) * wrow;
      cp_async(dst + kl * pitch +
                   (tc ? unit_at(kl, e >> 4, D) + (e & 15) : e),
               src + row + (e < split ? lo0 + e : hi0 + e - split), cw);
    }
    cp_commit();
  };
  stage(kq, sK);
  stage(vq, sV);
  // q on the tensor cores: two bf16 [QR, D] operands, the rows of head c
  // and those of head c + G/2, zero elsewhere (rows of D + 8 elements, 4
  // banks apart); else float [NR, D], four loads a thread in flight
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const int i = tid + j * kT, r = i >> ld;
    if (tc && i < QR * D) {
      const bool h = (hi >> r) & 1u;
      const int at = i + 8 * r;
      sqb[at] = h ? __float2bfloat16_rn(0.f) : qv[j];
      if (P::kTwoHeads)
        sqb[QR * (D + 8) + at] = h ? qv[j] : __float2bfloat16_rn(0.f);
    }
  }
  for (int i0 = tid; !tc && i0 < NR * D; i0 += 4 * kT) {
    float v[4];
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int i = i0 + j * kT, r = i >> ld;
      v[j] = i < NR * D && r < nr
                 ? __bfloat162float(q[((size_t)b * R + rid[r]) * D + i -
                                      r * D])
                 : 0.f;
    }
#pragma unroll
    for (int j = 0; j < 4; ++j)
      if (i0 + j * kT < NR * D) sq[i0 + j * kT] = v[j];
  }
#pragma unroll 1
  for (int r = 0; !pairs && r < srows; ++r) {
    const int srow = per_row ? rid[r] : c + r * (G / 2);
    for (int kl0 = tid; kl0 < n; kl0 += 4 * kT) {
      Scale a[4], v[4];
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int k = k0 + kl0 + j * kT;
        if (kl0 + j * kT < n) {
          const size_t o = ((size_t)phys(k) * scale_rows + srow) * K + k;
          a[j] = ks[o];
          v[j] = vs[o];
        }
      }
#pragma unroll
      for (int j = 0; j < 4; ++j)
        if (kl0 + j * kT < n) {
          sks[r * kp + kl0 + j * kT] = a[j];
          svs[r * kp + kl0 + j * kT] = v[j];
        }
    }
  }
  DECODE_TRACE(1);

  // 2. scores, on the tensor cores: a warp per tile of 16 keys, K (keys x
  // D, as bf16) times q^T of the rows of each head; the word a thread
  // reads (bytes 4t..4t+3 of 16) holds elements 4t..4t+3, taken as
  // k = 2t, 2t+1, 2t+8, 2t+9 by both operands
  const bool want_hi = P::kTwoHeads && nlo < nr;  // some row reads head 2
  const int g8 = lane >> 2, t4 = lane & 3;
  uint32_t cperm = P::kPerm;
  asm volatile("" : "+r"(cperm));  // kept in a register for the permutes
  cp_wait<1>();
  __syncthreads();
  DECODE_TRACE(2);
  for (int kb = warp * 16; tc && kb < n; kb += kWarps * 16) {
    float acc[2][4] = {};
    // rows kb + g and kb + g + 8 share their swizzle
    const uint8_t* k0r = sK + (kb + g8) * pitch + 4 * t4;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      if (16 * j >= D) break;
      const int at = unit_at(kb + g8, j, D);
      const uint32_t x0 = *reinterpret_cast<const uint32_t*>(k0r + at);
      const uint32_t x8 =
          *reinterpret_cast<const uint32_t*>(k0r + 8 * pitch + at);
      const int sh = 16 * j < split ? 0 : 4;
#pragma unroll
      for (int head = 0; head < 2; ++head) {
        if (head == 0 ? nlo == 0 : !want_hi) continue;
        uint32_t a[4];
        P::pairs(x0, sh ^ (4 * head), cperm, a[0], a[2]);
        P::pairs(x8, sh ^ (4 * head), cperm, a[1], a[3]);
#pragma unroll
        for (int nt = 0; nt < (NR > 8 ? 2 : 1); ++nt) {
          const uint2 bq = *reinterpret_cast<const uint2*>(
              sqb + (head * QR + nt * 8 + g8) * (D + 8) + 16 * j + 4 * t4);
          mma16816(acc[nt], a, bq.x, bq.y);
        }
      }
    }
#pragma unroll
    for (int nt = 0; nt < (NR > 8 ? 2 : 1); ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int key = kb + g8 + (e >> 1) * 8, r = nt * 8 + 2 * t4 + (e & 1);
        if (r < NR && key < n) {
          const float kscale =
              to_f32(sks[scale_row(per_row, r, hi, srows) * kp + key]);
          s[r * kp + key] =
              __fadd_rn(__fmul_rn(acc[nt][e], kscale), s[r * kp + key]);
        }
      }
  }
  // scores on the CUDA cores: a thread per key, its bytes turned to floats
  // once for all the query rows (both nibbles where the slot reads both
  // heads)
  for (int kl = tid; !tc && kl < n; kl += kT) {
    const uint8_t* kr = sK + kl * pitch;
    float dot[NR];
#pragma unroll
    for (int r = 0; r < NR; ++r) dot[r] = 0.f;
    if (D % 16 == 0 && split % 16 == 0) {  // 16 bytes on one side
      for (int e = 0; e < D; e += 16) {
        const uint4 w4 = *reinterpret_cast<const uint4*>(kr + e);
        const uint32_t wv[4] = {w4.x, w4.y, w4.z, w4.w};
        const int sh = e < split ? 0 : 4;
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          float xl[4], xh[4];
          P::floats(wv[j], sh, xl);
          if (want_hi) P::floats(wv[j], sh ^ 4, xh);
          dot4<NR>(xl, xh, hi, sq, D, e + 4 * j, dot);
        }
      }
    } else {
      for (int e = 0; e < D; e += 4) {
        const uint32_t w = *reinterpret_cast<const uint32_t*>(kr + e);
        const int sh = e < split ? 0 : 4;
        float xl[4], xh[4];
        P::floats(w, sh, xl);
        if (want_hi) P::floats(w, sh ^ 4, xh);
        dot4<NR>(xl, xh, hi, sq, D, e, dot);
      }
    }
#pragma unroll
    for (int r = 0; r < NR; ++r) {
      const float kscale =
          to_f32(sks[scale_row(per_row, r, hi, srows) * kp + kl]);
      s[r * kp + kl] = __fadd_rn(__fmul_rn(dot[r], kscale), s[r * kp + kl]);
    }
  }
  __syncthreads();
  DECODE_TRACE(3);

  // 3. the max of each local key block (a warp per (row, block)), then this
  // CTA's max per row (a warp per row)
  const int nbh = by_seg(n + seg - 1);
#pragma unroll 1
  for (int r = 0; r < NR; ++r)
#pragma unroll 1
  for (int j = warp; j < nbh; j += kWarps) {
    const int end = min(n, (j + 1) * seg);
    float v = -INFINITY;
    for (int k = j * seg + lane; k < end; k += 32) v = fmaxf(v, s[r * kp + k]);
#pragma unroll
    for (int o = 16; o > 0; o >>= 1)
      v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
    if (lane == 0) bmax[r * nbl + j] = v;
  }
  __syncthreads();
  asm volatile("barrier.cluster.wait.aligned;\n" ::: "memory");
  for (int r = warp; r < NR; r += kWarps) {
    float v = -INFINITY;
    for (int j = lane; j < nbh; j += 32) v = fmaxf(v, bmax[r * nbl + j]);
#pragma unroll
    for (int o = 16; o > 0; o >>= 1)
      v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
    if (lane < splits)  // this CTA's max, into every CTA's cmx[rank]
      *cluster.map_shared_rank(cmx + rank * NR + r, lane) = v;
  }
  cluster.sync();  // barrier 1: every CTA holds every CTA's maxima
  DECODE_TRACE(4);

  // the running maxima: M_last over the cluster; M_j from the maxima of the
  // CTAs before this one and this CTA's blocks up to j (aligned ranges), or
  // the global max for the one-block form
  for (int r = warp; r < NR; r += kWarps) {
    const float m = lane < splits ? cmx[lane * NR + r] : -INFINITY;
    float all = m;
    float before = lane < rank ? m : -INFINITY;
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) {
      all = fmaxf(all, __shfl_xor_sync(0xffffffffu, all, o));
      before = fmaxf(before, __shfl_xor_sync(0xffffffffu, before, o));
    }
    all = fmaxf(kNegInf, all);
    float carry = fmaxf(kNegInf, before);
    if (!aligned) {
      if (lane == 0 && n > 0) {
        bmax[r * nbl] = all;
        bfac[r * nbl] = 1.f;  // exp(M_last - M_last)
      }
    } else {
      for (int j0 = 0; j0 < nbh; j0 += 32) {
        const int j = j0 + lane;
        float v = j < nbh ? bmax[r * nbl + j] : -INFINITY;
#pragma unroll
        for (int o = 1; o < 32; o <<= 1) {
          const float u = __shfl_up_sync(0xffffffffu, v, o);
          if (lane >= o) v = fmaxf(v, u);
        }
        const float mj = fmaxf(carry, v);
        if (j < nbh) {
          bmax[r * nbl + j] = mj;
          bfac[r * nbl + j] = expf(mj - all);
        }
        carry = __shfl_sync(0xffffffffu, mj, 31);
      }
    }
  }
  __syncthreads();
  DECODE_TRACE(5);

  // p_k = exp(s_k - M_j), l += c_j p_k, and the score becomes
  // c_j * bf16(p_k * vs_k)
  float lsum[NR];
#pragma unroll
  for (int r = 0; r < NR; ++r) lsum[r] = 0.f;
  for (int kl = tid; kl < n; kl += kT) {
    const int j = by_seg(kl);
#pragma unroll
    for (int r = 0; r < NR; ++r) {
      const float cj = bfac[r * nbl + j];
      const float p = expf(s[r * kp + kl] - bmax[r * nbl + j]);
      lsum[r] = fmaf(p, cj, lsum[r]);
      const float vscale =
          to_f32(svs[scale_row(per_row, r, hi, srows) * kp + kl]);
      s[r * kp + kl] = __fmul_rn(
          __bfloat162float(__float2bfloat16_rn(__fmul_rn(p, vscale))), cj);
    }
  }
#pragma unroll
  for (int r = 0; r < NR; ++r) {
    float v = lsum[r];
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
    if (lane == 0) red[warp * NR + r] = v;
  }
  cp_wait<0>();
  __syncthreads();
  DECODE_TRACE(6);
  if (tid < NR) {  // this CTA's l, into every CTA's lrecv[rank]
    float l = 0.f;
    for (int w = 0; w < kWarps; ++w) l += red[w * NR + tid];
    for (int j = 0; j < splits; ++j)
      *cluster.map_shared_rank(lrecv + rank * NR + tid, j) = l;
  }

  // 4. P V, on the tensor cores: a warp per tile of 16 keys, P (rows x
  // keys, bf16; c_j * bf16(p vs) as a bf16 pair hi + lo over several
  // blocks) times V (keys x D) of each row's head; V by ldmatrix.trans of
  // the byte tile read as b16 pairs, a thread's register holding elements
  // 2g (byte 0, 2) and 2g + 1 (byte 1, 3) of keys 2t and 2t + 1: the n
  // index of an output tile is g, over the even or the odd elements. The
  // warps' partials go over the dead K tile.
  float* part = reinterpret_cast<float*>(sK);
  if (tc) {
    const bool hg = (hi >> g8) & 1u, hg8 = (hi >> (g8 + 8)) & 1u;
#pragma unroll
    for (int cb = 0; cb < 2; ++cb) {  // 32 columns at a time
      if (32 * cb >= D) break;
      float acc[4][4] = {};
      for (int kb = warp * 16; kb < n; kb += kWarps * 16) {
        // a0 (row g, keys 2t, 2t + 1), a1 (row g + 8), a2 / a3 (keys
        // 2t + 8, 2t + 9): the bf16 pair of P and what it leaves, each
        // in the operand of the row's head
        uint32_t ph[2][4], pl[2][4];
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int r = g8 + 8 * (e & 1), key = kb + 2 * t4 + 8 * (e >> 1);
          float x0 = 0.f, x1 = 0.f;
          if (r < NR && key + 1 < n) {
            const float2 x = *reinterpret_cast<const float2*>(s + r * kp + key);
            x0 = x.x;
            x1 = x.y;
          } else if (r < NR && key < n) {
            x0 = s[r * kp + key];
          }
          const uint32_t whole = bf16x2(x0, x1);
          const __nv_bfloat162 wb =
              *reinterpret_cast<const __nv_bfloat162*>(&whole);
          const uint32_t rest =
              aligned ? bf16x2(x0 - __low2float(wb), x1 - __high2float(wb))
                      : 0u;
          const bool rh = e & 1 ? hg8 : hg;
          ph[0][e] = rh ? 0u : whole;
          ph[1][e] = rh ? whole : 0u;
          pl[0][e] = rh ? 0u : rest;
          pl[1][e] = rh ? rest : 0u;
        }
        uint32_t m[4];
        const int vrow = kb + (lane & 7) + 8 * ((lane >> 3) & 1);
        ldsm_x4_trans(m, sV + vrow * pitch +
                             unit_at(vrow, 2 * cb + (lane >> 4), D));
#pragma unroll
        for (int bb = 0; bb < 2; ++bb) {
          const int sh = 32 * cb + 16 * bb < split ? 0 : 4;
#pragma unroll
          for (int head = 0; head < 2; ++head) {
            if (head == 0 ? nlo == 0 : !want_hi) continue;
            // even elements: bytes 0 and 2; odd: bytes 1 and 3
            uint32_t e0, o0, e8, o8;
            P::pv_pairs(m[2 * bb], sh ^ (4 * head), cperm, e0, o0);
            P::pv_pairs(m[2 * bb + 1], sh ^ (4 * head), cperm, e8, o8);
            mma16816(acc[2 * bb], ph[head], e0, e8);
            mma16816(acc[2 * bb + 1], ph[head], o0, o8);
            if (aligned) {
              mma16816(acc[2 * bb], pl[head], e0, e8);
              mma16816(acc[2 * bb + 1], pl[head], o0, o8);
            }
          }
        }
      }
      // tile (bb, par), element e: row g (e < 2) or g + 8, column
      // 32 cb + 16 bb + 2 (2 t + (e & 1)) + par
#pragma unroll
      for (int nt = 0; nt < 4; ++nt)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int r = g8 + 8 * (e >> 1);
          const int d = 32 * cb + 16 * (nt >> 1) + 4 * t4 + 2 * (e & 1) +
                        (nt & 1);
          if (r < NR) part[(warp * NR + r) * D + d] = acc[nt][e];
        }
    }
  }

  // P V on the CUDA cores: thread (group gi, word w) owns columns
  // 4w..4w+3 over the keys gi, gi + groups, ...; the group partials go
  // over the dead K tile
  const int words = D / 4, groups = tc ? kWarps : kT / words;
  const int w = tid % words, gi = tid / words;
  const int sh = 4 * w < split ? 0 : 4;
  float acc[NR][4];
#pragma unroll
  for (int r = 0; r < NR; ++r)
    acc[r][0] = acc[r][1] = acc[r][2] = acc[r][3] = 0.f;
  for (int kl = gi; !tc && kl < n; kl += groups) {
    const uint32_t word =
        *reinterpret_cast<const uint32_t*>(sV + kl * pitch + 4 * w);
    float xl[4], xh[4];
    P::floats(word, sh, xl);
    if (want_hi) P::floats(word, sh ^ 4, xh);
#pragma unroll
    for (int r = 0; r < NR; ++r) {
      const bool h = (hi >> r) & 1u;
      const float t = s[r * kp + kl];
      acc[r][0] = fmaf(t, h ? xh[0] : xl[0], acc[r][0]);
      acc[r][1] = fmaf(t, h ? xh[1] : xl[1], acc[r][1]);
      acc[r][2] = fmaf(t, h ? xh[2] : xl[2], acc[r][2]);
      acc[r][3] = fmaf(t, h ? xh[3] : xl[3], acc[r][3]);
    }
  }
#pragma unroll
  for (int r = 0; !tc && r < NR; ++r)
    *reinterpret_cast<float4*>(part + (gi * NR + r) * D + 4 * w) =
        make_float4(acc[r][0], acc[r][1], acc[r][2], acc[r][3]);
  __syncthreads();
  DECODE_TRACE(7);
  // output element i of the slot (row i / D) is CTA (i % splits)'s to
  // finish: this CTA's partial goes into that CTA's recv[rank]
  const int per = by_splits(nr * D + splits - 1);
  for (int i = tid; i < nr * D; i += kT) {
    float o = 0.f;
    for (int gg = 0; gg < groups; ++gg) o += part[gg * NR * D + i];
    const int owner_at = by_splits(i);
    *cluster.map_shared_rank(recv + rank * per + owner_at,
                             i - owner_at * splits) = o;
  }
  // barrier 2: every CTA holds the partials of its outputs; no shared
  // memory is written or read across CTAs after it
  cluster.sync();
  DECODE_TRACE(8);

  // this CTA's outputs: the partials summed in rank order, divided by l
  for (int j = tid; j < per; j += kT) {
    const int i = j * splits + rank, r = i >> ld;
    if (i >= nr * D) break;
    float o = 0.f, l = 0.f;
    for (int k = 0; k < splits; ++k) {
      o += recv[k * per + j];
      l += lrecv[k * NR + r];
    }
    const __nv_bfloat16 ob = __float2bfloat16_rn(__fdiv_rn(o, fmaxf(l, 1e-30f)));
    const size_t at = ((size_t)b * R + rid[r]) * D + (i - r * D);
    if (out_bf16)
      reinterpret_cast<__nv_bfloat16*>(out)[at] = ob;
    else
      reinterpret_cast<float*>(out)[at] = __bfloat162float(ob);
  }
  DECODE_TRACE(9);
}

template <class P, int NR, bool TC>
cudaError_t launch(dim3 grid, size_t smem, cudaStream_t stream,
                   const __nv_bfloat16* q, const uint8_t* kq,
                   const typename P::Scale* ks, const uint8_t* vq,
                   const typename P::Scale* vs, const float* bias,
                   const int* slots, const int* row_map, int R, int G, int D,
                   int K, int scale_rows, int bias_bstride, int bias_rstride,
                   int block_k, int live, int chunk, int aligned,
                   int out_bf16, void* out) {
  const int keys = chunk < live ? chunk : live;
  const FastDiv by_block(block_k), by_seg(aligned ? block_k : keys),
      by_splits((int)grid.x);
  if (smem > 48 * 1024) {  // past the default, on the current device
    const cudaError_t e = cudaFuncSetAttribute(
        decode_cluster_kernel<P, NR, TC>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return e;
  }
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = grid.x;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = grid;
  cfg.blockDim = dim3(kT);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return cudaLaunchKernelEx(&cfg, decode_cluster_kernel<P, NR, TC>, q, kq, ks,
                            vq, vs, bias, slots, row_map, R, G, D, K,
                            scale_rows, bias_bstride, bias_rstride, block_k,
                            live, chunk, aligned, out_bf16, out, by_block,
                            by_seg, by_splits);
}

template <class P, int NR, bool TC>
int clusters_of(int splits, int smem) {
  if (smem > 48 * 1024 &&
      cudaFuncSetAttribute(decode_cluster_kernel<P, NR, TC>,
                           cudaFuncAttributeMaxDynamicSharedMemorySize,
                           smem) != cudaSuccess)
    return -1;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = splits;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(splits);
  cfg.blockDim = dim3(kT);
  cfg.dynamicSmemBytes = smem;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  int n = -1;
  return cudaOccupancyMaxActiveClusters(&n, decode_cluster_kernel<P, NR, TC>,
                                        &cfg) == cudaSuccess
             ? n
             : -1;
}

// The clusters of `splits` CTAs of `smem` bytes, `rows` query rows a CTA at
// head dim D, that the current device holds at once (-1 on error): fewer
// than its SMs' shared memory and registers suggest, since a cluster's CTAs
// share one GPC; the host's plan reads it (ops/mxu_decode.py:int4_plan).
template <class P>
int max_clusters(int rows, int D, int splits, int smem) {
  const bool tc = tensor_cores(D);
  switch (rows) {
#define MG_CLUSTERS_CASE(N) \
  case N:                   \
    return tc ? clusters_of<P, N, true>(splits, smem) \
              : clusters_of<P, N, false>(splits, smem);
    MG_CLUSTERS_CASE(1) MG_CLUSTERS_CASE(2) MG_CLUSTERS_CASE(3)
    MG_CLUSTERS_CASE(4) MG_CLUSTERS_CASE(5) MG_CLUSTERS_CASE(6)
    MG_CLUSTERS_CASE(7) MG_CLUSTERS_CASE(8) MG_CLUSTERS_CASE(9)
    MG_CLUSTERS_CASE(10)
#undef MG_CLUSTERS_CASE
    default:
      return -1;
  }
}

// One call of the core under policy P (the C entries' body). slots: int32
// [n_slots, 3 + 10] = (run of bytes c, query rows, rows of head c, row ids
// padded with a real row: head c's, then, under Int4Pair with G even, head
// c + G/2's); rows: the most query rows of a slot; splits / chunk /
// aligned: the host's plan (ops/mxu_decode.py:int4_plan), re-checked here.
template <class P>
int run(const void* q, const uint8_t* kq, const void* ks, const uint8_t* vq,
        const void* vs, const float* bias, const int* slots,
        const int* row_map, int B, int R, int G, int D, int K, int scale_rows,
        int bias_bstride, int bias_rstride, int block_k, int live,
        int n_slots, int rows, int splits, int chunk, int aligned,
        int out_bf16, void* out, void* stream) {
  // whole words a key's row; the ranges [i * chunk, min(live, (i + 1) *
  // chunk)) cover [0, live), none empty, whole blocks when aligned; one
  // block of `live` otherwise
  if (D % 4 != 0 || D > kT || kT % D != 0 ||
      (G * D) % (4 * P::kPerByte) != 0 || B <= 0 || R <= 0 || G <= 0 ||
      n_slots <= 0 || (scale_rows != R && scale_rows != G) || block_k <= 0 ||
      (aligned && K % block_k != 0) || live <= 0 || live > K || rows < 1 ||
      rows > kMaxRows || splits < 1 || splits > kMaxSplits || chunk < 1 ||
      (long)splits * chunk < live || (long)(splits - 1) * chunk >= live ||
      (aligned ? chunk % block_k != 0 : (block_k != live || row_map)))
    return (int)cudaErrorInvalidValue;
  using Scale = typename P::Scale;
  const int keys = chunk < live ? chunk : live;
  const size_t smem =
      layout(D, rows, scale_rows_of<P>(scale_rows == R, rows, G), keys,
             aligned ? block_k : keys, (int)sizeof(Scale))
          .total;
  if (smem > kSmemCap) return (int)cudaErrorInvalidValue;
  const dim3 grid(splits, n_slots, B);
  cudaStream_t st = (cudaStream_t)stream;
  const auto* qb = (const __nv_bfloat16*)q;
  const auto* kss = (const Scale*)ks;
  const auto* vss = (const Scale*)vs;
  // the tensor cores where every head's runs are whole 16-byte blocks
  const bool tc = tensor_cores(D);
  cudaError_t e;
  switch (rows) {
#define MG_DECODE_CASE(N)                                                    \
  case N:                                                                    \
    e = (tc ? launch<P, N, true> : launch<P, N, false>)(                     \
        grid, smem, st, qb, kq, kss, vq, vss, bias, slots, row_map, R, G, D, \
        K, scale_rows, bias_bstride, bias_rstride, block_k, live, chunk,     \
        aligned, out_bf16, out);                                             \
    break;
    MG_DECODE_CASE(1) MG_DECODE_CASE(2) MG_DECODE_CASE(3) MG_DECODE_CASE(4)
    MG_DECODE_CASE(5) MG_DECODE_CASE(6) MG_DECODE_CASE(7) MG_DECODE_CASE(8)
    MG_DECODE_CASE(9) MG_DECODE_CASE(10)
#undef MG_DECODE_CASE
    default:
      return (int)cudaErrorInvalidValue;
  }
  if (e != cudaSuccess) return (int)e;
  return (int)cudaGetLastError();
}

}  // namespace
