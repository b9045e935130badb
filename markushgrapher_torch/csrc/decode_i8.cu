// Q=1 decode attention over int8 K/V, for every decode-step attention under
// the int8 KV scheme: self over the ring, cross over the encoder slab, the
// beam cross with all beams folded into the query rows, and the OCR LM's
// grouped ring.
//
// Replaces markushgrapher_tpu/ops/mxu_decode.py:cross_decode_mxu with its
// head_map, row_map and valid-prefix (block_map) options. K/V are int8
// [rows, K, G*D], scales f32 ([rows, R or G, K]). The function and the
// design are decode_cluster.cuh's, under its Int8 policy: a cluster per
// (sample, kv head g), the keys split over its CTAs, each CTA reading head
// g's D bytes of a key once for every query row that reads head g (5 under
// the beam fold, 3 under the OCR GQA, 1 under greedy and the self ring);
// the bytes become bf16 tensor-core operands exactly (float 2^23 + (x ^
// 0x80) by a byte permute, minus 2^23 + 128, packed to bf16).
//
// Bound: the bytes, 2 * B * live * G*D int8 plus the f32 scales: 31.2 MB a
// call at the MG cross (B=8, Kp=1792, 16 heads of 64), 9.3 us at 3.35 TB/s.
// The self ring's unwritten tail has zero values and zero scales; its score
// is the finite causal bias (float32's lowest), so p = 0 there and nothing
// is NaN.

#include "decode_cluster.cuh"

// The arguments of run<Int8> (decode_cluster.cuh); ks / vs float32.
extern "C" int mg_decode_i8(const void* q, const uint8_t* kq, const void* ks,
                            const uint8_t* vq, const void* vs,
                            const float* bias, const int* slots,
                            const int* row_map, int B, int R, int G, int D,
                            int K, int scale_rows, int bias_bstride,
                            int bias_rstride, int block_k, int live,
                            int n_slots, int rows, int splits, int chunk,
                            int aligned, int out_bf16, void* out,
                            void* stream) {
  return run<Int8>(q, kq, ks, vq, vs, bias, slots, row_map, B, R, G, D, K,
                   scale_rows, bias_bstride, bias_rstride, block_k, live,
                   n_slots, rows, splits, chunk, aligned, out_bf16, out,
                   stream);
}

// max_clusters<Int8> (decode_cluster.cuh): the resident clusters that the
// host's plan for decode_i8 counts its waves by.
extern "C" int mg_decode_i8_clusters(int rows, int D, int splits, int smem) {
  return max_clusters<Int8>(rows, D, splits, smem);
}

#ifdef DECODE_CLUSTER_TRACE
extern "C" int mg_decode_i8_trace(void* dst) { return read_trace(dst); }
#endif
