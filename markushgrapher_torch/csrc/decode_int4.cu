// Q=1 decode attention over int4-nibble K/V, for every decode-step
// attention under the int4 KV scheme (cross over the packed encoder slab,
// self over the ring, the beam cross with the beams folded into the query
// rows, and the OCR LM's grouped ring), and the lattice's beam
// self-attention.
//
// Replaces markushgrapher_tpu/ops/mxu_decode.py:cross_decode_mxu_int4 in its
// separate-K/V mode with its head_map option, and
// markushgrapher_tpu/ops/mxu_decode.py:lattice_self_int4 (the same function
// with row_map, block_k = seg and the keys of the first n_live segments
// only: ops/mxu_decode.py launches this entry so). The function, the layout
// of the packed bytes and the design are decode_cluster.cuh's, under its
// Int4Pair policy: a cluster per (sample, run of D packed bytes), each byte
// read once for the query rows of both heads whose nibbles it holds.
//
// Bound: the bytes. At the MG cross (B=8, Kp=1792, 16 heads of 64) one call
// reads 15.6 MB of packed K/V and bf16 scales, 4.7 us at 3.35 TB/s. Turning
// nibbles into numbers is the work: on the CUDA cores a few operations a
// nibble and a query row, which bound the first version of this design
// (decode_bench.py's ablation); on the tensor cores one byte permute and one
// bf16 subtraction a pair of nibbles, whatever the rows.

#include "decode_cluster.cuh"

// The arguments of run<Int4Pair> (decode_cluster.cuh); ks / vs bf16.
extern "C" int mg_decode_int4(const void* q, const uint8_t* kq, const void* ks,
                              const uint8_t* vq, const void* vs,
                              const float* bias, const int* slots,
                              const int* row_map, int B, int R, int G, int D,
                              int K, int scale_rows, int bias_bstride,
                              int bias_rstride, int block_k, int live,
                              int n_slots, int rows, int splits, int chunk,
                              int aligned, int out_bf16, void* out,
                              void* stream) {
  return run<Int4Pair>(q, kq, ks, vq, vs, bias, slots, row_map, B, R, G, D, K,
                       scale_rows, bias_bstride, bias_rstride, block_k, live,
                       n_slots, rows, splits, chunk, aligned, out_bf16, out,
                       stream);
}

#ifdef DECODE_CLUSTER_TRACE
extern "C" int mg_decode_int4_trace(void* dst) { return read_trace(dst); }
#endif
