// The stride-1 span of the ShuffleNetV2 backbone: nblk stride-1 blocks at
// one width, by hand for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel fastdet/kernels/fused_infer.py
// (_span_call -> _span_kernel/_span_blocks).  Same function, on an NCHW
// f32 activation (B, C, h, w), C = 2*MID in {48, 96, 192}.  Each block:
//   out[:, :MID]  = x[:, 0::2]                                (passthrough)
//   out[:, MID:]  = ReLU(pw2(dw3x3(ReLU(pw1(x[:, 1::2]))))),
// with BN folded into every conv (fastdet_torch/kernels/fold.py) and the
// depthwise conv zero-padded.  Per block the weights are one f32 row
//   [w1 (MID_in x MID_out, row i = input channel) | b1 (MID) |
//    wd (9 x MID, tap dy*3+dx major) | bd (MID) | w2 (MID x MID) | b2 (MID)].
//
// What bounds it on this card: a block does 2*(2*MID^2 + 9*MID) FLOP per
// pixel; read and written once per span, the activation moves 8*C bytes
// per pixel: 21 / 92 / 75 FLOP per byte for the 3 / 7 / 3 blocks at MID
// 24 / 48 / 96, above the f32 ridge (20), so operations bound each span.
// The TPU kernel composes dw3x3 and pw2 into one (MID, 9*MID) matrix to
// give the MXU a deep K; that is ~8x the real work, so here dw and pw2 run
// apart.  The design (span_block.cuh): the whole span in one launch, each
// image's activation held in the shared memory of a thread-block cluster
// (a band of rows per CTA), the depthwise halo rows traded over
// distributed shared memory, the passthrough half never moved, register-
// tiled pointwise products in f32 FMA.  Where a cluster of 8 cannot hold
// an image (80^2 x 48 at 640^2), one launch per block, each CTA computing
// its halo rows' pw1 (the per-block variant of the same kernel).  The
// launch plan is fused_infer.span_stage_plan; its rows, cluster and
// variant arrive as arguments.

#include "span_block.cuh"

extern "C" {

// x (B, C, h, w) f32 -> out (B, C, h, w) f32 through nblk blocks; tmp is a
// scratch tensor of the same shape (used by the per-block variant when
// nblk > 1); wts is (nblk, 2*MID^2 + 12*MID) f32, 16-byte aligned, all on
// the card.  rows, cluster and per_block are the plan's.  Returns a
// cudaError_t (0 = launched).
int fastdet_span(const float* x, float* out, float* tmp, const float* wts,
                 int b, int c, int h, int w, int nblk, int rows, int cluster,
                 int per_block, void* stream) {
  if (b < 1 || b > 65535 || h < 1 || w < 1 || nblk < 1)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  switch (c) {
    case 48: return launch_span<24>(x, out, tmp, wts, b, h, w, nblk, rows,
                                    cluster, per_block, s);
    case 96: return launch_span<48>(x, out, tmp, wts, b, h, w, nblk, rows,
                                    cluster, per_block, s);
    case 192: return launch_span<96>(x, out, tmp, wts, b, h, w, nblk, rows,
                                     cluster, per_block, s);
    default: return (int)cudaErrorInvalidValue;
  }
}


// The bf16 span (the JAX package's bf16 serving): x (B, C, h, w) bf16 ->
// out bf16 through nblk blocks, each y = bf16(ReLU(pw1(x_odd) + b1)),
// z = bf16(ReLU(Wc . taps(y) + bc)) with dw3x3 and pw2 composed into one
// (MID, 9*MID) bf16 matrix, out = concat[x_even, z] (span_block.cuh, the
// bf16 stage kernel).  One launch ("stage": a cluster of `cluster` bands
// an image) or one a block ("per block", bands of `rows` rows that compute
// their halo rows' pw1), as fused_infer.span16_plan says; tmp is a scratch
// tensor of x's shape (per block, nblk > 1).  wts: (nblk,
// fold.span16_elems(MID)) bf16 (fold.pack_span16: pw1 over the block's
// slots, then Wc, in fold.mma_fragments order), 16-byte aligned; bias
// (nblk, 2*MID) f32; all on the card.  Returns a cudaError_t (0 =
// launched).
int fastdet_span_bf16(const __nv_bfloat16* x, __nv_bfloat16* out,
                      __nv_bfloat16* tmp, const uint16_t* wts,
                      const float* bias, int b, int c, int h, int w, int nblk,
                      int rows, int cluster, int per_block, void* stream) {
  if (b < 1 || b > 65535 || h < 1 || w < 1 || nblk < 1)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  switch (c) {
    case 48: return launch_span16<24>(x, out, tmp, wts, bias, b, h, w, nblk,
                                      rows, cluster, per_block, s);
    case 96: return launch_span16<48>(x, out, tmp, wts, bias, b, h, w, nblk,
                                      rows, cluster, per_block, s);
    case 192: return launch_span16<96>(x, out, tmp, wts, bias, b, h, w, nblk,
                                       rows, cluster, per_block, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // extern "C"
