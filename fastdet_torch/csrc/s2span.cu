// One backbone stage of the ShuffleNetV2: the stride-2 block, then the
// stage's nblk stride-1 blocks (the span), by hand for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel fastdet/kernels/fused_infer.py
// (_s2span_call -> _s2span_kernel, prologue _s2_prologue, then
// _span_blocks).  Same function, on an NCHW f32 stage input
// (B, CIN, Hin, Win), CIN in {24, 48, 96}, to the stage output
// (B, 2*CIN, h, w), h = ceil(Hin/2), w = ceil(Win/2).  The stride-2 block
// (MID = CIN at every stage of this backbone):
//   out[:, :MID]  = ReLU(pwp(dw3x3s2(x)))                    (projection)
//   out[:, MID:]  = ReLU(pw2(dw3x3s2(ReLU(pw1(x)))))         (main)
// with BN folded into every conv (fastdet_torch/kernels/fold.py), both
// depthwise convs zero-padded, the main one on the post-ReLU branch.  The
// weights are one flat f32 row (fold.pack_s2span_weights):
//   [w1 (CIN x MID, row i = input channel) | b1 | wd (9 x MID, tap-major) |
//    bd | w2 (MID x MID) | b2 | wpd (9 x CIN) | bpd | wpp (CIN x MID) | bpp]
// followed by the span's nblk rows, as span.cu takes them.
//
// The TPU kernel reads its input phase-packed, (4*CIN, N) with the four
// spatial phases (y%2, x%2) on sublanes and lanes on the output grid,
// because Mosaic has no strided lane addressing.  On this card a stride-2
// tap is index arithmetic, so the input is read NCHW, as the previous
// stage (or either stem) wrote it: no phase split.  Nor are the TPU's
// composed matrices built (block-diagonal pw1 over four phases, dw3x3s2
// composed with pw2 and with pwp): they exist to give the MXU a deep K and
// are ~8x the real work here.
//
// What bounds it on this card: operations.  Per output pixel the stride-2
// block does 2*(4*CIN*MID + 9*MID + MID^2 + 9*CIN + CIN*MID) FLOP (pw1
// runs on the four input pixels of each output), and the span's blocks add
// their operations but no bytes; every stage is above the f32 ridge (20
// FLOP per byte).  The design (span_block.cuh): the stride-2 block is the
// prologue of the span's launch.  Each CTA of an image's cluster reads its
// band's input rows from device memory, in chunks of 5 input rows for pw1
// (2 output rows and the shared row, so pw1 is computed on 5/4 of the
// input), and writes the block's output straight into the band it holds
// on chip; then the span runs there, and the stage output is written once.
// Where the stage does not fit a cluster (at 640^2), the stride-2 block is
// one launch of the same kernel with no span blocks, and the span runs one
// launch per block (span.cu's per-block variant).

#include "span_block.cuh"

namespace {

template <int MID>
int launch_s2span(const float* x, float* out, float* tmp, const float* wts,
                  int b, int hin, int win, int nblk, int rows, int rows_s2,
                  int cluster, int per_block, cudaStream_t stream) {
  const int h = (hin + 1) / 2, w = (win + 1) / 2;
  if (rows < 1 || rows_s2 < 1 || cluster < 1 || cluster > 8)
    return (int)cudaErrorInvalidValue;
  if (!per_block)
    return launch_stage<MID, true>(x, out, wts, b, hin, win, h, w, rows,
                                   cluster, nblk,
                                   (cluster > 1 && nblk > 0) ? 1 : 0, stream);
  // the span's first block writes `out` when nblk is odd, `tmp` when even
  float* dst = (nblk % 2 == 1) ? tmp : out;
  const int rc = launch_stage<MID, true>(x, dst, wts, b, hin, win, h, w,
                                         rows_s2, 1, 0, 0, stream);
  if (rc || nblk == 0) return rc;
  constexpr int kS2Floats = 3 * MID * MID + 23 * MID;
  return launch_span<MID>(dst, out, tmp, wts + kS2Floats, b, h, w, nblk,
                          rows, 1, 1, stream);
}

}  // namespace

extern "C" {

// x (B, CIN, hin, win) f32 -> out (B, 2*CIN, ceil(hin/2), ceil(win/2)) f32
// through the stride-2 block and nblk span blocks; tmp is a scratch tensor
// of out's shape (used by the per-block variant when nblk > 0); wts is the
// flat row of fold.pack_s2span_weights, 3*CIN^2 + 23*CIN + nblk*(2*CIN^2 +
// 12*CIN) floats, 16-byte aligned, all on the card.  rows, rows_s2,
// cluster and per_block are the plan's.  Returns a cudaError_t (0 =
// launched).
int fastdet_s2span(const float* x, float* out, float* tmp, const float* wts,
                   int b, int cin, int hin, int win, int nblk, int rows,
                   int rows_s2, int cluster, int per_block, void* stream) {
  if (b < 1 || b > 65535 || hin < 1 || win < 1 || nblk < 0)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  switch (cin) {
    case 24: return launch_s2span<24>(x, out, tmp, wts, b, hin, win, nblk,
                                      rows, rows_s2, cluster, per_block, s);
    case 48: return launch_s2span<48>(x, out, tmp, wts, b, hin, win, nblk,
                                      rows, rows_s2, cluster, per_block, s);
    case 96: return launch_s2span<96>(x, out, tmp, wts, b, hin, win, nblk,
                                      rows, rows_s2, cluster, per_block, s);
    default: return (int)cudaErrorInvalidValue;
  }
}


// The bf16 stage (the JAX package's bf16 serving): x (B, CIN, hin, win)
// bf16 -> out (B, 2*CIN, ceil(hin/2), ceil(win/2)) bf16: the stride-2
// block, concat[bf16(ReLU(Wp . taps_s2(x) + bp)), bf16(ReLU(Wc .
// taps_s2(y) + bc))] with y = bf16(ReLU(pw1(x) + b1)) and both dw3x3 s2
// composed with their pointwise convs, then nblk span blocks as
// fastdet_span_bf16 runs them (span_block.cuh, the bf16 stage kernel).
// "stage": one launch, the stride-2 block the prologue of the span over
// chunks of `orows` output rows; "per block": the stride-2 block alone in
// bands of rows_s2 rows, then the span a launch a block.  w_s2 / b_s2: the
// stride-2 block's fold.pack_s2_16 weights and biases; w_span / b_span:
// the span's (may be null when nblk = 0); weights 16-byte aligned; tmp:
// scratch of out's shape.  Returns a cudaError_t (0 = launched).
int fastdet_s2span_bf16(const __nv_bfloat16* x, __nv_bfloat16* out,
                        __nv_bfloat16* tmp, const uint16_t* w_s2,
                        const float* b_s2, const uint16_t* w_span,
                        const float* b_span, int b, int cin, int hin,
                        int win, int nblk, int rows, int rows_s2, int orows,
                        int cluster, int per_block, void* stream) {
  if (b < 1 || b > 65535 || hin < 1 || win < 1 || nblk < 0)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  switch (cin) {
    case 24: return launch_s2span16<24>(x, out, tmp, w_s2, b_s2, w_span,
                                        b_span, b, hin, win, nblk, rows,
                                        rows_s2, orows, cluster, per_block, s);
    case 48: return launch_s2span16<48>(x, out, tmp, w_s2, b_s2, w_span,
                                        b_span, b, hin, win, nblk, rows,
                                        rows_s2, orows, cluster, per_block, s);
    case 96: return launch_s2span16<96>(x, out, tmp, w_s2, b_s2, w_span,
                                        b_span, b, hin, win, nblk, rows,
                                        rows_s2, orows, cluster, per_block, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // extern "C"
