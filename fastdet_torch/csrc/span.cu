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
// What bounds it on this card: at b128 352^2 a block does 2*(2*MID^2 +
// 9*MID) FLOP per pixel and moves 8*C bytes per pixel if it reads and
// writes the activation once: 57 / 111 / 219 FLOP per byte at MID 24 /
// 48 / 96, above the f32 ridge (20), so operations bound each block.  The
// TPU kernel composes dw3x3 and pw2 into one (MID, 9*MID) matrix to give
// the MXU a deep K; that is ~8x the real work, so here dw and pw2 run
// apart.  The design:
//   * one launch per block, one CTA per (image, spatial tile of TH x TW
//     pixels, fixed per width); the tile and a one-pixel halo live in shared
//     memory through the whole block: odd input channels -> pw1 + ReLU ->
//     dw -> pw2 + ReLU -> out.  Only the halo's pw1 is computed twice;
//   * halo pixels outside the image are set to 0 after pw1 + ReLU: the
//     dw's zero pad is on the post-ReLU branch, and ReLU(b1) is not 0
//     (the TPU kernel's `valid` masks do the same);
//   * the tile's sizes are compile-time constants: the first version's
//     runtime tile made every element pay integer divisions by a runtime
//     divisor, which cost more than its products;
//   * a thread issues 8 independent global loads before it stores them
//     into shared memory (6% faster than one at a time, chip run);
//   * the pointwise products run on CUDA cores in f32 FMA (no TF32: 13
//     blocks of 10-bit mantissas would not hold the forward's 2e-4); one
//     thread makes 8 output channels of one pixel, and a warp shares one
//     output group, so its 16-byte weight loads are uniform.
// The span reads and writes the activation once per block, nblk times in
// all: its floor is nblk times the one-pass byte bound.  Fusing the blocks
// so that the activation stays on chip across them is later work.
//
// The block kernel and its launcher live in span_block.cuh, which the
// stage kernel (s2span.cu) includes too.

#include "span_block.cuh"

extern "C" {

// x (B, C, h, w) f32 -> out (B, C, h, w) f32 through nblk blocks; tmp is a
// scratch tensor of the same shape (unused when nblk == 1); wts is
// (nblk, 2*MID^2 + 12*MID) f32, all on the card.  Returns a cudaError_t
// (0 = launched).
int fastdet_span(const float* x, float* out, float* tmp, const float* wts,
                 int b, int c, int h, int w, int nblk, void* stream) {
  if (b < 1 || b > 65535 || h < 1 || w < 1 || nblk < 1)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  switch (c) {
    case 48: return launch_span<24>(x, out, tmp, wts, b, h, w, nblk, s);
    case 96: return launch_span<48>(x, out, tmp, wts, b, h, w, nblk, s);
    case 192: return launch_span<96>(x, out, tmp, wts, b, h, w, nblk, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

const char* fastdet_cuda_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
