// The s2d(8) stem (kernel B10): conv3x3 stride 2 (3 -> 24, /255 and BN
// folded into the weight) + ReLU + maxpool 3x3 stride 2, by hand for
// Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel fastdet/kernels/fused_infer.py
// _stem8_call (_stem8_kernel/_stem8_body).  Same function: the input is
// the host's uint8 space-to-depth(8) layout (B, 192, npad), channel
// yoff*24 + xoff*3 + c, lane u*w8 + v for pixel (8u+yoff, 8v+xoff, c);
// lanes [h8*w8, npad) are padding and never read.
//
// Output layout.  The TPU kernel emits the pooled map phase-packed,
// (B, 4*24, npad) with phase (y%2)*2 + (x%2) on the coarse grid, because
// its stride-2 stage kernel reads that layout with lane rolls.  Here the
// output is the pooled map (B, 24, H/4, W/4) f32, NCHW, as the s2d(4)
// stem's: the stage kernel (s2span.cu) reads its input NCHW with stride-2
// addressing, so one input layout serves all three stages and both stems,
// and no phase split exists anywhere.
//
// The kernel is the shared stem core (stem_core.cuh); this file is its
// s2d(8) entry point.  The two factors differ only in how a CTA unpacks
// its pixels from the planes.

#include "stem_core.cuh"

extern "C" {

// x (B, 192, npad) u8 on the card -> out (B, 24, 2*h8, 2*w8) f32 on the
// card; w (27*24, HWIO) and bias (24) f32 on the HOST: they become the
// kernel's parameter block.  rows, strips, ctas: the tile and the
// persistent grid of `stem_plan`.  Returns a cudaError_t (0 = launched).
int fastdet_stem_s2d8(const uint8_t* x, float* out, const float* w_host,
                      const float* b_host, int b, int h8, int w8, int npad,
                      int rows, int strips, int ctas, void* stream) {
  return stem_launch<8>(x, out, w_host, b_host, b, h8, w8, npad, rows,
                        strips, ctas, stream);
}

// The bf16 form: x as above -> out (B, 24, 2*h8, 2*w8) bf16 on the
// card; w_bits (27*24 bf16 bit patterns, HWIO, /255 folded in, as the
// JAX package casts its phase matrix) and bias (24) f32 on the HOST.  The
// same tiles and grid.  Returns a cudaError_t (0 = launched).
int fastdet_stem_s2d8_bf16(const uint8_t* x, __nv_bfloat16* out,
                           const uint16_t* w_bits_host, const float* b_host,
                           int b, int h8, int w8, int npad, int rows,
                           int strips, int ctas, void* stream) {
  return stem_launch_bf16<8>(x, out, w_bits_host, b_host, b, h8, w8, npad,
                             rows, strips, ctas, stream);
}

// Shared memory (bytes) of one CTA at a tile of `rows` x 7*`strips` cells.
size_t fastdet_stem_smem(int rows, int strips) {
  return stem_smem_bytes(rows, strips, 8);
}

// CTAs an SM holds at that tile, from the occupancy calculator (-1 on an
// error).
int fastdet_stem_ctas_per_sm(int rows, int strips) {
  return stem_ctas_per_sm<8>(rows, strips);
}

const char* fastdet_cuda_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
