// The s2d(4) stem (kernel B1, and B6 at large sizes): conv3x3 stride 2
// (3 -> 24, /255 and BN folded into the weight) + ReLU + maxpool 3x3
// stride 2, by hand for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernels fastdet/kernels/fused_infer.py
// _stem_call (_stem_kernel/_stem_body) and _stem_call_chunked (its
// row-chunked form at 640^2).  Same function: the input is the host's
// uint8 space-to-depth(4) layout (B, 48, npad), channel yoff*12 + xoff*3
// + c, lane i*w4 + j for pixel (4i+yoff, 4j+xoff, c); lanes [h4*w4, npad)
// are padding and never read.  The output is the pooled map
// (B, 24, h4, w4) f32, NCHW.
//
// The kernel is the shared stem core (stem_core.cuh: tiles staged
// coalesced into f16 image planes, the conv on mma.sync f16 tensor cores
// with the weights in two terms, the pool in registers); this file is its
// s2d(4) entry point.  Any h4, w4 runs in one launch: the tiles' shared
// memory does not grow with the image.

#include "stem_core.cuh"

extern "C" {

// x (B, 48, npad) u8 on the card -> out (B, 24, h4, w4) f32 on the card;
// w (27*24, HWIO) and bias (24) f32 on the HOST: they become the kernel's
// parameter block.  rows, strips, ctas: the tile and the persistent
// grid of `stem_plan`.  Returns a cudaError_t (0 = launched).
int fastdet_stem_s2d(const uint8_t* x, float* out, const float* w_host,
                     const float* b_host, int b, int h4, int w4, int npad,
                     int rows, int strips, int ctas, void* stream) {
  return stem_launch<4>(x, out, w_host, b_host, b, h4, w4, npad, rows,
                        strips, ctas, stream);
}

// The bf16 form: x as above -> out (B, 24, h4, w4) bf16 on the
// card; w_bits (27*24 bf16 bit patterns, HWIO, /255 folded in, as the
// JAX package casts its phase matrix) and bias (24) f32 on the HOST.  The
// same tiles and grid.  Returns a cudaError_t (0 = launched).
int fastdet_stem_s2d_bf16(const uint8_t* x, __nv_bfloat16* out,
                          const uint16_t* w_bits_host, const float* b_host,
                          int b, int h4, int w4, int npad, int rows,
                          int strips, int ctas, void* stream) {
  return stem_launch_bf16<4>(x, out, w_bits_host, b_host, b, h4, w4, npad,
                             rows, strips, ctas, stream);
}

// Shared memory (bytes) of one CTA at a tile of `rows` x 7*`strips` cells.
size_t fastdet_stem_smem(int rows, int strips) {
  return stem_smem_bytes(rows, strips, 4);
}

// CTAs an SM holds at that tile, from the occupancy calculator (-1 on an
// error).
int fastdet_stem_ctas_per_sm(int rows, int strips) {
  return stem_ctas_per_sm<4>(rows, strips);
}

const char* fastdet_cuda_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
