// The s2d(8) stem: conv3x3 stride 2 (3 -> 24, /255 and BN folded into the
// weight) + ReLU + maxpool 3x3 stride 2, by hand for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel fastdet/kernels/fused_infer.py
// (_stem8_call -> _stem8_kernel/_stem8_body).  Same function: the input is
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
// What bounds it on this card: operations, as for the s2d(4) stem.  At
// 352^2 one image is 176^2*24 conv outputs x 27 MACs = 40.1 MFLOP against
// 0.37 MB of uint8 in and 0.74 MB of f32 out, ~36 FLOP per byte, above the
// f32 ridge (20).  The design is the s2d(4) stem's (stem_s2d.cu):
//   * the direct 27-tap conv per output on CUDA cores in f32 FMA.  The TPU
//     kernel's (768, 384) 16-phase matrix is 96% zeros, there to give the
//     MXU a dense K; here it would be 28x the work;
//   * the 648 folded weights and 24 biases travel as a kernel parameter
//     (the constant bank);
//   * one CTA per (image, 4x4 coarse cells) = 8x8 pooled cells.  The CTA
//     stages its coarse cells and a one-cell halo above and to the left
//     (zero outside the image: the conv's zero pad) as a 40x40 pixel tile
//     in shared memory, convolves conv rows and columns [2*i0-1, 2*i0+16)
//     (the tile's 16 and the pool's one above and to the left) into
//     shared memory, and pools from there.  Only the halo cell's pixel
//     rows 5-7 and conv row 3 are read: the conv and the pool reach one
//     coarse cell up and left, never down or right;
//   * the pool's -inf pad reaches only the top and left edges.  A conv
//     output outside the image stores 0 instead: every pooled window also
//     holds a real ReLU output, which is >= 0, so a 0 never wins.
// The halo conv outputs cost 289/256 of the tile's own conv work.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kCells = 4;                   // coarse cells per CTA side
constexpr int kPool = 2 * kCells;           // pooled cells per CTA side
constexpr int kConv = 2 * kPool + 1;        // conv outputs per side, halo
constexpr int kPix = 8 * (kCells + 1);      // staged pixels per side
constexpr int kCout = 24;

struct StemParams {
  float w[27 * kCout];  // [(ky*3 + kx)*3 + c][co], /255 and BN folded in
  float b[kCout];
};

__global__ void __launch_bounds__(kThreads)
stem_s2d8_kernel(const uint8_t* __restrict__ x, float* __restrict__ out,
                 int h8, int w8, int npad, int ntx, const StemParams p) {
  __shared__ uint8_t s_px[3][kPix][kPix];
  __shared__ float s_conv[kCout][kConv][kConv];

  const int b = blockIdx.y;
  const int ty = blockIdx.x / ntx;
  const int u0 = ty * kCells, v0 = (blockIdx.x - ty * ntx) * kCells;
  const int h2 = 4 * h8, w2 = 4 * w8;       // conv grid
  const int h4 = 2 * h8, w4 = 2 * w8;       // pooled grid
  const int tid = threadIdx.x;
  const uint8_t* xb = x + (size_t)b * 192 * npad;
  float* ob = out + (size_t)b * kCout * h4 * w4;

  // 1. coarse cells [u0-1, u0+4) x [v0-1, v0+4), 192 planes, as pixels
  //    [8*u0-8, 8*u0+32) x [8*v0-8, 8*v0+32) of the three colour planes
  for (int it = tid; it < 192 * (kCells + 1) * (kCells + 1); it += kThreads) {
    const int ch = it / ((kCells + 1) * (kCells + 1));
    const int cell = it - ch * (kCells + 1) * (kCells + 1);
    const int cr = cell / (kCells + 1), cc = cell - cr * (kCells + 1);
    const int u = u0 - 1 + cr, v = v0 - 1 + cc;
    const int yoff = ch / 24, xoff = (ch / 3) % 8, c = ch % 3;
    s_px[c][cr * 8 + yoff][cc * 8 + xoff] =
        (u >= 0 && u < h8 && v >= 0 && v < w8)
            ? xb[(size_t)ch * npad + u * w8 + v] : (uint8_t)0;
  }
  __syncthreads();

  // 2. conv + ReLU of conv rows/cols [4*u0-1, 4*u0+16).  Conv output
  //    (R, C) reads image rows 2R-1 .. 2R+1: staged row 2*lr + 5 + ky for
  //    local row lr = R - (4*u0-1); columns likewise
  for (int it = tid; it < kConv * kConv; it += kThreads) {
    const int lr = it / kConv, lc = it - lr * kConv;
    const int R = 4 * u0 - 1 + lr, C = 4 * v0 - 1 + lc;
    float acc[kCout];
    if (R >= 0 && C >= 0 && R < h2 && C < w2) {
#pragma unroll
      for (int o = 0; o < kCout; ++o) acc[o] = p.b[o];
#pragma unroll
      for (int ky = 0; ky < 3; ++ky) {
#pragma unroll
        for (int kx = 0; kx < 3; ++kx) {
#pragma unroll
          for (int c = 0; c < 3; ++c) {
            const float val = (float)s_px[c][2 * lr + 5 + ky][2 * lc + 5 + kx];
#pragma unroll
            for (int o = 0; o < kCout; ++o)
              acc[o] = fmaf(val, p.w[((ky * 3 + kx) * 3 + c) * kCout + o],
                            acc[o]);
          }
        }
      }
#pragma unroll
      for (int o = 0; o < kCout; ++o) acc[o] = fmaxf(acc[o], 0.f);
    } else {
#pragma unroll
      for (int o = 0; o < kCout; ++o) acc[o] = 0.f;
    }
#pragma unroll
    for (int o = 0; o < kCout; ++o) s_conv[o][lr][lc] = acc[o];
  }
  __syncthreads();

  // 3. maxpool 3x3 s2: pooled (i, j) takes conv rows 2i-1 .. 2i+1, which
  //    are local rows 2*pi .. 2*pi+2
  for (int it = tid; it < kCout * kPool * kPool; it += kThreads) {
    const int o = it / (kPool * kPool);
    const int cell = it - o * (kPool * kPool);
    const int pi = cell / kPool, pj = cell - pi * kPool;
    const int i = 2 * u0 + pi, j = 2 * v0 + pj;
    if (i >= h4 || j >= w4) continue;
    float m = s_conv[o][2 * pi][2 * pj];
#pragma unroll
    for (int dy = 0; dy < 3; ++dy)
#pragma unroll
      for (int dx = 0; dx < 3; ++dx)
        m = fmaxf(m, s_conv[o][2 * pi + dy][2 * pj + dx]);
    ob[(size_t)o * h4 * w4 + i * w4 + j] = m;
  }
}

}  // namespace

extern "C" {

// x (B, 192, npad) u8 on the card -> out (B, 24, 2*h8, 2*w8) f32 on the
// card; w (27*24) and bias (24) f32 on the HOST: they become the kernel's
// parameter block.  Returns a cudaError_t (0 = launched).
int fastdet_stem_s2d8(const uint8_t* x, float* out, const float* w_host,
                      const float* b_host, int b, int h8, int w8, int npad,
                      void* stream) {
  if (b < 1 || b > 65535 || h8 < 1 || w8 < 1 || npad < h8 * w8)
    return (int)cudaErrorInvalidValue;
  StemParams p;
  for (int k = 0; k < 27 * kCout; ++k) p.w[k] = w_host[k];
  for (int k = 0; k < kCout; ++k) p.b[k] = b_host[k];
  const int ntx = (w8 + kCells - 1) / kCells;
  const int nty = (h8 + kCells - 1) / kCells;
  stem_s2d8_kernel<<<dim3(ntx * nty, b), kThreads, 0,
                     (cudaStream_t)stream>>>(x, out, h8, w8, npad, ntx, p);
  return (int)cudaGetLastError();
}

const char* fastdet_cuda_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
