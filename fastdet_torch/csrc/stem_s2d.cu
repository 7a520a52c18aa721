// The s2d(4) stem: conv3x3 stride 2 (3 -> 24, /255 and BN folded into the
// weight) + ReLU + maxpool 3x3 stride 2, by hand for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel fastdet/kernels/fused_infer.py
// (_stem_call -> _stem_kernel/_stem_body).  Same function: the input is
// the host's uint8 space-to-depth(4) layout (B, 48, npad), channel
// yoff*12 + xoff*3 + c, lane i*w4 + j for pixel (4i+yoff, 4j+xoff, c);
// lanes [h4*w4, npad) are padding and never read.  The output is the
// pooled map (B, 24, h4, w4) f32, NCHW.
//
// What bounds it on this card: operations.  At 352^2 one image is
// 176^2*24 conv outputs x 27 MACs = 40.1 MFLOP against 0.37 MB of uint8 in
// and 0.74 MB of f32 out, about 36 FLOP per byte, above the card's f32
// ridge (67 TFLOP/s over 3.35 TB/s = 20).  The design:
//   * the direct 27-tap conv per output on CUDA cores in f32 FMA.  The TPU
//     kernel's (192, 96) phase matrix is 86% zeros, there only to give the
//     MXU a dense K; here it would be 7x the work;
//   * the 648 folded weights and 24 biases travel as a kernel parameter
//     (the constant bank), so every FMA takes its weight as a constant
//     operand with no load instruction;
//   * one CTA per (image, 8x8 tile of pooled cells).  The pooled grid is
//     the s2d grid, and cell (u, v) holds the four conv outputs
//     (2u+py, 2v+px).  The CTA stages the tile's input cells with a
//     two-cell halo above and to the left in shared memory (zero outside
//     the image: the conv's zero pad), convolves the tile's cells plus a
//     one-cell halo (all four phases, 24 channels) into shared memory, and
//     then pools from there: pooled(i, j) = max over conv rows
//     {2i-1, 2i, 2i+1} x cols {2j-1, 2j, 2j+1}, i.e. phase py=1 of cell
//     i-1, both phases of cell i, and likewise for columns;
//   * the pool's -inf pad reaches only the top and left edges.  A halo
//     cell outside the image stores 0 instead: every pooled window also
//     holds a real ReLU output, which is >= 0, so a 0 never wins.
// The halo cells cost 81/64 of the tile's own conv work.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kTR = 8, kTC = 8;             // pooled cells per CTA
constexpr int kCR = kTR + 1, kCC = kTC + 1; // conv cells, one-cell halo
constexpr int kIR = kTR + 2, kIC = kTC + 2; // input cells, two-cell halo
constexpr int kCells = kCR * kCC;
constexpr int kCout = 24;

struct StemParams {
  float w[27 * kCout];  // [(ky*3 + kx)*3 + c][co], /255 and BN folded in
  float b[kCout];
};

__global__ void __launch_bounds__(kThreads)
stem_s2d_kernel(const uint8_t* __restrict__ x, float* __restrict__ out,
                int h4, int w4, int npad, int ntx, const StemParams p) {
  __shared__ uint8_t s_in[48][kIR][kIC];
  __shared__ float s_conv[4][kCout][kCells];   // [py*2+px][co][cell]

  const int b = blockIdx.y;
  const int ty = blockIdx.x / ntx;
  const int i0 = ty * kTR, j0 = (blockIdx.x - ty * ntx) * kTC;
  const int tid = threadIdx.x;
  const uint8_t* xb = x + (size_t)b * 48 * npad;
  float* ob = out + (size_t)b * kCout * h4 * w4;

  // 1. input cells [i0-2, i0+kTR) x [j0-2, j0+kTC), 48 planes
  for (int it = tid; it < 48 * kIR * kIC; it += kThreads) {
    const int ch = it / (kIR * kIC);
    const int r = (it / kIC) % kIR;
    const int c = it % kIC;
    const int u = i0 - 2 + r, v = j0 - 2 + c;
    s_in[ch][r][c] = (u >= 0 && u < h4 && v >= 0 && v < w4)
                         ? xb[(size_t)ch * npad + u * w4 + v] : (uint8_t)0;
  }
  __syncthreads();

  // 2. conv + ReLU of cells [i0-1, i0+kTR) x [j0-1, j0+kTC), one phase of
  //    one cell per item.  Conv output (2u+py, 2v+px) reads image rows
  //    4u + 2py + ky - 1 (ky = 0..2): row offset -1 is yoff 3 of cell u-1,
  //    offsets 0..3 are yoff 0..3 of cell u; columns likewise.
  for (int it = tid; it < 4 * kCells; it += kThreads) {
    const int ph = it / kCells;
    const int cell = it - ph * kCells;
    const int cr = cell / kCC, cc = cell - cr * kCC;
    const int py = ph >> 1, px = ph & 1;
    const int u = i0 - 1 + cr, v = j0 - 1 + cc;
    float acc[kCout];
    if (u >= 0 && v >= 0 && u < h4 && v < w4) {
#pragma unroll
      for (int o = 0; o < kCout; ++o) acc[o] = p.b[o];
#pragma unroll
      for (int ky = 0; ky < 3; ++ky) {
        const int ro = 2 * py + ky - 1;
        const int sr = ro < 0 ? cr : cr + 1;     // s_in row of cell u-1 / u
        const int yoff = ro < 0 ? 3 : ro;
#pragma unroll
        for (int kx = 0; kx < 3; ++kx) {
          const int co = 2 * px + kx - 1;
          const int sc = co < 0 ? cc : cc + 1;
          const int xoff = co < 0 ? 3 : co;
#pragma unroll
          for (int c = 0; c < 3; ++c) {
            const float val = (float)s_in[yoff * 12 + xoff * 3 + c][sr][sc];
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
    for (int o = 0; o < kCout; ++o) s_conv[ph][o][cell] = acc[o];
  }
  __syncthreads();

  // 3. maxpool 3x3 s2: rows {py=1 of cell i-1, py=0 and 1 of cell i},
  //    then the same over columns
  for (int it = tid; it < kCout * kTR * kTC; it += kThreads) {
    const int o = it / (kTR * kTC);
    const int cell = it - o * (kTR * kTC);
    const int pr = cell / kTC, pc = cell - pr * kTC;
    const int i = i0 + pr, j = j0 + pc;
    if (i >= h4 || j >= w4) continue;
    float r[2][2];                               // [px][column j-1, j]
#pragma unroll
    for (int px = 0; px < 2; ++px) {
#pragma unroll
      for (int dc = 0; dc < 2; ++dc) {
        const int col = pc + dc;                 // conv cell column j-1+dc
        const float up = s_conv[2 + px][o][pr * kCC + col];
        const float p0 = s_conv[px][o][(pr + 1) * kCC + col];
        const float p1 = s_conv[2 + px][o][(pr + 1) * kCC + col];
        r[px][dc] = fmaxf(fmaxf(up, p0), p1);
      }
    }
    ob[(size_t)o * h4 * w4 + i * w4 + j] =
        fmaxf(fmaxf(r[0][1], r[1][1]), r[1][0]);
  }
}

}  // namespace

extern "C" {

// x (B, 48, npad) u8 on the card -> out (B, 24, h4, w4) f32 on the card;
// w (27*24) and bias (24) f32 on the HOST: they become the kernel's
// parameter block.  Returns a cudaError_t (0 = launched).
int fastdet_stem_s2d(const uint8_t* x, float* out, const float* w_host,
                     const float* b_host, int b, int h4, int w4, int npad,
                     void* stream) {
  if (b < 1 || b > 65535 || h4 < 1 || w4 < 1 || npad < h4 * w4)
    return (int)cudaErrorInvalidValue;
  StemParams p;
  for (int k = 0; k < 27 * kCout; ++k) p.w[k] = w_host[k];
  for (int k = 0; k < kCout; ++k) p.b[k] = b_host[k];
  const int ntx = (w4 + kTC - 1) / kTC;
  const int nty = (h4 + kTR - 1) / kTR;
  stem_s2d_kernel<<<dim3(ntx * nty, b), kThreads, 0, (cudaStream_t)stream>>>(
      x, out, h4, w4, npad, ntx, p);
  return (int)cudaGetLastError();
}

const char* fastdet_cuda_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
