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
// because Mosaic has no strided lane addressing: every stride-2 tap is
// then a coarse lane roll of one phase plane.  That layout cost a 6-D
// phase-split permute at every stage boundary, and it and the VMEM held
// by the (768, n/4)-deep tap stacks made the fused stage lose on the TPU.
// On this card a stride-2 tap is index arithmetic, so the input is read
// NCHW, as the previous stage (or either stem) wrote it: no phase split.
// Nor are the TPU's composed matrices built (block-diagonal pw1 over four
// phases, dw3x3s2 composed with pw2 and with pwp): they exist to give the
// MXU a deep K and are ~8x the real work here.
//
// What bounds it on this card: operations.  Per output pixel the stride-2
// block does 2*(4*CIN*MID + 9*MID + MID^2 + 9*CIN + CIN*MID) FLOP (pw1
// runs on the four input pixels of each output) against 4*CIN*4 + 2*MID*4
// bytes read and written once: 13.5 / 25.5 / 49.5 FLOP per byte at CIN
// 24 / 48 / 96, so bytes would bound stage 2's block alone (the f32 ridge
// is 20); with the span's blocks, which add their operations but no bytes
// to the stage, every stage is above the ridge.  The design:
//   * one launch for the stride-2 block, one CTA per (image, output tile of
//     TH x TW pixels, fixed per width at compile time); the CTA stages the
//     tile's input region, (2*TH+1) x (2*TW+1) pixels of all CIN channels,
//     a one-pixel halo above and to the left (zero outside the image: the
//     projection's zero pad), in shared memory;
//   * projection dw3x3 s2 from the staged input into shared memory; pw1 +
//     ReLU over the whole region into shared memory, 0 outside the image
//     (the main dw's zero pad is on the post-ReLU branch, and ReLU(b1) is
//     not 0: span.cu's rule); main dw3x3 s2 into the staged input's place;
//     then pw2 + ReLU and pwp + ReLU straight to the output.  Only the
//     halo row and column's pw1 is computed twice;
//   * the pointwise products as span.cu's: f32 FMA on CUDA cores (no TF32:
//     the forward's 2e-4 would not hold), 8 output channels per thread,
//     weights as uniform 16-byte loads;
//   * then the span through span.cu's own block kernel (span_block.cuh),
//     nblk launches; the stride-2 block writes whichever of (out, tmp) the
//     span's first block does not, so no extra buffer exists.
// Shared memory per CTA: MID*(2*(2TH+1)(2TW+1) + TH*TW)*4 bytes, 86,208 /
// 87,936 / 99,072 at MID 24 / 48 / 96, so two CTAs fit on an SM (227 KB).

#include "span_block.cuh"

namespace {

// The stride-2 block's output tile per width.  At 352^2 the tiles cover
// 44^2 (11 x 2 tiles) and 22^2 (6 x 2, the last row of tiles half full),
// and 11^2 in 4 + 4 + 3 rows and 6 + 5 columns.
template <int MID>
struct Tile2;
template <> struct Tile2<24> { static constexpr int TH = 4, TW = 22; };
template <> struct Tile2<48> { static constexpr int TH = 4, TW = 11; };
template <> struct Tile2<96> { static constexpr int TH = 4, TW = 6; };

template <int MID>
constexpr size_t s2_smem_bytes() {
  constexpr int th = Tile2<MID>::TH, tw = Tile2<MID>::TW;
  return (size_t)MID * (2 * (2 * th + 1) * (2 * tw + 1) + th * tw) *
         sizeof(float);
}

template <int MID>
__global__ void __launch_bounds__(kThreads)
s2_block_kernel(const float* __restrict__ x, float* __restrict__ y,
                const float* __restrict__ wts, int hin, int win, int h, int w,
                int ntx) {
  extern __shared__ float smem[];
  constexpr int CIN = MID;
  constexpr int G = MID / kGroup;
  constexpr int th = Tile2<MID>::TH, tw = Tile2<MID>::TW;
  constexpr int wp = 2 * tw + 1;              // staged row length
  constexpr int np = (2 * th + 1) * wp;       // staged pixels
  constexpr int nin = th * tw;                // output pixels
  float* s_x = smem;                  // CIN x np: input; later main dw out
  float* s_y = smem + CIN * np;       // MID x np: ReLU(pw1), 0 off the image
  float* s_p = smem + (CIN + MID) * np;  // CIN x nin: projection dw out

  const float* w1 = wts;
  const float* b1 = w1 + CIN * MID;
  const float* wd = b1 + MID;
  const float* bd = wd + 9 * MID;
  const float* w2 = bd + MID;
  const float* b2 = w2 + MID * MID;
  const float* wpd = b2 + MID;
  const float* bpd = wpd + 9 * CIN;
  const float* wpp = bpd + CIN;
  const float* bpp = wpp + CIN * MID;

  const int b = blockIdx.y;
  const int ty = blockIdx.x / ntx;
  const int y0 = ty * th, x0 = (blockIdx.x - ty * ntx) * tw;
  const int iy0 = 2 * y0 - 1, ix0 = 2 * x0 - 1;   // staged region's origin
  const size_t in_plane = (size_t)hin * win, plane = (size_t)h * w;
  const float* xb = x + (size_t)b * CIN * in_plane;
  float* yb = y + (size_t)b * 2 * MID * plane;
  const int tid = threadIdx.x;

  // 1. the input region, kLoads independent loads in flight per thread
  for (int it0 = tid; it0 < CIN * np; it0 += kLoads * kThreads) {
    float v[kLoads];
#pragma unroll
    for (int u = 0; u < kLoads; ++u) {
      const int it = it0 + u * kThreads;
      const int c = it / np, p = it - c * np;
      const int gy = iy0 + p / wp, gx = ix0 + p % wp;
      v[u] = (it < CIN * np && gy >= 0 && gy < hin && gx >= 0 && gx < win)
                 ? xb[c * in_plane + gy * win + gx] : 0.f;
    }
#pragma unroll
    for (int u = 0; u < kLoads; ++u)
      if (it0 + u * kThreads < CIN * np) s_x[it0 + u * kThreads] = v[u];
  }
  __syncthreads();

  // 2. projection dw3x3 s2 + bias -> s_p.  Output (oy, ox) of the tile
  //    reads staged rows 2*oy .. 2*oy+2 and columns 2*ox .. 2*ox+2
  for (int it = tid; it < CIN * nin; it += kThreads) {
    const int c = it / nin, p = it - c * nin;
    const int oy = p / tw, ox = p - oy * tw;
    const float* src = s_x + c * np + 2 * oy * wp + 2 * ox;
    float acc = __ldg(bpd + c);
#pragma unroll
    for (int t = 0; t < 9; ++t)
      acc = fmaf(__ldg(wpd + t * CIN + c), src[(t / 3) * wp + t % 3], acc);
    s_p[c * nin + p] = acc;
  }
  // 3. pw1 + ReLU over the region -> s_y; 0 outside the image
  for (int it = tid; it < G * np; it += kThreads) {
    const int g = it / np, p = it - g * np;
    const int gy = iy0 + p / wp, gx = ix0 + p % wp;
    const bool inside = gy >= 0 && gy < hin && gx >= 0 && gx < win;
    float acc[kGroup];
    pointwise8<MID>(s_x, np, p, w1, b1, g * kGroup, acc);
#pragma unroll
    for (int k = 0; k < kGroup; ++k)
      s_y[(g * kGroup + k) * np + p] = inside ? fmaxf(acc[k], 0.f) : 0.f;
  }
  __syncthreads();

  // 4. main dw3x3 s2 + bias -> s_x (MID x nin), the input is spent
  for (int it = tid; it < MID * nin; it += kThreads) {
    const int c = it / nin, p = it - c * nin;
    const int oy = p / tw, ox = p - oy * tw;
    const float* src = s_y + c * np + 2 * oy * wp + 2 * ox;
    float acc = __ldg(bd + c);
#pragma unroll
    for (int t = 0; t < 9; ++t)
      acc = fmaf(__ldg(wd + t * MID + c), src[(t / 3) * wp + t % 3], acc);
    s_x[c * nin + p] = acc;
  }
  __syncthreads();

  // 5. pwp + ReLU -> channels [0, MID), pw2 + ReLU -> [MID, 2*MID)
  for (int it = tid; it < 2 * G * nin; it += kThreads) {
    const int g2 = it / nin, p = it - g2 * nin;
    const int gy = y0 + p / tw, gx = x0 + p % tw;
    if (gy >= h || gx >= w) continue;
    const bool main = g2 >= G;
    const int g = main ? g2 - G : g2;
    float acc[kGroup];
    if (main)
      pointwise8<MID>(s_x, nin, p, w2, b2, g * kGroup, acc);
    else
      pointwise8<MID>(s_p, nin, p, wpp, bpp, g * kGroup, acc);
    float* dst = yb + (size_t)((main ? MID : 0) + g * kGroup) * plane +
                 gy * w + gx;
#pragma unroll
    for (int k = 0; k < kGroup; ++k) dst[k * plane] = fmaxf(acc[k], 0.f);
  }
}

template <int MID>
int launch_s2span(const float* x, float* out, float* tmp, const float* wts,
                  int b, int hin, int win, int nblk, cudaStream_t stream) {
  constexpr int kS2Floats = 3 * MID * MID + 23 * MID;
  constexpr int th = Tile2<MID>::TH, tw = Tile2<MID>::TW;
  const int h = (hin + 1) / 2, w = (win + 1) / 2;
  const int ny = (h + th - 1) / th, nx = (w + tw - 1) / tw;
  constexpr size_t smem = s2_smem_bytes<MID>();
  cudaError_t err = cudaFuncSetAttribute(
      s2_block_kernel<MID>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return (int)err;
  // the span's first block writes `out` when nblk is odd, `tmp` when even
  float* dst = (nblk % 2 == 1) ? tmp : out;
  s2_block_kernel<MID><<<dim3(nx * ny, b), kThreads, smem, stream>>>(
      x, dst, wts, hin, win, h, w, nx);
  err = cudaGetLastError();
  if (err != cudaSuccess || nblk == 0) return (int)err;
  return launch_span<MID>(dst, out, tmp, wts + kS2Floats, b, h, w, nblk,
                          stream);
}

}  // namespace

extern "C" {

// x (B, CIN, hin, win) f32 -> out (B, 2*CIN, ceil(hin/2), ceil(win/2)) f32
// through the stride-2 block and nblk span blocks; tmp is a scratch tensor
// of out's shape (unused when nblk == 0); wts is the flat row of
// fold.pack_s2span_weights, 3*CIN^2 + 23*CIN + nblk*(2*CIN^2 + 12*CIN)
// floats, 16-byte aligned, all on the card.  Returns a cudaError_t
// (0 = launched).
int fastdet_s2span(const float* x, float* out, float* tmp, const float* wts,
                   int b, int cin, int hin, int win, int nblk, void* stream) {
  if (b < 1 || b > 65535 || hin < 1 || win < 1 || nblk < 0)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  switch (cin) {
    case 24: return launch_s2span<24>(x, out, tmp, wts, b, hin, win, nblk, s);
    case 48: return launch_s2span<48>(x, out, tmp, wts, b, hin, win, nblk, s);
    case 96: return launch_s2span<96>(x, out, tmp, wts, b, hin, win, nblk, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

const char* fastdet_cuda_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
