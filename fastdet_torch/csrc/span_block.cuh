// The stride-1 ShuffleV2 block kernel of the span (span.cu) and its
// launcher, shared by span.cu and the stage kernel s2span.cu, which runs a
// stride-2 block and then a span.  The design is described in span.cu.

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kGroup = 8;   // output channels per thread in a pointwise conv
constexpr int kLoads = 8;   // independent global loads in flight per thread

// The tile per width, fixed at compile time so that the index arithmetic
// divides by constants; shared memory 2*MID*(TH+2)*(TW+2)*4 bytes: 59,904 /
// 64,896 / 79,872.  At 352^2 the tiles cover 44^2, 22^2 exactly and 11^2
// in 6 + 5 rows; other sizes leave a partial last tile.
template <int MID>
struct Tile;
template <> struct Tile<24> { static constexpr int TH = 11, TW = 22; };
template <> struct Tile<48> { static constexpr int TH = 11, TW = 11; };
template <> struct Tile<96> { static constexpr int TH = 6, TW = 11; };

template <int MID>
__device__ __forceinline__ void pointwise8(const float* __restrict__ src,
                                           int stride, int p,
                                           const float* __restrict__ w,
                                           const float* __restrict__ bias,
                                           int o0, float acc[kGroup]) {
  const float4 b0 = __ldg(reinterpret_cast<const float4*>(bias + o0));
  const float4 b1 = __ldg(reinterpret_cast<const float4*>(bias + o0 + 4));
  acc[0] = b0.x; acc[1] = b0.y; acc[2] = b0.z; acc[3] = b0.w;
  acc[4] = b1.x; acc[5] = b1.y; acc[6] = b1.z; acc[7] = b1.w;
#pragma unroll 4
  for (int i = 0; i < MID; ++i) {
    const float v = src[i * stride + p];
    const float4 wa = __ldg(reinterpret_cast<const float4*>(w + i * MID + o0));
    const float4 wb =
        __ldg(reinterpret_cast<const float4*>(w + i * MID + o0 + 4));
    acc[0] = fmaf(v, wa.x, acc[0]); acc[1] = fmaf(v, wa.y, acc[1]);
    acc[2] = fmaf(v, wa.z, acc[2]); acc[3] = fmaf(v, wa.w, acc[3]);
    acc[4] = fmaf(v, wb.x, acc[4]); acc[5] = fmaf(v, wb.y, acc[5]);
    acc[6] = fmaf(v, wb.z, acc[6]); acc[7] = fmaf(v, wb.w, acc[7]);
  }
}

template <int MID>
__global__ void __launch_bounds__(kThreads)
span_block_kernel(const float* __restrict__ x, float* __restrict__ y,
                  const float* __restrict__ wts, int h, int w, int ntx) {
  extern __shared__ float smem[];
  constexpr int C = 2 * MID;
  constexpr int G = MID / kGroup;
  constexpr int th = Tile<MID>::TH, tw = Tile<MID>::TW;
  constexpr int wp = tw + 2;
  constexpr int np = (th + 2) * wp;  // halo tile pixels
  constexpr int nin = th * tw;       // interior pixels
  float* s_a = smem;               // MID x np: odd input, later dw output
  float* s_b = smem + MID * np;    // MID x np: ReLU(pw1), 0 off the image

  const float* w1 = wts;
  const float* b1 = w1 + MID * MID;
  const float* wd = b1 + MID;
  const float* bd = wd + 9 * MID;
  const float* w2 = bd + MID;
  const float* b2 = w2 + MID * MID;

  const int b = blockIdx.y;
  const int ty = blockIdx.x / ntx;
  const int y0 = ty * th, x0 = (blockIdx.x - ty * ntx) * tw;
  const size_t plane = (size_t)h * w;
  const float* xb = x + (size_t)b * C * plane;
  float* yb = y + (size_t)b * C * plane;
  const int tid = threadIdx.x;

  // 1. odd input channels of the halo tile; even channels pass through.
  //    Each thread issues kLoads independent loads before their stores,
  //    so that enough bytes are in flight to cover the memory latency.
  for (int it0 = tid; it0 < MID * np; it0 += kLoads * kThreads) {
    float v[kLoads];
#pragma unroll
    for (int u = 0; u < kLoads; ++u) {
      const int it = it0 + u * kThreads;
      const int i = it / np, p = it - i * np;
      const int gy = y0 - 1 + p / wp, gx = x0 - 1 + p % wp;
      v[u] = (it < MID * np && gy >= 0 && gy < h && gx >= 0 && gx < w)
                 ? xb[(2 * i + 1) * plane + gy * w + gx] : 0.f;
    }
#pragma unroll
    for (int u = 0; u < kLoads; ++u)
      if (it0 + u * kThreads < MID * np) s_a[it0 + u * kThreads] = v[u];
  }
  for (int it0 = tid; it0 < MID * nin; it0 += kLoads * kThreads) {
    float v[kLoads];
    size_t at[kLoads];
#pragma unroll
    for (int u = 0; u < kLoads; ++u) {
      const int it = it0 + u * kThreads;
      const int c = it / nin, p = it - c * nin;
      const int gy = y0 + p / tw, gx = x0 + p % tw;
      const bool ok = it < MID * nin && gy < h && gx < w;
      at[u] = ok ? c * plane + gy * w + gx : ~(size_t)0;
      v[u] = ok ? xb[2 * c * plane + gy * w + gx] : 0.f;
    }
#pragma unroll
    for (int u = 0; u < kLoads; ++u)
      if (at[u] != ~(size_t)0) yb[at[u]] = v[u];
  }
  __syncthreads();

  // 2. pw1 + ReLU over the halo tile; 0 outside the image (dw zero pad)
  for (int it = tid; it < G * np; it += kThreads) {
    const int g = it / np, p = it - g * np;
    const int gy = y0 - 1 + p / wp, gx = x0 - 1 + p % wp;
    const bool inside = gy >= 0 && gy < h && gx >= 0 && gx < w;
    float acc[kGroup];
    pointwise8<MID>(s_a, np, p, w1, b1, g * kGroup, acc);
#pragma unroll
    for (int k = 0; k < kGroup; ++k)
      s_b[(g * kGroup + k) * np + p] = inside ? fmaxf(acc[k], 0.f) : 0.f;
  }
  __syncthreads();

  // 3. depthwise 3x3 + bias (no ReLU) on the interior -> s_a (MID x nin)
  for (int it = tid; it < MID * nin; it += kThreads) {
    const int c = it / nin, p = it - c * nin;
    const int py = p / tw, px = p - py * tw;
    const float* src = s_b + c * np + py * wp + px;  // window's top left
    float acc = __ldg(bd + c);
#pragma unroll
    for (int t = 0; t < 9; ++t)
      acc = fmaf(__ldg(wd + t * MID + c), src[(t / 3) * wp + t % 3], acc);
    s_a[c * nin + p] = acc;
  }
  __syncthreads();

  // 4. pw2 + ReLU -> output channels [MID, C)
  for (int it = tid; it < G * nin; it += kThreads) {
    const int g = it / nin, p = it - g * nin;
    const int gy = y0 + p / tw, gx = x0 + p % tw;
    if (gy >= h || gx >= w) continue;
    float acc[kGroup];
    pointwise8<MID>(s_a, nin, p, w2, b2, g * kGroup, acc);
#pragma unroll
    for (int k = 0; k < kGroup; ++k)
      yb[(MID + g * kGroup + k) * plane + gy * w + gx] = fmaxf(acc[k], 0.f);
  }
}

template <int MID>
int launch_span(const float* x, float* out, float* tmp, const float* wts,
                int b, int h, int w, int nblk, cudaStream_t stream) {
  constexpr int kBlockFloats = 2 * MID * MID + 12 * MID;
  constexpr int th = Tile<MID>::TH, tw = Tile<MID>::TW;
  const int ny = (h + th - 1) / th, nx = (w + tw - 1) / tw;
  const size_t smem = (size_t)2 * MID * (th + 2) * (tw + 2) * sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(
      span_block_kernel<MID>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return (int)err;
  // ping-pong so that the last block writes `out`; x is never written
  const float* src = x;
  for (int k = 0; k < nblk; ++k) {
    float* dst = ((nblk - 1 - k) % 2 == 0) ? out : tmp;
    span_block_kernel<MID><<<dim3(nx * ny, b), kThreads, smem, stream>>>(
        src, dst, wts + (size_t)k * kBlockFloats, h, w, nx);
    err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
    src = dst;
  }
  return 0;
}

}  // namespace
