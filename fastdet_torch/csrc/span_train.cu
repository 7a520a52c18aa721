// The training span B8: the stride-1 ShuffleV2 blocks of one backbone
// stage with ghost BatchNorm, forward and backward, by hand for Hopper
// (sm_90a).
//
// Replaces the Pallas TPU kernels fastdet/kernels/fused_train.py
// (_fwd_call -> _span_train_fwd_kernel, _bwd_call -> _span_train_bwd_kernel).
// Same function, on NCHW f32 activations (B, C, h, w), C = 2*MID in
// {48, 96, 192}.  One block:
//   u1 = pw1(x[:, 1::2])   y = ReLU(BN1(u1))
//   u2 = dw3x3(y)          v = BN2(u2)
//   u3 = pw2(v)            z = ReLU(BN3(u3))       out = cat[x[:, 0::2], z]
// Each BN normalises with the statistics of its ghost group (the g
// consecutive images of the group, m = g*h*w samples per channel): the
// mean, then the biased variance mean((u-mu)^2), eps 1e-5.  The weights
// of a block are one f32 row (fastdet_torch/kernels/fused_train.py):
//   [w1 (MID_in x MID_out) | wd (9 x MID) | w2 (MID_in x MID_out) |
//    g1 b1 g2 b2 g3 b3 (6 x MID)].
// Stats: (nblk, 3 BNs, G, [mu, sinv, var], MID).
//
// Design.  A ghost group's BN input is MID x m floats: 372 KB at stages 2
// and 3 and 743 KB at stage 4 at b128 352^2, more than the 227 KB of
// shared memory of an SM, so every BN is a global sync point and a block
// is several launches, split there:
//   forward:  pw1 -> stats -> dw (BN1+ReLU on load) -> stats -> pw2 (BN2 on
//             load) -> stats -> out (passthrough + BN3+ReLU);
//   backward: recompute u1, u2, u3 with the same kernels from the saved
//             block input and the saved stats, then BN3 backward (one CTA
//             per (group, channel): the sums, then du3) -> dW2 partials ->
//             dv = w2 du3 -> BN2 backward -> dwd partials -> transposed dw
//             -> BN1 backward (ReLU mask from the recomputed u1) -> dW1
//             partials -> dx (odd channels w1 du1, even channels dy).
// The intermediates u1, u2, u3 (and du, dv) are in device memory.  Stats
// are two-pass within a CTA (the mean, then sum (u-mu)^2), never
// E[u^2]-mu^2.  Weight gradients: each CTA writes a partial sum for its
// chunk of pixels (BN gammas and betas: for its group) into its own row,
// and one launch adds the rows in a fixed order, so two runs give the
// same bits (no atomics).
//
// Arithmetic: every pointwise conv sums its input channels in order,
// acc = acc + x*w, and the depthwise conv its 9 taps in order; BN is
// (u-mu)*(sinv*gamma)+beta.  The file is built with --fmad=false, so the
// plain PyTorch versions, which do the same operations, recompute the
// same forward values bit for bit from the same saved inputs and stats,
// and the backward's ReLU masks agree.
//
// What bounds it on this card: at b128 352^2 the forward does ~8.2 GFLOP
// (0.12 ms at 67 TFLOP/s f32) and must write the 345 MB of saved block
// inputs (0.10 ms); the backward ~3x the operations.  This first version
// is simple and launch-split: it re-reads the intermediates from device
// memory at every step.  Keeping a group on chip (thread-block clusters)
// and fewer launches per block are later work.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kTP = 64;       // pixels per CTA in a pointwise conv
constexpr int kChunk = 1024;  // pixels per weight-gradient partial row
constexpr int kSub = 32;      // pixels per shared tile in a dW product
constexpr float kEps = 1e-5f;

enum Pro { kRaw = 0, kBN = 1, kBNRelu = 2 };

template <int MID>
struct Row {
  static constexpr int W1 = 0;
  static constexpr int WD = MID * MID;
  static constexpr int W2 = MID * MID + 9 * MID;
  static constexpr int GB = 2 * MID * MID + 9 * MID;
  static constexpr int LEN = 2 * MID * MID + 15 * MID;
};

// the dW product's thread grid: TI x TI threads, each an RB x RB block
template <int MID> struct DW;
template <> struct DW<24> { static constexpr int TI = 8, RB = 3; };
template <> struct DW<48> { static constexpr int TI = 16, RB = 3; };
template <> struct DW<96> { static constexpr int TI = 16, RB = 6; };

// Stats of one BN: st[(gi*3 + kind)*MID + c], kind 0 mu, 1 sinv, 2 var.
// gb points at this BN's gamma; its beta is gb[MID + c].
template <int MID, int PRO>
__device__ __forceinline__ float prologue(float v, const float* st,
                                          const float* gb, int gi, int c) {
  if (PRO == kRaw) return v;
  const float mu = st[(gi * 3) * MID + c];
  const float sinv = st[(gi * 3 + 1) * MID + c];
  float r = (v - mu) * (sinv * gb[c]) + gb[MID + c];
  if (PRO == kBNRelu) r = fmaxf(r, 0.f);
  return r;
}

// Deterministic sum over the CTA's 256 threads; every thread gets it.
__device__ __forceinline__ float block_sum(float v, float* red) {
  for (int o = 16; o > 0; o >>= 1) v += __shfl_down_sync(0xffffffffu, v, o);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  __syncthreads();
  if (lane == 0) red[warp] = v;
  __syncthreads();
  float s = 0.f;
  if (threadIdx.x == 0) {
    for (int k = 0; k < kThreads / 32; ++k) s += red[k];
    red[kThreads / 32] = s;
  }
  __syncthreads();
  return red[kThreads / 32];
}

// 1x1 conv: out[b, out_off + j*out_step] = sum_k M(k, j) * f(in[b, in_off +
// k*in_step]), k in order; M(k, j) = W[k*MID + j], or W[j*MID + k] when
// TRANS.  f is the prologue (BN of the group, optional ReLU).
template <int MID, int PRO, bool TRANS>
__global__ void __launch_bounds__(kThreads)
pw_kernel(const float* __restrict__ in, int in_c, int in_off, int in_step,
          float* __restrict__ out, int out_c, int out_off, int out_step,
          const float* __restrict__ W, const float* __restrict__ st,
          const float* __restrict__ gb, int n_pix, int plane, int g) {
  __shared__ float s_in[MID * kTP];
  const int n0 = blockIdx.x * kTP;
  for (int it = threadIdx.x; it < MID * kTP; it += kThreads) {
    const int k = it / kTP, p = it - k * kTP, n = n0 + p;
    float v = 0.f;
    if (n < n_pix) {
      const int b = n / plane, q = n - b * plane;
      v = in[((size_t)b * in_c + in_off + k * in_step) * plane + q];
      v = prologue<MID, PRO>(v, st, gb, b / g, k);
    }
    s_in[it] = v;
  }
  __syncthreads();
  for (int it = threadIdx.x; it < (MID / 8) * kTP; it += kThreads) {
    const int jg = it / kTP, p = it - jg * kTP, n = n0 + p;
    if (n >= n_pix) continue;
    float acc[8];
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[j] = 0.f;
    for (int k = 0; k < MID; ++k) {
      const float v = s_in[k * kTP + p];
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const int jj = jg * 8 + j;
        const float w = TRANS ? __ldg(W + jj * MID + k) : __ldg(W + k * MID + jj);
        acc[j] = acc[j] + v * w;
      }
    }
    const int b = n / plane, q = n - b * plane;
#pragma unroll
    for (int j = 0; j < 8; ++j)
      out[((size_t)b * out_c + out_off + (jg * 8 + j) * out_step) * plane + q] =
          acc[j];
  }
}

// Depthwise 3x3, zero pad, on (B, MID, h, w): out = sum_t wd[t'][c] *
// f(in[neighbour t]), t in order, t' = FLIP ? 8 - t : t.
template <int MID, int PRO, bool FLIP>
__global__ void __launch_bounds__(kThreads)
dw_kernel(const float* __restrict__ in, float* __restrict__ out,
          const float* __restrict__ wd, const float* __restrict__ st,
          const float* __restrict__ gb, int total, int h, int w, int g) {
  const int idx = blockIdx.x * kThreads + threadIdx.x;
  if (idx >= total) return;
  const int plane = h * w;
  const int bc = idx / plane, q = idx - bc * plane;
  const int b = bc / MID, c = bc - b * MID;
  const int y0 = q / w, x0 = q - y0 * w;
  const float* src = in + (size_t)bc * plane;
  float acc = 0.f;
#pragma unroll
  for (int t = 0; t < 9; ++t) {
    const int yy = y0 + t / 3 - 1, xx = x0 + t % 3 - 1;
    if (yy < 0 || yy >= h || xx < 0 || xx >= w) continue;
    const float v = prologue<MID, PRO>(src[yy * w + xx], st, gb, b / g, c);
    acc = acc + __ldg(wd + (FLIP ? 8 - t : t) * MID + c) * v;
  }
  out[idx] = acc;
}

// Ghost-group stats of u (B, MID, h, w): one CTA per (group, channel).
template <int MID>
__global__ void __launch_bounds__(kThreads)
stats_kernel(const float* __restrict__ u, float* __restrict__ st, int plane,
             int g) {
  __shared__ float red[kThreads / 32 + 1];
  const int gi = blockIdx.x / MID, c = blockIdx.x - gi * MID;
  const int m = g * plane;
  const float* base = u + ((size_t)gi * g * MID + c) * plane;
  float s = 0.f;
  for (int i = threadIdx.x; i < m; i += kThreads) {
    const int bl = i / plane, q = i - bl * plane;
    s += base[(size_t)bl * MID * plane + q];
  }
  const float mu = block_sum(s, red) / (float)m;
  float s2 = 0.f;
  for (int i = threadIdx.x; i < m; i += kThreads) {
    const int bl = i / plane, q = i - bl * plane;
    const float d = base[(size_t)bl * MID * plane + q] - mu;
    s2 += d * d;
  }
  const float var = block_sum(s2, red) / (float)m;
  if (threadIdx.x == 0) {
    st[(gi * 3) * MID + c] = mu;
    st[(gi * 3 + 1) * MID + c] = rsqrtf(var + kEps);
    st[(gi * 3 + 2) * MID + c] = var;
  }
}

// Block output: channels < MID pass x's even channels through, the rest
// are ReLU(BN3(u3)).
template <int MID>
__global__ void __launch_bounds__(kThreads)
out_kernel(const float* __restrict__ x, const float* __restrict__ u3,
           const float* __restrict__ st, const float* __restrict__ gb,
           float* __restrict__ out, int total, int plane, int g) {
  const int idx = blockIdx.x * kThreads + threadIdx.x;
  if (idx >= total) return;
  const int bc = idx / plane, q = idx - bc * plane;
  const int b = bc / (2 * MID), ch = bc - b * 2 * MID;
  float v;
  if (ch < MID) {
    v = x[((size_t)b * 2 * MID + 2 * ch) * plane + q];
  } else {
    const int c = ch - MID;
    v = prologue<MID, kBNRelu>(u3[((size_t)b * MID + c) * plane + q], st, gb,
                               b / g, c);
  }
  out[idx] = v;
}

// dx's even channels: the passthrough's gradient dy[:, :MID].
template <int MID>
__global__ void __launch_bounds__(kThreads)
even_grad_kernel(const float* __restrict__ dy, float* __restrict__ dx,
                 int total, int plane) {
  const int idx = blockIdx.x * kThreads + threadIdx.x;
  if (idx >= total) return;
  const int bc = idx / plane, q = idx - bc * plane;
  const int b = bc / MID, c = bc - b * MID;
  dx[((size_t)b * 2 * MID + 2 * c) * plane + q] =
      dy[((size_t)b * 2 * MID + c) * plane + q];
}

// BN backward within the group, one CTA per (group, channel).  The
// gradient at the BN output is gsrc[b, g_off + c] (B, g_c channels), with
// the ReLU mask BN(u) > 0 when RELU.  Pass 1: s1 = sum g, s2 = sum g*xhat;
// pass 2: du = (gamma*sinv)*(g - s1/m - xhat*(s2/m)).  The group's
// (dgamma, dbeta) partials s2, s1 go to row gi of `part` (row stride LEN).
template <int MID, bool RELU>
__global__ void __launch_bounds__(kThreads)
bn_bwd_kernel(const float* __restrict__ gsrc, int g_c, int g_off,
              const float* __restrict__ u, const float* __restrict__ st,
              const float* __restrict__ gb, float* __restrict__ du,
              float* __restrict__ part, int gb_col, int plane, int g) {
  __shared__ float red[kThreads / 32 + 1];
  const int gi = blockIdx.x / MID, c = blockIdx.x - gi * MID;
  const int m = g * plane;
  const float mu = st[(gi * 3) * MID + c];
  const float sinv = st[(gi * 3 + 1) * MID + c];
  const float gamma = gb[c], beta = gb[MID + c];
  const float sc = sinv * gamma;
  float s1 = 0.f, s2 = 0.f;
  for (int i = threadIdx.x; i < m; i += kThreads) {
    const int b = gi * g + i / plane, q = i - (i / plane) * plane;
    const float uv = u[((size_t)b * MID + c) * plane + q];
    float gv = gsrc[((size_t)b * g_c + g_off + c) * plane + q];
    if (RELU && !((uv - mu) * sc + beta > 0.f)) gv = 0.f;
    s1 += gv;
    s2 += gv * ((uv - mu) * sinv);
  }
  s1 = block_sum(s1, red);
  s2 = block_sum(s2, red);
  const float a1 = s1 / (float)m, a2 = s2 / (float)m;
  const float k = gamma * sinv;
  for (int i = threadIdx.x; i < m; i += kThreads) {
    const int b = gi * g + i / plane, q = i - (i / plane) * plane;
    const size_t at = ((size_t)b * MID + c) * plane + q;
    const float uv = u[at];
    float gv = gsrc[((size_t)b * g_c + g_off + c) * plane + q];
    if (RELU && !((uv - mu) * sc + beta > 0.f)) gv = 0.f;
    const float xhat = (uv - mu) * sinv;
    du[at] = k * (gv - a1 - xhat * a2);
  }
  if (threadIdx.x == 0) {
    float* row = part + (size_t)gi * Row<MID>::LEN + Row<MID>::GB;
    row[gb_col * MID + c] = s2;
    row[(gb_col + 1) * MID + c] = s1;
  }
}

// Pointwise weight gradient over one chunk of pixels:
// part[chunk][off + i*MID + o] = sum_n f(a[b, a_off + i*a_step]) * dc[b, o].
template <int MID, int PRO>
__global__ void __launch_bounds__(kThreads)
dw_pw_kernel(const float* __restrict__ a, int a_c, int a_off, int a_step,
             const float* __restrict__ st, const float* __restrict__ gb,
             const float* __restrict__ dc, float* __restrict__ part, int off,
             int n_pix, int plane, int g) {
  constexpr int TI = DW<MID>::TI, RB = DW<MID>::RB;
  __shared__ float sa[MID][kSub + 1];
  __shared__ float sc[MID][kSub + 1];
  const int ti = threadIdx.x / TI, to = threadIdx.x - ti * TI;
  const bool active = threadIdx.x < TI * TI;
  float acc[RB][RB];
#pragma unroll
  for (int r = 0; r < RB; ++r)
#pragma unroll
    for (int s = 0; s < RB; ++s) acc[r][s] = 0.f;
  const int c0 = blockIdx.x * kChunk;
  const int c1 = min(c0 + kChunk, n_pix);
  for (int n0 = c0; n0 < c1; n0 += kSub) {
    __syncthreads();
    for (int it = threadIdx.x; it < MID * kSub; it += kThreads) {
      const int k = it / kSub, p = it - k * kSub, n = n0 + p;
      float va = 0.f, vc = 0.f;
      if (n < c1) {
        const int b = n / plane, q = n - b * plane;
        va = prologue<MID, PRO>(
            a[((size_t)b * a_c + a_off + k * a_step) * plane + q], st, gb,
            b / g, k);
        vc = dc[((size_t)b * MID + k) * plane + q];
      }
      sa[k][p] = va;
      sc[k][p] = vc;
    }
    __syncthreads();
    if (active) {
      for (int p = 0; p < kSub; ++p) {
        float av[RB], cv[RB];
#pragma unroll
        for (int r = 0; r < RB; ++r) av[r] = sa[ti * RB + r][p];
#pragma unroll
        for (int s = 0; s < RB; ++s) cv[s] = sc[to * RB + s][p];
#pragma unroll
        for (int r = 0; r < RB; ++r)
#pragma unroll
          for (int s = 0; s < RB; ++s) acc[r][s] = acc[r][s] + av[r] * cv[s];
      }
    }
  }
  if (active) {
    float* row = part + (size_t)blockIdx.x * Row<MID>::LEN + off;
#pragma unroll
    for (int r = 0; r < RB; ++r)
#pragma unroll
      for (int s = 0; s < RB; ++s)
        row[(ti * RB + r) * MID + to * RB + s] = acc[r][s];
  }
}

// Depthwise weight gradient over one chunk of pixels and one channel:
// part[chunk][WD + t*MID + c] = sum_n du2[b, c, q] * y[b, c, q + off_t],
// y = ReLU(BN1(u1)), 0 off the image.  Grid (chunks, MID).
template <int MID>
__global__ void __launch_bounds__(kThreads)
dw_dw_kernel(const float* __restrict__ du2, const float* __restrict__ u1,
             const float* __restrict__ st, const float* __restrict__ gb,
             float* __restrict__ part, int n_pix, int h, int w, int g) {
  __shared__ float red[kThreads / 32 + 1];
  const int c = blockIdx.y;
  const int plane = h * w;
  const int c0 = blockIdx.x * kChunk;
  const int c1 = min(c0 + kChunk, n_pix);
  float acc[9];
#pragma unroll
  for (int t = 0; t < 9; ++t) acc[t] = 0.f;
  for (int n = c0 + threadIdx.x; n < c1; n += kThreads) {
    const int b = n / plane, q = n - b * plane;
    const int y0 = q / w, x0 = q - y0 * w;
    const size_t base = ((size_t)b * MID + c) * plane;
    const float d = du2[base + q];
#pragma unroll
    for (int t = 0; t < 9; ++t) {
      const int yy = y0 + t / 3 - 1, xx = x0 + t % 3 - 1;
      if (yy < 0 || yy >= h || xx < 0 || xx >= w) continue;
      acc[t] = acc[t] + d * prologue<MID, kBNRelu>(u1[base + yy * w + xx],
                                                   st, gb, b / g, c);
    }
  }
  float* row = part + (size_t)blockIdx.x * Row<MID>::LEN + Row<MID>::WD;
  for (int t = 0; t < 9; ++t) {
    const float s = block_sum(acc[t], red);
    if (threadIdx.x == 0) row[t * MID + c] = s;
  }
}

// dblocks[i][j] = sum over the P partial rows of block i, in order.
__global__ void __launch_bounds__(kThreads)
reduce_rows_kernel(const float* __restrict__ part, float* __restrict__ out,
                   int nblk, int prows, int len) {
  const int idx = blockIdx.x * kThreads + threadIdx.x;
  if (idx >= nblk * len) return;
  const int i = idx / len, j = idx - i * len;
  const float* p = part + (size_t)i * prows * len + j;
  float s = 0.f;
  for (int r = 0; r < prows; ++r) s += p[(size_t)r * len];
  out[idx] = s;
}

inline int grid1(size_t n) { return (int)((n + kThreads - 1) / kThreads); }
inline int chunks(int n_pix) { return (n_pix + kChunk - 1) / kChunk; }

#define FASTDET_CHECK()                          \
  do {                                           \
    cudaError_t e_ = cudaGetLastError();         \
    if (e_ != cudaSuccess) return (int)e_;       \
  } while (0)

// u1, u2, u3 of one block from its input x and the stats st (3 BNs).
template <int MID>
int recompute(const float* x, const float* row, const float* st, float* u1,
              float* u2, float* u3, int b, int h, int w, int g, int G,
              cudaStream_t s, bool with_stats, float* st_out) {
  constexpr int C = 2 * MID;
  const int plane = h * w, n_pix = b * plane;
  const size_t total = (size_t)n_pix * MID;
  const size_t bn = (size_t)G * 3 * MID;  // floats of one BN's stats
  const float* gb = row + Row<MID>::GB;
  pw_kernel<MID, kRaw, false><<<(n_pix + kTP - 1) / kTP, kThreads, 0, s>>>(
      x, C, 1, 2, u1, MID, 0, 1, row + Row<MID>::W1, nullptr, nullptr, n_pix,
      plane, g);
  FASTDET_CHECK();
  if (with_stats) {
    stats_kernel<MID><<<G * MID, kThreads, 0, s>>>(u1, st_out, plane, g);
    FASTDET_CHECK();
  }
  dw_kernel<MID, kBNRelu, false><<<grid1(total), kThreads, 0, s>>>(
      u1, u2, row + Row<MID>::WD, st, gb, (int)total, h, w, g);
  FASTDET_CHECK();
  if (with_stats) {
    stats_kernel<MID><<<G * MID, kThreads, 0, s>>>(u2, st_out + bn, plane, g);
    FASTDET_CHECK();
  }
  pw_kernel<MID, kBN, false><<<(n_pix + kTP - 1) / kTP, kThreads, 0, s>>>(
      u2, MID, 0, 1, u3, MID, 0, 1, row + Row<MID>::W2, st + bn,
      gb + 2 * MID, n_pix, plane, g);
  FASTDET_CHECK();
  if (with_stats) {
    stats_kernel<MID><<<G * MID, kThreads, 0, s>>>(u3, st_out + 2 * bn, plane,
                                                   g);
    FASTDET_CHECK();
  }
  return 0;
}

template <int MID>
int span_fwd(const float* x, const float* blocks, float* out, float* xsave,
             float* stats, float* scratch, int b, int h, int w, int nblk,
             int g, cudaStream_t s) {
  constexpr int C = 2 * MID;
  const int plane = h * w, G = b / g;
  const size_t act = (size_t)b * C * plane;
  const size_t half = (size_t)b * MID * plane;
  float* u1 = scratch;
  float* u2 = scratch + half;
  float* u3 = scratch + 2 * half;
  cudaError_t err = cudaMemcpyAsync(xsave, x, act * sizeof(float),
                                    cudaMemcpyDeviceToDevice, s);
  if (err != cudaSuccess) return (int)err;
  for (int i = 0; i < nblk; ++i) {
    const float* row = blocks + (size_t)i * Row<MID>::LEN;
    const float* xi = xsave + i * act;
    float* st = stats + (size_t)i * 3 * G * 3 * MID;
    // the stats of each BN are written before the kernel that reads them
    int rc = recompute<MID>(xi, row, st, u1, u2, u3, b, h, w, g, G, s, true,
                            st);
    if (rc) return rc;
    float* dst = (i + 1 < nblk) ? xsave + (i + 1) * act : out;
    out_kernel<MID><<<grid1(act), kThreads, 0, s>>>(
        xi, u3, st + 2 * (size_t)G * 3 * MID, row + Row<MID>::GB + 4 * MID,
        dst, (int)act, plane, g);
    FASTDET_CHECK();
  }
  return 0;
}

template <int MID>
size_t bwd_scratch(int b, int h, int w, int nblk, int g) {
  const size_t plane = (size_t)h * w;
  const int prows = chunks(b * h * w) > b / g ? chunks(b * h * w) : b / g;
  return 5 * (size_t)b * MID * plane + (size_t)b * 2 * MID * plane +
         (size_t)nblk * prows * Row<MID>::LEN;
}

template <int MID>
int span_bwd(const float* dy, const float* xsave, const float* stats,
             const float* blocks, float* dx, float* dblocks, float* scratch,
             int b, int h, int w, int nblk, int g, cudaStream_t s) {
  constexpr int C = 2 * MID;
  constexpr int LEN = Row<MID>::LEN;
  const int plane = h * w, G = b / g, n_pix = b * plane;
  const int nch = chunks(n_pix);
  const int prows = nch > G ? nch : G;
  const size_t act = (size_t)b * C * plane;
  const size_t half = (size_t)b * MID * plane;
  const size_t bn = (size_t)G * 3 * MID;
  float* u1 = scratch;
  float* u2 = u1 + half;
  float* u3 = u2 + half;
  float* du = u3 + half;
  float* t = du + half;
  float* tmp = t + half;         // (B, C, h, w): ping-pong with dx
  float* part = tmp + act;       // (nblk, prows, LEN)
  cudaError_t err = cudaMemsetAsync(
      part, 0, (size_t)nblk * prows * LEN * sizeof(float), s);
  if (err != cudaSuccess) return (int)err;
  const float* g_in = dy;
  for (int i = nblk - 1; i >= 0; --i) {
    const float* row = blocks + (size_t)i * LEN;
    const float* gb = row + Row<MID>::GB;
    const float* xi = xsave + i * act;
    const float* st = stats + (size_t)i * 3 * bn;
    float* pi = part + (size_t)i * prows * LEN;
    float* g_out = (i % 2 == 0) ? dx : tmp;   // block 0 writes dx
    int rc = recompute<MID>(xi, row, st, u1, u2, u3, b, h, w, g, G, s, false,
                            nullptr);
    if (rc) return rc;
    // BN3 (ReLU): dz = g_in[:, MID:] -> du3; dgamma3, dbeta3
    bn_bwd_kernel<MID, true><<<G * MID, kThreads, 0, s>>>(
        g_in, C, MID, u3, st + 2 * bn, gb + 4 * MID, du, pi, 4, plane, g);
    FASTDET_CHECK();
    // dW2 = sum v du3, v = BN2(u2)
    dw_pw_kernel<MID, kBN><<<nch, kThreads, 0, s>>>(
        u2, MID, 0, 1, st + bn, gb + 2 * MID, du, pi, Row<MID>::W2, n_pix,
        plane, g);
    FASTDET_CHECK();
    // dv = w2 du3
    pw_kernel<MID, kRaw, true><<<(n_pix + kTP - 1) / kTP, kThreads, 0, s>>>(
        du, MID, 0, 1, t, MID, 0, 1, row + Row<MID>::W2, nullptr, nullptr,
        n_pix, plane, g);
    FASTDET_CHECK();
    // BN2 (no ReLU): dv -> du2; dgamma2, dbeta2
    bn_bwd_kernel<MID, false><<<G * MID, kThreads, 0, s>>>(
        t, MID, 0, u2, st + bn, gb + 2 * MID, du, pi, 2, plane, g);
    FASTDET_CHECK();
    // dwd = sum du2 * shifted y
    dw_dw_kernel<MID><<<dim3(nch, MID), kThreads, 0, s>>>(
        du, u1, st, gb, pi, n_pix, h, w, g);
    FASTDET_CHECK();
    // dy_y = transposed dw of du2
    dw_kernel<MID, kRaw, true><<<grid1(half), kThreads, 0, s>>>(
        du, t, row + Row<MID>::WD, nullptr, nullptr, (int)half, h, w, g);
    FASTDET_CHECK();
    // BN1 (ReLU): -> du1; dgamma1, dbeta1
    bn_bwd_kernel<MID, true><<<G * MID, kThreads, 0, s>>>(
        t, MID, 0, u1, st, gb, du, pi, 0, plane, g);
    FASTDET_CHECK();
    // dW1 = sum x_odd du1
    dw_pw_kernel<MID, kRaw><<<nch, kThreads, 0, s>>>(
        xi, C, 1, 2, nullptr, nullptr, du, pi, Row<MID>::W1, n_pix, plane, g);
    FASTDET_CHECK();
    // dx: odd channels w1 du1, even channels the passthrough's gradient
    pw_kernel<MID, kRaw, true><<<(n_pix + kTP - 1) / kTP, kThreads, 0, s>>>(
        du, MID, 0, 1, g_out, C, 1, 2, row + Row<MID>::W1, nullptr, nullptr,
        n_pix, plane, g);
    FASTDET_CHECK();
    even_grad_kernel<MID><<<grid1(half), kThreads, 0, s>>>(g_in, g_out,
                                                           (int)half, plane);
    FASTDET_CHECK();
    g_in = g_out;
  }
  reduce_rows_kernel<<<grid1((size_t)nblk * LEN), kThreads, 0, s>>>(
      part, dblocks, nblk, prows, LEN);
  FASTDET_CHECK();
  return 0;
}

bool valid(int b, int c, int h, int w, int nblk, int g) {
  if (b < 1 || h < 1 || w < 1 || nblk < 1 || g < 1 || b % g) return false;
  if (c != 48 && c != 96 && c != 192) return false;
  // element indices of one activation are ints in the elementwise kernels
  return (size_t)b * c * h * w < (size_t)1 << 31;
}

}  // namespace

extern "C" {

// x (B, C, h, w) f32 -> out (B, C, h, w), xsave (nblk, B, C, h, w) block
// inputs, stats (nblk, 3, B/g, 3, C/2); scratch holds 3*B*(C/2)*h*w
// floats; blocks (nblk, 2*MID^2 + 15*MID).  All on the card.  Returns a
// cudaError_t (0 = launched).
int fastdet_span_train_fwd(const float* x, const float* blocks, float* out,
                           float* xsave, float* stats, float* scratch, int b,
                           int c, int h, int w, int nblk, int g,
                           void* stream) {
  if (!valid(b, c, h, w, nblk, g)) return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  switch (c) {
    case 48: return span_fwd<24>(x, blocks, out, xsave, stats, scratch, b, h, w, nblk, g, s);
    case 96: return span_fwd<48>(x, blocks, out, xsave, stats, scratch, b, h, w, nblk, g, s);
    default: return span_fwd<96>(x, blocks, out, xsave, stats, scratch, b, h, w, nblk, g, s);
  }
}

// Floats of scratch that fastdet_span_train_bwd needs (0 if invalid).
size_t fastdet_span_train_bwd_scratch(int b, int c, int h, int w, int nblk,
                                      int g) {
  if (!valid(b, c, h, w, nblk, g)) return 0;
  switch (c) {
    case 48: return bwd_scratch<24>(b, h, w, nblk, g);
    case 96: return bwd_scratch<48>(b, h, w, nblk, g);
    default: return bwd_scratch<96>(b, h, w, nblk, g);
  }
}

// dy (B, C, h, w), xsave, stats and blocks as the forward's -> dx (B, C,
// h, w), dblocks (nblk, row).  dy is not written.
int fastdet_span_train_bwd(const float* dy, const float* xsave,
                           const float* stats, const float* blocks, float* dx,
                           float* dblocks, float* scratch, int b, int c, int h,
                           int w, int nblk, int g, void* stream) {
  if (!valid(b, c, h, w, nblk, g)) return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  switch (c) {
    case 48: return span_bwd<24>(dy, xsave, stats, blocks, dx, dblocks, scratch, b, h, w, nblk, g, s);
    case 96: return span_bwd<48>(dy, xsave, stats, blocks, dx, dblocks, scratch, b, h, w, nblk, g, s);
    default: return span_bwd<96>(dy, xsave, stats, blocks, dx, dblocks, scratch, b, h, w, nblk, g, s);
  }
}

const char* fastdet_cuda_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
