// The training stem B7: conv3x3 stride 2 (3 -> 24, no bias) + ghost
// BatchNorm + ReLU + maxpool 3x3 stride 2, forward and backward, from the
// s2d(4) uint8 layout, by hand for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernels of fastdet/kernels/stem_train.py
// (make_stem_train: _fwd_call1 -> _stem_train_fwd1_kernel, _bwd_call1 ->
// _stem_train_bwd1_kernel for ghost group 1, _fwd_call ->
// _stem_train_fwd_kernel, _bwd_call -> _stem_train_bwd_kernel for larger
// groups).  One design serves all four: the group g is an argument.
//
// Same function.  x (B, 48, npad) uint8 in the host's s2d(4) layout:
// channel yoff*12 + xoff*3 + c, lane i*w4 + j for pixel (4i+yoff, 4j+xoff,
// c); lanes [h4*w4, npad) are padding and never read.  w (24, 3, 3, 3) f32
// OIHW is the conv weight with the 1/255 input scale already applied (the
// caller scales the raw weight by a torch op, so autograd carries dW back
// through it); the conv multiplies it by the integer pixel values.
//   u   = conv3x3 s2 pad 1 of the image: conv output (2u+py, 2v+px) is phase
//         (py, px) of s2d cell (u, v); 27 taps summed in the order (ky, kx,
//         c), acc = acc + x*w, from 0;
//   BN  over the ghost group (g consecutive images, m = g*4*h4*w4 samples
//       per channel): mu, then the biased variance, sinv = 1/sqrt(var+1e-5);
//       bn = (u - mu)*(sinv*gamma) + beta in BOTH directions (the JAX kernel
//       writes the backward's ReLU mask as ((u-mu)*sinv)*gamma + beta; one
//       form here, so the recomputed masks are those of the forward);
//   y   = maxpool3x3 s2 pad 1 (-inf) of ReLU(bn), (B, 24, h4, w4) f32 NCHW;
//   stats (B/g, 24, [mu, sinv, var]) per group.
// Backward: dy (B, 24, h4, w4) -> dW (24, 3, 3, 3) with respect to the
// scaled weight, dgamma (24), dbeta (24) summed over the groups; no dX (the
// images are uint8).  The pooled cotangent is routed with the JAX kernel's
// fixed first-term-wins precedence (ties are real on uint8 images: inside
// a flat region neighbouring conv outputs are bitwise equal): first the
// column, conv column 2j, then 2j+1, then 2j-1; within the chosen column
// the row, 2i, then 2i+1, then 2i-1.  du = (gamma*sinv)*((gy - Sg/m) -
// xhat*(Sgx/m)) with Sg, Sgx the group sums of gy and gy*xhat.
//
// Built with --fmad=false: every a*b+c is two rounded operations, as the
// plain PyTorch version (fastdet_torch/kernels/stem_train.py) computes it
// with the same operations in the same order.  From the same saved stats,
// the recomputed conv outputs, BN values, ReLU masks and pool routing are
// then bit for bit those of the plain version; sums over many terms (the
// stats, Sg, Sgx, dW) differ only in their order.
//
// Variance: no E[u^2] - mu^2 (the JAX kernel's one-pass form cancels in f32
// where |mu| >> sigma).  Each 8x8-cell tile computes its mean, then its sum
// of squared deviations M2 (two passes over values held in registers);
// the tiles of a group are merged with Chan's pairwise formula, in a fixed
// order (a warp per (group, channel), each lane a strided run, then a
// fixed shuffle tree).
//
// What bounds it on this card: operations.  One conv sweep at 352^2 is
// 176^2*24 outputs x 27 MACs = 40.1 MFLOP per image against 0.37 MB of
// uint8 in; the forward writes only the pooled map (0.74 MB/img), the
// backward reads it and writes 696 floats.  The (176^2, 24) conv output
// (2.97 MB/img) never exists in device memory: a group's conv output does
// not fit in shared memory, so BN is a global sync point and the conv is
// recomputed from the uint8 input instead of stored.  Launches:
//   forward:  stats   (conv of a tile -> per-tile mean, M2)
//             combine (Chan merge per group -> stats)
//             emit    (conv of the tile + one-cell halo, BN, ReLU, pool)
//   backward: sums    (recompute the tile + halo, route dy, ReLU mask,
//                      per-tile Sg and Sgx)
//             combine (per group, fixed order)
//             dw      (one CTA per row band of tiles: recompute, route, du,
//                      dW partial summed over the band's tiles)
//             reduce  (dW over the bands, dgamma/dbeta over the groups,
//                      fixed order)
// No atomics: two runs give the same bits.  The direct 27-tap conv on CUDA
// cores (the TPU kernel's (192, 96) phase matrix is 86% zeros, there only
// for the MXU); weights and per-channel BN factors in shared memory
// (broadcast reads).  A simple first version: one conv sweep forward is
// done twice, the backward sweeps three times with halos.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kT = 8;          // a tile: 8x8 s2d cells = 8x8 pooled cells
constexpr int kCout = 24;
constexpr int kTaps = 27;
constexpr int kNW = kTaps * kCout;   // 648 weights
constexpr int kDuStride = 4 * kT * kT + 1;   // du rows, padded (banks)
constexpr float kEps = 1e-5f;
constexpr unsigned kFull = 0xffffffffu;

struct Geo {
  int h4, w4, npad, ntx, nty, g;
};

__device__ __forceinline__ float neg_inf() { return __int_as_float(0xff800000); }

// lane 0 gets the warp's sum (a fixed tree)
__device__ __forceinline__ float warp_sum(float v) {
  for (int o = 16; o > 0; o >>= 1) v = v + __shfl_down_sync(kFull, v, o);
  return v;
}

// OIHW (24, 3, 3, 3) -> s_w[((ky*3 + kx)*3 + c)*24 + co]
__device__ __forceinline__ void load_weights(const float* __restrict__ w,
                                             float* s_w) {
  for (int k = threadIdx.x; k < kNW; k += kThreads) {
    const int co = k / kTaps, r = k - co * kTaps;   // r = c*9 + ky*3 + kx
    const int c = r / 9, kk = r - c * 9;
    s_w[(kk * 3 + c) * kCout + co] = w[k];
  }
}

// s2d cells [u0, u0+R) x [v0, v0+C) of one image, 48 planes, into
// s_in[ch*R*C + r*C + c]; 0 outside the image (the conv's zero pad)
template <int R, int C>
__device__ __forceinline__ void load_cells(const uint8_t* __restrict__ xb,
                                           uint8_t* s_in, int u0, int v0,
                                           const Geo& geo) {
  for (int it = threadIdx.x; it < 48 * R * C; it += kThreads) {
    const int ch = it / (R * C);
    const int r = (it / C) % R;
    const int c = it % C;
    const int u = u0 + r, v = v0 + c;
    s_in[it] = (u >= 0 && u < geo.h4 && v >= 0 && v < geo.w4)
                   ? xb[(size_t)ch * geo.npad + u * geo.w4 + v]
                   : (uint8_t)0;
  }
}

// The 24 conv outputs of phase (py, px) of the cell at s_in position (r, c).
// Conv output (2u+py, 2v+px) reads image rows 4u + 2py + ky - 1: offset -1
// is yoff 3 of cell u-1, offsets 0..3 are yoff 0..3 of cell u; columns
// likewise.
template <int R, int C>
__device__ __forceinline__ void conv_cell(const uint8_t* s_in,
                                          const float* s_w, int r, int c,
                                          int py, int px, float acc[kCout]) {
#pragma unroll
  for (int o = 0; o < kCout; ++o) acc[o] = 0.f;
#pragma unroll
  for (int ky = 0; ky < 3; ++ky) {
    const int ro = 2 * py + ky - 1;
    const int sr = ro < 0 ? r - 1 : r;
    const int yoff = ro < 0 ? 3 : ro;
#pragma unroll
    for (int kx = 0; kx < 3; ++kx) {
      const int cof = 2 * px + kx - 1;
      const int sc = cof < 0 ? c - 1 : c;
      const int xoff = cof < 0 ? 3 : cof;
#pragma unroll
      for (int ci = 0; ci < 3; ++ci) {
        const float v =
            (float)s_in[(yoff * 12 + xoff * 3 + ci) * (R * C) + sr * C + sc];
        const float* wt = s_w + ((ky * 3 + kx) * 3 + ci) * kCout;
#pragma unroll
        for (int o = 0; o < kCout; ++o) acc[o] = acc[o] + v * wt[o];
      }
    }
  }
}

__device__ __forceinline__ int tile_count(const Geo& geo, int ty, int tx) {
  return 4 * min(kT, geo.h4 - ty * kT) * min(kT, geo.w4 - tx * kT);
}

// ------------------------------------------------------------ forward

// Per tile and channel: the mean and M2 of its valid conv outputs.
// part[(b*ntiles + tile)*48 + co*2 + {0: mean, 1: M2}].
__global__ void __launch_bounds__(kThreads)
stem_fwd_stats_kernel(const uint8_t* __restrict__ x,
                      const float* __restrict__ w, float* __restrict__ part,
                      const Geo geo) {
  __shared__ float s_w[kNW];
  __shared__ uint8_t s_in[48 * (kT + 1) * (kT + 1)];
  __shared__ float s_red[kCout][kWarps];
  __shared__ float s_mean[kCout];
  const int b = blockIdx.y, tile = blockIdx.x;
  const int ty = tile / geo.ntx, tx = tile - ty * geo.ntx;
  const int i0 = ty * kT, j0 = tx * kT;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  load_weights(w, s_w);
  load_cells<kT + 1, kT + 1>(x + (size_t)b * 48 * geo.npad, s_in, i0 - 1,
                             j0 - 1, geo);
  __syncthreads();

  const int ph = tid >> 6, cell = tid & 63;
  const int cr = cell >> 3, cc = cell & 7;
  const bool valid = i0 + cr < geo.h4 && j0 + cc < geo.w4;
  float u[kCout];
  conv_cell<kT + 1, kT + 1>(s_in, s_w, cr + 1, cc + 1, ph >> 1, ph & 1, u);
  const float n = (float)tile_count(geo, ty, tx);

#pragma unroll
  for (int o = 0; o < kCout; ++o) {
    const float s = warp_sum(valid ? u[o] : 0.f);
    if (lane == 0) s_red[o][warp] = s;
  }
  __syncthreads();
  if (tid < kCout) {
    float s = 0.f;
    for (int k = 0; k < kWarps; ++k) s = s + s_red[tid][k];
    s_mean[tid] = s / n;
  }
  __syncthreads();
#pragma unroll
  for (int o = 0; o < kCout; ++o) {
    const float d = valid ? u[o] - s_mean[o] : 0.f;
    const float s = warp_sum(d * d);
    if (lane == 0) s_red[o][warp] = s;
  }
  __syncthreads();
  if (tid < kCout) {
    float s = 0.f;
    for (int k = 0; k < kWarps; ++k) s = s + s_red[tid][k];
    float* pb = part + ((size_t)b * geo.ntx * geo.nty + tile) * (2 * kCout);
    pb[2 * tid] = s_mean[tid];
    pb[2 * tid + 1] = s;
  }
}

// Chan's merge of (n, mean, M2) with (nb, mb, m2b)
__device__ __forceinline__ void chan_merge(float& n, float& mean, float& m2,
                                           float nb, float mb, float m2b) {
  if (nb == 0.f) return;
  if (n == 0.f) {
    n = nb;
    mean = mb;
    m2 = m2b;
    return;
  }
  const float nn = n + nb;
  const float d = mb - mean;
  mean = mean + d * (nb / nn);
  m2 = (m2 + m2b) + (d * d) * (n * (nb / nn));
  n = nn;
}

// One warp per (group, channel): the group's tiles merged in a fixed order
// -> stats[(gi*24 + co)*3 + {mu, sinv, var}].
__global__ void __launch_bounds__(kThreads)
stem_stats_combine_kernel(const float* __restrict__ part,
                          float* __restrict__ stats, const Geo geo,
                          int ngroups) {
  const int wid = (blockIdx.x * kThreads + threadIdx.x) >> 5;
  const int lane = threadIdx.x & 31;
  if (wid >= ngroups * kCout) return;          // uniform within the warp
  const int gi = wid / kCout, o = wid - gi * kCout;
  const int ntiles = geo.ntx * geo.nty;
  const int nitems = geo.g * ntiles;
  float n = 0.f, mean = 0.f, m2 = 0.f;
  for (int k = lane; k < nitems; k += 32) {
    const int bi = gi * geo.g + k / ntiles, tile = k % ntiles;
    const int ty = tile / geo.ntx, tx = tile - ty * geo.ntx;
    const float* p = part + ((size_t)bi * ntiles + tile) * (2 * kCout) + 2 * o;
    chan_merge(n, mean, m2, (float)tile_count(geo, ty, tx), p[0], p[1]);
  }
  for (int off = 16; off > 0; off >>= 1) {
    const float nb = __shfl_down_sync(kFull, n, off);
    const float mb = __shfl_down_sync(kFull, mean, off);
    const float qb = __shfl_down_sync(kFull, m2, off);
    if (lane < off) chan_merge(n, mean, m2, nb, mb, qb);
  }
  if (lane == 0) {
    const float var = m2 / n;
    float* st = stats + (size_t)(gi * kCout + o) * 3;
    st[0] = mean;
    st[1] = 1.f / sqrtf(var + kEps);
    st[2] = var;
  }
}

// y of one tile: conv of cells [i0-1, i0+8) x [j0-1, j0+8), BN, ReLU, then
// the pool (as the inference stem, csrc/stem_s2d.cu).  A halo cell outside
// the image stores 0: every pooled window also holds a real ReLU output,
// which is >= 0, so a 0 never changes the max.
__global__ void __launch_bounds__(kThreads)
stem_fwd_emit_kernel(const uint8_t* __restrict__ x,
                     const float* __restrict__ w,
                     const float* __restrict__ gamma,
                     const float* __restrict__ beta,
                     const float* __restrict__ stats, float* __restrict__ y,
                     const Geo geo) {
  constexpr int kCR = kT + 1, kCC = kT + 1, kCells = kCR * kCC;
  __shared__ float s_w[kNW];
  __shared__ float s_mu[kCout], s_sg[kCout], s_beta[kCout];
  __shared__ uint8_t s_in[48 * (kT + 2) * (kT + 2)];
  __shared__ float s_conv[4][kCout][kCells];
  const int b = blockIdx.y, tile = blockIdx.x;
  const int ty = tile / geo.ntx, tx = tile - ty * geo.ntx;
  const int i0 = ty * kT, j0 = tx * kT;
  const int tid = threadIdx.x;
  load_weights(w, s_w);
  load_cells<kT + 2, kT + 2>(x + (size_t)b * 48 * geo.npad, s_in, i0 - 2,
                             j0 - 2, geo);
  if (tid < kCout) {
    const float* st = stats + (size_t)((b / geo.g) * kCout + tid) * 3;
    s_mu[tid] = st[0];
    s_sg[tid] = st[1] * gamma[tid];
    s_beta[tid] = beta[tid];
  }
  __syncthreads();

  // a barrier ends each round: without it ptxas kept the 648 weights in
  // registers from one round to the next (255 registers, 2 KB of spills;
  // the forward took 21.9 ms at b128 352^2 on an H100 80GB HBM3 at 700 W,
  // 1.03 ms with the barrier); after it, each round reads them from
  // shared memory
  for (int base = 0; base < 4 * kCells; base += kThreads) {
    const int it = base + tid;
    if (it < 4 * kCells) {
      const int ph = it / kCells;
      const int cell = it - ph * kCells;
      const int cr = cell / kCC, cc = cell - cr * kCC;
      const int u = i0 - 1 + cr, v = j0 - 1 + cc;
      float acc[kCout];
      if (u >= 0 && v >= 0 && u < geo.h4 && v < geo.w4) {
        conv_cell<kT + 2, kT + 2>(s_in, s_w, cr + 1, cc + 1, ph >> 1,
                                  ph & 1, acc);
#pragma unroll
        for (int o = 0; o < kCout; ++o)
          acc[o] = fmaxf((acc[o] - s_mu[o]) * s_sg[o] + s_beta[o], 0.f);
      } else {
#pragma unroll
        for (int o = 0; o < kCout; ++o) acc[o] = 0.f;
      }
#pragma unroll
      for (int o = 0; o < kCout; ++o) s_conv[ph][o][cell] = acc[o];
    }
    __syncthreads();
  }

  float* yb = y + (size_t)b * kCout * geo.h4 * geo.w4;
  for (int it = tid; it < kCout * kT * kT; it += kThreads) {
    const int o = it / (kT * kT);
    const int cell = it - o * (kT * kT);
    const int pr = cell / kT, pc = cell - pr * kT;
    const int i = i0 + pr, j = j0 + pc;
    if (i >= geo.h4 || j >= geo.w4) continue;
    float r[2][2];                             // [px][conv column j-1, j]
#pragma unroll
    for (int px = 0; px < 2; ++px) {
#pragma unroll
      for (int dc = 0; dc < 2; ++dc) {
        const int col = pc + dc;
        const float up = s_conv[2 + px][o][pr * kCC + col];
        const float p0 = s_conv[px][o][(pr + 1) * kCC + col];
        const float p1 = s_conv[2 + px][o][(pr + 1) * kCC + col];
        r[px][dc] = fmaxf(fmaxf(p0, p1), up);
      }
    }
    yb[(size_t)o * geo.h4 * geo.w4 + i * geo.w4 + j] =
        fmaxf(fmaxf(r[0][1], r[1][1]), r[1][0]);
  }
}

// ------------------------------------------------------------ backward

// Region geometry of a backward tile with cells [i0, i0+8) x [j0, j0+8):
// conv cells [i0-1, i0+9) x [j0-1, j0+9) (10x10, "yb"), pooled cells
// [i0, i0+9) x [j0, j0+9) (9x9, "dz" and the routing codes), input cells
// [i0-2, i0+9) x [j0-2, j0+9) (11x11).
constexpr int kYR = kT + 2;                   // 10
constexpr int kYN = kYR * kYR;                // 100
constexpr int kPR = kT + 1;                   // 9
constexpr int kPN = kPR * kPR;                // 81
constexpr int kIR = kT + 3;                   // 11

struct BwdSmem {
  float w[kNW];
  float mu[kCout], sg[kCout], sinv[kCout], beta[kCout];
  float a[kCout], sgm[kCout], sgxm[kCout];    // du's factors (dw pass)
  float red[2][kCout][kWarps];
  float dz[kCout][kPN];
  float yb[4 * kCout * kYN];                  // [ph][co][cell]; du later
  uint8_t mcode[kCout][kPN];   // column winner: 0 = 2j, 1 = 2j+1, 2 = 2j-1
  uint8_t ecode[2][kCout][kPN];  // [px] row winner: 0 = 2i, 1 = 2i+1, 2 = 2i-1
  uint8_t in[48 * kIR * kIR];
};
static_assert(kCout * kDuStride <= 4 * kCout * kYN, "du fits in yb");

__device__ __forceinline__ void load_bn(BwdSmem& S,
                                        const float* __restrict__ stats,
                                        const float* __restrict__ gamma,
                                        const float* __restrict__ beta,
                                        int gi) {
  const int t = threadIdx.x;
  if (t < kCout) {
    const float* st = stats + (size_t)(gi * kCout + t) * 3;
    S.mu[t] = st[0];
    S.sinv[t] = st[1];
    S.sg[t] = st[1] * gamma[t];
    S.beta[t] = beta[t];
  }
}

// dR_px at pooled region cell p (JAX's dR0 / dR1: dR1 also takes the
// 2j-1 winners of the cell to the right, p + 1)
__device__ __forceinline__ float routed(const BwdSmem& S, int px, int o,
                                        int p) {
  if (px == 0) return S.mcode[o][p] == 0 ? S.dz[o][p] : 0.f;
  const float a = S.mcode[o][p] == 1 ? S.dz[o][p] : 0.f;
  const float b = S.mcode[o][p + 1] == 2 ? S.dz[o][p + 1] : 0.f;
  return a + b;
}

// Recompute a tile, route its pooled cotangent, apply the ReLU mask: gy
// and xhat of this thread's tile item (phase tid>>6, cell tid&63), both 0
// for a cell outside the image.  Starts by overwriting S.in and S.dz, so
// the caller syncs before it if they are still being read.
__device__ __forceinline__ void tile_gy(BwdSmem& S,
                                        const uint8_t* __restrict__ xb,
                                        const float* __restrict__ dyb,
                                        int i0, int j0, const Geo& geo,
                                        float gy[kCout], float xh[kCout]) {
  const int tid = threadIdx.x;
  load_cells<kIR, kIR>(xb, S.in, i0 - 2, j0 - 2, geo);
  for (int it = tid; it < kCout * kPN; it += kThreads) {
    const int o = it / kPN, p = it - o * kPN;
    const int i = i0 + p / kPR, j = j0 + p % kPR;
    S.dz[o][p] = (i < geo.h4 && j < geo.w4)
                     ? dyb[((size_t)o * geo.h4 + i) * geo.w4 + j] : 0.f;
  }
  __syncthreads();

  // conv + BN + ReLU of the 10x10 region: first this thread's tile item
  // (keeping xhat), then the 144 halo items; -inf outside the image (the
  // pool's pad, never a winner)
  const int ph = tid >> 6, cell = tid & 63;
  const int cr = cell >> 3, cc = cell & 7;
  const bool valid = i0 + cr < geo.h4 && j0 + cc < geo.w4;
  {
    float u[kCout];
    conv_cell<kIR, kIR>(S.in, S.w, cr + 2, cc + 2, ph >> 1, ph & 1, u);
    float* ybp = S.yb + ph * kCout * kYN + (cr + 1) * kYR + (cc + 1);
#pragma unroll
    for (int o = 0; o < kCout; ++o) {
      const float d = u[o] - S.mu[o];
      const float bn = d * S.sg[o] + S.beta[o];
      xh[o] = valid ? d * S.sinv[o] : 0.f;
      ybp[o * kYN] = valid ? fmaxf(bn, 0.f) : neg_inf();
    }
  }
  for (int it = tid; it < 4 * 36; it += kThreads) {
    const int hph = it / 36, k = it - hph * 36;
    int r, c;                                  // the ring of the 10x10
    if (k < 10) {
      r = 0; c = k;
    } else if (k < 20) {
      r = 9; c = k - 10;
    } else if (k < 28) {
      r = k - 19; c = 0;
    } else {
      r = k - 27; c = 9;
    }
    const int u = i0 - 1 + r, v = j0 - 1 + c;
    float val[kCout];
    if (u >= 0 && v >= 0 && u < geo.h4 && v < geo.w4) {
      conv_cell<kIR, kIR>(S.in, S.w, r + 1, c + 1, hph >> 1, hph & 1, val);
#pragma unroll
      for (int o = 0; o < kCout; ++o)
        val[o] = fmaxf((val[o] - S.mu[o]) * S.sg[o] + S.beta[o], 0.f);
    } else {
#pragma unroll
      for (int o = 0; o < kCout; ++o) val[o] = neg_inf();
    }
    float* ybp = S.yb + hph * kCout * kYN + r * kYR + c;
#pragma unroll
    for (int o = 0; o < kCout; ++o) ybp[o * kYN] = val[o];
  }
  __syncthreads();

  // the pool's winners at each pooled cell of the 9x9 region
  for (int it = tid; it < kCout * kPN; it += kThreads) {
    const int o = it / kPN, p = it - o * kPN;
    const int pr = p / kPR, pc = p - pr * kPR;
    if (i0 + pr >= geo.h4 || j0 + pc >= geo.w4) {
      S.mcode[o][p] = 3;
      S.ecode[0][o][p] = 3;
      S.ecode[1][o][p] = 3;
      continue;
    }
    const int here = (pr + 1) * kYR + pc + 1, up = pr * kYR + pc + 1;
    const int left = here - 1, upleft = up - 1;
    const float* Y = S.yb + o * kYN;           // phase k at Y + k*kCout*kYN
    constexpr int P = kCout * kYN;
    float R[2];
#pragma unroll
    for (int px = 0; px < 2; ++px) {
      const float c0 = Y[px * P + here];       // row 2i
      const float c1 = Y[(2 + px) * P + here]; // row 2i+1
      const float c2 = Y[(2 + px) * P + up];   // row 2i-1
      R[px] = fmaxf(fmaxf(c0, c1), c2);
      S.ecode[px][o][p] = c0 == R[px] ? 0 : (c1 == R[px] ? 1 : 2);
    }
    const float t2 = fmaxf(fmaxf(Y[P + left], Y[3 * P + left]),
                           Y[3 * P + upleft]);  // column 2j-1
    const float out = fmaxf(fmaxf(R[0], R[1]), t2);
    S.mcode[o][p] = R[0] == out ? 0 : (R[1] == out ? 1 : 2);
  }
  __syncthreads();

  // gather: conv output (2u+py, 2v+px) of the tile takes dR_px of pooled
  // cell u (as row 2u+py) and, for py = 1, of pooled cell u+1 (as its row
  // 2(u+1)-1)
  const int py = ph >> 1, px = ph & 1;
  const int p = cr * kPR + cc;
  const float* ybp = S.yb + ph * kCout * kYN + (cr + 1) * kYR + (cc + 1);
#pragma unroll
  for (int o = 0; o < kCout; ++o) {
    float gv;
    if (py == 0) {
      gv = S.ecode[px][o][p] == 0 ? routed(S, px, o, p) : 0.f;
    } else {
      const float a = S.ecode[px][o][p] == 1 ? routed(S, px, o, p) : 0.f;
      const float b = S.ecode[px][o][p + kPR] == 2
                          ? routed(S, px, o, p + kPR) : 0.f;
      gv = a + b;
    }
    gy[o] = ybp[o * kYN] > 0.f ? gv : 0.f;     // -inf outside: 0
  }
}

// Per tile and channel: Sg and Sgx.  part[(b*ntiles + tile)*48 + co*2 +
// {0: Sg, 1: Sgx}].
__global__ void __launch_bounds__(kThreads)
stem_bwd_sums_kernel(const float* __restrict__ dy,
                     const uint8_t* __restrict__ x,
                     const float* __restrict__ stats,
                     const float* __restrict__ w,
                     const float* __restrict__ gamma,
                     const float* __restrict__ beta,
                     float* __restrict__ part, const Geo geo) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  BwdSmem& S = *reinterpret_cast<BwdSmem*>(smem_raw);
  const int b = blockIdx.y, tile = blockIdx.x;
  const int ty = tile / geo.ntx, tx = tile - ty * geo.ntx;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  load_weights(w, S.w);
  load_bn(S, stats, gamma, beta, b / geo.g);
  float gy[kCout], xh[kCout];
  tile_gy(S, x + (size_t)b * 48 * geo.npad,
          dy + (size_t)b * kCout * geo.h4 * geo.w4, ty * kT, tx * kT, geo,
          gy, xh);
#pragma unroll
  for (int o = 0; o < kCout; ++o) {
    const float s1 = warp_sum(gy[o]);
    const float s2 = warp_sum(gy[o] * xh[o]);
    if (lane == 0) {
      S.red[0][o][warp] = s1;
      S.red[1][o][warp] = s2;
    }
  }
  __syncthreads();
  if (tid < 2 * kCout) {
    const int k = tid / kCout, o = tid - k * kCout;
    float s = 0.f;
    for (int q = 0; q < kWarps; ++q) s = s + S.red[k][o][q];
    part[((size_t)b * geo.ntx * geo.nty + tile) * (2 * kCout) + 2 * o + k] =
        s;
  }
}

// One warp per (group, channel): Sg and Sgx of the group, fixed order ->
// gsum[(gi*24 + co)*2 + {0: Sg, 1: Sgx}].
__global__ void __launch_bounds__(kThreads)
stem_sums_combine_kernel(const float* __restrict__ part,
                         float* __restrict__ gsum, const Geo geo,
                         int ngroups) {
  const int wid = (blockIdx.x * kThreads + threadIdx.x) >> 5;
  const int lane = threadIdx.x & 31;
  if (wid >= ngroups * kCout) return;
  const int gi = wid / kCout, o = wid - gi * kCout;
  const int ntiles = geo.ntx * geo.nty;
  const int nitems = geo.g * ntiles;
  float s1 = 0.f, s2 = 0.f;
  for (int k = lane; k < nitems; k += 32) {
    const float* p = part + ((size_t)gi * nitems + k) * (2 * kCout) + 2 * o;
    s1 = s1 + p[0];
    s2 = s2 + p[1];
  }
  s1 = warp_sum(s1);
  s2 = warp_sum(s2);
  if (lane == 0) {
    gsum[(size_t)(gi * kCout + o) * 2] = s1;
    gsum[(size_t)(gi * kCout + o) * 2 + 1] = s2;
  }
}

// One CTA per (row band of tiles, image): du of each tile, and the band's
// dW partial wpart[(b*nty + ty)*648 + OIHW index].  Thread t < 216 owns
// tap (ky, kx) = t / 24 and channel t % 24, for the 3 input channels.
__global__ void __launch_bounds__(kThreads)
stem_bwd_dw_kernel(const float* __restrict__ dy,
                   const uint8_t* __restrict__ x,
                   const float* __restrict__ stats,
                   const float* __restrict__ gsum,
                   const float* __restrict__ w,
                   const float* __restrict__ gamma,
                   const float* __restrict__ beta,
                   float* __restrict__ wpart, const Geo geo, float inv_m) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  BwdSmem& S = *reinterpret_cast<BwdSmem*>(smem_raw);
  const int b = blockIdx.y, ty = blockIdx.x;
  const int tid = threadIdx.x;
  const int gi = b / geo.g;
  load_weights(w, S.w);
  load_bn(S, stats, gamma, beta, gi);
  if (tid < kCout) {
    const float* gs = gsum + (size_t)(gi * kCout + tid) * 2;
    S.a[tid] = gamma[tid] * S.sinv[tid];      // load_bn's, same thread
    S.sgm[tid] = gs[0] * inv_m;
    S.sgxm[tid] = gs[1] * inv_m;
  }
  const uint8_t* xb = x + (size_t)b * 48 * geo.npad;
  const float* dyb = dy + (size_t)b * kCout * geo.h4 * geo.w4;
  const int kk = tid / kCout, co = tid - kk * kCout;
  const int ky = kk / 3, kx = kk - ky * 3;
  float acc[3] = {0.f, 0.f, 0.f};
  float* du = S.yb;                            // [co][item], row kDuStride
  for (int tx = 0; tx < geo.ntx; ++tx) {
    __syncthreads();                           // the last tile's reads
    float gy[kCout], xh[kCout];
    tile_gy(S, xb, dyb, ty * kT, tx * kT, geo, gy, xh);
    const int cell = tid & 63;
    const bool valid =
        ty * kT + (cell >> 3) < geo.h4 && tx * kT + (cell & 7) < geo.w4;
    __syncthreads();                           // yb is read no more
#pragma unroll
    for (int o = 0; o < kCout; ++o)
      du[o * kDuStride + tid] =
          valid ? S.a[o] * ((gy[o] - S.sgm[o]) - xh[o] * S.sgxm[o]) : 0.f;
    __syncthreads();
    if (tid < 9 * kCout) {
      for (int item = 0; item < 4 * kT * kT; ++item) {
        const int iph = item >> 6, icell = item & 63;
        const int ro = 2 * (iph >> 1) + ky - 1;
        const int cof = 2 * (iph & 1) + kx - 1;
        const int sr = (icell >> 3) + (ro < 0 ? 1 : 2);
        const int sc = (icell & 7) + (cof < 0 ? 1 : 2);
        const int yoff = ro < 0 ? 3 : ro, xoff = cof < 0 ? 3 : cof;
        const uint8_t* xin =
            S.in + (yoff * 12 + xoff * 3) * (kIR * kIR) + sr * kIR + sc;
        const float d = du[co * kDuStride + item];
        acc[0] = acc[0] + d * (float)xin[0];
        acc[1] = acc[1] + d * (float)xin[kIR * kIR];
        acc[2] = acc[2] + d * (float)xin[2 * kIR * kIR];
      }
    }
  }
  if (tid < 9 * kCout) {
    float* pw = wpart + ((size_t)b * geo.nty + ty) * kNW + co * kTaps + kk;
    pw[0] = acc[0];
    pw[9] = acc[1];
    pw[18] = acc[2];
  }
}

// CTA k < 648: dW[k] = sum of the nparts band partials, in order of the
// bands; k in [648, 672): dgamma = the groups' Sgx; [672, 696): dbeta =
// their Sg.
__global__ void __launch_bounds__(kThreads)
stem_bwd_reduce_kernel(const float* __restrict__ wpart, int nparts,
                       const float* __restrict__ gsum, int ngroups,
                       float* __restrict__ dw, float* __restrict__ dgamma,
                       float* __restrict__ dbeta) {
  __shared__ float s_red[kWarps];
  const int k = blockIdx.x, tid = threadIdx.x;
  float s = 0.f;
  if (k < kNW) {
    for (int r = tid; r < nparts; r += kThreads)
      s = s + wpart[(size_t)r * kNW + k];
  } else {
    const int which = (k - kNW) / kCout, o = (k - kNW) - which * kCout;
    for (int gi = tid; gi < ngroups; gi += kThreads)
      s = s + gsum[(size_t)(gi * kCout + o) * 2 + (which == 0 ? 1 : 0)];
  }
  s = warp_sum(s);
  if ((tid & 31) == 0) s_red[tid >> 5] = s;
  __syncthreads();
  if (tid == 0) {
    float t = 0.f;
    for (int q = 0; q < kWarps; ++q) t = t + s_red[q];
    if (k < kNW) {
      dw[k] = t;
    } else if (k < kNW + kCout) {
      dgamma[k - kNW] = t;
    } else {
      dbeta[k - kNW - kCout] = t;
    }
  }
}

bool geo_ok(int b, int h4, int w4, int npad, int g) {
  return b >= 1 && b <= 65535 && h4 >= 1 && w4 >= 1 && npad >= h4 * w4 &&
         g >= 1 && b % g == 0;
}

Geo make_geo(int h4, int w4, int npad, int g) {
  return Geo{h4, w4, npad, (w4 + kT - 1) / kT, (h4 + kT - 1) / kT, g};
}

}  // namespace

extern "C" {

// floats of scratch for the forward: the per-tile (mean, M2)
size_t fastdet_stem_train_fwd_scratch(int b, int h4, int w4) {
  const Geo geo = make_geo(h4, w4, h4 * w4, 1);
  return (size_t)b * geo.ntx * geo.nty * 2 * kCout;
}

// x (B, 48, npad) u8, w (24,3,3,3) f32 (scaled), gamma/beta (24) f32 ->
// y (B, 24, h4, w4) f32, stats (B/g, 24, 3) f32; all on the card.
// Returns a cudaError_t (0 = launched).
int fastdet_stem_train_fwd(const uint8_t* x, const float* w,
                           const float* gamma, const float* beta, float* y,
                           float* stats, float* scratch, int b, int h4,
                           int w4, int npad, int g, void* stream) {
  if (!geo_ok(b, h4, w4, npad, g)) return (int)cudaErrorInvalidValue;
  const cudaStream_t st = (cudaStream_t)stream;
  const Geo geo = make_geo(h4, w4, npad, g);
  const int ntiles = geo.ntx * geo.nty, ngroups = b / g;
  stem_fwd_stats_kernel<<<dim3(ntiles, b), kThreads, 0, st>>>(x, w, scratch,
                                                             geo);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  stem_stats_combine_kernel<<<(ngroups * kCout * 32 + kThreads - 1) /
                                  kThreads,
                              kThreads, 0, st>>>(scratch, stats, geo,
                                                 ngroups);
  e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  stem_fwd_emit_kernel<<<dim3(ntiles, b), kThreads, 0, st>>>(
      x, w, gamma, beta, stats, y, geo);
  return (int)cudaGetLastError();
}

// floats of scratch for the backward: per-tile sums, per-group sums, the
// bands' dW partials
size_t fastdet_stem_train_bwd_scratch(int b, int h4, int w4, int g) {
  const Geo geo = make_geo(h4, w4, h4 * w4, g);
  return (size_t)b * geo.ntx * geo.nty * 2 * kCout +
         (size_t)(b / g) * 2 * kCout + (size_t)b * geo.nty * kNW;
}

// dy (B, 24, h4, w4) f32, x, stats (B/g, 24, 3), w, gamma, beta -> dw
// (24,3,3,3), dgamma (24), dbeta (24) f32; all on the card.
int fastdet_stem_train_bwd(const float* dy, const uint8_t* x,
                           const float* stats, const float* w,
                           const float* gamma, const float* beta, float* dw,
                           float* dgamma, float* dbeta, float* scratch,
                           int b, int h4, int w4, int npad, int g,
                           void* stream) {
  if (!geo_ok(b, h4, w4, npad, g)) return (int)cudaErrorInvalidValue;
  const cudaStream_t st = (cudaStream_t)stream;
  const Geo geo = make_geo(h4, w4, npad, g);
  const int ntiles = geo.ntx * geo.nty, ngroups = b / g;
  float* part = scratch;
  float* gsum = part + (size_t)b * ntiles * 2 * kCout;
  float* wpart = gsum + (size_t)ngroups * 2 * kCout;
  const int smem = (int)sizeof(BwdSmem);
  cudaError_t e = cudaFuncSetAttribute(
      stem_bwd_sums_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      smem);
  if (e != cudaSuccess) return (int)e;
  e = cudaFuncSetAttribute(stem_bwd_dw_kernel,
                           cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return (int)e;
  stem_bwd_sums_kernel<<<dim3(ntiles, b), kThreads, smem, st>>>(
      dy, x, stats, w, gamma, beta, part, geo);
  e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  stem_sums_combine_kernel<<<(ngroups * kCout * 32 + kThreads - 1) /
                                 kThreads,
                             kThreads, 0, st>>>(part, gsum, geo, ngroups);
  e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  const float inv_m = (float)(1.0 / ((double)g * 4.0 * h4 * w4));
  stem_bwd_dw_kernel<<<dim3(geo.nty, b), kThreads, smem, st>>>(
      dy, x, stats, gsum, w, gamma, beta, wpart, geo, inv_m);
  e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  stem_bwd_reduce_kernel<<<kNW + 2 * kCout, kThreads, 0, st>>>(
      wpart, b * geo.nty, gsum, ngroups, dw, dgamma, dbeta);
  return (int)cudaGetLastError();
}

const char* fastdet_cuda_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
