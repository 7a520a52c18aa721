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
//       bn = (u - mu)*(sinv*gamma) + beta in BOTH directions;
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
// stats, Sg, Sgx, dW) differ only in their order, and those may use an
// explicit fused multiply-add (__fmaf_rn).
//
// What bounds it on this card: operations.  One conv sweep at 352^2 is
// 176^2*24 outputs x 27 MACs = 40.1 MFLOP per image against 0.37 MB of
// uint8 in; under --fmad=false each MAC is two FP32 instructions, so one
// sweep at b128 is 5.14 G instructions, 0.153 ms at the FP32 instruction
// rate.
// The design sweeps the conv once in each direction, plus halos, from two
// exact identities:
//  1. Pool before BN.  Each rounded step of bn(u) and of ReLU is monotone
//     in u (non-decreasing where gamma >= 0, non-increasing where gamma <
//     0), so maxpool(ReLU(bn(u))) == ReLU(bn(z)) bit for bit, with z the
//     3x3 s2 max-pool of the raw u where gamma >= 0 and its min-pool where
//     gamma < 0.  The forward pools the raw u inside the sweep that also
//     takes the tile moments (the weights of a gamma < 0 channel are
//     negated in shared memory, which negates u exactly, so one max serves
//     both), writes z (kept for the backward), and a last pass over z
//     gives y once the group's stats are merged.
//  2. Sg and Sgx from (dy, z).  A pool winner passes dy on, and the ReLU
//     mask keeps it where y > 0, so Sg = sum dy*[bn(z) > 0] and Sgx = sum
//     dy*[bn(z) > 0]*(z - mu)*sinv over the pooled cells (exact up to
//     ties of bn between different u, which move Sgx by rounding noise).
//     Those feed du.  Where gamma = 0 BN is constant, every window member
//     ties and z is not the winner, but du = 0 there; dgamma and dbeta
//     are therefore taken from the routed gy of the backward's one sweep,
//     which recomputes u, routes dy, forms du and accumulates dW.
// Launches (stem_train_plan in kernels/stem_train.py states them):
//   forward:  sweep   (row bands of up to 11 cell rows; a warp owns 31 cell
//                      columns for 6 channels and takes the pool's column
//                      2j-1 by shuffle: conv, raw pool -> z, band moments)
//             combine (Chan merge per group, fixed order -> stats)
//             emit    (y = ReLU(bn(z)) per (image, channel) plane)
//   backward: sums    (Sg, Sgx per (image, channel) from dy and z)
//             sweep   (one CTA per row band of 8x8-cell tiles, each tile
//                      owning its 64 windows: recompute the tile and a
//                      33-output halo, route dy, du, register-tiled dW
//                      partial and the routed Sg, Sgx partials)
//             reduce  (dW, dgamma, dbeta over the bands, fixed order)
// No atomics: two runs give the same bits.  The direct 27-tap conv on CUDA
// cores (the TPU kernel's (192, 96) phase matrix is 86% zeros, there only
// for the MXU); weights in shared memory, [tap][channel].  A thread
// computes the four phases of one cell for six channels, so a tap's
// weights are one broadcast read (three float2) for 24 multiply-adds and
// its four input bytes: at a thread per output and 24 channels the
// broadcast weight reads held the shared-memory pipe, not the FP32 units
// (chip runs of this design, PERF.md section 6).
//
// The bf16 form (the Pallas kernels at dtype=bfloat16) has a design of its
// own, csrc/stem16_train.cu.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kCout = 24;
constexpr int kTaps = 27;
constexpr int kNW = kTaps * kCout;   // 648 weights
constexpr float kEps = 1e-5f;
constexpr unsigned kFull = 0xffffffffu;

__device__ __forceinline__ float neg_inf() { return __int_as_float(0xff800000); }

// lane 0 gets the warp's sum (a fixed tree)
__device__ __forceinline__ float warp_sum(float v) {
  for (int o = 16; o > 0; o >>= 1) v = v + __shfl_down_sync(kFull, v, o);
  return v;
}

// OIHW (24, 3, 3, 3) -> s_w[((ky*3 + kx)*3 + c)*24 + co], each channel's
// weights times sgn[co] (+1 or -1: exact); one
// division per thread
__device__ __forceinline__ void load_weights(const float* __restrict__ w,
                                             float* s_w, const float* sgn) {
  for (int t = threadIdx.x; t < 9 * kCout; t += blockDim.x) {
    const int co = t / 9, kk = t - co * 9;         // kk = ky*3 + kx
    const float s = sgn ? sgn[co] : 1.f;
#pragma unroll
    for (int c = 0; c < 3; ++c)
      s_w[(kk * 3 + c) * kCout + co] = s * w[co * kTaps + c * 9 + kk];
  }
}

// 4 bytes global -> shared without a register round trip (cp.async); 0
// where !valid (src-size 0: nothing read).  Every load of a prologue is in
// flight at once, and one wait ends them.
__device__ __forceinline__ void cp_async4(void* dst, const void* src,
                                          bool valid) {
  const unsigned d = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(d),
               "l"(src), "r"(valid ? 4 : 0));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

// wait until at most N of this thread's committed groups are in flight
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
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

// NCH consecutive weights of one tap (a broadcast read: every lane of the
// warp reads the same address), as float4 where NCH allows, else float2
template <int NCH>
__device__ __forceinline__ void load_tap_weights(const float* w,
                                                 float (&wv)[NCH]) {
  if constexpr (NCH % 4 == 0) {
#pragma unroll
    for (int q = 0; q < NCH / 4; ++q) {
      const float4 f = reinterpret_cast<const float4*>(w)[q];
      wv[4 * q] = f.x;
      wv[4 * q + 1] = f.y;
      wv[4 * q + 2] = f.z;
      wv[4 * q + 3] = f.w;
    }
  } else {
#pragma unroll
    for (int q = 0; q < NCH / 2; ++q) {
      const float2 f = reinterpret_cast<const float2*>(w)[q];
      wv[2 * q] = f.x;
      wv[2 * q + 1] = f.y;
    }
  }
}

// the conv of phases PH0..PH1 of one s2d cell (u[ph - PH0]), NCH output
// channels: `in` points at plane 0 of the cell in shared memory (planes PS
// bytes apart, rows RS), `wt` at the first channel's weight of tap 0 (taps
// 24 floats apart).  Conv output (2u+py, 2v+px) reads image rows
// 4u + 2py + ky - 1: offset -1 is yoff 3 of cell u-1, offsets 0..3 are
// yoff 0..3 of cell u; columns likewise.  Every offset is a compile-time
// constant.
template <int NCH, int PH0, int PH1, int PS, int RS>
__device__ __forceinline__ void conv_cell(const uint8_t* __restrict__ in,
                                          const float* __restrict__ wt,
                                          float (&u)[PH1 - PH0 + 1][NCH]) {
  static_assert(NCH % 2 == 0, "float2 or float4 weight reads");
#pragma unroll
  for (int ph = PH0; ph <= PH1; ++ph)
#pragma unroll
    for (int o = 0; o < NCH; ++o) u[ph - PH0][o] = 0.f;
#pragma unroll
  for (int ky = 0; ky < 3; ++ky) {
#pragma unroll
    for (int kx = 0; kx < 3; ++kx) {
#pragma unroll
      for (int c = 0; c < 3; ++c) {
        float wv[NCH];
        load_tap_weights<NCH>(wt + ((ky * 3 + kx) * 3 + c) * kCout, wv);
#pragma unroll
        for (int ph = PH0; ph <= PH1; ++ph) {
          const int ro = 2 * (ph >> 1) + ky - 1;
          const int cof = 2 * (ph & 1) + kx - 1;
          const int off = ((ro & 3) * 12 + (cof & 3) * 3 + c) * PS +
                          (ro < 0 ? -RS : 0) + (cof < 0 ? -1 : 0);
          const float v = (float)in[off];
#pragma unroll
          for (int o = 0; o < NCH; ++o)
            u[ph - PH0][o] = u[ph - PH0][o] + v * wv[o];
        }
      }
    }
  }
}

// ------------------------------------------------------------ forward

// The sweep's tile: a band of up to kFR cell rows and, per warp, 31 cell
// columns (lane 0 is the column to the left, computed again so that the
// pool's column 2j-1 comes by shuffle); ncw <= 3 warps across (93
// columns), kFGroups channel groups of kFCH each, so at most kFMaxThreads
// threads.  The input rows i0-1 .. i0+rows-1 sit in shared memory, row
// stride kFRS, plane stride kFPS; column j at byte j - c0 + 4.
constexpr int kFR = 11;
constexpr int kFWarpCols = 31;
constexpr int kFRS = 100;                   // >= 3*31 + 4, whole words
constexpr int kFPS = (kFR + 1) * kFRS;      // 1200
constexpr int kFCH = 6;
constexpr int kFGroups = kCout / kFCH;
constexpr int kFMaxWarps = 3 * kFGroups;
constexpr int kFMaxThreads = 32 * kFMaxWarps;
constexpr size_t kFwdSmem =
    (size_t)(kNW + kCout + kFMaxWarps * kFCH * 3) * sizeof(float) +
    48 * kFPS;

struct FwdGeo {
  int h4, w4, npad, g, tr, ncw, nchunk, nband;
};

// Per tile (band, chunk) and channel: the mean and M2 of its conv outputs
// -> part[(b*ntiles + tile)*48 + co*2 + {0: mean, 1: M2}]; the pooled raw
// extreme -> z (B, 24, h4, w4).
__global__ void __launch_bounds__(kFMaxThreads, 2)
stem_fwd_sweep_kernel(const uint8_t* __restrict__ x,
                      const float* __restrict__ w,
                      const float* __restrict__ gamma,
                      float* __restrict__ z, float* __restrict__ part,
                      const FwdGeo geo, int words) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  float* s_w = reinterpret_cast<float*>(smem_raw);
  float* s_sgn = s_w + kNW;
  float* s_mom = s_sgn + kCout;                     // [warp][kFCH][3]
  uint8_t* s_in = reinterpret_cast<uint8_t*>(s_mom + kFMaxWarps * kFCH * 3);
  const int b = blockIdx.y;
  const int band = blockIdx.x / geo.nchunk;
  const int chunk = blockIdx.x - band * geo.nchunk;
  const int i0 = band * geo.tr, c0 = chunk * geo.ncw * kFWarpCols;
  const int rows = min(geo.tr, geo.h4 - i0);
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int nwarps = blockDim.x >> 5;

  if (tid < kCout) s_sgn[tid] = gamma[tid] < 0.f ? -1.f : 1.f;
  __syncthreads();
  load_weights(w, s_w, s_sgn);
  // input rows i0-1 .. i0+rows-1 (0 outside the image), a warp per (plane,
  // row): 4-byte cp.async words where the caller found them aligned, all
  // in flight at once; else bytes
  const uint8_t* xb = x + (size_t)b * 48 * geo.npad;
  for (int pr = warp; pr < 48 * (rows + 1); pr += nwarps) {
    const int plane = pr / (rows + 1), r = pr - plane * (rows + 1);
    const int i = i0 - 1 + r;
    uint8_t* dst = s_in + plane * kFPS + r * kFRS;
    const bool in_img = i >= 0 && i < geo.h4;
    const uint8_t* src = xb + (size_t)plane * geo.npad + (size_t)i * geo.w4;
    if (words) {
      for (int k = lane; k < kFRS / 4; k += 32) {
        const int j = c0 - 4 + 4 * k;
        const bool ok = in_img && j >= 0 && j < geo.w4;
        cp_async4(dst + 4 * k, ok ? src + j : xb, ok);
      }
    } else {
      for (int k = lane; k < kFRS; k += 32) {
        const int j = c0 - 4 + k;
        dst[k] = (in_img && j >= 0 && j < geo.w4) ? src[j] : (uint8_t)0;
      }
    }
  }
  cp_async_commit();
  cp_async_wait<0>();
  __syncthreads();

  const int cw = warp % geo.ncw, grp = warp / geo.ncw;   // channel group
  const int j = c0 + cw * kFWarpCols - 1 + lane;
  const bool jvalid = j >= 0 && j < geo.w4;
  const bool owned = lane > 0 && jvalid;
  const uint8_t* in = s_in + (cw * kFWarpCols + lane + 3);   // column j
  const float* wt = s_w + grp * kFCH;
  float u[4][kFCH];
  float p10[kFCH], p11[kFCH];          // row 2i-1: phases (1,0), (1,1) above
  if (i0 > 0) {
    float uh[2][kFCH];
    conv_cell<kFCH, 2, 3, kFPS, kFRS>(in, wt, uh);
#pragma unroll
    for (int o = 0; o < kFCH; ++o) {
      p10[o] = jvalid ? uh[0][o] : neg_inf();
      p11[o] = jvalid ? uh[1][o] : neg_inf();
    }
  } else {
#pragma unroll
    for (int o = 0; o < kFCH; ++o) p10[o] = p11[o] = neg_inf();
  }
  float K[kFCH], s1[kFCH], s2[kFCH];
#pragma unroll
  for (int o = 0; o < kFCH; ++o) s1[o] = s2[o] = 0.f;
  const size_t hw = (size_t)geo.h4 * geo.w4;
  float* zb = z + ((size_t)b * kCout + grp * kFCH) * hw;
  for (int r = 1; r <= rows; ++r) {
    conv_cell<kFCH, 0, 3, kFPS, kFRS>(in + r * kFRS, wt, u);
    if (r == 1) {                             // the shift: a first value
#pragma unroll
      for (int o = 0; o < kFCH; ++o) K[o] = owned ? u[0][o] : 0.f;
    }
    float* zr = zb + (size_t)(i0 + r - 1) * geo.w4 + j;
#pragma unroll
    for (int o = 0; o < kFCH; ++o) {
      float v[4];
#pragma unroll
      for (int ph = 0; ph < 4; ++ph) v[ph] = jvalid ? u[ph][o] : neg_inf();
      // the window's columns 2j (px 0) and 2j+1 (px 1) over rows 2i-1..2i+1
      const float c0v = fmaxf(fmaxf(p10[o], v[0]), v[2]);
      const float c1v = fmaxf(fmaxf(p11[o], v[1]), v[3]);
      const float left = __shfl_up_sync(kFull, c1v, 1);   // column 2j-1
      const float zz = fmaxf(fmaxf(c0v, c1v), left);
      if (owned) zr[(size_t)o * hw] = s_sgn[grp * kFCH + o] * zz;
#pragma unroll
      for (int ph = 0; ph < 4; ++ph) {
        const float d = owned ? v[ph] - K[o] : 0.f;
        s1[o] = s1[o] + d;
        s2[o] = __fmaf_rn(d, d, s2[o]);
      }
      p10[o] = v[2];
      p11[o] = v[3];
    }
  }
  // the thread's (n, mean, M2) per channel (shifted sums), merged over the
  // warp by a fixed shuffle tree, then over the column warps in order
  const float n0 = owned ? (float)(4 * rows) : 0.f;
#pragma unroll
  for (int o = 0; o < kFCH; ++o) {
    float n = n0, mean = 0.f, m2 = 0.f;
    if (owned) {
      const float q = s1[o] / n;
      mean = K[o] + q;
      m2 = fmaxf(s2[o] - s1[o] * q, 0.f);
    }
    for (int off = 16; off > 0; off >>= 1) {
      const float nb = __shfl_down_sync(kFull, n, off);
      const float mb = __shfl_down_sync(kFull, mean, off);
      const float qb = __shfl_down_sync(kFull, m2, off);
      if (lane < off) chan_merge(n, mean, m2, nb, mb, qb);
    }
    if (lane == 0) {
      float* m = s_mom + (warp * kFCH + o) * 3;
      m[0] = n;
      m[1] = mean;
      m[2] = m2;
    }
  }
  __syncthreads();
  if (tid < kCout) {
    const int h = tid / kFCH, o = tid - h * kFCH;
    float n = 0.f, mean = 0.f, m2 = 0.f;
    for (int k = 0; k < geo.ncw; ++k) {
      const float* m = s_mom + ((h * geo.ncw + k) * kFCH + o) * 3;
      chan_merge(n, mean, m2, m[0], m[1], m[2]);
    }
    float* pb = part + ((size_t)b * geo.nband * geo.nchunk + blockIdx.x) *
                           (2 * kCout);
    pb[2 * tid] = s_sgn[tid] * mean;
    pb[2 * tid + 1] = m2;
  }
}

// One warp per (group, channel): the group's tiles merged in a fixed order
// -> stats[(gi*24 + co)*3 + {mu, sinv, var}].
__global__ void __launch_bounds__(256)
stem_stats_combine_kernel(const float* __restrict__ part,
                          float* __restrict__ stats, const FwdGeo geo,
                          int ngroups) {
  const int wid = (blockIdx.x * blockDim.x + threadIdx.x) >> 5;
  const int lane = threadIdx.x & 31;
  if (wid >= ngroups * kCout) return;          // uniform within the warp
  const int gi = wid / kCout, o = wid - gi * kCout;
  const int ntiles = geo.nband * geo.nchunk;
  const int nitems = geo.g * ntiles;
  const int cw = geo.ncw * kFWarpCols;
  float n = 0.f, mean = 0.f, m2 = 0.f;
  for (int k = lane; k < nitems; k += 32) {
    const int tile = k % ntiles;
    const int band = tile / geo.nchunk, chunk = tile - band * geo.nchunk;
    const float cnt = 4.f * min(geo.tr, geo.h4 - band * geo.tr) *
                      min(cw, geo.w4 - chunk * cw);
    const float* p = part + ((size_t)gi * nitems + k) * (2 * kCout) + 2 * o;
    chan_merge(n, mean, m2, cnt, p[0], p[1]);
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

// y = max((z - mu)*(sinv*gamma) + beta, 0), one CTA per (image, channel)
// plane; the pool already happened on z (identity 1).
__global__ void __launch_bounds__(256)
stem_fwd_emit_kernel(const float* __restrict__ z,
                     const float* __restrict__ gamma,
                     const float* __restrict__ beta,
                     const float* __restrict__ stats, float* __restrict__ y,
                     int hw, int g) {
  const int plane = blockIdx.x;
  const int b = plane / kCout, o = plane - b * kCout;
  const float* st = stats + (size_t)((b / g) * kCout + o) * 3;
  const float mu = st[0], sg = st[1] * gamma[o], bt = beta[o];
  const float* zp = z + (size_t)plane * hw;
  float* yp = y + (size_t)plane * hw;
  if ((hw & 3) == 0) {
    const float4* z4 = reinterpret_cast<const float4*>(zp);
    float4* y4 = reinterpret_cast<float4*>(yp);
    for (int k = threadIdx.x; k < hw / 4; k += blockDim.x) {
      const float4 v = z4[k];
      y4[k] = make_float4(fmaxf((v.x - mu) * sg + bt, 0.f),
                          fmaxf((v.y - mu) * sg + bt, 0.f),
                          fmaxf((v.z - mu) * sg + bt, 0.f),
                          fmaxf((v.w - mu) * sg + bt, 0.f));
    }
  } else {
    for (int k = threadIdx.x; k < hw; k += blockDim.x)
      yp[k] = fmaxf((zp[k] - mu) * sg + bt, 0.f);
  }
}

// ------------------------------------------------------------ backward

// Sg and Sgx of one (image, channel) plane from dy and z (identity 2):
// gpart[plane*2 + {0: Sg, 1: Sgx}], a fixed reduction order.
__global__ void __launch_bounds__(256)
stem_bwd_sums_kernel(const float* __restrict__ dy,
                     const float* __restrict__ z,
                     const float* __restrict__ stats,
                     const float* __restrict__ gamma,
                     const float* __restrict__ beta,
                     float* __restrict__ gpart, int hw, int g) {
  __shared__ float s_red[2][8];
  const int plane = blockIdx.x;
  const int b = plane / kCout, o = plane - b * kCout;
  const float* st = stats + (size_t)((b / g) * kCout + o) * 3;
  const float mu = st[0], sinv = st[1], sg = st[1] * gamma[o], bt = beta[o];
  const float* zp = z + (size_t)plane * hw;
  const float* dp = dy + (size_t)plane * hw;
  float a = 0.f, c = 0.f;
  for (int k = threadIdx.x; k < hw; k += blockDim.x) {
    const float d = zp[k] - mu;
    if (d * sg + bt > 0.f) {
      const float gv = dp[k];
      a = a + gv;
      c = __fmaf_rn(gv, d * sinv, c);
    }
  }
  a = warp_sum(a);
  c = warp_sum(c);
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  if (lane == 0) {
    s_red[0][warp] = a;
    s_red[1][warp] = c;
  }
  __syncthreads();
  if (threadIdx.x < 2) {
    float s = 0.f;
    for (int q = 0; q < (int)(blockDim.x >> 5); ++q)
      s = s + s_red[threadIdx.x][q];
    gpart[(size_t)plane * 2 + threadIdx.x] = s;
  }
}

// A backward tile owns the 8x8 windows (pooled cells) [i0, i0+8) x [j0,
// j0+8) of one image and routes their dy to the conv outputs under them:
// the tile's own 8x8 s2d cells, all four phases, and the halo the pool
// reaches to the top and left, phases py = 1 of the row above (the
// windows' row 2i-1), px = 1 of the column to the left (their column
// 2j-1) and the corner (1,1): 33 outputs for 256 (1.13 conv sweeps, as
// the forward's).  A conv output under windows of two tiles (the tile's
// last row or column, and the halo) gets a part of its gy from each, the
// plain version's sum split at one of its additions; du is linear in gy,
// so the tile that owns the output adds a*((gy_own - Sg/m) - xhat*Sgx/m)
// and the tile that has it as halo adds a*gy_halo, and the routed sums
// take both parts.  The routing codes themselves are those of the plain
// version, bit for bit.
// Region: cells [i0-1, i0+8) x [j0-1, j0+8) (9x9; "yb": ReLU(bn), -inf
// outside the image); input cells the same, each row in shared memory as
// the 16 bytes of columns j0-4 .. j0+11 (four aligned 4-byte cp.async
// words).  Window arrays (dz, the codes) have a border of windows that
// never win (code 3, dz 0): row and column index = window + 1.
constexpr int kBT = 8;
constexpr int kBThreads = 256;
constexpr int kBWarps = kBThreads / 32;
constexpr int kRN = kBT + 1;                  // 9
constexpr int kRC = kRN * kRN;                // 81: region cells, odd
constexpr int kWN = kBT + 2;                  // 10: windows with the border
constexpr int kWC = kWN * kWN;                // 100
constexpr int kIRS = 16;                      // input row stride (bytes)
constexpr int kIPS = kRN * kIRS;              // input plane stride (144)
constexpr int kIC0 = 3;                       // byte of column j0-1
constexpr int kOwn = 4 * kBT * kBT;           // 256 tile outputs
constexpr int kHalo = 33;
constexpr int kItems = kOwn + kHalo;          // 289
constexpr int kDwLanes = 27;                  // 3 channel blocks x 9 (c, ky)

struct BwdSmem {
  float w[kNW];                               // [tap][co]
  float mu[kCout], sg[kCout], beta[kCout];
  float yb[4 * kCout * kRC];                  // [ph][co][cell]; dW partials
  float dz[2][kCout][kWC];                    // this tile's and the next's
  float ut[kItems][kCout];                    // raw u, then du
  float red[kBWarps][kCout][2];               // routed Sg, Sgx partials
  uint8_t mcode[kCout][kWC];   // column winner: 0 = 2j, 1 = 2j+1, 2 = 2j-1
  uint8_t ecode[2][kCout][kWC];  // [px] row winner: 0 = 2i, 1 = 2i+1, 2 = 2i-1
  uint8_t in[2][48 * kIPS];                   // this tile's and the next's
};
static_assert(kBWarps * kNW <= 4 * kCout * kRC, "dW partials fit in yb");
static_assert(2 * kCout * kWC <= 4 * kCout * kRC, "dR fits in yb");

// halo output h (0..32) -> region cell (rr, cc) and phase: px = 1 of the
// left column (phase (0,1), rows 1..8), py = 1 of the top row (phase
// (1,0), columns 1..8), then phase (1,1): the top row, the left column,
// the corner
__device__ __forceinline__ void halo_point(int h, int& rr, int& cc,
                                           int& ph) {
  if (h < 8) {
    rr = 1 + h; cc = 0; ph = 1;
  } else if (h < 16) {
    rr = 0; cc = h - 7; ph = 2;
  } else if (h < 24) {
    rr = 0; cc = h - 15; ph = 3;
  } else if (h < 32) {
    rr = h - 23; cc = 0; ph = 3;
  } else {
    rr = 0; cc = 0; ph = 3;
  }
}

// the conv of one phase (a warp-uniform runtime value) of the cell whose
// plane 0 is at `in`, NCH channels
template <int NCH>
__device__ __forceinline__ void conv_phase(const uint8_t* in, const float* wt,
                                           int ph, float (&acc)[NCH]) {
  float (&u)[1][NCH] = *reinterpret_cast<float(*)[1][NCH]>(acc);
  switch (ph) {
    case 0: conv_cell<NCH, 0, 0, kIPS, kIRS>(in, wt, u); break;
    case 1: conv_cell<NCH, 1, 1, kIPS, kIRS>(in, wt, u); break;
    case 2: conv_cell<NCH, 2, 2, kIPS, kIRS>(in, wt, u); break;
    default: conv_cell<NCH, 3, 3, kIPS, kIRS>(in, wt, u); break;
  }
}

// ReLU(bn) of NCH conv outputs (channels o0 ..) of a region cell into yb,
// -inf outside the image
template <int NCH>
__device__ __forceinline__ void store_yb(float* yb, const float* mu,
                                         const float* sg, const float* beta,
                                         const float (&u)[NCH], int ph,
                                         int o0, int cell, bool valid) {
  float* ybp = yb + (ph * kCout + o0) * kRC + cell;
#pragma unroll
  for (int o = 0; o < NCH; ++o) {
    const float bn = (u[o] - mu[o0 + o]) * sg[o0 + o] + beta[o0 + o];
    ybp[o * kRC] = valid ? fmaxf(bn, 0.f) : neg_inf();
  }
}

// Tile (i0, j0)'s input cells and the dy of its windows into `in` and
// `dz` (interior of the bordered array), as cp.async (4-byte words of the
// input where `words`, else bytes by plain loads), committed as one
// group; 0 outside the image.
__device__ __forceinline__ void load_tile(uint8_t* in, float (*dz)[kWC],
                                          const uint8_t* __restrict__ xb,
                                          const float* __restrict__ dyb,
                                          int i0, int j0, int h4, int w4,
                                          int npad, bool words) {
  const int tid = threadIdx.x;
  if (words) {
    for (int k = tid; k < 48 * kRN * 4; k += kBThreads) {
      const int pr = k >> 2, q = k & 3;
      const int plane = pr / kRN, r = pr - plane * kRN;
      const int i = i0 - 1 + r, j = j0 - 4 + 4 * q;
      const bool ok = i >= 0 && i < h4 && j >= 0 && j < w4;
      cp_async4(in + plane * kIPS + r * kIRS + 4 * q,
                ok ? xb + (size_t)plane * npad + i * w4 + j : xb, ok);
    }
  } else {
    for (int k = tid; k < 48 * kRN * kIRS; k += kBThreads) {
      const int pr = k >> 4, q = k & 15;
      const int plane = pr / kRN, r = pr - plane * kRN;
      const int i = i0 - 1 + r, j = j0 - 4 + q;
      in[plane * kIPS + r * kIRS + q] =
          (i >= 0 && i < h4 && j >= 0 && j < w4)
              ? xb[(size_t)plane * npad + i * w4 + j] : (uint8_t)0;
    }
  }
  for (int k = tid; k < kCout * kBT * kBT; k += kBThreads) {
    const int o = k >> 6, r = (k >> 3) & 7, c = k & 7;
    const int i = i0 + r, j = j0 + c;
    const bool ok = i < h4 && j < w4;
    cp_async4(&dz[o][(r + 1) * kWN + c + 1],
              ok ? dyb + ((size_t)o * h4 + i) * w4 + j : dyb, ok);
  }
  cp_async_commit();
}

// One CTA per (row band of 8 cell rows, image), its tiles left to right,
// the next tile's input and dy in flight while one is computed: per tile
// recompute, route, du, and the dW product; the band's partials
// wpart[(b*nband + band)*648 + OIHW index] and spart[(b*nband + band)*48 +
// co*2 + {0: Sg, 1: Sgx}] (routed).  gpart: the sums kernel's output.
__global__ void __launch_bounds__(kBThreads, 2)
stem_bwd_sweep_kernel(const float* __restrict__ dy,
                      const uint8_t* __restrict__ x,
                      const float* __restrict__ stats,
                      const float* __restrict__ gpart,
                      const float* __restrict__ w,
                      const float* __restrict__ gamma,
                      const float* __restrict__ beta,
                      float* __restrict__ wpart, float* __restrict__ spart,
                      int h4, int w4, int npad, int g, float inv_m,
                      int words) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  BwdSmem& S = *reinterpret_cast<BwdSmem*>(smem_raw);
  const int b = blockIdx.y, band = blockIdx.x, nband = gridDim.x;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int gi = b / g;
  const int i0 = band * kBT;
  const uint8_t* xb = x + (size_t)b * 48 * npad;
  const float* dyb = dy + (size_t)b * kCout * h4 * w4;
  const int ntx = (w4 + kBT - 1) / kBT;
  // the window arrays' border: never a winner, no dy
  for (int k = tid; k < kCout * kWC; k += kBThreads) {
    const int o = k / kWC, q = k - o * kWC;
    const int r = q / kWN, c = q - r * kWN;
    if (r == 0 || c == 0 || r == kWN - 1 || c == kWN - 1) {
      S.dz[0][o][q] = S.dz[1][o][q] = 0.f;
      S.mcode[o][q] = S.ecode[0][o][q] = S.ecode[1][o][q] = 3;
    }
  }
  load_tile(S.in[0], S.dz[0], xb, dyb, i0, 0, h4, w4, npad, words);
  load_weights(w, S.w, nullptr);
  if (tid < kCout) {
    const float* st = stats + (size_t)(gi * kCout + tid) * 3;
    S.mu[tid] = st[0];
    S.sg[tid] = st[1] * gamma[tid];
    S.beta[tid] = beta[tid];
  }
  // A, the halo: warps 0-1 take phase (0,1), 2-3 phase (1,0), 4-7 phase
  // (1,1); a lane one output and four channels (item 6*point + quad)
  const int h_first = warp < 2 ? 0 : (warp < 4 ? 2 : 4);
  const int h_item = 32 * (warp - h_first) + lane;
  const int h_pt = h_item / 6, h_q = h_item - 6 * h_pt;
  const bool h_on = h_pt < (warp < 4 ? 8 : 17);
  const int h_idx = 4 * h_first + h_pt;      // halo output 0..32
  int h_rr = 0, h_cc = 0, h_ph = 0;
  if (h_on) halo_point(h_idx, h_rr, h_cc, h_ph);
  // C: lane = the channel, warp = every 8th output; du's factors
  const int co = lane;
  float c_mu = 0.f, c_sinv = 0.f, c_sg = 0.f, c_beta = 0.f, c_a = 0.f;
  float c_sgm = 0.f, c_sgxm = 0.f;
  if (co < kCout) {
    const float* st = stats + (size_t)(gi * kCout + co) * 3;
    float sgs = 0.f, sgx = 0.f;               // the group's, fixed order
    for (int k = 0; k < g; ++k) {
      const float* gp = gpart + ((size_t)(gi * g + k) * kCout + co) * 2;
      sgs = sgs + gp[0];
      sgx = sgx + gp[1];
    }
    c_mu = st[0];
    c_sinv = st[1];
    c_sg = st[1] * gamma[co];
    c_beta = beta[co];
    c_a = gamma[co] * st[1];
    c_sgm = sgs * inv_m;
    c_sgxm = sgx * inv_m;
  }
  // D: channels [8*cb, 8*cb + 8), input channel cin, kernel row ky, the
  // three kx; warp = the tile column it takes, then every 8th halo output
  const int cb = lane / 9, tg = lane - cb * 9;
  const int cin = tg / 3, ky = tg - cin * 3;
  float acc[8][3];
#pragma unroll
  for (int q = 0; q < 8; ++q) acc[q][0] = acc[q][1] = acc[q][2] = 0.f;
  float rs1 = 0.f, rs2 = 0.f;                 // routed Sg, Sgx of channel co
  float* const dr0 = S.yb;                    // B2's dR_0, dR_1 [co][window]
  float* const dr1 = S.yb + kCout * kWC;

  for (int tx = 0; tx < ntx; ++tx) {
    const int j0 = tx * kBT, cur = tx & 1;
    __syncthreads();            // the last tile's reads of the next buffer
    if (tx + 1 < ntx)
      load_tile(S.in[cur ^ 1], S.dz[cur ^ 1], xb, dyb, i0, j0 + kBT, h4, w4,
                npad, words);
    else
      cp_async_commit();        // an empty group: one per tile, always
    cp_async_wait<1>();         // this tile's group has landed
    __syncthreads();
    const uint8_t* in = S.in[cur] + kIC0;     // region cell (0, 0)
    const float (*dz)[kWC] = S.dz[cur];

    // A. conv: the tile's 64 cells, four phases each; a thread one cell
    // and six channels (warp-uniform: a tap's weights are one broadcast
    // read for the four outputs), raw u into ut; then the halo's 33 in
    // items of four channels.  ReLU(bn) into yb.
    {
      constexpr int Q = kCout / 4;
      const int cell = 32 * (warp & 1) + lane, q0 = Q * (warp >> 1);
      const int rr = 1 + (cell >> 3), cc = 1 + (cell & 7);
      float u[4][Q];
      conv_cell<Q, 0, 3, kIPS, kIRS>(in + rr * kIRS + cc, S.w + q0, u);
      const bool valid = i0 + rr - 1 < h4 && j0 + cc - 1 < w4;
#pragma unroll
      for (int ph = 0; ph < 4; ++ph) {
        float2* ut = reinterpret_cast<float2*>(S.ut[ph * 64 + cell] + q0);
#pragma unroll
        for (int k = 0; k < Q / 2; ++k)
          ut[k] = make_float2(u[ph][2 * k], u[ph][2 * k + 1]);
        store_yb<Q>(S.yb, S.mu, S.sg, S.beta, u[ph], ph, q0, rr * kRN + cc,
                       valid);
      }
    }
    if (h_on) {
      float u[4];
      conv_phase<4>(in + h_rr * kIRS + h_cc, S.w + 4 * h_q, h_ph, u);
      const int i = i0 - 1 + h_rr, j = j0 - 1 + h_cc;
      store_yb<4>(S.yb, S.mu, S.sg, S.beta, u, h_ph, 4 * h_q,
                     h_rr * kRN + h_cc, i >= 0 && i < h4 && j >= 0 && j < w4);
      *reinterpret_cast<float4*>(S.ut[kOwn + h_idx] + 4 * h_q) =
          make_float4(u[0], u[1], u[2], u[3]);
    }
    __syncthreads();

    // B. the pool's winners at the tile's 64 windows: the row codes of
    // each window's columns 2j, 2j+1 (and of the column 2j0-1 to the
    // tile's left) and the column codes
    for (int it = tid; it < kCout * kBT * kBT; it += kBThreads) {
      const int o = it >> 6, wr = (it >> 3) & 7, wc = it & 7;
      const int here = (wr + 1) * kRN + wc + 1, up = wr * kRN + wc + 1;
      const int left = here - 1, upleft = up - 1;
      const float* Y = S.yb + o * kRC;         // phase k at Y + k*kCout*kRC
      constexpr int P = kCout * kRC;
      const int q = (wr + 1) * kWN + wc + 1;   // the window, bordered
      float R[2];
#pragma unroll
      for (int px = 0; px < 2; ++px) {
        const float c0 = Y[px * P + here];       // row 2i
        const float c1 = Y[(2 + px) * P + here]; // row 2i+1
        const float c2 = Y[(2 + px) * P + up];   // row 2i-1
        R[px] = fmaxf(fmaxf(c0, c1), c2);
        S.ecode[px][o][q] = c0 == R[px] ? 0 : (c1 == R[px] ? 1 : 2);
      }
      const float l0 = Y[P + left], l1 = Y[3 * P + left];
      const float l2 = Y[3 * P + upleft];
      const float t2 = fmaxf(fmaxf(l0, l1), l2);   // column 2j-1
      if (wc == 0)     // that column's row code, for the halo under it
        S.ecode[1][o][q - 1] = l0 == t2 ? 0 : (l1 == t2 ? 1 : 2);
      const float out = fmaxf(fmaxf(R[0], R[1]), t2);
      S.mcode[o][q] = R[0] == out ? 0 : (R[1] == out ? 1 : 2);
    }
    __syncthreads();

    // B2. dR_px under every conv column: dR_0 of window (u, v) is its dy
    // where column 2v won it; dR_1 where 2v+1 won it, plus window (u,
    // v+1)'s dy where 2v+1 won that as its 2j-1.  Windows of other tiles
    // are on the border (no winner).  Into yb's place: from here on the
    // ReLU masks come from u.
    for (int it = tid; it < kCout * kWC; it += kBThreads) {
      const int o = it / kWC, q = it - o * kWC;
      const int m0 = S.mcode[o][q];
      const float d0 = dz[o][q];
      const bool right = q % kWN < kWN - 1;
      const int m1 = right ? S.mcode[o][q + 1] : 3;
      const float d1 = right ? dz[o][q + 1] : 0.f;
      dr0[it] = m0 == 0 ? d0 : 0.f;
      dr1[it] = (m0 == 1 ? d0 : 0.f) + (m1 == 2 ? d1 : 0.f);
    }
    __syncthreads();

    // C. gather: conv output (2u+py, 2v+px) takes dR_px of window u (as
    // row 2u+py) and, for py = 1, of window u+1 (as its row 2(u+1)-1);
    // ReLU mask (bn(u) > 0, as A computed it); du in place of u; the
    // routed sums.  The item (and so its phase) is the warp's; the lanes
    // are the channels.
    if (co < kCout) {
      const int o = co;
      for (int k = warp; k < kItems; k += kBWarps) {
        int rr, cc, ph;
        if (k < kOwn) {
          ph = k >> 6;
          rr = 1 + ((k >> 3) & 7);
          cc = 1 + (k & 7);
        } else {
          halo_point(k - kOwn, rr, cc, ph);
        }
        const int py = ph >> 1, px = ph & 1;
        const uint8_t* e = S.ecode[px][o];
        const float* dr = (px == 0 ? dr0 : dr1) + o * kWC;
        const int q = rr * kWN + cc;          // window (rr-1, cc-1)
        const float gv = py == 0 ? (e[q] == 0 ? dr[q] : 0.f)
                                 : (e[q] == 1 ? dr[q] : 0.f) +
                                       (e[q + kWN] == 2 ? dr[q + kWN] : 0.f);
        const float dd = S.ut[k][o] - c_mu;
        const int i = i0 - 1 + rr, j = j0 - 1 + cc;
        const bool inside = i >= 0 && i < h4 && j >= 0 && j < w4;
        const float gy = inside && dd * c_sg + c_beta > 0.f ? gv : 0.f;
        const float xh = dd * c_sinv;
        float du = c_a * gy;                     // the halo's part
        if (k < kOwn)
          du = inside ? c_a * ((gy - c_sgm) - xh * c_sgxm) : 0.f;
        S.ut[k][o] = du;
        rs1 = rs1 + gy;
        rs2 = __fmaf_rn(gy, xh, rs2);
      }
    }
    __syncthreads();

    // D. dW[co][cin][ky][kx] += du[co][item] * x[tap of item]: lane (cb,
    // cin, ky) of warp `warp` takes the tile column c = warp, all 8 rows,
    // phase by phase (the three tap offsets hoisted out of the rows), then
    // the halo outputs warp, warp + 8, ...
    if (lane < kDwLanes) {
#pragma unroll
      for (int ph = 0; ph < 4; ++ph) {
        const int ro = 2 * (ph >> 1) + ky - 1;
        int off[3];
#pragma unroll
        for (int kx = 0; kx < 3; ++kx) {
          const int cof = 2 * (ph & 1) + kx - 1;
          off[kx] = ((ro & 3) * 12 + (cof & 3) * 3 + cin) * kIPS +
                    (ro < 0 ? -kIRS : 0) + (cof < 0 ? -1 : 0);
        }
        const uint8_t* base = in + kIRS + (warp + 1);
#pragma unroll
        for (int r = 0; r < kBT; ++r) {
          const int k = ph * 64 + r * kBT + warp;
          const float4* dp = reinterpret_cast<const float4*>(S.ut[k]) + 2 * cb;
          const float4 d0 = dp[0], d1 = dp[1];
          const float du[8] = {d0.x, d0.y, d0.z, d0.w, d1.x, d1.y, d1.z, d1.w};
          float xv[3];
#pragma unroll
          for (int kx = 0; kx < 3; ++kx)
            xv[kx] = (float)base[r * kIRS + off[kx]];
#pragma unroll
          for (int q = 0; q < 8; ++q)
#pragma unroll
            for (int kx = 0; kx < 3; ++kx)
              acc[q][kx] = __fmaf_rn(du[q], xv[kx], acc[q][kx]);
        }
      }
      for (int hk = warp; hk < kHalo; hk += kBWarps) {
        int rr, cc, ph;
        halo_point(hk, rr, cc, ph);
        const int ro = 2 * (ph >> 1) + ky - 1;
        const float4* dp =
            reinterpret_cast<const float4*>(S.ut[kOwn + hk]) + 2 * cb;
        const float4 d0 = dp[0], d1 = dp[1];
        const float du[8] = {d0.x, d0.y, d0.z, d0.w, d1.x, d1.y, d1.z, d1.w};
        float xv[3];
#pragma unroll
        for (int kx = 0; kx < 3; ++kx) {
          const int cof = 2 * (ph & 1) + kx - 1;
          xv[kx] = (float)in[((ro & 3) * 12 + (cof & 3) * 3 + cin) * kIPS +
                             (rr + (ro < 0 ? -1 : 0)) * kIRS + cc +
                             (cof < 0 ? -1 : 0)];
        }
#pragma unroll
        for (int q = 0; q < 8; ++q)
#pragma unroll
          for (int kx = 0; kx < 3; ++kx)
            acc[q][kx] = __fmaf_rn(du[q], xv[kx], acc[q][kx]);
      }
    }
  }

  // the band's partials: dW and the routed sums over the 8 warps, in a
  // fixed order
  __syncthreads();
  float* red = S.yb;                          // [warp][648]
  if (lane < kDwLanes) {
#pragma unroll
    for (int q = 0; q < 8; ++q)
#pragma unroll
      for (int kx = 0; kx < 3; ++kx)
        red[warp * kNW + (cb * 8 + q) * kTaps + cin * 9 + ky * 3 + kx] =
            acc[q][kx];
  }
  if (co < kCout) {
    S.red[warp][co][0] = rs1;
    S.red[warp][co][1] = rs2;
  }
  __syncthreads();
  const size_t pi = (size_t)b * nband + band;
  for (int k = tid; k < kNW; k += kBThreads) {
    float s = 0.f;
#pragma unroll
    for (int q = 0; q < kBWarps; ++q) s = s + red[q * kNW + k];
    wpart[pi * kNW + k] = s;
  }
  if (tid < 2 * kCout) {
    const int o = tid >> 1, kind = tid & 1;
    float s = 0.f;
    for (int q = 0; q < kBWarps; ++q) s = s + S.red[q][o][kind];
    spart[pi * 2 * kCout + tid] = s;
  }
}

// CTA k < 648: dW[k] = sum of the nparts band partials, in order of the
// bands; k in [648, 672): dgamma = the bands' routed Sgx; [672, 696):
// dbeta = their routed Sg.
__global__ void __launch_bounds__(256)
stem_bwd_reduce_kernel(const float* __restrict__ wpart,
                       const float* __restrict__ spart, int nparts,
                       float* __restrict__ dw, float* __restrict__ dgamma,
                       float* __restrict__ dbeta) {
  __shared__ float s_red[8];
  const int k = blockIdx.x, tid = threadIdx.x;
  float s = 0.f;
  if (k < kNW) {
    for (int r = tid; r < nparts; r += blockDim.x)
      s = s + wpart[(size_t)r * kNW + k];
  } else {
    const int which = (k - kNW) / kCout, o = (k - kNW) - which * kCout;
    for (int r = tid; r < nparts; r += blockDim.x)
      s = s + spart[(size_t)r * 2 * kCout + 2 * o + (which == 0 ? 1 : 0)];
  }
  s = warp_sum(s);
  if ((tid & 31) == 0) s_red[tid >> 5] = s;
  __syncthreads();
  if (tid == 0) {
    float t = 0.f;
    for (int q = 0; q < (int)(blockDim.x >> 5); ++q) t = t + s_red[q];
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
         g >= 1 && b % g == 0 && (long long)b * kCout <= 0x7fffffff;
}

bool fwd_tile_ok(int tr, int ncw) {
  return tr >= 1 && tr <= kFR && ncw >= 1 && ncw <= 3;
}

FwdGeo make_fwd_geo(int h4, int w4, int npad, int g, int tr, int ncw) {
  const int cw = ncw * kFWarpCols;
  return FwdGeo{h4, w4, npad, g, tr, ncw, (w4 + cw - 1) / cw,
                (h4 + tr - 1) / tr};
}

// The forward's three launches.
int stem_fwd(const uint8_t* x, const float* w, const float* gamma,
             const float* beta, float* y, float* z, float* stats, float* scratch,
             int b, int h4, int w4, int npad, int g, int tr, int ncw,
             void* stream) {
  if (!geo_ok(b, h4, w4, npad, g) || !fwd_tile_ok(tr, ncw))
    return (int)cudaErrorInvalidValue;
  const cudaStream_t st = (cudaStream_t)stream;
  const FwdGeo geo = make_fwd_geo(h4, w4, npad, g, tr, ncw);
  const int ngroups = b / g;
  const auto sweep = stem_fwd_sweep_kernel;
  cudaError_t e = cudaFuncSetAttribute(
      sweep, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)kFwdSmem);
  if (e != cudaSuccess) return (int)e;
  // 4-byte input loads need every row start aligned, and one chunk (the
  // run then starts at column 0)
  const int words = w4 % 4 == 0 && npad % 4 == 0 && geo.nchunk == 1 &&
                    ((uintptr_t)x & 3) == 0;
  sweep<<<dim3(geo.nband * geo.nchunk, b), 32 * kFGroups * ncw, kFwdSmem,
          st>>>(x, w, gamma, z, scratch, geo, words);
  e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  stem_stats_combine_kernel<<<(ngroups * kCout * 32 + 255) / 256, 256, 0,
                              st>>>(scratch, stats, geo, ngroups);
  e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  stem_fwd_emit_kernel<<<b * kCout, 256, 0, st>>>(z, gamma, beta, stats, y,
                                                  h4 * w4, g);
  return (int)cudaGetLastError();
}

// The backward's three launches.
int stem_bwd(const float* dy, const uint8_t* x, const float* z,
             const float* stats, const float* w, const float* gamma,
             const float* beta, float* dw, float* dgamma, float* dbeta,
             float* scratch, int b, int h4, int w4, int npad, int g,
             void* stream) {
  if (!geo_ok(b, h4, w4, npad, g)) return (int)cudaErrorInvalidValue;
  const cudaStream_t st = (cudaStream_t)stream;
  const int nband = (h4 + kBT - 1) / kBT;
  float* gpart = scratch;
  float* wpart = gpart + (size_t)b * 2 * kCout;
  float* spart = wpart + (size_t)b * nband * kNW;
  const int smem = (int)sizeof(BwdSmem);
  const auto sweep = stem_bwd_sweep_kernel;
  cudaError_t e = cudaFuncSetAttribute(
      sweep, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return (int)e;
  stem_bwd_sums_kernel<<<b * kCout, 256, 0, st>>>(dy, z, stats, gamma, beta,
                                                  gpart, h4 * w4, g);
  e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  const float inv_m = (float)(1.0 / ((double)g * 4.0 * h4 * w4));
  // 4-byte input words need aligned rows (tiles start at multiples of 8)
  const int words = w4 % 4 == 0 && npad % 4 == 0 && ((uintptr_t)x & 3) == 0;
  sweep<<<dim3(nband, b), kBThreads, smem, st>>>(
      dy, x, stats, gpart, w, gamma, beta, wpart, spart, h4, w4, npad, g,
      inv_m, words);
  e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  stem_bwd_reduce_kernel<<<kNW + 2 * kCout, 256, 0, st>>>(
      wpart, spart, b * nband, dw, dgamma, dbeta);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// bytes of dynamic shared memory of the forward sweep (which = 0) and the
// backward sweep (1); the other kernels take less than 1 KB, static
size_t fastdet_stem_train_smem(int which) {
  return which == 0 ? kFwdSmem : sizeof(BwdSmem);
}

// floats of scratch for the forward: the per-tile (mean, M2)
size_t fastdet_stem_train_fwd_scratch(int b, int h4, int w4, int tr,
                                      int ncw) {
  if (!fwd_tile_ok(tr, ncw)) return 0;
  const FwdGeo geo = make_fwd_geo(h4, w4, h4 * w4, 1, tr, ncw);
  return (size_t)b * geo.nband * geo.nchunk * 2 * kCout;
}

// x (B, 48, npad) u8, w (24,3,3,3) f32 (scaled), gamma/beta (24) f32 ->
// y and z (B, 24, h4, w4) f32, stats (B/g, 24, 3) f32; all on the card;
// the sweep's tile: tr cell rows, ncw warps of 31 cell columns.
// Returns a cudaError_t (0 = launched).
int fastdet_stem_train_fwd(const uint8_t* x, const float* w,
                           const float* gamma, const float* beta, float* y,
                           float* z, float* stats, float* scratch, int b,
                           int h4, int w4, int npad, int g, int tr, int ncw,
                           void* stream) {
  return stem_fwd(x, w, gamma, beta, y, z, stats, scratch, b, h4, w4, npad,
                  g, tr, ncw, stream);
}

// floats of scratch for the backward: per-plane sums, the
// bands' dW and routed-sum partials
size_t fastdet_stem_train_bwd_scratch(int b, int h4) {
  const size_t parts = (size_t)b * ((h4 + kBT - 1) / kBT);
  return (size_t)b * 2 * kCout + parts * (kNW + 2 * kCout);
}

// dy (B, 24, h4, w4) f32, x, z (B, 24, h4, w4) f32 (the forward's), stats
// (B/g, 24, 3), w, gamma, beta -> dw (24,3,3,3), dgamma (24), dbeta (24)
// f32; all on the card.
int fastdet_stem_train_bwd(const float* dy, const uint8_t* x, const float* z,
                           const float* stats, const float* w,
                           const float* gamma, const float* beta, float* dw,
                           float* dgamma, float* dbeta, float* scratch,
                           int b, int h4, int w4, int npad, int g,
                           void* stream) {
  return stem_bwd(dy, x, z, stats, w, gamma, beta, dw, dgamma, dbeta,
                  scratch, b, h4, w4, npad, g, stream);
}

const char* fastdet_cuda_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
