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
// mean, then the biased variance, eps 1e-5.  The weights of a block are
// one f32 row (fastdet_torch/kernels/fused_train.py):
//   [w1 (MID_in x MID_out) | wd (9 x MID) | w2 (MID_in x MID_out) |
//    g1 b1 g2 b2 g3 b3 (6 x MID)].
// Stats: (nblk, 3 BNs, G, [mu, sinv, var], MID).
//
// Design.  Every kernel is one CTA per pixel tile: tr x tc pixels of one
// image (the launch plan, `span_train_plan` in the wrapper, picks a
// forward and a backward tile per stage and passes it), so a ghost group
// is a run of whole tiles and the weight gradients have one partial row
// per backward tile.  A ghost group's BN input (372-743 KB at b128
// 352^2) does not fit one SM.  The thread-block cluster that could hold
// it is not used at any stage: at stage 4 the 8 groups would fill 64 of
// 132 SMs with clusters of 8 (the portable limit), and at every stage
// the depthwise conv would read its halo rows from the neighbouring CTAs
// over DSMEM at every block.  Instead every BN's statistics are produced
// in the epilogue of the kernel that writes its input and merged in the
// prologue of the kernel that reads it:
//   forward, 3 launches per block + 1:
//     in   the block input to xsave[i] (x itself for block 0, else
//          ReLU(BN3(u3_{i-1})) into its second half), then u1 = pw1 and
//          u1's tile moments;
//     dw   BN1 merged, u2 = dw(ReLU(BN1(u1))) on a haloed tile, moments;
//     pw2  BN2 merged, u3 = pw2(BN2(u2)), moments; the warps that hold no
//          pointwise work meanwhile copy the next block input's first half
//          (this input's even channels);
//   and a last `in` writes the span's output.  A tile's moments are its
//   mean and M2 (two passes over the tile in shared memory); the consumer
//   merges its group's tiles, the mean as sum n_t mean_t / m, then M2 as
//   sum (M2_t + n_t (mean_t - mean)^2) (never E[u^2]-mu^2), and the
//   group's first tile writes the stats.  No copy of x: the first `in`
//   writes xsave[0].  The forward's tiles are large (half an image at
//   stage 3, a whole one at stage 4) so that its CTAs run in one wave.
//   backward, 5 launches per block + 1:
//     in   u1 = pw1(x_i[:, 1::2]) from the saved block input;
//     rec  u2, u3 recomputed with the saved stats; BN3's backward sums of
//          the tile (sum g, sum g*xhat, ReLU mask from u3);
//     bn3  du3 with the group's sums; dW2 partial; dv = w2 du3; BN2's sums;
//     bn2  du2 on a haloed tile; dwd partial; dy = transposed dw of du2,
//          ReLU mask from u1; BN1's sums;
//     bn1  du1; dW1 partial; dx (odd channels w1 du1, even ones dy[:, :MID]);
//   then one launch adds each block's partial rows in a fixed order.
//   Every BN-backward sum of a tile lands in its partial row, so the
//   (dgamma, dbeta) need no other pass and the partial buffer needs no
//   memset.
// Sums are in a fixed order everywhere (no atomics): every CTA of a group
// merges the same bits, and two runs give the same bits.  A kernel's
// tile, halo, weights and taps come in by cp.async, issued together
// before the group merge, so that one wait covers them.
//
// The pointwise convs stage the tile's MID inputs and the whole weight
// matrix (2.3 / 9.2 / 36.9 KB) in shared memory; a thread computes 4
// pixels x 8 outputs (6 loads per 32 multiply-adds).  The dW products
// give each thread an RB x RB block of (in, out) over its share of the
// tile's pixels (all 256 threads at every MID).
//
// Arithmetic: every pointwise conv sums its input channels in order,
// acc = acc + x*w, and the depthwise conv its 9 taps in order; BN is
// (u-mu)*(sinv*gamma)+beta.  The file is built with --fmad=false, so the
// plain PyTorch versions, which do the same operations, recompute the
// same forward values bit for bit from the same saved inputs and stats,
// and the backward's ReLU masks agree.
//
// What bounds it on this card: at b128 352^2 the forward does ~8.2 GFLOP
// (0.12 ms at 67 TFLOP/s f32; 0.245 ms as the separate multiplies and
// adds that --fmad=false issues) and must write the 345 MB of saved block
// inputs (0.10 ms); the backward ~3x the operations.  The intermediates
// (u1, u2, u3, dv, dy: 23.8 / 11.9 / 5.9 MB each at stages 2 / 3 / 4)
// make a round trip through L2 between launches.
//
// The bf16 form of B8 (the same Pallas kernels at dtype=bfloat16) is a
// kernel of its own, csrc/span16_train.cu: a thread-block cluster per
// ghost group holds the group's bf16 activation in shared memory for every
// block, and the products run on bf16 tensor cores.  This file holds the
// f32 form only.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
// CTAs per SM that every kernel's registers leave room for (their shared
// memory at the plan's tiles allows as many)
template <int MID> struct Occ { static constexpr int CTAS = MID == 96 ? 2 : 4; };
constexpr float kEps = 1e-5f;

template <int MID>
struct Row {
  static constexpr int W1 = 0;
  static constexpr int WD = MID * MID;
  static constexpr int W2 = MID * MID + 9 * MID;
  static constexpr int GB = 2 * MID * MID + 9 * MID;
  static constexpr int LEN = 2 * MID * MID + 15 * MID;
};

// The dW product's threads: PG pixel groups of TI x TI threads, each an
// RB x RB block of (in, out); TI*TI*PG = kThreads, TI*RB = MID.
template <int MID> struct DW;
template <> struct DW<24> { static constexpr int TI = 8, RB = 3, PG = 4; };
template <> struct DW<48> { static constexpr int TI = 8, RB = 6, PG = 4; };
template <> struct DW<96> { static constexpr int TI = 16, RB = 6, PG = 1; };

// Tiling of the (B, h, w) pixels: tr x tc tiles, image-major.  ps and phs
// are the shared-memory strides of one channel of a tile and of a tile
// with its one-pixel halo (odd, so that rows differ in bank).
struct Geo {
  int b, h, w, g, G;
  int tr, tc, tcn, tpi, ntiles;
  int ps, phs;
};

Geo make_geo(int b, int h, int w, int g, int tr, int tc) {
  Geo G;
  G.b = b; G.h = h; G.w = w; G.g = g; G.G = b / g;
  G.tr = tr; G.tc = tc;
  G.tcn = (w + tc - 1) / tc;
  G.tpi = ((h + tr - 1) / tr) * G.tcn;
  G.ntiles = b * G.tpi;
  G.ps = (tr * tc) | 1;
  G.phs = ((tr + 2) * (tc + 2)) | 1;
  return G;
}

constexpr size_t kSmemLimit = 232448;   // bytes a CTA may use on sm_90

// Shared-memory floats of each kernel (the layouts below, in order).
template <int MID>
struct Smem {
  static constexpr int CONSTF = 12 * MID;   // forward: BN constants, scratch
  static constexpr int CONST = 18 * MID;    // backward
  static constexpr int COMB = DW<MID>::PG > 1 ? DW<MID>::PG * MID * MID : 0;
  static size_t in(const Geo& G) { return MID * MID + CONSTF + 2 * (size_t)MID * G.ps; }
  static size_t fdw(const Geo& G) {
    return 9 * MID + CONSTF + (size_t)MID * G.phs + (size_t)MID * G.ps;
  }
  static size_t fpw2(const Geo& G) { return MID * MID + CONSTF + 2 * (size_t)MID * G.ps; }
  static size_t rec(const Geo& G) {
    return MID * MID + 9 * MID + CONST + (size_t)MID * G.phs + (size_t)MID * G.ps;
  }
  static size_t bn3(const Geo& G) {
    return MID * MID + CONST + 2 * (size_t)MID * G.ps + COMB;
  }
  static size_t bn2(const Geo& G) { return 9 * MID + CONST + 2 * (size_t)MID * G.phs; }
  static size_t bn1(const Geo& G) { return bn3(G); }
  // the most of the forward's kernels, or of the backward's
  static size_t most(const Geo& G, bool backward) {
    return backward ? top(top(in(G), rec(G)), top(top(bn3(G), bn2(G)), bn1(G)))
                    : top(in(G), top(fdw(G), fpw2(G)));
  }
  static size_t top(size_t a, size_t b) { return a > b ? a : b; }
};

struct Tile {
  int t, b, gi, r0, c0, th, tw, n;
  int q0;      // plane offset of the tile's first pixel
  bool full;   // the tile spans whole rows: its pixels are consecutive
  bool first;  // the first tile of its ghost group
};

__device__ __forceinline__ void tile_extent(const Geo& G, int local, int& r0,
                                            int& c0, int& th, int& tw) {
  const int ti = local / G.tcn, tj = local - ti * G.tcn;
  r0 = ti * G.tr;
  c0 = tj * G.tc;
  th = min(G.tr, G.h - r0);
  tw = min(G.tc, G.w - c0);
}

__device__ __forceinline__ Tile make_tile(const Geo& G, int t) {
  Tile T;
  T.t = t;
  T.b = t / G.tpi;
  const int local = t - T.b * G.tpi;
  T.gi = T.b / G.g;
  tile_extent(G, local, T.r0, T.c0, T.th, T.tw);
  T.n = T.th * T.tw;
  T.q0 = T.r0 * G.w + T.c0;
  T.full = T.tw == G.w;
  T.first = local == 0 && T.b % G.g == 0;
  return T;
}

// Offset in the (h, w) plane of tile pixel p (row-major in the tile).
__device__ __forceinline__ int pix(const Geo& G, const Tile& T, int p) {
  if (T.full) return T.q0 + p;
  const int py = p / T.tw;
  return T.q0 + py * G.w + (p - py * T.tw);
}

// Index in the haloed tile ((th+2) x (tw+2)) of tap t of tile pixel p.
__device__ __forceinline__ int tap(const Tile& T, int p, int t) {
  const int py = p / T.tw, px = p - py * T.tw;
  return (py + t / 3) * (T.tw + 2) + px + t % 3;
}

__device__ __forceinline__ float bn(float u, float mu, float sc, float beta) {
  return (u - mu) * sc + beta;
}

// The CTA's threads over the (channel, position) pairs of a tile: each
// thread takes a position (consecutive threads, consecutive positions)
// and, for it, the channels c0, c0 + cstep, ... < NC, so that the
// position's index arithmetic is done once per thread, not per element:
// body(pos, c0, cstep).
template <int NC, typename Body>
__device__ __forceinline__ void tile_positions(int npos, Body body) {
  if (npos <= kThreads) {
    const int cpt = min(kThreads / npos, NC);
    const int cg = threadIdx.x / npos;
    if (cg < cpt) body(threadIdx.x - cg * npos, cg, cpt);
  } else {
    for (int pos = threadIdx.x; pos < npos; pos += kThreads) body(pos, 0, 1);
  }
}

// Asynchronous copies global -> shared (sm_80+) of 4 and 16 bytes, and
// the wait for all of a thread's copies.
__device__ __forceinline__ void cp_async4(float* s, const float* g) {
  const unsigned a = (unsigned)__cvta_generic_to_shared(s);
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(a), "l"(g)
               : "memory");
}

__device__ __forceinline__ void cp_async16(float* s, const float* g) {
  const unsigned a = (unsigned)__cvta_generic_to_shared(s);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(a), "l"(g)
               : "memory");
}

__device__ __forceinline__ bool aligned16(const void* p) {
  return ((uintptr_t)p & 15) == 0;
}

__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_all;\n" ::: "memory");
}

// s[i] = g[i], i < n (or s[i] = g[(i % MID) * MID + i / MID], the
// transposed MID x MID matrix), asynchronously; 16 bytes a copy where g
// is aligned (s is, n a multiple of 4).
template <int MID, bool TRANS = false>
__device__ __forceinline__ void async_copy(float* s, const float* g, int n) {
  if (!TRANS && aligned16(g)) {
    for (int i = 4 * threadIdx.x; i < n; i += 4 * kThreads) cp_async16(s + i, g + i);
    return;
  }
  for (int i = threadIdx.x; i < n; i += kThreads) {
    if (TRANS) {
      const int k = i / MID, j = i - k * MID;
      cp_async4(s + i, g + j * MID + k);
    } else {
      cp_async4(s + i, g + i);
    }
  }
}

// The tile's pixels of NC channels of one image's (C', h, w) map src,
// channel c at src + c * cstride, to s[c * ss + p], asynchronously.
template <int NC>
__device__ __forceinline__ void async_tile(const Geo& G, const Tile& T,
                                           const float* src, size_t cstride,
                                           float* s, int ss) {
  tile_positions<NC>(T.n, [&](int p, int c0, int cstep) {
    const float* g = src + pix(G, T, p);
#pragma unroll 4
    for (int c = c0; c < NC; c += cstep) cp_async4(s + c * ss + p, g + c * cstride);
  });
}

// The haloed tile's pixels (hp over (th+2) x (tw+2)) of the MID channels
// of one image's (MID, h, w) map src to s[c * phs + hp], asynchronously;
// positions off the image get 0.
template <int MID>
__device__ __forceinline__ void async_halo(const Geo& G, const Tile& T,
                                           const float* src, float* s) {
  const int hw = T.tw + 2, nh = (T.th + 2) * hw;
  const size_t plane = (size_t)G.h * G.w;
  tile_positions<MID>(nh, [&](int hp, int c0, int cstep) {
    const int hy = hp / hw;
    const int y = T.r0 - 1 + hy, x = T.c0 - 1 + hp - hy * hw;
    if (y >= 0 && y < G.h && x >= 0 && x < G.w) {
      const float* g = src + y * G.w + x;
#pragma unroll 4
      for (int c = c0; c < MID; c += cstep) cp_async4(s + c * G.phs + hp, g + c * plane);
    } else {
      for (int c = c0; c < MID; c += cstep) s[c * G.phs + hp] = 0.f;
    }
  });
}

// s = ReLU(BN(s)) in place on the haloed tile's positions on the image
// (those off it stay 0); BN's mu, sinv*gamma and beta.
template <int MID>
__device__ __forceinline__ void halo_bn_relu(const Geo& G, const Tile& T,
                                             const float* mu, const float* sc,
                                             const float* beta, float* s) {
  const int hw = T.tw + 2, nh = (T.th + 2) * hw;
  tile_positions<MID>(nh, [&](int hp, int c0, int cstep) {
    const int hy = hp / hw;
    const int y = T.r0 - 1 + hy, x = T.c0 - 1 + hp - hy * hw;
    if (y >= 0 && y < G.h && x >= 0 && x < G.w) {
#pragma unroll 4
      for (int c = c0; c < MID; c += cstep)
        s[c * G.phs + hp] =
            fmaxf(bn(s[c * G.phs + hp], mu[c], sc[c], beta[c]), 0.f);
    }
  });
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// The tile's mean and M2 of each channel of s (channel c at s + c*ss)
// over its n pixels, two passes: thread (k, c) of MID x NP sums the
// pixels p = k, k + NP, ... of channel c, and thread c adds the NP parts
// in order through s_red (NP * MID floats) -> fst_t[c], fst_t[MID + c].
// Every thread must call it.
template <int MID>
__device__ void tile_moments(const float* s, int ss, int n, float* fst_t,
                             float* s_red) {
  constexpr int NP = MID == 24 ? 8 : MID == 48 ? 4 : 2;
  const int c = threadIdx.x % MID, k = threadIdx.x / MID;
  const float* row = s + c * ss;
  float a = 0.f;
  if (k < NP)
    for (int p = k; p < n; p += NP) a += row[p];
  if (k < NP) s_red[k * MID + c] = a;
  __syncthreads();
  float mean = 0.f;
#pragma unroll
  for (int j = 0; j < NP; ++j) mean += s_red[j * MID + c];
  mean = mean / (float)n;
  __syncthreads();
  a = 0.f;
  if (k < NP)
    for (int p = k; p < n; p += NP) {
      const float d = row[p] - mean;
      a += d * d;
    }
  if (k < NP) s_red[k * MID + c] = a;
  __syncthreads();
  if (threadIdx.x < MID) {
    float m2 = 0.f;
#pragma unroll
    for (int j = 0; j < NP; ++j) m2 += s_red[j * MID + c];
    fst_t[c] = mean;
    fst_t[MID + c] = m2;
  }
}

// The group's per-tile records (2*MID floats; tile t's at rec + t*stride),
// folded per channel over the group's tiles: warp w takes the tiles w, w
// + 8, ... in order, lanes the channels (so that a warp's loads are
// consecutive floats); the 8 warps' sums go through s_red (8 x MID) and
// thread c adds them in warp order: -> sum over the tiles of f(n_t,
// rec_t, c), in every thread c < MID's return value.  Every thread must
// call it; it ends with a barrier.
template <int MID, typename F>
__device__ __forceinline__ float group_sum(const Geo& G, const Tile& T,
                                           const float* rec, size_t stride,
                                           float* s_red, F f) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int t0 = T.gi * G.g * G.tpi, nt = G.g * G.tpi;
  for (int c = lane; c < MID; c += 32) {
    float acc = 0.f;
    for (int k = warp; k < nt; k += kWarps) {
      int r0, c0, th, tw;
      tile_extent(G, k % G.tpi, r0, c0, th, tw);
      acc += f((float)(th * tw), rec + (size_t)(t0 + k) * stride, c);
    }
    s_red[warp * MID + c] = acc;
  }
  __syncthreads();
  float sum = 0.f;
  if (threadIdx.x < MID) {
#pragma unroll
    for (int w = 0; w < kWarps; ++w) sum += s_red[w * MID + threadIdx.x];
  }
  __syncthreads();
  return sum;
}

// One BN's constants from the tiles' moments of its input (fst: ntiles x
// [mean, M2] x MID), merged over the group's tiles: the group mean is
// sum_t n_t mean_t / m, then M2 = sum_t (M2_t + n_t (mean_t - mean)^2)
// (no E[u^2] - mu^2), both in a fixed order, so that every CTA of the
// group gets the same bits.  -> s_c[c] = mu, s_c[MID + c] = sinv*gamma,
// s_c[2*MID + c] = beta (s_c holds 12*MID floats, the rest scratch); the
// group's first tile writes (mu, sinv, var) to st (G, 3, MID).  Every
// thread must call it.
template <int MID>
__device__ void bn_from_moments(const Geo& G, const Tile& T, const float* fst,
                                const float* gamma, float* st, float* s_c) {
  float* s_red = s_c + 3 * MID;
  float* s_mean = s_c + 11 * MID;
  const float m = (float)(G.g * G.h * G.w);
  const float mean = group_sum<MID>(G, T, fst, 2 * MID, s_red,
      [](float nb, const float* r, int c) { return nb * r[c]; }) / m;
  if (threadIdx.x < MID) s_mean[threadIdx.x] = mean;
  __syncthreads();
  const float m2 = group_sum<MID>(G, T, fst, 2 * MID, s_red,
      [&](float nb, const float* r, int c) {
        const float d = r[c] - s_mean[c];
        return r[MID + c] + nb * (d * d);
      });
  if (threadIdx.x < MID) {
    const int c = threadIdx.x;
    const float var = m2 / m;
    const float sinv = rsqrtf(var + kEps);
    s_c[c] = mean;
    s_c[MID + c] = sinv * gamma[c];
    s_c[2 * MID + c] = gamma[MID + c];
    if (T.first) {
      st[(T.gi * 3) * MID + c] = mean;
      st[(T.gi * 3 + 1) * MID + c] = sinv;
      st[(T.gi * 3 + 2) * MID + c] = var;
    }
  }
}

// One BN's saved constants for the backward: s_c[c] = mu, [MID+c] = sinv,
// [2MID+c] = sinv*gamma, [3MID+c] = beta (st: (G, 3, MID) of this BN).
template <int MID>
__device__ void bn_saved(const float* st, const float* gamma, int gi,
                         float* s_c) {
  for (int c = threadIdx.x; c < MID; c += kThreads) {
    const float sinv = st[(gi * 3 + 1) * MID + c];
    s_c[c] = st[(gi * 3) * MID + c];
    s_c[MID + c] = sinv;
    s_c[2 * MID + c] = sinv * gamma[c];
    s_c[3 * MID + c] = gamma[MID + c];
  }
}

// A BN backward's group means of g and g*xhat from the tiles' partial rows
// (slot col: sum g*xhat at GB + col*MID, sum g at GB + (col+1)*MID), in a
// fixed order -> s_a[c] = sum g / m, s_a[MID + c] = sum g*xhat / m.
// s_red: 8 * MID floats of scratch.  Every thread must call it.
template <int MID>
__device__ void bn_bwd_means(const Geo& G, const Tile& T, const float* part,
                             int col, float* s_a, float* s_red) {
  const float* rec = part + Row<MID>::GB + col * MID;
  const float s1 = group_sum<MID>(G, T, rec, Row<MID>::LEN, s_red,
      [](float, const float* r, int c) { return r[MID + c]; });
  const float s2 = group_sum<MID>(G, T, rec, Row<MID>::LEN, s_red,
      [](float, const float* r, int c) { return r[c]; });
  if (threadIdx.x < MID) {
    const float m = (float)(G.g * G.h * G.w);
    s_a[threadIdx.x] = s1 / m;
    s_a[MID + threadIdx.x] = s2 / m;
  }
}

// 1x1 conv of the tile: out(j, p, sum_k in[k*ss + p] * w[k*MID + j]), k in
// order (acc = acc + x*w), p < n.  A thread computes 4 pixels (strided by
// a quarter of the tile, so that a warp's pixels are consecutive) x 8
// outputs; w is in shared memory, 16-byte aligned.
template <int MID, typename Out>
__device__ __forceinline__ void pw_tile(const float* s_in, int ss,
                                        const float* s_w, int n, Out out) {
  constexpr int JO = 8, PX = 4, NJ = MID / JO;
  const int npg = (n + PX - 1) / PX;
  for (int it = threadIdx.x; it < npg * NJ; it += kThreads) {
    const int jg = it / npg, pg = it - jg * npg;
    bool ok[PX];
#pragma unroll
    for (int r = 0; r < PX; ++r) ok[r] = pg + r * npg < n;
    float acc[PX][JO];
#pragma unroll
    for (int r = 0; r < PX; ++r)
#pragma unroll
      for (int j = 0; j < JO; ++j) acc[r][j] = 0.f;
    const float* wk = s_w + jg * JO;
    const float* xk = s_in + pg;
#pragma unroll 4
    for (int k = 0; k < MID; ++k) {
      const float4 wa = *reinterpret_cast<const float4*>(wk + k * MID);
      const float4 wb = *reinterpret_cast<const float4*>(wk + k * MID + 4);
      const float wv[JO] = {wa.x, wa.y, wa.z, wa.w, wb.x, wb.y, wb.z, wb.w};
#pragma unroll
      for (int r = 0; r < PX; ++r) {
        const float xv = ok[r] ? xk[k * ss + r * npg] : 0.f;
#pragma unroll
        for (int j = 0; j < JO; ++j) acc[r][j] = acc[r][j] + xv * wv[j];
      }
    }
#pragma unroll
    for (int r = 0; r < PX; ++r)
      if (ok[r])
#pragma unroll
        for (int j = 0; j < JO; ++j) out(jg * JO + j, pg + r * npg, acc[r][j]);
  }
}

// Weight-gradient partial of the tile: dst[i*MID + o] = sum over p < n of
// a[i*ps + p] * c[o*ps + p].  The PG pixel groups' blocks are added in
// group order through s_comb (PG * MID * MID floats).  Every thread must
// call it.
template <int MID>
__device__ void dw_product(const float* s_a, const float* s_c, int ps, int n,
                           float* s_comb, float* dst) {
  constexpr int TI = DW<MID>::TI, RB = DW<MID>::RB, PG = DW<MID>::PG;
  const int grp = threadIdx.x / (TI * TI), rest = threadIdx.x - grp * TI * TI;
  const int ti = rest / TI, to = rest - ti * TI;
  float acc[RB][RB];
#pragma unroll
  for (int r = 0; r < RB; ++r)
#pragma unroll
    for (int s = 0; s < RB; ++s) acc[r][s] = 0.f;
  for (int p = grp; p < n; p += PG) {
    float av[RB], cv[RB];
#pragma unroll
    for (int r = 0; r < RB; ++r) av[r] = s_a[(ti * RB + r) * ps + p];
#pragma unroll
    for (int s = 0; s < RB; ++s) cv[s] = s_c[(to * RB + s) * ps + p];
#pragma unroll
    for (int r = 0; r < RB; ++r)
#pragma unroll
      for (int s = 0; s < RB; ++s) acc[r][s] = acc[r][s] + av[r] * cv[s];
  }
  float* out = PG > 1 ? s_comb + grp * MID * MID : dst;
#pragma unroll
  for (int r = 0; r < RB; ++r)
#pragma unroll
    for (int s = 0; s < RB; ++s)
      out[(ti * RB + r) * MID + to * RB + s] = acc[r][s];
  if (PG > 1) {
    __syncthreads();
    for (int e = threadIdx.x; e < MID * MID; e += kThreads) {
      float s = 0.f;
#pragma unroll
      for (int k = 0; k < PG; ++k) s += s_comb[k * MID * MID + e];
      dst[e] = s;
    }
  }
}

// ------------------------------------------------------------ forward

// The block input x_i = cat[x_{i-1}[:, 0::2], z], z = ReLU(BN3(u3)):
//   first block (u3 nullptr): x_0 = src, all C channels to dst (xsave[0]);
//   later blocks: z to dst[:, MID:] (the passthrough half was written by
//   the previous block's fwd_pw2_kernel), BN3's stats merged from fst3
//   (written to st3);
//   dst nullptr (the backward's recompute): x_i = src, nothing written.
// Then, when W1 is given, u1 = pw1(x_i[:, 1::2]) to u1 and, when fst1 is
// given, its tile moments to fst1.  Shared memory holds x_i's channels by
// row (only the rows needed), u1 going to the even rows once written out.
template <int MID>
__global__ void __launch_bounds__(kThreads, Occ<MID>::CTAS)
in_kernel(Geo G, const float* __restrict__ src, const float* __restrict__ u3,
          const float* __restrict__ fst3, const float* __restrict__ gb3,
          float* __restrict__ st3, float* __restrict__ dst,
          const float* __restrict__ W1, float* __restrict__ u1,
          float* __restrict__ fst1) {
  constexpr int C = 2 * MID, H = MID / 2;
  extern __shared__ __align__(16) float smem[];
  float* s_w = smem;                      // MID x MID
  float* s_c = s_w + MID * MID;           // BN3: mu, sinv*gamma, beta; scratch
  float* s_x = s_c + Smem<MID>::CONSTF;   // C x ps: x_i by channel
  const Tile T = make_tile(G, blockIdx.x);
  const size_t plane = (size_t)G.h * G.w;
  const float* sb = src + (size_t)T.b * C * plane;
  if (W1) async_copy<MID>(s_w, W1, MID * MID);
  if (!u3) {
    // all channels of x_i = src, or its odd ones (rows 1, 3, ...)
    if (dst) async_tile<C>(G, T, sb, plane, s_x, G.ps);
    else async_tile<MID>(G, T, sb + plane, 2 * plane, s_x + G.ps, 2 * G.ps);
  } else {
    // x_i's odd passthrough channels 2k+1 < MID (src's 4k+2) for pw1, and u3
    if (W1) async_tile<H>(G, T, sb + 2 * plane, 4 * plane, s_x + G.ps, 2 * G.ps);
    async_tile<MID>(G, T, u3 + (size_t)T.b * MID * plane, plane,
                    s_x + MID * G.ps, G.ps);
    bn_from_moments<MID>(G, T, fst3, gb3, st3, s_c);
  }
  cp_async_wait();
  __syncthreads();
  if (dst) {
    const int c_lo = u3 ? MID : 0;  // the channels this kernel writes
    if (u3) {
      float* s_z = s_x + MID * G.ps;
      tile_positions<MID>(T.n, [&](int p, int c0, int cstep) {
#pragma unroll 4
        for (int c = c0; c < MID; c += cstep)
          s_z[c * G.ps + p] = fmaxf(
              bn(s_z[c * G.ps + p], s_c[c], s_c[MID + c], s_c[2 * MID + c]),
              0.f);
      });
      __syncthreads();
    }
    tile_positions<C>(T.n, [&](int p, int c0, int cstep) {
      float* d = dst + (size_t)T.b * C * plane + pix(G, T, p);
#pragma unroll 4
      for (int c = c_lo + c0; c < C; c += cstep) d[c * plane] = s_x[c * G.ps + p];
    });
  }
  if (!W1) return;
  if (fst1) __syncthreads();  // u1 goes to the even rows, written out above
  pw_tile<MID>(s_x + G.ps, 2 * G.ps, s_w, T.n, [&](int j, int p, float v) {
    u1[((size_t)T.b * MID + j) * plane + pix(G, T, p)] = v;
    if (fst1) s_x[2 * j * G.ps + p] = v;
  });
  if (!fst1) return;
  __syncthreads();
  tile_moments<MID>(s_x, 2 * G.ps, T.n, fst1 + (size_t)T.t * 2 * MID,
                    s_c + 3 * MID);
}

// u2 = dw3x3(ReLU(BN1(u1))), BN1's stats merged from fst1 (written to
// st1); u2's tile moments to fst2.
template <int MID>
__global__ void __launch_bounds__(kThreads, Occ<MID>::CTAS)
fwd_dw_kernel(Geo G, const float* __restrict__ u1,
              const float* __restrict__ fst1, const float* __restrict__ row,
              float* __restrict__ st1, float* __restrict__ u2,
              float* __restrict__ fst2) {
  extern __shared__ __align__(16) float smem[];
  float* s_wd = smem;                     // 9 x MID
  float* s_c = s_wd + 9 * MID;            // BN1 constants, scratch
  float* s_y = s_c + Smem<MID>::CONSTF;   // MID x phs: y on the haloed tile
  float* s_u = s_y + MID * G.phs;         // MID x ps: u2
  const Tile T = make_tile(G, blockIdx.x);
  const size_t plane = (size_t)G.h * G.w;
  async_copy<MID>(s_wd, row + Row<MID>::WD, 9 * MID);
  async_halo<MID>(G, T, u1 + (size_t)T.b * MID * plane, s_y);
  bn_from_moments<MID>(G, T, fst1, row + Row<MID>::GB, st1, s_c);
  cp_async_wait();
  __syncthreads();
  halo_bn_relu<MID>(G, T, s_c, s_c + MID, s_c + 2 * MID, s_y);
  __syncthreads();
  tile_positions<MID>(T.n, [&](int p, int c0, int cstep) {
    const int h0 = tap(T, p, 0), hw = T.tw + 2;
    float* out = u2 + (size_t)T.b * MID * plane + pix(G, T, p);
    for (int c = c0; c < MID; c += cstep) {
      const float* yc = s_y + c * G.phs + h0;
      float acc = 0.f;
#pragma unroll
      for (int k = 0; k < 9; ++k)
        acc = acc + s_wd[k * MID + c] * yc[(k / 3) * hw + k % 3];
      out[c * plane] = acc;
      s_u[c * G.ps + p] = acc;
    }
  });
  __syncthreads();
  tile_moments<MID>(s_u, G.ps, T.n, fst2 + (size_t)T.t * 2 * MID,
                    s_c + 3 * MID);
}

// u3 = pw2(BN2(u2)), BN2's stats merged from fst2 (written to st2); u3's
// tile moments to fst3.  Meanwhile the warps that hold no pointwise work
// (all of them after it, if none is free) write the next block input's
// passthrough half: xnext[:, c] = x[:, 2c], c < MID (x = xsave[i]).
template <int MID>
__global__ void __launch_bounds__(kThreads, Occ<MID>::CTAS)
fwd_pw2_kernel(Geo G, const float* __restrict__ u2,
               const float* __restrict__ fst2, const float* __restrict__ row,
               float* __restrict__ st2, float* __restrict__ u3,
               float* __restrict__ fst3, const float* __restrict__ x,
               float* __restrict__ xnext) {
  constexpr int C = 2 * MID;
  extern __shared__ __align__(16) float smem[];
  float* s_w = smem;                      // MID x MID
  float* s_c = s_w + MID * MID;           // BN2 constants, scratch
  float* s_v = s_c + Smem<MID>::CONSTF;   // MID x ps: u2, then BN2(u2)
  float* s_u = s_v + MID * G.ps;          // MID x ps: u3
  const Tile T = make_tile(G, blockIdx.x);
  const size_t plane = (size_t)G.h * G.w;
  async_copy<MID>(s_w, row + Row<MID>::W2, MID * MID);
  async_tile<MID>(G, T, u2 + (size_t)T.b * MID * plane, plane, s_v, G.ps);
  bn_from_moments<MID>(G, T, fst2, row + Row<MID>::GB + 2 * MID, st2, s_c);
  cp_async_wait();
  __syncthreads();
  tile_positions<MID>(T.n, [&](int p, int c0, int cstep) {
#pragma unroll 4
    for (int c = c0; c < MID; c += cstep)
      s_v[c * G.ps + p] =
          bn(s_v[c * G.ps + p], s_c[c], s_c[MID + c], s_c[2 * MID + c]);
  });
  __syncthreads();
  // the passthrough copy: by the warps past pw_tile's items, or by all
  const int busy = min(kWarps, ((T.n + 3) / 4 * (MID / 8) + 31) / 32);
  const int warp = threadIdx.x >> 5;
  auto copy = [&](int first) {
    const int n0 = 32 * first, nthr = kThreads - n0;
    for (int p = threadIdx.x - n0; p < T.n; p += nthr) {
      const size_t q = (size_t)T.b * C * plane + pix(G, T, p);
      for (int cb = 0; cb < MID; cb += 8) {
        float v[8];
#pragma unroll
        for (int u = 0; u < 8; ++u) v[u] = x[q + 2 * (cb + u) * plane];
#pragma unroll
        for (int u = 0; u < 8; ++u) xnext[q + (cb + u) * plane] = v[u];
      }
    }
  };
  if (busy < kWarps && warp >= busy) copy(busy);
  pw_tile<MID>(s_v, G.ps, s_w, T.n, [&](int j, int p, float v) {
    u3[((size_t)T.b * MID + j) * plane + pix(G, T, p)] = v;
    s_u[j * G.ps + p] = v;
  });
  if (busy == kWarps) copy(0);
  __syncthreads();
  tile_moments<MID>(s_u, G.ps, T.n, fst3 + (size_t)T.t * 2 * MID,
                    s_c + 3 * MID);
}

// ------------------------------------------------------------ backward

// Recompute u2 = dw(ReLU(BN1(u1))) and u3 = pw2(BN2(u2)) with the saved
// stats st (3, G, 3, MID) and write both; then BN3's backward sums of the
// tile into its partial row: gz = gin[:, MID + j] where BN3(u3) > 0, sum
// gz*xhat3 (dgamma3) and sum gz (dbeta3).
template <int MID>
__global__ void __launch_bounds__(kThreads, Occ<MID>::CTAS)
rec_kernel(Geo G, const float* __restrict__ u1, const float* __restrict__ st,
           const float* __restrict__ row, const float* __restrict__ gin,
           float* __restrict__ u2, float* __restrict__ u3,
           float* __restrict__ part) {
  constexpr int C = 2 * MID, CW = MID / kWarps;
  extern __shared__ __align__(16) float smem[];
  float* s_w = smem;                      // MID x MID: w2
  float* s_wd = s_w + MID * MID;          // 9 x MID
  float* s_c = s_wd + 9 * MID;            // BN1, BN2, BN3 constants
  float* s_y = s_c + Smem<MID>::CONST;    // MID x phs: y, then u3 (ps)
  float* s_v = s_y + MID * G.phs;         // MID x ps: BN2(u2)
  const Tile T = make_tile(G, blockIdx.x);
  const size_t plane = (size_t)G.h * G.w;
  const size_t bnst = (size_t)G.G * 3 * MID;
  const float* gb = row + Row<MID>::GB;
  async_copy<MID>(s_w, row + Row<MID>::W2, MID * MID);
  async_copy<MID>(s_wd, row + Row<MID>::WD, 9 * MID);
  async_halo<MID>(G, T, u1 + (size_t)T.b * MID * plane, s_y);
  bn_saved<MID>(st, gb, T.gi, s_c);
  bn_saved<MID>(st + bnst, gb + 2 * MID, T.gi, s_c + 4 * MID);
  bn_saved<MID>(st + 2 * bnst, gb + 4 * MID, T.gi, s_c + 8 * MID);
  cp_async_wait();
  __syncthreads();
  halo_bn_relu<MID>(G, T, s_c, s_c + 2 * MID, s_c + 3 * MID, s_y);
  __syncthreads();
  const float* c2 = s_c + 4 * MID;
  tile_positions<MID>(T.n, [&](int p, int c0, int cstep) {
    const int h0 = tap(T, p, 0), hw = T.tw + 2;
    float* out = u2 + (size_t)T.b * MID * plane + pix(G, T, p);
    for (int c = c0; c < MID; c += cstep) {
      const float* yc = s_y + c * G.phs + h0;
      float acc = 0.f;
#pragma unroll
      for (int t = 0; t < 9; ++t)
        acc = acc + s_wd[t * MID + c] * yc[(t / 3) * hw + t % 3];
      out[c * plane] = acc;
      s_v[c * G.ps + p] = bn(acc, c2[c], c2[2 * MID + c], c2[3 * MID + c]);
    }
  });
  __syncthreads();
  float* s_u = s_y;
  pw_tile<MID>(s_v, G.ps, s_w, T.n, [&](int j, int p, float v) {
    u3[((size_t)T.b * MID + j) * plane + pix(G, T, p)] = v;
    s_u[j * G.ps + p] = v;
  });
  __syncthreads();
  // warp w: channels w, w + 8, ...; lanes over the pixels, the loads of
  // a pixel's CW channels issued together
  const float* c3 = s_c + 8 * MID;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  float s1[CW], s2[CW];
#pragma unroll
  for (int i = 0; i < CW; ++i) s1[i] = s2[i] = 0.f;
  const float* gz = gin + ((size_t)T.b * C + MID + warp) * plane;
  for (int p = lane; p < T.n; p += 32) {
    const int q = pix(G, T, p);
    float gv[CW];
#pragma unroll
    for (int i = 0; i < CW; ++i) gv[i] = gz[i * kWarps * plane + q];
#pragma unroll
    for (int i = 0; i < CW; ++i) {
      const int c = warp + i * kWarps;
      const float u = s_u[c * G.ps + p];
      const float g = bn(u, c3[c], c3[2 * MID + c], c3[3 * MID + c]) > 0.f ? gv[i] : 0.f;
      s1[i] += g;
      s2[i] += g * ((u - c3[c]) * c3[MID + c]);
    }
  }
  float* prow = part + (size_t)T.t * Row<MID>::LEN + Row<MID>::GB;
#pragma unroll
  for (int i = 0; i < CW; ++i) {
    const float a = warp_sum(s1[i]), b = warp_sum(s2[i]);
    if (lane == 0) {
      prow[4 * MID + warp + i * kWarps] = b;
      prow[5 * MID + warp + i * kWarps] = a;
    }
  }
}

// BN3 backward: du3 = (gamma3*sinv3)*(gz - mean gz - xhat3*mean gz*xhat3)
// with the group's means from the tiles' rows; dW2 partial = sum v (x)
// du3 (v = BN2(u2)); dv = w2 du3 to dv; BN2's backward sums of the tile:
// sum dv*xhat2 (dgamma2), sum dv (dbeta2).
template <int MID>
__global__ void __launch_bounds__(kThreads, Occ<MID>::CTAS)
bn3_kernel(Geo G, const float* __restrict__ u2, const float* __restrict__ u3,
           const float* __restrict__ st, const float* __restrict__ row,
           const float* __restrict__ gin, float* __restrict__ dv,
           float* __restrict__ part) {
  constexpr int C = 2 * MID, CW = MID / kWarps;
  extern __shared__ __align__(16) float smem[];
  float* s_w = smem;                      // MID x MID: w2 transposed
  float* s_c = s_w + MID * MID;           // BN2, BN3 constants, BN3 means
  float* s_v = s_c + Smem<MID>::CONST;    // MID x ps: u2, v, then dv
  float* s_du = s_v + MID * G.ps;         // MID x ps: u3, then du3
  float* s_comb = s_du + MID * G.ps;      // the dW product's groups
  const Tile T = make_tile(G, blockIdx.x);
  const size_t plane = (size_t)G.h * G.w;
  const size_t bnst = (size_t)G.G * 3 * MID;
  const float* gb = row + Row<MID>::GB;
  float* c2 = s_c;
  float* c3 = s_c + 4 * MID;
  float* a3 = s_c + 8 * MID;
  async_copy<MID, true>(s_w, row + Row<MID>::W2, MID * MID);
  async_tile<MID>(G, T, u2 + (size_t)T.b * MID * plane, plane, s_v, G.ps);
  async_tile<MID>(G, T, u3 + (size_t)T.b * MID * plane, plane, s_du, G.ps);
  bn_saved<MID>(st + bnst, gb + 2 * MID, T.gi, c2);
  bn_saved<MID>(st + 2 * bnst, gb + 4 * MID, T.gi, c3);
  bn_bwd_means<MID>(G, T, part, 4, a3, s_c + Smem<MID>::CONST - 8 * MID);
  cp_async_wait();
  __syncthreads();
  tile_positions<MID>(T.n, [&](int p, int c0, int cstep) {
    const float* gq = gin + ((size_t)T.b * C + MID) * plane + pix(G, T, p);
    for (int cb = c0; cb < MID; cb += 4 * cstep) {
      float gv[4];
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        const int c = cb + u * cstep;
        gv[u] = c < MID ? gq[c * plane] : 0.f;
      }
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        const int c = cb + u * cstep;
        if (c >= MID) break;
        const float uu = s_du[c * G.ps + p];
        const float g =
            bn(uu, c3[c], c3[2 * MID + c], c3[3 * MID + c]) > 0.f ? gv[u] : 0.f;
        const float xhat = (uu - c3[c]) * c3[MID + c];
        const float k3 = gb[4 * MID + c] * c3[MID + c];
        s_du[c * G.ps + p] = k3 * (g - a3[c] - xhat * a3[MID + c]);
        s_v[c * G.ps + p] =
            bn(s_v[c * G.ps + p], c2[c], c2[2 * MID + c], c2[3 * MID + c]);
      }
    }
  });
  __syncthreads();
  float* prow = part + (size_t)T.t * Row<MID>::LEN;
  dw_product<MID>(s_v, s_du, G.ps, T.n, s_comb, prow + Row<MID>::W2);
  __syncthreads();
  pw_tile<MID>(s_du, G.ps, s_w, T.n, [&](int i, int p, float v) {
    dv[((size_t)T.b * MID + i) * plane + pix(G, T, p)] = v;
    s_v[i * G.ps + p] = v;
  });
  __syncthreads();
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  float s1[CW], s2[CW];
#pragma unroll
  for (int i = 0; i < CW; ++i) s1[i] = s2[i] = 0.f;
  const float* uw = u2 + ((size_t)T.b * MID + warp) * plane;
  for (int p = lane; p < T.n; p += 32) {
    const int q = pix(G, T, p);
    float uv[CW];
#pragma unroll
    for (int i = 0; i < CW; ++i) uv[i] = uw[i * kWarps * plane + q];
#pragma unroll
    for (int i = 0; i < CW; ++i) {
      const int c = warp + i * kWarps;
      const float d = s_v[c * G.ps + p];
      s1[i] += d;
      s2[i] += d * ((uv[i] - c2[c]) * c2[MID + c]);
    }
  }
#pragma unroll
  for (int i = 0; i < CW; ++i) {
    const float a = warp_sum(s1[i]), b = warp_sum(s2[i]);
    if (lane == 0) {
      prow[Row<MID>::GB + 2 * MID + warp + i * kWarps] = b;
      prow[Row<MID>::GB + 3 * MID + warp + i * kWarps] = a;
    }
  }
}

// BN2 backward: du2 = (gamma2*sinv2)*(dv - mean dv - xhat2*mean dv*xhat2)
// on the haloed tile (0 off the image); the dw taps' gradients sum du2 *
// shifted y; dy = the transposed dw of du2 (taps 8-t), gy = dy where
// BN1(u1) > 0, to gy; BN1's backward sums: sum gy*xhat1 (dgamma1), sum gy
// (dbeta1).
template <int MID>
__global__ void __launch_bounds__(kThreads, Occ<MID>::CTAS)
bn2_kernel(Geo G, const float* __restrict__ u1, const float* __restrict__ u2,
           const float* __restrict__ dv, const float* __restrict__ st,
           const float* __restrict__ row, float* __restrict__ gy,
           float* __restrict__ part) {
  extern __shared__ __align__(16) float smem[];
  float* s_wd = smem;                     // 9 x MID
  float* s_c = s_wd + 9 * MID;            // BN1, BN2 constants, BN2 means
  float* s_d = s_c + Smem<MID>::CONST;    // MID x phs: dv, then du2
  float* s_y = s_d + MID * G.phs;         // MID x phs: u1, then y
  const Tile T = make_tile(G, blockIdx.x);
  const size_t plane = (size_t)G.h * G.w;
  const size_t bnst = (size_t)G.G * 3 * MID;
  const float* gb = row + Row<MID>::GB;
  float* c1 = s_c;
  float* c2 = s_c + 4 * MID;
  float* a2 = s_c + 8 * MID;
  async_copy<MID>(s_wd, row + Row<MID>::WD, 9 * MID);
  async_halo<MID>(G, T, u1 + (size_t)T.b * MID * plane, s_y);
  async_halo<MID>(G, T, dv + (size_t)T.b * MID * plane, s_d);
  bn_saved<MID>(st, gb, T.gi, c1);
  bn_saved<MID>(st + bnst, gb + 2 * MID, T.gi, c2);
  bn_bwd_means<MID>(G, T, part, 2, a2, s_c + Smem<MID>::CONST - 8 * MID);
  cp_async_wait();
  __syncthreads();
  // du2 on the haloed tile: u2 from device memory, the loads of 4
  // channels issued together
  const int hw = T.tw + 2, nh = (T.th + 2) * hw;
  tile_positions<MID>(nh, [&](int hp, int c0, int cstep) {
    const int hy = hp / hw;
    const int y = T.r0 - 1 + hy, x = T.c0 - 1 + hp - hy * hw;
    if (!(y >= 0 && y < G.h && x >= 0 && x < G.w)) return;
    const float* uq = u2 + (size_t)T.b * MID * plane + y * G.w + x;
    for (int cb = c0; cb < MID; cb += 4 * cstep) {
      float uv[4];
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        const int c = cb + u * cstep;
        uv[u] = c < MID ? uq[c * plane] : 0.f;
      }
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        const int c = cb + u * cstep;
        if (c >= MID) break;
        const float xhat = (uv[u] - c2[c]) * c2[MID + c];
        const float k2 = gb[2 * MID + c] * c2[MID + c];
        s_d[c * G.phs + hp] =
            k2 * (s_d[c * G.phs + hp] - a2[c] - xhat * a2[MID + c]);
      }
    }
  });
  // y = ReLU(BN1(u1)) in place; xhat1 below reads u1 from device memory
  halo_bn_relu<MID>(G, T, c1, c1 + 2 * MID, c1 + 3 * MID, s_y);
  __syncthreads();
  float* prow = part + (size_t)T.t * Row<MID>::LEN;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  for (int c = warp; c < MID; c += kWarps) {
    const float* yc = s_y + c * G.phs;
    const float* dc = s_d + c * G.phs;
    const float* uc = u1 + ((size_t)T.b * MID + c) * plane;
    float* gyc = gy + ((size_t)T.b * MID + c) * plane;
    float tg[9];
#pragma unroll
    for (int t = 0; t < 9; ++t) tg[t] = 0.f;
    float s1 = 0.f, s2 = 0.f;
    for (int p = lane; p < T.n; p += 32) {
      const int q = pix(G, T, p);
      const float uv = uc[q];
      const int h0 = tap(T, p, 0);
      const float d0 = dc[h0 + hw + 1];
      float acc = 0.f;
#pragma unroll
      for (int t = 0; t < 9; ++t) {
        const int at = h0 + (t / 3) * hw + t % 3;
        tg[t] = tg[t] + d0 * yc[at];
        acc = acc + s_wd[(8 - t) * MID + c] * dc[at];
      }
      // y > 0 exactly where BN1(u1) > 0
      const float gv = yc[h0 + hw + 1] > 0.f ? acc : 0.f;
      gyc[q] = gv;
      s1 += gv;
      s2 += gv * ((uv - c1[c]) * c1[MID + c]);
    }
#pragma unroll
    for (int t = 0; t < 9; ++t) tg[t] = warp_sum(tg[t]);
    s1 = warp_sum(s1);
    s2 = warp_sum(s2);
    if (lane == 0) {
#pragma unroll
      for (int t = 0; t < 9; ++t) prow[Row<MID>::WD + t * MID + c] = tg[t];
      prow[Row<MID>::GB + c] = s2;
      prow[Row<MID>::GB + MID + c] = s1;
    }
  }
}

// BN1 backward: du1 = (gamma1*sinv1)*(gy - mean gy - xhat1*mean gy*xhat1);
// dW1 partial = sum x[:, 1::2] (x) du1; gout's odd channels w1 du1, its
// even channels gin[:, :MID] (the passthrough's gradient).
template <int MID>
__global__ void __launch_bounds__(kThreads, Occ<MID>::CTAS)
bn1_kernel(Geo G, const float* __restrict__ x, const float* __restrict__ u1,
           const float* __restrict__ gy, const float* __restrict__ st,
           const float* __restrict__ row, const float* __restrict__ gin,
           float* __restrict__ gout, float* __restrict__ part) {
  constexpr int C = 2 * MID;
  extern __shared__ __align__(16) float smem[];
  float* s_w = smem;                      // MID x MID: w1 transposed
  float* s_c = s_w + MID * MID;           // BN1 constants, BN1 means
  float* s_x = s_c + Smem<MID>::CONST;    // MID x ps: x's odd channels
  float* s_du = s_x + MID * G.ps;         // MID x ps: gy, then du1
  float* s_comb = s_du + MID * G.ps;      // the dW product's groups
  const Tile T = make_tile(G, blockIdx.x);
  const size_t plane = (size_t)G.h * G.w;
  const float* gb = row + Row<MID>::GB;
  float* c1 = s_c;
  float* a1 = s_c + 4 * MID;
  async_copy<MID, true>(s_w, row + Row<MID>::W1, MID * MID);
  async_tile<MID>(G, T, x + (size_t)T.b * C * plane + plane, 2 * plane, s_x,
                  G.ps);
  async_tile<MID>(G, T, gy + (size_t)T.b * MID * plane, plane, s_du, G.ps);
  bn_saved<MID>(st, gb, T.gi, c1);
  bn_bwd_means<MID>(G, T, part, 0, a1, s_c + Smem<MID>::CONST - 8 * MID);
  // dx's even channels, the passthrough's gradient, meanwhile
  tile_positions<MID>(T.n, [&](int p, int c0, int cstep) {
    const size_t q = (size_t)T.b * C * plane + pix(G, T, p);
    for (int cb = c0; cb < MID; cb += 4 * cstep) {
      float v[4];
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        const int c = cb + u * cstep;
        v[u] = c < MID ? gin[q + c * plane] : 0.f;
      }
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        const int c = cb + u * cstep;
        if (c < MID) gout[q + 2 * c * plane] = v[u];
      }
    }
  });
  cp_async_wait();
  __syncthreads();
  tile_positions<MID>(T.n, [&](int p, int c0, int cstep) {
    const float* uq = u1 + (size_t)T.b * MID * plane + pix(G, T, p);
    for (int cb = c0; cb < MID; cb += 4 * cstep) {
      float uv[4];
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        const int c = cb + u * cstep;
        uv[u] = c < MID ? uq[c * plane] : 0.f;
      }
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        const int c = cb + u * cstep;
        if (c >= MID) break;
        const float xhat = (uv[u] - c1[c]) * c1[MID + c];
        const float k1 = gb[c] * c1[MID + c];
        s_du[c * G.ps + p] = k1 * (s_du[c * G.ps + p] - a1[c] - xhat * a1[MID + c]);
      }
    }
  });
  __syncthreads();
  float* prow = part + (size_t)T.t * Row<MID>::LEN;
  dw_product<MID>(s_x, s_du, G.ps, T.n, s_comb, prow + Row<MID>::W1);
  pw_tile<MID>(s_du, G.ps, s_w, T.n, [&](int i, int p, float v) {
    gout[((size_t)T.b * C + 2 * i + 1) * plane + pix(G, T, p)] = v;
  });
}

// dblocks[i][j] = the sum of column j over the P partial rows of block i:
// a CTA per (32 columns, block); warp k sums the rows r = k (mod 8) in
// order, and the 8 sums are added in warp order.
__global__ void __launch_bounds__(kThreads)
reduce_rows_kernel(const float* __restrict__ part, float* __restrict__ out,
                   int prows, int len) {
  __shared__ float red[kWarps][32];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int i = blockIdx.y, j = blockIdx.x * 32 + lane;
  float s = 0.f;
  if (j < len) {
    const float* p = part + (size_t)i * prows * len + j;
#pragma unroll 4
    for (int r = warp; r < prows; r += kWarps) s += p[(size_t)r * len];
  }
  red[warp][lane] = s;
  __syncthreads();
  if (warp == 0 && j < len) {
    float t = 0.f;
#pragma unroll
    for (int k = 0; k < kWarps; ++k) t += red[k][lane];
    out[(size_t)i * len + j] = t;
  }
}

#define FASTDET_CHECK()                          \
  do {                                           \
    cudaError_t e_ = cudaGetLastError();         \
    if (e_ != cudaSuccess) return (int)e_;       \
  } while (0)

// Allow a kernel the dynamic shared memory it is launched with.
template <typename K>
cudaError_t allow_smem(K kernel, size_t bytes) {
  if (bytes <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(kernel,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              (int)bytes);
}

#define FASTDET_LAUNCH(kernel, floats, s, ...)                         \
  do {                                                                 \
    const size_t bytes_ = (floats) * sizeof(float);                    \
    cudaError_t e_ = allow_smem(kernel, bytes_);                       \
    if (e_ != cudaSuccess) return (int)e_;                             \
    kernel<<<G.ntiles, kThreads, bytes_, s>>>(__VA_ARGS__);            \
    FASTDET_CHECK();                                                   \
  } while (0)

template <int MID>
size_t fwd_scratch(const Geo& G) {
  return 3 * (size_t)G.b * MID * G.h * G.w + 3 * (size_t)G.ntiles * 2 * MID;
}

// u1, u2, u3, dv, gy, the block-to-block gradient, the partial rows
template <int MID>
size_t bwd_scratch(const Geo& G, int nblk) {
  const size_t half = (size_t)G.b * MID * G.h * G.w;
  return 7 * half + (size_t)nblk * G.ntiles * Row<MID>::LEN;
}

template <int MID>
int span_fwd(const float* x, const float* blocks, float* out, float* xsave,
             float* stats, float* scratch, const Geo& G, int nblk,
             cudaStream_t s) {
  constexpr int C = 2 * MID, LEN = Row<MID>::LEN;
  const size_t act = (size_t)G.b * C * G.h * G.w;
  const size_t half = act / 2;
  const size_t bnst = (size_t)G.G * 3 * MID;   // floats of one BN's stats
  const size_t slot = (size_t)G.ntiles * 2 * MID;
  float* u1 = scratch;
  float* u2 = u1 + half;
  float* u3 = u2 + half;
  float* fst1 = u3 + half;
  float* fst2 = fst1 + slot;
  float* fst3 = fst2 + slot;
  const auto k_in = in_kernel<MID>;
  const auto k_dw = fwd_dw_kernel<MID>;
  const auto k_pw2 = fwd_pw2_kernel<MID>;
  for (int i = 0; i <= nblk; ++i) {
    const float* row = blocks + (size_t)i * LEN;
    float* st = stats + (size_t)i * 3 * bnst;
    const bool last = i == nblk;
    const float* prev = i ? blocks + (size_t)(i - 1) * LEN : nullptr;
    float* xi = last ? out : xsave + i * act;
    FASTDET_LAUNCH(k_in, Smem<MID>::in(G), s, G,
                   i ? xsave + (i - 1) * act : x, i ? u3 : nullptr, fst3,
                   i ? prev + Row<MID>::GB + 4 * MID : nullptr,
                   i ? st - bnst : nullptr, xi,
                   last ? nullptr : row + Row<MID>::W1, u1, fst1);
    if (last) break;
    FASTDET_LAUNCH(k_dw, Smem<MID>::fdw(G), s, G, u1, fst1, row, st, u2,
                   fst2);
    FASTDET_LAUNCH(k_pw2, Smem<MID>::fpw2(G), s, G, u2, fst2, row, st + bnst,
                   u3, fst3, xi, i + 1 < nblk ? xsave + (i + 1) * act : out);
  }
  return 0;
}

// The backward's five launches for block i: its gradient in gin, out to
// gout.
template <int MID>
int bwd_block(const Geo& G, const float* xi, const float* st,
              const float* row, const float* gin, float* gout, float* u1,
              float* u2, float* u3, float* dv, float* gy, float* pi,
              cudaStream_t s) {
  const auto k_in = in_kernel<MID>;
  const auto k_rec = rec_kernel<MID>;
  const auto k_bn3 = bn3_kernel<MID>;
  const auto k_bn2 = bn2_kernel<MID>;
  const auto k_bn1 = bn1_kernel<MID>;
  FASTDET_LAUNCH(k_in, Smem<MID>::in(G), s, G, xi, nullptr, nullptr, nullptr,
                 nullptr, (float*)nullptr, row + Row<MID>::W1, u1, nullptr);
  FASTDET_LAUNCH(k_rec, Smem<MID>::rec(G), s, G, u1, st, row, gin, u2, u3,
                 pi);
  FASTDET_LAUNCH(k_bn3, Smem<MID>::bn3(G), s, G, u2, u3, st, row, gin, dv,
                 pi);
  FASTDET_LAUNCH(k_bn2, Smem<MID>::bn2(G), s, G, u1, u2, dv, st, row, gy,
                 pi);
  FASTDET_LAUNCH(k_bn1, Smem<MID>::bn1(G), s, G, xi, u1, gy, st, row, gin,
                 gout, pi);
  return 0;
}

template <int MID>
int span_bwd(const float* dy, const float* xsave, const float* stats,
             const float* blocks, float* dx, float* dblocks, float* scratch,
             const Geo& G, int nblk, cudaStream_t s) {
  constexpr int C = 2 * MID, LEN = Row<MID>::LEN;
  const size_t act = (size_t)G.b * C * G.h * G.w;
  const size_t half = act / 2;
  const size_t bnst = (size_t)G.G * 3 * MID;
  float* u1 = scratch;
  float* u2 = u1 + half;
  float* u3 = u2 + half;
  float* dv = u3 + half;
  float* gy = dv + half;
  float* tmp = gy + half;                    // (B, C, h, w): ping-pong with dx
  float* part = tmp + act;                   // (nblk, ntiles, LEN)
  const float* gf = nullptr;                 // the gradient of block i+1
  for (int i = nblk - 1; i >= 0; --i) {
    const float* row = blocks + (size_t)i * LEN;
    const float* xi = xsave + i * act;
    const float* st = stats + (size_t)i * 3 * bnst;
    float* pi = part + (size_t)i * G.ntiles * LEN;
    // the gradients ping-pong between dx and tmp; block 0 writes dx
    float* gout = (i % 2 == 0) ? dx : tmp;
    const int rc = bwd_block<MID>(G, xi, st, row, gf ? gf : dy, gout, u1, u2,
                                  u3, dv, gy, pi, s);
    gf = gout;
    if (rc) return rc;
  }
  reduce_rows_kernel<<<dim3((LEN + 31) / 32, nblk), kThreads, 0, s>>>(
      part, dblocks, G.ntiles, LEN);
  FASTDET_CHECK();
  return 0;
}

size_t most_smem(int c, const Geo& G, bool backward) {
  switch (c) {
    case 48: return Smem<24>::most(G, backward) * sizeof(float);
    case 96: return Smem<48>::most(G, backward) * sizeof(float);
    default: return Smem<96>::most(G, backward) * sizeof(float);
  }
}

bool valid(int b, int c, int h, int w, int nblk, int g, int tr, int tc,
           bool backward) {
  if (b < 1 || h < 1 || w < 1 || nblk < 1 || g < 1 || b % g) return false;
  if (c != 48 && c != 96 && c != 192) return false;
  if (tr < 1 || tr > h || tc < 1 || tc > w) return false;
  if ((size_t)b * c * h * w >= (size_t)1 << 31) return false;
  return most_smem(c, make_geo(b, h, w, g, tr, tc), backward) <= kSmemLimit;
}

int span_fwd_c(const float* x, const float* blocks, float* out, float* xsave,
               float* stats, float* scratch, int b, int c, int h, int w,
               int nblk, int g, int tr, int tc, void* stream) {
  if (!valid(b, c, h, w, nblk, g, tr, tc, false)) return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  const Geo G = make_geo(b, h, w, g, tr, tc);
  switch (c) {
    case 48: return span_fwd<24>(x, blocks, out, xsave, stats, scratch, G, nblk, s);
    case 96: return span_fwd<48>(x, blocks, out, xsave, stats, scratch, G, nblk, s);
    default: return span_fwd<96>(x, blocks, out, xsave, stats, scratch, G, nblk, s);
  }
}

int span_bwd_c(const float* dy, const float* xsave, const float* stats,
               const float* blocks, float* dx, float* dblocks, float* scratch,
               int b, int c, int h, int w, int nblk, int g, int tr, int tc,
               void* stream) {
  if (!valid(b, c, h, w, nblk, g, tr, tc, true)) return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  const Geo G = make_geo(b, h, w, g, tr, tc);
  switch (c) {
    case 48: return span_bwd<24>(dy, xsave, stats, blocks, dx, dblocks, scratch, G, nblk, s);
    case 96: return span_bwd<48>(dy, xsave, stats, blocks, dx, dblocks, scratch, G, nblk, s);
    default: return span_bwd<96>(dy, xsave, stats, blocks, dx, dblocks, scratch, G, nblk, s);
  }
}

size_t bwd_scratch_c(int b, int c, int h, int w, int nblk, int g, int tr,
                     int tc) {
  if (!valid(b, c, h, w, nblk, g, tr, tc, true)) return 0;
  const Geo G = make_geo(b, h, w, g, tr, tc);
  switch (c) {
    case 48: return bwd_scratch<24>(G, nblk);
    case 96: return bwd_scratch<48>(G, nblk);
    default: return bwd_scratch<96>(G, nblk);
  }
}

}  // namespace

extern "C" {

// Bytes of shared memory of the forward's (backward 0) or the backward's
// (1) kernel that uses the most at tiles of tr x tc pixels.
size_t fastdet_span_train_smem(int c, int h, int w, int tr, int tc,
                               int backward) {
  if (c != 48 && c != 96 && c != 192) return 0;
  return most_smem(c, make_geo(1, h, w, 1, tr, tc), backward != 0);
}

// Floats of scratch that fastdet_span_train_fwd needs (0 if invalid).
size_t fastdet_span_train_fwd_scratch(int b, int c, int h, int w, int nblk,
                                      int g, int tr, int tc) {
  if (!valid(b, c, h, w, nblk, g, tr, tc, false)) return 0;
  const Geo G = make_geo(b, h, w, g, tr, tc);
  switch (c) {
    case 48: return fwd_scratch<24>(G);
    case 96: return fwd_scratch<48>(G);
    default: return fwd_scratch<96>(G);
  }
}

// x (B, C, h, w) f32 -> out (B, C, h, w), xsave (nblk, B, C, h, w) block
// inputs, stats (nblk, 3, B/g, 3, C/2); blocks (nblk, 2*MID^2 + 15*MID);
// tiles of tr x tc pixels.  All on the card.  Returns a cudaError_t (0 =
// launched).
int fastdet_span_train_fwd(const float* x, const float* blocks, float* out,
                           float* xsave, float* stats, float* scratch, int b,
                           int c, int h, int w, int nblk, int g, int tr,
                           int tc, void* stream) {
  return span_fwd_c(x, blocks, out, xsave, stats, scratch, b, c, h, w, nblk,
                    g, tr, tc, stream);
}

// Floats of scratch that fastdet_span_train_bwd needs (0 if invalid).
size_t fastdet_span_train_bwd_scratch(int b, int c, int h, int w, int nblk,
                                      int g, int tr, int tc) {
  return bwd_scratch_c(b, c, h, w, nblk, g, tr, tc);
}

// dy (B, C, h, w), xsave, stats and blocks as the forward's -> dx (B, C,
// h, w), dblocks (nblk, row).  dy is not written.
int fastdet_span_train_bwd(const float* dy, const float* xsave,
                           const float* stats, const float* blocks, float* dx,
                           float* dblocks, float* scratch, int b, int c, int h,
                           int w, int nblk, int g, int tr, int tc,
                           void* stream) {
  return span_bwd_c(dy, xsave, stats, blocks, dx, dblocks, scratch, b, c, h,
                    w, nblk, g, tr, tc, stream);
}

const char* fastdet_cuda_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
