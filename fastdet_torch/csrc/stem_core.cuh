// The u8 stem kernel for Hopper (sm_90a), shared by the s2d(4) and s2d(8)
// entry points (stem_s2d.cu, stem_s2d8.cu): conv3x3 stride 2 (3 -> 24,
// /255 and BN folded into the weight) + ReLU + maxpool 3x3 stride 2, from
// the host's uint8 space-to-depth(k) planes to the pooled map
// (B, 24, H/4, W/4) f32, NCHW.
//
// Replaces the Pallas TPU kernels of fastdet/kernels/fused_infer.py:
// _stem_call (_stem_kernel/_stem_body), _stem_call_chunked (its row-chunked
// form for large images) and _stem8_call (_stem8_kernel/_stem8_body).  The
// TPU's (192, 96) and (768, 384) phase matrices, its row chunks and its
// phase-packed s2d(8) output are not carried over.
//
// What bounds it: at b128 352^2 the f32 operations (27 MACs per conv output,
// 40.1 MFLOP an image) take 0.077 ms at the card's 67 TFLOP/s and the bytes
// (47.6 MB of u8 in, 95.2 MB of f32 out) 0.043 ms at 3.35 TB/s.  The design
// moves the conv to the tensor cores, where the operations fall under the
// bytes, and keeps the loads coalesced and the conv map out of memory:
//   * the pooled map is cut into tiles of `rows` pooled rows x 7*`strips`
//     pooled columns; a persistent CTA (two an SM) walks every
//     gridDim-th tile.  It stages a tile's pixels with a halo of 4 pixel
//     rows above and 4 columns to the left (zero outside the image: the
//     conv's zero pad) into shared memory as f16 image planes [c][y][x].
//     The s2d(k) planes hold a tile's rows as contiguous runs of lanes;
//     each thread copies one 4-byte word (4 lanes) from each of the k xoff
//     planes of one (yoff, c), coalesced across the warp, into a raw
//     buffer with cp.async, the next tile's while the CTA convolves this
//     one, and then unpacks them into k/4 groups of 4 pixels a lane.  The
//     unpacking is the only code that differs between the two factors;
//   * u8 -> f16 is exact: 0x6400 | x is the f16 1024 + x, less 1024;
//   * the conv is an implicit GEMM on mma.sync m16n8k16 (f16 in, f32
//     accumulate): M = 16 conv outputs (8 cells x the two column phases),
//     K = the 27 taps padded to 32, N = 3 tiles of 8 channels.  The
//     weights keep f32 accuracy as two f16 terms w_hi + w_lo, taken on the
//     host from w * 2^e (a power of two a channel, so that both terms are
//     normal f16); the bias seeds the accumulator as b * 2^e, and 2^-e is
//     applied after the pool (ReLU and max commute with it exactly).  A
//     CTA copies the weight block to shared memory once: the lanes'
//     fragments differ, which the constant bank serves one at a time;
//   * one warp owns a strip of 8 cells, the first the strip's left halo,
//     and walks down the tile's pooled rows.  Pooled (i, j) is the max of
//     conv rows 2i-1..2i+1 and columns 2j-1..2j+1: the warp keeps the
//     previous row's py=1 conv outputs in registers, a lane holds both
//     column phases of its cell, and the left cell's px=1 column max comes
//     by one shuffle.  No conv map is kept anywhere;
//   * the pool's -inf pad reaches only the top and left edges.  There the
//     halo stands in as 0: every pooled window also holds a real ReLU
//     output, which is >= 0, so a 0 never wins.
// Halo work: 8/7 of the columns and (2*rows+1)/(2*rows) of the conv rows.
//
// The bf16 form (BF16 = true; the JAX package's bf16 serving): the image
// planes hold bf16 pixels (u8 -> bf16 is exact for 0-255), each weight is
// the bf16 of the folded weight with /255 in it, as the JAX package casts
// its phase matrix, so one mma.sync m16n8k16 bf16 term a product, f32
// accumulate, computes its products exactly; the bias seeds the
// accumulator, no 2^e scale.  ReLU, the pool on the f32 values and one
// rounding to bf16 at the store (round-to-nearest is monotone, so pooling
// before rounding equals pooling the rounded values, as JAX pools them).
// The output is (B, 24, H/4, W/4) bf16: half the bytes of the f32 map.

#pragma once

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>
#include <string.h>

#include <type_traits>

namespace {

constexpr int kCout = 24;
constexpr int kTaps = 27;          // K order (ky, kx, c): the HWIO weight's
constexpr int kStripCells = 7;     // own pooled cells a warp
constexpr int kMaxStrips = 8;      // warps a CTA
constexpr int kMaxRows = 64;       // pooled rows a tile
constexpr int kFrag = 24;          // B registers a lane: 3 n x 2 k x 2 x 2 terms
constexpr int kSmemLimit = 227 * 1024;

struct StemParams {
  uint32_t frag[kFrag][32];  // f16 pairs, [register][lane]
  float seed[kCout];         // b * 2^e
  float unscale[kCout];      // 2^-e
};

// ---------------------------------------------------------- the layout

// f16 elements of one pixel row of the tile (a halo of 8 columns to the
// left, of which 4 are staged), made = 32 modulo 64 so that the A loads of
// one MMA meet at most two-way bank conflicts
inline __host__ __device__ int stem_row_stride(int strips) {
  const int need = 8 + 4 * kStripCells * strips;
  return need + (((32 - need) % 64) + 64) % 64;
}

inline __host__ __device__ int stem_tile_rows(int rows) {  // pixel rows
  return 4 * rows + 4;
}

inline __host__ __device__ int stem_plane_stride(int rows, int strips) {
  return stem_tile_rows(rows) * stem_row_stride(strips) + 16;
}

// words of the raw buffer: K words a task, for the most tasks a tile of
// `rows` x 7*`strips` cells can have at any offset
inline __host__ __device__ int stem_raw_words(int rows, int strips, int k) {
  const int urows = (4 * rows + 4 + k - 1) / k + 1;
  const int lanes = (4 * kStripCells * strips + 4 + k - 1) / k + 1;
  return urows * 3 * k * ((lanes + 3) / 4 + 1) * k;
}

inline __host__ __device__ size_t stem_smem_bytes(int rows, int strips,
                                                  int k) {
  return 2 * (size_t)3 * stem_plane_stride(rows, strips)
         + sizeof(uint32_t) * (stem_raw_words(rows, strips, k) + kFrag * 32)
         + sizeof(float) * 2 * kCout;
}

// ---------------------------------------------------------- the device

// f16 pair (lo = byte l of a, hi = byte l of b), both exact
__device__ __forceinline__ uint32_t u8_pair(uint32_t a, uint32_t b, int l) {
  uint32_t t = __byte_perm(a, b, (unsigned)(l | ((l + 4) << 8)));
  t = (t & 0x00FF00FFu) | 0x64006400u;           // 1024 + x, twice
  __half2 h = *reinterpret_cast<__half2*>(&t);
  h = __hsub2(h, __float2half2_rn(1024.f));
  return *reinterpret_cast<uint32_t*>(&h);
}

// bf16 pair (lo = byte l of a, hi = byte l of b), both exact
__device__ __forceinline__ uint32_t u8_pair_bf16(uint32_t a, uint32_t b,
                                                 int l) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(
      (float)((a >> (8 * l)) & 0xFFu), (float)((b >> (8 * l)) & 0xFFu));
  return *reinterpret_cast<const uint32_t*>(&h);
}

template <bool BF16>
__device__ __forceinline__ uint32_t pixel_pair(uint32_t a, uint32_t b,
                                               int l) {
  if constexpr (BF16) return u8_pair_bf16(a, b, l);
  else return u8_pair(a, b, l);
}

// A tile's staging geometry: pixel rows [4*i0-4, 4*i0+4*rows) x columns
// [4*v0-4, 4*v0+28*strips) clipped to the image, as tasks (s2d row u,
// yoff, c, word) that each move one 4-byte word (4 lanes) of each of the
// K xoff planes of (yoff, c).  Task t's words sit in the raw buffer at
// raw[q * stride + t], q the xoff.
struct TileGeom {
  int i0, v0, y_lo, y_hi, x_lo, x_hi, u_lo, l_lo, l_hi, nw, ntask;
};

template <int K>
__device__ __forceinline__ TileGeom tile_geom(int hk, int wk, int i0, int v0,
                                              int rows, int strips) {
  TileGeom g;
  g.i0 = i0;
  g.v0 = v0;
  g.y_lo = max(4 * i0 - 4, 0);
  g.y_hi = min(4 * (i0 + rows), K * hk);
  g.x_lo = max(4 * v0 - 4, 0);
  g.x_hi = min(4 * v0 + 4 * kStripCells * strips, K * wk);
  g.u_lo = g.y_lo / K;
  g.l_lo = g.x_lo / K;
  g.l_hi = (g.x_hi + K - 1) / K;
  g.nw = (g.l_hi - g.l_lo + 3) / 4 + 1;           // words a lane run, at most
  g.ntask = ((g.y_hi + K - 1) / K - g.u_lo) * 3 * K * g.nw;
  return g;
}

// Task t of tile g → (plane of xoff 0, word, s2d row u, yoff, c); false
// where the task has no word of the tile
template <int K>
__device__ __forceinline__ bool tile_task(const TileGeom& g, int wk, int t,
                                          int& plane, int& w, int& u,
                                          int& yoff, int& c) {
  const int wi = t % g.nw;
  int r = t / g.nw;
  c = r % 3;
  r /= 3;
  yoff = r % K;
  u = g.u_lo + r / K;
  const int y = K * u + yoff;
  w = ((u * wk + g.l_lo) >> 2) + wi;
  plane = yoff * 3 * K + c;
  return y >= g.y_lo && y < g.y_hi && 4 * w < u * wk + g.l_hi;
}

__device__ __forceinline__ void stem_cp_async4(uint32_t* dst,
                                               const uint32_t* src) {
  const unsigned d = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(d),
               "l"(src));
}

__device__ __forceinline__ void stem_cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

__device__ __forceinline__ void stem_cp_async_wait_all() {
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}

// Start the copies of tile g's plane words into the raw buffer.
template <int K>
__device__ void issue_tile(const uint8_t* __restrict__ xb, uint32_t* raw,
                           int stride, const TileGeom& g, int wk, int npad) {
  const size_t xoff_stride = (size_t)3 * npad / 4;   // words between xoff
  for (int t = threadIdx.x; t < g.ntask; t += blockDim.x) {
    int plane, w, u, yoff, c;
    if (!tile_task<K>(g, wk, t, plane, w, u, yoff, c)) continue;
    const uint32_t* src =
        reinterpret_cast<const uint32_t*>(xb + (size_t)plane * npad) + w;
#pragma unroll
    for (int q = 0; q < K; ++q)
      stem_cp_async4(raw + q * stride + t, src + q * xoff_stride);
  }
}

// Unpack tile g's words into s_img[c][ys][xs] (ys = y - 4*i0 + 4,
// xs = x - 4*v0 + 8), 4 pixels of a row a store, as exact f16; 0 for the
// halo above and left of the image.
template <int K, bool BF16>
__device__ void unpack_tile(const uint32_t* raw, int stride, __half* s_img,
                            const TileGeom& g, int wk, int rows, int rs,
                            int ps) {
  for (int t = threadIdx.x; t < g.ntask; t += blockDim.x) {
    int plane, w, u, yoff, c;
    if (!tile_task<K>(g, wk, t, plane, w, u, yoff, c)) continue;
    uint32_t p[K];
#pragma unroll
    for (int q = 0; q < K; ++q) p[q] = raw[q * stride + t];
    const int first = u * wk + g.l_lo, last = u * wk + g.l_hi;
    const int row = c * ps + (K * u + yoff - 4 * g.i0 + 4) * rs
                    - 4 * g.v0 + 8;
#pragma unroll
    for (int l = 0; l < 4; ++l) {
      const int lane = 4 * w + l;
      if (lane < first || lane >= last) continue;
      const int x0 = K * (lane - u * wk);
#pragma unroll
      for (int q = 0; q < K / 4; ++q) {
        const int x = x0 + 4 * q;
        if (x < g.x_lo || x >= g.x_hi) continue;
        *reinterpret_cast<uint2*>(s_img + row + x) =
            make_uint2(pixel_pair<BF16>(p[4 * q], p[4 * q + 1], l),
                       pixel_pair<BF16>(p[4 * q + 2], p[4 * q + 3], l));
      }
    }
  }
  const int rows_px = stem_tile_rows(rows);
  if (g.i0 == 0)
    for (int t = threadIdx.x; t < 3 * rs; t += blockDim.x) {
      const int c = t / rs, e = t - c * rs;       // 4 rows of rs, 4 a store
      *reinterpret_cast<uint2*>(s_img + c * ps + 4 * e) = make_uint2(0, 0);
    }
  if (g.v0 == 0)
    for (int t = threadIdx.x; t < 3 * rows_px * 2; t += blockDim.x) {
      const int c = t / (rows_px * 2), e = t - c * rows_px * 2;
      *reinterpret_cast<uint2*>(s_img + c * ps + (e >> 1) * rs
                                + 4 * (e & 1)) = make_uint2(0, 0);
    }
}

__device__ __forceinline__ void mma_f16(float (&d)[4], uint32_t a0,
                                        uint32_t a1, uint32_t a2,
                                        uint32_t a3, uint32_t b0,
                                        uint32_t b1) {
  asm("mma.sync.aligned.m16n8k16.row.col.f32.f16.f16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "r"(b0), "r"(b1));
}

__device__ __forceinline__ void mma_bf16(float (&d)[4], uint32_t a0,
                                         uint32_t a1, uint32_t a2,
                                         uint32_t a3, uint32_t b0,
                                         uint32_t b1) {
  asm("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "r"(b0), "r"(b1));
}

// One m-tile: conv row of pixel row `yrow` (its ky = 0 row in the tile) at
// the lane's cell, both column phases, 24 channels, ReLU'd and scaled by
// 2^e (bf16: one bf16 term a weight, no scale).  acc[n][0..1] = px 0,
// channels 8n + 2*tig + {0, 1}; [2..3] = px 1.
template <bool BF16>
__device__ __forceinline__ void conv_mtile(
    float (&acc)[3][4], const unsigned short* s, int at, const int (&off)[8],
    const uint32_t (&bf)[kFrag], const float (&seed)[6]) {
#pragma unroll
  for (int n = 0; n < 3; ++n) {
    acc[n][0] = acc[n][2] = seed[2 * n];
    acc[n][1] = acc[n][3] = seed[2 * n + 1];
  }
#pragma unroll
  for (int ks = 0; ks < 2; ++ks) {
    const unsigned short* p0 = s + at + off[4 * ks];
    const unsigned short* p1 = s + at + off[4 * ks + 1];
    const unsigned short* p2 = s + at + off[4 * ks + 2];
    const unsigned short* p3 = s + at + off[4 * ks + 3];
    const uint32_t a0 = __byte_perm(p0[0], p1[0], 0x5410);   // px 0
    const uint32_t a1 = __byte_perm(p0[2], p1[2], 0x5410);   // px 1
    const uint32_t a2 = __byte_perm(p2[0], p3[0], 0x5410);   // px 0, K + 8
    const uint32_t a3 = __byte_perm(p2[2], p3[2], 0x5410);   // px 1, K + 8
#pragma unroll
    for (int n = 0; n < 3; ++n) {
      if constexpr (BF16) {
        mma_bf16(acc[n], a0, a1, a2, a3, bf[(n * 2 + ks) * 2 + 0],
                 bf[(n * 2 + ks) * 2 + 1]);
      } else {
#pragma unroll
        for (int term = 0; term < 2; ++term)
          mma_f16(acc[n], a0, a1, a2, a3,
                  bf[((n * 2 + ks) * 2 + 0) * 2 + term],
                  bf[((n * 2 + ks) * 2 + 1) * 2 + term]);
      }
    }
  }
#pragma unroll
  for (int n = 0; n < 3; ++n)
#pragma unroll
    for (int q = 0; q < 4; ++q) acc[n][q] = fmaxf(acc[n][q], 0.f);
}

// One warp's strip of tile (i0, v0) of image b: cells j = v0 - 1 + 7*warp
// + g, down the tile's pooled rows; stores the pooled cells j >= v0 as
// OutT (f32, or bf16 rounded once).
template <bool BF16, class OutT>
__device__ __forceinline__ void pool_strip(
    OutT* __restrict__ out, const unsigned short* s, int b, int h4, int w4,
    int i0, int v0, int i_end, int j_end, int warp, int g, int tig, int rs,
    const int (&off)[8], const uint32_t (&bf)[kFrag], const float (&seed)[6],
    const float (&unscale)[6]) {
  const int j = v0 - 1 + kStripCells * warp + g;
  // conv output (2i + py, 2j + px) reads pixels y = 4i + 2py + ky - 1,
  // x = 4j + 2px + kx - 1: xs = 4*(7*warp + g) + 2px + kx + 3
  const int col = 4 * (kStripCells * warp + g) + 3;
  float prev[3][4];                       // conv row 2i - 1, both phases
  if (i0 == 0) {
#pragma unroll
    for (int n = 0; n < 3; ++n)
#pragma unroll
      for (int q = 0; q < 4; ++q) prev[n][q] = 0.f;
  } else {
    conv_mtile<BF16>(prev, s, 1 * rs + col, off, bf, seed);  // row 4i0 - 3
  }
  const bool store = g > 0 && j < j_end;
  OutT* ob = out + (size_t)b * kCout * h4 * w4 + j;
  for (int i = i0; i < i_end; ++i) {
    const int yrow = 4 * (i - i0) + 3;    // pixel row 4i - 1 in the tile
    float cm[3][4], cur[3][4];
    conv_mtile<BF16>(cur, s, yrow * rs + col, off, bf, seed);
#pragma unroll
    for (int n = 0; n < 3; ++n)
#pragma unroll
      for (int q = 0; q < 4; ++q) cm[n][q] = fmaxf(prev[n][q], cur[n][q]);
    conv_mtile<BF16>(prev, s, (yrow + 2) * rs + col, off, bf, seed);
#pragma unroll
    for (int n = 0; n < 3; ++n)
#pragma unroll
      for (int q = 0; q < 4; ++q) cm[n][q] = fmaxf(cm[n][q], prev[n][q]);
#pragma unroll
    for (int n = 0; n < 3; ++n)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        float left = __shfl_up_sync(0xffffffffu, cm[n][2 + e], 4);
        if (j == 0) left = 0.f;
        const float v = fmaxf(fmaxf(cm[n][e], cm[n][2 + e]), left);
        if (store) {
          OutT* o = ob + ((size_t)(8 * n + 2 * tig + e) * h4 + i) * w4;
          if constexpr (BF16) *o = __float2bfloat16_rn(v);
          else *o = v * unscale[2 * n + e];
        }
      }
  }
}

// A persistent CTA walks the tiles t = blockIdx.x, + gridDim.x, ...
// (image-major, then bands, then columns): it unpacks tile t from the raw
// buffer, starts the copies of its next tile into it, and convolves and
// pools tile t while they land.  BF16: bf16 pixels, weights and output.
template <int K, bool BF16 = false>
__global__ void __launch_bounds__(32 * kMaxStrips, 2)
stem_kernel(const uint8_t* __restrict__ x,
            std::conditional_t<BF16, __nv_bfloat16, float>* __restrict__ out,
            int nimg,
            int hk, int wk, int npad, int rows, int strips,
            const StemParams p) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int rs = stem_row_stride(strips);
  const int ps = stem_plane_stride(rows, strips);
  const int stride = stem_raw_words(rows, strips, K) / K;
  __half* s_img = reinterpret_cast<__half*>(smem);
  uint32_t* raw = reinterpret_cast<uint32_t*>(smem + 2 * (size_t)3 * ps);
  uint32_t* s_frag = raw + K * stride;
  float* s_vec = reinterpret_cast<float*>(s_frag + kFrag * 32);

  const int h4 = K * hk / 4, w4 = K * wk / 4;
  const int cols = kStripCells * strips;
  const int tiles_x = (w4 + cols - 1) / cols;
  const int per_image = (h4 + rows - 1) / rows * tiles_x;
  const int total = nimg * per_image;
  const size_t image = (size_t)3 * K * K * npad;
  const int tid = threadIdx.x;

  // 1. the weights, once; the first tile's copies
  for (int t = tid; t < kFrag * 32; t += blockDim.x)
    s_frag[t] = p.frag[t >> 5][t & 31];
  for (int t = tid; t < 2 * kCout; t += blockDim.x)
    s_vec[t] = t < kCout ? p.seed[t] : p.unscale[t - kCout];
  int tile = blockIdx.x;
  if (tile < total) {
    const int b = tile / per_image, r = tile - b * per_image;
    issue_tile<K>(x + b * image, raw, stride,
                  tile_geom<K>(hk, wk, r / tiles_x * rows,
                               r % tiles_x * cols, rows, strips),
                  wk, npad);
  }
  stem_cp_async_commit();
  __syncthreads();

  const int warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, tig = lane & 3;
  uint32_t bf[kFrag];
#pragma unroll
  for (int r = 0; r < kFrag; ++r) bf[r] = s_frag[r * 32 + lane];
  float seed[6], unscale[6];
#pragma unroll
  for (int n = 0; n < 3; ++n)
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      seed[2 * n + e] = s_vec[8 * n + 2 * tig + e];
      unscale[2 * n + e] = s_vec[kCout + 8 * n + 2 * tig + e];
    }
  // the lane's K slots 16*ks + 8*(r >> 1) + 2*tig + (r & 1); pad -> tap 0
  int off[8];
#pragma unroll
  for (int r = 0; r < 8; ++r) {
    int k = 16 * (r >> 2) + 8 * ((r >> 1) & 1) + 2 * tig + (r & 1);
    if (k >= kTaps) k = 0;
    const int ky = k / 9, kx = (k / 3) % 3, c = k % 3;
    off[r] = c * ps + ky * rs + kx;
  }
  const unsigned short* s = reinterpret_cast<const unsigned short*>(s_img);

  for (; tile < total; tile += gridDim.x) {
    const int b = tile / per_image, r = tile - b * per_image;
    const int i0 = r / tiles_x * rows, v0 = r % tiles_x * cols;
    // 2. tile's words landed, the last tile's strips done: unpack
    stem_cp_async_wait_all();
    __syncthreads();
    unpack_tile<K, BF16>(raw, stride, s_img,
                   tile_geom<K>(hk, wk, i0, v0, rows, strips), wk, rows, rs,
                   ps);
    __syncthreads();
    // 3. the next tile's copies, then this tile's strips
    const int next = tile + gridDim.x;
    if (next < total) {
      const int nb = next / per_image, nr = next - nb * per_image;
      issue_tile<K>(x + nb * image, raw, stride,
                    tile_geom<K>(hk, wk, nr / tiles_x * rows,
                                 nr % tiles_x * cols, rows, strips),
                    wk, npad);
    }
    stem_cp_async_commit();
    const int j_end = min(v0 + cols, w4);
    if (v0 + kStripCells * warp < j_end)            // the warp has own cells
      pool_strip<BF16>(out, s, b, h4, w4, i0, v0, min(i0 + rows, h4), j_end,
                 warp,
                 g, tig, rs, off, bf, seed, unscale);
  }
}

// ---------------------------------------------------------- the host

inline uint16_t f32_to_f16_rn(float f) {  // finite |f| < 65520
  uint32_t x;
  memcpy(&x, &f, 4);
  const uint32_t sign = (x >> 16) & 0x8000u, ax = x & 0x7FFFFFFFu;
  if (ax < 0x38800000u) {                  // below 2^-14: subnormal or 0
    float a;
    memcpy(&a, &ax, 4);
    return (uint16_t)(sign | (uint32_t)nearbyintf(a * 16777216.f));
  }
  uint32_t h = (((ax >> 23) - 112) << 10) | ((ax >> 13) & 0x3FFu);
  const uint32_t rem = ax & 0x1FFFu;
  if (rem > 0x1000u || (rem == 0x1000u && (h & 1u))) ++h;
  return (uint16_t)(sign | h);
}

inline float f16_to_f32(uint16_t h) {
  const uint32_t e = (h >> 10) & 0x1Fu, m = h & 0x3FFu;
  float v;
  if (e == 0) {
    v = ldexpf((float)m, -24);
  } else {
    const uint32_t x = ((e + 112) << 23) | (m << 13);
    memcpy(&v, &x, 4);
  }
  return (h & 0x8000u) ? -v : v;
}

// w (27*24, HWIO: [(ky*3 + kx)*3 + c][co]) and bias (24) f32 -> the
// kernel's parameter block: per channel e with max|w*2^e| in [2^14, 2^15),
// w*2^e = hi + lo in f16, each lane's B fragments, b*2^e and 2^-e
inline void stem_pack_params(const float* w, const float* bias,
                             StemParams* p) {
  uint16_t terms[2][32][kCout] = {};     // [term][K][co], K >= 27 zero
  for (int o = 0; o < kCout; ++o) {
    float m = 0.f;
    for (int k = 0; k < kTaps; ++k) m = fmaxf(m, fabsf(w[k * kCout + o]));
    int e = 0;
    if (m > 0.f) {
      frexpf(m, &e);
      e = 15 - e;
      e = e > 100 ? 100 : e;
    }
    for (int k = 0; k < kTaps; ++k) {
      const float ws = ldexpf(w[k * kCout + o], e);
      terms[0][k][o] = f32_to_f16_rn(ws);
      terms[1][k][o] = f32_to_f16_rn(ws - f16_to_f32(terms[0][k][o]));
    }
    p->seed[o] = ldexpf(bias[o], e);
    p->unscale[o] = ldexpf(1.f, -e);
  }
  for (int lane = 0; lane < 32; ++lane) {
    const int g = lane >> 2, tig = lane & 3;
    for (int n = 0; n < 3; ++n)
      for (int ks = 0; ks < 2; ++ks)
        for (int half = 0; half < 2; ++half)
          for (int term = 0; term < 2; ++term) {
            const int k = 16 * ks + 8 * half + 2 * tig, co = 8 * n + g;
            p->frag[((n * 2 + ks) * 2 + half) * 2 + term][lane] =
                terms[term][k][co] | ((uint32_t)terms[term][k + 1][co] << 16);
          }
  }
}

// w_bits (27*24 bf16 bit patterns, HWIO) and bias (24) f32 -> the bf16
// kernel's parameter block: registers [(n*2 + ks)*2 + half] of each lane
// (the first 12 of `frag`) hold its bf16 B pairs, the bias seeds, 2^0
inline void stem_pack_params_bf16(const uint16_t* w_bits, const float* bias,
                                  StemParams* p) {
  memset(p, 0, sizeof(*p));
  for (int lane = 0; lane < 32; ++lane) {
    const int g = lane >> 2, tig = lane & 3;
    for (int n = 0; n < 3; ++n)
      for (int ks = 0; ks < 2; ++ks)
        for (int half = 0; half < 2; ++half) {
          const int k = 16 * ks + 8 * half + 2 * tig, co = 8 * n + g;
          const uint32_t lo = k < kTaps ? w_bits[k * kCout + co] : 0u;
          const uint32_t hi = k + 1 < kTaps ? w_bits[(k + 1) * kCout + co]
                                            : 0u;
          p->frag[(n * 2 + ks) * 2 + half][lane] = lo | (hi << 16);
        }
  }
  for (int o = 0; o < kCout; ++o) {
    p->seed[o] = bias[o];
    p->unscale[o] = 1.f;
  }
}

// Let the kernel take `smem` bytes of dynamic shared memory.
template <int K, bool BF16 = false>
int stem_set_smem(size_t smem) {
  static size_t smem_set = 48 * 1024;
  if (smem <= smem_set) return 0;
  const cudaError_t err = cudaFuncSetAttribute(
      stem_kernel<K, BF16>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return (int)err;
  smem_set = smem;
  return 0;
}

// CTAs of the kernel an SM holds at a tile of `rows` x 7*`strips` cells
// (the occupancy calculator: registers, shared memory, threads); -1 on
// an error.
template <int K>
int stem_ctas_per_sm(int rows, int strips) {
  const size_t smem = stem_smem_bytes(rows, strips, K);
  int n = -1;
  if (stem_set_smem<K>(smem)
      || cudaOccupancyMaxActiveBlocksPerMultiprocessor(
             &n, stem_kernel<K>, 32 * strips, smem) != cudaSuccess)
    return -1;
  return n;
}

// Launch the stem on tiles of `rows` pooled rows x 7*`strips` pooled
// columns, one warp a strip, over `ctas` persistent CTAs.  Returns a
// cudaError_t (0 = launched).
template <int K>
int stem_launch(const uint8_t* x, float* out, const float* w_host,
                const float* b_host, int b, int hk, int wk, int npad,
                int rows, int strips, int ctas, void* stream) {
  if (b < 1 || hk < 1 || wk < 1 || npad < hk * wk || npad % 4 || rows < 1
      || rows > kMaxRows || strips < 1 || strips > kMaxStrips || ctas < 1)
    return (int)cudaErrorInvalidValue;
  const size_t smem = stem_smem_bytes(rows, strips, K);
  if (smem > (size_t)kSmemLimit) return (int)cudaErrorInvalidValue;
  const int err = stem_set_smem<K>(smem);
  if (err) return err;
  StemParams p;
  stem_pack_params(w_host, b_host, &p);
  stem_kernel<K><<<ctas, 32 * strips, smem, (cudaStream_t)stream>>>(
      x, out, b, hk, wk, npad, rows, strips, p);
  return (int)cudaGetLastError();
}

// The bf16 stem: out (B, 24, h4, w4) bf16; w_bits the bf16 bit patterns
// of the /255-folded HWIO weight, on the host.  The same tiles and grid.
template <int K>
int stem_launch_bf16(const uint8_t* x, __nv_bfloat16* out,
                     const uint16_t* w_bits_host, const float* b_host, int b,
                     int hk, int wk, int npad, int rows, int strips, int ctas,
                     void* stream) {
  if (b < 1 || hk < 1 || wk < 1 || npad < hk * wk || npad % 4 || rows < 1
      || rows > kMaxRows || strips < 1 || strips > kMaxStrips || ctas < 1)
    return (int)cudaErrorInvalidValue;
  const size_t smem = stem_smem_bytes(rows, strips, K);
  if (smem > (size_t)kSmemLimit) return (int)cudaErrorInvalidValue;
  const int err = stem_set_smem<K, true>(smem);
  if (err) return err;
  StemParams p;
  stem_pack_params_bf16(w_bits_host, b_host, &p);
  stem_kernel<K, true><<<ctas, 32 * strips, smem, (cudaStream_t)stream>>>(
      x, out, b, hk, wk, npad, rows, strips, p);
  return (int)cudaGetLastError();
}

}  // namespace
