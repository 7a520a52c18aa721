// The per-image core of the greedy NMS kernels, by hand for Hopper
// (sm_90a): nms_keep.cu (the staged postprocess's keep mask, B4 and B5)
// and pp_fused.cu (the serving postprocess's rank -> decode -> NMS, B3)
// include it.  Each feeds it an image's valid candidates in rank order,
// compacted (class-offset boxes, areas, ranks), and it computes
//   keep[i] = valid[i] && !exists j < i: keep[j] && IoU(i,j) > thres
// over them in two steps:
//   * rows (`image_rows`): for suppressor j and word u (candidates
//     64u..64u+63 of the compacted list) one warp builds the 64-bit word
//     of bits i > j with IoU(i,j) > thres: each lane holds two candidates
//     in registers and one ballot per half gives the word (two rows at a
//     time; disjoint pairs skip the division).  Only the words at or
//     right of the diagonal exist: row block r (rows 64r..64r+63) stores
//     words r..W-1, W = ceil(n_v/64) (`row_off`);
//   * the walk (`walk`, one warp, a word at a time): removed[u] is the
//     OR of word u of every row kept so far (a gather over the kept list:
//     independent loads, spread over the lanes, one OR-reduction); the
//     64 x 64 diagonal block is held across the lanes and the word's
//     greedy order is resolved as a fixpoint, a round an OR-reduction
//     (as many rounds as the word's longest chain of suppressions, not
//     one a kept candidate); the word's kept candidates join the kept
//     list and are scattered to keep.  The chain is one memory trip per
//     WORD, not per kept candidate.
// `block_scan` is the compaction's block-wide exclusive scan.
//
// Rounding: the IoU is the plain versions' (fastdet_torch/ops/nms.py) op
// for op, inter / (area_i + area_j - inter + 1e-9), with explicit
// round-to-nearest intrinsics; both including sources build with
// --fmad=false, so the threshold compares are bitwise those of the plain
// versions.  min/max and the area sum commute exactly, so IoU(i,j) =
// IoU(j,i) and one triangle serves.

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr unsigned kFull = 0xffffffffu;
constexpr int kScanBytes = 33 * 4;     // block_scan: warp totals + total

// the triangle of row words of an image of w words: row block r holds
// words r..w-1 of its 64 rows
__host__ __device__ __forceinline__ long long tri(long long w) {
  return 64 * (w * (w + 1) / 2);
}

// offset of row j's word u (u >= j / 64) in an image of w words
__device__ __forceinline__ long long row_off(int j, int u, int w) {
  const long long r = j >> 6;
  return 64 * (r * w - r * (r - 1) / 2) + (long long)(j & 63) * (w - r) +
         (u - r);
}

// one image's slice of the workspace (and, for the cta variant, of its
// shared memory): np candidates of compacted boxes, areas, ranks and the
// kept list, then the row triangle of np / 64 words
struct Image {
  float4* box;
  float* area;
  int* rank;
  int* kept;
  uint64_t* rows;
};

__host__ __device__ __forceinline__ size_t image_bytes(int np) {
  return (size_t)28 * np + 8 * (size_t)tri(np / 64);
}

__device__ __forceinline__ Image carve(unsigned char* base, int np) {
  Image im;
  im.box = reinterpret_cast<float4*>(base);
  im.area = reinterpret_cast<float*>(base + (size_t)16 * np);
  im.rank = reinterpret_cast<int*>(base + (size_t)20 * np);
  im.kept = reinterpret_cast<int*>(base + (size_t)24 * np);
  im.rows = reinterpret_cast<uint64_t*>(base + (size_t)28 * np);
  return im;
}

__device__ __forceinline__ bool overlaps(float4 bi, float ai, float4 bj,
                                         float aj, float iou_thres) {
  const float iw =
      fmaxf(__fsub_rn(fminf(bi.z, bj.z), fmaxf(bi.x, bj.x)), 0.f);
  const float ih =
      fmaxf(__fsub_rn(fminf(bi.w, bj.w), fmaxf(bi.y, bj.y)), 0.f);
  const float inter = __fmul_rn(iw, ih);
  // Disjoint boxes (every pair of two classes, by the class offset) skip
  // the division: 0 / den is +-0 or NaN, never above a threshold >= 0.
  if (inter == 0.f && iou_thres >= 0.f) return false;
  // inter / (area_i + area_j - inter + 1e-9)
  const float den = __fadd_rn(__fsub_rn(__fadd_rn(ai, aj), inter), 1e-9f);
  return __fdiv_rn(inter, den) > iou_thres;
}

// Block-wide exclusive scan of one int a thread (blockDim.x <= 1024);
// s holds 33 ints.  -> the thread's offset; *total the block's sum.
__device__ int block_scan(int v, int* s, int* total) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int nw = blockDim.x >> 5;
  int x = v;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const int y = __shfl_up_sync(kFull, x, o);
    if (lane >= o) x += y;
  }
  if (lane == 31) s[warp] = x;
  __syncthreads();
  if (warp == 0) {
    const int wv = lane < nw ? s[lane] : 0;
    int wx = wv;
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      const int y = __shfl_up_sync(kFull, wx, o);
      if (lane >= o) wx += y;
    }
    if (lane < nw) s[lane] = wx - wv;
    if (lane == 31) s[32] = wx;
  }
  __syncthreads();
  *total = s[32];
  return s[warp] + x - v;
}

// The warp's candidates of word u: lanes hold 64u + lane and 64u + 32 +
// lane (zero past n_v).
struct Cands {
  float4 b0, b1;
  float a0, a1;
  int i0, i1;
};

__device__ __forceinline__ Cands load_cands(const Image& im, int u, int nv,
                                            int lane) {
  Cands c;
  c.i0 = 64 * u + lane;
  c.i1 = c.i0 + 32;
  const float4 z = make_float4(0.f, 0.f, 0.f, 0.f);
  c.b0 = c.i0 < nv ? im.box[c.i0] : z;
  c.a0 = c.i0 < nv ? im.area[c.i0] : 0.f;
  c.b1 = c.i1 < nv ? im.box[c.i1] : z;
  c.a1 = c.i1 < nv ? im.area[c.i1] : 0.f;
  return c;
}

// Row j's word over the warp's candidates: bit c set when candidate
// 64u + c exists, comes after j and overlaps it.
__device__ __forceinline__ bool row_bit(const Cands& c, int h, float4 bj,
                                        float aj, int j, int nv,
                                        float iou_thres) {
  const int i = h ? c.i1 : c.i0;
  return i > j && i < nv &&
         overlaps(h ? c.b1 : c.b0, h ? c.a1 : c.a0, bj, aj, iou_thres);
}

// The words of rows j0 .. j1 - 1 in steps of `step` over the warp's
// candidates of word u, two rows at a time (four independent IoUs a
// lane between the ballots); lane 0 stores them.
__device__ __forceinline__ void row_words(const Image& im, const Cands& c,
                                          int u, int w, int j0, int j1,
                                          int step, int nv, float iou_thres,
                                          int lane) {
  for (int j = j0; j < j1; j += 2 * step) {
    const int k = j + step;                   // the second row, if any
    const bool two = k < j1;                  // uniform over the warp
    const float4 bj = im.box[j], bk = two ? im.box[k] : bj;
    const float aj = im.area[j], ak = two ? im.area[k] : aj;
    const bool p0 = row_bit(c, 0, bj, aj, j, nv, iou_thres);
    const bool p1 = row_bit(c, 1, bj, aj, j, nv, iou_thres);
    const bool q0 = two && row_bit(c, 0, bk, ak, k, nv, iou_thres);
    const bool q1 = two && row_bit(c, 1, bk, ak, k, nv, iou_thres);
    const uint64_t wj = (uint64_t)__ballot_sync(kFull, p0) |
                        ((uint64_t)__ballot_sync(kFull, p1) << 32);
    const uint64_t wk = (uint64_t)__ballot_sync(kFull, q0) |
                        ((uint64_t)__ballot_sync(kFull, q1) << 32);
    if (lane == 0) {
      im.rows[row_off(j, u, w)] = wj;
      if (two) im.rows[row_off(k, u, w)] = wk;
    }
  }
}

// The greedy walk of one image by one warp, a word at a time; keep gets a
// 1 at the rank of every kept candidate (it was zeroed before).  Word u:
// removed[u] is the OR of word u of the rows kept so far (independent
// loads, spread over the lanes, one OR-reduction); the word's greedy
// order is the fixpoint of kept = avail & ~OR{row c of the diagonal block
// : c in kept}, every lane the same.  That fixpoint is unique and is the
// scan's (a candidate's bit depends on lower ones only), and a round fixes
// at least the lowest candidate not yet fixed, so the rounds are as many
// as the longest chain of suppressions in the word, 65 at most, not one
// a kept candidate.  The chain is one memory trip per WORD.
__device__ __forceinline__ void walk(const Image& im, int nv, uint8_t* keep,
                                     int lane) {
  const int w = (nv + 63) >> 6;
  int nk = 0;
  for (int u = 0; u < w; ++u) {
    const int nrow = min(64, nv - 64 * u);
    // the diagonal block: row 64u + c's word u, c = lane and lane + 32
    const uint64_t d0 =
        lane < nrow ? im.rows[row_off(64 * u + lane, u, w)] : 0ull;
    const uint64_t d1 =
        lane + 32 < nrow ? im.rows[row_off(64 * u + lane + 32, u, w)] : 0ull;
    uint64_t acc = 0ull;
    int e = lane;
    for (; e + 96 < nk; e += 128) {
      const int j0 = im.kept[e], j1 = im.kept[e + 32];
      const int j2 = im.kept[e + 64], j3 = im.kept[e + 96];
      acc |= im.rows[row_off(j0, u, w)] | im.rows[row_off(j1, u, w)] |
             im.rows[row_off(j2, u, w)] | im.rows[row_off(j3, u, w)];
    }
    for (; e < nk; e += 32) acc |= im.rows[row_off(im.kept[e], u, w)];
    const uint64_t removed =
        ((uint64_t)__reduce_or_sync(kFull, (unsigned)(acc >> 32)) << 32) |
        __reduce_or_sync(kFull, (unsigned)acc);
    const uint64_t avail =
        (nrow == 64 ? ~0ull : (1ull << nrow) - 1ull) & ~removed;
    uint64_t kept = avail;
    for (;;) {
      const uint64_t mine = ((kept >> lane) & 1ull ? d0 : 0ull) |
                            ((kept >> (lane + 32)) & 1ull ? d1 : 0ull);
      const uint64_t next = avail & ~(
          ((uint64_t)__reduce_or_sync(kFull, (unsigned)(mine >> 32)) << 32) |
          __reduce_or_sync(kFull, (unsigned)mine));
      if (next == kept) break;
      kept = next;
    }
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int c = lane + 32 * h;
      if ((kept >> c) & 1ull) {
        const int j = 64 * u + c;
        im.kept[nk + __popcll(kept & ((1ull << c) - 1ull))] = j;
        keep[im.rank[j]] = 1;
      }
    }
    nk += __popcll(kept);
    __syncwarp();                     // the kept list, for every lane
  }
}

// The rows of every word of an image by the CTA's warps: warp w builds
// rows w, w + nw, ... of each word.
__device__ __forceinline__ void image_rows(const Image& im, int nv,
                                           float iou_thres) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int nw = blockDim.x >> 5;
  const int w = (nv + 63) >> 6;
  for (int u = 0; u < w; ++u)
    row_words(im, load_cands(im, u, nv, lane), u, w, warp,
              min(64 * u + 64, nv), nw, nv, iou_thres, lane);
}

}  // namespace
