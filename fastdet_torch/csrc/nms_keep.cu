// Greedy keep mask of a ranked NMS window (the staged postprocess), by hand
// for Hopper (sm_90a).
//
// Replaces both Pallas TPU kernels of fastdet/kernels/nms_kernel.py:
// keep_mask_batch -> _suppress_kernel (one (k,k) tile, k <= 512) and
// _suppress_call_tiled -> _suppress_kernel_tiled (k > 512 in T=512 rank
// blocks).  Same function: boxes (B,k,4) f32 xyxy, classes (B,k) int32 or
// int64 and validity (B,k), in rank order ->
//   keep[i] = valid[i] && !exists j < i: keep[j] && IoU(i,j) > thres,
// with the class offset (cls * 4096 added to the coordinates).  The TPU
// kernels iterate a triangular fixpoint of 0/1 matvecs to convergence; its
// unique solution is this greedy scan.
//
// What bounds it on this card: bytes, by the roofline.  The inputs and
// keep are 26 B a candidate (6.0 MB at b128, k = 1815: 1.8 us at 3.35
// TB/s); the pairs the scan may have to test are those of VALID
// candidates only (~136 an image on the eval batch, 1.2 M pairs, 14 f32
// operations each: 0.25 us at 67 TFLOP/s).  What sets the time is
// latency: the greedy scan is a chain of dependent steps per image.  The
// design:
//   1. Compaction.  The CTA scans the validity flags (each thread a
//      segment of ranks, one block-wide exclusive scan) and writes the
//      valid candidates, in rank order, as class-offset boxes, areas and
//      their rank.  Invalid candidates are never kept and a kept
//      suppressor is valid, so the greedy scan over the compacted list,
//      scattered back, is the function; everything after works on n_v.
//   2. Rows.  For suppressor j and word w (candidates 64w..64w+63 of the
//      compacted list) one warp builds the 64-bit word of bits i > j with
//      IoU(i,j) > thres: each lane holds two candidates in registers and
//      one ballot per half gives the word (two rows at a time; disjoint
//      pairs skip the division).  Only the words at or right of
//      the diagonal exist: row block r (rows 64r..64r+63) stores words
//      r..W-1, W = ceil(n_v/64) (`row_off`).
//   3. The walk, one warp, a word at a time.  removed[w] is the OR of
//      word w of every row kept so far (a gather over the kept list:
//      independent loads, spread over the lanes, one OR-reduction); the
//      64 x 64 diagonal block is held across the lanes and the word's
//      greedy order is resolved by shuffles; the word's kept candidates
//      join the kept list and are scattered to keep.  The chain is one
//      memory trip per WORD, not per kept candidate.
// Two variants of the same code, chosen by the wrapper's plan
// (fastdet_torch/kernels/nms_kernel.py::nms_keep_plan):
//   * cta: one launch, one CTA of kCtaThreads per image.  Where the
//     image's n_v fits (n_v <= 64 * wn, wn <= kCapWords), the compacted
//     list, the rows and the kept list live in shared memory; past it,
//     in the image's slice of a device workspace.
//   * grid: three launches for small batches of wide windows, where one
//     CTA per image would leave most SMs idle: compaction into the
//     workspace (nms_compact_kernel), the rows as a grid of 64 x 64
//     tiles over the compacted pairs (nms_tile_kernel), the walk
//     (nms_walk_kernel, one warp per image).
//
// Rounding: the class offset is __fadd_rn(x, __fmul_rn((float)cls,
// 4096.f)), bitwise the plain version's boxes + cls.to(f32) * 4096, and
// the IoU is the plain version's (fastdet_torch/ops/nms.py) op for op,
// inter / (area_i + area_j - inter + 1e-9), with explicit round-to-nearest
// intrinsics and --fmad=false, so the threshold compares are bitwise
// those of the plain version.  min/max and the area sum commute exactly,
// so IoU(i,j) = IoU(j,i) and one triangle serves.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kCtaThreads = 512;       // the cta variant's CTA
constexpr int kCompactThreads = 256;   // nms_compact_kernel
constexpr int kTileThreads = 128;      // nms_tile_kernel: 4 warps a tile
constexpr int kCapWords = 26;          // the cta variant's rows on chip
constexpr int kScanBytes = 33 * 4;     // warp totals + the block total
constexpr int kMaxGridY = 65535;
constexpr int kMaxSmem = 232448;       // a block's shared memory, opt-in
constexpr unsigned kFull = 0xffffffffu;

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

// Count the valid ranks of a thread's segment [lo, hi).
__device__ __forceinline__ int count_valid(const uint8_t* valid, int lo,
                                           int hi) {
  int n = 0;
#pragma unroll 4
  for (int i = lo; i < hi; ++i) n += valid[i] != 0;
  return n;
}

// Write the segment's valid candidates from compacted position pos on:
// class-offset box, area, rank; keep = 0 for every rank of the segment.
__device__ __forceinline__ void compact_segment(
    const float* boxes, const void* cls, int cls64, const uint8_t* valid,
    uint8_t* keep, int lo, int hi, int pos, const Image& im) {
#pragma unroll 4
  for (int i = lo; i < hi; ++i) {
    keep[i] = 0;
    if (valid[i] == 0) continue;
    const float c = cls64 ? (float)(static_cast<const long long*>(cls)[i])
                          : (float)(static_cast<const int*>(cls)[i]);
    const float off = __fmul_rn(c, 4096.f);
    const float* p = boxes + 4 * (size_t)i;
    float4 b;
    b.x = __fadd_rn(p[0], off);
    b.y = __fadd_rn(p[1], off);
    b.z = __fadd_rn(p[2], off);
    b.w = __fadd_rn(p[3], off);
    im.box[pos] = b;
    im.area[pos] = __fmul_rn(__fsub_rn(b.z, b.x), __fsub_rn(b.w, b.y));
    im.rank[pos] = i;
    ++pos;
  }
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
// 1 at the rank of every kept candidate (it was zeroed by the compaction).
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
    // removed[u]: word u of every row kept so far, independent loads
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
    // the word's greedy order, lowest rank first; every lane the same
    uint64_t avail = (nrow == 64 ? ~0ull : (1ull << nrow) - 1ull) & ~removed;
    uint64_t kept = 0ull;
    while (avail) {
      const int bit = __ffsll((long long)avail) - 1;
      kept |= 1ull << bit;
      const uint64_t d = __shfl_sync(kFull, bit < 32 ? d0 : d1, bit & 31);
      avail &= ~(d | (1ull << bit));
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

// The cta variant's work on one image once n_v is known: compaction into
// im, the rows of every word by the CTA's warps, the walk by warp 0.
__device__ __forceinline__ void cta_image(
    const float* boxes, const void* cls, int cls64, const uint8_t* valid,
    uint8_t* keep, int lo, int hi, int pos, int nv, float iou_thres,
    const Image& im) {
  compact_segment(boxes, cls, cls64, valid, keep, lo, hi, pos, im);
  __syncthreads();
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int nw = blockDim.x >> 5;
  const int w = (nv + 63) >> 6;
  for (int u = 0; u < w; ++u)
    row_words(im, load_cands(im, u, nv, lane), u, w, warp,
              min(64 * u + 64, nv), nw, nv, iou_thres, lane);
  __syncthreads();
  if (warp == 0) walk(im, nv, keep, lane);
}

__global__ void __launch_bounds__(kCtaThreads, 1)
nms_keep_kernel(const float* __restrict__ boxes, const void* __restrict__ cls,
                int cls64, const uint8_t* __restrict__ valid,
                uint8_t* __restrict__ keep, unsigned char* __restrict__ ws,
                int k, int wn, float iou_thres) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int np = 64 * wn;
  int* s_scan = reinterpret_cast<int*>(smem + image_bytes(np));
  const size_t b = blockIdx.x;
  boxes += b * k * 4;
  cls = cls64 ? (const void*)(static_cast<const long long*>(cls) + b * k)
              : (const void*)(static_cast<const int*>(cls) + b * k);
  valid += b * k;
  keep += b * k;
  const int seg = (k + blockDim.x - 1) / blockDim.x;
  const int lo = min((int)threadIdx.x * seg, k), hi = min(lo + seg, k);
  int nv;
  const int pos = block_scan(count_valid(valid, lo, hi), s_scan, &nv);
  if (nv <= np) {                                 // uniform over the CTA
    cta_image(boxes, cls, cls64, valid, keep, lo, hi, pos, nv, iou_thres,
              carve(smem, np));
  } else {
    const int kp = 64 * ((k + 63) / 64);
    cta_image(boxes, cls, cls64, valid, keep, lo, hi, pos, nv, iou_thres,
              carve(ws + b * image_bytes(kp), kp));
  }
}

__global__ void __launch_bounds__(kCompactThreads)
nms_compact_kernel(const float* __restrict__ boxes,
                   const void* __restrict__ cls, int cls64,
                   const uint8_t* __restrict__ valid,
                   uint8_t* __restrict__ keep, unsigned char* __restrict__ ws,
                   int* __restrict__ nvs, int k) {
  __shared__ int s_scan[33];
  const size_t b = blockIdx.x;
  boxes += b * k * 4;
  cls = cls64 ? (const void*)(static_cast<const long long*>(cls) + b * k)
              : (const void*)(static_cast<const int*>(cls) + b * k);
  valid += b * k;
  keep += b * k;
  const int kp = 64 * ((k + 63) / 64);
  const int seg = (k + blockDim.x - 1) / blockDim.x;
  const int lo = min((int)threadIdx.x * seg, k), hi = min(lo + seg, k);
  int nv;
  const int pos = block_scan(count_valid(valid, lo, hi), s_scan, &nv);
  compact_segment(boxes, cls, cls64, valid, keep, lo, hi, pos,
                  carve(ws + b * image_bytes(kp), kp));
  if (threadIdx.x == 0) nvs[b] = nv;
}

__global__ void __launch_bounds__(kTileThreads)
nms_tile_kernel(unsigned char* __restrict__ ws, const int* __restrict__ nvs,
                int k, float iou_thres, int b0) {
  // tile t of the upper triangle, column-major: word u, row block r <= u
  const long long t = blockIdx.x;
  int u = (int)((sqrt(8.0 * (double)t + 1.0) - 1.0) / 2.0);
  while ((long long)(u + 1) * (u + 2) / 2 <= t) ++u;
  while ((long long)u * (u + 1) / 2 > t) --u;
  const int r = (int)(t - (long long)u * (u + 1) / 2);
  const size_t b = (size_t)b0 + blockIdx.y;
  const int nv = nvs[b];
  const int w = (nv + 63) >> 6;
  if (u >= w) return;                             // uniform over the CTA
  const int kp = 64 * ((k + 63) / 64);
  const Image im = carve(ws + b * image_bytes(kp), kp);
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  row_words(im, load_cands(im, u, nv, lane), u, w, 64 * r + warp,
            min(64 * r + 64, nv), kTileThreads / 32, nv, iou_thres, lane);
}

__global__ void __launch_bounds__(32)
nms_walk_kernel(unsigned char* __restrict__ ws, const int* __restrict__ nvs,
                uint8_t* __restrict__ keep, int k) {
  const size_t b = blockIdx.x;
  const int kp = 64 * ((k + 63) / 64);
  walk(carve(ws + b * image_bytes(kp), kp), nvs[b], keep + b * k,
       threadIdx.x);
}

size_t cta_smem(int k) {
  const int wk = (k + 63) / 64;
  const int wn = wk < kCapWords ? wk : kCapWords;
  return image_bytes(64 * wn) + kScanBytes;
}

size_t workspace_bytes(int variant, int b, int k) {
  const int kp = 64 * ((k + 63) / 64);
  const size_t img = image_bytes(kp);
  if (variant == 0) return kp <= 64 * kCapWords ? 0 : (size_t)b * img;
  return (size_t)b * img + 4 * (size_t)b;
}

}  // namespace

extern "C" {

// Shared memory (bytes) of one CTA of the variant's largest launch:
// variant 0 (cta) the on-chip image of min(ceil(k/64), kCapWords) words
// and the scan's; variant 1 (grid) nms_compact_kernel's scan.
size_t fastdet_nms_keep_smem(int variant, int k) {
  return variant == 0 ? cta_smem(k) : (size_t)kScanBytes;
}

// Device workspace (bytes) the variant needs at (b, k): each image's
// compacted list and row triangle for n_v up to k (the cta variant only
// where k is past its on-chip cap), and the grid variant's n_v a image.
size_t fastdet_nms_keep_workspace(int variant, int b, int k) {
  return workspace_bytes(variant, b, k);
}

// boxes (B,k,4) f32 xyxy, cls (B,k) int32 (cls64 = 0) or int64 (1),
// valid (B,k) u8 (0/1), keep (B,k) u8 out, ws a device workspace of
// fastdet_nms_keep_workspace(variant, b, k) bytes (16-byte aligned; may
// be null where that is 0); all contiguous on one device.  variant 0
// launches the cta variant, 1 the grid variant.  Returns a cudaError_t
// (0 = launched).
int fastdet_nms_keep(const float* boxes, const void* cls, int cls64,
                     const uint8_t* valid, uint8_t* keep, void* ws, int b,
                     int k, float iou_thres, int variant, void* stream) {
  if (b < 1 || k < 1 || (variant != 0 && variant != 1))
    return (int)cudaErrorInvalidValue;
  if (workspace_bytes(variant, b, k) > 0 && ws == nullptr)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  unsigned char* w = static_cast<unsigned char*>(ws);
  if (variant == 0) {
    const size_t smem = cta_smem(k);
    if (smem > (size_t)kMaxSmem) return (int)cudaErrorInvalidValue;
    if (smem > 48 * 1024) {
      const cudaError_t err = cudaFuncSetAttribute(
          nms_keep_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
          (int)smem);
      if (err != cudaSuccess) return (int)err;
    }
    const int wk = (k + 63) / 64;
    nms_keep_kernel<<<b, kCtaThreads, smem, s>>>(
        boxes, cls, cls64, valid, keep, w, k,
        wk < kCapWords ? wk : kCapWords, iou_thres);
    return (int)cudaGetLastError();
  }
  const long long wk = (k + 63) / 64;
  const long long tiles = wk * (wk + 1) / 2;
  if (tiles > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  const int kp = 64 * (int)wk;
  int* nvs = reinterpret_cast<int*>(w + (size_t)b * image_bytes(kp));
  nms_compact_kernel<<<b, kCompactThreads, 0, s>>>(boxes, cls, cls64, valid,
                                                   keep, w, nvs, k);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  for (int b0 = 0; b0 < b; b0 += kMaxGridY) {
    const int nb = b - b0 < kMaxGridY ? b - b0 : kMaxGridY;
    nms_tile_kernel<<<dim3((unsigned)tiles, nb), kTileThreads, 0, s>>>(
        w, nvs, k, iou_thres, b0);
    err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
  }
  nms_walk_kernel<<<b, 32, 0, s>>>(w, nvs, keep, k);
  return (int)cudaGetLastError();
}

const char* fastdet_cuda_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
