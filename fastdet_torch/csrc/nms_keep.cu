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
//   2. Rows.  The 64-bit overlap words of the compacted pairs, in a row
//      triangle (the NMS core, nms_core.cuh, shared with pp_fused.cu).
//   3. The walk, one warp, a word at a time (the same core): one memory
//      trip per WORD, each word's greedy order resolved as a fixpoint on
//      its 64 x 64 diagonal block.
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
// the IoU is the plain version's op for op (nms_core.cuh), so the
// threshold compares are bitwise those of the plain version.

#include "nms_core.cuh"

namespace {

constexpr int kCtaThreads = 512;       // the cta variant's CTA
constexpr int kCompactThreads = 256;   // nms_compact_kernel
constexpr int kTileThreads = 128;      // nms_tile_kernel: 4 warps a tile
constexpr int kCapWords = 26;          // the cta variant's rows on chip
constexpr int kMaxGridY = 65535;
constexpr int kMaxSmem = 232448;       // a block's shared memory, opt-in

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

// The cta variant's work on one image once n_v is known: compaction into
// im, the rows of every word by the CTA's warps, the walk by warp 0.
__device__ __forceinline__ void cta_image(
    const float* boxes, const void* cls, int cls64, const uint8_t* valid,
    uint8_t* keep, int lo, int hi, int pos, int nv, float iou_thres,
    const Image& im) {
  compact_segment(boxes, cls, cls64, valid, keep, lo, hi, pos, im);
  __syncthreads();
  image_rows(im, nv, iou_thres);
  __syncthreads();
  if (threadIdx.x < 32) walk(im, nv, keep, threadIdx.x);
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
