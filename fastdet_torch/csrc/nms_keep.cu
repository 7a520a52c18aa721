// Greedy keep mask of a ranked NMS window (the staged postprocess), by hand
// for Hopper (sm_90a).
//
// Replaces both Pallas TPU kernels of fastdet/kernels/nms_kernel.py:
// keep_mask_batch -> _suppress_kernel (one (k,k) tile, k <= 512) and
// _suppress_call_tiled -> _suppress_kernel_tiled (k > 512 in T=512 rank
// blocks).  Same function: boxes (B,k,4) f32 xyxy with the class offset
// (cls * 4096) already added, in rank order, and validity (B,k) ->
//   keep[i] = valid[i] && !exists j < i: keep[j] && IoU(i,j) > thres.
// The TPU kernels iterate a triangular fixpoint of 0/1 matvecs to
// convergence; its unique solution is this greedy scan.  Their 512 split
// and 512 tiles are VMEM limits; nothing here depends on k.
//
// What bounds it on this card: operations, by the roofline.  k = 1815 at
// b128 is 2.1e8 pairs j < i, ~14 f32 operations each, 0.044 ms at 67
// TFLOP/s; the inputs are 0.4 MB.  In practice the serial greedy scan, a
// chain of dependent steps per image, sets the time.  The design:
//   1. nms_mask_kernel: a 2-D grid of 64 x 64 tiles over the pairs j < i
//      of each image (tiles below the diagonal return at once).  Thread t
//      owns suppressor j and builds one 64-bit word: bit c is set when
//      candidate i = 64 * tile + c has i > j and IoU(i,j) > thres.  The
//      overlap bitmask (B, k, ceil(k/64)) u64 lives in device memory, in a
//      workspace the wrapper allocates (53.9 MB at b128, k = 1815); only
//      the words at or right of the diagonal are written, and only those
//      are read.
//   2. nms_walk_kernel: one warp per image walks the ranks in order, one
//      64-candidate word at a time: the candidates still available (valid,
//      not removed) are taken lowest rank first; each one taken is kept,
//      and its mask row is ORed into the removed set (in shared memory,
//      ceil(k/64) words).  Suppressed candidates cost nothing, so the
//      chain is one step per KEPT candidate, each a load of its row.
// Validity gates only the candidate side: a kept suppressor is valid by
// construction, so the mask ignores it; the kernel never reads scores.
//
// Rounding: the IoU is the plain version's (fastdet_torch/ops/nms.py)
// op for op, inter / (area_i + area_j - inter + 1e-9), with explicit
// round-to-nearest intrinsics and --fmad=false, so the threshold
// compares are bitwise those of the plain version.  min/max and the area
// sum commute exactly, so IoU(i,j) = IoU(j,i) and one triangle serves.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kTile = 64;              // candidates per mask word and tile
constexpr int kMaxGridY = 65535;
constexpr int kMaxSmem = 232448;       // a block's shared memory, opt-in

__device__ __forceinline__ float area_rn(float4 b) {
  return __fmul_rn(__fsub_rn(b.z, b.x), __fsub_rn(b.w, b.y));
}

__global__ void __launch_bounds__(kTile)
nms_mask_kernel(const float4* __restrict__ boxes, uint64_t* __restrict__ mask,
                int k, int ntiles, int words, float iou_thres, int b0) {
  __shared__ float4 s_box[kTile];
  __shared__ float s_area[kTile];

  const int rt = blockIdx.x / ntiles;         // suppressor tile (rows j)
  const int ct = blockIdx.x - rt * ntiles;    // candidate tile (bits i)
  if (ct < rt) return;                        // uniform over the block
  const size_t b = (size_t)b0 + blockIdx.y;
  const float4* bb = boxes + b * k;
  const int t = threadIdx.x;
  const int i0 = ct * kTile;
  const int ncol = min(kTile, k - i0);        // the last word's tail
  if (t < ncol) {
    const float4 bi = bb[i0 + t];
    s_box[t] = bi;
    s_area[t] = area_rn(bi);
  }
  __syncthreads();

  const int j = rt * kTile + t;
  if (j >= k) return;
  const float4 bj = bb[j];
  const float aj = area_rn(bj);
  uint64_t bits = 0ull;
  for (int c = (ct == rt) ? t + 1 : 0; c < ncol; ++c) {   // i > j only
    const float4 bi = s_box[c];
    const float iw =
        fmaxf(__fsub_rn(fminf(bi.z, bj.z), fmaxf(bi.x, bj.x)), 0.f);
    const float ih =
        fmaxf(__fsub_rn(fminf(bi.w, bj.w), fmaxf(bi.y, bj.y)), 0.f);
    const float inter = __fmul_rn(iw, ih);
    // inter / (area_i + area_j - inter + 1e-9)
    const float den =
        __fadd_rn(__fsub_rn(__fadd_rn(s_area[c], aj), inter), 1e-9f);
    if (__fdiv_rn(inter, den) > iou_thres) bits |= 1ull << c;
  }
  mask[(b * k + j) * words + ct] = bits;
}

__global__ void __launch_bounds__(32)
nms_walk_kernel(const uint64_t* __restrict__ mask,
                const uint8_t* __restrict__ valid, uint8_t* __restrict__ keep,
                int k, int words) {
  extern __shared__ uint64_t s_removed[];
  const size_t b = blockIdx.x;
  const int lane = threadIdx.x;
  const uint64_t* mb = mask + b * k * words;
  valid += b * k;
  keep += b * k;

  for (int u = lane; u < words; u += 32) s_removed[u] = 0ull;
  __syncwarp();
  for (int w = 0; w < words; ++w) {
    const int i0 = w * kTile + lane, i1 = i0 + 32;
    const bool v0 = i0 < k && valid[i0] != 0;
    const bool v1 = i1 < k && valid[i1] != 0;
    const uint64_t vbits =
        (uint64_t)__ballot_sync(0xffffffffu, v0) |
        ((uint64_t)__ballot_sync(0xffffffffu, v1) << 32);
    // the same value in every lane, so the loop below is warp-uniform
    uint64_t avail = vbits & ~s_removed[w];
    uint64_t kept = 0ull;
    while (avail) {
      const int bit = __ffsll((long long)avail) - 1;   // lowest rank left
      kept |= 1ull << bit;
      const uint64_t* row = mb + (size_t)(w * kTile + bit) * words;
      avail &= ~(row[w] | (1ull << bit));
      // later words: each lane ORs its own, no two lanes the same word
      for (int u = w + 1 + lane; u < words; u += 32) s_removed[u] |= row[u];
    }
    __syncwarp();                     // removed[w + 1] visible to all lanes
    if (i0 < k) keep[i0] = (uint8_t)((kept >> lane) & 1ull);
    if (i1 < k) keep[i1] = (uint8_t)((kept >> (lane + 32)) & 1ull);
  }
}

}  // namespace

extern "C" {

// boxes (B,k,4) f32 class-offset xyxy, valid (B,k) u8 (0/1), mask a
// (B, k, ceil(k/64)) u64 workspace, keep (B,k) u8 out; all contiguous on
// one device.  Returns a cudaError_t (0 = launched).
int fastdet_nms_keep(const float* boxes, const uint8_t* valid, uint64_t* mask,
                     uint8_t* keep, int b, int k, float iou_thres,
                     void* stream) {
  if (b < 1 || k < 1) return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  const int ntiles = (k + kTile - 1) / kTile;
  const int words = ntiles;
  if ((long long)ntiles * ntiles > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  const size_t smem = (size_t)words * sizeof(uint64_t);
  if (smem > (size_t)kMaxSmem) return (int)cudaErrorInvalidValue;
  for (int b0 = 0; b0 < b; b0 += kMaxGridY) {
    const int nb = b - b0 < kMaxGridY ? b - b0 : kMaxGridY;
    nms_mask_kernel<<<dim3(ntiles * ntiles, nb), kTile, 0, s>>>(
        reinterpret_cast<const float4*>(boxes), mask, k, ntiles, words,
        iou_thres, b0);
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
  }
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        nms_walk_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  nms_walk_kernel<<<b, 32, smem, s>>>(mask, valid, keep, k, words);
  return (int)cudaGetLastError();
}

const char* fastdet_cuda_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
