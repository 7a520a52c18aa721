// Fused rank -> decode -> NMS for the serving postprocess, by hand for
// Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel fastdet/kernels/pp_fused.py
// (rank_decode_nms -> _fused_kernel).  Same function: for each image,
// the top-k candidates of the ranking sort (-score ascending, combo =
// idx*nc + cls) gather their raw reg logits and their geometry row, decode
// to xyxy boxes, and run class-aware greedy NMS (class offset x4096,
// IoU > thres against valid higher-ranked candidates).
//
// What bounds it on this card: neither bytes nor operations.  Per image it
// reads about k*64 bytes and tests at most n_v^2/2 pairs (n_v = the
// image's valid candidates; the served b128 batch has at most a few dozen
// an image), so the roofline time is well under a microsecond for a whole
// batch; latency sets the time: two dependent trips to device memory (the
// window, then the gather), the greedy scan's chain, and the launch.  The
// design, one launch of one CTA of 1024 threads per image (kernels/
// pp_fused.py::rank_decode_nms_plan):
//   1. Decode.  Thread i takes rank i: idx = combo / nc and cls = combo -
//      idx*nc as integers, one 16-byte load of the reg row (B,N,4) and two
//      of the geometry row (N,8) (the TPU version's one-hot MXU gather and
//      f32 floor trick are TPU workarounds), the box decoded in registers
//      and written to boxes_out for every rank; keep_out zeroed.
//   2. Compaction.  A block-wide exclusive scan of the validity flags
//      (neg_k < 0 and the combo in range) writes the valid candidates, in
//      rank order, to shared memory as class-offset boxes, areas and
//      ranks.  Invalid candidates are never kept and a kept suppressor is
//      valid, so everything after works on the n_v valid ones.
//   3. Rows and walk: the NMS core (nms_core.cuh, shared with nms_keep.cu):
//      64-bit overlap words of the compacted pairs in a row triangle, built
//      by all 32 warps (more warps hide more of the rows' latency), then
//      one warp walks them a word at a time and scatters keep.
// Shared memory is sized by k (the compacted list and the triangle for
// n_v up to k): 21.1 KB at k = 384.
//
// Rounding: every float operation is an explicit round-to-nearest
// intrinsic in the JAX package's operation order, and the library is built
// with --fmad=false, so no a*b+c is contracted.  Sigmoid is
// 1/(1+expf(-x)), op for op PyTorch's CUDA sigmoid, so the plain PyTorch
// version on the card gives the same bits.

#include "nms_core.cuh"

namespace {

constexpr int kMaxK = 384;
constexpr int kMaxThreads = 1024;
constexpr float kMaxWH = 4096.f;

__device__ __forceinline__ float sigmoid_rn(float x) {
  return __fdiv_rn(1.f, __fadd_rn(1.f, expf(-x)));
}

// an image's compacted list and row triangle for n_v up to k, and the
// scan's ints
size_t smem_bytes(int k) {
  return image_bytes(64 * ((k + 63) / 64)) + kScanBytes;
}

__global__ void __launch_bounds__(kMaxThreads, 1)
rank_decode_nms_kernel(const float* __restrict__ neg_k,
                       const int32_t* __restrict__ combo_k,
                       const float* __restrict__ regs,
                       const float* __restrict__ geo,
                       uint8_t* __restrict__ keep_out,
                       float* __restrict__ boxes_out,
                       int k, int n, int nc, float iou_thres) {
  extern __shared__ __align__(16) unsigned char smem[];
  const size_t b = blockIdx.x;
  const int np = 64 * ((k + 63) / 64);
  const Image im = carve(smem, np);
  int* s_scan = reinterpret_cast<int*>(smem + image_bytes(np));
  neg_k += b * k;
  combo_k += b * k;
  const float4* regs4 = reinterpret_cast<const float4*>(regs) + b * n;
  const float4* geo4 = reinterpret_cast<const float4*>(geo);
  keep_out += b * k;
  float4* boxes4 = reinterpret_cast<float4*>(boxes_out) + b * k;

  // 1. gather + decode of rank i (blockDim.x >= k)
  const int i = threadIdx.x;
  bool valid = false;
  float4 ob;                                      // class-offset box
  float area;
  if (i < k) {
    const float neg = neg_k[i];
    const int combo = combo_k[i];
    const int idx = combo / nc;
    float4 box;
    if (combo >= 0 && idx < n) {
      const float4 r = regs4[idx];
      const float4 g = geo4[2 * idx];             // cx, cy, stride, aw
      const float ah = geo4[2 * idx + 1].x;
      const float sx = sigmoid_rn(r.x), sy = sigmoid_rn(r.y);
      const float sw = sigmoid_rn(r.z), sh = sigmoid_rn(r.w);
      // x = (s*2 - 0.5 + cx) * stride;  w = (s*2)^2 * aw
      const float x = __fmul_rn(
          __fadd_rn(__fsub_rn(__fmul_rn(sx, 2.f), 0.5f), g.x), g.z);
      const float y = __fmul_rn(
          __fadd_rn(__fsub_rn(__fmul_rn(sy, 2.f), 0.5f), g.y), g.z);
      const float tw = __fmul_rn(sw, 2.f);
      const float th = __fmul_rn(sh, 2.f);
      const float w = __fmul_rn(__fmul_rn(tw, tw), g.w);
      const float h = __fmul_rn(__fmul_rn(th, th), ah);
      const float hw = __fdiv_rn(w, 2.f);
      const float hh = __fdiv_rn(h, 2.f);
      box = make_float4(__fsub_rn(x, hw), __fsub_rn(y, hh),
                        __fadd_rn(x, hw), __fadd_rn(y, hh));
      valid = neg < 0.f;
      const float off = __fmul_rn((float)(combo - idx * nc), kMaxWH);
      ob = make_float4(__fadd_rn(box.x, off), __fadd_rn(box.y, off),
                       __fadd_rn(box.z, off), __fadd_rn(box.w, off));
      area = __fmul_rn(__fsub_rn(ob.z, ob.x), __fsub_rn(ob.w, ob.y));
    } else {  // out-of-range index: never read past the inputs
      box = make_float4(__int_as_float(0x7fc00000), 0.f, 0.f, 0.f);
    }
    boxes4[i] = box;
    keep_out[i] = 0;
  }

  // 2. compaction of the valid ranks, in rank order
  int nv;
  const int pos = block_scan(valid ? 1 : 0, s_scan, &nv);
  if (valid) {
    im.box[pos] = ob;
    im.area[pos] = area;
    im.rank[pos] = i;
  }
  __syncthreads();

  // 3. rows by every warp, the walk by warp 0
  image_rows(im, nv, iou_thres);
  __syncthreads();
  if (threadIdx.x < 32) walk(im, nv, keep_out, threadIdx.x);
}

}  // namespace

extern "C" {

int fastdet_rank_decode_nms_max_k() { return kMaxK; }

// Shared memory (bytes) of one CTA at window k.
size_t fastdet_rank_decode_nms_smem(int k) { return smem_bytes(k); }

// neg_k (B,k) f32, combo_k (B,k) i32, regs (B,n,4) f32, geo (n,8) f32 ->
// keep (B,k) u8, boxes (B,k,4) f32; all contiguous on one device.
// threads: the CTA of `rank_decode_nms_plan` (k <= threads <= 1024,
// whole warps).  Returns a cudaError_t (0 = launched).
int fastdet_rank_decode_nms(const float* neg_k, const int32_t* combo_k,
                            const float* regs, const float* geo,
                            uint8_t* keep, float* boxes, int b, int k, int n,
                            int nc, float iou_thres, int threads,
                            void* stream) {
  if (b < 1 || k < 1 || k > kMaxK || n < 1 || nc < 1 || threads < k ||
      threads > kMaxThreads || threads % 32 != 0)
    return (int)cudaErrorInvalidValue;
  rank_decode_nms_kernel<<<b, threads, smem_bytes(k),
                           (cudaStream_t)stream>>>(
      neg_k, combo_k, regs, geo, keep, boxes, k, n, nc, iou_thres);
  return (int)cudaGetLastError();
}

const char* fastdet_cuda_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
