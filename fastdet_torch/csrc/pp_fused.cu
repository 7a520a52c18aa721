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
// reads about k*64 bytes and does about k^2/2 IoUs (k=128: ~8 KB and
// ~0.15 MFLOP), so the roofline time is well under a microsecond for a
// whole b128 batch; the greedy walk is a chain of k dependent steps, and
// launch latency plus that chain set the time.  The design:
//   * one CTA per image; the image's candidates live in shared memory;
//   * integer idx = combo / nc, cls = combo % nc, and direct 16-byte loads
//     of the reg row (B,N,4) and geometry row (N,8) -- the TPU version's
//     one-hot MXU gather and f32 floor trick are TPU workarounds;
//   * the (k,k) overlap matrix as a bitmask in shared memory (one 32-bit
//     word per (row, 32 columns); k=384 needs 18 KB), built by all threads;
//   * one warp walks the ranks in order and keeps a rank when no kept
//     higher rank overlaps it: the greedy scan, which is the unique
//     solution of the TPU version's triangular fixpoint.
//
// Rounding: every float operation is an explicit round-to-nearest
// intrinsic in the JAX package's operation order, and the library is built
// with --fmad=false, so no a*b+c is contracted.  Sigmoid is
// 1/(1+expf(-x)), op for op PyTorch's CUDA sigmoid, so the plain PyTorch
// version on the card gives the same bits.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kMaxK = 384;
constexpr int kMaxWords = kMaxK / 32;
constexpr int kThreads = 256;
constexpr float kMaxWH = 4096.f;

__device__ __forceinline__ float sigmoid_rn(float x) {
  return __fdiv_rn(1.f, __fadd_rn(1.f, expf(-x)));
}

__global__ void __launch_bounds__(kThreads)
rank_decode_nms_kernel(const float* __restrict__ neg_k,
                       const int32_t* __restrict__ combo_k,
                       const float* __restrict__ regs,
                       const float* __restrict__ geo,
                       uint8_t* __restrict__ keep_out,
                       float* __restrict__ boxes_out,
                       int k, int n, int nc, float iou_thres) {
  __shared__ float4 s_box[kMaxK];                 // class-offset xyxy
  __shared__ float s_area[kMaxK];
  __shared__ uint32_t s_valid[kMaxWords];
  __shared__ uint32_t s_keep[kMaxWords];
  __shared__ uint32_t s_mask[kMaxK * kMaxWords];  // row i, bit j: j sup. i

  const int b = blockIdx.x;
  const int tid = threadIdx.x;
  const int words = (k + 31) / 32;
  neg_k += (size_t)b * k;
  combo_k += (size_t)b * k;
  const float4* regs4 = reinterpret_cast<const float4*>(regs) + (size_t)b * n;
  const float4* geo4 = reinterpret_cast<const float4*>(geo);
  keep_out += (size_t)b * k;
  float4* boxes4 = reinterpret_cast<float4*>(boxes_out) + (size_t)b * k;

  if (tid < kMaxWords) s_valid[tid] = 0u;
  __syncthreads();

  // 1. gather + decode, one candidate per thread
  for (int i = tid; i < k; i += kThreads) {
    const int combo = combo_k[i];
    const int idx = combo / nc;
    const int cls = combo - idx * nc;
    float4 box;
    bool valid = false;
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
      valid = neg_k[i] < 0.f;
    } else {  // out-of-range index: never read past the inputs
      box = make_float4(__int_as_float(0x7fc00000), 0.f, 0.f, 0.f);
    }
    boxes4[i] = box;
    const float off = __fmul_rn((float)cls, kMaxWH);
    const float4 ob = make_float4(__fadd_rn(box.x, off), __fadd_rn(box.y, off),
                                  __fadd_rn(box.z, off), __fadd_rn(box.w, off));
    s_box[i] = ob;
    s_area[i] = __fmul_rn(__fsub_rn(ob.z, ob.x), __fsub_rn(ob.w, ob.y));
    if (valid) atomicOr(&s_valid[i >> 5], 1u << (i & 31));
  }
  __syncthreads();

  // 2. overlap bitmask: word (i, w) holds bits j in [32w, 32w+32), j < i,
  //    set where j is valid and IoU(i, j) > thres
  for (int t = tid; t < k * words; t += kThreads) {
    const int i = t / words;
    const int w = t - i * words;
    const int j0 = w * 32;
    uint32_t bits = 0u;
    if (j0 < i) {
      const float4 bi = s_box[i];
      const float ai = s_area[i];
      const uint32_t vw = s_valid[w];
      const int jn = min(32, i - j0);
      for (int jj = 0; jj < jn; ++jj) {
        if (!((vw >> jj) & 1u)) continue;
        const float4 bj = s_box[j0 + jj];
        const float iw = fmaxf(__fsub_rn(fminf(bi.z, bj.z), fmaxf(bi.x, bj.x)), 0.f);
        const float ih = fmaxf(__fsub_rn(fminf(bi.w, bj.w), fmaxf(bi.y, bj.y)), 0.f);
        const float inter = __fmul_rn(iw, ih);
        // inter / (area_i + area_j - inter + 1e-9)
        const float den = __fadd_rn(
            __fsub_rn(__fadd_rn(ai, s_area[j0 + jj]), inter), 1e-9f);
        if (__fdiv_rn(inter, den) > iou_thres) bits |= 1u << jj;
      }
    }
    s_mask[i * kMaxWords + w] = bits;
  }
  __syncthreads();

  // 3. greedy walk in rank order by warp 0; lane l owns keep word l
  if (tid < 32) {
    uint32_t kw = 0u;
    for (int i = 0; i < k; ++i) {
      const int w = i >> 5;
      const bool hit = tid <= w && (s_mask[i * kMaxWords + tid] & kw) != 0u;
      const bool suppressed = __any_sync(0xffffffffu, hit);
      if (tid == w && !suppressed && ((s_valid[w] >> (i & 31)) & 1u))
        kw |= 1u << (i & 31);
    }
    if (tid < words) s_keep[tid] = kw;
  }
  __syncthreads();
  for (int i = tid; i < k; i += kThreads)
    keep_out[i] = (uint8_t)((s_keep[i >> 5] >> (i & 31)) & 1u);
}

}  // namespace

extern "C" {

int fastdet_rank_decode_nms_max_k() { return kMaxK; }

// neg_k (B,k) f32, combo_k (B,k) i32, regs (B,n,4) f32, geo (n,8) f32 ->
// keep (B,k) u8, boxes (B,k,4) f32; all contiguous on one device.
// Returns a cudaError_t (0 = launched).
int fastdet_rank_decode_nms(const float* neg_k, const int32_t* combo_k,
                            const float* regs, const float* geo,
                            uint8_t* keep, float* boxes, int b, int k, int n,
                            int nc, float iou_thres, void* stream) {
  if (b < 1 || k < 1 || k > kMaxK || n < 1 || nc < 1)
    return (int)cudaErrorInvalidValue;
  rank_decode_nms_kernel<<<b, kThreads, 0, (cudaStream_t)stream>>>(
      neg_k, combo_k, regs, geo, keep, boxes, k, n, nc, iou_thres);
  return (int)cudaGetLastError();
}

const char* fastdet_cuda_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
