// The bf16 training span B8: the stride-1 ShuffleV2 blocks of one backbone
// stage with ghost BatchNorm, forward and backward, on bf16 activations,
// by hand for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernels fastdet/kernels/fused_train.py at
// dtype=bfloat16 (_fwd_call -> _span_train_fwd_kernel, _bwd_call ->
// _span_train_bwd_kernel).  One block, C = 2*MID in {48, 96, 192}:
//   u1 = pw1(x[:, 1::2]) with bf16(w1)   y = bf16(ReLU(BN1(u1)))
//   u2 = dw3x3(y) with bf16(wd)          v = bf16(BN2(u2))
//   u3 = pw2(v) with bf16(w2)            z = bf16(ReLU(BN3(u3)))
//   out = cat[x[:, 0::2], z]
// Each BN takes the statistics of its ghost group (g images, m = g*h*w
// samples a channel): the mean, then the biased variance of u - mean, eps
// 1e-5.  The backward recomputes each block from its saved input and the
// saved statistics and rounds where the JAX kernel rounds: du3 before dv =
// w2 du3, du2 before the depthwise products (dwd and dy), du1 and the
// passthrough gradient before dx; dW2 = v (x) du3 and dW1 = x (x) du1 take
// the f32 du; the gradient between blocks stays f32 and dx leaves as bf16.
// The plain versions are fused_train.span_train_forward_reference /
// span_train_backward_reference on a bf16 x.
//
// Design.  A thread-block cluster per ghost group: the group's pixels are
// cut into bands, one a CTA (`bpi` bands of `rows` rows an image, or `ipc`
// whole images a CTA), and the band stays in shared memory, pixel-major,
// for every block of the span: one launch a stage call forward, and one
// backward plus one that adds the weight-gradient partial rows in a fixed
// order.  Each BN's statistics are a cluster reduction: every CTA pushes
// its channel sums into the shared memory of every CTA of the cluster
// (st.async, counted on an mbarrier), and every CTA adds the n rows in
// rank order, so that every CTA holds the same bits; the mean first, then
// sum (u - mean)^2 the same way (never E[u^2] - mean^2); rank 0 writes the
// group's statistics.  No atomics: two runs give the same bits.  The
// depthwise conv's halo rows are pushed by the neighbouring band's CTA the
// same way, zeros off the image.
//
// Products.  A warp holds MTW m-tiles (16 pixels) by NTW n-tiles (8
// channels) of the band in the mma.sync fragment layout, so that every
// pointwise output, and the depthwise conv's output in the same layout,
// stays in registers through its BN's cluster reductions: the band is at
// most PMAX pixels (512 / 256 / 128 at MID 24 / 48 / 96).  The backward's
// products run on bf16 tensor cores (mma.sync m16n8k16, f32 accumulate,
// operands bf16 in shared memory): dv = w2' bf16(du3), the odd half of dx
// = w1' bf16(du1), and dW1, dW2 (f32 du times a bf16 operand) with du
// split into two bf16 terms, hi = bf16(du), lo = bf16(du - hi): |du - hi
// - lo| <= 2^-17 |du|, each product exact in f32.  pw1 and pw2, forward
// and recompute, run on CUDA cores in the plain version's order (`pw_seq`),
// so that the recompute's ReLU masks are the plain version's: on tensor
// cores, whose sums round otherwise, the recompute moved masks where BN's
// input sat within a rounding of 0, each moving a 3x3 patch of dx by O(1)
// (5.8% of max |dx| at stage 2 with the reference weights, b128 352^2).
// The depthwise conv, its weight gradient and its transposed conv stay on
// CUDA cores (9 taps a channel).
//
// The channel shuffle: the forward keeps the block input in slots, logical
// channel l of block k in slot P_k(l), P_0 the identity; the passthrough
// keeps its slots (P_{k+1}(j) = P_k(2j)) and z_r is written where pw1's
// input 2r + 1 was (P_{k+1}(MID + r) = P_k(2r + 1)), as the bf16 stage
// kernel (span_block.cuh) does.  pw1 reads the odd channels gathered into
// logical order, as the backward reads them from the saved input, so that
// both multiply the same operands in the same order.  The backward's f32
// gradient lives in device memory in the same slots: the gradient of block
// k's output channel MID + r lies in slot P_k(2r + 1), where dx's odd
// channel 2r + 1 is written back, and the passthrough half never moves; a
// passthrough gradient is rounded where it is used (dz of an even channel,
// and dx at the end), which rounds it once, as the JAX kernel does.
//
// Bit for bit: the backward recomputes u1, y, u2, v, u3 and the ReLU masks
// by the same functions as the forward (pw1, pw2 and the taps in order by
// fmaf, BN as __fadd_rn(__fmul_rn(__fsub_rn(u, mu), s), beta) with s =
// __fmul_rn(sinv, gamma) from the saved sinv), so its y, v, z and masks are
// the forward's, and the plain version's from the same saved input and
// statistics, bit for bit however the compiler contracts the rest.
//
// What bounds it on this card: at b128 352^2 the saved block inputs (172
// MB bf16) are written once by the forward and read once by the backward,
// 0.077 ms each at 3.35 TB/s; the products are ~8.2 GFLOP forward, 0.008
// ms at the bf16 tensor-core rate (0.12 ms on the CUDA cores' 67 TFLOP/s,
// where pw1 and pw2 run).

#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stddef.h>
#include <stdint.h>

namespace {

namespace cg = cooperative_groups;
typedef __nv_bfloat16 bf16;

constexpr int kThreads = 512;
constexpr int kWarps = kThreads / 32;
constexpr float kEps = 1e-5f;
constexpr size_t kSmemLimit = 232448;   // bytes a CTA may use on sm_90
constexpr int kMaxCluster = 16;          // with the non-portable attribute

__host__ __device__ constexpr int pad16(int n) { return (n + 15) & ~15; }
// the stride (bf16) of a pixel of n channels (n a multiple of 8): an odd
// number of 16-byte units, so that the 8 rows of an ldmatrix meet
// distinct banks
__host__ __device__ constexpr int odd16(int n) {
  return ((n / 8) & 1) ? n : n + 8;
}
__host__ __device__ constexpr int up16(int n) { return (n + 15) & ~15; }
// pixels a band holds at most: a warp's fragments of a band stay in
// registers (Cfg::MTW m-tiles by Cfg::NTW n-tiles)
__host__ __device__ constexpr int pmax_of(int mid) {
  return mid == 24 ? 512 : mid == 48 ? 256 : 128;
}

// warps along N of the fragment layout (each 3 n-tiles of 8 channels) and
// along M (each 2 m-tiles of 16 pixels at the band's PMAX)
__host__ __device__ constexpr int warps_n(int mid) { return mid / 24; }
__host__ __device__ constexpr int warps_m(int mid) {
  return kWarps / warps_n(mid);
}

template <int MID>
struct Cfg {
  static constexpr int C = 2 * MID;
  static constexpr int NT = MID / 8;               // n-tiles of 8 channels
  static constexpr int WN = warps_n(MID);          // warps along N
  static constexpr int NTW = NT / WN;              // n-tiles a warp
  static constexpr int WM = warps_m(MID);          // warps along M
  static constexpr int PMAX = pmax_of(MID);        // pixels a band
  static constexpr int MTW = PMAX / (16 * WM);     // m-tiles a warp
  static constexpr int KS = pad16(MID) / 16;       // k-steps of a pointwise
  static constexpr int PSX = odd16(C);
  static constexpr int PSY = odd16(MID);
  static constexpr int LEN = 2 * MID * MID + 15 * MID;
  static constexpr int WD = MID * MID;             // row offsets
  static constexpr int W2 = MID * MID + 9 * MID;
  static constexpr int GB = 2 * MID * MID + 9 * MID;
};

// Byte offsets into a CTA's shared memory.  Forward: V shares XO's bytes
// (XO is used up by pw1), and X holds the band's C slots.  Backward: V is
// also du2 with its halo (after dW2), DH / DL hold hi and lo of du3, then
// of du1.
struct Layout {
  int zero;    // 16 zero bytes: the A or B row of a k past MID
  int bar;     // 4 mbarriers: the cluster's sums arrived (by slot), the
               // halo rows of Y and of du2 arrived
  int lmap;    // 3 x C int16: two slot tables and an inverse
  int cst;     // 15 x MID f32: mu, sinv, sinv*gamma, beta, gamma of 3 BNs
  int red;     // WM x 2 x MID f32: the warp rows' channel sums
  int recv;    // 2 x n x 2 x MID f32: each CTA's sums, pushed by it
  int tot;     // 2 x MID f32: the cluster's sums
  int wd;      // 9 x MID f32: bf16(wd)
  int w1, w2;  // bf16(w1), bf16(w2), [in][out]: forward MID x MID f32
               // (`pw_seq` reads them unconverted), backward MID x
               // odd16(MID) bf16 (also the tensor cores' B)
  int xo;      // pad16(P) x odd16(MID) bf16: x's odd channels
  int y;       // ipc x (rows + 2) x (w + 2) x odd16(MID) bf16: y, halo
  int v;       // V (forward: = xo)
  int x;       // forward: P x odd16(C) bf16, the band's slots
  int dh, dl;  // backward: pad16(P) x odd16(MID) bf16 each
  int bytes;
};

__host__ __device__ inline Layout span16_train_layout(int mid, int rows, int w,
                                                      int ipc, int n, int bwd) {
  const int c = 2 * mid, P = ipc * rows * w, p16 = pad16(P);
  const int psy = odd16(mid), psx = odd16(c);
  const int halo_px = ipc * (rows + 2) * (w + 2);
  Layout L{};
  int at = 0;
  L.zero = at; at += 16;
  L.bar = at; at += 32;
  L.lmap = at; at += up16(6 * c);
  L.cst = at; at += up16(15 * mid * 4);
  L.red = at; at += up16(warps_m(mid) * 2 * mid * 4);
  L.recv = at; at += up16(2 * n * 2 * mid * 4);
  L.tot = at; at += up16(2 * mid * 4);
  L.wd = at; at += up16(9 * mid * 4);
  const int wbytes = bwd ? mid * psy * 2 : mid * mid * 4;
  L.w1 = at; at += up16(wbytes);
  L.w2 = at; at += up16(wbytes);
  L.xo = at; at += up16(p16 * psy * 2);
  L.y = at; at += up16(halo_px * psy * 2);
  if (!bwd) {
    L.v = L.xo;
    L.x = at; at += up16(P * psx * 2);
    L.dh = L.dl = 0;
  } else {
    L.v = at;
    at += up16((p16 > halo_px ? p16 : halo_px) * psy * 2);
    L.dh = at; at += up16(p16 * psy * 2);
    L.dl = at; at += up16(p16 * psy * 2);
    L.x = 0;
  }
  L.bytes = at;
  return L;
}

// The launch geometry: cluster n per group of g images; ipc > 1: ipc whole
// images a CTA (bpi 1, rows h); else bpi bands of `rows` rows an image.
struct Geo {
  int b, h, w, nblk, g, n, bpi, ipc, rows;
};

bool geo_valid(const Geo& G, int c) {
  if (c != 48 && c != 96 && c != 192) return false;
  if (G.b < 1 || G.h < 1 || G.w < 1 || G.nblk < 1 || G.g < 1 || G.b % G.g)
    return false;
  if (G.n < 1 || G.n > kMaxCluster || G.bpi < 1 || G.ipc < 1 || G.rows < 1)
    return false;
  if (G.ipc > 1) {
    if (G.bpi != 1 || G.rows != G.h || G.g % G.ipc || G.n != G.g / G.ipc)
      return false;
  } else {
    if (G.n != G.g * G.bpi || G.rows != (G.h + G.bpi - 1) / G.bpi ||
        (G.bpi - 1) * G.rows >= G.h)
      return false;
  }
  if (G.ipc * G.rows * G.w > pmax_of(c / 2)) return false;
  if ((size_t)G.b * c * G.h * G.w >= ((size_t)1 << 31) / 4) return false;
  for (int bwd = 0; bwd < 2; ++bwd)
    if ((size_t)span16_train_layout(c / 2, G.rows, G.w, G.ipc, G.n, bwd)
            .bytes >
        kSmemLimit)
      return false;
  return true;
}

// ---- device intrinsics

__device__ __forceinline__ unsigned char* dyn_smem() {
  extern __shared__ uint4 smem_u4[];
  return reinterpret_cast<unsigned char*>(smem_u4);
}

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return (uint32_t)__cvta_generic_to_shared(p);
}

__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], uint32_t a) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(a));
}

__device__ __forceinline__ void ldsm_x4_t(uint32_t (&r)[4], uint32_t a) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, "
      "[%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(a));
}

__device__ __forceinline__ void ldsm_x2(uint32_t (&r)[2], uint32_t a) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x2.shared.b16 {%0, %1}, [%2];\n"
               : "=r"(r[0]), "=r"(r[1])
               : "r"(a));
}

__device__ __forceinline__ void ldsm_x2_t(uint32_t (&r)[2], uint32_t a) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x2.trans.shared.b16 {%0, %1}, [%2];\n"
      : "=r"(r[0]), "=r"(r[1])
      : "r"(a));
}

__device__ __forceinline__ void mma16816(float (&d)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ uint32_t mapa(uint32_t addr, int rank) {
  uint32_t r;
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;\n"
               : "=r"(r)
               : "r"(addr), "r"(rank));
  return r;
}

// v into the shared memory of a cluster peer (raddr), the arrival of its
// bytes signalled on the peer's mbarrier (rbar)
__device__ __forceinline__ void st_async(uint32_t raddr, float v,
                                         uint32_t rbar) {
  asm volatile(
      "st.async.shared::cluster.mbarrier::complete_tx::bytes.f32 [%0], %1, "
      "[%2];\n" ::"r"(raddr),
      "f"(v), "r"(rbar)
      : "memory");
}

__device__ __forceinline__ void st_async16(uint32_t raddr, uint4 v,
                                           uint32_t rbar) {
  asm volatile(
      "st.async.shared::cluster.mbarrier::complete_tx::bytes.v4.b32 [%0], "
      "{%1, %2, %3, %4}, [%5];\n" ::"r"(raddr),
      "r"(v.x), "r"(v.y), "r"(v.z), "r"(v.w), "r"(rbar)
      : "memory");
}

__device__ __forceinline__ void mbar_init(uint32_t bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar),
               "r"(count));
}

__device__ __forceinline__ void mbar_init_fence() {
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile(
      "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar),
      "r"(bytes)
      : "memory");
}

__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  asm volatile(
      "{\n"
      ".reg .pred P1;\n"
      "LAB_WAIT:\n"
      "mbarrier.try_wait.parity.shared::cta.b64 P1, [%0], %1;\n"
      "@P1 bra DONE;\n"
      "bra LAB_WAIT;\n"
      "DONE:\n"
      "}\n" ::"r"(bar),
      "r"(parity)
      : "memory");
}

__device__ __forceinline__ void cluster_sync_all() {
  asm volatile(
      "barrier.cluster.arrive.release.aligned;\n"
      "barrier.cluster.wait.acquire.aligned;\n" ::
          : "memory");
}

// ---- end of device intrinsics

__device__ __forceinline__ float r16(float v) {
  return __bfloat162float(__float2bfloat16_rn(v));
}

// BN with a group's mu, s = sinv*gamma and beta, in the rounding the
// backward repeats
__device__ __forceinline__ float bn_apply(float u, float mu, float s,
                                          float beta) {
  return __fadd_rn(__fmul_rn(__fsub_rn(u, mu), s), beta);
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// The CTA's band of its group.
struct Band {
  int gi, rank;
  int img0;        // the band's first image
  int r0, rv;      // its first row and live rows (ipc > 1: 0, h)
  int P, live, p16;
  bool above, below;   // a neighbouring band of the same image
};

__device__ __forceinline__ Band make_band(const Geo& G) {
  Band B;
  B.rank = blockIdx.x;
  B.gi = blockIdx.y;
  if (G.ipc > 1) {
    B.img0 = B.gi * G.g + B.rank * G.ipc;
    B.r0 = 0;
    B.rv = G.h;
    B.above = B.below = false;
  } else {
    const int j = B.rank % G.bpi;
    B.img0 = B.gi * G.g + B.rank / G.bpi;
    B.r0 = j * G.rows;
    B.rv = min(G.rows, G.h - B.r0);
    B.above = j > 0;
    B.below = j + 1 < G.bpi;
  }
  B.P = G.ipc * G.rows * G.w;
  B.live = G.ipc > 1 ? B.P : B.rv * G.w;
  B.p16 = pad16(B.P);
  return B;
}

// image and plane offset of band pixel p
__device__ __forceinline__ int img_of(const Geo& G, const Band& B, int p) {
  return B.img0 + p / (G.rows * G.w);
}
__device__ __forceinline__ int off_of(const Geo& G, const Band& B, int p) {
  return B.r0 * G.w + p % (G.rows * G.w);
}
// the pixel of band pixel p in a haloed buffer (Y, du2)
__device__ __forceinline__ int ypix(const Geo& G, int p) {
  const int per = G.rows * G.w, j = p / per, q = p - j * per;
  const int i = q / G.w, c = q - i * G.w;
  return (j * (G.rows + 2) + i + 1) * (G.w + 2) + c + 1;
}

// The warp's fragment coordinates: m-tile mt holds pixels 16*(wm + WM*mt)
// + g8 + 8r, n-tile n channels (wn*NTW + n)*8 + 2*t4 + e; register
// acc[mt][n][2r + e].
template <int MID>
__device__ __forceinline__ void frag_coords(int& wm, int& wn, int& g8,
                                            int& t4) {
  using K = Cfg<MID>;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  wn = warp % K::WN;
  wm = warp / K::WN;
  g8 = lane >> 2;
  t4 = lane & 3;
}

template <int MID>
using Acc = float[Cfg<MID>::MTW][Cfg<MID>::NTW][4];

// The backward's transposed products on the tensor cores: acc(p, i) =
// sum over o of A[p][o] * W[i][o] (dv = w2' bf16(du3), dx's odd half =
// w1' bf16(du1)), A the pad16(P) x MID bf16 rows at a_s (pixel stride
// odd16(MID)), W the MID x MID bf16 matrix at w_s ([in][out], row stride
// odd16(MID)) read as B[k][n] = W[n][k].  Each k-step's 16 products go
// into a zero accumulator (mma.sync m16n8k16), added to the running f32
// sum by __fadd_rn, so that the running sum does not pass through the
// tensor core's truncating adder.
template <int MID>
__device__ __forceinline__ void gemm_t(Acc<MID>& acc, uint32_t a_s,
                                       uint32_t w_s, uint32_t zero,
                                       int p16) {
  using K = Cfg<MID>;
  int wm, wn, g8, t4;
  frag_coords<MID>(wm, wn, g8, t4);
  const int lane = threadIdx.x & 31;
  const int ah = lane >> 4, ar = lane & 15;
  const int bj = (lane >> 3) & 1, br = lane & 7;
#pragma unroll
  for (int mt = 0; mt < K::MTW; ++mt)
#pragma unroll
    for (int n = 0; n < K::NTW; ++n)
#pragma unroll
      for (int q = 0; q < 4; ++q) acc[mt][n][q] = 0.f;
#pragma unroll
  for (int s = 0; s < K::KS; ++s) {
    uint32_t a[K::MTW][4];
    uint32_t b[K::NTW][2];
    const int ka = 16 * s + 8 * ah;
#pragma unroll
    for (int mt = 0; mt < K::MTW; ++mt) {
      const int m0 = 16 * (wm + K::WM * mt);
      if (m0 < p16)
        ldsm_x4(a[mt], ka < MID ? a_s + ((m0 + ar) * K::PSY + ka) * 2 : zero);
    }
#pragma unroll
    for (int n = 0; n < K::NTW; ++n) {
      const int n0 = (wn * K::NTW + n) * 8;
      const int k = 16 * s + 8 * bj;
      ldsm_x2(b[n], k < MID ? w_s + ((n0 + br) * K::PSY + k) * 2 : zero);
    }
#pragma unroll
    for (int mt = 0; mt < K::MTW; ++mt)
      if (16 * (wm + K::WM * mt) < p16)
#pragma unroll
        for (int n = 0; n < K::NTW; ++n) {
          float t[4] = {0.f, 0.f, 0.f, 0.f};
          mma16816(t, a[mt], b[n][0], b[n][1]);
#pragma unroll
          for (int q = 0; q < 4; ++q)
            acc[mt][n][q] = __fadd_rn(acc[mt][n][q], t[q]);
        }
  }
}

// A pointwise conv in the fragment layout: acc(p, o) = sum over the input
// channels i in order of A[p][i] * W[i][o], by fmaf from 0, A the pad16(P)
// x MID bf16 rows at A (pixel stride odd16(MID)), W the MID x MID bf16
// matrix ([in][out], row stride odd16(MID)), or the same values as f32
// (row stride MID).  A bf16 x bf16 product is
// exact in f32, so each step is the plain version's acc + x*w with one
// rounding: the forward, the backward's recompute and the plain version
// (_pw) get the same bits, and the recompute's ReLU masks are the plain
// version's (tensor-core sums, which round otherwise, moved some of them;
// a moved mask moves a 3x3 patch of dx by O(1)).  A lane reads 8 input
// channels of a pixel at once.
__device__ __forceinline__ float2 w_pair(const bf16* W, int at) {
  return __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(W + at));
}
__device__ __forceinline__ float2 w_pair(const float* W, int at) {
  return *reinterpret_cast<const float2*>(W + at);
}

template <int MID, typename WT>
__device__ __forceinline__ void pw_seq(Acc<MID>& acc, const bf16* A,
                                       const WT* W, int p16) {
  constexpr int WS = sizeof(WT) == 4 ? MID : Cfg<MID>::PSY;  // W's row
  using K = Cfg<MID>;
  int wm, wn, g8, t4;
  frag_coords<MID>(wm, wn, g8, t4);
  bool ok[K::MTW];
#pragma unroll
  for (int mt = 0; mt < K::MTW; ++mt) {
    ok[mt] = 16 * (wm + K::WM * mt) < p16;
#pragma unroll
    for (int n = 0; n < K::NTW; ++n)
#pragma unroll
      for (int q = 0; q < 4; ++q) acc[mt][n][q] = 0.f;
  }
  for (int i0 = 0; i0 < MID; i0 += 8) {
    uint4 av[K::MTW][2];
#pragma unroll
    for (int mt = 0; mt < K::MTW; ++mt)
#pragma unroll
      for (int r = 0; r < 2; ++r)
        av[mt][r] = ok[mt] ? *reinterpret_cast<const uint4*>(
                                 A + (16 * (wm + K::WM * mt) + g8 + 8 * r) *
                                         K::PSY + i0)
                           : make_uint4(0, 0, 0, 0);
#pragma unroll
    for (int ii = 0; ii < 8; ++ii) {
      float2 wv[K::NTW];
#pragma unroll
      for (int n = 0; n < K::NTW; ++n)
        wv[n] = w_pair(W, (i0 + ii) * WS + (wn * K::NTW + n) * 8 + 2 * t4);
#pragma unroll
      for (int mt = 0; mt < K::MTW; ++mt)
#pragma unroll
        for (int r = 0; r < 2; ++r) {
          const float a = __bfloat162float(
              reinterpret_cast<const bf16*>(&av[mt][r])[ii]);
#pragma unroll
          for (int n = 0; n < K::NTW; ++n) {
            acc[mt][n][2 * r] = __fmaf_rn(a, wv[n].x, acc[mt][n][2 * r]);
            acc[mt][n][2 * r + 1] =
                __fmaf_rn(a, wv[n].y, acc[mt][n][2 * r + 1]);
          }
        }
    }
  }
}

// The depthwise 3x3 of a haloed buffer in the fragment layout: acc(p, o)
// = sum over taps t in order of wd[t'][o] * src(p + tap t)[o], t' = t, or
// 8 - t where FLIP (the transposed conv of the backward).  bf16 x bf16 is
// exact in f32, so fmaf adds each product with one rounding, as the plain
// version's acc + w*y does.
template <int MID, bool FLIP>
__device__ __forceinline__ void dw_px(Acc<MID>& acc, const bf16* src,
                                      const float* wd, const Geo& G,
                                      const Band& B) {
  using K = Cfg<MID>;
  int wm, wn, g8, t4;
  frag_coords<MID>(wm, wn, g8, t4);
  const int pitch = G.w + 2;
  int yp[K::MTW][2];
#pragma unroll
  for (int mt = 0; mt < K::MTW; ++mt)
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int p = 16 * (wm + K::WM * mt) + g8 + 8 * r;
      yp[mt][r] = p < B.P ? ypix(G, p) : -1;
    }
#pragma unroll
  for (int n = 0; n < K::NTW; ++n) {
    const int o = (wn * K::NTW + n) * 8 + 2 * t4;
#pragma unroll
    for (int mt = 0; mt < K::MTW; ++mt)
#pragma unroll
      for (int q = 0; q < 4; ++q) acc[mt][n][q] = 0.f;
#pragma unroll
    for (int t = 0; t < 9; ++t) {
      const int tt = FLIP ? 8 - t : t;
      const float2 wv = *reinterpret_cast<const float2*>(wd + tt * MID + o);
      const int dt = (t / 3 - 1) * pitch + (t % 3 - 1);
#pragma unroll
      for (int mt = 0; mt < K::MTW; ++mt)
#pragma unroll
        for (int r = 0; r < 2; ++r) {
          if (yp[mt][r] < 0) continue;
          const __nv_bfloat162 v = *reinterpret_cast<const __nv_bfloat162*>(
              src + (yp[mt][r] + dt) * K::PSY + o);
          acc[mt][n][2 * r] = __fmaf_rn(wv.x, __low2float(v),
                                        acc[mt][n][2 * r]);
          acc[mt][n][2 * r + 1] = __fmaf_rn(wv.y, __high2float(v),
                                            acc[mt][n][2 * r + 1]);
        }
    }
  }
}

// Shared state of the kernels.
template <int MID>
struct Smem {
  unsigned char* base;
  Layout L;
  short* lm;       // [2][C] slot tables, then [C] inverse
  float* cst;      // mu[3], sinv[3], sc[3], beta[3], gamma[3] x MID
  float* red;
  float* recv;
  float* tot;
  float* wd;
  bf16 *w1, *w2, *xo, *y, *v, *x, *dh, *dl;
  float *w1f, *w2f;   // the forward's f32 weights (the same bytes)
  uint32_t zero;
  int rs;          // cluster reductions so far (recv's slot and phase)
  __device__ __forceinline__ Smem(int rows, int w, int ipc, int n, int bwd) {
    base = dyn_smem();
    L = span16_train_layout(MID, rows, w, ipc, n, bwd);
    lm = reinterpret_cast<short*>(base + L.lmap);
    cst = reinterpret_cast<float*>(base + L.cst);
    red = reinterpret_cast<float*>(base + L.red);
    recv = reinterpret_cast<float*>(base + L.recv);
    tot = reinterpret_cast<float*>(base + L.tot);
    wd = reinterpret_cast<float*>(base + L.wd);
    w1 = reinterpret_cast<bf16*>(base + L.w1);
    w2 = reinterpret_cast<bf16*>(base + L.w2);
    w1f = reinterpret_cast<float*>(base + L.w1);
    w2f = reinterpret_cast<float*>(base + L.w2);
    xo = reinterpret_cast<bf16*>(base + L.xo);
    y = reinterpret_cast<bf16*>(base + L.y);
    v = reinterpret_cast<bf16*>(base + L.v);
    x = reinterpret_cast<bf16*>(base + L.x);
    dh = reinterpret_cast<bf16*>(base + L.dh);
    dl = reinterpret_cast<bf16*>(base + L.dl);
    zero = smem_u32(base + L.zero);
    rs = 0;
  }
  __device__ __forceinline__ float* mu(int k) { return cst + k * MID; }
  __device__ __forceinline__ float* sinv(int k) { return cst + (3 + k) * MID; }
  __device__ __forceinline__ float* sc(int k) { return cst + (6 + k) * MID; }
  __device__ __forceinline__ float* beta(int k) { return cst + (9 + k) * MID; }
  __device__ __forceinline__ float* gamma(int k) {
    return cst + (12 + k) * MID;
  }
};

// The mbarriers of the cluster's sums and of the halo rows, initialised
// before any peer can push to them (a cluster barrier after the init).
__device__ __forceinline__ void init_sums(unsigned char* base,
                                          const Layout& L, int n) {
  if (threadIdx.x == 0) {
    for (int i = 0; i < 4; ++i) mbar_init(smem_u32(base + L.bar + 8 * i), 1);
    mbar_init_fence();
  }
  if (n > 1) cluster_sync_all();
  else __syncthreads();
}

// The group's channel sums of NV quantities: s[n][e][v] per thread (its
// fragment channels), added over the lanes of a channel (butterfly: every
// lane the same bits), then over the warp rows in order -> the CTA's sum
// c_i (where dst, written to dst[i]); each CTA pushes its c_i into row
// `rank` of every peer's recv (st.async, counted on the peer's mbarrier
// of this reduction's slot), waits for the n rows of its own, and adds
// them in rank order -> S.tot[v*MID + c], in every CTA the same bits.  No
// cluster barrier: a CTA reaches reduction r + 2, which reuses the slot,
// only after every peer pushed reduction r + 1, that is, after every peer
// has read reduction r.
template <int MID, int NV>
__device__ __forceinline__ void group_sums(float (&s)[Cfg<MID>::NTW][2][NV],
                                           Smem<MID>& S, const Geo& G,
                                           const Band& B, float* dst) {
  using K = Cfg<MID>;
  int wm, wn, g8, t4;
  frag_coords<MID>(wm, wn, g8, t4);
#pragma unroll
  for (int n = 0; n < K::NTW; ++n)
#pragma unroll
    for (int e = 0; e < 2; ++e)
#pragma unroll
      for (int v = 0; v < NV; ++v) {
        float x = s[n][e][v];
        x += __shfl_xor_sync(0xffffffffu, x, 4);
        x += __shfl_xor_sync(0xffffffffu, x, 8);
        x += __shfl_xor_sync(0xffffffffu, x, 16);
        s[n][e][v] = x;
      }
  if (g8 == 0) {
#pragma unroll
    for (int n = 0; n < K::NTW; ++n)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int o = (wn * K::NTW + n) * 8 + 2 * t4 + e;
#pragma unroll
        for (int v = 0; v < NV; ++v)
          S.red[(wm * NV + v) * MID + o] = s[n][e][v];
      }
  }
  __syncthreads();
  const int slot = S.rs & 1;
  const uint32_t parity = (S.rs >> 1) & 1;
  ++S.rs;
  float* rv = S.recv + slot * G.n * 2 * MID;
  const uint32_t bar = smem_u32(S.base + S.L.bar + 8 * slot);
  for (int i = threadIdx.x; i < NV * MID; i += kThreads) {
    const int v = i / MID, c = i - v * MID;
    float a = 0.f;
#pragma unroll
    for (int q = 0; q < K::WM; ++q) a += S.red[(q * NV + v) * MID + c];
    if (dst) dst[i] = a;
    if (G.n > 1) {
      const uint32_t mine = smem_u32(rv + B.rank * 2 * MID + i);
      for (int r = 0; r < G.n; ++r)
        st_async(mapa(mine, r), a, mapa(bar, r));
    } else {
      S.tot[i] = a;
    }
  }
  if (G.n > 1) {
    if (threadIdx.x == 0)
      mbar_expect_tx(bar, (uint32_t)(G.n * NV * MID * 4));
    mbar_wait(bar, parity);
    for (int i = threadIdx.x; i < NV * MID; i += kThreads) {
      float a = 0.f;
      for (int r = 0; r < G.n; ++r) a += rv[r * 2 * MID + i];
      S.tot[i] = a;
    }
  }
  __syncthreads();
}

// Zero a byte range of shared memory (16-byte aligned, a multiple of 16).
__device__ __forceinline__ void zero_bytes(unsigned char* p, int n) {
  for (int i = 16 * threadIdx.x; i < n; i += 16 * kThreads)
    *reinterpret_cast<uint4*>(p + i) = make_uint4(0, 0, 0, 0);
}

// Block k's weights from its f32 row: bf16(w1), bf16(w2) [in][out] (as
// f32 where F32W), bf16(wd) as f32, gamma and beta of the 3 BNs.
template <int MID, bool F32W>
__device__ __forceinline__ void load_weights(Smem<MID>& S, const float* row) {
  using K = Cfg<MID>;
  for (int i = threadIdx.x; i < MID * MID; i += kThreads) {
    if (F32W) {
      S.w1f[i] = r16(row[i]);
      S.w2f[i] = r16(row[K::W2 + i]);
    } else {
      const int r = i / MID, c = i - r * MID;
      S.w1[r * K::PSY + c] = __float2bfloat16_rn(row[i]);
      S.w2[r * K::PSY + c] = __float2bfloat16_rn(row[K::W2 + i]);
    }
  }
  for (int i = threadIdx.x; i < 9 * MID; i += kThreads)
    S.wd[i] = r16(row[K::WD + i]);
  for (int i = threadIdx.x; i < 3 * MID; i += kThreads) {
    const int k = i / MID, c = i - k * MID;
    S.gamma(k)[c] = row[K::GB + 2 * k * MID + c];
    S.beta(k)[c] = row[K::GB + (2 * k + 1) * MID + c];
  }
}

// The halo rows of a haloed buffer (Y, or du2 in V's bytes) from the
// neighbouring bands' CTAs: each CTA pushes its first band row into the
// band above's bottom halo row and its last into the band below's top one
// (st.async, 16 bytes a store, counted on the receiver's mbarrier `bar`
// of this buffer), then waits for its own (phase `parity`: the buffer's
// exchanges so far, mod 2).  A neighbour pushes the next exchange only
// after a reduction to which this CTA contributes after it has read its
// halo rows, so no row is overwritten while it is read.
template <int MID>
__device__ __forceinline__ void halo_rows(bf16* buf, const Geo& G,
                                          const Band& B, uint32_t bar,
                                          uint32_t parity) {
  using K = Cfg<MID>;
  if (G.n < 2 || G.bpi < 2) return;
  __syncthreads();                          // the band rows are written
  const int rowb = (G.w + 2) * K::PSY * 2;
  const unsigned char* mine = reinterpret_cast<const unsigned char*>(buf);
  const uint32_t base = smem_u32(buf);
  if (B.above) {
    const uint32_t dst = mapa(base + (G.rows + 1) * rowb, B.rank - 1);
    const uint32_t rbar = mapa(bar, B.rank - 1);
    for (int i = 16 * threadIdx.x; i < rowb; i += 16 * kThreads)
      st_async16(dst + i, *reinterpret_cast<const uint4*>(mine + rowb + i),
                 rbar);
  }
  if (B.below) {
    const uint32_t dst = mapa(base, B.rank + 1);
    const uint32_t rbar = mapa(bar, B.rank + 1);
    for (int i = 16 * threadIdx.x; i < rowb; i += 16 * kThreads)
      st_async16(dst + i,
                 *reinterpret_cast<const uint4*>(mine + G.rows * rowb + i),
                 rbar);
  }
  if (threadIdx.x == 0)
    mbar_expect_tx(bar, (uint32_t)(rowb * ((B.above ? 1 : 0) +
                                           (B.below ? 1 : 0))));
  mbar_wait(bar, parity);
}

// One BN's group statistics from the fragments (live pixels): the mean,
// then the mean of (u - mean)^2, each a cluster reduction -> mu, sinv,
// sc = sinv*gamma in S; rank 0 writes (mu, sinv, var) to st (3 x MID).
template <int MID>
__device__ void bn_stats(const Acc<MID>& acc, Smem<MID>& S, int k,
                         const Geo& G, const Band& B, float* st) {
  using K = Cfg<MID>;
  int wm, wn, g8, t4;
  frag_coords<MID>(wm, wn, g8, t4);
  const float m = (float)(G.g * G.h * G.w);
  float s[K::NTW][2][1];
#pragma unroll
  for (int pass = 0; pass < 2; ++pass) {
#pragma unroll
    for (int n = 0; n < K::NTW; ++n)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const float mu = pass ? S.mu(k)[(wn * K::NTW + n) * 8 + 2 * t4 + e]
                              : 0.f;
        float a = 0.f;
#pragma unroll
        for (int mt = 0; mt < K::MTW; ++mt)
#pragma unroll
          for (int r = 0; r < 2; ++r) {
            const int p = 16 * (wm + K::WM * mt) + g8 + 8 * r;
            if (p < B.live) {
              const float u = acc[mt][n][2 * r + e];
              if (pass) {
                const float d = u - mu;
                a += d * d;
              } else {
                a += u;
              }
            }
          }
        s[n][e][0] = a;
      }
    group_sums<MID, 1>(s, S, G, B, nullptr);
    for (int c = threadIdx.x; c < MID; c += kThreads) {
      if (!pass) {
        S.mu(k)[c] = S.tot[c] / m;
      } else {
        const float var = S.tot[c] / m;
        const float sinv = rsqrtf(var + kEps);
        S.sinv(k)[c] = sinv;
        S.sc(k)[c] = __fmul_rn(sinv, S.gamma(k)[c]);
        if (B.rank == 0) {
          st[c] = S.mu(k)[c];
          st[MID + c] = sinv;
          st[2 * MID + c] = var;
        }
      }
    }
    __syncthreads();
  }
}

// BN k's saved statistics (st: 3 x MID of the group) -> mu, sinv, sc
template <int MID>
__device__ __forceinline__ void bn_saved(Smem<MID>& S, int k,
                                         const float* st) {
  for (int c = threadIdx.x; c < MID; c += kThreads) {
    const float sinv = st[MID + c];
    S.mu(k)[c] = st[c];
    S.sinv(k)[c] = sinv;
    S.sc(k)[c] = __fmul_rn(sinv, S.gamma(k)[c]);
  }
}

// y = bf16(ReLU(BN1(u1))) into Y at the band's pixels (0 where dead)
template <int MID>
__device__ __forceinline__ void put_y(const Acc<MID>& acc, Smem<MID>& S,
                                      const Geo& G, const Band& B) {
  using K = Cfg<MID>;
  int wm, wn, g8, t4;
  frag_coords<MID>(wm, wn, g8, t4);
#pragma unroll
  for (int mt = 0; mt < K::MTW; ++mt)
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int p = 16 * (wm + K::WM * mt) + g8 + 8 * r;
      if (p >= B.P) continue;
      bf16* dst = S.y + ypix(G, p) * K::PSY;
#pragma unroll
      for (int n = 0; n < K::NTW; ++n) {
        const int o = (wn * K::NTW + n) * 8 + 2 * t4;
        float y0 = 0.f, y1 = 0.f;
        if (p < B.live) {
          y0 = fmaxf(bn_apply(acc[mt][n][2 * r], S.mu(0)[o], S.sc(0)[o],
                              S.beta(0)[o]), 0.f);
          y1 = fmaxf(bn_apply(acc[mt][n][2 * r + 1], S.mu(0)[o + 1],
                              S.sc(0)[o + 1], S.beta(0)[o + 1]), 0.f);
        }
        *reinterpret_cast<__nv_bfloat162*>(dst + o) =
            __floats2bfloat162_rn(y0, y1);
      }
    }
}

// v = bf16(BN2(u2)) into V (0 at dead and pad pixels)
template <int MID>
__device__ __forceinline__ void put_v(const Acc<MID>& acc, Smem<MID>& S,
                                      const Band& B) {
  using K = Cfg<MID>;
  int wm, wn, g8, t4;
  frag_coords<MID>(wm, wn, g8, t4);
#pragma unroll
  for (int mt = 0; mt < K::MTW; ++mt)
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int p = 16 * (wm + K::WM * mt) + g8 + 8 * r;
      if (p >= B.p16) continue;
#pragma unroll
      for (int n = 0; n < K::NTW; ++n) {
        const int o = (wn * K::NTW + n) * 8 + 2 * t4;
        float v0 = 0.f, v1 = 0.f;
        if (p < B.live) {
          v0 = bn_apply(acc[mt][n][2 * r], S.mu(1)[o], S.sc(1)[o],
                        S.beta(1)[o]);
          v1 = bn_apply(acc[mt][n][2 * r + 1], S.mu(1)[o + 1], S.sc(1)[o + 1],
                        S.beta(1)[o + 1]);
        }
        *reinterpret_cast<__nv_bfloat162*>(S.v + p * K::PSY + o) =
            __floats2bfloat162_rn(v0, v1);
      }
    }
}

// The band's live pixels an item of 8 channels each, body(p, two, gs):
// pixels p and p + 1 where `two` (every pair in one image's run of
// pixels at an even plane offset: 4-byte global accesses), else p alone;
// gs < NG the group of 8 channels.
template <int NG, typename Body>
__device__ __forceinline__ void band_items(const Geo& G, const Band& B,
                                           Body body) {
  const bool pr = ((G.rows * G.w) & 1) == 0 && ((G.h * G.w) & 1) == 0;
  const int np = pr ? (B.live + 1) >> 1 : B.live;
  for (int it = threadIdx.x; it < np * NG; it += kThreads) {
    const int gs = it / np, p = (it - gs * np) << (pr ? 1 : 0);
    body(p, pr && p + 1 < B.live, gs);
  }
}

// 8 channels of pixel p (and p + 1 where two) of a (C', h, w) map from
// src (channel q at src + q * cstride), into e0 (and e1)
__device__ __forceinline__ void load8(const bf16* src, size_t cstride,
                                      bool two, bf16 (&e0)[8],
                                      bf16 (&e1)[8]) {
#pragma unroll
  for (int q = 0; q < 8; ++q) {
    if (two) {
      const __nv_bfloat162 v =
          *reinterpret_cast<const __nv_bfloat162*>(src + q * cstride);
      e0[q] = v.x;
      e1[q] = v.y;
    } else {
      e0[q] = src[q * cstride];
    }
  }
}

// The band's live pixels of x (B, C, h, w) -> X, slot = logical channel
template <int MID>
__device__ __forceinline__ void stage_x(Smem<MID>& S, const bf16* x,
                                        const Geo& G, const Band& B) {
  using K = Cfg<MID>;
  const size_t plane = (size_t)G.h * G.w;
  band_items<K::C / 8>(G, B, [&](int p, bool two, int gs) {
    alignas(16) bf16 e0[8];
    alignas(16) bf16 e1[8];
    load8(x + ((size_t)img_of(G, B, p) * K::C + 8 * gs) * plane +
              off_of(G, B, p),
          plane, two, e0, e1);
    *reinterpret_cast<uint4*>(S.x + p * K::PSX + 8 * gs) =
        *reinterpret_cast<const uint4*>(e0);
    if (two)
      *reinterpret_cast<uint4*>(S.x + (p + 1) * K::PSX + 8 * gs) =
          *reinterpret_cast<const uint4*>(e1);
  });
}

// X's slots -> dst (B, C, h, w) at the band's live pixels, logical
// channel inv[slot]
template <int MID>
__device__ __forceinline__ void store_x(Smem<MID>& S, bf16* dst,
                                        const short* inv, const Geo& G,
                                        const Band& B) {
  using K = Cfg<MID>;
  const size_t plane = (size_t)G.h * G.w;
  band_items<K::C / 8>(G, B, [&](int p, bool two, int gs) {
    alignas(16) bf16 e0[8];
    alignas(16) bf16 e1[8];
    *reinterpret_cast<uint4*>(e0) =
        *reinterpret_cast<const uint4*>(S.x + p * K::PSX + 8 * gs);
    if (two)
      *reinterpret_cast<uint4*>(e1) =
          *reinterpret_cast<const uint4*>(S.x + (p + 1) * K::PSX + 8 * gs);
    bf16* d = dst + (size_t)img_of(G, B, p) * K::C * plane + off_of(G, B, p);
#pragma unroll
    for (int k = 0; k < 8; ++k) {
      bf16* q = d + inv[8 * gs + k] * plane;
      if (two)
        *reinterpret_cast<__nv_bfloat162*>(q) = __halves2bfloat162(e0[k], e1[k]);
      else
        *q = e0[k];
    }
  });
}

// ------------------------------------------------------------ forward

// One launch a stage call: grid (n, groups), clusters of n.
template <int MID>
__global__ void __launch_bounds__(kThreads, 1)
span16_train_fwd_kernel(const bf16* __restrict__ x,
                        const float* __restrict__ blocks,
                        bf16* __restrict__ out, bf16* __restrict__ xsave,
                        float* __restrict__ stats, Geo G) {
  using K = Cfg<MID>;
  constexpr int C = K::C;
  Smem<MID> S(G.rows, G.w, G.ipc, G.n, 0);
  const Band B = make_band(G);
  const int tid = threadIdx.x;
  const size_t act = (size_t)G.b * C * G.h * G.w;
  const int ngroups = G.b / G.g;
  int wm, wn, g8, t4;
  frag_coords<MID>(wm, wn, g8, t4);

  zero_bytes(S.base + S.L.zero, 16);
  zero_bytes(S.base + S.L.y, up16(G.ipc * (G.rows + 2) * (G.w + 2) *
                                   K::PSY * 2));
  if (tid < C) S.lm[tid] = (short)tid;
  stage_x<MID>(S, x, G, B);
  init_sums(S.base, S.L, G.n);

  short* inv = S.lm + 2 * C;
  Acc<MID> acc;
  for (int k = 0; k < G.nblk; ++k) {
    const short* cur = S.lm + (k & 1) * C;
    short* nxt = S.lm + ((k + 1) & 1) * C;
    load_weights<MID, true>(S, blocks + (size_t)k * K::LEN);
    if (tid < C) inv[cur[tid]] = (short)tid;
    __syncthreads();
    // the block input, written once; x's odd channels in logical order
    store_x<MID>(S, xsave + k * act, inv, G, B);
    for (int it = tid; it < B.p16 * (MID / 8); it += kThreads) {
      const int gs = it / B.p16, p = it - gs * B.p16;
      alignas(16) bf16 e[8];
#pragma unroll
      for (int q = 0; q < 8; ++q)
        e[q] = p < B.live ? S.x[p * K::PSX + cur[2 * (8 * gs + q) + 1]]
                          : __float2bfloat16_rn(0.f);
      *reinterpret_cast<uint4*>(S.xo + p * K::PSY + 8 * gs) =
          *reinterpret_cast<const uint4*>(e);
    }
    __syncthreads();
    float* st = stats + (size_t)k * 3 * ngroups * 3 * MID;
    // 1. u1 = pw1, BN1, y -> Y, the halo rows
    pw_seq<MID>(acc, S.xo, S.w1f, B.p16);
    bn_stats<MID>(acc, S, 0, G, B, st + (size_t)B.gi * 3 * MID);
    put_y<MID>(acc, S, G, B);
    halo_rows<MID>(S.y, G, B, smem_u32(S.base + S.L.bar + 16), k & 1);
    __syncthreads();
    // 2. u2 = dw(y), BN2, v -> V
    dw_px<MID, false>(acc, S.y, S.wd, G, B);
    bn_stats<MID>(acc, S, 1, G, B,
                  st + ((size_t)ngroups + B.gi) * 3 * MID);
    put_v<MID>(acc, S, B);
    __syncthreads();
    // 3. u3 = pw2(v), BN3, z -> the slots of x's odd channels
    pw_seq<MID>(acc, S.v, S.w2f, B.p16);
    bn_stats<MID>(acc, S, 2, G, B,
                  st + ((size_t)2 * ngroups + B.gi) * 3 * MID);
#pragma unroll
    for (int mt = 0; mt < K::MTW; ++mt)
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const int p = 16 * (wm + K::WM * mt) + g8 + 8 * r;
        if (p >= B.live) continue;
        bf16* px = S.x + p * K::PSX;
#pragma unroll
        for (int n = 0; n < K::NTW; ++n) {
          const int o = (wn * K::NTW + n) * 8 + 2 * t4;
          px[cur[2 * o + 1]] = __float2bfloat16_rn(fmaxf(
              bn_apply(acc[mt][n][2 * r], S.mu(2)[o], S.sc(2)[o],
                       S.beta(2)[o]), 0.f));
          px[cur[2 * o + 3]] = __float2bfloat16_rn(fmaxf(
              bn_apply(acc[mt][n][2 * r + 1], S.mu(2)[o + 1], S.sc(2)[o + 1],
                       S.beta(2)[o + 1]), 0.f));
        }
      }
    if (tid < C)
      nxt[tid] = tid < MID ? cur[2 * tid] : cur[2 * (tid - MID) + 1];
    __syncthreads();
  }
  if (tid < C) inv[S.lm[(G.nblk & 1) * C + tid]] = (short)tid;
  __syncthreads();
  store_x<MID>(S, out, inv, G, B);
  if (G.n > 1) cluster_sync_all();   // no peer reads this CTA any more
}

// ------------------------------------------------------------ backward

// Weight-gradient partial of the band: dst[i*MID + o] = sum over its
// pixels of A[p][i] * (hi[p][o] + lo[p][o]), A, hi, lo pad16(P) x MID bf16
// (0 at dead and pad pixels); a warp per (16 i x 8 o) tile, the pixels in
// k-steps of 16, A transposed by ldmatrix.trans.
template <int MID>
__device__ __forceinline__ void dw_gemm(uint32_t a_s, uint32_t hi_s,
                                        uint32_t lo_s, uint32_t zero, int p16,
                                        float* dst) {
  using K = Cfg<MID>;
  constexpr int MTD = (MID + 15) / 16, NTD = MID / 8;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g8 = lane >> 2, t4 = lane & 3;
  const int aj = lane >> 3, ar = lane & 7;
  const int bj = (lane >> 3) & 1;
  for (int tile = warp; tile < MTD * NTD; tile += kWarps) {
    const int mi = tile / NTD, ni = tile - mi * NTD;
    float acc[4] = {0.f, 0.f, 0.f, 0.f};
    const int ci = 16 * mi + 8 * (aj & 1);   // A's channels of this lane
    for (int p0 = 0; p0 < p16; p0 += 16) {
      uint32_t a[4], bh[2], bl[2];
      const int pa = p0 + 8 * (aj >> 1) + ar;
      ldsm_x4_t(a, ci < MID ? a_s + (pa * K::PSY + ci) * 2 : zero);
      const int pb = p0 + 8 * bj + ar;
      ldsm_x2_t(bh, hi_s + (pb * K::PSY + 8 * ni) * 2);
      ldsm_x2_t(bl, lo_s + (pb * K::PSY + 8 * ni) * 2);
      mma16816(acc, a, bh[0], bh[1]);
      mma16816(acc, a, bl[0], bl[1]);
    }
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int i = 16 * mi + g8 + 8 * r;
      if (i < MID)
        *reinterpret_cast<float2*>(dst + i * MID + 8 * ni + 2 * t4) =
            make_float2(acc[2 * r], acc[2 * r + 1]);
    }
  }
}

// du = k*(g - a - xhat*b) of a BN backward, split into hi and lo bf16 terms
// into DH, DL (0 at dead and pad pixels)
template <int MID>
__device__ __forceinline__ void put_split(const Acc<MID>& du, Smem<MID>& S,
                                          const Band& B) {
  using K = Cfg<MID>;
  int wm, wn, g8, t4;
  frag_coords<MID>(wm, wn, g8, t4);
#pragma unroll
  for (int mt = 0; mt < K::MTW; ++mt)
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int p = 16 * (wm + K::WM * mt) + g8 + 8 * r;
      if (p >= B.p16) continue;
#pragma unroll
      for (int n = 0; n < K::NTW; ++n) {
        const int o = (wn * K::NTW + n) * 8 + 2 * t4;
        float d0 = 0.f, d1 = 0.f;
        if (p < B.live) {
          d0 = du[mt][n][2 * r];
          d1 = du[mt][n][2 * r + 1];
        }
        const __nv_bfloat162 hi = __floats2bfloat162_rn(d0, d1);
        const __nv_bfloat162 lo = __floats2bfloat162_rn(
            d0 - __low2float(hi), d1 - __high2float(hi));
        *reinterpret_cast<__nv_bfloat162*>(S.dh + p * K::PSY + o) = hi;
        *reinterpret_cast<__nv_bfloat162*>(S.dl + p * K::PSY + o) = lo;
      }
    }
}

// The witness build (fastdet_torch.kernels.fused_train.span16_witness_lib,
// for span16_witness.py) sets this to 1; the main build compiles the
// records below out, and its rec_du argument is unused.
#define SPAN16_RECORD_DU 0

// Where `out` is not null, a BN backward's f32 du of the live pixels into
// out (B, MID, h, w), logical channels: the values the kernel rounds to
// bf16 next (du3, du2) or splits (du1), for the numerical witness.
template <int MID>
__device__ void record_du(float* out, const Acc<MID>& du, const Geo& G,
                          const Band& B) {
  if (!SPAN16_RECORD_DU || !out) return;
  using K = Cfg<MID>;
  int wm, wn, g8, t4;
  frag_coords<MID>(wm, wn, g8, t4);
  const size_t plane = (size_t)G.h * G.w;
#pragma unroll
  for (int mt = 0; mt < K::MTW; ++mt)
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int p = 16 * (wm + K::WM * mt) + g8 + 8 * r;
      if (p >= B.live) continue;
      const size_t at =
          (size_t)img_of(G, B, p) * MID * plane + off_of(G, B, p);
#pragma unroll
      for (int n = 0; n < K::NTW; ++n)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int o = (wn * K::NTW + n) * 8 + 2 * t4 + e;
          out[at + o * plane] = du[mt][n][2 * r + e];
        }
    }
}

// A BN backward's cluster means from g (the masked gradient) and its
// input's fragments u: s = sum g, sum g*xhat over the live pixels, the
// CTA's sums to part (dgamma at part[0 .. MID), dbeta at part[MID ..)),
// the cluster's to a = sum g / m, b = sum g*xhat / m (tot); then g becomes
// du = gamma*sinv*(g - a - xhat*b).
template <int MID>
__device__ void bn_backward(Acc<MID>& gr, const Acc<MID>& u, Smem<MID>& S,
                            int k, const Geo& G, const Band& B,
                            float* part) {
  using K = Cfg<MID>;
  int wm, wn, g8, t4;
  frag_coords<MID>(wm, wn, g8, t4);
  const float m = (float)(G.g * G.h * G.w);
  float s[K::NTW][2][2];
#pragma unroll
  for (int n = 0; n < K::NTW; ++n)
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      const int o = (wn * K::NTW + n) * 8 + 2 * t4 + e;
      const float mu = S.mu(k)[o], si = S.sinv(k)[o];
      float a0 = 0.f, a1 = 0.f;
#pragma unroll
      for (int mt = 0; mt < K::MTW; ++mt)
#pragma unroll
        for (int r = 0; r < 2; ++r) {
          const int p = 16 * (wm + K::WM * mt) + g8 + 8 * r;
          if (p < B.live) {
            const float g = gr[mt][n][2 * r + e];
            a0 += g;
            a1 += g * ((u[mt][n][2 * r + e] - mu) * si);
          }
        }
      s[n][e][0] = a1;   // sum g*xhat: dgamma
      s[n][e][1] = a0;   // sum g: dbeta
    }
  group_sums<MID, 2>(s, S, G, B, part);
#pragma unroll
  for (int n = 0; n < K::NTW; ++n)
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      const int o = (wn * K::NTW + n) * 8 + 2 * t4 + e;
      const float mu = S.mu(k)[o], si = S.sinv(k)[o];
      const float kk = S.gamma(k)[o] * si;
      const float ga = S.tot[MID + o] / m, gb = S.tot[o] / m;
#pragma unroll
      for (int mt = 0; mt < K::MTW; ++mt)
#pragma unroll
        for (int r = 0; r < 2; ++r) {
          const float xh = (u[mt][n][2 * r + e] - mu) * si;
          const float g = gr[mt][n][2 * r + e];
          gr[mt][n][2 * r + e] = kk * (g - ga - xh * gb);
        }
    }
  __syncthreads();   // tot is read; the next merge may write it
}

// One launch a stage call, the blocks in reverse; the weight gradients as
// one partial row a CTA and block (part: nblk x ctas x LEN), added by
// reduce_rows_kernel.  gbuf: the f32 gradient, (B, C, h*w) by slot (a
// warp's lanes read and write consecutive pixels of a few slots).  rec:
// where not null, each block's recomputed z (nblk, B, MID, h, w).  rec_du:
// in the witness build, where not null, each block's du3, du2, du1 (nblk,
// 3, B, MID, h, w) f32.
template <int MID>
__global__ void __launch_bounds__(kThreads, 1)
span16_train_bwd_kernel(const bf16* __restrict__ dy,
                        const bf16* __restrict__ xsave,
                        const float* __restrict__ stats,
                        const float* __restrict__ blocks,
                        bf16* __restrict__ dx, float* __restrict__ gbuf,
                        float* __restrict__ part, bf16* __restrict__ rec,
                        float* __restrict__ rec_du, Geo G) {
  using K = Cfg<MID>;
  constexpr int C = K::C;
  Smem<MID> S(G.rows, G.w, G.ipc, G.n, 1);
  const Band B = make_band(G);
  const int tid = threadIdx.x;
  const size_t plane = (size_t)G.h * G.w;
  const size_t act = (size_t)G.b * C * plane;
  const int ngroups = G.b / G.g;
  const int cta = B.gi * G.n + B.rank, nctas = ngroups * G.n;
  const int halo_px = G.ipc * (G.rows + 2) * (G.w + 2);
  int wm, wn, g8, t4;
  frag_coords<MID>(wm, wn, g8, t4);
  short* cur = S.lm;

  zero_bytes(S.base + S.L.zero, 16);
  zero_bytes(S.base + S.L.y, up16(halo_px * K::PSY * 2));
  // the span's dy into gbuf, logical channel l in slot P_nblk(l)
  if (tid < C) {
    int s = tid;
    for (int i = 0; i < G.nblk; ++i) s = s < MID ? 2 * s : 2 * (s - MID) + 1;
    cur[tid] = (short)s;
  }
  init_sums(S.base, S.L, G.n);
  band_items<C / 8>(G, B, [&](int p, bool two, int gs) {
    const int img = img_of(G, B, p), off = off_of(G, B, p);
    bf16 e0[8], e1[8];
    load8(dy + ((size_t)img * C + 8 * gs) * plane + off, plane, two, e0, e1);
    float* dst = gbuf + (size_t)img * C * plane + off;
#pragma unroll
    for (int q = 0; q < 8; ++q) {
      float* d = dst + cur[8 * gs + q] * plane;
      if (two)
        *reinterpret_cast<float2*>(d) = make_float2(__bfloat162float(e0[q]),
                                                    __bfloat162float(e1[q]));
      else
        *d = __bfloat162float(e0[q]);
    }
  });
  __syncthreads();

  Acc<MID> acc, acc2;
  for (int k = G.nblk - 1; k >= 0; --k) {
    if (tid < C) {
      int s = tid;
      for (int i = 0; i < k; ++i) s = s < MID ? 2 * s : 2 * (s - MID) + 1;
      cur[tid] = (short)s;
    }
    load_weights<MID, false>(S, blocks + (size_t)k * K::LEN);
    __syncthreads();
    const float* st = stats + (size_t)k * 3 * ngroups * 3 * MID;
    for (int j = 0; j < 3; ++j)
      bn_saved<MID>(S, j, st + ((size_t)j * ngroups + B.gi) * 3 * MID);
    // x_k's odd channels from the saved input
    const bf16* xk = xsave + k * act;
    for (int it = tid; it < (B.p16 - B.live) * (MID / 8); it += kThreads) {
      const int gs = it / (B.p16 - B.live), p = B.live + it % (B.p16 - B.live);
      *reinterpret_cast<uint4*>(S.xo + p * K::PSY + 8 * gs) =
          make_uint4(0, 0, 0, 0);
    }
    band_items<MID / 8>(G, B, [&](int p, bool two, int gs) {
      alignas(16) bf16 e0[8];
      alignas(16) bf16 e1[8];
      load8(xk + ((size_t)img_of(G, B, p) * C + 16 * gs + 1) * plane +
                off_of(G, B, p),
            2 * plane, two, e0, e1);
      *reinterpret_cast<uint4*>(S.xo + p * K::PSY + 8 * gs) =
          *reinterpret_cast<const uint4*>(e0);
      if (two)
        *reinterpret_cast<uint4*>(S.xo + (p + 1) * K::PSY + 8 * gs) =
            *reinterpret_cast<const uint4*>(e1);
    });
    __syncthreads();
    float* prow = part + ((size_t)k * nctas + cta) * K::LEN;
    float* rdu = SPAN16_RECORD_DU && rec_du
                     ? rec_du + (size_t)k * 3 * G.b * MID * plane
                     : nullptr;

    // ---- the recompute: y, v, u3 as the forward computes them
    pw_seq<MID>(acc, S.xo, S.w1, B.p16);
    put_y<MID>(acc, S, G, B);
    const uint32_t nth = (uint32_t)(G.nblk - 1 - k) & 1;   // exchanges so far
    halo_rows<MID>(S.y, G, B, smem_u32(S.base + S.L.bar + 16), nth);
    __syncthreads();
    dw_px<MID, false>(acc, S.y, S.wd, G, B);
    put_v<MID>(acc, S, B);
    __syncthreads();
    pw_seq<MID>(acc, S.v, S.w2, B.p16);

    // ---- BN3: gz = dz where BN3(u3) > 0; du3 -> DH, DL
#pragma unroll
    for (int mt = 0; mt < K::MTW; ++mt)
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const int p = 16 * (wm + K::WM * mt) + g8 + 8 * r;
        const bool live = p < B.live;
        const int img = live ? img_of(G, B, p) : 0;
        const int off = live ? off_of(G, B, p) : 0;
        const float* gq = gbuf + (size_t)img * C * plane + off;
#pragma unroll
        for (int n = 0; n < K::NTW; ++n) {
          const int o = (wn * K::NTW + n) * 8 + 2 * t4;
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const float u = acc[mt][n][2 * r + e];
            float g = 0.f;
            if (live) {
              const float z = bn_apply(u, S.mu(2)[o + e], S.sc(2)[o + e],
                                       S.beta(2)[o + e]);
              // dz of output channel MID + o + e, rounded where that
              // channel is even (a passthrough of the block after)
              const float dz = gq[cur[2 * (o + e) + 1] * plane];
              if (z > 0.f) g = e == 0 ? r16(dz) : dz;
              if (rec)
                rec[(((size_t)k * G.b + img) * MID + o + e) * plane + off] =
                    __float2bfloat16_rn(fmaxf(z, 0.f));
            }
            acc2[mt][n][2 * r + e] = g;
          }
        }
      }
    bn_backward<MID>(acc2, acc, S, 2, G, B, prow + K::GB + 4 * MID);
    record_du<MID>(rdu, acc2, G, B);
    put_split<MID>(acc2, S, B);
    __syncthreads();
    dw_gemm<MID>(smem_u32(S.v), smem_u32(S.dh), smem_u32(S.dl), S.zero,
                 B.p16, prow + K::W2);

    // ---- dv = w2' bf16(du3); BN2 with u2 recomputed; du2 -> V as a
    //      haloed buffer
    gemm_t<MID>(acc2, smem_u32(S.dh), smem_u32(S.w2), S.zero, B.p16);
    dw_px<MID, false>(acc, S.y, S.wd, G, B);
    bn_backward<MID>(acc2, acc, S, 1, G, B, prow + K::GB + 2 * MID);
    record_du<MID>(rdu ? rdu + (size_t)G.b * MID * plane : nullptr, acc2, G,
                   B);
    // V's bytes are free (dW2 read them before the reduction): du2's
    // frame of zeros, but for the halo rows the neighbours push
    for (int q = tid; q < halo_px; q += kThreads) {
      const int per = (G.rows + 2) * (G.w + 2);
      const int rr = (q % per) / (G.w + 2), cc = q % (G.w + 2);
      const bool top = rr == 0, bottom = rr == G.rows + 1;
      if ((top && !B.above) || (bottom && !B.below) ||
          (!top && !bottom && (cc == 0 || cc == G.w + 1)))
        for (int c8 = 0; c8 < MID; c8 += 8)
          *reinterpret_cast<uint4*>(S.v + q * K::PSY + c8) =
              make_uint4(0, 0, 0, 0);
    }
#pragma unroll
    for (int mt = 0; mt < K::MTW; ++mt)
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const int p = 16 * (wm + K::WM * mt) + g8 + 8 * r;
        if (p >= B.P) continue;
        bf16* dst = S.v + ypix(G, p) * K::PSY;
#pragma unroll
        for (int n = 0; n < K::NTW; ++n) {
          const int o = (wn * K::NTW + n) * 8 + 2 * t4;
          const bool live = p < B.live;
          *reinterpret_cast<__nv_bfloat162*>(dst + o) = __floats2bfloat162_rn(
              live ? acc2[mt][n][2 * r] : 0.f,
              live ? acc2[mt][n][2 * r + 1] : 0.f);
        }
      }
    halo_rows<MID>(S.v, G, B, smem_u32(S.base + S.L.bar + 24), nth);
    __syncthreads();

    // ---- dwd: sum over the band of bf16(du2) * y at each tap; a warp per
    //      channel pair, its lanes over the pixels
    {
      const int warp = tid >> 5, lane = tid & 31, pitch = G.w + 2;
      for (int cp2 = warp; cp2 < MID / 2; cp2 += kWarps) {
        const int c = 2 * cp2;
        float tg[9][2];
#pragma unroll
        for (int t = 0; t < 9; ++t) tg[t][0] = tg[t][1] = 0.f;
        for (int p = lane; p < B.live; p += 32) {
          const int yp = ypix(G, p);
          const float2 d = __bfloat1622float2(
              *reinterpret_cast<const __nv_bfloat162*>(S.v + yp * K::PSY + c));
#pragma unroll
          for (int t = 0; t < 9; ++t) {
            const int at = yp + (t / 3 - 1) * pitch + (t % 3 - 1);
            const float2 yv = __bfloat1622float2(
                *reinterpret_cast<const __nv_bfloat162*>(S.y + at * K::PSY +
                                                         c));
            tg[t][0] = __fmaf_rn(d.x, yv.x, tg[t][0]);
            tg[t][1] = __fmaf_rn(d.y, yv.y, tg[t][1]);
          }
        }
#pragma unroll
        for (int t = 0; t < 9; ++t) {
          const float a = warp_sum(tg[t][0]), b = warp_sum(tg[t][1]);
          if (lane == 0) {
            prow[K::WD + t * MID + c] = a;
            prow[K::WD + t * MID + c + 1] = b;
          }
        }
      }
    }

    // ---- BN1: gy = the transposed dw of bf16(du2) where BN1(u1) > 0, u1
    //      recomputed; du1 -> DH, DL
    dw_px<MID, true>(acc2, S.v, S.wd, G, B);
    pw_seq<MID>(acc, S.xo, S.w1, B.p16);
#pragma unroll
    for (int mt = 0; mt < K::MTW; ++mt)
#pragma unroll
      for (int n = 0; n < K::NTW; ++n)
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          const int o = (wn * K::NTW + n) * 8 + 2 * t4 + (q & 1);
          if (!(bn_apply(acc[mt][n][q], S.mu(0)[o], S.sc(0)[o],
                         S.beta(0)[o]) > 0.f))
            acc2[mt][n][q] = 0.f;
        }
    bn_backward<MID>(acc2, acc, S, 0, G, B, prow + K::GB);
    record_du<MID>(rdu ? rdu + (size_t)2 * G.b * MID * plane : nullptr, acc2,
                   G, B);
    put_split<MID>(acc2, S, B);
    __syncthreads();
    dw_gemm<MID>(smem_u32(S.xo), smem_u32(S.dh), smem_u32(S.dl), S.zero,
                 B.p16, prow);

    // ---- dx's odd channels = w1' bf16(du1), into the slots of dz
    gemm_t<MID>(acc, smem_u32(S.dh), smem_u32(S.w1), S.zero, B.p16);
#pragma unroll
    for (int mt = 0; mt < K::MTW; ++mt)
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const int p = 16 * (wm + K::WM * mt) + g8 + 8 * r;
        if (p >= B.live) continue;
        float* gq = gbuf + (size_t)img_of(G, B, p) * C * plane +
                    off_of(G, B, p);
#pragma unroll
        for (int n = 0; n < K::NTW; ++n) {
          const int o = (wn * K::NTW + n) * 8 + 2 * t4;
          gq[cur[2 * o + 1] * plane] = acc[mt][n][2 * r];
          gq[cur[2 * o + 3] * plane] = acc[mt][n][2 * r + 1];
        }
      }
    __syncthreads();
  }
  // dx = bf16(gbuf), slot = logical channel at block 0
  band_items<C / 8>(G, B, [&](int p, bool two, int gs) {
    const int img = img_of(G, B, p), off = off_of(G, B, p);
    const size_t at = ((size_t)img * C + 8 * gs) * plane + off;
#pragma unroll
    for (int q = 0; q < 8; ++q) {
      const float* src = gbuf + at + q * plane;
      if (two) {
        const float2 v = *reinterpret_cast<const float2*>(src);
        *reinterpret_cast<__nv_bfloat162*>(dx + at + q * plane) =
            __floats2bfloat162_rn(v.x, v.y);
      } else {
        dx[at + q * plane] = __float2bfloat16_rn(src[0]);
      }
    }
  });
  if (G.n > 1) cluster_sync_all();   // no peer reads this CTA any more
}

// dblocks[i][j] = the sum of column j over the prows partial rows of block
// i: a CTA per (32 columns, block); warp k sums the rows r = k (mod 8) in
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

template <typename Kern>
cudaError_t prepare(Kern kernel, size_t smem, int n) {
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  if (n > 8)
    err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
  return err;
}

void cluster_config(cudaLaunchConfig_t& cfg, cudaLaunchAttribute* attr,
                    const Geo& G, size_t smem, cudaStream_t stream) {
  cfg = cudaLaunchConfig_t{};
  cfg.gridDim = dim3(G.n, G.b / G.g, 1);
  cfg.blockDim = dim3(kThreads, 1, 1);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = G.n;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
}

template <int MID>
int launch_fwd(const bf16* x, const float* blocks, bf16* out, bf16* xsave,
               float* stats, const Geo& G, cudaStream_t stream) {
  const size_t smem =
      (size_t)span16_train_layout(MID, G.rows, G.w, G.ipc, G.n, 0).bytes;
  cudaError_t err = prepare(span16_train_fwd_kernel<MID>, smem, G.n);
  if (err != cudaSuccess) return (int)err;
  cudaLaunchConfig_t cfg;
  cudaLaunchAttribute attr[1];
  cluster_config(cfg, attr, G, smem, stream);
  err = cudaLaunchKernelEx(&cfg, span16_train_fwd_kernel<MID>, x, blocks, out,
                           xsave, stats, G);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

template <int MID>
int launch_bwd(const bf16* dy, const bf16* xsave, const float* stats,
               const float* blocks, bf16* dx, float* dblocks, float* scratch,
               bf16* rec, float* rec_du, const Geo& G,
               cudaStream_t stream) {
  const size_t smem =
      (size_t)span16_train_layout(MID, G.rows, G.w, G.ipc, G.n, 1).bytes;
  cudaError_t err = prepare(span16_train_bwd_kernel<MID>, smem, G.n);
  if (err != cudaSuccess) return (int)err;
  cudaLaunchConfig_t cfg;
  cudaLaunchAttribute attr[1];
  cluster_config(cfg, attr, G, smem, stream);
  float* gbuf = scratch;
  float* part = scratch + (size_t)G.b * 2 * MID * G.h * G.w;
  err = cudaLaunchKernelEx(&cfg, span16_train_bwd_kernel<MID>, dy, xsave,
                           stats, blocks, dx, gbuf, part, rec, rec_du, G);
  if (err != cudaSuccess) return (int)err;
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const int len = Cfg<MID>::LEN, nctas = G.b / G.g * G.n;
  reduce_rows_kernel<<<dim3((len + 31) / 32, G.nblk), kThreads, 0, stream>>>(
      part, dblocks, nctas, len);
  return (int)cudaGetLastError();
}

template <int MID>
int max_clusters(const Geo& G, int bwd) {
  const size_t smem =
      (size_t)span16_train_layout(MID, G.rows, G.w, G.ipc, G.n, bwd).bytes;
  cudaLaunchConfig_t cfg;
  cudaLaunchAttribute attr[1];
  cluster_config(cfg, attr, G, smem, 0);
  int num = 0;
  cudaError_t err;
  if (bwd) {
    err = prepare(span16_train_bwd_kernel<MID>, smem, G.n);
    if (err == cudaSuccess)
      err = cudaOccupancyMaxActiveClusters(
          &num, (void*)span16_train_bwd_kernel<MID>, &cfg);
  } else {
    err = prepare(span16_train_fwd_kernel<MID>, smem, G.n);
    if (err == cudaSuccess)
      err = cudaOccupancyMaxActiveClusters(
          &num, (void*)span16_train_fwd_kernel<MID>, &cfg);
  }
  return err == cudaSuccess ? num : -(int)err;
}

Geo make_geo(int b, int h, int w, int nblk, int g, int n, int bpi, int ipc,
             int rows) {
  Geo G;
  G.b = b; G.h = h; G.w = w; G.nblk = nblk; G.g = g;
  G.n = n; G.bpi = bpi; G.ipc = ipc; G.rows = rows;
  return G;
}

}  // namespace

extern "C" {

// Bytes of shared memory of a CTA of the forward (bwd 0) or the backward
// (1) at MID channels a branch, ipc slices of `rows` rows of width w, in a
// cluster of n.
size_t fastdet_span16_train_smem(int mid, int rows, int w, int ipc, int n,
                                 int bwd) {
  if (mid != 24 && mid != 48 && mid != 96) return 0;
  return (size_t)span16_train_layout(mid, rows, w, ipc, n, bwd).bytes;
}

// Floats of scratch of the backward: the f32 gradient (B, h*w, C) and the
// partial rows (nblk, B/g*n, LEN); 0 if the geometry is invalid.
size_t fastdet_span16_train_scratch(int b, int c, int h, int w, int nblk,
                                    int g, int n, int bpi, int ipc,
                                    int rows) {
  const Geo G = make_geo(b, h, w, nblk, g, n, bpi, ipc, rows);
  if (!geo_valid(G, c)) return 0;
  const int mid = c / 2;
  return (size_t)b * c * h * w +
         (size_t)nblk * (b / g) * n * (2 * mid * mid + 15 * mid);
}

// Clusters of the plan that the card can hold at once
// (cudaOccupancyMaxActiveClusters), or minus a CUDA error.
int fastdet_span16_train_clusters(int b, int c, int h, int w, int nblk, int g,
                                  int n, int bpi, int ipc, int rows,
                                  int bwd) {
  const Geo G = make_geo(b, h, w, nblk, g, n, bpi, ipc, rows);
  if (!geo_valid(G, c)) return -(int)cudaErrorInvalidValue;
  switch (c) {
    case 48: return max_clusters<24>(G, bwd);
    case 96: return max_clusters<48>(G, bwd);
    default: return max_clusters<96>(G, bwd);
  }
}

// x (B, C, h, w) bf16 -> out (B, C, h, w) bf16, xsave (nblk, B, C, h, w)
// bf16, stats (nblk, 3, B/g, 3, C/2) f32; blocks (nblk, 2*MID^2 + 15*MID)
// f32; the plan's cluster n, bands a image bpi, images a CTA ipc and band
// rows.  Returns a cudaError_t (0 = launched).
int fastdet_span16_train_fwd(const bf16* x, const float* blocks, bf16* out,
                             bf16* xsave, float* stats, int b, int c, int h,
                             int w, int nblk, int g, int n, int bpi, int ipc,
                             int rows, void* stream) {
  const Geo G = make_geo(b, h, w, nblk, g, n, bpi, ipc, rows);
  if (!geo_valid(G, c)) return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  switch (c) {
    case 48: return launch_fwd<24>(x, blocks, out, xsave, stats, G, s);
    case 96: return launch_fwd<48>(x, blocks, out, xsave, stats, G, s);
    default: return launch_fwd<96>(x, blocks, out, xsave, stats, G, s);
  }
}

// dy (B, C, h, w) bf16, xsave, stats and blocks as the forward's -> dx (B,
// C, h, w) bf16, dblocks (nblk, row) f32; scratch as
// fastdet_span16_train_scratch; rec null, or (nblk, B, C/2, h, w) bf16 for
// each block's recomputed z; rec_du null, or in the witness build (nblk,
// 3, B, C/2, h, w) f32 for each block's du3, du2 and du1.
int fastdet_span16_train_bwd(const bf16* dy, const bf16* xsave,
                             const float* stats, const float* blocks, bf16* dx,
                             float* dblocks, float* scratch, bf16* rec,
                             float* rec_du, int b, int c, int h, int w,
                             int nblk, int g, int n, int bpi, int ipc,
                             int rows, void* stream) {
  const Geo G = make_geo(b, h, w, nblk, g, n, bpi, ipc, rows);
  if (!geo_valid(G, c)) return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  switch (c) {
    case 48:
      return launch_bwd<24>(dy, xsave, stats, blocks, dx, dblocks, scratch,
                            rec, rec_du, G, s);
    case 96:
      return launch_bwd<48>(dy, xsave, stats, blocks, dx, dblocks, scratch,
                            rec, rec_du, G, s);
    default:
      return launch_bwd<96>(dy, xsave, stats, blocks, dx, dblocks, scratch,
                            rec, rec_du, G, s);
  }
}

const char* fastdet_cuda_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
