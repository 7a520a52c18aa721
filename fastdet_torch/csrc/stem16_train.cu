// The bf16 training stem B7: conv3x3 stride 2 (3 -> 24, no bias) + ghost
// BatchNorm + ReLU + bf16 rounding + maxpool 3x3 stride 2, forward and
// backward, from the s2d(4) uint8 layout, by hand for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernels of fastdet/kernels/stem_train.py at
// dtype=bfloat16 (make_stem_train: _fwd_call1 -> _stem_train_fwd1_kernel,
// _bwd_call1 -> _stem_train_bwd1_kernel for ghost group 1, _fwd_call ->
// _stem_train_fwd_kernel, _bwd_call -> _stem_train_bwd_kernel for larger
// groups).  One design serves all four: the group g is an argument.  The
// f32 form keeps its own design (csrc/stem_train.cu).
//
// Same function as the plain bf16 version (stem_train_forward_reference /
// stem_train_backward_reference with bf16=True in kernels/stem_train.py).
// x (B, 48, npad) uint8 in the host's s2d(4) layout: channel yoff*12 +
// xoff*3 + c, lane i*w4 + j for pixel (4i+yoff, 4j+xoff, c); pad lanes are
// never read.  w (24, 3, 3, 3) f32 OIHW, already scaled by 1/255; the conv
// takes bf16(w) times the integer pixels.
//   u   = conv3x3 s2 pad 1: conv output (2u+py, 2v+px) is phase (py, px) of
//         s2d cell (u, v); 27 taps in the order (ky, kx, c), acc += x*w
//         from 0;
//   BN  over the ghost group (g images, m = g*4*h4*w4 samples a channel):
//       mu, var, sinv = 1/sqrt(var + 1e-5); bn = (u - mu)*(sinv*gamma) +
//       beta; yb = bf16(max(bn, 0));
//   y   = maxpool3x3 s2 pad 1 (-inf) of yb, bf16 (B, 24, h4, w4);
//   stats (B/g, 24, [mu, sinv, var]).
// Backward: dy bf16 -> dW (24, 3, 3, 3) with respect to the scaled weight,
// dgamma, dbeta (24) summed over the groups.  dy goes to the pool window's
// winner by the JAX kernel's first-term-wins precedence among the ROUNDED
// yb (column 2j, then 2j+1, then 2j-1; within it row 2i, then 2i+1, then
// 2i-1), masked where bn <= 0; du = (gamma*sinv)*((gy - Sg/m) - xhat*
// (Sgx/m)) with Sg, Sgx the group sums of gy and gy*xhat, rounded to bf16
// before the dW product.
//
// Exactness.  bf16(w) has 8 significant bits and a pixel is an integer
// below 256, at most 8 bits, so every product x*bf16(w) has at most 16
// significant bits and is exact in f32 (24).  With an exact product,
// __fmaf_rn(x, w, acc) == __fadd_rn(__fmul_rn(x, w), acc) bit for bit, so
// the conv issues one FMA a tap and u is the plain version's _conv bit for
// bit.  The source is built with --fmad=false all the same: BN's (u - mu)*
// (sinv*gamma) + beta keeps its two roundings (and is written with
// __f*_rn), as the plain version computes it.
//
// Launches (stem16_train_plan in kernels/stem_train.py states them).  A
// tile is a band of tr cell rows and 31*ncw cell columns of one image;
// a CTA of 128*ncw threads: warp = (column warp cw, channel group of 6),
// lane = a cell column (lane 0 the column left of the warp's 31, which
// only the forward's pool reads).
//   forward:  gram  (the moments without a conv: the integer Gram matrix
//                    of the 27-pixel patches and a ones column, 28 x 28,
//                    per tile on u8 tensor cores, mma.sync m16n8k32 with
//                    s32 sums, exact)
//             stats (per group: the tiles' Gram summed in int64, then in
//                    f64 mu = bf16(w).s/m, var = bf16(w)^T C bf16(w) with C
//                    the patch covariance; -> f32 stats)
//             emit  (the conv by FMA, BN, ReLU, bf16 rounding, the pool's
//                    winner by the JAX precedence among the rounded values
//                    -> y, and for the backward the winner's code (0..8:
//                    3*column + row in the precedence order) and its raw
//                    conv output zw)
//   backward: sums  (Sg, Sgx per (image, channel) from dy and zw: the
//                    routed sums, exact up to their order, also where
//                    gamma = 0 or bf16 ties let another member win)
//             sweep (owner computes: a tile recomputes its own cells' conv
//                    by FMA, no halo; each output's gy from the codes and
//                    dy of the (up to 4) windows over it, in the plain
//                    version's order; du whole, rounded to bf16; dW on bf16
//                    tensor cores, mma.sync m16n8k16: 27 taps padded to 32
//                    x 24 channels, K over the tile's conv outputs; per-warp
//                    f32 sums, reduced in a fixed order)
//             reduce (dW over the tiles, dgamma and dbeta over the planes,
//                    fixed order)
// No atomics: two runs give the same bits.  Neither approximation of the
// first bf16 design remains: du is rounded whole (owner computes) and Sgx
// takes the routed winner's xhat (zw).
// The input is staged in shared memory by cp.async, a warp a plane: in the
// emit and the sweep a ring of four u8 cell rows (the next rows land while
// a row is computed; the sweep's slots also hold a window row's codes and
// dy), which each thread turns, for the words it copied itself, into a ring
// of three f32 rows (emit) or bf16 rows (sweep: half the shared memory, and
// the MMA's pixel operand as ready pairs), so that a tap is one shared load
// and six FMAs for a thread's 6 channels (their weights one broadcast
// float4 and float2 read for the 4 phases); the gram kernel requests its
// whole band at once.
//
// What bounds it: operations.  One conv sweep at b128 352^2 is 2.57 G FMAs,
// 0.077 ms at the FP32 FMA rate; the forward sweeps once (emit), the
// backward once (sweep); the moments and dW run on tensor cores.  The
// bytes the kernels move at b128 352^2: forward 48 MB of x twice, y 47.6
// MB, code 23.8 MB, zw 95 MB (262 MB; the first design 286 MB); backward
// dy and zw (119 MB), x, codes and dy again (96 MB): 215 MB (~240 MB).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kCout = 24;
constexpr int kTaps = 27;
constexpr int kNW = kTaps * kCout;   // 648 weights
constexpr float kEps = 1e-5f;
constexpr unsigned kFull = 0xffffffffu;

constexpr int kCH = 6;               // channels a thread convolves
constexpr int kGroups = kCout / kCH; // 4
constexpr int kWarpCols = 31;        // cell columns a warp owns
constexpr int kMaxNcw = 3;           // column warps of a tile
constexpr int kMaxThreads = 32 * kMaxNcw * kGroups;   // 384
constexpr int kRS = 100;             // staged columns: c0-4 .. c0+95
constexpr int kXRow = 48 * kRS;      // one staged cell row: 48 planes
// a backward ring slot: the input row, then the window row's codes (24 x
// kRS bytes) and dy (24 x kRS bf16)
constexpr int kBSlot = kXRow + 24 * kRS + 24 * kRS * 2;
constexpr int kMaxRows = 11;       // cell rows of a tile
constexpr int kGramRows = kMaxRows + 1;  // staged rows of the gram's band
constexpr int kGRow = 50 * kRS;    // a gram row: 48 planes, ones, zeros
constexpr int kG = 28;               // Gram entries: 27 taps and the ones
constexpr int kGEntries = kG * kG;   // 784 per tile

typedef __nv_bfloat16 bf16;

__device__ __forceinline__ float neg_inf() {
  return __int_as_float(0xff800000);
}
__device__ __forceinline__ float rnd16(float v) {
  return __bfloat162float(__float2bfloat16_rn(v));
}
// {lo, hi} as a bf16 pair (lo in the low half), each rounded to nearest
// even (one F2FP for two values)
__device__ __forceinline__ uint32_t pack16(float lo, float hi) {
  uint32_t r;
  asm("cvt.rn.bf16x2.f32 %0, %1, %2;\n" : "=r"(r) : "f"(hi), "f"(lo));
  return r;
}
// a and b rounded to bf16, back in f32
__device__ __forceinline__ void rnd16x2(float& a, float& b) {
  const uint32_t p = pack16(a, b);
  a = __uint_as_float(p << 16);
  b = __uint_as_float(p & 0xffff0000u);
}

// lane 0 gets the warp's sum (a fixed tree)
__device__ __forceinline__ float warp_sum(float v) {
  for (int o = 16; o > 0; o >>= 1) v = v + __shfl_down_sync(kFull, v, o);
  return v;
}

__device__ __forceinline__ void cp_async4(void* dst, const void* src,
                                          bool valid) {
  const unsigned d = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(d),
               "l"(src), "r"(valid ? 4 : 0));
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

struct Geo {
  int h4, w4, npad, g, tr, ncw, nchunk, nband, words;
};

// The tile of this CTA: band rows [i0, i0 + rows), columns from c0
struct Tile {
  int b, i0, rows, c0;
};

__device__ __forceinline__ Tile tile_of(const Geo& G) {
  const int band = blockIdx.x / G.nchunk;
  const int chunk = blockIdx.x - band * G.nchunk;
  Tile t;
  t.b = blockIdx.y;
  t.i0 = band * G.tr;
  t.rows = min(G.tr, G.h4 - t.i0);
  t.c0 = chunk * G.ncw * kWarpCols;
  return t;
}

// OIHW (24, 3, 3, 3) -> s_w[((ky*3 + kx)*3 + c)*24 + co] = bf16(w)
__device__ __forceinline__ void load_weights(const float* __restrict__ w,
                                             float* s_w) {
  for (int t = threadIdx.x; t < kNW; t += blockDim.x) {
    const int co = t / kTaps, r = t - co * kTaps;   // r = c*9 + ky*3 + kx
    const int c = r / 9, kk = r - c * 9;
    s_w[(kk * 3 + c) * kCout + co] = rnd16(w[t]);
  }
}

// Staged row: cell row xi of the image, planes of kRS bytes, columns c0-4
// .. c0+95; 0 outside the image.  A warp copies whole planes (warp, warp +
// nwarps, ...), lane q the plane's word q < 25 (columns c0-4+4q ..);
// words mode: 4-byte cp.async (src-size 0 outside), else bytes by plain
// loads.  The same thread turns the same words into f32 or bf16
// (convert_own).
__device__ __forceinline__ void stage_x(uint8_t* slot,
                                        const uint8_t* __restrict__ xb,
                                        int xi, int c0, const Geo& G) {
  const int lane = threadIdx.x & 31;
  if (lane >= kRS / 4) return;
  const int j = c0 - 4 + 4 * lane;
  const bool row_in = xi >= 0 && xi < G.h4;
  const uint8_t* src = xb + (size_t)xi * G.w4 + j;
  uint8_t* dst = slot + 4 * lane;
  const bool ok = row_in && j >= 0 && j < G.w4;
  for (int plane = threadIdx.x >> 5; plane < 48;
       plane += (int)(blockDim.x >> 5)) {
    if (G.words) {
      cp_async4(dst + plane * kRS, ok ? src + (size_t)plane * G.npad : xb,
                ok);
    } else {
#pragma unroll
      for (int e = 0; e < 4; ++e)
        dst[plane * kRS + e] =
            (row_in && j + e >= 0 && j + e < G.w4)
                ? src[(size_t)plane * G.npad + e] : (uint8_t)0;
    }
  }
}

// a u8 byte b as f32: (2^23 + b) - 2^23, exact and on the FP32 and
// integer pipes (no I2F)
__device__ __forceinline__ float u8f(unsigned b) {
  return __fsub_rn(__int_as_float(0x4B000000 | b), 8388608.f);
}
// a staged pixel as f32, from an f32 or a bf16 ring
__device__ __forceinline__ float pix(const float* p) { return *p; }
__device__ __forceinline__ float pix(const bf16* p) {
  return __uint_as_float((uint32_t)__bfloat16_as_ushort(*p) << 16);
}

// Window row wi's codes and dy (the backward's) into a ring slot after its
// input row, columns c0-4 .. c0+95 as stage_x's; 0 outside the image (a
// code 0 with dy 0 routes nothing)
__device__ __forceinline__ void stage_windows(uint8_t* slot,
                                              const uint8_t* __restrict__ cb,
                                              const bf16* __restrict__ db,
                                              int wi, int c0, const Geo& G) {
  const int lane = threadIdx.x & 31;
  if (lane >= kRS / 4) return;
  uint8_t* sc = slot + kXRow;
  bf16* sd = reinterpret_cast<bf16*>(slot + kXRow + kCout * kRS);
  const bool row_in = wi >= 0 && wi < G.h4;
  const size_t hw = (size_t)G.h4 * G.w4;
  // lane q: the codes of columns c0-4+4q .., the dy of c0-4+2q .. and of
  // c0+46+2q ..
  const int jc = c0 - 4 + 4 * lane;
  const int jd[2] = {c0 - 4 + 2 * lane, c0 + 46 + 2 * lane};
  const size_t at = (size_t)wi * G.w4;
  for (int o = threadIdx.x >> 5; o < kCout; o += (int)(blockDim.x >> 5)) {
    const uint8_t* csrc = cb + o * hw + at;
    const bf16* dsrc = db + o * hw + at;
    if (G.words) {
      bool ok = row_in && jc >= 0 && jc < G.w4;
      cp_async4(sc + o * kRS + 4 * lane, ok ? csrc + jc : cb, ok);
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        ok = row_in && jd[h] >= 0 && jd[h] < G.w4;
        cp_async4(sd + o * kRS + 2 * lane + 50 * h, ok ? dsrc + jd[h] : db,
                  ok);
      }
    } else {
#pragma unroll
      for (int e = 0; e < 4; ++e)
        sc[o * kRS + 4 * lane + e] =
            (row_in && jc + e >= 0 && jc + e < G.w4) ? csrc[jc + e]
                                                      : (uint8_t)0;
#pragma unroll
      for (int h = 0; h < 2; ++h)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int jj = jd[h] + e;
          sd[o * kRS + 2 * lane + 50 * h + e] =
              (row_in && jj >= 0 && jj < G.w4) ? dsrc[jj]
                                               : __float2bfloat16_rn(0.f);
        }
    }
  }
}

// the words of a landed u8 row that this thread copied (stage_x) -> f32
__device__ __forceinline__ void convert_own(const uint8_t* slot, float* f) {
  const int lane = threadIdx.x & 31;
  if (lane >= kRS / 4) return;
  for (int plane = threadIdx.x >> 5; plane < 48;
       plane += (int)(blockDim.x >> 5)) {
    const int k = plane * (kRS / 4) + lane;
    const uint32_t v = reinterpret_cast<const uint32_t*>(slot)[k];
    reinterpret_cast<float4*>(f)[k] =
        make_float4(u8f(v & 255u), u8f((v >> 8) & 255u),
                    u8f((v >> 16) & 255u), u8f(v >> 24));
  }
}

// the same as bf16 pairs (exact: a pixel has at most 8 significant bits)
__device__ __forceinline__ void convert_own(const uint8_t* slot, bf16* h) {
  const int lane = threadIdx.x & 31;
  if (lane >= kRS / 4) return;
  for (int plane = threadIdx.x >> 5; plane < 48;
       plane += (int)(blockDim.x >> 5)) {
    const int k = plane * (kRS / 4) + lane;
    const uint32_t v = reinterpret_cast<const uint32_t*>(slot)[k];
    reinterpret_cast<uint2*>(h)[k] =
        make_uint2(pack16(u8f(v & 255u), u8f((v >> 8) & 255u)),
                   pack16(u8f((v >> 16) & 255u), u8f(v >> 24)));
  }
}

// The conv of phases PH0..PH1 of one cell for NCH channels: `prev` and
// `cur` point at the cell's column in the staged rows (f32 or bf16) of
// cell rows u-1 and u (planes kRS elements apart), `wt` at the group's
// first weight of tap 0.  Conv output (2u+py, 2v+px) reads image row 4u + 2py + ky - 1: offset -1
// is yoff 3 of row u-1, 0..3 are yoff 0..3 of row u; columns likewise.
template <int PH0, int PH1, int NCH, typename T>
__device__ __forceinline__ void conv_cell(const T* __restrict__ prev,
                                          const T* __restrict__ cur,
                                          const float* __restrict__ wt,
                                          float (&u)[PH1 - PH0 + 1][NCH]) {
  static_assert(NCH % 2 == 0, "float4 or float2 weight reads");
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
        const float* wp = wt + ((ky * 3 + kx) * 3 + c) * kCout;
        if constexpr (NCH % 4 == 0) {
#pragma unroll
          for (int q = 0; q < NCH / 4; ++q) {
            const float4 f = reinterpret_cast<const float4*>(wp)[q];
            wv[4 * q] = f.x;
            wv[4 * q + 1] = f.y;
            wv[4 * q + 2] = f.z;
            wv[4 * q + 3] = f.w;
          }
        } else {
#pragma unroll
          for (int q = 0; q < NCH / 2; ++q) {
            const float2 f = reinterpret_cast<const float2*>(wp)[q];
            wv[2 * q] = f.x;
            wv[2 * q + 1] = f.y;
          }
        }
#pragma unroll
        for (int ph = PH0; ph <= PH1; ++ph) {
          const int ro = 2 * (ph >> 1) + ky - 1;
          const int cof = 2 * (ph & 1) + kx - 1;
          const T* rp = ro < 0 ? prev : cur;
          const float v = pix(rp + ((ro & 3) * 12 + (cof & 3) * 3 + c) * kRS +
                              (cof < 0 ? -1 : 0));
#pragma unroll
          for (int o = 0; o < NCH; ++o)
            u[ph - PH0][o] = __fmaf_rn(v, wv[o], u[ph - PH0][o]);
        }
      }
    }
  }
}

// tap t (0..26, order (ky, kx, c)) of phase ph -> its plane, whether it
// reads the row above, and its column offset (0 or -1)
__device__ __forceinline__ void tap_place(int t, int ph, int& plane,
                                          bool& up, int& off) {
  const int ky = t / 9, kx = (t / 3) % 3, c = t % 3;
  const int ro = 2 * (ph >> 1) + ky - 1, cof = 2 * (ph & 1) + kx - 1;
  plane = (ro & 3) * 12 + (cof & 3) * 3 + c;
  up = ro < 0;
  off = cof < 0 ? -1 : 0;
}

// s_tap[ph*32 + t]: tap t of phase ph as its element in a staged row
// (plane*kRS + 4 + column offset, bit 16 set where it reads the row
// above); taps 27..31, the padding of the MMA's 32 rows, as tap 0 (the
// product's rows of those taps are dropped)
__device__ __forceinline__ void fill_taps(int* s_tap) {
  for (int e = threadIdx.x; e < 4 * 32; e += blockDim.x) {
    const int ph = e >> 5, t = e & 31;
    int plane, off;
    bool up;
    tap_place(t < kTaps ? t : 0, ph, plane, up, off);
    s_tap[e] = (plane * kRS + 4 + off) | (up ? 0x10000 : 0);
  }
}

// ------------------------------------------------------------ forward

// The tile's Gram matrix of the conv's input patches: P[k][t] = pixel of
// tap t under conv output k (t < 27), P[k][27] = 1, P[k][28..31] = 0, over
// the tile's outputs k; G = P^T P (28 x 28 of the 32 x 32) in s32, exact
// (a tile has at most 11*93*4 outputs, each term <= 255^2).  K-chunks of
// 32 outputs: one phase, 32 consecutive cells of a row; the A fragment
// (P^T) and the B fragment (P) are the same four-byte runs of a staged row.
// Little arithmetic a byte: the band's rows (at most kGramRows) are all
// requested at once and waited for once.  -> gpart[tile][28*28].
__global__ void __launch_bounds__(kMaxThreads)
stem16_gram_kernel(const uint8_t* __restrict__ x, int* __restrict__ gpart,
                   const Geo G) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  uint8_t* rows = smem_raw;                      // the band, kGRow apart
  int* red = reinterpret_cast<int*>(smem_raw);   // [warp][32*32], after
  int* s_tap = reinterpret_cast<int*>(smem_raw + kGramRows * kGRow + 16);
  const Tile T = tile_of(G);
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int nwarps = blockDim.x >> 5;
  const int gid = lane >> 2, tig = lane & 3;
  const uint8_t* xb = x + (size_t)T.b * 48 * G.npad;
  const int ncols = min(G.ncw * kWarpCols, G.w4 - T.c0);   // valid columns
  const int nchk = (G.ncw * kWarpCols + 31) / 32;
  const int NR = T.rows + 1, NS = T.rows;
  const int xr0 = T.i0 - 1;
  for (int t = 0; t < NR; ++t)
    stage_x(rows + t * kGRow, xb, xr0 + t, T.c0, G);
  cp_async_commit();
  // every row's plane 48 all ones (the Gram's ones column), 49 zeros
  for (int k = tid; k < NR * 2 * (kRS / 4); k += blockDim.x) {
    const int t = k / (2 * (kRS / 4)), q = k - t * 2 * (kRS / 4);
    reinterpret_cast<uint32_t*>(rows + t * kGRow + 48 * kRS)[q] =
        q < kRS / 4 ? 0x01010101u : 0u;
  }
  // tap t of phase ph: the aligned word of its first byte relative to the
  // row above (+ kGRow: the row itself) in the low half, the byte
  // selector that takes its 4 bytes from two words in the high half
  for (int e = tid; e < 4 * 32; e += blockDim.x) {
    const int ph = e >> 5, t = e & 31;
    int off = kGRow + (t == kTaps ? 48 : 49) * kRS + 4;
    if (t < kTaps) {
      int plane, co;
      bool up;
      tap_place(t, ph, plane, up, co);
      off = (up ? 0 : kGRow) + plane * kRS + 4 + co;
    }
    s_tap[e] = (off & ~3) | ((off & 3) ? 0x65430000 : 0x32100000);
  }
  int acc[2][4][4];
#pragma unroll
  for (int a = 0; a < 2; ++a)
#pragma unroll
    for (int n = 0; n < 4; ++n)
#pragma unroll
      for (int r = 0; r < 4; ++r) acc[a][n][r] = 0;
  cp_async_wait<0>();
  __syncthreads();
  // items (row, phase, chunk of 32 columns), the warps round robin
  for (int it = warp; it < NS * 4 * nchk; it += nwarps) {
    const int s = it / (4 * nchk), r = it - s * 4 * nchk;
    const int ph = r / nchk, jc = 32 * (r - ph * nchk);
    const uint8_t* base = rows + s * kGRow;
    uint32_t F[4][2];
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int k0 = jc + 16 * h + 4 * tig;          // first column
      // the bytes of columns k0..k0+3 that lie in the tile
      const int nv = min(max(ncols - k0, 0), 4);
      const uint32_t mask = nv >= 4 ? 0xffffffffu : ((1u << (8 * nv)) - 1u);
#pragma unroll
      for (int tq = 0; tq < 4; ++tq) {
        const int e = s_tap[ph * 32 + 8 * tq + gid];
        const uint32_t* wp =
            reinterpret_cast<const uint32_t*>(base + (e & 0xffff) + k0);
        F[tq][h] = __byte_perm(wp[0], wp[1], (unsigned)e >> 16) & mask;
      }
    }
#pragma unroll
    for (int mt = 0; mt < 2; ++mt)
#pragma unroll
      for (int nt = 0; nt < 4; ++nt)
        asm volatile(
            "mma.sync.aligned.m16n8k32.row.col.s32.u8.u8.s32 "
            "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, "
            "{%0,%1,%2,%3};\n"
            : "+r"(acc[mt][nt][0]), "+r"(acc[mt][nt][1]),
              "+r"(acc[mt][nt][2]), "+r"(acc[mt][nt][3])
            : "r"(F[2 * mt][0]), "r"(F[2 * mt + 1][0]),
              "r"(F[2 * mt][1]), "r"(F[2 * mt + 1][1]),
              "r"(F[nt][0]), "r"(F[nt][1]));
  }
  // the warps' sums, in order (integers: exact in any order)
  __syncthreads();
  int* mine = red + warp * 1024;
#pragma unroll
  for (int mt = 0; mt < 2; ++mt)
#pragma unroll
    for (int nt = 0; nt < 4; ++nt)
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        const int a = 16 * mt + gid + (r >= 2 ? 8 : 0);
        const int bb = 8 * nt + 2 * tig + (r & 1);
        mine[a * 32 + bb] = acc[mt][nt][r];
      }
  __syncthreads();
  int* out = gpart + ((size_t)T.b * gridDim.x + blockIdx.x) * kGEntries;
  for (int e = tid; e < kGEntries; e += blockDim.x) {
    const int a = e / kG, bb = e - a * kG;
    int sum = 0;
    for (int q = 0; q < nwarps; ++q) sum += red[q * 1024 + a * 32 + bb];
    out[e] = sum;
  }
}

// One CTA per group: the group's tile Gram matrices summed in int64, then
// in f64 the moments of u = bf16(w).patch: mu = w.s/m, var = w^T C w with
// C = (G - s s^T/m)/m, s = G[27][:27] (the ones column), m = G[27][27].
// -> stats[(gi*24 + co)*3 + {mu, sinv, var}].
__global__ void __launch_bounds__(256)
stem16_stats_kernel(const int* __restrict__ gpart, const float* __restrict__ w,
                    float* __restrict__ stats, int tiles_per_group) {
  __shared__ double s_c[kG * kG];
  __shared__ double s_w[kNW];       // [co][tap (ky, kx, c)]
  const int gi = blockIdx.x, tid = threadIdx.x;
  const int* gp = gpart + (size_t)gi * tiles_per_group * kGEntries;
  for (int e = tid; e < kGEntries; e += blockDim.x) {
    long long s = 0;
    for (int k = 0; k < tiles_per_group; ++k)
      s += gp[(size_t)k * kGEntries + e];
    s_c[e] = (double)s;
  }
  for (int t = tid; t < kNW; t += blockDim.x) {
    const int co = t / kTaps, r = t - co * kTaps;   // r = c*9 + ky*3 + kx
    const int c = r / 9, kk = r - c * 9;
    s_w[co * kTaps + kk * 3 + c] = (double)rnd16(w[t]);
  }
  __syncthreads();
  const double m = s_c[kTaps * kG + kTaps];
  for (int e = tid; e < kTaps * kTaps; e += blockDim.x) {
    const int a = e / kTaps, bb = e - a * kTaps;
    s_c[a * kG + bb] = (s_c[a * kG + bb] -
                        s_c[kTaps * kG + a] * s_c[kTaps * kG + bb] / m) / m;
  }
  __syncthreads();
  const int lane = tid & 31, warp = tid >> 5;
  for (int co = warp; co < kCout; co += (int)(blockDim.x >> 5)) {
    const double* wc = s_w + co * kTaps;
    double q = 0.0, mu = 0.0;
    if (lane < kTaps) {
      for (int bb = 0; bb < kTaps; ++bb) q += s_c[lane * kG + bb] * wc[bb];
      q *= wc[lane];
      mu = wc[lane] * s_c[kTaps * kG + lane];
    }
    for (int o = 16; o > 0; o >>= 1) {
      q += __shfl_down_sync(kFull, q, o);
      mu += __shfl_down_sync(kFull, mu, o);
    }
    if (lane == 0) {
      const float var = (float)fmax(q, 0.0);
      float* st = stats + (size_t)(gi * kCout + co) * 3;
      st[0] = (float)(mu / m);
      st[1] = 1.f / sqrtf(var + kEps);
      st[2] = var;
    }
  }
}

// The conv again, by FMA, with the group's stats: yb = bf16(ReLU(bn)) of
// every conv output, the pool's winner by the JAX precedence -> y (bf16),
// code = 3*column + row (0..8) and zw = the winner's raw u.  Step 0
// recomputes the phases py = 1 of the row above the band (the windows'
// row 2i-1); the column 2j-1 comes from the lane to the left (-inf left of
// the image).  Lanes outside the image compute values nobody reads.
__global__ void __launch_bounds__(kMaxThreads, 2)
stem16_emit_kernel(const uint8_t* __restrict__ x, const float* __restrict__ w,
                   const float* __restrict__ gamma,
                   const float* __restrict__ beta,
                   const float* __restrict__ stats, bf16* __restrict__ y,
                   float* __restrict__ zw, uint8_t* __restrict__ code,
                   const Geo G) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  float* s_w = reinterpret_cast<float*>(smem_raw);           // [tap][co]
  float* s_par = s_w + kNW;                           // [co][mu, sg, bt]
  float* fring = s_par + 3 * kCout;                          // 3 f32 rows
  uint8_t* ring = reinterpret_cast<uint8_t*>(fring + 3 * kXRow);
  const Tile T = tile_of(G);
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int cw = warp % G.ncw, grp = warp / G.ncw;
  const uint8_t* xb = x + (size_t)T.b * 48 * G.npad;
  const int j = T.c0 + cw * kWarpCols - 1 + lane;
  const bool owned = lane > 0 && j >= 0 && j < G.w4;
  const int col = cw * kWarpCols + 3 + lane;                 // staged column
  load_weights(w, s_w);
  if (tid < kCout) {
    const float* st = stats + (size_t)((T.b / G.g) * kCout + tid) * 3;
    s_par[tid * 3] = st[0];
    s_par[tid * 3 + 1] = st[1] * gamma[tid];
    s_par[tid * 3 + 2] = beta[tid];
  }
  const int NR = T.rows + 2, NS = T.rows + 1;
  const int xr0 = T.i0 - 2;
  for (int t = 0; t < 3; ++t) {
    if (t < NR) stage_x(ring + (t & 3) * kXRow, xb, xr0 + t, T.c0, G);
    cp_async_commit();
  }
  cp_async_wait<1>();
  convert_own(ring, fring);
  convert_own(ring + kXRow, fring + kXRow);

  const float* wt = s_w + grp * kCH;
  const float* par = s_par + grp * kCH * 3;
  const int hw = G.h4 * G.w4;
  const size_t plane0 = ((size_t)T.b * kCout + grp * kCH) * hw;
  bf16* yb0 = y + plane0;
  float* zw0 = zw + plane0;
  uint8_t* code0 = code + plane0;
  float pu2[kCH], pu3[kCH], pyb2[kCH], pyb3[kCH];   // row 2i-1 (u, yb)
#pragma unroll
  for (int o = 0; o < kCH; ++o) {
    pu2[o] = pu3[o] = 0.f;
    pyb2[o] = pyb3[o] = neg_inf();
  }
  for (int s = 0; s < NS; ++s) {
    __syncthreads();
    if (s + 3 < NR) stage_x(ring + ((s + 3) & 3) * kXRow, xb, xr0 + s + 3,
                            T.c0, G);
    cp_async_commit();
    cp_async_wait<1>();
    if (s + 2 < NR) convert_own(ring + ((s + 2) & 3) * kXRow,
                                fring + ((s + 2) % 3) * kXRow);
    const float* prev = fring + (s % 3) * kXRow + col;
    const float* cur = fring + ((s + 1) % 3) * kXRow + col;
    if (s == 0) {                  // the row above the band, phases py = 1
      if (T.i0 > 0) {
        float uh[2][kCH];
        conv_cell<2, 3, kCH>(prev, cur, wt, uh);
#pragma unroll
        for (int o = 0; o < kCH; ++o) {
          const float mu = par[3 * o], sg = par[3 * o + 1],
                      bt = par[3 * o + 2];
          pu2[o] = uh[0][o];
          pu3[o] = uh[1][o];
          pyb2[o] = fmaxf(__fadd_rn(__fmul_rn(__fsub_rn(uh[0][o], mu), sg),
                                    bt), 0.f);
          pyb3[o] = fmaxf(__fadd_rn(__fmul_rn(__fsub_rn(uh[1][o], mu), sg),
                                    bt), 0.f);
          rnd16x2(pyb2[o], pyb3[o]);
        }
      }
      continue;
    }
    float u[4][kCH];
    conv_cell<0, 3, kCH>(prev, cur, wt, u);
    int at = (T.i0 + s - 1) * G.w4 + j;        // (i, j) in this channel
#pragma unroll
    for (int o = 0; o < kCH; ++o, at += hw) {
      const float mu = par[3 * o], sg = par[3 * o + 1], bt = par[3 * o + 2];
      float yb[4];
#pragma unroll
      for (int ph = 0; ph < 4; ++ph)
        yb[ph] = fmaxf(__fadd_rn(__fmul_rn(__fsub_rn(u[ph][o], mu), sg), bt),
                       0.f);
      rnd16x2(yb[0], yb[1]);
      rnd16x2(yb[2], yb[3]);
      // column 2j (px 0) and 2j+1 (px 1): rows 2i, 2i+1, 2i-1
      const float r0 = fmaxf(fmaxf(yb[0], yb[2]), pyb2[o]);
      const int e0 = yb[0] == r0 ? 0 : (yb[2] == r0 ? 1 : 2);
      const float z0 = e0 == 0 ? u[0][o] : (e0 == 1 ? u[2][o] : pu2[o]);
      const float r1 = fmaxf(fmaxf(yb[1], yb[3]), pyb3[o]);
      const int e1 = yb[1] == r1 ? 0 : (yb[3] == r1 ? 1 : 2);
      const float z1 = e1 == 0 ? u[1][o] : (e1 == 1 ? u[3][o] : pu3[o]);
      // column 2j-1: the left lane's px 1
      const float rs = __shfl_up_sync(kFull, r1, 1);
      const int el = __shfl_up_sync(kFull, e1, 1);
      const float zl = __shfl_up_sync(kFull, z1, 1);
      const float rl = j == 0 ? neg_inf() : rs;
      const float out = fmaxf(fmaxf(r0, r1), rl);
      const int cc = r0 == out ? 0 : (r1 == out ? 1 : 2);
      if (owned) {
        yb0[at] = __float2bfloat16_rn(out);
        code0[at] = (uint8_t)(3 * cc + (cc == 0 ? e0 : (cc == 1 ? e1 : el)));
        zw0[at] = cc == 0 ? z0 : (cc == 1 ? z1 : zl);
      }
      pu2[o] = u[2][o];
      pu3[o] = u[3][o];
      pyb2[o] = yb[2];
      pyb3[o] = yb[3];
    }
  }
}

// ------------------------------------------------------------ backward

// Sg and Sgx of one (image, channel) plane from dy and zw, the windows'
// winners: gsum[plane*2 + {0: Sg, 1: Sgx}], a fixed reduction order.
__global__ void __launch_bounds__(256)
stem16_sums_kernel(const bf16* __restrict__ dy, const float* __restrict__ zw,
                   const float* __restrict__ stats,
                   const float* __restrict__ gamma,
                   const float* __restrict__ beta,
                   float* __restrict__ gsum, int hw, int g) {
  __shared__ float s_red[2][8];
  const int plane = blockIdx.x;
  const int b = plane / kCout, o = plane - b * kCout;
  const float* st = stats + (size_t)((b / g) * kCout + o) * 3;
  const float mu = st[0], sinv = st[1], sg = st[1] * gamma[o], bt = beta[o];
  const float* zp = zw + (size_t)plane * hw;
  const bf16* dp = dy + (size_t)plane * hw;
  float a = 0.f, c = 0.f;
  auto term = [&](float z, bf16 dv) {
    const float d = __fsub_rn(z, mu);
    if (__fadd_rn(__fmul_rn(d, sg), bt) > 0.f) {
      const float gv = __bfloat162float(dv);
      a = a + gv;
      c = __fmaf_rn(gv, __fmul_rn(d, sinv), c);
    }
  };
  if ((hw & 3) == 0) {           // four at a time: 16 bytes of zw, 8 of dy
    const float4* z4 = reinterpret_cast<const float4*>(zp);
    const uint2* d4 = reinterpret_cast<const uint2*>(dp);
    for (int k = threadIdx.x; k < hw / 4; k += blockDim.x) {
      const float4 z = z4[k];
      const uint2 dd = d4[k];
      term(z.x, __ushort_as_bfloat16((unsigned short)(dd.x & 0xffffu)));
      term(z.y, __ushort_as_bfloat16((unsigned short)(dd.x >> 16)));
      term(z.z, __ushort_as_bfloat16((unsigned short)(dd.y & 0xffffu)));
      term(z.w, __ushort_as_bfloat16((unsigned short)(dd.y >> 16)));
    }
  } else {
    for (int k = threadIdx.x; k < hw; k += blockDim.x) term(zp[k], dp[k]);
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
    gsum[(size_t)plane * 2 + threadIdx.x] = s;
  }
}

// Owner computes: the tile's own cells, all four phases; gy of output
// (py, px) of cell (i, j) from the windows (i + {0, py}) x (j + {0, px})
// that chose it (code = its member index there), summed as the plain
// version's route does: (A + B) + (C + D); du whole, rounded to bf16, into
// s_du[co][ph*96 + column]; then dW^T += pixels^T * du on tensor cores,
// mma.sync m16n8k16 in bf16 with f32 sums: a K-chunk is 16 columns of one
// phase, warp (chunk, phase pair) takes its chunk in two phases, A = the
// chunk's pixels at taps 16*mt + (0..15) (27 of 32 real) as bf16 (exact),
// B = du of channels 8*nt + (0..7).  -> wpart[tile][648] (OIHW): each
// weight's sum over the warps of its chunks, in order.
// The u8 ring's slots hold an input row and a window row (codes, dy):
// staged row t is input cell row i0-1+t and window row i0+t, so step s
// reads slots s and s+1 for both; each thread turns the input words it
// copied into bf16 (a ring of three rows), which the conv reads and the A
// fragments load as ready bf16 pairs.
constexpr int kDuCols = 96;              // du columns of a tile row
constexpr int kDuRow = 4 * kDuCols + 8;  // a channel's du row (bf16): the
                                         // 8 pad keep the B loads apart

__global__ void __launch_bounds__(kMaxThreads, 2)
stem16_bwd_kernel(const bf16* __restrict__ dy, const uint8_t* __restrict__ x,
                  const uint8_t* __restrict__ code,
                  const float* __restrict__ stats,
                  const float* __restrict__ gsum,
                  const float* __restrict__ w,
                  const float* __restrict__ gamma,
                  const float* __restrict__ beta, float* __restrict__ wpart,
                  const Geo G, float inv_m) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  float* s_w = reinterpret_cast<float*>(smem_raw);           // [tap][co]
  float4* s_par = reinterpret_cast<float4*>(s_w + kNW);      // [co][2]
  bf16* s_du = reinterpret_cast<bf16*>(s_par + 2 * kCout);   // [co][kDuRow]
  int* s_tap = reinterpret_cast<int*>(s_du + kCout * kDuRow);
  bf16* hring = reinterpret_cast<bf16*>(s_tap + 4 * 32);     // 3 bf16 rows
  uint8_t* ring = reinterpret_cast<uint8_t*>(hring + 3 * kXRow);
  const Tile T = tile_of(G);
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int cw = warp % G.ncw, grp = warp / G.ncw;
  const int gi = T.b / G.g;
  const size_t hw = (size_t)G.h4 * G.w4;
  const uint8_t* xb = x + (size_t)T.b * 48 * G.npad;
  const uint8_t* cb = code + (size_t)T.b * kCout * hw;
  const bf16* db = dy + (size_t)T.b * kCout * hw;
  const int j = T.c0 + cw * kWarpCols - 1 + lane;
  const bool owned = lane > 0 && j >= 0 && j < G.w4;
  const int col = cw * kWarpCols + 3 + lane;                 // staged column
  const int dcol = cw * kWarpCols - 1 + lane;                // du column
  load_weights(w, s_w);
  fill_taps(s_tap);
  for (int k = tid; k < kCout * kDuRow / 2; k += blockDim.x)
    reinterpret_cast<uint32_t*>(s_du)[k] = 0u;
  if (tid < kCout) {
    const float* st = stats + (size_t)(gi * kCout + tid) * 3;
    float sgs = 0.f, sgx = 0.f;                 // the group's, fixed order
    for (int k = 0; k < G.g; ++k) {
      const float* gp = gsum + ((size_t)(gi * G.g + k) * kCout + tid) * 2;
      sgs = sgs + gp[0];
      sgx = sgx + gp[1];
    }
    s_par[2 * tid] = make_float4(st[0], st[1] * gamma[tid], beta[tid], st[1]);
    s_par[2 * tid + 1] = make_float4(gamma[tid] * st[1], sgs * inv_m,
                                     sgx * inv_m, 0.f);
  }
  const int NR = T.rows + 1, NS = T.rows;
  for (int t = 0; t < 3; ++t) {
    if (t < NR) {
      stage_x(ring + (t & 3) * kBSlot, xb, T.i0 - 1 + t, T.c0, G);
      stage_windows(ring + (t & 3) * kBSlot, cb, db, T.i0 + t, T.c0, G);
    }
    cp_async_commit();
  }
  cp_async_wait<1>();
  convert_own(ring, hring);
  convert_own(ring + kBSlot, hring + kXRow);

  const int gid = lane >> 2, tig = lane & 3;
  // the warp's K-chunk: columns c0k .. c0k+15 (2*ncw chunks of 16), phases
  // ph0, ph0 + 1
  static_assert(kGroups == 4, "2*ncw chunks x 2 phase pairs = the warps");
  const int c0k = 16 * (warp % (2 * G.ncw));
  const int ph0 = 2 * (warp / (2 * G.ncw));
  float acc[2][3][4];                          // [tap tile][channel tile]
#pragma unroll
  for (int a = 0; a < 2; ++a)
#pragma unroll
    for (int n = 0; n < 3; ++n)
#pragma unroll
      for (int r = 0; r < 4; ++r) acc[a][n][r] = 0.f;
  const float* wt = s_w + grp * kCH;
  for (int s = 0; s < NS; ++s) {
    __syncthreads();
    if (s + 3 < NR) {
      uint8_t* slot = ring + ((s + 3) & 3) * kBSlot;
      stage_x(slot, xb, T.i0 + s + 2, T.c0, G);
      stage_windows(slot, cb, db, T.i0 + s + 3, T.c0, G);
    }
    cp_async_commit();
    cp_async_wait<1>();
    if (s + 2 < NR) convert_own(ring + ((s + 2) & 3) * kBSlot,
                                hring + ((s + 2) % 3) * kXRow);
    const uint8_t* prev = ring + (s & 3) * kBSlot;           // window i
    const uint8_t* cur = ring + ((s + 1) & 3) * kBSlot;      // window i+1
    const bf16* prevh = hring + (s % 3) * kXRow;             // row i-1
    const bf16* curh = hring + ((s + 1) % 3) * kXRow;        // row i
    if (owned) {
      const uint8_t* c0p = prev + kXRow + col;
      const uint8_t* c1p = cur + kXRow + col;
      const bf16* d0p = reinterpret_cast<const bf16*>(prev + kXRow +
                                                      kCout * kRS) + col;
      const bf16* d1p = reinterpret_cast<const bf16*>(cur + kXRow +
                                                      kCout * kRS) + col;
      // phases py = 0, then py = 1: half the conv outputs live at once,
      // so that the MMA's sums stay in registers
#pragma unroll
      for (int py = 0; py < 2; ++py) {
        float u[2][kCH];
        if (py == 0)
          conv_cell<0, 1, kCH>(prevh + col, curh + col, wt, u);
        else
          conv_cell<2, 3, kCH>(prevh + col, curh + col, wt, u);
#pragma unroll
        for (int o = 0; o < kCH; ++o) {
          const int co = grp * kCH + o;
          const float4 p0 = s_par[2 * co], p1 = s_par[2 * co + 1];
          const int cA = c0p[co * kRS], cB = c0p[co * kRS + 1];
          const float dA = __bfloat162float(d0p[co * kRS]);
          const float dB = __bfloat162float(d0p[co * kRS + 1]);
          float gy[2];
          if (py == 0) {
            gy[0] = cA == 0 ? dA : 0.f;
            gy[1] = (cA == 3 ? dA : 0.f) + (cB == 6 ? dB : 0.f);
          } else {
            const int cC = c1p[co * kRS], cD = c1p[co * kRS + 1];
            const float dC = __bfloat162float(d1p[co * kRS]);
            const float dD = __bfloat162float(d1p[co * kRS + 1]);
            gy[0] = (cA == 1 ? dA : 0.f) + (cC == 2 ? dC : 0.f);
            gy[1] = ((cA == 4 ? dA : 0.f) + (cB == 7 ? dB : 0.f)) +
                    ((cC == 5 ? dC : 0.f) + (cD == 8 ? dD : 0.f));
          }
          bf16* du_row = s_du + co * kDuRow + dcol + 2 * py * kDuCols;
#pragma unroll
          for (int px = 0; px < 2; ++px) {
            const float d = __fsub_rn(u[px][o], p0.x);
            const float bn = __fadd_rn(__fmul_rn(d, p0.y), p0.z);
            const float gv = bn > 0.f ? gy[px] : 0.f;
            const float xh = __fmul_rn(d, p0.w);
            const float du = __fmul_rn(
                p1.x, __fsub_rn(__fsub_rn(gv, p1.y), __fmul_rn(xh, p1.z)));
            du_row[px * kDuCols] = __float2bfloat16_rn(du);
          }
        }
      }
    }
    __syncthreads();
    // dW^T += pixels^T * du: the warp's chunk in its two phases
#pragma unroll
    for (int q2 = 0; q2 < 2; ++q2) {
      const int ph = ph0 + q2;
      uint32_t P[4][2];            // taps 8*q + gid, columns 2*tig (+8)
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        // pixels k, k+1 at this tap: two aligned words, the pair taken out
        // by a byte selector (an odd element where the column offset is -1)
        const int e = s_tap[ph * 32 + 8 * q + gid];
        const int a = (e & 0xffff) + c0k + 2 * tig;
        const uint32_t* bp = reinterpret_cast<const uint32_t*>(
            ((e & 0x10000) ? prevh : curh) + (a & ~1));
        const unsigned sel = (a & 1) ? 0x5432u : 0x3210u;
        P[q][0] = __byte_perm(bp[0], bp[1], sel);
        P[q][1] = __byte_perm(bp[4], bp[5], sel);
      }
      uint32_t D[3][2];
      const bf16* da = s_du + ph * kDuCols + c0k + 2 * tig;
#pragma unroll
      for (int nt = 0; nt < 3; ++nt) {
        D[nt][0] = *reinterpret_cast<const uint32_t*>(da + (8 * nt + gid) *
                                                               kDuRow);
        D[nt][1] = *reinterpret_cast<const uint32_t*>(da + (8 * nt + gid) *
                                                               kDuRow + 8);
      }
#pragma unroll
      for (int mt = 0; mt < 2; ++mt)
#pragma unroll
        for (int nt = 0; nt < 3; ++nt)
          asm volatile(
              "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
              "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, "
              "{%0,%1,%2,%3};\n"
              : "+f"(acc[mt][nt][0]), "+f"(acc[mt][nt][1]),
                "+f"(acc[mt][nt][2]), "+f"(acc[mt][nt][3])
              : "r"(P[2 * mt][0]), "r"(P[2 * mt + 1][0]),
                "r"(P[2 * mt][1]), "r"(P[2 * mt + 1][1]),
                "r"(D[nt][0]), "r"(D[nt][1]));
    }
  }
  // the tile's dW: the warps' sums added in order
  __syncthreads();
  float* red = reinterpret_cast<float*>(ring);               // [warp][648]
#pragma unroll
  for (int mt = 0; mt < 2; ++mt)
#pragma unroll
    for (int nt = 0; nt < 3; ++nt)
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        const int t = 16 * mt + gid + (r >= 2 ? 8 : 0);
        const int co = 8 * nt + 2 * tig + (r & 1);
        if (t < kTaps) {
          const int ky = t / 9, kx = (t / 3) % 3, c = t % 3;
          red[warp * kNW + co * kTaps + c * 9 + ky * 3 + kx] =
              acc[mt][nt][r];
        }
      }
  __syncthreads();
  float* out = wpart + ((size_t)T.b * gridDim.x + blockIdx.x) * kNW;
  const int nwarps = blockDim.x >> 5;
  for (int k = tid; k < kNW; k += blockDim.x) {
    float s = 0.f;
    for (int q = 0; q < nwarps; ++q) s = s + red[q * kNW + k];
    out[k] = s;
  }
}

// CTA k < 648: dW[k] = the tiles' partials summed in order; [648, 672):
// dgamma = the planes' Sgx; [672, 696): dbeta = their Sg.
__global__ void __launch_bounds__(256)
stem16_reduce_kernel(const float* __restrict__ wpart,
                     const float* __restrict__ gsum, int ntiles, int b,
                     float* __restrict__ dw, float* __restrict__ dgamma,
                     float* __restrict__ dbeta) {
  __shared__ float s_red[8];
  const int k = blockIdx.x, tid = threadIdx.x;
  float s = 0.f;
  if (k < kNW) {
    for (int r = tid; r < ntiles; r += blockDim.x)
      s = s + wpart[(size_t)r * kNW + k];
  } else {
    const int which = (k - kNW) / kCout, o = (k - kNW) - which * kCout;
    for (int r = tid; r < b; r += blockDim.x)
      s = s + gsum[((size_t)r * kCout + o) * 2 + (which == 0 ? 1 : 0)];
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

constexpr size_t kGramSmem = kGramRows * kGRow + 16 + 4 * 32 * sizeof(int);
static_assert((kMaxThreads / 32) * 1024 * sizeof(int) <= kGramRows * kGRow,
              "the warps' Gram sums fit where the band was");
constexpr size_t kEmitSmem = (size_t)(kNW + 3 * kCout + 3 * kXRow) *
                                 sizeof(float) + 4 * kXRow;
constexpr size_t kBwdSmem = (size_t)(kNW + 8 * kCout + 4 * 32) *
                                sizeof(float) +
                            (size_t)(kCout * kDuRow + 3 * kXRow) *
                                sizeof(bf16) +
                            4 * (size_t)kBSlot;
static_assert((size_t)(kMaxThreads / 32) * kNW * sizeof(float) <=
                  4 * (size_t)kBSlot,
              "the dW partials fit in the ring");

bool geo_ok(int b, int h4, int w4, int npad, int g, int tr, int ncw) {
  return b >= 1 && b <= 65535 && h4 >= 1 && w4 >= 1 && npad >= h4 * w4 &&
         g >= 1 && b % g == 0 && tr >= 1 && ncw >= 1 && ncw <= kMaxNcw &&
         (long long)b * kCout <= 0x7fffffff && tr <= kMaxRows &&
         (ncw * kWarpCols + 15) / 16 == 2 * ncw;
}

Geo make_geo(int h4, int w4, int npad, int g, int tr, int ncw) {
  const int cw = ncw * kWarpCols;
  return Geo{h4, w4, npad, g, tr, ncw, (w4 + cw - 1) / cw,
             (h4 + tr - 1) / tr, 0};
}

}  // namespace

extern "C" {

// bytes of dynamic shared memory of the gram (which = 0), emit (1) and
// backward sweep (2) kernels; the others take static shared memory only
size_t fastdet_stem16_train_smem(int which) {
  return which == 0 ? kGramSmem : (which == 1 ? kEmitSmem : kBwdSmem);
}

// ints of forward scratch (the tiles' Gram matrices)
size_t fastdet_stem16_train_fwd_scratch(int b, int h4, int w4, int tr,
                                        int ncw) {
  if (tr < 1 || ncw < 1 || ncw > kMaxNcw) return 0;
  const Geo G = make_geo(h4, w4, h4 * w4, 1, tr, ncw);
  return (size_t)b * G.nband * G.nchunk * kGEntries;
}

// floats of backward scratch: the planes' (Sg, Sgx), the tiles' dW
size_t fastdet_stem16_train_bwd_scratch(int b, int h4, int w4, int tr,
                                        int ncw) {
  if (tr < 1 || ncw < 1 || ncw > kMaxNcw) return 0;
  const Geo G = make_geo(h4, w4, h4 * w4, 1, tr, ncw);
  return (size_t)b * 2 * kCout + (size_t)b * G.nband * G.nchunk * kNW;
}

// x (B, 48, npad) u8, w (24,3,3,3) f32 (scaled), gamma/beta (24) f32 ->
// y (B, 24, h4, w4) bf16, zw f32 and code u8 of the same shape, stats
// (B/g, 24, 3) f32; scratch of fastdet_stem16_train_fwd_scratch ints; all
// on the card; the tile: tr cell rows, ncw warps of 31 cell columns.
// Returns a cudaError_t (0 = launched).
int fastdet_stem16_train_fwd(const uint8_t* x, const float* w,
                             const float* gamma, const float* beta, bf16* y,
                             float* zw, uint8_t* code, float* stats,
                             int* scratch, int b, int h4, int w4, int npad,
                             int g, int tr, int ncw, void* stream) {
  if (!geo_ok(b, h4, w4, npad, g, tr, ncw))
    return (int)cudaErrorInvalidValue;
  const cudaStream_t st = (cudaStream_t)stream;
  Geo G = make_geo(h4, w4, npad, g, tr, ncw);
  // 4-byte input words need aligned rows and one chunk (start column 0)
  G.words = w4 % 4 == 0 && npad % 4 == 0 && G.nchunk == 1 &&
            ((uintptr_t)x & 3) == 0;
  cudaError_t e = cudaFuncSetAttribute(
      stem16_gram_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)kGramSmem);
  if (e != cudaSuccess) return (int)e;
  e = cudaFuncSetAttribute(stem16_emit_kernel,
                           cudaFuncAttributeMaxDynamicSharedMemorySize,
                           (int)kEmitSmem);
  if (e != cudaSuccess) return (int)e;
  const dim3 grid(G.nband * G.nchunk, b);
  stem16_gram_kernel<<<grid, 32 * kGroups * ncw, kGramSmem, st>>>(x, scratch,
                                                                   G);
  e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  stem16_stats_kernel<<<b / g, 256, 0, st>>>(scratch, w, stats,
                                             g * G.nband * G.nchunk);
  e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  stem16_emit_kernel<<<grid, 32 * kGroups * ncw, kEmitSmem, st>>>(
      x, w, gamma, beta, stats, y, zw, code, G);
  return (int)cudaGetLastError();
}

// dy (B, 24, h4, w4) bf16, x, zw and code (the forward's), stats, w, gamma,
// beta -> dw (24,3,3,3), dgamma (24), dbeta (24) f32; scratch of
// fastdet_stem16_train_bwd_scratch floats; all on the card.
int fastdet_stem16_train_bwd(const bf16* dy, const uint8_t* x,
                             const float* zw, const uint8_t* code,
                             const float* stats, const float* w,
                             const float* gamma, const float* beta,
                             float* dw, float* dgamma, float* dbeta,
                             float* scratch, int b, int h4, int w4, int npad,
                             int g, int tr, int ncw, void* stream) {
  if (!geo_ok(b, h4, w4, npad, g, tr, ncw))
    return (int)cudaErrorInvalidValue;
  const cudaStream_t st = (cudaStream_t)stream;
  Geo G = make_geo(h4, w4, npad, g, tr, ncw);
  G.words = w4 % 4 == 0 && npad % 4 == 0 && G.nchunk == 1 &&
            ((uintptr_t)x & 3) == 0 && ((uintptr_t)code & 3) == 0 &&
            ((uintptr_t)dy & 3) == 0;
  float* gsum = scratch;
  float* wpart = gsum + (size_t)b * 2 * kCout;
  cudaError_t e = cudaFuncSetAttribute(
      stem16_bwd_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)kBwdSmem);
  if (e != cudaSuccess) return (int)e;
  stem16_sums_kernel<<<b * kCout, 256, 0, st>>>(dy, zw, stats, gamma, beta,
                                                gsum, h4 * w4, g);
  e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  const float inv_m = (float)(1.0 / ((double)g * 4.0 * h4 * w4));
  const dim3 grid(G.nband * G.nchunk, b);
  stem16_bwd_kernel<<<grid, 32 * kGroups * ncw, kBwdSmem, st>>>(
      dy, x, code, stats, gsum, w, gamma, beta, wpart, G, inv_m);
  e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  stem16_reduce_kernel<<<kNW + 2 * kCout, 256, 0, st>>>(
      wpart, gsum, b * G.nband * G.nchunk, b, dw, dgamma, dbeta);
  return (int)cudaGetLastError();
}

const char* fastdet_cuda_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
