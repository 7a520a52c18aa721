// The stage kernel of the ShuffleNetV2 backbone's inference spans, shared
// by span.cu (B2: nblk stride-1 blocks) and s2span.cu (B9: the stride-2
// block, then the span).  The design is described here; span.cu and
// s2span.cu hold the C entry points and what each replaces.
//
// One CTA holds a band of `rows` output rows of one image, all C = 2*MID
// channels, in shared memory, beside a scratch of MID planes: 3*MID slot
// planes of ps = pad4(rows*w) floats.  A stride-1 block then needs no
// copy and no trip to device memory:
//   1. pw1 + ReLU reads the odd logical channels' slots, writes the scratch;
//   2. dw3x3 reads the scratch, writes the odd slots, which pw1 has used up;
//   3. pw2 + ReLU reads the odd slots, writes the scratch;
//   4. relabel: logical j < MID is the old logical 2j (the passthrough half,
//      which never moves), logical MID + j is scratch plane j, and the old
//      odd slots are the next scratch.
// A table in shared memory maps logical channels to slots (`lmap`).
//
// The depthwise conv needs one row above and below the band.  Three ways:
//   halo 0: the band is the whole image (or no block runs): zeros;
//   halo 1: a thread-block cluster per image, one band per CTA; after pw1
//           (cluster barrier) each CTA copies its neighbours' edge rows of
//           pw1's output over distributed shared memory into its halo
//           buffer H, and arrives on a second barrier, which it waits on
//           only before pw2 overwrites the scratch its neighbours read;
//   halo 2: one block per launch (the per-block variant, for stages that a
//           cluster of 8 cannot hold): the CTA loads the odd channels of
//           the two rows beyond its band and computes their pw1 itself.
// With stride2 (B9) the band is first filled by the stride-2 block, over
// chunks of 5 input rows (2 output rows and the row they share) staged by
// cp.async into X: pw1 + ReLU into Y with zeros off the image (the
// depthwise pad is on the post-ReLU branch), both dw3x3 s2 (from X and
// from Y) into free slots, and after the last chunk the two pointwise
// convs into the slots that become the stage's channels.
//
// Pointwise convs are register-tiled: a thread makes 8 output channels x 4
// neighbouring pixels, so that per input channel one 16-byte activation
// load and two 16-byte (warp-uniform) weight loads feed 32 FMAs.  The
// products stay f32 FMA on CUDA cores: TF32 does not hold 2e-4 over 13
// blocks.  A block's weights (or one pointwise matrix of the stride-2
// block) are copied into shared memory by cp.async before use.  Depthwise
// convs: a thread keeps a channel's 9 taps in registers and walks a column,
// the window rolling down it.
//
// The layout of shared memory is computed by stage_layout on the host and
// on the card alike; fastdet_span_stage_smem reports its size so that the
// launch plan (fused_infer.span_stage_plan) can be checked against it.
//
// The bf16 forms of both stages (the JAX package's bf16 serving) are the
// second half of this file; their design is described there.

#pragma once

#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stddef.h>
#include <stdint.h>

namespace {

namespace cg = cooperative_groups;

constexpr int kThreads = 384;
constexpr int kWarps = kThreads / 32;
constexpr int kChunkRows = 5;  // input rows per chunk of the stride-2 block

// ---- device intrinsics

__device__ __forceinline__ float* dyn_smem() {
  extern __shared__ float4 smem_f4[];
  return reinterpret_cast<float*>(smem_f4);
}

// 4 bytes; zero-filled where !ok (src is then not read)
__device__ __forceinline__ void cp_async4(float* dst, const float* src,
                                          bool ok) {
  const unsigned d = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(d),
               "l"(src), "r"(ok ? 4 : 0));
}

__device__ __forceinline__ void cp_async16(float* dst, const float* src) {
  const unsigned d = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(d),
               "l"(src));
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.commit_group;\ncp.async.wait_group 0;\n" ::
                   : "memory");
}

__device__ __forceinline__ void cluster_arrive() {
  asm volatile("barrier.cluster.arrive.release.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void cluster_wait() {
  asm volatile("barrier.cluster.wait.acquire.aligned;\n" ::: "memory");
}

// the same shared-memory address in CTA `rank` of this cluster
__device__ __forceinline__ const float* cluster_peer(float* p, int rank) {
  return cg::this_cluster().map_shared_rank(p, rank);
}

// ---- end of device intrinsics

__host__ __device__ constexpr int pad4(int n) { return (n + 3) & ~3; }

// Offsets (floats) into a CTA's shared memory.
struct StageLayout {
  int ps;      // slot plane stride: pad4(rows * w)
  int hs;      // halo plane stride: pad4(2 * w), row 0 above, row 1 below
  int xs;      // stride-2 chunk plane stride: pad4(kChunkRows * (2w + 2))
  int halo;    // H: MID planes of hs (halo 1 and 2)
  int hx;      // HX: MID planes of hs, pw1's input for H (halo 2)
  int wbuf;    // weights: a block's row, or one pointwise matrix + bias
  int xbuf;    // X: MID planes of xs (the free slots when xs <= ps)
  int ybuf;    // Y: MID planes of xs, after the matrix in wbuf
  int tables;  // int tables: lmap (2*MID), lfree, tsrc, tdst, tsrc2, tdst2
  int floats;  // total
};

__host__ __device__ inline StageLayout stage_layout(int mid, int rows, int w,
                                                    int halo, bool s2) {
  StageLayout L{};
  L.ps = pad4(rows * w);
  L.hs = halo ? pad4(2 * w) : 0;
  L.xs = s2 ? pad4(kChunkRows * (2 * w + 2)) : 0;
  L.halo = 3 * mid * L.ps;
  L.hx = L.halo + (halo ? mid * L.hs : 0);
  L.wbuf = L.hx + (halo == 2 ? mid * L.hs : 0);
  int region = 2 * mid * mid + 12 * mid;          // a block's weights
  if (s2) {
    const bool x_in_slots = L.xs <= L.ps;
    L.ybuf = L.wbuf + mid * mid + mid;
    L.xbuf = x_in_slots ? 2 * mid * L.ps : L.ybuf + mid * L.xs;
    const int need = mid * mid + mid + (x_in_slots ? 1 : 2) * mid * L.xs;
    region = need > region ? need : region;
  }
  L.tables = L.wbuf + region;
  L.floats = L.tables + 7 * mid;
  return L;
}

// Pointwise conv + ReLU over npix (a multiple of 4) pixels of MID planes:
// dst plane tdst[o] = ReLU(bias[o] + sum_i w[i*MID + o] * src plane
// tsrc[i]), 0 where !keep(pixel).  Plane offsets are floats into sm.
struct KeepAll {
  __device__ bool operator()(int) const { return true; }
};

template <int MID, class Keep>
__device__ __forceinline__ void pw_phase(float* sm, const int* tsrc,
                                         const int* tdst,
                                         const float* __restrict__ w,
                                         const float* __restrict__ bias,
                                         int npix, Keep keep) {
  constexpr int G = MID / 8;
  const int nq = npix >> 2;
  for (int it = threadIdx.x; it < G * nq; it += kThreads) {
    const int g = it / nq;
    const int p = (it - g * nq) * 4, o0 = g * 8;
    float acc[8][4];
    {
      const float4 b0 = *reinterpret_cast<const float4*>(bias + o0);
      const float4 b1 = *reinterpret_cast<const float4*>(bias + o0 + 4);
      const float bb[8] = {b0.x, b0.y, b0.z, b0.w, b1.x, b1.y, b1.z, b1.w};
#pragma unroll
      for (int k = 0; k < 8; ++k)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[k][j] = bb[k];
    }
#pragma unroll 4
    for (int i = 0; i < MID; ++i) {
      const float4 a = *reinterpret_cast<const float4*>(sm + tsrc[i] + p);
      const float4 wa = *reinterpret_cast<const float4*>(w + i * MID + o0);
      const float4 wb =
          *reinterpret_cast<const float4*>(w + i * MID + o0 + 4);
      const float av[4] = {a.x, a.y, a.z, a.w};
      const float wv[8] = {wa.x, wa.y, wa.z, wa.w, wb.x, wb.y, wb.z, wb.w};
#pragma unroll
      for (int k = 0; k < 8; ++k)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[k][j] = fmaf(wv[k], av[j], acc[k][j]);
    }
    const bool k0 = keep(p), k1 = keep(p + 1), k2 = keep(p + 2),
               k3 = keep(p + 3);
#pragma unroll
    for (int k = 0; k < 8; ++k) {
      float4 v;
      v.x = k0 ? fmaxf(acc[k][0], 0.f) : 0.f;
      v.y = k1 ? fmaxf(acc[k][1], 0.f) : 0.f;
      v.z = k2 ? fmaxf(acc[k][2], 0.f) : 0.f;
      v.w = k3 ? fmaxf(acc[k][3], 0.f) : 0.f;
      *reinterpret_cast<float4*>(sm + tdst[o0 + k] + p) = v;
    }
  }
}

// Depthwise 3x3 stride 1 + bias over a band of `rows` rows of width w:
// plane tdst[c] from plane tsrc[c]; the row above the band is htop + c*hs
// and the row below hbot + c*hs, each null for zeros; zero columns.  A
// thread walks one column of one channel down the band, the 3x3 window
// rolling by one row: 3 loads per output, a warp's lanes on neighbouring
// columns.
template <int MID>
__device__ __forceinline__ void dw_phase(float* sm, const int* tsrc,
                                         const int* tdst,
                                         const float* __restrict__ wd,
                                         const float* __restrict__ bd,
                                         int rows, int w, const float* htop,
                                         const float* hbot, int hs) {
  for (int it = threadIdx.x; it < MID * w; it += kThreads) {
    const int c = it / w, x = it - c * w;
    const bool has_l = x > 0, has_r = x + 1 < w;
    const float* src = sm + tsrc[c] + x;
    float* dst = sm + tdst[c] + x;
    float wt[9];
#pragma unroll
    for (int t = 0; t < 9; ++t) wt[t] = wd[t * MID + c];
    const float bias = bd[c];
    auto row3 = [&](const float* q, float v[3]) {
      v[0] = (q && has_l) ? q[-1] : 0.f;
      v[1] = q ? q[0] : 0.f;
      v[2] = (q && has_r) ? q[1] : 0.f;
    };
    float up[3], mid[3], dn[3];
    row3(htop ? htop + c * hs + x : nullptr, up);
    row3(rows > 0 ? src : nullptr, mid);
    for (int r = 0; r < rows; ++r) {
      row3(r + 1 < rows ? src + (r + 1) * w
                        : (hbot ? hbot + c * hs + x : nullptr), dn);
      float acc = bias;
#pragma unroll
      for (int t = 0; t < 3; ++t) acc = fmaf(wt[t], up[t], acc);
#pragma unroll
      for (int t = 0; t < 3; ++t) acc = fmaf(wt[3 + t], mid[t], acc);
#pragma unroll
      for (int t = 0; t < 3; ++t) acc = fmaf(wt[6 + t], dn[t], acc);
      dst[r * w] = acc;
#pragma unroll
      for (int t = 0; t < 3; ++t) {
        up[t] = mid[t];
        mid[t] = dn[t];
      }
    }
  }
}

// Load `n` floats (a multiple of 4, 16-byte aligned at both ends) into
// shared memory, asynchronously.
__device__ __forceinline__ void load_floats(float* dst, const float* src,
                                            int n) {
  for (int i = 4 * threadIdx.x; i < n; i += 4 * kThreads)
    cp_async16(dst + i, src + i);
}

// Depthwise 3x3 stride 2 + bias over `orows` (1 or 2) output rows of a
// staged chunk: plane c of the chunk starts at sm + src + c*xs, its rows
// are xw = 2w + 2 long (input column i at i + 1, zero columns around);
// output row k reads chunk rows 2k..2k+2.  Writes plane c at sm + dst +
// c*ps.  A thread walks one output column of one channel; the taps come
// from device memory (L1).
template <int MID>
__device__ __forceinline__ void dw_s2_phase(float* sm, int src, int xs,
                                            int dst, int ps,
                                            const float* __restrict__ wd,
                                            const float* __restrict__ bd,
                                            int orows, int w) {
  const int xw = 2 * w + 2;
  for (int it = threadIdx.x; it < MID * w; it += kThreads) {
    const int c = it / w, x = it - c * w;
    float wt[9];
#pragma unroll
    for (int t = 0; t < 9; ++t) wt[t] = __ldg(wd + t * MID + c);
    const float bias = __ldg(bd + c);
    const float* col = sm + src + c * xs + 2 * x;
    float* out = sm + dst + c * ps + x;
    float top[3];
#pragma unroll
    for (int t = 0; t < 3; ++t) top[t] = col[t];
    for (int k = 0; k < orows; ++k) {
      const float* q = col + 2 * k * xw;
      float acc = bias;
#pragma unroll
      for (int t = 0; t < 3; ++t) acc = fmaf(wt[t], top[t], acc);
#pragma unroll
      for (int t = 0; t < 3; ++t) acc = fmaf(wt[3 + t], q[xw + t], acc);
#pragma unroll
      for (int t = 0; t < 3; ++t) {
        top[t] = q[2 * xw + t];
        acc = fmaf(wt[6 + t], top[t], acc);
      }
      out[k * w] = acc;
    }
  }
}

// The stride-2 block into slots: logical j < MID (projection) in slot
// 2*MID + j, MID + j (main) in slot MID + j; slots [0, MID) are left
// free.  Over chunks of 2 output rows: the 5 input rows staged in X
// (cp.async, the next chunk's while the main dw runs), pw1 + ReLU into Y
// (0 off the image), the projection dw s2 from X into P (slots [MID,
// 2*MID)), the main dw s2 from Y into T (slots [0, MID)); then the
// projection's pointwise P -> [2*MID, 3*MID), pw2 T -> [MID, 2*MID).
template <int MID>
__device__ __forceinline__ void s2_prologue(
    float* sm, const StageLayout& L, const float* __restrict__ xb,
    const float* __restrict__ wts, int hin, int win, int r0, int rv, int w,
    int* tsrc, int* tdst) {
  constexpr int CIN = MID;
  const float* w1 = wts;               // [w1 | b1] contiguous
  const float* wd = w1 + MID * MID + MID;
  const float* bd = wd + 9 * MID;
  const float* w2 = bd + MID;          // [w2 | b2]
  const float* wpd = w2 + MID * MID + MID;
  const float* bpd = wpd + 9 * CIN;
  const float* wpp = bpd + CIN;        // [wpp | bpp]
  const size_t in_plane = (size_t)hin * win;
  const int tid = threadIdx.x;
  const int xw = 2 * w + 2;            // a staged row: column c at c + 1
  float* wb = sm + L.wbuf;

  load_floats(wb, w1, MID * MID + MID);
  if (tid < MID) {
    tsrc[tid] = L.xbuf + tid * L.xs;
    tdst[tid] = L.ybuf + tid * L.xs;
  }
  auto stage_x = [&](int chunk) {
    const int iy0 = 2 * (r0 + 2 * chunk) - 1;
    for (int cr = tid / 32; cr < CIN * kChunkRows; cr += kWarps) {
      const int c = cr / kChunkRows, rr = cr - c * kChunkRows;
      const int iy = iy0 + rr;
      const bool row_ok = iy >= 0 && iy < hin;
      const float* src = xb + c * in_plane + (size_t)(row_ok ? iy : 0) * win;
      float* dst = sm + L.xbuf + c * L.xs + rr * xw;
      for (int col = tid % 32; col < xw; col += 32) {
        const bool ok = row_ok && col >= 1 && col <= win;
        cp_async4(dst + col, ok ? src + col - 1 : xb, ok);
      }
    }
  };
  const int nchunks = (rv + 1) / 2;
  if (nchunks > 0) stage_x(0);
  for (int chunk = 0; chunk < nchunks; ++chunk) {
    cp_async_wait_all();
    __syncthreads();
    const int iy0 = 2 * (r0 + 2 * chunk) - 1;
    const int orows = rv - 2 * chunk < 2 ? rv - 2 * chunk : 2;
    // rows of the chunk on the image: [rlo, rhi)
    const int rlo = max(0, -iy0), rhi = min(kChunkRows, hin - iy0);
    pw_phase<MID>(sm, tsrc, tdst, wb, wb + MID * MID,
                  pad4(kChunkRows * xw), [&](int p) {
                    const int rr = p / xw, col = p - rr * xw;
                    return rr >= rlo && rr < rhi && col >= 1 && col <= win;
                  });
    dw_s2_phase<MID>(sm, L.xbuf, L.xs, MID * L.ps + 2 * chunk * w, L.ps,
                     wpd, bpd, orows, w);
    __syncthreads();
    if (chunk + 1 < nchunks) stage_x(chunk + 1);   // X is free again
    dw_s2_phase<MID>(sm, L.ybuf, L.xs, 2 * chunk * w, L.ps, wd, bd, orows,
                     w);
    __syncthreads();                   // Y is read before the next pw1
  }

  // the projection's pointwise + ReLU: P -> [2*MID, 3*MID)
  load_floats(wb, wpp, MID * MID + MID);
  if (tid < MID) {
    tsrc[tid] = (MID + tid) * L.ps;
    tdst[tid] = (2 * MID + tid) * L.ps;
  }
  cp_async_wait_all();
  __syncthreads();
  pw_phase<MID>(sm, tsrc, tdst, wb, wb + MID * MID, pad4(rv * w), KeepAll());
  __syncthreads();

  // pw2 + ReLU: T -> [MID, 2*MID)
  load_floats(wb, w2, MID * MID + MID);
  if (tid < MID) {
    tsrc[tid] = tid * L.ps;
    tdst[tid] = (MID + tid) * L.ps;
  }
  cp_async_wait_all();
  __syncthreads();
  pw_phase<MID>(sm, tsrc, tdst, wb, wb + MID * MID, pad4(rv * w), KeepAll());
}

// The stage kernel: one CTA per (band of `rows` output rows, image).
// stride2: x is the stage input (B, MID, hin, win) and wts starts with the
// stride-2 block's row; else x is (B, 2*MID, h, w).  Then nblk stride-1
// blocks (halo 2: nblk == 1), and the band of y (B, 2*MID, h, w) is
// written once.
template <int MID, bool S2>
__global__ void __launch_bounds__(kThreads, 1)
span_stage_kernel(const float* __restrict__ x, float* __restrict__ y,
                  const float* __restrict__ wts, int hin, int win, int h,
                  int w, int rows, int nblk, int halo) {
  constexpr int C = 2 * MID;
  constexpr int kS2Floats = 3 * MID * MID + 23 * MID;
  constexpr int kBlockFloats = 2 * MID * MID + 12 * MID;
  float* sm = dyn_smem();
  const StageLayout L = stage_layout(MID, rows, w, halo, S2);
  int* lmap = reinterpret_cast<int*>(sm + L.tables);
  int* lfree = lmap + C;
  int* tsrc = lfree + MID;
  int* tdst = tsrc + MID;
  int* tsrc2 = tdst + MID;
  int* tdst2 = tsrc2 + MID;
  const int tid = threadIdx.x;
  const int band = blockIdx.x;
  const int r0 = band * rows;
  const int rv = max(0, min(rows, h - r0));
  const size_t plane = (size_t)h * w;
  float* wb = sm + L.wbuf;

  if (S2) {
    s2_prologue<MID>(sm, L, x + (size_t)blockIdx.y * MID * hin * win, wts,
                     hin, win, r0, rv, w, tsrc, tdst);
    if (tid < C) lmap[tid] = (tid < MID ? 2 * MID + tid : tid) * L.ps;
    if (tid < MID) lfree[tid] = tid * L.ps;
  } else {
    const float* xb = x + (size_t)blockIdx.y * C * plane + (size_t)r0 * w;
    const int n = rv * w;
    for (int c = tid / 32; c < C; c += kWarps)
      for (int p = tid % 32; p < n; p += 32)
        cp_async4(sm + c * L.ps + p, xb + c * plane + p, true);
    if (halo == 2) {
      // the odd channels of the rows above and below the band -> HX
      for (int jr = tid / 32; jr < 2 * MID; jr += kWarps) {
        const int j = jr >> 1, below = jr & 1;
        const int gy = below ? r0 + rv : r0 - 1;
        const bool ok = gy >= 0 && gy < h;
        const float* src = x + (size_t)blockIdx.y * C * plane +
                           (2 * j + 1) * plane + (size_t)(ok ? gy : 0) * w;
        float* dst = sm + L.hx + j * L.hs + below * w;
        for (int col = tid % 32; col < w; col += 32)
          cp_async4(dst + col, ok ? src + col : x, ok);
      }
      if (tid < MID) {
        tsrc2[tid] = L.hx + tid * L.hs;
        tdst2[tid] = L.halo + tid * L.hs;
      }
    }
    if (tid < C) lmap[tid] = tid * L.ps;
    if (tid < MID) lfree[tid] = (2 * MID + tid) * L.ps;
  }

  const bool has_above = halo && r0 > 0;
  const bool has_below = halo && r0 + rv < h;
  const float* htop = has_above ? sm + L.halo : nullptr;
  const float* hbot = has_below ? sm + L.halo + w : nullptr;
  const int rank = blockIdx.x;         // cluster dims (n, 1, 1), grid.x = n
  for (int k = 0; k < nblk; ++k) {
    __syncthreads();                   // the last phase's reads are done
    load_floats(wb, wts + (S2 ? kS2Floats : 0) + (size_t)k * kBlockFloats,
                kBlockFloats);
    if (tid < MID) {
      tsrc[tid] = lmap[2 * tid + 1];
      tdst[tid] = lfree[tid];
    }
    cp_async_wait_all();
    __syncthreads();
    const float* w1 = wb;
    const float* b1 = w1 + MID * MID;
    const float* wd = b1 + MID;
    const float* bd = wd + 9 * MID;
    const float* w2 = bd + MID;
    const float* b2 = w2 + MID * MID;

    // 1. pw1 + ReLU: odd slots -> scratch (and HX -> H, halo 2)
    pw_phase<MID>(sm, tsrc, tdst, w1, b1, pad4(rv * w), KeepAll());
    if (halo == 2)
      pw_phase<MID>(sm, tsrc2, tdst2, w1, b1, L.hs, [&](int p) {
        return p < w ? has_above : (p < 2 * w && has_below);
      });
    if (halo == 1) {
      // 2. the neighbours' edge rows of pw1's output -> H
      cluster_arrive();
      cluster_wait();
      for (int it = tid; it < 2 * MID * w; it += kThreads) {
        const int below = it >= MID * w;
        const int jc = it - below * MID * w;
        const int j = jc / w, col = jc - j * w;
        float v = 0.f;
        if (below ? has_below : has_above) {
          const float* peer = cluster_peer(sm, below ? rank + 1 : rank - 1);
          v = peer[tdst[j] + (below ? 0 : (rows - 1) * w) + col];
        }
        sm[L.halo + j * L.hs + below * w + col] = v;
      }
      cluster_arrive();                // done reading the neighbours
    }
    __syncthreads();

    // 3. dw3x3 + bias: scratch (+ H) -> odd slots
    dw_phase<MID>(sm, tdst, tsrc, wd, bd, rv, w, htop, hbot, L.hs);
    __syncthreads();
    if (halo == 1) cluster_wait();     // before the scratch is overwritten

    // 4. pw2 + ReLU: odd slots -> scratch
    pw_phase<MID>(sm, tsrc, tdst, w2, b2, pad4(rv * w), KeepAll());
    __syncthreads();

    // 5. relabel: passthrough j <- 2j, branch MID + j <- scratch j, the
    //    odd slots become the scratch
    int v = 0;
    if (tid < MID) v = lmap[2 * tid];
    else if (tid < 2 * MID) v = tdst[tid - MID];
    else if (tid < 3 * MID) v = tsrc[tid - 2 * MID];
    __syncthreads();
    if (tid < 2 * MID) lmap[tid] = v;
    else if (tid < 3 * MID) lfree[tid - 2 * MID] = v;
  }
  __syncthreads();

  // the band of every logical channel, written once
  float* yb = y + (size_t)blockIdx.y * C * plane + (size_t)r0 * w;
  const int n = rv * w;
  for (int c = tid / 32; c < C; c += kWarps) {
    const float* src = sm + lmap[c];
    for (int p = tid % 32; p < n; p += 32) yb[c * plane + p] = src[p];
  }
}

template <int MID, bool S2>
int launch_stage(const float* x, float* y, const float* wts, int b, int hin,
                 int win, int h, int w, int rows, int cluster, int nblk,
                 int halo, cudaStream_t stream) {
  const size_t smem =
      (size_t)stage_layout(MID, rows, w, halo, S2).floats * sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(
      span_stage_kernel<MID, S2>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const int bands = (h + rows - 1) / rows;
  if (bands % cluster) return (int)cudaErrorInvalidValue;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(bands, b, 1);
  cfg.blockDim = dim3(kThreads, 1, 1);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = cluster;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  err = cudaLaunchKernelEx(&cfg, span_stage_kernel<MID, S2>, x, y, wts, hin,
                           win, h, w, rows, nblk, halo);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

// nblk stride-1 blocks from src (B, 2*MID, h, w) to out with the plan's
// rows and cluster: one launch ("stage": a cluster of `cluster` bands per
// image), or one launch per block ("per block": bands of `rows` rows that
// compute their halo rows' pw1, ping-pong through tmp so that the last
// block writes out; src is never written).
template <int MID>
int launch_span(const float* src, float* out, float* tmp, const float* wts,
                int b, int h, int w, int nblk, int rows, int cluster,
                int per_block, cudaStream_t stream) {
  if (rows < 1 || cluster < 1 || cluster > 8) return (int)cudaErrorInvalidValue;
  if (!per_block)
    return launch_stage<MID, false>(src, out, wts, b, h, w, h, w, rows,
                                    cluster, nblk, cluster > 1 ? 1 : 0,
                                    stream);
  constexpr size_t kBlockFloats = 2 * MID * MID + 12 * MID;
  for (int k = 0; k < nblk; ++k) {
    float* dst = ((nblk - 1 - k) % 2 == 0) ? out : tmp;
    const int rc = launch_stage<MID, false>(
        src, dst, wts + k * kBlockFloats, b, h, w, h, w, rows, 1, 1,
        rows < h ? 2 : 0, stream);
    if (rc) return rc;
    src = dst;
  }
  return 0;
}


// ====================================================== the bf16 stage
//
// The JAX package's bf16 serving runs each stride-1 block as
//   y = bf16(ReLU(pw1(x_odd) + b1)),  z = bf16(ReLU(Wc . taps(y) + bc)),
//   out = concat[x_even, z],
// with Wc (MID, 9*MID) = dw3x3 composed with pw2 and cast to bf16 as one
// matrix, and the stride-2 block as
//   y = bf16(ReLU(pw1(x) + b1)) on the input grid,
//   out = concat[bf16(ReLU(Wp . taps_s2(x) + bp)),
//                bf16(ReLU(Wc . taps_s2(y) + bc))],
// every product of bf16 operands accumulated in f32 (fold.py's composed
// packings; fused_infer.span_reference_bf16, s2span_reference_bf16).
// bf16(Wc) is not bf16(pw2) . bf16(dw), so the bf16 stage runs the
// composed product, an implicit GEMM of depth K = 9*MID, on the tensor
// cores (mma.sync m16n8k16 bf16, f32 accumulate): M = pixels, N = MID.
//
// One launch a stage call (span16_stage_kernel), as the f32 stage kernel:
// a CTA holds a band of `rows` output rows of one image, all C = 2*MID
// channels, in shared memory for all nblk blocks; the CTAs of an image
// form a thread-block cluster, and the depthwise halo (pw1's output on the
// rows beyond the band) comes from the neighbours over distributed shared
// memory with the two-barrier scheme of the f32 kernel.  The passthrough
// half never moves.  Shared memory, pixel-major (a pixel's channels
// contiguous, its stride an odd number of 16-byte units, so that the 8
// rows of an ldmatrix meet distinct banks):
//   X  the band, C slots a pixel;
//   Y  pw1's output, MID channels, the band's rows and the row above and
//      below, one zero column on each side (the conv's zero pad), so that
//      every tap's A row is the pixel's address plus a constant;
//   a ring of two chunks of B fragments, streamed by cp.async;
//   16 zero bytes, the A row of K past 9*MID, and past MID in the
//   stride-2 pw1 (both at MID = 24).
// Each GEMM (M pixels, N = MID, K = C, 9*MID or pad16(MID)) gives a warp
// MT m-tiles by NTW n-tiles at once: per k-step one ldmatrix.x4 an m-tile
// and one 8-byte shared load a lane an n-tile, each B fragment feeding MT
// MMAs and each A fragment NTW.  M-tile i of a pass goes to warp row
// i % WM, so that a small M (a stride-2 chunk) spreads over the warps; at
// MID 96 two warp columns split N, so that stage 4's 121 pixels an image
// (8 m-tiles) keep all 8 warps busy.  The weights stream through the ring in
// chunks of KC k-steps, the next chunk (of this GEMM, its next pass, or
// the next GEMM) loading while the current one is multiplied.  A band
// larger than a pass (CAP m-tiles) is multiplied in passes, the weights
// streamed again for each.  The 9 taps are unrolled: a lane's A address is
// its pixel's plus a compile-time tap offset.
//
// The channel shuffle: the weights carry it (fold.pack_span16).  Logical
// channel l of block k lies in slot P_k(l): P_0 the identity, then the
// passthrough keeps its slots (P_{k+1}(j) = P_k(2j)) and z_r is written
// where pw1's input 2r + 1 was (P_{k+1}(MID + r) = P_k(2r + 1)).  pw1 runs
// over all C slots with the composed `wa`'s top half, whose even columns
// are 0 (as the JAX package's pw1 is), its columns permuted by P_k on the
// host; z's epilogue stores by the table P_k(2r + 1), kept in shared
// memory (lmap); staging and the output go through its inverse.
//
// The stride-2 block (S2) is the launch's prologue: over chunks of `orows`
// output rows, the 2*orows + 1 input rows staged pixel-major with zero
// columns (XI), pw1 into YI (zero off the image), then Wp over XI's and Wc
// over YI's stride-2 taps into the band's slots (proj j in slot j, main in
// MID + j: P_0).  Where no cluster of 8 holds an image the plan launches
// this kernel once a block (halo 2: the band stages the rows above and
// below and computes their pw1 itself), and the stride-2 block alone.
//
// What bounds it on this card: at 352² b128 the spans (3/7/3 blocks)
// 0.0142 ms by bytes at stage 2 (the activation read and written once) and
// 0.0202 / 0.0087 ms by bf16 tensor-core operations at stages 3 and 4
// (pw1 over all C slots adds a tenth to the operations).  The card reads
// the mma.sync loops, the epilogues and, at stage 2, the staging of the
// NCHW input as most of the time (fastdet_torch.kernels.stage_phases).
// Rounding points are the JAX package's: the f32 bias is added to the f32
// accumulator, then ReLU, then one rounding to bf16.

constexpr int kThreads16 = 256;
constexpr int kWarps16 = kThreads16 / 32;

__host__ __device__ constexpr int pad16(int n) { return (n + 15) & ~15; }

// the stride (bf16) of a pixel of n channels (n a multiple of 8): an odd
// number of 16-byte units
__host__ __device__ constexpr int odd16(int n) {
  return ((n / 8) & 1) ? n : n + 8;
}

// k-steps of B a ring chunk holds
__host__ __device__ constexpr int kc16(int mid) {
  return mid == 24 ? 14 : mid == 48 ? 9 : 6;
}

template <int MID>
struct Cfg16 {
  static constexpr int C = 2 * MID;
  static constexpr int NT = MID / 8;               // n-tiles of 8 channels
  static constexpr int NTW = NT < 6 ? NT : 6;      // n-tiles a warp
  static constexpr int WN = NT / NTW;              // warps along N
  static constexpr int WM = kWarps16 / WN;         // warps along M
  static constexpr int MT = MID == 96 ? 2 : 4;     // m-tiles a warp at once
  static constexpr int CAP = WM * MT;              // m-tiles a pass
  static constexpr int KC = kc16(MID);
  static constexpr int KSB = MID * 32;             // bytes of a k-step's B
  static constexpr int PSX = odd16(C);
  static constexpr int PSY = odd16(MID);
  static constexpr int KS1 = C / 16;               // the span's pw1
  static constexpr int KSC = pad16(9 * MID) / 16;  // a composed 3x3
  static constexpr int KS1S = pad16(MID) / 16;     // the stride-2 pw1
  static constexpr int ELEMS = (C + pad16(9 * MID)) * MID;  // a span block
};

// Byte offsets into a CTA's shared memory (bytes 0-15 are zeros).
struct Layout16 {
  int lmap;    // 2 x C int16: the slot of each logical channel, by k parity
  int inv;     // C int16: the logical channel of each slot
  int ring;    // two chunks of B fragments
  int x;       // X: (rows, + 2 with halo 2) x w pixels of odd16(C)
  int u;       // Y, (rows + 2) x (w + 2) pixels of odd16(MID); or XI (S2)
  int yi;      // YI (S2): after XI's (2*orows + 1) x (win + 2) pixels,
               // both of odd16(MID)
  int bytes;   // total
};

__host__ __device__ inline Layout16 span16_layout(int mid, int rows, int w,
                                                  int halo, int s2, int win,
                                                  int orows) {
  const int c = 2 * mid;
  Layout16 L{};
  L.lmap = 16;
  L.inv = L.lmap + 4 * c;
  L.ring = L.inv + 2 * c;
  L.x = L.ring + 2 * kc16(mid) * mid * 32;
  L.u = L.x + (rows + (halo == 2 ? 2 : 0)) * w * odd16(c) * 2;
  const int ybytes = (rows + 2) * (w + 2) * odd16(mid) * 2;
  int pbytes = 0;
  L.yi = L.u;
  if (s2) {
    const int npi = (2 * orows + 1) * (win + 2);
    L.yi = L.u + npi * odd16(mid) * 2;
    pbytes = 2 * npi * odd16(mid) * 2;
  }
  L.bytes = L.u + (ybytes > pbytes ? ybytes : pbytes);
  return L;
}

__device__ __forceinline__ unsigned char* dyn_smem16() {
  extern __shared__ uint4 smem_u4[];
  return reinterpret_cast<unsigned char*>(smem_u4);
}

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return (uint32_t)__cvta_generic_to_shared(p);
}

__device__ __forceinline__ void cp_async16_to(uint32_t dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(dst),
               "l"(src));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

__device__ __forceinline__ void cp_async_wait0() {
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}

__device__ __forceinline__ void ldmatrix_x4(uint32_t (&a)[4], uint32_t addr) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(a[0]), "=r"(a[1]), "=r"(a[2]), "=r"(a[3])
      : "r"(addr));
}

__device__ __forceinline__ void mma_bf16_16816(float (&d)[4],
                                               const uint32_t (&a)[4],
                                               uint2 b) {
  asm("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b.x), "r"(b.y));
}

__device__ __forceinline__ __nv_bfloat162 relu_bias16(float a, float b,
                                                      float2 bias) {
  return __floats2bfloat162_rn(fmaxf(a + bias.x, 0.f),
                               fmaxf(b + bias.y, 0.f));
}

// The first of the lane's output columns in a GEMM's epilogue: o0 + 8n
// + {0, 1} for its n-tiles n < NTW (`gemm16`).
template <int MID>
__device__ __forceinline__ int lane_col0() {
  using K = Cfg16<MID>;
  return (threadIdx.x >> 5) % K::WN * K::NTW * 8 + 2 * (threadIdx.x & 3);
}

// The lane's biases of a GEMM's columns, read before the GEMM so that the
// epilogue waits on no load.
template <int MID>
struct Bias16 {
  float2 v[Cfg16<MID>::NTW];
  __device__ __forceinline__ explicit Bias16(const float* bias) {
    const int o0 = lane_col0<MID>();
#pragma unroll
    for (int n = 0; n < Cfg16<MID>::NTW; ++n)
      v[n] = make_float2(__ldg(bias + o0 + 8 * n), __ldg(bias + o0 + 8 * n + 1));
  }
};

// nks k-steps of B fragments (fold.mma_fragments order) into a ring chunk
template <int MID>
__device__ __forceinline__ void ring_issue(uint32_t dst, const uint16_t* src,
                                           int nks) {
  const int n16 = nks * (Cfg16<MID>::KSB / 16);
  const char* s = reinterpret_cast<const char*>(src);
  for (int i = threadIdx.x; i < n16; i += kThreads16)
    cp_async16_to(dst + 16 * i, s + 16 * i);
  cp_async_commit();
}

// The first chunk of the GEMM after this one (src null: none).
struct Next16 {
  const uint16_t* src;
  int ks;
};

// The k-steps of ring chunk j for a warp's first NM m-tiles (NM known at
// compile time, so that the whole chunk is one schedule).
template <int MID, int KS, int NM, class AAddr>
__device__ __forceinline__ void chunk16(
    float (&acc)[Cfg16<MID>::MT][Cfg16<MID>::NTW][4],
    const uint32_t (&base)[Cfg16<MID>::MT], const unsigned char* bbuf, int j,
    int wn, int lane, AAddr a_addr) {
  using K = Cfg16<MID>;
  const int h = lane >> 4;
#pragma unroll
  for (int ss = 0; ss < K::KC; ++ss) {
    const int s = j * K::KC + ss;
    if (s < KS) {
      uint32_t a[NM][4];
      uint2 b[K::NTW];
#pragma unroll
      for (int mt = 0; mt < NM; ++mt)
        ldmatrix_x4(a[mt], a_addr(base[mt], s, h));
#pragma unroll
      for (int n = 0; n < K::NTW; ++n)
        b[n] = *reinterpret_cast<const uint2*>(
            bbuf + ((ss * K::NT + wn * K::NTW + n) * 32 + lane) * 8);
#pragma unroll
      for (int mt = 0; mt < NM; ++mt)
#pragma unroll
        for (int n = 0; n < K::NTW; ++n)
          mma_bf16_16816(acc[mt][n], a[mt], b[n]);
    }
  }
}

// One GEMM phase: for each of the npix pixels p (M) and MID columns o
// (N), sum over KS k-steps of A(p, k) B(k, o), the B fragments streamed
// from src through the ring (the phase's first chunk already issued into
// ring chunk `cur`; the chunk after the phase's last is `next`'s first).
// A pass takes CAP m-tiles, m-tile i of a pass to warp row i % WM, so
// that a small M spreads over the warps.  a_base(p): the shared address
// of p's A row; a_addr(base, s, h): the lane's row address at k-step s,
// k-half h (columns 16s + 8h ..).  epi(p, o0, v, r): row r of the lane's
// fragments for pixel p, columns o0 + 8n + {0, 1} in v[n][2r],
// v[n][2r + 1].
template <int MID, int KS, class ABase, class AAddr, class Epi>
__device__ __forceinline__ void gemm16(unsigned char* ring, int& cur,
                                       const uint16_t* src, int npix,
                                       Next16 next, ABase a_base,
                                       AAddr a_addr, Epi epi) {
  using K = Cfg16<MID>;
  constexpr int NCH = (KS + K::KC - 1) / K::KC;
  constexpr int CHB = K::KC * K::KSB;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int wn = warp % K::WN, wm = warp / K::WN;
  const int g = lane >> 2, tig = lane & 3;
  const int mtiles = (npix + 15) >> 4;
  const int npass = (mtiles + K::CAP - 1) / K::CAP;
  const uint32_t ring_s = smem_u32(ring);
  for (int pass = 0; pass < npass; ++pass) {
    const int mt0 = pass * K::CAP + wm;      // then every WM-th
    const int nmt = max(0, min(K::MT, (mtiles - mt0 + K::WM - 1) / K::WM));
    uint32_t base[K::MT];
#pragma unroll
    for (int mt = 0; mt < K::MT; ++mt)
      base[mt] = a_base(
          min((mt0 + mt * K::WM) * 16 + (lane & 15), npix - 1));
    float acc[K::MT][K::NTW][4];
#pragma unroll
    for (int mt = 0; mt < K::MT; ++mt)
#pragma unroll
      for (int n = 0; n < K::NTW; ++n)
#pragma unroll
        for (int q = 0; q < 4; ++q) acc[mt][n][q] = 0.f;
#pragma unroll
    for (int j = 0; j < NCH; ++j) {
      cp_async_wait0();
      __syncthreads();       // chunk j landed; all warps are done with cur^1
      {
        const uint16_t* nsrc = next.src;
        int nks = next.ks;
        if (j + 1 < NCH) {
          nsrc = src + (size_t)(j + 1) * K::KC * MID * 16;
          nks = KS - (j + 1) * K::KC;
        } else if (pass + 1 < npass) {
          nsrc = src;
          nks = KS;
        }
        if (nsrc)
          ring_issue<MID>(ring_s + (cur ^ 1) * CHB, nsrc,
                          nks < K::KC ? nks : K::KC);
      }
      const unsigned char* bbuf = ring + cur * CHB;
      if (nmt == K::MT)
        chunk16<MID, KS, K::MT>(acc, base, bbuf, j, wn, lane, a_addr);
      else if (K::MT > 3 && nmt == 3)
        chunk16<MID, KS, (K::MT > 3 ? 3 : 1)>(acc, base, bbuf, j, wn, lane,
                                              a_addr);
      else if (K::MT > 2 && nmt == 2)
        chunk16<MID, KS, (K::MT > 2 ? 2 : 1)>(acc, base, bbuf, j, wn, lane,
                                              a_addr);
      else if (nmt == 1)
        chunk16<MID, KS, 1>(acc, base, bbuf, j, wn, lane, a_addr);
      cur ^= 1;
    }
#pragma unroll
    for (int mt = 0; mt < K::MT; ++mt)
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const int p = (mt0 + mt * K::WM) * 16 + g + 8 * r;
        if (mt < nmt && p < npix)
          epi(p, wn * K::NTW * 8 + 2 * tig, acc[mt], r);
      }
  }
}

// The A address of a composed 3x3 GEMM: column k = 9 taps of MID channels
// (tap t = ky*3 + kx major), the tap's pixel at base + ky*rowb + kx*psb
// (bytes), the 16 zero bytes beyond K = 9*MID.
template <int MID>
struct TapAddr16 {
  uint32_t rowb, psb, zero;
  __device__ __forceinline__ uint32_t at(uint32_t base, int k0) const {
    const int t = k0 / MID, ch = k0 - t * MID;
    return t < 9 ? base + (t / 3) * rowb + (t % 3) * psb + 2 * ch : zero;
  }
  __device__ __forceinline__ uint32_t operator()(uint32_t base, int s,
                                                 int h) const {
    if ((16 * s) / MID == (16 * s + 8) / MID)   // one tap: compile time
      return at(base + 16 * h, 16 * s);
    return h ? at(base, 16 * s + 8) : at(base, 16 * s);
  }
};

// The A address of a pointwise GEMM of depth KV (a multiple of 8): the
// pixel's channels in order, the 16 zero bytes beyond KV (pad16(KV)).
template <int KV>
struct RowAddr16 {
  uint32_t zero;
  __device__ __forceinline__ uint32_t operator()(uint32_t base, int s,
                                                 int h) const {
    if (16 * s + 8 >= KV) return h ? zero : base + 32 * s;
    return base + 32 * s + 16 * h;
  }
};

// The stage kernel: one CTA per (band of `rows` output rows, image).  S2:
// x is the stage input (B, MID, hin, win), the stride-2 block (ws2, bs2:
// fold.pack_s2_16) is the prologue; else x is (B, C, h, w).  Then nblk
// span blocks from wspan / bspan (block k0 of the span first: its slots
// P_k0), and the band of y (B, C, h, w) is written once.
template <int MID, bool S2>
__global__ void __launch_bounds__(kThreads16, 1)
span16_stage_kernel(const __nv_bfloat16* __restrict__ x,
                    __nv_bfloat16* __restrict__ y,
                    const uint16_t* __restrict__ wspan,
                    const float* __restrict__ bspan,
                    const uint16_t* __restrict__ ws2,
                    const float* __restrict__ bs2, int hin, int win, int h,
                    int w, int rows, int nblk, int halo, int k0, int orows) {
  using K = Cfg16<MID>;
  using bf16 = __nv_bfloat16;
  constexpr int C = K::C, PSX = K::PSX, PSY = K::PSY;
  unsigned char* sm = dyn_smem16();
  const Layout16 L = span16_layout(MID, rows, w, halo, S2, win, orows);
  short* lmap = reinterpret_cast<short*>(sm + L.lmap);
  short* inv = reinterpret_cast<short*>(sm + L.inv);
  unsigned char* ring = sm + L.ring;
  bf16* sx = reinterpret_cast<bf16*>(sm + L.x);
  bf16* sy = reinterpret_cast<bf16*>(sm + L.u);
  const uint32_t zero = smem_u32(sm);
  const uint32_t sx_s = smem_u32(sx), sy_s = smem_u32(sy);
  const int tid = threadIdx.x;
  const int r0 = blockIdx.x * rows, rv = max(0, min(rows, h - r0));
  const size_t plane = (size_t)h * w;
  const int xoff = halo == 2 ? w : 0;        // X pixel of band pixel 0
  const int xr0 = r0 - (halo == 2 ? 1 : 0);  // image row of X's row 0
  const int yrow0 = halo == 2 ? 0 : 1;       // Y row of X's row 0
  const uint4 zero4 = make_uint4(0, 0, 0, 0);
  int cur = 0;

  if (tid == 0) *reinterpret_cast<uint4*>(sm) = zero4;
  if (tid < C) {                             // P_k0
    int s = tid;
    for (int i = 0; i < k0; ++i) s = s < MID ? 2 * s : 2 * (s - MID) + 1;
    lmap[tid] = (short)s;
    inv[s] = (short)tid;
  }
  constexpr int KS0 = S2 ? K::KS1S : K::KS1;  // the first GEMM's k-steps
  ring_issue<MID>(smem_u32(ring), S2 ? ws2 : wspan,
                  KS0 < K::KC ? KS0 : K::KC);
  __syncthreads();

  if (S2) {
    // ---- the stride-2 block, over chunks of orows output rows
    const size_t in_plane = (size_t)hin * win;
    const bf16* xb = x + (size_t)blockIdx.y * MID * in_plane;
    const int pitch = win + 2;
    bf16* sxi = sy;
    bf16* syi = reinterpret_cast<bf16*>(sm + L.yi);
    const uint32_t sxi_s = smem_u32(sxi), syi_s = smem_u32(syi);
    const uint16_t* w1s = ws2;
    const uint16_t* wcs = ws2 + pad16(MID) * MID;
    const uint16_t* wps = wcs + pad16(9 * MID) * MID;
    const TapAddr16<MID> tx{(uint32_t)(pitch * PSY * 2), PSY * 2, zero};
    for (int ro0 = r0; ro0 < r0 + rv; ro0 += orows) {
      const int orc = min(orows, r0 + rv - ro0);
      const int iy0 = 2 * ro0 - 1, npi = (2 * orc + 1) * pitch;
      __syncthreads();                       // XI and YI are free
      // XI: input rows iy0 .., columns -1 .. win, 0 off the image; four
      // items (a pixel's 8 channels) a thread in flight
      constexpr int G = MID / 8;
      for (int it0 = tid; it0 < npi * G; it0 += 4 * kThreads16) {
        alignas(16) bf16 e[4][8];
#pragma unroll
        for (int u = 0; u < 4; ++u) {
          const int it = it0 + u * kThreads16;
          const int gq = it / npi, q = it - gq * npi;
          const int lr = q / pitch, ix = q - lr * pitch - 1, iy = iy0 + lr;
          const bool ok = it < npi * G && iy >= 0 && iy < hin && ix >= 0 &&
                          ix < win;
          const bf16* src = xb + (size_t)(8 * gq) * in_plane +
                            (size_t)iy * win + ix;
#pragma unroll
          for (int k = 0; k < 8; ++k)
            e[u][k] = ok ? src[k * in_plane] : __float2bfloat16(0.f);
        }
#pragma unroll
        for (int u = 0; u < 4; ++u) {
          const int it = it0 + u * kThreads16;
          const int gq = it / npi, q = it - gq * npi;
          if (it < npi * G)
            *reinterpret_cast<uint4*>(sxi + q * PSY + 8 * gq) =
                *reinterpret_cast<const uint4*>(e[u]);
        }
      }
      // pw1 + ReLU on the input grid -> YI (0 off the image)
      const Bias16<MID> b1s(bs2);
      gemm16<MID, K::KS1S>(
          ring, cur, w1s, npi, Next16{wps, K::KSC},
          [&](int q) { return sxi_s + q * PSY * 2; },
          RowAddr16<MID>{zero},
          [&](int q, int o0, const float (&v)[K::NTW][4], int r) {
            const int lr = q / pitch, pc = q - lr * pitch;
            const bool live = iy0 + lr >= 0 && iy0 + lr < hin && pc >= 1 &&
                              pc <= win;
#pragma unroll
            for (int n = 0; n < K::NTW; ++n) {
              const int o = o0 + 8 * n;
              __nv_bfloat162 t = relu_bias16(v[n][2 * r], v[n][2 * r + 1],
                                             b1s.v[n]);
              if (!live) t = __floats2bfloat162_rn(0.f, 0.f);
              *reinterpret_cast<__nv_bfloat162*>(syi + q * PSY + o) = t;
            }
          });
      // the projection: Wp over XI's stride-2 taps -> slots 0 .. MID-1;
      // the main branch: Wc over YI's -> slots MID .. C-1
      auto tap_base = [&](uint32_t src) {
        return [=](int p) {
          const int i = p / w, c = p - i * w;
          return src + (2 * i * pitch + 2 * c) * PSY * 2;
        };
      };
      auto put = [&](int slot0, const Bias16<MID> bias) {
        return [=](int p, int o0, const float (&v)[K::NTW][4], int r) {
          bf16* px = sx + ((ro0 - r0) * w + p) * PSX + slot0;
#pragma unroll
          for (int n = 0; n < K::NTW; ++n) {
            const int o = o0 + 8 * n;
            *reinterpret_cast<__nv_bfloat162*>(px + o) =
                relu_bias16(v[n][2 * r], v[n][2 * r + 1], bias.v[n]);
          }
        };
      };
      gemm16<MID, K::KSC>(ring, cur, wps, orc * w, Next16{wcs, K::KSC},
                          tap_base(sxi_s), tx,
                          put(0, Bias16<MID>(bs2 + 2 * MID)));
      const bool last = ro0 + orows >= r0 + rv;
      const Next16 nx = !last ? Next16{w1s, K::KS1S}
                              : Next16{nblk ? wspan : nullptr, K::KS1};
      gemm16<MID, K::KSC>(ring, cur, wcs, orc * w, nx, tap_base(syi_s),
                          tx, put(MID, Bias16<MID>(bs2 + MID)));
    }
    __syncthreads();                         // XI and YI are done with
  } else {
    // ---- the band (and with halo 2 the rows above and below) into X,
    //      logical channel inv[s] in slot s; four items (a pixel's 8
    //      channels, 2-byte loads: 4-byte pixel pairs read slower at 44²)
    //      a thread in flight
    const bf16* xb = x + (size_t)blockIdx.y * C * plane;
    const int nq = (rv + (halo == 2 ? 2 : 0)) * w;
    for (int it0 = tid; it0 < nq * (C / 8); it0 += 4 * kThreads16) {
      alignas(16) bf16 e[4][8];
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        const int it = it0 + u * kThreads16;
        const int gs = it / nq, q = it - gs * nq;
        const long off = (long)xr0 * w + q;
        const bool ok = it < nq * (C / 8) && off >= 0 && off < (long)plane;
#pragma unroll
        for (int k = 0; k < 8; ++k)
          e[u][k] = ok ? xb[inv[8 * gs + k] * plane + off]
                       : __float2bfloat16(0.f);
      }
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        const int it = it0 + u * kThreads16;
        const int gs = it / nq, q = it - gs * nq;
        if (it < nq * (C / 8))
          *reinterpret_cast<uint4*>(sx + q * PSX + 8 * gs) =
              *reinterpret_cast<const uint4*>(e[u]);
      }
    }
  }

  if (nblk > 0) {
    // Y: zero (the halo rows at the image's edges, the zero columns)
    const int rowb = (w + 2) * PSY * 2;
    for (int i = 16 * tid; i < (rows + 2) * rowb; i += 16 * kThreads16)
      *reinterpret_cast<uint4*>(sm + L.u + i) = zero4;
    const bool has_above = halo == 1 && r0 > 0;
    const bool has_below = halo == 1 && r0 + rv < h;
    const int rank = blockIdx.x;             // cluster dims (n, 1, 1)
    const TapAddr16<MID> ty{(uint32_t)rowb, PSY * 2, zero};
    const uint16_t* wk = wspan;
    const float* bk = bspan;
    for (int k = 0; k < nblk; ++k, wk += K::ELEMS, bk += C) {
      const short* lcur = lmap + (k & 1) * C;
      short* lnxt = lmap + ((k + 1) & 1) * C;
      if (halo == 1 && k > 0) cluster_wait();   // the neighbours read Y
      // 1. pw1 + ReLU over all C slots: X -> Y's rows (0 off the image)
      const Bias16<MID> b1(bk);
      gemm16<MID, K::KS1>(
          ring, cur, wk, (rv + (halo == 2 ? 2 : 0)) * w,
          Next16{wk + C * MID, K::KSC},
          [&](int q) { return sx_s + q * PSX * 2; }, RowAddr16<C>{zero},
          [&](int q, int o0, const float (&v)[K::NTW][4], int r) {
            const int i = q / w, c = q - i * w;
            const bool live = xr0 + i >= 0 && xr0 + i < h;
            bf16* dst = sy + ((i + yrow0) * (w + 2) + c + 1) * PSY;
#pragma unroll
            for (int n = 0; n < K::NTW; ++n) {
              const int o = o0 + 8 * n;
              __nv_bfloat162 t = relu_bias16(v[n][2 * r], v[n][2 * r + 1],
                                             b1.v[n]);
              if (!live) t = __floats2bfloat162_rn(0.f, 0.f);
              *reinterpret_cast<__nv_bfloat162*>(dst + o) = t;
            }
          });
      if (tid < C)                           // P_{k+1}
        lnxt[tid] = tid < MID ? lcur[2 * tid] : lcur[2 * (tid - MID) + 1];
      if (halo == 1) {
        // 2. the neighbours' edge rows of pw1's output -> Y's rows 0, rv+1
        cluster_arrive();
        cluster_wait();
        for (int i = 16 * tid; i < rowb; i += 16 * kThreads16) {
          if (has_above) {
            const unsigned char* peer =
                cg::this_cluster().map_shared_rank(sm, rank - 1);
            *reinterpret_cast<uint4*>(sm + L.u + i) =
                *reinterpret_cast<const uint4*>(peer + L.u + rows * rowb + i);
          }
          if (has_below) {
            const unsigned char* peer =
                cg::this_cluster().map_shared_rank(sm, rank + 1);
            *reinterpret_cast<uint4*>(sm + L.u + (rv + 1) * rowb + i) =
                *reinterpret_cast<const uint4*>(peer + L.u + rowb + i);
          }
        }
        cluster_arrive();                    // done reading the neighbours
      }
      // 3. z = bf16(ReLU(Wc . taps(Y) + bc)) -> the slots of pw1's inputs,
      //    z_o in slot P_k(2o + 1)
      const Bias16<MID> bc(bk + MID);
      short2 zslot[K::NTW];
#pragma unroll
      for (int n = 0; n < K::NTW; ++n) {
        const int o = lane_col0<MID>() + 8 * n;
        zslot[n] = make_short2(lcur[2 * o + 1], lcur[2 * o + 3]);
      }
      gemm16<MID, K::KSC>(
          ring, cur, wk + C * MID, rv * w,
          Next16{k + 1 < nblk ? wk + K::ELEMS : nullptr, K::KS1},
          [&](int p) {
            const int i = p / w, c = p - i * w;
            return sy_s + (i * (w + 2) + c) * PSY * 2;
          },
          ty,
          [&](int p, int, const float (&v)[K::NTW][4], int r) {
            bf16* px = sx + (p + xoff) * PSX;
#pragma unroll
            for (int n = 0; n < K::NTW; ++n) {
              const __nv_bfloat162 t =
                  relu_bias16(v[n][2 * r], v[n][2 * r + 1], bc.v[n]);
              px[zslot[n].x] = t.x;
              px[zslot[n].y] = t.y;
            }
          });
    }
    if (halo == 1) cluster_wait();           // the neighbours are done
  }
  __syncthreads();

  // ---- the band of every logical channel, written once
  const short* lfin = lmap + (nblk & 1) * C;
  if (tid < C) inv[lfin[tid]] = (short)tid;
  __syncthreads();
  bf16* yb = y + (size_t)blockIdx.y * C * plane + (size_t)r0 * w;
  const int nq = rv * w;
  const bool pairs = plane % 2 == 0 && (r0 * w) % 2 == 0;
  const int np = pairs ? (nq + 1) / 2 : nq;         // items a group
  for (int it = tid; it < np * (C / 8); it += kThreads16) {
    const int gs = it / np, q = (it - gs * np) << (pairs ? 1 : 0);
    const bool two = pairs && q + 1 < nq;
    alignas(16) bf16 e[2][8];
    *reinterpret_cast<uint4*>(e[0]) =
        *reinterpret_cast<const uint4*>(sx + (q + xoff) * PSX + 8 * gs);
    if (two)
      *reinterpret_cast<uint4*>(e[1]) = *reinterpret_cast<const uint4*>(
          sx + (q + 1 + xoff) * PSX + 8 * gs);
#pragma unroll
    for (int k = 0; k < 8; ++k) {
      bf16* dst = yb + inv[8 * gs + k] * plane + q;
      if (two)
        *reinterpret_cast<__nv_bfloat162*>(dst) = __halves2bfloat162(
            e[0][k], e[1][k]);
      else
        dst[0] = e[0][k];
    }
  }
}

template <int MID, bool S2>
int launch_stage16(const __nv_bfloat16* x, __nv_bfloat16* y,
                   const uint16_t* wspan, const float* bspan,
                   const uint16_t* ws2, const float* bs2, int b, int hin,
                   int win, int h, int w, int rows, int cluster, int nblk,
                   int halo, int k0, int orows, cudaStream_t stream) {
  if (rows < 1 || cluster < 1 || cluster > 8 || (S2 && orows < 1))
    return (int)cudaErrorInvalidValue;
  const size_t smem =
      (size_t)span16_layout(MID, rows, w, halo, S2, win, orows).bytes;
  cudaError_t err = cudaFuncSetAttribute(
      span16_stage_kernel<MID, S2>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const int bands = (h + rows - 1) / rows;
  if (bands % cluster) return (int)cudaErrorInvalidValue;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(bands, b, 1);
  cfg.blockDim = dim3(kThreads16, 1, 1);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = cluster;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  err = cudaLaunchKernelEx(&cfg, span16_stage_kernel<MID, S2>, x, y, wspan,
                           bspan, ws2, bs2, hin, win, h, w, rows, nblk, halo,
                           k0, orows);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

// nblk bf16 stride-1 blocks from src (B, 2*MID, h, w) to out with the
// plan's rows and cluster: one launch ("stage"), or one launch a block
// ("per block": halo 2, ping-pong through tmp so that the last block
// writes out; src is never written).  wts: nblk rows of
// fold.span16_elems(MID) bf16; bias: nblk rows of 2*MID f32.
template <int MID>
int launch_span16(const __nv_bfloat16* src, __nv_bfloat16* out,
                  __nv_bfloat16* tmp, const uint16_t* wts, const float* bias,
                  int b, int h, int w, int nblk, int rows, int cluster,
                  int per_block, cudaStream_t stream) {
  if (nblk < 1) return (int)cudaErrorInvalidValue;
  if (!per_block)
    return launch_stage16<MID, false>(src, out, wts, bias, nullptr, nullptr,
                                      b, h, w, h, w, rows, cluster, nblk,
                                      cluster > 1 ? 1 : 0, 0, 0, stream);
  for (int k = 0; k < nblk; ++k) {
    __nv_bfloat16* dst = ((nblk - 1 - k) % 2 == 0) ? out : tmp;
    const int rc = launch_stage16<MID, false>(
        src, dst, wts + (size_t)k * Cfg16<MID>::ELEMS, bias + k * 2 * MID,
        nullptr, nullptr, b, h, w, h, w, rows, 1, 1, rows < h ? 2 : 0, k, 0,
        stream);
    if (rc) return rc;
    src = dst;
  }
  return 0;
}

// The bf16 stage: the stride-2 block as the prologue of the span's launch
// ("stage"), or alone in a launch of bands of rows_s2 rows followed by the
// span's per-block launches ("per block"; it writes tmp when nblk is odd,
// so that the last block writes out).
template <int MID>
int launch_s2span16(const __nv_bfloat16* x, __nv_bfloat16* out,
                    __nv_bfloat16* tmp, const uint16_t* w_s2,
                    const float* b_s2, const uint16_t* w_span,
                    const float* b_span, int b, int hin, int win, int nblk,
                    int rows, int rows_s2, int orows, int cluster,
                    int per_block, cudaStream_t stream) {
  const int h = (hin + 1) / 2, w = (win + 1) / 2;
  if (!per_block)
    return launch_stage16<MID, true>(x, out, w_span, b_span, w_s2, b_s2, b,
                                     hin, win, h, w, rows, cluster, nblk,
                                     (cluster > 1 && nblk > 0) ? 1 : 0, 0,
                                     orows, stream);
  __nv_bfloat16* dst = (nblk % 2 == 1) ? tmp : out;
  const int rc = launch_stage16<MID, true>(x, dst, nullptr, nullptr, w_s2,
                                           b_s2, b, hin, win, h, w, rows_s2,
                                           1, 0, 0, 0, orows, stream);
  if (rc || nblk == 0) return rc;
  return launch_span16<MID>(dst, out, tmp, w_span, b_span, b, h, w, nblk,
                            rows, 1, 1, stream);
}
}  // namespace

extern "C" {

// Shared memory (bytes) of one CTA of the stage kernel: MID channels per
// branch, a band of `rows` rows of width w, halo 0/1/2 as above, s2 for
// the stride-2 prologue.
size_t fastdet_span_stage_smem(int mid, int rows, int w, int halo, int s2) {
  return (size_t)stage_layout(mid, rows, w, halo, s2 != 0).floats *
         sizeof(float);
}

// Shared memory (bytes) of one CTA of the bf16 stage kernel: MID channels
// a branch, a band of `rows` output rows of width w, halo 0/1/2, s2 for the
// stride-2 prologue from input width win in chunks of orows output rows.
size_t fastdet_span16_smem(int mid, int rows, int w, int halo, int s2,
                           int win, int orows) {
  return (size_t)span16_layout(mid, rows, w, halo, s2, win, orows).bytes;
}

const char* fastdet_cuda_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
