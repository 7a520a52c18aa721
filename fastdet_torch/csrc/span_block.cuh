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
// cores (mma.sync m16n8k16 bf16, f32 accumulate): M = pixels, N = MID
// output channels.
//
// One launch per block: a CTA takes a band of `rows` output rows of one
// image, stages what the band needs of the block's input pixel-major in
// shared memory (a pixel's channels contiguous, so that an A register, two
// channels of one pixel at one tap, is one 4-byte load; the pixel stride
// is padded so that a warp's A loads meet 32 banks), zero on rows off the
// image:
//   stride 1: the odd channels of rows r0-1 .. r0+rv (the depthwise halo);
//             pw1 + ReLU into Y (rows off the image 0: the conv's zero
//             pad), then Wc over the 9 taps of Y into channels MID..C-1
//             of the output band; the even channels are copied across;
//   stride 2: all CIN channels of input rows 2*r0-1 .. 2*(r0+rv)-1; pw1 +
//             ReLU into Y on the input grid, then per output pixel Wc over
//             Y's and Wp over X's stride-2 taps.
// The B operand (the weights) is read from device memory through L1 in
// the lanes' fragment order (fold.mma_fragments), one 8-byte load per
// lane, k-step and n-tile, shared by the MT m-tiles a warp takes at once.
// Rounding points are the JAX package's: the f32 bias is added to the f32
// accumulator, then ReLU, then one rounding to bf16.

constexpr int kThreads16 = 256;
constexpr int kWarps16 = kThreads16 / 32;
constexpr int kMTiles16 = 2;       // m-tiles of 16 pixels a warp at once

__host__ __device__ constexpr int pad16(int n) { return (n + 15) & ~15; }

// bf16 elements between two pixels of a pixel-major buffer of `mid`
// channels: 2 * words with words = 4 modulo 8 (8 pixels x 4 pairs of a
// warp's A load fall in distinct banks)
__host__ __device__ constexpr int px_stride16(int mid) {
  return 2 * (mid / 2 + ((12 - (mid / 2) % 8) % 8));
}

// Shared memory (bytes) of one CTA: X and Y, each `npix` pixels of
// px_stride16(mid) bf16: rows + 2 rows of w (stride 1) or 2*rows + 1 rows
// of win (stride 2)
__host__ __device__ inline size_t span16_smem_bytes(int mid, int rows, int w,
                                                    int s2, int win) {
  const size_t npix =
      s2 ? (size_t)(2 * rows + 1) * win : (size_t)(rows + 2) * w;
  return 2 * npix * px_stride16(mid) * sizeof(__nv_bfloat16);
}

__device__ __forceinline__ unsigned char* dyn_smem16() {
  extern __shared__ uint4 smem_u4[];
  return reinterpret_cast<unsigned char*>(smem_u4);
}

__device__ __forceinline__ void mma_bf16_16816(float (&d)[4],
                                               const uint32_t (&a)[4],
                                               uint2 b) {
  asm("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b.x), "r"(b.y));
}

// acc[mt][n] += A . B over K = KTOT (padded to 16 with zero A), for the
// warp's kMTiles16 m-tiles: a_pair(mt, r, k) is the lane's A register of
// m-tile mt, row g + 8r, columns k and k+1 (two bf16, lo = k); frag is the
// B operand in fold.mma_fragments order.
template <int MID, int KTOT, class APair>
__device__ __forceinline__ void gemm16(float (&acc)[kMTiles16][MID / 8][4],
                                       const uint2* __restrict__ frag,
                                       APair a_pair) {
  constexpr int KS = pad16(KTOT) / 16;
  constexpr int NT = MID / 8;
  const int lane = threadIdx.x & 31, tig = lane & 3;
#pragma unroll 2
  for (int s = 0; s < KS; ++s) {
    uint32_t a[kMTiles16][4];
#pragma unroll
    for (int mt = 0; mt < kMTiles16; ++mt)
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const int k = 16 * s + 8 * half + 2 * tig;
        const bool in = (KTOT % 16 == 0) || k < KTOT;
        a[mt][2 * half] = in ? a_pair(mt, 0, k) : 0u;
        a[mt][2 * half + 1] = in ? a_pair(mt, 1, k) : 0u;
      }
#pragma unroll
    for (int n = 0; n < NT; ++n) {
      const uint2 b = __ldg(frag + (s * NT + n) * 32 + lane);
#pragma unroll
      for (int mt = 0; mt < kMTiles16; ++mt)
        mma_bf16_16816(acc[mt][n], a[mt], b);
    }
  }
}

template <int MID>
__device__ __forceinline__ void zero_acc(float (&acc)[kMTiles16][MID / 8][4]) {
#pragma unroll
  for (int mt = 0; mt < kMTiles16; ++mt)
#pragma unroll
    for (int n = 0; n < MID / 8; ++n)
#pragma unroll
      for (int q = 0; q < 4; ++q) acc[mt][n][q] = 0.f;
}

__device__ __forceinline__ uint32_t bf16_pair_bits(__nv_bfloat16 lo,
                                                   __nv_bfloat16 hi) {
  return (uint32_t)__bfloat16_as_ushort(lo)
         | ((uint32_t)__bfloat16_as_ushort(hi) << 16);
}

// The epilogue: out(pixel, o) = bf16(ReLU(acc + bias[o])) for the lane's
// pixels m < npix (channels 8n + 2*tig + {0, 1}), handed to
// put(pixel, o, pair) with the pair of channels o, o+1.
template <int MID, class Put>
__device__ __forceinline__ void epilogue16(
    const float (&acc)[kMTiles16][MID / 8][4], const float* __restrict__ bias,
    int m0, int npix, Put put) {
  const int lane = threadIdx.x & 31, g = lane >> 2, tig = lane & 3;
#pragma unroll
  for (int n = 0; n < MID / 8; ++n) {
    const int o = 8 * n + 2 * tig;
    const float b0 = __ldg(bias + o), b1 = __ldg(bias + o + 1);
#pragma unroll
    for (int mt = 0; mt < kMTiles16; ++mt)
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const int m = (m0 + mt) * 16 + g + 8 * r;
        if (m >= npix) continue;
        put(m, o, __floats2bfloat162_rn(fmaxf(acc[mt][n][2 * r] + b0, 0.f),
                                        fmaxf(acc[mt][n][2 * r + 1] + b1,
                                              0.f)));
      }
  }
}

// pw1 + ReLU over `npix` staged pixels: Y[m] = bf16(ReLU(W1 . X[m] + b1)),
// 0 where !live(m) (rows off the image: the depthwise conv's zero pad).
template <int MID, int KIN, class Live>
__device__ __forceinline__ void pw1_16(const __nv_bfloat16* sx,
                                       __nv_bfloat16* sy, int npix,
                                       const uint2* __restrict__ w1,
                                       const float* __restrict__ b1,
                                       Live live) {
  constexpr int PS = px_stride16(MID);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2;
  const int mtiles = (npix + 15) / 16;
  for (int m0 = warp * kMTiles16; m0 < mtiles; m0 += kWarps16 * kMTiles16) {
    float acc[kMTiles16][MID / 8][4];
    zero_acc<MID>(acc);
    int q[kMTiles16][2];
#pragma unroll
    for (int mt = 0; mt < kMTiles16; ++mt)
#pragma unroll
      for (int r = 0; r < 2; ++r)
        q[mt][r] = min((m0 + mt) * 16 + g + 8 * r, npix - 1) * PS;
    gemm16<MID, KIN>(acc, w1, [&](int mt, int r, int k) {
      return *reinterpret_cast<const uint32_t*>(sx + q[mt][r] + k);
    });
    epilogue16<MID>(acc, b1, m0, npix,
                    [&](int m, int o, __nv_bfloat162 v) {
                      if (!live(m)) v = __floats2bfloat162_rn(0.f, 0.f);
                      *reinterpret_cast<__nv_bfloat162*>(sy + m * PS + o) = v;
                    });
  }
}

// One stride-1 block of the bf16 span: x (B, 2*MID, h, w) bf16 -> y, one
// CTA per (band of `rows` rows, image).  wts: [pw1 | Wc] fragments, bias
// [b1 | bc] f32.
template <int MID>
__global__ void __launch_bounds__(kThreads16)
span_bf16_kernel(const __nv_bfloat16* __restrict__ x,
                 __nv_bfloat16* __restrict__ y, const uint2* __restrict__ wts,
                 const float* __restrict__ bias, int h, int w, int rows) {
  constexpr int C = 2 * MID, PS = px_stride16(MID);
  const int r0 = blockIdx.x * rows, rv = min(rows, h - r0);
  const int npix = (rv + 2) * w;            // staged rows r0-1 .. r0+rv
  const size_t plane = (size_t)h * w;
  const __nv_bfloat16* xb = x + (size_t)blockIdx.y * C * plane;
  __nv_bfloat16* yb = y + (size_t)blockIdx.y * C * plane;
  __nv_bfloat16* sx = reinterpret_cast<__nv_bfloat16*>(dyn_smem16());
  __nv_bfloat16* sy = sx + (size_t)npix * PS;
  const int tid = threadIdx.x;

  // 1. the odd channels pixel-major (pairs of odd channels 4jp+1, 4jp+3),
  //    0 off the image; the even channels across (the passthrough)
  for (int it = tid; it < (MID / 2) * npix; it += kThreads16) {
    const int jp = it / npix, q = it - jp * npix;
    const int gy = r0 - 1 + q / w;
    uint32_t v = 0;
    if (gy >= 0 && gy < h) {
      const size_t off = (size_t)gy * w + q % w;
      v = bf16_pair_bits(xb[(4 * jp + 1) * plane + off],
                         xb[(4 * jp + 3) * plane + off]);
    }
    *reinterpret_cast<uint32_t*>(sx + q * PS + 2 * jp) = v;
  }
  const int nout = rv * w;
  for (int it = tid; it < MID * nout; it += kThreads16) {
    const int j = it / nout, p = it - j * nout;
    yb[j * plane + (size_t)r0 * w + p] = xb[2 * j * plane + (size_t)r0 * w + p];
  }
  __syncthreads();

  // 2. pw1 + ReLU -> Y
  pw1_16<MID, MID>(sx, sy, npix, wts, bias, [&](int m) {
    const int gy = r0 - 1 + m / w;
    return gy >= 0 && gy < h;
  });
  __syncthreads();

  // 3. z = bf16(ReLU(Wc . taps(Y) + bc)) -> channels MID..C-1
  const uint2* wc = wts + pad16(MID) * MID / 4;
  const int warp = tid >> 5, lane = tid & 31, g = lane >> 2;
  const int mtiles = (nout + 15) / 16;
  for (int m0 = warp * kMTiles16; m0 < mtiles; m0 += kWarps16 * kMTiles16) {
    float acc[kMTiles16][MID / 8][4];
    zero_acc<MID>(acc);
    int base[kMTiles16][2], cl[kMTiles16][2], cr[kMTiles16][2];
#pragma unroll
    for (int mt = 0; mt < kMTiles16; ++mt)
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const int p = min((m0 + mt) * 16 + g + 8 * r, nout - 1);
        const int col = p % w;
        base[mt][r] = p + w;                // staged pixel of the centre tap
        cl[mt][r] = col > 0;
        cr[mt][r] = col + 1 < w;
      }
    gemm16<MID, 9 * MID>(acc, wc, [&](int mt, int r, int k) -> uint32_t {
      const int t = k / MID, c = k - t * MID;
      const int dy = t / 3 - 1, dx = t - 3 * (t / 3) - 1;
      if ((dx < 0 && !cl[mt][r]) || (dx > 0 && !cr[mt][r])) return 0u;
      return *reinterpret_cast<const uint32_t*>(
          sy + (base[mt][r] + dy * w + dx) * PS + c);
    });
    epilogue16<MID>(acc, bias + MID, m0, nout,
                    [&](int m, int o, __nv_bfloat162 v) {
                      __nv_bfloat16* dst =
                          yb + (size_t)(MID + o) * plane + (size_t)r0 * w + m;
                      dst[0] = v.x;
                      dst[plane] = v.y;
                    });
  }
}

// The bf16 stride-2 block: x (B, MID, hin, win) bf16 -> y (B, 2*MID, h, w)
// = concat[proj, main], one CTA per (band of `rows` output rows, image).
// wts: [pw1 | Wc | Wp] fragments, bias [b1 | bc | bp] f32.
template <int MID>
__global__ void __launch_bounds__(kThreads16)
s2_bf16_kernel(const __nv_bfloat16* __restrict__ x,
               __nv_bfloat16* __restrict__ y, const uint2* __restrict__ wts,
               const float* __restrict__ bias, int hin, int win, int h, int w,
               int rows) {
  constexpr int CIN = MID, PS = px_stride16(MID);
  const int r0 = blockIdx.x * rows, rv = min(rows, h - r0);
  const int iy0 = 2 * r0 - 1;
  const int npix = (2 * rv + 1) * win;      // input rows iy0 .. iy0 + 2rv
  const size_t in_plane = (size_t)hin * win, plane = (size_t)h * w;
  const __nv_bfloat16* xb = x + (size_t)blockIdx.y * CIN * in_plane;
  __nv_bfloat16* yb = y + (size_t)blockIdx.y * 2 * MID * plane;
  __nv_bfloat16* sx = reinterpret_cast<__nv_bfloat16*>(dyn_smem16());
  __nv_bfloat16* sy = sx + (size_t)npix * PS;
  const int tid = threadIdx.x;

  // 1. the input rows pixel-major, 0 off the image
  for (int it = tid; it < (CIN / 2) * npix; it += kThreads16) {
    const int cp = it / npix, q = it - cp * npix;
    const int iy = iy0 + q / win;
    uint32_t v = 0;
    if (iy >= 0 && iy < hin) {
      const size_t off = (size_t)iy * win + q % win;
      v = bf16_pair_bits(xb[2 * cp * in_plane + off],
                         xb[(2 * cp + 1) * in_plane + off]);
    }
    *reinterpret_cast<uint32_t*>(sx + q * PS + 2 * cp) = v;
  }
  __syncthreads();

  // 2. pw1 + ReLU on the input grid -> Y
  pw1_16<MID, CIN>(sx, sy, npix, wts, bias, [&](int m) {
    const int iy = iy0 + m / win;
    return iy >= 0 && iy < hin;
  });
  __syncthreads();

  // 3. per output pixel: main = Wc over Y's stride-2 taps, projection =
  //    Wp over X's
  const uint2* wc = wts + pad16(CIN) * MID / 4;
  const uint2* wp = wc + pad16(9 * MID) * MID / 4;
  const int nout = rv * w;
  const int warp = tid >> 5, lane = tid & 31, g = lane >> 2;
  const int mtiles = (nout + 15) / 16;
  for (int m0 = warp * kMTiles16; m0 < mtiles; m0 += kWarps16 * kMTiles16) {
    int base[kMTiles16][2], cl[kMTiles16][2], cr[kMTiles16][2];
#pragma unroll
    for (int mt = 0; mt < kMTiles16; ++mt)
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const int p = min((m0 + mt) * 16 + g + 8 * r, nout - 1);
        const int row = p / w, col = p - (p / w) * w;
        base[mt][r] = (2 * row + 1) * win + 2 * col;   // the centre tap
        cl[mt][r] = col > 0;
        cr[mt][r] = 2 * col + 1 < win;
      }
    for (int branch = 0; branch < 2; ++branch) {
      const __nv_bfloat16* src = branch ? sy : sx;
      float acc[kMTiles16][MID / 8][4];
      zero_acc<MID>(acc);
      auto a_pair = [&](int mt, int r, int k) -> uint32_t {
        const int t = k / MID, c = k - t * MID;
        const int dy = t / 3 - 1, dx = t - 3 * (t / 3) - 1;
        if ((dx < 0 && !cl[mt][r]) || (dx > 0 && !cr[mt][r])) return 0u;
        return *reinterpret_cast<const uint32_t*>(
            src + (base[mt][r] + dy * win + dx) * PS + c);
      };
      gemm16<MID, 9 * MID>(acc, branch ? wc : wp, a_pair);
      epilogue16<MID>(acc, bias + (branch ? MID : 2 * MID), m0, nout,
                      [&](int m, int o, __nv_bfloat162 v) {
                        __nv_bfloat16* dst = yb
                            + (size_t)(branch * MID + o) * plane
                            + (size_t)r0 * w + m;
                        dst[0] = v.x;
                        dst[plane] = v.y;
                      });
    }
  }
}

template <class Kernel>
int set_smem16(Kernel kernel, size_t smem) {
  const cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  return (int)err;
}

// nblk bf16 stride-1 blocks from src (B, 2*MID, h, w) to out, one launch a
// block over bands of `rows` rows, ping-pong through tmp so that the last
// block writes out; src is never written.  wts: nblk rows of
// fold.span16_elems(MID) bf16; bias: nblk rows of 2*MID f32.
template <int MID>
int launch_span16(const __nv_bfloat16* src, __nv_bfloat16* out,
                  __nv_bfloat16* tmp, const uint16_t* wts, const float* bias,
                  int b, int h, int w, int nblk, int rows,
                  cudaStream_t stream) {
  if (rows < 1 || nblk < 1) return (int)cudaErrorInvalidValue;
  const size_t smem = span16_smem_bytes(MID, rows, w, 0, 0);
  int err = set_smem16(span_bf16_kernel<MID>, smem);
  if (err) return err;
  constexpr size_t kElems = (size_t)(pad16(MID) + pad16(9 * MID)) * MID;
  const dim3 grid((h + rows - 1) / rows, b);
  for (int k = 0; k < nblk; ++k) {
    __nv_bfloat16* dst = ((nblk - 1 - k) % 2 == 0) ? out : tmp;
    span_bf16_kernel<MID><<<grid, kThreads16, smem, stream>>>(
        src, dst, reinterpret_cast<const uint2*>(wts + k * kElems),
        bias + (size_t)k * 2 * MID, h, w, rows);
    err = (int)cudaGetLastError();
    if (err) return err;
    src = dst;
  }
  return 0;
}

// The bf16 stride-2 block (one launch, bands of rows_s2 rows), then nblk
// stride-1 blocks (launch_span16); the stride-2 block writes tmp when nblk
// is odd, so that the last block writes out.
template <int MID>
int launch_s2span16(const __nv_bfloat16* x, __nv_bfloat16* out,
                    __nv_bfloat16* tmp, const uint16_t* w_s2,
                    const float* b_s2, const uint16_t* w_span,
                    const float* b_span, int b, int hin, int win, int nblk,
                    int rows_s2, int rows, cudaStream_t stream) {
  const int h = (hin + 1) / 2, w = (win + 1) / 2;
  if (rows_s2 < 1 || nblk < 0) return (int)cudaErrorInvalidValue;
  const size_t smem = span16_smem_bytes(MID, rows_s2, w, 1, win);
  int err = set_smem16(s2_bf16_kernel<MID>, smem);
  if (err) return err;
  __nv_bfloat16* dst = (nblk % 2 == 1) ? tmp : out;
  s2_bf16_kernel<MID><<<dim3((h + rows_s2 - 1) / rows_s2, b), kThreads16,
                        smem, stream>>>(
      x, dst, reinterpret_cast<const uint2*>(w_s2), b_s2, hin, win, h, w,
      rows_s2);
  err = (int)cudaGetLastError();
  if (err || nblk == 0) return err;
  return launch_span16<MID>(dst, out, tmp, w_span, b_span, b, h, w, nblk,
                            rows, stream);
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

// Shared memory (bytes) of one CTA of the bf16 stage kernels: a band of
// `rows` output rows of width w at MID channels, s2 for the stride-2 block
// (input width win).
size_t fastdet_span16_smem(int mid, int rows, int w, int s2, int win) {
  return span16_smem_bytes(mid, rows, w, s2, win);
}

const char* fastdet_cuda_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
