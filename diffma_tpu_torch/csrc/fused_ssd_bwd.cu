// Whole Mamba-2 (SSD) mixer backward for Hopper (sm_90a), for one or two
// mixers (the Spiral block's two branches) in one call.
//
// Replaces the TPU kernel diffma_tpu/ops/fused_ssd.py::_ssd_bwd_kernel, as
// its launcher _launch_bwd drives it (the custom VJPs of mamba2_mixer_fused
// and mamba2_dual_mixer_fused). Given x and g = dL/dout (B, L, h) per branch,
// the mixer's 8 weights (torch layout) and the residual that kernel E wrote,
// zx = in_proj(x) in token order with columns [z (d) | x (d) | B (n) | C (n) |
// dt (H)], it writes gx (B, L, h) and the 8 weight gradients summed over the
// batch, all fp32. Per stream s (token order fwd[s]) the forward was
//
//     [X | Bs | Cs] = silu(a),  a = causal_conv_K(zx[fwd[s], d : 2d + 2n]) + conv_b
//     dt = clip(softplus(p), lo, hi),  p = zx[fwd[s], dt columns] + dt_bias
//     cs = cumsum_t(dt A),  A = -exp(A_log);   xdt = X dt (per head)
//     M[t, u] = (Cs_t . Bs_u) exp(cs_t - cs_u)  for u <= t, per head
//     y_pre = M xdt;   y = y_pre + D X;   y_s = y back in token order
//     yg = y_s silu(z);  rms = rsqrt(mean_d(yg^2) + eps);  n_s = yg rms norm_w
//     merged = scale sum_s n_s;   out = merged W_out^T
//
// and the backward is
//
//     gm = g W_out;  g_n = scale gm (the same for every stream);  gW_out = g^T merged
//     gw = g_n norm_w;  g_yg = gw rms - rms^3 / d <gw, yg> yg;  g_norm_w = sum g_n yg rms
//     g_z = sum_s g_yg y_s silu'(z);   g_y = (g_yg silu(z))[fwd[s]]
//     g_D[head] = sum <g_y, X>_head
//     g_xdt = M^T g_y;   W = (g_y xdt^T) o exp(cs_t - cs_u)  (u <= t)
//     g_C = sum_heads W Bs;   g_B = sum_heads W^T Cs
//     P = W o (Cs Bs^T);  g_cs[t] = sum_{u < t} P[t, u] - sum_{t' > t} P[t', t]
//     g_dA = reverse cumsum of g_cs
//     g_dt = <X, g_xdt>_head + g_dA A;   gA = sum g_dA dt;   g_A_log = gA A
//     g_p = g_dt [lo <= softplus(p) <= hi] sigmoid(p);   g_dt_bias = sum g_p
//     g_X = D g_y + dt g_xdt;   g_a = [g_X | g_B | g_C] silu'(a)
//     g_conv_b = sum g_a;  g_conv_w[k] = sum g_a[t] in[t - K + 1 + k];  the conv's
//     input adjoint, taps never crossing a stream's start, back in token order
//     and summed over the streams: g_zx
//     gx = g_zx W_in;   gW_in = g_zx^T x
//
// Every product is this file's own fp32 code on the CUDA cores (no cuBLAS, no
// TF32). The decay is the quadratic form at every span, with the causal mask
// a selection, never a product: above the diagonal cs_t - cs_u is positive,
// exp would overflow at wide spans, and inf * 0 is NaN. g_cs is a row sum
// less a column sum of P; with the diagonal included they are the TPU
// kernel's two inner products, <g_y, y_pre> and <xdt, g_xdt>, whose diagonal
// terms are equal and cancel. At a wide span the diagonal is all there is
// (the decay kills the rest), so the difference of the inner products is
// rounding noise as large as the gradient. Here both sums leave the diagonal
// out, exactly. And since gA = sum_t dt_t g_dA[t] weighs g_cs[t] with the
// whole cumulative dt up to t, while each P[t, u] truly counts only with the
// dt between u and t, the rounding of the two sums is magnified by the
// sequence's length: so they, their difference and its reverse cumsum run
// in fp64, as the forward's cs does; and the adjoint takes cs_t - cs_u from
// the fp64 cs, before the rounding that the forward's product can afford.
//
// Bound on an H100 SXM (67 TFLOP/s fp32 outside the tensor cores,
// 3.35 TB/s). At DiffMa's training shapes, batch 8, both branches (B = 8,
// L = 196, h = 512, d = 1024, H = 16, n = 16, S = 3), one call does about
// 27 GFLOP: four GEMMs over the 1568 token rows, 20 GFLOP; per stream and
// head the causal halves of y_pre, M^T g_y and g_y xdt^T, 5.7 GFLOP; the
// rest elementwise. That is 0.40 ms at the fp32 rate, against about 70 MB of
// x, g, the residual, weights and gradients, 0.02 ms. So operations bound it.
//
// Design, simple and right first: a chain of launches over a workspace the
// caller allocates (ssd_mixer_bwd_workspace_floats; about 200 MB at the
// shapes above), with the branch on blockIdx.z (or a grid axis) in every
// launch, so both branches share each launch and their gradients never mix.
// 1. gm = g W_out, a GEMM (gemm_ops.cuh).
// 2. y per stream in token order: kernel E's own SSD kernel (ssd_core.cuh).
// 3. the gate + RMSNorm adjoint: one block per (branch, token row), which
//    holds the whole d-wide row; writes g_yg silu(z) per stream, g_z summed
//    in stream order into g_zx, merged, and the row's g_norm_w terms.
// 4. the SSD adjoint: one block of 256 threads per (branch, b, stream,
//    head). It stages the head as the forward does, gathers g_y into stream
//    order, and walks tiles of 32 columns u: lane u of each warp keeps
//    xdt[u, :] and Bs[u, :] in registers and builds, for its rows t >= u0,
//    M[t, u] and W[t, u] in shared memory; then g_xdt's 32 x 64 tile is
//    M^T g_y with a 2 x 4 register tile per thread, g_C accumulates W Bs in
//    shared memory and g_B = W^T Cs goes out; the warps' row and column sums
//    of P build g_cs on the way. What crosses heads is each head's own
//    (L, 16) g_B and g_C, never an L x L matrix. The reverse cumsum of g_cs,
//    g_dt, the clip and softplus adjoints and the head's sums for g_A_log,
//    g_D and g_dt_bias end the block.
// 5. g_a: the heads' g_B and g_C summed in head order, times silu'(a) with a
//    recomputed from zx; then g_zx's conv and dt columns by a gather-sum
//    through the merge table (each stream is a permutation: no atomics),
//    and g_conv_w, g_conv_b by column sums over row splits.
// 6. gx = g_zx W_in, gW_in = g_zx^T x, gW_out = g^T merged: GEMMs whose
//    reduction runs over all B * L rows.
// 7. a pass that sums every partial in a fixed order. Nothing uses atomics
//    and every output element is written, never accumulated into, so two
//    calls give the same bits and nothing is left over from the last call.
// The TPU kernel's one-hot permutation and head-fold matmuls, its
// tril-matmul cumsums, its 8-row padding of L and its accumulation across a
// sequential grid exist for the MXU and VMEM; here they are index gathers,
// sums over a head's 64 channels, warp scans, exact t < L and second passes.
//
// Partition specs, several B/C groups, bf16 and the factored decay form are
// not built: the wrapper raises for the first three, and the last is a
// design for a later change.

#include <cuda_runtime.h>
#include <stdint.h>

#include "gemm_ops.cuh"
#include "ssd_core.cuh"

namespace {

using ssd::block_sum;
using ssd::dsilu;
using ssd::kBStride;
using ssd::kConv;
using ssd::kHd;
using ssd::kMaxSharedBytes;
using ssd::kMaxStreams;
using ssd::kN;
using ssd::kThreads;
using ssd::kTile;
using ssd::sigmoid;
using ssd::softplus;

constexpr int kBranchPtrs = 19;   // x, g, 8 weights, gx, 8 gradients
constexpr int kRowThreads = 256;  // the gate + norm adjoint
constexpr int kMaxPerThread = 8;  // so d <= 2048
constexpr int kSplits = 16;       // row splits of the column sums
constexpr int kHeadParts = 3;     // per (sequence, head): gA, g_D, g_dt_bias
constexpr int kXStride = kHd + 1;  // X rows padded: lanes read different rows
constexpr int kTStride = kTile + 1;  // M and W tiles, (rows, 32 columns)

struct Branch {
  const float* x;        // (B, L, h)
  const float* g;        // (B, L, h)
  const float* in_w;     // (2d + 2n + H, h)
  const float* conv_w;   // (d + 2n, K)
  const float* conv_b;   // (d + 2n,)
  const float* dt_bias;  // (H,)
  const float* A_log;    // (H,)
  const float* D;        // (H,)
  const float* norm_w;   // (d,)
  const float* out_w;    // (h, d)
  float* gx;             // (B, L, h)
  float* g_in_w;         // the gradients, each shaped as its weight
  float* g_conv_w;
  float* g_conv_b;
  float* g_dt_bias;
  float* g_A_log;
  float* g_D;
  float* g_norm_w;
  float* g_out_w;
};

// Workspace arrays hold both branches, branch m at offset m * (its size).
// T = B * L token rows; R = B * S * L stream rows, row (b * S + s) * L + t in
// stream order or (b * S + s) * L + token in token order.
struct Params {
  Branch br[2];
  const int64_t* fwd;    // (S, L): stream s visits tokens fwd[s, 0..L-1]
  const int64_t* merge;  // (L, S): the stream rows s * L + position of token l
  const float* zx;       // (M, T, dproj): kernel E's residual
  float* gm;             // (T, d): g W_out
  float* y;              // (R, d) token order: the SSD output before the gate
  float* gy;             // (R, d) token order: its adjoint
  float* merged;         // (T, d)
  float* gnw;            // (T, d): the row's g_norm_w terms
  float* gzx;            // (T, dproj)
  float* gxbc;           // (R, d + 2n) stream order: g_X, then g_a
  float* graw;           // (R, H) stream order: g_p
  float* gbc;            // (R, H, 2n) stream order: each head's g_B, g_C
  float* part_head;      // (B * S, H, kHeadParts)
  float* part_conv;      // (kSplits, d + 2n, K + 1): g_conv_w (K), g_conv_b
  float* part_nw;        // (kSplits, d)
  int B, L, h, d, H, S, dproj, conv_dim;
  float scale, eps, dt_lo, dt_hi;
};

__device__ __forceinline__ size_t tokens(const Params& p) { return static_cast<size_t>(p.B) * p.L; }
__device__ __forceinline__ size_t srows(const Params& p) { return tokens(p) * p.S; }

struct GradOutProj {  // gm = g W_out
  static constexpr bool kAByRow = false, kBByRow = true;
  const float *g, *w;
  float* c;
  int rows, cols, depth;
  __device__ GradOutProj(const Params& p, int m)
      : g(p.br[m].g), w(p.br[m].out_w), c(p.gm + m * tokens(p) * p.d),
        rows(static_cast<int>(tokens(p))), cols(p.d), depth(p.h) {}
  __device__ float a(int row, int k) const { return g[static_cast<size_t>(row) * depth + k]; }
  __device__ float b(int col, int k) const { return w[static_cast<size_t>(k) * cols + col]; }
  __device__ void store(int row, int col, int, float v) const { c[static_cast<size_t>(row) * cols + col] = v; }
};

struct GradX {  // gx = g_zx W_in
  static constexpr bool kAByRow = false, kBByRow = true;
  const float *gzx, *w;
  float* c;
  int rows, cols, depth;
  __device__ GradX(const Params& p, int m)
      : gzx(p.gzx + m * tokens(p) * p.dproj), w(p.br[m].in_w), c(p.br[m].gx),
        rows(static_cast<int>(tokens(p))), cols(p.h), depth(p.dproj) {}
  __device__ float a(int row, int k) const { return gzx[static_cast<size_t>(row) * depth + k]; }
  __device__ float b(int col, int k) const { return w[static_cast<size_t>(k) * cols + col]; }
  __device__ void store(int row, int col, int, float v) const { c[static_cast<size_t>(row) * cols + col] = v; }
};

struct GradInW {  // gW_in = g_zx^T x
  static constexpr bool kAByRow = true, kBByRow = true;
  const float *gzx, *x;
  float* c;
  int rows, cols, depth;
  __device__ GradInW(const Params& p, int m)
      : gzx(p.gzx + m * tokens(p) * p.dproj), x(p.br[m].x), c(p.br[m].g_in_w),
        rows(p.dproj), cols(p.h), depth(static_cast<int>(tokens(p))) {}
  __device__ float a(int row, int k) const { return gzx[static_cast<size_t>(k) * rows + row]; }
  __device__ float b(int col, int k) const { return x[static_cast<size_t>(k) * cols + col]; }
  __device__ void store(int row, int col, int, float v) const { c[static_cast<size_t>(row) * cols + col] = v; }
};

struct GradOutW {  // gW_out = g^T merged
  static constexpr bool kAByRow = true, kBByRow = true;
  const float *g, *merged;
  float* c;
  int rows, cols, depth;
  __device__ GradOutW(const Params& p, int m)
      : g(p.br[m].g), merged(p.merged + m * tokens(p) * p.d), c(p.br[m].g_out_w),
        rows(p.h), cols(p.d), depth(static_cast<int>(tokens(p))) {}
  __device__ float a(int row, int k) const { return g[static_cast<size_t>(k) * rows + row]; }
  __device__ float b(int col, int k) const { return merged[static_cast<size_t>(k) * cols + col]; }
  __device__ void store(int row, int col, int, float v) const { c[static_cast<size_t>(row) * cols + col] = v; }
};

// 3. The gate + RMSNorm adjoint of one token row. grid (B * L, M).
__global__ void __launch_bounds__(kRowThreads) gate_norm_bwd_kernel(const Params p) {
  __shared__ float red[kRowThreads / 32];
  const int row = blockIdx.x;  // b * L + l
  const int m = blockIdx.y;
  const int b = row / p.L, l = row % p.L;
  const int d = p.d;
  const size_t trow = static_cast<size_t>(m) * p.B * p.L + row;
  const float* z = p.zx + trow * p.dproj;
  const float* gm = p.gm + trow * d;
  const float* norm_w = p.br[m].norm_w;
  float sz[kMaxPerThread], dsz[kMaxPerThread], gn[kMaxPerThread], nw[kMaxPerThread];
  float acc[kMaxPerThread], gz[kMaxPerThread], gnw[kMaxPerThread];
#pragma unroll
  for (int i = 0; i < kMaxPerThread; ++i) {
    const int c = threadIdx.x + i * kRowThreads;
    const float zc = c < d ? z[c] : 0.0f;
    sz[i] = zc * sigmoid(zc);
    dsz[i] = dsilu(zc);
    gn[i] = c < d ? gm[c] * p.scale : 0.0f;
    nw[i] = c < d ? norm_w[c] : 0.0f;
    acc[i] = gz[i] = gnw[i] = 0.0f;
  }
  for (int s = 0; s < p.S; ++s) {
    const size_t srow = ((static_cast<size_t>(m) * p.B + b) * p.S + s) * p.L + l;
    const float* y = p.y + srow * d;
    float* gy = p.gy + srow * d;
    float yv[kMaxPerThread], yg[kMaxPerThread];
    float q = 0.0f;
#pragma unroll
    for (int i = 0; i < kMaxPerThread; ++i) {
      const int c = threadIdx.x + i * kRowThreads;
      yv[i] = c < d ? y[c] : 0.0f;
      yg[i] = yv[i] * sz[i];
      q = fmaf(yg[i], yg[i], q);
    }
    const float rms = rsqrtf(block_sum(q, red) / d + p.eps);
    float t = 0.0f;
#pragma unroll
    for (int i = 0; i < kMaxPerThread; ++i) {
      acc[i] += yg[i] * rms * nw[i];
      gnw[i] += gn[i] * yg[i] * rms;
      t = fmaf(gn[i] * nw[i], yg[i], t);
    }
    const float coef = rms * rms * rms / d * block_sum(t, red);
#pragma unroll
    for (int i = 0; i < kMaxPerThread; ++i) {
      const int c = threadIdx.x + i * kRowThreads;
      const float g_yg = gn[i] * nw[i] * rms - coef * yg[i];
      if (c < d) gy[c] = g_yg * sz[i];
      gz[i] += g_yg * yv[i] * dsz[i];
    }
  }
  float* merged = p.merged + trow * d;
  float* gnw_row = p.gnw + trow * d;
  float* gzx = p.gzx + trow * p.dproj;
#pragma unroll
  for (int i = 0; i < kMaxPerThread; ++i) {
    const int c = threadIdx.x + i * kRowThreads;
    if (c < d) {
      merged[c] = acc[i] * p.scale;
      gnw_row[c] = gnw[i];
      gzx[c] = gz[i];
    }
  }
}

// Shared memory of one SSD adjoint block, in floats (the token order is ints
// of the same size).
__host__ __device__ constexpr size_t adj_smem_floats(int L) {
  return static_cast<size_t>(L) * (kHd + kXStride + kBStride + 2 * kN + 12 + 2 * kTStride);
}

// 4. The SSD adjoint of one (branch, b, stream, head). grid (H, B * S, M).
__global__ void __launch_bounds__(kThreads) ssd_adjoint_kernel(const Params p) {
  __shared__ float red[kThreads / 32];
  __shared__ double colp[kThreads / 32][kTile];  // each warp's column sums of P
  float* smem = ssd::dynamic_smem();
  const int L = p.L, d = p.d;
  const int head = blockIdx.x;
  const int bs = blockIdx.y;  // b * S + s
  const int s = bs % p.S;
  const int b = bs / p.S;
  const int m = blockIdx.z;
  const int tid = threadIdx.x;
  const int warp = tid / 32, lane = tid % 32;

  float* GY = smem;                  // (L, 64): g_y in stream order, 16-byte aligned rows
  double* rs = reinterpret_cast<double*>(GY + L * kHd);  // (L,): sum_{u < t} P[t, u]
  double* cl = rs + L;                                    // (L,): sum_{t > u} P[t, u]
  ssd::Head hd;
  hd.css64 = cl + L;                                      // (L,)
  hd.X = reinterpret_cast<float*>(hd.css64 + L);          // (L, 65)
  hd.Bs = hd.X + L * kXStride;       // (L, 17)
  hd.Cs = hd.Bs + L * kBStride;      // (L, 16)
  float* gC = hd.Cs + L * kN;        // (L, 16)
  hd.dts = gC + L * kN;              // (L,)
  hd.css = hd.dts + L;               // (L,)
  hd.pre = hd.css + L;               // (L,)
  float* qs = hd.pre + L;            // (L,): <X, g_xdt> over the head's channels
  float* gda = qs + L;               // (L,): g_dA
  hd.tok = reinterpret_cast<int*>(gda + L);  // (L,)
  float* Mt = gda + 2 * L;           // (L, 33): M[t, u] for the tile's columns u
  float* Wt = Mt + L * kTStride;     // (L, 33): W[t, u]
  hd.x_stride = kXStride;
  hd.zx_b = p.zx + (static_cast<size_t>(m) * p.B + b) * L * p.dproj;
  hd.order = p.fwd + static_cast<size_t>(s) * L;
  const Branch& br = p.br[m];
  hd.mx = ssd::Mixer{br.conv_w, br.conv_b, br.dt_bias, br.A_log, br.D};
  hd.head = head;
  hd.L = L;
  hd.d = d;
  hd.dproj = p.dproj;
  hd.dt_lo = p.dt_lo;
  hd.dt_hi = p.dt_hi;
  ssd::stage_head(hd);
  const float *X = hd.X, *Bs = hd.Bs, *Cs = hd.Cs, *dts = hd.dts;
  const double* css = hd.css64;
  const int* tok = hd.tok;

  const float A = -expf(br.A_log[head]);
  const float Dh = br.D[head];
  // Row of (m, b, s, t = 0) in the stream-row arrays; token rows share it.
  const size_t row0 = (static_cast<size_t>(m) * p.B * p.S + bs) * L;

  // g_y into stream order, and the head's sum of g_y X.
  float dsum = 0.0f;
  {
    const float* gy_bs = p.gy + row0 * d + head * kHd;
    for (int i = tid; i < L * kHd; i += kThreads) {
      const int t = i / kHd, c = i % kHd;
      const float g = gy_bs[static_cast<size_t>(tok[t]) * d + c];
      GY[i] = g;
      dsum = fmaf(g, X[t * kXStride + c], dsum);
    }
    for (int i = tid; i < L * kN; i += kThreads) gC[i] = 0.0f;
    for (int t = tid; t < L; t += kThreads) rs[t] = 0.0;
  }
  __syncthreads();

  const int tx = tid % 16;  // columns tx + 16 j
  const int ty = tid / 16;  // rows ty and ty + 16 of the tile

  for (int u0 = 0; u0 < L; u0 += kTile) {
    const int nrows = L - u0;             // rows t = u0 .. L - 1 see these columns
    const int ncols = min(kTile, nrows);  // columns u = u0 .. u0 + ncols - 1
    // M[t, u] = (Cs_t . Bs_u) decay and W[t, u] = <g_y[t], xdt[u]> decay for
    // u <= t, 0 above the diagonal; P = W (Cs_t . Bs_u) below it, summed along its rows
    // (over the warp) and its columns (over the lane's rows, then the warps).
    // Lane u keeps its column's xdt and Bs.
    {
      const int u = u0 + lane;
      const bool u_ok = u < L;
      float xu[kHd], bu[kN];
      const float dt_u = u_ok ? dts[u] : 0.0f;
      const double cs_u = u_ok ? css[u] : 0.0;
#pragma unroll
      for (int c = 0; c < kHd; ++c) xu[c] = u_ok ? X[u * kXStride + c] * dt_u : 0.0f;
#pragma unroll
      for (int k = 0; k < kN; ++k) bu[k] = u_ok ? Bs[u * kBStride + k] : 0.0f;
      double col = 0.0;
      for (int t = u0 + warp; t < L; t += kThreads / 32) {
        const float4* g4 = reinterpret_cast<const float4*>(GY + t * kHd);
        float gx0 = 0.0f, gx1 = 0.0f;
#pragma unroll
        for (int c4 = 0; c4 < kHd / 4; ++c4) {
          const float4 v = g4[c4];
          gx0 = fmaf(v.x, xu[4 * c4], gx0);
          gx1 = fmaf(v.y, xu[4 * c4 + 1], gx1);
          gx0 = fmaf(v.z, xu[4 * c4 + 2], gx0);
          gx1 = fmaf(v.w, xu[4 * c4 + 3], gx1);
        }
        float cb = 0.0f;
#pragma unroll
        for (int k = 0; k < kN; ++k) cb = fmaf(Cs[t * kN + k], bu[k], cb);
        float mv = 0.0f, wv = 0.0f, pv = 0.0f;
        if (u_ok && u <= t) {
          const float decay = expf(static_cast<float>(css[t] - cs_u));
          mv = cb * decay;
          wv = (gx0 + gx1) * decay;
          if (u < t) pv = wv * cb;
        }
        Mt[(t - u0) * kTStride + lane] = mv;
        Wt[(t - u0) * kTStride + lane] = wv;
        double row = static_cast<double>(pv);
        col += row;
#pragma unroll
        for (int o = 16; o > 0; o >>= 1) row += __shfl_xor_sync(0xffffffffu, row, o);
        if (lane == 0) rs[t] += row;  // one warp per row and tile, tiles in turn
      }
      colp[warp][lane] = col;
    }
    __syncthreads();
    if (tid < ncols) {
      double c = 0.0;
      for (int w = 0; w < kThreads / 32; ++w) c += colp[w][tid];
      cl[u0 + tid] = c;
    }

    // g_xdt tile (32 x 64) = M^T (32 x nrows) . g_y (nrows x 64); then
    // g_X = D g_y + dt g_xdt, and <X, g_xdt> over the head's channels.
    {
      float acc[2][4] = {{0.0f, 0.0f, 0.0f, 0.0f}, {0.0f, 0.0f, 0.0f, 0.0f}};
      for (int r = 0; r < nrows; ++r) {
        const float a0 = Mt[r * kTStride + ty], a1 = Mt[r * kTStride + ty + 16];
        const float* gr = GY + (u0 + r) * kHd + tx;
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const float gv = gr[16 * j];
          acc[0][j] = fmaf(a0, gv, acc[0][j]);
          acc[1][j] = fmaf(a1, gv, acc[1][j]);
        }
      }
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        const int u = u0 + ty + 16 * i;
        const bool ok = u < L;
        float q = 0.0f;
        if (ok) {
          float* gx_row = p.gxbc + (row0 + u) * p.conv_dim + head * kHd;
          const float dt_u = dts[u];
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            const int c = tx + 16 * j;
            q = fmaf(X[u * kXStride + c], acc[i][j], q);
            gx_row[c] = fmaf(dt_u, acc[i][j], Dh * GY[u * kHd + c]);
          }
        }
#pragma unroll
        for (int o = 8; o > 0; o >>= 1) q += __shfl_xor_sync(0xffffffffu, q, o);
        if (ok && tx == 0) qs[u] = q;
      }
    }
    // g_C[t, :] += W[t, tile] . Bs[tile, :] for the rows t >= u0
    for (int i = tid; i < nrows * kN; i += kThreads) {
      const int r = i / kN, k = i % kN;
      float a = 0.0f;
      for (int j = 0; j < ncols; ++j) a = fmaf(Wt[r * kTStride + j], Bs[(u0 + j) * kBStride + k], a);
      gC[(u0 + r) * kN + k] += a;
    }
    // g_B[tile, :] = W[:, tile]^T . Cs, complete: no later tile has these columns
    for (int i = tid; i < ncols * kN; i += kThreads) {
      const int j = i / kN, k = i % kN;
      float a = 0.0f;
      for (int r = 0; r < nrows; ++r) a = fmaf(Wt[r * kTStride + j], Cs[(u0 + r) * kN + k], a);
      p.gbc[((row0 + u0 + j) * p.H + head) * 2 * kN + k] = a;
    }
    __syncthreads();  // Mt and Wt are rebuilt by the next tile
  }

  // g_dA: the reverse cumsum of g_cs = rs - cl, by warp 0 in fp64, 32 steps
  // at a time from the end.
  if (tid < 32) {
    double carry = 0.0;
    for (int r0 = 0; r0 < L; r0 += 32) {
      const int t = L - 1 - (r0 + tid);
      double v = t >= 0 ? rs[t] - cl[t] : 0.0;
#pragma unroll
      for (int o = 1; o < 32; o <<= 1) {
        const double up = __shfl_up_sync(0xffffffffu, v, o);
        if (tid >= o) v += up;
      }
      v += carry;
      if (t >= 0) gda[t] = static_cast<float>(v);
      carry = __shfl_sync(0xffffffffu, v, 31);
    }
  }
  __syncthreads();

  // g_dt, the clip's and the softplus's adjoints, and the head's sums.
  float sum_a = 0.0f, sum_b = 0.0f;
  for (int t = tid; t < L; t += kThreads) {
    const float g_da = gda[t];
    float g_dt = fmaf(g_da, A, qs[t]);
    sum_a = fmaf(g_da, dts[t], sum_a);
    const float pre = hd.pre[t];
    const float sp = softplus(pre);
    if (!(sp >= p.dt_lo && sp <= p.dt_hi)) g_dt = 0.0f;
    const float g_p = g_dt * sigmoid(pre);
    p.graw[(row0 + t) * p.H + head] = g_p;
    sum_b += g_p;
  }
  sum_a = block_sum(sum_a, red);
  sum_b = block_sum(sum_b, red);
  dsum = block_sum(dsum, red);
  if (tid == 0) {
    float* part =
        p.part_head + ((static_cast<size_t>(m) * p.B * p.S + bs) * p.H + head) * kHeadParts;
    part[0] = sum_a;
    part[1] = dsum;
    part[2] = sum_b;
  }
  for (int i = tid; i < L * kN; i += kThreads) {
    p.gbc[((row0 + i / kN) * p.H + head) * 2 * kN + kN + i % kN] = gC[i];
  }
}

// 5a. g_a = [g_X | sum_heads g_B | sum_heads g_C] silu'(a), a recomputed from
// zx, in place of g_X. One thread per (stream row, conv channel).
__global__ void grad_preact_kernel(const Params p) {
  const int m = blockIdx.y;
  const size_t R = srows(p);
  const size_t i = static_cast<size_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (i >= R * p.conv_dim) return;
  const int cc = static_cast<int>(i % p.conv_dim);
  const size_t row = i / p.conv_dim;  // (b * S + s) * L + t
  const int L = p.L, d = p.d;
  const int t = static_cast<int>(row % L);
  const size_t bs = row / L;
  const int64_t* order = p.fwd + (bs % p.S) * L;
  const float* zx_b = p.zx + (static_cast<size_t>(m) * p.B + bs / p.S) * L * p.dproj + d + cc;
  const float* w = p.br[m].conv_w + static_cast<size_t>(cc) * kConv;
  float a = p.br[m].conv_b[cc];
#pragma unroll
  for (int k = 0; k < kConv; ++k) {
    const int tt = t - (kConv - 1) + k;
    if (tt >= 0) a = fmaf(w[k], zx_b[order[tt] * p.dproj], a);
  }
  float* out = p.gxbc + (m * R + row) * p.conv_dim + cc;
  float g = 0.0f;
  if (cc < d) {
    g = *out;
  } else {
    const float* part = p.gbc + (m * R + row) * p.H * 2 * kN + (cc - d);
    for (int hh = 0; hh < p.H; ++hh) g += part[hh * 2 * kN];  // head order
  }
  *out = g * dsilu(a);
}

// 5b. g_zx's conv and dt columns (T, dproj - d): the conv adjoint of each
// stream, gathered back to token order and summed over the streams. For conv
// channel j of token l, stream s holds the token at position pos (merge table
// entry s * L + pos); tap k of the conv read it for the output at
// pos + K - 1 - k, if that is inside the stream. The dt columns sum g_p.
__global__ void grad_zx_kernel(const Params p) {
  const int m = blockIdx.y;
  const size_t T = tokens(p);
  const int L = p.L, S = p.S;
  const int width = p.dproj - p.d;
  const size_t i = static_cast<size_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (i >= T * width) return;
  const int j = static_cast<int>(i % width);
  const size_t tok = i / width;
  const int b = static_cast<int>(tok / L), l = static_cast<int>(tok % L);
  const size_t seq0 = (static_cast<size_t>(m) * p.B + b) * S * L;  // row of (m, b, s = 0, 0)
  float acc = 0.0f;
  if (j < p.conv_dim) {
    const float* w = p.br[m].conv_w + static_cast<size_t>(j) * kConv;
    for (int q = 0; q < S; ++q) {
      const int64_t e = p.merge[static_cast<size_t>(l) * S + q];  // s * L + pos
      const int pos = static_cast<int>(e % L);
#pragma unroll
      for (int k = 0; k < kConv; ++k) {
        const int out = pos + kConv - 1 - k;
        if (out < L) acc = fmaf(w[k], p.gxbc[(seq0 + e + kConv - 1 - k) * p.conv_dim + j], acc);
      }
    }
  } else {
    for (int q = 0; q < S; ++q) {
      const int64_t e = p.merge[static_cast<size_t>(l) * S + q];
      acc += p.graw[(seq0 + e) * p.H + (j - p.conv_dim)];
    }
  }
  p.gzx[(static_cast<size_t>(m) * T + tok) * p.dproj + p.d + j] = acc;
}

// 5c. Per row split: g_conv_w[c, k] = sum g_a[row, c] in[row - K + 1 + k, c]
// and g_conv_b[c] = sum g_a[row, c] over the split's stream rows, where in is
// the stream's gathered zx columns with zeros before its start. Block
// (32 channels, 8 row lanes); grid (conv_dim / 32, kSplits, M).
__global__ void __launch_bounds__(256) grad_conv_kernel(const Params p) {
  constexpr int kLanes = 8;
  __shared__ float red[kLanes][kConv + 1][32];
  const int m = blockIdx.z, split = blockIdx.y;
  const int c = blockIdx.x * 32 + threadIdx.x;
  const int L = p.L, S = p.S;
  const int rows = static_cast<int>(srows(p));
  const int per = (rows + kSplits - 1) / kSplits;
  const int begin = split * per, end = min(rows, begin + per);
  float acc[kConv + 1];
#pragma unroll
  for (int k = 0; k <= kConv; ++k) acc[k] = 0.0f;
  if (c < p.conv_dim) {
    const float* ga = p.gxbc + static_cast<size_t>(m) * rows * p.conv_dim;
    const float* zx = p.zx + static_cast<size_t>(m) * tokens(p) * p.dproj;
    for (int row = begin + threadIdx.y; row < end; row += kLanes) {
      const int t = row % L, bs = row / L;
      const int64_t* order = p.fwd + static_cast<size_t>(bs % S) * L;
      const float* zx_b = zx + static_cast<size_t>(bs / S) * L * p.dproj + p.d + c;
      const float g = ga[static_cast<size_t>(row) * p.conv_dim + c];
#pragma unroll
      for (int k = 0; k < kConv; ++k) {
        const int tt = t - (kConv - 1) + k;
        if (tt >= 0) acc[k] = fmaf(g, zx_b[order[tt] * p.dproj], acc[k]);
      }
      acc[kConv] += g;
    }
  }
#pragma unroll
  for (int k = 0; k <= kConv; ++k) red[threadIdx.y][k][threadIdx.x] = acc[k];
  __syncthreads();
  if (threadIdx.y != 0 || c >= p.conv_dim) return;
  float* part =
      p.part_conv + ((static_cast<size_t>(m) * kSplits + split) * p.conv_dim + c) * (kConv + 1);
#pragma unroll
  for (int k = 0; k <= kConv; ++k) {
    float v = 0.0f;
    for (int y = 0; y < kLanes; ++y) v += red[y][k][threadIdx.x];
    part[k] = v;
  }
}

// Per row split: the column sums of the token rows' g_norm_w terms.
// grid (d / 128, kSplits, M).
__global__ void norm_w_partial_kernel(const Params p) {
  const int m = blockIdx.z, split = blockIdx.y;
  const int c = blockIdx.x * blockDim.x + threadIdx.x;
  if (c >= p.d) return;
  const int rows = static_cast<int>(tokens(p));
  const int per = (rows + kSplits - 1) / kSplits;
  const int begin = split * per, end = min(rows, begin + per);
  const float* gnw = p.gnw + static_cast<size_t>(m) * rows * p.d + c;
  float acc = 0.0f;
  for (int row = begin; row < end; ++row) acc += gnw[static_cast<size_t>(row) * p.d];
  p.part_nw[(static_cast<size_t>(m) * kSplits + split) * p.d + c] = acc;
}

// 7. Every partial summed in order: g_conv_w and g_conv_b per conv channel,
// g_norm_w per channel, g_A_log, g_D and g_dt_bias per head.
__global__ void finalize_kernel(const Params p) {
  const int m = blockIdx.y;
  const int c = blockIdx.x * blockDim.x + threadIdx.x;
  const Branch& w = p.br[m];
  if (c < p.conv_dim) {
    float conv[kConv + 1];
#pragma unroll
    for (int k = 0; k <= kConv; ++k) conv[k] = 0.0f;
    for (int q = 0; q < kSplits; ++q) {
      const float* part =
          p.part_conv + ((static_cast<size_t>(m) * kSplits + q) * p.conv_dim + c) * (kConv + 1);
#pragma unroll
      for (int k = 0; k <= kConv; ++k) conv[k] += part[k];
    }
#pragma unroll
    for (int k = 0; k < kConv; ++k) w.g_conv_w[static_cast<size_t>(c) * kConv + k] = conv[k];
    w.g_conv_b[c] = conv[kConv];
  }
  if (c < p.d) {
    float acc = 0.0f;
    for (int q = 0; q < kSplits; ++q) acc += p.part_nw[(static_cast<size_t>(m) * kSplits + q) * p.d + c];
    w.g_norm_w[c] = acc;
  }
  if (c < p.H) {
    const int seqs = p.B * p.S;
    float acc[kHeadParts] = {0.0f, 0.0f, 0.0f};
    for (int q = 0; q < seqs; ++q) {
      const float* part = p.part_head + ((static_cast<size_t>(m) * seqs + q) * p.H + c) * kHeadParts;
#pragma unroll
      for (int k = 0; k < kHeadParts; ++k) acc[k] += part[k];
    }
    w.g_A_log[c] = acc[0] * -expf(w.A_log[c]);  // g_A_log = gA * A
    w.g_D[c] = acc[1];
    w.g_dt_bias[c] = acc[2];
  }
}

// Lay the workspace out for these shapes (pointers into `base` when given);
// returns its size in floats.
size_t layout(Params& p, float* base, int M) {
  const size_t T = static_cast<size_t>(p.B) * p.L, R = T * p.S, d = p.d;
  const size_t sizes[] = {
      T * d, R * d, R * d, T * d, T * d,           // gm, y, gy, merged, gnw
      T * p.dproj, R * p.conv_dim,                 // gzx, gxbc
      R * p.H, R * p.H * 2 * kN,                   // graw, gbc
      static_cast<size_t>(p.B) * p.S * p.H * kHeadParts,  // part_head
      static_cast<size_t>(kSplits) * p.conv_dim * (kConv + 1),  // part_conv
      static_cast<size_t>(kSplits) * d,            // part_nw
  };
  float** ptrs[] = {&p.gm, &p.y, &p.gy, &p.merged, &p.gnw, &p.gzx, &p.gxbc, &p.graw, &p.gbc,
                    &p.part_head, &p.part_conv, &p.part_nw};
  size_t total = 0;
  for (int i = 0; i < 12; ++i) {
    if (base != nullptr) *ptrs[i] = base + total;
    total += (sizes[i] * M + 3) / 4 * 4;  // every array 16-byte aligned
  }
  return total;
}

void set_dims(Params& p, int B, int L, int h, int d, int H, int S) {
  p.B = B;
  p.L = L;
  p.h = h;
  p.d = d;
  p.H = H;
  p.S = S;
  p.conv_dim = d + 2 * kN;
  p.dproj = 2 * d + 2 * kN + H;
}

unsigned blocks_for(size_t n, int threads) { return static_cast<unsigned>((n + threads - 1) / threads); }

}  // namespace

// Floats of workspace that ssd_mixer_bwd needs for these shapes.
extern "C" long long ssd_mixer_bwd_workspace_floats(int M, int B, int L, int d, int H, int S) {
  Params p{};
  set_dims(p, B, L, 0, d, H, S);
  return static_cast<long long>(layout(p, nullptr, M));
}

// The longest sequence whose SSD adjoint block fits in a block's shared memory.
extern "C" int ssd_mixer_bwd_max_tokens() {
  int L = 0;
  while (adj_smem_floats(L + 1) * sizeof(float) <= kMaxSharedBytes) ++L;
  return L;
}

// `ptrs` holds 19 pointers per branch, in the order of struct Branch, for
// M = 1 or 2 branches; all fp32 and contiguous. `fwd` (S, L) and `merge`
// (L, S) are int64, each row of fwd a permutation of 0 .. L-1. `zx` is the
// residual (M, B * L, dproj) that ssd_mixer_fwd wrote for the same x and
// weights. Launches the chain on `stream`; returns the first launch's
// cudaError_t that is not 0, or -1 for shapes that are not built.
extern "C" int ssd_mixer_bwd(void* const* ptrs, int M, const void* fwd, const void* merge,
                             const void* zx, void* workspace, int B, int L, int h, int d, int n,
                             int H, int K, int S, float scale, float eps, float dt_lo,
                             float dt_hi, void* stream) {
  if (M < 1 || M > 2 || n != kN || K != kConv || H < 1 || d != H * kHd ||
      d > kRowThreads * kMaxPerThread || S < 1 || S > kMaxStreams || L < 1 ||
      adj_smem_floats(L) * sizeof(float) > kMaxSharedBytes) {
    return -1;
  }
  Params p{};
  for (int m = 0; m < M; ++m) {
    void* const* q = ptrs + m * kBranchPtrs;
    const float* in[10];
    float* out[9];
    for (int i = 0; i < 10; ++i) in[i] = static_cast<const float*>(q[i]);
    for (int i = 0; i < 9; ++i) out[i] = static_cast<float*>(q[10 + i]);
    p.br[m] = Branch{in[0], in[1], in[2], in[3], in[4], in[5], in[6], in[7], in[8], in[9],
                     out[0], out[1], out[2], out[3], out[4], out[5], out[6], out[7], out[8]};
  }
  p.fwd = static_cast<const int64_t*>(fwd);
  p.merge = static_cast<const int64_t*>(merge);
  p.zx = static_cast<const float*>(zx);
  set_dims(p, B, L, h, d, H, S);
  p.scale = scale;
  p.eps = eps;
  p.dt_lo = dt_lo;
  p.dt_hi = dt_hi;
  layout(p, static_cast<float*>(workspace), M);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int T = B * L, R = B * S * L;

  int err = launch_gemm_op<64, 64, 16, 4, 4, GradOutProj>(p, T, d, M, st);
  if (err == 0) {
    ssd::FwdArgs core{};
    for (int m = 0; m < M; ++m) {
      const Branch& br = p.br[m];
      core.mx[m] = ssd::Mixer{br.conv_w, br.conv_b, br.dt_bias, br.A_log, br.D};
    }
    core.fwd = p.fwd;
    core.zx = p.zx;
    core.y = p.y;
    core.B = B;
    core.L = L;
    core.Lt = L;
    core.d = d;
    core.S = S;
    core.y_streams = S;
    core.dproj = p.dproj;
    core.dt_lo = dt_lo;
    core.dt_hi = dt_hi;
    err = ssd::launch_ssd_fwd(core, M, H, st);
  }
  if (err == 0) {
    gate_norm_bwd_kernel<<<dim3(T, M), kRowThreads, 0, st>>>(p);
    err = static_cast<int>(cudaGetLastError());
  }
  if (err == 0) {
    const size_t smem = adj_smem_floats(L) * sizeof(float);
    err = static_cast<int>(cudaFuncSetAttribute(
        ssd_adjoint_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem)));
    if (err == 0) {
      ssd_adjoint_kernel<<<dim3(H, B * S, M), kThreads, smem, st>>>(p);
      err = static_cast<int>(cudaGetLastError());
    }
  }
  if (err == 0) {
    grad_preact_kernel<<<dim3(blocks_for(static_cast<size_t>(R) * p.conv_dim, 256), M), 256, 0, st>>>(p);
    err = static_cast<int>(cudaGetLastError());
  }
  if (err == 0) {
    grad_zx_kernel<<<dim3(blocks_for(static_cast<size_t>(T) * (p.dproj - d), 256), M), 256, 0, st>>>(p);
    err = static_cast<int>(cudaGetLastError());
  }
  if (err == 0) {
    grad_conv_kernel<<<dim3(blocks_for(p.conv_dim, 32), kSplits, M), dim3(32, 8), 0, st>>>(p);
    err = static_cast<int>(cudaGetLastError());
  }
  if (err == 0) {
    norm_w_partial_kernel<<<dim3(blocks_for(d, 128), kSplits, M), 128, 0, st>>>(p);
    err = static_cast<int>(cudaGetLastError());
  }
  if (err == 0) err = launch_gemm_op<64, 64, 16, 4, 4, GradX>(p, T, h, M, st);
  if (err == 0) err = launch_gemm_op<64, 64, 16, 4, 4, GradInW>(p, p.dproj, h, M, st);
  if (err == 0) err = launch_gemm_op<64, 64, 16, 4, 4, GradOutW>(p, h, d, M, st);
  if (err == 0) {
    finalize_kernel<<<dim3(blocks_for(p.conv_dim, 128), M), 128, 0, st>>>(p);
    err = static_cast<int>(cudaGetLastError());
  }
  return err;
}
