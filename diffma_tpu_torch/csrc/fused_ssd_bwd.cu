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
// Arithmetic. The four GEMMs (g W_out, gx, gW_in, gW_out) run on the tensor
// cores in 3xTF32 (gemm_tc.cuh), as kernel D's do; the rest is fp32 on the
// CUDA cores, with the sums named below in fp64. The decay is the quadratic
// form within a chunk and a carried state across chunks, every exponent a sum
// of dt * A (never positive) taken in fp64 and rounded once, with the causal
// mask a selection, never a product: above the diagonal the exponent is
// positive, exp would overflow at wide spans, and inf * 0 is NaN.
//
// g_cs is a row sum less a column sum of P; with the diagonal included they
// are the TPU kernel's two inner products, <g_y, y_pre> and <xdt, g_xdt>,
// whose diagonal terms are equal and cancel. At a wide span the diagonal is
// all there is (the decay kills the rest), so the difference of the inner
// products is rounding noise as large as the gradient. Here both sums leave
// the diagonal out, exactly: within a chunk as sums of P's entries, and
// across chunks as inner products that hold no diagonal term,
//
//     sum_{u in earlier chunks} P[t, u]  = <g_y[t], y_off[t]>,   y_off[t] = exp(lcs[t]) Cs_t . h_in(c)
//     sum_{t' in later chunks} P[t', u] = <xdt[u], g_xdt_off[u]>,  g_xdt_off[u] = exp(sum(c) - lcs[u]) Bs_u . g_h(c)
//
// where h_in(c) is the state entering chunk c and g_h(c) the state adjoint
// leaving it (ssd_core.cuh's notation). Since gA = sum_t dt_t g_dA[t] weighs
// g_cs[t] with the whole cumulative dt up to t, while each P[t, u] truly
// counts only with the dt between u and t, the rounding of the two sums is
// magnified by the sequence's length: so they, their difference and the
// reverse cumsum over the whole stream run in fp64.
//
// Bound on an H100 SXM (165 TFLOP/s for 3xTF32 products, 67 TFLOP/s fp32
// outside the tensor cores, 3.35 TB/s). At DiffMa's training shapes, batch 8,
// both branches (B = 8, L = 196, h = 512, d = 1024, H = 16, n = 16, S = 3),
// one call does about 23 GFLOP of products at the 3xTF32 rate: four GEMMs
// over the 1568 token rows, 20 GFLOP, and the chunked SSD's, forward and
// adjoint, 3.4 GFLOP (chip_smoke.py's ssd_chunk_work), 0.14 ms; and 0.6
// GFLOP of the rest at fp32, 0.01 ms. About 0.15 ms, against about 71 MB of
// x, g, the residual, weights and gradients, 0.02 ms. So operations bound
// it.
//
// Design: a chain of launches over a workspace the caller allocates
// (ssd_mixer_bwd_workspace_floats), with the branch on blockIdx.z (or a grid
// axis) in every launch, so both branches share each launch and their
// gradients never mix.
// 1. gm = g W_out: gemm_tc.cuh's GEMM.
// 2. y per stream in token order: kernel E's chunked SSD (ssd_core.cuh),
//    which also leaves each chunk's end state and sum(c) in the workspace.
// 3. the gate + RMSNorm adjoint: one block per (branch, token row), which
//    holds the whole d-wide row; writes g_yg silu(z) per stream, g_z summed
//    in stream order into g_zx, merged, and the row's g_norm_w terms.
// 4. the SSD adjoint, chunked as the forward, in chunks of 64 steps: one
//    block of 256 threads per (branch, b, stream, head, chunk) each time.
//    a. each chunk's share of the state adjoint, a_c = sum_{t in c}
//       exp(lcs[t]) Cs_t (x) g_y[t] (16 x 64);
//    b. per chunk, h_in(c) and g_h(c) folded from the other chunks' states
//       and a's, then the chunk's M and W (64 x 64) in shared memory, and
//       from them and the two states g_xdt (its intra-chunk product M^T g_y
//       and the cross term), g_X = D g_y + dt g_xdt, g_C and g_B (each
//       head's own, never an L x L matrix), <X, g_xdt>, and g_cs per step in
//       fp64, the intra-chunk row and column sums of P taken by a fixed tree;
//    c. per (branch, b, stream, head), one warp: the reverse cumsum of g_cs
//       over the whole stream in fp64, 32 steps at a time with a carry, g_dt,
//       the clip and softplus adjoints, and the head's sums for g_A_log, g_D
//       and g_dt_bias.
// 5. g_a: the heads' g_B and g_C summed in head order, times silu'(a) with a
//    recomputed from zx; then g_zx's conv and dt columns by a gather-sum
//    through the merge table (each stream is a permutation: no atomics),
//    and g_conv_w, g_conv_b by column sums over row splits.
// 6. gx = g_zx W_in, gW_in = g_zx^T x, gW_out = g^T merged: GEMMs; the
//    weight gradients' depth is the B * L token rows, split over blocks
//    (tc::splits_for) and the partials summed in split order.
// 7. a pass that sums every partial in a fixed order. Nothing uses atomics
//    and every output element is written, never accumulated into, so two
//    calls give the same bits and nothing is left over from the last call.
// The TPU kernel's one-hot permutation and head-fold matmuls, its
// tril-matmul cumsums, its 8-row padding of L and its accumulation across a
// sequential grid exist for the MXU and VMEM; here they are index gathers,
// sums over a head's 64 channels, warp scans, exact t < L and second passes.
//
// Two kinds of scan spec, as in kernel E: full-length streams (Ls = L, each a
// permutation of the tokens), and an exact partition (Ls = L / S, every token
// in exactly one stream: EfficientVMamba's atrous streams), each stream a
// sequence of its own whose conv pad and cumsum start at its first step, and
// whose chunks never cross into another stream. For a partition, y and g_y
// have one token row each, the conv adjoint's gather-sum reads one merge
// entry per token (each token written once), and the column sums run over
// the B * S * Ls = B * L stream rows. Shared memory holds one chunk, so it
// does not grow with the stream and nothing caps its length; the folds of
// the states read a number that grows as the square of the chunks
// (ssd_core.cuh).
//
// bf16 (dtype 1: x, g and gx in bf16, the weights and their gradients
// fp32), the TPU kernel at a compute dtype cd = bfloat16. The four GEMMs
// multiply bf16 operands with fp32 sums (gemm_tc.cuh's kBf16 stages), each
// operand rounded where the JAX kernel casts it: g and W_out for gm; merged
// and g for gW_out; g_zx and W_in for gx, which is stored in bf16; x and g_zx
// for gW_in. y is recomputed with kernel E's rounding (ssd_core.cuh), and
// each stream's y and g_y are rounded to bf16 where E rounds y, for every
// stream not in token order (`ident` as in kernel E). The SSD's head
// products round their operands: M^T g_y takes M and g_y, and W's g_y xdt^T
// g_y and xdt = dt X, each rounded at the product with fp32 sums. The
// gradient of each non-identity stream's conv and dt columns is rounded
// before it is added back to token order. g_C and g_B, which the TPU kernel
// takes from the sum over heads of g_cb rounded to bf16, stay fp32 here:
// each head's block holds its own W, and the heads' shares are summed
// after. The rest (the norm's and the cumsum's adjoints, the conv, the
// clip and softplus, the sums) is the fp32 variant's arithmetic.
//
// Several B/C groups are not built: the wrapper raises for them.

#include <cuda_runtime.h>
#include <stdint.h>

#include <algorithm>

#include "gemm_tc.cuh"
#include "ssd_core.cuh"

namespace {

using ssd::block_mm;
using ssd::block_sum;
using ssd::Chunk;
using ssd::dsilu;
using ssd::kConv;
using ssd::kHd;
using ssd::kMaxStreams;
using ssd::kN;
using ssd::kNS;
using ssd::kQ;
using ssd::kQS;
using ssd::kRawFloats;
using ssd::kState;
using ssd::kThreads;
using ssd::kXS;
using ssd::Keep;
using ssd::round_bf16;
using ssd::sigmoid;
using ssd::softplus;
using ssd::Where;
using ssd::zero;
using tc::al;
using tc::kIsBf16;
using tc::ld;
using tc::ld4;
using tc::put;
using bf16 = tc::bf16;

constexpr int kBranchPtrs = 19;   // x, g, 8 weights, gx, 8 gradients
constexpr int kRowThreads = 256;  // the gate + norm adjoint
constexpr int kMaxPerThread = 8;  // so d <= 2048
constexpr int kSplits = 16;       // row splits of the column sums
constexpr int kHeadParts = 3;     // per (sequence, head): gA, g_D, g_dt_bias

struct Branch {
  const void* x;         // (B, L, h), fp32 or bf16
  const void* g;         // (B, L, h), x's dtype
  const float* in_w;     // (2d + 2n + H, h)
  const float* conv_w;   // (d + 2n, K)
  const float* conv_b;   // (d + 2n,)
  const float* dt_bias;  // (H,)
  const float* A_log;    // (H,)
  const float* D;        // (H,)
  const float* norm_w;   // (d,)
  const float* out_w;    // (h, d)
  void* gx;              // (B, L, h), x's dtype
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
// T = B * L token rows; R = B * S * Ls stream rows, row (b * S + s) * Ls + t
// in stream order. A token lies in ys streams (S, or 1 for a partition): the
// merge table's width, and the rows per token of the token-order arrays y
// and gy, row (b * ys + s) * L + token. A head's stream has nc chunks.
struct Params {
  Branch br[2];
  const int64_t* fwd;    // (S, Ls): stream s visits tokens fwd[s, 0..Ls-1]
  const int64_t* merge;  // (L, ys): the stream rows s * Ls + position of token l
  const float* zx;       // (M, T, dproj): kernel E's residual
  float* gm;             // (T, d): g W_out
  float* y;              // (T * ys, d) token order: the SSD output before the gate
  float* gy;             // (T * ys, d) token order: its adjoint
  float* merged;         // (T, d)
  float* gnw;            // (T, d): the row's g_norm_w terms
  float* gzx;            // (T, dproj)
  float* gxbc;           // (R, d + 2n) stream order: g_X, then g_a
  float* graw;           // (R, H) stream order: g_p
  float* gbc;            // (R, H, 2n) stream order: each head's g_B, g_C
  float* states;         // the forward's chunk states and sums (ssd::state_floats)
  float* achunk;         // (B * S, H, nc, 16, 64): each chunk's a_c
  double* gcs;           // (R, H) stream order: g_cs
  float* qs;             // (R, H) stream order: <X, g_xdt> over the head's channels
  float* part_d;         // (B * S, H, nc): each chunk's sum of g_y X
  float* part_head;      // (B * S, H, kHeadParts)
  float* part_conv;      // (kSplits, d + 2n, K + 1): g_conv_w (K), g_conv_b
  float* part_nw;        // (kSplits, d)
  float* part;           // (part_size): a split product's partials
  float* dst[2];         // where the current split product's result goes, per branch
  size_t part_size;      // floats of `part` per branch
  int splits;            // of the current product's depth
  int sp_inw, sp_outw;   // depth splits of gW_in and gW_out
  int B, L, Ls, h, d, H, S, ys, dproj, conv_dim, nc;
  int ident;  // bf16: bit s set when stream s runs in token order (nothing of it rounds)
  float scale, eps, dt_lo, dt_hi;
};

__device__ __forceinline__ size_t tokens(const Params& p) { return static_cast<size_t>(p.B) * p.L; }
__device__ __forceinline__ size_t srows(const Params& p) {
  return static_cast<size_t>(p.B) * p.S * p.Ls;
}
__device__ __forceinline__ float* split_dst(const Params& p, int m) {
  return p.splits == 1 ? p.dst[m] : p.part + m * p.part_size;
}

// The stages of gemm_tc.cuh: c[row, col] = sum_k a(row, k) b(col, k) for one
// branch; T is x's dtype, and with bf16 every stage multiplies in bf16.
template <class T>
struct RowPtr {  // a row-major a, contiguous along k
  const T* p;
};
struct RowIdx {  // an a contiguous along row: a(row, k) = X[k * rows + row]
  int row;
};

template <class T>
struct GradOutProj {  // gm = g W_out
  static constexpr bool kAByRow = false, kBByRow = true, kBf16 = kIsBf16<T>;
  bool vec;  // float4 loads: every row aligned
  using ARow = RowPtr<T>;
  const T* g;
  const float* w;
  float* c;
  int rows, cols, depth;
  __device__ GradOutProj(const Params& p, int m)
      : g(static_cast<const T*>(p.br[m].g)), w(p.br[m].out_w), c(p.gm + m * tokens(p) * p.d),
        rows(static_cast<int>(tokens(p))), cols(p.d), depth(p.h) {
    vec = al(g, depth) && al(w, cols);
  }
  __device__ ARow arow(int row) const { return {g + static_cast<size_t>(row) * depth}; }
  __device__ float a(const ARow& r, int k) const { return ld(r.p + k); }
  __device__ float4 a4(const ARow& r, int k) const { return ld4(r.p + k); }
  __device__ float b(int col, int k) const { return w[static_cast<size_t>(k) * cols + col]; }
  __device__ float4 b4(int col, int k) const { return ld4(w + static_cast<size_t>(k) * cols + col); }
  __device__ void store(int row, int col, int, float v) const { c[static_cast<size_t>(row) * cols + col] = v; }
};

template <class T>
struct GradX {  // gx = g_zx W_in, stored as T
  static constexpr bool kAByRow = false, kBByRow = true, kBf16 = kIsBf16<T>;
  bool vec;  // float4 loads: every row aligned
  using ARow = RowPtr<float>;
  const float *gzx, *w;
  T* c;
  int rows, cols, depth;
  __device__ GradX(const Params& p, int m)
      : gzx(p.gzx + m * tokens(p) * p.dproj), w(p.br[m].in_w), c(static_cast<T*>(p.br[m].gx)),
        rows(static_cast<int>(tokens(p))), cols(p.h), depth(p.dproj) {
    vec = al(gzx, depth) && al(w, cols);
  }
  __device__ ARow arow(int row) const { return {gzx + static_cast<size_t>(row) * depth}; }
  __device__ float a(const ARow& r, int k) const { return r.p[k]; }
  __device__ float4 a4(const ARow& r, int k) const { return ld4(r.p + k); }
  __device__ float b(int col, int k) const { return w[static_cast<size_t>(k) * cols + col]; }
  __device__ float4 b4(int col, int k) const { return ld4(w + static_cast<size_t>(k) * cols + col); }
  __device__ void store(int row, int col, int, float v) const { put(c + static_cast<size_t>(row) * cols + col, v); }
};

template <class T>
struct GradInW {  // gW_in = g_zx^T x
  static constexpr bool kAByRow = true, kBByRow = true, kBf16 = kIsBf16<T>;
  bool vec;  // float4 loads: every row aligned
  using ARow = RowIdx;
  const float* gzx;
  const T* x;
  float* c;
  int rows, cols, depth;
  __device__ GradInW(const Params& p, int m)
      : gzx(p.gzx + m * tokens(p) * p.dproj), x(static_cast<const T*>(p.br[m].x)), c(split_dst(p, m)),
        rows(p.dproj), cols(p.h), depth(static_cast<int>(tokens(p))) {
    vec = al(gzx, rows) && al(x, cols);
  }
  __device__ ARow arow(int row) const { return {row}; }
  __device__ float a(const ARow& r, int k) const { return gzx[static_cast<size_t>(k) * rows + r.row]; }
  __device__ float4 a4(const ARow& r, int k) const { return ld4(gzx + static_cast<size_t>(k) * rows + r.row); }
  __device__ float b(int col, int k) const { return ld(x + static_cast<size_t>(k) * cols + col); }
  __device__ float4 b4(int col, int k) const { return ld4(x + static_cast<size_t>(k) * cols + col); }
  __device__ void store(int row, int col, int split, float v) const {
    c[(static_cast<size_t>(split) * rows + row) * cols + col] = v;
  }
};

template <class T>
struct GradOutW {  // gW_out = g^T merged
  static constexpr bool kAByRow = true, kBByRow = true, kBf16 = kIsBf16<T>;
  bool vec;  // float4 loads: every row aligned
  using ARow = RowIdx;
  const T* g;
  const float* merged;
  float* c;
  int rows, cols, depth;
  __device__ GradOutW(const Params& p, int m)
      : g(static_cast<const T*>(p.br[m].g)), merged(p.merged + m * tokens(p) * p.d), c(split_dst(p, m)),
        rows(p.h), cols(p.d), depth(static_cast<int>(tokens(p))) {
    vec = al(g, rows) && al(merged, cols);
  }
  __device__ ARow arow(int row) const { return {row}; }
  __device__ float a(const ARow& r, int k) const { return ld(g + static_cast<size_t>(k) * rows + r.row); }
  __device__ float4 a4(const ARow& r, int k) const { return ld4(g + static_cast<size_t>(k) * rows + r.row); }
  __device__ float b(int col, int k) const { return merged[static_cast<size_t>(k) * cols + col]; }
  __device__ float4 b4(int col, int k) const { return ld4(merged + static_cast<size_t>(k) * cols + col); }
  __device__ void store(int row, int col, int split, float v) const {
    c[(static_cast<size_t>(split) * rows + row) * cols + col] = v;
  }
};

// 3. The gate + RMSNorm adjoint of one token row; kBf16: a non-identity
// stream's y and g_y rounded, as kernel E rounds y. grid (B * L, M).
template <bool kBf16>
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
  for (int s = 0; s < p.ys; ++s) {
    const size_t srow = ((static_cast<size_t>(m) * p.B + b) * p.ys + s) * p.L + l;
    const float* y = p.y + srow * d;
    float* gy = p.gy + srow * d;
    const bool round = kBf16 && !((p.ident >> s) & 1);
    float yv[kMaxPerThread], yg[kMaxPerThread];
    float q = 0.0f;
#pragma unroll
    for (int i = 0; i < kMaxPerThread; ++i) {
      const int c = threadIdx.x + i * kRowThreads;
      yv[i] = c < d ? (round ? round_bf16(y[c]) : y[c]) : 0.0f;
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
      if (c < d) gy[c] = round ? round_bf16(g_yg * sz[i]) : g_yg * sz[i];
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

// 4. The SSD adjoint, one block per (branch, b, stream, head, chunk), as in
// the forward (ssd::where).

// The chunk's g_y in stream order, zero past its end, into GY (kQ, kHd);
// returns this thread's share of sum g_y X. After stage_chunk.
__device__ inline float gather_gy(const Params& p, const Where& w, const Chunk& ch, float* GY) {
  const size_t yrow0 = (p.ys == 1 ? static_cast<size_t>(w.m) * p.B + w.b : w.seq) * p.L;
  const float* gy_bs = p.gy + yrow0 * p.d + w.head * kHd;
  constexpr int kIters = kQ * kHd / kThreads;
  float g[kIters];
#pragma unroll
  for (int it = 0; it < kIters; ++it) {  // the loads first, all in flight at once
    const int i = threadIdx.x + it * kThreads, t = i / kHd;
    g[it] = t < ch.q ? gy_bs[static_cast<size_t>(ch.tok[t]) * p.d + i % kHd] : 0.0f;
  }
  float dsum = 0.0f;
#pragma unroll
  for (int it = 0; it < kIters; ++it) {
    const int i = threadIdx.x + it * kThreads;
    GY[i] = g[it];
    dsum = fmaf(g[it], ch.X[(i / kHd) * kXS + i % kHd], dsum);
  }
  return dsum;
}

constexpr int kChunkAdjSmem = (ssd::kChunkFloats + kRawFloats) * 4;  // GY in the scratch

// 4a. a_c = sum_{t in c} exp(lcs[t]) Cs_t (x) g_y[t]: the chunk's share of
// the state adjoint of every earlier chunk. Chunks 1 .. nc - 1: no chunk
// reads the first one's.
__global__ void __launch_bounds__(kThreads) ssd_chunk_adj_kernel(const Params p, const ssd::FwdArgs a) {
  const Where w = ssd::where(a, 1, a.nc - 1);
  Chunk ch = ssd::chunk_of(a, w, a.mx[w.m]);
  float* GY = ssd::chunk_layout(ch, ssd::dynamic_smem());
  ssd::stage_chunk(ch, GY);
  gather_gy(p, w, ch, GY);
  for (int i = threadIdx.x; i < kQ * kN; i += kThreads) {
    const int t = i / kN, k = i % kN;
    ch.Cs[t * kNS + k] *= expf(static_cast<float>(ch.lcs[t]));
  }
  __syncthreads();
  float acc[1][4];
  zero(acc);
  block_mm<1, 4, true, false>(acc, ch.Cs, kNS, GY, kHd, 0, kQ);
  float* out = p.achunk + (w.unit * a.nc + w.c) * kState;
  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;
#pragma unroll
  for (int j = 0; j < 4; ++j) out[ty * kHd + tx + 16 * j] = acc[0][j];
}

constexpr int kAdjSmem =
    (ssd::kChunkFloats + kQ * kHd + 2 * kQ * kQS + 2 * kN * kXS) * 4 + (2 + kThreads / 32) * kQ * 8;

// Sum v over the 16 lanes of a half-warp (the block_mm threads of one ty).
template <class T>
__device__ __forceinline__ T half_warp_sum(T v) {
#pragma unroll
  for (int o = 8; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// 4b. The chunk's adjoint: g_X, g_B, g_C, <X, g_xdt> and g_cs per step, and
// its share of g_D. kBf16: M stored rounded, and g_y, dt X rounded where the
// products read them (the causal products of kernel E's bf16 variant).
template <bool kBf16>
__global__ void __launch_bounds__(kThreads) ssd_adjoint_kernel(const Params p, const ssd::FwdArgs a) {
  __shared__ float red[kThreads / 32];
  const Where w = ssd::where(a, 0, a.nc);
  Chunk ch = ssd::chunk_of(a, w, a.mx[w.m]);
  float* GY = ssd::chunk_layout(ch, ssd::dynamic_smem());  // (kQ, kHd)
  float* Mt = GY + kQ * kHd;      // (kQ, kQS): M[t, u] = (Cs_t . Bs_u) decay
  float* Wt = Mt + kQ * kQS;      // (kQ, kQS): W[t, u] = <g_y[t], xdt[u]> decay
  float* Hin = Wt + kQ * kQS;     // (16, kXS): h_in(c)
  float* Gh = Hin + kN * kXS;     // (16, kXS): g_h(c)
  double* rs = reinterpret_cast<double*>(Gh + kN * kXS);  // (kQ,): sum_{u < t in c} P[t, u]
  double* cl = rs + kQ;                                    // (kQ,): sum_{t > u in c} P[t, u]
  double* colp = cl + kQ;                                  // (8, kQ): each warp's column sums
  const size_t units = w.unit * a.nc;
  ssd::stage_chunk(ch, GY);  // its scratch is GY's and Mt's memory
  ssd::fold_states(a.states + units * kState, a.sums + units, w.c, a.nc, false, Hin);
  ssd::fold_states(p.achunk + units * kState, a.sums + units, w.c, a.nc, true, Gh);
  float dsum = gather_gy(p, w, ch, GY);
  __syncthreads();

  const int tid = threadIdx.x, tx = tid % 16, ty = tid / 16, warp = tid / 32, lane = tid % 32;
  const int q = ch.q;
  // Rows r = 4 ty + i; the causal products stop at (or start from) the warp's rows.
  const int r_begin = ssd::rows_begin(), r_end = ssd::rows_end();
  const double* lcs = ch.lcs;
  const float* dts = ch.dts;
  // M, W and the chunk's own row and column sums of P = W (Cs_t . Bs_u), u < t.
  {
    float cb[4][4], gx[4][4];
    zero(cb);
    zero(gx);
    block_mm<4, 4, false, true, true>(cb, ch.Cs, kNS, ch.Bs, kNS, 0, kN);
    if constexpr (kBf16) {  // g_y . xdt_u, xdt_u = dt_u X_u
      block_mm<4, 4, false, true, true>(
          gx, GY, kHd, ch.X, kXS, 0, kHd, [](float v, int, int) { return round_bf16(v); },
          [dts](float v, int, int u) { return round_bf16(v * dts[u]); });
    } else {
      block_mm<4, 4, false, true, true>(gx, GY, kHd, ch.X, kXS, 0, kHd);
    }
    double row[4] = {0.0, 0.0, 0.0, 0.0}, col[4] = {0.0, 0.0, 0.0, 0.0};
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int t = 4 * ty + i, u = tx + 16 * j;
        float mv = 0.0f, wv = 0.0f;
        if (u <= t && t < q) {
          const float decay = expf(static_cast<float>(lcs[t] - lcs[u]));
          mv = kBf16 ? round_bf16(cb[i][j] * decay) : cb[i][j] * decay;
          wv = kBf16 ? gx[i][j] * decay : gx[i][j] * decay * dts[u];
          if (u < t) {
            const double pv = static_cast<double>(wv * cb[i][j]);
            row[i] += pv;
            col[j] += pv;
          }
        }
        Mt[t * kQS + u] = mv;
        Wt[t * kQS + u] = wv;
      }
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const double r = half_warp_sum(row[i]);
      if (tx == 0) rs[4 * ty + i] = r;
    }
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const double c = col[j] + __shfl_xor_sync(0xffffffffu, col[j], 16);  // the warp's two ty
      if (lane < 16) colp[warp * kQ + tx + 16 * j] = c;
    }
  }
  __syncthreads();
  if (tid < kQ) {
    double c = 0.0;
    for (int v = 0; v < kThreads / 32; ++v) c += colp[v * kQ + tid];
    cl[tid] = c;
  }
  __syncthreads();

  const ssd::Mixer& mx = a.mx[w.m];
  const float Dh = mx.D[w.head];
  const double total = lcs[kQ - 1];
  const size_t row0 = w.seq * a.Ls + ch.t0;  // stream row of the chunk's first step
  const bool has_in = w.c > 0, has_out = w.c + 1 < a.nc;
  // g_xdt = M^T g_y + exp(sum(c) - lcs[u]) Bs_u . g_h; g_X; <X, g_xdt>; and
  // g_cs, the cross-chunk terms from y_off and g_xdt_off. Rows r are steps.
  {
    float gxd[4][4], gcr[4][4], yo[4][4];
    zero(gxd);
    zero(gcr);
    zero(yo);
    if constexpr (kBf16) {
      block_mm<4, 4, true, false>(gxd, Mt, kQS, GY, kHd, r_begin, kQ, Keep(),
                                  [](float v, int, int) { return round_bf16(v); });
    } else {
      block_mm<4, 4, true, false>(gxd, Mt, kQS, GY, kHd, r_begin, kQ);  // t >= u
    }
    if (has_out) block_mm<4, 4, false, false>(gcr, ch.Bs, kNS, Gh, kXS, 0, kN);
    if (has_in) block_mm<4, 4, false, false>(yo, ch.Cs, kNS, Hin, kXS, 0, kN);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int r = 4 * ty + i;
      const float fu = expf(static_cast<float>(total - lcs[r]));
      const float er = expf(static_cast<float>(lcs[r]));
      float* gx_row = p.gxbc + (row0 + r) * p.conv_dim + w.head * kHd;
      float qv = 0.0f;
      double rowx = 0.0, colx = 0.0;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int c = tx + 16 * j;
        const float goff = fu * gcr[i][j];
        const float g = gxd[i][j] + goff;
        const float xv = ch.X[r * kXS + c];
        const float gy = GY[r * kHd + c];
        qv = fmaf(xv, g, qv);
        colx += static_cast<double>(xv * goff);
        rowx += static_cast<double>(gy * (er * yo[i][j]));
        if (r < q) gx_row[c] = fmaf(dts[r], g, Dh * gy);
      }
      qv = half_warp_sum(qv);
      rowx = half_warp_sum(rowx);
      colx = half_warp_sum(colx);
      if (tx == 0 && r < q) {
        p.qs[(row0 + r) * p.H + w.head] = qv;
        p.gcs[(row0 + r) * p.H + w.head] =
            (rs[r] + rowx) - (cl[r] + static_cast<double>(dts[r]) * colx);
      }
    }
  }
  // g_C = W Bs + exp(lcs[t]) g_y . h_in and g_B = W^T Cs + exp(sum(c) - lcs[u])
  // dt_u X_u . g_h, per step and state channel k = tx.
  {
    float gc[4][1], gcx[4][1], gb[4][1], gbx[4][1];
    zero(gc);
    zero(gcx);
    zero(gb);
    zero(gbx);
    block_mm<4, 1, false, false>(gc, Wt, kQS, ch.Bs, kNS, 0, r_end);     // u <= t
    block_mm<4, 1, true, false>(gb, Wt, kQS, ch.Cs, kNS, r_begin, kQ);   // t >= u
    if (has_in) block_mm<4, 1, false, true>(gcx, GY, kHd, Hin, kXS, 0, kHd);
    if (has_out) block_mm<4, 1, false, true>(gbx, ch.X, kXS, Gh, kXS, 0, kHd);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int r = 4 * ty + i;
      if (r >= q) continue;
      const float fu = expf(static_cast<float>(total - lcs[r]));
      const float er = expf(static_cast<float>(lcs[r]));
      float* out = p.gbc + ((row0 + r) * p.H + w.head) * 2 * kN;
      out[tx] = fmaf(fu * dts[r], gbx[i][0], gb[i][0]);
      out[kN + tx] = fmaf(er, gcx[i][0], gc[i][0]);
    }
  }
  dsum = block_sum(dsum, red);
  if (tid == 0) p.part_d[units + w.c] = dsum;
}

// 4c. g_dA, the reverse cumsum of g_cs over the whole stream, by one warp in
// fp64, 32 steps at a time from the end with a carry; then g_dt, the clip's
// and the softplus's adjoints, and the head's sums. grid (H, B * S, M).
__global__ void __launch_bounds__(32) ssd_adjoint_finish_kernel(const Params p) {
  const int head = blockIdx.x, bs = blockIdx.y, m = blockIdx.z, lane = threadIdx.x;
  const int Ls = p.Ls, H = p.H;
  const size_t seq = static_cast<size_t>(m) * p.B * p.S + bs;
  const size_t unit = seq * H + head, row0 = seq * Ls;
  const int64_t* order = p.fwd + static_cast<size_t>(bs % p.S) * Ls;
  const float* zx_b =
      p.zx + (static_cast<size_t>(m) * p.B + bs / p.S) * p.L * p.dproj + p.d + p.conv_dim + head;
  const Branch& br = p.br[m];
  const float A = -expf(br.A_log[head]);
  const float dtb = br.dt_bias[head];
  double carry = 0.0;
  float sum_a = 0.0f, sum_b = 0.0f;
  for (int r0 = 0; r0 < Ls; r0 += 32) {
    const int t = Ls - 1 - (r0 + lane);
    double v = t >= 0 ? p.gcs[(row0 + t) * H + head] : 0.0;
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      const double up = __shfl_up_sync(0xffffffffu, v, o);
      if (lane >= o) v += up;
    }
    v += carry;
    carry = __shfl_sync(0xffffffffu, v, 31);
    if (t >= 0) {
      const float g_da = static_cast<float>(v);
      const float pre = zx_b[order[t] * p.dproj] + dtb;
      const float sp = softplus(pre);
      const float dt = fminf(fmaxf(sp, p.dt_lo), p.dt_hi);
      float g_dt = fmaf(g_da, A, p.qs[(row0 + t) * H + head]);
      sum_a = fmaf(g_da, dt, sum_a);
      if (!(sp >= p.dt_lo && sp <= p.dt_hi)) g_dt = 0.0f;
      const float g_p = g_dt * sigmoid(pre);
      p.graw[(row0 + t) * H + head] = g_p;
      sum_b += g_p;
    }
  }
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) {
    sum_a += __shfl_xor_sync(0xffffffffu, sum_a, o);
    sum_b += __shfl_xor_sync(0xffffffffu, sum_b, o);
  }
  if (lane == 0) {
    float dsum = 0.0f;
    for (int c = 0; c < p.nc; ++c) dsum += p.part_d[unit * p.nc + c];
    float* part = p.part_head + unit * kHeadParts;
    part[0] = sum_a;
    part[1] = dsum;
    part[2] = sum_b;
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
  const size_t row = i / p.conv_dim;  // (b * S + s) * Ls + t
  const int Ls = p.Ls, d = p.d;
  const int t = static_cast<int>(row % Ls);
  const size_t bs = row / Ls;
  const int64_t* order = p.fwd + (bs % p.S) * Ls;
  const float* zx_b = p.zx + (static_cast<size_t>(m) * p.B + bs / p.S) * p.L * p.dproj + d + cc;
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
// entry s * Ls + pos; a partition has one entry per token); tap k of the conv
// read it for the output at pos + K - 1 - k, if that is inside the stream.
// The dt columns sum g_p. kBf16: each non-identity stream's share rounded
// before it is added.
template <bool kBf16>
__global__ void grad_zx_kernel(const Params p) {
  const int m = blockIdx.y;
  const size_t T = tokens(p);
  const int L = p.L, Ls = p.Ls, ys = p.ys;
  const int width = p.dproj - p.d;
  const size_t i = static_cast<size_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (i >= T * width) return;
  const int j = static_cast<int>(i % width);
  const size_t tok = i / width;
  const int b = static_cast<int>(tok / L), l = static_cast<int>(tok % L);
  const size_t seq0 = (static_cast<size_t>(m) * p.B + b) * p.S * Ls;  // row of (m, b, s = 0, 0)
  float acc = 0.0f;
  if (j < p.conv_dim) {
    const float* w = p.br[m].conv_w + static_cast<size_t>(j) * kConv;
    for (int q = 0; q < ys; ++q) {
      const int64_t e = p.merge[static_cast<size_t>(l) * ys + q];  // s * Ls + pos
      const int pos = static_cast<int>(e % Ls);
      if constexpr (kBf16) {
        float part = 0.0f;
#pragma unroll
        for (int k = 0; k < kConv; ++k) {
          const int out = pos + kConv - 1 - k;
          if (out < Ls) part = fmaf(w[k], p.gxbc[(seq0 + e + kConv - 1 - k) * p.conv_dim + j], part);
        }
        acc += (p.ident >> (e / Ls)) & 1 ? part : round_bf16(part);
      } else {
#pragma unroll
        for (int k = 0; k < kConv; ++k) {
          const int out = pos + kConv - 1 - k;
          if (out < Ls) acc = fmaf(w[k], p.gxbc[(seq0 + e + kConv - 1 - k) * p.conv_dim + j], acc);
        }
      }
    }
  } else {
    for (int q = 0; q < ys; ++q) {
      const int64_t e = p.merge[static_cast<size_t>(l) * ys + q];
      const float v = p.graw[(seq0 + e) * p.H + (j - p.conv_dim)];
      acc += kBf16 && !((p.ident >> (e / Ls)) & 1) ? round_bf16(v) : v;
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
  const int L = p.L, Ls = p.Ls, S = p.S;
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
      const int t = row % Ls, bs = row / Ls;
      const int64_t* order = p.fwd + static_cast<size_t>(bs % S) * Ls;
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

int tiles(int rows, int cols, int bn, int M) {
  return M * ((rows + tc::kBM - 1) / tc::kBM) * ((cols + bn - 1) / bn);
}

void set_dims(Params& p, int M, int B, int L, int Ls, int h, int d, int H, int S) {
  p.B = B;
  p.L = L;
  p.Ls = Ls;
  p.ys = Ls == L ? S : 1;
  p.h = h;
  p.d = d;
  p.H = H;
  p.S = S;
  p.conv_dim = d + 2 * kN;
  p.dproj = 2 * d + 2 * kN + H;
  p.nc = ssd::num_chunks(Ls);
  const int T = B * L;
  p.sp_inw = tc::splits_for(tiles(p.dproj, h, 128, M), T);
  p.sp_outw = tc::splits_for(tiles(h, d, 64, M), T);
  p.part_size = std::max(p.sp_inw > 1 ? static_cast<size_t>(p.sp_inw) * p.dproj * h : 0,
                         p.sp_outw > 1 ? static_cast<size_t>(p.sp_outw) * h * d : 0);
}

// Lay the workspace out for these shapes (pointers into `base` when given);
// returns its size in floats.
size_t layout(Params& p, float* base, int M) {
  const size_t T = static_cast<size_t>(p.B) * p.L, R = static_cast<size_t>(p.B) * p.S * p.Ls;
  const size_t d = p.d, Ty = T * p.ys, units = static_cast<size_t>(p.B) * p.S * p.H;
  const size_t sizes[] = {
      T * d, Ty * d, Ty * d, T * d, T * d,         // gm, y, gy, merged, gnw
      T * p.dproj, R * p.conv_dim,                 // gzx, gxbc
      R * p.H, R * p.H * 2 * kN,                   // graw, gbc
      ssd::state_floats(1, p.B, p.S, p.Ls, p.H),   // states
      units * p.nc * kState,                       // achunk
      R * p.H * 2, R * p.H,                        // gcs (doubles), qs
      units * p.nc,                                // part_d
      units * kHeadParts,                          // part_head
      static_cast<size_t>(kSplits) * p.conv_dim * (kConv + 1),  // part_conv
      static_cast<size_t>(kSplits) * d,            // part_nw
      p.part_size,                                 // part
  };
  float* gcs = nullptr;
  float** ptrs[] = {&p.gm,    &p.y,      &p.gy,        &p.merged,   &p.gnw,       &p.gzx,
                    &p.gxbc,  &p.graw,   &p.gbc,       &p.states,   &p.achunk,    &gcs,
                    &p.qs,    &p.part_d, &p.part_head, &p.part_conv, &p.part_nw, &p.part};
  size_t total = 0;
  for (int i = 0; i < 18; ++i) {
    if (base != nullptr) *ptrs[i] = base + total;
    total += (sizes[i] * M + 3) / 4 * 4;  // every array 16-byte aligned
  }
  p.gcs = reinterpret_cast<double*>(gcs);
  return total;
}

unsigned blocks_for(size_t n, int threads) { return static_cast<unsigned>((n + threads - 1) / threads); }

// Launch a product whose depth is split `splits` ways into `dst[m]` (rows x
// cols per branch): straight with one split, else into p.part and summed.
template <int BN, class Op>
int launch_split(Params p, float* dst0, float* dst1, int rows, int cols, int M, int splits,
                 cudaStream_t st) {
  p.dst[0] = dst0;
  p.dst[1] = dst1;
  p.splits = splits;
  int err = tc::launch_gemm_tc<BN, Op>(p, rows, cols, M, st, splits);
  if (err != 0 || splits == 1) return err;
  tc::SplitSum q{};
  for (int m = 0; m < M; ++m) {
    q.part[m] = p.part + m * p.part_size;
    q.out[m] = m == 0 ? dst0 : dst1;
  }
  q.n = rows * cols;
  q.splits = splits;
  return tc::launch_sum_splits(q, M, st);
}

// The chain of launches for x of type T (see ssd_mixer_bwd).
template <class T>
int run(Params& p, int M, cudaStream_t st) {
  constexpr bool kB = kIsBf16<T>;
  const int B = p.B, L = p.L, Ls = p.Ls, h = p.h, d = p.d, H = p.H, S = p.S;
  const int T_ = B * L, R = B * S * Ls;
  static const cudaError_t attr[] = {
      cudaFuncSetAttribute(ssd_chunk_adj_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                           kChunkAdjSmem),
      cudaFuncSetAttribute(ssd_adjoint_kernel<kB>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                           kAdjSmem),
  };
  for (const cudaError_t e : attr) {
    if (e != cudaSuccess) return static_cast<int>(e);
  }

  ssd::FwdArgs core{};
  for (int m = 0; m < M; ++m) {
    const Branch& br = p.br[m];
    core.mx[m] = ssd::Mixer{br.conv_w, br.conv_b, br.dt_bias, br.A_log, br.D};
  }
  core.fwd = p.fwd;
  core.zx = p.zx;
  core.y = p.y;
  core.B = B;
  core.Ls = Ls;
  core.Lt = L;
  core.d = d;
  core.H = H;
  core.S = S;
  core.y_streams = p.ys;
  core.dproj = p.dproj;
  core.bf16 = kB;
  core.dt_lo = p.dt_lo;
  core.dt_hi = p.dt_hi;
  ssd::set_state_workspace(core, p.states, M);

  int err = tc::launch_gemm_tc<128, GradOutProj<T>>(p, T_, d, M, st);
  if (err == 0) err = ssd::launch_ssd_fwd(core, M, st);
  if (err == 0) {
    gate_norm_bwd_kernel<kB><<<dim3(T_, M), kRowThreads, 0, st>>>(p);
    err = static_cast<int>(cudaGetLastError());
  }
  if (err == 0 && p.nc > 1) {
    ssd_chunk_adj_kernel<<<dim3((p.nc - 1) * H, B * S, M), kThreads, kChunkAdjSmem, st>>>(p, core);
    err = static_cast<int>(cudaGetLastError());
  }
  if (err == 0) {
    ssd_adjoint_kernel<kB><<<dim3(p.nc * H, B * S, M), kThreads, kAdjSmem, st>>>(p, core);
    err = static_cast<int>(cudaGetLastError());
  }
  if (err == 0) {
    ssd_adjoint_finish_kernel<<<dim3(H, B * S, M), 32, 0, st>>>(p);
    err = static_cast<int>(cudaGetLastError());
  }
  if (err == 0) {
    grad_preact_kernel<<<dim3(blocks_for(static_cast<size_t>(R) * p.conv_dim, 256), M), 256, 0, st>>>(p);
    err = static_cast<int>(cudaGetLastError());
  }
  if (err == 0) {
    grad_zx_kernel<kB><<<dim3(blocks_for(static_cast<size_t>(T_) * (p.dproj - d), 256), M), 256, 0, st>>>(p);
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
  if (err == 0) err = tc::launch_gemm_tc<128, GradX<T>>(p, T_, h, M, st);
  if (err == 0) {
    err = launch_split<128, GradInW<T>>(p, p.br[0].g_in_w, p.br[1].g_in_w, p.dproj, h, M, p.sp_inw, st);
  }
  if (err == 0) {
    err = launch_split<64, GradOutW<T>>(p, p.br[0].g_out_w, p.br[1].g_out_w, h, d, M, p.sp_outw, st);
  }
  if (err == 0) {
    finalize_kernel<<<dim3(blocks_for(p.conv_dim, 128), M), 128, 0, st>>>(p);
    err = static_cast<int>(cudaGetLastError());
  }
  return err;
}

}  // namespace

// Floats of workspace that ssd_mixer_bwd needs for these shapes.
extern "C" long long ssd_mixer_bwd_workspace_floats(int M, int B, int L, int Ls, int h, int d,
                                                    int H, int S) {
  Params p{};
  set_dims(p, M, B, L, Ls, h, d, H, S);
  return static_cast<long long>(layout(p, nullptr, M));
}

// `ptrs` holds 19 pointers per branch, in the order of struct Branch, for
// M = 1 or 2 branches, all contiguous: x, g and gx of `dtype` (0 fp32, 1
// bf16), the weights and their gradients fp32. `fwd` (S, Ls) and `merge`
// (L, S, or L, 1 for a partition) are int64: with Ls = L each row of fwd is
// a permutation of 0 .. L-1, with Ls = L / S its rows partition them. `zx`
// is the residual (M, B * L, dproj) that ssd_mixer_fwd wrote for the same x
// and weights. `ident` (bf16 only) has bit s set when stream s is in token
// order. Launches the chain on `stream`; returns the first launch's
// cudaError_t that is not 0, or -1 for shapes or a dtype that are not built.
extern "C" int ssd_mixer_bwd(void* const* ptrs, int M, const void* fwd, const void* merge,
                             const void* zx, void* workspace, int B, int L, int Ls, int h,
                             int d, int n, int H, int K, int S, float scale, float eps,
                             float dt_lo, float dt_hi, int dtype, int ident, void* stream) {
  if (M < 1 || M > 2 || n != kN || K != kConv || H < 1 || d != H * kHd ||
      d > kRowThreads * kMaxPerThread || S < 1 || S > kMaxStreams || L < 1 || Ls < 1 ||
      (Ls != L && Ls * S != L) || dtype < 0 || dtype > 1) {
    return -1;
  }
  Params p{};
  for (int m = 0; m < M; ++m) {
    void* const* q = ptrs + m * kBranchPtrs;
    const float* in[8];
    float* out[8];
    for (int i = 0; i < 8; ++i) in[i] = static_cast<const float*>(q[2 + i]);
    for (int i = 0; i < 8; ++i) out[i] = static_cast<float*>(q[11 + i]);
    p.br[m] = Branch{q[0], q[1], in[0], in[1], in[2], in[3], in[4], in[5], in[6], in[7],
                     q[10], out[0], out[1], out[2], out[3], out[4], out[5], out[6], out[7]};
  }
  p.fwd = static_cast<const int64_t*>(fwd);
  p.merge = static_cast<const int64_t*>(merge);
  p.zx = static_cast<const float*>(zx);
  set_dims(p, M, B, L, Ls, h, d, H, S);
  p.scale = scale;
  p.eps = eps;
  p.dt_lo = dt_lo;
  p.dt_hi = dt_hi;
  p.ident = ident;
  layout(p, static_cast<float*>(workspace), M);
  p.splits = 1;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return dtype == 1 ? run<bf16>(p, M, st) : run<float>(p, M, st);
}
