// Whole Mamba-1 mixer backward for Hopper (sm_90a), for one or two mixers
// (the Spiral block's two branches) in one call.
//
// Replaces the TPU kernel diffma_tpu/ops/fused_mixer.py::_mixer_bwd_kernel,
// as its launcher _monolithic_bwd drives it (the custom VJPs of
// mamba_mixer_fused and mamba_dual_mixer_fused). Given x and g = dL/dout
// (B, L, h) per branch and the mixer's 9 weights (torch layout, A as A_log),
// it recomputes the forward from x alone, as kernel C computes it
// (fused_mixer_fwd.cu), and writes gx (B, L, h) and the 9 weight gradients
// summed over the batch, all fp32:
//
//     forward   xz = x W_in^T; per stream s (token order fwd[s]):
//               pre = conv(xz_u) + conv_b; u = silu(pre); [dt_r, B, C] = u W_x^T
//               raw = dt_r W_dt^T + dt_b; y_s = scan(u, raw, A, B, C, D) silu(z)
//               out = (scale sum_s y_s, in token order) W_out^T
//     backward  gm = g W_out; g_y = scale gm[fwd[s]]   (merge adjoint: a gather)
//               dW_out = g^T merged
//               du, draw, dB, dC, dz, dA, dD: the scan's adjoint (scan_bwd.cuh)
//               d dt_r = draw W_dt;  dW_dt = draw^T dt_r;  d dt_b = sum draw
//               dW_x = [d dt_r, dB, dC]^T u
//               dpre = (du + [d dt_r, dB, dC] W_x) silu'(pre)
//               conv adjoints per stream, taps never crossing a stream's start;
//               dxz = sum over streams back in token order (through the merge
//               table: each stream is a permutation, so this is a gather)
//               gx = dxz W_in;  dW_in = dxz^T x;  dA_log = dA A (A = -exp(A_log))
//
// Every product is this file's own fp32 code on the CUDA cores (no cuBLAS,
// no TF32), so that the kernel agrees with its plain PyTorch version to fp32
// rounding.
//
// Bound on an H100 SXM (67 TFLOP/s fp32 outside the tensor cores,
// 3.35 TB/s). At DiffMa-B/2's training shapes, batch 8, both branches
// (B = 8, L = 196, h = 512, d = 1024, n = 16, r = 32, S = 3), one call does
// about 35.8 GFLOP: the forward recompute 9.5 (kernel C's forward up to the
// scan) and the backward 26.3 (two products per projection, the conv's and
// the scan's adjoints). That is 0.53 ms at the fp32 rate, against about 46 MB
// of weights, gradients, x, g and gx, 14 us at the memory rate. So operations
// bound it.
//
// Design, simple and right first: a chain of launches over a workspace the
// caller allocates (mixer_fused_bwd_workspace_floats; about 390 MB at the
// shapes above), with the branch on blockIdx.z in every launch, so both
// branches share each launch and their gradients never mix.
// 1. in_proj and conv + x_proj: kernel C's GEMMs and loaders again (the
//    conv's pre-activation is stored as well, for the SiLU adjoint).
// 2. gm = g W_out, a GEMM.
// 3. the scan adjoint: kernel B's device code (scan_bwd.cuh), with dt_proj
//    fused as in kernel C (the channel's 32 weights in registers), z and g_y
//    read through the token index, dz and y written back in token order.
//    Per-sequence partials of dA, dD and d dt_b; dB and dC as per-block
//    partials, summed by a second pass.
// 4. d dt_r, dW_dt, dW_x, dpre: GEMMs; the two weight gradients, whose depth
//    is the B * S * L stream rows, split that depth over blocks and sum the
//    partials in a second pass.
// 5. conv adjoints: dxz by a gather-sum through the merge table (no atomics);
//    dconv_w and dconv_b by column sums over row splits.
// 6. gx = dxz W_in, dW_in = dxz^T x, dW_out = g^T merged: GEMMs.
// 7. a pass that sums every partial in a fixed order. Nothing uses atomics,
//    so the result is deterministic.
// All GEMMs are one tiled template (gemm_ops.cuh; 64 x 64 tiles or smaller, 16-deep
// k-slabs in shared memory, register tiles, the next slab loaded into
// registers during the products); each operand is read along whichever of
// its axes is contiguous, so the loads coalesce. The TPU kernel's one-hot
// permutation matmuls and its padding of L to chunks exist for the MXU and
// VMEM; here they are index gathers and exact bounds.
//
// The three kinds of scan spec that kernel C runs, it differentiates:
// * full-length streams (Ls = L, each a permutation of the tokens), one or
//   two branches: the chain above.
// * an exact partition (Ls = L / S, every token in exactly one stream:
//   EfficientVMamba's atrous streams), one branch. Each stream is a sequence
//   of its own: the conv's pad and the scan's state start at its first step,
//   so the scan adjoint runs chains of Ls steps (its checkpoints every kChunk
//   steps end in an exact tail, nothing padded). dz and y have one token row
//   each (each token lies in one stream), the conv adjoint's gather-sum reads
//   one merge entry per token, and the weight-gradient reductions run over
//   the B * S * Ls = B * L stream rows.
// * the Mamba-1 vim quirk (S = 2, the tokens forward and reversed), one
//   branch. The forward is out[t] = scale (y_0[t] W_out^T + flip_h(y_1[t]
//   W_out^T)) with y_s[t] the stream's step t, not merged. So the stream
//   gradients come with no row permute, both from one product of g against
//   [W_out | flip_rows(W_out)] (the second half's weight rows read in reverse,
//   no copy): g_y_s[t] = scale gm[t, s d : (s + 1) d]; and dW_out = P[:, :d] +
//   flip_rows(P[:, d:]) with P = scale g^T [y_0 | y_1] (h x 2d, stream steps
//   along the depth), a product and a fold. Everything upstream of the merge
//   is the full-length chain.

#include <cuda_runtime.h>
#include <stdint.h>

#include <algorithm>

#include "gemm_ops.cuh"
#include "scan_bwd.cuh"

namespace {

using scan_bwd::kChunk;
using scan_bwd::kWarp;
using scan_bwd::sigmoid;
using scan_bwd::softplus;

constexpr int kN = 16;        // d_state
constexpr int kConv = 4;      // conv taps
constexpr int kMaxRank = 32;  // dt_rank
constexpr int kMaxStreams = 4;
constexpr int kBranchPtrs = 21;
constexpr int kConvSplits = 16;  // row splits of the conv weight gradients
constexpr int kScanParts = kN + 2;  // per sequence and channel: dA (n), dD, d dt_b

struct Branch {
  const float* x;       // (B, L, h)
  const float* g;       // (B, L, h)
  const float* in_w;    // (2d, h)
  const float* conv_w;  // (d, K)
  const float* conv_b;  // (d,)
  const float* xp_w;    // (r + 2n, d)
  const float* dt_w;    // (d, r)
  const float* dt_b;    // (d,)
  const float* A_log;   // (d, n)
  const float* D;       // (d,)
  const float* out_w;   // (h, d)
  float* gx;            // (B, L, h)
  float* g_in_w;        // the gradients, each shaped as its weight
  float* g_conv_w;
  float* g_conv_b;
  float* g_xp_w;
  float* g_dt_w;
  float* g_dt_b;
  float* g_A_log;
  float* g_D;
  float* g_out_w;
};

// Workspace arrays hold both branches, branch m at offset m * (its size).
// T = B * L token rows; R = B * S * Ls stream rows, row (b * S + s) * Ls + t in
// stream order. A token lies in ys streams (S, or 1 for a partition): the
// merge table's width, and the rows per token of the token-order arrays dz
// and y, row (b * ys + s) * L + token.
struct Params {
  Branch br[2];
  const int64_t* fwd;    // (S, Ls): stream s visits tokens fwd[s, 0..Ls-1]
  const int64_t* merge;  // (L, ys): the stream rows s * Ls + position of token l
  float* xz;             // (T, 2d)
  float* u;              // (R, d) stream order
  float* pre;            // (R, d) stream order: the conv's output before SiLU
  float* xdb;            // (R, r + 2n) stream order: dt_r, B, C
  float* gm;             // (T, gm_cols): g W_out, or [g W_out | g flip_rows(W_out)]
  float* ckpt;           // (B * S, nq, n, d): the scan's chunk-entry states
  float* du;             // (R, d) stream order: the scan's du, then dpre
  float* ddb;            // (R, d) stream order: d raw delta
  float* dz;             // (T * ys, d) token order
  float* y;              // (T * ys, d) token order: the gated scan output
  float* bc;             // (R, nblk, 32): dB/dC partials per channel block
  float* dxdb;           // (R, r + 2n): d dt_r, dB, dC
  float* dxz;            // (T, 2d)
  float* part_scan;      // (B * S, d, kScanParts)
  float* part_conv;      // (kConvSplits, d, K + 1): dconv_w (K), dconv_b
  float* part_w;         // (splits, max((r + 2n) d, d r)): split-K partials
  float* pout;           // (h, 2d): the vim quirk's P, before the fold
  int B, L, Ls, h, d, r, S, ys, nq, nblk, splits;
  bool quirk;
  float scale;
};

__device__ __forceinline__ size_t tokens(const Params& p) { return static_cast<size_t>(p.B) * p.L; }
__device__ __forceinline__ size_t srows(const Params& p) {
  return static_cast<size_t>(p.B) * p.S * p.Ls;
}
__device__ __forceinline__ int r2n(const Params& p) { return p.r + 2 * kN; }
__device__ __forceinline__ int gm_cols(const Params& p) { return p.quirk ? 2 * p.d : p.d; }

// Per-branch views of the workspace arrays.
__device__ __forceinline__ float* xz_of(const Params& p, int m) { return p.xz + m * tokens(p) * 2 * p.d; }
__device__ __forceinline__ float* u_of(const Params& p, int m) { return p.u + m * srows(p) * p.d; }
__device__ __forceinline__ float* pre_of(const Params& p, int m) { return p.pre + m * srows(p) * p.d; }
__device__ __forceinline__ float* xdb_of(const Params& p, int m) { return p.xdb + m * srows(p) * r2n(p); }
__device__ __forceinline__ float* gm_of(const Params& p, int m) { return p.gm + m * tokens(p) * gm_cols(p); }
__device__ __forceinline__ float* du_of(const Params& p, int m) { return p.du + m * srows(p) * p.d; }
__device__ __forceinline__ float* ddb_of(const Params& p, int m) { return p.ddb + m * srows(p) * p.d; }
__device__ __forceinline__ float* dz_of(const Params& p, int m) { return p.dz + m * tokens(p) * p.ys * p.d; }
__device__ __forceinline__ float* y_of(const Params& p, int m) { return p.y + m * tokens(p) * p.ys * p.d; }
__device__ __forceinline__ float* dxdb_of(const Params& p, int m) { return p.dxdb + m * srows(p) * r2n(p); }
__device__ __forceinline__ float* dxz_of(const Params& p, int m) { return p.dxz + m * tokens(p) * 2 * p.d; }
__device__ __forceinline__ size_t part_w_size(const Params& p) {
  return static_cast<size_t>(p.splits) * max(r2n(p) * p.d, p.d * p.r);
}

__device__ __forceinline__ float silu(float x) { return x * sigmoid(x); }
__device__ __forceinline__ float dsilu(float x) {
  const float s = sigmoid(x);
  return s * (1.0f + x * (1.0f - s));
}

struct InProj {  // xz = x W_in^T
  static constexpr bool kAByRow = false, kBByRow = false;
  const float *x, *w;
  float* c;
  int rows, cols, depth;
  __device__ InProj(const Params& p, int m)
      : x(p.br[m].x), w(p.br[m].in_w), c(xz_of(p, m)),
        rows(static_cast<int>(tokens(p))), cols(2 * p.d), depth(p.h) {}
  __device__ float a(int row, int k) const { return x[static_cast<size_t>(row) * depth + k]; }
  __device__ float b(int col, int k) const { return w[static_cast<size_t>(col) * depth + k]; }
  __device__ void store(int row, int col, int, float v) const { c[static_cast<size_t>(row) * cols + col] = v; }
};

struct ConvXProj {  // pre = conv(gathered xz_u) + conv_b; u = silu(pre); xdb = u W_x^T
  static constexpr bool kAByRow = false, kBByRow = false;
  const float *xz, *conv_w, *conv_b, *w;
  const int64_t* fwd;
  float *u, *pre, *c;
  int rows, cols, depth, L, Ls, S;
  bool store_u;
  __device__ ConvXProj(const Params& p, int m)
      : xz(xz_of(p, m)), conv_w(p.br[m].conv_w), conv_b(p.br[m].conv_b), w(p.br[m].xp_w),
        fwd(p.fwd), u(u_of(p, m)), pre(pre_of(p, m)), c(xdb_of(p, m)),
        rows(static_cast<int>(srows(p))), cols(r2n(p)), depth(p.d), L(p.L), Ls(p.Ls), S(p.S),
        store_u(blockIdx.y == 0) {}  // the first column tile writes u and pre once
  __device__ float a(int row, int ch) const {  // row = (b * S + s) * Ls + t
    const int t = row % Ls, bs = row / Ls;
    const int64_t* order = fwd + static_cast<size_t>(bs % S) * Ls;
    const float* xz_b = xz + static_cast<size_t>(bs / S) * L * 2 * depth;
    float acc = conv_b[ch];
#pragma unroll
    for (int k = 0; k < kConv; ++k) {
      const int tt = t - (kConv - 1) + k;
      if (tt >= 0) acc = fmaf(conv_w[ch * kConv + k], xz_b[order[tt] * 2 * depth + ch], acc);
    }
    const float v = silu(acc);
    if (store_u) {
      pre[static_cast<size_t>(row) * depth + ch] = acc;
      u[static_cast<size_t>(row) * depth + ch] = v;
    }
    return v;
  }
  __device__ float b(int col, int ch) const { return w[static_cast<size_t>(col) * depth + ch]; }
  __device__ void store(int row, int col, int, float v) const { c[static_cast<size_t>(row) * cols + col] = v; }
};

// gm = g W_out; with the vim quirk [g W_out | g flip_rows(W_out)], the second
// half reading W_out's rows h - 1 - k.
struct GradOutProj {
  static constexpr bool kAByRow = false, kBByRow = true;
  const float *g, *w;
  float* c;
  int rows, cols, depth, d;
  __device__ GradOutProj(const Params& p, int m)
      : g(p.br[m].g), w(p.br[m].out_w), c(gm_of(p, m)),
        rows(static_cast<int>(tokens(p))), cols(gm_cols(p)), depth(p.h), d(p.d) {}
  __device__ float a(int row, int k) const { return g[static_cast<size_t>(row) * depth + k]; }
  __device__ float b(int col, int k) const {
    return col < d ? w[static_cast<size_t>(k) * d + col]
                   : w[static_cast<size_t>(depth - 1 - k) * d + (col - d)];
  }
  __device__ void store(int row, int col, int, float v) const { c[static_cast<size_t>(row) * cols + col] = v; }
};

struct GradDtRank {  // d dt_r = draw W_dt, into dxdb[:, :r]
  static constexpr bool kAByRow = false, kBByRow = true;
  const float *ddb, *w;
  float* c;
  int rows, cols, depth, ld;
  __device__ GradDtRank(const Params& p, int m)
      : ddb(ddb_of(p, m)), w(p.br[m].dt_w), c(dxdb_of(p, m)),
        rows(static_cast<int>(srows(p))), cols(p.r), depth(p.d), ld(r2n(p)) {}
  __device__ float a(int row, int k) const { return ddb[static_cast<size_t>(row) * depth + k]; }
  __device__ float b(int col, int k) const { return w[static_cast<size_t>(k) * cols + col]; }
  __device__ void store(int row, int col, int, float v) const { c[static_cast<size_t>(row) * ld + col] = v; }
};

struct GradXProjW {  // dW_x = dxdb^T u, per split
  static constexpr bool kAByRow = true, kBByRow = true;
  const float *dxdb, *u;
  float* c;
  int rows, cols, depth;
  __device__ GradXProjW(const Params& p, int m)
      : dxdb(dxdb_of(p, m)), u(u_of(p, m)), c(p.part_w + m * part_w_size(p)),
        rows(r2n(p)), cols(p.d), depth(static_cast<int>(srows(p))) {}
  __device__ float a(int row, int k) const { return dxdb[static_cast<size_t>(k) * rows + row]; }
  __device__ float b(int col, int k) const { return u[static_cast<size_t>(k) * cols + col]; }
  __device__ void store(int row, int col, int split, float v) const {
    c[(static_cast<size_t>(split) * rows + row) * cols + col] = v;
  }
};

struct GradDtW {  // dW_dt = draw^T dt_r, per split
  static constexpr bool kAByRow = true, kBByRow = true;
  const float *ddb, *xdb;
  float* c;
  int rows, cols, depth, ld;
  __device__ GradDtW(const Params& p, int m)
      : ddb(ddb_of(p, m)), xdb(xdb_of(p, m)), c(p.part_w + m * part_w_size(p)),
        rows(p.d), cols(p.r), depth(static_cast<int>(srows(p))), ld(r2n(p)) {}
  __device__ float a(int row, int k) const { return ddb[static_cast<size_t>(k) * rows + row]; }
  __device__ float b(int col, int k) const { return xdb[static_cast<size_t>(k) * ld + col]; }
  __device__ void store(int row, int col, int split, float v) const {
    c[(static_cast<size_t>(split) * rows + row) * cols + col] = v;
  }
};

struct GradPre {  // dpre = (du + dxdb W_x) silu'(pre), in place of du
  static constexpr bool kAByRow = false, kBByRow = true;
  const float *dxdb, *w, *pre;
  float* du;
  int rows, cols, depth;
  __device__ GradPre(const Params& p, int m)
      : dxdb(dxdb_of(p, m)), w(p.br[m].xp_w), pre(pre_of(p, m)), du(du_of(p, m)),
        rows(static_cast<int>(srows(p))), cols(p.d), depth(r2n(p)) {}
  __device__ float a(int row, int k) const { return dxdb[static_cast<size_t>(row) * depth + k]; }
  __device__ float b(int col, int k) const { return w[static_cast<size_t>(k) * cols + col]; }
  __device__ void store(int row, int col, int, float v) const {
    const size_t i = static_cast<size_t>(row) * cols + col;
    du[i] = (du[i] + v) * dsilu(pre[i]);
  }
};

struct GradX {  // gx = dxz W_in
  static constexpr bool kAByRow = false, kBByRow = true;
  const float *dxz, *w;
  float* c;
  int rows, cols, depth;
  __device__ GradX(const Params& p, int m)
      : dxz(dxz_of(p, m)), w(p.br[m].in_w), c(p.br[m].gx),
        rows(static_cast<int>(tokens(p))), cols(p.h), depth(2 * p.d) {}
  __device__ float a(int row, int k) const { return dxz[static_cast<size_t>(row) * depth + k]; }
  __device__ float b(int col, int k) const { return w[static_cast<size_t>(k) * cols + col]; }
  __device__ void store(int row, int col, int, float v) const { c[static_cast<size_t>(row) * cols + col] = v; }
};

struct GradInW {  // dW_in = dxz^T x
  static constexpr bool kAByRow = true, kBByRow = true;
  const float *dxz, *x;
  float* c;
  int rows, cols, depth;
  __device__ GradInW(const Params& p, int m)
      : dxz(dxz_of(p, m)), x(p.br[m].x), c(p.br[m].g_in_w),
        rows(2 * p.d), cols(p.h), depth(static_cast<int>(tokens(p))) {}
  __device__ float a(int row, int k) const { return dxz[static_cast<size_t>(k) * rows + row]; }
  __device__ float b(int col, int k) const { return x[static_cast<size_t>(k) * cols + col]; }
  __device__ void store(int row, int col, int, float v) const { c[static_cast<size_t>(row) * cols + col] = v; }
};

struct GradOutW {  // dW_out = g^T merged, merged = scale sum_s y_s in token order
  static constexpr bool kAByRow = true, kBByRow = true;
  const float *g, *y;
  float* c;
  float scale;
  int rows, cols, depth, L, S;
  __device__ GradOutW(const Params& p, int m)
      : g(p.br[m].g), y(y_of(p, m)), c(p.br[m].g_out_w), scale(p.scale),
        rows(p.h), cols(p.d), depth(static_cast<int>(tokens(p))), L(p.L), S(p.ys) {}
  __device__ float a(int row, int k) const { return g[static_cast<size_t>(k) * rows + row]; }
  __device__ float b(int col, int k) const {  // k = b * L + l
    const float* y0 = y + (static_cast<size_t>(k / L) * S * L + k % L) * cols + col;
    float acc = 0.0f;
    for (int s = 0; s < S; ++s) acc += y0[static_cast<size_t>(s) * L * cols];  // stream order
    return acc * scale;
  }
  __device__ void store(int row, int col, int, float v) const { c[static_cast<size_t>(row) * cols + col] = v; }
};

// The vim quirk's P = scale g^T [y_0 | y_1] (h x 2d), y_s at the stream's step
// t for depth index k = b * L + t; fold_out_w_kernel folds it into dW_out.
struct GradOutWQuirk {
  static constexpr bool kAByRow = true, kBByRow = true;
  const float *g, *y;
  const int64_t* fwd;
  float* c;
  float scale;
  int rows, cols, depth, L, d;
  __device__ GradOutWQuirk(const Params& p, int m)
      : g(p.br[m].g), y(y_of(p, m)), fwd(p.fwd), c(p.pout), scale(p.scale),
        rows(p.h), cols(2 * p.d), depth(static_cast<int>(tokens(p))), L(p.L), d(p.d) {}
  __device__ float a(int row, int k) const { return g[static_cast<size_t>(k) * rows + row]; }
  __device__ float b(int col, int k) const {  // y_s[token] at (b * 2 + s) * L + token
    const int s = col < d ? 0 : 1, t = k % L;
    const size_t tok = static_cast<size_t>(fwd[s * L + t]);
    return y[((static_cast<size_t>(k / L) * 2 + s) * L + tok) * d + (col - s * d)] * scale;
  }
  __device__ void store(int row, int col, int, float v) const { c[static_cast<size_t>(row) * cols + col] = v; }
};

// ---------------------------------------------------------------------------
// The scan adjoint: one thread per (branch, b, s, channel), scan_bwd::sweep.
// ---------------------------------------------------------------------------

struct MixerScanIO {
  const float* u_p;  // this sequence's u rows (L, d), at channel c
  const float* xdb;  // this sequence's xdb rows (L, r + 2n)
  const float* xz_b;  // this batch element's xz (L, 2d)
  const float* gm_b;  // this batch element's gm (L, d)
  const int64_t* order;  // fwd[s]
  float* du;   // stream-order rows of this sequence, at channel c
  float* ddb;
  float* dz;   // token-order rows of this sequence, at channel c
  float* y;
  float* bc;   // this sequence's dB/dC partials (L, nblk, 32)
  float* ckpt;
  float (*sDt)[kMaxRank];
  float (*sB)[kN];
  float (*sC)[kN];
  int64_t* sTok;
  float wdt[kMaxRank];
  float dtb, scale, dtb_sum;
  int c, d, r, ld, nblk, t0, gm_ld;
  bool active, by_step;  // by_step: gm's row is the stream's step (vim quirk), not its token

  __device__ bool gated() const { return true; }
  __device__ void stage(int t0_, int steps) {
    t0 = t0_;
    const float* rows = xdb + static_cast<size_t>(t0) * ld;
    for (int i = threadIdx.x; i < steps * kMaxRank; i += kWarp) {
      const int t = i / kMaxRank, j = i % kMaxRank;
      sDt[t][j] = j < r ? rows[static_cast<size_t>(t) * ld + j] : 0.0f;
    }
    for (int i = threadIdx.x; i < steps * kN; i += kWarp) {
      const int t = i / kN, k = i % kN;
      sB[t][k] = rows[static_cast<size_t>(t) * ld + r + k];
      sC[t][k] = rows[static_cast<size_t>(t) * ld + r + kN + k];
    }
    for (int i = threadIdx.x; i < steps; i += kWarp) sTok[i] = order[t0 + i];
  }
  __device__ float delta(int s) const {  // dt_proj, fused as in kernel C
    float part[4] = {0.0f, 0.0f, 0.0f, 0.0f};
#pragma unroll
    for (int j = 0; j < kMaxRank; ++j) part[j % 4] = fmaf(wdt[j], sDt[s][j], part[j % 4]);
    return (part[0] + part[1]) + (part[2] + part[3]) + dtb;
  }
  __device__ float u(int s) const { return active ? u_p[static_cast<size_t>(t0 + s) * d] : 0.0f; }
  __device__ float z(int s) const { return active ? xz_b[sTok[s] * 2 * d + d] : 0.0f; }
  __device__ float g(int s) const {
    return active ? scale * gm_b[(by_step ? t0 + s : sTok[s]) * gm_ld] : 0.0f;
  }
  __device__ const float* B(int s) const { return sB[s]; }
  __device__ const float* C(int s) const { return sC[s]; }
  __device__ void save_ckpt(int q, const float (&h)[kN]) {
    if (!active) return;
#pragma unroll
    for (int k = 0; k < kN; ++k) ckpt[(static_cast<size_t>(q) * kN + k) * d] = h[k];
  }
  __device__ void load_ckpt(int q, float (&h)[kN]) const {
#pragma unroll
    for (int k = 0; k < kN; ++k) h[k] = active ? ckpt[(static_cast<size_t>(q) * kN + k) * d] : 0.0f;
  }
  __device__ void put(int s, float du_v, float draw, float dz_v, float y_v) {
    if (!active) return;
    const size_t row = static_cast<size_t>(t0 + s) * d;
    const size_t tok = static_cast<size_t>(sTok[s]) * d;
    du[row] = du_v;
    ddb[row] = draw;
    dz[tok] = dz_v;
    y[tok] = y_v;
    dtb_sum += draw;
  }
  __device__ void put_bc(int s, float v) {
    bc[(static_cast<size_t>(t0 + s) * nblk + blockIdx.x) * kWarp + threadIdx.x] = v;
  }
};

// grid (nblk, B * S, M), one warp per block.
__global__ void __launch_bounds__(kWarp) scan_bwd_kernel(const Params p) {
  __shared__ float sDt[kChunk][kMaxRank];
  __shared__ float sB[kChunk][kN];
  __shared__ float sC[kChunk][kN];
  __shared__ int64_t sTok[kChunk];

  const int m = blockIdx.z;
  const int bs = blockIdx.y;  // b * S + s
  const int b = bs / p.S;
  const int s = bs % p.S;
  const int c = blockIdx.x * kWarp + threadIdx.x;
  const int d = p.d, L = p.L, Ls = p.Ls;
  const bool active = c < d;
  const int cc = active ? c : 0;
  const Branch& w = p.br[m];
  const size_t seq = static_cast<size_t>(m) * p.B * p.S + bs;
  const size_t row0 = seq * Ls;  // row of (m, b, s, t = 0) in the stream-row arrays
  // row of (m, b, s, token 0) in the token-order arrays dz and y
  const size_t yrow0 = (p.ys == 1 ? static_cast<size_t>(m) * p.B + b : seq) * L;
  const int gld = gm_cols(p);

  float a[kN];
#pragma unroll
  for (int k = 0; k < kN; ++k) a[k] = active ? -expf(w.A_log[static_cast<size_t>(c) * kN + k]) : 0.0f;
  const float Dc = active ? w.D[c] : 0.0f;

  MixerScanIO io;
  io.u_p = p.u + row0 * d + cc;
  io.xdb = p.xdb + row0 * (p.r + 2 * kN);
  io.xz_b = p.xz + (static_cast<size_t>(m) * p.B + b) * L * 2 * d + cc;
  io.gm_b = p.gm + (static_cast<size_t>(m) * p.B + b) * L * gld + (p.quirk ? s * d : 0) + cc;
  io.order = p.fwd + static_cast<size_t>(s) * Ls;
  io.du = p.du + row0 * d + cc;
  io.ddb = p.ddb + row0 * d + cc;
  io.dz = p.dz + yrow0 * d + cc;
  io.y = p.y + yrow0 * d + cc;
  io.bc = p.bc + row0 * p.nblk * kWarp;
  io.ckpt = p.ckpt + seq * p.nq * kN * d + cc;
  io.sDt = sDt;
  io.sB = sB;
  io.sC = sC;
  io.sTok = sTok;
#pragma unroll
  for (int j = 0; j < kMaxRank; ++j) {
    io.wdt[j] = (active && j < p.r) ? w.dt_w[static_cast<size_t>(c) * p.r + j] : 0.0f;
  }
  io.dtb = active ? w.dt_b[c] : 0.0f;
  io.scale = p.scale;
  io.dtb_sum = 0.0f;
  io.c = c;
  io.d = d;
  io.r = p.r;
  io.ld = p.r + 2 * kN;
  io.nblk = p.nblk;
  io.t0 = 0;
  io.gm_ld = gld;
  io.active = active;
  io.by_step = p.quirk;

  float dA[kN], dD;
  scan_bwd::sweep<kN>(io, a, Dc, Ls, dA, dD);
  if (active) {
    float* part = p.part_scan + (seq * d + c) * kScanParts;
#pragma unroll
    for (int k = 0; k < kN; ++k) part[k] = dA[k];
    part[kN] = dD;
    part[kN + 1] = io.dtb_sum;
  }
}

// dxdb[:, r + j] = sum over channel blocks of the dB/dC partials.
__global__ void reduce_bc_kernel(const Params p) {
  const size_t rows = srows(p);
  const size_t i = static_cast<size_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  const int m = blockIdx.y;
  if (i >= rows * kWarp) return;
  const size_t row = i / kWarp;
  const int j = static_cast<int>(i % kWarp);
  const float* part = p.bc + ((m * rows + row) * p.nblk) * kWarp + j;
  float acc = 0.0f;
  for (int blk = 0; blk < p.nblk; ++blk) acc += part[static_cast<size_t>(blk) * kWarp];
  dxdb_of(p, m)[row * r2n(p) + p.r + j] = acc;
}

// dxz (T, 2d): the conv adjoint of each stream, gathered back to token order
// and summed over the streams. For channel j < d of token l, stream s holds
// the token at position pos (merge table entry s * Ls + pos; a partition has
// one entry per token); tap k of the conv read it for the output at
// pos + K - 1 - k, if that is inside the stream. The z half sums dz, already
// in token order, over its ys rows per token.
__global__ void grad_xz_kernel(const Params p) {
  const int m = blockIdx.y;
  const size_t T = tokens(p);
  const int d = p.d, L = p.L, Ls = p.Ls;
  const size_t i = static_cast<size_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (i >= T * 2 * d) return;
  const int j = static_cast<int>(i % (2 * d));
  const size_t tok = i / (2 * d);
  const int b = static_cast<int>(tok / L), l = static_cast<int>(tok % L);
  const size_t seq0 = (static_cast<size_t>(m) * p.B + b) * p.S * Ls;  // row of (m, b, s = 0, 0)
  float acc = 0.0f;
  if (j < d) {
    const float* w = p.br[m].conv_w + static_cast<size_t>(j) * kConv;
    for (int q = 0; q < p.ys; ++q) {
      const int64_t e = p.merge[static_cast<size_t>(l) * p.ys + q];  // s * Ls + pos
      const int pos = static_cast<int>(e % Ls);
#pragma unroll
      for (int k = 0; k < kConv; ++k) {
        const int out = pos + kConv - 1 - k;
        if (out < Ls) acc = fmaf(w[k], p.du[(seq0 + e + kConv - 1 - k) * d + j], acc);
      }
    }
  } else {
    const size_t zrow0 = (static_cast<size_t>(m) * p.B + b) * p.ys * L;
    for (int s = 0; s < p.ys; ++s) acc += p.dz[(zrow0 + static_cast<size_t>(s) * L + l) * d + j - d];
  }
  p.dxz[(static_cast<size_t>(m) * T + tok) * 2 * d + j] = acc;
}

// Per row split: dconv_w[c, k] = sum dpre[row, c] u0[row - K + 1 + k, c] and
// dconv_b[c] = sum dpre[row, c] over the split's stream rows, where u0 is the
// stream's gathered xz_u with zeros before its start. Block (32 channels,
// 8 row lanes); grid (nblk, kConvSplits, M).
__global__ void __launch_bounds__(256) grad_conv_kernel(const Params p) {
  constexpr int kLanes = 8;
  __shared__ float red[kLanes][kConv + 1][kWarp];
  const int m = blockIdx.z, split = blockIdx.y;
  const int c = blockIdx.x * kWarp + threadIdx.x;
  const int d = p.d, L = p.L, Ls = p.Ls, S = p.S;
  const int rows = static_cast<int>(srows(p));
  const int per = (rows + kConvSplits - 1) / kConvSplits;
  const int begin = split * per, end = min(rows, begin + per);
  float acc[kConv + 1];
#pragma unroll
  for (int k = 0; k <= kConv; ++k) acc[k] = 0.0f;
  if (c < d) {
    const float* dpre = du_of(p, m);
    const float* xz = xz_of(p, m);
    for (int row = begin + threadIdx.y; row < end; row += kLanes) {
      const int t = row % Ls, bs = row / Ls;
      const int64_t* order = p.fwd + static_cast<size_t>(bs % S) * Ls;
      const float* xz_b = xz + static_cast<size_t>(bs / S) * L * 2 * d + c;
      const float dp = dpre[static_cast<size_t>(row) * d + c];
#pragma unroll
      for (int k = 0; k < kConv; ++k) {
        const int tt = t - (kConv - 1) + k;
        if (tt >= 0) acc[k] = fmaf(dp, xz_b[order[tt] * 2 * d], acc[k]);
      }
      acc[kConv] += dp;
    }
  }
#pragma unroll
  for (int k = 0; k <= kConv; ++k) red[threadIdx.y][k][threadIdx.x] = acc[k];
  __syncthreads();
  if (threadIdx.y != 0 || c >= d) return;
  float* part = p.part_conv + ((static_cast<size_t>(m) * kConvSplits + split) * d + c) * (kConv + 1);
#pragma unroll
  for (int k = 0; k <= kConv; ++k) {
    float v = 0.0f;
    for (int y = 0; y < kLanes; ++y) v += red[y][k][threadIdx.x];
    part[k] = v;
  }
}

// out[i] = sum over splits of part[split * n + i], for branch blockIdx.y.
__global__ void sum_splits_kernel(const Params p, int which, int n) {
  const int m = blockIdx.y;
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  const float* part = p.part_w + m * part_w_size(p);
  float acc = 0.0f;
  for (int s = 0; s < p.splits; ++s) acc += part[static_cast<size_t>(s) * n + i];
  (which == 0 ? p.br[m].g_xp_w : p.br[m].g_dt_w)[i] = acc;
}

// The vim quirk's dW_out[j, c] = P[j, c] + P[h - 1 - j, d + c].
__global__ void fold_out_w_kernel(const Params p) {
  const size_t i = static_cast<size_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  const int d = p.d, h = p.h;
  if (i >= static_cast<size_t>(h) * d) return;
  const int j = static_cast<int>(i / d), c = static_cast<int>(i % d);
  p.br[0].g_out_w[i] = p.pout[static_cast<size_t>(j) * 2 * d + c] +
                       p.pout[static_cast<size_t>(h - 1 - j) * 2 * d + d + c];
}

// Per channel: dA_log, dD and d dt_b from the per-sequence scan partials,
// dconv_w and dconv_b from the per-split conv partials, summed in order.
__global__ void finalize_kernel(const Params p) {
  const int m = blockIdx.y;
  const int c = blockIdx.x * blockDim.x + threadIdx.x;
  if (c >= p.d) return;
  const Branch& w = p.br[m];
  const int seqs = p.B * p.S;
  float acc[kScanParts];
#pragma unroll
  for (int k = 0; k < kScanParts; ++k) acc[k] = 0.0f;
  for (int q = 0; q < seqs; ++q) {
    const float* part = p.part_scan + ((static_cast<size_t>(m) * seqs + q) * p.d + c) * kScanParts;
#pragma unroll
    for (int k = 0; k < kScanParts; ++k) acc[k] += part[k];
  }
#pragma unroll
  for (int k = 0; k < kN; ++k) {
    const size_t i = static_cast<size_t>(c) * kN + k;
    w.g_A_log[i] = acc[k] * -expf(w.A_log[i]);  // dA_log = dA * A
  }
  w.g_D[c] = acc[kN];
  w.g_dt_b[c] = acc[kN + 1];
  float conv[kConv + 1];
#pragma unroll
  for (int k = 0; k <= kConv; ++k) conv[k] = 0.0f;
  for (int q = 0; q < kConvSplits; ++q) {
    const float* part = p.part_conv + ((static_cast<size_t>(m) * kConvSplits + q) * p.d + c) * (kConv + 1);
#pragma unroll
    for (int k = 0; k <= kConv; ++k) conv[k] += part[k];
  }
#pragma unroll
  for (int k = 0; k < kConv; ++k) w.g_conv_w[static_cast<size_t>(c) * kConv + k] = conv[k];
  w.g_conv_b[c] = conv[kConv];
}

// Lay the workspace out for these shapes (pointers into `base` when given);
// returns its size in floats.
size_t layout(Params& p, float* base, int M) {
  const size_t T = static_cast<size_t>(p.B) * p.L, R = static_cast<size_t>(p.B) * p.S * p.Ls;
  const size_t d = p.d, r2 = p.r + 2 * kN, Ty = T * p.ys;
  const size_t sizes[] = {
      T * 2 * d,                                     // xz
      R * d, R * d, R * r2, T * (p.quirk ? 2 : 1) * d,  // u, pre, xdb, gm
      static_cast<size_t>(p.B) * p.S * p.nq * kN * d,  // ckpt
      R * d, R * d, Ty * d, Ty * d,                  // du, ddb, dz, y
      R * p.nblk * kWarp, R * r2, T * 2 * d,         // bc, dxdb, dxz
      static_cast<size_t>(p.B) * p.S * d * kScanParts,  // part_scan
      kConvSplits * d * (kConv + 1),                 // part_conv
      static_cast<size_t>(p.splits) * std::max(r2 * d, d * p.r),  // part_w
      p.quirk ? static_cast<size_t>(p.h) * 2 * d : 0,  // pout (M = 1)
  };
  float** ptrs[] = {&p.xz, &p.u, &p.pre, &p.xdb, &p.gm, &p.ckpt, &p.du, &p.ddb, &p.dz,
                    &p.y, &p.bc, &p.dxdb, &p.dxz, &p.part_scan, &p.part_conv, &p.part_w,
                    &p.pout};
  size_t total = 0;
  for (int i = 0; i < 17; ++i) {
    if (base != nullptr) *ptrs[i] = base + total;
    total += sizes[i] * M;
  }
  return total;
}

void set_dims(Params& p, int B, int L, int Ls, int h, int d, int r, int S, int quirk,
              float scale) {
  p.B = B;
  p.L = L;
  p.Ls = Ls;
  p.h = h;
  p.d = d;
  p.r = r;
  p.S = S;
  p.ys = Ls == L ? S : 1;
  p.quirk = quirk != 0;
  p.nq = (Ls + kChunk - 1) / kChunk;
  p.nblk = (d + kWarp - 1) / kWarp;
  // split the B * S * Ls-deep weight-gradient products about 512 rows a block
  p.splits = std::max(1, std::min(16, (B * S * Ls + 511) / 512));
  p.scale = scale;
}

unsigned blocks_for(size_t n, int threads) { return static_cast<unsigned>((n + threads - 1) / threads); }

}  // namespace

// Floats of workspace that mixer_fused_bwd needs for these shapes.
extern "C" long long mixer_fused_bwd_workspace_floats(int M, int B, int L, int Ls, int h, int d,
                                                      int r, int S, int quirk) {
  Params p{};
  set_dims(p, B, L, Ls, h, d, r, S, quirk, 1.0f);
  return static_cast<long long>(layout(p, nullptr, M));
}

// `ptrs` holds 21 pointers per branch, in the order of struct Branch, for
// M = 1 or 2 branches; all fp32 and contiguous. `fwd` (S, Ls) and `merge`
// (L, S, or L, 1 for a partition) are int64: with Ls = L each row of fwd is
// a permutation of 0 .. L-1, with Ls = L / S its rows partition them (M = 1).
// `quirk` (M = 1, S = 2, Ls = L) asks for the vim merge's adjoint. Launches
// the chain on `stream`; returns the first launch's cudaError_t that is not
// 0, or -1 for shapes that are not built.
extern "C" int mixer_fused_bwd(void* const* ptrs, int M, const void* fwd, const void* merge,
                               void* workspace, int B, int L, int Ls, int h, int d, int n,
                               int r, int K, int S, int quirk, float scale, void* stream) {
  const bool partition = Ls != L;
  if (M < 1 || M > 2 || n != kN || K != kConv || r < 1 || r > kMaxRank || S < 1 ||
      S > kMaxStreams || Ls < 1 || (partition && (Ls * S != L || M != 1)) ||
      (quirk && (S != 2 || partition || M != 1))) {
    return -1;
  }
  Params p{};
  for (int m = 0; m < M; ++m) {
    void* const* q = ptrs + m * kBranchPtrs;
    const float* in[11];
    float* out[10];
    for (int i = 0; i < 11; ++i) in[i] = static_cast<const float*>(q[i]);
    for (int i = 0; i < 10; ++i) out[i] = static_cast<float*>(q[11 + i]);
    p.br[m] = Branch{in[0], in[1], in[2], in[3], in[4], in[5], in[6], in[7], in[8], in[9], in[10],
                     out[0], out[1], out[2], out[3], out[4], out[5], out[6], out[7], out[8], out[9]};
  }
  p.fwd = static_cast<const int64_t*>(fwd);
  p.merge = static_cast<const int64_t*>(merge);
  set_dims(p, B, L, Ls, h, d, r, S, quirk, scale);
  layout(p, static_cast<float*>(workspace), M);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int T = B * L, R = B * S * Ls, r2 = r + 2 * kN;

  int err = launch_gemm_op<64, 64, 16, 4, 4, InProj>(p, T, 2 * d, M, st);
  if (err == 0) err = launch_gemm_op<16, 64, 16, 1, 4, ConvXProj>(p, R, r2, M, st);
  if (err == 0) err = launch_gemm_op<64, 64, 16, 4, 4, GradOutProj>(p, T, quirk ? 2 * d : d, M, st);
  if (err == 0) {
    scan_bwd_kernel<<<dim3(p.nblk, B * S, M), kWarp, 0, st>>>(p);
    err = static_cast<int>(cudaGetLastError());
  }
  if (err == 0) {
    reduce_bc_kernel<<<dim3(blocks_for(static_cast<size_t>(R) * kWarp, 256), M), 256, 0, st>>>(p);
    err = static_cast<int>(cudaGetLastError());
  }
  if (err == 0) err = launch_gemm_op<64, 32, 16, 4, 2, GradDtRank>(p, R, r, M, st);
  if (err == 0) err = launch_gemm_op<64, 64, 16, 4, 4, GradXProjW>(p, r2, d, M, st, p.splits);
  if (err == 0) {
    sum_splits_kernel<<<dim3(blocks_for(static_cast<size_t>(r2) * d, 256), M), 256, 0, st>>>(p, 0, r2 * d);
    err = static_cast<int>(cudaGetLastError());
  }
  if (err == 0) err = launch_gemm_op<64, 32, 16, 4, 2, GradDtW>(p, d, r, M, st, p.splits);
  if (err == 0) {
    sum_splits_kernel<<<dim3(blocks_for(static_cast<size_t>(d) * r, 256), M), 256, 0, st>>>(p, 1, d * r);
    err = static_cast<int>(cudaGetLastError());
  }
  if (err == 0) err = launch_gemm_op<64, 64, 16, 4, 4, GradPre>(p, R, d, M, st);
  if (err == 0) {
    grad_xz_kernel<<<dim3(blocks_for(static_cast<size_t>(T) * 2 * d, 256), M), 256, 0, st>>>(p);
    err = static_cast<int>(cudaGetLastError());
  }
  if (err == 0) {
    grad_conv_kernel<<<dim3(p.nblk, kConvSplits, M), dim3(kWarp, 8), 0, st>>>(p);
    err = static_cast<int>(cudaGetLastError());
  }
  if (err == 0) err = launch_gemm_op<64, 64, 16, 4, 4, GradX>(p, T, h, M, st);
  if (err == 0) err = launch_gemm_op<64, 64, 16, 4, 4, GradInW>(p, 2 * d, h, M, st);
  if (err == 0 && !quirk) err = launch_gemm_op<64, 64, 16, 4, 4, GradOutW>(p, h, d, M, st);
  if (err == 0 && quirk) {
    err = launch_gemm_op<64, 64, 16, 4, 4, GradOutWQuirk>(p, h, 2 * d, M, st);
    if (err == 0) {
      fold_out_w_kernel<<<blocks_for(static_cast<size_t>(h) * d, 256), 256, 0, st>>>(p);
      err = static_cast<int>(cudaGetLastError());
    }
  }
  if (err == 0) {
    finalize_kernel<<<dim3(blocks_for(d, 128), M), 128, 0, st>>>(p);
    err = static_cast<int>(cudaGetLastError());
  }
  return err;
}
