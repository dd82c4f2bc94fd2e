// Whole Mamba-1 mixer backward for Hopper (sm_90a), for one or two mixers
// (the Spiral block's two branches) in one call.
//
// Replaces the TPU kernel diffma_tpu/ops/fused_mixer.py:565
// (_mixer_bwd_kernel), as its launcher _monolithic_bwd drives it (the custom
// VJPs of mamba_mixer_fused and mamba_dual_mixer_fused). Given x and g =
// dL/dout (B, L, h) per branch and the mixer's 9 weights (torch layout, A as
// A_log), it recomputes the forward from x alone, as kernel C computes it
// (fused_mixer_fwd.cu), and writes gx (B, L, h) and the 9 weight gradients
// summed over the batch, all fp32:
//
//     forward   xz = x W_in^T; per stream s (token order fwd[s]):
//               pre = conv(xz_u) + conv_b; u = silu(pre); [dt_r, B, C] = u W_x^T
//               dt = softplus(dt_r W_dt^T + dt_b); y_s = scan(u, dt, A, B, C, D) silu(z)
//               out = (scale sum_s y_s, in token order) W_out^T
//     backward  gm = g W_out; g_y = scale gm[fwd[s]]   (merge adjoint: a gather)
//               dW_out = g^T merged
//               du, draw, dB, dC, dz, dA, dD: the scan's adjoint
//               d dt_r = draw W_dt;  dW_dt = draw^T dt_r;  d dt_b = sum draw
//               dW_x = [d dt_r, dB, dC]^T u
//               dpre = (du + [d dt_r, dB, dC] W_x) silu'(pre)
//               conv adjoints per stream, taps never crossing a stream's start;
//               dxz = sum over streams back in token order (through the merge
//               table: each stream is a permutation, so this is a gather)
//               gx = dxz W_in;  dW_in = dxz^T x;  dA_log = dA A (A = -exp(A_log))
//
// Arithmetic. The eleven products (in_proj, x_proj and dt_proj recomputed;
// g W_out, dW_out, d dt_r, dW_dt, dpre's, dW_x, gx, dW_in) run on the tensor
// cores in 3xTF32 (gemm_tc.cuh): each operand split once into a TF32 high
// part and a TF32 remainder, three products summed in fp32, which keeps about
// 22 bits of each operand, so a product of depth up to B * S * L = 4704 stays
// within fp32 rounding of the plain version and the 2e-4 bar. The scan's
// adjoint, the conv's and the sums are fp32 on the CUDA cores; draw uses
// sigmoid(raw) = 1 - exp(-dt), as -expm1(-dt), since the forward keeps dt.
//
// Bound on an H100 SXM (495 TFLOP/s TF32 on the tensor cores, 67 TFLOP/s fp32
// outside them, 3.35 TB/s). At DiffMa-B/2's training shapes, batch 8, both
// branches (B = 8, L = 196, h = 512, d = 1024, n = 16, r = 32, S = 3), one
// call does 31.9 GFLOP of products, 0.19 ms at the 3xTF32 rate (495 / 3),
// and about 3.9 GFLOP of scan, conv and elementwise work, 0.06 ms at the fp32
// rate: 0.25 ms, against about 46 MB of weights, gradients, x, g and gx,
// 14 us at the memory rate. (All of it at the fp32 rate: 0.53 ms.)
//
// Design: a chain of launches over a workspace the caller allocates
// (mixer_fused_bwd_workspace_floats; about 460 MB at the shapes above), with
// the branch on blockIdx.z in every launch, so both branches share each
// launch and their gradients never mix.
// 1. in_proj, conv + SiLU, x_proj and dt_proj: kernel C's stages again (the
//    conv's pre-activation is stored as well, for the SiLU adjoint; dt is
//    stored for the scan, which so runs no dot product in its chain).
// 2. gm = g W_out.
// 3. the scan adjoint (scan_bwd_kernel below): four lanes per channel, each
//    holding 4 of its 16 states, so a step's sums over the states (y, the
//    parts of d raw, sum_n s_t B_t) are two shuffles and the chain's latency
//    hides behind 16 warps per SM (a thread per channel, with 16 states and
//    32 dB/dC partials in registers, left room for 12; at B = 8, both
//    branches, four lanes measured 0.77-0.81 ms a call, eight 1.08, one
//    0.99). A block is 8 warps, 64 channels of one sequence, at most 128
//    registers a thread. B, C and the token index of a 16-step chunk are
//    staged once for the block; the lanes of a channel load the chunk's dt,
//    u, z and g four steps each and pass them round by shuffles, so no step
//    waits on device memory. The forward pass stores the state at every
//    chunk's entry; the reverse pass recomputes a chunk's 16 states into
//    shared memory (with y) and sweeps it backwards. Each step's dB and dC
//    (sums over channels) reduce over the warp's 8 channels by a
//    recursive-halving reduce-scatter, then over the block's 8 warps in
//    shared memory, so one partial per block and step goes out, and
//    reduce_bc_kernel sums d / 64 of them. Per-sequence partials of dA, dD
//    and d dt_b.
// 4. d dt_r, dW_dt, dW_x, dpre: products; the weight gradients, whose depth is
//    the B * S * Ls stream rows, split it over blocks and sum the partials in
//    a second pass.
// 5. conv adjoints: dxz by a gather-sum through the merge table (no atomics);
//    dconv_w and dconv_b by column sums over row splits.
// 6. gx = dxz W_in, dW_in = dxz^T x, dW_out = g^T merged: products; merged,
//    out_proj's input, is built once from y (merge_y_kernel) so that the
//    product's loads are plain reads.
// 7. a pass that sums every partial in a fixed order. Nothing uses atomics,
//    so the result is deterministic.
// Each operand is read along whichever of its axes is contiguous and staged
// K-major, as wgmma takes tf32 (gemm_tc.cuh). The TPU kernel's one-hot
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
//
// bf16 (dtype 1: x, g and gx in bf16, the weights and their gradients fp32),
// the TPU kernel at a compute dtype cd = bfloat16: the forward recomputed as
// kernel C's bf16 variant computes it (xz rounded to bf16, u and x_proj's
// output fp32, its merge rounding), and every product on bf16 operands with
// fp32 sums (gemm_tc.cuh's kBf16 stages), each operand rounded where the
// JAX kernel casts it: x, g and the weights as they stand, u, d raw, dt_r,
// [d dt_r, dB, dC], dxz and out_proj's merged input. The scan's adjoint, the
// conv's and the sums stay fp32, as the gradients of the weights. As the
// TPU kernel sums each stream's dxs into dxz through a one-hot product, a
// stream's share is rounded to bf16 before the sum, but for a stream in
// token order (`ident`). gx is rounded to bf16 once, after its product.

#include <cuda_runtime.h>
#include <stdint.h>

#include <algorithm>

#include "gemm_tc.cuh"

namespace {

constexpr int kN = 16;        // d_state
constexpr int kConv = 4;      // conv taps
constexpr int kMaxRank = 32;  // dt_rank
constexpr int kMaxStreams = 4;
constexpr int kBranchPtrs = 21;
constexpr int kConvSplits = 16;  // row splits of the conv weight gradients
constexpr int kScanParts = kN + 2;  // per sequence and channel: dA (n), dD, d dt_b
constexpr int kWarp = 32;
constexpr int kLPC = 4;                          // scan adjoint: lanes per channel
constexpr int kSPL = kN / kLPC;                  // states per lane
constexpr int kCPW = kWarp / kLPC;               // channels per warp
constexpr int kScanWarps = 8;                    // warps of a scan block
constexpr int kScanThreads = kScanWarps * kWarp;
constexpr int kScanCh = kScanWarps * kCPW;       // channels of a scan block
constexpr int kChunk = 16;                       // steps between checkpoints
constexpr int kScanSmem = kChunk * kN * kScanCh * static_cast<int>(sizeof(float));
static_assert(kCPW == 2 * kSPL, "dB and dC of a lane's states reduce as one scatter over channels");
static_assert(kChunk % kLPC == 0, "a lane holds whole steps of a chunk");
constexpr float kLog2e = 1.4426950408889634f;
constexpr float kLn2 = 0.6931471805599453f;

__device__ __forceinline__ float sigmoid(float x) { return 1.0f / (1.0f + expf(-x)); }

// softplus(x) = log(1 + exp(x)) without overflow: max(x, 0) + log1p(exp(-|x|)).
__device__ __forceinline__ float softplus(float x) {
  return fmaxf(x, 0.0f) + log1pf(expf(-fabsf(x)));
}

struct Branch {
  const void* x;        // (B, L, h), fp32 or bf16
  const void* g;        // (B, L, h), x's dtype
  const float* in_w;    // (2d, h)
  const float* conv_w;  // (d, K)
  const float* conv_b;  // (d,)
  const float* xp_w;    // (r + 2n, d)
  const float* dt_w;    // (d, r)
  const float* dt_b;    // (d,)
  const float* A_log;   // (d, n)
  const float* D;       // (d,)
  const float* out_w;   // (h, d)
  void* gx;             // (B, L, h), x's dtype
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

// The split counts of the products whose depth is split over blocks.
struct Splits {
  int xp, xw, dtw, inw, outw;
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
  float* dt;             // (R, d) stream order: softplus(dt_r W_dt^T + dt_b)
  float* gm;             // (T, gm_cols): g W_out, or [g W_out | g flip_rows(W_out)]
  float* ckpt;           // (B * S, nq, n, d): the scan's chunk-entry states
  float* du;             // (R, d) stream order: the scan's du, then dpre
  float* ddb;            // (R, d) stream order: d raw delta
  float* dz;             // (T * ys, d) token order
  float* y;              // (T * ys, d) token order: the gated scan output
  float* ym;             // (T, ym_cols): out_proj's input as the forward built it from y
  float* bc;             // (R, nblk, 32): dB/dC partials per channel block
  float* dxdb;           // (R, r + 2n): d dt_r, dB, dC
  float* dxz;            // (T, 2d)
  float* part_scan;      // (B * S, d, kScanParts)
  float* part_conv;      // (kConvSplits, d, K + 1): dconv_w (K), dconv_b
  float* part;           // split partials of one product at a time, per branch
  float* pout;           // (h, 2d): the vim quirk's P, before the fold
  float* dst[2];         // where the current split product's result goes, per branch
  int B, L, Ls, h, d, r, S, ys, nq, nblk, splits;  // splits: the current split product's
  size_t part_size;      // floats of `part` per branch
  Splits sp;
  bool quirk;
  int ident;  // bf16: bit s set when stream s runs in token order
  float scale;
};

__device__ __forceinline__ size_t tokens(const Params& p) { return static_cast<size_t>(p.B) * p.L; }
__device__ __forceinline__ size_t srows(const Params& p) {
  return static_cast<size_t>(p.B) * p.S * p.Ls;
}
__device__ __forceinline__ int r2n(const Params& p) { return p.r + 2 * kN; }
__device__ __forceinline__ int gm_cols(const Params& p) { return p.quirk ? 2 * p.d : p.d; }
__device__ __forceinline__ int ym_cols(const Params& p) { return p.quirk ? 2 * p.d : p.d; }

// Per-branch views of the workspace arrays.
__device__ __forceinline__ float* xz_of(const Params& p, int m) { return p.xz + m * tokens(p) * 2 * p.d; }
__device__ __forceinline__ float* u_of(const Params& p, int m) { return p.u + m * srows(p) * p.d; }
__device__ __forceinline__ float* pre_of(const Params& p, int m) { return p.pre + m * srows(p) * p.d; }
__device__ __forceinline__ float* xdb_of(const Params& p, int m) { return p.xdb + m * srows(p) * r2n(p); }
__device__ __forceinline__ float* dt_of(const Params& p, int m) { return p.dt + m * srows(p) * p.d; }
__device__ __forceinline__ float* gm_of(const Params& p, int m) { return p.gm + m * tokens(p) * gm_cols(p); }
__device__ __forceinline__ float* du_of(const Params& p, int m) { return p.du + m * srows(p) * p.d; }
__device__ __forceinline__ float* ddb_of(const Params& p, int m) { return p.ddb + m * srows(p) * p.d; }
__device__ __forceinline__ float* y_of(const Params& p, int m) { return p.y + m * tokens(p) * p.ys * p.d; }
__device__ __forceinline__ float* ym_of(const Params& p, int m) { return p.ym + m * tokens(p) * ym_cols(p); }
__device__ __forceinline__ float* dxdb_of(const Params& p, int m) { return p.dxdb + m * srows(p) * r2n(p); }
__device__ __forceinline__ float* dxz_of(const Params& p, int m) { return p.dxz + m * tokens(p) * 2 * p.d; }
// A split product's store target: the result itself with one split, else its partials.
__device__ __forceinline__ float* split_dst(const Params& p, int m) {
  return p.splits == 1 ? p.dst[m] : p.part + m * p.part_size;
}

__device__ __forceinline__ float silu(float x) { return x * sigmoid(x); }

using bf16 = tc::bf16;
using tc::al;
using tc::kIsBf16;
using tc::ld;
using tc::ld4;
using tc::put;
using tc::round_bf16;
__device__ __forceinline__ float dsilu(float x) {
  const float s = sigmoid(x);
  return s * (1.0f + x * (1.0f - s));
}

// The stages of gemm_tc.cuh: c[row, col] = sum_k a(row, k) b(col, k) for one
// branch. An ARow is what a's loads of one row need, resolved once. T is x's
// dtype: with bf16 every stage multiplies in bf16 (kBf16).

template <class E>
struct RowPtrOf {  // a row-major a, contiguous along k
  const E* p;
};
using RowPtr = RowPtrOf<float>;
struct RowIdx {  // an a contiguous along row: a(row, k) = X[k * rows + row]
  int row;
};

template <class T>
struct InProj {  // xz = x W_in^T, rounded to bf16 in the bf16 model, as kernel C
  static constexpr bool kAByRow = false, kBByRow = false, kBf16 = kIsBf16<T>;
  bool vec;  // float4 loads: every row aligned
  using ARow = RowPtrOf<T>;
  const T* x;
  const float* w;
  float* c;
  int rows, cols, depth;
  __device__ InProj(const Params& p, int m)
      : x(static_cast<const T*>(p.br[m].x)), w(p.br[m].in_w), c(xz_of(p, m)),
        rows(static_cast<int>(tokens(p))), cols(2 * p.d), depth(p.h) {
    vec = al(x, depth) && al(w, depth);
  }
  __device__ ARow arow(int row) const { return {x + static_cast<size_t>(row) * depth}; }
  __device__ void store(int row, int col, int, float v) const {
    c[static_cast<size_t>(row) * cols + col] = kBf16 ? round_bf16(v) : v;
  }
  __device__ float a(const ARow& r, int k) const { return ld(r.p + k); }
  __device__ float4 a4(const ARow& r, int k) const { return ld4(r.p + k); }
  __device__ float b(int col, int k) const { return w[static_cast<size_t>(col) * depth + k]; }
  __device__ float4 b4(int col, int k) const { return ld4(w + static_cast<size_t>(col) * depth + k); }
};

template <class T>
struct XProj {  // xdb = u W_x^T (split partials)
  static constexpr bool kBf16 = kIsBf16<T>, kAByRow = false, kBByRow = false;
  bool vec;  // float4 loads: every row aligned
  using ARow = RowPtr;
  const float *u, *w;
  float* c;
  int rows, cols, depth;
  __device__ XProj(const Params& p, int m)
      : u(u_of(p, m)), w(p.br[m].xp_w), c(split_dst(p, m)),
        rows(static_cast<int>(srows(p))), cols(r2n(p)), depth(p.d) {
    vec = al(u, depth) && al(w, depth);
  }
  __device__ ARow arow(int row) const { return {u + static_cast<size_t>(row) * depth}; }
  __device__ float a(const ARow& r, int k) const { return r.p[k]; }
  __device__ float4 a4(const ARow& r, int k) const { return ld4(r.p + k); }
  __device__ float b(int col, int k) const { return w[static_cast<size_t>(col) * depth + k]; }
  __device__ float4 b4(int col, int k) const { return ld4(w + static_cast<size_t>(col) * depth + k); }
  __device__ void store(int row, int col, int split, float v) const {
    c[(static_cast<size_t>(split) * rows + row) * cols + col] = v;
  }
};

template <class T>
struct DtProj {  // dt = softplus(dt_r W_dt^T + dt_b)
  static constexpr bool kBf16 = kIsBf16<T>, kAByRow = false, kBByRow = false;
  bool vec;  // float4 loads: every row aligned
  using ARow = RowPtr;
  const float *xdb, *w, *bias;
  float* c;
  int rows, cols, depth, ld;
  __device__ DtProj(const Params& p, int m)
      : xdb(xdb_of(p, m)), w(p.br[m].dt_w), bias(p.br[m].dt_b), c(dt_of(p, m)),
        rows(static_cast<int>(srows(p))), cols(p.d), depth(p.r), ld(r2n(p)) {
    vec = al(xdb, ld) && al(w, depth);
  }
  __device__ ARow arow(int row) const { return {xdb + static_cast<size_t>(row) * ld}; }
  __device__ float a(const ARow& r, int k) const { return r.p[k]; }
  __device__ float4 a4(const ARow& r, int k) const { return ld4(r.p + k); }
  __device__ float b(int col, int k) const { return w[static_cast<size_t>(col) * depth + k]; }
  __device__ float4 b4(int col, int k) const { return ld4(w + static_cast<size_t>(col) * depth + k); }
  __device__ void store(int row, int col, int, float v) const {
    c[static_cast<size_t>(row) * cols + col] = softplus(v + bias[col]);
  }
};

// gm = g W_out; with the vim quirk [g W_out | g flip_rows(W_out)], the second
// half reading W_out's rows h - 1 - k.
template <class T>
struct GradOutProj {
  static constexpr bool kAByRow = false, kBByRow = true, kBf16 = kIsBf16<T>;
  bool vec;  // float4 loads: every row aligned
  using ARow = RowPtrOf<T>;
  const T* g;
  const float* w;
  float* c;
  int rows, cols, depth, d;
  __device__ GradOutProj(const Params& p, int m)
      : g(static_cast<const T*>(p.br[m].g)), w(p.br[m].out_w), c(gm_of(p, m)),
        rows(static_cast<int>(tokens(p))), cols(gm_cols(p)), depth(p.h), d(p.d) {
    vec = al(g, depth) && al(w, d);
  }
  __device__ ARow arow(int row) const { return {g + static_cast<size_t>(row) * depth}; }
  __device__ void store(int row, int col, int, float v) const { c[static_cast<size_t>(row) * cols + col] = v; }
  __device__ float a(const ARow& r, int k) const { return ld(r.p + k); }
  __device__ float4 a4(const ARow& r, int k) const { return ld4(r.p + k); }
  __device__ const float* w_at(int col, int k) const {  // d % 4 == 0: no float4 straddles d
    return col < d ? w + static_cast<size_t>(k) * d + col
                   : w + static_cast<size_t>(depth - 1 - k) * d + (col - d);
  }
  __device__ float b(int col, int k) const { return *w_at(col, k); }
  __device__ float4 b4(int col, int k) const { return ld4(w_at(col, k)); }
};

template <class T>
struct GradDtRank {  // d dt_r = draw W_dt, into dxdb[:, :r]
  static constexpr bool kBf16 = kIsBf16<T>, kAByRow = false, kBByRow = true;
  bool vec;  // float4 loads: every row aligned
  using ARow = RowPtr;
  const float *ddb, *w;
  float* c;
  int rows, cols, depth, ld;
  __device__ GradDtRank(const Params& p, int m)
      : ddb(ddb_of(p, m)), w(p.br[m].dt_w), c(dxdb_of(p, m)),
        rows(static_cast<int>(srows(p))), cols(p.r), depth(p.d), ld(r2n(p)) {
    vec = al(ddb, depth) && al(w, cols);
  }
  __device__ ARow arow(int row) const { return {ddb + static_cast<size_t>(row) * depth}; }
  __device__ void store(int row, int col, int, float v) const { c[static_cast<size_t>(row) * ld + col] = v; }
  __device__ float a(const ARow& r, int k) const { return r.p[k]; }
  __device__ float4 a4(const ARow& r, int k) const { return ld4(r.p + k); }
  __device__ float b(int col, int k) const { return w[static_cast<size_t>(k) * cols + col]; }
  __device__ float4 b4(int col, int k) const { return ld4(w + static_cast<size_t>(k) * cols + col); }
};

template <class T>
struct GradXProjW {  // dW_x = dxdb^T u
  static constexpr bool kAByRow = true, kBByRow = true, kBf16 = kIsBf16<T>;
  bool vec;  // float4 loads: every row aligned
  using ARow = RowIdx;
  const float *dxdb, *u;
  float* c;
  int rows, cols, depth;
  __device__ GradXProjW(const Params& p, int m)
      : dxdb(dxdb_of(p, m)), u(u_of(p, m)), c(split_dst(p, m)),
        rows(r2n(p)), cols(p.d), depth(static_cast<int>(srows(p))) {
    vec = al(dxdb, rows) && al(u, cols);
  }
  __device__ ARow arow(int row) const { return {row}; }
  __device__ void store(int row, int col, int split, float v) const {
    c[(static_cast<size_t>(split) * rows + row) * cols + col] = v;
  }
  __device__ float a(const ARow& r, int k) const { return dxdb[static_cast<size_t>(k) * rows + r.row]; }
  __device__ float4 a4(const ARow& r, int k) const { return ld4(dxdb + static_cast<size_t>(k) * rows + r.row); }
  __device__ float b(int col, int k) const { return u[static_cast<size_t>(k) * cols + col]; }
  __device__ float4 b4(int col, int k) const { return ld4(u + static_cast<size_t>(k) * cols + col); }
};

template <class T>
struct GradDtW {  // dW_dt = draw^T dt_r
  static constexpr bool kAByRow = true, kBByRow = true, kBf16 = kIsBf16<T>;
  bool vec;  // float4 loads: every row aligned
  using ARow = RowIdx;
  const float *ddb, *xdb;
  float* c;
  int rows, cols, depth, ld;
  __device__ GradDtW(const Params& p, int m)
      : ddb(ddb_of(p, m)), xdb(xdb_of(p, m)), c(split_dst(p, m)),
        rows(p.d), cols(p.r), depth(static_cast<int>(srows(p))), ld(r2n(p)) {
    vec = al(ddb, rows) && al(xdb, ld);
  }
  __device__ ARow arow(int row) const { return {row}; }
  __device__ void store(int row, int col, int split, float v) const {
    c[(static_cast<size_t>(split) * rows + row) * cols + col] = v;
  }
  __device__ float a(const ARow& r, int k) const { return ddb[static_cast<size_t>(k) * rows + r.row]; }
  __device__ float4 a4(const ARow& r, int k) const { return ld4(ddb + static_cast<size_t>(k) * rows + r.row); }
  __device__ float b(int col, int k) const { return xdb[static_cast<size_t>(k) * ld + col]; }
  __device__ float4 b4(int col, int k) const { return ld4(xdb + static_cast<size_t>(k) * ld + col); }
};

template <class T>
struct GradPre {  // dpre = (du + dxdb W_x) silu'(pre), in place of du
  static constexpr bool kBf16 = kIsBf16<T>, kAByRow = false, kBByRow = true;
  bool vec;  // float4 loads: every row aligned
  using ARow = RowPtr;
  const float *dxdb, *w, *pre;
  float* du;
  int rows, cols, depth;
  __device__ GradPre(const Params& p, int m)
      : dxdb(dxdb_of(p, m)), w(p.br[m].xp_w), pre(pre_of(p, m)), du(du_of(p, m)),
        rows(static_cast<int>(srows(p))), cols(p.d), depth(r2n(p)) {
    vec = al(dxdb, depth) && al(w, cols);
  }
  __device__ ARow arow(int row) const { return {dxdb + static_cast<size_t>(row) * depth}; }
  __device__ float a(const ARow& r, int k) const { return r.p[k]; }
  __device__ float4 a4(const ARow& r, int k) const { return ld4(r.p + k); }
  __device__ void store(int row, int col, int, float v) const {
    const size_t i = static_cast<size_t>(row) * cols + col;
    du[i] = (du[i] + v) * dsilu(pre[i]);
  }
  __device__ float b(int col, int k) const { return w[static_cast<size_t>(k) * cols + col]; }
  __device__ float4 b4(int col, int k) const { return ld4(w + static_cast<size_t>(k) * cols + col); }
};

template <class T>
struct GradX {  // gx = dxz W_in
  static constexpr bool kAByRow = false, kBByRow = true, kBf16 = kIsBf16<T>;
  bool vec;  // float4 loads: every row aligned
  using ARow = RowPtr;
  const float *dxz, *w;
  T* c;
  int rows, cols, depth;
  __device__ GradX(const Params& p, int m)
      : dxz(dxz_of(p, m)), w(p.br[m].in_w), c(static_cast<T*>(p.br[m].gx)),
        rows(static_cast<int>(tokens(p))), cols(p.h), depth(2 * p.d) {
    vec = al(dxz, depth) && al(w, cols);
  }
  __device__ ARow arow(int row) const { return {dxz + static_cast<size_t>(row) * depth}; }
  __device__ void store(int row, int col, int, float v) const { put(c + static_cast<size_t>(row) * cols + col, v); }
  __device__ float a(const ARow& r, int k) const { return r.p[k]; }
  __device__ float4 a4(const ARow& r, int k) const { return ld4(r.p + k); }
  __device__ float b(int col, int k) const { return w[static_cast<size_t>(k) * cols + col]; }
  __device__ float4 b4(int col, int k) const { return ld4(w + static_cast<size_t>(k) * cols + col); }
};

template <class T>
struct GradInW {  // dW_in = dxz^T x
  static constexpr bool kAByRow = true, kBByRow = true, kBf16 = kIsBf16<T>;
  bool vec;  // float4 loads: every row aligned
  using ARow = RowIdx;
  const float* dxz;
  const T* x;
  float* c;
  int rows, cols, depth;
  __device__ GradInW(const Params& p, int m)
      : dxz(dxz_of(p, m)), x(static_cast<const T*>(p.br[m].x)), c(split_dst(p, m)),
        rows(2 * p.d), cols(p.h), depth(static_cast<int>(tokens(p))) {
    vec = al(dxz, rows) && al(x, cols);
  }
  __device__ ARow arow(int row) const { return {row}; }
  __device__ void store(int row, int col, int split, float v) const {
    c[(static_cast<size_t>(split) * rows + row) * cols + col] = v;
  }
  __device__ float a(const ARow& r, int k) const { return dxz[static_cast<size_t>(k) * rows + r.row]; }
  __device__ float4 a4(const ARow& r, int k) const { return ld4(dxz + static_cast<size_t>(k) * rows + r.row); }
  __device__ float b(int col, int k) const { return ld(x + static_cast<size_t>(k) * cols + col); }
  __device__ float4 b4(int col, int k) const { return ld4(x + static_cast<size_t>(k) * cols + col); }
};

// dW_out = g^T ym: ym = merged = scale sum_s y_s in token order; with the vim
// quirk ym = scale [y_0 | y_1] at each stream step and the product is P
// (h x 2d), which fold_out_w_kernel folds into dW_out.
template <class T>
struct GradOutW {
  static constexpr bool kAByRow = true, kBByRow = true, kBf16 = kIsBf16<T>;
  bool vec;  // float4 loads: every row aligned
  using ARow = RowIdx;
  const T* g;
  const float* ym;
  float* c;
  int rows, cols, depth;
  __device__ GradOutW(const Params& p, int m)
      : g(static_cast<const T*>(p.br[m].g)), ym(ym_of(p, m)), c(split_dst(p, m)),
        rows(p.h), cols(ym_cols(p)), depth(static_cast<int>(tokens(p))) {
    vec = al(g, rows) && al(ym, cols);
  }
  __device__ ARow arow(int row) const { return {row}; }
  __device__ void store(int row, int col, int split, float v) const {
    c[(static_cast<size_t>(split) * rows + row) * cols + col] = v;
  }
  __device__ float a(const ARow& r, int k) const { return ld(g + static_cast<size_t>(k) * rows + r.row); }
  __device__ float4 a4(const ARow& r, int k) const { return ld4(g + static_cast<size_t>(k) * rows + r.row); }
  __device__ float b(int col, int k) const { return ym[static_cast<size_t>(k) * cols + col]; }
  __device__ float4 b4(int col, int k) const { return ld4(ym + static_cast<size_t>(k) * cols + col); }
};

// ---------------------------------------------------------------------------
// The scan adjoint. Per channel, with n = 16 states, a = A (negative), dt_t
// the softplus of raw_t, the forward is
//
//     h_t = exp(dt_t a) h_{t-1} + dt_t u_t B_t;  y_t = <C_t, h_t> + D u_t
//     out_t = y_t * silu(z_t)
//
// and, given g_t = dL/dout_t, the backward:
//
//     dy_t = g_t silu(z_t);  dz_t = g_t y_t silu'(z_t);  dD += dy_t u_t
//     s_t  = C_t dy_t + exp(dt_{t+1} a) s_{t+1}             (adjoint state)
//     dB_t = sum_channels s_t dt_t u_t;   dC_t = sum_channels h_t dy_t
//     dA  += s_t h_{t-1} exp(dt_t a) dt_t
//     draw_t = sigmoid(raw_t) sum_n s_t (h_{t-1} exp(dt_t a) a + u_t B_t)
//     du_t = dy_t D + dt_t sum_n s_t B_t
// ---------------------------------------------------------------------------

// Recursive-halving reduce-scatter over the channels of a warp (lane bits 2
// to 4: lane = 4 * channel + j): on return, the lane of channel c holds the
// sum over the warp's 8 channels of their v[c]. At each level a lane keeps
// the half of its values whose index has its channel's bit, and adds its
// partner's copy.
__device__ __forceinline__ float reduce_scatter_channels(float (&v)[kCPW]) {
  const int lane = threadIdx.x % kWarp;
#pragma unroll
  for (int half = kCPW / 2, off = kWarp / 2; half >= 1; half /= 2, off /= 2) {
    const bool upper = (lane & off) != 0;
#pragma unroll
    for (int i = 0; i < half; ++i) {
      const float send = upper ? v[i] : v[i + half];
      const float keep = upper ? v[i + half] : v[i];
      v[i] = keep + __shfl_xor_sync(0xffffffffu, send, off);
    }
  }
  return v[0];
}

// The sum over a channel's kLPC lanes, on every one of them.
__device__ __forceinline__ float channel_sum(float v) {
#pragma unroll
  for (int off = 1; off < kLPC; off *= 2) v += __shfl_xor_sync(0xffffffffu, v, off);
  return v;
}

// Step s's value of a per-step quantity that lane j of each channel holds for
// steps j, j + kLPC, ... (v[s / kLPC] on lane s % kLPC), on every lane.
__device__ __forceinline__ float from_step(const float (&v)[kChunk / kLPC], int s) {
  const int lane = threadIdx.x % kWarp;
  return __shfl_sync(0xffffffffu, v[s / kLPC], (lane & ~(kLPC - 1)) | (s % kLPC));
}

// grid (nblk, B * S, M), kScanThreads threads: a warp is kCPW channels of
// kLPC lanes, lane j of a channel holding states j + kLPC i (i < kSPL).
// Dynamic shared memory: the chunk's states, sH[kChunk][kN][kScanCh].
__global__ void __launch_bounds__(kScanThreads, 2) scan_bwd_kernel(const Params p) {
  extern __shared__ float sH[];  // [s][k][channel of the block]
  __shared__ float sB[kChunk][kN];
  __shared__ float sC[kChunk][kN];
  __shared__ int sTok[kChunk];
  __shared__ float sBC[kScanWarps][kChunk][kWarp];  // each warp's dB/dC sums per step

  const int tid = threadIdx.x, warp = tid / kWarp, lane = tid % kWarp;
  const int j = lane % kLPC;                           // lane within the channel
  const int chl = warp * kCPW + lane / kLPC;           // channel within the block
  const int m = blockIdx.z;
  const int bs = blockIdx.y;  // b * S + s
  const int b = bs / p.S, s = bs % p.S;
  const int c = blockIdx.x * kScanCh + chl;
  const int d = p.d, L = p.L, Ls = p.Ls, ld = r2n(p), gld = gm_cols(p);
  const bool active = c < d;
  const int cc = active ? c : 0;
  const Branch& w = p.br[m];
  const size_t seq = static_cast<size_t>(m) * p.B * p.S + bs;
  const size_t row0 = seq * Ls;  // row of (m, b, s, t = 0) in the stream-row arrays
  // row of (m, b, s, token 0) in the token-order arrays dz and y
  const size_t yrow0 = (p.ys == 1 ? static_cast<size_t>(m) * p.B + b : seq) * L;
  const int64_t* order = p.fwd + static_cast<size_t>(s) * Ls;
  const float* xdb = p.xdb + row0 * ld;
  const float* dt_p = p.dt + row0 * d + cc;
  const float* u_p = p.u + row0 * d + cc;
  const float* z_p = p.xz + (static_cast<size_t>(m) * p.B + b) * L * 2 * d + d + cc;
  const float* g_p = p.gm + (static_cast<size_t>(m) * p.B + b) * L * gld + (p.quirk ? s * d : 0) + cc;
  float* ckpt = p.ckpt + seq * p.nq * kN * d + cc;
  float* du_p = p.du + row0 * d + cc;
  float* ddb_p = p.ddb + row0 * d + cc;
  float* dz_p = p.dz + yrow0 * d + cc;
  float* y_p = p.y + yrow0 * d + cc;
  float* bc = p.bc + row0 * p.nblk * kWarp;

  // a2 = A log2(e): each decay exp(dt A) is one exp2f(dt a2)
  float a2[kSPL];
#pragma unroll
  for (int i = 0; i < kSPL; ++i) {
    const int k = j + kLPC * i;
    a2[i] = active ? -expf(w.A_log[static_cast<size_t>(c) * kN + k]) * kLog2e : 0.0f;
  }
  const float Dc = active ? w.D[c] : 0.0f;

  // Stage B (and C, and the token index) of steps t0 .. t0 + steps - 1.
  auto stage = [&](int t0, int steps, bool all) {
    for (int i = tid; i < steps * kN; i += kScanThreads) {
      const float* row = xdb + static_cast<size_t>(t0 + i / kN) * ld + p.r + i % kN;
      sB[i / kN][i % kN] = row[0];
      if (all) sC[i / kN][i % kN] = row[kN];
    }
    if (all && tid < steps) sTok[tid] = static_cast<int>(order[t0 + tid]);
  };
  // This lane's steps of the chunk: j, j + kLPC, ...
  constexpr int kMine = kChunk / kLPC;
  auto mine = [&](int t0, int steps, const float* base, float (&v)[kMine]) {
#pragma unroll
    for (int q = 0; q < kMine; ++q) {
      const int st = j + kLPC * q;
      v[q] = (st < steps && active) ? base[static_cast<size_t>(t0 + st) * d] : 0.0f;
    }
  };

  // Phase 1: the forward, storing each chunk's entry state.
  float h[kSPL];
#pragma unroll
  for (int i = 0; i < kSPL; ++i) h[i] = 0.0f;
  for (int q = 0; q < p.nq; ++q) {
    const int t0 = q * kChunk, steps = min(kChunk, Ls - t0);
    if (active) {
#pragma unroll
      for (int i = 0; i < kSPL; ++i) ckpt[(static_cast<size_t>(q) * kN + j + kLPC * i) * d] = h[i];
    }
    __syncthreads();  // the previous chunk's staging is no longer read
    stage(t0, steps, false);
    float dtm[kMine], um[kMine];
    mine(t0, steps, dt_p, dtm);
    mine(t0, steps, u_p, um);
    __syncthreads();
#pragma unroll
    for (int st = 0; st < kChunk; ++st) {
      if (st >= steps) break;
      const float dt = from_step(dtm, st), du = dt * from_step(um, st);
#pragma unroll
      for (int i = 0; i < kSPL; ++i) h[i] = exp2f(dt * a2[i]) * h[i] + du * sB[st][j + kLPC * i];
    }
  }

  // Phase 2: the chunks in reverse; `carry` is exp(dt_{t+1} a) s_{t+1}.
  float carry[kSPL], dA[kSPL], dD = 0.0f, dtb_sum = 0.0f;
#pragma unroll
  for (int i = 0; i < kSPL; ++i) {
    carry[i] = 0.0f;
    dA[i] = 0.0f;
  }
  for (int q = p.nq - 1; q >= 0; --q) {
    const int t0 = q * kChunk, steps = min(kChunk, Ls - t0);
    __syncthreads();  // the previous chunk's staging and dB/dC sums are no longer read
    stage(t0, steps, true);
    __syncthreads();
    float dtm[kMine], um[kMine], zm[kMine], gm[kMine], ym[kMine];
    mine(t0, steps, dt_p, dtm);
    mine(t0, steps, u_p, um);
#pragma unroll
    for (int qq = 0; qq < kMine; ++qq) {  // z and g through the token index
      const int st = j + kLPC * qq;
      const bool ok = st < steps && active;
      const size_t tok = static_cast<size_t>(ok ? sTok[st] : 0);
      zm[qq] = ok ? z_p[tok * 2 * d] : 0.0f;
      gm[qq] = ok ? p.scale * g_p[(p.quirk ? static_cast<size_t>(t0 + st) : tok) * gld] : 0.0f;
      ym[qq] = 0.0f;
    }
    float h0[kSPL];
#pragma unroll
    for (int i = 0; i < kSPL; ++i) {
      h0[i] = active ? ckpt[(static_cast<size_t>(q) * kN + j + kLPC * i) * d] : 0.0f;
      h[i] = h0[i];
    }
#pragma unroll
    for (int st = 0; st < kChunk; ++st) {  // the chunk's states, and y
      if (st >= steps) break;
      const float dt = from_step(dtm, st), u = from_step(um, st), du = dt * u;
      float yp = 0.0f;
#pragma unroll
      for (int i = 0; i < kSPL; ++i) {
        const int k = j + kLPC * i;
        h[i] = exp2f(dt * a2[i]) * h[i] + du * sB[st][k];
        sH[(st * kN + k) * kScanCh + chl] = h[i];
        yp = fmaf(sC[st][k], h[i], yp);
      }
      const float y = channel_sum(yp) + Dc * u;
      if (j == st % kLPC) ym[st / kLPC] = y;
    }
#pragma unroll
    for (int st = kChunk - 1; st >= 0; --st) {
      if (st >= steps) continue;
      const float dt = from_step(dtm, st), u = from_step(um, st), z = from_step(zm, st);
      const float g = from_step(gm, st), y = from_step(ym, st);
      const float sz = sigmoid(z);
      const float dz = g * y * sz * (1.0f + z * (1.0f - sz));
      const float dy = g * z * sz;
      float v[kCPW];  // dB (states j + kLPC i), then dC
      float dda = 0.0f, gB = 0.0f;  // this lane's parts of sum_n s_t h_{t-1} exp(dt a) a2, sum_n s_t B_t
#pragma unroll
      for (int i = 0; i < kSPL; ++i) {
        const int k = j + kLPC * i;
        const float hp = st > 0 ? sH[((st - 1) * kN + k) * kScanCh + chl] : h0[i];
        const float gk = sC[st][k] * dy + carry[i];
        const float ak = exp2f(dt * a2[i]);
        const float gha = gk * hp * ak;
        dA[i] += gha * dt;
        dda += gha * a2[i];
        gB += gk * sB[st][k];
        carry[i] = ak * gk;
        v[i] = gk * dt * u;
        v[kSPL + i] = sH[(st * kN + k) * kScanCh + chl] * dy;
      }
      dda = channel_sum(dda);
      gB = channel_sum(gB);
      const float ddt = dda * kLn2 + u * gB;    // a = a2 ln 2
      const float draw = ddt * -expm1f(-dt);  // ddt * sigmoid(raw)
      dD += dy * u;
      dtb_sum += draw;
      if (active && j == 0) {
        const size_t row = static_cast<size_t>(t0 + st) * d;
        const size_t tok = static_cast<size_t>(sTok[st]) * d;
        du_p[row] = dy * Dc + dt * gB;
        ddb_p[row] = draw;
        dz_p[tok] = dz;
        y_p[tok] = y * z * sz;
      }
      // the warp's sums over its channels: lane (channel ci, j) ends with
      // dB of state j + kLPC ci for ci < kSPL, else dC of state j + kLPC (ci - kSPL)
      const float sum = reduce_scatter_channels(v);
      const int ci = lane / kLPC;
      sBC[warp][st][(ci < kSPL ? 0 : kN) + j + kLPC * (ci % kSPL)] = sum;
    }
    __syncthreads();
    // one dB/dC partial per block and step: the warps' sums, in order
    for (int i = tid; i < steps * kWarp; i += kScanThreads) {
      const int st = i / kWarp, e = i % kWarp;
      float acc = sBC[0][st][e];
#pragma unroll
      for (int w2 = 1; w2 < kScanWarps; ++w2) acc += sBC[w2][st][e];
      bc[(static_cast<size_t>(t0 + st) * p.nblk + blockIdx.x) * kWarp + e] = acc;
    }
  }
  if (active && j == 0) {
    float* part = p.part_scan + (seq * d + c) * kScanParts;
    part[kN] = dD;
    part[kN + 1] = dtb_sum;
  }
  if (active) {
    float* part = p.part_scan + (seq * d + c) * kScanParts;
#pragma unroll
    for (int i = 0; i < kSPL; ++i) part[j + kLPC * i] = dA[i];
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
// in token order, over its ys rows per token. bf16 rounds each stream's share
// as the header says. grid (T, M): a block is one token row, so its merge
// entries are read once.
template <class T>
__global__ void grad_xz_kernel(const Params p) {
  constexpr bool kBf16 = kIsBf16<T>;
  const int m = blockIdx.y, tok = blockIdx.x;
  const int d = p.d, L = p.L, Ls = p.Ls;
  const int b = tok / L, l = tok % L;
  const size_t seq0 = (static_cast<size_t>(m) * p.B + b) * p.S * Ls;  // row of (m, b, s = 0, 0)
  const size_t zrow0 = (static_cast<size_t>(m) * p.B + b) * p.ys * L;
  float* dxz = p.dxz + (static_cast<size_t>(m) * tokens(p) + tok) * 2 * d;
  for (int j = threadIdx.x; j < 2 * d; j += blockDim.x) {
    float acc = 0.0f;
    if (j < d) {
      const float* w = p.br[m].conv_w + static_cast<size_t>(j) * kConv;
      for (int q = 0; q < p.ys; ++q) {
        const int64_t e = p.merge[static_cast<size_t>(l) * p.ys + q];  // s * Ls + pos
        const int pos = static_cast<int>(e % Ls);
        float share = kBf16 ? 0.0f : acc;  // fp32: one running sum over the streams
#pragma unroll
        for (int k = 0; k < kConv; ++k) {
          const int out = pos + kConv - 1 - k;
          if (out < Ls) share = fmaf(w[k], p.du[(seq0 + e + kConv - 1 - k) * d + j], share);
        }
        acc = !kBf16 ? share : acc + (((p.ident >> q) & 1) ? share : round_bf16(share));
      }
    } else {
      for (int s = 0; s < p.ys; ++s) {
        const float v = p.dz[(zrow0 + static_cast<size_t>(s) * L + l) * d + j - d];
        acc += kBf16 && !((p.ident >> s) & 1) ? round_bf16(v) : v;
      }
    }
    dxz[j] = acc;
  }
}

// Per row split: dconv_w[c, k] = sum dpre[row, c] u0[row - K + 1 + k, c] and
// dconv_b[c] = sum dpre[row, c] over the split's stream rows, where u0 is the
// stream's gathered xz_u with zeros before its start. Block (32 channels,
// 8 row lanes); grid (ceil(d / 32), kConvSplits, M).
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

// pre = causal_conv_K(gathered xz[:, :d]) + conv_b and u = silu(pre), stream
// order, as kernel C's conv_kernel. grid (R, M): a block is one stream row
// (b * S + s) * Ls + t, its threads the channels.
__global__ void conv_kernel(const Params p) {
  const int m = blockIdx.y, row = blockIdx.x;
  const int d = p.d, Ls = p.Ls;
  const int t = row % Ls, bs = row / Ls;
  const int64_t* order = p.fwd + static_cast<size_t>(bs % p.S) * Ls;
  const float* xz_b = xz_of(p, m) + static_cast<size_t>(bs / p.S) * p.L * 2 * d;
  const float* tap[kConv];
#pragma unroll
  for (int k = 0; k < kConv; ++k) {
    const int tt = t - (kConv - 1) + k;
    tap[k] = tt >= 0 ? xz_b + order[tt] * 2 * d : nullptr;
  }
  float* pre = pre_of(p, m) + static_cast<size_t>(row) * d;
  float* u = u_of(p, m) + static_cast<size_t>(row) * d;
  for (int ch = threadIdx.x; ch < d; ch += blockDim.x) {
    const float* w = p.br[m].conv_w + static_cast<size_t>(ch) * kConv;
    float acc = p.br[m].conv_b[ch];
#pragma unroll
    for (int k = 0; k < kConv; ++k) {
      if (tap[k] != nullptr) acc = fmaf(w[k], tap[k][ch], acc);
    }
    pre[ch] = acc;
    u[ch] = silu(acc);
  }
}

// ym, out_proj's input as the forward built it from the scan's y: per token,
// scale times the sum of its ys stream rows, in stream order; with the vim
// quirk, scale [y_0 | y_1] at each stream step t (stream s's token fwd[s, t]).
// bf16 rounds as kernel C's merge does. grid (T, M): a block is one token row.
template <class T>
__global__ void merge_y_kernel(const Params p) {
  constexpr bool kBf16 = kIsBf16<T>;
  const int m = blockIdx.y, row = blockIdx.x;
  const int d = p.d, L = p.L, cols = ym_cols(p);
  const int t = row % L;
  const float* y = y_of(p, m) + static_cast<size_t>(row / L) * p.ys * L * d;  // the batch element's rows
  float* ym = ym_of(p, m) + static_cast<size_t>(row) * cols;
  if (p.quirk) {
    const float* y0 = y + p.fwd[t] * d;
    const float* y1 = y + (L + p.fwd[L + t]) * d;
    for (int j = threadIdx.x; j < d; j += blockDim.x) {
      ym[j] = (kBf16 ? round_bf16(y0[j]) : y0[j]) * p.scale;
      ym[d + j] = (kBf16 ? round_bf16(y1[j]) : y1[j]) * p.scale;
    }
    return;
  }
  for (int j = threadIdx.x; j < d; j += blockDim.x) {
    float acc = 0.0f;
    for (int s = 0; s < p.ys; ++s) {
      const float v = y[(static_cast<size_t>(s) * L + t) * d + j];
      acc += kBf16 && !((p.ident >> s) & 1) ? round_bf16(v) : v;
    }
    ym[j] = kBf16 ? round_bf16(acc * p.scale) : acc * p.scale;
  }
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

int tiles(int rows, int cols, int bn, int M) {
  return M * ((rows + tc::kBM - 1) / tc::kBM) * ((cols + bn - 1) / bn);
}

void set_dims(Params& p, int M, int B, int L, int Ls, int h, int d, int r, int S, int quirk,
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
  p.nblk = (d + kScanCh - 1) / kScanCh;
  p.scale = scale;
  const int T = B * L, R = B * S * Ls, r2 = r + 2 * kN, wo = quirk ? 2 * d : d;
  p.sp.xp = tc::splits_for(tiles(R, r2, 64, M), d);
  p.sp.xw = tc::splits_for(tiles(r2, d, 128, M), R);
  p.sp.dtw = tc::splits_for(tiles(d, r, 32, M), R);
  p.sp.inw = tc::splits_for(tiles(2 * d, h, 128, M), T);
  p.sp.outw = tc::splits_for(tiles(h, wo, 64, M), T);
  const size_t sizes[] = {
      p.sp.xp > 1 ? static_cast<size_t>(p.sp.xp) * R * r2 : 0,
      p.sp.xw > 1 ? static_cast<size_t>(p.sp.xw) * r2 * d : 0,
      p.sp.dtw > 1 ? static_cast<size_t>(p.sp.dtw) * d * r : 0,
      p.sp.inw > 1 ? static_cast<size_t>(p.sp.inw) * 2 * d * h : 0,
      p.sp.outw > 1 ? static_cast<size_t>(p.sp.outw) * h * wo : 0,
  };
  p.part_size = *std::max_element(sizes, sizes + 5);
}

// Lay the workspace out for these shapes (pointers into `base` when given);
// returns its size in floats.
size_t layout(Params& p, float* base, int M) {
  const size_t T = static_cast<size_t>(p.B) * p.L, R = static_cast<size_t>(p.B) * p.S * p.Ls;
  const size_t d = p.d, r2 = p.r + 2 * kN, Ty = T * p.ys;
  const size_t sizes[] = {
      T * 2 * d,                                     // xz
      R * d, R * d, R * r2, R * d,                   // u, pre, xdb, dt
      T * (p.quirk ? 2 : 1) * d,                     // gm
      static_cast<size_t>(p.B) * p.S * p.nq * kN * d,  // ckpt
      R * d, R * d, Ty * d, Ty * d,                  // du, ddb, dz, y
      T * (p.quirk ? 2 : 1) * d,                     // ym
      R * p.nblk * kWarp, R * r2, T * 2 * d,         // bc, dxdb, dxz
      static_cast<size_t>(p.B) * p.S * d * kScanParts,  // part_scan
      kConvSplits * d * (kConv + 1),                 // part_conv
      p.part_size,                                   // part
      p.quirk ? static_cast<size_t>(p.h) * 2 * d : 0,  // pout (M = 1)
  };
  float** ptrs[] = {&p.xz, &p.u, &p.pre, &p.xdb, &p.dt, &p.gm, &p.ckpt, &p.du, &p.ddb, &p.dz,
                    &p.y, &p.ym, &p.bc, &p.dxdb, &p.dxz, &p.part_scan, &p.part_conv, &p.part,
                    &p.pout};
  size_t total = 0;
  for (int i = 0; i < 19; ++i) {
    if (base != nullptr) *ptrs[i] = base + total;
    total += sizes[i] * M;
  }
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

}  // namespace

// Floats of workspace that mixer_fused_bwd needs for these shapes.
extern "C" long long mixer_fused_bwd_workspace_floats(int M, int B, int L, int Ls, int h, int d,
                                                      int r, int S, int quirk) {
  Params p{};
  set_dims(p, M, B, L, Ls, h, d, r, S, quirk, 1.0f);
  return static_cast<long long>(layout(p, nullptr, M));
}

namespace {

// The chain of launches for x of type E (see mixer_fused_bwd).
template <class E>
int run(Params& p, int M, cudaStream_t st) {
  const int B = p.B, L = p.L, Ls = p.Ls, h = p.h, d = p.d, r = p.r, S = p.S;
  const bool quirk = p.quirk;
  const int T = B * L, R = B * S * Ls, r2 = r + 2 * kN;
  const size_t xdb_size = static_cast<size_t>(R) * r2;
  static const cudaError_t attr = cudaFuncSetAttribute(
      scan_bwd_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kScanSmem);
  if (attr != cudaSuccess) return static_cast<int>(attr);

  int err = tc::launch_gemm_tc<128, InProj<E>>(p, T, 2 * d, M, st);
  if (err == 0) {
    conv_kernel<<<dim3(R, M), 256, 0, st>>>(p);
    err = static_cast<int>(cudaGetLastError());
  }
  if (err == 0) err = launch_split<64, XProj<E>>(p, p.xdb, p.xdb + xdb_size, R, r2, M, p.sp.xp, st);
  if (err == 0) err = tc::launch_gemm_tc<128, DtProj<E>>(p, R, d, M, st);
  if (err == 0) err = tc::launch_gemm_tc<128, GradOutProj<E>>(p, T, quirk ? 2 * d : d, M, st);
  if (err == 0) {
    scan_bwd_kernel<<<dim3(p.nblk, B * S, M), kScanThreads, kScanSmem, st>>>(p);
    err = static_cast<int>(cudaGetLastError());
  }
  if (err == 0) {
    reduce_bc_kernel<<<dim3(blocks_for(static_cast<size_t>(R) * kWarp, 256), M), 256, 0, st>>>(p);
    err = static_cast<int>(cudaGetLastError());
  }
  if (err == 0) err = tc::launch_gemm_tc<32, GradDtRank<E>>(p, R, r, M, st);
  if (err == 0) {
    err = launch_split<128, GradXProjW<E>>(p, p.br[0].g_xp_w, p.br[1].g_xp_w, r2, d, M, p.sp.xw, st);
  }
  if (err == 0) {
    err = launch_split<32, GradDtW<E>>(p, p.br[0].g_dt_w, p.br[1].g_dt_w, d, r, M, p.sp.dtw, st);
  }
  if (err == 0) err = tc::launch_gemm_tc<128, GradPre<E>>(p, R, d, M, st);
  if (err == 0) {
    grad_xz_kernel<E><<<dim3(T, M), 256, 0, st>>>(p);
    err = static_cast<int>(cudaGetLastError());
  }
  if (err == 0) {
    grad_conv_kernel<<<dim3(blocks_for(d, kWarp), kConvSplits, M), dim3(kWarp, 8), 0, st>>>(p);
    err = static_cast<int>(cudaGetLastError());
  }
  if (err == 0) err = tc::launch_gemm_tc<128, GradX<E>>(p, T, h, M, st);
  if (err == 0) {
    err = launch_split<128, GradInW<E>>(p, p.br[0].g_in_w, p.br[1].g_in_w, 2 * d, h, M, p.sp.inw, st);
  }
  if (err == 0) {
    merge_y_kernel<E><<<dim3(T, M), 256, 0, st>>>(p);
    err = static_cast<int>(cudaGetLastError());
  }
  if (err == 0) {
    err = quirk ? launch_split<64, GradOutW<E>>(p, p.pout, nullptr, h, 2 * d, M, p.sp.outw, st)
                : launch_split<64, GradOutW<E>>(p, p.br[0].g_out_w, p.br[1].g_out_w, h, d, M,
                                                p.sp.outw, st);
  }
  if (err == 0 && quirk) {
    fold_out_w_kernel<<<blocks_for(static_cast<size_t>(h) * d, 256), 256, 0, st>>>(p);
    err = static_cast<int>(cudaGetLastError());
  }
  if (err == 0) {
    finalize_kernel<<<dim3(blocks_for(d, 128), M), 128, 0, st>>>(p);
    err = static_cast<int>(cudaGetLastError());
  }
  return err;
}

}  // namespace

// `ptrs` holds 21 pointers per branch, in the order of struct Branch, for
// M = 1 or 2 branches, all contiguous: x, g and gx of `dtype` (0 fp32, 1
// bf16), the weights and their gradients fp32. `fwd` (S, Ls) and `merge` (L,
// S, or L, 1 for a partition) are int64: with Ls = L each row of fwd is a
// permutation of 0 .. L-1, with Ls = L / S its rows partition them (M = 1).
// `quirk` (M = 1, S = 2, Ls = L) asks for the vim merge's adjoint. `ident`
// (bf16 only) has bit s set when stream s is in token order. Launches the
// chain on `stream`; returns the first launch's cudaError_t that is not 0, or
// -1 for shapes or a dtype that are not built.
extern "C" int mixer_fused_bwd(void* const* ptrs, int M, const void* fwd, const void* merge,
                               void* workspace, int B, int L, int Ls, int h, int d, int n,
                               int r, int K, int S, int quirk, float scale, int dtype, int ident,
                               void* stream) {
  const bool partition = Ls != L;
  if (M < 1 || M > 2 || n != kN || K != kConv || r < 1 || r > kMaxRank || S < 1 ||
      S > kMaxStreams || Ls < 1 || (partition && (Ls * S != L || M != 1)) ||
      (quirk && (S != 2 || partition || M != 1)) || dtype < 0 || dtype > 1) {
    return -1;
  }
  Params p{};
  for (int m = 0; m < M; ++m) {
    void* const* q = ptrs + m * kBranchPtrs;
    const float* in[11];
    float* out[10];
    for (int i = 0; i < 11; ++i) in[i] = static_cast<const float*>(q[i]);
    for (int i = 0; i < 10; ++i) out[i] = static_cast<float*>(q[11 + i]);
    p.br[m] = Branch{q[0], q[1], in[2], in[3], in[4], in[5], in[6], in[7], in[8], in[9], in[10],
                     q[11], out[1], out[2], out[3], out[4], out[5], out[6], out[7], out[8], out[9]};
  }
  p.fwd = static_cast<const int64_t*>(fwd);
  p.merge = static_cast<const int64_t*>(merge);
  set_dims(p, M, B, L, Ls, h, d, r, S, quirk, scale);
  layout(p, static_cast<float*>(workspace), M);
  p.splits = 1;
  p.ident = ident;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return dtype == 1 ? run<bf16>(p, M, st) : run<float>(p, M, st);
}
