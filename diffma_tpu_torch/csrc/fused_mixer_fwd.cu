// Whole Mamba-1 mixer forward for Hopper (sm_90a): in_proj, stream gather,
// causal conv + SiLU, x_proj, dt_proj, selective scan, silu(z) gate, stream
// merge and out_proj, for one or two mixers (the Spiral block's two branches)
// in one call.
//
// Replaces the TPU kernel diffma_tpu/ops/fused_mixer.py:104 (_mixer_kernel),
// as its launchers _fwd_impl (one mixer) and _dual_fwd_impl (both branches of
// a dual block) drive it. Per branch m and batch element b, with x (L, h),
// d = d_inner, n = d_state = 16, r = dt_rank <= 32, K = 4 taps, S streams of
// Ls steps each:
//
//     xz    = x . W_in^T                                     (L, 2d)
//     for each stream s, in token order fwd[s]:
//       u   = silu(causal_conv_K(xz[fwd[s], :d]) + conv_b)  (zero left-pad)
//       xdb = u . W_x^T  -> dt_r (r), B (n), C (n)
//       dt  = softplus(dt_r . W_dt^T + dt_b);  A = -exp(A_log)
//       h_t = exp(dt A) h_{t-1} + dt u B_t;  y = <C_t, h_t> + D u
//       y_s = y * silu(xz[fwd[s], d:])
//     merged[l] = scale * sum_s y_s[position of token l in stream s]
//     out   = merged . W_out^T                               (L, h)
//
// Three kinds of scan spec:
// * full-length streams (Ls = L, each a permutation of the tokens: spiral,
//   zig, vmamba), one or two branches;
// * an exact partition (Ls = L / S, every token in exactly one stream:
//   EfficientVMamba's atrous streams), one branch. Each stream is a sequence
//   of its own: the conv's pad and the scan's state start at its first step,
//   and the merge is a scatter (the scan writes each token's row once);
// * the Mamba-1 vim quirk (S = 2, the tokens forward and reversed), one
//   branch. Nothing is merged: out_proj runs per stream in the stream's own
//   order, and the second stream's output features are flipped,
//     out[t, j] = scale * (sum_c y_0[t, c] W[j, c] + sum_c y_1[t, c] W[h-1-j, c])
//   with y_s[t] the stream's step t (for the reverse stream, token L-1-t).
//
// Arithmetic. The four products (in_proj, x_proj, dt_proj, out_proj) run on
// the tensor cores in 3xTF32 (gemm_tc.cuh): each operand split once into a
// TF32 high part and a TF32 remainder, three products summed in fp32, which
// keeps about 22 bits of each operand and meets the 1e-4 bar against the
// plain fp32 version at depths 32 to 2048. The conv, the scan and the gate
// are fp32 on the CUDA cores.
//
// Bound on an H100 SXM (495 TFLOP/s TF32 on the tensor cores, 67 TFLOP/s fp32
// outside them, 3.35 TB/s). At the DiffMa-B/2 sampler's shapes (batch 1,
// L = 196, h = 512, d = 1024, r = 32, S = 3), both branches do 1.5 GFLOP of
// products (in_proj 0.82, out_proj 0.41, x_proj 0.15, dt_proj 0.08): 9.4 us
// at the 3xTF32 rate (495 / 3); the scan's 0.13 GFLOP, 1.9 us at the fp32
// rate; 15.2 MB of weights, x and out, 4.5 us. The scan's chain of 196
// dependent steps is what the design has to break up at this size: 192 warps
// of chains, one per 32 channels of a stream, leave most of the 132 SMs idle.
//
// Design. One call launches seven kernels on the stream (up to two more that
// sum split depths, one more with the vim quirk), with the intermediates in
// a workspace the caller allocates (mixer_fused_workspace_floats);
// blockIdx.z selects the branch in every kernel, so both branches share each
// launch.
// 1. in_proj: gemm_tc.cuh over the B * L token rows, 64 x 128 tiles, or
//    64 x 64 when those would leave SMs idle (batch 1: 256 blocks for two
//    branches instead of 128). A split of its depth h, as x_proj's and
//    out_proj's, ran slower at batch 1 (512 blocks: more than the SMs hold
//    at once, and the partials' pass).
// 2. conv + SiLU (conv_kernel: the 4 taps of each stream step gathered from
//    xz through the stream table), then x_proj: gemm_tc.cuh on u. The depth
//    d is split over blocks when the rows are few (at batch 1: 20 tiles, 8
//    splits), and a fixed-order pass sums the splits.
// 3. dt_proj: gemm_tc.cuh, softplus in its store, so the scan reads dt and
//    runs no dot product in its chain (inside the chain, as before, the scan
//    took 0.086 ms at batch 1 against 0.049 plus the product's 0.016).
// 4. the scan, chunked: a block is 32 channels of one stream, its warps
//    chunks of the stream's steps (as many as keep about eight warps per SM
//    in all; one at the training batch). Each warp but the last runs its
//    chunk from a zero state and keeps the chunk's end state and its sum of
//    dt; after one barrier each warp folds the chunks before it, pairwise and
//    in order, h = exp(A sum dt) h + h_chunk (a product of decays, never a
//    quotient, so a wide span underflows to 0 and stays finite), and runs its
//    chunk again from that entry state, writing y at the step's token row.
//    Each warp stages 16 steps of B, C and the token index in shared memory
//    (sized by the chunk count, so that one-warp blocks at the training
//    batch fit many to an SM) and loads its lanes' 16 values of dt, u and z
//    at once, so no step of the chain waits on device memory. This is the
//    associative form of diffma_tpu/ops/selective_scan.py::
//    selective_scan_assoc, with one level of chunks.
// 5. merge (merge_kernel: each token's S stream rows summed in stream order,
//    times scale; a partition has one row per token), then out_proj:
//    gemm_tc.cuh, the depth split at batch 1 and summed in order. With the
//    vim quirk the merge writes the 2d-wide row [y_0 at step t | y_1 at step
//    t] instead, and out_proj runs against [W | flip_h(W)] (h, 2d), which a
//    small kernel writes into the workspace first.
// Both gemm_tc.cuh loaders so read plain rows as float4s: a loader that
// gathered conv taps or summed streams ran the product at 8-18 TFLOP/s.
// The TPU kernel's one-hot permutation matmuls and its 8-row padding of L
// exist for the MXU and VMEM; here they are index gathers and masks.
//
// bf16 (dtype 1: x and out in bf16, the weights fp32), the TPU kernel at a
// compute dtype cd = bfloat16, as the JAX package's bf16 model runs it: the
// four products multiply bf16 operands with fp32 sums (gemm_tc.cuh's kBf16
// stages), each operand rounded to bf16 (to nearest even) where the JAX
// kernel casts it: x and the four weights as they stand, u for x_proj,
// dt_r for dt_proj and out_proj's input. xz is rounded to bf16 as in_proj
// stores it; u, x_proj's output (dt_r, B, C), dt, the conv, the scan and the
// gate stay fp32. The merge follows the kernel's one-hot products: each
// stream's y is rounded to bf16 before the sum, but for a stream in token
// order (`ident`, the TPU kernel's identity streams, added in fp32), and the
// scaled sum is rounded to bf16; with the vim quirk y_0 and y_1 are rounded
// (times the quirk's scale, 1/2, which keeps them bf16). out is rounded to
// bf16 once, after out_proj's fp32 sum (and its splits' sum).
//
// The backward, diffma_tpu/ops/fused_mixer.py:565 (_mixer_bwd_kernel), is
// kernel D, fused_mixer_bwd.cu.

#include <cuda_runtime.h>
#include <stdint.h>

#include "gemm_tc.cuh"

namespace {

constexpr int kN = 16;        // d_state
constexpr int kConv = 4;      // conv taps
constexpr int kMaxRank = 32;  // dt_rank
constexpr int kMaxStreams = 4;
constexpr int kBranchPtrs = 11;
constexpr int kFlipThreads = 256;
constexpr int kEltThreads = 256;  // threads of the elementwise kernels
constexpr int kLanes = 32;     // channels of a scan block
constexpr int kMaxChunks = 8;  // warps of a scan block, each a chunk of steps
constexpr int kSub = 16;       // steps a scan warp stages at a time
constexpr float kLog2e = 1.4426950408889634f;

__device__ __forceinline__ float silu(float x) { return x / (1.0f + expf(-x)); }

using bf16 = tc::bf16;
using tc::al;
using tc::kIsBf16;
using tc::ld;
using tc::ld4;
using tc::put;
using tc::round_bf16;

// softplus(x) = log(1 + exp(x)) without overflow: max(x, 0) + log1p(exp(-|x|)).
__device__ __forceinline__ float softplus(float x) {
  return fmaxf(x, 0.0f) + log1pf(expf(-fabsf(x)));
}

struct Branch {
  const void* x;        // (B, L, h), fp32 or bf16
  const float* in_w;    // (2d, h)
  const float* conv_w;  // (d, K)
  const float* conv_b;  // (d,)
  const float* xp_w;    // (r + 2n, d)
  const float* dt_w;    // (d, r)
  const float* dt_b;    // (d,)
  const float* A_log;   // (d, n)
  const float* D;       // (d,)
  const float* out_w;   // (h, d)
  void* out;            // (B, L, h), x's dtype
};

// Workspace arrays hold both branches, branch m at offset m * (its size).
// T = B * L token rows; R = B * S * Ls stream rows, row (b * S + s) * Ls + t.
struct Params {
  Branch br[2];
  const int64_t* fwd;  // (S, Ls): stream s visits tokens fwd[s, 0..Ls-1]
  float* xz;           // (T, 2d)
  float* u;            // (R, d), stream order
  float* xdb;          // (R, r + 2n), stream order
  float* xdb_part;     // (xp_splits, R, r + 2n): x_proj's split partials, if split
  float* dt;           // (R, d), stream order: softplus(dt_r W_dt^T + dt_b)
  float* y;            // (T * y_streams, d), token order: y_s[l] at
                       // (b * S + s) * L + l, or y[l] at b * L + l for a partition
  float* ym;           // (T, ym_cols): out_proj's input (merge_kernel)
  float* wcat;         // (h, 2d): [W_out | flip_h(W_out)], vim quirk only (M = 1)
  float* out_part;     // (out_splits, T, h): out_proj's split partials, if split
  int B, L, Ls, h, d, r, S, y_streams, ym_cols, in_bn, xp_splits, out_splits;
  int ident;  // bf16: bit s set when stream s runs in token order (its y merges unrounded)
  float scale;
};

__device__ __forceinline__ size_t tokens(const Params& p) { return static_cast<size_t>(p.B) * p.L; }
__device__ __forceinline__ size_t srows(const Params& p) {
  return static_cast<size_t>(p.B) * p.S * p.Ls;
}
__device__ __forceinline__ int r2n(const Params& p) { return p.r + 2 * kN; }

// The stages of gemm_tc.cuh: c[row, col] = sum_k a(row, k) b(col, k) for one
// branch. Rows resolve into an ARow once per thread, before the k-loop. T is
// x's dtype: with bf16 every stage multiplies in bf16 (kBf16).

template <class T>
struct InProj {  // xz = x . W_in^T, rounded to bf16 in the bf16 model
  static constexpr bool kAByRow = false, kBByRow = false, kBf16 = kIsBf16<T>;
  bool vec;  // float4 loads: every row aligned
  struct ARow {
    const T* x;
  };
  const T* x;
  const float* w;
  float* c;
  int rows, cols, depth;
  __device__ InProj(const Params& p, int m)
      : x(static_cast<const T*>(p.br[m].x)), w(p.br[m].in_w), c(p.xz + m * tokens(p) * 2 * p.d),
        rows(static_cast<int>(tokens(p))), cols(2 * p.d), depth(p.h) {
    vec = al(x, depth) && al(w, depth);
  }
  __device__ ARow arow(int i) const { return {x + static_cast<size_t>(i) * depth}; }
  __device__ float a(const ARow& r, int k) const { return ld(r.x + k); }
  __device__ float4 a4(const ARow& r, int k) const { return ld4(r.x + k); }
  __device__ float b(int col, int k) const { return w[static_cast<size_t>(col) * depth + k]; }
  __device__ float4 b4(int col, int k) const { return ld4(w + static_cast<size_t>(col) * depth + k); }
  __device__ void store(int row, int col, int, float v) const {
    c[static_cast<size_t>(row) * cols + col] = kBf16 ? round_bf16(v) : v;
  }
};

template <class T>
struct XProj {  // xdb = u . W_x^T
  static constexpr bool kAByRow = false, kBByRow = false, kBf16 = kIsBf16<T>;
  bool vec;  // float4 loads: every row aligned
  struct ARow {
    const float* u;
  };
  const float *u, *w;
  float* c;
  int rows, cols, depth;
  __device__ XProj(const Params& p, int m)
      : u(p.u + m * srows(p) * p.d), w(p.br[m].xp_w),
        c(p.xp_splits == 1 ? p.xdb + m * srows(p) * r2n(p)
                           : p.xdb_part + static_cast<size_t>(m) * p.xp_splits * srows(p) * r2n(p)),
        rows(static_cast<int>(srows(p))), cols(r2n(p)), depth(p.d) {
    vec = al(u, depth) && al(w, depth);
  }
  __device__ ARow arow(int i) const { return {u + static_cast<size_t>(i) * depth}; }
  __device__ float a(const ARow& r, int k) const { return r.u[k]; }
  __device__ float4 a4(const ARow& r, int k) const { return ld4(r.u + k); }
  __device__ float b(int col, int k) const { return w[static_cast<size_t>(col) * depth + k]; }
  __device__ float4 b4(int col, int k) const { return ld4(w + static_cast<size_t>(col) * depth + k); }
  __device__ void store(int row, int col, int split, float v) const {
    c[(static_cast<size_t>(split) * rows + row) * cols + col] = v;
  }
};

template <class T>
struct DtProj {  // dt = softplus(dt_r . W_dt^T + dt_b); one slab deep
  static constexpr bool kAByRow = false, kBByRow = false, kBf16 = kIsBf16<T>;
  bool vec;  // float4 loads: every row aligned
  struct ARow {
    const float* xdb;
  };
  const float *xdb, *w, *bias;
  float* c;
  int rows, cols, depth, ld;
  __device__ DtProj(const Params& p, int m)
      : xdb(p.xdb + m * srows(p) * r2n(p)), w(p.br[m].dt_w), bias(p.br[m].dt_b),
        c(p.dt + m * srows(p) * p.d), rows(static_cast<int>(srows(p))), cols(p.d), depth(p.r),
        ld(r2n(p)) {
    vec = al(xdb, ld) && al(w, depth);
  }
  __device__ ARow arow(int i) const { return {xdb + static_cast<size_t>(i) * ld}; }
  __device__ float a(const ARow& r, int k) const { return r.xdb[k]; }
  __device__ float4 a4(const ARow& r, int k) const { return ld4(r.xdb + k); }
  __device__ float b(int col, int k) const { return w[static_cast<size_t>(col) * depth + k]; }
  __device__ float4 b4(int col, int k) const { return ld4(w + static_cast<size_t>(col) * depth + k); }
  __device__ void store(int row, int col, int, float v) const {
    c[static_cast<size_t>(row) * cols + col] = softplus(v + bias[col]);
  }
};

// out = ym . W^T: ym is merged (scale * sum_s y_s in token order) against
// W_out, or with the vim quirk scale [y_0 | y_1] at each stream step against
// wcat = [W_out | flip_h(W_out)] (depth 2d). Stores out (x's dtype), or its
// fp32 split partials.
template <class T>
struct OutProj {
  static constexpr bool kAByRow = false, kBByRow = false, kBf16 = kIsBf16<T>;
  bool vec;  // float4 loads: every row aligned
  struct ARow {
    const float* ym;
  };
  const float *ym, *w;
  T* out;
  float* part;
  int rows, cols, depth;
  __device__ OutProj(const Params& p, int m)
      : ym(p.ym + m * tokens(p) * p.ym_cols), w(p.ym_cols == p.d ? p.br[m].out_w : p.wcat),
        out(static_cast<T*>(p.br[m].out)),
        part(p.out_part + static_cast<size_t>(m) * p.out_splits * tokens(p) * p.h),
        rows(static_cast<int>(tokens(p))), cols(p.h), depth(p.ym_cols) {
    vec = al(ym, depth) && al(w, depth);
    if (p.out_splits == 1) part = nullptr;
  }
  __device__ ARow arow(int i) const { return {ym + static_cast<size_t>(i) * depth}; }
  __device__ float a(const ARow& r, int k) const { return r.ym[k]; }
  __device__ float4 a4(const ARow& r, int k) const { return ld4(r.ym + k); }
  __device__ float b(int col, int k) const { return w[static_cast<size_t>(col) * depth + k]; }
  __device__ float4 b4(int col, int k) const { return ld4(w + static_cast<size_t>(col) * depth + k); }
  __device__ void store(int row, int col, int split, float v) const {
    if (part != nullptr) {
      part[(static_cast<size_t>(split) * rows + row) * cols + col] = v;
    } else {
      put(out + static_cast<size_t>(row) * cols + col, v);
    }
  }
};

// u = silu(causal_conv_K(gathered xz[:, :d]) + conv_b), stream order. grid
// (R, M): a block is one stream row (b * S + s) * Ls + t, its threads the
// channels, so the row's tap lookups run once.
__global__ void __launch_bounds__(kEltThreads) conv_kernel(const Params p) {
  const int m = blockIdx.y, row = blockIdx.x;
  const int d = p.d, Ls = p.Ls;
  const int t = row % Ls, bs = row / Ls;
  const int64_t* order = p.fwd + static_cast<size_t>(bs % p.S) * Ls;
  const float* xz_b = p.xz + (static_cast<size_t>(m) * p.B + bs / p.S) * p.L * 2 * d;
  const float* tap[kConv];
#pragma unroll
  for (int k = 0; k < kConv; ++k) {
    const int tt = t - (kConv - 1) + k;
    tap[k] = tt >= 0 ? xz_b + order[tt] * 2 * d : nullptr;
  }
  float* u = p.u + (static_cast<size_t>(m) * srows(p) + row) * d;
  for (int ch = threadIdx.x; ch < d; ch += kEltThreads) {
    const float* w = p.br[m].conv_w + static_cast<size_t>(ch) * kConv;
    float acc = p.br[m].conv_b[ch];
#pragma unroll
    for (int k = 0; k < kConv; ++k) {
      if (tap[k] != nullptr) acc = fmaf(w[k], tap[k][ch], acc);
    }
    u[ch] = silu(acc);
  }
}

// ym, out_proj's input: per token, scale times the sum of its y_streams rows
// in stream order; with the vim quirk, scale [y_0 | y_1] at each stream step
// t (stream s's token fwd[s, t]). bf16 rounds as the header says. grid (T,
// M): a block is one token row.
template <class T>
__global__ void __launch_bounds__(kEltThreads) merge_kernel(const Params p) {
  constexpr bool kBf16 = kIsBf16<T>;
  const int m = blockIdx.y, row = blockIdx.x;
  const int d = p.d, L = p.L, cols = p.ym_cols;
  const int t = row % L;
  const float* y = p.y + (static_cast<size_t>(m) * p.B + row / L) * p.y_streams * L * d;
  float* ym = p.ym + (static_cast<size_t>(m) * tokens(p) + row) * cols;
  if (cols != d) {  // the vim quirk
    const float* y0 = y + p.fwd[t] * d;
    const float* y1 = y + (L + p.fwd[L + t]) * d;
    for (int j = threadIdx.x; j < d; j += kEltThreads) {
      ym[j] = (kBf16 ? round_bf16(y0[j]) : y0[j]) * p.scale;
      ym[d + j] = (kBf16 ? round_bf16(y1[j]) : y1[j]) * p.scale;
    }
    return;
  }
  for (int j = threadIdx.x; j < d; j += kEltThreads) {
    float acc = 0.0f;
    for (int s = 0; s < p.y_streams; ++s) {
      const float v = y[(static_cast<size_t>(s) * L + t) * d + j];
      acc += kBf16 && !((p.ident >> s) & 1) ? round_bf16(v) : v;
    }
    ym[j] = kBf16 ? round_bf16(acc * p.scale) : acc * p.scale;
  }
}

// wcat[j, :] = [W_out[j, :] | W_out[h - 1 - j, :]]. grid ceil(h * 2d / 256).
__global__ void __launch_bounds__(kFlipThreads) flip_cat_kernel(const Params p) {
  const size_t i = static_cast<size_t>(blockIdx.x) * kFlipThreads + threadIdx.x;
  const size_t width = 2 * static_cast<size_t>(p.d);
  if (i >= p.h * width) return;
  const int j = static_cast<int>(i / width), k = static_cast<int>(i % width);
  const float* w = p.br[0].out_w;
  p.wcat[i] = k < p.d ? w[static_cast<size_t>(j) * p.d + k]
                      : w[static_cast<size_t>(p.h - 1 - j) * p.d + (k - p.d)];
}

// One scan warp's shared memory: 16 steps of B, C and the token index, and
// its chunk's end state and sum of dt for the warps after it.
struct ScanWarpSmem {
  float B[kSub][kN];
  float C[kSub][kN];
  int tok[kSub];
  float end[kN + 1][kLanes];
};

// The selective scan with the D skip and the gate, chunked over the warps of
// a block. grid (ceil(d / 32), B * S, M), block (32, chunks): lane = channel,
// warp = chunk of the stream's steps.
__global__ void __launch_bounds__(kLanes * kMaxChunks) scan_kernel(const Params p) {
  // Dynamic shared memory, ScanWarpSmem per warp (chunk), so that a block of
  // one chunk (the training batch) takes no more than it uses.
  extern __shared__ float4 scan_smem[];
  ScanWarpSmem& sw = reinterpret_cast<ScanWarpSmem*>(scan_smem)[threadIdx.y];
  ScanWarpSmem* const all = reinterpret_cast<ScanWarpSmem*>(scan_smem);

  const int lane = threadIdx.x, w = threadIdx.y, chunks = blockDim.y;
  const int m = blockIdx.z;
  const int bs = blockIdx.y;  // b * S + s
  const int s = bs % p.S, b = bs / p.S;
  const int c = blockIdx.x * kLanes + lane;
  const int d = p.d, L = p.L, Ls = p.Ls, r = p.r, ld = r2n(p);
  const bool active = c < d;
  const int cc = active ? c : 0;
  const int len = (Ls + chunks - 1) / chunks;
  const int t_begin = min(Ls, w * len), t_end = min(Ls, t_begin + len);

  // a2 = A log2(e): each decay exp(dt A) is one exp2f(dt a2)
  float a2[kN];
#pragma unroll
  for (int k = 0; k < kN; ++k) {
    a2[k] = active ? -expf(p.br[m].A_log[static_cast<size_t>(c) * kN + k]) * kLog2e : 0.0f;
  }
  const float Dc = active ? p.br[m].D[c] : 0.0f;
  const size_t row0 = (static_cast<size_t>(m) * p.B * p.S + bs) * Ls;  // stream row of step 0
  const size_t yrow0 =
      (p.y_streams == 1 ? static_cast<size_t>(m) * p.B + b
                        : static_cast<size_t>(m) * p.B * p.S + bs) * L;
  const float* xz_b = p.xz + (static_cast<size_t>(m) * p.B + b) * L * 2 * d + d + cc;
  const int64_t* order = p.fwd + static_cast<size_t>(s) * Ls;
  const float* xdb = p.xdb + row0 * ld;
  const float* dt_p = p.dt + row0 * d + cc;
  const float* u_p = p.u + row0 * d + cc;
  float* y_p = p.y + yrow0 * d + cc;

  // Run steps t_begin .. t_end - 1 from state h; with `out`, write y too.
  auto run = [&](bool out, float (&h)[kN], float& dt_sum) {
    for (int t0 = t_begin; t0 < t_end; t0 += kSub) {
      const int steps = min(kSub, t_end - t0);
      __syncwarp();  // the previous staging is no longer read
      for (int i = lane; i < steps * kN; i += kLanes) {
        const float* row = xdb + static_cast<size_t>(t0 + i / kN) * ld + r + i % kN;
        sw.B[i / kN][i % kN] = row[0];
        if (out) sw.C[i / kN][i % kN] = row[kN];
      }
      if (lane < steps) sw.tok[lane] = static_cast<int>(order[t0 + lane]);
      __syncwarp();
      float dtv[kSub], uv[kSub], zv[kSub];
#pragma unroll
      for (int q = 0; q < kSub; ++q) {  // all loads of the 16 steps fly together
        const bool ok = q < steps && active;
        dtv[q] = ok ? dt_p[static_cast<size_t>(t0 + q) * d] : 0.0f;
        uv[q] = ok ? u_p[static_cast<size_t>(t0 + q) * d] : 0.0f;
        zv[q] = (ok && out) ? xz_b[static_cast<size_t>(sw.tok[q]) * 2 * d] : 0.0f;
      }
#pragma unroll
      for (int q = 0; q < kSub; ++q) {
        if (q >= steps) break;
        const float dt = dtv[q], du = dt * uv[q];
        dt_sum += dt;
        float yp[4] = {0.0f, 0.0f, 0.0f, 0.0f};
#pragma unroll
        for (int k = 0; k < kN; ++k) {
          h[k] = exp2f(dt * a2[k]) * h[k] + du * sw.B[q][k];
          yp[k % 4] = fmaf(h[k], sw.C[q][k], yp[k % 4]);
        }
        if (out && active) {
          const float yv = (yp[0] + yp[1]) + (yp[2] + yp[3]) + Dc * uv[q];
          y_p[static_cast<size_t>(sw.tok[q]) * d] = yv * silu(zv[q]);
        }
      }
    }
  };

  float h[kN], dt_sum = 0.0f;
#pragma unroll
  for (int k = 0; k < kN; ++k) h[k] = 0.0f;
  if (w + 1 < chunks) {  // the chunk's own end state, from a zero state
    run(false, h, dt_sum);
#pragma unroll
    for (int k = 0; k < kN; ++k) sw.end[k][lane] = h[k];
    sw.end[kN][lane] = dt_sum;
  }
  __syncthreads();
  // The entry state: the chunks before this one folded in order.
#pragma unroll
  for (int k = 0; k < kN; ++k) h[k] = 0.0f;
  for (int j = 0; j < w; ++j) {
    const float span = all[j].end[kN][lane];
#pragma unroll
    for (int k = 0; k < kN; ++k) h[k] = exp2f(a2[k] * span) * h[k] + all[j].end[k][lane];
  }
  run(true, h, dt_sum);
}

// Chunks per scan block: doubled while the launch keeps under eight warps
// per SM and each chunk at least 8 steps.
int scan_chunks(int blocks, int Ls) {
  int chunks = 1;
  while (2 * chunks <= kMaxChunks && blocks * 2 * chunks <= 8 * tc::kSMs && Ls >= 2 * chunks * 8) {
    chunks *= 2;
  }
  return chunks;
}

void set_dims(Params& p, int M, int B, int L, int Ls, int h, int d, int r, int S) {
  p.B = B;
  p.L = L;
  p.Ls = Ls;
  p.h = h;
  p.d = d;
  p.r = r;
  p.S = S;
  p.y_streams = Ls == L ? S : 1;
  const int R = B * S * Ls, T = B * L, row_tiles = (T + tc::kBM - 1) / tc::kBM;
  // in_proj in 64-wide column tiles when 128-wide ones leave SMs idle (batch 1:
  // 4 row tiles x 16 per branch). Splitting its depth h as well ran slower.
  p.in_bn = M * row_tiles * ((2 * d + 127) / 128) < tc::kSMs ? 64 : 128;
  p.xp_splits = tc::splits_for(M * ((R + tc::kBM - 1) / tc::kBM), d);
  p.out_splits = tc::splits_for(M * ((T + tc::kBM - 1) / tc::kBM) * ((h + 127) / 128), d);
}

// Lay the workspace out (pointers into `base` when given); returns its size in floats.
size_t layout(Params& p, float* base, int M, bool quirk) {
  const size_t T = static_cast<size_t>(p.B) * p.L, R = static_cast<size_t>(p.B) * p.S * p.Ls;
  const size_t d = p.d, r2 = p.r + 2 * kN;
  p.ym_cols = quirk ? 2 * p.d : p.d;
  const size_t sizes[] = {
      T * 2 * d,                                         // xz
      R * d, R * r2,                                     // u, xdb
      p.xp_splits > 1 ? p.xp_splits * R * r2 : 0,        // xdb_part
      R * d, T * p.y_streams * d,                        // dt, y
      T * p.ym_cols,                                     // ym
      quirk ? static_cast<size_t>(p.h) * 2 * d : 0,      // wcat
      p.out_splits > 1 ? p.out_splits * T * p.h : 0,     // out_part
  };
  float** ptrs[] = {&p.xz, &p.u, &p.xdb, &p.xdb_part, &p.dt, &p.y, &p.ym, &p.wcat, &p.out_part};
  size_t total = 0;
  for (int i = 0; i < 9; ++i) {
    if (base != nullptr) *ptrs[i] = base + total;
    total += sizes[i] * M;
  }
  return total;
}

}  // namespace

// Floats of workspace that mixer_fused_fwd needs for these shapes.
extern "C" long long mixer_fused_workspace_floats(int M, int B, int L, int Ls, int h, int d,
                                                  int r, int S, int quirk) {
  Params p{};
  set_dims(p, M, B, L, Ls, h, d, r, S);
  return static_cast<long long>(layout(p, nullptr, M, quirk != 0));
}

namespace {

// The chain of launches for x of type T (see mixer_fused_fwd).
template <class T>
int run(Params& p, int M, int quirk, cudaStream_t st) {
  const int B = p.B, L = p.L, Ls = p.Ls, h = p.h, d = p.d, S = p.S;
  const int T_ = B * L, R = B * S * Ls, r2 = p.r + 2 * kN;

  int err = p.in_bn == 64 ? tc::launch_gemm_tc<64, InProj<T>>(p, T_, 2 * d, M, st)
                         : tc::launch_gemm_tc<128, InProj<T>>(p, T_, 2 * d, M, st);
  if (err == 0) {
    conv_kernel<<<dim3(R, M), kEltThreads, 0, st>>>(p);
    err = static_cast<int>(cudaGetLastError());
  }
  if (err == 0) err = tc::launch_gemm_tc<64, XProj<T>>(p, R, r2, M, st, p.xp_splits);
  if (err == 0 && p.xp_splits > 1) {
    tc::SplitSum q{};
    for (int m = 0; m < M; ++m) {
      q.part[m] = p.xdb_part + static_cast<size_t>(m) * p.xp_splits * R * r2;
      q.out[m] = p.xdb + static_cast<size_t>(m) * R * r2;
    }
    q.n = R * r2;
    q.splits = p.xp_splits;
    err = tc::launch_sum_splits(q, M, st);
  }
  if (err == 0) err = tc::launch_gemm_tc<128, DtProj<T>>(p, R, d, M, st);
  if (err == 0) {
    const dim3 grid((d + kLanes - 1) / kLanes, B * S, M);
    const int chunks = scan_chunks(grid.x * grid.y * grid.z, Ls);
    scan_kernel<<<grid, dim3(kLanes, chunks), chunks * sizeof(ScanWarpSmem), st>>>(p);
    err = static_cast<int>(cudaGetLastError());
  }
  if (err == 0 && quirk) {
    const size_t flips = static_cast<size_t>(h) * 2 * d;
    flip_cat_kernel<<<static_cast<unsigned>((flips + kFlipThreads - 1) / kFlipThreads),
                      kFlipThreads, 0, st>>>(p);
    err = static_cast<int>(cudaGetLastError());
  }
  if (err == 0) {
    merge_kernel<T><<<dim3(T_, M), kEltThreads, 0, st>>>(p);
    err = static_cast<int>(cudaGetLastError());
  }
  if (err == 0) err = tc::launch_gemm_tc<128, OutProj<T>>(p, T_, h, M, st, p.out_splits);
  if (err != 0 || p.out_splits == 1) return err;
  tc::SplitSumOf<T> q{};
  for (int m = 0; m < M; ++m) {
    q.part[m] = p.out_part + static_cast<size_t>(m) * p.out_splits * T_ * h;
    q.out[m] = static_cast<T*>(p.br[m].out);
  }
  q.n = T_ * h;
  q.splits = p.out_splits;
  return tc::launch_sum_splits(q, M, st);
}

}  // namespace

// `ptrs` holds 11 pointers per branch, in the order of struct Branch, for
// M = 1 or 2 branches, all contiguous: x and out of `dtype` (0 fp32, 1 bf16),
// the weights fp32. `fwd` (S, Ls) is int64: with Ls = L each of its rows is
// a permutation of 0 .. L-1, with Ls = L / S its rows partition them (M = 1).
// `quirk` (M = 1, S = 2, Ls = L) asks for the vim merge. `ident` (bf16 only)
// has bit s set when stream s is in token order. Launches its kernels on
// `stream`; returns the first launch's cudaError_t that is not 0, or -1 for
// shapes or a dtype that are not built.
extern "C" int mixer_fused_fwd(void* const* ptrs, int M, const void* fwd,
                               void* workspace, int B, int L, int Ls, int h, int d,
                               int n, int r, int K, int S, int quirk, float scale,
                               int dtype, int ident, void* stream) {
  const bool partition = Ls != L;
  if (M < 1 || M > 2 || n != kN || K != kConv || r < 1 || r > kMaxRank ||
      S < 1 || S > kMaxStreams || Ls < 1 || (partition && (Ls * S != L || M != 1)) ||
      (quirk && (S != 2 || partition || M != 1)) || dtype < 0 || dtype > 1) {
    return -1;
  }
  Params p{};
  for (int m = 0; m < M; ++m) {
    void* const* q = ptrs + m * kBranchPtrs;
    p.br[m] = Branch{
        q[0], static_cast<const float*>(q[1]),
        static_cast<const float*>(q[2]), static_cast<const float*>(q[3]),
        static_cast<const float*>(q[4]), static_cast<const float*>(q[5]),
        static_cast<const float*>(q[6]), static_cast<const float*>(q[7]),
        static_cast<const float*>(q[8]), static_cast<const float*>(q[9]), q[10]};
  }
  p.fwd = static_cast<const int64_t*>(fwd);
  p.scale = scale;
  p.ident = ident;
  set_dims(p, M, B, L, Ls, h, d, r, S);
  layout(p, static_cast<float*>(workspace), M, quirk != 0);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return dtype == 1 ? run<bf16>(p, M, quirk, st) : run<float>(p, M, quirk, st);
}
