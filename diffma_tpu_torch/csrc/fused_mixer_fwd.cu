// Whole Mamba-1 mixer forward for Hopper (sm_90a): in_proj, stream gather,
// causal conv + SiLU, x_proj, dt_proj, selective scan, silu(z) gate, stream
// merge and out_proj, for one or two mixers (the Spiral block's two branches)
// in one call.
//
// Replaces the TPU kernel diffma_tpu/ops/fused_mixer.py::_mixer_kernel, as
// its launchers _fwd_impl (one mixer) and _dual_fwd_impl (both branches of a
// dual block) drive it. Per branch m and batch element b, with x (L, h),
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
// Everything is fp32, on the CUDA cores (no TF32), so that the kernel agrees
// with its plain PyTorch version to fp32 rounding.
//
// Bound on an H100 SXM (67 TFLOP/s fp32 outside the tensor cores, 3.35 TB/s).
// At the DiffMa-B/2 sampler's shapes (batch 1, L = 196, h = 512, d = 1024,
// r = 32, S = 3), one branch does 0.80 GFLOP: in_proj 411 M, x_proj 77 M,
// dt_proj 39 M, the scan 63 M, out_proj 206 M, the conv 5 M. Both branches
// take 1.60 GFLOP, 24 us at the fp32 rate. The bytes that must move are the
// weights (6.8 MB per branch) and x and out (0.8 MB per branch), 15.2 MB or
// 4.5 us. So operations bound it, at about 24 us per call. At batch 1 the
// scan's 196-step chain, whose steps depend on each other, will take longer
// than that (kernel A, the same recurrence, takes 0.145 ms).
//
// Design, simple and right first. One call launches four kernels on the
// stream (five with the vim quirk), with the intermediates in a workspace
// the caller allocates (mixer_fused_workspace_floats); at batch 1 it is 13 MB
// and stays in L2. blockIdx.z selects the branch in every kernel, so both
// branches share each launch.
// 1. in_proj: the tiled GEMM of gemm_nt.cuh (64 x 64 tiles, 16-deep k-slabs
//    in shared memory, a 4 x 4 register tile per thread, the next slab loaded
//    into registers during the products) over the B * L token rows; the
//    ragged edge of L is masked. 4 x 32 tiles per branch at batch 1.
//    Each thread resolves its tile rows into pointers once, before the
//    k-loop, so the loop's loads need no index arithmetic, and no load in a
//    loader waits on another: a chain of dependent loads outlasts the
//    products that the next slab's loads should hide behind.
// 2. conv + x_proj and 3. the scan: mixer_core.cuh, which kernel H
//    (fused_mamba_fwd.cu) shares. The scan writes y at the step's token
//    index: per stream for full-length specs (each stream is a permutation,
//    so no two writes meet), into one row per token for a partition.
// 4. merge + out_proj: the GEMM, whose A-tile loader sums the S streams'
//    rows of each token, in stream order, times scale (a partition has one
//    row per token). 32-row tiles. With the vim quirk the loader reads the
//    2d-wide row [y_0 at step t | y_1 at step t] instead, against the weight
//    [W | flip_h(W)] (h, 2d), which a small kernel writes into the workspace
//    first.
// The TPU kernel's one-hot permutation matmuls and its 8-row padding of L
// exist for the MXU and VMEM; here they are index gathers and masks.
//
// The backward, diffma_tpu/ops/fused_mixer.py::_mixer_bwd_kernel, is kernel
// D, fused_mixer_bwd.cu.

#include <cuda_runtime.h>
#include <stdint.h>

#include "gemm_nt.cuh"
#include "mixer_core.cuh"

namespace {

using mixer::kConv;
using mixer::kMaxRank;
using mixer::kN;

constexpr int kMaxStreams = 4;
constexpr int kBranchPtrs = 11;
constexpr int kFlipThreads = 256;

struct Branch {
  const float* x;       // (B, L, h)
  const float* in_w;    // (2d, h)
  const float* conv_w;  // (d, K)
  const float* conv_b;  // (d,)
  const float* xp_w;    // (r + 2n, d)
  const float* dt_w;    // (d, r)
  const float* dt_b;    // (d,)
  const float* A_log;   // (d, n)
  const float* D;       // (d,)
  const float* out_w;   // (h, d)
  float* out;           // (B, L, h)
};

struct Params {
  Branch br[2];
  const int64_t* fwd;  // (S, Ls): stream s visits tokens fwd[s, 0..Ls-1]
  float* xz;           // (M, B * L, 2d)
  float* y;            // (M, B * y_streams * L, d), token order: y_s[l] at
                       // (b * S + s) * L + l, or y[l] at b * L + l for a partition
  float* wcat;         // (M, h, 2d): [W_out | flip_h(W_out)], vim quirk only
  int B, L, h, d, S, y_streams;
  float scale;
};

// The stages of gemm_nt.cuh's GEMM: c[row, col] = sum_k a(row, k) * w[col, k]
// for one branch, w a torch Linear weight (cols, depth), row-major. A thread
// resolves each of its rows into a Row (the pointers its loads need) once,
// before the k-loop.

struct InProj {  // xz = x . W_in^T
  struct Row {
    const float* x;
  };
  const float* x;
  const float* w;
  float* c;
  int rows, cols, depth;
  __device__ InProj(const Params& p, int m)
      : x(p.br[m].x),
        w(p.br[m].in_w),
        c(p.xz + static_cast<size_t>(m) * p.B * p.L * 2 * p.d),
        rows(p.B * p.L),
        cols(2 * p.d),
        depth(p.h) {}
  __device__ Row row(int i) const { return {x + static_cast<size_t>(i) * depth}; }
  __device__ float a(const Row& r, int k) const { return r.x[k]; }
};

struct MergeOutProj {  // out = (scale * sum_s y_s) . W_out^T
  struct Row {
    const float* y;  // stream 0's row of the token; stream s is s * L rows on
  };
  const float* y;
  const float* w;
  float* c;
  float scale;
  int rows, cols, depth, L, S;
  __device__ MergeOutProj(const Params& p, int m)
      : y(p.y + static_cast<size_t>(m) * p.B * p.y_streams * p.L * p.d),
        w(p.br[m].out_w),
        c(p.br[m].out),
        scale(p.scale),
        rows(p.B * p.L),
        cols(p.h),
        depth(p.d),
        L(p.L),
        S(p.y_streams) {}
  __device__ Row row(int i) const {  // i = b * L + l
    return {y + (static_cast<size_t>(i / L) * S * L + i % L) * depth};
  }
  __device__ float a(const Row& r, int ch) const {
    float ys[kMaxStreams];
#pragma unroll
    for (int s = 0; s < kMaxStreams; ++s) {
      ys[s] = s < S ? r.y[static_cast<size_t>(s) * L * depth + ch] : 0.0f;
    }
    float acc = ys[0];
#pragma unroll
    for (int s = 1; s < kMaxStreams; ++s) acc += ys[s];  // stream order; the 0s add nothing
    return acc * scale;
  }
};

// The vim quirk's out_proj: out = scale * (y_0 . W^T + flip_h(y_1 . W^T)), each
// stream's rows in its own order, as one product of depth 2d against wcat.
struct QuirkOutProj {
  struct Row {
    const float* y0;  // stream 0's row at this step
    const float* y1;  // stream 1's row at this step, less d floats
  };
  const float* y;
  const int64_t* fwd;
  const float* w;
  float* c;
  float scale;
  int rows, cols, depth, L, d;
  __device__ QuirkOutProj(const Params& p, int m)
      : y(p.y + static_cast<size_t>(m) * p.B * 2 * p.L * p.d),
        fwd(p.fwd),
        w(p.wcat + static_cast<size_t>(m) * p.h * 2 * p.d),
        c(p.br[m].out),
        scale(p.scale),
        rows(p.B * p.L),
        cols(p.h),
        depth(2 * p.d),
        L(p.L),
        d(p.d) {}
  __device__ Row row(int i) const {  // i = b * L + t; y_s[token] at (b * 2 + s) * L + token
    const int t = i % L;
    const float* y_b = y + static_cast<size_t>(i / L) * 2 * L * d;
    return {y_b + fwd[t] * d, y_b + (L + fwd[L + t]) * d - d};
  }
  __device__ float a(const Row& r, int k) const { return (k < d ? r.y0[k] : r.y1[k]) * scale; }
};

// wcat[j, :] = [W_out[j, :] | W_out[h - 1 - j, :]]. grid (ceil(h * 2d / 256), M).
__global__ void __launch_bounds__(kFlipThreads) flip_cat_kernel(const Params p) {
  const int m = blockIdx.y;
  const size_t i = static_cast<size_t>(blockIdx.x) * kFlipThreads + threadIdx.x;
  const size_t width = 2 * static_cast<size_t>(p.d);
  if (i >= p.h * width) return;
  const int j = static_cast<int>(i / width), k = static_cast<int>(i % width);
  const float* w = p.br[m].out_w;
  p.wcat[static_cast<size_t>(m) * p.h * width + i] =
      k < p.d ? w[static_cast<size_t>(j) * p.d + k]
              : w[static_cast<size_t>(p.h - 1 - j) * p.d + (k - p.d)];
}

size_t workspace_floats(int M, int B, int L, int Ls, int h, int d, int r, int S, int quirk) {
  const size_t tokens = static_cast<size_t>(M) * B * L;
  const size_t stream_rows = static_cast<size_t>(M) * B * S * Ls;
  const size_t y_streams = Ls == L ? S : 1;
  return tokens * 2 * d                   // xz
         + stream_rows * d                // u
         + stream_rows * (r + 2 * kN)     // xdb
         + tokens * y_streams * d         // y
         + (quirk ? static_cast<size_t>(M) * h * 2 * d : 0);  // wcat
}

}  // namespace

// Floats of workspace that mixer_fused_fwd needs for these shapes.
extern "C" long long mixer_fused_workspace_floats(int M, int B, int L, int Ls, int h, int d,
                                                  int r, int S, int quirk) {
  return static_cast<long long>(workspace_floats(M, B, L, Ls, h, d, r, S, quirk));
}

// `ptrs` holds 11 pointers per branch, in the order of struct Branch, for
// M = 1 or 2 branches; all fp32 and contiguous. `fwd` (S, Ls) is int64: with
// Ls = L each of its rows is a permutation of 0 .. L-1, with Ls = L / S its
// rows partition them (M = 1). `quirk` (M = 1, S = 2, Ls = L) asks for the vim
// merge. Launches its kernels on `stream`; returns the first launch's
// cudaError_t that is not 0, or -1 for shapes that are not built.
extern "C" int mixer_fused_fwd(void* const* ptrs, int M, const void* fwd,
                               void* workspace, int B, int L, int Ls, int h, int d,
                               int n, int r, int K, int S, int quirk, float scale,
                               void* stream) {
  const bool partition = Ls != L;
  if (M < 1 || M > 2 || n != kN || K != kConv || r < 1 || r > kMaxRank ||
      S < 1 || S > kMaxStreams || Ls < 1 || (partition && (Ls * S != L || M != 1)) ||
      (quirk && (S != 2 || partition || M != 1))) {
    return -1;
  }
  Params p{};
  for (int m = 0; m < M; ++m) {
    void* const* q = ptrs + m * kBranchPtrs;
    p.br[m] = Branch{
        static_cast<const float*>(q[0]), static_cast<const float*>(q[1]),
        static_cast<const float*>(q[2]), static_cast<const float*>(q[3]),
        static_cast<const float*>(q[4]), static_cast<const float*>(q[5]),
        static_cast<const float*>(q[6]), static_cast<const float*>(q[7]),
        static_cast<const float*>(q[8]), static_cast<const float*>(q[9]),
        static_cast<float*>(q[10])};
  }
  p.fwd = static_cast<const int64_t*>(fwd);
  float* ws = static_cast<float*>(workspace);
  const size_t tokens = static_cast<size_t>(M) * B * L;
  const size_t stream_rows = static_cast<size_t>(M) * B * S * Ls;
  p.y_streams = partition ? 1 : S;
  p.xz = ws;
  mixer::Inner in{};
  in.u = p.xz + tokens * 2 * d;
  in.xdb = in.u + stream_rows * d;
  p.y = in.xdb + stream_rows * (r + 2 * kN);
  p.wcat = p.y + tokens * p.y_streams * d;
  p.B = B;
  p.L = L;
  p.h = h;
  p.d = d;
  p.S = S;
  p.scale = scale;
  for (int m = 0; m < M; ++m) {
    const Branch& br = p.br[m];
    in.w[m] = mixer::Weights{br.conv_w, br.conv_b, br.xp_w, br.dt_w, br.dt_b, br.A_log, br.D};
  }
  in.fwd = p.fwd;
  in.xz = p.xz;
  in.y = p.y;
  in.B = B;
  in.L = L;
  in.Ls = Ls;
  in.d = d;
  in.r = r;
  in.S = S;
  in.y_streams = p.y_streams;
  in.a_is_log = true;
  cudaStream_t s = static_cast<cudaStream_t>(stream);

  int err = launch_gemm<64, 64, 16, 4, 4, InProj>(p, B * L, 2 * d, M, s);
  if (err != 0) return err;
  err = mixer::launch_inner(in, M, s);
  if (err != 0) return err;
  if (!quirk) return launch_gemm<32, 64, 16, 2, 4, MergeOutProj>(p, B * L, h, M, s);
  const size_t flips = static_cast<size_t>(h) * 2 * d;
  flip_cat_kernel<<<dim3(static_cast<unsigned>((flips + kFlipThreads - 1) / kFlipThreads), M),
                    kFlipThreads, 0, s>>>(p);
  err = static_cast<int>(cudaGetLastError());
  if (err != 0) return err;
  return launch_gemm<32, 64, 16, 2, 4, QuirkOutProj>(p, B * L, h, M, s);
}
