// Whole Mamba-2 (SSD) mixer forward for Hopper (sm_90a): in_proj, stream
// gather, causal conv + SiLU, dt = clip(softplus), the per-head cumulative
// decay, the quadratic state-space-duality product, the D skip, un-permute,
// silu(z) gate + RMSNorm per stream, stream merge and out_proj, for one or two
// mixers (the Spiral block's two branches) in one call; optionally with the
// block's LayerNorm + adaLN modulation + soft mask in front (prologue mode).
//
// Replaces the TPU kernel diffma_tpu/ops/fused_ssd.py::_ssd_kernel, as its
// launcher _launch drives it (single, dual-stacked and prologue modes). Per
// branch m and batch element b, with x (L, h), d = d_inner, n = d_state = 16,
// H heads of 64 channels, K = 4 taps, S streams of Ls steps (Ls = L: each a
// permutation of the tokens; Ls = L / S: an exact partition, EfficientVMamba's
// atrous streams, each a sequence of its own whose merge is a scatter), and
// in_proj's columns in the order [z (d) | x (d) | B (n) | C (n) | dt (H)]:
//
//     zx    = x . W_in^T                                      (L, 2d + 2n + H)
//     for each stream s, in token order fwd[s]:
//       [xs | Bs | Cs] = silu(causal_conv_K(zx[fwd[s], d : 2d + 2n]) + conv_b)
//       dt   = clip(softplus(zx[fwd[s], dt columns] + dt_bias), lo, hi)   (L, H)
//       cs   = inclusive cumsum over t of dt * A,  A = -exp(A_log)        (L, H)
//       y[t, head, :] = sum_{u <= t} (Cs_t . Bs_u) exp(cs_t - cs_u) dt_u xs[u, head, :]
//                       + D[head] * xs[t, head, :]
//       y_s  = y back in token order
//       g_s  = y_s * silu(zx[:, :d]);  n_s = g_s * rsqrt(mean_d(g_s^2) + eps) * norm_w
//     merged = scale * sum_s n_s
//     out   = merged . W_out^T                                (L, h)
//
// In prologue mode both branches read the same x, and x is replaced by
// LN(x) * ln_w + ln_b, then * (1 + scale_b) + shift_b, and for the second
// branch * wmask[b, l].
//
// Everything is fp32 on the CUDA cores (no TF32); the cumsum runs in fp64 and
// is rounded once, because everything after it goes through exp(cs_t - cs_u).
// The causal mask is a selection (u <= t), never a product: above the
// diagonal cs_t - cs_u is positive and exp would overflow at wide spans.
//
// Bound on an H100 SXM (67 TFLOP/s fp32 outside the tensor cores, 3.35 TB/s).
// At the DiffMa-B/2 sampler's shapes (batch 1, L = 196, h = 512, d = 1024,
// H = 16, S = 3) one branch does 0.42 GFLOP in in_proj, 0.21 in out_proj and
// 0.12 in the three streams' causal products: 1.5 GFLOP for both branches,
// 22 us at the fp32 rate, against 14.4 MB of weights, x and out, 4 us. So
// operations bound it.
//
// Design, simple and right first. One call launches four kernels on the
// stream (five in prologue mode), with the intermediates in zx and a
// workspace that the caller allocates (ssd_mixer_workspace_floats); at batch
// 1 they are 10 MB and stay in L2. blockIdx.z (or a grid axis) selects the branch in every
// kernel, so both branches share each launch.
// 0. prologue (only in that mode): one block per token row; LayerNorm,
//    modulate, and both branches' inputs written to the workspace.
// 1. in_proj: gemm_nt.cuh's GEMM, 64 x 64 tiles.
// 2. the SSD: one block of 256 threads per (branch, b, stream, head). It
//    stages in shared memory the stream's token order, the head's 64 conv'd
//    channels xs (L x 64), Bs and Cs (L x 16 each; every head's block
//    recomputes them, 32 channels), dt and cs. One warp scans dt * A in fp64.
//    Then, for each tile of 32 steps t, the block builds
//    M[t, u] = (Cs_t . Bs_u) exp(cs_t - cs_u) dt_u for u <= t (0 above the
//    diagonal) in shared memory and multiplies M (32 x t_end) by xs
//    (t_end x 64) with a 2 x 4 register tile per thread, stopping at the
//    tile's last step. y goes to the workspace in token order: per stream
//    for full-length specs (each stream is a permutation, so no two writes
//    meet), one row per token for a partition. The block holds Ls steps, so
//    the shared-memory cap is on Ls.
// 3. gate + norm + merge: one block per token row and branch; each thread
//    holds d / 256 channels; per stream the gated row's sum of squares is
//    reduced over the block, and the normed rows add up in stream order (a
//    partition has one row per token).
// 4. out_proj: the GEMM again, 32 x 64 tiles.
// The TPU kernel's one-hot permutation and head-expansion matmuls, its
// tril-matmul cumsum and its 8-row padding of L exist for the MXU and VMEM;
// here they are index gathers, c / 64, a warp scan and exact t < L.
//
// Stage 2 and the staging of a head live in ssd_core.cuh, which the backward
// (kernel F, fused_ssd_bwd.cu) shares.
//
// The residual: the TPU kernel's want_res outputs, the permuted conv + dt
// columns xs and the gate z, exist so that its backward need not repeat
// in_proj or a permutation (a matmul there). Here a permutation is an index,
// and zx in token order holds both. So zx is not part of the workspace but a
// tensor the caller owns: a caller that needs the backward keeps it for
// kernel F, any other drops it. The kernel does the same work either way.
//
// Several B/C groups, bf16 and a partition spec in prologue mode are not
// built: the wrapper raises for them.

#include <cuda_runtime.h>
#include <stdint.h>

#include "gemm_nt.cuh"
#include "ssd_core.cuh"

namespace {

using ssd::block_sum;
using ssd::kConv;
using ssd::kHd;
using ssd::kMaxSharedBytes;
using ssd::kMaxStreams;
using ssd::kN;
using ssd::silu;

constexpr int kBranchPtrs = 10;
constexpr int kRowThreads = 256;  // gate + norm + merge
constexpr int kMaxPerThread = 8;  // so d <= 2048
constexpr int kProThreads = 128;

struct Branch {
  const float* x;        // (B, L, h)
  const float* in_w;     // (2d + 2n + H, h)
  const float* conv_w;   // (d + 2n, K)
  const float* conv_b;   // (d + 2n,)
  const float* dt_bias;  // (H,)
  const float* A_log;    // (H,)
  const float* D;        // (H,)
  const float* norm_w;   // (d,)
  const float* out_w;    // (h, d)
  float* out;            // (B, L, h)
};

struct Params {
  Branch br[2];
  const int64_t* fwd;  // (S, Ls): stream s visits tokens fwd[s, 0..Ls-1]
  float* xmod;         // (M, B * L, h), prologue mode only
  float* zx;           // (M, B * L, dproj)
  float* y;            // (M, B * y_streams * L, d), token order: y_s[l] at
                       // (b * S + s) * L + l, or y[l] at b * L + l for a partition
  float* merged;       // (M, B * L, d)
  // prologue mode
  const float* wmask;  // (B, L)
  const float* ln_w;   // (h,)
  const float* ln_b;   // (h,)
  const float* shift;  // (B, h), rows mod_stride apart
  const float* scale_;  // (B, h), rows mod_stride apart
  int mod_stride;
  float ln_eps;
  int B, L, h, d, H, S, y_streams, dproj;
  float scale, eps, dt_lo, dt_hi;
};

// 0. LayerNorm + modulate (+ soft mask for branch 1). grid B * L.
__global__ void __launch_bounds__(kProThreads) prologue_kernel(const Params p) {
  __shared__ float red[kProThreads / 32];
  const int row = blockIdx.x;  // b * L + l
  const int b = row / p.L;
  const int h = p.h;
  const float* x = p.br[0].x + static_cast<size_t>(row) * h;
  float s = 0.0f;
  for (int c = threadIdx.x; c < h; c += kProThreads) s += x[c];
  const float mu = block_sum(s, red) / h;
  float q = 0.0f;
  for (int c = threadIdx.x; c < h; c += kProThreads) {
    const float xc = x[c] - mu;
    q += xc * xc;
  }
  const float r = rsqrtf(block_sum(q, red) / h + p.ln_eps);
  const float* shift = p.shift + static_cast<size_t>(b) * p.mod_stride;
  const float* scale = p.scale_ + static_cast<size_t>(b) * p.mod_stride;
  const float wm = p.wmask[row];
  float* x0 = p.xmod + static_cast<size_t>(row) * h;
  float* x1 = x0 + static_cast<size_t>(p.B) * p.L * h;
  for (int c = threadIdx.x; c < h; c += kProThreads) {
    const float xn = (x[c] - mu) * r * p.ln_w[c] + p.ln_b[c];
    const float xm = xn * (1.0f + scale[c]) + shift[c];
    x0[c] = xm;
    x1[c] = xm * wm;
  }
}

struct InProj {  // zx = x . W_in^T
  struct Row {
    const float* x;
  };
  const float* x;
  const float* w;
  float* c;
  int rows, cols, depth;
  __device__ InProj(const Params& p, int m)
      : x(p.xmod ? p.xmod + static_cast<size_t>(m) * p.B * p.L * p.h : p.br[m].x),
        w(p.br[m].in_w),
        c(p.zx + static_cast<size_t>(m) * p.B * p.L * p.dproj),
        rows(p.B * p.L),
        cols(p.dproj),
        depth(p.h) {}
  __device__ Row row(int i) const { return {x + static_cast<size_t>(i) * depth}; }
  __device__ float a(const Row& r, int k) const { return r.x[k]; }
};

struct OutProj {  // out = merged . W_out^T
  struct Row {
    const float* a;
  };
  const float* merged;
  const float* w;
  float* c;
  int rows, cols, depth;
  __device__ OutProj(const Params& p, int m)
      : merged(p.merged + static_cast<size_t>(m) * p.B * p.L * p.d),
        w(p.br[m].out_w),
        c(p.br[m].out),
        rows(p.B * p.L),
        cols(p.h),
        depth(p.d) {}
  __device__ Row row(int i) const { return {merged + static_cast<size_t>(i) * depth}; }
  __device__ float a(const Row& r, int k) const { return r.a[k]; }
};

// 3. Gate with silu(z), RMSNorm over d per stream, sum over streams, * scale.
// grid (B * L, M).
__global__ void __launch_bounds__(kRowThreads) gate_norm_merge_kernel(const Params p) {
  __shared__ float red[kRowThreads / 32];
  const int row = blockIdx.x;  // b * L + l
  const int m = blockIdx.y;
  const int b = row / p.L, l = row % p.L;
  const int d = p.d;
  const float* z = p.zx + (static_cast<size_t>(m) * p.B * p.L + row) * p.dproj;
  const float* norm_w = p.br[m].norm_w;
  float sz[kMaxPerThread], acc[kMaxPerThread], g[kMaxPerThread];
#pragma unroll
  for (int i = 0; i < kMaxPerThread; ++i) {
    const int c = threadIdx.x + i * kRowThreads;
    sz[i] = c < d ? silu(z[c]) : 0.0f;
    acc[i] = 0.0f;
  }
  for (int s = 0; s < p.y_streams; ++s) {
    const float* y =
        p.y + (((static_cast<size_t>(m) * p.B + b) * p.y_streams + s) * p.L + l) * d;
    float q = 0.0f;
#pragma unroll
    for (int i = 0; i < kMaxPerThread; ++i) {
      const int c = threadIdx.x + i * kRowThreads;
      g[i] = c < d ? y[c] * sz[i] : 0.0f;
      q = fmaf(g[i], g[i], q);
    }
    const float rms = rsqrtf(block_sum(q, red) / d + p.eps);
#pragma unroll
    for (int i = 0; i < kMaxPerThread; ++i) {
      const int c = threadIdx.x + i * kRowThreads;
      if (c < d) acc[i] += g[i] * rms * norm_w[c];
    }
  }
  float* out = p.merged + (static_cast<size_t>(m) * p.B * p.L + row) * d;
#pragma unroll
  for (int i = 0; i < kMaxPerThread; ++i) {
    const int c = threadIdx.x + i * kRowThreads;
    if (c < d) out[c] = acc[i] * p.scale;
  }
}

size_t workspace_floats(int M, int B, int L, int Ls, int h, int d, int H, int S,
                        int prologue) {
  const size_t tokens = static_cast<size_t>(M) * B * L;
  return (prologue ? tokens * h : 0)                // xmod
         + tokens * (Ls == L ? S : 1) * d           // y
         + tokens * d;                              // merged
}

}  // namespace

// Floats of workspace that ssd_mixer_fwd needs for these shapes.
extern "C" long long ssd_mixer_workspace_floats(int M, int B, int L, int Ls, int h, int d,
                                                int H, int S, int prologue) {
  return static_cast<long long>(workspace_floats(M, B, L, Ls, h, d, H, S, prologue));
}

// The longest stream whose SSD block fits in a block's shared memory.
extern "C" int ssd_mixer_max_tokens() {
  int L = 0;
  while (ssd::fwd_smem_floats(L + 1) * sizeof(float) <= kMaxSharedBytes) ++L;
  return L;
}

// `ptrs` holds 10 pointers per branch, in the order of struct Branch, for
// M = 1 or 2 branches; all fp32 and contiguous. `fwd` (S, Ls) is int64: with
// Ls = L each of its rows is a permutation of 0 .. L-1, with Ls = L / S its
// rows partition them (not in prologue mode). `pro` is null, or five
// pointers for prologue mode (then M = 2 and both branches' x is the block's
// input): wmask (B, L), ln_w (h,), ln_b (h,), shift and scale (B, h) whose
// rows lie `mod_stride` floats apart. `zx` (M, B * L, dproj) takes in_proj's
// output, the residual that kernel F reads. Launches its kernels on `stream`;
// returns the first cudaError_t that is not 0, or -1 for shapes that are not
// built.
extern "C" int ssd_mixer_fwd(void* const* ptrs, int M, const void* fwd, void* workspace,
                             void* zx, void* const* pro, int mod_stride, float ln_eps,
                             int B, int L, int Ls,
                             int h, int d, int n, int H, int K, int S, float scale,
                             float eps, float dt_lo, float dt_hi, void* stream) {
  const bool partition = Ls != L;
  if (M < 1 || M > 2 || n != kN || K != kConv || H < 1 || d != H * kHd ||
      d > kRowThreads * kMaxPerThread || S < 1 || S > kMaxStreams || Ls < 1 ||
      (partition && (Ls * S != L || pro)) ||
      ssd::fwd_smem_floats(Ls) * sizeof(float) > kMaxSharedBytes || (pro && M != 2)) {
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
        static_cast<const float*>(q[8]), static_cast<float*>(q[9])};
  }
  p.fwd = static_cast<const int64_t*>(fwd);
  const int dproj = 2 * d + 2 * kN + H;
  const size_t tokens = static_cast<size_t>(M) * B * L;
  float* ws = static_cast<float*>(workspace);
  p.xmod = nullptr;
  if (pro) {
    p.xmod = ws;
    ws += tokens * h;
    p.wmask = static_cast<const float*>(pro[0]);
    p.ln_w = static_cast<const float*>(pro[1]);
    p.ln_b = static_cast<const float*>(pro[2]);
    p.shift = static_cast<const float*>(pro[3]);
    p.scale_ = static_cast<const float*>(pro[4]);
    p.mod_stride = mod_stride;
    p.ln_eps = ln_eps;
  }
  p.zx = static_cast<float*>(zx);
  p.y_streams = partition ? 1 : S;
  p.y = ws;
  p.merged = p.y + tokens * p.y_streams * d;
  p.B = B;
  p.L = L;
  p.h = h;
  p.d = d;
  p.H = H;
  p.S = S;
  p.dproj = dproj;
  p.scale = scale;
  p.eps = eps;
  p.dt_lo = dt_lo;
  p.dt_hi = dt_hi;
  cudaStream_t st = static_cast<cudaStream_t>(stream);

  int err;
  if (pro) {
    prologue_kernel<<<B * L, kProThreads, 0, st>>>(p);
    err = static_cast<int>(cudaGetLastError());
    if (err != 0) return err;
  }
  err = launch_gemm<64, 64, 16, 4, 4, InProj>(p, B * L, dproj, M, st);
  if (err != 0) return err;
  ssd::FwdArgs core{};
  for (int m = 0; m < M; ++m) {
    const Branch& br = p.br[m];
    core.mx[m] = ssd::Mixer{br.conv_w, br.conv_b, br.dt_bias, br.A_log, br.D};
  }
  core.fwd = p.fwd;
  core.zx = p.zx;
  core.y = p.y;
  core.B = B;
  core.L = Ls;
  core.Lt = L;
  core.d = d;
  core.S = S;
  core.y_streams = p.y_streams;
  core.dproj = dproj;
  core.dt_lo = dt_lo;
  core.dt_hi = dt_hi;
  err = ssd::launch_ssd_fwd(core, M, H, st);
  if (err != 0) return err;
  gate_norm_merge_kernel<<<dim3(B * L, M), kRowThreads, 0, st>>>(p);
  err = static_cast<int>(cudaGetLastError());
  if (err != 0) return err;
  return launch_gemm<32, 64, 16, 2, 4, OutProj>(p, B * L, h, M, st);
}
