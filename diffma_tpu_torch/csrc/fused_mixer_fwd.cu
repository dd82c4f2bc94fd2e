// Whole Mamba-1 mixer forward for Hopper (sm_90a): in_proj, stream gather,
// causal conv + SiLU, x_proj, dt_proj, selective scan, silu(z) gate, stream
// merge and out_proj, for one or two mixers (the Spiral block's two branches)
// in one call.
//
// Replaces the TPU kernel diffma_tpu/ops/fused_mixer.py::_mixer_kernel, as
// its launchers _fwd_impl (one mixer) and _dual_fwd_impl (both branches of a
// dual block) drive it. Per branch m and batch element b, with x (L, h),
// d = d_inner, n = d_state = 16, r = dt_rank <= 32, K = 4 taps, S streams:
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
// stream, with the intermediates in a workspace the caller allocates
// (mixer_fused_workspace_floats); at batch 1 it is 13 MB and stays in L2.
// blockIdx.z selects the branch in every kernel, so both branches share each
// launch.
// 1. in_proj: the tiled GEMM of gemm_nt.cuh (64 x 64 tiles, 16-deep k-slabs
//    in shared memory, a 4 x 4 register tile per thread, the next slab loaded
//    into registers during the products) over the B * L token rows; the
//    ragged edge of L is masked. 4 x 32 tiles per branch at batch 1.
//    Each thread resolves its tile rows into pointers once, before the
//    k-loop, so the loop's loads need no index arithmetic, and no load in a
//    loader waits on another: a chain of dependent loads outlasts the
//    products that the next slab's loads should hide behind.
// 2. conv + x_proj: the same GEMM, whose A-tile loader gathers the 4 conv
//    taps of each stream position from xz (rows looked up through fwd when
//    the thread resolves its row), adds the bias, applies SiLU, and stores u
//    for the scan. 16-row tiles, to spread the 588 stream rows over 74 blocks.
// 3. the scan: kernel A's design, one thread per (branch, b, s, channel) with
//    its 16 states and its row of A = -exp(A_log) in registers, in blocks of
//    32 channels. Each block stages 64 steps of dt_r, B, C and the token
//    index in shared memory. The channel's 32 dt_proj weights live in
//    registers, so dt_proj and softplus run inside the recurrence; its dot
//    product and C . h run as 4 partial sums each, to shorten the step's
//    dependent chain. z is read straight out of xz through the token index,
//    one step ahead like u, and y is written back in token order (each
//    stream is a permutation, so no two writes meet).
// 4. merge + out_proj: the GEMM, whose A-tile loader sums the S streams'
//    rows of each token, in stream order, times scale. 32-row tiles.
// The TPU kernel's one-hot permutation matmuls and its 8-row padding of L
// exist for the MXU and VMEM; here they are index gathers and masks.
//
// The backward, diffma_tpu/ops/fused_mixer.py::_mixer_bwd_kernel, is kernel
// D, fused_mixer_bwd.cu. The vim feature-flip quirk and partition specs are
// not built: the wrapper raises for them.

#include <cuda_runtime.h>
#include <stdint.h>

#include "gemm_nt.cuh"

namespace {

constexpr int kN = 16;        // d_state
constexpr int kConv = 4;      // conv taps
constexpr int kMaxRank = 32;  // dt_rank
constexpr int kMaxStreams = 4;
constexpr int kBranchPtrs = 11;
constexpr int kScanThreads = 32;
constexpr int kScanChunk = 64;
constexpr int kSums = 4;  // partial sums per dot product in the scan
static_assert(kSums == 4, "the scan adds its partial sums as two pairs");

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
  const int64_t* fwd;  // (S, L): stream s visits tokens fwd[s, 0..L-1]
  float* xz;           // (M, B * L, 2d)
  float* u;            // (M, B * S * L, d), stream order
  float* xdb;          // (M, B * S * L, r + 2n), stream order
  float* y;            // (M, B * S * L, d), token order: y_s[l] at (b * S + s) * L + l
  int B, L, h, d, r, S;
  float scale;
};

__device__ __forceinline__ float silu(float x) { return x / (1.0f + expf(-x)); }

// softplus(x) = log(1 + exp(x)) without overflow: max(x, 0) + log1p(exp(-|x|)).
__device__ __forceinline__ float softplus(float x) {
  return fmaxf(x, 0.0f) + log1pf(expf(-fabsf(x)));
}

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

struct ConvXProj {  // u = silu(conv(gathered xz[:, :d])); xdb = u . W_x^T
  struct Row {
    const float* tap[kConv];  // xz row of each tap; in the left pad, any row
    float live[kConv];        // 1 for a tap inside the stream, 0 in the pad
    float* u;
  };
  const float* xz;
  const float* conv_w;
  const float* conv_b;
  const int64_t* fwd;
  float* u;
  const float* w;
  float* c;
  int rows, cols, depth, L, S;
  bool store_u;
  __device__ ConvXProj(const Params& p, int m)
      : xz(p.xz + static_cast<size_t>(m) * p.B * p.L * 2 * p.d),
        conv_w(p.br[m].conv_w),
        conv_b(p.br[m].conv_b),
        fwd(p.fwd),
        u(p.u + static_cast<size_t>(m) * p.B * p.S * p.L * p.d),
        w(p.br[m].xp_w),
        c(p.xdb + static_cast<size_t>(m) * p.B * p.S * p.L * (p.r + 2 * kN)),
        rows(p.B * p.S * p.L),
        cols(p.r + 2 * kN),
        depth(p.d),
        L(p.L),
        S(p.S),
        store_u(blockIdx.y == 0) {}  // the first column tile writes u once
  __device__ Row row(int i) const {  // i = (b * S + s) * L + t
    const int t = i % L, bs = i / L;
    const int64_t* order = fwd + static_cast<size_t>(bs % S) * L;
    const float* xz_b = xz + static_cast<size_t>(bs / S) * L * 2 * depth;
    Row r;
#pragma unroll
    for (int k = 0; k < kConv; ++k) {
      const int tt = t - (kConv - 1) + k;
      r.tap[k] = xz_b + order[max(tt, 0)] * 2 * depth;
      r.live[k] = tt >= 0 ? 1.0f : 0.0f;
    }
    r.u = u + static_cast<size_t>(i) * depth;
    return r;
  }
  __device__ float a(const Row& r, int ch) const {
    const float4 wk = reinterpret_cast<const float4*>(conv_w)[ch];  // taps 0..3
    const float wt[kConv] = {wk.x, wk.y, wk.z, wk.w};
    float xv[kConv];
#pragma unroll
    for (int k = 0; k < kConv; ++k) xv[k] = r.tap[k][ch];
    float acc = conv_b[ch];
#pragma unroll
    for (int k = 0; k < kConv; ++k) acc = fmaf(wt[k] * r.live[k], xv[k], acc);
    const float v = silu(acc);
    if (store_u) r.u[ch] = v;
    return v;
  }
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
      : y(p.y + static_cast<size_t>(m) * p.B * p.S * p.L * p.d),
        w(p.br[m].out_w),
        c(p.br[m].out),
        scale(p.scale),
        rows(p.B * p.L),
        cols(p.h),
        depth(p.d),
        L(p.L),
        S(p.S) {}
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

// The selective scan with dt_proj, softplus, the D skip and the gate fused.
// grid (ceil(d / 32), B * S, M); one thread per channel.
__global__ void __launch_bounds__(kScanThreads) scan_kernel(const Params p) {
  __shared__ float sDt[kScanChunk][kMaxRank];
  __shared__ float sB[kScanChunk][kN];
  __shared__ float sC[kScanChunk][kN];
  __shared__ int64_t sTok[kScanChunk];

  const int m = blockIdx.z;
  const int bs = blockIdx.y;  // b * S + s
  const int s = bs % p.S;
  const int b = bs / p.S;
  const int c = blockIdx.x * kScanThreads + threadIdx.x;
  const int d = p.d, L = p.L, r = p.r, r2n = p.r + 2 * kN;
  const bool active = c < d;
  const float* A_log = p.br[m].A_log;
  const float* dt_w = p.br[m].dt_w;

  float a[kN], h[kN], wdt[kMaxRank];
#pragma unroll
  for (int k = 0; k < kN; ++k) {
    a[k] = active ? -expf(A_log[static_cast<size_t>(c) * kN + k]) : 0.0f;
    h[k] = 0.0f;
  }
#pragma unroll
  for (int j = 0; j < kMaxRank; ++j) {
    wdt[j] = (active && j < r) ? dt_w[static_cast<size_t>(c) * r + j] : 0.0f;
  }
  const float dtb = active ? p.br[m].dt_b[c] : 0.0f;
  const float Dc = active ? p.br[m].D[c] : 0.0f;

  // Row of (m, b, s, t = 0) in u, xdb and y.
  const size_t row0 = (static_cast<size_t>(m) * p.B * p.S + bs) * L;
  const float* xz_b = p.xz + (static_cast<size_t>(m) * p.B + b) * L * 2 * d;
  const int64_t* order = p.fwd + static_cast<size_t>(s) * L;

  for (int t0 = 0; t0 < L; t0 += kScanChunk) {
    const int steps = min(kScanChunk, L - t0);
    __syncthreads();  // the previous chunk's staging is no longer read
    const float* xrow = p.xdb + (row0 + t0) * r2n;
    for (int i = threadIdx.x; i < steps * kMaxRank; i += kScanThreads) {
      const int t = i / kMaxRank, j = i % kMaxRank;
      sDt[t][j] = j < r ? xrow[static_cast<size_t>(t) * r2n + j] : 0.0f;
    }
    for (int i = threadIdx.x; i < steps * kN; i += kScanThreads) {
      const int t = i / kN, k = i % kN;
      sB[t][k] = xrow[static_cast<size_t>(t) * r2n + r + k];
      sC[t][k] = xrow[static_cast<size_t>(t) * r2n + r + kN + k];
    }
    for (int i = threadIdx.x; i < steps; i += kScanThreads) sTok[i] = order[t0 + i];
    __syncthreads();
    if (!active) continue;
    const float* u_t = p.u + (row0 + t0) * d + c;
    float u_next = u_t[0];
    float z_next = xz_b[sTok[0] * 2 * d + d + c];
    for (int t = 0; t < steps; ++t) {
      const float uv = u_next, zv = z_next;
      if (t + 1 < steps) {  // the next step's loads fly during this step
        u_next = u_t[static_cast<size_t>(t + 1) * d];
        z_next = xz_b[sTok[t + 1] * 2 * d + d + c];
      }
      // The dot products run as kSums independent partial sums: a chain of
      // 32 or 16 dependent adds would set each step's latency.
      float part[kSums];
#pragma unroll
      for (int q = 0; q < kSums; ++q) part[q] = 0.0f;
#pragma unroll
      for (int j = 0; j < kMaxRank; ++j) {
        part[j % kSums] = fmaf(wdt[j], sDt[t][j], part[j % kSums]);
      }
      const float dt = softplus((part[0] + part[1]) + (part[2] + part[3]) + dtb);
      const float du = dt * uv;
#pragma unroll
      for (int q = 0; q < kSums; ++q) part[q] = 0.0f;
#pragma unroll
      for (int k = 0; k < kN; ++k) {
        h[k] = expf(dt * a[k]) * h[k] + du * sB[t][k];
        part[k % kSums] = fmaf(h[k], sC[t][k], part[k % kSums]);
      }
      const float yv = (part[0] + part[1]) + (part[2] + part[3]) + Dc * uv;
      p.y[(row0 + sTok[t]) * d + c] = yv * silu(zv);  // back in token order
    }
  }
}

size_t workspace_floats(int M, int B, int L, int d, int r, int S) {
  const size_t tokens = static_cast<size_t>(M) * B * L;
  const size_t stream_rows = tokens * S;
  return tokens * 2 * d                   // xz
         + stream_rows * d                // u
         + stream_rows * (r + 2 * kN)     // xdb
         + stream_rows * d;               // y
}

}  // namespace

// Floats of workspace that mixer_fused_fwd needs for these shapes.
extern "C" long long mixer_fused_workspace_floats(int M, int B, int L, int d,
                                                  int r, int S) {
  return static_cast<long long>(workspace_floats(M, B, L, d, r, S));
}

// `ptrs` holds 11 pointers per branch, in the order of struct Branch, for
// M = 1 or 2 branches; all fp32 and contiguous. `fwd` (S, L) is int64 and
// each of its rows a permutation of 0 .. L-1. Launches four kernels on
// `stream`; returns the first launch's cudaError_t that is not 0, or -1 for
// shapes that are not built.
extern "C" int mixer_fused_fwd(void* const* ptrs, int M, const void* fwd,
                               void* workspace, int B, int L, int h, int d,
                               int n, int r, int K, int S, float scale,
                               void* stream) {
  if (M < 1 || M > 2 || n != kN || K != kConv || r < 1 || r > kMaxRank ||
      S < 1 || S > kMaxStreams) {
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
  p.xz = ws;
  p.u = p.xz + tokens * 2 * d;
  p.xdb = p.u + tokens * S * d;
  p.y = p.xdb + tokens * S * (r + 2 * kN);
  p.B = B;
  p.L = L;
  p.h = h;
  p.d = d;
  p.r = r;
  p.S = S;
  p.scale = scale;
  cudaStream_t s = static_cast<cudaStream_t>(stream);

  int err = launch_gemm<64, 64, 16, 4, 4, InProj>(p, B * L, 2 * d, M, s);
  if (err != 0) return err;
  err = launch_gemm<16, 64, 16, 1, 4, ConvXProj>(p, B * S * L, r + 2 * kN, M, s);
  if (err != 0) return err;
  const dim3 scan_grid((d + kScanThreads - 1) / kScanThreads, B * S, M);
  scan_kernel<<<scan_grid, kScanThreads, 0, s>>>(p);
  err = static_cast<int>(cudaGetLastError());
  if (err != 0) return err;
  return launch_gemm<32, 64, 16, 2, 4, MergeOutProj>(p, B * L, h, M, s);
}
