// The Mamba-1 mixer's inner part for Hopper (sm_90a), on streams that arrive
// gathered and projected: causal conv + SiLU, x_proj, dt_proj, softplus, the
// selective scan, the D skip and the silu(z) gate, in one call.
//
// Replaces the TPU kernel diffma_tpu/ops/fused_mamba.py::_fused_kernel, as
// its launcher _fused_fwd_impl drives it. Per sequence g, with xz (L, 2d) =
// [u0 | z], d = d_inner, n = d_state = 16, r = dt_rank <= 32, K = 4 taps:
//
//     u   = silu(causal_conv_K(u0) + conv_b)                (zero left pad)
//     xdb = u . W_x^T  -> dt_r (r), B (n), C (n)
//     dt  = softplus(dt_r . W_dt^T + dt_b)
//     h_t = exp(dt A) h_{t-1} + dt u B_t;  y = <C_t, h_t> + D u
//     out = y * silu(z)                                      (L, d)
//
// A is given itself (negative), not as its logarithm. Everything is fp32 on
// the CUDA cores (no TF32). The two products are the kernel's own: x_proj is
// gemm_nt.cuh's GEMM, dt_proj runs inside the recurrence.
//
// Bound on an H100 SXM (67 TFLOP/s fp32 outside the tensor cores, 3.35 TB/s).
// At the shapes of three DiffMa-B/2 streams (G = 3, L = 196, d = 1024,
// r = 32) the call does 0.18 GFLOP (x_proj 77 M, dt_proj 39 M, the scan 63 M,
// the conv 5 M), 2.7 us at the fp32 rate, against 7.7 MB that must move (xz
// 4.8 MB, out 2.4 MB, the weights 0.5 MB), 2.3 us: the two bounds lie close,
// operations first. The scan's chain of L dependent steps takes far longer
// than either at this size (kernel A, the same recurrence, takes 0.12 ms).
//
// Design, simple and right first: two device kernels, with u and xdb in a
// workspace the caller allocates (mamba_inner_workspace_floats), 2.5 MB at
// G = 3, which stays in L2. Step t of sequence g is row g * L + t of xz.
// 1. conv + x_proj: gemm_nt.cuh's GEMM, whose A-tile loader reads the 4 conv
//    taps of each step from xz, adds the bias, applies SiLU, and stores u for
//    the scan. 16-row tiles, to spread few rows over many blocks.
// 2. the scan: one thread per (sequence, channel) with its 16 states and its
//    row of A in registers, in blocks of 32 channels. Each block stages 64
//    steps of dt_r, B and C in shared memory. The channel's 32 dt_proj
//    weights live in registers, so dt_proj and softplus run inside the
//    recurrence; its dot product and C . h run as 4 partial sums each, to
//    shorten the step's dependent chain. u and z are read one step ahead.
// The TPU kernel's 16-step chunks, its VMEM scratch and its zero padding of L
// to a multiple of 16 exist for VMEM; here L is masked and nothing is padded.
//
// It has no backward kernel, in either package: the gradient recomputes the
// function through the composable operators (the scan kernels A and B).

#include <cuda_runtime.h>
#include <stdint.h>

#include "gemm_nt.cuh"

namespace {

constexpr int kN = 16;        // d_state
constexpr int kConv = 4;      // conv taps
constexpr int kMaxRank = 32;  // dt_rank
constexpr int kScanThreads = 32;
constexpr int kScanChunk = 64;
constexpr int kSums = 4;  // partial sums per dot product in the scan
static_assert(kSums == 4, "the scan adds its partial sums as two pairs");

__device__ __forceinline__ float silu(float x) { return x / (1.0f + expf(-x)); }

// softplus(x) = log(1 + exp(x)) without overflow: max(x, 0) + log1p(exp(-|x|)).
__device__ __forceinline__ float softplus(float x) {
  return fmaxf(x, 0.0f) + log1pf(expf(-fabsf(x)));
}

struct Params {
  const float* conv_w;  // (d, K)
  const float* conv_b;  // (d,)
  const float* xp_w;    // (r + 2n, d)
  const float* dt_w;    // (d, r)
  const float* dt_b;    // (d,)
  const float* A;       // (d, n)
  const float* D;       // (d,)
  const float* xz;      // (G * L, 2d)
  float* u;             // (G * L, d)
  float* xdb;           // (G * L, r + 2n)
  float* y;             // (G * L, d)
  int G, L, d, r;
};

struct ConvXProj {  // u = silu(conv(xz[:, :d])); xdb = u . W_x^T
  struct Row {
    const float* tap[kConv];  // xz row of each tap; in the left pad, the step's first row
    float live[kConv];        // 1 for a tap inside the sequence, 0 in the pad
    float* u;
  };
  const float* xz;
  const float* conv_w;
  const float* conv_b;
  float* u;
  const float* w;
  float* c;
  int rows, cols, depth, L;
  bool store_u;
  __device__ ConvXProj(const Params& p, int)
      : xz(p.xz),
        conv_w(p.conv_w),
        conv_b(p.conv_b),
        u(p.u),
        w(p.xp_w),
        c(p.xdb),
        rows(p.G * p.L),
        cols(p.r + 2 * kN),
        depth(p.d),
        L(p.L),
        store_u(blockIdx.y == 0) {}  // the first column tile writes u once
  __device__ Row row(int i) const {  // i = g * L + t
    const int t = i % L;
    const float* xz_g = xz + static_cast<size_t>(i / L) * L * 2 * depth;
    Row r;
#pragma unroll
    for (int k = 0; k < kConv; ++k) {
      const int tt = t - (kConv - 1) + k;
      r.tap[k] = xz_g + static_cast<size_t>(max(tt, 0)) * 2 * depth;
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

// The selective scan with dt_proj, softplus, the D skip and the gate fused.
// grid (ceil(d / 32), G); one thread per channel.
__global__ void __launch_bounds__(kScanThreads) scan_kernel(const Params p) {
  __shared__ float sDt[kScanChunk][kMaxRank];
  __shared__ float sB[kScanChunk][kN];
  __shared__ float sC[kScanChunk][kN];

  const int g = blockIdx.y;
  const int c = blockIdx.x * kScanThreads + threadIdx.x;
  const int d = p.d, L = p.L, r = p.r, r2n = p.r + 2 * kN;
  const bool active = c < d;

  float a[kN], h[kN], wdt[kMaxRank];
#pragma unroll
  for (int k = 0; k < kN; ++k) {
    a[k] = active ? p.A[static_cast<size_t>(c) * kN + k] : 0.0f;
    h[k] = 0.0f;
  }
#pragma unroll
  for (int j = 0; j < kMaxRank; ++j) {
    wdt[j] = (active && j < r) ? p.dt_w[static_cast<size_t>(c) * r + j] : 0.0f;
  }
  const float dtb = active ? p.dt_b[c] : 0.0f;
  const float Dc = active ? p.D[c] : 0.0f;

  const size_t row0 = static_cast<size_t>(g) * L;  // row of (g, t = 0) in xz, u, xdb and y
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
    __syncthreads();
    if (!active) continue;
    const float* u_t = p.u + (row0 + t0) * d + c;
    const float* z_t = p.xz + (row0 + t0) * 2 * d + d + c;
    float u_next = u_t[0];
    float z_next = z_t[0];
    for (int t = 0; t < steps; ++t) {
      const float uv = u_next, zv = z_next;
      if (t + 1 < steps) {  // the next step's loads fly during this step
        u_next = u_t[static_cast<size_t>(t + 1) * d];
        z_next = z_t[static_cast<size_t>(t + 1) * 2 * d];
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
      p.y[(row0 + t0 + t) * d + c] = yv * silu(zv);
    }
  }
}

}  // namespace

// Floats of workspace that mamba_inner_fwd needs for these shapes.
extern "C" long long mamba_inner_workspace_floats(int G, int L, int d, int r) {
  return static_cast<long long>(G) * L * (d + r + 2 * kN);
}

// All pointers fp32 and contiguous: xz (G, L, 2d), conv_w (d, K), conv_b (d,),
// xp_w (r + 2n, d), dt_w (d, r), dt_b (d,), A (d, n), D (d,), out (G, L, d).
// Launches two kernels on `stream`; returns the first launch's cudaError_t
// that is not 0, or -1 for shapes that are not built.
extern "C" int mamba_inner_fwd(const void* xz, const void* conv_w, const void* conv_b,
                               const void* xp_w, const void* dt_w, const void* dt_b,
                               const void* A, const void* D, void* out, void* workspace,
                               int G, int L, int d, int n, int r, int K, void* stream) {
  if (n != kN || K != kConv || r < 1 || r > kMaxRank || G < 1 || L < 1 || d < 1) return -1;
  Params p{};
  p.conv_w = static_cast<const float*>(conv_w);
  p.conv_b = static_cast<const float*>(conv_b);
  p.xp_w = static_cast<const float*>(xp_w);
  p.dt_w = static_cast<const float*>(dt_w);
  p.dt_b = static_cast<const float*>(dt_b);
  p.A = static_cast<const float*>(A);
  p.D = static_cast<const float*>(D);
  p.xz = static_cast<const float*>(xz);
  p.u = static_cast<float*>(workspace);
  p.xdb = p.u + static_cast<size_t>(G) * L * d;
  p.y = static_cast<float*>(out);
  p.G = G;
  p.L = L;
  p.d = d;
  p.r = r;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  int err = launch_gemm<16, 64, 16, 1, 4, ConvXProj>(p, G * L, r + 2 * kN, 1, st);
  if (err != 0) return err;
  scan_kernel<<<dim3((d + kScanThreads - 1) / kScanThreads, G), kScanThreads, 0, st>>>(p);
  return static_cast<int>(cudaGetLastError());
}
