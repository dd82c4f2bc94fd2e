// The inner part of a Mamba-1 mixer, shared by kernel C (fused_mixer_fwd.cu,
// the whole mixer) and kernel H (fused_mamba_fwd.cu, the inner part alone):
// on projected rows xz = [u | z] (2d wide), per stream
//
//     u   = silu(causal_conv_K(xz[:, :d]) + conv_b)           (zero left pad)
//     xdb = u . W_x^T  -> dt_r (r), B (n), C (n)
//     dt  = softplus(dt_r . W_dt^T + dt_b)
//     h_t = exp(dt A) h_{t-1} + dt u B_t;  y = <C_t, h_t> + D u
//     y   = y * silu(xz[:, d:])
//
// in two device kernels that launch_inner starts:
// 1. conv + x_proj: gemm_nt.cuh's GEMM, whose A-tile loader gathers the 4
//    conv taps of each stream step from xz, adds the bias, applies SiLU, and
//    stores u for the scan. 16-row tiles, to spread few rows over many blocks.
// 2. the scan: one thread per (branch, sequence, channel) with its 16 states
//    and its row of A in registers, in blocks of 32 channels. Each block
//    stages 64 steps of dt_r, B, C and the row index in shared memory. The
//    channel's 32 dt_proj weights live in registers, so dt_proj and softplus
//    run inside the recurrence; its dot product and C . h run as 4 partial
//    sums each, to shorten the step's dependent chain. z is read straight
//    out of xz, one step ahead like u.
//
// A stream's steps are rows of xz: step t of stream s of batch element b is
// row fwd[s, t] of that element's L rows (kernel C: in_proj ran in token
// order and the gather is an index), or, without a table, row t itself
// (kernel H: the caller gathered). A stream has Ls steps; Ls = L when every
// stream visits every token, Ls = L / S when the streams partition them. The
// conv's zero pad and the scan's zero state start at each stream's first
// step. y goes out at the step's row index: per stream ((b * S + s) * L +
// row) when `y_streams` is S, or (b * L + row) when it is 1 (a partition,
// where each token lies in one stream; one stream; or kernel H, whose rows
// are its steps).
//
// Everything is fp32 FMA on the CUDA cores, no TF32.

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

#include "gemm_nt.cuh"

namespace mixer {

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

// The inner weights of one mixer.
struct Weights {
  const float* conv_w;  // (d, K)
  const float* conv_b;  // (d,)
  const float* xp_w;    // (r + 2n, d)
  const float* dt_w;    // (d, r)
  const float* dt_b;    // (d,)
  const float* A;       // (d, n): A itself, or log(-A) when a_is_log
  const float* D;       // (d,)
};

struct Inner {
  Weights w[2];
  const int64_t* fwd;  // (S, Ls) row of each stream step, or null: step t is row t
  const float* xz;     // (M, B * L, 2d)
  float* u;            // (M, B * S * Ls, d), stream order
  float* xdb;          // (M, B * S * Ls, r + 2n), stream order
  float* y;            // (M, B * y_streams * L, d), by row index (see above)
  int B, L, Ls, d, r, S, y_streams;
  bool a_is_log;
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
  int rows, cols, depth, L, Ls, S;
  bool store_u;
  __device__ ConvXProj(const Inner& p, int m)
      : xz(p.xz + static_cast<size_t>(m) * p.B * p.L * 2 * p.d),
        conv_w(p.w[m].conv_w),
        conv_b(p.w[m].conv_b),
        fwd(p.fwd),
        u(p.u + static_cast<size_t>(m) * p.B * p.S * p.Ls * p.d),
        w(p.w[m].xp_w),
        c(p.xdb + static_cast<size_t>(m) * p.B * p.S * p.Ls * (p.r + 2 * kN)),
        rows(p.B * p.S * p.Ls),
        cols(p.r + 2 * kN),
        depth(p.d),
        L(p.L),
        Ls(p.Ls),
        S(p.S),
        store_u(blockIdx.y == 0) {}  // the first column tile writes u once
  __device__ Row row(int i) const {  // i = (b * S + s) * Ls + t
    const int t = i % Ls, bs = i / Ls;
    const int64_t* order = fwd ? fwd + static_cast<size_t>(bs % S) * Ls : nullptr;
    const float* xz_b = xz + static_cast<size_t>(bs / S) * L * 2 * depth;
    Row r;
#pragma unroll
    for (int k = 0; k < kConv; ++k) {
      const int tt = t - (kConv - 1) + k;
      const int64_t at = max(tt, 0);
      r.tap[k] = xz_b + (order ? order[at] : at) * 2 * depth;
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
// grid (ceil(d / 32), B * S, M); one thread per channel.
static __global__ void __launch_bounds__(kScanThreads) scan_kernel(const Inner p) {
  __shared__ float sDt[kScanChunk][kMaxRank];
  __shared__ float sB[kScanChunk][kN];
  __shared__ float sC[kScanChunk][kN];
  __shared__ int64_t sTok[kScanChunk];

  const int m = blockIdx.z;
  const int bs = blockIdx.y;  // b * S + s
  const int s = bs % p.S;
  const int b = bs / p.S;
  const int c = blockIdx.x * kScanThreads + threadIdx.x;
  const int d = p.d, L = p.L, Ls = p.Ls, r = p.r, r2n = p.r + 2 * kN;
  const bool active = c < d;
  const float* A = p.w[m].A;
  const float* dt_w = p.w[m].dt_w;

  float a[kN], h[kN], wdt[kMaxRank];
#pragma unroll
  for (int k = 0; k < kN; ++k) {
    const float av = active ? A[static_cast<size_t>(c) * kN + k] : 0.0f;
    a[k] = p.a_is_log ? (active ? -expf(av) : 0.0f) : av;
    h[k] = 0.0f;
  }
#pragma unroll
  for (int j = 0; j < kMaxRank; ++j) {
    wdt[j] = (active && j < r) ? dt_w[static_cast<size_t>(c) * r + j] : 0.0f;
  }
  const float dtb = active ? p.w[m].dt_b[c] : 0.0f;
  const float Dc = active ? p.w[m].D[c] : 0.0f;

  // Row of (m, b, s, t = 0) in u and xdb; row 0 of this sequence's y.
  const size_t row0 = (static_cast<size_t>(m) * p.B * p.S + bs) * Ls;
  const size_t yrow0 =
      (p.y_streams == 1 ? static_cast<size_t>(m) * p.B + b
                        : static_cast<size_t>(m) * p.B * p.S + bs) * L;
  const float* xz_b = p.xz + (static_cast<size_t>(m) * p.B + b) * L * 2 * d;
  const int64_t* order = p.fwd ? p.fwd + static_cast<size_t>(s) * Ls : nullptr;

  for (int t0 = 0; t0 < Ls; t0 += kScanChunk) {
    const int steps = min(kScanChunk, Ls - t0);
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
    for (int i = threadIdx.x; i < steps; i += kScanThreads) {
      sTok[i] = order ? order[t0 + i] : t0 + i;
    }
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
      p.y[(yrow0 + sTok[t]) * d + c] = yv * silu(zv);  // at the step's row index
    }
  }
}

// Launch the two kernels for M branches on `stream`; returns the first
// launch's cudaError_t that is not 0.
inline int launch_inner(const Inner& p, int M, cudaStream_t stream) {
  int err = launch_gemm<16, 64, 16, 1, 4, ConvXProj>(p, p.B * p.S * p.Ls, p.r + 2 * kN, M, stream);
  if (err != 0) return err;
  const dim3 scan_grid((p.d + kScanThreads - 1) / kScanThreads, p.B * p.S, M);
  scan_kernel<<<scan_grid, kScanThreads, 0, stream>>>(p);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace mixer
