// Kernel P for Hopper (sm_90a): the SSD core of the split SSD probe, on
// gathered streams, with its gated RMSNorm.
//
// Replaces the TPU kernel tools/probes/probe_split_ssd.py::_core_kernel, the
// core of the probe's "split" form of the dual Mamba-2 mixer, in which
// in_proj, the stream gathers, the merge and out_proj run outside the kernel.
// Given zx (G, L, dproj), dproj = 2d + 2n + H with columns [z | x | B | C |
// dt], one gathered stream per sequence g in stream order, and each branch's
// core weights (branch m = g / (G / M)), it writes per sequence
//
//     [xs | Bs | Cs] = silu(causal_conv_K([x | B | C] columns) + conv_b)
//     dt   = clip(softplus(dt column of each head + dt_bias), lo, hi)
//     y[t, head, :] = sum_{u <= t} (Cs_t . Bs_u) exp(cs_t - cs_u) dt_u xs[u, head, :]
//                     + D[head] xs[t, head, :],  cs = cumsum of dt * A
//     out[g, t] = rmsnorm(y[t] silu(z[t])) * norm_w     (over all d channels)
//
// with no merge, (G, L, d). Nothing is padded: the TPU probe pads each stream
// after its last step, and the conv is causal, so its first L rows are the
// answer.
//
// Arithmetic: the rules of ssd_core.cuh, which kernels E and F follow. Each
// exponent is a sum of dt * A taken in fp64, rounded once, never positive; the
// causal mask is a selection (u <= t), never a product; the state entering a
// chunk is summed directly over the earlier chunks' states in chunk order,
// the offsets carried in fp64 (ssd::fold_states). fp32 on the CUDA cores.
//
// Bound on an H100 SXM at the probe's shapes (G = 48, L = 196, d = 1024, H =
// 16): the chunked SSD's products make about 1.1 GFLOP, 0.007 ms at the 3xTF32
// rate, and the rest (the conv, the decays, the D skip, the gate and the
// norm) 0.18 GFLOP, 0.003 ms at fp32, against 118 MB of zx read and out
// written, 0.035 ms at the memory rate. So the bytes bound it.
//
// Design. The earlier form of P (kernel E's SSD stage, then a row kernel)
// staged each chunk once per head, computing the B/C conv 16 times a chunk,
// and wrote y to device memory for the norm to read back. Here:
// * Chunks balanced to the stream: nc = ceil(L / 64) chunks of Qc = ceil(L /
//   nc) steps rounded up to 4 (196 steps: 52, 52, 52, 40, not 64, 64, 64, 4).
// * One thread-block cluster per (sequence, chunk); each of its H / 2 blocks
//   (8 at H = 16) owns two heads, 128 channels. Each block computes
//   the conv + SiLU of its share of the chunk's B and C rows (rank r: rows
//   r Qc / 8 ..) once; every block reads them all through distributed shared
//   memory. dt and its fp64 cumsum are computed once per head, by the block
//   that owns it.
// * Two kernels: core_states_kernel writes each chunk's end state per head
//   (chunks 0 .. nc - 2; none for a stream of one chunk), then
//   core_out_norm_kernel folds the earlier states into the state entering its
//   chunk, forms y for its heads, and finishes the gated RMSNorm in the
//   cluster: each block writes its rows' partial sums of squares (its 128
//   channels) to its shared memory, and after cluster.sync() every block
//   reads all of them in rank order (the same bits every call), scales, and
//   writes out. y never reaches device memory. A last cluster.sync() keeps
//   every block alive until the others have read its shared memory.
// * All of a block's loads of zx are issued before its first conv; 68 KB of
//   shared memory and at most 85 registers a thread, so three blocks an SM.
//   The products run on the CUDA cores, a 4 x 4 tile a thread with both
//   operands k-major in shared memory (one float4 each a step). At the
//   probe's shapes the kernel stays 7x its byte bound; PERF.md records what
//   was timed and what did not move it.
// Both kernels launch with cudaLaunchKernelEx and a cluster dimension; the
// grid's x, H / 2 per chunk, is a multiple of it.
//
// bf16 (dtype 1: zx and out bf16, the weights fp32), the TPU kernel at a zx
// of bfloat16: it rounds where kernel E's bf16 variant rounds (ssd_core.cuh):
// inside each chunk the masked decay (Cs_t . Bs_u) exp(lcs[t] - lcs[u]) and
// dt_u xs_u are rounded to bf16 (to nearest even) at the heads' product,
// which sums in fp32; the conv, dt, the cumsums, the states, the cross-chunk
// term, the D skip, the gate and the norm stay fp32, and out is rounded to
// bf16 once. The TPU kernel's one quadratic block per stream rounds its
// cross-chunk terms too; here they go through the fp32 states. Bound at the
// probe's shapes: 59 MB of zx read and out written, 0.018 ms at the memory
// rate, the products at 989 TFLOP/s.

#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

#include "ssd_core.cuh"

namespace cg = cooperative_groups;

namespace {

using ssd::kConv;
using ssd::kHd;
using ssd::kN;
using ssd::kQ;
using ssd::kState;
using ssd::kThreads;
using ssd::round_bf16;
using ssd::silu;
using ssd::softplus;
using bf16 = __nv_bfloat16;

constexpr int kHeads = 2;          // heads a block owns
constexpr int kCh = kHeads * kHd;  // its x channels, X's row stride
constexpr int kMaxCluster = 8;     // blocks a cluster: H <= 16 (a portable cluster)
constexpr int kBC = 2 * kN;        // the B and C conv channels
constexpr int kRowGroups = kThreads / (kCh / 4);  // the x conv: 8 groups of 8 rows
constexpr int kGroupRows = kQ / kRowGroups;
static_assert(kConv == 4, "the conv's taps are one float4 a channel");

struct Args {
  const float* conv_w[2];  // (d + 2n, K)
  const float* conv_b[2];  // (d + 2n,)
  const float* dt_bias[2];
  const float* A_log[2];
  const float* D[2];
  const float* norm_w[2];  // (d,)
  const void* zx;          // (G, L, dproj), fp32 or bf16
  void* out;               // (G, L, d), zx's dtype
  float* states;           // (G, H, nc, 16, 64): each chunk's end state, chunks 0 .. nc - 2
  double* sums;            // (G, H, nc): each chunk's sum of dt * A
  int G, per, L, d, H, dproj, nc, Qc, csize, rpr;  // rpr: B/C rows a rank convolves
  float eps, dt_lo, dt_hi;
};

// A block's staged chunk, in dynamic shared memory (16-byte aligned).
struct Stage {
  double* lcs;  // (kHeads, kQ): inclusive cumsum of dt * A from the chunk's
                // first step; rows past q hold sum(c)
  float* dts;   // (kHeads, kQ)
  float* X;     // (kQ, kCh): xs of the block's heads, zeros past q
  float* BsT;   // (kN, kQ): Bs transposed, zeros past q
  float* CsT;   // (kN, kQ)
  float* bc;    // (rpr, kBC): this rank's share of the conv'd B | C rows
  float* rest;  // what the kernels lay out after it
};

__host__ __device__ constexpr int stage_floats(int rpr) {
  return 2 * kHeads * kQ + kHeads * kQ + kQ * kCh + 2 * kN * kQ + rpr * kBC;
}
constexpr int kStatesExtra = kHeads * kQ * kN;            // B scaled per head
constexpr int kOutExtra = kQ * kQ + kHeads * kState + kQ;  // M, h_in per head, row partials

__device__ __forceinline__ Stage stage_layout(float* smem, int rpr) {
  Stage s;
  s.lcs = reinterpret_cast<double*>(smem);
  s.dts = smem + 2 * kHeads * kQ;
  s.X = s.dts + kHeads * kQ;
  s.BsT = s.X + kQ * kCh;
  s.CsT = s.BsT + kN * kQ;
  s.bc = s.CsT + kN * kQ;
  s.rest = s.bc + rpr * kBC;
  return s;
}

__device__ __forceinline__ float4 ld4(const float* p) { return *reinterpret_cast<const float4*>(p); }
__device__ __forceinline__ float4 ld4(const bf16* p) {
  const uint2 v = *reinterpret_cast<const uint2*>(p);
  const __nv_bfloat162 lo = *reinterpret_cast<const __nv_bfloat162*>(&v.x);
  const __nv_bfloat162 hi = *reinterpret_cast<const __nv_bfloat162*>(&v.y);
  return make_float4(__low2float(lo), __high2float(lo), __low2float(hi), __high2float(hi));
}
__device__ __forceinline__ float ld1(const float* p) { return *p; }
__device__ __forceinline__ float ld1(const bf16* p) { return __bfloat162float(*p); }
__device__ __forceinline__ void st4(float* p, const float4 v) { *reinterpret_cast<float4*>(p) = v; }
__device__ __forceinline__ void st4(bf16* p, const float4 v) {
  const __nv_bfloat162 lo = __floats2bfloat162_rn(v.x, v.y), hi = __floats2bfloat162_rn(v.z, v.w);
  *reinterpret_cast<uint2*>(p) =
      make_uint2(*reinterpret_cast<const uint32_t*>(&lo), *reinterpret_cast<const uint32_t*>(&hi));
}

// conv + SiLU of four channels at one step: bias + w.x raw[0] + ... + w.w raw[3],
// raw[0] the earliest step.
__device__ __forceinline__ float4 conv4(const float4 (&w)[4], const float4 b, const float4& r0,
                                        const float4& r1, const float4& r2, const float4& r3) {
  float4 o;
  float* po = &o.x;
  const float* pb = &b.x;
  const float* p0 = &r0.x;
  const float* p1 = &r1.x;
  const float* p2 = &r2.x;
  const float* p3 = &r3.x;
#pragma unroll
  for (int e = 0; e < 4; ++e) {
    float acc = pb[e];
    acc = fmaf(w[e].x, p0[e], acc);
    acc = fmaf(w[e].y, p1[e], acc);
    acc = fmaf(w[e].z, p2[e], acc);
    acc = fmaf(w[e].w, p3[e], acc);
    po[e] = silu(acc);
  }
  return o;
}

template <class T>
struct Where {
  int g, m, c, rank, head0, t0, q;
  const T* zx_g;  // sequence g's rows (L, dproj)
};

template <class T>
__device__ __forceinline__ Where<T> where(const Args& a) {
  Where<T> w;
  w.rank = static_cast<int>(cg::this_cluster().block_rank());
  w.c = blockIdx.x / a.csize;
  w.g = blockIdx.y;
  w.m = w.g / a.per;
  w.head0 = kHeads * w.rank;
  w.t0 = w.c * a.Qc;
  w.q = min(a.Qc, a.L - w.t0);
  w.zx_g = static_cast<const T*>(a.zx) + static_cast<size_t>(w.g) * a.L * a.dproj;
  return w;
}

// Stage the chunk: the block's x conv, its share of the B | C conv, its heads'
// dt and lcs; then, across the cluster, every rank's B | C rows into BsT and
// CsT. All threads of all the cluster's blocks call it; it ends with the block
// synchronised and the cluster's shares read (each block must reach a later
// cluster.sync() before it exits).
template <class T>
__device__ void stage_chunk(const Args& a, const Where<T>& w, const Stage& s,
                            cg::cluster_group& cl) {
  const int tid = threadIdx.x, d = a.d;
  const float* conv_w = a.conv_w[w.m];
  const float* conv_b = a.conv_b[w.m];
  const float4 zero4 = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
  // Every load of zx first, so that the block waits for memory once.
  // x: thread (c4, rg) takes channels 4 c4 .. 4 c4 + 3 over rows 8 rg .. 8 rg
  // + 7, from the 11 steps 8 rg - 3 .. 8 rg + 7 (before the stream's start,
  // and past the chunk's end, zero).
  const int c4 = tid % (kCh / 4), rg = tid / (kCh / 4);
  const int ch = w.head0 * kHd + 4 * c4;  // conv channel
  float4 raw[kGroupRows + kConv - 1];
#pragma unroll
  for (int k = 0; k < kGroupRows + kConv - 1; ++k) {
    const int r = kGroupRows * rg - (kConv - 1) + k;  // chunk row
    const int t = w.t0 + r;
    raw[k] = r < w.q && t >= 0 ? ld4(w.zx_g + static_cast<size_t>(t) * a.dproj + d + ch) : zero4;
  }
  // This rank's B | C rows, rank r Qc / csize .. (r + 1) Qc / csize - 1: thread
  // i < rpr * 8 takes row r0 + i / 8, channels 4 (i % 8) ..
  const int r0 = w.rank * a.rpr, bc_row = r0 + tid / (kBC / 4), bc4 = tid % (kBC / 4);
  const bool bc_live = tid < a.rpr * (kBC / 4);
  const int bc_ch = d + 4 * bc4;
  float4 bc_raw[kConv];
#pragma unroll
  for (int k = 0; k < kConv; ++k) {
    const int t = w.t0 + bc_row - (kConv - 1) + k;
    bc_raw[k] = bc_live && bc_row < w.q && t >= 0
                    ? ld4(w.zx_g + static_cast<size_t>(t) * a.dproj + d + bc_ch) : zero4;
  }
  // dt of the block's heads: thread hh kQ + r.
  const int dt_hh = tid / kQ, dt_r = tid % kQ;
  const bool dt_live = tid < kHeads * kQ && dt_r < w.q;
  const float dt_raw = dt_live
      ? ld1(w.zx_g + static_cast<size_t>(w.t0 + dt_r) * a.dproj + 2 * d + kBC + w.head0 + dt_hh)
      : 0.0f;

  float4 wk[4];
#pragma unroll
  for (int e = 0; e < 4; ++e) wk[e] = ld4(conv_w + static_cast<size_t>(ch + e) * kConv);
  const float4 bk = ld4(conv_b + ch);
#pragma unroll
  for (int i = 0; i < kGroupRows; ++i) {
    const int r = kGroupRows * rg + i;
    const float4 v = r < w.q ? conv4(wk, bk, raw[i], raw[i + 1], raw[i + 2], raw[i + 3]) : zero4;
    *reinterpret_cast<float4*>(s.X + r * kCh + 4 * c4) = v;
  }
  if (bc_live) {
    float4 v = zero4;
    if (bc_row < w.q) {
#pragma unroll
      for (int e = 0; e < 4; ++e) wk[e] = ld4(conv_w + static_cast<size_t>(bc_ch + e) * kConv);
      v = conv4(wk, ld4(conv_b + bc_ch), bc_raw[0], bc_raw[1], bc_raw[2], bc_raw[3]);
    }
    *reinterpret_cast<float4*>(s.bc + (tid / (kBC / 4)) * kBC + 4 * bc4) = v;
  }
  if (tid < kHeads * kQ) {
    s.dts[tid] = dt_live ? fminf(fmaxf(softplus(dt_raw + a.dt_bias[w.m][w.head0 + dt_hh]), a.dt_lo),
                                 a.dt_hi)
                         : 0.0f;
  }
  cl.sync();  // every rank's B | C rows written; the block's X and dts too
  // lcs, by warp hh for head hh, in fp64 32 steps at a time (the rows past q
  // add 0 and so hold sum(c)); the others gather B and C from the ranks.
  const int warp = tid / 32, lane = tid % 32;
  if (warp < kHeads) {
    const float A = -expf(a.A_log[w.m][w.head0 + warp]);
    double carry = 0.0;
    for (int r = 0; r < kQ; r += 32) {
      double c = static_cast<double>(s.dts[warp * kQ + r + lane] * A);
#pragma unroll
      for (int o = 1; o < 32; o <<= 1) {
        const double up = __shfl_up_sync(0xffffffffu, c, o);
        if (lane >= o) c += up;
      }
      c += carry;
      s.lcs[warp * kQ + r + lane] = c;
      carry = __shfl_sync(0xffffffffu, c, 31);
    }
  }
  for (int i = tid; i < kQ * (kBC / 4); i += kThreads) {
    const int r = i % kQ, q4 = i / kQ;
    float4 v = zero4;
    if (r < w.q) {
      const float* src = cl.map_shared_rank(s.bc, r / a.rpr);
      v = ld4(src + (r % a.rpr) * kBC + 4 * q4);
    }
    float* dst = (q4 < kN / 4 ? s.BsT + 4 * q4 * kQ : s.CsT + (4 * q4 - kN) * kQ) + r;
    dst[0] = v.x;
    dst[kQ] = v.y;
    dst[2 * kQ] = v.z;
    dst[3 * kQ] = v.w;
  }
  __syncthreads();
}

// acc[i][j] += sum_{k0 <= k < k1} A[k lda + 4 ty + i] B[k ldb + 4 tx + j] over the
// block's 16 x 16 threads (tx = thread % 16, ty = thread / 16): both operands
// k-major in shared memory, each thread's four rows and four columns one
// float4 apiece (a warp's two ty read two float4s of A, its 16 tx 256
// contiguous bytes of B). kXdt: each element of B's row k is scaled by
// dts[k] and rounded to bf16 as it is read (the bf16 product's dt_u xs_u).
template <bool kXdt = false>
__device__ __forceinline__ void mm4(float (&acc)[4][4], const float* A, int lda, const float* B,
                                    int ldb, int k0, int k1, const float* dts = nullptr) {
  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;
#pragma unroll 4
  for (int k = k0; k < k1; ++k) {
    const float4 a = ld4(A + k * lda + 4 * ty);
    float4 b = ld4(B + k * ldb + 4 * tx);
    if constexpr (kXdt) {
      const float s = dts[k];
      b = make_float4(round_bf16(b.x * s), round_bf16(b.y * s), round_bf16(b.z * s),
                      round_bf16(b.w * s));
    }
    const float av[4] = {a.x, a.y, a.z, a.w}, bv[4] = {b.x, b.y, b.z, b.w};
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(av[i], bv[j], acc[i][j]);
  }
}

// The state entering chunk c of both the block's heads, as ssd::fold_states
// sums it: over c' = c - 1 down to 0, exp(sum(c' + 1) + ... + sum(c - 1))
// st[c'], the offset in fp64; each thread four consecutive of a head's 1024
// elements, into out (kHeads, 16, 64). The next chunk's states are loaded
// before the current ones are added.
template <class T>
__device__ __forceinline__ void fold_heads(const Args& a, const Where<T>& w, float* out) {
  const size_t unit = static_cast<size_t>(w.g) * a.H + w.head0;
  const float* st[kHeads];
  const double* sums[kHeads];
  float4 acc[kHeads], v[kHeads];
#pragma unroll
  for (int hh = 0; hh < kHeads; ++hh) {
    st[hh] = a.states + (unit + hh) * a.nc * kState + 4 * threadIdx.x;
    sums[hh] = a.sums + (unit + hh) * a.nc;
    acc[hh] = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
    v[hh] = ld4(st[hh] + static_cast<size_t>(w.c - 1) * kState);
  }
  double off[kHeads] = {};
  for (int cp = w.c - 1; cp >= 0; --cp) {
    float4 next[kHeads];
#pragma unroll
    for (int hh = 0; hh < kHeads; ++hh) {
      next[hh] = cp > 0 ? ld4(st[hh] + static_cast<size_t>(cp - 1) * kState) : v[hh];
      if (cp + 1 != w.c) off[hh] += sums[hh][cp + 1];
      const float f = expf(static_cast<float>(off[hh]));
      acc[hh] = make_float4(fmaf(f, v[hh].x, acc[hh].x), fmaf(f, v[hh].y, acc[hh].y),
                            fmaf(f, v[hh].z, acc[hh].z), fmaf(f, v[hh].w, acc[hh].w));
      v[hh] = next[hh];
    }
  }
#pragma unroll
  for (int hh = 0; hh < kHeads; ++hh) {
    *reinterpret_cast<float4*>(out + hh * kState + 4 * threadIdx.x) = acc[hh];
  }
}

// Each chunk's end state per head, chunks 0 .. nc - 2: h_c[k, j] = sum_u
// (w_u Bs[u, k]) xs[u, j], w_u = exp(sum(c) - lcs[u]) dt_u, and sum(c). Thread
// (tx, ty) takes state row k = ty and channels 8 tx .. 8 tx + 7 of the block's
// 128 (head tx / 8).
template <class T>
__global__ void __launch_bounds__(kThreads, 3) core_states_kernel(const Args a) {
  extern __shared__ float4 smem4[];
  cg::cluster_group cl = cg::this_cluster();
  const Where<T> w = where<T>(a);
  const Stage s = stage_layout(reinterpret_cast<float*>(smem4), a.rpr);
  float* Bw = s.rest;  // (kHeads, kQ, kN): w_u Bs[u, k] per head
  stage_chunk(a, w, s, cl);
  for (int i = threadIdx.x; i < kHeads * kQ * kN; i += kThreads) {
    const int hh = i / (kQ * kN), u = (i / kN) % kQ, k = i % kN;
    const double* lcs = s.lcs + hh * kQ;
    Bw[i] = s.BsT[k * kQ + u] * expf(static_cast<float>(lcs[kQ - 1] - lcs[u])) * s.dts[hh * kQ + u];
  }
  __syncthreads();
  const int tx = threadIdx.x % 16, k = threadIdx.x / 16, hh = tx / 8;
  const float* bw = Bw + hh * kQ * kN + k;
  float acc[8] = {};
  for (int u = 0; u < w.q; ++u) {
    const float b = bw[u * kN];
    const float4 x0 = ld4(s.X + u * kCh + 8 * tx), x1 = ld4(s.X + u * kCh + 8 * tx + 4);
    const float xv[8] = {x0.x, x0.y, x0.z, x0.w, x1.x, x1.y, x1.z, x1.w};
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[j] = fmaf(b, xv[j], acc[j]);
  }
  const size_t unit = static_cast<size_t>(w.g) * a.H + w.head0 + hh;
  float* st = a.states + (unit * a.nc + w.c) * kState + k * kHd + 8 * tx - hh * kHd;
  *reinterpret_cast<float4*>(st) = make_float4(acc[0], acc[1], acc[2], acc[3]);
  *reinterpret_cast<float4*>(st + 4) = make_float4(acc[4], acc[5], acc[6], acc[7]);
  if (threadIdx.x < kHeads) {
    a.sums[(unit - hh + threadIdx.x) * a.nc + w.c] = s.lcs[threadIdx.x * kQ + kQ - 1];
  }
  cl.sync();  // no block leaves while another may still read its B | C rows
}

// y of the chunk for the block's heads, gated, and the RMSNorm over all d
// channels across the cluster; out written in place of y. Thread (tx, ty)
// takes steps 4 ty .. 4 ty + 3 and channels 4 tx .. 4 tx + 3 of each head.
// At bf16 (T) the chunk's product takes M and dt_u xs_u rounded to bf16.
template <class T>
__global__ void __launch_bounds__(kThreads, 3) core_out_norm_kernel(const Args a) {
  constexpr bool kBf16 = std::is_same<T, bf16>::value;
  extern __shared__ float4 smem4[];
  cg::cluster_group cl = cg::this_cluster();
  const Where<T> w = where<T>(a);
  const Stage s = stage_layout(reinterpret_cast<float*>(smem4), a.rpr);
  float* MT = s.rest;                 // (kQ, kQ): M[t, u] of one head at MT[u kQ + t]
  float* Hin = MT + kQ * kQ;          // (kHeads, 16, 64): h_in(c) per head
  float* part = Hin + kHeads * kState;  // (kQ,): the block's sum of squares per row
  stage_chunk(a, w, s, cl);
  if (w.c > 0) fold_heads(a, w, Hin);
  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16, warp = threadIdx.x / 32;
  const bool live = kGroupRows * warp < w.q;     // the warp holds a step of the chunk
  const int k_end = min(w.q, 8 * warp + 8);       // its last step + 1
  const T* z_g = w.zx_g + w.head0 * kHd + 4 * tx;
  float sq[4] = {0.0f, 0.0f, 0.0f, 0.0f};         // the thread's sums of squares per row
#pragma unroll
  for (int hh = 0; hh < kHeads; ++hh) {
    const double* lcs = s.lcs + hh * kQ;
    const float* dts = s.dts + hh * kQ;
    {  // M of this head: cbT[i][j] = Bs_u . Cs_t for u = 4 ty + i, t = 4 tx + j (u <= t)
      float cbT[4][4];
      ssd::zero(cbT);
      if (ty <= tx) mm4(cbT, s.BsT, kQ, s.CsT, kQ, 0, kN);
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int u = 4 * ty + i;
        float v[4];
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const int t = 4 * tx + j;
          const float m = cbT[i][j] * expf(static_cast<float>(lcs[t] - lcs[u]));
          v[j] = u <= t && t < w.q ? (kBf16 ? round_bf16(m) : m * dts[u]) : 0.0f;
        }
        *reinterpret_cast<float4*>(MT + u * kQ + 4 * tx) = make_float4(v[0], v[1], v[2], v[3]);
      }
    }
    float4 zv[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int t = 4 * ty + i;
      zv[i] = t < w.q ? ld4(z_g + static_cast<size_t>(w.t0 + t) * a.dproj + hh * kHd)
                      : make_float4(0.0f, 0.0f, 0.0f, 0.0f);
    }
    __syncthreads();
    float acc[4][4], cross[4][4];
    ssd::zero(acc);
    ssd::zero(cross);
    float* Xh = s.X + hh * kHd;
    if (live) {
      mm4<kBf16>(acc, MT, kQ, Xh, kCh, 0, k_end, dts);  // u <= t
      if (w.c > 0) mm4(cross, s.CsT, kQ, Hin + hh * kState, kHd, 0, kN);
    }
    __syncthreads();  // Xh and MT read: g overwrites xs in place, M the next head's
    const float Dh = a.D[w.m][w.head0 + hh];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int t = 4 * ty + i;
      const float e = expf(static_cast<float>(lcs[t]));
      float* xp = Xh + t * kCh + 4 * tx;
      const float4 xv = ld4(xp);
      const float xs[4] = {xv.x, xv.y, xv.z, xv.w}, zs[4] = {zv[i].x, zv[i].y, zv[i].z, zv[i].w};
      float g[4];
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float y = fmaf(e, cross[i][j], acc[i][j]) + Dh * xs[j];
        g[j] = t < w.q ? y * silu(zs[j]) : 0.0f;
        sq[i] = fmaf(g[j], g[j], sq[i]);
      }
      *reinterpret_cast<float4*>(xp) = make_float4(g[0], g[1], g[2], g[3]);
    }
  }
  // The block's sum of squares per row: each thread's (heads, then j), then
  // the 16 lanes of the row by xor 1, 2, 4, 8.
#pragma unroll
  for (int i = 0; i < 4; ++i) {
#pragma unroll
    for (int o = 1; o < 16; o <<= 1) sq[i] += __shfl_xor_sync(0xffffffffu, sq[i], o);
    if (tx == 0) part[4 * ty + i] = sq[i];
  }
  cl.sync();  // every rank's partials written
  const float* norm_w = a.norm_w[w.m] + w.head0 * kHd + 4 * tx;
  T* out_g = static_cast<T*>(a.out) + static_cast<size_t>(w.g) * a.L * a.d + w.head0 * kHd + 4 * tx;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int t = 4 * ty + i;
    if (t >= w.q) continue;
    float total = 0.0f;
    for (int r = 0; r < a.csize; ++r) total += cl.map_shared_rank(part, r)[t];  // rank order
    const float rms = rsqrtf(total / a.d + a.eps);
    T* orow = out_g + static_cast<size_t>(w.t0 + t) * a.d;
#pragma unroll
    for (int hh = 0; hh < kHeads; ++hh) {
      const float4 g = ld4(s.X + t * kCh + hh * kHd + 4 * tx), nw = ld4(norm_w + hh * kHd);
      st4(orow + hh * kHd,
          make_float4(g.x * rms * nw.x, g.y * rms * nw.y, g.z * rms * nw.z, g.w * rms * nw.w));
    }
  }
  cl.sync();  // no block leaves while another may still read its partials
}

// nc chunks of Qc steps: nc = ceil(L / kQ), Qc = ceil(L / nc) rounded up to 4.
void set_dims(Args& a, int G, int M, int L, int d, int H) {
  a.G = G;
  a.per = G / M;
  a.L = L;
  a.d = d;
  a.H = H;
  a.dproj = 2 * d + 2 * kN + H;
  a.nc = (L + kQ - 1) / kQ;
  a.Qc = ((L + a.nc - 1) / a.nc + 3) / 4 * 4;
  a.csize = H / kHeads;
  a.rpr = (a.Qc + a.csize - 1) / a.csize;
}

size_t workspace_floats(const Args& a) {
  const size_t units = static_cast<size_t>(a.G) * a.H * a.nc;
  return units * kState + 2 * units;  // states, then sums as two floats each
}

template <class... Kargs>
int launch_cluster(void (*kernel)(Kargs...), const Args& a, int chunks, int smem_floats,
                   cudaStream_t stream) {
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(a.csize * chunks, a.G, 1);
  cfg.blockDim = dim3(kThreads, 1, 1);
  cfg.dynamicSmemBytes = static_cast<size_t>(smem_floats) * sizeof(float);
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = a.csize;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return static_cast<int>(cudaLaunchKernelEx(&cfg, kernel, a));
}

}  // namespace

// Floats of workspace that ssd_core_fwd needs for these shapes.
extern "C" long long ssd_core_workspace_floats(int M, int G, int L, int d, int H) {
  Args a{};
  set_dims(a, G, M, L, d, H);
  return static_cast<long long>(workspace_floats(a));
}

namespace {

// The two launches for zx of type T (see ssd_core_fwd).
template <class T>
int run(const Args& a, cudaStream_t st) {
  constexpr int kMaxStates = stage_floats(kQ) + kStatesExtra;
  constexpr int kMaxOut = stage_floats(kQ) + kOutExtra;
  static const cudaError_t attr[] = {
      cudaFuncSetAttribute(core_states_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                           kMaxStates * 4),
      cudaFuncSetAttribute(core_out_norm_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                           kMaxOut * 4),
  };
  for (const cudaError_t e : attr) {
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  if (a.nc > 1) {
    const int err = launch_cluster(core_states_kernel<T>, a, a.nc - 1,
                                   stage_floats(a.rpr) + kStatesExtra, st);
    if (err != 0) return err;
  }
  return launch_cluster(core_out_norm_kernel<T>, a, a.nc, stage_floats(a.rpr) + kOutExtra, st);
}

}  // namespace

// `ptrs` holds 6 pointers per branch: conv_w (d + 2n, K), conv_b (d + 2n,),
// dt_bias, A_log, D (H,) and norm_w (d,), for M = 1 or 2 branches; all fp32
// and contiguous, conv_w and zx 16-byte aligned. `zx` (G, L, dproj) and `out`
// (G, L, d) of `dtype` (0 fp32, 1 bf16), G a multiple of M, sequence g taking
// branch g / (G / M); `workspace` ssd_core_workspace_floats floats. Launches
// two kernels on `stream` (one for L <= 64); returns the first cudaError_t
// that is not 0, or -1 for shapes or a dtype that are not built (up to 16
// heads of 64 channels, H a multiple of 4 so that zx's rows are whole groups
// of 4).
extern "C" int ssd_core_fwd(void* const* ptrs, int M, const void* zx, void* out,
                            void* workspace, int G, int L, int d, int n, int H, int K,
                            float eps, float dt_lo, float dt_hi, int dtype, void* stream) {
  if (M < 1 || M > 2 || G < M || G % M != 0 || n != kN || K != kConv || H < 1 ||
      H > kHeads * kMaxCluster || H % 4 != 0 || d != H * kHd || L < 1 || dtype < 0 ||
      dtype > 1) {
    return -1;
  }
  Args a{};
  for (int m = 0; m < M; ++m) {
    void* const* q = ptrs + m * 6;
    a.conv_w[m] = static_cast<const float*>(q[0]);
    a.conv_b[m] = static_cast<const float*>(q[1]);
    a.dt_bias[m] = static_cast<const float*>(q[2]);
    a.A_log[m] = static_cast<const float*>(q[3]);
    a.D[m] = static_cast<const float*>(q[4]);
    a.norm_w[m] = static_cast<const float*>(q[5]);
  }
  set_dims(a, G, M, L, d, H);
  a.zx = zx;
  a.out = out;
  a.states = static_cast<float*>(workspace);
  a.sums = reinterpret_cast<double*>(a.states + static_cast<size_t>(G) * H * a.nc * kState);
  a.eps = eps;
  a.dt_lo = dt_lo;
  a.dt_hi = dt_hi;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return dtype == 1 ? run<bf16>(a, st) : run<float>(a, st);
}
