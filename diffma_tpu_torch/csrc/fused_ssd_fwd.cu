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
// H heads of 64 channels, K = 4 taps, S streams, and in_proj's columns in the
// order [z (d) | x (d) | B (n) | C (n) | dt (H)]:
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
// stream (five in prologue mode), with the intermediates in a workspace the
// caller allocates (ssd_mixer_workspace_floats); at batch 1 it is 10 MB and
// stays in L2. blockIdx.z (or a grid axis) selects the branch in every
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
//    tile's last step. y goes to the workspace in token order (each stream
//    is a permutation, so no two writes meet).
// 3. gate + norm + merge: one block per token row and branch; each thread
//    holds d / 256 channels; per stream the gated row's sum of squares is
//    reduced over the block, and the normed rows add up in stream order.
// 4. out_proj: the GEMM again, 32 x 64 tiles.
// The TPU kernel's one-hot permutation and head-expansion matmuls, its
// tril-matmul cumsum and its 8-row padding of L exist for the MXU and VMEM;
// here they are index gathers, c / 64, a warp scan and exact t < L.
//
// The backward (_ssd_bwd_kernel) and the residual outputs it reads are not
// built yet; neither are partition specs, several B/C groups or bf16: the
// wrapper raises for them.

#include <cuda_runtime.h>
#include <stdint.h>

#include "gemm_nt.cuh"

namespace {

constexpr int kN = 16;         // d_state
constexpr int kHd = 64;        // channels per head
constexpr int kConv = 4;       // conv taps
constexpr int kMaxStreams = 4;
constexpr int kBranchPtrs = 10;
constexpr int kSsdThreads = 256;
constexpr int kTile = 32;      // steps t per tile of the SSD product
constexpr int kBStride = kN + 1;  // Bs rows padded: lanes read different rows
constexpr int kRowThreads = 256;  // gate + norm + merge
constexpr int kMaxPerThread = 8;  // so d <= 2048
constexpr int kProThreads = 128;
constexpr int kMaxSharedBytes = 227 * 1024;

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
  const int64_t* fwd;  // (S, L): stream s visits tokens fwd[s, 0..L-1]
  float* xmod;         // (M, B * L, h), prologue mode only
  float* zx;           // (M, B * L, dproj)
  float* y;            // (M, B * S * L, d), token order: y_s[l] at (b * S + s) * L + l
  float* merged;       // (M, B * L, d)
  // prologue mode
  const float* wmask;  // (B, L)
  const float* ln_w;   // (h,)
  const float* ln_b;   // (h,)
  const float* shift;  // (B, h), rows mod_stride apart
  const float* scale_;  // (B, h), rows mod_stride apart
  int mod_stride;
  float ln_eps;
  int B, L, h, d, H, S, dproj;
  float scale, eps, dt_lo, dt_hi;
};

__device__ __forceinline__ float silu(float x) { return x / (1.0f + expf(-x)); }

// softplus(x) = log(1 + exp(x)) without overflow: max(x, 0) + log1p(exp(-|x|)).
__device__ __forceinline__ float softplus(float x) {
  return fmaxf(x, 0.0f) + log1pf(expf(-fabsf(x)));
}

// Sum of v over the block; every thread gets it. `red` holds one float per warp.
__device__ float block_sum(float v, float* red) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  __syncthreads();  // the last call's reads of red are done
  if (lane == 0) red[warp] = v;
  __syncthreads();
  float total = 0.0f;
  for (int w = 0; w < blockDim.x / 32; ++w) total += red[w];  // the same order in every thread
  return total;
}

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

// Shared memory of one SSD block, in floats (the token order is ints of the
// same size).
__host__ __device__ constexpr size_t ssd_smem_floats(int L) {
  return static_cast<size_t>(L) * (kHd + kBStride + kN + 3) + kTile * static_cast<size_t>(L + 1);
}

// 2. The SSD of one (branch, b, stream, head). grid (H, B * S, M).
__global__ void __launch_bounds__(kSsdThreads) ssd_kernel(const Params p) {
  extern __shared__ float smem[];
  const int L = p.L, d = p.d;
  float* X = smem;                    // (L, 64)   xs, this head's channels
  float* Bs = X + L * kHd;            // (L, 17)
  float* Cs = Bs + L * kBStride;      // (L, 16)
  float* dts = Cs + L * kN;           // (L,)
  float* css = dts + L;               // (L,)
  int* tok = reinterpret_cast<int*>(css + L);  // (L,)
  float* Mt = css + 2 * L;            // (kTile, L + 1)
  const int mstride = L + 1;

  const int head = blockIdx.x;
  const int bs = blockIdx.y;  // b * S + s
  const int s = bs % p.S;
  const int b = bs / p.S;
  const int m = blockIdx.z;
  const int tid = threadIdx.x;
  const Branch& br = p.br[m];
  const float* zx_b = p.zx + (static_cast<size_t>(m) * p.B + b) * L * p.dproj;
  const int conv_dim = d + 2 * kN;

  for (int t = tid; t < L; t += kSsdThreads) {
    tok[t] = static_cast<int>(p.fwd[static_cast<size_t>(s) * L + t]);
  }
  __syncthreads();

  // conv + SiLU over this head's 64 x channels and the 32 B and C channels,
  // in stream order, zero left pad; dt.
  constexpr int kCols = kHd + 2 * kN;
  for (int i = tid; i < L * kCols; i += kSsdThreads) {
    const int t = i / kCols, j = i % kCols;
    const int cc = j < kHd ? head * kHd + j : d + (j - kHd);  // conv channel
    const float4 wk = reinterpret_cast<const float4*>(br.conv_w)[cc];  // taps 0..3
    const float wt[kConv] = {wk.x, wk.y, wk.z, wk.w};
    float acc = br.conv_b[cc];
#pragma unroll
    for (int k = 0; k < kConv; ++k) {
      const int tt = t - (kConv - 1) + k;
      if (tt >= 0) acc = fmaf(wt[k], zx_b[static_cast<size_t>(tok[tt]) * p.dproj + d + cc], acc);
    }
    const float v = silu(acc);
    if (j < kHd) {
      X[t * kHd + j] = v;
    } else if (j < kHd + kN) {
      Bs[t * kBStride + (j - kHd)] = v;
    } else {
      Cs[t * kN + (j - kHd - kN)] = v;
    }
  }
  const float A = -expf(br.A_log[head]);
  const float dtb = br.dt_bias[head];
  for (int t = tid; t < L; t += kSsdThreads) {
    const float raw = zx_b[static_cast<size_t>(tok[t]) * p.dproj + d + conv_dim + head];
    dts[t] = fminf(fmaxf(softplus(raw + dtb), p.dt_lo), p.dt_hi);
  }
  __syncthreads();

  // cs: inclusive cumsum of dt * A, by warp 0 in fp64, 32 steps at a time.
  if (tid < 32) {
    double carry = 0.0;
    for (int t0 = 0; t0 < L; t0 += 32) {
      const int t = t0 + tid;
      double v = t < L ? static_cast<double>(dts[t] * A) : 0.0;
#pragma unroll
      for (int o = 1; o < 32; o <<= 1) {
        const double up = __shfl_up_sync(0xffffffffu, v, o);
        if (tid >= o) v += up;
      }
      v += carry;
      if (t < L) css[t] = static_cast<float>(v);
      carry = __shfl_sync(0xffffffffu, v, 31);
    }
  }
  __syncthreads();

  const float Dh = br.D[head];
  float* y_bs = p.y + (static_cast<size_t>(m) * p.B * p.S + bs) * L * d + head * kHd;
  const int warp = tid / 32, lane = tid % 32;
  const int tx = tid % 16;  // columns tx + 16 j
  const int ty = tid / 16;  // rows ty and ty + 16 of the tile

  for (int t0 = 0; t0 < L; t0 += kTile) {
    const int rows = min(kTile, L - t0);
    const int t_end = t0 + rows;  // the tile's rows need u < t_end
    // M[i, u] for the tile's rows: each warp takes rows warp, warp + 8, ...
    for (int i = warp; i < rows; i += kSsdThreads / 32) {
      const int t = t0 + i;
      float c[kN];
#pragma unroll
      for (int k = 0; k < kN; ++k) c[k] = Cs[t * kN + k];
      const float cs_t = css[t];
      for (int u = lane; u < t_end; u += 32) {
        float v = 0.0f;
        if (u <= t) {
          float cb = 0.0f;
#pragma unroll
          for (int k = 0; k < kN; ++k) cb = fmaf(c[k], Bs[u * kBStride + k], cb);
          v = cb * expf(cs_t - css[u]) * dts[u];
        }
        Mt[i * mstride + u] = v;
      }
    }
    __syncthreads();
    // y tile = M (rows x t_end) . X (t_end x 64)
    float acc[2][4] = {{0.0f, 0.0f, 0.0f, 0.0f}, {0.0f, 0.0f, 0.0f, 0.0f}};
    const bool ok0 = ty < rows, ok1 = ty + 16 < rows;
    const float* m0 = Mt + (ok0 ? ty : 0) * mstride;
    const float* m1 = Mt + (ok1 ? ty + 16 : 0) * mstride;
    for (int u = 0; u < t_end; ++u) {
      const float a0 = m0[u], a1 = m1[u];
      const float* xr = X + u * kHd + tx;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float xv = xr[16 * j];
        acc[0][j] = fmaf(a0, xv, acc[0][j]);
        acc[1][j] = fmaf(a1, xv, acc[1][j]);
      }
    }
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int t = t0 + ty + 16 * i;
      if (i == 0 ? ok0 : ok1) {
        float* yrow = y_bs + static_cast<size_t>(tok[t]) * d;  // back in token order
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const int c = tx + 16 * j;
          yrow[c] = acc[i][j] + Dh * X[t * kHd + c];
        }
      }
    }
    __syncthreads();  // Mt is rebuilt by the next tile
  }
}

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
  for (int s = 0; s < p.S; ++s) {
    const float* y =
        p.y + (((static_cast<size_t>(m) * p.B + b) * p.S + s) * p.L + l) * d;
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

size_t workspace_floats(int M, int B, int L, int h, int d, int H, int S, int prologue) {
  const size_t tokens = static_cast<size_t>(M) * B * L;
  return (prologue ? tokens * h : 0)                // xmod
         + tokens * (2 * d + 2 * kN + H)            // zx
         + tokens * S * d                           // y
         + tokens * d;                              // merged
}

}  // namespace

// Floats of workspace that ssd_mixer_fwd needs for these shapes.
extern "C" long long ssd_mixer_workspace_floats(int M, int B, int L, int h, int d, int H,
                                                int S, int prologue) {
  return static_cast<long long>(workspace_floats(M, B, L, h, d, H, S, prologue));
}

// The longest sequence whose SSD block fits in a block's shared memory.
extern "C" int ssd_mixer_max_tokens() {
  int L = 0;
  while (ssd_smem_floats(L + 1) * sizeof(float) <= kMaxSharedBytes) ++L;
  return L;
}

// `ptrs` holds 10 pointers per branch, in the order of struct Branch, for
// M = 1 or 2 branches; all fp32 and contiguous. `fwd` (S, L) is int64 and
// each of its rows a permutation of 0 .. L-1. `pro` is null, or five
// pointers for prologue mode (then M = 2 and both branches' x is the block's
// input): wmask (B, L), ln_w (h,), ln_b (h,), shift and scale (B, h) whose
// rows lie `mod_stride` floats apart. Launches its kernels on `stream`;
// returns the first cudaError_t that is not 0, or -1 for shapes that are not
// built.
extern "C" int ssd_mixer_fwd(void* const* ptrs, int M, const void* fwd, void* workspace,
                             void* const* pro, int mod_stride, float ln_eps, int B, int L,
                             int h, int d, int n, int H, int K, int S, float scale,
                             float eps, float dt_lo, float dt_hi, void* stream) {
  if (M < 1 || M > 2 || n != kN || K != kConv || H < 1 || d != H * kHd ||
      d > kRowThreads * kMaxPerThread || S < 1 || S > kMaxStreams || L < 1 ||
      ssd_smem_floats(L) * sizeof(float) > kMaxSharedBytes || (pro && M != 2)) {
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
  p.zx = ws;
  p.y = p.zx + tokens * dproj;
  p.merged = p.y + tokens * S * d;
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
  const size_t smem = ssd_smem_floats(L) * sizeof(float);
  err = static_cast<int>(
      cudaFuncSetAttribute(ssd_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                           static_cast<int>(smem)));
  if (err != 0) return err;
  ssd_kernel<<<dim3(H, B * S, M), kSsdThreads, smem, st>>>(p);
  err = static_cast<int>(cudaGetLastError());
  if (err != 0) return err;
  gate_norm_merge_kernel<<<dim3(B * L, M), kRowThreads, 0, st>>>(p);
  err = static_cast<int>(cudaGetLastError());
  if (err != 0) return err;
  return launch_gemm<32, 64, 16, 2, 4, OutProj>(p, B * L, h, M, st);
}
