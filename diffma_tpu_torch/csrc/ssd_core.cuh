// The state-space-duality (SSD) core of one Mamba-2 head, shared by kernel E
// (fused_ssd_fwd.cu, which also holds kernel P, the split form's core) and
// kernel F (fused_ssd_bwd.cu): staging a head's stream in shared memory, and
// the forward product.
//
// Given zx = in_proj(x) in token order, with columns [z (d) | x (d) | B (n) |
// C (n) | dt (H)], one (branch, batch element, stream, head) needs, in the
// stream's token order fwd[s]:
//
//     [xs | Bs | Cs] = silu(causal_conv_K(zx[fwd[s], d : 2d + 2n]) + conv_b)
//     dt   = clip(softplus(zx[fwd[s], dt column of the head] + dt_bias), lo, hi)
//     cs   = inclusive cumsum over t of dt * A,  A = -exp(A_log)
//     y[t, :] = sum_{u <= t} (Cs_t . Bs_u) exp(cs_t - cs_u) dt_u xs[u, :] + D xs[t, :]
//
// stage_head fills shared memory with xs (the head's 64 channels), Bs, Cs, dt
// and cs; ssd_fwd_kernel stages a head and writes y back in token order. The
// cumsum runs in fp64 in one warp and is rounded once, because everything
// after it goes through exp(cs_t - cs_u). The causal mask is a selection
// (u <= t), never a product: above the diagonal cs_t - cs_u is positive and
// exp would overflow at wide spans. Everything else is fp32 FMA.
//
// A stream has L steps over the Lt tokens of its batch element: L = Lt when
// every stream visits every token, L = Lt / S when the streams partition
// them (each stream then is a sequence of its own: the conv's pad and the
// cumsum start at its first step). y goes out at the step's token index: per
// stream ((b * S + s) * Lt + token) when `y_streams` is S, or (b * Lt + token)
// when it is 1 (a partition, where each token lies in one stream). Without a
// gather table (kernel P: the caller gathered) step t is row t itself.

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace ssd {

constexpr int kN = 16;         // d_state
constexpr int kHd = 64;        // channels per head
constexpr int kConv = 4;       // conv taps
constexpr int kMaxStreams = 4;
constexpr int kThreads = 256;  // threads of a head's block
constexpr int kTile = 32;      // steps per tile of the SSD products
constexpr int kBStride = kN + 1;  // Bs rows padded: lanes read different rows
constexpr int kMaxSharedBytes = 227 * 1024;

__device__ __forceinline__ float sigmoid(float x) { return 1.0f / (1.0f + expf(-x)); }
__device__ __forceinline__ float silu(float x) { return x / (1.0f + expf(-x)); }
__device__ __forceinline__ float dsilu(float x) {
  const float s = sigmoid(x);
  return s * (1.0f + x * (1.0f - s));
}

// softplus(x) = log(1 + exp(x)) without overflow: max(x, 0) + log1p(exp(-|x|)).
__device__ __forceinline__ float softplus(float x) {
  return fmaxf(x, 0.0f) + log1pf(expf(-fabsf(x)));
}

// Sum of v over the block; every thread gets it. `red` holds one float per warp.
__device__ __forceinline__ float block_sum(float v, float* red) {
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

// The block's dynamic shared memory, 16-byte aligned.
__device__ __forceinline__ float* dynamic_smem() {
  extern __shared__ float4 ssd_dynamic_smem[];
  return reinterpret_cast<float*>(ssd_dynamic_smem);
}

// The per-head weights of one mixer that the SSD core reads.
struct Mixer {
  const float* conv_w;   // (d + 2n, K)
  const float* conv_b;   // (d + 2n,)
  const float* dt_bias;  // (H,)
  const float* A_log;    // (H,)
  const float* D;        // (H,)
};

// What one head's block reads, and where it stages it.
struct Head {
  const float* zx_b;     // this (branch, batch element)'s zx rows (L, dproj)
  const int64_t* order;  // fwd[s]: the stream's token order (L,), or null: step t is row t
  Mixer mx;
  int head, L, d, dproj;
  float dt_lo, dt_hi;
  // shared memory
  float* X;    // (L, x_stride): xs, this head's 64 channels
  float* Bs;   // (L, kBStride)
  float* Cs;   // (L, kN)
  float* dts;  // (L,)
  float* css;  // (L,)
  double* css64;  // (L,) cs before its rounding to fp32, or null
  float* pre;  // (L,) dt's pre-activation zx + dt_bias, or null
  int* tok;    // (L,)
  int x_stride;
};

// Fill the head's shared memory; all kThreads threads call it, and it ends
// with a __syncthreads().
__device__ inline void stage_head(const Head& hd) {
  const int L = hd.L, d = hd.d, tid = threadIdx.x;
  const int conv_dim = d + 2 * kN;
  for (int t = tid; t < L; t += kThreads) hd.tok[t] = hd.order ? static_cast<int>(hd.order[t]) : t;
  __syncthreads();

  // conv + SiLU over this head's 64 x channels and the 32 B and C channels,
  // in stream order, zero left pad; dt.
  constexpr int kCols = kHd + 2 * kN;
  for (int i = tid; i < L * kCols; i += kThreads) {
    const int t = i / kCols, j = i % kCols;
    const int cc = j < kHd ? hd.head * kHd + j : d + (j - kHd);  // conv channel
    const float4 wk = reinterpret_cast<const float4*>(hd.mx.conv_w)[cc];  // taps 0..3
    const float wt[kConv] = {wk.x, wk.y, wk.z, wk.w};
    float acc = hd.mx.conv_b[cc];
#pragma unroll
    for (int k = 0; k < kConv; ++k) {
      const int tt = t - (kConv - 1) + k;
      if (tt >= 0) {
        acc = fmaf(wt[k], hd.zx_b[static_cast<size_t>(hd.tok[tt]) * hd.dproj + d + cc], acc);
      }
    }
    const float v = silu(acc);
    if (j < kHd) {
      hd.X[t * hd.x_stride + j] = v;
    } else if (j < kHd + kN) {
      hd.Bs[t * kBStride + (j - kHd)] = v;
    } else {
      hd.Cs[t * kN + (j - kHd - kN)] = v;
    }
  }
  const float A = -expf(hd.mx.A_log[hd.head]);
  const float dtb = hd.mx.dt_bias[hd.head];
  for (int t = tid; t < L; t += kThreads) {
    const float p =
        hd.zx_b[static_cast<size_t>(hd.tok[t]) * hd.dproj + d + conv_dim + hd.head] + dtb;
    if (hd.pre != nullptr) hd.pre[t] = p;
    hd.dts[t] = fminf(fmaxf(softplus(p), hd.dt_lo), hd.dt_hi);
  }
  __syncthreads();

  // cs: inclusive cumsum of dt * A, by warp 0 in fp64, 32 steps at a time.
  if (tid < 32) {
    double carry = 0.0;
    for (int t0 = 0; t0 < L; t0 += 32) {
      const int t = t0 + tid;
      double v = t < L ? static_cast<double>(hd.dts[t] * A) : 0.0;
#pragma unroll
      for (int o = 1; o < 32; o <<= 1) {
        const double up = __shfl_up_sync(0xffffffffu, v, o);
        if (tid >= o) v += up;
      }
      v += carry;
      if (t < L) {
        hd.css[t] = static_cast<float>(v);
        if (hd.css64 != nullptr) hd.css64[t] = v;
      }
      carry = __shfl_sync(0xffffffffu, v, 31);
    }
  }
  __syncthreads();
}

// The forward product's arguments: both branches of a call.
struct FwdArgs {
  Mixer mx[2];
  const int64_t* fwd;  // (S, L): stream s visits tokens fwd[s, 0..L-1], or null
  const float* zx;     // (M, B * Lt, dproj)
  float* y;            // (M, B * y_streams * Lt, d), token order (see above)
  int B, L, Lt, d, S, y_streams, dproj;
  float dt_lo, dt_hi;
};

// Shared memory of one forward block, in floats (the token order is ints of
// the same size).
__host__ __device__ constexpr size_t fwd_smem_floats(int L) {
  return static_cast<size_t>(L) * (kHd + kBStride + kN + 3) + kTile * static_cast<size_t>(L + 1);
}

// The SSD of one (branch, b, stream, head). grid (H, B * S, M). For each
// tile of 32 steps t, the block builds M[t, u] = (Cs_t . Bs_u)
// exp(cs_t - cs_u) dt_u for u <= t (0 above the diagonal) in shared memory
// and multiplies M (32 x t_end) by xs (t_end x 64) with a 2 x 4 register tile
// per thread, stopping at the tile's last step. y goes out in token order
// (no two writes meet: a stream visits a token once, and in a partition
// each token lies in one stream).
static __global__ void __launch_bounds__(kThreads) ssd_fwd_kernel(const FwdArgs a) {
  float* smem = dynamic_smem();
  const int L = a.L, d = a.d;
  const int head = blockIdx.x;
  const int bs = blockIdx.y;  // b * S + s
  const int s = bs % a.S;
  const int b = bs / a.S;
  const int m = blockIdx.z;
  const int tid = threadIdx.x;

  Head hd;
  hd.zx_b = a.zx + (static_cast<size_t>(m) * a.B + b) * a.Lt * a.dproj;
  hd.order = a.fwd ? a.fwd + static_cast<size_t>(s) * L : nullptr;
  hd.mx = a.mx[m];
  hd.head = head;
  hd.L = L;
  hd.d = d;
  hd.dproj = a.dproj;
  hd.dt_lo = a.dt_lo;
  hd.dt_hi = a.dt_hi;
  hd.X = smem;                       // (L, 64)
  hd.Bs = hd.X + L * kHd;            // (L, 17)
  hd.Cs = hd.Bs + L * kBStride;      // (L, 16)
  hd.dts = hd.Cs + L * kN;           // (L,)
  hd.css = hd.dts + L;               // (L,)
  hd.css64 = nullptr;
  hd.pre = nullptr;
  hd.tok = reinterpret_cast<int*>(hd.css + L);  // (L,)
  hd.x_stride = kHd;
  float* Mt = hd.css + 2 * L;        // (kTile, L + 1)
  const int mstride = L + 1;
  stage_head(hd);
  const float *X = hd.X, *Bs = hd.Bs, *Cs = hd.Cs, *dts = hd.dts, *css = hd.css;
  const int* tok = hd.tok;

  const float Dh = hd.mx.D[head];
  const size_t y_seq = a.y_streams == 1 ? static_cast<size_t>(m) * a.B + b
                                        : static_cast<size_t>(m) * a.B * a.S + bs;
  float* y_bs = a.y + y_seq * a.Lt * d + head * kHd;
  const int warp = tid / 32, lane = tid % 32;
  const int tx = tid % 16;  // columns tx + 16 j
  const int ty = tid / 16;  // rows ty and ty + 16 of the tile

  for (int t0 = 0; t0 < L; t0 += kTile) {
    const int rows = min(kTile, L - t0);
    const int t_end = t0 + rows;  // the tile's rows need u < t_end
    // M[i, u] for the tile's rows: each warp takes rows warp, warp + 8, ...
    for (int i = warp; i < rows; i += kThreads / 32) {
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

// Launch ssd_fwd_kernel for M branches of H heads on `stream`; returns the
// first cudaError_t that is not 0.
inline int launch_ssd_fwd(const FwdArgs& a, int M, int H, cudaStream_t stream) {
  const size_t smem = fwd_smem_floats(a.L) * sizeof(float);
  int err = static_cast<int>(cudaFuncSetAttribute(
      ssd_fwd_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem)));
  if (err != 0) return err;
  ssd_fwd_kernel<<<dim3(H, a.B * a.S, M), kThreads, smem, stream>>>(a);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace ssd
