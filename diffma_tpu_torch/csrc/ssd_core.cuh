// The state-space-duality (SSD) core of one Mamba-2 head, chunked over the
// sequence, shared by kernel E (fused_ssd_fwd.cu) and kernel F
// (fused_ssd_bwd.cu): staging a chunk of a head's stream in shared memory,
// the block products, and the forward. Kernel P (ssd_core_fwd.cu) stages
// and multiplies its chunks its own way; it takes the constants and the
// activations from here and keeps the arithmetic rules below.
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
// Chunked form. The stream's Ls steps are cut into chunks of kQ = 64 (the
// last one ragged; masking is exact, t < Ls, with zeros past the end). Within
// chunk c, lcs[t] is the inclusive cumsum of dt * A from the chunk's first
// step, in fp64, and sum(c) = lcs[last]. Then
//
//     h_c     = sum_{u in c} exp(sum(c) - lcs[u]) dt_u Bs_u (x) xs_u      (16 x 64)
//     h_in(c) = sum_{c' < c} exp(sum(c' + 1) + ... + sum(c - 1)) h_c'    (the state entering c)
//     y[t]    = sum_{u <= t in c} (Cs_t . Bs_u) exp(lcs[t] - lcs[u]) dt_u xs_u
//               + exp(lcs[t]) Cs_t . h_in(c) + D xs_t
//
// Every exponent is a sum of dt * A over steps, so it is <= 0: at a span of
// dt |A| in the thousands the decays underflow to 0 and everything stays
// finite. The causal mask is a selection (u <= t), never a product: above the
// diagonal lcs[t] - lcs[u] is positive and exp would overflow. Each exponent
// is taken in fp64 and rounded once. h_in(c) is summed directly over the
// earlier chunks' states, in chunk order, with the chunk offsets carried in
// fp64: no sequential pass, and every chunk's block is independent. So chunk
// c reads c states of 4 KB, a stream of nc chunks nc (nc - 1) / 2 per head
// where a pass along the chunks would read nc - 1 at the cost of one more
// launch: at 16 chunks (1024 steps) the fold takes about a quarter of the
// output kernel's time, at 4 (196 steps) about 6% (PERF.md).
//
// Two kernels, each one block of 256 threads per (branch, b, stream, head,
// chunk): ssd_state_kernel writes h_c and sum(c) to the workspace, and
// ssd_out_kernel, after it, folds the earlier chunks' states into h_in(c) and
// writes y back in token order; no state is written for a stream's last chunk,
// which no chunk reads. A block holds one chunk, about 54 KB of shared memory
// (four blocks an SM), whatever the stream's length. It loads each zx value the
// conv reads once (the four taps share the rows), and the conv's token rows
// with them. The products are fp32 FMA on the CUDA cores with a 4 x 4 register
// tile per thread (block_mm), each warp's causal products cut to the steps its
// rows can see.
//
// bf16 (FwdArgs::bf16, kernels E and F at a compute dtype of bfloat16): the
// output kernel rounds the chunk's masked decay (Cs_t . Bs_u) exp(lcs[t] -
// lcs[u]) and xdt_u = dt_u xs_u to bf16 (to nearest even) at its product,
// which sums in fp32, as the TPU kernel's bf16 head products do; the states,
// the cross-chunk term and the D skip stay fp32, and so does everything
// stage_chunk computes (zx holds bf16 values then).
//
// A stream has Ls steps over the Lt tokens of its batch element: Ls = Lt when
// every stream visits every token, Ls = Lt / S when the streams partition
// them (each stream then is a sequence of its own: the conv's pad and the
// cumsum start at its first step, and chunks never cross streams). y goes out
// at the step's token index: per stream ((b * S + s) * Lt + token) when
// `y_streams` is S, or (b * Lt + token) when it is 1 (a partition, where each
// token lies in one stream).

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "bf16_round.cuh"

namespace ssd {

constexpr int kN = 16;         // d_state
constexpr int kHd = 64;        // channels per head
constexpr int kConv = 4;       // conv taps
constexpr int kMaxStreams = 4;
constexpr int kThreads = 256;  // threads of a chunk's block: 16 x 16 for block_mm
constexpr int kQ = 64;         // steps per chunk
constexpr int kXS = kHd + 1;   // row strides, padded so that 16 lanes reading 16
constexpr int kNS = kN + 1;    // rows of one column meet 16 banks
constexpr int kQS = kQ + 1;
constexpr int kState = kN * kHd;  // floats of one head's state

__device__ __forceinline__ float sigmoid(float x) { return 1.0f / (1.0f + expf(-x)); }
__device__ __forceinline__ float silu(float x) { return x / (1.0f + expf(-x)); }
__device__ __forceinline__ float dsilu(float x) {
  const float s = sigmoid(x);
  return s * (1.0f + x * (1.0f - s));
}

using ::round_bf16;

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

// acc[i][j] += sum_{k_begin <= k < k_end} a(RI ty + i, k) b(k, tx + 16 j)
// over the block's 16 x 16 threads (tx = thread % 16, ty = thread / 16), with
// a(r, k) = A[r * lda + k] (A[k * lda + r] when TA) and b(k, c) = B[k * ldb + c]
// (B[c * ldb + k] when TB), all in shared memory. A warp's two ty read two
// addresses of A (a broadcast); its 16 tx read 16 consecutive floats of B,
// or 16 rows of an odd stride (TB). A warp holds rows RI 2w .. RI (2w + 2) - 1,
// so a causal product bounds k by the warp (rows_begin, rows_end below); with
// kLower the column groups above the warp's last row are skipped (the causal
// half of an outer product, c <= r). fa(a, r, k) and fb(b, k, c) map each
// element as it is read (Keep: as it stands; the bf16 products round).
struct Keep {
  __device__ __forceinline__ float operator()(float v, int, int) const { return v; }
};

template <int RI, int CJ, bool TA, bool TB, bool kLower = false, class FA = Keep, class FB = Keep>
__device__ __forceinline__ void block_mm(float (&acc)[RI][CJ], const float* A, int lda,
                                         const float* B, int ldb, int k_begin, int k_end,
                                         FA fa = FA(), FB fb = FB()) {
  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;
  const int last = RI * (threadIdx.x / 32 * 2 + 2) - 1;  // the warp's last row
#pragma unroll 4
  for (int k = k_begin; k < k_end; ++k) {
    float a[RI], b[CJ];
#pragma unroll
    for (int i = 0; i < RI; ++i) {
      const int r = RI * ty + i;
      a[i] = fa(TA ? A[k * lda + r] : A[r * lda + k], r, k);
    }
#pragma unroll
    for (int j = 0; j < CJ; ++j) {
      if (kLower && 16 * j > last) continue;
      const int c = tx + 16 * j;
      b[j] = fb(TB ? B[c * ldb + k] : B[k * ldb + c], k, c);
    }
#pragma unroll
    for (int i = 0; i < RI; ++i)
#pragma unroll
      for (int j = 0; j < CJ; ++j) {
        if (kLower && 16 * j > last) continue;
        acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
      }
  }
}

// The first and one past the last row of the calling warp in block_mm<4, ...>.
__device__ __forceinline__ int rows_begin() { return 8 * (threadIdx.x / 32); }
__device__ __forceinline__ int rows_end() { return 8 * (threadIdx.x / 32) + 8; }

template <int RI, int CJ>
__device__ __forceinline__ void zero(float (&acc)[RI][CJ]) {
#pragma unroll
  for (int i = 0; i < RI; ++i)
#pragma unroll
    for (int j = 0; j < CJ; ++j) acc[i][j] = 0.0f;
}

// The per-head weights of one mixer that the SSD core reads.
struct Mixer {
  const float* conv_w;   // (d + 2n, K)
  const float* conv_b;   // (d + 2n,)
  const float* dt_bias;  // (H,)
  const float* A_log;    // (H,)
  const float* D;        // (H,)
};

// One chunk of one head's stream: what its block reads, and where it stages it.
struct Chunk {
  const float* zx_b;     // this (branch, batch element)'s zx rows (Lt, dproj)
  const int64_t* order;  // fwd[s]: the stream's token order (Ls,)
  Mixer mx;
  int head, d, dproj, t0, q;  // the chunk's steps are t0 .. t0 + q - 1, q <= kQ
  float dt_lo, dt_hi;
  // shared memory, kQ rows each; rows q .. kQ - 1 hold zeros (lcs: sum(c))
  float* X;     // (kQ, kXS): xs, this head's 64 channels
  float* Bs;    // (kQ, kNS)
  float* Cs;    // (kQ, kNS)
  float* dts;   // (kQ,)
  double* lcs;  // (kQ,): inclusive cumsum of dt * A from the chunk's first step
  int* tok;     // tok[t] for t = -(K - 1) .. kQ - 1: the token row of step t0 + t,
                // or -1 before the stream's start (the conv's taps)
  float4* cw;   // (kCols,): the conv's taps of the head's channels
  float* cb;    // (kCols,): their biases
};

// The conv channels a head reads: its 64 x channels, then B and C.
constexpr int kCols = kHd + 2 * kN;
static_assert(kConv == 4, "the conv's taps are one float4 a channel");
// Floats of shared memory that stage_chunk fills (lcs as two floats a step,
// tok 2 kQ ints, the conv's weights), and of the scratch it needs besides:
// the conv's input rows, the chunk's steps and the K - 1 before them.
constexpr int kChunkFloats = kQ * (kXS + 2 * kNS + 5) + (kConv + 1) * kCols;
constexpr int kRawFloats = (kQ + kConv - 1) * kCols;

// Lay a chunk's staging arrays out from `smem` (16-byte aligned); returns the
// first float after them.
__device__ __forceinline__ float* chunk_layout(Chunk& ch, float* smem) {
  ch.lcs = reinterpret_cast<double*>(smem);
  ch.X = smem + 2 * kQ;
  ch.Bs = ch.X + kQ * kXS;
  ch.Cs = ch.Bs + kQ * kNS;
  ch.dts = ch.Cs + kQ * kNS;
  ch.tok = reinterpret_cast<int*>(ch.dts + kQ) + (kConv - 1);
  ch.cw = reinterpret_cast<float4*>(ch.dts + 3 * kQ);
  ch.cb = ch.dts + 3 * kQ + kConv * kCols;
  return ch.cb + kCols;
}

__device__ __forceinline__ int token_of(const Chunk& ch, int t) {
  return static_cast<int>(ch.order[t]);
}

// Fill the chunk's shared memory, using `raw` (kRawFloats) as scratch; all
// kThreads threads call it, and it ends with a __syncthreads(). Each zx value
// the conv reads is loaded once, into raw, whose rows the four taps share;
// the loads of a phase are issued together (unrolled), so that a block waits
// for memory once a phase, not once a value.
__device__ inline void stage_chunk(const Chunk& ch, float* raw) {
  const int d = ch.d, tid = threadIdx.x, q = ch.q;
  const int conv_dim = d + 2 * kN;
  // 1. The token rows (with the conv's K - 1 before the chunk), dt, and the
  // conv's weights.
  for (int i = tid - (kConv - 1); i < kQ; i += kThreads) {
    const int t = ch.t0 + i;
    const int tk = i < q && t >= 0 ? token_of(ch, t) : -1;
    ch.tok[i] = tk;
    if (i >= 0) {
      float dt = 0.0f;
      if (i < q) {
        const float p = ch.zx_b[static_cast<size_t>(tk) * ch.dproj + d + conv_dim + ch.head] +
                        ch.mx.dt_bias[ch.head];
        dt = fminf(fmaxf(softplus(p), ch.dt_lo), ch.dt_hi);
      }
      ch.dts[i] = dt;
    }
  }
  for (int j = tid; j < kCols; j += kThreads) {
    const int cc = j < kHd ? ch.head * kHd + j : d + (j - kHd);  // conv channel
    ch.cw[j] = reinterpret_cast<const float4*>(ch.mx.conv_w)[cc];  // taps 0..3
    ch.cb[j] = ch.mx.conv_b[cc];
  }
  __syncthreads();

  // 2. The conv's input: raw row r is step t0 + r - (K - 1), zero before the
  // stream's start and past the chunk's end.
  constexpr int kRawIters = (kRawFloats + kThreads - 1) / kThreads;
  const int n_raw = (q + kConv - 1) * kCols;
  float v[kRawIters];
#pragma unroll
  for (int it = 0; it < kRawIters; ++it) {
    const int i = tid + it * kThreads;
    v[it] = 0.0f;
    if (i < n_raw) {
      const int r = i / kCols, j = i % kCols;
      const int tk = ch.tok[r - (kConv - 1)];
      const int cc = j < kHd ? ch.head * kHd + j : d + (j - kHd);
      if (tk >= 0) v[it] = ch.zx_b[static_cast<size_t>(tk) * ch.dproj + d + cc];
    }
  }
#pragma unroll
  for (int it = 0; it < kRawIters; ++it) {
    const int i = tid + it * kThreads;
    if (i < kRawFloats) raw[i] = v[it];
  }
  __syncthreads();

  // 3. conv + SiLU over the 96 channels, in stream order; lcs, the inclusive
  // cumsum of dt * A, by warp 0 in fp64, 32 steps at a time (the rows past q
  // add 0 and so hold sum(c)).
#pragma unroll 4
  for (int i = tid; i < kQ * kCols; i += kThreads) {
    const int r = i / kCols, j = i % kCols;
    float y = 0.0f;
    if (r < q) {
      const float4 wk = ch.cw[j];
      float acc = ch.cb[j];
      acc = fmaf(wk.x, raw[r * kCols + j], acc);
      acc = fmaf(wk.y, raw[(r + 1) * kCols + j], acc);
      acc = fmaf(wk.z, raw[(r + 2) * kCols + j], acc);
      acc = fmaf(wk.w, raw[(r + 3) * kCols + j], acc);
      y = silu(acc);
    }
    if (j < kHd) {
      ch.X[r * kXS + j] = y;
    } else if (j < kHd + kN) {
      ch.Bs[r * kNS + (j - kHd)] = y;
    } else {
      ch.Cs[r * kNS + (j - kHd - kN)] = y;
    }
  }
  if (tid < 32) {
    const float A = -expf(ch.mx.A_log[ch.head]);
    double carry = 0.0;
    for (int r0 = 0; r0 < kQ; r0 += 32) {
      double c = static_cast<double>(ch.dts[r0 + tid] * A);
#pragma unroll
      for (int o = 1; o < 32; o <<= 1) {
        const double up = __shfl_up_sync(0xffffffffu, c, o);
        if (tid >= o) c += up;
      }
      c += carry;
      ch.lcs[r0 + tid] = c;
      carry = __shfl_sync(0xffffffffu, c, 31);
    }
  }
  __syncthreads();
}

// S(c) = sum_{c' < c} exp(sum(c' + 1) + ... + sum(c - 1)) st[c'] (forward:
// the state entering chunk c, from the states st and sums of the stream's
// chunks), or with `later` sum_{c' > c} exp(sum(c + 1) + ... + sum(c' - 1))
// st[c'] (backward: the state adjoint leaving chunk c). It reads st of
// chunks 0 .. nc - 2 (forward) or 1 .. nc - 1 (backward) and sums of 1 .. nc -
// 2 only. Each of the 256 threads sums 4 of the 1024 elements in chunk
// order, into out (16, kXS).
__device__ inline void fold_states(const float* st, const double* sums, int c, int nc, bool later,
                                   float* out) {
  float acc[kState / kThreads] = {0.0f, 0.0f, 0.0f, 0.0f};
  double off = 0.0;
  const int step = later ? 1 : -1;
  for (int cp = c + step; cp >= 0 && cp < nc; cp += step) {
    if (cp - step != c) off += sums[cp - step];  // the chunks between c and cp
    const float f = expf(static_cast<float>(off));
    const float* s = st + static_cast<size_t>(cp) * kState;
#pragma unroll
    for (int i = 0; i < kState / kThreads; ++i) acc[i] = fmaf(f, s[threadIdx.x + i * kThreads], acc[i]);
  }
#pragma unroll
  for (int i = 0; i < kState / kThreads; ++i) {
    const int e = threadIdx.x + i * kThreads;
    out[(e / kHd) * kXS + e % kHd] = acc[i];
  }
}

// The forward's arguments: both branches of a call.
struct FwdArgs {
  Mixer mx[2];
  const int64_t* fwd;  // (S, Ls): stream s visits tokens fwd[s, 0..Ls-1]
  const float* zx;     // (M, B * Lt, dproj)
  float* y;            // (M, B * y_streams * Lt, d), token order (see above)
  float* states;       // (M, B * S, H, nc, 16, 64): each chunk's h_c
  double* sums;        // (M, B * S, H, nc): each chunk's sum(c)
  int B, Ls, Lt, d, H, S, y_streams, dproj, nc;
  int bf16;  // the output kernel's products on bf16 operands (see the header)
  float dt_lo, dt_hi;
};

__host__ __device__ constexpr int num_chunks(int Ls) { return (Ls + kQ - 1) / kQ; }

// Floats of the workspace that the forward's states and sums take (sums as
// two floats each), for M branches of B * S streams of Ls steps and H heads.
__host__ __device__ constexpr size_t state_floats(int M, int B, int S, int Ls, int H) {
  return static_cast<size_t>(M) * B * S * H * num_chunks(Ls) * (kState + 2);
}

// The block's (branch, b, stream, head, chunk) and its chunk. grid
// (chunks * H, B * S, M), blockIdx.x = head * chunks + chunk - first: a launch
// over `chunks` of a stream's chunks from `first` on.
struct Where {
  int m, bs, b, s, head, c;
  size_t seq;   // (m * B + b) * S + s
  size_t unit;  // seq * H + head: the index of this head's stream in states and sums
};

template <class Args>
__device__ __forceinline__ Where where(const Args& a, int first, int chunks) {
  Where w;
  w.c = first + blockIdx.x % chunks;
  w.head = blockIdx.x / chunks;
  w.bs = blockIdx.y;
  w.s = w.bs % a.S;
  w.b = w.bs / a.S;
  w.m = blockIdx.z;
  w.seq = static_cast<size_t>(w.m) * a.B * a.S + w.bs;
  w.unit = w.seq * a.H + w.head;
  return w;
}

template <class Args>
__device__ __forceinline__ Chunk chunk_of(const Args& a, const Where& w, const Mixer& mx) {
  Chunk ch;
  ch.zx_b = a.zx + (static_cast<size_t>(w.m) * a.B + w.b) * a.Lt * a.dproj;
  ch.order = a.fwd + static_cast<size_t>(w.s) * a.Ls;
  ch.mx = mx;
  ch.head = w.head;
  ch.d = a.d;
  ch.dproj = a.dproj;
  ch.t0 = w.c * kQ;
  ch.q = min(kQ, a.Ls - ch.t0);
  ch.dt_lo = a.dt_lo;
  ch.dt_hi = a.dt_hi;
  return ch;
}

// Shared memory of the state and output kernels, in bytes: the chunk, then
// stage_chunk's scratch, which the output kernel's M and h_in reuse.
constexpr int kStateSmem = (kChunkFloats + kRawFloats) * 4;
constexpr int kOutSmem =
    (kChunkFloats + (kQ * kQS + kN * kXS > kRawFloats ? kQ * kQS + kN * kXS : kRawFloats)) * 4;

// h_c and sum(c) of one chunk: h_c[k, j] = sum_u (w_u Bs[u, k]) xs[u, j],
// w_u = exp(sum(c) - lcs[u]) dt_u. Chunks 0 .. nc - 2: no chunk reads the
// last one's.
static __global__ void __launch_bounds__(kThreads) ssd_state_kernel(const FwdArgs a) {
  const Where w = where(a, 0, a.nc - 1);
  Chunk ch = chunk_of(a, w, a.mx[w.m]);
  stage_chunk(ch, chunk_layout(ch, dynamic_smem()));
  const double total = ch.lcs[kQ - 1];
  for (int i = threadIdx.x; i < kQ * kN; i += kThreads) {
    const int u = i / kN, k = i % kN;
    ch.Bs[u * kNS + k] *= expf(static_cast<float>(total - ch.lcs[u])) * ch.dts[u];
  }
  __syncthreads();
  float acc[1][4];
  zero(acc);
  block_mm<1, 4, true, false>(acc, ch.Bs, kNS, ch.X, kXS, 0, kQ);
  float* st = a.states + (w.unit * a.nc + w.c) * kState;
  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;
#pragma unroll
  for (int j = 0; j < 4; ++j) st[ty * kHd + tx + 16 * j] = acc[0][j];
  if (threadIdx.x == 0) a.sums[w.unit * a.nc + w.c] = total;
}

// y of one chunk: the chunk's own causal product, the state entering it and
// the D skip, written back in token order (no two writes meet: a stream
// visits a token once, and in a partition each token lies in one stream).
// kBf16: the causal product on bf16 operands, M[t, u] and dt_u xs_u.
template <bool kBf16>
static __global__ void __launch_bounds__(kThreads) ssd_out_kernel(const FwdArgs a) {
  const Where w = where(a, 0, a.nc);
  Chunk ch = chunk_of(a, w, a.mx[w.m]);
  float* Mt = chunk_layout(ch, dynamic_smem());  // (kQ, kQS): M[t, u]
  float* Hin = Mt + kQ * kQS;                            // (16, kXS): h_in(c)
  stage_chunk(ch, Mt);  // its scratch is Mt's and Hin's memory
  fold_states(a.states + w.unit * a.nc * kState, a.sums + w.unit * a.nc, w.c, a.nc, false, Hin);
  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;
  {
    float cb[4][4];
    zero(cb);
    block_mm<4, 4, false, true, true>(cb, ch.Cs, kNS, ch.Bs, kNS, 0, kN);
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int t = 4 * ty + i, u = tx + 16 * j;
        float v = 0.0f;
        if (u <= t && t < ch.q) {
          const float m = cb[i][j] * expf(static_cast<float>(ch.lcs[t] - ch.lcs[u]));
          v = kBf16 ? round_bf16(m) : m * ch.dts[u];
        }
        Mt[t * kQS + u] = v;
      }
  }
  __syncthreads();
  float acc[4][4], cross[4][4];
  zero(acc);
  zero(cross);
  if constexpr (kBf16) {
    const float* dts = ch.dts;
    block_mm<4, 4, false, false>(acc, Mt, kQS, ch.X, kXS, 0, rows_end(), Keep(),
                                 [dts](float v, int u, int) { return round_bf16(v * dts[u]); });
  } else {
    block_mm<4, 4, false, false>(acc, Mt, kQS, ch.X, kXS, 0, rows_end());  // u <= t
  }
  if (w.c > 0) block_mm<4, 4, false, false>(cross, ch.Cs, kNS, Hin, kXS, 0, kN);
  const float Dh = ch.mx.D[w.head];
  const size_t y_seq = a.y_streams == 1 ? static_cast<size_t>(w.m) * a.B + w.b : w.seq;
  float* y_bs = a.y + y_seq * a.Lt * a.d + w.head * kHd;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int t = 4 * ty + i;
    if (t >= ch.q) continue;
    const float e = expf(static_cast<float>(ch.lcs[t]));
    float* yrow = y_bs + static_cast<size_t>(ch.tok[t]) * a.d;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int c = tx + 16 * j;
      yrow[c] = fmaf(e, cross[i][j], acc[i][j]) + Dh * ch.X[t * kXS + c];
    }
  }
}

// Launch the forward for M branches on `stream`: the states (for a stream of
// more than one chunk), then y; returns the first cudaError_t that is not 0.
// `static`: each library that includes this header sets the attributes of its
// own copies of the kernels (an inline function's static would be one object
// for every library loaded in the process, set once for only one of them).
static int launch_ssd_fwd(const FwdArgs& a, int M, cudaStream_t stream) {
  static const cudaError_t attr[] = {
      cudaFuncSetAttribute(ssd_state_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                           kStateSmem),
      cudaFuncSetAttribute(ssd_out_kernel<false>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                           kOutSmem),
      cudaFuncSetAttribute(ssd_out_kernel<true>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                           kOutSmem),
  };
  for (const cudaError_t e : attr) {
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  if (a.nc > 1) {
    ssd_state_kernel<<<dim3((a.nc - 1) * a.H, a.B * a.S, M), kThreads, kStateSmem, stream>>>(a);
    const int err = static_cast<int>(cudaGetLastError());
    if (err != 0) return err;
  }
  const dim3 grid(a.nc * a.H, a.B * a.S, M);
  if (a.bf16) {
    ssd_out_kernel<true><<<grid, kThreads, kOutSmem, stream>>>(a);
  } else {
    ssd_out_kernel<false><<<grid, kThreads, kOutSmem, stream>>>(a);
  }
  return static_cast<int>(cudaGetLastError());
}

// Point the forward's states and sums into `ws` (16-byte aligned, at least
// state_floats(M, B, S, Ls, H) floats) and set nc.
inline void set_state_workspace(FwdArgs& a, float* ws, int M) {
  a.nc = num_chunks(a.Ls);
  a.states = ws;
  a.sums = reinterpret_cast<double*>(ws + static_cast<size_t>(M) * a.B * a.S * a.H * a.nc * kState);
}

}  // namespace ssd
