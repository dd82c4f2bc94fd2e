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
// Arithmetic. in_proj and out_proj run on the tensor cores in 3xTF32
// (gemm_tc.cuh: each operand split into a TF32 high part and remainder, three
// products summed in fp32), as kernel C's do; the SSD and the row kernels are
// fp32 on the CUDA cores. Each decay's exponent is a sum of dt * A taken in
// fp64 and rounded once, and it is never positive: the causal mask is a
// selection (u <= t), never a product (ssd_core.cuh).
//
// Bound on an H100 SXM (495 TFLOP/s TF32, so 165 TFLOP/s for the 3xTF32
// products; 67 TFLOP/s fp32 outside the tensor cores; 3.35 TB/s). At the
// DiffMa-B/2 sampler's shapes (batch 1, L = 196, h = 512, d = 1024, H = 16,
// S = 3) one branch does 0.42 GFLOP in in_proj, 0.21 in out_proj and 0.07 in
// the three streams' chunked SSD products, all at the 3xTF32 rate: about 9 us
// in all for both branches, against 14.4 MB of weights, x and out, 4 us. So
// operations bound it, in_proj's share most.
//
// Design. One call launches six kernels on the stream (seven in prologue
// mode, one more where out_proj's depth is split), with the intermediates in
// zx and a workspace that the caller allocates (ssd_mixer_workspace_floats).
// blockIdx.z (or a grid axis) selects the branch in every kernel, so both
// branches share each launch.
// 0. prologue (only in that mode): one block per token row; LayerNorm,
//    modulate, and both branches' inputs written to the workspace. A row
//    kernel: loaders that compute ran kernel C's products at 8-18 TFLOP/s.
// 1. in_proj: gemm_tc.cuh's GEMM (InProj below), 64 x 64 or 64 x 128 tiles;
//    the edge of its 2d + 2n + H = 2096 columns is masked by the GEMM.
// 2. the SSD, chunked over each stream in chunks of 64 steps with a carried
//    state (ssd_core.cuh): one block of 256 threads per (branch, b, stream,
//    head, chunk) writes the chunk's end state, then one per the same folds
//    the earlier chunks' states into the state entering its chunk and writes
//    y to the workspace in token order: per stream for full-length specs
//    (each stream is a permutation, so no two writes meet), one row per token
//    for a partition. A block holds one chunk, so shared memory does not
//    grow with the stream and nothing caps its length; the fold's reads
//    grow as the square of the chunks (ssd_core.cuh).
// 3. gate + norm + merge: one block per token row and branch; each thread
//    holds d / 256 channels; per stream the gated row's sum of squares is
//    reduced over the block, and the normed rows add up in stream order (a
//    partition has one row per token).
// 4. out_proj: the GEMM again (OutProj), its depth d split over blocks when
//    the tiles alone leave SMs idle, the partials summed in a fixed order.
// The TPU kernel's one-hot permutation and head-expansion matmuls, its
// tril-matmul cumsum and its 8-row padding of L exist for the MXU and VMEM;
// here they are index gathers, c / 64, a warp scan and exact t < L.
//
// Stage 2 lives in ssd_core.cuh, which the backward (kernel F,
// fused_ssd_bwd.cu) shares.
//
// The residual: the TPU kernel's want_res outputs, the permuted conv + dt
// columns xs and the gate z, exist so that its backward need not repeat
// in_proj or a permutation (a matmul there). Here a permutation is an index,
// and zx in token order holds both. So zx is not part of the workspace but a
// tensor the caller owns: a caller that needs the backward keeps it for
// kernel F, any other drops it. The kernel does the same work either way.
//
// bf16 (dtype 1: x and out in bf16, and in prologue mode wmask, shift and
// scale; the weights fp32), the TPU kernel at a compute dtype cd = bfloat16,
// as the JAX package's bf16 model runs it. in_proj and out_proj multiply bf16
// operands with fp32 sums (gemm_tc.cuh's kBf16 stages), each operand rounded
// to bf16 (to nearest even) where the JAX kernel casts it: x (in prologue
// mode LN + modulate + mask, computed in fp32), W_in, the merge and W_out.
// zx is rounded to bf16 as in_proj stores it (the residual then holds bf16
// values in fp32); the conv, dt and the cumsum are fp32 from it. The SSD
// rounds its intra-chunk products' operands (ssd_core.cuh). y + D x is fp32
// and is rounded to bf16 before the gate for every stream that does not run
// in token order (`ident`, the TPU kernel's identity streams, whose y its
// un-permute skips); the gate, the norm and the stream sum are fp32. out is
// rounded to bf16 once, after out_proj's fp32 sum (and its splits' sum).
// The workspaces stay fp32, holding bf16 values where the JAX kernel rounds,
// so the SSD, conv and row kernels are those of the fp32 variant.
//
// Several B/C groups and a partition spec in prologue mode are not built:
// the wrapper raises for them.

#include <cuda_runtime.h>
#include <stdint.h>

#include "gemm_tc.cuh"
#include "ssd_core.cuh"

namespace {

using ssd::block_sum;
using ssd::kConv;
using ssd::kHd;
using ssd::kMaxStreams;
using ssd::kN;
using ssd::round_bf16;
using ssd::silu;
using tc::al;
using tc::kIsBf16;
using tc::ld;
using tc::ld4;
using tc::put;
using bf16 = tc::bf16;

constexpr int kBranchPtrs = 10;
constexpr int kRowThreads = 256;  // gate + norm + merge
constexpr int kMaxPerThread = 8;  // so d <= 2048
constexpr int kProThreads = 128;

struct Branch {
  const void* x;         // (B, L, h), fp32 or bf16
  const float* in_w;     // (2d + 2n + H, h)
  const float* conv_w;   // (d + 2n, K)
  const float* conv_b;   // (d + 2n,)
  const float* dt_bias;  // (H,)
  const float* A_log;    // (H,)
  const float* D;        // (H,)
  const float* norm_w;   // (d,)
  const float* out_w;    // (h, d)
  void* out;             // (B, L, h), x's dtype
};

struct Params {
  Branch br[2];
  const int64_t* fwd;  // (S, Ls): stream s visits tokens fwd[s, 0..Ls-1]
  float* xmod;         // (M, B * L, h), prologue mode only
  float* zx;           // (M, B * L, dproj)
  float* y;            // (M, B * y_streams * L, d), token order: y_s[l] at
                       // (b * S + s) * L + l, or y[l] at b * L + l for a partition
  float* merged;       // (M, B * L, d)
  float* states;       // the SSD's chunk states and sums (ssd::state_floats)
  float* out_part;     // (M, out_splits, B * L, h): out_proj's split partials, if split
  // prologue mode; wmask, shift and scale of x's dtype
  const void* wmask;   // (B, L)
  const float* ln_w;   // (h,)
  const float* ln_b;   // (h,)
  const void* shift;   // (B, h), rows mod_stride apart
  const void* scale_;  // (B, h), rows mod_stride apart
  int mod_stride;
  float ln_eps;
  int B, L, Ls, h, d, H, S, y_streams, dproj, in_bn, out_splits;
  int ident;  // bf16: bit s set when stream s runs in token order (its y is not rounded)
  float scale, eps, dt_lo, dt_hi;
};

__device__ __forceinline__ size_t tokens(const Params& p) { return static_cast<size_t>(p.B) * p.L; }

// 0. LayerNorm + modulate (+ soft mask for branch 1), in fp32 for either
// dtype T of x (in_proj's bf16 stage rounds the result). grid B * L.
template <class T>
__global__ void __launch_bounds__(kProThreads) prologue_kernel(const Params p) {
  __shared__ float red[kProThreads / 32];
  const int row = blockIdx.x;  // b * L + l
  const int b = row / p.L;
  const int h = p.h;
  const T* x = static_cast<const T*>(p.br[0].x) + static_cast<size_t>(row) * h;
  float s = 0.0f;
  for (int c = threadIdx.x; c < h; c += kProThreads) s += ld(x + c);
  const float mu = block_sum(s, red) / h;
  float q = 0.0f;
  for (int c = threadIdx.x; c < h; c += kProThreads) {
    const float xc = ld(x + c) - mu;
    q += xc * xc;
  }
  const float r = rsqrtf(block_sum(q, red) / h + p.ln_eps);
  const T* shift = static_cast<const T*>(p.shift) + static_cast<size_t>(b) * p.mod_stride;
  const T* scale = static_cast<const T*>(p.scale_) + static_cast<size_t>(b) * p.mod_stride;
  const float wm = ld(static_cast<const T*>(p.wmask) + row);
  float* x0 = p.xmod + static_cast<size_t>(row) * h;
  float* x1 = x0 + static_cast<size_t>(p.B) * p.L * h;
  for (int c = threadIdx.x; c < h; c += kProThreads) {
    const float xn = (ld(x + c) - mu) * r * p.ln_w[c] + p.ln_b[c];
    const float xm = xn * (1.0f + ld(scale + c)) + ld(shift + c);
    x0[c] = xm;
    x1[c] = xm * wm;
  }
}

// The stages of gemm_tc.cuh: c[row, col] = sum_k a(row, k) b(col, k) for one
// branch. Rows resolve into an ARow once per thread, before the k-loop.

// zx = x . W_in^T, x of type XT (the input, or fp32 xmod in prologue mode);
// kB: the bf16 model, whose products take bf16 operands and whose zx rounds.
template <class XT, bool kB>
struct InProj {
  static constexpr bool kAByRow = false, kBByRow = false, kBf16 = kB;
  bool vec;  // float4 loads: every row aligned
  struct ARow {
    const XT* x;
  };
  const XT* x;
  const float* w;
  float* c;
  int rows, cols, depth;
  __device__ InProj(const Params& p, int m)
      : x(p.xmod ? reinterpret_cast<const XT*>(p.xmod + m * tokens(p) * p.h)
                 : static_cast<const XT*>(p.br[m].x)),
        w(p.br[m].in_w), c(p.zx + m * tokens(p) * p.dproj), rows(static_cast<int>(tokens(p))),
        cols(p.dproj), depth(p.h) {
    vec = al(x, depth) && al(w, depth);
  }
  __device__ ARow arow(int i) const { return {x + static_cast<size_t>(i) * depth}; }
  __device__ float a(const ARow& r, int k) const { return ld(r.x + k); }
  __device__ float4 a4(const ARow& r, int k) const { return ld4(r.x + k); }
  __device__ float b(int col, int k) const { return w[static_cast<size_t>(col) * depth + k]; }
  __device__ float4 b4(int col, int k) const { return ld4(w + static_cast<size_t>(col) * depth + k); }
  __device__ void store(int row, int col, int, float v) const {
    c[static_cast<size_t>(row) * cols + col] = kB ? round_bf16(v) : v;
  }
};

// out = merged . W_out^T: out of type T, or its fp32 split partials.
template <class T>
struct OutProj {
  static constexpr bool kAByRow = false, kBByRow = false, kBf16 = kIsBf16<T>;
  bool vec;  // float4 loads: every row aligned
  struct ARow {
    const float* a;
  };
  const float *merged, *w;
  T* out;
  float* part;
  int rows, cols, depth;
  __device__ OutProj(const Params& p, int m)
      : merged(p.merged + m * tokens(p) * p.d), w(p.br[m].out_w), out(static_cast<T*>(p.br[m].out)),
        part(p.out_splits == 1 ? nullptr
                               : p.out_part + static_cast<size_t>(m) * p.out_splits * tokens(p) * p.h),
        rows(static_cast<int>(tokens(p))), cols(p.h), depth(p.d) {
    vec = al(merged, depth) && al(w, depth);
  }
  __device__ ARow arow(int i) const { return {merged + static_cast<size_t>(i) * depth}; }
  __device__ float a(const ARow& r, int k) const { return r.a[k]; }
  __device__ float4 a4(const ARow& r, int k) const { return ld4(r.a + k); }
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

// 3. Gate with silu(z), RMSNorm over d per stream, sum over streams, * scale;
// kBf16: each stream's y rounded first but an identity stream's. grid (B * L, M).
template <bool kBf16>
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
    const bool round = kBf16 && !((p.ident >> s) & 1);
    float q = 0.0f;
#pragma unroll
    for (int i = 0; i < kMaxPerThread; ++i) {
      const int c = threadIdx.x + i * kRowThreads;
      g[i] = c < d ? (round ? round_bf16(y[c]) : y[c]) * sz[i] : 0.0f;
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

void set_dims(Params& p, int B, int L, int Ls, int h, int d, int H, int S) {
  p.B = B;
  p.L = L;
  p.Ls = Ls;
  p.h = h;
  p.d = d;
  p.H = H;
  p.S = S;
  p.y_streams = Ls == L ? S : 1;
  p.dproj = 2 * d + 2 * kN + H;
  // Tiles counted for two branches whatever M is, so that a one-mixer call
  // tiles and splits as the dual call does and gives its branch's bits.
  const int tiles = 2 * ((B * L + tc::kBM - 1) / tc::kBM);
  // in_proj in 64-wide column tiles while 128-wide ones give under two
  // blocks per SM (batch 1); out_proj's depth split while its tiles are few.
  p.in_bn = tiles * ((p.dproj + 127) / 128) < 2 * tc::kSMs ? 64 : 128;
  p.out_splits = tc::splits_for(tiles * ((h + 127) / 128), d);
}

// Lay the workspace out for these shapes (pointers into `base` when given);
// returns its size in floats.
size_t layout(Params& p, float* base, int M, bool prologue) {
  const size_t tokens = static_cast<size_t>(M) * p.B * p.L;
  const size_t sizes[] = {
      prologue ? tokens * p.h : 0,                                   // xmod
      tokens * p.y_streams * p.d,                                    // y
      tokens * p.d,                                                  // merged
      ssd::state_floats(M, p.B, p.S, p.Ls, p.H),                     // states
      p.out_splits > 1 ? static_cast<size_t>(p.out_splits) * tokens * p.h : 0,  // out_part
  };
  float** ptrs[] = {&p.xmod, &p.y, &p.merged, &p.states, &p.out_part};
  size_t total = 0;
  for (int i = 0; i < 5; ++i) {
    if (base != nullptr) *ptrs[i] = sizes[i] ? base + total : nullptr;
    total += (sizes[i] + 3) / 4 * 4;  // every array 16-byte aligned
  }
  return total;
}

ssd::FwdArgs core_args(const Params& p, int M) {
  ssd::FwdArgs core{};
  for (int m = 0; m < M; ++m) {
    const Branch& br = p.br[m];
    core.mx[m] = ssd::Mixer{br.conv_w, br.conv_b, br.dt_bias, br.A_log, br.D};
  }
  core.fwd = p.fwd;
  core.zx = p.zx;
  core.y = p.y;
  core.B = p.B;
  core.Ls = p.Ls;
  core.Lt = p.L;
  core.d = p.d;
  core.H = p.H;
  core.S = p.S;
  core.y_streams = p.y_streams;
  core.dproj = p.dproj;
  core.dt_lo = p.dt_lo;
  core.dt_hi = p.dt_hi;
  ssd::set_state_workspace(core, p.states, M);
  return core;
}

// The chain of launches for x of type T (see ssd_mixer_fwd).
template <class T>
int run(Params& p, int M, bool prologue, cudaStream_t st) {
  constexpr bool kB = kIsBf16<T>;
  const int T_ = p.B * p.L, h = p.h;
  int err = 0;
  if (prologue) {
    prologue_kernel<T><<<T_, kProThreads, 0, st>>>(p);
    err = static_cast<int>(cudaGetLastError());
  }
  if (err == 0) {
    if (prologue) {
      err = p.in_bn == 64 ? tc::launch_gemm_tc<64, InProj<float, kB>>(p, T_, p.dproj, M, st)
                          : tc::launch_gemm_tc<128, InProj<float, kB>>(p, T_, p.dproj, M, st);
    } else {
      err = p.in_bn == 64 ? tc::launch_gemm_tc<64, InProj<T, kB>>(p, T_, p.dproj, M, st)
                          : tc::launch_gemm_tc<128, InProj<T, kB>>(p, T_, p.dproj, M, st);
    }
  }
  ssd::FwdArgs core = core_args(p, M);
  core.bf16 = kB;
  if (err == 0) err = ssd::launch_ssd_fwd(core, M, st);
  if (err == 0) {
    gate_norm_merge_kernel<kB><<<dim3(T_, M), kRowThreads, 0, st>>>(p);
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

// Floats of workspace that ssd_mixer_fwd needs for these shapes.
extern "C" long long ssd_mixer_workspace_floats(int M, int B, int L, int Ls, int h, int d,
                                                int H, int S, int prologue) {
  Params p{};
  set_dims(p, B, L, Ls, h, d, H, S);
  return static_cast<long long>(layout(p, nullptr, M, prologue != 0));
}

// `ptrs` holds 10 pointers per branch, in the order of struct Branch, for
// M = 1 or 2 branches, all contiguous: x and out of `dtype` (0 fp32, 1
// bf16), the weights fp32. `fwd` (S, Ls) is int64: with Ls = L each of its
// rows is a permutation of 0 .. L-1, with Ls = L / S its rows partition
// them (not in prologue mode). `pro` is null, or five pointers for prologue
// mode (then M = 2 and both branches' x is the block's input): wmask (B, L),
// ln_w (h,), ln_b (h,), shift and scale (B, h) whose rows lie `mod_stride`
// elements apart; wmask, shift and scale of `dtype`, ln_w and ln_b fp32.
// `zx` (M, B * L, dproj) fp32 takes in_proj's output, the residual that
// kernel F reads. `ident` (bf16 only) has bit s set when stream s is in
// token order. Launches its kernels on `stream`; returns the first
// cudaError_t that is not 0, or -1 for shapes or a dtype that are not built.
extern "C" int ssd_mixer_fwd(void* const* ptrs, int M, const void* fwd, void* workspace,
                             void* zx, void* const* pro, int mod_stride, float ln_eps,
                             int B, int L, int Ls,
                             int h, int d, int n, int H, int K, int S, float scale,
                             float eps, float dt_lo, float dt_hi, int dtype, int ident,
                             void* stream) {
  const bool partition = Ls != L;
  if (M < 1 || M > 2 || n != kN || K != kConv || H < 1 || d != H * kHd ||
      d > kRowThreads * kMaxPerThread || S < 1 || S > kMaxStreams || Ls < 1 ||
      (partition && (Ls * S != L || pro)) || (pro && M != 2) || dtype < 0 || dtype > 1) {
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
        static_cast<const float*>(q[8]), q[9]};
  }
  p.fwd = static_cast<const int64_t*>(fwd);
  set_dims(p, B, L, Ls, h, d, H, S);
  layout(p, static_cast<float*>(workspace), M, pro != nullptr);
  if (pro) {
    p.wmask = pro[0];
    p.ln_w = static_cast<const float*>(pro[1]);
    p.ln_b = static_cast<const float*>(pro[2]);
    p.shift = pro[3];
    p.scale_ = pro[4];
    p.mod_stride = mod_stride;
    p.ln_eps = ln_eps;
  }
  p.zx = static_cast<float*>(zx);
  p.scale = scale;
  p.eps = eps;
  p.dt_lo = dt_lo;
  p.dt_hi = dt_hi;
  p.ident = ident;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return dtype == 1 ? run<bf16>(p, M, pro != nullptr, st) : run<float>(p, M, pro != nullptr, st);
}
