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
// A is given itself (negative), not as its logarithm.
//
// Arithmetic. The two products (x_proj, dt_proj) run on the tensor cores in
// 3xTF32 (gemm_tc.cuh: each operand split into a TF32 high part and
// remainder, three products summed in fp32, about fp32's accuracy); the
// conv, the scan and the gate are fp32 on the CUDA cores.
//
// Bound on an H100 SXM (495 TFLOP/s TF32 on the tensor cores, 67 TFLOP/s
// fp32 outside them, 3.35 TB/s). At the shapes of three DiffMa-B/2 streams
// (G = 3, L = 196, d = 1024, r = 32) the call does 0.12 GFLOP of products
// (x_proj 77 M, dt_proj 39 M), 2.1 us at the 3xTF32 rate (495 / 3), and 68 M
// other operations (the scan 63 M, the conv 5 M), 1.0 us at the fp32 rate,
// against 7.7 MB that must move (xz 4.8 MB, out 2.4 MB, the weights 0.5 MB),
// 2.3 us. The scan's chain of L dependent steps is what the design has to
// break up at this size.
//
// Design: kernel C's stages (fused_mixer_fwd.cu) without its gather, five
// device kernels with u, xdb and dt in a workspace the caller allocates
// (mamba_inner_workspace_floats). Step t of sequence g is row g * L + t.
// 1. conv + SiLU (conv_kernel: a block per row, its threads the channels)
//    into u;
// 2. x_proj: gemm_tc.cuh on u, its depth d split over blocks when the rows
//    are few (8 atrous streams of 49 steps: 7 row tiles, 8 splits) and the
//    splits summed in a fixed order; the partials lie in dt's space, which
//    is free until step 3;
// 3. dt_proj: gemm_tc.cuh, softplus in its store, so the scan reads dt and
//    runs no dot product in its chain;
// 4. the scan: scan_fwd.cuh's, chunked over up to eight warps of a block,
//    each warp issuing the next 8 steps' loads of B, C, dt, u and z before
//    it runs the current 8; InnerSeq below is its loader policy (B and C
//    from xdb, z from xz).
// The TPU kernel's 16-step chunks, its VMEM scratch and its zero padding of L
// to a multiple of 16 exist for VMEM; here L is masked and nothing is padded.
//
// bf16 (dtype 1: xz and out bf16, the weights fp32), the TPU kernel at an
// xz of bfloat16, as the JAX package's bf16 model runs it: the conv, SiLU,
// softplus, the scan and the gate stay fp32, on the fp32 u; x_proj and
// dt_proj multiply bf16 operands with fp32 sums (gemm_tc.cuh's kBf16
// stages), each operand rounded to bf16 (to nearest even) where the JAX
// kernel casts it: u and xp_w for x_proj, dt_r and dt_w for dt_proj. B, C,
// dt_b and the split sums stay fp32; out is rounded to bf16 once, at the
// scan's store. The bound at that dtype: the same 0.12 GFLOP of products at
// 989 TFLOP/s, 0.12 us, against 4.1 MB that must move (xz and out at 2
// bytes), 1.2 us.
//
// It has no backward kernel, in either package: the gradient recomputes the
// function through the composable operators (the scan kernels A and B).

#include <cuda_runtime.h>
#include <stdint.h>

#include "gemm_tc.cuh"
#include "scan_fwd.cuh"

namespace {

constexpr int kN = scan_fwd::kN;  // d_state
constexpr int kConv = 4;          // conv taps
constexpr int kMaxRank = 32;      // dt_rank
constexpr int kEltThreads = 256;  // threads of the conv kernel

using bf16 = tc::bf16;
using tc::al;
using tc::kIsBf16;
using tc::ld;
using tc::ld4;
using tc::put;

// softplus(x) = log(1 + exp(x)) without overflow: max(x, 0) + log1p(exp(-|x|)).
__device__ __forceinline__ float softplus(float x) {
  return fmaxf(x, 0.0f) + log1pf(expf(-fabsf(x)));
}

// R = G * L rows; xz and y of type T (float or bf16), the rest fp32.
template <class T>
struct InnerParams {
  const float* conv_w;  // (d, K)
  const float* conv_b;  // (d,)
  const float* xp_w;    // (r + 2n, d)
  const float* dt_w;    // (d, r)
  const float* dt_b;    // (d,)
  const float* A;       // (d, n)
  const float* D;       // (d,)
  const T* xz;          // (R, 2d)
  float* u;             // (R, d)
  float* xdb;           // (R, r + 2n)
  float* dt;            // (R, d): softplus(dt_r W_dt^T + dt_b)
  float* xdb_part;      // (xp_splits, R, r + 2n) inside dt's space, if split
  T* y;                 // (R, d)
  int G, L, d, r, xp_splits;
};

// The stages of gemm_tc.cuh: c[row, col] = sum_k a(row, k) b(col, k). T is
// xz's dtype: with bf16 both stages multiply in bf16 (kBf16).

template <class T>
struct XProj {  // xdb = u . W_x^T
  static constexpr bool kAByRow = false, kBByRow = false, kBf16 = kIsBf16<T>;
  bool vec;  // float4 loads: every row aligned
  struct ARow {
    const float* u;
  };
  const float *u, *w;
  float* c;
  int rows, cols, depth;
  __device__ XProj(const InnerParams<T>& p, int)
      : u(p.u), w(p.xp_w), c(p.xp_splits == 1 ? p.xdb : p.xdb_part), rows(p.G * p.L),
        cols(p.r + 2 * kN), depth(p.d) {
    vec = al(u, depth) && al(w, depth);
  }
  __device__ ARow arow(int i) const { return {u + static_cast<size_t>(i) * depth}; }
  __device__ float a(const ARow& r, int k) const { return r.u[k]; }
  __device__ float4 a4(const ARow& r, int k) const { return ld4(r.u + k); }
  __device__ float b(int col, int k) const { return w[static_cast<size_t>(col) * depth + k]; }
  __device__ float4 b4(int col, int k) const { return ld4(w + static_cast<size_t>(col) * depth + k); }
  __device__ void store(int row, int col, int split, float v) const {
    c[(static_cast<size_t>(split) * rows + row) * cols + col] = v;
  }
};

template <class T>
struct DtProj {  // dt = softplus(dt_r . W_dt^T + dt_b); one slab deep
  static constexpr bool kAByRow = false, kBByRow = false, kBf16 = kIsBf16<T>;
  bool vec;  // float4 loads: every row aligned
  struct ARow {
    const float* xdb;
  };
  const float *xdb, *w, *bias;
  float* c;
  int rows, cols, depth, ld;
  __device__ DtProj(const InnerParams<T>& p, int)
      : xdb(p.xdb), w(p.dt_w), bias(p.dt_b), c(p.dt), rows(p.G * p.L), cols(p.d), depth(p.r),
        ld(p.r + 2 * kN) {
    vec = al(xdb, ld) && al(w, depth);
  }
  __device__ ARow arow(int i) const { return {xdb + static_cast<size_t>(i) * ld}; }
  __device__ float a(const ARow& r, int k) const { return r.xdb[k]; }
  __device__ float4 a4(const ARow& r, int k) const { return ld4(r.xdb + k); }
  __device__ float b(int col, int k) const { return w[static_cast<size_t>(col) * depth + k]; }
  __device__ float4 b4(int col, int k) const { return ld4(w + static_cast<size_t>(col) * depth + k); }
  __device__ void store(int row, int col, int, float v) const {
    c[static_cast<size_t>(row) * cols + col] = softplus(v + bias[col]);
  }
};

// u = silu(causal_conv_K(xz[:, :d]) + conv_b). grid R: a block is one row
// g * L + t, its threads the channels.
template <class T>
__global__ void __launch_bounds__(kEltThreads) conv_kernel(const InnerParams<T> p) {
  const int row = blockIdx.x;
  const int d = p.d, t = row % p.L;
  const T* tap[kConv];
#pragma unroll
  for (int k = 0; k < kConv; ++k) {
    const int back = kConv - 1 - k;  // tap k reads step t - back of the same sequence
    tap[k] = t >= back ? p.xz + static_cast<size_t>(row - back) * 2 * d : nullptr;
  }
  float* u = p.u + static_cast<size_t>(row) * d;
  for (int ch = threadIdx.x; ch < d; ch += kEltThreads) {
    const float* w = p.conv_w + static_cast<size_t>(ch) * kConv;
    float acc = p.conv_b[ch];
#pragma unroll
    for (int k = 0; k < kConv; ++k) {
      if (tap[k] != nullptr) acc = fmaf(w[k], ld(tap[k] + ch), acc);
    }
    u[ch] = scan_fwd::silu(acc);
  }
}

// The loader policy of scan_fwd.cuh: stream g is sequence g; dt, u and B, C
// come from the workspace (fp32), z from xz (T, raw until the step takes it).
template <class T>
struct InnerSeq {
  using Params = InnerParams<T>;
  const float *ap, *dp, *bc, *dtp, *up;
  const T* zp;
  T* yp;
  int d, ld;
  __device__ InnerSeq(const Params& p, int g, int c)
      : ap(p.A + static_cast<size_t>(c) * kN), dp(p.D + c), d(p.d), ld(p.r + 2 * kN) {
    const size_t row0 = static_cast<size_t>(g) * p.L;
    bc = p.xdb + row0 * ld + p.r;
    dtp = p.dt + row0 * d + c;
    up = p.u + row0 * d + c;
    zp = p.xz + row0 * 2 * d + d + c;
    yp = p.y + row0 * d + c;
  }
  __device__ float a2(int k) const { return ap[k] * scan_fwd::kLog2e; }
  __device__ float D() const { return *dp; }
  __device__ float B(int t, int k) const { return bc[static_cast<size_t>(t) * ld + k]; }
  __device__ float C(int t, int k) const { return bc[static_cast<size_t>(t) * ld + kN + k]; }
  __device__ float dt(int t) const { return dtp[static_cast<size_t>(t) * d]; }
  __device__ float u(int t) const { return up[static_cast<size_t>(t) * d]; }
  __device__ T z(int t) const { return zp[static_cast<size_t>(t) * 2 * d]; }
  __device__ static float f(float x) { return x; }
  __device__ static float f(bf16 x) { return __bfloat162float(x); }
  __device__ float dt_of(float dt) const { return dt; }  // softplus is in dt_proj's store
  __device__ void store(int t, float y) const { put(yp + static_cast<size_t>(t) * d, y); }
};

// x_proj's depth splits. Each split keeps at least 4 slabs of 32 (splits_for),
// so splits * (r + 2n) <= d / 128 * 64 < d: the partials fit in dt's space.
int xp_splits(int G, int L, int d) {
  return tc::splits_for((G * L + tc::kBM - 1) / tc::kBM, d);
}

}  // namespace

// Floats of workspace that mamba_inner_fwd needs for these shapes: u, xdb, dt.
extern "C" long long mamba_inner_workspace_floats(int G, int L, int d, int r) {
  return static_cast<long long>(G) * L * (2 * d + r + 2 * kN);
}

namespace {

// The chain of launches for xz of type T (see mamba_inner_fwd).
template <class T>
int run(const void* xz, const void* conv_w, const void* conv_b, const void* xp_w,
        const void* dt_w, const void* dt_b, const void* A, const void* D, void* out,
        void* workspace, int G, int L, int d, int r, cudaStream_t st) {
  const int R = G * L, r2 = r + 2 * kN;
  InnerParams<T> p{};
  p.conv_w = static_cast<const float*>(conv_w);
  p.conv_b = static_cast<const float*>(conv_b);
  p.xp_w = static_cast<const float*>(xp_w);
  p.dt_w = static_cast<const float*>(dt_w);
  p.dt_b = static_cast<const float*>(dt_b);
  p.A = static_cast<const float*>(A);
  p.D = static_cast<const float*>(D);
  p.xz = static_cast<const T*>(xz);
  p.u = static_cast<float*>(workspace);
  p.xdb = p.u + static_cast<size_t>(R) * d;
  p.dt = p.xdb + static_cast<size_t>(R) * r2;
  p.xdb_part = p.dt;
  p.y = static_cast<T*>(out);
  p.G = G;
  p.L = L;
  p.d = d;
  p.r = r;
  p.xp_splits = xp_splits(G, L, d);
  if (p.xp_splits > 1 && p.xp_splits * r2 > d) return -1;  // cannot happen: see xp_splits

  conv_kernel<T><<<R, kEltThreads, 0, st>>>(p);
  int err = static_cast<int>(cudaGetLastError());
  if (err == 0) err = tc::launch_gemm_tc<64, XProj<T>>(p, R, r2, 1, st, p.xp_splits);
  if (err == 0 && p.xp_splits > 1) {
    tc::SplitSum q{};
    q.part[0] = p.xdb_part;
    q.out[0] = p.xdb;
    q.n = R * r2;
    q.splits = p.xp_splits;
    err = tc::launch_sum_splits(q, 1, st);
  }
  if (err == 0) err = tc::launch_gemm_tc<128, DtProj<T>>(p, R, d, 1, st);
  if (err == 0) err = scan_fwd::launch<InnerSeq<T>>(p, G, L, d, true, st);
  return err;
}

}  // namespace

// xz (G, L, 2d) and out (G, L, d) of `dtype` (0 fp32, 1 bf16); the weights
// fp32: conv_w (d, K), conv_b (d,), xp_w (r + 2n, d), dt_w (d, r), dt_b
// (d,), A (d, n), D (d,); all contiguous. Launches its kernels on `stream`;
// returns the first launch's cudaError_t that is not 0, or -1 for shapes or
// a dtype that are not built.
extern "C" int mamba_inner_fwd(const void* xz, const void* conv_w, const void* conv_b,
                               const void* xp_w, const void* dt_w, const void* dt_b,
                               const void* A, const void* D, void* out, void* workspace,
                               int G, int L, int d, int n, int r, int K, int dtype,
                               void* stream) {
  if (n != kN || K != kConv || r < 1 || r > kMaxRank || G < 1 || L < 1 || d < 1 || dtype < 0 ||
      dtype > 1) {
    return -1;
  }
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return dtype == 1 ? run<bf16>(xz, conv_w, conv_b, xp_w, dt_w, dt_b, A, D, out, workspace, G, L,
                                d, r, st)
                    : run<float>(xz, conv_w, conv_b, xp_w, dt_w, dt_b, A, D, out, workspace, G,
                                 L, d, r, st);
}
