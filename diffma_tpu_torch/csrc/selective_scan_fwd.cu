// Mamba-1 selective-scan forward for Hopper (sm_90a).
//
// Replaces the TPU kernel diffma_tpu/ops/selective_scan.py::_fwd_kernel
// (launched by _selective_scan_pallas_fwd_impl). It computes, for every
// (g, channel) pair and t = 0 .. L-1,
//
//     dt_t  = softplus(delta_t)
//     h_t   = exp(dt_t * A) * h_{t-1} + (dt_t * u_t) * B_t      (n states)
//     y_t   = <C_t, h_t> + D * u_t
//     out_t = y_t * silu(z_t)                                   (z optional)
//
// with the state in fp32 and the output in u's type. Inputs: u, z (G, L, d)
// and B, C (G, L, n) in one type T (fp32 or bf16); delta (G, L, d) in T or
// fp32, bias already added; A (d, n) fp32, negative; D (d,) fp32.
//
// Bound on an H100 SXM (3.35 TB/s, 67 TFLOP/s fp32 outside the tensor
// cores). At the DiffMa-B/2 sampling shapes, batch 1 fp32 (G = 3 streams,
// L = 196, d = 1024, n = 16), the kernel reads u, delta, z and writes out,
// about 4 * 3 * 196 * 1024 * 4 B = 9.6 MB, or 2.9 us at the memory rate; it
// also evaluates 3 * 196 * 1024 * 16 = 9.6 M exp and about 4 flops per state
// per step. Each channel's 196 steps depend on each other, so a scan that
// runs them in order is held by the chain's latency instead, and the design
// has to break the chain up.
//
// Design: scan_fwd.cuh's scan, chunked over up to eight warps of a block
// (96 blocks of 8 warps at batch 1, 768 one-warp blocks at the training
// batch G = 24), each warp issuing the next 8 steps' loads of B, C, delta,
// u and z before it runs the current 8 and computing softplus(delta) when
// it takes them up, off the chain; B and C staged in shared memory as fp32;
// each decay one ex2. ScanSeq below is its loader policy for this layout.
// Any L, nothing padded.
//
// The backward, diffma_tpu/ops/selective_scan.py::_bwd_kernel, is kernel B,
// selective_scan_bwd.cu.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "scan_fwd.cuh"

namespace {

constexpr int kN = scan_fwd::kN;

template <typename T>
__device__ __forceinline__ T from_float(float x);
template <>
__device__ __forceinline__ float from_float<float>(float x) {
  return x;
}
template <>
__device__ __forceinline__ __nv_bfloat16 from_float<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

// softplus(x) = log(1 + exp(x)), written so that it neither overflows nor
// loses the small tail: max(x, 0) + log1p(exp(-|x|)).
__device__ __forceinline__ float softplus(float x) {
  return fmaxf(x, 0.0f) + log1pf(expf(-fabsf(x)));
}

// The loader policy of scan_fwd.cuh for the layout above: stream g is
// sequence g, step t its row g * L + t.
template <typename T, typename TD>
struct ScanSeq {
  struct Params {
    const T* u;
    const TD* delta;
    const float* A;
    const T* B;
    const T* C;
    const float* D;
    const T* z;  // null: ungated
    T* out;
    int L, d;
  };
  const float *ap, *dp;
  const T *bp, *cp, *up, *zp;
  const TD* deltap;
  T* outp;
  int d;
  __device__ ScanSeq(const Params& p, int g, int c)
      : ap(p.A + static_cast<size_t>(c) * kN), dp(p.D + c), d(p.d) {
    const size_t row0 = static_cast<size_t>(g) * p.L;
    bp = p.B + row0 * kN;
    cp = p.C + row0 * kN;
    up = p.u + row0 * d + c;
    deltap = p.delta + row0 * d + c;
    zp = p.z != nullptr ? p.z + row0 * d + c : nullptr;
    outp = p.out + row0 * d + c;
  }
  __device__ float a2(int k) const { return ap[k] * scan_fwd::kLog2e; }
  __device__ float D() const { return *dp; }
  __device__ T B(int t, int k) const { return bp[static_cast<size_t>(t) * kN + k]; }
  __device__ T C(int t, int k) const { return cp[static_cast<size_t>(t) * kN + k]; }
  __device__ TD dt(int t) const { return deltap[static_cast<size_t>(t) * d]; }
  __device__ T u(int t) const { return up[static_cast<size_t>(t) * d]; }
  __device__ T z(int t) const { return zp[static_cast<size_t>(t) * d]; }
  __device__ static float f(float x) { return x; }
  __device__ static float f(__nv_bfloat16 x) { return __bfloat162float(x); }
  __device__ float dt_of(float delta) const { return softplus(delta); }
  __device__ void store(int t, float y) const { outp[static_cast<size_t>(t) * d] = from_float<T>(y); }
};

template <typename T, typename TD>
int launch(const void* u, const void* delta, const void* A, const void* B,
           const void* C, const void* D, const void* z, void* out, int G,
           int L, int d, cudaStream_t stream) {
  typename ScanSeq<T, TD>::Params p{
      static_cast<const T*>(u), static_cast<const TD*>(delta),
      static_cast<const float*>(A), static_cast<const T*>(B),
      static_cast<const T*>(C), static_cast<const float*>(D),
      static_cast<const T*>(z), static_cast<T*>(out), L, d};
  return scan_fwd::launch<ScanSeq<T, TD>>(p, G, L, d, z != nullptr, stream);
}

}  // namespace

// Type codes: 0 = fp32, 1 = bf16. `z` may be null (ungated). Returns the
// cudaError_t of the launch, or -1 for a combination that is not built.
extern "C" int selective_scan_fwd(const void* u, const void* delta,
                                  const void* A, const void* B, const void* C,
                                  const void* D, const void* z, void* out,
                                  int G, int L, int d, int n, int dtype,
                                  int delta_dtype, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (n != kN) return -1;
  if (dtype == 0 && delta_dtype == 0)
    return launch<float, float>(u, delta, A, B, C, D, z, out, G, L, d, s);
  if (dtype == 1 && delta_dtype == 1)
    return launch<__nv_bfloat16, __nv_bfloat16>(u, delta, A, B, C, D, z, out, G, L, d, s);
  if (dtype == 1 && delta_dtype == 0)
    return launch<__nv_bfloat16, float>(u, delta, A, B, C, D, z, out, G, L, d, s);
  return -1;
}
