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
// per step. Neither is what limits it at this batch: each channel runs a
// 196-step recurrence whose steps depend on each other, so the time is the
// chain's latency, not bytes or operations.
//
// Design, simple and right first:
// - one thread per (g, channel) keeps its n states and its row of A in
//   registers, so the recurrence never leaves the SM;
// - a block of kThreads = 32 threads covers 32 consecutive channels of one
//   g. At batch 1 there are only G * d = 3072 channels, so narrow blocks give
//   96 blocks and spread the chains over most of the 132 SMs; a 128-wide
//   block would leave 108 SMs idle;
// - the block stages B_t and C_t for kTimeChunk steps at a time in shared
//   memory (every thread of the block reads the same B_t, C_t), converted to
//   fp32 once;
// - loads of u, delta, z and the store of out are coalesced along d;
// - the time loop runs t < L exactly: no chunk padding, any L works.
//
// The backward, diffma_tpu/ops/selective_scan.py::_bwd_kernel, is kernel B,
// selective_scan_bwd.cu.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 32;
constexpr int kTimeChunk = 64;

__device__ __forceinline__ float to_float(float x) { return x; }
__device__ __forceinline__ float to_float(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

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

template <int N, typename T, typename TD>
__global__ void __launch_bounds__(kThreads)
    selective_scan_fwd_kernel(const T* __restrict__ u,
                              const TD* __restrict__ delta,
                              const float* __restrict__ A,
                              const T* __restrict__ B,
                              const T* __restrict__ C,
                              const float* __restrict__ D,
                              const T* __restrict__ z, T* __restrict__ out,
                              int L, int d) {
  __shared__ float sB[kTimeChunk][N];
  __shared__ float sC[kTimeChunk][N];

  const int g = blockIdx.y;
  const int c = blockIdx.x * kThreads + threadIdx.x;
  const bool active = c < d;

  float a[N];
  float h[N];
#pragma unroll
  for (int k = 0; k < N; ++k) {
    a[k] = active ? A[static_cast<size_t>(c) * N + k] : 0.0f;
    h[k] = 0.0f;
  }
  const float Dc = active ? D[c] : 0.0f;
  const size_t row0 = static_cast<size_t>(g) * L;

  for (int t0 = 0; t0 < L; t0 += kTimeChunk) {
    const int steps = min(kTimeChunk, L - t0);
    __syncthreads();  // the previous chunk's B, C are no longer read
    const size_t bc0 = (row0 + t0) * N;
    for (int i = threadIdx.x; i < steps * N; i += kThreads) {
      sB[i / N][i % N] = to_float(B[bc0 + i]);
      sC[i / N][i % N] = to_float(C[bc0 + i]);
    }
    __syncthreads();
    if (!active) continue;
    for (int s = 0; s < steps; ++s) {
      const size_t idx = (row0 + t0 + s) * d + c;
      const float dt = softplus(to_float(delta[idx]));
      const float uv = to_float(u[idx]);
      const float du = dt * uv;
      float y = 0.0f;
#pragma unroll
      for (int k = 0; k < N; ++k) {
        h[k] = expf(dt * a[k]) * h[k] + du * sB[s][k];
        y += h[k] * sC[s][k];
      }
      y += Dc * uv;
      if (z != nullptr) {
        const float zv = to_float(z[idx]);
        y *= zv / (1.0f + expf(-zv));
      }
      out[idx] = from_float<T>(y);
    }
  }
}

template <int N, typename T, typename TD>
int launch(const void* u, const void* delta, const void* A, const void* B,
           const void* C, const void* D, const void* z, void* out, int G,
           int L, int d, cudaStream_t stream) {
  const dim3 grid((d + kThreads - 1) / kThreads, G);
  selective_scan_fwd_kernel<N, T, TD><<<grid, kThreads, 0, stream>>>(
      static_cast<const T*>(u), static_cast<const TD*>(delta),
      static_cast<const float*>(A), static_cast<const T*>(B),
      static_cast<const T*>(C), static_cast<const float*>(D),
      static_cast<const T*>(z), static_cast<T*>(out), L, d);
  return static_cast<int>(cudaGetLastError());
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
  if (n != 16) return -1;
  if (dtype == 0 && delta_dtype == 0)
    return launch<16, float, float>(u, delta, A, B, C, D, z, out, G, L, d, s);
  if (dtype == 1 && delta_dtype == 1)
    return launch<16, __nv_bfloat16, __nv_bfloat16>(u, delta, A, B, C, D, z,
                                                    out, G, L, d, s);
  if (dtype == 1 && delta_dtype == 0)
    return launch<16, __nv_bfloat16, float>(u, delta, A, B, C, D, z, out, G,
                                            L, d, s);
  return -1;
}
