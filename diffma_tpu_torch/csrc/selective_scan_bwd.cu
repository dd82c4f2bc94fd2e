// Mamba-1 selective-scan backward for Hopper (sm_90a).
//
// Replaces the TPU kernel diffma_tpu/ops/selective_scan.py::_bwd_kernel
// (launched by _selective_scan_pallas_bwd_impl, the custom VJP's backward).
// Given the forward's inputs (kernel A's: u, z (G, L, d) and B, C (G, L, n)
// in T = fp32 or bf16, delta (G, L, d) in T or fp32 with the bias added,
// A (d, n) and D (d,) fp32) and g = dL/dout (G, L, d) in T, it writes, all in
// fp32:
//
//     du, ddelta, dz (G, L, d)    ddelta through the softplus: sigmoid(delta)
//     dB, dC (G, L, n)            sums over the d channels
//     dA (G, d, n), dD (G, d)     per sequence g; the wrapper sums over g,
//                                 as the JAX launcher does outside its kernel
//
// The recurrence is scan_bwd.cuh's.
//
// Bound on an H100 SXM (3.35 TB/s, 67 TFLOP/s fp32 outside the tensor
// cores). At the composable training path's shapes for DiffMa-B/2 at batch 8
// (G = 24 = 8 x 3 streams, L = 196, d = 1024, n = 16, fp32) it must read u,
// delta, z, g and write du, ddelta, dz, seven (G, L, d) arrays, 136 MB with
// B, C and their gradients, or 41 us at the memory rate; the operations the
// function needs, about 1.87 GFLOP (the forward once and the adjoint, about
// 23 per state and 20 per channel and step), take 28 us at the fp32 rate. So
// bytes bound it. What limits this design is the dependent chain of 3 x 196
// steps per channel (forward, chunk recompute, reverse), as in kernel A.
//
// Design, simple and right first: kernel A's layout, one thread per
// (g, channel) with its 16 states in registers, blocks of 32 channels of one
// g (768 blocks at the shapes above), B_t and C_t staged per 16-step chunk in
// shared memory. Chunk-entry states go to a workspace (checkpoints,
// G x ceil(L/16) x n x d floats); phase 2 recomputes each chunk from its
// checkpoint into shared memory and sweeps it backwards. dB and dC are
// reduced within the warp each step and written as per-block partials
// (G x L x ceil(d/32) x 2n floats), which a second kernel sums over the
// blocks in a fixed order: no atomics, deterministic. t < L exactly: no
// dt = -20 padding.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "scan_bwd.cuh"

namespace {

using scan_bwd::kChunk;
using scan_bwd::kWarp;

__device__ __forceinline__ float to_float(float x) { return x; }
__device__ __forceinline__ float to_float(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

struct Args {
  const void *u, *delta, *A, *B, *C, *D, *z, *g;
  float *du, *ddelta, *dz, *dB, *dC, *dA, *dD;
  float *ckpt, *bc;  // workspace: checkpoints, then dB/dC block partials
  int L, d, nblk;
};

// A thread's view of its channel c of sequence gi, for scan_bwd::sweep.
template <int N, typename T, typename TD>
struct ScanIO {
  const T* u_p;
  const TD* delta_p;
  const T* z_p;
  const T* g_p;
  const T* Bg;  // this sequence's B, C: (L, N)
  const T* Cg;
  float* du_p;
  float* ddelta_p;
  float* dz_p;
  float* bc;    // this sequence's dB/dC partials: (L, nblk, 32)
  float* ckpt;  // checkpoint k of chunk q at ckpt[(q * N + k) * d]
  float (*sB)[N];
  float (*sC)[N];
  size_t row0;  // gi * L
  int c, d, nblk, t0;
  bool active;

  __device__ bool gated() const { return z_p != nullptr; }
  __device__ void stage(int t0_, int steps) {
    t0 = t0_;
    for (int i = threadIdx.x; i < steps * N; i += kWarp) {
      sB[i / N][i % N] = to_float(Bg[static_cast<size_t>(t0) * N + i]);
      sC[i / N][i % N] = to_float(Cg[static_cast<size_t>(t0) * N + i]);
    }
  }
  __device__ size_t idx(int s) const { return (row0 + t0 + s) * d + c; }
  __device__ float delta(int s) const { return active ? to_float(delta_p[idx(s)]) : 0.0f; }
  __device__ float u(int s) const { return active ? to_float(u_p[idx(s)]) : 0.0f; }
  __device__ float z(int s) const { return active ? to_float(z_p[idx(s)]) : 0.0f; }
  __device__ float g(int s) const { return active ? to_float(g_p[idx(s)]) : 0.0f; }
  __device__ const float* B(int s) const { return sB[s]; }
  __device__ const float* C(int s) const { return sC[s]; }
  __device__ void save_ckpt(int q, const float (&h)[N]) {
    if (!active) return;
#pragma unroll
    for (int k = 0; k < N; ++k) ckpt[(static_cast<size_t>(q) * N + k) * d] = h[k];
  }
  __device__ void load_ckpt(int q, float (&h)[N]) const {
#pragma unroll
    for (int k = 0; k < N; ++k) {
      h[k] = active ? ckpt[(static_cast<size_t>(q) * N + k) * d] : 0.0f;
    }
  }
  __device__ void put(int s, float du, float ddelta, float dz, float) {
    if (!active) return;
    du_p[idx(s)] = du;
    ddelta_p[idx(s)] = ddelta;
    if (dz_p != nullptr) dz_p[idx(s)] = dz;
  }
  __device__ void put_bc(int s, float v) {
    bc[(static_cast<size_t>(t0 + s) * nblk + blockIdx.x) * kWarp + threadIdx.x] = v;
  }
};

template <int N, typename T, typename TD>
__global__ void __launch_bounds__(kWarp) scan_bwd_kernel(const Args p) {
  __shared__ float sB[kChunk][N];
  __shared__ float sC[kChunk][N];
  const int gi = blockIdx.y;
  const int c = blockIdx.x * kWarp + threadIdx.x;
  const bool active = c < p.d;
  const int L = p.L, d = p.d;
  const int nq = (L + kChunk - 1) / kChunk;
  const size_t row0 = static_cast<size_t>(gi) * L;

  float a[N];
#pragma unroll
  for (int k = 0; k < N; ++k) {
    a[k] = active ? static_cast<const float*>(p.A)[static_cast<size_t>(c) * N + k] : 0.0f;
  }
  const float Dc = active ? static_cast<const float*>(p.D)[c] : 0.0f;

  ScanIO<N, T, TD> io;
  io.u_p = static_cast<const T*>(p.u);
  io.delta_p = static_cast<const TD*>(p.delta);
  io.z_p = static_cast<const T*>(p.z);
  io.g_p = static_cast<const T*>(p.g);
  io.Bg = static_cast<const T*>(p.B) + row0 * N;
  io.Cg = static_cast<const T*>(p.C) + row0 * N;
  io.du_p = p.du;
  io.ddelta_p = p.ddelta;
  io.dz_p = p.dz;
  io.bc = p.bc + row0 * p.nblk * kWarp;
  io.ckpt = p.ckpt + static_cast<size_t>(gi) * nq * N * d + (active ? c : 0);
  io.sB = sB;
  io.sC = sC;
  io.row0 = row0;
  io.c = c;
  io.d = d;
  io.nblk = p.nblk;
  io.t0 = 0;
  io.active = active;

  float dA[N], dD;
  scan_bwd::sweep<N>(io, a, Dc, L, dA, dD);
  if (active) {
#pragma unroll
    for (int k = 0; k < N; ++k) p.dA[(static_cast<size_t>(gi) * d + c) * N + k] = dA[k];
    p.dD[static_cast<size_t>(gi) * d + c] = dD;
  }
}

// dB[row, k] and dC[row, k] (row = g * L + t): the sums of the per-block
// partials, over the blocks in order.
template <int N>
__global__ void reduce_bc_kernel(const Args p, int rows) {
  const size_t i = static_cast<size_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (i >= static_cast<size_t>(rows) * kWarp) return;
  const size_t row = i / kWarp;
  const int j = static_cast<int>(i % kWarp);
  const float* part = p.bc + row * p.nblk * kWarp + j;
  float acc = 0.0f;
  for (int b = 0; b < p.nblk; ++b) acc += part[static_cast<size_t>(b) * kWarp];
  if (j < N) {
    p.dB[row * N + j] = acc;
  } else {
    p.dC[row * N + j - N] = acc;
  }
}

size_t ckpt_floats(int G, int L, int d, int n) {
  return static_cast<size_t>(G) * ((L + kChunk - 1) / kChunk) * n * d;
}

template <int N, typename T, typename TD>
int launch(Args p, int G, cudaStream_t stream) {
  scan_bwd_kernel<N, T, TD><<<dim3(p.nblk, G), kWarp, 0, stream>>>(p);
  int err = static_cast<int>(cudaGetLastError());
  if (err != 0) return err;
  const size_t threads = static_cast<size_t>(G) * p.L * kWarp;
  reduce_bc_kernel<N><<<static_cast<unsigned>((threads + 255) / 256), 256, 0, stream>>>(p, G * p.L);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Floats of workspace that selective_scan_bwd needs for these shapes.
extern "C" long long selective_scan_bwd_workspace_floats(int G, int L, int d, int n) {
  const size_t nblk = (d + kWarp - 1) / kWarp;
  return static_cast<long long>(ckpt_floats(G, L, d, n) +
                                static_cast<size_t>(G) * L * nblk * kWarp);
}

// Type codes: 0 = fp32, 1 = bf16 (of u, z, B, C, g; and of delta). `z` and
// `dz` are null for an ungated scan. Every output is fp32 and contiguous;
// dA is (G, d, n) and dD (G, d). Returns the first cudaError_t of the two
// launches that is not 0, or -1 for a combination that is not built.
extern "C" int selective_scan_bwd(const void* u, const void* delta, const void* A,
                                  const void* B, const void* C, const void* D,
                                  const void* z, const void* g, float* du,
                                  float* ddelta, float* dz, float* dB, float* dC,
                                  float* dA, float* dD, float* workspace, int G,
                                  int L, int d, int n, int dtype, int delta_dtype,
                                  void* stream) {
  if (n != 16 || (z == nullptr) != (dz == nullptr)) return -1;
  Args p{u, delta, A, B, C, D, z, g, du, ddelta, dz, dB, dC, dA, dD,
         workspace, workspace + ckpt_floats(G, L, d, n), L, d, (d + kWarp - 1) / kWarp};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0 && delta_dtype == 0) return launch<16, float, float>(p, G, s);
  if (dtype == 1 && delta_dtype == 1) return launch<16, __nv_bfloat16, __nv_bfloat16>(p, G, s);
  if (dtype == 1 && delta_dtype == 0) return launch<16, __nv_bfloat16, float>(p, G, s);
  return -1;
}
