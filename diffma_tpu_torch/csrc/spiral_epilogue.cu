// The Spiral block's tail for Hopper (sm_90a): the learned mix of the two
// branch outputs and the gated residual.
//
// Replaces the TPU kernel diffma_tpu/ops/fused_ssd.py::_spiral_epilogue_kernel
// (driven by _spiral_block_fwd_impl). Per token row, with the branch outputs
// o0, o1 (h,), the block's input x (h,) and the adaLN gate of its batch
// element:
//
//     n      = LayerNorm([o0 | o1]) * an_w + an_b         (2h,), statistics over 2h
//     hmid   = silu(n . fc1_w^T + fc1_b)                  (h,)
//     alpha  = sigmoid(hmid . fc2_w + fc2_b)              scalar
//     out    = x + gate * (alpha * o0 + (1 - alpha) * o1)
//
// fp32 on the CUDA cores (no TF32). Bound on an H100 SXM (67 TFLOP/s fp32,
// 3.35 TB/s): at batch 1, L = 196, h = 512 the 2h -> h product is 0.21 GFLOP,
// 3.1 us, against 2.1 MB of fc1_w and 1.6 MB of rows, 1.1 us: operations
// bound it.
//
// Design: three kernels on the stream, the intermediates in a workspace the
// caller allocates (spiral_epilogue_workspace_floats).
// 1. stats: one warp per row; mean and 1 / sqrt(var + eps) over the virtual
//    concat, the variance as the mean of squared deviations.
// 2. fc1: gemm_nt.cuh's GEMM, whose A-tile loader normalises as it reads o0
//    or o1 (the concat is never written); 16 x 64 tiles, so that batch 1's
//    196 rows make 104 blocks (with 32 x 64 tiles, 56 blocks on 132 SMs, the
//    call took twice as long).
// 3. tail: one block per row; bias + SiLU + the h -> 1 product reduced over
//    the block, the sigmoid, the mix and the gated residual.
// The TPU kernel's (B, 8, h) packing of shift/scale/gate and its 8-row
// padding of L exist for VMEM's tiling; here the gate is a pointer with a row
// stride and rows are exact.

#include <cuda_runtime.h>
#include <stdint.h>

#include "gemm_nt.cuh"

namespace {

constexpr int kStatsWarps = 4;
constexpr int kTailThreads = 128;

struct Params {
  const float* o0;     // (B * L, h)
  const float* o1;     // (B * L, h)
  const float* x;      // (B * L, h)
  const float* gate;   // (B, h), rows gate_stride apart
  const float* an_w;   // (2h,)
  const float* an_b;   // (2h,)
  const float* fc1_w;  // (h, 2h)
  const float* fc1_b;  // (h,)
  const float* fc2_w;  // (h,)
  const float* fc2_b;  // (1,)
  float* out;          // (B * L, h)
  float* stats;        // (B * L, 2): mean, 1 / sqrt(var + eps)
  float* hpre;         // (B * L, h): n . fc1_w^T
  int rows, L, h, gate_stride;
  float ln_eps;
};

__device__ __forceinline__ float silu(float x) { return x / (1.0f + expf(-x)); }

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// 1. grid ceil(rows / kStatsWarps), one warp per row.
__global__ void __launch_bounds__(kStatsWarps * 32) stats_kernel(const Params p) {
  const int row = blockIdx.x * kStatsWarps + threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  if (row >= p.rows) return;
  const int h = p.h;
  const float* o0 = p.o0 + static_cast<size_t>(row) * h;
  const float* o1 = p.o1 + static_cast<size_t>(row) * h;
  float s = 0.0f;
  for (int c = lane; c < h; c += 32) s += o0[c] + o1[c];
  const float mu = warp_sum(s) / (2 * h);
  float q = 0.0f;
  for (int c = lane; c < h; c += 32) {
    const float c0 = o0[c] - mu, c1 = o1[c] - mu;
    q += c0 * c0 + c1 * c1;
  }
  const float var = warp_sum(q) / (2 * h);
  if (lane == 0) {
    p.stats[2 * row] = mu;
    p.stats[2 * row + 1] = rsqrtf(var + p.ln_eps);
  }
}

struct Fc1 {  // hpre = LayerNorm([o0 | o1]) . fc1_w^T
  struct Row {
    const float* o0;
    const float* o1;
    float mu, r;
  };
  const float* o0;
  const float* o1;
  const float* stats;
  const float* an_w;
  const float* an_b;
  const float* w;
  float* c;
  int h, rows, cols, depth;
  __device__ Fc1(const Params& p, int)
      : o0(p.o0), o1(p.o1), stats(p.stats), an_w(p.an_w), an_b(p.an_b), w(p.fc1_w),
        c(p.hpre), h(p.h), rows(p.rows), cols(p.h), depth(2 * p.h) {}
  __device__ Row row(int i) const {
    return {o0 + static_cast<size_t>(i) * h, o1 + static_cast<size_t>(i) * h, stats[2 * i],
            stats[2 * i + 1]};
  }
  __device__ float a(const Row& r, int k) const {
    const float v = k < h ? r.o0[k] : r.o1[k - h];
    return (v - r.mu) * r.r * an_w[k] + an_b[k];
  }
};

// 3. grid rows.
__global__ void __launch_bounds__(kTailThreads) tail_kernel(const Params p) {
  __shared__ float red[kTailThreads / 32];
  const int row = blockIdx.x;
  const int h = p.h;
  const float* hpre = p.hpre + static_cast<size_t>(row) * h;
  float s = 0.0f;
  for (int c = threadIdx.x; c < h; c += kTailThreads) {
    s = fmaf(silu(hpre[c] + p.fc1_b[c]), p.fc2_w[c], s);
  }
  s = warp_sum(s);
  if (threadIdx.x % 32 == 0) red[threadIdx.x / 32] = s;
  __syncthreads();
  float logit = p.fc2_b[0];
  for (int w = 0; w < kTailThreads / 32; ++w) logit += red[w];
  const float alpha = 1.0f / (1.0f + expf(-logit));
  const float* o0 = p.o0 + static_cast<size_t>(row) * h;
  const float* o1 = p.o1 + static_cast<size_t>(row) * h;
  const float* x = p.x + static_cast<size_t>(row) * h;
  const float* gate = p.gate + static_cast<size_t>(row / p.L) * p.gate_stride;
  float* out = p.out + static_cast<size_t>(row) * h;
  for (int c = threadIdx.x; c < h; c += kTailThreads) {
    out[c] = x[c] + gate[c] * (alpha * o0[c] + (1.0f - alpha) * o1[c]);
  }
}

}  // namespace

// Floats of workspace that spiral_epilogue_fwd needs for these shapes.
extern "C" long long spiral_epilogue_workspace_floats(int B, int L, int h) {
  return static_cast<long long>(B) * L * (h + 2);
}

// `ptrs` holds the 11 pointers of struct Params from o0 to out, in that
// order; all fp32; gate's rows lie `gate_stride` floats apart, everything
// else is contiguous. Launches three kernels on `stream`; returns the first
// cudaError_t that is not 0, or -1 for shapes that are not built.
extern "C" int spiral_epilogue_fwd(void* const* ptrs, void* workspace, int B, int L, int h,
                                   int gate_stride, float ln_eps, void* stream) {
  if (B < 1 || L < 1 || h < 1) return -1;
  Params p{};
  p.o0 = static_cast<const float*>(ptrs[0]);
  p.o1 = static_cast<const float*>(ptrs[1]);
  p.x = static_cast<const float*>(ptrs[2]);
  p.gate = static_cast<const float*>(ptrs[3]);
  p.an_w = static_cast<const float*>(ptrs[4]);
  p.an_b = static_cast<const float*>(ptrs[5]);
  p.fc1_w = static_cast<const float*>(ptrs[6]);
  p.fc1_b = static_cast<const float*>(ptrs[7]);
  p.fc2_w = static_cast<const float*>(ptrs[8]);
  p.fc2_b = static_cast<const float*>(ptrs[9]);
  p.out = static_cast<float*>(ptrs[10]);
  p.rows = B * L;
  p.stats = static_cast<float*>(workspace);
  p.hpre = p.stats + 2 * static_cast<size_t>(p.rows);
  p.L = L;
  p.h = h;
  p.gate_stride = gate_stride;
  p.ln_eps = ln_eps;
  cudaStream_t st = static_cast<cudaStream_t>(stream);

  stats_kernel<<<(p.rows + kStatsWarps - 1) / kStatsWarps, kStatsWarps * 32, 0, st>>>(p);
  int err = static_cast<int>(cudaGetLastError());
  if (err != 0) return err;
  err = launch_gemm<16, 64, 16, 1, 4, Fc1>(p, p.rows, h, 1, st);
  if (err != 0) return err;
  tail_kernel<<<p.rows, kTailThreads, 0, st>>>(p);
  return static_cast<int>(cudaGetLastError());
}
