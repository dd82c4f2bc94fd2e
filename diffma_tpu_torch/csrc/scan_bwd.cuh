// The Mamba-1 selective scan's backward for one (sequence, channel) thread,
// kernel B's (selective_scan_bwd.cu). It is the recurrence of the TPU kernel
// diffma_tpu/ops/selective_scan.py::_bwd_kernel. (Kernel D, the fused
// mixer's backward, has a scan adjoint of its own in fused_mixer_bwd.cu,
// four lanes per channel.) Per channel, with
// n = N states, a = A (negative), dt_t = softplus(raw_t), the forward is
//
//     h_t = exp(dt_t a) h_{t-1} + dt_t u_t B_t;  y_t = <C_t, h_t> + D u_t
//     out_t = y_t * silu(z_t)                               (z optional)
//
// and, given g_t = dL/dout_t, the backward:
//
//     dy_t = g_t silu(z_t);  dz_t = g_t y_t silu'(z_t);  dD += dy_t u_t
//     s_t  = C_t dy_t + exp(dt_{t+1} a) s_{t+1}             (adjoint state)
//     dB_t = sum_channels s_t dt_t u_t;   dC_t = sum_channels h_t dy_t
//     dA  += s_t h_{t-1} exp(dt_t a) dt_t
//     draw_t = sigmoid(raw_t) sum_n s_t (h_{t-1} exp(dt_t a) a + u_t B_t)
//     du_t = dy_t D + dt_t sum_n s_t B_t
//
// Design: one thread per channel keeps its n states, its row of A and its
// adjoint state in registers; a block is one warp of 32 channels of one
// sequence. Phase 1 runs the forward and stores the state at the entry of
// every kChunk-step chunk (a checkpoint, through IO::save_ckpt). Phase 2
// walks the chunks backwards: it recomputes the chunk's states from its
// checkpoint into shared memory, then sweeps the chunk in reverse. The time
// loop runs t < L exactly, so there is no padding to mask. dB_t and dC_t sum
// over channels: each step the warp reduces its 2n partial sums with a
// recursive-halving reduce-scatter (31 shuffles), after which lane j holds
// the warp's sum of value j, and IO::put_bc writes it as a per-block partial
// that a second pass sums over blocks. The order of every sum is fixed, so
// the result is deterministic.
//
// The IO class gives a thread its inputs and takes its outputs:
//   bool gated();                 z given
//   void stage(int t0, int steps) block-wide: make steps t0 .. t0+steps-1
//                                 readable (all 32 threads call it)
//   float delta(s), u(s), z(s), g(s)   step t0 + s of this thread's channel
//                                 (0 for a thread past the last channel)
//   const float* B(s), C(s)       the staged n values of step t0 + s
//   void save_ckpt(q, h), load_ckpt(q, h)   the state at chunk q's entry
//   void put(s, du, draw, dz, y_gated)      this channel's results at step s
//   void put_bc(s, v)             lane j's reduced value: dB[j] for j < n,
//                                 else dC[j - n]

#pragma once

#include <cuda_runtime.h>

namespace scan_bwd {

constexpr int kWarp = 32;   // threads per block: one warp, one channel each
constexpr int kChunk = 16;  // steps between checkpoints

// softplus(x) = log(1 + exp(x)) without overflow: max(x, 0) + log1p(exp(-|x|)).
__device__ __forceinline__ float softplus(float x) {
  return fmaxf(x, 0.0f) + log1pf(expf(-fabsf(x)));
}

__device__ __forceinline__ float sigmoid(float x) { return 1.0f / (1.0f + expf(-x)); }

// Recursive-halving reduce-scatter over the warp: on return, lane j holds the
// sum over all 32 lanes of their v[j]. At each level a lane keeps the half of
// its values whose index has the lane's bit, and adds its partner's copy.
__device__ __forceinline__ float warp_reduce_scatter(float (&v)[kWarp]) {
  const int lane = threadIdx.x % kWarp;
#pragma unroll
  for (int off = kWarp / 2; off >= 1; off /= 2) {
    const bool upper = (lane & off) != 0;
#pragma unroll
    for (int i = 0; i < off; ++i) {
      const float send = upper ? v[i] : v[i + off];
      const float keep = upper ? v[i + off] : v[i];
      v[i] = keep + __shfl_xor_sync(0xffffffffu, send, off);
    }
  }
  return v[0];
}

// The whole backward of one thread's channel over L steps. `a` is the
// channel's row of A, `Dc` its skip weight (both 0 past the last channel);
// on return dA and dD hold the channel's sums over the L steps.
template <int N, class IO>
__device__ __forceinline__ void sweep(IO& io, const float (&a)[N], float Dc, int L,
                                      float (&dA)[N], float& dD) {
  static_assert(2 * N == kWarp, "dB and dC reduce as one warp-wide reduce-scatter");
  __shared__ float sH[kChunk][N][kWarp];  // the chunk's states, per thread
  __shared__ float sRaw[kChunk][kWarp];   // the chunk's raw deltas
  const int lane = threadIdx.x;
  const int nq = (L + kChunk - 1) / kChunk;

  // Phase 1: the forward, storing each chunk's entry state.
  float h[N];
#pragma unroll
  for (int k = 0; k < N; ++k) {
    h[k] = 0.0f;
    dA[k] = 0.0f;
  }
  dD = 0.0f;
  for (int q = 0; q < nq; ++q) {
    const int t0 = q * kChunk, steps = min(kChunk, L - t0);
    io.save_ckpt(q, h);
    __syncthreads();  // the previous chunk's staging is no longer read
    io.stage(t0, steps);
    __syncthreads();
    for (int s = 0; s < steps; ++s) {
      const float dt = softplus(io.delta(s));
      const float du = dt * io.u(s);
      const float* Bs = io.B(s);
#pragma unroll
      for (int k = 0; k < N; ++k) h[k] = expf(dt * a[k]) * h[k] + du * Bs[k];
    }
  }

  // Phase 2: the chunks in reverse; `carry` is exp(dt_{t+1} a) s_{t+1}.
  float carry[N];
#pragma unroll
  for (int k = 0; k < N; ++k) carry[k] = 0.0f;
  for (int q = nq - 1; q >= 0; --q) {
    const int t0 = q * kChunk, steps = min(kChunk, L - t0);
    __syncthreads();
    io.stage(t0, steps);
    __syncthreads();
    float h0[N];
    io.load_ckpt(q, h0);
#pragma unroll
    for (int k = 0; k < N; ++k) h[k] = h0[k];
    for (int s = 0; s < steps; ++s) {
      const float raw = io.delta(s);
      sRaw[s][lane] = raw;
      const float dt = softplus(raw);
      const float du = dt * io.u(s);
      const float* Bs = io.B(s);
#pragma unroll
      for (int k = 0; k < N; ++k) {
        h[k] = expf(dt * a[k]) * h[k] + du * Bs[k];
        sH[s][k][lane] = h[k];
      }
    }
    for (int s = steps - 1; s >= 0; --s) {
      const float raw = sRaw[s][lane];
      const float dt = softplus(raw);
      const float uv = io.u(s);
      const float gv = io.g(s);
      const float* Bs = io.B(s);
      const float* Cs = io.C(s);
      float y = Dc * uv;
#pragma unroll
      for (int k = 0; k < N; ++k) y += Cs[k] * sH[s][k][lane];
      float dy = gv, dz = 0.0f, yg = y;
      if (io.gated()) {
        const float zv = io.z(s);
        const float sz = sigmoid(zv);
        const float silu = zv * sz;
        dz = gv * y * sz * (1.0f + zv * (1.0f - sz));
        dy = gv * silu;
        yg = y * silu;
      }
      dD += dy * uv;
      float v[kWarp];
      float ddt = 0.0f, gB = 0.0f;
#pragma unroll
      for (int k = 0; k < N; ++k) {
        const float hp = s > 0 ? sH[s - 1][k][lane] : h0[k];
        const float gk = Cs[k] * dy + carry[k];
        const float ak = expf(dt * a[k]);
        const float gha = gk * hp * ak;
        dA[k] += gha * dt;
        ddt += gha * a[k] + gk * uv * Bs[k];
        gB += gk * Bs[k];
        carry[k] = ak * gk;
        v[k] = gk * dt * uv;
        v[N + k] = sH[s][k][lane] * dy;
      }
      io.put(s, dy * Dc + dt * gB, ddt * sigmoid(raw), dz, yg);
      io.put_bc(s, warp_reduce_scatter(v));
    }
  }
}

}  // namespace scan_bwd
