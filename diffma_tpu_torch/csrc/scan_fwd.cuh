// The Mamba-1 selective scan's forward, chunked over the warps of a block,
// for kernels A (selective_scan_fwd.cu) and H (fused_mamba_fwd.cu). Per
// stream g (L steps) and channel c, with n = 16 states:
//
//     h_t = exp(dt_t A) h_{t-1} + dt_t u_t B_t
//     y_t = (<C_t, h_t> + D u_t) * silu(z_t)                 (z optional)
//
// The state and the arithmetic are fp32. A stream's steps depend on each
// other, so a block that runs them in order waits on the chain; this is the
// design of kernel C's scan (fused_mixer_fwd.cu), in a form that a loader
// policy adapts to each kernel's layout.
//
// * A block is 32 channels (its lanes) of one stream times `chunks` warps;
//   warp w runs steps [w len, w len + len) of the stream, len = ceil(L /
//   chunks). chunks_for picks as many chunks as keep about eight warps per
//   SM in all, with at least 8 steps a chunk: 8 at batch 1 (96 blocks for
//   A's three DiffMa-B/2 streams), 1 at the training batch.
// * Every warp but the last runs its chunk from a zero state and keeps the
//   chunk's end state and its sum of dt in shared memory. After one barrier
//   each warp folds the chunks before it, in order, h = exp(A sum dt) h +
//   h_chunk (a product of decays, never a quotient, so a wide span
//   underflows to 0 and stays finite), runs its chunk again from that entry
//   state and writes y. The first pass skips C, z and y.
// * A warp works through its chunk 8 steps at a time. It issues its lanes'
//   loads of the next 8 steps' B, C, dt, u and z (raw, into registers)
//   before it runs the current 8, so those loads fly while it computes and
//   no step waits on device memory; the first 8 of the second pass are
//   issued before the barrier and the fold. Each lane then writes its share
//   of B and C, as fp32, into the warp's shared memory, which every lane
//   reads, and converts its dt, u and z; the policy's dt_of computes there
//   (kernel A's softplus), off the chain. Batches of 8 keep a thread near
//   128 registers, so that more warps fit on an SM than with batches of 16
//   (above 200), which ran slower at the training batch.
// * Each decay is one ex2.approx.ftz (exp2 of dt a2, a2 = A log2(e) kept in
//   registers; a decay under 2^-126 is 0, as it is to the state in fp32
//   anyway), and the gate silu(z) = z / (1 + exp(-z)) takes the fast exp and
//   division, with `gated` a template parameter: exp2f's range checks and
//   the exact division's slow path, a call inside a branch, sat on every
//   step's chain and ran slower.
// * Any L, nothing padded, any d (the last block's spare lanes only load
//   nothing and store nothing).
//
// A policy `Seq` has a type Seq::Params, the kernel's argument, and is built
// per thread as Seq(params, stream, channel) with the channel clamped into
// range. It gives a2(k) and D(); the loads B(t, k) and C(t, k) (step t of
// the stream), dt(t), u(t) and z(t) (for its channel) in their storage
// types, static f(x), which converts each of those to fp32, and dt_of(x),
// which maps a converted dt to the step's dt; and store(t, y).

#pragma once

#include <cuda_runtime.h>

#include <type_traits>
#include <utility>

namespace scan_fwd {

constexpr int kN = 16;         // d_state
constexpr int kLanes = 32;     // channels of a block
constexpr int kMaxChunks = 8;  // warps of a block
constexpr int kSub = 8;        // steps a warp stages at a time
constexpr int kSMs = 132;      // H100 SXM; sets the chunk counts, so the bits do not depend on the card
constexpr float kLog2e = 1.4426950408889634f;

// 2^x; results under 2^-126 flush to 0.
__device__ __forceinline__ float ex2(float x) {
  float r;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(r) : "f"(x));
  return r;
}

// silu(z) with the fast exp and division: for z < -87, exp(-z) is inf and
// the result 0, as silu's.
__device__ __forceinline__ float silu(float x) { return __fdividef(x, 1.0f + __expf(-x)); }

constexpr int kPerLane = kSub * kN / kLanes;  // values of B (and of C) a lane stages
static_assert(kLanes % kN == 0, "a row of loads covers whole steps of B");

// One warp's shared memory: 8 steps of B and C, and its chunk's end state
// and sum of dt for the warps after it.
struct WarpSmem {
  float B[kSub][kN];
  float C[kSub][kN];
  float end[kN + 1][kLanes];
};

// 8 steps' loads of one lane, in flight until the warp runs those steps.
// Lane l stages B and C of step 2 j + l / 16, state l % 16, in b[j] and c[j].
template <class Seq>
struct Batch {
  using TB = decltype(std::declval<const Seq&>().B(0, 0));  // B's and C's storage type
  using TD = decltype(std::declval<const Seq&>().dt(0));
  using TU = decltype(std::declval<const Seq&>().u(0));  // u's and z's
  TB b[kPerLane], c[kPerLane];
  TD dt[kSub];
  TU u[kSub], z[kSub];
};

// grid (ceil(d / 32), streams), block (32, chunks), chunks * sizeof(WarpSmem)
// bytes of dynamic shared memory; kGated: y is gated by silu(z).
template <class Seq, bool kGated>
__global__ void __launch_bounds__(kLanes * kMaxChunks)
    scan_kernel(const typename Seq::Params p, int L, int d) {
  extern __shared__ float4 scan_smem[];
  WarpSmem* const all = reinterpret_cast<WarpSmem*>(scan_smem);
  WarpSmem& sw = all[threadIdx.y];

  const int lane = threadIdx.x, w = threadIdx.y, chunks = blockDim.y;
  const int c = blockIdx.x * kLanes + lane;
  const bool active = c < d;
  const Seq seq(p, blockIdx.y, active ? c : 0);
  const int len = (L + chunks - 1) / chunks;
  const int t_begin = min(L, w * len), t_end = min(L, t_begin + len);
  const int s_lane = lane / kN, k_lane = lane % kN;  // the lane's step and state in a row of B

  float a2[kN];
#pragma unroll
  for (int k = 0; k < kN; ++k) a2[k] = active ? seq.a2(k) : 0.0f;
  const float Dc = active ? seq.D() : 0.0f;

  // Issue the loads of steps t0 .. t0 + 7 (those before t_end) into x. The
  // first pass (kOut false) needs no C and no z.
  using X = Batch<Seq>;
  auto fetch = [&](auto out, X& x, int t0) {
    constexpr bool kOut = decltype(out)::value;
    const int steps = min(kSub, t_end - t0);
#pragma unroll
    for (int j = 0; j < kPerLane; ++j) {
      const int s = j * (kLanes / kN) + s_lane;
      x.b[j] = s < steps ? seq.B(t0 + s, k_lane) : typename X::TB{};
      if constexpr (kOut) x.c[j] = s < steps ? seq.C(t0 + s, k_lane) : typename X::TB{};
    }
#pragma unroll
    for (int q = 0; q < kSub; ++q) {
      const bool ok = q < steps && active;
      x.dt[q] = ok ? seq.dt(t0 + q) : typename X::TD{};
      x.u[q] = ok ? seq.u(t0 + q) : typename X::TU{};
      if constexpr (kOut && kGated) x.z[q] = ok ? seq.z(t0 + q) : typename X::TU{};
    }
  };

  // Run steps t_begin .. t_end - 1 from state h, their first 8 steps' loads
  // issued into x: the first pass sums dt, the second writes y.
  auto run = [&](auto out, X& x, float(&h)[kN], float& dt_sum) {
    constexpr bool kOut = decltype(out)::value;
    for (int t0 = t_begin; t0 < t_end; t0 += kSub) {
      const int steps = min(kSub, t_end - t0);
      __syncwarp();  // the previous staging is no longer read
#pragma unroll
      for (int j = 0; j < kPerLane; ++j) {
        const int s = j * (kLanes / kN) + s_lane;
        sw.B[s][k_lane] = Seq::f(x.b[j]);
        if constexpr (kOut) sw.C[s][k_lane] = Seq::f(x.c[j]);
      }
      float dtv[kSub], uv[kSub], zv[kSub];
#pragma unroll
      for (int q = 0; q < kSub; ++q) {
        dtv[q] = seq.dt_of(Seq::f(x.dt[q]));
        uv[q] = Seq::f(x.u[q]);
        zv[q] = 0.0f;
        if constexpr (kOut && kGated) zv[q] = Seq::f(x.z[q]);
      }
      __syncwarp();
      if (t0 + kSub < t_end) fetch(out, x, t0 + kSub);  // in flight during these 8 steps
#pragma unroll
      for (int q = 0; q < kSub; ++q) {
        if (q >= steps) break;
        const float dt = dtv[q], du = dt * uv[q];
        if constexpr (!kOut) dt_sum += dt;
        float yp[4] = {0.0f, 0.0f, 0.0f, 0.0f};
#pragma unroll
        for (int k = 0; k < kN; ++k) {
          h[k] = ex2(dt * a2[k]) * h[k] + du * sw.B[q][k];
          if constexpr (kOut) yp[k % 4] = fmaf(h[k], sw.C[q][k], yp[k % 4]);
        }
        if (kOut && active) {
          const float yv = (yp[0] + yp[1]) + (yp[2] + yp[3]) + Dc * uv[q];
          seq.store(t0 + q, kGated ? yv * silu(zv[q]) : yv);
        }
      }
    }
  };

  X x;
  float h[kN], dt_sum = 0.0f;
#pragma unroll
  for (int k = 0; k < kN; ++k) h[k] = 0.0f;
  if (w + 1 < chunks) {  // the chunk's own end state, from a zero state
    fetch(std::false_type{}, x, t_begin);
    run(std::false_type{}, x, h, dt_sum);
#pragma unroll
    for (int k = 0; k < kN; ++k) sw.end[k][lane] = h[k];
    sw.end[kN][lane] = dt_sum;
  }
  fetch(std::true_type{}, x, t_begin);  // in flight during the barrier and the fold
  __syncthreads();
  // The entry state: the chunks before this one folded in order.
#pragma unroll
  for (int k = 0; k < kN; ++k) h[k] = 0.0f;
  for (int j = 0; j < w; ++j) {
    const float span = all[j].end[kN][lane];
#pragma unroll
    for (int k = 0; k < kN; ++k) h[k] = ex2(a2[k] * span) * h[k] + all[j].end[k][lane];
  }
  run(std::true_type{}, x, h, dt_sum);
}

// Chunks per block: doubled while the launch keeps under eight warps per SM
// and each chunk at least 8 steps.
inline int chunks_for(int blocks, int L) {
  int chunks = 1;
  while (2 * chunks <= kMaxChunks && blocks * 2 * chunks <= 8 * kSMs && L >= 2 * chunks * 8) {
    chunks *= 2;
  }
  return chunks;
}

// Launch the scan of `streams` streams of L steps over d channels, gated or
// not, on `stream`; returns the launch's cudaError_t as an int.
template <class Seq>
int launch(const typename Seq::Params& p, int streams, int L, int d, bool gated,
           cudaStream_t stream) {
  const dim3 grid((d + kLanes - 1) / kLanes, streams);
  const int chunks = chunks_for(static_cast<int>(grid.x * grid.y), L);
  const dim3 block(kLanes, chunks);
  const size_t smem = chunks * sizeof(WarpSmem);
  if (gated) {
    scan_kernel<Seq, true><<<grid, block, smem, stream>>>(p, L, d);
  } else {
    scan_kernel<Seq, false><<<grid, block, smem, stream>>>(p, L, d);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace scan_fwd
