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
// Per channel, with n = 16 states, a = A (negative), dt_t = softplus(raw_t)
// (raw = delta), the forward is
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
// Bound on an H100 SXM (3.35 TB/s, 67 TFLOP/s fp32 outside the tensor
// cores). At the composable training path's shapes for DiffMa-B/2 at batch 8
// (G = 24 = 8 x 3 streams, L = 196, d = 1024, n = 16, fp32) it must read u,
// delta, z, g and write du, ddelta, dz, seven (G, L, d) arrays, 136 MB with
// B, C and their gradients, or 41 us at the memory rate; the operations the
// function needs, about 1.87 GFLOP (the forward once and the adjoint, about
// 23 per state and 20 per channel and step), take 28 us at the fp32 rate. So
// bytes bound it. What holds a design back is the dependent chain of 3 x 196
// steps per channel (forward, chunk recompute, reverse).
//
// Design: kernel D's scan adjoint (fused_mixer_bwd.cu, scan_bwd_kernel) for
// this layout.
// * Four lanes per channel, lane j holding states j, j + 4, j + 8, j + 12,
//   so the sums over the states of a step (y, the parts of d raw, sum_n s_t
//   B_t) are two shuffles, and the chain's latency hides behind 16 warps an
//   SM. A block is 8 warps, 64 channels of one sequence (384 blocks at the
//   shapes above), at most 128 registers a thread.
// * The four lanes of a channel load a 16-step chunk's raw delta, u, z and
//   g, four steps each, and pass them round by shuffles; B and C are staged
//   once for the block. The next chunk's loads (and its checkpoint) are
//   issued before the current chunk runs, so no step waits on device memory.
// * Each step's transcendentals run once, by the lane that loaded the step,
//   when the chunk is taken up: softplus(raw) and sigmoid(raw) from one exp,
//   and the gate's silu(z) and silu'(z) folded into dy and dz's factor. Each
//   decay exp(dt a) is one ex2.approx.ftz of dt a log2(e) (a decay under
//   2^-126 is 0, as it is to the state in fp32 anyway).
// * Three launches. scan_ckpt_kernel runs the forward and stores the state
//   at every chunk's entry (a checkpoint); scan_bwd_kernel walks the chunks
//   backwards, recomputing a chunk's 16 states into shared memory from its
//   checkpoint, with y, and sweeping it in reverse; reduce_bc_kernel sums
//   dB and dC. The profiler so times each stage on its own.
// * Each step's dB and dC reduce over the warp's 8 channels by a
//   recursive-halving reduce-scatter, then over the block's 8 warps in
//   shared memory, so one partial per block and step goes out (d / 64 a
//   row), and reduce_bc_kernel sums them in order. Nothing uses atomics:
//   two calls give the same bits.
// * t < L exactly: no dt = -20 padding; any d (the last block's spare
//   channels load nothing and store nothing).
// D keeps its own adjoint: it reads dt (not raw delta) through a token index
// and takes exact exp2f decays; moving it here would change its bits.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kN = 16;                      // d_state
constexpr int kWarp = 32;
constexpr int kLPC = 4;                     // lanes per channel
constexpr int kSPL = kN / kLPC;             // states per lane
constexpr int kCPW = kWarp / kLPC;          // channels per warp
constexpr int kWarps = 8;                   // warps of a block
constexpr int kThreads = kWarps * kWarp;
constexpr int kCh = kWarps * kCPW;          // channels of a block
constexpr int kChunk = 16;                  // steps between checkpoints
constexpr int kMine = kChunk / kLPC;        // steps of a chunk a lane loads
constexpr int kSmem = kChunk * kN * kCh * static_cast<int>(sizeof(float));  // the chunk's states
static_assert(kCPW == 2 * kSPL, "dB and dC of a lane's states reduce as one scatter over channels");
static_assert(kChunk * kN == kThreads, "a thread stages one value of B and one of C a chunk");
constexpr float kLog2e = 1.4426950408889634f;
constexpr float kLn2 = 0.6931471805599453f;

__device__ __forceinline__ float to_float(float x) { return x; }
__device__ __forceinline__ float to_float(__nv_bfloat16 x) { return __bfloat162float(x); }

// 2^x; results under 2^-126 flush to 0.
__device__ __forceinline__ float ex2(float x) {
  float r;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(r) : "f"(x));
  return r;
}

// The sum over a channel's kLPC lanes, on every one of them.
__device__ __forceinline__ float channel_sum(float v) {
#pragma unroll
  for (int off = 1; off < kLPC; off *= 2) v += __shfl_xor_sync(0xffffffffu, v, off);
  return v;
}

// Step s's value of a per-step quantity that lane j of each channel holds for
// steps j, j + kLPC, ... (v[s / kLPC] on lane s % kLPC), on every lane.
__device__ __forceinline__ float from_step(const float (&v)[kMine], int s) {
  const int lane = threadIdx.x % kWarp;
  return __shfl_sync(0xffffffffu, v[s / kLPC], (lane & ~(kLPC - 1)) | (s % kLPC));
}

// Recursive-halving reduce-scatter over the channels of a warp (lane bits 2
// to 4: lane = 4 * channel + j): on return, the lane of channel c holds the
// sum over the warp's 8 channels of their v[c]. At each level a lane keeps
// the half of its values whose index has its channel's bit, and adds its
// partner's copy.
__device__ __forceinline__ float reduce_scatter_channels(float (&v)[kCPW]) {
  const int lane = threadIdx.x % kWarp;
#pragma unroll
  for (int half = kCPW / 2, off = kWarp / 2; half >= 1; half /= 2, off /= 2) {
    const bool upper = (lane & off) != 0;
#pragma unroll
    for (int i = 0; i < half; ++i) {
      const float send = upper ? v[i] : v[i + half];
      const float keep = upper ? v[i + half] : v[i];
      v[i] = keep + __shfl_xor_sync(0xffffffffu, send, off);
    }
  }
  return v[0];
}

struct Args {
  const void *u, *delta, *A, *B, *C, *D, *z, *g;
  float *du, *ddelta, *dz, *dB, *dC, *dA, *dD;
  float *ckpt, *bc;  // workspace: checkpoints, then dB/dC block partials
  int L, d, nblk;
};

// One chunk's loads of one thread, in flight until the chunk runs: steps j,
// j + 4, ... of its channel, one value of B and of C (step tid / 16, state
// tid % 16) and, in the reverse pass, its states at the chunk's entry.
template <typename T, typename TD>
struct Loads {
  TD raw[kMine];
  T u[kMine], z[kMine], g[kMine];
  T b, c;
  float ck[kSPL];
};

// A thread's place: lane j of channel c of sequence gi (blocks of kCh
// channels of one sequence), and its pointers.
template <typename T, typename TD>
struct Lane {
  int tid, j, chl, c, L, d, nq;
  bool active;
  const TD* delta;
  const T *u, *z, *g, *B, *C;
  float* ckpt;  // this channel's state k at chunk q's entry: ckpt[(q * kN + k) * d]

  __device__ explicit Lane(const Args& p)
      : tid(threadIdx.x), j(threadIdx.x % kLPC), chl(threadIdx.x / kLPC),
        c(blockIdx.x * kCh + threadIdx.x / kLPC), L(p.L), d(p.d),
        nq((p.L + kChunk - 1) / kChunk), active(c < p.d) {
    const size_t row0 = static_cast<size_t>(blockIdx.y) * L;
    const size_t at = row0 * d + (active ? c : 0);
    delta = static_cast<const TD*>(p.delta) + at;
    u = static_cast<const T*>(p.u) + at;
    z = static_cast<const T*>(p.z) + at;
    g = static_cast<const T*>(p.g) + at;
    B = static_cast<const T*>(p.B) + row0 * kN;
    C = static_cast<const T*>(p.C) + row0 * kN;
    ckpt = p.ckpt + static_cast<size_t>(blockIdx.y) * nq * kN * d + (active ? c : 0);
  }
  __device__ size_t ck(int q, int i) const { return (static_cast<size_t>(q) * kN + j + kLPC * i) * d; }
  // a2 = A log2(e) of this lane's states: each decay exp(dt A) is one ex2(dt a2)
  __device__ void a2_of(const Args& p, float (&a2)[kSPL]) const {
#pragma unroll
    for (int i = 0; i < kSPL; ++i) {
      a2[i] = active ? static_cast<const float*>(p.A)[static_cast<size_t>(c) * kN + j + kLPC * i] * kLog2e
                     : 0.0f;
    }
  }
  // Issue chunk q's loads into x: the forward (kAll false) needs no C, z, g
  // or checkpoint; chunk 0's checkpoint is 0.
  template <bool kAll, bool kGated>
  __device__ void fetch(Loads<T, TD>& x, int q) const {
    const int t0 = q * kChunk, steps = min(kChunk, L - t0);
    const int s_st = tid / kN, s_k = tid % kN;
    const bool sok = s_st < steps;
    x.b = sok ? B[static_cast<size_t>(t0 + s_st) * kN + s_k] : T{};
    if constexpr (kAll) x.c = sok ? C[static_cast<size_t>(t0 + s_st) * kN + s_k] : T{};
#pragma unroll
    for (int m = 0; m < kMine; ++m) {
      const int st = j + kLPC * m;
      const bool ok = st < steps && active;
      const size_t idx = static_cast<size_t>(t0 + st) * d;
      x.raw[m] = ok ? delta[idx] : TD{};
      x.u[m] = ok ? u[idx] : T{};
      if constexpr (kAll) {
        x.g[m] = ok ? g[idx] : T{};
        if constexpr (kGated) x.z[m] = ok ? z[idx] : T{};
      }
    }
    if constexpr (kAll) {
#pragma unroll
      for (int i = 0; i < kSPL; ++i) x.ck[i] = (active && q > 0) ? ckpt[ck(q, i)] : 0.0f;
    }
  }
};

// softplus(raw) = max(raw, 0) + log1p(exp(-|raw|)), and sigmoid(raw) into
// sig, from one exp.
__device__ __forceinline__ float dt_of(float raw, float& sig) {
  const float e = expf(-fabsf(raw));
  const float r = 1.0f / (1.0f + e);
  sig = raw >= 0.0f ? r : e * r;
  return fmaxf(raw, 0.0f) + log1pf(e);
}

// The forward to the checkpoints: the state at the entry of chunks 1 ..
// nq - 1. grid (nblk, G), kThreads threads.
template <typename T, typename TD>
__global__ void __launch_bounds__(kThreads) scan_ckpt_kernel(const Args p) {
  __shared__ float sB[kChunk][kN];
  const Lane<T, TD> ln(p);
  float a2[kSPL], h[kSPL];
  ln.a2_of(p, a2);
#pragma unroll
  for (int i = 0; i < kSPL; ++i) h[i] = 0.0f;
  Loads<T, TD> x;
  ln.template fetch<false, false>(x, 0);
  for (int q = 0; q + 1 < ln.nq; ++q) {  // a chunk before the last is whole
    __syncthreads();  // the previous chunk's staging is no longer read
    sB[ln.tid / kN][ln.tid % kN] = to_float(x.b);
    float dtm[kMine], um[kMine], sig;
#pragma unroll
    for (int m = 0; m < kMine; ++m) {
      dtm[m] = dt_of(to_float(x.raw[m]), sig);
      um[m] = to_float(x.u[m]);
    }
    __syncthreads();
    if (q + 2 < ln.nq) ln.template fetch<false, false>(x, q + 1);  // in flight during this chunk
#pragma unroll
    for (int st = 0; st < kChunk; ++st) {
      const float dt = from_step(dtm, st), du = dt * from_step(um, st);
#pragma unroll
      for (int i = 0; i < kSPL; ++i) h[i] = ex2(dt * a2[i]) * h[i] + du * sB[st][ln.j + kLPC * i];
    }
    if (ln.active) {
#pragma unroll
      for (int i = 0; i < kSPL; ++i) ln.ckpt[ln.ck(q + 1, i)] = h[i];
    }
  }
}

// The reverse pass: each chunk's states from its checkpoint, then the sweep.
// grid (nblk, G), kThreads threads, kSmem bytes of dynamic shared memory.
template <typename T, typename TD, bool kGated>
__global__ void __launch_bounds__(kThreads, 2) scan_bwd_kernel(const Args p) {
  // The chunk's states: state j + kLPC i of block channel ch at step st is
  // sH[((st * kSPL + i) * kCh + ch) * kLPC + j], so a warp's lanes read and
  // write consecutive words.
  extern __shared__ float sH[];
  __shared__ float sB[kChunk][kN];
  __shared__ float sC[kChunk][kN];
  __shared__ float sBC[kWarps][kChunk][kWarp];  // each warp's dB/dC sums per step

  const Lane<T, TD> ln(p);
  const int tid = ln.tid, warp = tid / kWarp, lane = tid % kWarp, j = ln.j, chl = ln.chl;
  const int d = ln.d, nq = ln.nq;
  const bool active = ln.active;
  const size_t row0 = static_cast<size_t>(blockIdx.y) * ln.L;
  const size_t at = row0 * d + (active ? ln.c : 0);
  float* du_p = p.du + at;
  float* ddelta_p = p.ddelta + at;
  float* dz_p = p.dz + at;
  float* bc = p.bc + row0 * p.nblk * kWarp;
  float a2[kSPL];
  ln.a2_of(p, a2);
  const float Dc = active ? static_cast<const float*>(p.D)[ln.c] : 0.0f;

  // `carry` is exp(dt_{t+1} a) s_{t+1}
  float carry[kSPL], dA[kSPL], dD = 0.0f;
#pragma unroll
  for (int i = 0; i < kSPL; ++i) {
    carry[i] = 0.0f;
    dA[i] = 0.0f;
  }
  Loads<T, TD> x;
  ln.template fetch<true, kGated>(x, nq - 1);
  for (int q = nq - 1; q >= 0; --q) {
    const int t0 = q * kChunk, steps = min(kChunk, ln.L - t0);
    __syncthreads();  // the previous chunk's staging and dB/dC sums are no longer read
    sB[tid / kN][tid % kN] = to_float(x.b);
    sC[tid / kN][tid % kN] = to_float(x.c);
    // this lane's steps: dt, sigmoid(raw), u, dy and dz's factor g silu'(z)
    float dtm[kMine], sgm[kMine], um[kMine], dym[kMine], dzf[kMine], ym[kMine];
#pragma unroll
    for (int m = 0; m < kMine; ++m) {
      dtm[m] = dt_of(to_float(x.raw[m]), sgm[m]);
      um[m] = to_float(x.u[m]);
      const float gv = to_float(x.g[m]);
      dym[m] = gv;
      dzf[m] = 0.0f;
      if constexpr (kGated) {
        const float zv = to_float(x.z[m]);
        const float sz = 1.0f / (1.0f + expf(-zv));
        dym[m] = gv * zv * sz;
        dzf[m] = gv * sz * (1.0f + zv * (1.0f - sz));
      }
      dD = fmaf(dym[m], um[m], dD);
      ym[m] = 0.0f;
    }
    float h0[kSPL], h[kSPL];
#pragma unroll
    for (int i = 0; i < kSPL; ++i) h[i] = h0[i] = x.ck[i];
    __syncthreads();
    if (q > 0) ln.template fetch<true, kGated>(x, q - 1);  // in flight during this chunk

#pragma unroll
    for (int st = 0; st < kChunk; ++st) {  // the chunk's states, and y
      if (st >= steps) break;
      const float dt = from_step(dtm, st), u = from_step(um, st), du = dt * u;
      float yp = 0.0f;
#pragma unroll
      for (int i = 0; i < kSPL; ++i) {
        const int k = j + kLPC * i;
        h[i] = ex2(dt * a2[i]) * h[i] + du * sB[st][k];
        sH[((st * kSPL + i) * kCh + chl) * kLPC + j] = h[i];
        yp = fmaf(sC[st][k], h[i], yp);
      }
      const float y = channel_sum(yp) + Dc * u;
      if (j == st % kLPC) ym[st / kLPC] = y;
    }
#pragma unroll
    for (int st = kChunk - 1; st >= 0; --st) {
      if (st >= steps) continue;
      const float dt = from_step(dtm, st), u = from_step(um, st), dy = from_step(dym, st);
      const float dtu = dt * u;
      float v[kCPW];                // dB (states j + kLPC i), then dC
      float dda = 0.0f, gB = 0.0f;  // this lane's parts of sum_n s h_{t-1} exp(dt a) a2, sum_n s B
#pragma unroll
      for (int i = 0; i < kSPL; ++i) {
        const int k = j + kLPC * i;
        const float hp = st > 0 ? sH[(((st - 1) * kSPL + i) * kCh + chl) * kLPC + j] : h0[i];
        const float gk = fmaf(sC[st][k], dy, carry[i]);
        const float ak = ex2(dt * a2[i]);
        const float gha = gk * hp * ak;
        dA[i] = fmaf(gha, dt, dA[i]);
        dda = fmaf(gha, a2[i], dda);
        gB = fmaf(gk, sB[st][k], gB);
        carry[i] = ak * gk;
        v[i] = gk * dtu;
        v[kSPL + i] = sH[((st * kSPL + i) * kCh + chl) * kLPC + j] * dy;
      }
      dda = channel_sum(dda);
      gB = channel_sum(gB);
      if (active && j == st % kLPC) {  // the lane that loaded step st stores it
        const int m = st / kLPC;
        const size_t idx = static_cast<size_t>(t0 + st) * d;
        du_p[idx] = fmaf(dym[m], Dc, dtm[m] * gB);
        ddelta_p[idx] = fmaf(dda, kLn2, um[m] * gB) * sgm[m];  // a = a2 ln 2
        if constexpr (kGated) dz_p[idx] = ym[m] * dzf[m];
      }
      // the warp's sums over its channels: lane (channel ci, j) ends with
      // dB of state j + kLPC ci for ci < kSPL, else dC of state j + kLPC (ci - kSPL)
      const float sum = reduce_scatter_channels(v);
      const int ci = lane / kLPC;
      sBC[warp][st][(ci < kSPL ? 0 : kN) + j + kLPC * (ci % kSPL)] = sum;
    }
    __syncthreads();
    // one dB/dC partial per block and step: the warps' sums, in order
    for (int i = tid; i < steps * kWarp; i += kThreads) {
      const int st = i / kWarp, e = i % kWarp;
      float acc = sBC[0][st][e];
#pragma unroll
      for (int w = 1; w < kWarps; ++w) acc += sBC[w][st][e];
      bc[(static_cast<size_t>(t0 + st) * p.nblk + blockIdx.x) * kWarp + e] = acc;
    }
  }
  dD = channel_sum(dD);
  if (active) {
    float* dA_p = p.dA + (static_cast<size_t>(blockIdx.y) * d + ln.c) * kN;
#pragma unroll
    for (int i = 0; i < kSPL; ++i) dA_p[j + kLPC * i] = dA[i];
    if (j == 0) p.dD[static_cast<size_t>(blockIdx.y) * d + ln.c] = dD;
  }
}

// dB[row, k] and dC[row, k] (row = g * L + t): the sums of the per-block
// partials, over the blocks in order.
__global__ void reduce_bc_kernel(const Args p, int rows) {
  const size_t i = static_cast<size_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (i >= static_cast<size_t>(rows) * kWarp) return;
  const size_t row = i / kWarp;
  const int j = static_cast<int>(i % kWarp);
  const float* part = p.bc + row * p.nblk * kWarp + j;
  float acc = 0.0f;
  for (int b = 0; b < p.nblk; ++b) acc += part[static_cast<size_t>(b) * kWarp];
  if (j < kN) {
    p.dB[row * kN + j] = acc;
  } else {
    p.dC[row * kN + j - kN] = acc;
  }
}

size_t ckpt_floats(int G, int L, int d) {
  return static_cast<size_t>(G) * ((L + kChunk - 1) / kChunk) * kN * d;
}

template <typename T, typename TD, bool kGated>
int launch_reverse(const Args& p, int G, cudaStream_t stream) {
  static const cudaError_t attr = cudaFuncSetAttribute(
      scan_bwd_kernel<T, TD, kGated>, cudaFuncAttributeMaxDynamicSharedMemorySize, kSmem);
  if (attr != cudaSuccess) return static_cast<int>(attr);
  scan_bwd_kernel<T, TD, kGated><<<dim3(p.nblk, G), kThreads, kSmem, stream>>>(p);
  return static_cast<int>(cudaGetLastError());
}

template <typename T, typename TD>
int launch(const Args& p, int G, cudaStream_t stream) {
  scan_ckpt_kernel<T, TD><<<dim3(p.nblk, G), kThreads, 0, stream>>>(p);
  int err = static_cast<int>(cudaGetLastError());
  if (err == 0) {
    err = p.z != nullptr ? launch_reverse<T, TD, true>(p, G, stream)
                         : launch_reverse<T, TD, false>(p, G, stream);
  }
  if (err != 0) return err;
  const size_t threads = static_cast<size_t>(G) * p.L * kWarp;
  reduce_bc_kernel<<<static_cast<unsigned>((threads + 255) / 256), 256, 0, stream>>>(p, G * p.L);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Floats of workspace that selective_scan_bwd needs for these shapes.
extern "C" long long selective_scan_bwd_workspace_floats(int G, int L, int d, int n) {
  const size_t nblk = (d + kCh - 1) / kCh;
  return static_cast<long long>(ckpt_floats(G, L, d) + static_cast<size_t>(G) * L * nblk * kWarp);
}

// Type codes: 0 = fp32, 1 = bf16 (of u, z, B, C, g; and of delta). `z` and
// `dz` are null for an ungated scan. Every output is fp32 and contiguous;
// dA is (G, d, n) and dD (G, d). Returns the first cudaError_t of the
// launches that is not 0, or -1 for a combination that is not built.
extern "C" int selective_scan_bwd(const void* u, const void* delta, const void* A,
                                  const void* B, const void* C, const void* D,
                                  const void* z, const void* g, float* du,
                                  float* ddelta, float* dz, float* dB, float* dC,
                                  float* dA, float* dD, float* workspace, int G,
                                  int L, int d, int n, int dtype, int delta_dtype,
                                  void* stream) {
  if (n != kN || (z == nullptr) != (dz == nullptr)) return -1;
  Args p{u, delta, A, B, C, D, z, g, du, ddelta, dz, dB, dC, dA, dD,
         workspace, workspace + ckpt_floats(G, L, d), L, d, (d + kCh - 1) / kCh};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0 && delta_dtype == 0) return launch<float, float>(p, G, s);
  if (dtype == 1 && delta_dtype == 1) return launch<__nv_bfloat16, __nv_bfloat16>(p, G, s);
  if (dtype == 1 && delta_dtype == 0) return launch<__nv_bfloat16, float>(p, G, s);
  return -1;
}
