// The training step's AdamW and EMA update, masked by the step's finite flag.
//
// Replaces no TPU kernel. The JAX package leaves this update to XLA
// (diffma_tpu/train/state.py: optax's adamw, the EMA and the NaN skip's
// jnp.where), which fuses the select into the update's loop. Per fp32
// parameter, when the device flag `keep` is true:
//
//     m   = b1 m + (1 - b1) g
//     v   = b2 v + (1 - b2) g^2
//     p   = p (1 - lr wd) - lr (m / bc1) / (sqrt(v / bc2) + eps)
//     ema = decay ema + (1 - decay) p
//
// with bc1 = 1 - b1^(step + 1) and bc2 = 1 - b2^(step + 1) in fp32 from the
// tensor's fp32 step count, as torch's capturable AdamW computes them; then
// step += 1. When `keep` is false it writes nothing. A tensor without a
// gradient (g null) takes the EMA alone.
//
// Bound on an H100 SXM: bytes. It reads g, p, m, v and the EMA and writes p,
// m, v and the EMA, 36 bytes a parameter (3.2 GB a step for DiffMa-L/2's
// 89.3 M parameters, 0.96 ms at 3.35 TB/s), for about 15 flops. The update
// it replaces moved about 280 bytes a parameter: a flat snapshot of the
// state, torch's foreach AdamW and EMA, and torch.where over flat copies to
// put the state back.
//
// Design: one pass and no copy. One launch walks every tensor of the step.
// Its parameters hold the table: each tensor's pointers and size, and the
// first block of each tensor, by which a block finds its tensor (a binary
// search). The gradients are made anew by every backward, and at a CUDA
// graph's capture in the graph's pool, so each launch writes the table into
// its own parameters; a captured launch keeps them in its graph node, and a
// replay copies nothing to the device. A block updates 4096 elements of one
// tensor, each thread four 16-byte vectors of each array, every load issued
// before the first store; a tensor's last piece, and a tensor whose arrays
// are not 16-byte aligned, go element by element. Each operation rounds on
// its own (__fmul_rn and the like), as the plain version's torch operations
// do, but for the EMA's sum, one fused multiply-add as torch's add with
// alpha on the card: an EMA moves a few ulps of the weights in a few steps,
// so the order of its roundings shows against any other EMA. A second,
// small launch adds 1 to each step count, after every block of the first
// has read it.

#include <climits>
#include <cstdint>

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kVectors = 4;                      // 16-byte vectors a thread, per array
constexpr int kChunk = kThreads * kVectors * 4;  // elements a block updates
// Tensors a launch takes: the table rides in the launch's parameters, which
// hold 32,764 bytes from CUDA 12.1 on.
static_assert(CUDART_VERSION >= 12010, "launch parameters over 4 KB need CUDA 12.1");
constexpr int kMaxTensors = 512;
constexpr int kParamBytes = 32764;

struct TensorPtrs {
  float* p;
  const float* g;  // null: the EMA alone
  float* m;
  float* v;
  float* ema;
  float* step;  // 0-d
  long long n;
};

struct Coef {
  float lr, beta1, beta2, eps, one_minus_beta1, one_minus_beta2, decay, one_minus_decay,
      wd_scale;
};

struct Table {
  TensorPtrs t[kMaxTensors];
  int first_block[kMaxTensors + 1];  // tensor i's blocks: [first_block[i], first_block[i + 1])
  const unsigned char* keep;         // torch.bool, on the device
  Coef c;
  int count;
};
static_assert(sizeof(Table) <= kParamBytes, "the table must fit in a launch's parameters");

__device__ __forceinline__ void adam(float& p, float g, float& m, float& v, float& e,
                                     const Coef& c, float bc1, float bc2) {
  m = __fadd_rn(__fmul_rn(m, c.beta1), __fmul_rn(g, c.one_minus_beta1));
  v = __fadd_rn(__fmul_rn(v, c.beta2), __fmul_rn(__fmul_rn(g, g), c.one_minus_beta2));
  const float num = __fmul_rn(c.lr, __fdiv_rn(m, bc1));
  const float den = __fadd_rn(__fsqrt_rn(__fdiv_rn(v, bc2)), c.eps);
  p = __fsub_rn(__fmul_rn(p, c.wd_scale), __fdiv_rn(num, den));
  e = __fmaf_rn(c.one_minus_decay, p, __fmul_rn(e, c.decay));
}

__device__ __forceinline__ void ema_only(float p, float& e, const Coef& c) {
  e = __fmaf_rn(c.one_minus_decay, p, __fmul_rn(e, c.decay));
}

__device__ __forceinline__ void adam4(float4& p, const float4& g, float4& m, float4& v,
                                      float4& e, const Coef& c, float bc1, float bc2) {
  adam(p.x, g.x, m.x, v.x, e.x, c, bc1, bc2);
  adam(p.y, g.y, m.y, v.y, e.y, c, bc1, bc2);
  adam(p.z, g.z, m.z, v.z, e.z, c, bc1, bc2);
  adam(p.w, g.w, m.w, v.w, e.w, c, bc1, bc2);
}

__device__ __forceinline__ void ema4(const float4& p, float4& e, const Coef& c) {
  ema_only(p.x, e.x, c);
  ema_only(p.y, e.y, c);
  ema_only(p.z, e.z, c);
  ema_only(p.w, e.w, c);
}

// A whole chunk from element `begin` (a multiple of kChunk), 16 bytes at a time.
template <bool kAdam>
__device__ __forceinline__ void update_vectors(const TensorPtrs& t, long long begin,
                                               const Coef& c, float bc1, float bc2) {
  float4* p4 = reinterpret_cast<float4*>(t.p);
  float4* e4 = reinterpret_cast<float4*>(t.ema);
  const float4* g4 = reinterpret_cast<const float4*>(t.g);
  float4* m4 = reinterpret_cast<float4*>(t.m);
  float4* v4 = reinterpret_cast<float4*>(t.v);
  const long long base = begin / 4 + threadIdx.x;
  float4 P[kVectors], G[kVectors], M[kVectors], V[kVectors], E[kVectors];
#pragma unroll
  for (int u = 0; u < kVectors; ++u) {
    const long long i = base + static_cast<long long>(u) * kThreads;
    P[u] = p4[i];
    E[u] = e4[i];
    if (kAdam) {
      G[u] = __ldg(g4 + i);
      M[u] = m4[i];
      V[u] = v4[i];
    }
  }
#pragma unroll
  for (int u = 0; u < kVectors; ++u) {
    if (kAdam) {
      adam4(P[u], G[u], M[u], V[u], E[u], c, bc1, bc2);
    } else {
      ema4(P[u], E[u], c);
    }
  }
#pragma unroll
  for (int u = 0; u < kVectors; ++u) {
    const long long i = base + static_cast<long long>(u) * kThreads;
    e4[i] = E[u];
    if (kAdam) {
      p4[i] = P[u];
      m4[i] = M[u];
      v4[i] = V[u];
    }
  }
}

// Elements [begin, end) one at a time.
template <bool kAdam>
__device__ void update_scalars(const TensorPtrs& t, long long begin, long long end,
                               const Coef& c, float bc1, float bc2) {
  for (long long i = begin + threadIdx.x; i < end; i += kThreads) {
    float p = t.p[i], e = t.ema[i];
    if (kAdam) {
      float m = t.m[i], v = t.v[i];
      adam(p, t.g[i], m, v, e, c, bc1, bc2);
      t.p[i] = p;
      t.m[i] = m;
      t.v[i] = v;
    } else {
      ema_only(p, e, c);
    }
    t.ema[i] = e;
  }
}

__device__ __forceinline__ bool aligned16(const TensorPtrs& t) {
  const uintptr_t any = reinterpret_cast<uintptr_t>(t.p) | reinterpret_cast<uintptr_t>(t.g) |
                        reinterpret_cast<uintptr_t>(t.m) | reinterpret_cast<uintptr_t>(t.v) |
                        reinterpret_cast<uintptr_t>(t.ema);
  return (any & 15) == 0;
}

__global__ void __launch_bounds__(kThreads) masked_adamw_kernel(const __grid_constant__ Table a) {
  if (!*a.keep) return;
  // The block's tensor: the last whose first block is at most this one (a
  // tensor of no elements has no block and is never found).
  const int block = blockIdx.x;
  int lo = 0, hi = a.count - 1;
  while (lo < hi) {
    const int mid = (lo + hi + 1) / 2;
    if (a.first_block[mid] <= block) {
      lo = mid;
    } else {
      hi = mid - 1;
    }
  }
  const TensorPtrs& t = a.t[lo];
  const long long begin = static_cast<long long>(block - a.first_block[lo]) * kChunk;
  const long long end = begin + kChunk < t.n ? begin + kChunk : t.n;
  const bool whole = end - begin == kChunk && aligned16(t);
  if (t.g == nullptr) {
    if (whole) {
      update_vectors<false>(t, begin, a.c, 1.0f, 1.0f);
    } else {
      update_scalars<false>(t, begin, end, a.c, 1.0f, 1.0f);
    }
    return;
  }
  const float s = __fadd_rn(*t.step, 1.0f);
  const float bc1 = __fsub_rn(1.0f, powf(a.c.beta1, s));
  const float bc2 = __fsub_rn(1.0f, powf(a.c.beta2, s));
  if (whole) {
    update_vectors<true>(t, begin, a.c, bc1, bc2);
  } else {
    update_scalars<true>(t, begin, end, a.c, bc1, bc2);
  }
}

// step += 1 for every tensor with a gradient, where `keep`; launched after
// masked_adamw_kernel, whose blocks read the counts.
__global__ void masked_adamw_steps(const __grid_constant__ Table a) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i < a.count && *a.keep && a.t[i].g != nullptr) {
    float* step = a.t[i].step;
    *step = __fadd_rn(*step, 1.0f);
  }
}

int launch(const long long* rows, int count, const void* keep, const Coef& c, cudaStream_t s) {
  Table a;
  a.keep = static_cast<const unsigned char*>(keep);
  a.c = c;
  a.count = count;
  long long blocks = 0;
  for (int i = 0; i < count; ++i) {
    const long long* r = rows + 7 * i;
    a.t[i] = TensorPtrs{reinterpret_cast<float*>(r[0]), reinterpret_cast<const float*>(r[1]),
                        reinterpret_cast<float*>(r[2]),  reinterpret_cast<float*>(r[3]),
                        reinterpret_cast<float*>(r[4]),  reinterpret_cast<float*>(r[5]),
                        r[6]};
    a.first_block[i] = static_cast<int>(blocks);
    blocks += (r[6] + kChunk - 1) / kChunk;
    if (blocks > INT_MAX) return -2;
  }
  a.first_block[count] = static_cast<int>(blocks);
  if (blocks > 0) {
    masked_adamw_kernel<<<static_cast<unsigned>(blocks), kThreads, 0, s>>>(a);
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  masked_adamw_steps<<<(count + kThreads - 1) / kThreads, kThreads, 0, s>>>(a);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// rows: count x 7 int64 on the host, one row a tensor: the device addresses
// of p, g, m, v, the EMA and the step count (g, m, v and the step 0 for a
// tensor that takes the EMA alone), then its number of elements. coef: lr,
// b1, b2, eps, 1 - b1, 1 - b2, decay, 1 - decay, 1 - lr wd, each rounded to
// fp32 from the double. keep: a torch.bool on the device. Launches on
// `stream` and returns 0 or the CUDA error (-2: more than 2^31 blocks).
extern "C" int masked_adamw(const long long* rows, int count, const void* keep,
                            const float* coef, void* stream) {
  const Coef c{coef[0], coef[1], coef[2], coef[3], coef[4], coef[5], coef[6], coef[7], coef[8]};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  for (int start = 0; start < count; start += kMaxTensors) {
    const int n = count - start < kMaxTensors ? count - start : kMaxTensors;
    const int err = launch(rows + 7 * static_cast<long long>(start), n, keep, c, s);
    if (err != 0) return err;
  }
  return 0;
}
