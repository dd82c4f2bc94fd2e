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
// Arithmetic. The 2h -> h product runs on the tensor cores in 3xTF32
// (gemm_tc.cuh: each operand split into a TF32 high part and remainder, three
// products summed in fp32), as kernels C, D, E, F and H run theirs; the rest
// is fp32 on the CUDA cores.
//
// Bound on an H100 SXM (495 TFLOP/s TF32, so 165 TFLOP/s for the 3xTF32
// products; 3.35 TB/s): at batch 1, L = 196, h = 512 the product is 0.21
// GFLOP, 1.2 us, against 2.1 MB of fc1_w and 1.6 MB of rows, 1.1 us: the
// operations bound it, barely; at batch 8 the product's 1.6 GFLOP, 9.9 us,
// against 15 MB, 4.5 us.
//
// Design: three kernels on the stream (as before the redesign), the
// intermediates in a workspace the caller allocates
// (spiral_epilogue_workspace_floats).
// 1. LayerNorm: one warp per row (196 blocks at batch 1); mean and 1 /
//    sqrt(var + eps) over the virtual concat, the variance as the mean of
//    squared deviations. It writes n (rows, 2h), which fc1 reads with plain
//    float4 loads: faster on the H100 than a loader that applies the
//    statistics as it reads o0 and o1 (PERF.md). Block 0 also clears fc1's
//    tickets.
// 2. fc1 on gemm_tc.cuh's GEMM (stage Fc1): 64 x 64 tiles where they alone
//    fill the card (batch 8), else 64 x 32 tiles with the depth 2h split in
//    two (batch 1: 64 tiles, 128 blocks). The GEMM's epilogue is the tail's
//    first half: each tile's last block (with a split, the one that takes
//    the tile's second ticket, an atomic counter that elects it and sums
//    nothing) adds the two partials in split order, the bias, takes the SiLU
//    and the dot with fc2_w over the tile's columns, and writes one partial
//    logit per (row, column tile). hpre never reaches device memory whole.
//    The GEMM's loop, not the products, sets fc1's time: one 32-deep slab's
//    loads in flight a block, about a microsecond a slab (PERF.md).
// 3. tail: one block per row; the partial logits summed in column-tile
//    order, the sigmoid, the mix and the gated residual, in float4s.
// The TPU kernel's (B, 8, h) packing of shift/scale/gate and its 8-row
// padding of L exist for VMEM's tiling; here the gate is a pointer with a row
// stride and rows are exact.
//
// bf16 (dtype 1: o0, o1, x, the gate and out in bf16, the weights fp32), the
// TPU kernel at a compute dtype cd = bfloat16: the LayerNorm is fp32 over the
// bf16 values; fc1 multiplies the normed concat and fc1_w rounded to bf16
// (gemm_tc.cuh's kBf16 stage) with fp32 sums, and fc1_b is added in fp32;
// silu(h) and fc2_w are rounded to bf16 before the h -> 1 dot, which sums in
// fp32; the mix and the gated residual are fp32, and out is rounded once.

#include <cuda_runtime.h>
#include <stdint.h>

#include "gemm_tc.cuh"

namespace {

constexpr int kLnWarps = 1;
constexpr int kTailThreads = 128;

// o0, o1, x, gate and out are of the call's dtype, fp32 or bf16.
struct Params {
  const void* o0;      // (B * L, h)
  const void* o1;      // (B * L, h)
  const void* x;       // (B * L, h)
  const void* gate;    // (B, h), rows gate_stride apart
  const float* an_w;   // (2h,)
  const float* an_b;   // (2h,)
  const float* fc1_w;  // (h, 2h)
  const float* fc1_b;  // (h,)
  const float* fc2_w;  // (h,)
  const float* fc2_b;  // (1,)
  void* out;           // (B * L, h)
  float* n;            // (B * L, 2h): the normed concat
  float* part;         // (splits, B * L, h): fc1's split partials, if split
  float* logit;        // (B * L, col_tiles): sum_c silu(hpre + fc1_b) fc2_w per column tile
  unsigned* tickets;   // (row tiles * col_tiles,): blocks of a tile done, if split
  int rows, L, h, gate_stride, bn, splits, col_tiles;
  float ln_eps;
};

using bf16 = tc::bf16;
using tc::kIsBf16;
using tc::ld4;
using tc::round_bf16;

__device__ __forceinline__ float silu(float x) { return x / (1.0f + expf(-x)); }
__device__ __forceinline__ void st4(float* p, float4 v) { *reinterpret_cast<float4*>(p) = v; }
__device__ __forceinline__ void st4(bf16* p, float4 v) { tc::bf16_store(p, 0, v); }

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// 1. grid ceil(rows / kLnWarps), one warp per row, h a multiple of 4; each
// lane's sums over its groups of 4 in order, then the warp's.
template <class T>
__global__ void __launch_bounds__(kLnWarps * 32) ln_kernel(const Params p) {
  if (blockIdx.x == 0 && p.splits > 1) {
    const int tiles = (p.rows + tc::kBM - 1) / tc::kBM * p.col_tiles;
    for (int i = threadIdx.x; i < tiles; i += blockDim.x) p.tickets[i] = 0u;
  }
  const int row = blockIdx.x * kLnWarps + threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  if (row >= p.rows) return;
  const int h4 = p.h / 4;
  const T* o0 = static_cast<const T*>(p.o0) + static_cast<size_t>(row) * p.h;
  const T* o1 = static_cast<const T*>(p.o1) + static_cast<size_t>(row) * p.h;
  float s = 0.0f;
  for (int c = lane; c < h4; c += 32) {
    const float4 a = ld4(o0 + 4 * c), b = ld4(o1 + 4 * c);
    s += ((a.x + a.y) + (a.z + a.w)) + ((b.x + b.y) + (b.z + b.w));
  }
  const float mu = warp_sum(s) / (2 * p.h);
  float q = 0.0f;
  for (int c = lane; c < h4; c += 32) {
    const float4 a = ld4(o0 + 4 * c), b = ld4(o1 + 4 * c);
    const float v[8] = {a.x - mu, a.y - mu, a.z - mu, a.w - mu, b.x - mu, b.y - mu, b.z - mu, b.w - mu};
#pragma unroll
    for (int e = 0; e < 8; ++e) q = fmaf(v[e], v[e], q);
  }
  const float r = rsqrtf(warp_sum(q) / (2 * p.h) + p.ln_eps);
  float4* n = reinterpret_cast<float4*>(p.n + static_cast<size_t>(row) * 2 * p.h);
  const float4* w = reinterpret_cast<const float4*>(p.an_w);
  const float4* b = reinterpret_cast<const float4*>(p.an_b);
  for (int c = lane; c < 2 * h4; c += 32) {
    const float4 v = c < h4 ? ld4(o0 + 4 * c) : ld4(o1 + 4 * (c - h4)), g = w[c], bb = b[c];
    n[c] = make_float4((v.x - mu) * r * g.x + bb.x, (v.y - mu) * r * g.y + bb.y,
                       (v.z - mu) * r * g.z + bb.z, (v.w - mu) * r * g.w + bb.w);
  }
}

// 2. hpre = n . fc1_w^T on gemm_tc.cuh, finished per tile into partial
// logits; kB: the bf16 model's products (see the header).
template <bool kB>
struct Fc1 {
  static constexpr bool kAByRow = false, kBByRow = false, kFinish = true, kBf16 = kB;
  bool vec = true;  // h a multiple of 4 and every pointer 16-byte aligned (the wrapper checks)
  struct ARow {
    const float* n;
  };
  Params p;
  const float* w;
  int rows, cols, depth;
  __device__ Fc1(const Params& q, int)
      : p(q), w(q.fc1_w), rows(q.rows), cols(q.h), depth(2 * q.h) {}
  __device__ ARow arow(int i) const { return {p.n + static_cast<size_t>(i) * depth}; }
  __device__ float a(const ARow& r, int k) const { return r.n[k]; }
  __device__ float4 a4(const ARow& r, int k) const { return ld4(r.n + k); }
  __device__ float b(int col, int k) const { return w[static_cast<size_t>(col) * depth + k]; }
  __device__ float4 b4(int col, int k) const { return ld4(w + static_cast<size_t>(col) * depth + k); }

  // The tile's epilogue. With splits, every block stores its partial; the
  // tile's last block sums them in split order (its own from its registers).
  // Then per row: sum over the tile's columns of silu(hpre + fc1_b) fc2_w,
  // each thread over its columns (j, then c), then the four lanes that share
  // the row ((l0 + l1) + (l2 + l3)), written as the row's partial logit of
  // this column tile.
  template <int BN>
  __device__ void finish(const float (&acc)[BN / 2], int row0, int col0, int split,
                         int splits) const {
    const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
    const size_t plane = static_cast<size_t>(rows) * cols;
    if (splits > 1) {
      __shared__ unsigned last;
#pragma unroll
      for (int j = 0; j < BN / 8; ++j)
#pragma unroll
        for (int i = 0; i < 2; ++i)
#pragma unroll
          for (int c = 0; c < 2; ++c) {
            const int row = row0 + warp * 16 + lane / 4 + 8 * i;
            const int col = col0 + j * 8 + (lane % 4) * 2 + c;
            if (row < rows && col < cols) {
              p.part[split * plane + static_cast<size_t>(row) * cols + col] = acc[j * 4 + i * 2 + c];
            }
          }
      __threadfence();  // the partial is visible before the ticket is taken
      __syncthreads();
      if (threadIdx.x == 0) {
        const unsigned tile = (row0 / tc::kBM) * p.col_tiles + col0 / BN;
        last = atomicAdd(p.tickets + tile, 1u) == static_cast<unsigned>(splits - 1);
      }
      __syncthreads();
      if (!last) return;
      __threadfence();
    }
    float s[2] = {0.0f, 0.0f};
#pragma unroll
    for (int j = 0; j < BN / 8; ++j)
#pragma unroll
      for (int i = 0; i < 2; ++i)
#pragma unroll
        for (int c = 0; c < 2; ++c) {
          const int row = row0 + warp * 16 + lane / 4 + 8 * i;
          const int col = col0 + j * 8 + (lane % 4) * 2 + c;
          if (row < rows && col < cols) {
            float v = 0.0f;
            for (int sp = 0; sp < splits; ++sp) {
              v += sp == split ? acc[j * 4 + i * 2 + c]
                               : __ldcg(p.part + sp * plane + static_cast<size_t>(row) * cols + col);
            }
            const float a = silu(v + p.fc1_b[col]);
            s[i] = kB ? fmaf(round_bf16(a), round_bf16(p.fc2_w[col]), s[i])
                      : fmaf(a, p.fc2_w[col], s[i]);
          }
        }
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      s[i] += __shfl_xor_sync(0xffffffffu, s[i], 1);
      s[i] += __shfl_xor_sync(0xffffffffu, s[i], 2);
      const int row = row0 + warp * 16 + lane / 4 + 8 * i;
      if (lane % 4 == 0 && row < rows) p.logit[static_cast<size_t>(row) * p.col_tiles + col0 / BN] = s[i];
    }
  }
};

// 3. grid rows.
template <class T>
__global__ void __launch_bounds__(kTailThreads) tail_kernel(const Params p) {
  const int row = blockIdx.x;
  const int h = p.h;
  const float* lp = p.logit + static_cast<size_t>(row) * p.col_tiles;
  float s = 0.0f;
  for (int t = 0; t < p.col_tiles; ++t) s += lp[t];
  const float alpha = 1.0f / (1.0f + expf(-(s + p.fc2_b[0])));
  const T* o0 = static_cast<const T*>(p.o0) + static_cast<size_t>(row) * h;
  const T* o1 = static_cast<const T*>(p.o1) + static_cast<size_t>(row) * h;
  const T* x = static_cast<const T*>(p.x) + static_cast<size_t>(row) * h;
  const T* gate = static_cast<const T*>(p.gate) + static_cast<size_t>(row / p.L) * p.gate_stride;
  T* out = static_cast<T*>(p.out) + static_cast<size_t>(row) * h;
  for (int c = 4 * threadIdx.x; c < h; c += 4 * kTailThreads) {
    const float4 a = ld4(o0 + c), b = ld4(o1 + c), xv = ld4(x + c), g = ld4(gate + c);
    st4(out + c,
        make_float4(xv.x + g.x * (alpha * a.x + (1.0f - alpha) * b.x),
                    xv.y + g.y * (alpha * a.y + (1.0f - alpha) * b.y),
                    xv.z + g.z * (alpha * a.z + (1.0f - alpha) * b.z),
                    xv.w + g.w * (alpha * a.w + (1.0f - alpha) * b.w)));
  }
}

// Lay the workspace out for these shapes (pointers into `base` when given);
// returns its size in floats.
size_t layout(Params& p, float* base) {
  const size_t rows = p.rows;
  const size_t row_tiles = (rows + tc::kBM - 1) / tc::kBM;
  const size_t sizes[] = {
      rows * 2 * p.h,                                          // n
      p.splits > 1 ? p.splits * rows * p.h : 0,                // part
      rows * p.col_tiles,                                      // logit
      p.splits > 1 ? row_tiles * p.col_tiles : 0,              // tickets
  };
  float* ptrs[4] = {};
  size_t total = 0;
  for (int i = 0; i < 4; ++i) {
    if (base != nullptr && sizes[i]) ptrs[i] = base + total;
    total += (sizes[i] + 3) / 4 * 4;  // every array 16-byte aligned
  }
  p.n = ptrs[0];
  p.part = ptrs[1];
  p.logit = ptrs[2];
  p.tickets = reinterpret_cast<unsigned*>(ptrs[3]);
  return total;
}

void set_dims(Params& p, int B, int L, int h) {
  p.rows = B * L;
  p.L = L;
  p.h = h;
  // 64-wide column tiles where they alone fill the card (batch 8: 200 tiles),
  // else 32-wide ones with the depth split in two (batch 1: 64 tiles, 128
  // blocks); a function of the shapes alone.
  const int row_tiles = (p.rows + tc::kBM - 1) / tc::kBM;
  p.bn = row_tiles * ((h + 63) / 64) >= tc::kSMs ? 64 : 32;
  p.col_tiles = (h + p.bn - 1) / p.bn;
  p.splits = row_tiles * p.col_tiles < tc::kSMs ? 2 : 1;
}

}  // namespace

// Floats of workspace that spiral_epilogue_fwd needs for these shapes.
extern "C" long long spiral_epilogue_workspace_floats(int B, int L, int h) {
  Params p{};
  set_dims(p, B, L, h);
  return static_cast<long long>(layout(p, nullptr));
}

namespace {

// The three launches for rows of type T (see spiral_epilogue_fwd).
template <class T>
int run(const Params& p, cudaStream_t st) {
  constexpr bool kB = kIsBf16<T>;
  ln_kernel<T><<<(p.rows + kLnWarps - 1) / kLnWarps, kLnWarps * 32, 0, st>>>(p);
  int err = static_cast<int>(cudaGetLastError());
  if (err == 0) {
    err = p.bn == 32 ? tc::launch_gemm_tc<32, Fc1<kB>>(p, p.rows, p.h, 1, st, p.splits)
                     : tc::launch_gemm_tc<64, Fc1<kB>>(p, p.rows, p.h, 1, st, p.splits);
  }
  if (err != 0) return err;
  tail_kernel<T><<<p.rows, kTailThreads, 0, st>>>(p);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// `ptrs` holds the 11 pointers of struct Params from o0 to out, in that
// order: o0, o1, x, gate and out of `dtype` (0 fp32, 1 bf16), the weights
// fp32; gate's rows lie `gate_stride` elements apart, everything else is
// contiguous, h and gate_stride multiples of 4 and every pointer 16-byte
// aligned. Launches three kernels on `stream`; returns the first
// cudaError_t that is not 0, or -1 for shapes or a dtype that are not built.
extern "C" int spiral_epilogue_fwd(void* const* ptrs, void* workspace, int B, int L, int h,
                                   int gate_stride, float ln_eps, int dtype, void* stream) {
  if (B < 1 || L < 1 || h < 4 || h % 4 != 0 || gate_stride % 4 != 0 || dtype < 0 || dtype > 1) {
    return -1;
  }
  Params p{};
  p.o0 = ptrs[0];
  p.o1 = ptrs[1];
  p.x = ptrs[2];
  p.gate = ptrs[3];
  p.an_w = static_cast<const float*>(ptrs[4]);
  p.an_b = static_cast<const float*>(ptrs[5]);
  p.fc1_w = static_cast<const float*>(ptrs[6]);
  p.fc1_b = static_cast<const float*>(ptrs[7]);
  p.fc2_w = static_cast<const float*>(ptrs[8]);
  p.fc2_b = static_cast<const float*>(ptrs[9]);
  p.out = ptrs[10];
  set_dims(p, B, L, h);
  layout(p, static_cast<float*>(workspace));
  p.gate_stride = gate_stride;
  p.ln_eps = ln_eps;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return dtype == 1 ? run<bf16>(p, st) : run<float>(p, st);
}
