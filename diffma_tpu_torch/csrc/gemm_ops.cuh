// Tiled fp32 GEMM on the CUDA cores whose operands are read along whichever
// of their axes is contiguous, for the fused Mamba-2 mixer's backward
// (kernel F, fused_ssd_bwd.cu): products with a transposed weight (g W),
// weight gradients (a^T b, the depth being the token rows) and stages whose
// loader or store does more than copy. (Kernel D's products moved to
// gemm_tc.cuh's tensor-core GEMM.)
//
// An operand class Op is built on the device from the kernel's parameters
// and the branch, `Op(const P& params, int branch)`, and gives
//
//     rows, cols, depth       c (rows x cols) = sum over k < depth of a(row, k) b(col, k)
//     kAByRow, kBByRow        true when a (b) is contiguous along row (col), false
//                             when along k: the tile loads follow the contiguous axis
//     a(row, k), b(col, k), store(row, col, split, value)
//
// With `splits` > 1 the depth is split over that many blocks (blockIdx.z =
// branch * splits + split) and each stores its own partial, which a second
// pass sums in a fixed order. Everything is fp32 FMA, no TF32 and no atomics.

#pragma once

#include <cuda_runtime.h>

// One BM x BN tile per block: 16-deep k-slabs in shared memory, a TM x TN
// register tile per thread, the next slab loaded into registers during the
// products. The ragged edges of rows, cols and depth are masked.
template <int BM, int BN, int BK, int TM, int TN, class Op, class P>
__global__ void __launch_bounds__((BM / TM) * (BN / TN)) gemm_op_kernel(const P p, int splits) {
  constexpr int kThreads = (BM / TM) * (BN / TN);
  constexpr int kRowStep = BM / TM;
  constexpr int kColStep = BN / TN;
  constexpr int kALoads = BM * BK / kThreads;
  constexpr int kBLoads = BN * BK / kThreads;
  static_assert(BM * BK % kThreads == 0 && BN * BK % kThreads == 0, "whole loads per thread");
  static_assert(Op::kAByRow ? kThreads % BM == 0 : kThreads % BK == 0, "fixed row or k per thread");
  static_assert(Op::kBByRow ? kThreads % BN == 0 : kThreads % BK == 0, "fixed col or k per thread");
  __shared__ float As[BK][BM + 1];
  __shared__ float Bs[BK][BN + 1];

  const int m = blockIdx.z / splits;
  const int split = blockIdx.z % splits;
  const Op op(p, m);
  const int row0 = blockIdx.x * BM;
  const int col0 = blockIdx.y * BN;
  const int per_split = (op.depth + splits * BK - 1) / (splits * BK) * BK;
  const int k_begin = split * per_split;
  const int k_end = min(op.depth, k_begin + per_split);
  const int tid = threadIdx.x;
  const int tx = tid % kColStep;
  const int ty = tid / kColStep;

  int ar[kALoads], ak[kALoads], br[kBLoads], bk[kBLoads];
#pragma unroll
  for (int q = 0; q < kALoads; ++q) {
    const int e = tid + q * kThreads;
    ar[q] = Op::kAByRow ? e % BM : e / BK;
    ak[q] = Op::kAByRow ? e / BM : e % BK;
  }
#pragma unroll
  for (int q = 0; q < kBLoads; ++q) {
    const int e = tid + q * kThreads;
    br[q] = Op::kBByRow ? e % BN : e / BK;
    bk[q] = Op::kBByRow ? e / BN : e % BK;
  }

  float ra[kALoads], rb[kBLoads];
  auto load_slab = [&](int k0) {
#pragma unroll
    for (int q = 0; q < kALoads; ++q) {
      const int row = row0 + ar[q], k = k0 + ak[q];
      ra[q] = (row < op.rows && k < k_end) ? op.a(row, k) : 0.0f;
    }
#pragma unroll
    for (int q = 0; q < kBLoads; ++q) {
      const int col = col0 + br[q], k = k0 + bk[q];
      rb[q] = (col < op.cols && k < k_end) ? op.b(col, k) : 0.0f;
    }
  };

  float acc[TM][TN];
#pragma unroll
  for (int i = 0; i < TM; ++i)
#pragma unroll
    for (int j = 0; j < TN; ++j) acc[i][j] = 0.0f;
  if (k_begin < k_end) load_slab(k_begin);

  for (int k0 = k_begin; k0 < k_end; k0 += BK) {
#pragma unroll
    for (int q = 0; q < kALoads; ++q) As[ak[q]][ar[q]] = ra[q];
#pragma unroll
    for (int q = 0; q < kBLoads; ++q) Bs[bk[q]][br[q]] = rb[q];
    __syncthreads();
    if (k0 + BK < k_end) load_slab(k0 + BK);
#pragma unroll
    for (int k = 0; k < BK; ++k) {
      float av[TM], bv[TN];
#pragma unroll
      for (int i = 0; i < TM; ++i) av[i] = As[k][ty + i * kRowStep];
#pragma unroll
      for (int j = 0; j < TN; ++j) bv[j] = Bs[k][tx + j * kColStep];
#pragma unroll
      for (int i = 0; i < TM; ++i)
#pragma unroll
        for (int j = 0; j < TN; ++j) acc[i][j] = fmaf(av[i], bv[j], acc[i][j]);
    }
    __syncthreads();
  }

#pragma unroll
  for (int i = 0; i < TM; ++i) {
    const int row = row0 + ty + i * kRowStep;
#pragma unroll
    for (int j = 0; j < TN; ++j) {
      const int col = col0 + tx + j * kColStep;
      if (row < op.rows && col < op.cols) op.store(row, col, split, acc[i][j]);
    }
  }
}

// Launch `Op` over a rows x cols output for `branches` branches, the depth
// split over `splits` blocks; returns the launch's cudaError_t as an int.
template <int BM, int BN, int BK, int TM, int TN, class Op, class P>
int launch_gemm_op(const P& p, int rows, int cols, int branches, cudaStream_t stream,
                   int splits = 1) {
  const dim3 grid((rows + BM - 1) / BM, (cols + BN - 1) / BN, branches * splits);
  gemm_op_kernel<BM, BN, BK, TM, TN, Op, P>
      <<<grid, (BM / TM) * (BN / TN), 0, stream>>>(p, splits);
  return static_cast<int>(cudaGetLastError());
}
