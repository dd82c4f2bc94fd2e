// Tiled fp32 GEMM on the CUDA cores, shared by the fused mixers' stages
// (kernel C's in_proj, conv + x_proj and merge + out_proj; kernel E's in_proj
// and out_proj; kernel G's 2h -> h product).
//
// A stage computes c[row, col] = sum_k a(row, k) * w[col, k] for one branch:
// w is a torch Linear weight (cols, depth), row-major, and a(row, k) is
// whatever the stage's loader makes of its inputs (a plain read, a gather, a
// conv, a LayerNorm). A stage class has
//
//     Stage(const P& params, int branch);      // built on the device
//     struct Row;  Row row(int i) const;       // what the loads of row i need
//     float a(const Row&, int k) const;
//     const float* w;  float* c;  int rows, cols, depth;
//
// A thread's rows stay the same over the k-loop, so it resolves each into a
// Row once, before the loop: the loop's loads then need no index arithmetic,
// and no load in a loader waits on another (a chain of dependent loads
// outlasts the products that the next slab's loads should hide behind).
//
// Everything is fp32 FMA, no TF32, so that a kernel agrees with its plain
// PyTorch version to fp32 rounding.

#pragma once

#include <cuda_runtime.h>

// One BM x BN tile per block, blockIdx.z the branch. Thread (tx, ty) owns rows
// ty + i * (BM / TM) and columns tx + j * (BN / TN) of the tile, so that its
// shared-memory reads of W are conflict-free and its stores coalesce. Each
// thread loads its share of the next k-slab into registers while the block
// multiplies the current one out of shared memory: elements tid + q * threads
// of the slab, all at depth tid % BK. The ragged edges of rows, cols and depth
// are masked.
template <int BM, int BN, int BK, int TM, int TN, class Stage, class P>
__global__ void __launch_bounds__((BM / TM) * (BN / TN))
    gemm_nt_kernel(const P p) {
  constexpr int kThreads = (BM / TM) * (BN / TN);
  constexpr int kRowStep = BM / TM;
  constexpr int kColStep = BN / TN;
  constexpr int kALoads = BM * BK / kThreads;
  constexpr int kWLoads = BN * BK / kThreads;
  constexpr int kSlabRows = kThreads / BK;  // rows a slab's pass of the block covers
  static_assert(kThreads % BK == 0 && BM % kSlabRows == 0 && BN % kSlabRows == 0,
                "each thread loads whole elements of a slab, at one depth");
  __shared__ float As[BK][BM + 1];
  __shared__ float Ws[BK][BN + 1];

  const Stage st(p, blockIdx.z);
  const int row0 = blockIdx.x * BM;
  const int col0 = blockIdx.y * BN;
  const int tx = threadIdx.x % kColStep;
  const int ty = threadIdx.x / kColStep;
  const int kk = threadIdx.x % BK;
  const int r0 = threadIdx.x / BK;

  typename Stage::Row arow[kALoads];
  bool a_ok[kALoads];
#pragma unroll
  for (int q = 0; q < kALoads; ++q) {
    const int row = row0 + r0 + q * kSlabRows;
    a_ok[q] = row < st.rows;
    arow[q] = st.row(a_ok[q] ? row : row0);
  }
  const float* wrow[kWLoads];
  bool w_ok[kWLoads];
#pragma unroll
  for (int q = 0; q < kWLoads; ++q) {
    const int col = col0 + r0 + q * kSlabRows;
    w_ok[q] = col < st.cols;
    wrow[q] = st.w + static_cast<size_t>(w_ok[q] ? col : col0) * st.depth + kk;
  }

  float ra[kALoads], rw[kWLoads];
  auto load_slab = [&](int k0) {
    const bool k_ok = k0 + kk < st.depth;
#pragma unroll
    for (int q = 0; q < kALoads; ++q) {
      ra[q] = (a_ok[q] && k_ok) ? st.a(arow[q], k0 + kk) : 0.0f;
    }
#pragma unroll
    for (int q = 0; q < kWLoads; ++q) rw[q] = (w_ok[q] && k_ok) ? wrow[q][k0] : 0.0f;
  };

  float acc[TM][TN];
#pragma unroll
  for (int i = 0; i < TM; ++i)
#pragma unroll
    for (int j = 0; j < TN; ++j) acc[i][j] = 0.0f;
  load_slab(0);

  for (int k0 = 0; k0 < st.depth; k0 += BK) {
#pragma unroll
    for (int q = 0; q < kALoads; ++q) As[kk][r0 + q * kSlabRows] = ra[q];
#pragma unroll
    for (int q = 0; q < kWLoads; ++q) Ws[kk][r0 + q * kSlabRows] = rw[q];
    __syncthreads();
    if (k0 + BK < st.depth) load_slab(k0 + BK);
#pragma unroll
    for (int k = 0; k < BK; ++k) {
      float av[TM], wv[TN];
#pragma unroll
      for (int i = 0; i < TM; ++i) av[i] = As[k][ty + i * kRowStep];
#pragma unroll
      for (int j = 0; j < TN; ++j) wv[j] = Ws[k][tx + j * kColStep];
#pragma unroll
      for (int i = 0; i < TM; ++i)
#pragma unroll
        for (int j = 0; j < TN; ++j) acc[i][j] = fmaf(av[i], wv[j], acc[i][j]);
    }
    __syncthreads();
  }

#pragma unroll
  for (int i = 0; i < TM; ++i) {
    const int row = row0 + ty + i * kRowStep;
#pragma unroll
    for (int j = 0; j < TN; ++j) {
      const int col = col0 + tx + j * kColStep;
      if (row < st.rows && col < st.cols) {
        st.c[static_cast<size_t>(row) * st.cols + col] = acc[i][j];
      }
    }
  }
}

// Launch `Stage` over a rows x cols output for `branches` branches; returns
// the launch's cudaError_t as an int.
template <int BM, int BN, int BK, int TM, int TN, class Stage, class P>
int launch_gemm(const P& p, int rows, int cols, int branches, cudaStream_t stream) {
  const dim3 grid((rows + BM - 1) / BM, (cols + BN - 1) / BN, branches);
  gemm_nt_kernel<BM, BN, BK, TM, TN, Stage, P>
      <<<grid, (BM / TM) * (BN / TN), 0, stream>>>(p);
  return static_cast<int>(cudaGetLastError());
}
