// Tiled GEMM on Hopper's tensor cores in fp32-accurate 3xTF32, for the
// product stages of kernels C (fused_mixer_fwd.cu) and D (fused_mixer_bwd.cu),
// E's and F's projections (fused_ssd_fwd.cu, fused_ssd_bwd.cu), G's fc1
// (spiral_epilogue.cu) and H's x_proj and dt_proj (fused_mamba_fwd.cu). Rows,
// columns and depth of any size: the tiles' ragged edges are masked (E's
// in_proj has 2d + 2n + H = 2096 columns).
//
// A stage computes c[row, col] = sum_k a(row, k) b(col, k) for one branch.
// An operand class Op is built on the device from the kernel's parameters and
// the branch, `Op(const P& params, int branch)`, and gives
//
//     rows, cols, depth         the product's shape
//     kAByRow, kBByRow          true when a (b) is contiguous along row (col),
//                               false when along k: the loads follow that axis
//     struct ARow; ARow arow(int row)   what the loads of row `row` of a need,
//                               resolved once per thread before the k-loop
//     float a(const ARow&, int k), float b(int col, int k)
//     float4 a4(const ARow&, int k), float4 b4(int col, int k)
//                               four elements along the contiguous axis: k .. k+3
//                               (k a multiple of 4), or rows (cols) row .. row+3
//                               at k (row a multiple of 4)
//     bool vec                  whether a4 and b4 may be used (aligned rows); if
//                               not, every element loads through a and b
//     void store(int row, int col, int split, float value)
//
// or, in place of store, an epilogue that takes the whole tile: an operand
// class with `static constexpr bool kFinish = true` gives
//
//     template <int BN> void finish(const float (&acc)[BN / 2], int row0, int col0,
//                                   int split, int splits)
//
// called by all the block's threads with the accumulator in wgmma's layout
// (see the end of gemm_tc_kernel); for every other class the hook compiles to
// nothing.
//
// so a loader may gather, sum streams or apply a conv and SiLU (the stage
// classes of kernels C and D) as well as read a matrix.
//
// Arithmetic. TF32 keeps 10 explicit mantissa bits, about 3 decimal digits,
// which cannot hold a 1e-4 bar over depths of 512 to 12,544. So each operand
// element x is split once, when the loader stages it:
//
//     hi = cvt.rna.tf32(x),  lo = cvt.rna.tf32(x - hi)
//
// (x - hi is exact in fp32), and the tile accumulates lo a * hi b + hi a * lo b
// + hi a * hi b in fp32 on the tensor cores. hi + lo carries 22 of fp32's 24
// bits; the dropped lo * lo term and the rounding of lo are below 2^-21 of each
// product, so a sum of depth K drifts from the fp32 sum by about the fp32
// rounding itself.
//
// Design. One warpgroup (128 threads) per 64 x BN output tile (BN = 32, 64 or
// 128); blockIdx.z = branch * splits + split. The depth runs in 32-deep slabs
// through two shared-memory stages. Each stage holds hi and lo of both
// operands in the layout wgmma reads without swizzle, K-major: core matrices
// of 8 rows x 4 k (128 contiguous bytes), k-chunk major. While the tensor
// cores multiply slab s in one stage (wgmma is asynchronous), the threads
// split slab s + 1, loaded into registers one iteration earlier, into the
// other stage, and issue the loads of slab s + 2 (Loader).
// Every load is a float4 along the operand's contiguous axis; an operand read
// along its rows (a weight gradient's a = X^T, or g W's transposed weight) is
// transposed in registers on the way, as wgmma takes tf32 only K-major.
//
// Per 32-deep slab, 12 wgmma.m64nBNk8 (3 per k8 step): at BN = 128 about 870
// cycles of an SM (measured without the loads: 147 TFLOP/s fp32-equivalent
// on a 4096^3 product). The loads and the split's shared-memory stores, not
// the products, set each slab's time; a cp.async ring for the plain operands
// (three slabs ahead) measured slower, its 168 KB of shared memory leaving
// one block per SM.
//
// With `splits` > 1 the depth is split over that many blocks and each stores
// its own partial (store's `split`), which sum_splits_kernel adds in a fixed
// order. Nothing uses atomics, so a run repeats its bits.
//
// bf16 products. An operand class with `static constexpr bool kBf16 = true`
// multiplies in bf16 instead, for the JAX package's bf16 model (the products
// of kernels C, D, E, F and G at a compute dtype of bfloat16): the loaders
// hand the same fp32 values, and the stash rounds each to bf16 (round to
// nearest even, as XLA's convert) where 3xTF32 splits it. A value the class already
// holds in bf16 passes unchanged. One wgmma.m64nBNk16.f32.bf16.bf16 per
// 16-deep step accumulates in fp32, with no split: two a slab. The stage
// layout is the same in bytes, core matrices of 8 rows x 16 bytes (here 8
// bf16), K-major, so the descriptors are the same too.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

#include "bf16_round.cuh"

namespace tc {

constexpr int kBM = 64;        // rows of a tile: one wgmma m64
constexpr int kBK = 32;        // depth of a shared-memory stage
constexpr int kThreads = 128;  // one warpgroup
constexpr int kSMs = 132;      // H100 SXM; sets the split counts, so the bits do not depend on the card

__device__ __forceinline__ float tf32_rna(float x) {
  uint32_t r;
  asm("cvt.rna.tf32.f32 %0, %1;\n" : "=r"(r) : "f"(x));
  return __uint_as_float(r);
}

// A wgmma shared-memory descriptor, no swizzle: start address, leading byte
// offset (between core matrices adjacent along k) and stride byte offset
// (between core matrices adjacent along rows), each in 16-byte units.
__device__ __forceinline__ uint64_t smem_desc(const void* p, uint32_t lbo, uint32_t sbo) {
  const uint32_t addr = static_cast<uint32_t>(__cvta_generic_to_shared(p));
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) | (static_cast<uint64_t>(lbo >> 4) << 16) |
         (static_cast<uint64_t>(sbo >> 4) << 32);
}

// The descriptor of one k8 step of an R-row operand tile: its two core
// matrices along k lie R / 8 core matrices apart, its row groups one apart.
template <int R>
__device__ __forceinline__ uint64_t operand_desc(const void* p) {
  return smem_desc(p, R * 16, 128);
}

template <int N>
struct Wgmma;

template <>
struct Wgmma<32> {
  __device__ static __forceinline__ void mma(float (&d)[16], uint64_t a, uint64_t b) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %18, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n32k8.f32.tf32.tf32 "
        "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15}, %16, %17, p, 1, 1;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
        : "l"(a), "l"(b), "r"(1));
  }
};

template <>
struct Wgmma<64> {
  __device__ static __forceinline__ void mma(float (&d)[32], uint64_t a, uint64_t b) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n64k8.f32.tf32.tf32 "
        "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, %32, %33, p, 1, 1;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
        : "l"(a), "l"(b), "r"(1));
  }
};

template <>
struct Wgmma<128> {
  __device__ static __forceinline__ void mma(float (&d)[64], uint64_t a, uint64_t b) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n128k8.f32.tf32.tf32 "
        "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, %64, %65, p, 1, 1;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
        : "l"(a), "l"(b), "r"(1));
  }
};

// The same products in bf16, 16 deep: both operands K-major (the transpose
// immediates 0), the accumulator in the layout of Wgmma<N>.
template <int N>
struct WgmmaBf16;

template <>
struct WgmmaBf16<32> {
  __device__ static __forceinline__ void mma(float (&d)[16], uint64_t a, uint64_t b) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %18, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 "
        "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15}, %16, %17, p, 1, 1, 0, 0;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
        : "l"(a), "l"(b), "r"(1));
  }
};

template <>
struct WgmmaBf16<64> {
  __device__ static __forceinline__ void mma(float (&d)[32], uint64_t a, uint64_t b) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
        "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, %32, %33, p, 1, 1, 0, 0;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
        : "l"(a), "l"(b), "r"(1));
  }
};

template <>
struct WgmmaBf16<128> {
  __device__ static __forceinline__ void mma(float (&d)[64], uint64_t a, uint64_t b) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
        "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, %64, %65, p, 1, 1, 0, 0;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
        : "l"(a), "l"(b), "r"(1));
  }
};

__device__ __forceinline__ void wgmma_fence() { asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory"); }
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_wait_all() {
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}
// Keep the compiler from moving an accumulator across the asynchronous products.
__device__ __forceinline__ void fence_reg(float& r) { asm volatile("" : "+f"(r)::"memory"); }

// float offset of (row, k) in a stage's R x kBK operand: core matrix
// (k / 4, row / 8), k-chunk major, row % 8 within it
template <int R>
__device__ __forceinline__ int tile_offset(int row, int k) {
  return ((k / 4) * (R / 8) + row / 8) * 32 + (row % 8) * 4 + k % 4;
}

// bf16 offset of (row, k) in a stage's R x kBK bf16 operand: core matrix
// (k / 8, row / 8), k-chunk major, row % 8 within it (16 bytes a row)
template <int R>
__device__ __forceinline__ int tile_offset_bf16(int row, int k) {
  return ((k / 8) * (R / 8) + row / 8) * 64 + (row % 8) * 8 + k % 8;
}

// Four values rounded to bf16 (to nearest even) and stored as 8 bytes at `off`.
__device__ __forceinline__ void bf16_store(__nv_bfloat16* tile, int off, const float4 x) {
  const __nv_bfloat162 lo = __floats2bfloat162_rn(x.x, x.y), hi = __floats2bfloat162_rn(x.z, x.w);
  *reinterpret_cast<uint2*>(tile + off) =
      make_uint2(*reinterpret_cast<const uint32_t*>(&lo), *reinterpret_cast<const uint32_t*>(&hi));
}

// Element access for the stage classes of either dtype: T is float or bf16
// (x's dtype), the loads hand fp32 values to the loaders.
using bf16 = __nv_bfloat16;

__device__ __forceinline__ float ld(const float* p) { return *p; }
__device__ __forceinline__ float ld(const bf16* p) { return __bfloat162float(*p); }
__device__ __forceinline__ float4 ld4(const float* p) { return *reinterpret_cast<const float4*>(p); }
__device__ __forceinline__ float4 ld4(const bf16* p) {
  const uint2 v = *reinterpret_cast<const uint2*>(p);
  const __nv_bfloat162 lo = *reinterpret_cast<const __nv_bfloat162*>(&v.x);
  const __nv_bfloat162 hi = *reinterpret_cast<const __nv_bfloat162*>(&v.y);
  return make_float4(__low2float(lo), __high2float(lo), __low2float(hi), __high2float(hi));
}
// Rows of `stride` elements from p that 4-element loads can read: aligned to
// 4 elements and a stride of whole groups of 4 (true at every DiffMa width).
// A stage whose rows are not takes its scalar loads (Loader, `vec`).
template <class T>
__device__ __forceinline__ bool al(const T* p, int stride) {
  return (reinterpret_cast<uintptr_t>(p) & (4 * sizeof(T) - 1)) == 0 && stride % 4 == 0;
}
__device__ __forceinline__ void put(float* p, float v) { *p = v; }
__device__ __forceinline__ void put(bf16* p, float v) { *p = __float2bfloat16_rn(v); }
using ::round_bf16;
template <class T>
constexpr bool kIsBf16 = std::is_same<T, bf16>::value;

__device__ __forceinline__ float comp4(const float4& v, int i) {
  return i == 0 ? v.x : i == 1 ? v.y : i == 2 ? v.z : v.w;
}

// Split four values and store hi and lo as float4s at `off`.
__device__ __forceinline__ void split_store(float* hi, float* lo, int off, const float4 x) {
  const float4 h = make_float4(tf32_rna(x.x), tf32_rna(x.y), tf32_rna(x.z), tf32_rna(x.w));
  *reinterpret_cast<float4*>(hi + off) = h;
  *reinterpret_cast<float4*>(lo + off) =
      make_float4(tf32_rna(x.x - h.x), tf32_rna(x.y - h.y), tf32_rna(x.z - h.z), tf32_rna(x.w - h.w));
}

// One operand's share of a slab: loaded into registers, then split into a
// hi/lo stage, every store a float4 and each quarter-warp's eight stores one
// core matrix's 128 bytes or eight of its rows, free of bank conflicts.
//
// * Contiguous along k (kByRow false): a thread loads float4s, 4 k of one row
//   each: warp w's lane l takes rows 8 (w kRows + i) + l % 8, i < kRows, at k
//   16 half + 4 (l / 8), half = 0, 1. A warp instruction reads 64 contiguous
//   bytes of each of 8 rows.
// * Contiguous along rows (kByRow true): a thread loads 4 x 4 blocks (rows
//   4 rb .. 4 rb + 3, k 4 kc .. 4 kc + 3), four float4s along the rows, and
//   transposes them in registers; block t + 128 j is row block (t + 128 j)
//   % (R / 4) of k-chunk (t + 128 j) / (R / 4), so a warp instruction reads
//   512 contiguous bytes. Each lane stores its block's rows in an order
//   rotated by (rb / 2) % 4, so that the eight lanes of a quarter-warp meet
//   eight different rows of their core matrices.
//
// `get(i, k)` is a scalar element of the thread's row i (k-contiguous) or of
// row `row` (row-contiguous, get(row, k)); `get4(i, k)` four along the
// contiguous axis; elements past the edges are 0.
template <int R, bool kByRow>
struct Loader;

template <int R>
struct Loader<R, false> {
  static_assert(R % 32 == 0, "whole row groups for each warp");
  static constexpr int kLoads = R / 16;  // float4s a thread
  static constexpr int kRows = kLoads / 2;
  float4 v[kLoads];
  __device__ static int row(int t, int i) { return ((t / 32) * kRows + i) * 8 + t % 8; }
  __device__ static int k(int t, int q) { return (q % 2) * 16 + ((t % 32) / 8) * 4; }
  template <class Get, class Get4>
  __device__ __forceinline__ void load(int t, int k0, int k_end, const bool (&ok)[kRows], bool vec,
                                       Get get, Get4 get4) {
#pragma unroll
    for (int q = 0; q < kLoads; ++q) {
      const int i = q / 2, kk = k0 + k(t, q);
      if (vec && ok[i] && kk + 3 < k_end) {
        v[q] = get4(i, kk);
      } else {
        v[q] = make_float4(ok[i] && kk < k_end ? get(i, kk) : 0.0f,
                           ok[i] && kk + 1 < k_end ? get(i, kk + 1) : 0.0f,
                           ok[i] && kk + 2 < k_end ? get(i, kk + 2) : 0.0f,
                           ok[i] && kk + 3 < k_end ? get(i, kk + 3) : 0.0f);
      }
    }
  }
  // put(row, k, four values along k from k)
  template <class Put>
  __device__ __forceinline__ void stash_each(int t, Put put) const {
#pragma unroll
    for (int q = 0; q < kLoads; ++q) put(row(t, q / 2), k(t, q), v[q]);
  }
  __device__ __forceinline__ void stash(int t, float* hi, float* lo) const {
    stash_each(t, [&](int r, int kk, float4 x) { split_store(hi, lo, tile_offset<R>(r, kk), x); });
  }
  __device__ __forceinline__ void stash_bf16(int t, __nv_bfloat16* tile) const {
    stash_each(t, [&](int r, int kk, float4 x) { bf16_store(tile, tile_offset_bf16<R>(r, kk), x); });
  }
};

template <int R>
struct Loader<R, true> {
  static_assert(R % 32 == 0, "whole quarter-warps of row blocks");
  static constexpr int kBlocks = R * kBK / 16;
  static constexpr int kRows = (kBlocks + kThreads - 1) / kThreads;  // blocks a thread
  float4 v[kRows][4];  // v[j][c]: the block's 4 rows at k 4 kc + c
  __device__ static bool live(int t, int j) { return t + j * kThreads < kBlocks; }
  __device__ static int row(int t, int j) { return 4 * ((t + j * kThreads) % (R / 4)); }
  __device__ static int kc(int t, int j) { return (t + j * kThreads) / (R / 4); }
  // get(row, k): the element; get4(j, k): the thread's block j's 4 rows at k
  template <class Get, class Get4>
  __device__ __forceinline__ void load(int t, int k0, int k_end, int row0, int rows, bool vec,
                                       Get get, Get4 get4) {
#pragma unroll
    for (int j = 0; j < kRows; ++j) {
      const int r = row0 + row(t, j);
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        const int kk = k0 + 4 * kc(t, j) + c;
        if (!live(t, j) || kk >= k_end) {
          v[j][c] = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
        } else if (vec && r + 3 < rows) {
          v[j][c] = get4(j, kk);
        } else {
          v[j][c] = make_float4(r < rows ? get(r, kk) : 0.0f, r + 1 < rows ? get(r + 1, kk) : 0.0f,
                                r + 2 < rows ? get(r + 2, kk) : 0.0f,
                                r + 3 < rows ? get(r + 3, kk) : 0.0f);
        }
      }
    }
  }
  // put(row, k, four values along k from k), each row of the thread's blocks
  template <class Put>
  __device__ __forceinline__ void stash_each(int t, Put put) const {
#pragma unroll
    for (int j = 0; j < kRows; ++j) {
      if (!live(t, j)) continue;
      // w[i]: row 4 rb + i at k 4 kc .. 4 kc + 3, rotated by sh
      const int sh = (row(t, j) / 8) % 4;  // (rb / 2) % 4
      float4 w[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        w[i] = make_float4(comp4(v[j][0], i), comp4(v[j][1], i), comp4(v[j][2], i),
                           comp4(v[j][3], i));
      }
      if (sh & 1) {
        const float4 x = w[0];
        w[0] = w[1];
        w[1] = w[2];
        w[2] = w[3];
        w[3] = x;
      }
      if (sh & 2) {
        const float4 x = w[0], y = w[1];
        w[0] = w[2];
        w[1] = w[3];
        w[2] = x;
        w[3] = y;
      }
#pragma unroll
      for (int s = 0; s < 4; ++s) put(row(t, j) + (s + sh) % 4, 4 * kc(t, j), w[s]);  // w[s]: row 4 rb + (s + sh) % 4
    }
  }
  __device__ __forceinline__ void stash(int t, float* hi, float* lo) const {
    stash_each(t, [&](int r, int kk, float4 x) { split_store(hi, lo, tile_offset<R>(r, kk), x); });
  }
  __device__ __forceinline__ void stash_bf16(int t, __nv_bfloat16* tile) const {
    stash_each(t, [&](int r, int kk, float4 x) { bf16_store(tile, tile_offset_bf16<R>(r, kk), x); });
  }
};

// Whether an operand class finishes its tiles itself (kFinish, see above).
template <class Op, class = void>
struct Finishes : std::false_type {};
template <class Op>
struct Finishes<Op, std::void_t<decltype(Op::kFinish)>> : std::bool_constant<Op::kFinish> {};

// Whether an operand class multiplies in bf16 (kBf16, see above).
template <class Op, class = void>
struct Bf16Products : std::false_type {};
template <class Op>
struct Bf16Products<Op, std::void_t<decltype(Op::kBf16)>> : std::bool_constant<Op::kBf16> {};

// Dynamic shared memory of a BN-wide launch: two stages of a and b, as
// hi and lo (3xTF32) or as bf16.
template <int BN, bool kBf16>
constexpr int stage_bytes() {
  return kBf16 ? 2 * (kBM + BN) * kBK * 2 : 2 * 2 * (kBM + BN) * kBK * static_cast<int>(sizeof(float));
}

// An operand's a4 and b4 are looked up only where the loaders use them.
template <class Op, class Row>
__device__ __forceinline__ float4 read_a4(const Op& op, const Row& r, int k) {
  return op.a4(r, k);
}
template <class Op>
__device__ __forceinline__ float4 read_b4(const Op& op, int col, int k) {
  return op.b4(col, k);
}

template <int BN, class Op, class P>
__global__ void __launch_bounds__(kThreads) gemm_tc_kernel(const P p, int splits) {
  using LA = Loader<kBM, Op::kAByRow>;
  using LB = Loader<BN, Op::kBByRow>;
  constexpr int kAF = kBM * kBK;  // floats of one operand's tile in a stage
  constexpr int kBF = BN * kBK;
  constexpr int kStageF = 2 * (kAF + kBF);  // a stage: a hi, a lo, b hi, b lo
  constexpr bool kBf16 = Bf16Products<Op>::value;
  extern __shared__ __align__(128) float smem[];  // bf16 products: stages of kAF + kBF bf16

  const int m = blockIdx.z / splits;
  const int split = blockIdx.z % splits;
  const Op op(p, m);
  const int row0 = blockIdx.x * kBM;
  const int col0 = blockIdx.y * BN;
  const int per_split = (op.depth + splits * kBK - 1) / (splits * kBK) * kBK;
  const int k_begin = split * per_split;
  const int k_end = min(op.depth, k_begin + per_split);
  const int nslab = k_begin < k_end ? (k_end - k_begin + kBK - 1) / kBK : 0;
  const int t = threadIdx.x;

  // A thread's rows of a and columns of b stay the same over the k-loop: a's
  // resolve into ARows once (for a contiguous along rows, the first of each
  // block's 4). Rows past the edge stand in as the first row.
  typename Op::ARow ar[LA::kRows];
  bool a_ok[LA::kRows], b_ok[LB::kRows];
  int b_col[LB::kRows];
#pragma unroll
  for (int i = 0; i < LA::kRows; ++i) {
    const int row = row0 + LA::row(t, i);
    a_ok[i] = row < op.rows;
    ar[i] = op.arow(a_ok[i] ? row : row0);
  }
#pragma unroll
  for (int i = 0; i < LB::kRows; ++i) {
    const int col = col0 + LB::row(t, i);
    b_ok[i] = col < op.cols;
    b_col[i] = b_ok[i] ? col : col0;
  }
  LA la;
  LB lb;
  auto load = [&](int k0) {
    if constexpr (Op::kAByRow) {
      la.load(t, k0, k_end, row0, op.rows, op.vec,
              [&](int row, int k) { return op.a(op.arow(row), k); },
              [&](auto j, int k) { return read_a4(op, ar[j], k); });
    } else {
      la.load(t, k0, k_end, a_ok, op.vec, [&](int i, int k) { return op.a(ar[i], k); },
              [&](auto i, int k) { return read_a4(op, ar[i], k); });
    }
    if constexpr (Op::kBByRow) {
      lb.load(t, k0, k_end, col0, op.cols, op.vec, [&](int col, int k) { return op.b(col, k); },
              [&](auto j, int k) { return read_b4(op, b_col[j], k); });
    } else {
      lb.load(t, k0, k_end, b_ok, op.vec, [&](int i, int k) { return op.b(b_col[i], k); },
              [&](auto i, int k) { return read_b4(op, b_col[i], k); });
    }
  };
  auto stash = [&](int stage) {
    if constexpr (kBf16) {
      __nv_bfloat16* st = reinterpret_cast<__nv_bfloat16*>(smem) + stage * (kAF + kBF);
      la.stash_bf16(t, st);
      lb.stash_bf16(t, st + kAF);
    } else {
      float* st = smem + stage * kStageF;
      la.stash(t, st, st + kAF);
      lb.stash(t, st + 2 * kAF, st + 2 * kAF + kBF);
    }
    // make the generic-proxy stores visible to wgmma's async-proxy reads
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
  };

  float acc[BN / 2];
#pragma unroll
  for (int i = 0; i < BN / 2; ++i) acc[i] = 0.0f;
  // The registers hold slab s + 1 from the end of iteration s - 1 to its
  // split in iteration s, so each slab's loads fly across a whole product.
  if (nslab > 0) {
    load(k_begin);
    stash(0);
  }
  if (nslab > 1) load(k_begin + kBK);
  for (int s = 0; s < nslab; ++s) {
    __syncthreads();  // stage s % 2 is written; stage (s + 1) % 2 is no longer read
#pragma unroll
    for (int i = 0; i < BN / 2; ++i) fence_reg(acc[i]);
    wgmma_fence();
    if constexpr (kBf16) {
      const __nv_bfloat16* a = reinterpret_cast<const __nv_bfloat16*>(smem) + (s & 1) * (kAF + kBF);
      const __nv_bfloat16* b = a + kAF;
#pragma unroll
      for (int ks = 0; ks < kBK / 16; ++ks) {
        WgmmaBf16<BN>::mma(acc, operand_desc<kBM>(a + ks * kBM * 16), operand_desc<BN>(b + ks * BN * 16));
      }
    } else {
      const float* a_hi = smem + (s & 1) * kStageF;
      const float* a_lo = a_hi + kAF;
      const float* b_hi = a_hi + 2 * kAF;
      const float* b_lo = b_hi + kBF;
#pragma unroll
      for (int ks = 0; ks < kBK / 8; ++ks) {
        const int oa = ks * kBM * 8, ob = ks * BN * 8;
        Wgmma<BN>::mma(acc, operand_desc<kBM>(a_lo + oa), operand_desc<BN>(b_hi + ob));
        Wgmma<BN>::mma(acc, operand_desc<kBM>(a_hi + oa), operand_desc<BN>(b_lo + ob));
        Wgmma<BN>::mma(acc, operand_desc<kBM>(a_hi + oa), operand_desc<BN>(b_hi + ob));
      }
    }
    wgmma_commit();
#pragma unroll
    for (int i = 0; i < BN / 2; ++i) fence_reg(acc[i]);
    if (s + 1 < nslab) stash((s + 1) & 1);
    if (s + 2 < nslab) load(k_begin + (s + 2) * kBK);
    wgmma_wait_all();
#pragma unroll
    for (int i = 0; i < BN / 2; ++i) fence_reg(acc[i]);
  }

  // wgmma's accumulator layout: warp w holds rows 16w .. 16w + 15; in each
  // 8-column group j, lane l holds rows l / 4 and l / 4 + 8 at columns
  // 2 (l % 4) and 2 (l % 4) + 1: acc[j * 4 + i * 2 + c] is row l / 4 + 8 i,
  // column 8 j + 2 (l % 4) + c.
  if constexpr (Finishes<Op>::value) {
    op.template finish<BN>(acc, row0, col0, split, splits);
  } else {
    const int warp = t / 32, lane = t % 32;
#pragma unroll
    for (int j = 0; j < BN / 8; ++j)
#pragma unroll
      for (int i = 0; i < 2; ++i)
#pragma unroll
        for (int c = 0; c < 2; ++c) {
          const int row = row0 + warp * 16 + lane / 4 + 8 * i;
          const int col = col0 + j * 8 + (lane % 4) * 2 + c;
          if (row < op.rows && col < op.cols) op.store(row, col, split, acc[j * 4 + i * 2 + c]);
        }
  }
}

// Launch `Op` over a rows x cols output for `branches` branches, the depth
// split over `splits` blocks; returns the launch's cudaError_t as an int.
template <int BN, class Op, class P>
int launch_gemm_tc(const P& p, int rows, int cols, int branches, cudaStream_t stream,
                   int splits = 1) {
  constexpr int kBytes = stage_bytes<BN, Bf16Products<Op>::value>();
  static const cudaError_t attr = cudaFuncSetAttribute(
      gemm_tc_kernel<BN, Op, P>, cudaFuncAttributeMaxDynamicSharedMemorySize, kBytes);
  if (attr != cudaSuccess) return static_cast<int>(attr);
  const dim3 grid((rows + kBM - 1) / kBM, (cols + BN - 1) / BN, branches * splits);
  gemm_tc_kernel<BN, Op, P><<<grid, kThreads, kBytes, stream>>>(p, splits);
  return static_cast<int>(cudaGetLastError());
}

// Depth splits for a launch of `tiles` output tiles over all its branches:
// doubled while the launch has fewer than two blocks per SM and each split
// keeps at least four slabs. A function of the shapes alone.
inline int splits_for(int tiles, int depth, int max_splits = 16) {
  int s = 1;
  while (2 * s <= max_splits && tiles * s < 2 * kSMs && depth >= 2 * s * 4 * kBK) s *= 2;
  return s;
}

// out[m][i] = sum over s < splits of part[m][s * n + i], in split order, in
// fp32; a bf16 out takes the sum rounded.
template <class T>
struct SplitSumOf {
  const float* part[2];
  T* out[2];
  int n, splits;
};
using SplitSum = SplitSumOf<float>;

template <class T>
static __global__ void sum_splits_kernel(const SplitSumOf<T> q) {
  const int m = blockIdx.y;
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= q.n) return;
  const float* part = q.part[m] + i;
  float acc = 0.0f;
  for (int s = 0; s < q.splits; ++s) acc += part[static_cast<size_t>(s) * q.n];
  put(q.out[m] + i, acc);
}

template <class T>
inline int launch_sum_splits(const SplitSumOf<T>& q, int branches, cudaStream_t stream) {
  sum_splits_kernel<<<dim3((q.n + 255) / 256, branches), 256, 0, stream>>>(q);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace tc
