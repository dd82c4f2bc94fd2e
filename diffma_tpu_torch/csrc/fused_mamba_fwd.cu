// The Mamba-1 mixer's inner part for Hopper (sm_90a), on streams that arrive
// gathered and projected: causal conv + SiLU, x_proj, dt_proj, softplus, the
// selective scan, the D skip and the silu(z) gate, in one call.
//
// Replaces the TPU kernel diffma_tpu/ops/fused_mamba.py::_fused_kernel, as
// its launcher _fused_fwd_impl drives it. Per sequence g, with xz (L, 2d) =
// [u0 | z], d = d_inner, n = d_state = 16, r = dt_rank <= 32, K = 4 taps:
//
//     u   = silu(causal_conv_K(u0) + conv_b)                (zero left pad)
//     xdb = u . W_x^T  -> dt_r (r), B (n), C (n)
//     dt  = softplus(dt_r . W_dt^T + dt_b)
//     h_t = exp(dt A) h_{t-1} + dt u B_t;  y = <C_t, h_t> + D u
//     out = y * silu(z)                                      (L, d)
//
// A is given itself (negative), not as its logarithm. Everything is fp32 on
// the CUDA cores (no TF32). The two products are the kernel's own: x_proj is
// gemm_nt.cuh's GEMM, dt_proj runs inside the recurrence.
//
// Bound on an H100 SXM (67 TFLOP/s fp32 outside the tensor cores, 3.35 TB/s).
// At the shapes of three DiffMa-B/2 streams (G = 3, L = 196, d = 1024,
// r = 32) the call does 0.18 GFLOP (x_proj 77 M, dt_proj 39 M, the scan 63 M,
// the conv 5 M), 2.7 us at the fp32 rate, against 7.7 MB that must move (xz
// 4.8 MB, out 2.4 MB, the weights 0.5 MB), 2.3 us: the two bounds lie close,
// operations first. The scan's chain of L dependent steps takes far longer
// than either at this size (kernel A, the same recurrence, takes 0.12 ms).
//
// Design, simple and right first: the two stages of mixer_core.cuh, which
// kernel C (fused_mixer_fwd.cu) shares, with no gather table (step t of
// sequence g is row t of its xz), one stream per sequence, and y written
// straight into the output. u and xdb live in a workspace the caller
// allocates (mamba_inner_workspace_floats), 2.5 MB at G = 3, which stays in
// L2. The TPU kernel's 16-step chunks, its VMEM scratch and its zero padding
// of L to a multiple of 16 exist for VMEM; here L is masked and nothing is
// padded.
//
// It has no backward kernel, in either package: the gradient recomputes the
// function through the composable operators (the scan kernels A and B).

#include <cuda_runtime.h>
#include <stdint.h>

#include "mixer_core.cuh"

// Floats of workspace that mamba_inner_fwd needs for these shapes.
extern "C" long long mamba_inner_workspace_floats(int G, int L, int d, int r) {
  return static_cast<long long>(G) * L * (d + r + 2 * mixer::kN);
}

// All pointers fp32 and contiguous: xz (G, L, 2d), conv_w (d, K), conv_b (d,),
// xp_w (r + 2n, d), dt_w (d, r), dt_b (d,), A (d, n), D (d,), out (G, L, d).
// Launches two kernels on `stream`; returns the first launch's cudaError_t
// that is not 0, or -1 for shapes that are not built.
extern "C" int mamba_inner_fwd(const void* xz, const void* conv_w, const void* conv_b,
                               const void* xp_w, const void* dt_w, const void* dt_b,
                               const void* A, const void* D, void* out, void* workspace,
                               int G, int L, int d, int n, int r, int K, void* stream) {
  if (n != mixer::kN || K != mixer::kConv || r < 1 || r > mixer::kMaxRank || G < 1 || L < 1 ||
      d < 1) {
    return -1;
  }
  mixer::Inner in{};
  in.w[0] = mixer::Weights{
      static_cast<const float*>(conv_w), static_cast<const float*>(conv_b),
      static_cast<const float*>(xp_w),   static_cast<const float*>(dt_w),
      static_cast<const float*>(dt_b),   static_cast<const float*>(A),
      static_cast<const float*>(D)};
  in.fwd = nullptr;
  in.xz = static_cast<const float*>(xz);
  in.u = static_cast<float*>(workspace);
  in.xdb = in.u + static_cast<size_t>(G) * L * d;
  in.y = static_cast<float*>(out);
  in.B = G;
  in.L = L;
  in.Ls = L;
  in.d = d;
  in.r = r;
  in.S = 1;
  in.y_streams = 1;
  in.a_is_log = false;
  return mixer::launch_inner(in, 1, static_cast<cudaStream_t>(stream));
}
