// bf16 rounding shared by the tensor-core GEMM (gemm_tc.cuh) and the chunked
// SSD (ssd_core.cuh): the bf16 variants round where the JAX package casts
// to bf16, and keep the value in fp32 after.

#pragma once

#include <cuda_bf16.h>

// v rounded to bf16 (to nearest even) and back
__device__ __forceinline__ float round_bf16(float v) { return __bfloat162float(__float2bfloat16_rn(v)); }
