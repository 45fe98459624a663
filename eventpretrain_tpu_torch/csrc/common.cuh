// Shared helpers of the port's CUDA kernels (built for sm_90a by _build.py).
//
// Every launcher is a plain C function: pointers and the CUDA stream arrive
// as void* (ctypes.c_void_p), and the launcher returns the cudaError_t of
// its launch (cudaGetLastError() right after it), so a refused launch —
// too much shared memory, a bad grid — is reported to the Python wrapper,
// which raises. Launchers never synchronise and never allocate.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

typedef __nv_bfloat16 bf16;

extern "C" const char* kernel_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) {
    v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  }
  return v;
}

__device__ __forceinline__ float round_bf16(float v) {
  return __bfloat162float(__float2bfloat16(v));
}

// LayerNorm statistics of one bf16 row of length K (K even), computed by a
// whole warp with the TPU kernels' numerics (pallas_common.py:68-78): f32
// sums, var = E[x^2] - mean^2, rstd = rsqrt(var + eps). Every kernel that
// normalises a row (the GEMM prologue, the LN row kernels) calls this one
// function, and the explicit _rn intrinsics keep the compiler from
// contracting differently in each, so all of them see the same mu and rstd
// bit for bit.
__device__ __forceinline__ void ln_row_stats(const bf16* row, int K, float eps,
                                             int lane, float* mu_out,
                                             float* rstd_out) {
  const __nv_bfloat162* row2 = reinterpret_cast<const __nv_bfloat162*>(row);
  float s = 0.0f, ss = 0.0f;
  for (int k2 = lane; k2 < K / 2; k2 += 32) {
    const float2 v = __bfloat1622float2(row2[k2]);
    s = __fadd_rn(s, __fadd_rn(v.x, v.y));
    ss = __fadd_rn(ss, __fmaf_rn(v.y, v.y, __fmul_rn(v.x, v.x)));
  }
  s = warp_sum(s);
  ss = warp_sum(ss);
  const float mu = __fdiv_rn(s, static_cast<float>(K));
  const float var = __fsub_rn(__fdiv_rn(ss, static_cast<float>(K)),
                              __fmul_rn(mu, mu));
  *mu_out = mu;
  *rstd_out = rsqrtf(__fadd_rn(var, eps));
}

// xhat = (x - mu) * rstd
__device__ __forceinline__ float ln_xhat(float x, float mu, float rstd) {
  return __fmul_rn(__fsub_rn(x, mu), rstd);
}

// xhat * gamma + beta, in f32 (rounded by the caller)
__device__ __forceinline__ float ln_apply(float x, float mu, float rstd,
                                         float gamma, float beta) {
  return __fmaf_rn(ln_xhat(x, mu, rstd), gamma, beta);
}

// Exact GELU and its derivative, d/dx x*Phi(x) = Phi(x) + x*phi(x). The TPU
// kernels approximate erf with Abramowitz-Stegun 7.1.26 (|err| < 1.5e-7,
// fused_mlp.py:81-103); erff is CUDA's own.
__device__ __forceinline__ float gelu_erf(float v) {
  return v * 0.5f * (1.0f + erff(v * 0.7071067811865476f));
}

__device__ __forceinline__ float gelu_erf_grad(float v) {
  const float cdf = 0.5f * (1.0f + erff(v * 0.7071067811865476f));
  const float pdf = 0.3989422804014327f * expf(-0.5f * v * v);
  return cdf + v * pdf;
}
