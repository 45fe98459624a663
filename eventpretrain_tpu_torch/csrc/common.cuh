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
