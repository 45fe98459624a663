// K3 — per-event splat: (B, C, E) f32 weights summed at integer (y, x) into
// a (B, H, W, C) f32 grid.
//
// Replaces eventpretrain_tpu/ops/pallas_voxel.py::splat_mxu. The TPU kernel
// turns the scatter into one-hot matrix products (all-pairs E*H*W work)
// because the TPU has no scatter unit; Hopper has fast float atomics in L2,
// so this is the plain O(E*C) scatter: one thread per (sample, event), which
// skips out-of-frame events and adds each nonzero channel weight with
// atomicAdd. What bounds it on the card is the atomic traffic to L2
// (E*C adds, ~4 B each; the 128x128x5 grid of a sample is 320 KB and stays
// in L2), not arithmetic. The caller zeroes the output first. Atomic order
// varies from run to run, so sums agree with the sequential scatter only to
// f32 rounding.
#include "common.cuh"

__global__ void splat_kernel(const int* __restrict__ y,
                             const int* __restrict__ x,
                             const float* __restrict__ w,
                             float* __restrict__ out, int C, int E, int H,
                             int W) {
  const int b = blockIdx.y;
  const int e = blockIdx.x * blockDim.x + threadIdx.x;
  if (e >= E) return;
  const long long ev = static_cast<long long>(b) * E + e;
  const int yi = y[ev];
  const int xi = x[ev];
  if (yi < 0 || yi >= H || xi < 0 || xi >= W) return;
  float* cell = out + ((static_cast<long long>(b) * H + yi) * W + xi) * C;
  const float* wb = w + static_cast<long long>(b) * C * E + e;
  for (int c = 0; c < C; ++c) {
    const float v = wb[static_cast<long long>(c) * E];
    if (v != 0.0f) atomicAdd(cell + c, v);
  }
}

extern "C" int splat_f32(const void* y, const void* x, const void* w,
                         void* out, int B, int C, int E, int H, int W,
                         void* stream) {
  if (B == 0 || E == 0) return 0;
  const dim3 block(256);
  const dim3 grid((E + 255) / 256, B);
  splat_kernel<<<grid, block, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int*>(y), static_cast<const int*>(x),
      static_cast<const float*>(w), static_cast<float*>(out), C, E, H, W);
  return static_cast<int>(cudaGetLastError());
}
