// K8 — the per-event scatter voxelizer: raw (B, E, 4) xytp events and (B,)
// counts to (B, H, W, bins) f32 temporal-bilinear voxel grids, in one pass.
//
// Replaces eventpretrain_tpu/ops/pallas_voxel.py::voxelize_batch_pallas (:97),
// whose kernel _voxel_kernel (:32) walks one sample's events in order and
// adds two weights per event into the sample's grid in VMEM. It computes,
// per event of sample b with count n:
//   window   t0 = t[0], t1 = t[max(n - 1, 0)], dt = t1 - t0 (0 taken as 1);
//   time     ts = (bins - 1) * (t - t0) / dt, tis = floor(ts), dts = ts - tis;
//   value    p (0 taken as -1); x, y truncated toward zero;
//   adds     p * (1 - dts) at bin tis and p * dts at bin tis + 1 of cell
//            (y, x), each where the event is one of the n, in frame, and its
//            bin lies in [0, bins).
// floor(ts) picks the bin, so every step is an IEEE _rn intrinsic: no
// contraction, no fast division; an event on a bin edge lands where the plain
// version puts it.
//
// Unlike K3 (csrc/splat.cu), which receives (B, bins, E) weights computed
// first, this reads only the events: 16 bytes per event in, at most two f32
// atomicAdds per event out. One thread per (sample, event); a block covers
// `chunk` events of one sample. What bounds it on this card is the atomic
// traffic to L2 (a DSEC-shape grid, 440x640x5 f32, is 5.6 MB a sample) and
// the zeroing of the grid by the caller, not arithmetic. Atomic order varies
// from run to run, so sums agree with the sequential scatter only to f32
// rounding.
#include "common.cuh"

__global__ void voxel_scatter_kernel(const float4* __restrict__ events,
                                     const int* __restrict__ counts,
                                     float* __restrict__ out, int E, int H,
                                     int W, int bins, int chunk) {
  const int b = blockIdx.y;
  const int n = counts[b];
  const float4* ev = events + static_cast<long long>(b) * E;
  const float t0 = ev[0].z;
  const float t1 = ev[min(max(n - 1, 0), E - 1)].z;
  float dt = __fsub_rn(t1, t0);
  if (dt == 0.0f) dt = 1.0f;
  const int first = static_cast<int>(blockIdx.x) * chunk;
  const int end = min(min(n, E), first + chunk);
  float* grid = out + static_cast<long long>(b) * H * W * bins;
  const float nb1 = static_cast<float>(bins - 1);
  for (int e = first + static_cast<int>(threadIdx.x); e < end;
       e += static_cast<int>(blockDim.x)) {
    const float4 x = ev[e];
    const int xi = __float2int_rz(x.x);
    const int yi = __float2int_rz(x.y);
    if (xi < 0 || xi >= W || yi < 0 || yi >= H) continue;
    const float ts = __fdiv_rn(__fmul_rn(nb1, __fsub_rn(x.z, t0)), dt);
    const float tis = floorf(ts);
    if (!(tis >= 0.0f) || !(tis < static_cast<float>(bins))) continue;
    const float dts = __fsub_rn(ts, tis);
    const float p = x.w == 0.0f ? -1.0f : x.w;
    const int bin = static_cast<int>(tis);
    float* cell = grid + (static_cast<long long>(yi) * W + xi) * bins + bin;
    const float wl = __fmul_rn(p, __fsub_rn(1.0f, dts));
    if (wl != 0.0f) atomicAdd(cell, wl);
    if (bin + 1 < bins) {
      const float wr = __fmul_rn(p, dts);
      if (wr != 0.0f) atomicAdd(cell + 1, wr);
    }
  }
}

// events (B, E, 4) f32 contiguous; counts (B,) int32; out (B, H, W, bins) f32
// zeroed by the caller.
extern "C" int voxel_scatter_f32(const void* events, const void* counts,
                                 void* out, int B, int E, int H, int W,
                                 int bins, int chunk, void* stream) {
  if (B == 0 || E == 0) return 0;
  const int threads = chunk < 256 ? chunk : 256;
  const dim3 grid((E + chunk - 1) / chunk, B);
  voxel_scatter_kernel<<<grid, threads, 0,
                         static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float4*>(events), static_cast<const int*>(counts),
      static_cast<float*>(out), E, H, W, bins, chunk);
  return static_cast<int>(cudaGetLastError());
}
