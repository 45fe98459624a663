// K3 — per-event splat: (B, C, E) f32 weights summed at integer (y, x) into
// a (B, H, W, C) f32 grid.
//
// Replaces eventpretrain_tpu/ops/pallas_voxel.py::splat_mxu (+
// voxelize_batch_mxu). The TPU kernel turns the scatter into one-hot matrix
// products (all-pairs E*H*W work) because the TPU has no scatter unit; here
// it is a scatter, by one of two routes that ops/splat.py::splat_route picks
// from the batch's shape:
//
// "cluster" (splat_cluster_f32), wherever a sample's grid fits a cluster of
// at most 8 CTAs' shared memory (the N-Cars canvas, 128x128x5 in two CTAs
// of 3 and 2 channels) and the batch's clusters fill most of the SMs:
// csrc/splat_core.cuh, one cluster a sample. What
// bounds it is the bytes (the weights read once, the coordinates once a
// CTA, the grid written once in whole 16-byte rows) and the shared-memory
// adds (a compare-and-swap loop each on this card). The sums stay in
// shared memory, so there is no zero fill and no global atomic: the output
// is written exactly once.
//
// "global" (splat_f32, the first port's body) for the larger grids (DSEC's
// 440x640x5, MVSEC's 260x346x5 when tiling is off) and small batches, where
// a cluster a sample would leave most SMs idle: one thread per (sample,
// event) adds each nonzero channel weight with a global atomicAdd into a
// grid the caller zeroes first; bound by the atomic traffic to L2.
//
// Atomic order varies from run to run on both routes, so sums agree with the
// sequential scatter only to f32 rounding.
#include "splat_core.cuh"

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

namespace splat {

// A plane is sample p's whole grid and all its events.
struct SampleSource {
  __device__ int first(const Args&, int) const { return 0; }

  __device__ Plane plane(const Args& a, const Geom&, int p, int) const {
    Plane pl;
    pl.b = p;
    pl.y0 = 0;
    pl.x0 = 0;
    pl.ylim = a.H;
    pl.xlim = a.W;
    pl.c0 = 0;
    pl.cph = a.C;
    pl.lo = 0;
    pl.hi = a.E;
    return pl;
  }

  // every slot may touch every channel
  __device__ void clamp(const Args&, const Plane&, int, int&, int&) const {}
};

}  // namespace splat

// The cluster route: one cluster of `cluster` CTAs a sample, each holding
// `cp` channels of the H x W grid in `smem` bytes of dynamic shared memory
// (at least what that takes).
extern "C" int splat_cluster_f32(const void* y, const void* x, const void* w,
                                 void* out, int B, int C, int E, int H, int W,
                                 int cluster, int cp, int smem,
                                 void* stream) {
  if (B == 0 || C == 0 || H == 0 || W == 0) return 0;
  splat::Geom g;
  g.rows = H;
  g.cols = W;
  g.cp = cp;
  g.vec_in = splat::inputs_vectorizable(y, x, w, E);
  const splat::Args a{static_cast<const int*>(y), static_cast<const int*>(x),
                      static_cast<const float*>(w), static_cast<float*>(out),
                      C, E, H, W};
  return splat::launch(a, g, splat::SampleSource{}, B, cluster, C, smem,
                       static_cast<cudaStream_t>(stream));
}

extern "C" int splat_cluster_occupancy(int cluster, int smem, int* out) {
  return splat::max_active_clusters<splat::SampleSource>(cluster, smem, out);
}
