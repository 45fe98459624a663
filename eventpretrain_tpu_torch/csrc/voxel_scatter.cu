// K8 — the per-event scatter voxelizer: raw (B, E, 4) xytp events and (B,)
// counts to (B, H, W, bins) f32 temporal-bilinear voxel grids, in one launch
// that writes every cell of its output itself.
//
// Replaces eventpretrain_tpu/ops/pallas_voxel.py::voxelize_batch_pallas (:97),
// whose kernel _voxel_kernel (:32) zeroes one sample's grid in VMEM, walks
// the sample's events in order and adds two weights per event. It computes,
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
// What bounds it on this card: the events below the counts read once (16
// bytes each) and the grids written once, ~123 MB at DSEC's shape (16 x
// 200000 events, 440x640x5: a grid is 5.6 MB, the batch 90 MB, almost twice
// the 50 MB L2); and ~4.2 M f32 adds at cells spread over the grids. Every
// global reduction, scalar, .v2 or .v4, runs at ~90 G a second into a grid
// that stays in L2 and ~20 G past it (tools/splat_adds.cu), so the adds must
// land in L2 and move as few reductions as they can.
//
// The design (ops/splat.py::voxel_scatter_plan plans it; its ticket order
// is modelled in Python for the CPU tests):
// - One persistent launch, one 512-thread CTA an SM. A CTA takes work items
//   in ticket order from a counter in a workspace of B + 1 ints (the
//   counter, then zero_done[B]) that the launcher clears. A zero item writes
//   one span of `zero_span` floats of one sample's grid with 16-byte
//   stores, then thread 0 publishes with a release (a fence after the
//   barrier, then an add to zero_done[s]) while the other threads go on. An
//   add item takes `chunk` events of one sample: its threads load their
//   events while thread 0 waits, with acquire loads, until every zero item
//   of the sample has published; then they add.
// - The order: the zero items of samples 0 .. D-1, then for each sample s
//   the zero items of sample s + D and the add items of sample s. The zero
//   stores bring the lines into L2, the adds that follow hit there, and each
//   grid reaches DRAM once, by eviction. The grids open at once (zeroed, not
//   finished) are D + 1 and those the tickets in flight reach; the plan
//   keeps them within a third of the L2, the knee measured on the H100
//   (more open grids, more adds miss). Events are read with streaming loads
//   (evict first). No persisting-L2 carve-out or access-policy window: those
//   are device state shared with every other kernel.
// - No deadlock: a CTA only ever waits on tickets smaller than its own, and
//   those belong to CTAs that took them, so are running or done, however
//   many CTAs are resident. A CTA takes its next ticket only once its item
//   waits no more, so no ticket is held by a waiting CTA (that convoy made
//   zeroing run late); it reads the result at the item's end.
// - Vector reductions: the grid is channels-last, so an event's two adds
//   (bins k, k + 1 of one cell) are adjacent floats. With i = cell * bins + k
//   (each sample's grid is 512-byte aligned: H * W * bins % 128 == 0), i % 4
//   in {0, 2} sends both as one red.global.add.v2.f32, i % 4 == 1 as one
//   red.global.add.v4.f32 with +0.0 in lanes 0 and 3, i % 4 == 3 as two
//   scalar reds: 1.25 reductions an event instead of 2. A cell starts at
//   +0.0 and a sum of non-zero weights never becomes -0.0, so adding +0.0
//   leaves every cell's bits as they were; a zero weight is never added on
//   its own (ops/splat.py::voxel_scatter_ops is the same selection).
// Atomic order varies from run to run, so sums agree with the sequential
// scatter only to f32 rounding.
#include "common.cuh"

constexpr int kThreads = 512;
constexpr int kUnroll = 4;  // events a thread keeps in flight

struct VoxelPlan {
  int B, E, H, W, bins;
  int zero_span;   // floats a zero item writes
  int zero_items;  // zero items a sample
  int chunk;       // events an add item takes
  int add_items;   // add items a sample: ceil(E / chunk)
  int lookahead;   // D: samples zeroed ahead of the one being added
};

// Ticket t -> (is_zero, sample, item index within the sample's items of that
// kind); ops/splat.py::voxel_scatter_item is the same arithmetic.
__device__ __forceinline__ void item_of(const VoxelPlan& p, int t, bool* zero,
                                        int* s, int* i) {
  const int d = min(p.lookahead, p.B);
  const int prologue = d * p.zero_items;
  if (t < prologue) {
    *zero = true;
    *s = t / p.zero_items;
    *i = t % p.zero_items;
    return;
  }
  const int u = t - prologue;
  const int block = p.zero_items + p.add_items;
  const int paired = p.B - d;  // samples whose adds follow a zero block
  if (u < paired * block) {
    const int r = u % block;
    *zero = r < p.zero_items;
    *s = u / block + (*zero ? d : 0);
    *i = *zero ? r : r - p.zero_items;
    return;
  }
  const int v = u - paired * block;
  *zero = false;
  *s = paired + v / p.add_items;
  *i = v % p.add_items;
}

__device__ __forceinline__ int load_acquire(const int* ptr) {
  int v;
  asm volatile("ld.acquire.gpu.global.b32 %0, [%1];"
               : "=r"(v) : "l"(ptr) : "memory");
  return v;
}

__device__ __forceinline__ void red_release(int* a) {
  asm volatile("fence.acq_rel.gpu;\n\tred.relaxed.gpu.global.add.s32 [%0], 1;"
               ::"l"(a) : "memory");
}

__device__ __forceinline__ void red_add(float* a, float v) {
  asm volatile("red.global.add.f32 [%0], %1;" ::"l"(a), "f"(v) : "memory");
}

__device__ __forceinline__ void red_add2(float* a, float v0, float v1) {
  asm volatile("red.global.add.v2.f32 [%0], {%1, %2};"
               ::"l"(a), "f"(v0), "f"(v1) : "memory");
}

__device__ __forceinline__ void red_add4(float* a, float v0, float v1,
                                         float v2, float v3) {
  asm volatile("red.global.add.v4.f32 [%0], {%1, %2, %3, %4};"
               ::"l"(a), "f"(v0), "f"(v1), "f"(v2), "f"(v3) : "memory");
}

// Events base, base + kThreads, ... (kUnroll of them) below lim, with
// streaming loads (evict first: the grids are what L2 should keep).
__device__ __forceinline__ void load_events(float4 (&x)[kUnroll],
                                            const float4* ev, int base,
                                            int lim) {
#pragma unroll
  for (int u = 0; u < kUnroll; ++u) {
    const int e = base + u * kThreads;
    if (e < lim) x[u] = __ldcs(ev + e);
  }
}

// One event's adds into its sample's grid.
__device__ __forceinline__ void scatter_event(const float4 x, float* grid,
                                              float t0, float dt, int H,
                                              int W, int bins) {
  const int xi = __float2int_rz(x.x);
  const int yi = __float2int_rz(x.y);
  if (xi < 0 || xi >= W || yi < 0 || yi >= H) return;
  const float nb1 = static_cast<float>(bins - 1);
  const float ts = __fdiv_rn(__fmul_rn(nb1, __fsub_rn(x.z, t0)), dt);
  const float tis = floorf(ts);
  if (!(tis >= 0.0f) || !(tis < static_cast<float>(bins))) return;
  const float dts = __fsub_rn(ts, tis);
  const float p = x.w == 0.0f ? -1.0f : x.w;
  const int bin = static_cast<int>(tis);
  const int i = (yi * W + xi) * bins + bin;
  float* cell = grid + i;
  const float wl = __fmul_rn(p, __fsub_rn(1.0f, dts));
  const float wr = bin + 1 < bins ? __fmul_rn(p, dts) : 0.0f;
  if (wl != 0.0f && wr != 0.0f) {
    switch (i & 3) {
      case 0:
      case 2:
        red_add2(cell, wl, wr);
        break;
      case 1:
        red_add4(cell - 1, 0.0f, wl, wr, 0.0f);
        break;
      default:
        red_add(cell, wl);
        red_add(cell + 1, wr);
    }
  } else if (wl != 0.0f) {
    red_add(cell, wl);
  } else if (wr != 0.0f) {
    red_add(cell + 1, wr);
  }
}

__global__ void __launch_bounds__(kThreads)
    voxel_scatter_kernel(const float4* __restrict__ events,
                         const int* __restrict__ counts,
                         float* __restrict__ out, int* work, VoxelPlan p) {
  __shared__ int s_ticket[2];
  __shared__ float s_t0, s_dt;
  int* next = work;
  int* zero_done = work + 1;
  const int tid = static_cast<int>(threadIdx.x);
  const long long cells = static_cast<long long>(p.H) * p.W * p.bins;
  const int total = p.B * (p.zero_items + p.add_items);
  int ready = -1;  // thread 0: a sample whose zero items all published
  int ticket = 0;  // thread 0: the next ticket, read only at an item's end
  if (tid == 0) s_ticket[0] = atomicAdd(next, 1);
  __syncthreads();
  for (int buf = 0;; buf ^= 1) {
    const int t = s_ticket[buf];
    if (t >= total) break;
    bool zero;
    int s, i;
    item_of(p, t, &zero, &s, &i);
    float* grid = out + s * cells;
    const float4* ev = events + static_cast<long long>(s) * p.E;
    if (zero) {
      if (tid == 0) ticket = atomicAdd(next, 1);
      const long long lo = static_cast<long long>(i) * p.zero_span;
      const long long left = cells - lo;
      const int n4 = static_cast<int>(left < p.zero_span ? left
                                                         : p.zero_span) / 4;
      float4* dst = reinterpret_cast<float4*>(grid + lo);
      const float4 z = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
      for (int j = tid; j < n4; j += kThreads) dst[j] = z;
      if (tid == 0) s_ticket[buf ^ 1] = ticket;
      // the CTA's stores, then a release of the count, cumulative over the
      // barrier; the other threads go on to the next item meanwhile
      __syncthreads();
      if (tid == 0) red_release(zero_done + s);
      continue;
    }
    const int first = i * p.chunk;
    const int n = counts[s];
    const int end = min(min(max(n, 0), p.E), first + p.chunk);
    // the item's first events, loaded while thread 0 waits: they do not
    // depend on the zero items
    float4 x[kUnroll];
    int base = first + tid;
    load_events(x, ev, base, end);
    if (tid == 0) {
      // the window's loads go out before the wait, and land during it
      const float t0 = ev[0].z;
      const float t1 = ev[min(max(n - 1, 0), p.E - 1)].z;
      if (ready != s) {
        while (load_acquire(zero_done + s) < p.zero_items) {
          __nanosleep(128);
        }
        ready = s;
      }
      const float dt = __fsub_rn(t1, t0);
      s_t0 = t0;
      s_dt = dt == 0.0f ? 1.0f : dt;
      // the next ticket only once this item waits no more: a CTA never
      // holds a ticket while it waits on others
      ticket = atomicAdd(next, 1);
    }
    __syncthreads();
    const float t0 = s_t0, dt = s_dt;
    for (;;) {
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        if (base + u * kThreads < end) {
          scatter_event(x[u], grid, t0, dt, p.H, p.W, p.bins);
        }
      }
      base += kThreads * kUnroll;
      if (base >= end) break;
      load_events(x, ev, base, end);
    }
    if (tid == 0) s_ticket[buf ^ 1] = ticket;
    // every thread is done with this item's ticket and shared values, and
    // the next ticket is visible
    __syncthreads();
  }
}

// CTAs of the kernel one SM holds at once.
extern "C" int voxel_scatter_occupancy(int* blocks_per_sm) {
  cudaError_t err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      blocks_per_sm, voxel_scatter_kernel, kThreads, 0);
  return static_cast<int>(err);
}

// events (B, E, 4) f32 contiguous; counts (B,) int32; out (B, H, W, bins)
// f32, 16-byte aligned, every cell written here; workspace (B + 1) int32:
// the ticket counter and zero_done, cleared here.
// The plan's numbers come from ops/splat.py.
extern "C" int voxel_scatter_f32(const void* events, const void* counts,
                                 void* out, void* workspace, int B, int E,
                                 int H, int W, int bins, int zero_span,
                                 int zero_items, int chunk, int add_items,
                                 int lookahead, int ctas, void* stream) {
  if (B == 0) return 0;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t err =
      cudaMemsetAsync(workspace, 0, sizeof(int) * (B + 1), st);
  if (err != cudaSuccess) return static_cast<int>(err);
  const VoxelPlan p{B, E, H, W, bins, zero_span, zero_items, chunk, add_items,
               lookahead};
  voxel_scatter_kernel<<<ctas, kThreads, 0, st>>>(
      static_cast<const float4*>(events), static_cast<const int*>(counts),
      static_cast<float*>(out), static_cast<int*>(workspace), p);
  return static_cast<int>(cudaGetLastError());
}
