// The cluster-plane body of the two splats, K3 (splat.cu) and K6
// (splat_tiled.cu): f32 weights of events at integer (y, x) summed into a
// channels-last f32 grid.
//
// The unit is a plane: one sample's whole grid (K3), or one tile of one
// sample (K6; a group of its channels where more than a cluster holds). A
// plane is held in shared memory, cut by channels over the CTAs of a
// thread-block cluster: CTA r holds channels [r*cp, (r+1)*cp) of every cell,
// channels-last. A 128x128x5 plane is 320 KB, more than a CTA's 227 KB, so
// it takes two CTAs, of 3 and 2 channels (192 and 128 KB). The host planner
// (ops/splat.py::splat_plan) picks the cluster size and cp.
//
// Why channels and not rows: a float add into shared memory is a
// compare-and-swap loop on this card (ATOMS.CAST.SPIN), and one into
// another CTA's shared memory a loop of round trips across the cluster,
// about 7x slower again (tools/splat_adds.cu). Cut by channels, every add
// lands in the CTA's own shared memory. The price is that each CTA reads
// the coordinates of every event of the plane (the second read is mostly
// an L2 hit while the cluster runs together), but only its own channels'
// weights.
//
// Per plane: every CTA zeroes its part; every CTA walks the plane's events,
// each of 1024 threads 4 consecutive events at a time (16-byte loads where
// the rows allow them), their coordinates and the weights of its channels
// loaded before any is added; 32 warps an SM keep enough loads in flight
// without a staging ring (the plane takes the shared memory). K6 skips the
// channels outside each chunk's bin range, and a chunk none of whose
// channels the CTA holds costs it no load. An event outside its plane (its
// chunk's tile, or past row H or column W) adds nothing. After a cluster
// sync, CTA r writes rows [r*h, (r+1)*h) of the plane, cropped to the grid,
// each output row in order, every value read from the CTA that holds its
// channel (distributed shared memory loads) through a map of the row. A
// last cluster sync keeps every CTA's memory alive until all have read it.
// So the weights are read once, every output cell is written once, and
// nothing is zero-filled or added in device memory.
//
// What bounds it: the bytes, in the adds phase (it streams at the card's
// rate) and in the write (each SM stores ~32 bytes a cycle); and the
// phases of one plane run one after the other in each CTA, so a CTA's
// zeroing, table count and cluster syncs leave its SM's share of the
// memory rate idle (tools/compare_splat.py).
//
// The sums are exact f32 up to the order of the additions, which varies
// from run to run (atomics).
#pragma once

#include <cooperative_groups.h>

#include "common.cuh"

namespace splat {

namespace cg = cooperative_groups;

constexpr int kThreads = 1024;
constexpr int kChans = 4;  // the most channels a CTA holds

// The launch plan's geometry, the same for every plane of a launch.
struct Geom {
  int rows, cols;    // plane rows and columns (K3: H x W; K6: the tile)
  int cp;            // channels a CTA holds
  int plane_floats;  // rows * cols * cp, rounded up to a multiple of 4
  int vec_in;        // event rows 16-byte aligned: 4 events a load
  int row_map;       // room after the part for write_rows' map of a row
};

// One plane.
struct Plane {
  int b;           // sample
  int y0, x0;      // the plane's first cell in the grid
  int ylim, xlim;  // its rows and columns inside the grid (the crop)
  int c0, cph;     // its channels [c0, c0 + cph)
  int lo, hi;      // its events: slots [lo, hi) of sample b
};

struct Args {
  const int* y;
  const int* x;
  const float* w;
  float* out;
  int C, E, H, W;
};

template <int V>
__device__ __forceinline__ void load_ints(const int* p, int (&v)[V]) {
  if constexpr (V == 4) {
    const int4 q = __ldg(reinterpret_cast<const int4*>(p));
    v[0] = q.x;
    v[1] = q.y;
    v[2] = q.z;
    v[3] = q.w;
  } else {
    v[0] = __ldg(p);
  }
}

template <int V>
__device__ __forceinline__ void load_floats(const float* p, float (&v)[V]) {
  if constexpr (V == 4) {
    const float4 q = __ldg(reinterpret_cast<const float4*>(p));
    v[0] = q.x;
    v[1] = q.y;
    v[2] = q.z;
    v[3] = q.w;
  } else {
    v[0] = __ldg(p);
  }
}

// An add of one f32 into this CTA's shared memory, by its 32-bit
// shared-window address. The card has no shared-memory float add: this is
// a compare-and-swap loop (ATOMS.CAST.SPIN), ~1.2 adds a cycle an SM with
// every SM busy (tools/splat_adds.cu).
__device__ __forceinline__ void red_add_local(unsigned addr, float v) {
  asm volatile("red.shared.add.f32 [%0], %1;\n" ::"r"(addr), "f"(v)
               : "memory");
}

// A load of one f32 from shared memory: this CTA's, or another CTA's of
// the cluster (mapa, then ld.shared::cluster).
__device__ __forceinline__ float load_cell(unsigned addr, int owner,
                                           int rank) {
  float v;
  if (owner == rank) {
    asm volatile("ld.shared.f32 %0, [%1];\n" : "=f"(v) : "r"(addr));
  } else {
    unsigned remote;
    asm volatile("mapa.shared::cluster.u32 %0, %1, %2;\n"
                 : "=r"(remote)
                 : "r"(addr), "r"(owner));
    asm volatile("ld.shared::cluster.f32 %0, [%1];\n"
                 : "=f"(v)
                 : "r"(remote));
  }
  return v;
}

// One thread's group of V consecutive slots: coordinates, the weights of
// the CTA's channels (at most kChans) and the channels its chunk may touch.
template <int V>
struct Group {
  int y[V], x[V];
  float w[kChans][V];
  int clo, chi;  // empty (clo > chi) past the plane's slots
};

template <int V, class Src>
__device__ __forceinline__ void load_group(const Args& a, const Src& src,
                                           const Plane& pl, int e, int mlo,
                                           int mhi, Group<V>& gr) {
  const long long row = static_cast<long long>(pl.b) * a.E;
  gr.clo = mlo;
  gr.chi = mhi - 1;
  if (e < pl.hi) {
    src.clamp(a, pl, e, gr.clo, gr.chi);
  } else {
    gr.chi = gr.clo - 1;
  }
  if (gr.clo > gr.chi) return;
  load_ints<V>(a.y + row + e, gr.y);
  load_ints<V>(a.x + row + e, gr.x);
  const float* wb = a.w + row * a.C + e;
#pragma unroll
  for (int k = 0; k < kChans; ++k) {
    const int c = mlo + k;
    if (c >= gr.clo && c <= gr.chi) {
      load_floats<V>(wb + static_cast<long long>(c) * a.E, gr.w[k]);
    } else {
#pragma unroll
      for (int i = 0; i < V; ++i) gr.w[k][i] = 0.0f;
    }
  }
}

// Add a group's nonzero in-plane weights into this CTA's part.
template <int V>
__device__ __forceinline__ void add_group(const Geom& g, const Plane& pl,
                                          const Group<V>& gr, unsigned part) {
  if (gr.clo > gr.chi) return;
#pragma unroll
  for (int i = 0; i < V; ++i) {
    const int ly = gr.y[i] - pl.y0;
    const int lx = gr.x[i] - pl.x0;
    if (static_cast<unsigned>(ly) >= static_cast<unsigned>(pl.ylim) ||
        static_cast<unsigned>(lx) >= static_cast<unsigned>(pl.xlim)) {
      continue;
    }
    const unsigned cell = part + 4u * ((ly * g.cols + lx) * g.cp);
#pragma unroll
    for (int k = 0; k < kChans; ++k) {
      const float v = gr.w[k][i];
      if (v != 0.0f) red_add_local(cell + 4u * k, v);
    }
  }
}

// Add the plane's events into this CTA's channels [mlo, mhi) (at most
// kChans) at `part`, its shared memory: each thread takes groups of V
// consecutive slots kThreads * V apart, loads a group, then adds it. With
// 32 warps an SM, the others' loads are in flight while one adds (a deeper
// prefetch in registers, or two groups a thread, measured no faster).
template <int V, class Src>
__device__ __forceinline__ void add_events(const Args& a, const Geom& g,
                                           const Src& src, const Plane& pl,
                                           unsigned part, int mlo, int mhi) {
  for (int e = pl.lo + threadIdx.x * V; e < pl.hi; e += kThreads * V) {
    Group<V> gr;
    load_group<V>(a, src, pl, e, mlo, mhi, gr);
    add_group<V>(g, pl, gr, part);
  }
}

// Write rows [rank * h, (rank + 1) * h) of the plane (h = ceil(ylim / n)),
// cropped to the grid, each value read from the CTA that holds its channel.
//
// A plane of all C channels (`row_map` set) writes each output row of
// xlim x C floats in order, a float a thread, consecutive threads on
// consecutive floats: every warp's store fills whole 32-byte sectors (an
// SM stores ~32 bytes a cycle, and a store that fills part of a sector
// costs as much as a full one), and a warp reads the map and its cells
// from nearby shared-memory words, with few bank conflicts (4 floats a
// thread, 16 bytes apart, hit each bank 4 times and took 3x as long).
// row_map[f] says where float f of a row lives, (owner CTA << 24) | (its
// word in the owner's row of cols x cp words), so the gather does no
// division, and each thread steps over its floats by kThreads without one.
//
// A plane of a channel group writes each cell's cph channels at stride C,
// a float a thread.
__device__ __forceinline__ void write_rows(const Args& a, const Geom& g,
                                           const Plane& pl, unsigned part,
                                           const int* row_map, int rank,
                                           int n) {
  const int h = (pl.ylim + n - 1) / n;
  const int r0 = rank * h;
  const int rows = max(0, min(h, pl.ylim - r0));
  const int len = pl.xlim * pl.cph;  // floats of an output row
  const long long out_row = static_cast<long long>(a.W) * a.C;
  const int stride = g.cols * g.cp;  // words of a part's row
  float* out =
      a.out +
      ((static_cast<long long>(pl.b) * a.H + pl.y0 + r0) * a.W + pl.x0) *
          a.C +
      pl.c0;
  if (row_map != nullptr) {
    if (len == 0) return;
    int i = threadIdx.x / len;
    int j = threadIdx.x - i * len;  // this thread's float of row i
    const int di = kThreads / len;
    const int dj = kThreads - di * len;
    for (; i < rows; i += di) {
      const int m = row_map[j];
      out[i * out_row + j] = load_cell(
          part + 4u * ((r0 + i) * stride + (m & 0xffffff)), m >> 24, rank);
      j += dj;
      if (j >= len) {
        j -= len;
        ++i;
      }
    }
    return;
  }
  for (int u = threadIdx.x; u < rows * len; u += kThreads) {
    const int i = u / len;
    const int j = u - i * len;
    const int cell = j / pl.cph;
    const int c = j - cell * pl.cph;  // channel of the plane
    const int owner = c / g.cp;
    out[i * out_row + static_cast<long long>(cell) * a.C + c] = load_cell(
        part + 4u * ((r0 + i) * stride + cell * g.cp + c - owner * g.cp),
        owner, rank);
  }
}

// The body both splats launch: one cluster a plane. Src says what plane p
// is and which channels each slot's chunk may touch (SampleSource in
// splat.cu, TileSource in splat_tiled.cu).
template <class Src>
__global__ void __launch_bounds__(kThreads, 1)
    splat_cluster_kernel(Args a, Geom g, Src src) {
  extern __shared__ __align__(16) float smem[];
  cg::cluster_group cluster = cg::this_cluster();
  const int rank = static_cast<int>(cluster.block_rank());
  const int n = static_cast<int>(cluster.num_blocks());
  const int head = src.first(a, blockIdx.x / n);
  float4* part4 = reinterpret_cast<float4*>(smem);
  for (int i = threadIdx.x; i < g.plane_floats / 4; i += kThreads) {
    part4[i] = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
  }
  // the row map of write_rows, after the part, where the plan left room
  int* row_map = g.row_map ? reinterpret_cast<int*>(smem + g.plane_floats)
                           : nullptr;
  if (row_map != nullptr) {
    for (int f = threadIdx.x; f < g.cols * a.C; f += kThreads) {
      const int cell = f / a.C;
      const int c = f - cell * a.C;
      const int owner = c / g.cp;
      row_map[f] = (owner << 24) | (cell * g.cp + c - owner * g.cp);
    }
  }
  const Plane pl = src.plane(a, g, blockIdx.x / n, head);  // block-wide
  const unsigned part = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  const int mlo = pl.c0 + rank * g.cp;  // this CTA's channels [mlo, mhi)
  const int mhi = min(pl.c0 + pl.cph, mlo + g.cp);
  __syncthreads();
  if (mlo < mhi) {
    if (g.vec_in) {
      add_events<4>(a, g, src, pl, part, mlo, mhi);
    } else {
      add_events<1>(a, g, src, pl, part, mlo, mhi);
    }
  }
  cluster.sync();  // every add of the cluster landed
  write_rows(a, g, pl, part, row_map, rank, n);
  cluster.sync();  // every CTA's part read before any exits
}

inline cudaLaunchConfig_t cluster_config(int cluster, int planes, int smem,
                                         cudaStream_t stream,
                                         cudaLaunchAttribute* attr) {
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(planes * cluster);
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  attr->id = cudaLaunchAttributeClusterDimension;
  attr->val.clusterDim.x = cluster;
  attr->val.clusterDim.y = 1;
  attr->val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return cfg;
}

// Check the plan against the geometry, set the kernel's shared memory and
// launch `planes` clusters of `cluster` CTAs.
template <class Src>
inline int launch(const Args& a, Geom g, const Src& src, int planes,
                  int cluster, int channels, int smem, cudaStream_t stream) {
  g.plane_floats = (g.rows * g.cols * g.cp + 3) & ~3;
  // the row map needs the plane's channels to be all of a row's (one
  // group) and a word for each float of a row
  g.row_map = channels == a.C &&
              smem >= 4 * (g.plane_floats + g.cols * a.C);
  if (cluster < 1 || g.cp > kChans || cluster * g.cp < channels ||
      smem < 4 * g.plane_floats) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  auto kernel = splat_cluster_kernel<Src>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  cudaLaunchAttribute attr;
  const cudaLaunchConfig_t cfg =
      cluster_config(cluster, planes, smem, stream, &attr);
  err = cudaLaunchKernelEx(&cfg, kernel, a, g, src);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}

// How many clusters of this shape the card holds at once
// (cudaOccupancyMaxActiveClusters).
template <class Src>
inline int max_active_clusters(int cluster, int smem, int* out) {
  auto kernel = splat_cluster_kernel<Src>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  cudaLaunchAttribute attr;
  const cudaLaunchConfig_t cfg = cluster_config(cluster, 1, smem, nullptr,
                                                &attr);
  return static_cast<int>(cudaOccupancyMaxActiveClusters(out, kernel, &cfg));
}

// Whether the event rows can be read 4 slots a load: aligned pointers, a
// row length E that is a multiple of 4, and (the caller's part) every
// plane's slots starting at a multiple of 4.
inline int inputs_vectorizable(const void* y, const void* x, const void* w,
                               int E) {
  const unsigned long long bits = reinterpret_cast<unsigned long long>(y) |
                                  reinterpret_cast<unsigned long long>(x) |
                                  reinterpret_cast<unsigned long long>(w);
  return (bits % 16 == 0) && (E % 4 == 0);
}

}  // namespace splat
