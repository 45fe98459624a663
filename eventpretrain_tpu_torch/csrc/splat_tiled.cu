// K6 — tiled splat: (B, C, E) f32 weights of tile-bucketed events summed at
// integer (y, x) into a (B, H, W, C) f32 grid.
//
// Replaces eventpretrain_tpu/ops/pallas_voxel.py::splat_mxu_tiled (and
// voxelize_batch_mxu_tiled, whose bin weights the Python wrapper computes).
// The host bucketer (native/__init__.py) groups the events by 128x128 tile:
// each chunk of `chunk` slots belongs to one tile, the chunk table is
// nondecreasing, and pads carry out-of-frame sentinels. The TPU kernel
// turns each chunk into one-hot matrix products into its tile's block,
// carrying the weights as a bf16 hi+lo pair; that is the TPU's way around
// having no scatter unit, not part of the function.
//
// Here the body of csrc/splat_core.cuh takes a plane per (sample, tile):
// the tile's tile_h x tile_w cells, its channels cut over a cluster's CTAs
// (DSEC's 5 bins in two CTAs of 3 and 2 channels, the 2-bin count image in
// one CTA); where more channels than a cluster of 8 holds, a plane per
// group of them (ops/splat_tiled.py::splat_tiled_plan). What bounds it on
// the card is the bytes (the grid written once, 90 MB at DSEC's semseg
// batch; the coordinates and the weights inside each chunk's bin range)
// and the shared-memory adds. The first port's body read a tile's
// coordinates once per bin and wrote the grid one channel at a time (4-byte
// stores 20 bytes apart); here the block finds its tile's chunks in the
// nondecreasing table with one block-wide count, each CTA loads only the
// weight rows of its channels inside each chunk's bin range (a chunk with
// none costs it nothing), and each CTA writes whole rows of tile_w x C
// floats, 16 bytes a store, cropped to H x W (the last tile row of DSEC
// holds 56 of 128 rows). An event outside its chunk's tile, or past row H
// or column W, adds nothing, as in the TPU kernel. The sums are exact f32
// up to the order of the additions, which varies from run to run.
#include <climits>

#include "splat_core.cuh"

namespace splat {

// A plane is (sample, tile, channel group) p, groups innermost, so a
// tile's groups run side by side and share its coordinates in L2. The
// bucketer keeps a tile's chunks contiguous, so its events are one range of
// slots.
struct TileSource {
  const int* table;      // (B, n_chunks) nondecreasing tile of each chunk
  const int* bin_range;  // (B, n_chunks, 2) inclusive channels, or null
  int n_chunks, chunk, tile_h, tile_w, tiles_x, tiles, groups;

  // This thread's first word of plane p's sample's table (read before the
  // block zeroes its part, so the read's latency hides behind the zeroing).
  __device__ int first(const Args&, int p) const {
    const int b = p / (groups * tiles);
    return threadIdx.x < n_chunks
               ? table[static_cast<long long>(b) * n_chunks + threadIdx.x]
               : INT_MAX;
  }

  __device__ Plane plane(const Args& a, const Geom& g, int p,
                         int head) const {
    Plane pl;
    const int grp = p % groups;
    const int t = (p / groups) % tiles;
    pl.b = p / (groups * tiles);
    // tile t's chunks, [first with table >= t, first with table > t): two
    // counts over the nondecreasing table, by the whole block
    const int* tab = table + static_cast<long long>(pl.b) * n_chunks;
    int lo = 0, hi = 0;
    for (int base = 0; base < n_chunks; base += kThreads) {
      const int j = base + threadIdx.x;
      const int v = base == 0 ? head : j < n_chunks ? tab[j] : INT_MAX;
      lo += __syncthreads_count(v < t);
      hi += __syncthreads_count(v <= t);
    }
    pl.lo = lo * chunk;
    pl.hi = hi * chunk;
    pl.y0 = (t / tiles_x) * tile_h;
    pl.x0 = (t % tiles_x) * tile_w;
    pl.ylim = min(tile_h, a.H - pl.y0);  // rows past H are cropped
    pl.xlim = min(tile_w, a.W - pl.x0);
    const int per_group = (a.C + groups - 1) / groups;
    pl.c0 = grp * per_group;
    pl.cph = min(per_group, a.C - pl.c0);
    return pl;
  }

  // the channels slot e's chunk may touch: its bin range
  __device__ void clamp(const Args&, const Plane& pl, int e, int& lo,
                        int& hi) const {
    if (bin_range == nullptr) return;
    const int* br = bin_range +
                    (static_cast<long long>(pl.b) * n_chunks + e / chunk) * 2;
    lo = max(lo, __ldg(br));
    hi = min(hi, __ldg(br + 1));
  }
};

}  // namespace splat

// One cluster of `cluster` CTAs a plane of the tile_h x tile_w tile and
// ceil(C / groups) channels (`groups` planes a tile), each CTA holding `cp`
// channels in `smem` bytes of dynamic shared memory (at least what that
// takes).
extern "C" int splat_tiled_cluster_f32(
    const void* y, const void* x, const void* w, const void* table,
    const void* bin_range, void* out, int B, int C, int E, int chunk, int H,
    int W, int tile_h, int tile_w, int cluster, int cp, int groups, int smem,
    void* stream) {
  if (B == 0 || C == 0 || H == 0 || W == 0) return 0;
  const int tiles_y = (H + tile_h - 1) / tile_h;
  const int tiles_x = (W + tile_w - 1) / tile_w;
  splat::Geom g;
  g.rows = tile_h;
  g.cols = tile_w;
  g.cp = cp;
  g.vec_in = splat::inputs_vectorizable(y, x, w, E) && chunk % 4 == 0;
  const splat::Args a{static_cast<const int*>(y), static_cast<const int*>(x),
                      static_cast<const float*>(w), static_cast<float*>(out),
                      C, E, H, W};
  const splat::TileSource src{static_cast<const int*>(table),
                              static_cast<const int*>(bin_range),
                              E / chunk, chunk, tile_h, tile_w, tiles_x,
                              tiles_y * tiles_x, groups};
  return splat::launch(a, g, src, B * tiles_y * tiles_x * groups, cluster,
                       (C + groups - 1) / groups, smem,
                       static_cast<cudaStream_t>(stream));
}

extern "C" int splat_tiled_cluster_occupancy(int cluster, int smem,
                                             int* out) {
  return splat::max_active_clusters<splat::TileSource>(cluster, smem, out);
}
