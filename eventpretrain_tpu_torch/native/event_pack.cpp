// Native host-side event batch packing for the input pipelines.
//
// The reference framework's host hot path runs per-sample inside Python
// DataLoader workers (SURVEY §3.3); here the variable-length -> fixed-
// capacity packing (window select + pad + batch assembly, the step between
// file decode and device transfer) is one multithreaded C++ call:
//
//   pack_event_batch: gather B variable-length (N_i, 4) float32 streams into
//   one (B, capacity, 4) padded batch + (B,) counts, taking the LAST
//   `capacity` events when longer (backward window) or a caller-provided
//   window start.
//
// Built by eventpretrain_tpu_torch/native/__init__.py with g++ at first use
// and loaded with ctypes; a failed build raises. The numpy versions there
// are the specifications, run only when a caller forces them. This file is
// the JAX package's eventpretrain_tpu/native/event_pack.cpp, code unchanged.

#include <algorithm>
#include <atomic>
#include <cstdint>
#include <cstring>
#include <thread>
#include <vector>

extern "C" {

// event_ptrs: B pointers to (len_i, 4) float32 rows (xytp)
// starts:     B window start indices (row offset into each stream)
// lengths:    B row counts available from starts (already clamped by caller)
// out:        (B, capacity, 4) float32, zero-filled here
// counts:     (B,) int32 valid-row counts
void pack_event_batch(const float** event_ptrs, const int64_t* starts,
                      const int64_t* lengths, int64_t batch,
                      int64_t capacity, float* out, int32_t* counts) {
  const int64_t row_floats = 4;
  const int64_t sample_floats = capacity * row_floats;

  int num_threads = std::min<int64_t>(
      batch, std::max(1u, std::thread::hardware_concurrency()));
  std::atomic<int64_t> next(0);

  auto worker = [&]() {
    int64_t i;
    while ((i = next.fetch_add(1)) < batch) {
      float* dst = out + i * sample_floats;
      int64_t n = std::min(lengths[i], capacity);
      const float* src = event_ptrs[i] + starts[i] * row_floats;
      if (n > 0) {
        std::memcpy(dst, src, static_cast<size_t>(n) * row_floats *
                                   sizeof(float));
      }
      if (n < capacity) {
        std::memset(dst + n * row_floats, 0,
                    static_cast<size_t>(capacity - n) * row_floats *
                        sizeof(float));
      }
      counts[i] = static_cast<int32_t>(n);
    }
  };

  std::vector<std::thread> threads;
  threads.reserve(num_threads);
  for (int t = 0; t < num_threads; ++t) threads.emplace_back(worker);
  for (auto& t : threads) t.join();
}

}  // extern "C"

#include <random>
#include <unordered_set>

extern "C" {

// Fused erase_and_add augmentation + packing (one pass per sample).
//
// Distributional parity with dataset/augmentation/events_augment.py:28-55:
// erase a uniform subset of size U[0.001n, 0.01n); add the same order of
// events copied from uniformly-chosen originals with N(0,1.5) spatial and
// N(0,1e-3) temporal jitter, coords clipped to the sensor; output stays
// time-sorted (adds are merge-inserted). RNG is std::mt19937_64 per sample
// (seeded by the caller), not numpy PCG — same distribution, different
// stream.
void augment_and_pack_batch(const float** event_ptrs, const int64_t* starts,
                            const int64_t* lengths, const float* sensor_hs,
                            const float* sensor_ws, const uint64_t* seeds,
                            int64_t batch, int64_t capacity, float* out,
                            int32_t* counts) {
  const int64_t rf = 4;
  int num_threads = std::min<int64_t>(
      batch, std::max(1u, std::thread::hardware_concurrency()));
  std::atomic<int64_t> next(0);

  auto worker = [&]() {
    int64_t i;
    while ((i = next.fetch_add(1)) < batch) {
      float* dst = out + i * capacity * rf;
      const float* src = event_ptrs[i] + starts[i] * rf;
      int64_t n = lengths[i];
      const float h = sensor_hs[i], w = sensor_ws[i];

      if (n / 100 <= 0) {  // too short: plain copy (reference :31)
        int64_t m = std::min(n, capacity);
        std::memcpy(dst, src, static_cast<size_t>(m) * rf * sizeof(float));
        std::memset(dst + m * rf, 0,
                    static_cast<size_t>(capacity - m) * rf * sizeof(float));
        counts[i] = static_cast<int32_t>(m);
        continue;
      }

      std::mt19937_64 gen(seeds[i]);
      const int64_t lo = n / 1000, hi = n / 100;
      std::uniform_int_distribution<int64_t> num_dist(lo, hi - 1);
      const int64_t erase_num = num_dist(gen);
      const int64_t add_num = num_dist(gen);

      // Floyd's sampling without replacement
      auto sample_set = [&](int64_t k) {
        std::unordered_set<int64_t> s;
        s.reserve(k * 2);
        for (int64_t j = n - k; j < n; ++j) {
          std::uniform_int_distribution<int64_t> d(0, j);
          int64_t t = d(gen);
          if (!s.insert(t).second) s.insert(j);
        }
        return s;
      };
      std::unordered_set<int64_t> erase = sample_set(erase_num);
      std::unordered_set<int64_t> add_src_set = sample_set(add_num);

      std::normal_distribution<float> jxy(0.0f, 1.5f);
      std::normal_distribution<float> jt(0.0f, 0.001f);
      struct Ev { float x, y, t, p; };
      std::vector<Ev> adds;
      adds.reserve(add_num);
      for (int64_t idx : add_src_set) {
        const float* e = src + idx * rf;
        Ev a;
        a.x = std::min(std::max(e[0] + jxy(gen), 0.0f), w - 1.0f);
        a.y = std::min(std::max(e[1] + jxy(gen), 0.0f), h - 1.0f);
        a.t = e[2] + jt(gen);
        a.p = e[3];
        adds.push_back(a);
      }
      std::sort(adds.begin(), adds.end(),
                [](const Ev& a, const Ev& b) { return a.t < b.t; });

      // merge kept events with sorted adds, truncating at capacity
      int64_t written = 0;
      size_t ai = 0;
      for (int64_t j = 0; j < n && written < capacity; ++j) {
        if (erase.count(j)) continue;
        const float* e = src + j * rf;
        while (ai < adds.size() && adds[ai].t <= e[2] &&
               written < capacity) {
          float* o = dst + written * rf;
          o[0] = adds[ai].x; o[1] = adds[ai].y;
          o[2] = adds[ai].t; o[3] = adds[ai].p;
          ++ai; ++written;
        }
        if (written >= capacity) break;
        std::memcpy(dst + written * rf, e, rf * sizeof(float));
        ++written;
      }
      while (ai < adds.size() && written < capacity) {
        float* o = dst + written * rf;
        o[0] = adds[ai].x; o[1] = adds[ai].y;
        o[2] = adds[ai].t; o[3] = adds[ai].p;
        ++ai; ++written;
      }
      std::memset(dst + written * rf, 0,
                  static_cast<size_t>(capacity - written) * rf *
                      sizeof(float));
      counts[i] = static_cast<int32_t>(written);
    }
  };

  std::vector<std::thread> threads;
  threads.reserve(num_threads);
  for (int t = 0; t < num_threads; ++t) threads.emplace_back(worker);
  for (auto& t : threads) t.join();
}

}  // extern "C"

// Greedy knapsack window grouping for the sparse-Swin host planner.
// Exact port of models/swin_plan.py::knapsack/group_windows (themselves a
// port of the reference swin_block.py:280-352), moved to C++ because the
// planner runs every pretrain step on the prefetch thread and the Python
// DP loop held the GIL for ~14 ms/step. Tie-breaking must match the
// numpy version bit-for-bit: the backtrack prefers NOT taking item i when
// table[i-1][w] already attains the value.
extern "C" {

void group_windows_native(int64_t capacity, const int32_t* weights,
                          int64_t n, int32_t* group_of,
                          int32_t* num_groups) {
  std::vector<int32_t> active(n);
  for (int64_t i = 0; i < n; ++i) active[i] = static_cast<int32_t>(i);
  const int64_t w_cols = capacity + 1;
  std::vector<int64_t> table;  // (m+1) x (capacity+1), row-major
  std::vector<int32_t> chosen;
  int32_t group = 0;
  while (!active.empty()) {
    const int64_t m = static_cast<int64_t>(active.size());
    table.assign((m + 1) * w_cols, 0);
    for (int64_t i = 1; i <= m; ++i) {
      const int64_t w_i = weights[active[i - 1]];
      const int64_t* prev = table.data() + (i - 1) * w_cols;
      int64_t* row = table.data() + i * w_cols;
      std::copy(prev, prev + w_cols, row);
      if (w_i <= capacity) {
        for (int64_t w = capacity; w >= w_i; --w) {
          const int64_t cand = prev[w - w_i] + w_i;
          if (cand > row[w]) row[w] = cand;
        }
      }
    }
    int64_t res = table[m * w_cols + capacity];
    int64_t w = capacity;
    chosen.clear();
    for (int64_t i = m; i >= 1; --i) {
      if (res <= 0) break;
      if (res == table[(i - 1) * w_cols + w]) continue;
      chosen.push_back(static_cast<int32_t>(i - 1));
      const int64_t w_i = weights[active[i - 1]];
      res -= w_i;
      w -= w_i;
    }
    if (chosen.empty()) {
      // cannot happen for valid inputs (every weight <= capacity); guard
      // against an infinite loop by closing out one window per group
      chosen.push_back(0);
    }
    // chosen holds positions in descending order; membership is what
    // matters for group_of
    for (int32_t pos : chosen) group_of[active[pos]] = group;
    std::vector<int32_t> next;
    next.reserve(active.size() - chosen.size());
    for (int64_t i = 0; i < m; ++i) {
      bool took = false;
      for (int32_t pos : chosen)
        if (pos == i) { took = true; break; }
      if (!took) next.push_back(active[i]);
    }
    active.swap(next);
    ++group;
  }
  *num_groups = group;
}

}  // extern "C"

// ---------------------------------------------------------------------------
// Tile bucketing for the large-grid MXU splat
// (ops/pallas_voxel.py::voxelize_batch_mxu_tiled).
//
// A stable counting sort per sample: count events per (tile_h x tile_w)
// spatial tile, lay tiles out contiguously in row-major tile order with
// each segment padded to a multiple of `chunk` (and at least one chunk,
// so every output tile is visited by the kernel), then place events in a
// second O(E) pass. Pad slots carry the codec-surviving out-of-frame
// sentinel (2047, 1023, t0, 0). Semantics are pinned bit-exact against
// the numpy specification (native/__init__.py::bucket_pack_event_batch) by
// tests/test_torch_port_native.py.
// ---------------------------------------------------------------------------

extern "C" {

// chunk_trange: (B, n_chunks, 2) f32 min/max timestamp over each chunk's
// REAL events ((t0, t0) for all-pad chunks) — lets the device kernel skip
// temporal bins no event in the chunk can touch (events stay time-sorted
// within a tile, so a chunk spans a narrow slice of the window).
void bucket_pack_batch(const float* packed, const int32_t* counts,
                       int64_t batch, int64_t cap, int64_t tile_h,
                       int64_t tile_w, int64_t tiles_x, int64_t tiles_y,
                       int64_t chunk, int64_t epad, float* out,
                       int32_t* table, float* t_range, float* chunk_trange) {
  const int64_t row = 4;
  const int64_t t_total = tiles_x * tiles_y;
  const int64_t n_chunks = epad / chunk;

  int num_threads = std::min<int64_t>(
      batch, std::max(1u, std::thread::hardware_concurrency()));
  std::atomic<int64_t> next(0);

  auto worker = [&]() {
    std::vector<int64_t> cnts(t_total), starts(t_total + 1), fill(t_total);
    int64_t i;
    while ((i = next.fetch_add(1)) < batch) {
      const float* src = packed + i * cap * row;
      float* dst = out + i * epad * row;
      int32_t* tab = table + i * n_chunks;
      const int64_t n = counts[i];
      const float t0 = n > 0 ? src[2] : 0.0f;
      const float t1 = n > 0 ? src[(n - 1) * row + 2] : 0.0f;
      t_range[i * 2] = t0;
      t_range[i * 2 + 1] = t1;

      auto tile_of = [&](const float* e) -> int64_t {
        int64_t tx = static_cast<int64_t>(e[0]) / tile_w;
        int64_t ty = static_cast<int64_t>(e[1]) / tile_h;
        tx = std::min(std::max(tx, int64_t{0}), tiles_x - 1);
        ty = std::min(std::max(ty, int64_t{0}), tiles_y - 1);
        return ty * tiles_x + tx;
      };

      std::fill(cnts.begin(), cnts.end(), 0);
      for (int64_t e = 0; e < n; ++e) ++cnts[tile_of(src + e * row)];

      int64_t off = 0;
      for (int64_t t = 0; t < t_total; ++t) {
        starts[t] = off;
        int64_t region = std::max((cnts[t] + chunk - 1) / chunk, int64_t{1});
        off += region * chunk;
      }
      starts[t_total] = off;

      // sentinel-fill every slot, then place events (pad slots keep it)
      for (int64_t s = 0; s < epad; ++s) {
        float* d = dst + s * row;
        d[0] = 2047.0f;
        d[1] = 1023.0f;
        d[2] = t0;
        d[3] = 0.0f;
      }
      float* ctr = chunk_trange + i * n_chunks * 2;
      for (int64_t c = 0; c < n_chunks; ++c) {
        ctr[c * 2] = t0;
        ctr[c * 2 + 1] = t0;
      }
      std::copy(starts.begin(), starts.end() - 1, fill.begin());
      for (int64_t e = 0; e < n; ++e) {
        const float* ev = src + e * row;
        const int64_t dest = fill[tile_of(ev)]++;
        std::memcpy(dst + dest * row, ev, row * sizeof(float));
        const int64_t c = dest / chunk;
        // placement preserves time order within a tile and tile segments
        // are chunk-aligned, so a chunk's first filled slot (dest % chunk
        // == 0) is its min timestamp and the last placed is its max
        if (dest % chunk == 0) ctr[c * 2] = ev[2];
        ctr[c * 2 + 1] = ev[2];
      }

      int64_t c = 0;
      for (int64_t t = 0; t < t_total; ++t) {
        const int64_t region_chunks = (starts[t + 1] - starts[t]) / chunk;
        for (int64_t r = 0; r < region_chunks; ++r)
          tab[c++] = static_cast<int32_t>(t);
      }
      for (; c < n_chunks; ++c) tab[c] = static_cast<int32_t>(t_total - 1);
    }
  };

  std::vector<std::thread> threads;
  threads.reserve(num_threads);
  for (int t = 0; t < num_threads; ++t) threads.emplace_back(worker);
  for (auto& t : threads) t.join();
}

// Prefix-layout u32 transfer encoding (the cls/pretrain pipelines' wire
// format, data/codec.py::encode_events_u32): valid events lead each row,
// the time window reads off slots 0 / n-1, pad slots encode to 0. Word
// values are bit-identical to the vectorized-numpy encoder (f64 divide
// path mirrored); this exists because that encoder costs ~33 ms per
// batch-64x30k on a 1-core host vs ~4 ms here.
void encode_u32_prefix(const float* packed, const int32_t* counts,
                       int64_t batch, int64_t cap, uint32_t* out,
                       float* t_range) {
  const int64_t row = 4;
  int num_threads = std::min<int64_t>(
      batch, std::max(1u, std::thread::hardware_concurrency()));
  std::atomic<int64_t> next(0);

  auto worker = [&]() {
    int64_t i;
    while ((i = next.fetch_add(1)) < batch) {
      const float* src = packed + i * cap * row;
      uint32_t* dst = out + i * cap;
      const int64_t n = counts[i];
      const float t0 = n > 0 ? src[2] : 0.0f;
      const float t1 = n > 0 ? src[(n - 1) * row + 2] : 0.0f;
      // numpy 2 (NEP 50) keeps the whole chain float32: python-float
      // scalars are weak, so (ev - t0) / dt * 1023.0 + 0.5 evaluates in
      // f32. dt is the correctly-rounded f32 difference (the numpy
      // side's f64 python subtraction rounds to the same f32 at use).
      float dtf = t1 - t0;
      if (dtf == 0.0f) dtf = 1.0f;
      for (int64_t e = 0; e < n; ++e) {
        const float* ev = src + e * row;
        int64_t x = static_cast<int64_t>(ev[0]);
        int64_t y = static_cast<int64_t>(ev[1]);
        if (x < 0 || x >= 2047) x = 2047;
        if (y < 0 || y >= 1023) y = 1023;
        const float tq_f = (ev[2] - t0) / dtf * 1023.0f + 0.5f;
        const int64_t tq = static_cast<int64_t>(
            std::min(std::max(tq_f, 0.0f), 1023.0f));
        const uint32_t pos = ev[3] > 0.0f ? 1u : 0u;
        dst[e] = static_cast<uint32_t>(x) |
                 (static_cast<uint32_t>(y) << 11) |
                 (static_cast<uint32_t>(tq) << 21) | (pos << 31);
      }
      std::memset(dst + n, 0,
                  static_cast<size_t>(cap - n) * sizeof(uint32_t));
      t_range[i * 2] = t0;
      t_range[i * 2 + 1] = t1;
    }
  };

  std::vector<std::thread> threads;
  threads.reserve(num_threads);
  for (int t = 0; t < num_threads; ++t) threads.emplace_back(worker);
  for (auto& t : threads) t.join();
}

// Fused tile bucketing + u32 transfer encoding: places each event directly
// as its encoded uint32 word (data/codec.py layout: x[0:11] | y[11:21] |
// t[21:31] | sign(p)[31]) instead of bucketing f32 quads and running a
// separate vectorized-numpy encode pass. One O(E) pass, 4 B/slot written
// instead of 16 B twice — on the 1-core hosts of this environment that
// collapses ~267 ms of per-batch host work (103 ms bucket + 163 ms encode,
// 8x200k events) to ~20 ms. Word values are bit-identical to
// encode_events_u32_full(bucket_pack_batch(...)) — pinned by
// tests/test_torch_port_native.py.
void bucket_pack_batch_u32(const float* packed, const int32_t* counts,
                           int64_t batch, int64_t cap, int64_t tile_h,
                           int64_t tile_w, int64_t tiles_x, int64_t tiles_y,
                           int64_t chunk, int64_t epad, uint32_t* out,
                           int32_t* table, float* t_range,
                           float* chunk_trange) {
  const int64_t row = 4;
  const int64_t t_total = tiles_x * tiles_y;
  const int64_t n_chunks = epad / chunk;
  // == codec.py X_SENTINEL | Y_SENTINEL << 11 | t_q(t0) << 21 with
  // t_q(t0) = (int)((t0 - t0) / dt * 1023 + 0.5) = 0 and p = 0
  const uint32_t kPadWord = 2047u | (1023u << 11);

  int num_threads = std::min<int64_t>(
      batch, std::max(1u, std::thread::hardware_concurrency()));
  std::atomic<int64_t> next(0);

  auto worker = [&]() {
    std::vector<int64_t> cnts(t_total), starts(t_total + 1), fill(t_total);
    std::vector<int32_t> tids;  // tile id per event, computed once
    int64_t i;
    while ((i = next.fetch_add(1)) < batch) {
      const float* src = packed + i * cap * row;
      uint32_t* dst = out + i * epad;
      int32_t* tab = table + i * n_chunks;
      const int64_t n = counts[i];
      const float t0 = n > 0 ? src[2] : 0.0f;
      const float t1 = n > 0 ? src[(n - 1) * row + 2] : 0.0f;
      // codec.py's numpy encode stays float32 end to end under numpy 2
      // (NEP 50 weak scalars: np.where(..., 1.0, f32) is f32, and the
      // divide/scale/round chain keeps the array dtype) — mirror that
      const float dt = (t1 - t0) != 0.0f ? (t1 - t0) : 1.0f;
      t_range[i * 2] = t0;
      t_range[i * 2 + 1] = t1;

      auto tile_of = [&](const float* e) -> int64_t {
        int64_t tx = static_cast<int64_t>(e[0]) / tile_w;
        int64_t ty = static_cast<int64_t>(e[1]) / tile_h;
        tx = std::min(std::max(tx, int64_t{0}), tiles_x - 1);
        ty = std::min(std::max(ty, int64_t{0}), tiles_y - 1);
        return ty * tiles_x + tx;
      };

      std::fill(cnts.begin(), cnts.end(), 0);
      tids.resize(static_cast<size_t>(n));
      for (int64_t e = 0; e < n; ++e) {
        const int64_t t = tile_of(src + e * row);
        tids[e] = static_cast<int32_t>(t);
        ++cnts[t];
      }

      int64_t off = 0;
      for (int64_t t = 0; t < t_total; ++t) {
        starts[t] = off;
        int64_t region = std::max((cnts[t] + chunk - 1) / chunk, int64_t{1});
        off += region * chunk;
      }
      starts[t_total] = off;

      std::fill(dst, dst + epad, kPadWord);
      float* ctr = chunk_trange + i * n_chunks * 2;
      for (int64_t c = 0; c < n_chunks; ++c) {
        ctr[c * 2] = t0;
        ctr[c * 2 + 1] = t0;
      }
      std::copy(starts.begin(), starts.end() - 1, fill.begin());
      for (int64_t e = 0; e < n; ++e) {
        const float* ev = src + e * row;
        const int64_t dest = fill[tids[e]]++;
        // encode exactly like codec.py encode_events_u32_full: trunc-to-
        // int64 coords with sentinel clamp, f32 window-normalized t with
        // +0.5 rounding, polarity sign bit
        int64_t x = static_cast<int64_t>(ev[0]);
        int64_t y = static_cast<int64_t>(ev[1]);
        if (x < 0 || x >= 2047) x = 2047;
        if (y < 0 || y >= 1023) y = 1023;
        const float tq_f = (ev[2] - t0) / dt * 1023.0f + 0.5f;
        const int64_t tq = static_cast<int64_t>(
            std::min(std::max(tq_f, 0.0f), 1023.0f));
        const uint32_t pos = ev[3] > 0.0f ? 1u : 0u;
        dst[dest] = static_cast<uint32_t>(x) |
                    (static_cast<uint32_t>(y) << 11) |
                    (static_cast<uint32_t>(tq) << 21) | (pos << 31);
        const int64_t c = dest / chunk;
        if (dest % chunk == 0) ctr[c * 2] = ev[2];
        ctr[c * 2 + 1] = ev[2];
      }

      int64_t c = 0;
      for (int64_t t = 0; t < t_total; ++t) {
        const int64_t region_chunks = (starts[t + 1] - starts[t]) / chunk;
        for (int64_t r = 0; r < region_chunks; ++r)
          tab[c++] = static_cast<int32_t>(t);
      }
      for (; c < n_chunks; ++c) tab[c] = static_cast<int32_t>(t_total - 1);
    }
  };

  std::vector<std::thread> threads;
  threads.reserve(num_threads);
  for (int t = 0; t < num_threads; ++t) threads.emplace_back(worker);
  for (auto& t : threads) t.join();
}

}  // extern "C"
