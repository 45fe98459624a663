// Row and column reductions of the K1/K2/K4/K5 backward: the LayerNorm
// forward recompute, the LayerNorm backward (K1/K2) and the bias /
// LN-parameter gradients.
//
// Replaces the LN tail of the TPU backward kernels
// (eventpretrain_tpu/ops/fused_attn_layer.py::_ln_bwd_kernel :341-354 and
// fused_mlp.py::_ln_bwd_kernel :320-326, the C=768 XLA twin
// _xla_ln_mlp_bwd :451-456) and their f32 bias sums (:132, :169, :285,
// :312):
//
//   dxhat = d_yln * gamma
//   dx    = dy + rstd * (dxhat - mean(dxhat) - xhat * mean(dxhat * xhat))
//                                                      (f32, rounded once)
//   dgamma = sum_tokens d_yln * xhat,  dbeta = sum_tokens d_yln     (f32)
//   dbias  = sum_tokens dY                    (f32, rounded to bf16 once)
//
// What bounds them on the H100: device-memory bytes. The LayerNorm backward
// reads 8 bytes of every element (x, dy bf16, d_yln f32) and writes 2 (dx),
// a few flops each; a column sum reads 2 bytes an element and writes one row.
//
// The design. Every access to a row is 16 bytes a lane (8 bf16, or two
// groups of 4 f32), and each row is read from device memory once: a warp
// loads the whole row of x, d_yln and dy into registers before it uses any
// of it (C/256 16-byte chunks a lane, C/64 the template argument), so each
// SM has many kilobytes in flight. The x row goes to a copy in shared
// memory, which the rest of the row reads: the LayerNorm statistics are
// ln_row_stats of common.cuh run on it, so the mean and rstd are the
// forward's (ln_rows, the GEMM's input) bit for bit. The grid
// is the card's: ops/common.py::plan_row_ranges cuts the rows into
// contiguous ranges, about one block per block slot of the card (SMs times
// the blocks an SM holds at these registers), one block a range (and a
// column tile for the column sums).
//
// The TPU kernels carried the column sums across their sequential batch
// grid. Hopper blocks run in no set order, and this port adds no float
// atomics, so every sum comes out the same bit for bit on every run and the
// kernel path can be held step by step against the plain one:
//   1. each warp adds its rows in row order; the block adds its warps'
//      sums in warp order and writes its range's partial row;
//   2. the ranges are grouped `group` at a time: the last block of a group
//      to finish (an integer counter) adds the group's partial rows in range
//      order;
//   3. the last group to finish adds the groups' rows in group order into
//      the output.
// Which block does an addition depends on scheduling; what is added, and in
// which order, does not. One launch a call. A step adds at most kBatch rows
// a column, all loaded at once; a thread takes 2 columns (1 in a column
// sum, whose tile has as many columns as the block threads). The counters
// are atomicInc with a wrap at the group's size, so each launch leaves them
// at zero for the next one on the stream: the wrapper keeps one zeroed
// counter array and one partial-sum scratch a stream.
#include <type_traits>

#include "common.cuh"

namespace {

constexpr int kWarps = 8;
constexpr int kThreads = kWarps * 32;
constexpr int kTile = 8 * 32;  // colsum: a block's columns, 8 a lane
constexpr int kUnroll = 8;     // colsum: rows a lane has in flight
// partial rows a thread of the ordered sum has in flight; the planner keeps
// a step's rows within it (at most kBatch^2 ranges)
constexpr int kBatch = 16;
// columns a thread of the ordered sum adds: 2 in the LayerNorm backward
// (its 2 x C columns over the block's threads), 1 in a column sum (its
// tile's 256 columns, one a thread)
constexpr int kLnSumCols = 2;
constexpr int kColSumCols = 1;

// yln = LN(x) rounded to bf16, one warp per row.
__global__ void __launch_bounds__(kWarps * 32)
    ln_rows_kernel(const bf16* __restrict__ x, const float* __restrict__ g,
                   const float* __restrict__ b, float eps,
                   bf16* __restrict__ y, int M, int C) {
  const int row = blockIdx.x * kWarps + threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  if (row >= M) return;
  const bf16* xr = x + (long long)row * C;
  float mu, rstd;
  ln_row_stats(xr, C, eps, lane, &mu, &rstd);
  const __nv_bfloat162* x2 = reinterpret_cast<const __nv_bfloat162*>(xr);
  __nv_bfloat162* y2 = reinterpret_cast<__nv_bfloat162*>(y + (long long)row * C);
  for (int p = lane; p < C / 2; p += 32) {
    const float2 v = __bfloat1622float2(x2[p]);
    y2[p] = __floats2bfloat162_rn(
        ln_apply(v.x, mu, rstd, g[2 * p], b[2 * p]),
        ln_apply(v.y, mu, rstd, g[2 * p + 1], b[2 * p + 1]));
  }
}

__device__ __forceinline__ uint4 load16(const bf16* p) {
  return __ldg(reinterpret_cast<const uint4*>(p));
}

__device__ __forceinline__ void unpack8(const uint4& v, float (&f)[8]) {
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&v);
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const float2 t = __bfloat1622float2(h[j]);
    f[2 * j] = t.x;
    f[2 * j + 1] = t.y;
  }
}

__device__ __forceinline__ uint4 pack8(const float (&f)[8]) {
  uint4 v;
  __nv_bfloat162* h = reinterpret_cast<__nv_bfloat162*>(&v);
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    h[j] = __floats2bfloat162_rn(f[2 * j], f[2 * j + 1]);
  }
  return v;
}

// 8 f32 to 16-byte aligned shared memory, two 16-byte stores
__device__ __forceinline__ void store8(float* p, const float (&f)[8]) {
  float4* r = reinterpret_cast<float4*>(p);
  r[0] = make_float4(f[0], f[1], f[2], f[3]);
  r[1] = make_float4(f[4], f[5], f[6], f[7]);
}

// V adjacent f32 from L2 (V = 1 or 2; 4 V-byte aligned)
template <int V>
__device__ __forceinline__ void load_l2(const float* p, float (&v)[V]) {
  static_assert(V == 1 || V == 2, "one or two columns a thread");
  if constexpr (V == 1) {
    v[0] = __ldcg(p);
  } else {
    const float2 t = __ldcg(reinterpret_cast<const float2*>(p));
    v[0] = t.x;
    v[1] = t.y;
  }
}

// V adjacent f32 sums to f32, or rounded once to bf16
template <int V>
__device__ __forceinline__ void put(float* p, const float (&v)[V]) {
#pragma unroll
  for (int j = 0; j < V; ++j) p[j] = v[j];
}
template <int V>
__device__ __forceinline__ void put(bf16* p, const float (&v)[V]) {
#pragma unroll
  for (int j = 0; j < V; ++j) p[j] = __float2bfloat16(v[j]);
}

// True in every thread of the one block that arrives last at `counter`,
// of n arrivals. Each block's stores before the call are visible to that
// block when it returns true. atomicInc wraps the counter back to 0 at the
// n-th arrival.
__device__ __forceinline__ bool arrive_last(unsigned* counter, unsigned n) {
  __shared__ bool last;
  __threadfence();
  __syncthreads();
  if (threadIdx.x == 0) last = atomicInc(counter, n - 1) == n - 1;
  __syncthreads();
  const bool is_last = last;
  if (is_last) __threadfence();
  return is_last;
}

// For each of the NS sums s: dst_s[c] = the sum of src_s[r * ld + c] over
// r < n, in row order, for the columns [col0, col0 + ncols), ncols % V == 0
// (src_s = src + s * stride, dst_s = dst0 or dst1). A thread takes V
// adjacent columns of one sum, with kBatch rows in flight. The rows were
// written by other blocks: read them from L2.
template <int NS, int V, typename Out>
__device__ void add_rows(const float* src, long long stride, int n, int ld,
                         int col0, int ncols, Out* dst0, Out* dst1) {
  const int per_sum = ncols / V;
  for (int i = threadIdx.x; i < NS * per_sum; i += blockDim.x) {
    const int s = i / per_sum;
    const int c = col0 + V * (i - s * per_sum);
    const float* p = src + s * stride + c;
    float acc[V] = {};
    for (int r0 = 0; r0 < n; r0 += kBatch) {
      float v[kBatch][V];
#pragma unroll
      for (int u = 0; u < kBatch; ++u) {
        if (r0 + u < n) load_l2(p + (long long)(r0 + u) * ld, v[u]);
      }
#pragma unroll
      for (int u = 0; u < kBatch; ++u) {
        if (r0 + u < n) {
#pragma unroll
          for (int j = 0; j < V; ++j) acc[j] += v[u][j];
        }
      }
    }
    put((s == 0 ? dst0 : dst1) + c, acc);
  }
}

// Steps 2 and 3 of the ordered sum (see the top), after this block wrote
// its partial rows. `part` holds, for each of the NS sums, `slab` rows of
// width ld: the ranges' partial rows, then the groups'. `cnt` holds a
// counter for each group and one for the last step.
template <int NS, int V, typename Out>
__device__ void finish_sums(float* part, int slab, unsigned* cnt, int range,
                            int ranges, int group, int ld, int col0,
                            int ncols, Out* out0, Out* out1) {
  const int groups = (ranges + group - 1) / group;
  const int g = range / group;
  const int first = g * group;
  const int n = min(group, ranges - first);
  if (!arrive_last(cnt + g, n)) return;
  const long long stride = (long long)slab * ld;  // from one sum to the next
  const float* rows = part + (long long)first * ld;
  if (groups == 1) {
    add_rows<NS, V>(rows, stride, n, ld, col0, ncols, out0, out1);
    return;
  }
  float* gp = part + (long long)(ranges + g) * ld;
  add_rows<NS, V>(rows, stride, n, ld, col0, ncols, gp, gp + stride);
  if (!arrive_last(cnt + groups, groups)) return;
  add_rows<NS, V>(part + (long long)ranges * ld, stride, groups, ld, col0,
                  ncols, out0, out1);
}

// The LayerNorm backward of rows [blockIdx.x * rows, + rows), C = 64 W.
// Warp w takes the range's rows w, w + 8, ...; lane l owns the 16-byte
// chunks l + 32 t of a row (8 columns each; at C = 384 half the lanes own
// one chunk fewer).
template <int W>
__global__ void __launch_bounds__(kThreads, 2)
    ln_bwd_kernel(const bf16* __restrict__ x, const float* __restrict__ g,
                  float eps, const bf16* __restrict__ dy,
                  const float* __restrict__ dyln, bf16* __restrict__ dx,
                  float* part, unsigned* cnt, float* dg, float* db, int M,
                  int rows, int group) {
  constexpr int C = 64 * W;
  constexpr int kChunks = C / 8;
  constexpr int T = (kChunks + 31) / 32;
  __shared__ __align__(16) bf16 stage[kWarps][C];
  __shared__ __align__(16) float red[kWarps][C];
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  float acc_g[T][8], acc_b[T][8];
#pragma unroll
  for (int t = 0; t < T; ++t) {
#pragma unroll
    for (int j = 0; j < 8; ++j) acc_g[t][j] = acc_b[t][j] = 0.0f;
  }

  const int r0 = blockIdx.x * rows;
  const int r1 = min(M, r0 + rows);
  for (int row = r0 + warp; row < r1; row += kWarps) {
    const long long base = (long long)row * C;
    uint4 xv[T], dyv[T];
    float4 dv[T][2];
#pragma unroll
    for (int t = 0; t < T; ++t) {
      const int q = lane + 32 * t;
      if (q < kChunks) {
        xv[t] = load16(x + base + 8 * q);
        dv[t][0] = __ldg(reinterpret_cast<const float4*>(dyln + base) + 2 * q);
        dv[t][1] =
            __ldg(reinterpret_cast<const float4*>(dyln + base) + 2 * q + 1);
        dyv[t] = load16(dy + base + 8 * q);
      }
    }
    // the statistics in ln_rows' lane order, from a copy of the row
    __syncwarp();
#pragma unroll
    for (int t = 0; t < T; ++t) {
      const int q = lane + 32 * t;
      if (q < kChunks) *reinterpret_cast<uint4*>(&stage[warp][8 * q]) = xv[t];
    }
    __syncwarp();
    float mu, rstd;
    ln_row_stats(stage[warp], C, eps, lane, &mu, &rstd);

    // x is read back from the row's copy, and xhat recomputed for dx (two
    // operations an element), rather than held in registers across the
    // row sums
    const uint4* xs = reinterpret_cast<const uint4*>(stage[warp]);
    float dxh[T][8];
    float s1 = 0.0f, s2 = 0.0f;
#pragma unroll
    for (int t = 0; t < T; ++t) {
      const int q = lane + 32 * t;
      if (q < kChunks) {
        float xf[8];
        unpack8(xs[q], xf);
        const float4 g0 = __ldg(reinterpret_cast<const float4*>(g) + 2 * q);
        const float4 g1 =
            __ldg(reinterpret_cast<const float4*>(g) + 2 * q + 1);
        const float d[8] = {dv[t][0].x, dv[t][0].y, dv[t][0].z, dv[t][0].w,
                            dv[t][1].x, dv[t][1].y, dv[t][1].z, dv[t][1].w};
        const float gg[8] = {g0.x, g0.y, g0.z, g0.w, g1.x, g1.y, g1.z, g1.w};
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          const float xh = ln_xhat(xf[j], mu, rstd);
          acc_g[t][j] += d[j] * xh;
          acc_b[t][j] += d[j];
          dxh[t][j] = d[j] * gg[j];
          s1 += dxh[t][j];
          s2 += dxh[t][j] * xh;
        }
      }
    }
    const float m1 = warp_sum(s1) / C;
    const float m2 = warp_sum(s2) / C;
#pragma unroll
    for (int t = 0; t < T; ++t) {
      const int q = lane + 32 * t;
      if (q < kChunks) {
        float xf[8], r[8];
        unpack8(xs[q], xf);
        unpack8(dyv[t], r);
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          const float xh = ln_xhat(xf[j], mu, rstd);
          r[j] += rstd * (dxh[t][j] - m1 - xh * m2);
        }
        *reinterpret_cast<uint4*>(dx + base + 8 * q) = pack8(r);
      }
    }
  }

  // step 1: the block's partial rows, its warps' sums added in warp order
  const int ranges = gridDim.x;
  const int slab = ranges + (ranges + group - 1) / group;
#pragma unroll
  for (int s = 0; s < 2; ++s) {
#pragma unroll
    for (int t = 0; t < T; ++t) {
      const int q = lane + 32 * t;
      if (q < kChunks) store8(&red[warp][8 * q], s == 0 ? acc_g[t] : acc_b[t]);
    }
    __syncthreads();
    float* out = part + ((long long)s * slab + blockIdx.x) * C;
    for (int c = threadIdx.x; c < C; c += kThreads) {
      float v = 0.0f;
#pragma unroll
      for (int w = 0; w < kWarps; ++w) v += red[w][c];
      out[c] = v;
    }
    __syncthreads();
  }
  finish_sums<2, kLnSumCols>(part, slab, cnt, blockIdx.x, ranges, group, C,
                             0, C, dg, db);
}

// Column sums of rows [blockIdx.y * rows, + rows) of the 256 columns of
// tile blockIdx.x: lane l owns the 8 columns from 8 l, one 16-byte load a
// row; warp w takes the range's rows w, w + 8, ..., kUnroll loads in flight.
__global__ void __launch_bounds__(kThreads)
    colsum_kernel(const bf16* __restrict__ in, float* part, unsigned* cnt,
                  bf16* __restrict__ out, int M, int N, int rows, int group) {
  __shared__ __align__(16) float red[kWarps][kTile];
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int col0 = blockIdx.x * kTile;
  const int col = col0 + 8 * lane;
  float acc[8];
#pragma unroll
  for (int j = 0; j < 8; ++j) acc[j] = 0.0f;
  const int r1 = min(M, (int)blockIdx.y * rows + rows);
  if (col < N) {
    for (int row = blockIdx.y * rows + warp; row < r1;
         row += kUnroll * kWarps) {
      uint4 v[kUnroll];
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        if (row + u * kWarps < r1) {
          v[u] = load16(in + (long long)(row + u * kWarps) * N + col);
        }
      }
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        if (row + u * kWarps < r1) {
          float f[8];
          unpack8(v[u], f);
#pragma unroll
          for (int j = 0; j < 8; ++j) acc[j] += f[j];
        }
      }
    }
  }
  store8(&red[warp][8 * lane], acc);
  __syncthreads();

  const int ranges = gridDim.y;
  const int groups = (ranges + group - 1) / group;
  const int ncols = min(kTile, N - col0);
  if (threadIdx.x < ncols) {
    float v = 0.0f;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) v += red[w][threadIdx.x];
    part[(long long)blockIdx.y * N + col0 + threadIdx.x] = v;
  }
  finish_sums<1, kColSumCols>(part, ranges + groups,
                              cnt + blockIdx.x * (groups + 1), blockIdx.y,
                              ranges, group, N, col0, ncols, out,
                              static_cast<bf16*>(nullptr));
}

template <int W>
int launch_ln_bwd(const void* x, const void* g, float eps, const void* dy,
                  const void* dyln, void* dx, void* part, void* cnt, void* dg,
                  void* db, int M, int rows, int group, cudaStream_t s) {
  const int ranges = (M + rows - 1) / rows;
  ln_bwd_kernel<W><<<ranges, kThreads, 0, s>>>(
      static_cast<const bf16*>(x), static_cast<const float*>(g), eps,
      static_cast<const bf16*>(dy), static_cast<const float*>(dyln),
      static_cast<bf16*>(dx), static_cast<float*>(part),
      static_cast<unsigned*>(cnt), static_cast<float*>(dg),
      static_cast<float*>(db), M, rows, group);
  return static_cast<int>(cudaGetLastError());
}

template <int W>
int ln_bwd_occupancy() {
  int n = 0;
  const cudaError_t err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      &n, ln_bwd_kernel<W>, kThreads, 0);
  return err == cudaSuccess ? n : -static_cast<int>(err);
}

// f(std::integral_constant<int, C / 64>{}) for C % 64 == 0, 64 <= C <= 768
template <typename F>
int by_width(int C, F f) {
  switch (C / 64) {
    case 1: return f(std::integral_constant<int, 1>{});
    case 2: return f(std::integral_constant<int, 2>{});
    case 3: return f(std::integral_constant<int, 3>{});
    case 4: return f(std::integral_constant<int, 4>{});
    case 5: return f(std::integral_constant<int, 5>{});
    case 6: return f(std::integral_constant<int, 6>{});
    case 7: return f(std::integral_constant<int, 7>{});
    case 8: return f(std::integral_constant<int, 8>{});
    case 9: return f(std::integral_constant<int, 9>{});
    case 10: return f(std::integral_constant<int, 10>{});
    case 11: return f(std::integral_constant<int, 11>{});
    case 12: return f(std::integral_constant<int, 12>{});
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

// x, y (M, C) bf16; g, b (C,) f32. C even, C <= 768 not required here.
extern "C" int ln_rows_bf16(const void* x, const void* g, const void* b,
                            float eps, void* y, int M, int C, void* stream) {
  if (M == 0) return 0;
  ln_rows_kernel<<<(M + kWarps - 1) / kWarps, kWarps * 32, 0,
                   static_cast<cudaStream_t>(stream)>>>(
      static_cast<const bf16*>(x), static_cast<const float*>(g),
      static_cast<const float*>(b), eps, static_cast<bf16*>(y), M, C);
  return static_cast<int>(cudaGetLastError());
}

// Blocks of the kernel an SM holds at its registers and shared memory:
// kind 0 the LayerNorm backward at width C, kind 1 the column sum. A
// negative value is minus a CUDA error code.
extern "C" int row_kernel_occupancy(int kind, int C) {
  if (kind == 1) {
    int n = 0;
    const cudaError_t err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &n, colsum_kernel, kThreads, 0);
    return err == cudaSuccess ? n : -static_cast<int>(err);
  }
  if (C % 64 || C < 64 || C > 768) {
    return -static_cast<int>(cudaErrorInvalidValue);
  }
  return by_width(C, [](auto w) {
    return ln_bwd_occupancy<decltype(w)::value>();
  });
}

// x, dy, dx (M, C) bf16; g (C,) f32; dyln (M, C) f32; dg, db (C,) f32.
// C % 64 == 0 and C <= 768 (the wrapper checks). The rows are cut into
// ranges = ceil(M / rows) ranges, grouped `group` at a time
// (ops/common.py::plan_row_ranges); part is f32 scratch of
// (2, ranges + groups, C), cnt a u32 array of groups + 1 zeros (left at
// zero).
extern "C" int ln_backward_bf16(const void* x, const void* g, float eps,
                                const void* dy, const void* dyln, void* dx,
                                void* part, void* cnt, void* dg, void* db,
                                int M, int C, int rows, int group,
                                void* stream) {
  if (M <= 0 || C % 64 || rows <= 0 || group <= 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return by_width(C, [&](auto w) {
    return launch_ln_bwd<decltype(w)::value>(x, g, eps, dy, dyln, dx, part,
                                             cnt, dg, db, M, rows, group, s);
  });
}

// in (M, N) bf16, N % 8 == 0; out (N,) bf16 = the f32 column sums, rounded
// once. ranges = ceil(M / rows) row ranges grouped `group` at a time for
// each of the ceil(N / 256) column tiles; part is f32 scratch of
// (ranges + groups, N), cnt a u32 array of tiles * (groups + 1) zeros (left
// at zero).
extern "C" int colsum_bf16(const void* in, void* part, void* cnt, void* out,
                           int M, int N, int rows, int group, void* stream) {
  if (M <= 0 || N <= 0 || N % 8 || rows <= 0 || group <= 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const dim3 grid((N + kTile - 1) / kTile, (M + rows - 1) / rows);
  colsum_kernel<<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const bf16*>(in), static_cast<float*>(part),
      static_cast<unsigned*>(cnt), static_cast<bf16*>(out), M, N, rows,
      group);
  return static_cast<int>(cudaGetLastError());
}
