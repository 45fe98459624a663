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
// On the TPU those column sums accumulate in VMEM across the sequential
// batch grid. Hopper blocks run in no set order, so each sum is two passes:
// every block writes the partial sums of its own rows (in row order, and the
// warps' partials combined in warp order), and a second kernel adds the
// partial rows in block order. No atomics, so a sum comes out the same bit
// for bit on every run and the kernel path can be held step by step against
// the plain one. These kernels are bound by device-memory bytes (each row is
// read once; the partial sums are 1/64 of the input).
#include "common.cuh"

namespace {

constexpr int kWarps = 8;
constexpr int kMaxPairsPerLane = 12;  // C <= 768: C / 64 column pairs a lane

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

// part[blockIdx.x, :] = the sum over the block's warps of each warp's
// per-lane column sums, in warp order.
__device__ __forceinline__ void block_partial(
    const float (&acc)[2 * kMaxPairsPerLane], float (*red)[768],
    float* __restrict__ part, int lane, int warp, int pairs, int C) {
#pragma unroll
  for (int t = 0; t < kMaxPairsPerLane; ++t) {
    const int p = lane + 32 * t;
    if (p < pairs) {
      red[warp][2 * p] = acc[2 * t];
      red[warp][2 * p + 1] = acc[2 * t + 1];
    }
  }
  __syncthreads();
  for (int c = threadIdx.x; c < C; c += blockDim.x) {
    float s = 0.0f;
    for (int w = 0; w < kWarps; ++w) s += red[w][c];
    part[(long long)blockIdx.x * C + c] = s;
  }
  __syncthreads();
}

// dx for rows [blockIdx.x * rows, + rows), one warp per row, and the
// block's partial dgamma / dbeta. Lane l owns the column pairs l + 32 t.
__global__ void __launch_bounds__(kWarps * 32)
    ln_bwd_kernel(const bf16* __restrict__ x, const float* __restrict__ g,
                  float eps, const bf16* __restrict__ dy,
                  const float* __restrict__ dyln, bf16* __restrict__ dx,
                  float* __restrict__ part_dg, float* __restrict__ part_db,
                  int M, int C, int rows) {
  __shared__ float red[kWarps][768];
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int pairs = C / 2;
  float acc_g[2 * kMaxPairsPerLane], acc_b[2 * kMaxPairsPerLane];
#pragma unroll
  for (int t = 0; t < 2 * kMaxPairsPerLane; ++t) acc_g[t] = acc_b[t] = 0.0f;

  const int r0 = blockIdx.x * rows;
  const int r1 = min(M, r0 + rows);
  for (int row = r0 + warp; row < r1; row += kWarps) {
    const bf16* xr = x + (long long)row * C;
    float mu, rstd;
    ln_row_stats(xr, C, eps, lane, &mu, &rstd);
    const __nv_bfloat162* x2 = reinterpret_cast<const __nv_bfloat162*>(xr);
    const float2* d2 =
        reinterpret_cast<const float2*>(dyln + (long long)row * C);
    float xh[2 * kMaxPairsPerLane], dxh[2 * kMaxPairsPerLane];
    float s1 = 0.0f, s2 = 0.0f;
#pragma unroll
    for (int t = 0; t < kMaxPairsPerLane; ++t) {
      const int p = lane + 32 * t;
      xh[2 * t] = xh[2 * t + 1] = dxh[2 * t] = dxh[2 * t + 1] = 0.0f;
      if (p < pairs) {
        const float2 v = __bfloat1622float2(x2[p]);
        const float2 d = d2[p];
        xh[2 * t] = ln_xhat(v.x, mu, rstd);
        xh[2 * t + 1] = ln_xhat(v.y, mu, rstd);
        acc_g[2 * t] += d.x * xh[2 * t];
        acc_g[2 * t + 1] += d.y * xh[2 * t + 1];
        acc_b[2 * t] += d.x;
        acc_b[2 * t + 1] += d.y;
        dxh[2 * t] = d.x * g[2 * p];
        dxh[2 * t + 1] = d.y * g[2 * p + 1];
        s1 += dxh[2 * t] + dxh[2 * t + 1];
        s2 += dxh[2 * t] * xh[2 * t] + dxh[2 * t + 1] * xh[2 * t + 1];
      }
    }
    const float m1 = warp_sum(s1) / C;
    const float m2 = warp_sum(s2) / C;
    const __nv_bfloat162* dy2 =
        reinterpret_cast<const __nv_bfloat162*>(dy + (long long)row * C);
    __nv_bfloat162* dx2 =
        reinterpret_cast<__nv_bfloat162*>(dx + (long long)row * C);
#pragma unroll
    for (int t = 0; t < kMaxPairsPerLane; ++t) {
      const int p = lane + 32 * t;
      if (p < pairs) {
        const float2 r = __bfloat1622float2(dy2[p]);
        dx2[p] = __floats2bfloat162_rn(
            r.x + rstd * (dxh[2 * t] - m1 - xh[2 * t] * m2),
            r.y + rstd * (dxh[2 * t + 1] - m1 - xh[2 * t + 1] * m2));
      }
    }
  }

  // the block's partial sums: warps' partials added in warp order
  block_partial(acc_g, red, part_dg, lane, warp, pairs, C);
  block_partial(acc_b, red, part_db, lane, warp, pairs, C);
}

// part[blockIdx.y, n] = sum of in[r, n] over the block's rows, in row order.
__global__ void colsum_partial_kernel(const bf16* __restrict__ in,
                                      float* __restrict__ part, int M, int N,
                                      int rows) {
  const int n = blockIdx.x * blockDim.x + threadIdx.x;
  if (n >= N) return;
  const int r0 = blockIdx.y * rows;
  const int r1 = min(M, r0 + rows);
  float s = 0.0f;
  for (int r = r0; r < r1; ++r) s += __bfloat162float(in[(long long)r * N + n]);
  part[(long long)blockIdx.y * N + n] = s;
}

// out[n] = sum of part[r, n] over the R partial rows, in order; f32 out, or
// rounded to bf16 when out_bf16 is given.
__global__ void colsum_final_kernel(const float* __restrict__ part, int R,
                                    int N, float* __restrict__ out_f32,
                                    bf16* __restrict__ out_bf16) {
  const int n = blockIdx.x * blockDim.x + threadIdx.x;
  if (n >= N) return;
  float s = 0.0f;
  for (int r = 0; r < R; ++r) s += part[(long long)r * N + n];
  if (out_bf16 != nullptr) {
    out_bf16[n] = __float2bfloat16(s);
  } else {
    out_f32[n] = s;
  }
}

constexpr int kColThreads = 256;

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

// x, dy, dx (M, C) bf16; g (C,) f32; dyln (M, C) f32; part (2, nblk, C) f32
// scratch with nblk = ceil(M / rows); dg, db (C,) f32. C % 64 == 0 and
// C <= 768 (the wrapper checks).
extern "C" int ln_backward_bf16(const void* x, const void* g, float eps,
                                const void* dy, const void* dyln, void* dx,
                                void* part, void* dg, void* db, int M, int C,
                                int rows, void* stream) {
  if (M == 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int nblk = (M + rows - 1) / rows;
  float* part_dg = static_cast<float*>(part);
  float* part_db = part_dg + (long long)nblk * C;
  ln_bwd_kernel<<<nblk, kWarps * 32, 0, s>>>(
      static_cast<const bf16*>(x), static_cast<const float*>(g), eps,
      static_cast<const bf16*>(dy), static_cast<const float*>(dyln),
      static_cast<bf16*>(dx), part_dg, part_db, M, C, rows);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  const int grid = (C + kColThreads - 1) / kColThreads;
  colsum_final_kernel<<<grid, kColThreads, 0, s>>>(
      part_dg, nblk, C, static_cast<float*>(dg), nullptr);
  colsum_final_kernel<<<grid, kColThreads, 0, s>>>(
      part_db, nblk, C, static_cast<float*>(db), nullptr);
  return static_cast<int>(cudaGetLastError());
}

// in (M, N) bf16; part (nblk, N) f32 scratch with nblk = ceil(M / rows);
// out (N,) bf16 = the f32 column sums, rounded once.
extern "C" int colsum_bf16(const void* in, void* part, void* out, int M, int N,
                           int rows, void* stream) {
  if (N == 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int nblk = M == 0 ? 0 : (M + rows - 1) / rows;
  const int gx = (N + kColThreads - 1) / kColThreads;
  if (nblk > 0) {
    colsum_partial_kernel<<<dim3(gx, nblk), kColThreads, 0, s>>>(
        static_cast<const bf16*>(in), static_cast<float*>(part), M, N, rows);
    cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  colsum_final_kernel<<<gx, kColThreads, 0, s>>>(
      static_cast<const float*>(part), nblk, N, nullptr,
      static_cast<bf16*>(out));
  return static_cast<int>(cudaGetLastError());
}
