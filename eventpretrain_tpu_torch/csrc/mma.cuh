// Tensor-core building blocks shared by the attention kernels (the one-pass
// bodies of attention_core.cuh, which the K1/K4 attention core and K7's
// one-pass route wrap; mha.cu, K7's tiled kernels): the bf16
// mma.sync.m16n8k16 product, its fragment loaders, the quad reductions over
// an accumulator row, the softmax of a warp's score rows, ldmatrix, and
// 16-byte cp.async.
//
// Fragments of mma.m16n8k16 (PTX ISA, "Matrix Fragments for
// mma.m16n8k16"), lane = 4 * g + t:
//   A (16 x 16, row-major)  a0 (g, 2t..2t+1)  a1 (g + 8, 2t..)
//                           a2 (g, 8 + 2t..)  a3 (g + 8, 8 + 2t..)
//   B (16 x 8, k x n)       b0 (k = 2t..2t+1, n = g)  b1 (k = 8 + 2t.., n = g)
//   C (16 x 8, f32)         c0, c1 (g, 2t..2t+1)  c2, c3 (g + 8, 2t..2t+1)
#pragma once

#include <math.h>
#include <stdint.h>

#include "common.cuh"

__host__ __device__ constexpr int round16(int n) {
  return (n + 15) / 16 * 16;
}

__device__ __forceinline__ void mma_bf16(float c[4], const uint32_t a[4],
                                         const uint32_t b[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

__device__ __forceinline__ uint32_t pack_f32(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

__device__ __forceinline__ uint32_t pack_bf16(bf16 lo, bf16 hi) {
  return static_cast<uint32_t>(__bfloat16_as_ushort(lo)) |
         (static_cast<uint32_t>(__bfloat16_as_ushort(hi)) << 16);
}

__device__ __forceinline__ uint32_t ld32(const bf16* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

// A (16 x 16) from row-major X[m][k]:
__device__ __forceinline__ void frag_a(uint32_t a[4], const bf16* x, int ld,
                                       int m0, int k0, int g, int t) {
  const bf16* r0 = x + (m0 + g) * ld + k0 + 2 * t;
  const bf16* r1 = r0 + 8 * ld;
  a[0] = ld32(r0);
  a[1] = ld32(r1);
  a[2] = ld32(r0 + 8);
  a[3] = ld32(r1 + 8);
}

// B (16 x 8), B(k, n) = Y[n][k]: a row-major operand used transposed.
__device__ __forceinline__ void frag_b_nk(uint32_t b[2], const bf16* y,
                                          int ld, int n0, int k0, int g,
                                          int t) {
  const bf16* r = y + (n0 + g) * ld + k0 + 2 * t;
  b[0] = ld32(r);
  b[1] = ld32(r + 8);
}

// B (16 x 8), B(k, n) = Z[k][n]: a row-major operand used as it is.
__device__ __forceinline__ void frag_b_kn(uint32_t b[2], const bf16* z,
                                          int ld, int k0, int n0, int g,
                                          int t) {
  const bf16* c = z + (k0 + 2 * t) * ld + n0 + g;
  b[0] = pack_bf16(c[0], c[ld]);
  b[1] = pack_bf16(c[8 * ld], c[9 * ld]);
}

// The f32 accumulators of two neighbouring n8 tiles, rounded to bf16, as the
// A fragment of the next product (its k = their n).
__device__ __forceinline__ void acc_to_a(uint32_t a[4], const float lo[4],
                                         const float hi[4]) {
  a[0] = pack_f32(lo[0], lo[1]);
  a[1] = pack_f32(lo[2], lo[3]);
  a[2] = pack_f32(hi[0], hi[1]);
  a[3] = pack_f32(hi[2], hi[3]);
}

__device__ __forceinline__ float quad_max(float v) {
  v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 1));
  return fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 2));
}

__device__ __forceinline__ float quad_sum(float v) {
  v += __shfl_xor_sync(0xffffffffu, v, 1);
  return v + __shfl_xor_sync(0xffffffffu, v, 2);
}

// ---- x / y for many x of one y, bit for bit __fdiv_rn's quotient

// Markstein's FMA correction: with ry = __frcp_rn(y), the correctly rounded
// reciprocal, q = RN(x * ry) lies within an ulp of x / y, r = x - y * q is
// exact in one FMA, and RN(q + r * ry) is the correctly rounded quotient
// (Markstein 1990; Muller et al., Handbook of Floating-Point Arithmetic,
// "Newton-Raphson-based division with an FMA"), provided nothing
// underflows: div_rcp_exact(x) and 1 <= y <= 2^24 (a softmax's row sum)
// keep x, q and r normal. A caller takes __fdiv_rn for any other x.
__device__ __forceinline__ float div_rcp(float x, float y, float ry) {
  const float q = __fmul_rn(x, ry);
  return __fmaf_rn(__fmaf_rn(-y, q, x), ry, q);
}

__device__ __forceinline__ bool div_rcp_exact(float x) {
  return x == 0.0f || (x >= 0x1p-100f && x <= 1.0f);
}

// ---- the softmax of a warp's 16 score rows, held in registers

// p = softmax(s * scale) over the keys of rows g and g + 8 of a warp's 16,
// in place: s holds q.k^T as 2 * KT n8 accumulator tiles (tile j: keys 8j +
// 2t + (e & 1), rows g for e < 2 and g + 8 for e >= 2), the first 2 * nkt
// of them computed. Keys past L (only in the last 16) are masked to -inf
// before the max. The sums are f32 in a fixed order; p = x / sum is
// __fdiv_rn's quotient, through one correctly rounded reciprocal of the sum
// (div_rcp) unless a row has an x that could underflow there. ``stats``, if
// given, receives each row's (max, sum).
template <int KT>
__device__ __forceinline__ void softmax_rows(float s[2 * KT][4], int nkt,
                                             int L, int t, float scale,
                                             float stats[2][2]) {
  float mx[2] = {-INFINITY, -INFINITY}, sum[2] = {0.0f, 0.0f};
#pragma unroll
  for (int j = 0; j < 2 * KT; ++j) {
    if (j < 2 * nkt) {
      const bool tail = j >= 2 * nkt - 2;
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        s[j][e] = __fmul_rn(s[j][e], scale);
        if (tail && 8 * j + 2 * t + (e & 1) >= L) s[j][e] = -INFINITY;
        mx[e >> 1] = fmaxf(mx[e >> 1], s[j][e]);
      }
    }
  }
  mx[0] = quad_max(mx[0]);
  mx[1] = quad_max(mx[1]);
  bool exact = true;
#pragma unroll
  for (int j = 0; j < 2 * KT; ++j) {
    if (j < 2 * nkt) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        s[j][e] = expf(__fsub_rn(s[j][e], mx[e >> 1]));
        sum[e >> 1] = __fadd_rn(sum[e >> 1], s[j][e]);
        exact &= div_rcp_exact(s[j][e]);
      }
    }
  }
  sum[0] = quad_sum(sum[0]);
  sum[1] = quad_sum(sum[1]);
  if (exact) {
    const float rs[2] = {__frcp_rn(sum[0]), __frcp_rn(sum[1])};
#pragma unroll
    for (int j = 0; j < 2 * KT; ++j) {
      if (j < 2 * nkt) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          s[j][e] = div_rcp(s[j][e], sum[e >> 1], rs[e >> 1]);
        }
      }
    }
  } else {
#pragma unroll
    for (int j = 0; j < 2 * KT; ++j) {
      if (j < 2 * nkt) {
#pragma unroll
        for (int e = 0; e < 4; ++e) s[j][e] = __fdiv_rn(s[j][e], sum[e >> 1]);
      }
    }
  }
  if (stats != nullptr) {
    stats[0][0] = mx[0];
    stats[0][1] = sum[0];
    stats[1][0] = mx[1];
    stats[1][1] = sum[1];
  }
}

// ---- shared-memory tiles: ldmatrix and cp.async

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// Four 8 x 8 bf16 matrices; lane l gives the address of row l % 8 of
// matrix l / 8 (16 bytes, 16-byte aligned), and r[i] is matrix i in the
// fragment layout: thread (g, t) holds row g, columns 2t and 2t + 1.
__device__ __forceinline__ void ldsm_x4(uint32_t r[4], const bf16* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_addr(p)));
}

// The same, each matrix transposed: thread (g, t) holds rows 2t and 2t + 1
// of column g.
__device__ __forceinline__ void ldsm_x4_trans(uint32_t r[4], const bf16* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, "
      "[%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_addr(p)));
}

// A (16 x 16) of rows m0.. and columns k0.. of a row-major bf16 tile.
__device__ __forceinline__ void ldsm_a(uint32_t a[4], const bf16* x, int ld,
                                       int m0, int k0, int lane) {
  ldsm_x4(a, x + (m0 + (lane & 15)) * ld + k0 + (lane >> 4) * 8);
}

// B of two n8 tiles, B(k, n) = Y[n0 + n][k0 + k] (rows of Y are the n):
// b[0..1] the tile n0, b[2..3] the tile n0 + 8.
__device__ __forceinline__ void ldsm_b_nk(uint32_t b[4], const bf16* y,
                                          int ld, int n0, int k0, int lane) {
  ldsm_x4(b, y + (n0 + (lane & 7) + (lane >> 4) * 8) * ld + k0 +
                 ((lane >> 3) & 1) * 8);
}

// B of two n8 tiles, B(k, n) = Z[k0 + k][n0 + n] (rows of Z are the k):
// b[0..1] the tile n0, b[2..3] the tile n0 + 8.
__device__ __forceinline__ void ldsm_b_kn(uint32_t b[4], const bf16* z,
                                          int ld, int k0, int n0, int lane) {
  ldsm_x4_trans(b, z + (k0 + (lane & 7) + ((lane >> 3) & 1) * 8) * ld + n0 +
                       (lane >> 4) * 8);
}

// 16 bytes from global to shared memory, asynchronously; zeros when !valid
// (then nothing is read, and src only has to be a mapped address).
__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   smem_addr(dst)),
               "l"(src), "r"(valid ? 16 : 0));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

// Wait until at most N committed groups of this thread are in flight.
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}
