// The GEMM under the port's K1/K2 sub-block kernels and their bare K4/K5
// twins, forward and backward (it replaces the matrix products inside the
// TPU kernels eventpretrain_tpu/ops/fused_attn_layer.py::_ln_fwd_kernel,
// _ln_bwd_kernel, _fwd_kernel, _bwd_kernel and fused_mlp.py's four):
//
//     out[M, N] = epilogue(A[M, K] . B[K, N] + bias[N])
//
// bf16 operands, f32 accumulation on Hopper's tensor cores. Three operand
// layouts, one template:
//
//   forward  A (M, K) row-major, B given as W (N, K) row-major, i.e. A . W^T
//            (the (out, in) torch weights as they are);
//   dgrad    A (M, K) row-major, B given as W (K, N) row-major, i.e. dY . W
//            (the input gradient through a Linear);
//   wgrad    A given as dY (K, M) row-major and B as X (K, N) row-major,
//            i.e. dW = dY^T . X, the weight gradient summed over the K
//            tokens. K may be ragged.
//
// The LayerNorm of K1's and K2's inputs is not applied here: the wrapper
// runs ln_rows (csrc/ln_bwd.cu) first, whose bf16 rows are the values the
// earlier in-GEMM prologue staged, bit for bit (the same ln_row_stats and
// ln_apply of common.cuh), and hands them over as A. Normalising the staged
// A tiles inside this GEMM instead (a statistics pass, then the consumer
// warpgroup over each stage) cost 5 times that pass on the H100 (PERF.md).
//
// * Epilogue, in f32 on the accumulator registers (bias optional: a null
//   pointer adds nothing):
//     0  bias, rounded                 (qkv, K4/K5's proj and fc2,
//                                       do = dy.Wo, dW, K4/K5's dx)
//     1  bias + GELU, rounded          (fc1, fused_mlp.py:262-264)
//     2  bias + bf16 residual, rounded (proj / fc2 plus the skip)
//     3  bias, f32 out, no rounding    (d_yln = dqkv.Wqkv, fused_attn_layer
//        .py:170-173; h_pre, fused_mlp.py:295-297); with out2 it also
//        writes round(GELU(v)), the forward's h, from the same accumulator
//     4  x gelu'(aux[m, n]), rounded   (dh_pre = dh * gelu'(h_pre),
//        fused_mlp.py:307), aux the f32 h_pre
//
// What bounds it on the H100. Counting each input read once and each output
// written once, the main paths' products do 130 to 510 flops per byte
// against the card's 295 (989 TFLOP/s over 3.35 TB/s): at ViT-S's C = 384
// (K = C or 3C, outputs as large as the inputs) and for the f32 outputs
// (K2's h_pre, 103 MB, and the gelu' dgrad that reads it back) the bytes
// bound them; at C = 512 and 768 with K or N = 4C, the tensor cores. The
// weight gradients are a few output tiles (9 to 144 at C = 384..768) each
// reducing over every token: one block per tile would leave most of the
// 132 SMs idle.
//
// The design. Tiles of 128 x 128 outputs, 64 deep (128 bytes of bf16, one
// 128-byte swizzle row). One thread of a producer warpgroup fills a ring of
// six operand stages in shared memory with TMA (cp.async.bulk.tensor into
// an mbarrier; 128-byte swizzled tensor maps; out-of-range rows and tokens
// arrive as zeros). Two consumer warpgroups take the tiles in turn, each a
// whole tile: wgmma.mma_async m64n128k16 on both 64-row halves, both
// operands read from shared memory through matrix descriptors, 128
// accumulators a thread in up to 232 registers (setmaxnreg moves them from
// the producer warpgroup). Their main loops run one after the other, so one
// warpgroup's epilogue overlaps the other's products ("ping-pong"). wgmma
// takes either major order of a 16-bit operand through its transpose flags,
// so the dgrad's (K, N) weight and the wgrad's token-major operands are read
// as stored. One persistent block an SM walks over the tiles; the epilogue
// is a template argument, applied in registers on the accumulator
// fragments. The weight gradient's grid has a third dimension of S
// contiguous token ranges, each a multiple of 64 tokens
// (ops/common.py::plan_wgrad_split picks S so that there are about two
// tiles per SM); each tile writes its f32 partial to an (S, M, N) scratch
// and a second kernel adds the partials in split order and rounds once. No
// atomics: a weight gradient comes out the same bit for bit on every run.
// What the design leaves exposed: the epilogues that read or write an f32
// (M, N) array and evaluate erff per element (the gelu' dgrad, h_pre with
// its GELU output) run on one warpgroup at a time and take about 2.7 times
// torch.matmul's time for the product alone.
#include <cuda.h>  // CUtensorMap and its enums (types only; no -lcuda)
#include <stdint.h>

#include "common.cuh"

namespace {

constexpr int BM = 128;
constexpr int BN = 128;
constexpr int BK = 64;  // 128 bytes of bf16: one 128-byte swizzle row
constexpr int STAGES = 6;
constexpr int CONSUMERS = 2;  // warpgroups, a whole tile each, in turns
// and a producer warpgroup, of which one thread issues the copies: whole
// warpgroups, so that setmaxnreg can move registers from it to the
// consumers (40 and 232 a thread: 65,536 in all)
constexpr int THREADS = (CONSUMERS + 1) * 128;
constexpr int PRODUCER_REGS = 40;
constexpr int CONSUMER_REGS = 232;
// one operand's tile of a stage: 128 rows (or columns) by 64 deep
constexpr int TILE_BYTES = BM * BK * 2;
constexpr int STAGE_BYTES = 2 * TILE_BYTES;
// 64 rows of a K-major tile, or one 64-column box of an MN-major tile
constexpr int HALF_BYTES = 64 * BK * 2;
constexpr int SWIZZLE_ATOM = 1024;  // 8 rows of 128 bytes
// one block an SM: 193 KB of shared memory
constexpr int SMEM_BYTES = STAGES * STAGE_BYTES + SWIZZLE_ATOM;  // + align
constexpr int SUM_THREADS = 256;

enum Layout { kForward = 0, kDgrad = 1, kWgrad = 2 };

enum Epilogue {
  kBias = 0,
  kBiasGelu = 1,
  kBiasResidual = 2,
  kF32 = 3,
  kDGelu = 4,
};

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;" ::"r"(bar),
               "r"(count)
               : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::"r"(
                   bar),
               "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];" ::"r"(bar)
               : "memory");
}

// spin until the barrier's phase of this parity has completed. A wait that
// never ends (a lost copy, a wrong phase) traps, so it surfaces as a launch
// error instead of a hung card; a real wait is microseconds.
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  uint32_t done;
  uint32_t spins = 0;
  do {
    if (++spins == (1u << 28)) __trap();
    asm volatile(
        "{\n"
        ".reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n"
        "}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
  } while (!done);
}

// one box of a 2-D tensor map into shared memory; c0 is the inner
// (contiguous) coordinate
__device__ __forceinline__ void tma_load(uint32_t dst, const CUtensorMap* map,
                                         uint32_t bar, int c0, int c1) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%3, %4}], [%2];" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0), "r"(c1)
      : "memory");
}

// wgmma matrix descriptor of a 128-byte swizzled operand tile at a
// shared-memory address (16-byte units): leading byte offset (bits 16-29),
// stride byte offset (32-45), layout 1 = 128-byte swizzle (62-63). K-major:
// rows of 128 bytes, 8-row groups SBO apart, LBO unused (1). MN-major: 64
// contiguous MN elements a row, one row per k, 8-k groups SBO apart, the
// next 64 MN elements LBO further.
__device__ __forceinline__ uint64_t sw128_desc(uint32_t addr, uint32_t lbo,
                                               uint32_t sbo) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) |
         (static_cast<uint64_t>(lbo >> 4) << 16) |
         (static_cast<uint64_t>(sbo >> 4) << 32) | (1ull << 62);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;" ::: "memory");
}

__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;" ::: "memory");
}

template <int kPending>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;" ::"n"(kPending)
               : "memory");
}

// keep the compiler from moving accumulator reads or writes across the
// asynchronous products
__device__ __forceinline__ void fence_acc(float (&d)[64]) {
#pragma unroll
  for (int i = 0; i < 64; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

// d[64 x 128] += A[64 x 16] . B[16 x 128], both from shared memory; a
// transpose flag of 1 reads that operand MN-major
template <int kTransA, int kTransB>
__device__ __forceinline__ void wgmma_m64n128k16(float (&d)[64], uint64_t da,
                                                 uint64_t db) {
  asm volatile(
    "{\n"
    ".reg .pred p;\n"
    "setp.ne.b32 p, %66, 0;\n"
    "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
    "{"
    "%0, %1, %2, %3, %4, %5, %6, %7, "
    "%8, %9, %10, %11, %12, %13, %14, %15, "
    "%16, %17, %18, %19, %20, %21, %22, %23, "
    "%24, %25, %26, %27, %28, %29, %30, %31, "
    "%32, %33, %34, %35, %36, %37, %38, %39, "
    "%40, %41, %42, %43, %44, %45, %46, %47, "
    "%48, %49, %50, %51, %52, %53, %54, %55, "
    "%56, %57, %58, %59, %60, %61, %62, %63}, "
    "%64, %65, p, 1, 1, %67, %68;\n"
    "}\n"
    : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
      "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
      "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
      "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
      "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
      "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
      "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]),
      "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
      "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]),
      "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]),
      "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]),
      "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
      "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
    : "l"(da), "l"(db), "r"(1), "n"(kTransA), "n"(kTransB));
}

// The epilogue of one accumulator pair (columns n, n + 1 of row m, at idx
// = m * N + n), in f32, with the rounding points listed at the top.
template <int kEpi>
__device__ __forceinline__ void epilogue_pair(
    float v0, float v1, __nv_bfloat162 b, const bf16* __restrict__ residual,
    const float* __restrict__ aux, float* __restrict__ out_f32,
    bf16* __restrict__ out_bf16, bf16* __restrict__ out2, long long idx) {
  const float2 bf = __bfloat1622float2(b);
  v0 += bf.x;
  v1 += bf.y;
  if (kEpi == kF32) {
    *reinterpret_cast<float2*>(out_f32 + idx) = make_float2(v0, v1);
    if (out2 != nullptr) {
      *reinterpret_cast<__nv_bfloat162*>(out2 + idx) =
          __floats2bfloat162_rn(gelu_erf(v0), gelu_erf(v1));
    }
    return;
  }
  if (kEpi == kBiasGelu) {
    v0 = gelu_erf(v0);
    v1 = gelu_erf(v1);
  } else if (kEpi == kBiasResidual) {
    const float2 r = __bfloat1622float2(
        *reinterpret_cast<const __nv_bfloat162*>(residual + idx));
    v0 = r.x + v0;
    v1 = r.y + v1;
  } else if (kEpi == kDGelu) {
    const float2 x = *reinterpret_cast<const float2*>(aux + idx);
    v0 = v0 * gelu_erf_grad(x.x);
    v1 = v1 * gelu_erf_grad(x.y);
  }
  *reinterpret_cast<__nv_bfloat162*>(out_bf16 + idx) =
      __floats2bfloat162_rn(v0, v1);
}

// Persistent blocks, one an SM: block b takes the output tiles b, b + G,
// b + 2G, ... of the grid's T tiles (G blocks), tile t being column block
// t % NT, row block (t / NT) % MT and, for the weight gradient, token range
// t / (NT * MT): tokens [z * k_chunk, min(K, (z + 1) * k_chunk)). The two
// consumer warpgroups take the block's tiles in turn (warpgroup g its
// tiles g, g + 2, ...), each a whole 128 x 128 tile, and their main loops
// run one after the other in tile order (each waits for the other's to
// end), so one warpgroup's epilogue overlaps the other's products. The
// producer loads every stage in that same order, running ahead across
// tiles. Shared memory: STAGES stages of [A tile | B tile], 16 KB each,
// 1024-byte aligned.
//   A K-major (forward, dgrad): one box of 128 rows x 64 k;
//   A MN-major (wgrad): two boxes of 64 k rows x 64 m, m0 and m0 + 64;
//   B K-major (forward): one box of 128 rows (n) x 64 k;
//   B MN-major (dgrad, wgrad): two boxes of 64 k rows x 64 n.
// Either way rows 64 r .. 64 r + 63 of A lie at r * HALF_BYTES.
// The epilogue is a template argument, so its loads carry no branch and can
// all be issued before the stores.
template <int kLayout, int kEpi>
__global__ void __launch_bounds__(THREADS, 1)
    gemm_kernel(const __grid_constant__ CUtensorMap map_a,
                const __grid_constant__ CUtensorMap map_b,
                const bf16* __restrict__ bias,
                const bf16* __restrict__ residual,
                const float* __restrict__ aux, void* __restrict__ out,
                bf16* __restrict__ out2, int M, int N, int K, int k_chunk,
                int tiles) {
  constexpr bool kAK = kLayout != kWgrad;    // A K-major
  constexpr bool kBK = kLayout == kForward;  // B K-major
  extern __shared__ uint8_t smem_raw[];
  __shared__ __align__(8) uint64_t full[STAGES];
  __shared__ __align__(8) uint64_t empty[STAGES];
  // done[g] completes a phase each time warpgroup g's main loop ends
  __shared__ __align__(8) uint64_t done[CONSUMERS];
  const uint32_t base =
      (smem_u32(smem_raw) + SWIZZLE_ATOM - 1) & ~uint32_t(SWIZZLE_ATOM - 1);
  const int n_tiles = N / BN;
  const int m_tiles = (M + BM - 1) / BM;
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;

  if (threadIdx.x == 0) {
#pragma unroll
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(smem_u32(&full[s]), 1);
      mbar_init(smem_u32(&empty[s]), 4);  // a lane of each consuming warp
    }
#pragma unroll
    for (int g = 0; g < CONSUMERS; ++g) mbar_init(smem_u32(&done[g]), 1);
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();

  if (warp >= CONSUMERS * 4) {  // the producer warpgroup
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;" ::"n"(PRODUCER_REGS));
    if (warp != CONSUMERS * 4 || lane != 0) return;
    int it = 0;  // ring position, counted across tiles
    for (int t = blockIdx.x; t < tiles; t += gridDim.x) {
      const int n0 = (t % n_tiles) * BN;
      const int m0 = (t / n_tiles % m_tiles) * BM;
      const int k_begin = t / (n_tiles * m_tiles) * k_chunk;
      const int k_tiles = (min(K, k_begin + k_chunk) - k_begin + BK - 1) / BK;
      for (int kt = 0; kt < k_tiles; ++kt, ++it) {
        const int s = it % STAGES;
        // the first pass finds every stage free (parity of the phase
        // before the first)
        mbar_wait(smem_u32(&empty[s]), ((it / STAGES) & 1) ^ 1);
        const uint32_t bar = smem_u32(&full[s]);
        mbar_expect_tx(bar, STAGE_BYTES);
        const uint32_t sa = base + s * STAGE_BYTES;
        const uint32_t sb = sa + TILE_BYTES;
        const int k = k_begin + kt * BK;
        if (kAK) {
          tma_load(sa, &map_a, bar, k, m0);
        } else {
          tma_load(sa, &map_a, bar, m0, k);
          tma_load(sa + HALF_BYTES, &map_a, bar, m0 + 64, k);
        }
        if (kBK) {
          tma_load(sb, &map_b, bar, k, n0);
        } else {
          tma_load(sb, &map_b, bar, n0, k);
          tma_load(sb + HALF_BYTES, &map_b, bar, n0 + 64, k);
        }
      }
    }
    return;
  }

  // the consumers: warpgroup g, its warp w = warp % 4
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;" ::"n"(CONSUMER_REGS));
  const int g = warp / 4;
  const int w = warp % 4;
  int it = 0;     // ring position at the start of tile t
  int i = 0;      // t's place in the block's sequence of tiles
  int turns = 0;  // main loops the other warpgroup has ended, waited for
  for (int t = blockIdx.x; t < tiles; t += gridDim.x, ++i) {
    const int n0 = (t % n_tiles) * BN;
    const int m0 = (t / n_tiles % m_tiles) * BM;
    const int z = t / (n_tiles * m_tiles);
    const int k_begin = z * k_chunk;
    const int k_tiles = (min(K, k_begin + k_chunk) - k_begin + BK - 1) / BK;
    if ((i & 1) != g) {  // the other warpgroup's tile
      it += k_tiles;
      continue;
    }
    // the main loops run in tile order: tile i waits for tile i - 1's.
    // That also keeps every full-barrier wait below at most one phase
    // ahead of its barrier, as the parity test needs.
    if (i > 0) mbar_wait(smem_u32(&done[g ^ 1]), (turns++) & 1);
    float acc[2][64];
#pragma unroll
    for (int r = 0; r < 2; ++r)
#pragma unroll
      for (int j = 0; j < 64; ++j) acc[r][j] = 0.0f;
    for (int kt = 0; kt < k_tiles; ++kt, ++it) {
      const int s = it % STAGES;
      mbar_wait(smem_u32(&full[s]), (it / STAGES) & 1);
      const uint32_t sa = base + s * STAGE_BYTES;
      const uint32_t sb = base + s * STAGE_BYTES + TILE_BYTES;
      wgmma_fence();
      fence_acc(acc[0]);
      fence_acc(acc[1]);
#pragma unroll
      for (int kk = 0; kk < BK / 16; ++kk) {
        // 16 deep: 32 bytes along a K-major row, 16 rows of an MN-major box
        const uint64_t db = kBK ? sw128_desc(sb + kk * 32, 16, SWIZZLE_ATOM)
                                : sw128_desc(sb + kk * 16 * 128, HALF_BYTES,
                                             SWIZZLE_ATOM);
#pragma unroll
        for (int r = 0; r < 2; ++r) {
          const uint32_t ar = sa + r * HALF_BYTES;
          const uint64_t da =
              kAK ? sw128_desc(ar + kk * 32, 16, SWIZZLE_ATOM)
                  : sw128_desc(ar + kk * 16 * 128, HALF_BYTES, SWIZZLE_ATOM);
          wgmma_m64n128k16<kAK ? 0 : 1, kBK ? 0 : 1>(acc[r], da, db);
        }
      }
      wgmma_commit();
      fence_acc(acc[0]);
      fence_acc(acc[1]);
      // the previous stage's products are done: hand its buffers back
      wgmma_wait<1>();
      fence_acc(acc[0]);
      fence_acc(acc[1]);
      if (kt > 0 && lane == 0) {
        mbar_arrive(smem_u32(&empty[(it - 1) % STAGES]));
      }
    }
    // the other warpgroup's next main loop may start
    if (threadIdx.x % 128 == 0) mbar_arrive(smem_u32(&done[g]));
    wgmma_wait<0>();
    fence_acc(acc[0]);
    fence_acc(acc[1]);
    if (k_tiles > 0 && lane == 0) {
      mbar_arrive(smem_u32(&empty[(it - 1) % STAGES]));
    }

    // accumulator fragment: register 4 j + 2 h + e of acc[r] holds row
    // 64 r + 16 w + lane / 4 + 8 h and column 8 j + 2 (lane % 4) + e
    const int col0 = n0 + (lane % 4) * 2;
    __nv_bfloat162 bias2[16];
#pragma unroll
    for (int j = 0; j < 16; ++j) {
      bias2[j] = bias != nullptr ? *reinterpret_cast<const __nv_bfloat162*>(
                                       bias + col0 + j * 8)
                                 : __floats2bfloat162_rn(0.0f, 0.0f);
    }
    // a weight gradient's split writes its own partial (S, M, N) slice
    float* out_f32 =
        static_cast<float*>(out) + (long long)z * M * (long long)N;
    bf16* out_bf16 = static_cast<bf16*>(out);
#pragma unroll
    for (int r = 0; r < 2; ++r) {
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int m = m0 + 64 * r + 16 * w + lane / 4 + 8 * h;
        if (m >= M) continue;
#pragma unroll
        for (int j = 0; j < 16; ++j) {
          epilogue_pair<kEpi>(acc[r][4 * j + 2 * h], acc[r][4 * j + 2 * h + 1],
                              bias2[j], residual, aux, out_f32, out_bf16,
                              out2, (long long)m * N + col0 + j * 8);
        }
      }
    }
  }
}

// out[i] = the sum of part[z, i] over the splits z, in split order, rounded
// to bf16 once; four elements a thread
__global__ void __launch_bounds__(SUM_THREADS)
    split_sum_kernel(const float* __restrict__ part, int splits,
                     long long mn, bf16* __restrict__ out) {
  const long long i =
      ((long long)blockIdx.x * SUM_THREADS + threadIdx.x) * 4;
  if (i >= mn) return;
  float4 s = *reinterpret_cast<const float4*>(part + i);
  for (int z = 1; z < splits; ++z) {
    const float4 v = *reinterpret_cast<const float4*>(part + z * mn + i);
    s.x += v.x;
    s.y += v.y;
    s.z += v.z;
    s.w += v.w;
  }
  __nv_bfloat162* o = reinterpret_cast<__nv_bfloat162*>(out + i);
  o[0] = __floats2bfloat162_rn(s.x, s.y);
  o[1] = __floats2bfloat162_rn(s.z, s.w);
}

typedef CUresult (*EncodeTiled)(CUtensorMap*, CUtensorMapDataType, cuuint32_t,
                                void*, const cuuint64_t*, const cuuint64_t*,
                                const cuuint32_t*, const cuuint32_t*,
                                CUtensorMapInterleave, CUtensorMapSwizzle,
                                CUtensorMapL2promotion,
                                CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled through the runtime's driver entry point, so the
// library needs no link against libcuda
EncodeTiled encode_tiled() {
  static EncodeTiled fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found = cudaDriverEntryPointSymbolNotFound;
#if CUDART_VERSION >= 12050
    const cudaError_t err = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &found);
#else
    const cudaError_t err = cudaGetDriverEntryPoint(
        "cuTensorMapEncodeTiled", &p, cudaEnableDefault, &found);
#endif
    if (err == cudaSuccess && found == cudaDriverEntryPointSuccess) {
      fn = reinterpret_cast<EncodeTiled>(p);
    }
  }
  return fn;
}

// A row-major bf16 (rows, cols) matrix read in boxes of 64 columns (128
// bytes, 128-byte swizzle) by box_rows rows; out-of-range elements read 0.
cudaError_t make_map(CUtensorMap* map, const void* ptr, int rows, int cols,
                     int box_rows) {
  const EncodeTiled fn = encode_tiled();
  if (fn == nullptr) return cudaErrorNotSupported;
  const cuuint64_t dims[2] = {static_cast<cuuint64_t>(cols),
                              static_cast<cuuint64_t>(rows)};
  const cuuint64_t strides[1] = {static_cast<cuuint64_t>(cols) * 2};
  const cuuint32_t box[2] = {static_cast<cuuint32_t>(BK),
                             static_cast<cuuint32_t>(box_rows)};
  const cuuint32_t elem_strides[2] = {1, 1};
  const CUresult r = fn(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2,
                        const_cast<void*>(ptr), dims, strides, box,
                        elem_strides, CU_TENSOR_MAP_INTERLEAVE_NONE,
                        CU_TENSOR_MAP_SWIZZLE_128B,
                        CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                        CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? cudaSuccess : cudaErrorInvalidValue;
}

// the SM count of a device, read once
int sm_count(int dev) {
  static int counts[64] = {0};
  if (dev < 0 || dev >= 64) return 0;
  if (counts[dev] == 0) {
    cudaDeviceGetAttribute(&counts[dev], cudaDevAttrMultiProcessorCount, dev);
  }
  return counts[dev];
}

// once per device and kernel: above 48 KB of shared memory only by opting
// in, and the whole of the SM's shared memory for it
template <int kLayout, int kEpi>
cudaError_t configure(int dev) {
  static bool done[64] = {false};
  if (dev < 0 || dev >= 64) return cudaErrorInvalidDevice;
  if (done[dev]) return cudaSuccess;
  cudaError_t err = cudaFuncSetAttribute(
      gemm_kernel<kLayout, kEpi>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      SMEM_BYTES);
  if (err == cudaSuccess) {
    err = cudaFuncSetAttribute(gemm_kernel<kLayout, kEpi>,
                               cudaFuncAttributePreferredSharedMemoryCarveout,
                               cudaSharedmemCarveoutMaxShared);
  }
  done[dev] = err == cudaSuccess;
  return err;
}

struct Args {
  const bf16* bias;
  const bf16* residual;
  const float* aux;
  void* out;
  bf16* out2;
  int M, N, K, k_chunk, tiles;
};

template <int kLayout, int kEpi>
cudaError_t launch(cudaStream_t s, const CUtensorMap& ma,
                   const CUtensorMap& mb, const Args& x) {
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess) err = configure<kLayout, kEpi>(dev);
  if (err != cudaSuccess) return err;
  const int sms = sm_count(dev);
  if (sms == 0) return cudaErrorInvalidDevice;
  gemm_kernel<kLayout, kEpi><<<min(x.tiles, sms), THREADS, SMEM_BYTES,
                               s>>>(ma, mb, x.bias, x.residual, x.aux, x.out,
                                    x.out2, x.M, x.N, x.K, x.k_chunk,
                                    x.tiles);
  return cudaGetLastError();
}

template <int kLayout>
cudaError_t launch_epilogue(int epilogue, cudaStream_t s,
                            const CUtensorMap& ma, const CUtensorMap& mb,
                            const Args& x) {
  switch (epilogue) {
    case kBias:
      return launch<kLayout, kBias>(s, ma, mb, x);
    case kBiasGelu:
      return launch<kLayout, kBiasGelu>(s, ma, mb, x);
    case kBiasResidual:
      return launch<kLayout, kBiasResidual>(s, ma, mb, x);
    case kF32:
      return launch<kLayout, kF32>(s, ma, mb, x);
    case kDGelu:
      return launch<kLayout, kDGelu>(s, ma, mb, x);
    default:
      return cudaErrorInvalidValue;
  }
}

}  // namespace

// out[M, N] = epilogue(A . B + bias); layout 0 forward, 1 dgrad, 2 wgrad
// (see the top of the file). All bf16 operands row-major and 16-byte
// aligned; aux (M, N) f32; out bf16, or f32 for epilogue 3; out2 (M, N)
// bf16 or null; bias (N,) or null. Requires N % 128 == 0; forward and dgrad
// K % 64 == 0 with M ragged; wgrad M % 128 == 0, K >= 1 ragged, k_chunk a
// positive multiple of 64 (the wrapper checks). The weight gradient is
// summed over ceil(K / k_chunk) token ranges: with more than one, the
// blocks write f32 partials to part (splits, M, N) and a second kernel adds
// them into out; with one, part is unused.
extern "C" int gemm_bf16(const void* a, const void* w, const void* bias,
                         const void* residual, const void* aux, void* out,
                         void* out2, void* part, int M, int N, int K,
                         int layout, int epilogue, int k_chunk,
                         void* stream) {
  if (M == 0) return 0;
  if (N % BN != 0 || K <= 0) return static_cast<int>(cudaErrorInvalidValue);
  CUtensorMap ma, mb;
  cudaError_t err;
  if (layout == kForward) {
    err = make_map(&ma, a, M, K, BM);
    if (err == cudaSuccess) err = make_map(&mb, w, N, K, BN);
  } else if (layout == kDgrad) {
    err = make_map(&ma, a, M, K, BM);
    if (err == cudaSuccess) err = make_map(&mb, w, K, N, 64);
  } else if (layout == kWgrad) {
    if (M % BM != 0 || k_chunk <= 0 || k_chunk % BK != 0) {
      return static_cast<int>(cudaErrorInvalidValue);
    }
    err = make_map(&ma, a, K, M, 64);
    if (err == cudaSuccess) err = make_map(&mb, w, K, N, 64);
  } else {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (err != cudaSuccess) return static_cast<int>(err);
  if (layout != kWgrad) k_chunk = K;
  const int splits = (K + k_chunk - 1) / k_chunk;
  Args x{static_cast<const bf16*>(bias), static_cast<const bf16*>(residual),
         static_cast<const float*>(aux), out, static_cast<bf16*>(out2),
         M, N, K, k_chunk, (N / BN) * ((M + BM - 1) / BM) * splits};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (layout == kForward) {
    return static_cast<int>(launch_epilogue<kForward>(epilogue, s, ma, mb, x));
  }
  if (layout == kDgrad) {
    return static_cast<int>(launch_epilogue<kDgrad>(epilogue, s, ma, mb, x));
  }
  if (splits == 1) {
    return static_cast<int>(launch_epilogue<kWgrad>(epilogue, s, ma, mb, x));
  }
  if (part == nullptr) return static_cast<int>(cudaErrorInvalidValue);
  x.bias = nullptr;
  x.out = part;
  err = launch<kWgrad, kF32>(s, ma, mb, x);
  if (err != cudaSuccess) return static_cast<int>(err);
  const long long mn = (long long)M * N;
  const long long blocks = (mn / 4 + SUM_THREADS - 1) / SUM_THREADS;
  split_sum_kernel<<<static_cast<unsigned>(blocks), SUM_THREADS, 0, s>>>(
      static_cast<const float*>(part), splits, mn, static_cast<bf16*>(out));
  return static_cast<int>(cudaGetLastError());
}
