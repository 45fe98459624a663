// The attention core of K1's and K4's backward: per (sample, head), from
// the packed qkv rows and the head outputs' gradient do, the gradients dq,
// dk, dv, on the tensor cores.
//
// Replaces the per-head loop of eventpretrain_tpu/ops/fused_attn_layer.py::
// _layer_bwd (:142-164). Two thin kernels, a dq kernel and then a dk/dv
// kernel, resolve the packed rows of their (sample, head) — q, k, v and dq,
// dk, dv at row stride 3C, do at row stride C — and run the one-pass
// backward bodies of attention_core.cuh, which K7's one-pass route (mha.cu)
// wraps too. That header says how the bodies work and what bounds them on
// this card. The dq kernel saves each row's (max, sum, dd) in a (3, B, H, L)
// f32 scratch that the dk/dv kernel reads; there are no atomics, and the
// result repeats bit for bit.
#include "attention_core.cuh"

namespace {

using onepass::kRows;
using onepass::kThreads;

template <int KT>  // KT * 16 >= Lp: the score tiles a thread holds
__global__ void __launch_bounds__(kThreads)
    attention_dq_kernel(const bf16* __restrict__ qkv,
                        const bf16* __restrict__ dout, bf16* __restrict__ dqkv,
                        float* __restrict__ stats, int B, int L, int H, int D,
                        float scale) {
  const int h = blockIdx.y, b = blockIdx.z;
  const int C = H * D;
  const long long stride = 3LL * C, row_b = static_cast<long long>(b) * L;
  const bf16* head = qkv + row_b * stride + h * D;
  onepass::dq_block<KT>(
      {head, stride}, {head + C, stride}, {head + 2 * C, stride},
      {dout + row_b * C + h * D, C}, {dqkv + row_b * stride + h * D, stride},
      stats + (static_cast<long long>(b) * H + h) * L,
      static_cast<long long>(B) * H * L, L, D, scale);
}

__global__ void __launch_bounds__(kThreads)
    attention_dkdv_kernel(const bf16* __restrict__ qkv,
                          const bf16* __restrict__ dout,
                          bf16* __restrict__ dqkv,
                          const float* __restrict__ stats, int B, int L,
                          int H, int D, float scale) {
  const int h = blockIdx.y, b = blockIdx.z;
  const int C = H * D;
  const long long stride = 3LL * C, row_b = static_cast<long long>(b) * L;
  const bf16* head = qkv + row_b * stride + h * D;
  bf16* dhead = dqkv + row_b * stride + h * D;
  onepass::dkdv_block(
      {head, stride}, {head + C, stride}, {head + 2 * C, stride},
      {dout + row_b * C + h * D, C}, {dhead + C, stride},
      {dhead + 2 * C, stride}, stats + (static_cast<long long>(b) * H + h) * L,
      static_cast<long long>(B) * H * L, L, D, scale);
}

}  // namespace

extern "C" long long attention_bwd_smem_bytes(int L, int D) {
  return onepass::bwd_smem_bytes(L, D);
}

// qkv (B, L, 3*H*D) bf16 packed [q | k | v] with head h at columns h*D;
// dout (B, L, H*D) bf16 the gradient of the concatenated head outputs;
// dqkv (B, L, 3*H*D) bf16 in the same packing; stats (3, B, H, L) f32
// scratch: the dq kernel writes each row's max, sum and dd, and the dk/dv
// kernel after it on the same stream reads them. Requires L <= 256, D % 8
// == 0, D <= 256, H*D % 128 == 0 and 16-byte aligned pointers (the wrapper
// checks).
extern "C" int attention_bwd_bf16(const void* qkv, const void* dout,
                                  void* dqkv, void* stats, int B, int L,
                                  int H, int D, float scale, void* stream) {
  if (B == 0 || L == 0) return 0;
  if (L > 256) return static_cast<int>(cudaErrorInvalidValue);
  const int smem = static_cast<int>(attention_bwd_smem_bytes(L, D));
  const bf16* q = static_cast<const bf16*>(qkv);
  const bf16* d = static_cast<const bf16*>(dout);
  bf16* dx = static_cast<bf16*>(dqkv);
  float* st = static_cast<float*>(stats);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const dim3 grid((L + kRows - 1) / kRows, H, B);
  const int code = onepass::with_key_tiles(L, [&](auto kt) {
    constexpr int KT = decltype(kt)::value;
    cudaError_t err = cudaFuncSetAttribute(
        attention_dq_kernel<KT>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        smem);
    if (err != cudaSuccess) return static_cast<int>(err);
    attention_dq_kernel<KT><<<grid, kThreads, smem, s>>>(q, d, dx, st, B, L,
                                                         H, D, scale);
    return static_cast<int>(cudaGetLastError());
  });
  if (code != 0) return code;
  cudaError_t err = cudaFuncSetAttribute(
      attention_dkdv_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  attention_dkdv_kernel<<<grid, kThreads, smem, s>>>(q, d, dx, st, B, L, H,
                                                     D, scale);
  return static_cast<int>(cudaGetLastError());
}
