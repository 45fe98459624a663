// The attention core of K1 and K4, forward: per (sample, head),
// softmax(q k^T * scale) v over packed qkv rows, on the tensor cores.
//
// Replaces the per-head loop inside eventpretrain_tpu/ops/
// fused_attn_layer.py::_attention_heads (:83, with _head_softmax :73). The
// kernel is a thin wrapper: it resolves the packed rows of its (sample,
// head) — q at qkv, k at qkv + C, v at qkv + 2C, row stride 3C; the head
// outputs at row stride C — and runs the one-pass forward body of
// attention_core.cuh, which K7's one-pass route (mha.cu) wraps too. That
// header says how the body works and what bounds it on this card.
#include "attention_core.cuh"

namespace {

using onepass::kRows;
using onepass::kThreads;

// KT * 16 >= Lp: the score tiles a thread holds. ptxas's default target,
// 3 blocks an SM, spills at KT = 16; one block an SM as the floor lets it
// take what it needs there.
template <int KT>
__global__ void __launch_bounds__(kThreads, KT > 13 ? 1 : 3)
    attention_fwd_kernel(const bf16* __restrict__ qkv, bf16* __restrict__ out,
                         int L, int H, int D, float scale) {
  const int h = blockIdx.y, b = blockIdx.z;
  const int C = H * D;
  const long long stride = 3LL * C;
  const bf16* head = qkv + static_cast<long long>(b) * L * stride + h * D;
  onepass::forward_block<KT>(
      {head, stride}, {head + C, stride}, {head + 2 * C, stride},
      [=] {
        return onepass::Out{out + static_cast<long long>(b) * L * H * D +
                                h * D,
                            H * D};
      },
      [] { return onepass::Stats{nullptr, 0}; }, L, D, scale);
}

}  // namespace

extern "C" long long attention_smem_bytes(int L, int D) {
  return onepass::fwd_smem_bytes(L, D);
}

// qkv (B, L, 3*H*D) bf16 packed [q | k | v] with head h at columns h*D;
// out (B, L, H*D) bf16. Requires L <= 256, D % 8 == 0, D <= 256, H*D % 128
// == 0 and 16-byte aligned pointers (the wrapper checks).
extern "C" int attention_bf16(const void* qkv, void* out, int B, int L, int H,
                              int D, float scale, void* stream) {
  if (B == 0 || L == 0) return 0;
  if (L > 256) return static_cast<int>(cudaErrorInvalidValue);
  const int smem = static_cast<int>(attention_smem_bytes(L, D));
  const bf16* x = static_cast<const bf16*>(qkv);
  bf16* o = static_cast<bf16*>(out);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return onepass::with_key_tiles(L, [&](auto kt) {
    constexpr int KT = decltype(kt)::value;
    cudaError_t err = cudaFuncSetAttribute(
        attention_fwd_kernel<KT>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        smem);
    if (err != cudaSuccess) return static_cast<int>(err);
    const dim3 grid((L + kRows - 1) / kRows, H, B);
    attention_fwd_kernel<KT><<<grid, kThreads, smem, s>>>(x, o, L, H, D,
                                                          scale);
    return static_cast<int>(cudaGetLastError());
  });
}
