"""K1 — the pre-norm attention sub-block ``y = x + AttnLayer(LayerNorm(x))``.

Replaces eventpretrain_tpu/ops/fused_attn_layer.py::fused_ln_attn_layer
(forward, ``_ln_fwd_kernel``):

    q|k|v = LN(x) . Wqkv^T + bqkv            (rounded to x.dtype)
    o_h   = softmax(q_h k_h^T * scale) v_h    (f32 softmax, p rounded, o_h rounded)
    y     = x + concat_h(o_h) . Wo^T + bo     (f32, rounded once)

On the TPU this is one kernel with both weight matrices resident in VMEM.
On Hopper they do not fit in shared memory (Wqkv alone is 884 KB at C=384,
against 227 KB a block may use), so the CUDA path is three launches of two
hand-written kernels: the LN-prologue GEMM (csrc/ln_gemm.cu) for qkv, the
per-(sample, head) attention kernel (csrc/attention.cu), and the GEMM with
the residual epilogue for the out projection. qkv and the head outputs
round-trip device memory between them (3C + C bf16 per token); keeping them
on chip is later work. The attention kernel is bound by CUDA-core FMA
issue, the GEMMs by a simple WMMA loop (see the sources).

Weights are in the torch layout: ``wqkv`` (3C, C), ``wo`` (C, C).
The backward (``_ln_bwd_kernel``) is not ported yet.
"""

from __future__ import annotations

import torch

from eventpretrain_tpu_torch import _build
from eventpretrain_tpu_torch.ops.common import (
    EPI_BIAS,
    EPI_BIAS_RESIDUAL,
    MAX_FUSED_SEQ_LEN,
    check_cuda_operands,
    ln_forward,
    ln_gemm,
    mm_f32,
)

# csrc/attention.cu: 8 warps, shared memory 3*L*D*2 + 8*L*4 bytes
_ATTN_WARPS = 8
MAX_BLOCK_SMEM = 232448  # bytes of shared memory a Hopper block may use


def attention_smem_bytes(seq_len: int, head_dim: int) -> int:
    return 3 * seq_len * head_dim * 2 + _ATTN_WARPS * seq_len * 4


def supports_fused_attn_layer(seq_len: int, dim: int, num_heads: int,
                              dtype=None) -> bool:
    """The JAX gate (fused_attn_layer.py:48-63), plus the attention
    kernel's shared-memory bound: q, k and v of one head must fit a block
    (every ViT and decoder width of the repo does; head_dim 256 at long
    sequences does not)."""
    if dtype is not None and torch.empty((), dtype=dtype).element_size() > 2:
        return False
    if dim % num_heads != 0:
        return False
    head_dim = dim // num_heads
    return (
        seq_len <= MAX_FUSED_SEQ_LEN
        and head_dim % 8 == 0
        and head_dim <= 256
        and dim % 128 == 0
        and attention_smem_bytes(seq_len, head_dim) <= MAX_BLOCK_SMEM
    )


def fused_ln_attn_layer_reference(x, ln_weight, ln_bias, wqkv, bqkv, wo, bo,
                                  *, num_heads: int, scale: float,
                                  eps: float = 1e-6) -> torch.Tensor:
    """Plain PyTorch version of K1, with the kernel's rounding points."""
    b, l, c = x.shape
    d = c // num_heads
    yln = ln_forward(x, ln_weight, ln_bias, eps)
    qkv = (mm_f32(yln, wqkv.t()) + bqkv.float()).to(x.dtype)
    q, k, v = qkv.view(b, l, 3, num_heads, d).permute(2, 0, 3, 1, 4)
    s = mm_f32(q, k.transpose(-1, -2)) * scale
    s = s - s.amax(-1, keepdim=True)
    p = torch.exp(s)
    p = p / p.sum(-1, keepdim=True)
    o = mm_f32(p.to(x.dtype), v).to(x.dtype)  # (b, h, l, d)
    o = o.transpose(1, 2).reshape(b, l, c)
    y = mm_f32(o, wo.t()) + bo.float()
    return (x.float() + y).to(x.dtype)


def _attention(qkv: torch.Tensor, b: int, l: int, num_heads: int,
               scale: float) -> torch.Tensor:
    c = qkv.shape[-1] // 3
    out = torch.empty((b * l, c), dtype=qkv.dtype, device=qkv.device)
    lib = _build.load("attention")
    with torch.cuda.device(qkv.device):
        code = lib.attention_bf16(
            qkv.data_ptr(), out.data_ptr(), b, l, num_heads, c // num_heads,
            float(scale), torch.cuda.current_stream(qkv.device).cuda_stream,
        )
    _build.check(lib, "attention_bf16", code)
    return out


def fused_ln_attn_layer(x: torch.Tensor, ln_weight: torch.Tensor,
                        ln_bias: torch.Tensor, wqkv: torch.Tensor,
                        bqkv: torch.Tensor, wo: torch.Tensor,
                        bo: torch.Tensor, *, num_heads: int, scale: float,
                        eps: float = 1e-6) -> torch.Tensor:
    """``x + AttnLayer(LayerNorm(x))`` over (B, L, C) tokens.

    CPU tensors take :func:`fused_ln_attn_layer_reference`. CUDA tensors
    launch the kernels or raise: ``x``, weights and biases bf16, LayerNorm
    parameters f32, all contiguous; shapes inside
    :func:`supports_fused_attn_layer`.
    """
    if x.device.type == "cpu":
        return fused_ln_attn_layer_reference(
            x, ln_weight, ln_bias, wqkv, bqkv, wo, bo,
            num_heads=num_heads, scale=scale, eps=eps,
        )
    if x.ndim != 3:
        raise ValueError(f"fused_ln_attn_layer: x must be (B, L, C), "
                         f"got {tuple(x.shape)}")
    b, l, c = x.shape
    if not supports_fused_attn_layer(l, c, num_heads, x.dtype):
        raise ValueError(
            f"fused_ln_attn_layer: L={l} C={c} heads={num_heads} "
            f"{x.dtype} is outside the kernel's gate"
        )
    if wqkv.shape != (3 * c, c) or wo.shape != (c, c):
        raise ValueError("fused_ln_attn_layer: weights must be (3C, C), (C, C)")
    check_cuda_operands("fused_ln_attn_layer", torch.bfloat16, x=x,
                        wqkv=wqkv, bqkv=bqkv, wo=wo, bo=bo)
    x2 = x.view(b * l, c)
    qkv = ln_gemm(x2, wqkv, bqkv, epilogue=EPI_BIAS,
                  ln=(ln_weight, ln_bias, eps))
    o = _attention(qkv, b, l, num_heads, scale)
    y = ln_gemm(o, wo, bo, epilogue=EPI_BIAS_RESIDUAL, residual=x2)
    fused_ln_attn_layer.launches += 1
    return y.view(b, l, c)


fused_ln_attn_layer.launches = 0
