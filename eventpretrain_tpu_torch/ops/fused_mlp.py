"""K2 — the pre-norm MLP sub-block ``y = x + fc2(GELU(fc1(LayerNorm(x))))``.

Replaces eventpretrain_tpu/ops/fused_mlp.py::fused_ln_mlp (forward,
``_ln_fwd_kernel``): LN in f32, fc1 bias and GELU in f32 with ``h`` rounded
to x.dtype before fc2, fc2 bias and the residual in f32, rounded once.

On the TPU the (L, 4C) hidden activation never leaves VMEM. On Hopper the
CUDA path is two launches of the hand-written GEMM (csrc/ln_gemm.cu): fc1
with the LayerNorm prologue and the bias+GELU epilogue writes ``h`` to
device memory, fc2 with the bias+residual epilogue reads it back. That
round trip (B*L*4C bf16 written and read, 38.5 MB per layer at B=64, C=384)
is the known cost of this first version; keeping ``h`` on chip is later
work. GELU uses CUDA's exact ``erff``; the TPU kernel approximates erf with
Abramowitz-Stegun 7.1.26 (|err| < 1.5e-7, below bf16 rounding).

Weights are in the torch layout: ``w1`` (4C, C), ``w2`` (C, 4C). The
backward (``_ln_bwd_kernel`` and ``_xla_ln_mlp_bwd``) is not ported yet.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from eventpretrain_tpu_torch.ops.common import (
    EPI_BIAS_GELU,
    EPI_BIAS_RESIDUAL,
    MAX_FUSED_SEQ_LEN,
    check_cuda_operands,
    ln_forward,
    ln_gemm,
    mm_f32,
)


def supports_fused_ln_mlp(seq_len: int, dim: int, hidden_dim: int,
                          dtype=None) -> bool:
    """The JAX gate (fused_mlp.py:62-74)."""
    return (
        (dtype is None or torch.empty((), dtype=dtype).element_size() <= 2)
        and seq_len <= MAX_FUSED_SEQ_LEN
        and dim <= 768
        and dim % 128 == 0
        and hidden_dim % 256 == 0
        and hidden_dim == 4 * dim
    )


def fused_ln_mlp_reference(x, ln_weight, ln_bias, w1, b1, w2, b2, *,
                           eps: float = 1e-6) -> torch.Tensor:
    """Plain PyTorch version of K2, with the kernel's rounding points."""
    yln = ln_forward(x, ln_weight, ln_bias, eps)
    h_pre = mm_f32(yln, w1.t()) + b1.float()
    h = F.gelu(h_pre, approximate="none").to(x.dtype)
    y = mm_f32(h, w2.t()) + b2.float()
    return (x.float() + y).to(x.dtype)


def fused_ln_mlp(x: torch.Tensor, ln_weight: torch.Tensor,
                 ln_bias: torch.Tensor, w1: torch.Tensor, b1: torch.Tensor,
                 w2: torch.Tensor, b2: torch.Tensor, *,
                 eps: float = 1e-6) -> torch.Tensor:
    """``x + MLP(LayerNorm(x))`` over (B, L, C) tokens.

    CPU tensors take :func:`fused_ln_mlp_reference`. CUDA tensors launch
    the kernels or raise: ``x``, weights and biases bf16, LayerNorm
    parameters f32, all contiguous; shapes inside
    :func:`supports_fused_ln_mlp`.
    """
    if x.device.type == "cpu":
        return fused_ln_mlp_reference(x, ln_weight, ln_bias, w1, b1, w2, b2,
                                      eps=eps)
    if x.ndim != 3:
        raise ValueError(f"fused_ln_mlp: x must be (B, L, C), "
                         f"got {tuple(x.shape)}")
    b, l, c = x.shape
    hidden = w1.shape[0]
    if not supports_fused_ln_mlp(l, c, hidden, x.dtype):
        raise ValueError(
            f"fused_ln_mlp: L={l} C={c} hidden={hidden} {x.dtype} is outside "
            "the kernel's gate"
        )
    if w1.shape != (hidden, c) or w2.shape != (c, hidden):
        raise ValueError("fused_ln_mlp: weights must be (4C, C), (C, 4C)")
    check_cuda_operands("fused_ln_mlp", torch.bfloat16, x=x, w1=w1, b1=b1,
                        w2=w2, b2=b2)
    x2 = x.view(b * l, c)
    h = ln_gemm(x2, w1, b1, epilogue=EPI_BIAS_GELU,
                ln=(ln_weight, ln_bias, eps))
    y = ln_gemm(h, w2, b2, epilogue=EPI_BIAS_RESIDUAL, residual=x2)
    fused_ln_mlp.launches += 1
    return y.view(b, l, c)


fused_ln_mlp.launches = 0
