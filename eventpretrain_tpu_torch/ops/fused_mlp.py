"""K2 — the pre-norm MLP sub-block ``y = x + fc2(GELU(fc1(LayerNorm(x))))``,
forward and backward.

Replaces eventpretrain_tpu/ops/fused_mlp.py::fused_ln_mlp: the forward
``_ln_fwd_kernel`` (LN in f32, fc1 bias and GELU in f32 with ``h`` rounded
to x.dtype before fc2, fc2 bias and the residual in f32, rounded once) and
both of its backward implementations, the hidden-chunked Pallas kernel for
C <= 512 (``_ln_bwd_call`` :356) and the XLA composition for C = 768
(``_xla_ln_mlp_bwd`` :416), which compute the same function. The port has
one backward for every width, with their rounding points: ``dh = dy . W2``
in f32, ``dh_pre = dh * gelu'(h_pre)`` rounded, ``db1`` summed from the
rounded values, ``d_yln = dh_pre . W1`` in f32, the LayerNorm backward in
f32 with ``dx`` rounded once, every weight and bias gradient summed in f32
over all B*L tokens and rounded to the weight dtype once.

On the TPU the (L, 4C) hidden activation never leaves VMEM. On Hopper the
CUDA forward is two launches of the hand-written GEMM (csrc/ln_gemm.cu):
fc1 with the LayerNorm prologue and the bias+GELU epilogue writes ``h`` to
device memory, fc2 with the bias+residual epilogue reads it back. That
round trip (B*L*4C bf16 written and read, 38.5 MB per layer at B=64,
C=384) is the known cost of this first version. The backward saves only
the inputs, as the TPU kernel does, and recomputes: one launch of the same
LN-prologue GEMM writes the f32 ``h_pre`` and the forward's ``h`` from one
accumulator, then the dgrad and weight-gradient layouts of the GEMM, the
gelu' epilogue, and the row kernels of csrc/ln_bwd.cu. GELU uses CUDA's
exact ``erff``; the TPU kernel approximates erf with Abramowitz-Stegun
7.1.26 (|err| < 1.5e-7, below bf16 rounding).

Weights are in the torch layout: ``w1`` (4C, C), ``w2`` (C, 4C).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from eventpretrain_tpu_torch.ops.common import (
    EPI_BIAS_GELU,
    EPI_BIAS_RESIDUAL,
    EPI_DGELU,
    EPI_F32,
    MAX_FUSED_SEQ_LEN,
    check_cuda_operands,
    colsum,
    gelu_grad,
    gemm_dgrad,
    gemm_wgrad,
    ln_backward,
    ln_backward_reference,
    ln_forward,
    ln_gemm,
    ln_rows,
    mm_f32,
)


def supports_fused_ln_mlp(seq_len: int, dim: int, hidden_dim: int,
                          dtype=None) -> bool:
    """The JAX gate (fused_mlp.py:62-74). The port's backward takes every
    width inside it (the LN backward rows hold up to C=768)."""
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
    """Plain PyTorch version of K2's forward, with the kernel's rounding
    points."""
    yln = ln_forward(x, ln_weight, ln_bias, eps)
    h_pre = mm_f32(yln, w1.t()) + b1.float()
    h = F.gelu(h_pre, approximate="none").to(x.dtype)
    y = mm_f32(h, w2.t()) + b2.float()
    return (x.float() + y).to(x.dtype)


def fused_ln_mlp_bwd_reference(x, ln_weight, ln_bias, w1, b1, w2, dy, *,
                               eps: float = 1e-6):
    """Plain PyTorch version of K2's backward, at every width: ``(dx,
    dgamma, dbeta, dw1, db1, dw2, db2)``, LN gradients f32, the rest in the
    dtypes of x and the weights."""
    dt = x.dtype
    c = x.shape[-1]
    yln = ln_forward(x, ln_weight, ln_bias, eps).reshape(-1, c)
    h_pre = mm_f32(yln, w1.t()) + b1.float()
    h = F.gelu(h_pre, approximate="none").to(dt)
    dy2 = dy.reshape(-1, c)
    dw2 = mm_f32(dy2.t(), h).to(w2.dtype)
    db2 = dy2.float().sum(0).to(w2.dtype)
    dh = mm_f32(dy2, w2)
    dh_pre = (dh * gelu_grad(h_pre)).to(dt)
    dw1 = mm_f32(dh_pre.t(), yln).to(w1.dtype)
    db1 = dh_pre.float().sum(0).to(w1.dtype)
    d_yln = mm_f32(dh_pre, w1).view(x.shape)
    dx, dg, dbeta = ln_backward_reference(x, ln_weight, eps, dy, d_yln)
    return dx, dg, dbeta, dw1, db1, dw2, db2


def _check_cuda(x, ln_weight, ln_bias, w1, b1, w2, b2):
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
    check_cuda_operands("fused_ln_mlp", torch.float32, ln_weight=ln_weight,
                        ln_bias=ln_bias)
    if ln_weight.device != x.device:
        raise ValueError("fused_ln_mlp: operands on several devices")


def _forward_cuda(x, ln_weight, ln_bias, w1, b1, w2, b2, eps):
    b, l, c = x.shape
    x2 = x.view(b * l, c)
    h = ln_gemm(x2, w1, b1, epilogue=EPI_BIAS_GELU,
                ln=(ln_weight, ln_bias, eps))
    y = ln_gemm(h, w2, b2, epilogue=EPI_BIAS_RESIDUAL, residual=x2)
    return y.view(b, l, c)


def _backward_cuda(x, ln_weight, ln_bias, w1, b1, w2, dy, eps):
    b, l, c = x.shape
    x2 = x.view(b * l, c)
    check_cuda_operands("fused_ln_mlp backward", torch.bfloat16, dy=dy)
    dy2 = dy.view(b * l, c)
    h_pre, h = ln_gemm(x2, w1, b1, epilogue=EPI_F32,
                       ln=(ln_weight, ln_bias, eps), gelu_out=True)
    dw2 = gemm_wgrad(dy2, h)
    db2 = colsum(dy2)
    dh_pre = gemm_dgrad(dy2, w2, epilogue=EPI_DGELU, aux=h_pre)
    del h_pre, h
    yln = ln_rows(x2, ln_weight, ln_bias, eps)
    dw1 = gemm_wgrad(dh_pre, yln)
    db1 = colsum(dh_pre)
    d_yln = gemm_dgrad(dh_pre, w1, epilogue=EPI_F32)
    dx, dg, dbeta = ln_backward(x2, ln_weight, eps, dy2, d_yln)
    return dx.view(b, l, c), dg, dbeta, dw1, db1, dw2, db2


class _FusedLnMlp(torch.autograd.Function):
    """K2 with its backward: the plain versions for CPU tensors, the CUDA
    kernels for CUDA tensors (never autograd of the plain forward)."""

    @staticmethod
    def forward(ctx, x, ln_weight, ln_bias, w1, b1, w2, b2, eps):
        ctx.eps = eps
        ctx.save_for_backward(x, ln_weight, ln_bias, w1, b1, w2)
        if x.device.type == "cpu":
            return fused_ln_mlp_reference(x, ln_weight, ln_bias, w1, b1, w2,
                                          b2, eps=eps)
        y = _forward_cuda(x, ln_weight, ln_bias, w1, b1, w2, b2, eps)
        fused_ln_mlp.launches += 1
        return y

    @staticmethod
    def backward(ctx, dy):
        x, ln_weight, ln_bias, w1, b1, w2 = ctx.saved_tensors
        dy = dy.contiguous()
        if x.device.type == "cpu":
            grads = fused_ln_mlp_bwd_reference(x, ln_weight, ln_bias, w1, b1,
                                               w2, dy, eps=ctx.eps)
        else:
            grads = _backward_cuda(x, ln_weight, ln_bias, w1, b1, w2, dy,
                                   ctx.eps)
            fused_ln_mlp.launches_bwd += 1
        return (*grads, None)


def fused_ln_mlp(x: torch.Tensor, ln_weight: torch.Tensor,
                 ln_bias: torch.Tensor, w1: torch.Tensor, b1: torch.Tensor,
                 w2: torch.Tensor, b2: torch.Tensor, *,
                 eps: float = 1e-6) -> torch.Tensor:
    """``x + MLP(LayerNorm(x))`` over (B, L, C) tokens, differentiable.

    CPU tensors take :func:`fused_ln_mlp_reference` and, under autograd,
    :func:`fused_ln_mlp_bwd_reference`. CUDA tensors launch the kernels or
    raise: ``x``, weights and biases bf16, LayerNorm parameters f32, all
    contiguous; shapes inside :func:`supports_fused_ln_mlp`. ``launches``
    and ``launches_bwd`` count the CUDA forward and backward calls.
    """
    if x.device.type != "cpu":
        _check_cuda(x, ln_weight, ln_bias, w1, b1, w2, b2)
    return _FusedLnMlp.apply(x, ln_weight, ln_bias, w1, b1, w2, b2,
                             float(eps))


def fused_ln_mlp_bwd(x: torch.Tensor, ln_weight: torch.Tensor,
                     ln_bias: torch.Tensor, w1: torch.Tensor,
                     b1: torch.Tensor, w2: torch.Tensor, b2: torch.Tensor,
                     dy: torch.Tensor, *, eps: float = 1e-6):
    """K2's backward alone for a given ``dy`` (the gradients of
    :func:`fused_ln_mlp_bwd_reference`); neither counter moves."""
    if x.device.type == "cpu":
        return fused_ln_mlp_bwd_reference(x, ln_weight, ln_bias, w1, b1, w2,
                                          dy, eps=eps)
    _check_cuda(x, ln_weight, ln_bias, w1, b1, w2, b2)
    return _backward_cuda(x, ln_weight, ln_bias, w1, b1, w2, dy.contiguous(),
                          eps)


fused_ln_mlp.launches = 0
fused_ln_mlp.launches_bwd = 0
