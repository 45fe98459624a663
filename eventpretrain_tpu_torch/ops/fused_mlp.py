"""K2 and K5 — the transformer MLP, forward and backward: K2 is the
pre-norm sub-block ``y = x + fc2(GELU(fc1(LayerNorm(x))))``, K5 the bare
``y = fc2(GELU(fc1(x)))`` with no LayerNorm and no residual.

K2 replaces eventpretrain_tpu/ops/fused_mlp.py::fused_ln_mlp: the forward
``_ln_fwd_kernel`` and both of its backward implementations, the
hidden-chunked Pallas kernel for C <= 512 (``_ln_bwd_call`` :356) and the
XLA composition for C = 768 (``_xla_ln_mlp_bwd`` :416), which compute the
same function. K5 replaces ``fused_mlp`` :231 (forward ``_fwd_kernel``
:106 through ``_fwd_call`` :152, backward ``_bwd_kernel`` :116 through
``_bwd_call`` :173 and the custom VJP :207-228). Both compute, on
``u = LN(x)`` (f32 statistics, rounded) for K2 and ``u = x`` for K5:
``h_pre = u . W1^T + b1`` in f32, ``h = GELU(h_pre)`` rounded to x.dtype,
``y = [x +] h . W2^T + b2`` in f32, rounded once. The backward has their
rounding points: ``dh = dy . W2`` in f32, ``dh_pre = dh * gelu'(h_pre)``
rounded, ``db1`` summed from the rounded values, ``du = dh_pre . W1`` in
f32; K2 keeps ``du`` in f32 for the LayerNorm backward (f32, ``dx`` rounded
once), K5 rounds it once as its ``dx``. Every weight and bias gradient is
summed in f32 over all B*L tokens and rounded to the weight dtype once.

On the TPU the (L, 4C) hidden activation never leaves VMEM. On Hopper the
CUDA forward is launches of the hand-written tensor-core GEMM
(csrc/ln_gemm.cu: TMA into a shared-memory ring, ``wgmma``): for K2 the
LayerNorm rows first (csrc/ln_bwd.cu ``ln_rows``), then fc1 with the
bias+GELU epilogue writes ``h`` to device memory, fc2 (K2 with the
bias+residual epilogue, K5 with the bias epilogue) reads it back. That
round trip (B*L*4C bf16 written and read, 38.5 MB per layer at B=64,
C=384) is the known cost of this design. The backward saves only the
inputs, as the TPU kernels do, and recomputes: one launch of the same GEMM
on the LayerNorm rows writes the f32 ``h_pre`` and the forward's ``h`` from
one accumulator, then the dgrad and weight-gradient layouts of the GEMM
(the weight gradients split over token ranges and summed in order), the
gelu' epilogue, the column sums and, for K2, the row kernels of
csrc/ln_bwd.cu. GELU uses CUDA's exact ``erff``; the TPU
kernels approximate erf with Abramowitz-Stegun 7.1.26 (|err| < 1.5e-7,
below bf16 rounding).

Weights are in the torch layout: ``w1`` (4C, C), ``w2`` (C, 4C).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from eventpretrain_tpu_torch.ops.common import (
    EPI_BIAS,
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


# Widest C of K5 (fused_mlp.py:41): the TPU kernel's f32 weight-gradient
# accumulators must fit VMEM. The port keeps the JAX gate.
MAX_FUSED_MLP_WIDTH = 512


def _two_bytes(dtype) -> bool:
    return dtype is None or torch.empty((), dtype=dtype).element_size() <= 2


def supports_fused_mlp(seq_len: int, dim: int, hidden_dim: int,
                       dtype=None) -> bool:
    """The JAX gate of K5 (fused_mlp.py:50-59)."""
    return (
        _two_bytes(dtype)
        and seq_len <= MAX_FUSED_SEQ_LEN
        and dim <= MAX_FUSED_MLP_WIDTH
        and dim % 128 == 0
        and hidden_dim % 128 == 0
        and hidden_dim == 4 * dim
    )


def supports_fused_ln_mlp(seq_len: int, dim: int, hidden_dim: int,
                          dtype=None) -> bool:
    """The JAX gate of K2 (fused_mlp.py:62-74). The port's backward takes
    every width inside it (the LN backward rows hold up to C=768)."""
    return (
        _two_bytes(dtype)
        and seq_len <= MAX_FUSED_SEQ_LEN
        and dim <= 768
        and dim % 128 == 0
        and hidden_dim % 256 == 0
        and hidden_dim == 4 * dim
    )


def _mlp_reference(u, w1, b1, w2, b2):
    """fc2(GELU(fc1(u))) in f32 before the output rounding, ``h`` rounded
    to u.dtype (``_fwd_kernel``, fused_mlp.py:106)."""
    h_pre = mm_f32(u, w1.t()) + b1.float()
    h = F.gelu(h_pre, approximate="none").to(u.dtype)
    return mm_f32(h, w2.t()) + b2.float()


def _mlp_bwd_reference(u, w1, b1, w2, dy):
    """Backward of :func:`_mlp_reference` (``_bwd_kernel``, fused_mlp.py
    :116): ``(du f32, dw1, db1, dw2, db2)``."""
    dt = u.dtype
    c = u.shape[-1]
    u2 = u.reshape(-1, c)
    h_pre = mm_f32(u2, w1.t()) + b1.float()
    h = F.gelu(h_pre, approximate="none").to(dt)
    dy2 = dy.reshape(-1, c)
    dw2 = mm_f32(dy2.t(), h).to(w2.dtype)
    db2 = dy2.float().sum(0).to(w2.dtype)
    dh = mm_f32(dy2, w2)
    dh_pre = (dh * gelu_grad(h_pre)).to(dt)
    dw1 = mm_f32(dh_pre.t(), u2).to(w1.dtype)
    db1 = dh_pre.float().sum(0).to(w1.dtype)
    du = mm_f32(dh_pre, w1).view(u.shape)
    return du, dw1, db1, dw2, db2


def fused_ln_mlp_reference(x, ln_weight, ln_bias, w1, b1, w2, b2, *,
                           eps: float = 1e-6) -> torch.Tensor:
    """Plain PyTorch version of K2's forward, with the kernel's rounding
    points."""
    yln = ln_forward(x, ln_weight, ln_bias, eps)
    return (x.float() + _mlp_reference(yln, w1, b1, w2, b2)).to(x.dtype)


def fused_ln_mlp_bwd_reference(x, ln_weight, ln_bias, w1, b1, w2, dy, *,
                               eps: float = 1e-6):
    """Plain PyTorch version of K2's backward, at every width: ``(dx,
    dgamma, dbeta, dw1, db1, dw2, db2)``, LN gradients f32, the rest in the
    dtypes of x and the weights."""
    yln = ln_forward(x, ln_weight, ln_bias, eps)
    d_yln, dw1, db1, dw2, db2 = _mlp_bwd_reference(yln, w1, b1, w2, dy)
    dx, dg, dbeta = ln_backward_reference(x, ln_weight, eps, dy, d_yln)
    return dx, dg, dbeta, dw1, db1, dw2, db2


def fused_mlp_reference(x, w1, b1, w2, b2) -> torch.Tensor:
    """Plain PyTorch version of K5's forward, with the kernel's rounding
    points."""
    return _mlp_reference(x, w1, b1, w2, b2).to(x.dtype)


def fused_mlp_bwd_reference(x, w1, b1, w2, dy):
    """Plain PyTorch version of K5's backward: ``(dx, dw1, db1, dw2,
    db2)`` in the dtypes of x and the weights, dx rounded once."""
    du, *grads = _mlp_bwd_reference(x, w1, b1, w2, dy)
    return (du.to(x.dtype), *grads)


def _check_cuda(fn, gate, x, w1, b1, w2, b2, ln=None):
    if x.ndim != 3:
        raise ValueError(f"{fn}: x must be (B, L, C), got {tuple(x.shape)}")
    b, l, c = x.shape
    hidden = w1.shape[0]
    if not gate(l, c, hidden, x.dtype):
        raise ValueError(
            f"{fn}: L={l} C={c} hidden={hidden} {x.dtype} is outside the "
            "kernel's gate"
        )
    if w1.shape != (hidden, c) or w2.shape != (c, hidden):
        raise ValueError(f"{fn}: weights must be (4C, C), (C, 4C)")
    check_cuda_operands(fn, torch.bfloat16, x=x, w1=w1, b1=b1, w2=w2, b2=b2)
    if ln is not None:
        check_cuda_operands(fn, torch.float32, ln_weight=ln[0],
                            ln_bias=ln[1])
        if ln[0].device != x.device:
            raise ValueError(f"{fn}: operands on several devices")


def _mlp_cuda(x, w1, b1, w2, b2, ln=None):
    """``ln = (gamma, beta, eps)`` makes it K2 (LayerNorm rows first,
    residual epilogue), None K5."""
    b, l, c = x.shape
    x2 = x.view(b * l, c)
    h = ln_gemm(x2, w1, b1, epilogue=EPI_BIAS_GELU, ln=ln)
    if ln is None:
        y = ln_gemm(h, w2, b2, epilogue=EPI_BIAS)
    else:
        y = ln_gemm(h, w2, b2, epilogue=EPI_BIAS_RESIDUAL, residual=x2)
    return y.view(b, l, c)


def _mlp_bwd_cuda(u2, w1, b1, w2, dy2, du_epilogue):
    """(du, dw1, db1, dw2, db2) for the fc1 input rows ``u2`` (LN(x) for
    K2, x for K5); ``du`` f32 (``EPI_F32``) or rounded (``EPI_BIAS``)."""
    check_cuda_operands("mlp backward", torch.bfloat16, dy=dy2)
    h_pre, h = ln_gemm(u2, w1, b1, epilogue=EPI_F32, gelu_out=True)
    dw2 = gemm_wgrad(dy2, h)
    db2 = colsum(dy2)
    dh_pre = gemm_dgrad(dy2, w2, epilogue=EPI_DGELU, aux=h_pre)
    del h_pre, h
    dw1 = gemm_wgrad(dh_pre, u2)
    db1 = colsum(dh_pre)
    du = gemm_dgrad(dh_pre, w1, epilogue=du_epilogue)
    return du, dw1, db1, dw2, db2


def _ln_backward_cuda(x, ln_weight, ln_bias, w1, b1, w2, dy, eps):
    b, l, c = x.shape
    x2 = x.view(b * l, c)
    dy2 = dy.view(b * l, c)
    yln = ln_rows(x2, ln_weight, ln_bias, eps)
    d_yln, dw1, db1, dw2, db2 = _mlp_bwd_cuda(yln, w1, b1, w2, dy2, EPI_F32)
    dx, dg, dbeta = ln_backward(x2, ln_weight, eps, dy2, d_yln)
    return dx.view(b, l, c), dg, dbeta, dw1, db1, dw2, db2


def _backward_cuda(x, w1, b1, w2, dy):
    b, l, c = x.shape
    x2 = x.view(b * l, c)
    dx, *grads = _mlp_bwd_cuda(x2, w1, b1, w2, dy.view(b * l, c), EPI_BIAS)
    return (dx.view(b, l, c), *grads)


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
        y = _mlp_cuda(x, w1, b1, w2, b2, ln=(ln_weight, ln_bias, eps))
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
            grads = _ln_backward_cuda(x, ln_weight, ln_bias, w1, b1, w2, dy,
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
        _check_cuda("fused_ln_mlp", supports_fused_ln_mlp, x, w1, b1, w2, b2,
                    ln=(ln_weight, ln_bias))
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
    _check_cuda("fused_ln_mlp", supports_fused_ln_mlp, x, w1, b1, w2, b2,
                ln=(ln_weight, ln_bias))
    return _ln_backward_cuda(x, ln_weight, ln_bias, w1, b1, w2,
                             dy.contiguous(), eps)


class _FusedMlp(torch.autograd.Function):
    """K5 with its backward: the plain versions for CPU tensors, the CUDA
    kernels for CUDA tensors (never autograd of the plain forward)."""

    @staticmethod
    def forward(ctx, x, w1, b1, w2, b2):
        ctx.save_for_backward(x, w1, b1, w2)
        if x.device.type == "cpu":
            return fused_mlp_reference(x, w1, b1, w2, b2)
        y = _mlp_cuda(x, w1, b1, w2, b2)
        fused_mlp.launches += 1
        return y

    @staticmethod
    def backward(ctx, dy):
        x, w1, b1, w2 = ctx.saved_tensors
        dy = dy.contiguous()
        if x.device.type == "cpu":
            return fused_mlp_bwd_reference(x, w1, b1, w2, dy)
        grads = _backward_cuda(x, w1, b1, w2, dy)
        fused_mlp.launches_bwd += 1
        return grads


def fused_mlp(x: torch.Tensor, w1: torch.Tensor, b1: torch.Tensor,
              w2: torch.Tensor, b2: torch.Tensor) -> torch.Tensor:
    """``fc2(GELU(fc1(x)))`` over (B, L, C) tokens, differentiable.

    CPU tensors take :func:`fused_mlp_reference` and, under autograd,
    :func:`fused_mlp_bwd_reference`. CUDA tensors launch the kernels or
    raise: every operand bf16 and contiguous, shapes inside
    :func:`supports_fused_mlp`. ``launches`` and ``launches_bwd`` count the
    CUDA forward and backward calls.
    """
    if x.device.type != "cpu":
        _check_cuda("fused_mlp", supports_fused_mlp, x, w1, b1, w2, b2)
    return _FusedMlp.apply(x, w1, b1, w2, b2)


def fused_mlp_bwd(x: torch.Tensor, w1: torch.Tensor, b1: torch.Tensor,
                  w2: torch.Tensor, b2: torch.Tensor, dy: torch.Tensor):
    """K5's backward alone for a given ``dy`` (the gradients of
    :func:`fused_mlp_bwd_reference`); neither counter moves."""
    if x.device.type == "cpu":
        return fused_mlp_bwd_reference(x, w1, b1, w2, dy)
    _check_cuda("fused_mlp", supports_fused_mlp, x, w1, b1, w2, b2)
    return _backward_cuda(x, w1, b1, w2, dy.contiguous())


fused_ln_mlp.launches = 0
fused_ln_mlp.launches_bwd = 0
fused_mlp.launches = 0
fused_mlp.launches_bwd = 0
