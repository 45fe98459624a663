"""K1 and K4 — the attention layer, forward and backward: K1 is the pre-norm
sub-block ``y = x + AttnLayer(LayerNorm(x))``, K4 the bare layer
``y = AttnLayer(x)`` with no LayerNorm and no residual.

K1 replaces eventpretrain_tpu/ops/fused_attn_layer.py::fused_ln_attn_layer
(forward ``_ln_fwd_kernel``, backward ``_ln_bwd_kernel`` through
``_ln_bwd_call`` :386 and the custom VJP :436-468); K4 replaces
``fused_attn_layer`` :272 (forward ``_fwd_kernel`` through ``_fwd_call``
:202, backward ``_bwd_kernel`` :183 through ``_bwd_call`` :220 and the
custom VJP :245-269). Both compute, on ``u = LN(x)`` for K1 and ``u = x``
for K4:

    q|k|v = u . Wqkv^T + bqkv                 (rounded to x.dtype)
    o_h   = softmax(q_h k_h^T * scale) v_h    (f32 softmax, p rounded, o_h rounded)
    y     = [x +] concat_h(o_h) . Wo^T + bo   (f32, rounded once)

and the backward with the Pallas kernels' rounding points: ``do = dy . Wo``
rounded; per head the softmax recomputed in f32, ``dv = bf16(p)^T . do``,
``ds = bf16(p * (dp - rowsum(dp * p)) * scale)``, ``dq = ds . k`` and
``dk = ds^T . q``, each rounded; ``du = dqkv . Wqkv`` in f32. K1 keeps
``du`` in f32 for the LayerNorm backward (f32, ``dx`` rounded once); K4
rounds it once as its ``dx`` (fused_attn_layer.py:199). Every weight and
bias gradient is summed in f32 over all B*L tokens and rounded to the
weight dtype once.

On the TPU each direction is one kernel with both weight matrices resident
in VMEM. On Hopper they do not fit in shared memory (Wqkv alone is 884 KB
at C=384, against 227 KB a block may use), so the CUDA path is a few
launches of hand-written kernels:

    forward   the GEMM for qkv (csrc/ln_gemm.cu; K1 on the LayerNorm rows
              of csrc/ln_bwd.cu), the attention core (csrc/attention.cu),
              the GEMM for the out projection (K1 with the residual
              epilogue);
    backward  dWo = dy^T . o and do = dy . Wo (GEMM, weight-gradient and
              dgrad layouts), the attention core's backward
              (csrc/attention_bwd.cu: a dq kernel, then a dk/dv kernel),
              dWqkv = dqkv^T . u and du = dqkv . Wqkv (GEMM; K4 rounds du in
              the epilogue), and for K1 the LN rows and LN backward; the bias
              sums (csrc/ln_bwd.cu).

qkv and the head outputs round-trip device memory between launches. The
CUDA forward saves them for the backward instead of recomputing them (the
same values bit for bit; 4C bf16 per token); K1's backward recomputes only
LN(x). The attention core runs every product on the tensor cores (bf16
``mma.sync``, one pass over the scores, whose whole rows fit in registers
at L <= 256); the GEMMs run on ``wgmma`` fed by TMA through a
shared-memory ring, the weight gradients split over token ranges and
summed in order, without atomics (see the sources).

Weights are in the torch layout: ``wqkv`` (3C, C), ``wo`` (C, C).
"""

from __future__ import annotations

import torch

from eventpretrain_tpu_torch import _build
from eventpretrain_tpu_torch.ops.common import (
    EPI_BIAS,
    EPI_BIAS_RESIDUAL,
    EPI_F32,
    LN_BWD_MAX_WIDTH,
    MAX_FUSED_SEQ_LEN,
    check_cuda_operands,
    colsum,
    gemm_dgrad,
    gemm_wgrad,
    ln_backward,
    ln_backward_reference,
    ln_forward,
    ln_gemm,
    ln_rows,
    mm_f32,
)

# csrc/attention.cu and attention_bwd.cu: a block is 4 warps of 16 rows
_ATTN_ROWS = 64
_ATTN_PAD = 8  # bf16 of padding per shared-memory row
MAX_BLOCK_SMEM = 232448  # bytes of shared memory a Hopper block may use


def _round16(n: int) -> int:
    return -(-n // 16) * 16


def attention_smem_bytes(seq_len: int, head_dim: int) -> int:
    """csrc/attention.cu: the block's 64 q rows and the head's k and v, L
    and D rounded up to 16, rows padded by 8 bf16."""
    rows = _ATTN_ROWS + 2 * _round16(seq_len)
    return rows * (_round16(head_dim) + _ATTN_PAD) * 2


def attention_bwd_smem_bytes(seq_len: int, head_dim: int) -> int:
    """csrc/attention_bwd.cu, the larger of its two kernels: the block's 64
    rows of two operands and the head's other two (q, do and k, v for dq;
    k, v and q, do for dk/dv), and the dk/dv kernel's row statistics (max,
    sum, dd and the sum's reciprocal)."""
    lp = _round16(seq_len)
    return (4 * (_ATTN_ROWS + lp) * (_round16(head_dim) + _ATTN_PAD)
            + 16 * lp)


def attention_bwd_scratch(b: int, seq_len: int, num_heads: int,
                          device) -> torch.Tensor:
    """The backward's (3, B, H, L) f32 scratch: each query row's score max,
    sum of exp and rowsum(dp * p), written by the dq kernel and read by the
    dk/dv kernel."""
    return torch.empty((3, b, num_heads, seq_len), dtype=torch.float32,
                       device=device)


def supports_fused_attn_layer(seq_len: int, dim: int, num_heads: int,
                              dtype=None, backward: bool = False) -> bool:
    """The JAX gate of K1 and K4 (fused_attn_layer.py:48-63), plus the
    shared-memory bound of the attention core: a block's staged tiles must
    fit, and with ``backward`` those of the backward kernels too. Every
    ViT, decoder and dense width of the repo fits both (the largest, L=196
    at head_dim 64, takes 80 KB in the backward); at L=256 the forward
    takes head_dim up to 192 and the backward up to 160."""
    if dtype is not None and torch.empty((), dtype=dtype).element_size() > 2:
        return False
    if dim % num_heads != 0:
        return False
    head_dim = dim // num_heads
    ok = (
        seq_len <= MAX_FUSED_SEQ_LEN
        and head_dim % 8 == 0
        and head_dim <= 256
        and dim % 128 == 0
        and attention_smem_bytes(seq_len, head_dim) <= MAX_BLOCK_SMEM
    )
    if ok and backward:
        ok = attention_bwd_smem_bytes(seq_len, head_dim) <= MAX_BLOCK_SMEM
    return ok


def supports_fused_ln_attn_layer(seq_len: int, dim: int, num_heads: int,
                                 dtype=None, backward: bool = False) -> bool:
    """K1's gate: :func:`supports_fused_attn_layer`, and with ``backward``
    also the width the LayerNorm backward of its backward holds
    (``ln_backward``, C <= ``LN_BWD_MAX_WIDTH``). K4's backward has no
    LayerNorm, so its gate has no such bound."""
    return (supports_fused_attn_layer(seq_len, dim, num_heads, dtype,
                                      backward)
            and (not backward or dim <= LN_BWD_MAX_WIDTH))


def _heads_softmax(qkv, b, l, num_heads, scale):
    """(b, l, 3c) packed qkv -> (q, k, v) each (b, h, l, d) and f32 p."""
    d = qkv.shape[-1] // (3 * num_heads)
    q, k, v = qkv.view(b, l, 3, num_heads, d).permute(2, 0, 3, 1, 4)
    s = mm_f32(q, k.transpose(-1, -2)) * scale
    s = s - s.amax(-1, keepdim=True)
    p = torch.exp(s)
    return q, k, v, p / p.sum(-1, keepdim=True)


def attention_core_reference(qkv, b, l, num_heads, scale):
    """Plain version of the attention core (csrc/attention.cu) on packed
    (b*l, 3c) qkv rows: the head outputs, rounded, concatenated (b*l, c)
    (``_attention_heads``, fused_attn_layer.py:83)."""
    c = qkv.shape[-1] // 3
    _, _, v, p = _heads_softmax(qkv, b, l, num_heads, scale)
    o = mm_f32(p.to(qkv.dtype), v).to(qkv.dtype)  # (b, h, l, d)
    return o.transpose(1, 2).reshape(b * l, c)


def attention_core_bwd_reference(qkv, do, b, l, num_heads, scale):
    """Plain version of the attention core's backward
    (csrc/attention_bwd.cu): ``dqkv`` (b*l, 3c) in the packing of qkv, for
    the head outputs' gradient ``do`` (b*l, c) (the head loop of
    ``_layer_bwd``, fused_attn_layer.py:142-164)."""
    dt = qkv.dtype
    c = do.shape[-1]
    q, k, v, p = _heads_softmax(qkv, b, l, num_heads, scale)
    do_h = do.view(b, l, num_heads, -1).transpose(1, 2)  # (b, h, l, d)
    dv = mm_f32(p.to(dt).transpose(-1, -2), do_h)
    dp = mm_f32(do_h, v.transpose(-1, -2))
    ds = (p * (dp - (dp * p).sum(-1, keepdim=True)) * scale).to(dt)
    dq = mm_f32(ds, k)
    dk = mm_f32(ds.transpose(-1, -2), q)
    # (3, b, h, l, d) -> (b, l, 3, h, d): the packing of qkv
    dqkv = torch.stack([dq, dk, dv]).to(dt).permute(1, 3, 0, 2, 4)
    return dqkv.reshape(b * l, 3 * c)


def _layer_reference(u, wqkv, bqkv, wo, bo, num_heads, scale):
    """The attention layer on ``u`` (b, l, c), f32 result before the
    output rounding (``_layer_fwd``, fused_attn_layer.py:103)."""
    b, l, c = u.shape
    qkv = (mm_f32(u, wqkv.t()) + bqkv.float()).to(u.dtype)
    o = attention_core_reference(qkv, b, l, num_heads, scale)
    return mm_f32(o.view(b, l, c), wo.t()) + bo.float()


def _layer_bwd_reference(u, wqkv, bqkv, wo, dy, num_heads, scale):
    """Backward of :func:`_layer_reference` (``_layer_bwd``,
    fused_attn_layer.py:115): ``(du f32, dwqkv, dbqkv, dwo, dbo)``."""
    dt = u.dtype
    b, l, c = u.shape
    qkv = (mm_f32(u, wqkv.t()) + bqkv.float()).to(dt)
    o = attention_core_reference(qkv, b, l, num_heads, scale)
    dy2 = dy.reshape(b * l, c)
    dwo = mm_f32(dy2.t(), o).to(wo.dtype)
    dbo = dy2.float().sum(0).to(wo.dtype)
    do = mm_f32(dy2, wo).to(dt)
    dqkv = attention_core_bwd_reference(qkv, do, b, l, num_heads, scale)
    dwqkv = mm_f32(dqkv.t(), u.reshape(b * l, c)).to(wqkv.dtype)
    dbqkv = dqkv.float().sum(0).to(wqkv.dtype)
    du = mm_f32(dqkv, wqkv).view(b, l, c)
    return du, dwqkv, dbqkv, dwo, dbo


def fused_ln_attn_layer_reference(x, ln_weight, ln_bias, wqkv, bqkv, wo, bo,
                                  *, num_heads: int, scale: float,
                                  eps: float = 1e-6) -> torch.Tensor:
    """Plain PyTorch version of K1's forward, with the kernel's rounding
    points."""
    yln = ln_forward(x, ln_weight, ln_bias, eps)
    y = _layer_reference(yln, wqkv, bqkv, wo, bo, num_heads, scale)
    return (x.float() + y).to(x.dtype)


def fused_ln_attn_layer_bwd_reference(x, ln_weight, ln_bias, wqkv, bqkv, wo,
                                      dy, *, num_heads: int, scale: float,
                                      eps: float = 1e-6):
    """Plain PyTorch version of K1's backward (``_ln_bwd_kernel``), with the
    kernel's rounding points: ``(dx, dgamma, dbeta, dwqkv, dbqkv, dwo,
    dbo)``, LN gradients f32, the rest in the dtypes of x and the weights.
    """
    yln = ln_forward(x, ln_weight, ln_bias, eps)
    d_yln, dwqkv, dbqkv, dwo, dbo = _layer_bwd_reference(
        yln, wqkv, bqkv, wo, dy, num_heads, scale)
    dx, dg, dbeta = ln_backward_reference(x, ln_weight, eps, dy, d_yln)
    return dx, dg, dbeta, dwqkv, dbqkv, dwo, dbo


def fused_attn_layer_reference(x, wqkv, bqkv, wo, bo, *, num_heads: int,
                               scale: float) -> torch.Tensor:
    """Plain PyTorch version of K4's forward (``_fwd_kernel``), with the
    kernel's rounding points."""
    return _layer_reference(x, wqkv, bqkv, wo, bo, num_heads,
                            scale).to(x.dtype)


def fused_attn_layer_bwd_reference(x, wqkv, bqkv, wo, dy, *, num_heads: int,
                                   scale: float):
    """Plain PyTorch version of K4's backward (``_bwd_kernel``): ``(dx,
    dwqkv, dbqkv, dwo, dbo)`` in the dtypes of x and the weights, dx
    rounded once."""
    du, *grads = _layer_bwd_reference(x, wqkv, bqkv, wo, dy, num_heads,
                                      scale)
    return (du.to(x.dtype), *grads)


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


def _attention_bwd(qkv: torch.Tensor, do: torch.Tensor, b: int, l: int,
                   num_heads: int, scale: float) -> torch.Tensor:
    c = do.shape[-1]
    dqkv = torch.empty((b * l, 3 * c), dtype=qkv.dtype, device=qkv.device)
    stats = attention_bwd_scratch(b, l, num_heads, qkv.device)
    lib = _build.load("attention_bwd")
    with torch.cuda.device(qkv.device):
        code = lib.attention_bwd_bf16(
            qkv.data_ptr(), do.data_ptr(), dqkv.data_ptr(), stats.data_ptr(),
            b, l, num_heads, c // num_heads, float(scale),
            torch.cuda.current_stream(qkv.device).cuda_stream,
        )
    _build.check(lib, "attention_bwd_bf16", code)
    return dqkv


def _check_cuda(fn, x, wqkv, bqkv, wo, bo, num_heads, backward, ln=None):
    if x.ndim != 3:
        raise ValueError(f"{fn}: x must be (B, L, C), got {tuple(x.shape)}")
    b, l, c = x.shape
    gate = (supports_fused_attn_layer if ln is None
            else supports_fused_ln_attn_layer)
    if not gate(l, c, num_heads, x.dtype, backward):
        raise ValueError(
            f"{fn}: L={l} C={c} heads={num_heads} {x.dtype} is outside the "
            "kernel's gate"
        )
    if wqkv.shape != (3 * c, c) or wo.shape != (c, c):
        raise ValueError(f"{fn}: weights must be (3C, C), (C, C)")
    check_cuda_operands(fn, torch.bfloat16, x=x, wqkv=wqkv, bqkv=bqkv, wo=wo,
                        bo=bo)
    if ln is not None:
        check_cuda_operands(fn, torch.float32, ln_weight=ln[0],
                            ln_bias=ln[1])
        if ln[0].device != x.device:
            raise ValueError(f"{fn}: operands on several devices")


def _layer_cuda(x, wqkv, bqkv, wo, bo, num_heads, scale, ln=None):
    """(y, qkv, o): the output and the two intermediates the backward
    takes. ``ln = (gamma, beta, eps)`` makes it K1 (LayerNorm rows first,
    residual epilogue), None K4."""
    b, l, c = x.shape
    x2 = x.view(b * l, c)
    qkv = ln_gemm(x2, wqkv, bqkv, epilogue=EPI_BIAS, ln=ln)
    o = _attention(qkv, b, l, num_heads, scale)
    if ln is None:
        y = ln_gemm(o, wo, bo, epilogue=EPI_BIAS)
    else:
        y = ln_gemm(o, wo, bo, epilogue=EPI_BIAS_RESIDUAL, residual=x2)
    return y.view(b, l, c), qkv, o


def _layer_bwd_cuda(u2, wqkv, wo, qkv, o, dy2, b, l, num_heads, scale,
                    du_epilogue):
    """(du, dwqkv, dbqkv, dwo, dbo) for the layer input ``u2`` (B*L, C);
    ``du`` f32 (``EPI_F32``) or rounded (``EPI_BIAS``)."""
    check_cuda_operands("attention layer backward", torch.bfloat16, dy=dy2,
                        qkv=qkv, o=o)
    dwo = gemm_wgrad(dy2, o)
    dbo = colsum(dy2)
    do = gemm_dgrad(dy2, wo)
    dqkv = _attention_bwd(qkv, do, b, l, num_heads, scale)
    dwqkv = gemm_wgrad(dqkv, u2)
    dbqkv = colsum(dqkv)
    du = gemm_dgrad(dqkv, wqkv, epilogue=du_epilogue)
    return du, dwqkv, dbqkv, dwo, dbo


def _ln_backward_cuda(x, ln_weight, ln_bias, wqkv, wo, qkv, o, dy, num_heads,
                      scale, eps):
    b, l, c = x.shape
    x2 = x.view(b * l, c)
    dy2 = dy.view(b * l, c)
    yln = ln_rows(x2, ln_weight, ln_bias, eps)
    d_yln, dwqkv, dbqkv, dwo, dbo = _layer_bwd_cuda(
        yln, wqkv, wo, qkv, o, dy2, b, l, num_heads, scale, EPI_F32)
    dx, dg, dbeta = ln_backward(x2, ln_weight, eps, dy2, d_yln)
    return dx.view(b, l, c), dg, dbeta, dwqkv, dbqkv, dwo, dbo


def _backward_cuda(x, wqkv, wo, qkv, o, dy, num_heads, scale):
    b, l, c = x.shape
    dx, *grads = _layer_bwd_cuda(x.view(b * l, c), wqkv, wo, qkv, o,
                                 dy.view(b * l, c), b, l, num_heads, scale,
                                 EPI_BIAS)
    return (dx.view(b, l, c), *grads)


class _FusedLnAttnLayer(torch.autograd.Function):
    """K1 with its backward: the plain versions for CPU tensors, the CUDA
    kernels for CUDA tensors (never autograd of the plain forward)."""

    @staticmethod
    def forward(ctx, x, ln_weight, ln_bias, wqkv, bqkv, wo, bo, num_heads,
                scale, eps):
        ctx.cfg = (num_heads, scale, eps)
        if x.device.type == "cpu":
            ctx.save_for_backward(x, ln_weight, ln_bias, wqkv, bqkv, wo)
            return fused_ln_attn_layer_reference(
                x, ln_weight, ln_bias, wqkv, bqkv, wo, bo,
                num_heads=num_heads, scale=scale, eps=eps,
            )
        y, qkv, o = _layer_cuda(x, wqkv, bqkv, wo, bo, num_heads, scale,
                                ln=(ln_weight, ln_bias, eps))
        fused_ln_attn_layer.launches += 1
        ctx.save_for_backward(x, ln_weight, ln_bias, wqkv, bqkv, wo, qkv, o)
        return y

    @staticmethod
    def backward(ctx, dy):
        num_heads, scale, eps = ctx.cfg
        dy = dy.contiguous()
        saved = ctx.saved_tensors
        x, ln_weight, ln_bias, wqkv, bqkv, wo = saved[:6]
        if x.device.type == "cpu":
            grads = fused_ln_attn_layer_bwd_reference(
                x, ln_weight, ln_bias, wqkv, bqkv, wo, dy,
                num_heads=num_heads, scale=scale, eps=eps,
            )
        else:
            qkv, o = saved[6:]
            grads = _ln_backward_cuda(x, ln_weight, ln_bias, wqkv, wo, qkv,
                                      o, dy, num_heads, scale, eps)
            fused_ln_attn_layer.launches_bwd += 1
        return (*grads, None, None, None)


def fused_ln_attn_layer(x: torch.Tensor, ln_weight: torch.Tensor,
                        ln_bias: torch.Tensor, wqkv: torch.Tensor,
                        bqkv: torch.Tensor, wo: torch.Tensor,
                        bo: torch.Tensor, *, num_heads: int, scale: float,
                        eps: float = 1e-6) -> torch.Tensor:
    """``x + AttnLayer(LayerNorm(x))`` over (B, L, C) tokens, differentiable.

    CPU tensors take :func:`fused_ln_attn_layer_reference` and, under
    autograd, :func:`fused_ln_attn_layer_bwd_reference`. CUDA tensors launch
    the kernels or raise: ``x``, weights and biases bf16, LayerNorm
    parameters f32, all contiguous; shapes inside
    :func:`supports_fused_ln_attn_layer` (with the backward's bounds when
    gradients are on). ``launches`` and ``launches_bwd`` count the CUDA
    forward and backward calls.
    """
    if x.device.type != "cpu":
        _check_cuda("fused_ln_attn_layer", x, wqkv, bqkv, wo, bo, num_heads,
                    torch.is_grad_enabled(), ln=(ln_weight, ln_bias))
    return _FusedLnAttnLayer.apply(x, ln_weight, ln_bias, wqkv, bqkv, wo, bo,
                                   int(num_heads), float(scale), float(eps))


def fused_ln_attn_layer_bwd(x: torch.Tensor, ln_weight: torch.Tensor,
                            ln_bias: torch.Tensor, wqkv: torch.Tensor,
                            bqkv: torch.Tensor, wo: torch.Tensor,
                            bo: torch.Tensor, dy: torch.Tensor, *,
                            num_heads: int, scale: float, eps: float = 1e-6):
    """K1's backward alone for a given ``dy`` (the gradients of
    :func:`fused_ln_attn_layer_bwd_reference`). On CUDA it runs the forward
    kernels for qkv and o, then the backward kernels; neither counter
    moves."""
    if x.device.type == "cpu":
        return fused_ln_attn_layer_bwd_reference(
            x, ln_weight, ln_bias, wqkv, bqkv, wo, dy,
            num_heads=num_heads, scale=scale, eps=eps,
        )
    _check_cuda("fused_ln_attn_layer", x, wqkv, bqkv, wo, bo, num_heads,
                True, ln=(ln_weight, ln_bias))
    _, qkv, o = _layer_cuda(x, wqkv, bqkv, wo, bo, num_heads, scale,
                            ln=(ln_weight, ln_bias, eps))
    return _ln_backward_cuda(x, ln_weight, ln_bias, wqkv, wo, qkv, o,
                             dy.contiguous(), num_heads, scale, eps)


class _FusedAttnLayer(torch.autograd.Function):
    """K4 with its backward: the plain versions for CPU tensors, the CUDA
    kernels for CUDA tensors (never autograd of the plain forward)."""

    @staticmethod
    def forward(ctx, x, wqkv, bqkv, wo, bo, num_heads, scale):
        ctx.cfg = (num_heads, scale)
        if x.device.type == "cpu":
            ctx.save_for_backward(x, wqkv, bqkv, wo)
            return fused_attn_layer_reference(x, wqkv, bqkv, wo, bo,
                                              num_heads=num_heads,
                                              scale=scale)
        y, qkv, o = _layer_cuda(x, wqkv, bqkv, wo, bo, num_heads, scale)
        fused_attn_layer.launches += 1
        ctx.save_for_backward(x, wqkv, bqkv, wo, qkv, o)
        return y

    @staticmethod
    def backward(ctx, dy):
        num_heads, scale = ctx.cfg
        dy = dy.contiguous()
        saved = ctx.saved_tensors
        x, wqkv, bqkv, wo = saved[:4]
        if x.device.type == "cpu":
            grads = fused_attn_layer_bwd_reference(
                x, wqkv, bqkv, wo, dy, num_heads=num_heads, scale=scale)
        else:
            qkv, o = saved[4:]
            grads = _backward_cuda(x, wqkv, wo, qkv, o, dy, num_heads, scale)
            fused_attn_layer.launches_bwd += 1
        return (*grads, None, None)


def fused_attn_layer(x: torch.Tensor, wqkv: torch.Tensor, bqkv: torch.Tensor,
                     wo: torch.Tensor, bo: torch.Tensor, *, num_heads: int,
                     scale: float) -> torch.Tensor:
    """``AttnLayer(x)`` (qkv projection, multi-head attention, out
    projection) over (B, L, C) tokens, differentiable.

    CPU tensors take :func:`fused_attn_layer_reference` and, under
    autograd, :func:`fused_attn_layer_bwd_reference`. CUDA tensors launch
    the kernels or raise: every operand bf16 and contiguous, shapes inside
    :func:`supports_fused_attn_layer` (with the backward's bound when
    gradients are on). ``launches`` and ``launches_bwd`` count the CUDA
    forward and backward calls.
    """
    if x.device.type != "cpu":
        _check_cuda("fused_attn_layer", x, wqkv, bqkv, wo, bo, num_heads,
                    torch.is_grad_enabled())
    return _FusedAttnLayer.apply(x, wqkv, bqkv, wo, bo, int(num_heads),
                                 float(scale))


def fused_attn_layer_bwd(x: torch.Tensor, wqkv: torch.Tensor,
                         bqkv: torch.Tensor, wo: torch.Tensor,
                         bo: torch.Tensor, dy: torch.Tensor, *,
                         num_heads: int, scale: float):
    """K4's backward alone for a given ``dy`` (the gradients of
    :func:`fused_attn_layer_bwd_reference`). On CUDA it runs the forward
    kernels for qkv and o, then the backward kernels; neither counter
    moves."""
    if x.device.type == "cpu":
        return fused_attn_layer_bwd_reference(x, wqkv, bqkv, wo, dy,
                                              num_heads=num_heads,
                                              scale=scale)
    _check_cuda("fused_attn_layer", x, wqkv, bqkv, wo, bo, num_heads, True)
    _, qkv, o = _layer_cuda(x, wqkv, bqkv, wo, bo, num_heads, scale)
    return _backward_cuda(x, wqkv, wo, qkv, o, dy.contiguous(), num_heads,
                          scale)


fused_ln_attn_layer.launches = 0
fused_ln_attn_layer.launches_bwd = 0
fused_attn_layer.launches = 0
fused_attn_layer.launches_bwd = 0
