"""K7 — fused multi-head attention ``softmax(q kᵀ · scale) v`` over
(B, L, H, D) operands, forward and backward.

Counterpart of eventpretrain_tpu/ops/pallas_attention.py: ``fused_mha``
(:140), forward ``_fwd_kernel`` (:40) and backward ``_bwd_kernel`` (:54)
through the custom VJP (:119-133), with the gate ``supports_fused_mha``
(:136). No mask, bias or dropout. Both directions keep the Pallas kernels'
rounding points:

    s  = q . kᵀ (f32 accumulation) * scale             (f32)
    p  = exp(s - rowmax(s)) / rowsum(exp(s - rowmax))   (f32)
    o  = bf16(p) . v (f32 accumulation), rounded to the input dtype
    dv = bf16(p)ᵀ . do;  dp = do . vᵀ (f32)
    ds = p * (dp - rowsum(dp * p)) * scale, rounded to the input dtype
    dq = ds . k;  dk = dsᵀ . q   (f32 accumulation, each rounded once)

``bf16(p)`` is p rounded to the input dtype (a no-op in f32).

CPU tensors take the plain versions, forward and backward. CUDA tensors
launch the kernels of csrc/mha.cu or raise: bf16 only, inside the gate.
The kernels read q, k, v (and the incoming gradient) through their strides,
so the slices of a packed qkv projection go in without a copy; outputs are
contiguous. The CUDA forward saves each row's max and sum of exp, (2, B, H,
L) f32, for its backward (the Pallas VJP saves only q, k and v and
recomputes them; the same code computes the same values).
"""

from __future__ import annotations

import torch

from eventpretrain_tpu_torch import _build
from eventpretrain_tpu_torch.ops.common import mm_f32

# Longest sequence the kernel takes (pallas_attention.py:37).
MAX_FUSED_SEQ_LEN = 1024


def supports_fused_mha(seq_len: int, head_dim: int) -> bool:
    """The JAX gate (pallas_attention.py:136): L <= 1024 and D <= 256. The
    CUDA kernels take every shape inside it."""
    return seq_len <= MAX_FUSED_SEQ_LEN and head_dim <= 256


def _heads(*ts):
    """(B, L, H, D) -> (B, H, L, D) views."""
    return tuple(t.transpose(1, 2) for t in ts)


def _probs(q, k, scale):
    """f32 softmax of the scaled scores, (B, H, L, L)."""
    s = mm_f32(q, k.transpose(-1, -2)) * scale
    s = s - s.amax(-1, keepdim=True)
    p = torch.exp(s)
    return p / p.sum(-1, keepdim=True)


def fused_mha_reference(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                        scale: float) -> torch.Tensor:
    """Plain PyTorch version of K7's forward (``_fwd_kernel``), (B, L, H, D)
    in and out, with the kernel's rounding points."""
    qt, kt, vt = _heads(q, k, v)
    p = _probs(qt, kt, scale)
    return mm_f32(p.to(q.dtype), vt).to(q.dtype).transpose(1, 2)


def fused_mha_bwd_reference(q: torch.Tensor, k: torch.Tensor,
                            v: torch.Tensor, do: torch.Tensor, *,
                            scale: float):
    """Plain PyTorch version of K7's backward (``_bwd_kernel``): ``(dq, dk,
    dv)``, (B, L, H, D) in the input dtype."""
    dt = q.dtype
    qt, kt, vt, dot = _heads(q, k, v, do)
    p = _probs(qt, kt, scale)
    dv = mm_f32(p.to(dt).transpose(-1, -2), dot)
    dp = mm_f32(dot, vt.transpose(-1, -2))
    ds = (p * (dp - (dp * p).sum(-1, keepdim=True)) * scale).to(dt)
    dq = mm_f32(ds, kt)
    dk = mm_f32(ds.transpose(-1, -2), qt)
    return tuple(g.to(dt).transpose(1, 2) for g in (dq, dk, dv))


def _check_cuda(fn: str, **tensors) -> tuple[int, int, int, int]:
    shape, devices = None, set()
    for name, t in tensors.items():
        if t.device.type != "cuda":
            raise ValueError(f"{fn}: {name} is on {t.device}, expected cuda")
        if t.dtype != torch.bfloat16:
            raise TypeError(f"{fn}: {name} is {t.dtype}, expected "
                            "torch.bfloat16")
        if t.ndim != 4:
            raise ValueError(f"{fn}: {name} must be (B, L, H, D), got "
                             f"{tuple(t.shape)}")
        if shape is not None and t.shape != shape:
            raise ValueError(f"{fn}: {name} is {tuple(t.shape)}, expected "
                             f"{tuple(shape)}")
        shape = t.shape
        devices.add(t.device)
    if len(devices) > 1:
        raise ValueError(f"{fn}: operands on several devices {devices}")
    b, l, h, d = shape
    if not supports_fused_mha(l, d):
        raise ValueError(f"{fn}: L={l} D={d} is outside the kernel's gate "
                         f"(L <= {MAX_FUSED_SEQ_LEN}, D <= 256)")
    if b > 65535 or h > 65535:
        raise ValueError(f"{fn}: B={b} H={h} exceed the launch grid")
    return b, l, h, d


def _strided(t: torch.Tensor) -> list:
    return [t.data_ptr(), *t.stride()]


def _forward_cuda(q, k, v, scale):
    """(o, stats): the output and the saved row max and sum, (2, B, H, L)."""
    b, l, h, d = q.shape
    out = torch.empty((b, l, h, d), dtype=q.dtype, device=q.device)
    stats = torch.empty((2, b, h, l), dtype=torch.float32, device=q.device)
    lib = _build.load("mha")
    with torch.cuda.device(q.device):
        code = lib.mha_fwd_bf16(
            *_strided(q), *_strided(k), *_strided(v), out.data_ptr(),
            stats.data_ptr(), b, l, h, d, float(scale),
            torch.cuda.current_stream(q.device).cuda_stream,
        )
    _build.check(lib, "mha_fwd_bf16", code)
    return out, stats


def _backward_cuda(q, k, v, stats, do, scale):
    b, l, h, d = q.shape
    dq, dk, dv = (torch.empty((b, l, h, d), dtype=q.dtype, device=q.device)
                  for _ in range(3))
    delta = torch.empty((b, h, l), dtype=torch.float32, device=q.device)
    lib = _build.load("mha")
    with torch.cuda.device(q.device):
        code = lib.mha_bwd_bf16(
            *_strided(q), *_strided(k), *_strided(v), *_strided(do),
            stats.data_ptr(), delta.data_ptr(), dq.data_ptr(), dk.data_ptr(),
            dv.data_ptr(), b, l, h, d, float(scale),
            torch.cuda.current_stream(q.device).cuda_stream,
        )
    _build.check(lib, "mha_bwd_bf16", code)
    return dq, dk, dv


class _FusedMha(torch.autograd.Function):
    """K7 with its backward: the plain versions for CPU tensors, the CUDA
    kernels for CUDA tensors (never autograd of the plain forward)."""

    @staticmethod
    def forward(ctx, q, k, v, scale):
        ctx.scale = scale
        if q.device.type == "cpu":
            ctx.save_for_backward(q, k, v)
            return fused_mha_reference(q, k, v, scale=scale)
        out, stats = _forward_cuda(q, k, v, scale)
        fused_mha.launches += 1
        ctx.save_for_backward(q, k, v, stats)
        return out

    @staticmethod
    def backward(ctx, do):
        q, k, v = ctx.saved_tensors[:3]
        if q.device.type == "cpu":
            grads = fused_mha_bwd_reference(q, k, v, do, scale=ctx.scale)
        else:
            _check_cuda("fused_mha backward", do=do, q=q)
            grads = _backward_cuda(q, k, v, ctx.saved_tensors[3], do,
                                   ctx.scale)
            fused_mha.launches_bwd += 1
        return (*grads, None)


def fused_mha(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
              scale: float) -> torch.Tensor:
    """``softmax(q kᵀ · scale) v`` over (B, L, H, D) tensors, differentiable;
    the contract of ``jax.nn.dot_product_attention(q, k, v, scale=scale)``
    with no mask, bias or dropout.

    CPU tensors take :func:`fused_mha_reference` and, under autograd,
    :func:`fused_mha_bwd_reference`. CUDA tensors launch the kernels or
    raise: bf16, one shape, inside :func:`supports_fused_mha`, any strides.
    ``launches`` and ``launches_bwd`` count the CUDA forward and backward
    calls.
    """
    if q.device.type != "cpu":
        _check_cuda("fused_mha", q=q, k=k, v=v)
    return _FusedMha.apply(q, k, v, float(scale))


def fused_mha_bwd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                  do: torch.Tensor, *, scale: float):
    """K7's backward alone for a given ``do`` (the gradients of
    :func:`fused_mha_bwd_reference`). On CUDA it runs the forward kernel for
    the row statistics, then the backward kernels; neither counter moves."""
    if q.device.type == "cpu":
        return fused_mha_bwd_reference(q, k, v, do, scale=scale)
    _check_cuda("fused_mha", q=q, k=k, v=v, do=do)
    _, stats = _forward_cuda(q, k, v, scale)
    return _backward_cuda(q, k, v, stats, do, scale)


fused_mha.launches = 0
fused_mha.launches_bwd = 0
