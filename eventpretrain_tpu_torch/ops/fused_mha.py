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
launch a kernel or raise: bf16 only, inside the gate. :func:`mha_route`
picks the kernels of a call, in Python, from its shape and its operands;
each route has its own entry points in csrc/mha.cu:

    "onepass"  the one-pass bodies that the K1/K4 attention core runs too
               (csrc/attention_core.cuh), over K7's operands as descriptors
               (pointer and batch, row and head strides), where L <= 256,
               D % 8 == 0, every operand's rows can be read 16 bytes at a
               time and the shared memory fits: the shapes of every hub of
               the repo;
    "tiled"    K7's tiled kernels for the rest of the gate.

Both read q, k, v (and the incoming gradient) through their strides, so the
slices of a packed qkv projection go in without a copy; outputs are
contiguous. The CUDA forward saves each row's max and sum of exp, (2, B, H,
L) f32, which the tiled backward reads (the one-pass backward recomputes
them with the forward's code; the Pallas VJP saves only q, k and v).
"""

from __future__ import annotations

import torch

from eventpretrain_tpu_torch import _build
from eventpretrain_tpu_torch.ops.common import mm_f32
from eventpretrain_tpu_torch.ops.fused_attn_layer import (
    MAX_BLOCK_SMEM,
    attention_bwd_scratch,
    attention_bwd_smem_bytes,
    attention_smem_bytes,
)

# Longest sequence the kernel takes (pallas_attention.py:37).
MAX_FUSED_SEQ_LEN = 1024


def supports_fused_mha(seq_len: int, head_dim: int) -> bool:
    """The JAX gate (pallas_attention.py:136): L <= 1024 and D <= 256. The
    CUDA kernels take every shape inside it."""
    return seq_len <= MAX_FUSED_SEQ_LEN and head_dim <= 256


# Longest sequence of the one-pass route: a warp holds its 16 score rows
ONEPASS_MAX_SEQ_LEN = 256


def _rows_16_bytes(t: torch.Tensor) -> bool:
    """Every (B, L, H) row of ``t`` can be read 16 bytes at a time: bf16
    columns of unit stride, the other strides multiples of 8 elements (a
    dimension of size 1 has no stride that matters), a 16-byte aligned
    pointer."""
    (b, l, h, _), (sb, sl, sh, sd) = t.shape, t.stride()
    return (sd == 1 and t.data_ptr() % 16 == 0
            and ((sb if b > 1 else 0) | (sl if l > 1 else 0)
                 | (sh if h > 1 else 0)) % 8 == 0)


def mha_route(seq_len: int, head_dim: int, operands,
              backward: bool) -> str:
    """The kernels K7 launches for CUDA ``operands`` (q, k, v, and do for
    the ``backward``; each (B, L, H, D)) inside :func:`supports_fused_mha`:
    ``"onepass"`` where L <= 256, D % 8 == 0, the one-pass kernels' shared
    memory fits (the forward's; with ``backward`` the backward's, which is
    the larger) and every operand can be read 16 bytes at a time;
    ``"tiled"`` everywhere else."""
    smem = (attention_bwd_smem_bytes if backward
            else attention_smem_bytes)(seq_len, head_dim)
    if (seq_len <= ONEPASS_MAX_SEQ_LEN and head_dim % 8 == 0
            and smem <= MAX_BLOCK_SMEM
            and all(map(_rows_16_bytes, operands))):
        return "onepass"
    return "tiled"


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


def _descriptor(t: torch.Tensor) -> list:
    """The one-pass route's operand descriptor of a (B, L, H, D) tensor
    with contiguous columns: its pointer and its B, L and H strides."""
    return [t.data_ptr(), *t.stride()[:3]]


def _forward_cuda(q, k, v, scale):
    """(o, stats, route): the output, the row max and sum of exp (2, B, H,
    L), and the route taken."""
    b, l, h, d = q.shape
    out = torch.empty((b, l, h, d), dtype=q.dtype, device=q.device)
    stats = torch.empty((2, b, h, l), dtype=torch.float32, device=q.device)
    route = mha_route(l, d, (q, k, v), backward=False)
    lib = _build.load("mha")
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        if route == "onepass":
            fn = "mha_onepass_fwd_bf16"
            code = lib.mha_onepass_fwd_bf16(
                *_descriptor(q), *_descriptor(k), *_descriptor(v),
                *_descriptor(out), stats.data_ptr(), b, l, h, d,
                float(scale), stream)
        else:
            fn = "mha_fwd_bf16"
            code = lib.mha_fwd_bf16(
                *_strided(q), *_strided(k), *_strided(v), out.data_ptr(),
                stats.data_ptr(), b, l, h, d, float(scale), stream)
    _build.check(lib, fn, code)
    return out, stats, route


def _backward_cuda(q, k, v, do, scale, stats=None):
    """((dq, dk, dv), route). The tiled route reads the forward's ``stats``
    (computed here when not given); the one-pass route recomputes them."""
    b, l, h, d = q.shape
    dq, dk, dv = (torch.empty((b, l, h, d), dtype=q.dtype, device=q.device)
                  for _ in range(3))
    route = mha_route(l, d, (q, k, v, do), backward=True)
    if route == "onepass":
        scratch = attention_bwd_scratch(b, l, h, q.device)
    elif stats is None:
        stats = _forward_cuda(q, k, v, scale)[1]
    lib = _build.load("mha")
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        if route == "onepass":
            fn = "mha_onepass_bwd_bf16"
            code = lib.mha_onepass_bwd_bf16(
                *_descriptor(q), *_descriptor(k), *_descriptor(v),
                *_descriptor(do), *_descriptor(dq), *_descriptor(dk),
                *_descriptor(dv), scratch.data_ptr(), b, l, h, d,
                float(scale), stream)
        else:
            fn = "mha_bwd_bf16"
            delta = torch.empty((b, h, l), dtype=torch.float32,
                                device=q.device)
            code = lib.mha_bwd_bf16(
                *_strided(q), *_strided(k), *_strided(v), *_strided(do),
                stats.data_ptr(), delta.data_ptr(), dq.data_ptr(),
                dk.data_ptr(), dv.data_ptr(), b, l, h, d, float(scale),
                stream)
    _build.check(lib, fn, code)
    return (dq, dk, dv), route


class _FusedMha(torch.autograd.Function):
    """K7 with its backward: the plain versions for CPU tensors, the CUDA
    kernels for CUDA tensors (never autograd of the plain forward)."""

    @staticmethod
    def forward(ctx, q, k, v, scale):
        ctx.scale = scale
        if q.device.type == "cpu":
            ctx.save_for_backward(q, k, v)
            return fused_mha_reference(q, k, v, scale=scale)
        out, stats, route = _forward_cuda(q, k, v, scale)
        fused_mha.launches += 1
        fused_mha.launches_by_route[route] += 1
        ctx.save_for_backward(q, k, v, stats)
        return out

    @staticmethod
    def backward(ctx, do):
        q, k, v = ctx.saved_tensors[:3]
        if q.device.type == "cpu":
            grads = fused_mha_bwd_reference(q, k, v, do, scale=ctx.scale)
        else:
            _check_cuda("fused_mha backward", do=do, q=q)
            grads, route = _backward_cuda(q, k, v, do, ctx.scale,
                                          ctx.saved_tensors[3])
            fused_mha.launches_bwd += 1
            fused_mha.launches_bwd_by_route[route] += 1
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
    calls, and ``launches_by_route`` and ``launches_bwd_by_route`` the same
    calls by the :func:`mha_route` each took.
    """
    if q.device.type != "cpu":
        _check_cuda("fused_mha", q=q, k=k, v=v)
    return _FusedMha.apply(q, k, v, float(scale))


def fused_mha_bwd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                  do: torch.Tensor, *, scale: float):
    """K7's backward alone for a given ``do`` (the gradients of
    :func:`fused_mha_bwd_reference`). On CUDA it runs the backward kernels
    of its :func:`mha_route` (the tiled route after the forward kernel, for
    the row statistics); no counter moves."""
    if q.device.type == "cpu":
        return fused_mha_bwd_reference(q, k, v, do, scale=scale)
    _check_cuda("fused_mha", q=q, k=k, v=v, do=do)
    return _backward_cuda(q, k, v, do, scale)[0]


fused_mha.launches = 0
fused_mha.launches_bwd = 0
fused_mha.launches_by_route = {"onepass": 0, "tiled": 0}
fused_mha.launches_bwd_by_route = {"onepass": 0, "tiled": 0}
