"""Pieces shared by the fused kernels K1/K4 (fused_attn_layer.py) and K2/K5
(fused_mlp.py): the LayerNorm numerics, forward and backward, and the
launchers of their GEMM (csrc/ln_gemm.cu) and row kernels (csrc/ln_bwd.cu).

Counterpart of eventpretrain_tpu/ops/pallas_common.py. ``ln_forward`` keeps
the TPU kernels' LN numerics (f32 statistics, var = E[x^2] - mean^2), so the
plain versions and the CUDA GEMM's LayerNorm prologue round where the
Pallas kernels round; ``ln_backward_reference`` is the LN tail of their
backward kernels (fused_attn_layer.py:348-354, fused_mlp.py:320-326).
"""

from __future__ import annotations

import math
from typing import Optional

import torch

from eventpretrain_tpu_torch import _build

# Longest token block the fused sub-block kernels take (pallas_common.py).
MAX_FUSED_SEQ_LEN = 256

# GEMM epilogues (csrc/ln_gemm.cu)
EPI_BIAS = 0           # + bias, rounded
EPI_BIAS_GELU = 1      # + bias, GELU, rounded
EPI_BIAS_RESIDUAL = 2  # + bias + residual, rounded
EPI_F32 = 3            # + bias, f32 out (optionally also GELU rounded)
EPI_DGELU = 4          # * gelu'(aux), rounded

_GEMM_BM, _GEMM_BN, _GEMM_BK = 64, 64, 32
# rows of one block's partial column sums (csrc/ln_bwd.cu)
_COLSUM_ROWS = 64
_LN_BWD_MAX_WIDTH = 768


def ln_stats(x: torch.Tensor, eps: float):
    """f32 ``(xhat, rstd)`` of a LayerNorm over the last axis."""
    xf = x.float()
    mu = xf.mean(-1, keepdim=True)
    var = (xf * xf).mean(-1, keepdim=True) - mu * mu
    rstd = torch.rsqrt(var + eps)
    return (xf - mu) * rstd, rstd


def ln_forward(x: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor,
               eps: float):
    """f32 LayerNorm over the last axis, rounded to ``x.dtype``."""
    xhat, _ = ln_stats(x, eps)
    return (xhat * weight.float() + bias.float()).to(x.dtype)


def ln_backward_reference(x, weight, eps, dy, d_yln):
    """Plain LN tail of the sub-block backward: ``(dx, dgamma, dbeta)``.

    ``dy`` is the gradient of the residual output (it passes straight to
    ``dx``), ``d_yln`` the f32 gradient of the normalised activation. Sums
    and ``dx`` are f32, ``dx`` rounded to ``x.dtype`` once.
    """
    xhat, rstd = ln_stats(x, eps)
    red = tuple(range(x.ndim - 1))
    dg = (d_yln * xhat).sum(red)
    db = d_yln.sum(red)
    dxhat = d_yln * weight.float()
    m1 = dxhat.mean(-1, keepdim=True)
    m2 = (dxhat * xhat).mean(-1, keepdim=True)
    dx = dy.float() + rstd * (dxhat - m1 - xhat * m2)
    return dx.to(x.dtype), dg, db


def gelu_grad(x: torch.Tensor) -> torch.Tensor:
    """d/dx of the exact GELU, ``Phi(x) + x * phi(x)`` (fused_mlp.py:100)."""
    cdf = 0.5 * (1.0 + torch.erf(x * (1.0 / math.sqrt(2.0))))
    pdf = torch.exp(-0.5 * x * x) * (1.0 / math.sqrt(2.0 * math.pi))
    return cdf + x * pdf


def mm_f32(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``a @ b`` with f32 accumulation and an f32 result, whatever the
    operands' dtype (bf16 x bf16 products are exact in f32), i.e. the
    ``preferred_element_type=jnp.float32`` dot of the Pallas kernels."""
    return torch.matmul(a.float(), b.float())


def check_cuda_operands(fn: str, dtype: torch.dtype, **tensors) -> None:
    """Raise unless every tensor is a contiguous, 16-byte aligned CUDA
    tensor of ``dtype`` on one device."""
    devices = set()
    for name, t in tensors.items():
        if t.device.type != "cuda":
            raise ValueError(f"{fn}: {name} is on {t.device}, expected cuda")
        if t.dtype != dtype:
            raise TypeError(f"{fn}: {name} is {t.dtype}, expected {dtype}")
        if not t.is_contiguous():
            raise ValueError(f"{fn}: {name} must be contiguous")
        if t.data_ptr() % 16:
            raise ValueError(f"{fn}: {name} must be 16-byte aligned")
        devices.add(t.device)
    if len(devices) > 1:
        raise ValueError(f"{fn}: operands on several devices {devices}")


def _stream(t: torch.Tensor) -> int:
    return torch.cuda.current_stream(t.device).cuda_stream


def _ptr(t: Optional[torch.Tensor]):
    return None if t is None else t.data_ptr()


def _gemm(a, w, *, m, n, k, a_trans, b_kn, epilogue, bias=None, ln=None,
          residual=None, aux=None, gelu_out=False):
    """Launch ``gemm_bf16`` after checking what it needs; see ln_gemm.cu."""
    if n % _GEMM_BN:
        raise ValueError(f"gemm: needs N % {_GEMM_BN} == 0, got N={n}")
    if a_trans:
        if m % _GEMM_BM:
            raise ValueError(f"gemm: the weight-gradient layout needs "
                             f"M % {_GEMM_BM} == 0, got M={m}")
    elif k % _GEMM_BK:
        raise ValueError(f"gemm: needs K % {_GEMM_BK} == 0, got K={k}")
    if (m + _GEMM_BM - 1) // _GEMM_BM > 65535:
        raise ValueError(f"gemm: M={m} rows exceed the launch grid")
    check_cuda_operands("gemm", torch.bfloat16, a=a, w=w)
    if bias is not None:
        if bias.shape != (n,):
            raise ValueError(f"gemm: bias must be ({n},)")
        check_cuda_operands("gemm", torch.bfloat16, a=a, bias=bias)
    if epilogue == EPI_BIAS_RESIDUAL:
        if residual is None or residual.shape != (m, n):
            raise ValueError("gemm: the residual epilogue needs (M, N)")
        check_cuda_operands("gemm", torch.bfloat16, a=a, residual=residual)
    if epilogue == EPI_DGELU:
        if aux is None or aux.shape != (m, n):
            raise ValueError("gemm: the gelu' epilogue needs f32 (M, N)")
        check_cuda_operands("gemm", torch.float32, aux=aux)
        if aux.device != a.device:
            raise ValueError("gemm: aux on another device")
    if ln is not None:
        gamma, beta, eps = ln
        if a_trans or b_kn:
            raise ValueError("gemm: the LayerNorm prologue needs the "
                             "forward layout")
        if gamma.shape != (k,) or beta.shape != (k,):
            raise ValueError("gemm: LayerNorm parameters must be (K,)")
        check_cuda_operands("gemm", torch.float32, a_ln_w=gamma, a_ln_b=beta)
        if gamma.device != a.device:
            raise ValueError("gemm: LayerNorm parameters on another device")
    out_dtype = torch.float32 if epilogue == EPI_F32 else torch.bfloat16
    out = torch.empty((m, n), dtype=out_dtype, device=a.device)
    out2 = (torch.empty((m, n), dtype=torch.bfloat16, device=a.device)
            if gelu_out else None)
    lib = _build.load("ln_gemm")
    with torch.cuda.device(a.device):
        code = lib.gemm_bf16(
            a.data_ptr(),
            _ptr(ln[0]) if ln is not None else None,
            _ptr(ln[1]) if ln is not None else None,
            float(ln[2]) if ln is not None else 0.0,
            int(ln is not None), int(a_trans), int(b_kn),
            w.data_ptr(), _ptr(bias), _ptr(residual), _ptr(aux),
            out.data_ptr(), _ptr(out2), m, n, k, int(epilogue), _stream(a),
        )
    _build.check(lib, "gemm_bf16", code)
    return (out, out2) if gelu_out else out


def ln_gemm(a: torch.Tensor, w: torch.Tensor, bias: Optional[torch.Tensor],
            *, epilogue: int, ln: Optional[tuple] = None,
            residual: Optional[torch.Tensor] = None, gelu_out: bool = False):
    """``epilogue([LN](a) @ w.T + bias)``: the forward layout.

    ``a`` (M, K), ``w`` (N, K), ``bias`` (N,) or None, ``residual`` (M, N);
    ``ln`` is ``(gamma f32 (K,), beta f32 (K,), eps)``. bf16 out, or f32
    for ``EPI_F32`` (with ``gelu_out`` also the rounded GELU of it, as a
    second result). CUDA tensors only.
    """
    m, k = a.shape
    n = w.shape[0]
    if w.shape != (n, k):
        raise ValueError(f"ln_gemm: a {tuple(a.shape)} and w "
                         f"{tuple(w.shape)} do not agree")
    return _gemm(a, w, m=m, n=n, k=k, a_trans=False, b_kn=False,
                 epilogue=epilogue, bias=bias, ln=ln, residual=residual,
                 gelu_out=gelu_out)


def gemm_dgrad(dy: torch.Tensor, w: torch.Tensor, *, epilogue: int = EPI_BIAS,
               aux: Optional[torch.Tensor] = None) -> torch.Tensor:
    """``dy @ w`` for ``dy`` (M, N_out) and a torch-layout weight ``w``
    (N_out, N_in): the input gradient through a Linear. ``EPI_BIAS``
    rounds to bf16, ``EPI_F32`` keeps f32, ``EPI_DGELU`` multiplies by
    ``gelu'(aux)`` then rounds. CUDA tensors only."""
    m, k = dy.shape
    if w.ndim != 2 or w.shape[0] != k:
        raise ValueError(f"gemm_dgrad: dy {tuple(dy.shape)} and w "
                         f"{tuple(w.shape)} do not agree")
    return _gemm(dy, w, m=m, n=w.shape[1], k=k, a_trans=False, b_kn=True,
                 epilogue=epilogue, aux=aux)


def gemm_wgrad(dy: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """``dy.T @ x``, the weight gradient of a Linear in the torch layout
    (N_out, N_in), summed over the M tokens in f32 and rounded to bf16
    once. ``dy`` (M, N_out), ``x`` (M, N_in). CUDA tensors only."""
    if dy.ndim != 2 or x.ndim != 2 or dy.shape[0] != x.shape[0]:
        raise ValueError(f"gemm_wgrad: dy {tuple(dy.shape)} and x "
                         f"{tuple(x.shape)} do not agree")
    return _gemm(dy, x, m=dy.shape[1], n=x.shape[1], k=dy.shape[0],
                 a_trans=True, b_kn=True, epilogue=EPI_BIAS)


def ln_rows(x: torch.Tensor, gamma: torch.Tensor, beta: torch.Tensor,
            eps: float) -> torch.Tensor:
    """``LN(x)`` rounded to bf16 (csrc/ln_bwd.cu), with the statistics of
    the GEMM prologue. ``x`` (M, C) bf16. CUDA tensors only."""
    m, c = x.shape
    check_cuda_operands("ln_rows", torch.bfloat16, x=x)
    check_cuda_operands("ln_rows", torch.float32, gamma=gamma, beta=beta)
    if c % 2 or gamma.shape != (c,) or beta.shape != (c,):
        raise ValueError("ln_rows: needs an even C and (C,) parameters")
    out = torch.empty_like(x)
    lib = _build.load("ln_bwd")
    with torch.cuda.device(x.device):
        code = lib.ln_rows_bf16(x.data_ptr(), gamma.data_ptr(),
                                beta.data_ptr(), float(eps), out.data_ptr(),
                                m, c, _stream(x))
    _build.check(lib, "ln_rows_bf16", code)
    return out


def ln_backward(x: torch.Tensor, gamma: torch.Tensor, eps: float,
                dy: torch.Tensor, d_yln: torch.Tensor):
    """CUDA twin of :func:`ln_backward_reference` over (M, C) rows:
    ``(dx bf16, dgamma f32, dbeta f32)``, the column sums deterministic."""
    m, c = x.shape
    if c % 64 or c > _LN_BWD_MAX_WIDTH:
        raise ValueError(f"ln_backward: needs C % 64 == 0 and C <= "
                         f"{_LN_BWD_MAX_WIDTH}, got C={c}")
    if dy.shape != (m, c) or d_yln.shape != (m, c) or gamma.shape != (c,):
        raise ValueError("ln_backward: shapes do not agree")
    check_cuda_operands("ln_backward", torch.bfloat16, x=x, dy=dy)
    check_cuda_operands("ln_backward", torch.float32, gamma=gamma,
                        d_yln=d_yln)
    if gamma.device != x.device:
        raise ValueError("ln_backward: operands on several devices")
    nblk = max(1, -(-m // _COLSUM_ROWS))
    dx = torch.empty_like(x)
    part = torch.empty((2, nblk, c), dtype=torch.float32, device=x.device)
    dg = torch.empty((c,), dtype=torch.float32, device=x.device)
    db = torch.empty((c,), dtype=torch.float32, device=x.device)
    lib = _build.load("ln_bwd")
    with torch.cuda.device(x.device):
        code = lib.ln_backward_bf16(
            x.data_ptr(), gamma.data_ptr(), float(eps), dy.data_ptr(),
            d_yln.data_ptr(), dx.data_ptr(), part.data_ptr(), dg.data_ptr(),
            db.data_ptr(), m, c, _COLSUM_ROWS, _stream(x),
        )
    _build.check(lib, "ln_backward_bf16", code)
    return dx, dg, db


def colsum(x: torch.Tensor) -> torch.Tensor:
    """Column sums of a bf16 (M, N) matrix in f32, rounded to bf16 once:
    a bias gradient. Deterministic (csrc/ln_bwd.cu). CUDA tensors only."""
    m, n = x.shape
    check_cuda_operands("colsum", torch.bfloat16, x=x)
    nblk = max(1, -(-m // _COLSUM_ROWS))
    part = torch.empty((nblk, n), dtype=torch.float32, device=x.device)
    out = torch.empty((n,), dtype=torch.bfloat16, device=x.device)
    lib = _build.load("ln_bwd")
    with torch.cuda.device(x.device):
        code = lib.colsum_bf16(x.data_ptr(), part.data_ptr(), out.data_ptr(),
                               m, n, _COLSUM_ROWS, _stream(x))
    _build.check(lib, "colsum_bf16", code)
    return out
