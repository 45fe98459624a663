"""Pieces shared by the fused sub-block kernels K1 (fused_attn_layer.py) and
K2 (fused_mlp.py): the LayerNorm numerics and the launcher of their GEMM.

Counterpart of eventpretrain_tpu/ops/pallas_common.py. ``ln_forward`` keeps
the TPU kernels' LN numerics (f32 statistics, var = E[x^2] - mean^2), so the
plain versions and the CUDA GEMM's LayerNorm prologue round where the
Pallas kernels round.
"""

from __future__ import annotations

from typing import Optional

import torch

from eventpretrain_tpu_torch import _build

# Longest token block the fused sub-block kernels take (pallas_common.py).
MAX_FUSED_SEQ_LEN = 256

# ln_gemm epilogues (csrc/ln_gemm.cu)
EPI_BIAS = 0
EPI_BIAS_GELU = 1
EPI_BIAS_RESIDUAL = 2

_GEMM_BM, _GEMM_BN, _GEMM_BK = 64, 64, 32


def ln_forward(x: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor,
               eps: float):
    """f32 LayerNorm over the last axis, rounded to ``x.dtype``."""
    xf = x.float()
    mu = xf.mean(-1, keepdim=True)
    var = (xf * xf).mean(-1, keepdim=True) - mu * mu
    xhat = (xf - mu) * torch.rsqrt(var + eps)
    return (xhat * weight.float() + bias.float()).to(x.dtype)


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


def ln_gemm(a: torch.Tensor, w: torch.Tensor, bias: torch.Tensor, *,
            epilogue: int, ln: Optional[tuple] = None,
            residual: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Launch csrc/ln_gemm.cu: ``epilogue([LN](a) @ w.T + bias)`` in bf16.

    ``a`` (M, K), ``w`` (N, K), ``bias`` (N,), ``residual`` (M, N); ``ln`` is
    ``(gamma f32 (K,), beta f32 (K,), eps)``. CUDA tensors only.
    """
    m, k = a.shape
    n = w.shape[0]
    if w.shape != (n, k) or bias.shape != (n,):
        raise ValueError(
            f"ln_gemm: shapes a {tuple(a.shape)} w {tuple(w.shape)} "
            f"bias {tuple(bias.shape)} do not agree"
        )
    if k % _GEMM_BK or n % _GEMM_BN:
        raise ValueError(
            f"ln_gemm: needs K % {_GEMM_BK} == 0 and N % {_GEMM_BN} == 0, "
            f"got K={k} N={n}"
        )
    if (m + _GEMM_BM - 1) // _GEMM_BM > 65535:
        raise ValueError(f"ln_gemm: M={m} rows exceed the launch grid")
    check_cuda_operands("ln_gemm", torch.bfloat16, a=a, w=w, bias=bias)
    if epilogue == EPI_BIAS_RESIDUAL:
        if residual is None or residual.shape != (m, n):
            raise ValueError("ln_gemm: the residual epilogue needs (M, N)")
        check_cuda_operands("ln_gemm", torch.bfloat16, a=a, residual=residual)
    if ln is not None:
        gamma, beta, eps = ln
        if gamma.shape != (k,) or beta.shape != (k,):
            raise ValueError("ln_gemm: LayerNorm parameters must be (K,)")
        check_cuda_operands("ln_gemm", torch.float32, a_ln_w=gamma,
                            a_ln_b=beta)
        if gamma.device != a.device or beta.device != a.device:
            raise ValueError("ln_gemm: LayerNorm parameters on another device")
    out = torch.empty((m, n), dtype=torch.bfloat16, device=a.device)
    lib = _build.load("ln_gemm")
    with torch.cuda.device(a.device):
        code = lib.ln_gemm_bf16(
            a.data_ptr(),
            gamma.data_ptr() if ln is not None else None,
            beta.data_ptr() if ln is not None else None,
            float(eps) if ln is not None else 0.0,
            int(ln is not None),
            w.data_ptr(),
            bias.data_ptr(),
            residual.data_ptr() if residual is not None else None,
            out.data_ptr(),
            m, n, k, int(epilogue),
            torch.cuda.current_stream(a.device).cuda_stream,
        )
    _build.check(lib, "ln_gemm_bf16", code)
    return out
