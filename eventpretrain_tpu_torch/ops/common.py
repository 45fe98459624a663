"""Pieces shared by the fused kernels K1/K4 (fused_attn_layer.py) and K2/K5
(fused_mlp.py): the LayerNorm numerics, forward and backward, and the
launchers of their GEMM (csrc/ln_gemm.cu) and row kernels (csrc/ln_bwd.cu),
with the GEMM's plain version and its weight-gradient split planner, and
the row kernels' range planner and plain twins of their launches.

Counterpart of eventpretrain_tpu/ops/pallas_common.py. ``ln_forward`` keeps
the TPU kernels' LN numerics (f32 statistics, var = E[x^2] - mean^2), so the
plain versions and the CUDA LayerNorm rows (``ln_rows``, which K1's and
K2's forward GEMMs read) round where the Pallas kernels round;
``ln_backward_reference`` is the LN tail of their backward kernels
(fused_attn_layer.py:348-354, fused_mlp.py:320-326).
"""

from __future__ import annotations

import functools
import math
from typing import NamedTuple, Optional

import torch
import torch.nn.functional as F

from eventpretrain_tpu_torch import _build

# Longest token block the fused sub-block kernels take (pallas_common.py).
MAX_FUSED_SEQ_LEN = 256

# GEMM epilogues (csrc/ln_gemm.cu)
EPI_BIAS = 0           # + bias, rounded
EPI_BIAS_GELU = 1      # + bias, GELU, rounded
EPI_BIAS_RESIDUAL = 2  # + bias + residual, rounded
EPI_F32 = 3            # + bias, f32 out (optionally also GELU rounded)
EPI_DGELU = 4          # * gelu'(aux), rounded

# GEMM operand layouts (csrc/ln_gemm.cu)
LAYOUT_FORWARD = 0  # A (M, K) . W (N, K)^T
LAYOUT_DGRAD = 1    # A (M, K) . W (K, N)
LAYOUT_WGRAD = 2    # dY (K, M)^T . X (K, N), K the tokens

# the GEMM's output tile and depth step (csrc/ln_gemm.cu)
GEMM_BM, GEMM_BN, GEMM_BK = 128, 128, 64
# the H100 SXM's SMs, and the weight-gradient grid's aim of output tiles an
# SM (csrc/ln_gemm.cu's persistent blocks take them in turn)
H100_SMS = 132
WGRAD_TILES_PER_SM = 2
# csrc/ln_bwd.cu: a row-kernel block is 8 warps; the column sum's block
# covers 256 columns (8 a lane) and each of its warps takes at least 4
# rows; the LayerNorm backward holds C % 64 == 0 up to 768
ROW_WARPS = 8
COLSUM_TILE = 256
COLSUM_MIN_ROWS = 4 * ROW_WARPS
LN_BWD_MAX_WIDTH = 768
# a step of the ordered sum adds at most 16 rows in one batch of loads
# (csrc/ln_bwd.cu kBatch), so a tile has at most 16 x 16 ranges
ROW_MAX_RANGES = 16 * 16


def grad_needed(*tensors: torch.Tensor) -> bool:
    """Whether autograd will record a call on ``tensors``: gradients are
    enabled and one of them requires a gradient. A call that is not
    recorded saves nothing and never runs a backward, so the sub-blocks'
    backward bounds apply only where this holds (a frozen trunk under
    enabled gradients runs forward only)."""
    return torch.is_grad_enabled() and any(t.requires_grad for t in tensors)


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
    """The raw handle of the current stream of ``t``'s device (the value of
    ``torch.cuda.current_stream(t.device).cuda_stream``, without building
    the Stream object: a twentieth of its host time)."""
    return torch._C._cuda_getCurrentRawStream(t.device.index)


def _ptr(t: Optional[torch.Tensor]):
    return None if t is None else t.data_ptr()


def gemm_check(m: int, n: int, k: int, layout: int) -> None:
    """Raise ``ValueError`` unless ``gemm_bf16`` takes an (M, N, K) product
    in this layout: N a multiple of the tile's 128 columns; the forward
    and dgrad depth K a multiple of 64 (M ragged); the weight gradient's M
    a multiple of 128 (its K, the tokens, ragged)."""
    if layout not in (LAYOUT_FORWARD, LAYOUT_DGRAD, LAYOUT_WGRAD):
        raise ValueError(f"gemm: unknown layout {layout}")
    if n % GEMM_BN:
        raise ValueError(f"gemm: needs N % {GEMM_BN} == 0, got N={n}")
    if layout == LAYOUT_WGRAD:
        if m % GEMM_BM:
            raise ValueError(f"gemm: the weight-gradient layout needs "
                             f"M % {GEMM_BM} == 0, got M={m}")
    elif k % GEMM_BK:
        raise ValueError(f"gemm: needs K % {GEMM_BK} == 0, got K={k}")
    if -(-m // GEMM_BM) > 65535:
        raise ValueError(f"gemm: M={m} rows exceed the launch grid")


def plan_wgrad_split(m: int, n: int, tokens: int,
                     sms: int = H100_SMS) -> tuple[int, int]:
    """``(splits, chunk)`` of a weight gradient's (M, N) sum over
    ``tokens``: ``splits`` contiguous token ranges of ``chunk`` tokens (a
    multiple of 64; the last range may be shorter), enough that the
    (M / 128) x (N / 128) output tiles, once per range, come to at least
    ``WGRAD_TILES_PER_SM`` tiles an SM where the tokens allow, never more
    ranges than 64-token steps: the longest ranges that give that many. A
    function of the shape and the SM count alone, so a gradient's summation
    order is the same on every run."""
    tiles = (m // GEMM_BM) * (n // GEMM_BN)
    k_tiles = max(1, -(-tokens // GEMM_BK))
    want = -(-WGRAD_TILES_PER_SM * sms // max(1, tiles))
    steps = -(-k_tiles // want)  # 64-token steps a range
    while steps > 1 and -(-k_tiles // steps) < want:
        steps -= 1
    chunk = steps * GEMM_BK
    return -(-tokens // chunk) if tokens else 1, chunk


@functools.lru_cache(maxsize=None)
def _sm_count(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


def _gemm(a, w, *, m, n, k, layout, epilogue, bias=None, residual=None,
          aux=None, gelu_out=False):
    """Launch ``gemm_bf16`` after checking what it needs; see ln_gemm.cu.
    The weight gradient gets its token split and its f32 partial scratch
    here."""
    gemm_check(m, n, k, layout)
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
    out_dtype = torch.float32 if epilogue == EPI_F32 else a.dtype
    out = torch.empty((m, n), dtype=out_dtype, device=a.device)
    out2 = (torch.empty((m, n), dtype=a.dtype, device=a.device)
            if gelu_out else None)
    part, chunk = None, k
    if layout == LAYOUT_WGRAD:
        if k == 0:  # a sum over no tokens
            return out.zero_()
        splits, chunk = plan_wgrad_split(m, n, k, _sm_count(a.device.index))
        if splits > 1:
            part = torch.empty((splits, m, n), dtype=torch.float32,
                               device=a.device)
    _launch_gemm(a, w, bias, residual, aux, out, out2, part, m, n, k,
                 layout, epilogue, chunk)
    return (out, out2) if gelu_out else out


def _launch_gemm(a, w, bias, residual, aux, out, out2, part, m, n, k,
                 layout, epilogue, chunk) -> None:
    lib = _build.load("ln_gemm")
    with torch.cuda.device(a.device):
        code = lib.gemm_bf16(
            a.data_ptr(), w.data_ptr(), _ptr(bias), _ptr(residual),
            _ptr(aux), out.data_ptr(), _ptr(out2), _ptr(part), m, n, k,
            int(layout), int(epilogue), int(chunk), _stream(a),
        )
    _build.check(lib, "gemm_bf16", code)


def _gemm_operands_f32(a, w, layout):
    """The (M, K) and (K, N) factors of a layout's product, in f32."""
    if layout == LAYOUT_FORWARD:
        return a.float(), w.float().t()
    if layout == LAYOUT_DGRAD:
        return a.float(), w.float()
    return a.float().t(), w.float()


def gemm_reference(a, w, *, layout, epilogue=EPI_BIAS, bias=None,
                   residual=None, aux=None, gelu_out=False, chunk=None):
    """Plain PyTorch version of ``gemm_bf16`` (csrc/ln_gemm.cu) in each
    layout and epilogue: the f32 product, ``+ bias``, then the epilogue,
    rounded to ``a.dtype`` where the kernel rounds (``EPI_F32`` keeps f32,
    and with ``gelu_out`` also returns the rounded GELU). With ``chunk``
    (the weight gradient) the tokens are summed range by range and the
    ranges' f32 sums added in order, as the kernel's split does. Used by
    the tests and ``chip_smoke.py``, by nothing on the main path."""
    lhs, rhs = _gemm_operands_f32(a, w, layout)
    if chunk is None:
        acc = lhs @ rhs
    else:
        acc = None
        for t in range(0, max(1, lhs.shape[1]), chunk):
            p = lhs[:, t:t + chunk] @ rhs[t:t + chunk]
            acc = p if acc is None else acc + p
    if bias is not None:
        acc = acc + bias.float()
    if epilogue == EPI_F32:
        if gelu_out:
            return acc, F.gelu(acc, approximate="none").to(a.dtype)
        return acc
    if epilogue == EPI_BIAS_GELU:
        acc = F.gelu(acc, approximate="none")
    elif epilogue == EPI_BIAS_RESIDUAL:
        acc = residual.float() + acc
    elif epilogue == EPI_DGELU:
        acc = acc * gelu_grad(aux)
    return acc.to(a.dtype)


def gemm_launch_reference(a, w, bias, residual, aux, out, out2, part, m, n,
                          k, layout, epilogue, chunk) -> None:
    """Plain twin of :func:`_launch_gemm`: fills ``out`` (and ``out2``) as
    ``gemm_bf16`` does, a weight gradient with a partial scratch ``part``
    summed over its ``chunk``-token ranges in order. The tests put it in
    the launcher's place to run the CUDA paths' composition on the CPU."""
    got = gemm_reference(a, w, layout=layout, epilogue=epilogue, bias=bias,
                         residual=residual, aux=aux,
                         gelu_out=out2 is not None,
                         chunk=chunk if part is not None else None)
    if out2 is not None:
        out.copy_(got[0])
        out2.copy_(got[1])
    else:
        out.copy_(got)


def ln_gemm(a: torch.Tensor, w: torch.Tensor, bias: Optional[torch.Tensor],
            *, epilogue: int, ln: Optional[tuple] = None,
            residual: Optional[torch.Tensor] = None, gelu_out: bool = False):
    """``epilogue([LN](a) @ w.T + bias)``: the forward layout.

    ``a`` (M, K), ``w`` (N, K), ``bias`` (N,) or None, ``residual`` (M, N);
    ``ln`` is ``(gamma f32 (K,), beta f32 (K,), eps)``: :func:`ln_rows`
    normalises the rows first, then the GEMM reads them. bf16 out, or f32
    for ``EPI_F32`` (with ``gelu_out`` also the rounded GELU of it, as a
    second result). CUDA tensors only.
    """
    m, k = a.shape
    n = w.shape[0]
    if w.shape != (n, k):
        raise ValueError(f"ln_gemm: a {tuple(a.shape)} and w "
                         f"{tuple(w.shape)} do not agree")
    if ln is not None:
        a = ln_rows(a, *ln)
    return _gemm(a, w, m=m, n=n, k=k, layout=LAYOUT_FORWARD,
                 epilogue=epilogue, bias=bias, residual=residual,
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
    return _gemm(dy, w, m=m, n=w.shape[1], k=k, layout=LAYOUT_DGRAD,
                 epilogue=epilogue, aux=aux)


def gemm_wgrad(dy: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """``dy.T @ x``, the weight gradient of a Linear in the torch layout
    (N_out, N_in), summed over the M tokens in f32 and rounded to bf16
    once (over :func:`plan_wgrad_split`'s token ranges, added in order).
    ``dy`` (M, N_out), ``x`` (M, N_in). CUDA tensors only."""
    if dy.ndim != 2 or x.ndim != 2 or dy.shape[0] != x.shape[0]:
        raise ValueError(f"gemm_wgrad: dy {tuple(dy.shape)} and x "
                         f"{tuple(x.shape)} do not agree")
    return _gemm(dy, x, m=dy.shape[1], n=x.shape[1], k=dy.shape[0],
                 layout=LAYOUT_WGRAD, epilogue=EPI_BIAS)


def ln_rows(x: torch.Tensor, gamma: torch.Tensor, beta: torch.Tensor,
            eps: float) -> torch.Tensor:
    """``LN(x)`` rounded to bf16 (csrc/ln_bwd.cu): K1's and K2's GEMM input,
    with the statistics and rounding of the TPU kernels' LN (common.cuh).
    ``x`` (M, C) bf16. CUDA tensors only. ``launches`` counts its kernel's
    launches."""
    m, c = x.shape
    check_cuda_operands("ln_rows", torch.bfloat16, x=x)
    check_cuda_operands("ln_rows", torch.float32, gamma=gamma, beta=beta)
    if c % 2 or gamma.shape != (c,) or beta.shape != (c,):
        raise ValueError("ln_rows: needs an even C and (C,) parameters")
    out = torch.empty_like(x)
    if m == 0:
        return out
    lib = _build.load("ln_bwd")
    with torch.cuda.device(x.device):
        code = lib.ln_rows_bf16(x.data_ptr(), gamma.data_ptr(),
                                beta.data_ptr(), float(eps), out.data_ptr(),
                                m, c, _stream(x))
    _build.check(lib, "ln_rows_bf16", code)
    ln_rows.launches += 1
    return out


class RowPlan(NamedTuple):
    """How csrc/ln_bwd.cu's row kernels cut M rows: ``ranges`` contiguous
    ranges of ``rows`` rows (the last may be shorter), one block each (for
    each column tile of a column sum), and their partial sums added
    ``group`` ranges at a time, then group by group."""

    ranges: int
    rows: int
    group: int

    @property
    def groups(self) -> int:
        return -(-self.ranges // self.group)

    def bounds(self, m: int) -> list[tuple[int, int]]:
        """``[(start, stop), ...]`` of each range, in order."""
        return [(r * self.rows, min(m, (r + 1) * self.rows))
                for r in range(self.ranges)]


def plan_row_ranges(m: int, slots: int, tiles: int = 1,
                    min_rows: int = ROW_WARPS) -> RowPlan:
    """The ranges of a row kernel's M rows: at most one block for each of
    the ``slots`` blocks the card holds at once (its SMs times the blocks
    an SM holds at the kernel's registers and shared memory), shared by
    ``tiles`` column tiles, so that they run in one wave; each range at
    least ``min_rows`` long where M allows, and at most ``ROW_MAX_RANGES``
    ranges. They are grouped ceil(sqrt(ranges)) at a time, so that both
    steps of the ordered sum add about as many rows, at most 16. A
    function of the shape and the card alone, so a sum's order is the
    same on every run."""
    if m <= 0 or slots <= 0 or tiles <= 0 or min_rows <= 0:
        raise ValueError(f"plan_row_ranges: M={m}, slots={slots}, "
                         f"tiles={tiles}, min_rows={min_rows}")
    ranges = max(1, min(slots // tiles, m // min_rows, ROW_MAX_RANGES))
    rows = -(-m // ranges)
    ranges = -(-m // rows)
    return RowPlan(ranges, rows, math.isqrt(ranges - 1) + 1)


def row_scratch_shape(plan: RowPlan, sums: int,
                      width: int) -> tuple[int, int, int]:
    """The f32 scratch of ``sums`` column sums of ``width`` columns: each
    range's partial row, then each group's."""
    return sums, plan.ranges + plan.groups, width


def row_counter_count(plan: RowPlan, tiles: int = 1) -> int:
    """The integer counters a launch uses: one for each group and one for
    the last step, for each column tile."""
    return tiles * (plan.groups + 1)


def ordered_row_sum(t: torch.Tensor, plan: RowPlan) -> torch.Tensor:
    """Plain twin of the row kernels' ordered column sum of ``t`` (M, N):
    the f32 partial sum of each planned range, the ranges of a group added
    in order, then the groups in order."""
    t = t.float()
    parts = [t[a:b].sum(0) for a, b in plan.bounds(t.shape[0])]
    sums = []
    for first in range(0, plan.ranges, plan.group):
        acc = parts[first]
        for p in parts[first + 1:first + plan.group]:
            acc = acc + p
        sums.append(acc)
    out = sums[0]
    for acc in sums[1:]:
        out = out + acc
    return out


def ln_backward_launch_reference(x, weight, eps, dy, d_yln, plan: RowPlan):
    """Plain twin of ``ln_backward_bf16``'s launch contract: ``dx`` row by
    row as :func:`ln_backward_reference`, ``dgamma`` and ``dbeta`` summed
    over ``plan``'s ranges and added in its order. Used by the tests."""
    xhat, _ = ln_stats(x, eps)
    dx, _, _ = ln_backward_reference(x, weight, eps, dy, d_yln)
    d = d_yln.float()
    return dx, ordered_row_sum(d * xhat, plan), ordered_row_sum(d, plan)


def colsum_launch_reference(x: torch.Tensor, plan: RowPlan) -> torch.Tensor:
    """Plain twin of ``colsum_bf16``: the f32 column sums over ``plan``'s
    ranges in its order, rounded to ``x.dtype`` once."""
    return ordered_row_sum(x, plan).to(x.dtype)


@functools.lru_cache(maxsize=None)
def _row_occupancy(index: int, kind: int, width: int) -> int:
    """Blocks of a row kernel an SM of card ``index`` holds (kind 0: the
    LayerNorm backward at ``width``, 1: the column sum)."""
    lib = _build.load("ln_bwd")
    with torch.cuda.device(index):
        n = lib.row_kernel_occupancy(kind, width)
    if n < 0:
        _build.check(lib, "row_kernel_occupancy", -n)
    if n == 0:
        raise RuntimeError(f"row kernel {kind} at width {width}: an SM "
                           "holds no block")
    return n


@functools.lru_cache(maxsize=None)
def _row_launch(index: int, kind: int, m: int, n: int):
    """``(rows, group, scratch floats, counters)`` of a row kernel's
    launch over (M, N) on card ``index``: kind 0 the LayerNorm backward
    (two sums of N = C columns), 1 the column sum (one sum, N / 256
    tiles)."""
    slots = _sm_count(index) * _row_occupancy(index, kind,
                                              n if kind == 0 else 0)
    if kind == 0:
        plan, sums, tiles = plan_row_ranges(m, slots), 2, 1
    else:
        tiles = -(-n // COLSUM_TILE)
        plan = plan_row_ranges(m, slots, tiles, COLSUM_MIN_ROWS)
        sums = 1
    return (plan.rows, plan.group,
            math.prod(row_scratch_shape(plan, sums, n)),
            row_counter_count(plan, tiles))


_ROW_WORKSPACE: dict[tuple[int, int], tuple[torch.Tensor, torch.Tensor]] = {}


def _row_workspace(device: torch.device, stream: int, floats: int,
                   counters: int) -> tuple[torch.Tensor, torch.Tensor]:
    """The row kernels' f32 partial-sum scratch and their zeroed u32
    counters on this stream, at least ``floats`` and ``counters`` long.
    The launches of one stream run one after the other, and each leaves
    the counters it used at zero (csrc/ln_bwd.cu wraps them), so they
    share one pair, allocated (``torch.empty``, ``torch.zeros``) when a
    launch needs more."""
    key = (device.index, stream)
    ws = _ROW_WORKSPACE.get(key)
    if ws is None or ws[0].numel() < floats or ws[1].numel() < counters:
        have = (0, 0) if ws is None else (ws[0].numel(), ws[1].numel())
        ws = (torch.empty(max(floats, have[0], 1 << 16), dtype=torch.float32,
                          device=device),
              torch.zeros(max(counters, have[1], 1024), dtype=torch.int32,
                          device=device))
        _ROW_WORKSPACE[key] = ws
    return ws


def ln_backward(x: torch.Tensor, gamma: torch.Tensor, eps: float,
                dy: torch.Tensor, d_yln: torch.Tensor):
    """CUDA twin of :func:`ln_backward_reference` over (M, C) rows:
    ``(dx bf16, dgamma f32, dbeta f32)``, the column sums in the order of
    :func:`plan_row_ranges` (one launch; see csrc/ln_bwd.cu). CUDA tensors
    only; ``launches`` counts its kernel's launches."""
    m, c = x.shape
    if c % 64 or not 0 < c <= LN_BWD_MAX_WIDTH:
        raise ValueError(f"ln_backward: needs C % 64 == 0 and C <= "
                         f"{LN_BWD_MAX_WIDTH}, got C={c}")
    if dy.shape != (m, c) or d_yln.shape != (m, c) or gamma.shape != (c,):
        raise ValueError("ln_backward: shapes do not agree")
    check_cuda_operands("ln_backward", torch.bfloat16, x=x, dy=dy)
    check_cuda_operands("ln_backward", torch.float32, gamma=gamma,
                        d_yln=d_yln)
    device = x.device
    if gamma.device != device:
        raise ValueError("ln_backward: operands on several devices")
    dx = torch.empty_like(x)
    dg = torch.empty((c,), dtype=torch.float32, device=device)
    db = torch.empty((c,), dtype=torch.float32, device=device)
    if m == 0:
        return dx, dg.zero_(), db.zero_()
    rows, group, floats, counters = _row_launch(device.index, 0, m, c)
    stream = _stream(x)
    part, cnt = _row_workspace(device, stream, floats, counters)
    lib = _build.load("ln_bwd")
    with torch.cuda.device(device):
        code = lib.ln_backward_bf16(
            x.data_ptr(), gamma.data_ptr(), float(eps), dy.data_ptr(),
            d_yln.data_ptr(), dx.data_ptr(), part.data_ptr(), cnt.data_ptr(),
            dg.data_ptr(), db.data_ptr(), m, c, rows, group, stream,
        )
    _build.check(lib, "ln_backward_bf16", code)
    ln_backward.launches += 1
    return dx, dg, db


def colsum(x: torch.Tensor) -> torch.Tensor:
    """Column sums of a bf16 (M, N) matrix in f32, rounded to bf16 once:
    a bias gradient, in the order of :func:`plan_row_ranges` (one launch;
    see csrc/ln_bwd.cu). N % 8 == 0 (16-byte rows). CUDA tensors only;
    ``launches`` counts its kernel's launches."""
    m, n = x.shape
    check_cuda_operands("colsum", torch.bfloat16, x=x)
    if n % 8:
        raise ValueError(f"colsum: needs N % 8 == 0, got N={n}")
    device = x.device
    out = torch.empty((n,), dtype=torch.bfloat16, device=device)
    if m == 0 or n == 0:
        return out.zero_()
    rows, group, floats, counters = _row_launch(device.index, 1, m, n)
    stream = _stream(x)
    part, cnt = _row_workspace(device, stream, floats, counters)
    lib = _build.load("ln_bwd")
    with torch.cuda.device(device):
        code = lib.colsum_bf16(x.data_ptr(), part.data_ptr(), cnt.data_ptr(),
                               out.data_ptr(), m, n, rows, group, stream)
    _build.check(lib, "colsum_bf16", code)
    colsum.launches += 1
    return out


ln_rows.launches = 0
ln_backward.launches = 0
colsum.launches = 0
