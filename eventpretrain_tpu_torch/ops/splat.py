"""K3 — the per-event splat behind the voxel grid.

Replaces eventpretrain_tpu/ops/pallas_voxel.py::splat_mxu (+
``voxelize_batch_mxu``): ``(B, C, E)`` f32 weights summed at integer
``(y, x)`` into ``(B, H, W, C)`` f32 grids; out-of-frame events add
nothing, and weights of rows past ``count`` are already 0.

The TPU kernel runs the scatter as one-hot matrix products on the MXU,
because the TPU has no scatter unit, carrying the f32 weights as a bf16
hi+lo split. Hopper has float atomics, so the CUDA kernel (csrc/splat.cu)
is the direct scatter: one thread per (sample, event), an ``atomicAdd``
per nonzero channel, exact f32 up to the order of the additions. It is
bound by atomic traffic to L2 (E*C adds per sample), not by arithmetic.
"""

from __future__ import annotations

import torch

from eventpretrain_tpu_torch import _build
from eventpretrain_tpu_torch.ops.common import check_cuda_operands
from eventpretrain_tpu_torch.ops.events import bilinear_bin_weights


def splat_reference(y: torch.Tensor, x: torch.Tensor, weights: torch.Tensor,
                    *, height: int, width: int) -> torch.Tensor:
    """Plain PyTorch version of K3: ``index_put_(accumulate=True)``."""
    b, c, e = weights.shape
    ok = (y >= 0) & (y < height) & (x >= 0) & (x < width)
    bi = torch.arange(b, device=weights.device)[:, None].expand(b, e)
    cell = (bi * height + y.long()) * width + x.long()
    out = torch.zeros((b * height * width, c), dtype=torch.float32,
                      device=weights.device)
    out.index_put_((cell[ok],), weights.transpose(1, 2)[ok].float(),
                   accumulate=True)
    return out.view(b, height, width, c)


def splat(y: torch.Tensor, x: torch.Tensor, weights: torch.Tensor, *,
          height: int, width: int) -> torch.Tensor:
    """Scatter ``(B, C, E)`` weights at int32 ``y, x (B, E)`` into
    ``(B, H, W, C)``.

    CPU tensors take :func:`splat_reference`. CUDA tensors launch the
    kernel or raise: ``y``, ``x`` int32 and ``weights`` f32, contiguous.
    """
    if weights.device.type == "cpu":
        return splat_reference(y, x, weights, height=height, width=width)
    if weights.ndim != 3:
        raise ValueError(f"splat: weights must be (B, C, E), "
                         f"got {tuple(weights.shape)}")
    b, c, e = weights.shape
    if y.shape != (b, e) or x.shape != (b, e):
        raise ValueError(f"splat: y, x must be ({b}, {e})")
    if b > 65535:
        raise ValueError(f"splat: batch {b} exceeds the launch grid")
    check_cuda_operands("splat", torch.int32, y=y, x=x)
    check_cuda_operands("splat", torch.float32, weights=weights)
    if y.device != weights.device:
        raise ValueError("splat: coordinates and weights on other devices")
    out = torch.zeros((b, height, width, c), dtype=torch.float32,
                      device=weights.device)
    lib = _build.load("splat")
    with torch.cuda.device(weights.device):
        code = lib.splat_f32(
            y.data_ptr(), x.data_ptr(), weights.data_ptr(), out.data_ptr(),
            b, c, e, height, width,
            torch.cuda.current_stream(weights.device).cuda_stream,
        )
    _build.check(lib, "splat_f32", code)
    splat.launches += 1
    return out


splat.launches = 0


def voxelize_batch(events: torch.Tensor, counts: torch.Tensor, *,
                   num_bins: int, height: int, width: int) -> torch.Tensor:
    """``(B, E, 4)`` xytp, ``(B,)`` -> ``(B, H, W, num_bins)`` voxel grids:
    plain-PyTorch bin weights, then :func:`splat`."""
    x = events[..., 0].to(torch.int32).contiguous()
    y = events[..., 1].to(torch.int32).contiguous()
    wb = bilinear_bin_weights(events, counts, num_bins)
    wb = wb.transpose(1, 2).contiguous()  # (B, NB, E)
    return splat(y, x, wb, height=height, width=width)
