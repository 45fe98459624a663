"""K3 — the per-event splat behind the voxel grid — and K8, the per-event
scatter voxelizer that computes the same grids from the raw events in one
pass.

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

K8 replaces ``voxelize_batch_pallas`` (pallas_voxel.py:97, ``_voxel_kernel``
:32), the JAX package's executable specification of the grid:
``voxelize_batch_scatter`` reads ``(B, E, 4)`` events and ``(B,)`` counts
and computes each event's window, bin and two weights itself
(csrc/voxel_scatter.cu), where ``voxelize_batch`` computes ``(B, bins, E)``
weights in PyTorch first and hands them to K3.
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


def voxelize_batch_scatter_reference(events: torch.Tensor,
                                     counts: torch.Tensor, *, num_bins: int,
                                     height: int,
                                     width: int) -> torch.Tensor:
    """Plain PyTorch version of K8: ``_voxel_kernel``'s per-event arithmetic,
    each event's two weights summed with ``index_put_(accumulate=True)``."""
    b, e, _ = events.shape
    n = counts.to(device=events.device, dtype=torch.long)
    t = events[..., 2]
    t0 = t[:, 0]
    last = (n - 1).clamp(0, max(e - 1, 0))
    t1 = torch.gather(t, 1, last[:, None])[:, 0]
    delta_t = t1 - t0
    delta_t = torch.where(delta_t == 0, 1.0, delta_t)
    x = events[..., 0].to(torch.int32)
    y = events[..., 1].to(torch.int32)
    p = events[..., 3]
    p = torch.where(p == 0, -1.0, p)
    valid = torch.arange(e, device=events.device)[None] < n[:, None]
    in_frame = (x >= 0) & (x < width) & (y >= 0) & (y < height)
    ts = (num_bins - 1) * (t - t0[:, None]) / delta_t[:, None]
    tis = torch.floor(ts)
    dts = ts - tis
    ok = valid & in_frame & (tis >= 0)
    left_ok = ok & (tis < num_bins)
    right_ok = ok & (tis + 1 < num_bins)
    num_cells = height * width * num_bins
    base = (torch.arange(b, device=events.device)[:, None] * num_cells
            + (y.long() * width + x.long()) * num_bins
            + tis.clamp(0, num_bins).long())
    out = torch.zeros(b * num_cells, dtype=torch.float32,
                      device=events.device)
    idx = torch.cat([base[left_ok], base[right_ok] + 1])
    val = torch.cat([(p * (1.0 - dts))[left_ok], (p * dts)[right_ok]])
    out.index_put_((idx,), val.float(), accumulate=True)
    return out.view(b, height, width, num_bins)


def voxelize_batch_scatter(events: torch.Tensor, counts: torch.Tensor, *,
                           num_bins: int, height: int, width: int,
                           chunk: int = 512) -> torch.Tensor:
    """``(B, E, 4)`` xytp events, ``(B,)`` counts -> ``(B, H, W, num_bins)``
    f32 voxel grids, in one pass over the raw events (JAX's
    ``voxelize_batch_pallas``). The window runs from ``t[0]`` to
    ``t[max(count - 1, 0)]`` (a count past E reads ``t[E - 1]``).

    Keeps JAX's contract, ``height * width * num_bins % 128 == 0``
    (``ValueError`` where JAX asserts). CPU tensors take
    :func:`voxelize_batch_scatter_reference`. CUDA tensors launch the kernel
    or raise: ``events`` f32 contiguous, ``counts`` an integer tensor on the
    same card. ``chunk`` is the number of events each block of the kernel
    takes; it does not change the result. ``launches`` counts the CUDA
    calls.
    """
    num_cells = height * width * num_bins
    if num_cells % 128:
        raise ValueError(f"voxelize_batch_scatter: H*W*bins = {num_cells} "
                         "must tile into 128 lanes (a multiple of 128)")
    if events.ndim != 3 or events.shape[-1] != 4:
        raise ValueError(f"voxelize_batch_scatter: events must be (B, E, 4), "
                         f"got {tuple(events.shape)}")
    b, e, _ = events.shape
    if counts.shape != (b,):
        raise ValueError(f"voxelize_batch_scatter: counts must be ({b},)")
    if events.device.type == "cpu":
        return voxelize_batch_scatter_reference(
            events, counts, num_bins=num_bins, height=height, width=width)
    if chunk < 1:
        raise ValueError(f"voxelize_batch_scatter: chunk {chunk} < 1")
    if b > 65535:
        raise ValueError(f"voxelize_batch_scatter: batch {b} exceeds the "
                         "launch grid")
    if counts.is_floating_point() or counts.is_complex():
        raise TypeError(f"voxelize_batch_scatter: counts are {counts.dtype}, "
                        "expected an integer dtype")
    if counts.device != events.device:
        raise ValueError("voxelize_batch_scatter: events and counts on other "
                         "devices")
    check_cuda_operands("voxelize_batch_scatter", torch.float32,
                        events=events)
    counts = counts.to(torch.int32).contiguous()
    out = torch.zeros((b, height, width, num_bins), dtype=torch.float32,
                      device=events.device)
    lib = _build.load("voxel_scatter")
    with torch.cuda.device(events.device):
        code = lib.voxel_scatter_f32(
            events.data_ptr(), counts.data_ptr(), out.data_ptr(), b, e,
            height, width, num_bins, chunk,
            torch.cuda.current_stream(events.device).cuda_stream,
        )
    _build.check(lib, "voxel_scatter_f32", code)
    voxelize_batch_scatter.launches += 1
    return out


voxelize_batch_scatter.launches = 0
