"""K3 — the per-event splat behind the voxel grid — and K8, the per-event
scatter voxelizer that computes the same grids from the raw events in one
pass.

Replaces eventpretrain_tpu/ops/pallas_voxel.py::splat_mxu (+
``voxelize_batch_mxu``): ``(B, C, E)`` f32 weights summed at integer
``(y, x)`` into ``(B, H, W, C)`` f32 grids; out-of-frame events add
nothing, and weights of rows past ``count`` are already 0.

The TPU kernel runs the scatter as one-hot matrix products on the MXU,
because the TPU has no scatter unit, carrying the f32 weights as a bf16
hi+lo split. Here the scatter runs by one of two routes (csrc/splat.cu),
which :func:`splat_route` picks from the batch's shape alone: "cluster"
where a sample's grid fits the shared memory of a thread-block cluster of
at most 8 CTAs, its channels cut over them (:func:`splat_plan`; the N-Cars
canvas, 128x128x5, takes two CTAs of 3 and 2 channels), and the batch's
clusters fill most of the card's SMs: the plane body of csrc/splat_core.cuh, shared
with K6, which sums in shared memory and writes each cell once, so the
output needs no zero fill; "global" for larger grids (DSEC's or MVSEC's
untiled) and small batches: one thread per (sample, event) and a global
``atomicAdd`` per nonzero channel into a zeroed grid. Both are exact f32
up to the order of the additions.
:func:`splat_launch_reference` replays the cluster route's decomposition
(each CTA's channels, the rows each writes) in PyTorch.

K8 replaces ``voxelize_batch_pallas`` (pallas_voxel.py:97, ``_voxel_kernel``
:32), the JAX package's executable specification of the grid:
``voxelize_batch_scatter`` reads ``(B, E, 4)`` events and ``(B,)`` counts
and computes each event's window, bin and two weights itself
(csrc/voxel_scatter.cu), where ``voxelize_batch`` computes ``(B, bins, E)``
weights in PyTorch first and hands them to K3.
"""

from __future__ import annotations

import ctypes
import functools
from dataclasses import dataclass
from typing import Optional

import torch

from eventpretrain_tpu_torch import _build
from eventpretrain_tpu_torch.ops.common import _stream, check_cuda_operands
from eventpretrain_tpu_torch.ops.events import bilinear_bin_weights

# csrc/splat_core.cuh: the shared memory one CTA may use; a cluster holds
# at most 8 CTAs (the portable limit)
SMEM_LIMIT = 232448
MAX_CLUSTER = 8
MAX_CTA_CHANNELS = 4  # kChans: the weights of a group a thread holds
# K3 takes the cluster route from 80 CTAs up (B >= 40 at the N-Cars canvas)
CLUSTER_ROUTE_MIN_CTAS = 80


@dataclass(frozen=True)
class SplatPlan:
    """How csrc/splat_core.cuh lays a plane over a cluster: ``cluster``
    CTAs, each holding ``cp`` channels of every cell of the plane in
    ``smem_bytes`` of shared memory (with the map of an output row where
    it fits); ``groups`` planes cover a tile's channels (K6; K3 has
    one)."""

    cluster: int
    cp: int
    groups: int
    smem_bytes: int


def splat_smem_bytes(rows: int, cols: int, cp: int,
                     row_map: int = 0) -> int:
    """A CTA's shared memory: ``cp`` f32 channels of ``rows x cols`` cells,
    rounded up to 16 bytes, then ``row_map`` words (the kernel's map of an
    output row, one word a float of it, where there is room)."""
    return 4 * (-(-rows * cols * cp // 4) * 4 + row_map)


@functools.lru_cache(maxsize=None)
def splat_plan(rows: int, cols: int, channels: int, *, max_groups: int = 1,
               cluster: Optional[int] = None) -> Optional[SplatPlan]:
    """The plan of a ``rows x cols x channels`` plane, or None where none
    fits: the fewest channel groups (at most ``max_groups``, each of
    ceil(channels / groups) channels), then the smallest cluster whose CTAs
    hold ceil(group / n) channels each, at most ``MAX_CTA_CHANNELS`` and
    within ``SMEM_LIMIT``, every CTA holding at least one; with one group,
    room for the map of an output row too where it fits. ``cluster`` pins
    the cluster's size."""
    if min(rows, cols, channels) < 1:
        return None
    for groups in range(1, min(max_groups, channels) + 1):
        width = -(-channels // groups)
        if -(-channels // width) != groups:
            continue
        for n in ((cluster,) if cluster else range(1, MAX_CLUSTER + 1)):
            cp = -(-width // n)
            if -(-width // cp) != n or cp > MAX_CTA_CHANNELS:
                continue
            smem = splat_smem_bytes(rows, cols, cp)
            if smem <= SMEM_LIMIT:
                mapped = splat_smem_bytes(rows, cols, cp, cols * channels)
                if groups == 1 and mapped <= SMEM_LIMIT:
                    smem = mapped
                return SplatPlan(n, cp, groups, smem)
    return None


def splat_route(batch: int, height: int, width: int, channels: int) -> str:
    """K3's route for ``batch`` grids of ``height x width x channels``:
    "cluster" where a sample's grid fits a cluster's shared memory and the
    batch's clusters hold at least ``CLUSTER_ROUTE_MIN_CTAS`` CTAs, else
    "global". A cluster runs its sample's events through two SMs at most,
    so a small batch leaves the card idle: at the N-Cars canvas the global
    route took 8.5 µs at B=8 against the cluster route's 27.0, 23.1
    against 28.0 at B=32, and 56.8 against 38.4 at B=64 (graph-timed, H100
    80GB HBM3 at 700 W, tools/compare_splat.py --variants)."""
    plan = splat_plan(height, width, channels)
    if plan is None or batch * plan.cluster < CLUSTER_ROUTE_MIN_CTAS:
        return "global"
    return "cluster"


@functools.lru_cache(maxsize=None)
def max_active_clusters(lib_name: str, cluster: int, smem: int,
                        device: int) -> int:
    """How many clusters of ``cluster`` CTAs with ``smem`` bytes each the
    card holds at once (cudaOccupancyMaxActiveClusters of the plane body
    in ``lib<lib_name>.so``)."""
    lib = _build.load(lib_name)
    fn = f"{lib_name}_cluster_occupancy"
    out = ctypes.c_int(0)
    with torch.cuda.device(device):
        code = getattr(lib, fn)(cluster, smem, ctypes.byref(out))
    _build.check(lib, fn, code)
    return out.value


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


def write_rows(parts: list, rows: int, cols: int) -> torch.Tensor:
    """A plane's cells, cropped to ``rows x cols``, as the kernel writes
    them: CTA ``r`` of ``n`` writes rows [r*h, (r+1)*h), h = ceil(rows /
    n), each cell's channels read from the parts that hold them (part ``q``
    holds channels [q*cp, (q+1)*cp), the last perhaps fewer)."""
    n = len(parts)
    h = -(-rows // n)
    return torch.cat([torch.cat([q[r * h:min(rows, (r + 1) * h), :cols]
                                 for q in parts], dim=-1)
                      for r in range(n)], dim=0)


def splat_launch_reference(y: torch.Tensor, x: torch.Tensor,
                           weights: torch.Tensor, *, height: int,
                           width: int, plan: SplatPlan) -> torch.Tensor:
    """The cluster route's decomposition replayed in PyTorch: per sample,
    CTA ``r`` of ``n`` sums every in-frame event's weights of its channels
    ``[r*cp, (r+1)*cp)`` into its own part; :func:`write_rows` writes the
    sample's grid from the parts."""
    b, c, e = weights.shape
    out = torch.empty((b, height, width, c), dtype=torch.float32,
                      device=weights.device)
    ok = (y >= 0) & (y < height) & (x >= 0) & (x < width)
    for p in range(b):
        parts = []
        for rank in range(plan.cluster):
            lo, hi = rank * plan.cp, min(c, (rank + 1) * plan.cp)
            part = torch.zeros((height, width, plan.cp), dtype=torch.float32,
                               device=weights.device)
            k = ok[p]
            part[..., :hi - lo].index_put_(
                (y[p][k].long(), x[p][k].long()),
                weights[p, lo:hi][:, k].t().float(), accumulate=True)
            parts.append(part[..., :hi - lo])
        out[p] = write_rows(parts, height, width)
    return out


def splat(y: torch.Tensor, x: torch.Tensor, weights: torch.Tensor, *,
          height: int, width: int) -> torch.Tensor:
    """Scatter ``(B, C, E)`` weights at int32 ``y, x (B, E)`` into
    ``(B, H, W, C)``.

    CPU tensors take :func:`splat_reference`. CUDA tensors launch the
    kernel of :func:`splat_route`'s route or raise: ``y``, ``x`` int32 and
    ``weights`` f32, contiguous. ``launches`` counts the CUDA calls,
    ``launches_by_route`` by route.
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
    route = splat_route(b, height, width, c)
    lib = _build.load("splat")
    dev = weights.device
    with torch.cuda.device(dev):
        if route == "cluster":
            plan = splat_plan(height, width, c)
            out = torch.empty((b, height, width, c), dtype=torch.float32,
                              device=dev)
            fn = "splat_cluster_f32"
            code = lib.splat_cluster_f32(
                y.data_ptr(), x.data_ptr(), weights.data_ptr(),
                out.data_ptr(), b, c, e, height, width, plan.cluster,
                plan.cp, plan.smem_bytes, _stream(weights))
        else:
            out = torch.zeros((b, height, width, c), dtype=torch.float32,
                              device=dev)
            fn = "splat_f32"
            code = lib.splat_f32(
                y.data_ptr(), x.data_ptr(), weights.data_ptr(),
                out.data_ptr(), b, c, e, height, width, _stream(weights))
    _build.check(lib, fn, code)
    splat.launches += 1
    splat.launches_by_route[route] += 1
    return out


splat.launches = 0
splat.launches_by_route = {"cluster": 0, "global": 0}


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
