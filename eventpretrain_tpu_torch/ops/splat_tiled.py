"""K6 — the tiled splat behind the voxel grids of large sensors (DSEC).

Replaces eventpretrain_tpu/ops/pallas_voxel.py::splat_mxu_tiled (:403) and
``voxelize_batch_mxu_tiled`` (:494). The events arrive grouped by spatial
tile (``native.bucket_pack_event_batch``): slot ``e`` belongs to chunk
``e // chunk``, whose tile is ``tile_table[b, e // chunk]`` (nondecreasing
along the chunks). ``(B, C, E)`` f32 weights are summed at their integer
``(y, x)`` into ``(B, H, W, C)`` f32; an event whose coordinates lie
outside its chunk's tile, or past row ``H`` or column ``W``, adds nothing.
``bin_range (B, E // chunk, 2)`` optionally bounds, inclusively, the
channels a chunk can touch: channels outside it are skipped, not merely
zero, so the bounds must be conservative.

The TPU kernel splats each chunk into its tile's block with one-hot matrix
products, carrying the weights as a bf16 hi+lo pair (within ~1e-5 of
f32). The CUDA kernel (csrc/splat_tiled.cu, on the plane body of
csrc/splat_core.cuh that K3 shares) sums in exact f32: a thread-block
cluster per (sample, tile) holds the tile's plane in shared memory, its
channels cut over the CTAs (:func:`splat_tiled_plan`: DSEC's 128x128x5
tile in two CTAs of 3 and 2 channels, the 2-bin count image in one); each
CTA walks the tile's chunks, loads the weights of its channels inside each
chunk's bin range, adds each in-tile weight into its own shared memory,
and writes its share of the tile's rows once, whole rows gathered from the
CTAs, cropped. It is bound by the bytes it reads and writes and by its
shared-memory adds. :func:`splat_tiled_launch_reference` replays that
decomposition in PyTorch.

The tile geometry defaults come from ``eventpretrain_tpu_torch.native``,
the bucketer's module, so the two sides cannot disagree.
"""

from __future__ import annotations

from typing import Optional

import torch

from eventpretrain_tpu_torch import _build
from eventpretrain_tpu_torch.native import TILE_CHUNK, TILE_H, TILE_W
from eventpretrain_tpu_torch.ops.common import _stream, check_cuda_operands
from eventpretrain_tpu_torch.ops.events import bilinear_bin_weights_windowed
from eventpretrain_tpu_torch.ops.splat import (
    SplatPlan,
    splat_plan,
    write_rows,
)


def splat_tiled_plan(tile_h: int, tile_w: int, channels: int,
                     **pins) -> Optional[SplatPlan]:
    """K6's plan: a ``tile_h x tile_w`` plane of all the channels where a
    cluster holds it, else of the fewest channel groups that fit; None
    where not even one channel of a tile fits a CTA. ``pins`` go to
    :func:`splat_plan`."""
    return splat_plan(tile_h, tile_w, channels, max_groups=channels, **pins)


def _slot_tiles(tile_table: torch.Tensor, chunk: int) -> torch.Tensor:
    return tile_table.long().repeat_interleave(chunk, dim=1)  # (B, E)


def splat_tiled_reference(y: torch.Tensor, x: torch.Tensor,
                          weights: torch.Tensor, tile_table: torch.Tensor,
                          bin_range: Optional[torch.Tensor] = None, *,
                          height: int, width: int, tile_h: int = TILE_H,
                          tile_w: int = TILE_W,
                          chunk: int = TILE_CHUNK) -> torch.Tensor:
    """Plain PyTorch version of K6: ``index_put_(accumulate=True)`` of the
    events inside their chunk's tile (and the frame), each channel inside
    its chunk's bin range."""
    b, c, e = weights.shape
    tiles_x = -(-width // tile_w)
    tile = _slot_tiles(tile_table, chunk)
    ty0 = tile // tiles_x * tile_h
    tx0 = tile % tiles_x * tile_w
    yl, xl = y.long(), x.long()
    ok = ((yl >= ty0) & (yl < ty0 + tile_h) & (xl >= tx0)
          & (xl < tx0 + tile_w) & (yl < height) & (xl < width))
    w = weights.float()
    if bin_range is not None:
        br = bin_range.long().repeat_interleave(chunk, dim=1)  # (B, E, 2)
        ch = torch.arange(c, device=weights.device)[None, :, None]
        inside = (ch >= br[:, None, :, 0]) & (ch <= br[:, None, :, 1])
        w = torch.where(inside, w, 0.0)
    bi = torch.arange(b, device=weights.device)[:, None].expand(b, e)
    cell = (bi * height + yl) * width + xl
    out = torch.zeros((b * height * width, c), dtype=torch.float32,
                      device=weights.device)
    out.index_put_((cell[ok],), w.transpose(1, 2)[ok], accumulate=True)
    return out.view(b, height, width, c)


def splat_tiled_launch_reference(y: torch.Tensor, x: torch.Tensor,
                                 weights: torch.Tensor,
                                 tile_table: torch.Tensor,
                                 bin_range: Optional[torch.Tensor] = None, *,
                                 height: int, width: int, plan: SplatPlan,
                                 tile_h: int = TILE_H, tile_w: int = TILE_W,
                                 chunk: int = TILE_CHUNK) -> torch.Tensor:
    """The kernel's decomposition replayed in PyTorch: per (sample, tile,
    channel group) plane, the tile's chunks counted in the table; CTA ``r``
    of ``n`` walks them and adds each in-tile event's weights of its
    channels ``[r*cp, (r+1)*cp)`` of the group that lie inside the chunk's
    bin range into its own part; :func:`write_rows` writes the plane's
    cells from the parts, cropped to the grid."""
    b, c, e = weights.shape
    n, cp, groups = plan.cluster, plan.cp, plan.groups
    width_g = -(-c // groups)
    tiles_x = -(-width // tile_w)
    tiles = -(-height // tile_h) * tiles_x
    ch = torch.arange(c, device=weights.device)[:, None]
    out = torch.empty((b, height, width, c), dtype=torch.float32,
                      device=weights.device)
    for p in range(b * tiles * groups):
        grp, t, bi = p % groups, p // groups % tiles, p // (groups * tiles)
        lo = int((tile_table[bi] < t).sum()) * chunk
        hi = int((tile_table[bi] <= t).sum()) * chunk
        y0, x0 = t // tiles_x * tile_h, t % tiles_x * tile_w
        ylim, xlim = min(tile_h, height - y0), min(tile_w, width - x0)
        c0 = grp * width_g
        cph = min(width_g, c - c0)
        ly = y[bi, lo:hi].long() - y0
        lx = x[bi, lo:hi].long() - x0
        ok = (ly >= 0) & (ly < ylim) & (lx >= 0) & (lx < xlim)
        w = weights[bi, :, lo:hi].float()
        if bin_range is not None:
            br = bin_range[bi].long().repeat_interleave(chunk, 0)[lo:hi]
            w = torch.where((ch >= br[:, 0]) & (ch <= br[:, 1]), w, 0.0)
        parts = []
        for rank in range(n):
            mlo = c0 + rank * cp
            mhi = min(c0 + cph, mlo + cp)
            part = torch.zeros((tile_h, tile_w, max(mhi - mlo, 0)),
                               dtype=torch.float32, device=weights.device)
            part.index_put_((ly[ok], lx[ok]), w[mlo:mhi, ok].t(),
                            accumulate=True)
            parts.append(part)
        out[bi, y0:y0 + ylim, x0:x0 + xlim, c0:c0 + cph] = write_rows(
            parts, ylim, xlim)
    return out


def splat_tiled(y: torch.Tensor, x: torch.Tensor, weights: torch.Tensor,
                tile_table: torch.Tensor,
                bin_range: Optional[torch.Tensor] = None, *, height: int,
                width: int, tile_h: int = TILE_H, tile_w: int = TILE_W,
                chunk: int = TILE_CHUNK) -> torch.Tensor:
    """Sum ``(B, C, E)`` weights of tile-bucketed events at int32
    ``y, x (B, E)`` into ``(B, H, W, C)``.

    CPU tensors take :func:`splat_tiled_reference`. CUDA tensors launch the
    kernel or raise: ``y``, ``x``, ``tile_table (B, E // chunk)`` and
    ``bin_range (B, E // chunk, 2)`` int32, ``weights`` f32, contiguous;
    ``E`` a multiple of ``chunk``; a tile that :func:`splat_tiled_plan`
    fits.
    """
    if weights.ndim != 3:
        raise ValueError(f"splat_tiled: weights must be (B, C, E), "
                         f"got {tuple(weights.shape)}")
    b, c, e = weights.shape
    if e % chunk:
        raise ValueError(f"splat_tiled: E={e} is not a multiple of the "
                         f"chunk {chunk} (the bucketed layout)")
    if y.shape != (b, e) or x.shape != (b, e):
        raise ValueError(f"splat_tiled: y, x must be ({b}, {e})")
    if tile_table.shape != (b, e // chunk):
        raise ValueError(f"splat_tiled: tile_table must be "
                         f"({b}, {e // chunk}), got {tuple(tile_table.shape)}")
    if bin_range is not None and bin_range.shape != (b, e // chunk, 2):
        raise ValueError(f"splat_tiled: bin_range must be "
                         f"({b}, {e // chunk}, 2), got "
                         f"{tuple(bin_range.shape)}")
    if weights.device.type == "cpu":
        return splat_tiled_reference(
            y, x, weights, tile_table, bin_range, height=height, width=width,
            tile_h=tile_h, tile_w=tile_w, chunk=chunk)
    plan = splat_tiled_plan(tile_h, tile_w, max(c, 1))
    if plan is None:
        raise ValueError(f"splat_tiled: a {tile_h}x{tile_w} f32 tile does "
                         "not fit in a cluster's shared memory")
    planes = b * -(-height // tile_h) * -(-width // tile_w) * plan.groups
    if planes * plan.cluster >= 2**31:
        raise ValueError(f"splat_tiled: {planes} planes exceed the launch "
                         "grid")
    ints = dict(y=y, x=x, tile_table=tile_table)
    if bin_range is not None:
        ints["bin_range"] = bin_range
    check_cuda_operands("splat_tiled", torch.int32, **ints)
    check_cuda_operands("splat_tiled", torch.float32, weights=weights)
    if y.device != weights.device:
        raise ValueError("splat_tiled: coordinates and weights on other "
                         "devices")
    out = torch.empty((b, height, width, c), dtype=torch.float32,
                      device=weights.device)
    if out.numel() == 0:
        return out
    lib = _build.load("splat_tiled")
    with torch.cuda.device(weights.device):
        code = lib.splat_tiled_cluster_f32(
            y.data_ptr(), x.data_ptr(), weights.data_ptr(),
            tile_table.data_ptr(),
            None if bin_range is None else bin_range.data_ptr(),
            out.data_ptr(), b, c, e, chunk, height, width, tile_h, tile_w,
            plan.cluster, plan.cp, plan.groups, plan.smem_bytes,
            _stream(weights))
    _build.check(lib, "splat_tiled_cluster_f32", code)
    splat_tiled.launches += 1
    return out


splat_tiled.launches = 0


def chunk_bin_range(t_range: torch.Tensor, chunk_trange: torch.Tensor,
                    num_bins: int) -> torch.Tensor:
    """``(B, NC, 2)`` int32 inclusive bin bounds of each chunk from its time
    span (pallas_voxel.py:527-546). The bounds come from the f32
    timestamps but the bins from the codec-decoded ones, so the slack
    covers the u32 codec's t quantisation (``(num_bins - 1) / 2046`` bins)
    plus f32 noise."""
    t0 = t_range[:, 0:1, None]
    dt = t_range[:, 1:2, None] - t0
    dt = torch.where(dt == 0, 1.0, dt)
    ts = (num_bins - 1) * (chunk_trange - t0) / dt  # (B, NC, 2)
    slack = 0.01 + (num_bins - 1) / 2046.0
    bmin = torch.clamp(torch.floor(ts[..., 0] - slack), 0, num_bins - 1)
    bmax = torch.clamp(torch.floor(ts[..., 1] + slack) + 1, 0, num_bins - 1)
    return torch.stack([bmin, bmax], dim=-1).to(torch.int32)


def voxelize_batch_tiled(events: torch.Tensor, tile_table: torch.Tensor,
                         t_range: torch.Tensor,
                         chunk_trange: Optional[torch.Tensor] = None, *,
                         num_bins: int, height: int, width: int,
                         tile_h: int = TILE_H, tile_w: int = TILE_W,
                         chunk: int = TILE_CHUNK) -> torch.Tensor:
    """``(B, E, 4)`` tile-bucketed xytp, ``tile_table (B, E // chunk)``,
    ``t_range (B, 2)`` -> ``(B, H, W, num_bins)`` voxel grids.

    Validity comes from the coordinates (pads carry out-of-frame
    sentinels), the time window is explicit (bucketing broke time order),
    and ``chunk_trange (B, E // chunk, 2)`` lets the kernel skip the bins a
    chunk cannot touch. Plain-PyTorch bin weights, then
    :func:`splat_tiled`.
    """
    x = events[..., 0].to(torch.int32).contiguous()
    y = events[..., 1].to(torch.int32).contiguous()
    valid = (x >= 0) & (x < width) & (y >= 0) & (y < height)
    wb = bilinear_bin_weights_windowed(events, valid, t_range[:, 0],
                                       t_range[:, 1], num_bins)
    wb = wb.transpose(1, 2).contiguous()  # (B, NB, E)
    bin_range = (None if chunk_trange is None
                 else chunk_bin_range(t_range, chunk_trange, num_bins))
    return splat_tiled(y, x, wb, tile_table.to(torch.int32).contiguous(),
                       bin_range, height=height, width=width, tile_h=tile_h,
                       tile_w=tile_w, chunk=chunk)
