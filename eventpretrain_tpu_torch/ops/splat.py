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
weights in PyTorch first and hands them to K3. Its one launch zeroes each
grid itself, a few samples ahead of that sample's adds, so the grids it
adds into stay in L2 (:func:`voxel_scatter_plan`, whose ticket order
:func:`voxel_scatter_item` models and :func:`voxel_scatter_launch_reference`
replays on the CPU).
"""

from __future__ import annotations

import ctypes
import dataclasses
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


def voxel_scatter_terms(events: torch.Tensor, counts: torch.Tensor, *,
                        num_bins: int, height: int, width: int):
    """``_voxel_kernel``'s per-event arithmetic over ``(B, E)``: each event's
    left index ``(y * W + x) * num_bins + floor(ts)`` in its sample's grid,
    its weights ``p * (1 - dts)`` and ``p * dts``, and whether each is
    added (the event one of its sample's count, in frame, its bin in
    ``[0, num_bins)``, and for the right weight the next bin too)."""
    e = events.shape[1]
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
    index = ((y.long() * width + x.long()) * num_bins
             + tis.clamp(0, num_bins).long())
    return index, p * (1.0 - dts), p * dts, left_ok, right_ok


def voxelize_batch_scatter_reference(events: torch.Tensor,
                                     counts: torch.Tensor, *, num_bins: int,
                                     height: int,
                                     width: int) -> torch.Tensor:
    """Plain PyTorch version of K8: ``_voxel_kernel``'s per-event arithmetic
    (:func:`voxel_scatter_terms`), each event's two weights summed with
    ``index_put_(accumulate=True)``."""
    b = events.shape[0]
    index, wl, wr, left_ok, right_ok = voxel_scatter_terms(
        events, counts, num_bins=num_bins, height=height, width=width)
    num_cells = height * width * num_bins
    base = (torch.arange(b, device=events.device)[:, None] * num_cells
            + index)
    out = torch.zeros(b * num_cells, dtype=torch.float32,
                      device=events.device)
    idx = torch.cat([base[left_ok], base[right_ok] + 1])
    val = torch.cat([wl[left_ok], wr[right_ok]])
    out.index_put_((idx,), val.float(), accumulate=True)
    return out.view(b, height, width, num_bins)


# csrc/voxel_scatter.cu: the floats a zero item writes (64 KB), and the
# events an add item takes by default (4 a thread of a 512-thread CTA)
ZERO_SPAN = 16384
SCATTER_CHUNK = 2048
# K8 keeps the grids open at once (zeroed, not yet finished, the in-flight
# tickets' counted) within a third of the L2: the knee measured at DSEC's
# shape on an H100 (graph-timed, one CTA an SM: 70.6 us with D + 1 + span
# = 3 grids of 5.6 MB open, 88.9 with 4, 103.5 with 5)
L2_SHARE = 3


@dataclass(frozen=True)
class ScatterPlan:
    """How csrc/voxel_scatter.cu walks a batch: ``zero_items`` spans of
    ``zero_span`` floats zero a sample's grid, ``add_items`` items of
    ``chunk`` events add its events; ``lookahead`` (D) samples are zeroed
    ahead of the one being added; ``ctas`` persistent CTAs take the
    ``tickets`` items in the order :func:`voxel_scatter_item` gives."""

    batch: int
    zero_span: int
    zero_items: int
    chunk: int
    add_items: int
    lookahead: int
    ctas: int

    @property
    def tickets(self) -> int:
        return self.batch * (self.zero_items + self.add_items)

    @property
    def open_grids(self) -> int:
        """The most grids zeroed and not finished at once, with ``ctas``
        tickets in flight: D + 1, and one more for each block of a
        sample's items the tickets in flight may reach into."""
        span = -(-(self.ctas - 1) // (self.zero_items + self.add_items))
        return min(self.batch, self.lookahead + 1 + span)


@functools.lru_cache(maxsize=None)
def voxel_scatter_plan(batch: int, height: int, width: int, bins: int,
                       events: int, *, chunk: int, l2_bytes: int,
                       sms: int) -> ScatterPlan:
    """K8's plan for ``batch`` grids of ``height x width x bins`` f32 from
    ``events`` slots a sample: one persistent CTA an SM (``sms``; at most
    one a ticket), and D, the most samples zeroed ahead that keep the open
    grids (:attr:`ScatterPlan.open_grids`) within ``l2_bytes /
    L2_SHARE``: 1 at DSEC's 5.6 MB grid on an H100, 45 at N-Cars' 0.33
    MB, the whole batch where all its grids fit; 0 where even that leaves
    none to spare. ``chunk`` sets the add items only."""
    cells = height * width * bins
    zero_items = -(-cells // ZERO_SPAN)
    add_items = -(-events // chunk)
    tickets = batch * (zero_items + add_items)
    plan = ScatterPlan(batch=batch, zero_span=ZERO_SPAN,
                       zero_items=zero_items, chunk=chunk,
                       add_items=add_items, lookahead=0,
                       ctas=max(1, min(sms, tickets)))
    grids = (l2_bytes // L2_SHARE) // (4 * cells)
    if batch > grids:
        # open_grids is D + 1 + span below the batch
        return dataclasses.replace(plan, lookahead=max(
            0, grids - plan.open_grids))
    return dataclasses.replace(plan, lookahead=batch)


def voxel_scatter_item(plan: ScatterPlan, ticket: int) -> tuple[str, int,
                                                                int]:
    """The item of ``ticket``, as the kernel computes it (``item_of``):
    ``("zero", s, i)``, the i-th span of sample s's grid, or ``("add", s,
    i)``, its events ``[i * chunk, (i + 1) * chunk)``. The zero items of
    samples 0 .. D-1 come first, then for each sample s the zero items of
    sample s + D and the add items of s."""
    d = min(plan.lookahead, plan.batch)
    z, a = plan.zero_items, plan.add_items
    if ticket < d * z:
        return "zero", ticket // z, ticket % z
    u = ticket - d * z
    paired = plan.batch - d
    if u < paired * (z + a):
        s, r = divmod(u, z + a)
        return ("zero", s + d, r) if r < z else ("add", s, r - z)
    s, i = divmod(u - paired * (z + a), a)
    return "add", paired + s, i


def voxel_scatter_ops(index: int, wl: float,
                      wr: float) -> list[tuple[int, tuple[float, ...]]]:
    """The reductions csrc/voxel_scatter.cu issues for one event whose left
    weight ``wl`` goes to float ``index`` of its sample's grid and right
    weight ``wr`` to ``index + 1`` (each 0.0 where it is not added): a list
    of (first float, lanes), one entry a ``red``. Both weights non-zero:
    one ``.v2`` at ``index`` where it is even, one ``.v4`` at ``index - 1``
    with +0.0 in lanes 0 and 3 where ``index % 4 == 1``, else two scalars.
    A zero weight is never added."""
    if wl != 0.0 and wr != 0.0:
        if index % 2 == 0:
            return [(index, (wl, wr))]
        if index % 4 == 1:
            return [(index - 1, (0.0, wl, wr, 0.0))]
        return [(index, (wl,)), (index + 1, (wr,))]
    if wl != 0.0:
        return [(index, (wl,))]
    if wr != 0.0:
        return [(index + 1, (wr,))]
    return []


def voxel_scatter_launch_reference(events: torch.Tensor,
                                   counts: torch.Tensor, out: torch.Tensor,
                                   *, num_bins: int, height: int, width: int,
                                   plan: ScatterPlan) -> torch.Tensor:
    """csrc/voxel_scatter.cu's walk replayed on the CPU, one item at a time
    in ticket order, into ``out`` as it is given (a grid of NaN shows a
    cell no item wrote): a zero item writes its span; an add item takes
    events ``[i * chunk, min(count, E, (i + 1) * chunk))`` of its sample and
    issues :func:`voxel_scatter_ops` of each, in event order. Raises if an
    add lands on a cell its sample's zero items have not written. For
    small inputs: it loops in Python."""
    b, e, _ = events.shape
    index, wl, wr, left_ok, right_ok = voxel_scatter_terms(
        events, counts, num_bins=num_bins, height=height, width=width)
    wl = torch.where(left_ok, wl, 0.0).float()
    wr = torch.where(right_ok, wr, 0.0).float()
    flat = out.view(b, -1)
    cells = flat.shape[1]
    zeroed = torch.zeros_like(flat, dtype=torch.bool)
    for ticket in range(plan.tickets):
        kind, s, i = voxel_scatter_item(plan, ticket)
        if kind == "zero":
            lo = i * plan.zero_span
            hi = min(lo + plan.zero_span, cells)
            flat[s, lo:hi] = 0.0
            zeroed[s, lo:hi] = True
            continue
        n = min(max(int(counts[s]), 0), e)
        for ev in range(i * plan.chunk, min(n, (i + 1) * plan.chunk)):
            for first, lanes in voxel_scatter_ops(
                    int(index[s, ev]), float(wl[s, ev]), float(wr[s, ev])):
                span = slice(first, first + len(lanes))
                if not bool(zeroed[s, span].all()):
                    raise RuntimeError(f"sample {s}: an add before its "
                                       "zero items")
                flat[s, span] += torch.tensor(lanes, dtype=flat.dtype)
    return out


@functools.lru_cache(maxsize=None)
def voxel_scatter_device(device: int) -> tuple[int, int, int]:
    """The card's L2 bytes, its SMs, and how many CTAs of
    csrc/voxel_scatter.cu an SM holds at once
    (cudaOccupancyMaxActiveBlocksPerMultiprocessor)."""
    lib = _build.load("voxel_scatter")
    per_sm = ctypes.c_int(0)
    with torch.cuda.device(device):
        code = lib.voxel_scatter_occupancy(ctypes.byref(per_sm))
    _build.check(lib, "voxel_scatter_occupancy", code)
    props = torch.cuda.get_device_properties(device)
    return props.L2_cache_size, props.multi_processor_count, per_sm.value


def voxelize_batch_scatter(events: torch.Tensor, counts: torch.Tensor, *,
                           num_bins: int, height: int, width: int,
                           chunk: int = SCATTER_CHUNK) -> torch.Tensor:
    """``(B, E, 4)`` xytp events, ``(B,)`` counts -> ``(B, H, W, num_bins)``
    f32 voxel grids, in one pass over the raw events (JAX's
    ``voxelize_batch_pallas``). The window runs from ``t[0]`` to
    ``t[max(count - 1, 0)]`` (a count past E reads ``t[E - 1]``).

    Keeps JAX's contract, ``height * width * num_bins % 128 == 0``
    (``ValueError`` where JAX asserts). CPU tensors take
    :func:`voxelize_batch_scatter_reference`. CUDA tensors launch the kernel
    or raise: ``events`` f32 contiguous, ``counts`` an integer tensor on the
    same card. The grid comes from ``torch.empty``: the kernel's one launch
    zeroes each sample's grid itself, a few samples ahead of the adds, so
    that the grids it adds into stay in L2 (:func:`voxel_scatter_plan`).
    ``chunk`` is the number of events each add item of the kernel takes; it
    does not change the result. ``launches`` counts the CUDA calls.
    """
    _check_scatter_shapes(events, counts, num_bins, height, width)
    if events.device.type == "cpu":
        return voxelize_batch_scatter_reference(
            events, counts, num_bins=num_bins, height=height, width=width)
    out = torch.empty((events.shape[0], height, width, num_bins),
                      dtype=torch.float32, device=events.device)
    return _voxel_scatter_into(events, counts, out, num_bins=num_bins,
                               height=height, width=width, chunk=chunk)


def _check_scatter_shapes(events, counts, num_bins, height, width) -> None:
    """JAX's grid contract and the operands' shapes, on every device."""
    num_cells = height * width * num_bins
    if num_cells % 128:
        raise ValueError(f"voxelize_batch_scatter: H*W*bins = {num_cells} "
                         "must tile into 128 lanes (a multiple of 128)")
    if events.ndim != 3 or events.shape[-1] != 4:
        raise ValueError(f"voxelize_batch_scatter: events must be (B, E, 4), "
                         f"got {tuple(events.shape)}")
    if counts.shape != (events.shape[0],):
        raise ValueError(f"voxelize_batch_scatter: counts must be "
                         f"({events.shape[0]},)")


def _voxel_scatter_into(events: torch.Tensor, counts: torch.Tensor,
                        out: torch.Tensor, *, num_bins: int, height: int,
                        width: int, chunk: int = SCATTER_CHUNK,
                        plan: Optional[ScatterPlan] = None) -> torch.Tensor:
    """K8's launch into ``out``, whatever it holds: the kernel writes every
    cell. ``plan`` replaces :func:`voxel_scatter_plan`'s (another
    look-ahead or CTA count, for timing them)."""
    _check_scatter_shapes(events, counts, num_bins, height, width)
    b, e, _ = events.shape
    if chunk < 1:
        raise ValueError(f"voxelize_batch_scatter: chunk {chunk} < 1")
    if counts.is_floating_point() or counts.is_complex():
        raise TypeError(f"voxelize_batch_scatter: counts are {counts.dtype}, "
                        "expected an integer dtype")
    if counts.device != events.device:
        raise ValueError("voxelize_batch_scatter: events and counts on other "
                         "devices")
    check_cuda_operands("voxelize_batch_scatter", torch.float32,
                        events=events, out=out)
    if out.shape != (b, height, width, num_bins):
        raise ValueError(f"voxelize_batch_scatter: out must be "
                         f"({b}, {height}, {width}, {num_bins})")
    if plan is None:
        l2_bytes, sms, _ = voxel_scatter_device(events.device.index)
        plan = voxel_scatter_plan(b, height, width, num_bins, e, chunk=chunk,
                                  l2_bytes=l2_bytes, sms=sms)
    if (plan.tickets >= 2**31 or height * width * num_bins >= 2**31
            or plan.batch != b or plan.zero_span % 4):
        raise ValueError(f"voxelize_batch_scatter: plan {plan} does not "
                         f"take a batch of {b} grids of {height}x{width}x"
                         f"{num_bins}")
    counts = counts.to(torch.int32).contiguous()
    work = torch.empty(b + 1, dtype=torch.int32, device=events.device)
    lib = _build.load("voxel_scatter")
    with torch.cuda.device(events.device):
        code = lib.voxel_scatter_f32(
            events.data_ptr(), counts.data_ptr(), out.data_ptr(),
            work.data_ptr(), b, e, height, width, num_bins, plan.zero_span,
            plan.zero_items, plan.chunk, plan.add_items, plan.lookahead,
            plan.ctas, _stream(events))
    _build.check(lib, "voxel_scatter_f32", code)
    voxelize_batch_scatter.launches += 1
    return out


voxelize_batch_scatter.launches = 0
