"""K8's launch plan, ticket order and vector-add selection on the CPU.

K8 (``ops/splat.py::voxelize_batch_scatter``, ``csrc/voxel_scatter.cu``) is
one persistent launch whose CTAs take zero items and add items in ticket
order. The plan (``voxel_scatter_plan``) and the order
(``voxel_scatter_item``, the kernel's ``item_of`` arithmetic) are plain
Python, and so is the choice of reductions an event issues
(``voxel_scatter_ops``). ``voxel_scatter_launch_reference`` replays the
walk item by item into a grid of NaN; it is held against the JAX package's
``voxelize_batch_pallas`` with ``pallas_call`` patched to interpret, as
the JAX package's own tests run it off a TPU.
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import eventpretrain_tpu.ops.pallas_voxel as jpv
from eventpretrain_tpu_torch.ops.splat import (
    L2_SHARE,
    SCATTER_CHUNK,
    ZERO_SPAN,
    _voxel_scatter_into,
    voxel_scatter_item,
    voxel_scatter_launch_reference,
    voxel_scatter_ops,
    voxel_scatter_plan,
    voxelize_batch_scatter,
    voxelize_batch_scatter_reference,
)

from tests._port_threads import one_torch_thread  # noqa: F401

H100_L2 = 50 * 2**20  # torch.cuda.get_device_properties().L2_cache_size
H100_SMS = 132
# the sequential scatter on both sides, the same f32 weights; the adds run
# in another order
K8_ATOL = 1e-5

# (batch, H, W, bins, events, chunk, l2_bytes, SMs): DSEC's and N-Cars'
# shapes on the H100, and small grids under every look-ahead
PLAN_CASES = [
    (16, 440, 640, 5, 200_000, SCATTER_CHUNK, H100_L2, H100_SMS),
    (64, 128, 128, 5, 30_000, SCATTER_CHUNK, H100_L2, H100_SMS),
    (5, 64, 80, 5, 1000, 300, 0, 7),                 # D = 0: a grid > budget
    (6, 64, 80, 5, 1000, 256, 3 * 3 * 102400, 3),    # D = 1
    (8, 128, 128, 4, 999, 1000, 3 * 7 * 262144, 3),  # D = 5
    (4, 16, 16, 2, 300, 64, 3 * 4 * 2048, 40),       # the batch fits: D = 4
    (3, 16, 16, 2, 0, 64, H100_L2, 4),               # no events at all
]
LOOKAHEADS = [1, 45, 0, 1, 5, 4, 3]


def _grid_bytes(h, w, bins):
    return 4 * h * w * bins


def _walk(plan):
    return [voxel_scatter_item(plan, t) for t in range(plan.tickets)]


def _plan(case):
    batch, h, w, bins, events, chunk, l2, sms = case
    return voxel_scatter_plan(batch, h, w, bins, events, chunk=chunk,
                              l2_bytes=l2, sms=sms)


def test_plan_at_the_main_shapes():
    dsec, ncars = _plan(PLAN_CASES[0]), _plan(PLAN_CASES[1])
    # DSEC: 5.6 MB grids, 3 open (D + 1, and one more the 132 tickets in
    # flight reach) within a third of the L2
    assert (dsec.zero_items, dsec.add_items, dsec.lookahead) == (86, 98, 1)
    assert dsec.zero_span == ZERO_SPAN and dsec.ctas == H100_SMS
    assert dsec.open_grids == 3
    # N-Cars: 0.33 MB grids, the tickets in flight reach 7 samples' blocks
    assert (ncars.zero_items, ncars.add_items, ncars.lookahead) == (5, 15, 45)
    assert ncars.ctas == H100_SMS and ncars.open_grids == 53
    # fewer tickets than SMs: one CTA a ticket
    small = voxel_scatter_plan(2, 16, 16, 2, 100, chunk=64, l2_bytes=H100_L2,
                               sms=1000)
    assert small.ctas == small.tickets == 2 * (1 + 2)
    assert [_plan(c).lookahead for c in PLAN_CASES] == LOOKAHEADS


@pytest.mark.parametrize("case", PLAN_CASES)
def test_ticket_order_takes_every_item_once(case):
    batch, h, w, bins, events = case[:5]
    plan = _plan(case)
    items = _walk(plan)
    want = ({("zero", s, i) for s in range(batch)
             for i in range(plan.zero_items)}
            | {("add", s, i) for s in range(batch)
               for i in range(plan.add_items)})
    assert len(items) == len(set(items)) == len(want) and set(items) == want
    # the order written out: zero items of samples 0 .. D-1, then per
    # sample s the zero items of s + D and the add items of s
    d = plan.lookahead
    order = [("zero", s, i) for s in range(min(d, batch))
             for i in range(plan.zero_items)]
    for s in range(batch):
        if s + d < batch:
            order += [("zero", s + d, i) for i in range(plan.zero_items)]
        order += [("add", s, i) for i in range(plan.add_items)]
    assert items == order


@pytest.mark.parametrize("case", PLAN_CASES)
def test_zero_items_come_first_and_stay_within_the_l2_budget(case):
    """Each sample's zero items all come before its first add item; with
    the ``ctas`` newest tickets in flight, the grids zeroed and not yet
    finished never outnumber ``open_grids``, which stays within a third of
    the L2 wherever the plan zeroes ahead at all."""
    batch, h, w, bins, events, chunk, l2, _ = case
    plan = _plan(case)
    items = _walk(plan)
    first_zero, last_zero, first_add, last = {}, {}, {}, {}
    for t, (kind, s, _) in enumerate(items):
        if kind == "zero":
            first_zero.setdefault(s, t)
            last_zero[s] = t
        else:
            first_add.setdefault(s, t)
        last[s] = t
    for s in range(batch):
        assert last_zero[s] < first_add.get(s, len(items))
    most = max(sum(first_zero[s] <= t and last[s] > t - plan.ctas
                   for s in range(batch)) for t in range(len(items)))
    assert most <= plan.open_grids
    budget = (l2 // L2_SHARE) // _grid_bytes(h, w, bins)
    if plan.lookahead:
        assert plan.open_grids <= budget
    # the most samples the budget allows: one more zeroed ahead is over it
    if 0 < plan.lookahead < batch:
        ahead = dataclasses.replace(plan, lookahead=plan.lookahead + 1)
        assert ahead.open_grids > budget


def _covers_once(spans, length):
    """The half-open spans, clipped to ``length``, cover [0, length) once."""
    at = 0
    for lo, hi in sorted((lo, min(hi, length)) for lo, hi in spans):
        if lo != at or hi <= lo:
            return False
        at = hi
    return at == length


@pytest.mark.parametrize("case", PLAN_CASES)
def test_zero_items_tile_each_grid_and_add_items_each_sample(case):
    batch, h, w, bins, events = case[:5]
    plan = _plan(case)
    cells = h * w * bins
    zeroed = {s: [] for s in range(batch)}
    added = {s: [] for s in range(batch)}
    for kind, s, i in _walk(plan):
        if kind == "zero":
            zeroed[s].append((i * plan.zero_span, (i + 1) * plan.zero_span))
        else:
            added[s].append((i * plan.chunk, (i + 1) * plan.chunk))
    for s in range(batch):
        # every float of the grid by one zero item, every event slot (so
        # every event below any count) by one add item
        assert _covers_once(zeroed[s], cells)
        assert _covers_once(added[s], events) or (events == 0
                                                  and not added[s])
    # the zero items' 16-byte stores: every span starts 16-byte aligned
    assert plan.zero_span % 4 == 0 and cells % 4 == 0


def _events(rng, b, e, h, w):
    """Fractional xytp events from 2 before to 2 past the grid (strays,
    negative fractions that truncate to 0), sorted t, polarity {0, 1}."""
    return np.stack([
        rng.uniform(-2, w + 2, (b, e)),
        rng.uniform(-2, h + 2, (b, e)),
        np.sort(rng.uniform(0, 1, (b, e)), axis=1),
        rng.integers(0, 2, (b, e)).astype(np.float64),
    ], axis=-1).astype(np.float32)


@pytest.fixture
def interpret_pallas(monkeypatch):
    orig = jpv.pl.pallas_call

    def patched(*args, **kwargs):
        kwargs.setdefault("interpret", True)
        return orig(*args, **kwargs)

    monkeypatch.setattr(jpv.pl, "pallas_call", patched)


@pytest.mark.parametrize("l2_bytes", [0, 3 * 3 * 2048, 2**30])
def test_launch_replay_into_nan_matches_jax_pallas(interpret_pallas,
                                                   l2_bytes):
    """The walk, replayed into a grid of NaN under look-aheads 0, 1 and the
    whole batch, writes every cell and gives JAX's grids; a count of 0
    gives an all-zero grid."""
    h, w, bins, e = 8, 16, 4, 256
    rng = np.random.default_rng(l2_bytes % 97)
    ev = _events(rng, 4, e, h, w)
    counts = np.array([e, 0, 1, 200], np.int32)
    want = jpv.voxelize_batch_pallas.__wrapped__(
        jnp.asarray(ev), jnp.asarray(counts), num_bins=bins, height=h,
        width=w, chunk=128)
    plan = voxel_scatter_plan(4, h, w, bins, e, chunk=100,
                              l2_bytes=l2_bytes, sms=5)
    assert plan.lookahead == {0: 0, 3 * 3 * 2048: 1, 2**30: 4}[l2_bytes]
    out = torch.full((4, h, w, bins), float("nan"))
    got = voxel_scatter_launch_reference(
        torch.from_numpy(ev), torch.from_numpy(counts), out, num_bins=bins,
        height=h, width=w, plan=plan)
    assert not torch.isnan(got).any()
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=K8_ATOL)
    assert float(got[1].abs().max()) == 0.0


def test_chunk_changes_only_the_add_items_not_the_grid():
    """``chunk`` sizes the add items alone: the zero items, the look-ahead
    and the grid the walk gives (each cell's adds in event order, bit for
    bit) are the same for every chunk, and equal the plain version's; a
    count past E reads t[E - 1]."""
    h, w, bins, e = 8, 16, 5, 200
    rng = np.random.default_rng(5)
    ev = torch.from_numpy(_events(rng, 3, e, h, w))
    counts = torch.tensor([e + 50, 0, 131], dtype=torch.int32)
    kw = dict(num_bins=bins, height=h, width=w)
    ref = voxelize_batch_scatter_reference(ev, counts, **kw)
    grids, plans = [], []
    for chunk in (1, 7, 64, 199, 200, 4096):
        plan = voxel_scatter_plan(3, h, w, bins, e, chunk=chunk,
                                  l2_bytes=3 * 2 * 4 * h * w * bins,
                                  sms=10**6)
        plans.append(plan)
        grids.append(voxel_scatter_launch_reference(
            ev, counts, torch.full((3, h, w, bins), float("nan")), **kw,
            plan=plan))
    for plan, grid in zip(plans, grids):
        assert plan.add_items == -(-e // plan.chunk)
        assert dataclasses.replace(
            plan, chunk=0, add_items=0, ctas=0) == dataclasses.replace(
            plans[0], chunk=0, add_items=0, ctas=0)
        assert torch.equal(grid, grids[0])
    np.testing.assert_allclose(grids[0].numpy(), ref.numpy(), atol=K8_ATOL)
    assert float(grids[0][1].abs().max()) == 0.0


def _scalar_adds(index, wl, wr):
    """The scalar path: each non-zero weight at its float."""
    return [(i, v) for i, v in ((index, wl), (index + 1, wr)) if v != 0.0]


@pytest.mark.parametrize("bins", [2, 4, 5, 9])
def test_vector_adds_give_the_scalar_adds_lane_for_lane(bins):
    """Every residue of ``(cell * bins + k) % 4`` with each weight non-zero,
    zero or -0.0: the reductions' lanes, laid on the grid, add exactly the
    scalar path's weights at its floats, and +0.0 everywhere else; a
    ``.v2`` starts 8-byte aligned and a ``.v4`` 16-byte aligned."""
    seen = set()
    for cell in range(8):
        for k in range(bins):
            index = cell * bins + k
            right = k + 1 < bins
            for wl in (0.75, -0.25, 0.0, -0.0):
                for wr in ((0.5, -1.5, 0.0, -0.0) if right else (0.0,)):
                    ops = voxel_scatter_ops(index, wl, wr)
                    lanes = np.zeros(index + 6, np.float64)
                    touched = np.zeros(index + 6, np.int64)
                    for first, vals in ops:
                        assert len(vals) in (1, 2, 4)
                        assert first % len(vals) == 0 or len(vals) == 1
                        lanes[first:first + len(vals)] += vals
                        touched[first:first + len(vals)] += 1
                        for j, v in enumerate(vals):
                            if first + j not in (index, index + 1):
                                # padding lanes are +0.0, never -0.0
                                assert v == 0.0 and not np.signbit(v)
                    want = np.zeros_like(lanes)
                    for i, v in _scalar_adds(index, wl, wr):
                        want[i] += v
                    np.testing.assert_array_equal(lanes, want)
                    # each float at most once; a zero weight never alone
                    assert touched.max() <= 1
                    assert all(any(v != 0.0 for v in vals)
                               for _, vals in ops)
                    if wl != 0.0 and wr != 0.0:
                        width = {0: 2, 1: 4, 2: 2, 3: 1}[index % 4]
                        assert [len(v) for _, v in ops] == (
                            [width] if width > 1 else [1, 1])
                        seen.add(index % 4)
    assert seen == {(c * bins + k) % 4 for c in range(8)
                    for k in range(bins - 1)}


def test_the_vector_reductions_at_dsec_shape_cut_the_operations():
    """At DSEC's 440x640x5 grid, events whose two weights are non-zero
    issue 1.25 reductions on average over the residues (v2 at 0 and 2, v4
    at 1, two scalars at 3), against 2 scalars each."""
    h, w, bins = 440, 640, 5
    rng = np.random.default_rng(0)
    cells = rng.integers(0, h * w, 20000)
    k = rng.integers(0, bins - 1, 20000)
    ops = sum(len(voxel_scatter_ops(int(c * bins + b), 0.5, 0.5))
              for c, b in zip(cells, k))
    assert abs(ops / 20000 - 1.25) < 0.02


def test_into_entry_never_falls_back_off_cuda():
    """The internal entry that takes the output has no CPU path: CPU or
    meta tensors raise, and nothing is counted."""
    before = voxelize_batch_scatter.launches
    kw = dict(num_bins=5, height=16, width=16)
    for dev in ("cpu", "meta"):
        ev = torch.zeros((2, 8, 4), device=dev)
        counts = torch.zeros(2, dtype=torch.int32, device=dev)
        out = torch.empty((2, 16, 16, 5), device=dev)
        with pytest.raises(ValueError, match="expected cuda"):
            _voxel_scatter_into(ev, counts, out, **kw)
    with pytest.raises(ValueError, match="multiple of 128"):
        _voxel_scatter_into(torch.zeros((1, 4, 4)), torch.zeros(1),
                            torch.empty((1, 10, 10, 5)), num_bins=5,
                            height=10, width=10)
    assert voxelize_batch_scatter.launches == before
