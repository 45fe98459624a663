"""Host-side planning for the sparse (GreenMIM-style) Swin backbone.

A copy of eventpretrain_tpu/models/swin_plan.py (numpy only), whose one code
change is the import of the C++ knapsack: ``group_windows`` takes the
port's ``native.group_windows_native``. Every plan array equals the JAX
package's integer for integer (tests/test_torch_port_swin.py).

The reference (model/sub_module/swin_block.py:280-464) builds its grouping
structures on device per forward: window ids from visible-token coordinates,
knapsack DP packing of variable-occupancy windows into fixed-size groups,
shuffle/unshuffle index tensors, attention masks and relative-position
indices. None of that is tensor math — it is integer planning — so it
belongs on the host: these functions produce static-shape numpy index plans
(one per stage x shift parity) that the model consumes. The mask is
shared across the batch (reference model/backbone/swin.py:158 uses
``mask[:1]``), so one plan per step suffices; plans are padded to bucketed
group counts so recompiles are rare; the dense path's plans are constants.

Parity notes:
  * masking-mode fallback when tokens <= 2*ws^2 (swin_block.py:444-450)
  * knapsack/group_windows ports the exact DP (swin_block.py:280-352)
  * group_size is fixed at ws^2 (the reference shrinks it to the max window
    occupancy, swin_block.py:410 — a shape optimization, not semantics)
  * PatchMerging child order [tl, bl, tr, br] for Swin checkpoint
    compatibility (swin_block.py:196-200)
"""

from __future__ import annotations

import dataclasses
import functools
from typing import NamedTuple, Optional, Sequence

import numpy as np


class GroupPlan(NamedTuple):
    """Static-shape grouping plan for one (stage, shift) parity.

    Carries only the compact per-slot data — group ids and coordinates;
    the (nG, GS, GS) additive attention mask and relative-position index
    tensors are derived on device once a step
    (models/swin.py::expand_plan). Shipping them precomputed cost ~2 MB of
    host->device transfer per training step (the masks are quadratic in
    group size); gid+coords are ~60 KB and the expansion fuses into the
    attention computation.
    """

    idx_shuffle: np.ndarray    # (nG*GS,) int32 gather into token axis
    idx_unshuffle: np.ndarray  # (N_vis,) int32 gather back from group slots
    gid: np.ndarray            # (nG, GS) int32 window id per slot, -1 = pad
    coords_g: np.ndarray       # (nG, GS, 2) int32 token coords per slot
    grouped: bool              # False => masking mode (no shuffle)


def knapsack(capacity: int, weights: Sequence[int]) -> tuple[int, list[int]]:
    """0/1 knapsack with value==weight (port of swin_block.py:280-323)."""
    n = len(weights)
    table = np.zeros((n + 1, capacity + 1), np.int64)
    for i in range(1, n + 1):
        w_i = weights[i - 1]
        table[i] = table[i - 1]
        if w_i <= capacity:
            cand = table[i - 1, : capacity - w_i + 1] + w_i
            np.maximum(table[i, w_i:], cand, out=table[i, w_i:])
    best = int(table[n, capacity])
    res, w = best, capacity
    idx = []
    for i in range(n, 0, -1):
        if res <= 0:
            break
        if res == table[i - 1][w]:
            continue
        idx.append(i - 1)
        res -= weights[i - 1]
        w -= weights[i - 1]
    return best, idx[::-1]


def _group_windows_numpy(group_size: int, occupancy: list[int]):
    wt = list(occupancy)
    ori_idx = list(range(len(wt)))
    grouped_idx, num_ele_group = [], []
    while wt:
        res, idx = knapsack(group_size, wt)
        num_ele_group.append(res)
        grouped_idx.append([ori_idx[i] for i in idx])
        keep = [i for i in range(len(ori_idx)) if i not in idx]
        wt = [wt[i] for i in keep]
        ori_idx = [ori_idx[i] for i in keep]
    return num_ele_group, grouped_idx


def group_windows(group_size: int, occupancy: list[int]):
    """Greedy knapsack packing (port of swin_block.py:326-352).

    Dispatches to the native C++ DP (native/event_pack.cpp::
    group_windows_native) when available — the planner runs every pretrain
    step on the prefetch thread and the Python DP held the GIL for most of
    the ~23 ms of planning; selection/tie-breaking are identical (pinned by
    tests/test_native_pack.py).
    """
    from eventpretrain_tpu_torch.native import group_windows_native

    if len(occupancy) and max(occupancy) > group_size:
        # The numpy DP would spin forever and the C++ DP silently closes a
        # group per oversized window; fail loudly and identically instead.
        raise ValueError(
            f"window occupancy {max(occupancy)} exceeds group capacity "
            f"{group_size}")
    res = group_windows_native(group_size, occupancy)
    if res is None:
        return _group_windows_numpy(group_size, occupancy)
    group_of, num_groups = res
    grouped_idx = [
        np.flatnonzero(group_of == g).tolist() for g in range(num_groups)
    ]
    occ = np.asarray(occupancy)
    num_ele_group = [int(occ[idx].sum()) for idx in grouped_idx]
    return num_ele_group, grouped_idx


def _window_group_id(coords: np.ndarray, window_size: int, shift_size: int):
    """Injective window id per coordinate (swin_block.py:365-370)."""
    shifted = coords + (window_size - shift_size) % window_size
    win = shifted // window_size
    width = int(win[:, 1].max()) + 1 if len(win) else 1
    return win[:, 0] * width + win[:, 1]


def _attn_mask_from_gid(gid: np.ndarray) -> np.ndarray:
    """(nG, GS) group ids (-1 = pad) -> (nG, GS, GS) additive mask.

    Port of swin_block.py:372-379: pairs in different windows or pad-pad
    pairs get -100.
    """
    pad = gid == -1
    pad_pair = pad[:, :, None] & pad[:, None, :]
    diff = gid[:, :, None] - gid[:, None, :]
    masked = (diff != 0) | pad_pair
    return np.where(masked, -100.0, 0.0).astype(np.float32)


def _rel_pos_idx(coords: np.ndarray, window_size: int) -> np.ndarray:
    """(nG, GS, 2) -> (nG, GS, GS) table indices (swin_block.py:381-387)."""
    rel = coords[:, :, None, :] - coords[:, None, :, :]
    rel = rel + (window_size - 1)
    idx = rel[..., 0] * (2 * window_size - 1) + rel[..., 1]
    return idx.astype(np.int64)


def expand_group_plan(plan: "GroupPlan", window_size: int):
    """Host (numpy) expansion of a compact plan into the
    (attn_mask, rel_pos_idx) tensors — same formulas as the device-side
    models/swin.py::expand_plan; used by parity tests."""
    attn_mask = _attn_mask_from_gid(plan.gid)
    rel = _rel_pos_idx(plan.coords_g, window_size)
    rel = np.where(attn_mask != 0, 0, rel)
    return attn_mask.astype(np.float32), rel.astype(np.int32)


def make_group_plan(
    coords: np.ndarray,
    window_size: int,
    shift_size: int,
    pad_groups_to: Optional[int] = None,
) -> GroupPlan:
    """Build the grouping plan for visible-token ``coords`` (N, 2).

    Mirrors GroupingModule.prepare (swin_block.py:444-450): masking mode for
    small token counts, knapsack grouping otherwise.
    """
    n = coords.shape[0]
    if n <= 2 * window_size ** 2:
        gid = _window_group_id(coords, window_size, shift_size)[None]
        return GroupPlan(
            idx_shuffle=np.arange(n, dtype=np.int32),
            idx_unshuffle=np.arange(n, dtype=np.int32),
            gid=gid.astype(np.int32),
            coords_g=coords[None].astype(np.int32),
            grouped=False,
        )

    group_size = window_size ** 2
    gid = _window_group_id(coords, window_size, shift_size)
    order = np.argsort(gid, kind="stable")
    gid_sorted = gid[order]
    _, counts_arr = np.unique(gid_sorted, return_counts=True)

    num_ele_group, grouped_idx = group_windows(
        group_size, counts_arr.tolist()
    )

    # Vectorized group assembly (the per-group concatenate+pad loop was
    # ~340 np.pad calls/step of planner time): emit every token once,
    # ordered by (group, window-within-group, token-within-window), then
    # scatter into the padded (nG, GS) grids.
    num_groups = len(grouped_idx)
    rows = num_groups if pad_groups_to is None else pad_groups_to
    if pad_groups_to is not None:
        assert pad_groups_to >= num_groups, (pad_groups_to, num_groups)
    win_start = np.cumsum(counts_arr) - counts_arr
    flat_w = np.concatenate(grouped_idx).astype(np.int64)
    wins_per_group = np.fromiter(
        (len(g) for g in grouped_idx), np.int64, num_groups
    )
    grp_of_win = np.repeat(np.arange(num_groups), wins_per_group)
    reps = counts_arr[flat_w]
    tok_start = np.cumsum(reps) - reps
    src = (
        np.repeat(win_start[flat_w], reps)
        + np.arange(int(reps.sum())) - np.repeat(tok_start, reps)
    )
    grp = np.repeat(grp_of_win, reps)
    tok_per_group = np.asarray(num_ele_group, np.int64)
    grp_start = np.cumsum(tok_per_group) - tok_per_group
    col = np.arange(len(src)) - np.repeat(grp_start, tok_per_group)

    shuffle_grid = np.full((rows, group_size), -1, np.int64)
    shuffle_grid[grp, col] = order[src]
    gid_grid = np.full((rows, group_size), -1, np.int64)
    gid_grid[grp, col] = gid_sorted[src]

    idx_shuffle = shuffle_grid.reshape(-1)
    order_of = np.argsort(idx_shuffle, kind="stable")
    idx_unshuffle = order_of[-int(sum(num_ele_group)):].astype(np.int32)
    idx_shuffle = np.where(idx_shuffle < 0, 0, idx_shuffle).astype(np.int32)
    coords_shuffled = coords[idx_shuffle.reshape(-1, group_size)]
    return GroupPlan(
        idx_shuffle=idx_shuffle,
        idx_unshuffle=idx_unshuffle,
        gid=gid_grid.astype(np.int32),
        coords_g=coords_shuffled.astype(np.int32),
        grouped=True,
    )


def merge_plan(coords: np.ndarray, resolution: tuple[int, int]):
    """PatchMerging gather plan (port of swin_block.py:180-211).

    coords: (N, 2) visible token coords at resolution (H, W); every 2x2 block
    is fully visible or fully masked (mask granularity guarantees it).
    Returns (child_idx (N//4, 4) int32 in [tl, bl, tr, br] order,
             coords_new (N//4, 2)).
    """
    h, w = resolution
    n = coords.shape[0]
    pos_to_idx = -np.ones((h, w), np.int64)
    pos_to_idx[coords[:, 0], coords[:, 1]] = np.arange(n)

    blocks = np.unique(coords // 2, axis=0)  # row-major sorted
    tl_y, tl_x = blocks[:, 0] * 2, blocks[:, 1] * 2
    child_idx = np.stack(
        [
            pos_to_idx[tl_y, tl_x],          # tl
            pos_to_idx[tl_y + 1, tl_x],      # bl
            pos_to_idx[tl_y, tl_x + 1],      # tr
            pos_to_idx[tl_y + 1, tl_x + 1],  # br
        ],
        axis=1,
    )
    assert (child_idx >= 0).all(), "mask does not align with 2x2 merging"
    return child_idx.astype(np.int32), blocks.astype(np.int32)


def visible_coords(
    mask_cells: Optional[np.ndarray],
    resolution: tuple[int, int],
    cell_grid: int,
) -> np.ndarray:
    """Visible patch coords (row-major) given mask at cell granularity.

    mask_cells: (cell_grid**2,) bool, True = removed (reference swin.py:154-179
    upsamples the 7x7 cell mask to the 56x56 patch grid); None = all visible.
    """
    h, w = resolution
    ys, xs = np.mgrid[0:h, 0:w]
    if mask_cells is None:
        keep = np.ones((h, w), bool)
    else:
        cells = mask_cells.reshape(cell_grid, cell_grid)
        cy = ys * cell_grid // h
        cx = xs * cell_grid // w
        keep = ~cells[cy, cx]
    return np.stack([ys[keep], xs[keep]], axis=1).astype(np.int32)


@dataclasses.dataclass(frozen=True)
class StagePlan:
    """Everything one Swin stage needs for a given (shared) mask."""

    plan_even: GroupPlan            # shift 0 blocks
    plan_odd: GroupPlan             # shifted blocks
    coords_flat: np.ndarray         # (N_vis,) int32 = y*W + x
    resolution: tuple[int, int]
    merge_child_idx: Optional[np.ndarray]  # (N//4, 4) or None (last stage)


def _round_up(x: int, mult: int) -> int:
    return ((x + mult - 1) // mult) * mult


@functools.lru_cache(maxsize=64)
def _cached_plans(
    mask_key, resolutions, window_size, cell_grid, bucket, clamp_shift=True
):
    mask_cells = (
        np.array(mask_key, dtype=bool) if mask_key is not None else None
    )
    plans = []
    coords = visible_coords(mask_cells, resolutions[0], cell_grid)
    for i, res in enumerate(resolutions):
        ws = min(window_size, min(res))
        # The pretrain Swin clamps shift to 0 once the window covers the
        # whole map (reference swin_block.py:246-248). The mmseg-style
        # ECDDP Swin does NOT (swin_ecddp_block.py:187-243): its stage-4
        # shifted blocks roll the lone 7x7 window and mask it into 2x2
        # quadrant groups — which the group-id formulation reproduces
        # exactly when the shift is left unclamped.
        if clamp_shift:
            shift = 0 if ws >= min(res) else window_size // 2
        else:
            shift = window_size // 2
        n = coords.shape[0]
        if n > 2 * ws ** 2:
            # bucket the padded group count to avoid recompiles
            probe = make_group_plan(coords, ws, 0, None)
            probe_s = make_group_plan(coords, ws, shift, None)
            ng = max(probe.gid.shape[0], probe_s.gid.shape[0])
            ng = _round_up(ng, bucket)
            plan_even = make_group_plan(coords, ws, 0, ng)
            plan_odd = (
                make_group_plan(coords, ws, shift, ng) if shift else plan_even
            )
        else:
            plan_even = make_group_plan(coords, ws, 0)
            plan_odd = (
                make_group_plan(coords, ws, shift) if shift else plan_even
            )
        if i < len(resolutions) - 1:
            child_idx, new_coords = merge_plan(coords, res)
        else:
            child_idx, new_coords = None, None
        plans.append(
            StagePlan(
                plan_even=plan_even,
                plan_odd=plan_odd,
                coords_flat=(coords[:, 0] * res[1] + coords[:, 1]).astype(
                    np.int32
                ),
                resolution=res,
                merge_child_idx=child_idx,
            )
        )
        coords = new_coords
    return tuple(plans)


def build_swin_plans(
    mask_cells: Optional[np.ndarray],
    *,
    input_resolution: tuple[int, int] = (56, 56),
    num_stages: int = 4,
    window_size: int = 7,
    cell_grid: int = 7,
    group_bucket: int = 8,
    clamp_shift: bool = True,
) -> tuple[StagePlan, ...]:
    """Plans for all stages. mask_cells: (cell_grid**2,) bool or None.

    clamp_shift=False selects the mmseg/ECDDP shifted-window semantics
    (stage-4 quadrant masking, see _cached_plans).
    """
    resolutions = tuple(
        (input_resolution[0] >> i, input_resolution[1] >> i)
        for i in range(num_stages)
    )
    mask_key = (
        tuple(bool(v) for v in np.asarray(mask_cells).reshape(-1))
        if mask_cells is not None
        else None
    )
    return _cached_plans(
        mask_key, resolutions, window_size, cell_grid, group_bucket,
        clamp_shift,
    )
