"""MVSEC optical-flow dataset source.

Counterpart of eventpretrain_tpu/data/mvsec.py (``VALID_TIME_INDEX`` :19,
``_remap_nearest`` :28, ``prop_flow`` :40, ``gen_correspond_gt_flow`` :51,
``MvsecSource`` :98), numpy for numpy: the events between consecutive
grayscale-image indices, the ground-truth flow propagated over that span
by iterative warping (a nearest-neighbour gather in place of the
reference's cv2.remap INTER_NEAREST), valid where the flow is nonzero and
both components are under 1000 px. The indoor_flying1 1% train split takes
the same seeded ``random.sample``. ``h5py`` is imported when a source is
opened, so the module imports without it.
"""

from __future__ import annotations

import os
import random

import numpy as np

VALID_TIME_INDEX = {
    "indoor_flying1": [314, 2199],
    "indoor_flying2": [314, 2199],
    "indoor_flying3": [314, 2199],
    "outdoor_day1": [245, 3000],
    "outdoor_day2": [4375, 7002],
}


def _remap_nearest(src: np.ndarray, x_idx: np.ndarray, y_idx: np.ndarray):
    """cv2.remap(src, x, y, INTER_NEAREST) with zero border."""
    h, w = src.shape
    xi = np.round(x_idx).astype(np.int64)
    yi = np.round(y_idx).astype(np.int64)
    inside = (xi >= 0) & (xi < w) & (yi >= 0) & (yi < h)
    out = np.zeros_like(src)
    out[inside] = src[yi[inside], xi[inside]]
    return out


def prop_flow(x_flow, y_flow, x_indices, y_indices, x_mask, y_mask,
              scale_factor=1.0):
    """One propagation step (reference ft_mvsec_dataset.py:180-188)."""
    fx = _remap_nearest(x_flow, x_indices, y_indices)
    fy = _remap_nearest(y_flow, x_indices, y_indices)
    x_mask[fx == 0] = False
    y_mask[fy == 0] = False
    x_indices += fx * scale_factor
    y_indices += fy * scale_factor


def gen_correspond_gt_flow(flows, flows_ts, start_time, end_time):
    """Propagate gt flow over [start_time, end_time]
    (reference ft_mvsec_dataset.py:121-178)."""
    flow_length = len(flows)
    assert flow_length == len(flows_ts) - 1

    x_flow = np.array(flows[0][0], np.float32)
    y_flow = np.array(flows[0][1], np.float32)
    gt_dt = flows_ts[1] - flows_ts[0]
    pre_dt = end_time - start_time

    if start_time > flows_ts[0] and end_time <= flows_ts[1]:
        x_flow *= pre_dt / gt_dt
        y_flow *= pre_dt / gt_dt
        return np.stack([x_flow, y_flow], axis=0)

    x_indices, y_indices = np.meshgrid(
        np.arange(x_flow.shape[1]), np.arange(x_flow.shape[0])
    )
    x_indices = x_indices.astype(np.float32)
    y_indices = y_indices.astype(np.float32)
    orig_x = x_indices.copy()
    orig_y = y_indices.copy()
    x_mask = np.ones(x_indices.shape, bool)
    y_mask = np.ones(y_indices.shape, bool)

    scale_factor = (flows_ts[1] - start_time) / gt_dt
    prop_flow(x_flow, y_flow, x_indices, y_indices, x_mask, y_mask,
              scale_factor)

    for i in range(1, flow_length - 1):
        prop_flow(np.array(flows[i][0], np.float32),
                  np.array(flows[i][1], np.float32),
                  x_indices, y_indices, x_mask, y_mask)

    gt_dt = flows_ts[flow_length] - flows_ts[flow_length - 1]
    pred_dt = end_time - flows_ts[flow_length - 1]
    prop_flow(np.array(flows[flow_length - 1][0], np.float32),
              np.array(flows[flow_length - 1][1], np.float32),
              x_indices, y_indices, x_mask, y_mask, pred_dt / gt_dt)

    x_shift = x_indices - orig_x
    y_shift = y_indices - orig_y
    x_shift[~x_mask] = 0
    y_shift[~y_mask] = 0
    return np.stack([x_shift, y_shift], axis=0)


class MvsecSource:
    """One MVSEC sequence: {'events', 'flow' (H,W,2), 'valid' (H,W)}."""

    def __init__(self, root: str, seq_name: str, fix_events_num: int = 30_000,
                 skip_num: int = 1, is_train: bool = True, seed: int = 0):
        import h5py

        self.seq_name = seq_name
        self.skip_num = skip_num
        lo, hi = VALID_TIME_INDEX[seq_name]
        hi = hi - 1 - (skip_num - 1)
        raw_index = list(range(lo, hi))
        if seq_name == "indoor_flying1":
            length = int(0.01 * (hi - lo))
            random.seed(seed)
            train_idx = random.sample(raw_index, length)
            raw_index = (
                train_idx if is_train
                else [i for i in raw_index if i not in train_idx]
            )
        self.raw_index = raw_index

        data = h5py.File(os.path.join(root, f"{seq_name}_data.hdf5"), "r")
        gt = h5py.File(os.path.join(root, f"{seq_name}_gt.hdf5"), "r")
        self._files = (data, gt)  # open while the source reads them
        self.events = data.get("davis/left/events")
        self.image_ts = data.get("davis/left/image_raw_ts")
        self.image_event_inds = data.get("davis/left/image_raw_event_inds")
        self.flow_dist = gt.get("davis/left/flow_dist")
        self.flow_dist_ts = np.array(
            gt.get("davis/left/flow_dist_ts"), np.float64
        )

    def close(self) -> None:
        """Close the two HDF5 files; the source reads nothing after."""
        for f in self._files:
            f.close()

    def __len__(self):
        return len(self.raw_index)

    def load(self, index: int) -> dict:
        raw = self.raw_index[index]
        t1 = float(self.image_ts[raw])
        t2 = float(self.image_ts[raw + self.skip_num])
        e1 = int(self.image_event_inds[raw])
        e2 = int(self.image_event_inds[raw + self.skip_num])
        events = np.asarray(self.events[e1:e2], np.float64)  # (N,4) xytp
        # MVSEC timestamps are absolute epoch seconds (~1.5e9); the device
        # path carries events as float32, which would quantize them to
        # ~128 s steps and collapse the voxel time axis. Rebase to the
        # first image timestamp in float64 on host: the reference's
        # normalization (t - t0)/(tN - t0) is shift-invariant, so this is
        # value-preserving parity-wise (ft_mvsec_dataset.py:207,229).
        if events.shape[0] > 0:
            events[:, 2] -= t1

        left = int(np.searchsorted(self.flow_dist_ts, t1, side="right")) - 1
        right = int(np.searchsorted(self.flow_dist_ts, t2, side="right"))
        flows = self.flow_dist[left:right]
        flows_ts = self.flow_dist_ts[left:right + 1]
        flow = gen_correspond_gt_flow(flows, flows_ts, t1, t2)  # (2,H,W)
        flow_hwc = flow.transpose(1, 2, 0)
        valid = (
            (np.linalg.norm(flow, axis=0) > 0)
            & (np.abs(flow[0]) < 1000)
            & (np.abs(flow[1]) < 1000)
        ).astype(np.float32)
        return {"events": events, "flow": flow_hwc, "valid": valid}
