"""Event-stream rasterisation: temporal-bilinear voxel grids and the
per-event weights of the splats.

Counterpart of eventpretrain_tpu/ops/events.py (:34-79, :242-323, the
ECDP count image :111-124 and :326-369, the MEM image :126-138 and
:374-395 with ``remove_hot_pixels`` :141-180, and
``polarity_weights_coordvalid`` :336), with its conventions:

* ``events``: float32 ``(B, E, 4)`` with columns ``[x, y, t, p]``,
  time-sorted, valid rows leading; ``counts``: int ``(B,)`` valid rows.
* Outputs are channels-last ``(B, H, W, C)``.
* The window runs from ``t[0]`` to ``t[count-1]``; a window of 0 becomes 1.
* Polarity 0 means negative and maps to -1.
* Coordinates are truncated toward zero; out-of-frame events and rows past
  ``count`` add nothing.
"""

from __future__ import annotations

import torch


def bilinear_bin_weights(events: torch.Tensor, counts: torch.Tensor,
                         num_bins: int) -> torch.Tensor:
    """Per-event temporal-bilinear bin weights, ``(B, E, num_bins)`` f32."""
    e = events.shape[1]
    t = events[..., 2]
    valid = torch.arange(e, device=events.device)[None] < counts[:, None]
    first = t[:, 0]
    last_idx = (counts.long() - 1).clamp_min(0)[:, None]
    last = torch.gather(t, 1, last_idx)[:, 0]
    return bilinear_bin_weights_windowed(events, valid, first, last, num_bins)


def bilinear_bin_weights_windowed(events: torch.Tensor, valid: torch.Tensor,
                                  first: torch.Tensor, last: torch.Tensor,
                                  num_bins: int) -> torch.Tensor:
    """``bilinear_bin_weights`` with an explicit ``(B, E)`` validity mask and
    a per-sample ``(B,)`` time window ``[first, last]``."""
    t = events[..., 2]
    p = events[..., 3]
    p = torch.where(p == 0, -1.0, p)
    delta_t = last - first
    delta_t = torch.where(delta_t == 0, 1.0, delta_t)
    ts = (num_bins - 1) * (t - first[:, None]) / delta_t[:, None]
    tis = torch.floor(ts)
    dts = ts - tis
    tis_i = tis.to(torch.int32)
    left_ok = valid & (tis >= 0) & (tis < num_bins)
    right_ok = valid & (tis >= 0) & (tis + 1 < num_bins)
    w_left = torch.where(left_ok, p * (1.0 - dts), 0.0)
    w_right = torch.where(right_ok, p * dts, 0.0)
    bins = torch.arange(num_bins, device=events.device, dtype=torch.int32)
    return (
        w_left[..., None] * (tis_i[..., None] == bins)
        + w_right[..., None] * (tis_i[..., None] + 1 == bins)
    )


def _polarity_weights(events: torch.Tensor,
                      counts: torch.Tensor) -> torch.Tensor:
    """``(B, 2, E)`` f32 [positive, negative] indicators of each event,
    zeroed past ``count`` (events.py:326-333). Coordinates outside the
    frame keep their weights: the splat drops them."""
    e = events.shape[1]
    valid = (torch.arange(e, device=events.device)[None]
             < counts.to(events.device)[:, None]).float()
    p = events[..., 3]
    return torch.stack([(p > 0).float() * valid, (p <= 0).float() * valid],
                       dim=1)


def events_to_image_ecdp(events: torch.Tensor, count, *, height: int,
                         width: int) -> torch.Tensor:
    """One sample's ECDP [positive, negative] count image, ``(E, 4)`` ->
    ``(H, W, 2)`` f32 (events.py:111-124): the batched path at B=1, over
    the first ``count`` events that fall in the frame; polarity <= 0
    counts as negative."""
    counts = torch.as_tensor(count, dtype=torch.int32).reshape(1)
    return events_to_image_ecdp_batch(events[None], counts, height=height,
                                      width=width)[0]


def events_to_image_ecdp_batch(events: torch.Tensor, counts: torch.Tensor,
                               *, height: int, width: int) -> torch.Tensor:
    """``(B, E, 4), (B,)`` -> ``(B, H, W, 2)`` f32 ECDP count images
    (events.py:351-369): the prefix-valid polarity weights summed by the
    splat kernel (ops/splat.py, K3) on CUDA, by its exact scatter on the
    CPU."""
    from eventpretrain_tpu_torch.ops.splat import splat

    return splat(events[..., 1].to(torch.int32).contiguous(),
                 events[..., 0].to(torch.int32).contiguous(),
                 _polarity_weights(events, counts).contiguous(),
                 height=height, width=width)


def events_to_image_mem_batch(events: torch.Tensor, counts: torch.Tensor,
                              *, height: int, width: int) -> torch.Tensor:
    """``(B, E, 4), (B,)`` -> ``(B, H, W, 3)`` f32 MEM count images
    (events.py:374-395): the two polarity planes of
    :func:`events_to_image_ecdp_batch` (K3 on CUDA, its exact scatter on
    the CPU) with a zero channel between them."""
    img = events_to_image_ecdp_batch(events, counts, height=height,
                                     width=width)
    return insert_zero_channel(img)


def insert_zero_channel(img: torch.Tensor) -> torch.Tensor:
    """``(..., 2)`` [positive, negative] planes -> ``(..., 3)`` [positive,
    0, negative]."""
    return torch.cat([img[..., :1], torch.zeros_like(img[..., :1]),
                      img[..., 1:]], dim=-1)


def remove_hot_pixels(hist: torch.Tensor, num_stds: float = 10.0,
                      region_hw=None) -> torch.Tensor:
    """Zero the hot pixels of MEM count images, ``(H, W, 3)`` or ``(B, H,
    W, 3)`` (events.py:141-180), each sample on its own statistics.

    The statistics run over the two count channels (0 and 2), the std
    unbiased as torch's; a pixel above ``mean + num_stds * std`` in either
    count channel has both zeroed. ``region_hw``, ``(2,)`` or ``(B, 2)``
    ints (h, w), takes the statistics over each canvas's top-left sensor
    region only (JAX's formulas: the count clamped to 2 at least)."""
    single = hist.ndim == 3
    if single:
        hist = hist[None]
    b, h, w, _ = hist.shape
    counts = hist[..., 0::2]
    if region_hw is None:
        flat = counts.reshape(b, -1)
        mean = flat.mean(dim=1)
        std = flat.std(dim=1, correction=1)
    else:
        region_hw = torch.as_tensor(region_hw, device=hist.device)
        region_hw = region_hw.reshape(-1, 2).expand(b, 2)
        rows = (torch.arange(h, device=hist.device)[None, :, None]
                < region_hw[:, 0, None, None])
        cols = (torch.arange(w, device=hist.device)[None, None, :]
                < region_hw[:, 1, None, None])
        region = (rows & cols)[..., None].to(counts.dtype)
        n = torch.clamp_min((region * torch.ones_like(counts)).sum(
            dim=(1, 2, 3)), 2.0)
        mean = (counts * region).sum(dim=(1, 2, 3)) / n
        var = (((counts - mean[:, None, None, None]) * region) ** 2).sum(
            dim=(1, 2, 3)) / (n - 1.0)
        std = torch.sqrt(var)
    threshold = (mean + num_stds * std)[:, None, None]
    hot = (hist[..., 0] > threshold) | (hist[..., 2] > threshold)
    keep = torch.where(hot, 0.0, 1.0).to(hist.dtype)[..., None]
    out = hist * torch.cat([keep, torch.ones_like(keep), keep], dim=-1)
    return out[0] if single else out


def polarity_weights_coordvalid(events: torch.Tensor, height: int,
                                width: int) -> torch.Tensor:
    """``(B, 2, E)`` f32 [positive, negative] counts of each event, with
    validity from the coordinates (in frame) rather than a leading prefix:
    the weights of the 2-bin count image over a tile-bucketed layout, whose
    pads carry out-of-frame sentinels."""
    x = events[..., 0].to(torch.int32)
    y = events[..., 1].to(torch.int32)
    valid = ((x >= 0) & (x < width) & (y >= 0) & (y < height)).float()
    p = events[..., 3]
    pos = (p > 0).float() * valid
    neg = (p <= 0).float() * valid
    return torch.stack([pos, neg], dim=1)


def events_to_voxel_grid_batch(events: torch.Tensor, counts: torch.Tensor, *,
                               num_bins: int, height: int,
                               width: int) -> torch.Tensor:
    """``(B, E, 4), (B,)`` -> ``(B, H, W, num_bins)`` f32 voxel grids.

    Bin weights in plain PyTorch, summed into the grid by the splat kernel
    (ops/splat.py) on CUDA and by its exact scatter on the CPU. Unlike the
    JAX dispatcher there is no grid-size gate: the TPU kernel's all-pairs
    E*H*W formulation needed one, the atomic scatter costs O(E) at any size.
    """
    from eventpretrain_tpu_torch.ops.splat import voxelize_batch

    return voxelize_batch(events, counts, num_bins=num_bins, height=height,
                          width=width)
