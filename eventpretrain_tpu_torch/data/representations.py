"""Batched on-device event representations and their post-augment
normalisation.

Counterpart of eventpretrain_tpu/data/representations.py:29-133:

* ``num_bins == 2``: the ECDP [positive, negative] count image;
* ``num_bins == 3``: the MEM [positive, 0, negative] image / 255 with its
  hot pixels removed (statistics over each sample's sensor region when
  ``sensor_hw`` is given);
* else the temporal-bilinear voxel grid.

The counts and the grid go through the splat (K3) on a prefix-valid
layout, and through the tiled splat (K6) over a tile-bucketed one
(``tile_table``, :67-100). ``use_evrep`` is the EvRep image
(``ops.events.events_to_evrep_batch``, plain PyTorch), untiled only, as
in JAX: it has no tiled path.
"""

from __future__ import annotations

from typing import Optional

import torch

from eventpretrain_tpu_torch.ops.events import (
    events_to_evrep_batch,
    events_to_image_ecdp_batch,
    events_to_image_mem_batch,
    events_to_voxel_grid_batch,
    insert_zero_channel,
    polarity_weights_coordvalid,
    remove_hot_pixels,
)
from eventpretrain_tpu_torch.ops.splat_tiled import voxelize_batch_tiled


def num_channels(num_bins: int) -> int:
    """The representation's channels: 2 and 3 for the count images, else
    one a bin."""
    return {2: 2, 3: 3}.get(num_bins, num_bins)


def build_representation(events: torch.Tensor, counts: torch.Tensor, *,
                         num_bins: int, height: int, width: int,
                         sensor_hw: Optional[torch.Tensor] = None,
                         use_evrep: bool = False,
                         tile_table: Optional[torch.Tensor] = None,
                         t_range: Optional[torch.Tensor] = None,
                         chunk_trange: Optional[torch.Tensor] = None,
                         ) -> torch.Tensor:
    """(B, E, 4) padded events -> (B, height, width, C) representation.

    With ``tile_table`` the events are tile-bucketed
    (``native.bucket_pack_event_batch``): validity comes from the
    coordinates, ``t_range`` is the time window and ``chunk_trange`` each
    chunk's time span, and the grid goes through the tiled splat (K6).
    ``sensor_hw`` ``(B, 2)`` bounds the MEM image's hot-pixel statistics."""
    if use_evrep:
        if tile_table is not None:
            raise ValueError("EvRep has no tiled splat path")
        return events_to_evrep_batch(events, counts, height=height,
                                     width=width)
    if tile_table is not None:
        if num_bins in (2, 3):
            # looked up at the call, as the other splat calls are, so a
            # caller may put the plain version in its place
            from eventpretrain_tpu_torch.ops.splat_tiled import splat_tiled

            img = splat_tiled(
                events[..., 1].to(torch.int32).contiguous(),
                events[..., 0].to(torch.int32).contiguous(),
                polarity_weights_coordvalid(events, height, width),
                tile_table.to(torch.int32).contiguous(), height=height,
                width=width)
            if num_bins == 2:
                return img
            return remove_hot_pixels(insert_zero_channel(img) / 255.0,
                                     10.0, sensor_hw)
        return voxelize_batch_tiled(
            events, tile_table, t_range, chunk_trange, num_bins=num_bins,
            height=height, width=width)
    if num_bins == 2:
        return events_to_image_ecdp_batch(events, counts, height=height,
                                          width=width)
    if num_bins == 3:
        img = events_to_image_mem_batch(events, counts, height=height,
                                        width=width) / 255.0
        return remove_hot_pixels(img, 10.0, sensor_hw)
    return events_to_voxel_grid_batch(
        events, counts, num_bins=num_bins, height=height, width=width
    )


def normalize_representation(evg: torch.Tensor, num_bins: int) -> torch.Tensor:
    """Post-augment per-sample normalisation (ft_n_cars_dataset.py:89-95)."""
    if num_bins == 2:
        amax = evg.amax(dim=(1, 2), keepdim=True)
        evg = evg / (amax + 1.0)
        return (evg - 0.5) * 2.0
    if num_bins == 3:
        counts_max = evg[..., 0::2].amax(dim=(1, 2, 3), keepdim=True)
        factor = torch.where(
            counts_max > 0, 1.0 / torch.clamp_min(counts_max, 1e-12), 1.0
        )
        scale = torch.cat([factor, torch.ones_like(factor), factor], dim=-1)
        return evg * scale
    return evg
