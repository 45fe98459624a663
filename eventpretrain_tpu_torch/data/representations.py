"""Batched on-device event representations and their post-augment
normalisation.

Counterpart of eventpretrain_tpu/data/representations.py:33-133. The port
has the temporal-bilinear voxel grid (``num_bins`` not in {2, 3}), the
2-bin ECDP count image through the splat (K3, :102-105), and over a
tile-bucketed layout (``tile_table``, :67-100) the voxel grid and the
2-bin count image through the tiled splat (K6). The MEM (3) image needs
``remove_hot_pixels``, which is not ported, and neither is EvRep: they
raise ``NotImplementedError`` naming slice 5.
"""

from __future__ import annotations

from typing import Optional

import torch

from eventpretrain_tpu_torch.ops.events import (
    events_to_image_ecdp_batch,
    events_to_voxel_grid_batch,
    polarity_weights_coordvalid,
)
from eventpretrain_tpu_torch.ops.splat_tiled import (
    splat_tiled,
    voxelize_batch_tiled,
)


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
    chunk's time span, and the grid goes through the tiled splat (K6)."""
    del sensor_hw  # used by the MEM hot-pixel removal, not by voxel grids
    if use_evrep:
        raise NotImplementedError(
            "EvRep is not ported yet; it comes with slice 5")
    if num_bins == 3:
        raise NotImplementedError(
            "the num_bins=3 MEM count image needs remove_hot_pixels, which "
            "is not ported yet; it comes with slice 5")
    if tile_table is not None:
        if num_bins == 2:
            return splat_tiled(
                events[..., 1].to(torch.int32).contiguous(),
                events[..., 0].to(torch.int32).contiguous(),
                polarity_weights_coordvalid(events, height, width),
                tile_table.to(torch.int32).contiguous(), height=height,
                width=width)
        return voxelize_batch_tiled(
            events, tile_table, t_range, chunk_trange, num_bins=num_bins,
            height=height, width=width)
    if num_bins == 2:
        return events_to_image_ecdp_batch(events, counts, height=height,
                                          width=width)
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
