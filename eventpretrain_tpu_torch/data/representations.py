"""Batched on-device event representations and their post-augment
normalisation.

Counterpart of eventpretrain_tpu/data/representations.py:33-133. The port
has the temporal-bilinear voxel grid (``num_bins`` not in {2, 3}); the ECDP
(2) and MEM (3) count images, EvRep and the tile-bucketed path raise
``NotImplementedError`` until they are ported.
"""

from __future__ import annotations

from typing import Optional

import torch

from eventpretrain_tpu_torch.ops.events import events_to_voxel_grid_batch


def build_representation(events: torch.Tensor, counts: torch.Tensor, *,
                         num_bins: int, height: int, width: int,
                         sensor_hw: Optional[torch.Tensor] = None,
                         use_evrep: bool = False,
                         tile_table: Optional[torch.Tensor] = None,
                         ) -> torch.Tensor:
    """(B, E, 4) padded events -> (B, height, width, C) representation."""
    del sensor_hw  # used by the MEM hot-pixel removal, not by voxel grids
    if use_evrep:
        raise NotImplementedError("EvRep is not ported yet")
    if tile_table is not None:
        raise NotImplementedError("the tile-bucketed splat is not ported yet")
    if num_bins in (2, 3):
        raise NotImplementedError(
            f"the num_bins={num_bins} count image is not ported yet"
        )
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
