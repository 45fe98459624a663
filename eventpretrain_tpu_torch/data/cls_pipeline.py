"""Classification preprocessing on the device: raw padded events -> the
normalised model input.

Counterpart of eventpretrain_tpu/data/cls_pipeline.py:95-132
(``_device_preprocess``). Events arrive as float32 xytp; the compact u16/u32
transfer codecs and EvRep (``build_representation`` raises for it) are not
ported yet.
"""

from __future__ import annotations

import torch

from eventpretrain_tpu_torch.data.representations import (
    build_representation,
    normalize_representation,
)
from eventpretrain_tpu_torch.ops.view_augment import (
    ViewParams,
    apply_view_augment,
    identity_view_params,
)


def eval_view_params(sensor_hw: torch.Tensor) -> ViewParams:
    """The evaluation view (cls_pipeline.py:223-226): the whole sensor box
    ``(0, 0, h, w)`` of each sample, no flips."""
    return identity_view_params(
        sensor_hw.shape[0], 0, 0, sensor_hw.device
    )._replace(
        crop_h=sensor_hw[:, 0].to(torch.int32),
        crop_w=sensor_hw[:, 1].to(torch.int32),
    )


def _device_preprocess(events: torch.Tensor, counts: torch.Tensor,
                       sensor_hw: torch.Tensor, params: ViewParams, *,
                       num_bins: int, height: int, width: int, out_size: int,
                       mode: str) -> torch.Tensor:
    """(B, E, 4) f32 events -> (B, out_size, out_size, C) f32 input."""
    if events.dtype != torch.float32:
        raise NotImplementedError(
            f"{events.dtype} events: the transfer codecs are not ported yet"
        )
    evg = build_representation(
        events, counts, num_bins=num_bins, height=height, width=width,
        sensor_hw=sensor_hw,
    )
    evg = apply_view_augment(
        evg, params, (out_size, out_size), mode,
        negate_on_tflip=num_bins in (5, 6),
    )
    return normalize_representation(evg, num_bins)
