"""Optical-flow objective: the L1 error on valid pixels.

Counterpart of eventpretrain_tpu/objectives/flow.py:14-32: a pixel is valid
where its ground-truth validity is at least 0.5 and its flow is shorter
than ``max_flow``; the mean runs over both components of the valid pixels.
"""

from __future__ import annotations

import torch


def flow_l1_loss(predict: torch.Tensor, target: torch.Tensor,
                 target_valid: torch.Tensor,
                 max_flow: float = 400.0) -> torch.Tensor:
    """``predict``, ``target`` (B, H, W, 2); ``target_valid`` (B, H, W)
    -> the f32 scalar mean."""
    predict = predict.float()
    target = target.float()
    mag = torch.sqrt((target ** 2).sum(dim=-1))
    valid = (target_valid >= 0.5) & (mag < max_flow)
    w = valid.float()[..., None]
    abs_err = (predict - target).abs() * w
    # w counts once per pixel and broadcasts over the two components
    return abs_err.sum() / torch.clamp_min(w.sum() * 2.0, 1.0)
