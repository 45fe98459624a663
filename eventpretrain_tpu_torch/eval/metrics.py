"""Task metrics.

Counterpart of eventpretrain_tpu/eval/metrics.py:21-39 (``topk_accuracy``);
the semseg and flow metrics come with the dense slice.
"""

from __future__ import annotations

from typing import Optional

import torch


def topk_accuracy(logits: torch.Tensor, labels: torch.Tensor,
                  topk: tuple[int, ...] = (1, 5),
                  weights: Optional[torch.Tensor] = None,
                  ) -> dict[str, torch.Tensor]:
    """Per-batch top-k accuracy in percent, as device tensors. ``weights``
    (B,) masks samples (a wrapped tail batch's pads carry weight 0). Ties
    rank the lower class first, as ``jax.lax.top_k`` does."""
    max_k = max(topk)
    pred = torch.sort(logits, dim=-1, descending=True,
                      stable=True).indices[:, :max_k]
    correct = pred == labels[:, None].to(pred.dtype)
    out = {}
    for k in topk:
        hit = correct[:, :k].any(dim=1).float()
        if weights is None:
            out[f"acc{k}"] = hit.mean() * 100.0
        else:
            w = weights.float()
            out[f"acc{k}"] = (hit * w).sum() / torch.clamp_min(w.sum(),
                                                               1.0) * 100.0
    return out
