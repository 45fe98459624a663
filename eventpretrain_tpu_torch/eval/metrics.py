"""Task metrics.

Counterpart of eventpretrain_tpu/eval/metrics.py:21-126
(``topk_accuracy``, ``confusion_matrix``, ``miou_from_confusion``,
``macc_from_confusion``, ``flow_error``).
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


def confusion_matrix(predict: torch.Tensor, target: torch.Tensor,
                     num_classes: int, ignore_label: Optional[int] = None,
                     valid: Optional[torch.Tensor] = None) -> torch.Tensor:
    """``(num_classes, num_classes)`` int64 counts, rows the prediction and
    columns the target (metrics.py:42-79, semseg_metric.py:4-18): pixels
    predicted as ``ignore_label`` are dropped, and so are pixels whose
    target lies outside the classes (the 255 ignore label); ``valid``, a
    bool mask broadcastable to ``predict``, drops more (a tail batch's
    pads). The counts are exact integers."""
    if valid is not None:
        valid = torch.broadcast_to(valid, predict.shape).reshape(-1)
    predict = predict.reshape(-1).long()
    target = target.reshape(-1).long()
    keep = ((target >= 0) & (target < num_classes)
            & (predict >= 0) & (predict < num_classes))
    if ignore_label is not None:
        keep &= predict != ignore_label
    if valid is not None:
        keep &= valid
    # dropped pixels count into a spare last bin; an integer index_add
    # needs no device synchronisation, unlike a boolean gather
    cells = num_classes * num_classes
    flat = torch.where(keep, predict * num_classes + target, cells)
    counts = torch.zeros(cells + 1, dtype=torch.int64, device=flat.device)
    counts.index_add_(0, flat, torch.ones_like(flat))
    return counts[:cells].view(num_classes, num_classes)


def miou_from_confusion(confusion: torch.Tensor) -> torch.Tensor:
    """Mean IoU in percent, in f64 (metrics.py:85-91)."""
    confusion = confusion.double()
    diag = torch.diagonal(confusion)
    denom = confusion.sum(dim=1) + confusion.sum(dim=0) - diag
    return (100.0 * diag / torch.clamp_min(denom, 1e-12)).mean()


def macc_from_confusion(confusion: torch.Tensor) -> torch.Tensor:
    """Mean class accuracy in percent, in f64 (metrics.py:94-99)."""
    confusion = confusion.double()
    diag = torch.diagonal(confusion)
    return (100.0 * diag / torch.clamp_min(confusion.sum(dim=1),
                                           1e-12)).mean()


def flow_error(predict: torch.Tensor, target: torch.Tensor,
               valid: Optional[torch.Tensor] = None,
               ) -> tuple[torch.Tensor, torch.Tensor]:
    """``(AEE, outliers in percent)`` over the valid pixels
    (metrics.py:102-126): ``predict``, ``target`` (..., H, W, 2), ``valid``
    (..., H, W), where 1 marks a valid pixel, or None for all of them. An
    outlier's end-point error is over 3 and over 5% of the flow's
    length."""
    epe = torch.sqrt(((predict - target) ** 2).sum(dim=-1))
    mag = torch.sqrt((target ** 2).sum(dim=-1))
    w = torch.ones_like(epe) if valid is None else (valid == 1).to(epe.dtype)
    total = torch.clamp_min(w.sum(), 1.0)
    aee = (epe * w).sum() / total
    outlier = ((epe > 3.0) & (epe / torch.clamp_min(mag, 1e-12) > 0.05))
    return aee, (outlier.to(epe.dtype) * w).sum() / total * 100.0
