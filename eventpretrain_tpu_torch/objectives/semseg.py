"""Semantic-segmentation objective: cross-entropy with an ignore index plus
multi-class Dice.

Counterpart of eventpretrain_tpu/objectives/semseg.py:21-98:

* CE in f32 over the pixels whose label is not ``ignore_index`` (without
  one, labels are clamped into the class range);
* Dice over the softmax probabilities, per class ``1 - (2 sum(p t) + 1) /
  (sum(p^2) + sum(t^2) + 1)`` with the ignored pixels zeroed on both
  sides, summed over the classes but the ignore index and divided by the
  number of ALL classes, as the reference does.
"""

from __future__ import annotations

from typing import Optional

import torch


def semseg_ce_loss(logits: torch.Tensor, labels: torch.Tensor,
                   ignore_index: Optional[int] = None) -> torch.Tensor:
    """``logits (B, H, W, C)``, ``labels (B, H, W)`` int -> scalar."""
    logits = logits.float()
    labels = labels.long()
    num_classes = logits.shape[-1]
    if ignore_index is None:
        labels = labels.clamp(0, num_classes - 1)
    lse = torch.logsumexp(logits, dim=-1)
    # the label's logit by comparison, not a gather: an ignore label (255)
    # lies outside the class range and picks nothing
    one_hot = labels[..., None] == torch.arange(num_classes,
                                                device=labels.device)
    ce = lse - (logits * one_hot).sum(dim=-1)
    if ignore_index is None:
        return ce.mean()
    keep = (labels != ignore_index).float()
    return (ce * keep).sum() / torch.clamp_min(keep.sum(), 1.0)


def semseg_dice_loss(logits: torch.Tensor, labels: torch.Tensor,
                     num_classes: int, ignore_index: Optional[int] = None,
                     smooth: float = 1.0) -> torch.Tensor:
    logits = logits.float()
    labels = labels.long()
    if ignore_index is None:
        keep = torch.ones_like(labels, dtype=torch.float32)
    else:
        keep = (labels != ignore_index).float()
    probs = torch.softmax(logits, dim=-1) * keep[..., None]
    classes = torch.arange(num_classes, device=labels.device)
    # the per-class sums of every class at once: a class loop would give
    # each class's probs[..., c] a full-size gradient in the backward
    target = (labels[..., None] == classes).float() * keep[..., None]
    dims = tuple(range(probs.ndim - 1))
    num = 2.0 * (probs * target).sum(dim=dims) + smooth
    den = (probs * probs).sum(dim=dims) + target.sum(dim=dims) + smooth
    per_class = 1.0 - num / den
    if ignore_index is not None and 0 <= ignore_index < num_classes:
        per_class = torch.where(classes == ignore_index, 0.0, per_class)
    return per_class.sum() / num_classes


def semseg_loss(logits: torch.Tensor, labels: torch.Tensor, num_classes: int,
                ignore_index: Optional[int] = None
                ) -> tuple[torch.Tensor, torch.Tensor]:
    """``(ce, dice)``, as the reference's ``SemsegLoss.forward``."""
    return (semseg_ce_loss(logits, labels, ignore_index),
            semseg_dice_loss(logits, labels, num_classes, ignore_index))
