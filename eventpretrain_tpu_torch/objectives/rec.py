"""Difference-guided masked-modeling reconstruction loss (stage 1).

Counterpart of eventpretrain_tpu/objectives/rec.py: patch-normalised MSE on
the masked patches of the temporal intensity-difference frame.
"""

from __future__ import annotations

import torch

from eventpretrain_tpu_torch.ops.reshape import frame2emb


def reconstruct_loss(pred: torch.Tensor, sub_frame: torch.Tensor,
                     mask: torch.Tensor, *, patch_size: int,
                     norm_pix_loss: bool = True,
                     mask_ratio: float = 0.75) -> torch.Tensor:
    """``pred (B, L, p*p*C)``, ``sub_frame (B, H, W, C)``, ``mask (B, L)``
    with 1 = masked. In f32. With ``norm_pix_loss`` each target patch is
    standardised with its *unbiased* variance (torch ``Tensor.var``);
    ``mask_ratio == 0`` averages over every patch."""
    target = frame2emb(patch_size, sub_frame).float()
    pred = pred.float()
    if norm_pix_loss:
        mean = target.mean(-1, keepdim=True)
        var = target.var(-1, keepdim=True, unbiased=True)
        target = (target - mean) / (var + 1.0e-6) ** 0.5
    loss = ((pred - target) ** 2).mean(-1)  # (B, L)
    if mask_ratio == 0:
        return loss.mean()
    mask = mask.float()
    return (mask * loss).sum() / mask.sum()
