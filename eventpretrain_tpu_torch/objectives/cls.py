"""Classification objective: cross-entropy, optionally label-smoothed.

Counterpart of eventpretrain_tpu/objectives/cls.py:14-24, in f32:
``optax.smooth_labels`` mixes the one-hot target with the uniform
distribution, ``(1 - s) * onehot + s / K``.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F


def per_sample_cls_loss(logits: torch.Tensor, labels: torch.Tensor,
                        smoothing: float = 0.0) -> torch.Tensor:
    """(B,) f32 cross-entropy of ``logits`` (B, K) against integer
    ``labels`` (B,), with label smoothing ``smoothing``."""
    logp = torch.log_softmax(logits.float(), dim=-1)
    labels = labels.long()
    if smoothing > 0.0:
        k = logits.shape[-1]
        soft = F.one_hot(labels, k).float() * (1.0 - smoothing) + smoothing / k
        return -(soft * logp).sum(-1)
    return -logp.gather(-1, labels[:, None])[:, 0]


def cls_loss(logits: torch.Tensor, labels: torch.Tensor,
             smoothing: float = 0.0) -> torch.Tensor:
    """The batch mean of :func:`per_sample_cls_loss`."""
    return per_sample_cls_loss(logits, labels, smoothing).mean()
