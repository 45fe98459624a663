"""The stage-1 train step.

Counterpart of eventpretrain_tpu/train/steps.py:101-160 (``make_rec_step``).
The contrastive and joint steps come with slice 3.
"""

from __future__ import annotations

from typing import Callable, Optional

import torch

from eventpretrain_tpu_torch.objectives.rec import reconstruct_loss
from eventpretrain_tpu_torch.ops.masking import (
    make_mask_from_noise,
    masking_noise,
)
from eventpretrain_tpu_torch.train.optim import global_grad_norm
from eventpretrain_tpu_torch.train.state import TrainState


def make_rec_step(hub, *, patch_size: int, num_patches: int,
                  mask_ratio: float = 0.75,
                  masking_strategy: str = "random",
                  norm_pix_loss: bool = True,
                  generator: Optional[torch.Generator] = None) -> Callable:
    """``step(state, batch) -> metrics``: masked encode and decode, the
    reconstruction loss, the backward and one AdamW update.

    ``batch = {'evg': (B, H, W, bins), 'frame': (B, H, W, C)}``; a batch
    that also holds ``ids_keep``, ``mask`` and ``ids_restore`` replays that
    masking (steps.py:120-127), otherwise the noise of
    ``masking_strategy`` is drawn from ``generator`` (on the batch's
    device). ``metrics`` holds ``loss`` and ``grad_norm`` (of the
    gradients before the update) as device tensors: no step synchronises.
    """
    len_keep = int(num_patches * (1 - mask_ratio))

    def step(state: TrainState, batch: dict) -> dict:
        hub.train()
        evg = batch["evg"]
        if "ids_restore" in batch:
            ids_keep = batch["ids_keep"]
            mask = batch["mask"]
            ids_restore = batch["ids_restore"]
        else:
            noise = masking_noise(generator, evg, patch_size,
                                  masking_strategy)
            ids_keep, mask, ids_restore = make_mask_from_noise(noise,
                                                               len_keep)
        pred, *_ = hub.forward_rec(evg, ids_keep, ids_restore)
        loss = reconstruct_loss(pred, batch["frame"], mask,
                                patch_size=patch_size,
                                norm_pix_loss=norm_pix_loss,
                                mask_ratio=mask_ratio)
        loss.backward()
        grad_norm = global_grad_norm(
            [p.grad for p in hub.parameters() if p.grad is not None])
        state.apply_gradients()
        return {"loss": loss.detach(), "grad_norm": grad_norm}

    return step
