"""The stage-1 train step and the classification finetune steps.

Counterpart of eventpretrain_tpu/train/steps.py: ``make_rec_step``
:101-160, ``make_cls_train_step`` :298-345 and ``make_cls_eval_step``
:348-385 with ``_valid_row_mask`` :29-42. The contrastive and joint steps
come with slice 3.
"""

from __future__ import annotations

from typing import Callable, Optional

import torch

from eventpretrain_tpu_torch.eval.metrics import topk_accuracy
from eventpretrain_tpu_torch.models.layers import (
    DropPathSource,
    set_drop_path_source,
)
from eventpretrain_tpu_torch.objectives.cls import (
    cls_loss,
    per_sample_cls_loss,
)
from eventpretrain_tpu_torch.objectives.rec import reconstruct_loss
from eventpretrain_tpu_torch.ops.masking import (
    make_mask_from_noise,
    masking_noise,
)
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
    device), which also feeds stochastic depth. ``metrics`` holds
    ``loss`` and ``grad_norm`` (of the gradients before the update) as
    device tensors: no step synchronises.
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
        set_drop_path_source(hub, DropPathSource(generator))
        pred, *_ = hub.forward_rec(evg, ids_keep, ids_restore)
        loss = reconstruct_loss(pred, batch["frame"], mask,
                                patch_size=patch_size,
                                norm_pix_loss=norm_pix_loss,
                                mask_ratio=mask_ratio)
        loss.backward()
        grad_norm = state.apply_gradients()
        return {"loss": loss.detach(), "grad_norm": grad_norm}

    return step


def _valid_row_mask(batch: dict, n: int, device) -> Optional[torch.Tensor]:
    """(n,) bool of the real (non-pad) rows, or None when every row is
    real: a per-row ``valid_rows``, or rows ``[0, num_valid)``
    (steps.py:29-42)."""
    if "valid_rows" in batch:
        return batch["valid_rows"]
    if "num_valid" in batch:
        return torch.arange(n, device=device) < batch["num_valid"]
    return None


def _topk(num_classes: int) -> tuple[int, ...]:
    return (1,) if num_classes < 5 else (1, 5)


def make_cls_train_step(hub, *, smoothing: float = 0.0,
                        generator: Optional[torch.Generator] = None
                        ) -> Callable:
    """``step(state, batch) -> metrics``: the classification finetune step
    (steps.py:298-345). The hub runs in training mode (dropout and
    drop-path active), the label-smoothed loss is differentiated, and
    :class:`TrainState` clips and applies one AdamW update.

    ``batch = {'evg': (B, H, W, C), 'label': (B,)}``. Stochastic depth
    draws its keep masks from ``generator`` (on the batch's device); a
    batch that also holds ``drop_path_keep`` (S, B) bool replays those
    masks, one row per active DropPath call in the model's call order,
    and must hold exactly as many rows as the model asks for. Frozen
    parameters (``requires_grad=False``, ``--linprob``) get no gradient and
    no update; the backbone then runs forward only. ``metrics`` holds
    ``loss``, ``grad_norm`` (before the clip) and ``acc1`` (and ``acc5``
    from 5 classes) as device tensors: no step synchronises.
    """

    def step(state: TrainState, batch: dict) -> dict:
        hub.train()
        source = DropPathSource(generator, batch.get("drop_path_keep"))
        set_drop_path_source(hub, source)
        _, logits, _ = hub(batch["evg"])
        if source.keep is not None and source.used != source.keep.shape[0]:
            raise ValueError(
                f"drop_path_keep holds {source.keep.shape[0]} masks, the "
                f"model used {source.used}")
        loss = cls_loss(logits, batch["label"], smoothing)
        loss.backward()
        grad_norm = state.apply_gradients()
        return {
            "loss": loss.detach(), "grad_norm": grad_norm,
            **topk_accuracy(logits.detach(), batch["label"],
                            _topk(logits.shape[-1])),
        }

    return step


def make_cls_eval_step(hub) -> Callable:
    """``step(batch) -> metrics``: the validation step (steps.py:348-385)
    in eval mode without gradients. Pad rows of a wrapped tail batch
    (``num_valid`` / ``valid_rows``) weigh 0: ``loss`` (unsmoothed) and the
    accuracies are means over the real rows, and ``_n`` is their count,
    the weight :func:`~eventpretrain_tpu_torch.train.loop.evaluate` gives
    the batch."""

    @torch.no_grad()
    def step(batch: dict) -> dict:
        hub.eval()
        _, logits, _ = hub(batch["evg"])
        b = logits.shape[0]
        vmask = _valid_row_mask(batch, b, logits.device)
        w = (torch.ones((b,), device=logits.device) if vmask is None
             else vmask.float())
        n = w.sum()
        per_sample = per_sample_cls_loss(logits, batch["label"])
        return {
            "loss": (per_sample * w).sum() / torch.clamp_min(n, 1.0),
            **topk_accuracy(logits, batch["label"], _topk(logits.shape[-1]),
                            weights=w),
            "_n": n,
        }

    return step
