"""The pretrain steps of the three stages, the classification finetune
steps and the dense finetune steps (semantic segmentation and optical
flow).

Counterpart of eventpretrain_tpu/train/steps.py: ``make_rec_step``
:101-160, ``_queue_loss`` :85-98 (global scope), ``make_con_step``
:163-220, ``make_rec_and_con_step`` :223-295, ``make_cls_train_step``
:298-345, ``make_cls_eval_step`` :348-385, ``make_semseg_train_step``
:607-648, ``make_semseg_eval_step`` :651-675, ``make_flow_train_step``
:679-717 and ``make_flow_eval_step`` :720-761, with ``_valid_row_mask``
:29-42. Stage 2's frozen trunk is ``requires_grad=False`` on the module
(``train/optim.py::freeze_except_norm``), JAX's ``trainable_mask``: the
trunk runs forward only, as under ``partitioned_value_and_grad``.
"""

from __future__ import annotations

from typing import Callable, Optional

import torch

from eventpretrain_tpu_torch.eval.metrics import (
    confusion_matrix,
    topk_accuracy,
)
from eventpretrain_tpu_torch.models.dense_heads import set_dropout_source
from eventpretrain_tpu_torch.models.layers import (
    DropPathSource,
    set_drop_path_source,
)
from eventpretrain_tpu_torch.objectives.cls import (
    cls_loss,
    per_sample_cls_loss,
)
from eventpretrain_tpu_torch.objectives.contrastive import (
    QueueState,
    global_token_infonce,
    token_infonce_queue,
)
from eventpretrain_tpu_torch.objectives.flow import flow_l1_loss
from eventpretrain_tpu_torch.objectives.rec import reconstruct_loss
from eventpretrain_tpu_torch.objectives.semseg import semseg_loss
from eventpretrain_tpu_torch.ops.masking import (
    make_mask_from_noise,
    masking_noise,
)
from eventpretrain_tpu_torch.ops.reshape import resize, resize_flow
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
    rec_loss = _rec_loss_fn(hub, patch_size, num_patches, mask_ratio,
                            masking_strategy, norm_pix_loss, generator)

    def step(state: TrainState, batch: dict) -> dict:
        hub.train()
        set_drop_path_source(hub, DropPathSource(generator))
        loss = rec_loss(batch)
        loss.backward()
        grad_norm = state.apply_gradients()
        return {"loss": loss.detach(), "grad_norm": grad_norm}

    return step


def _rec_loss_fn(hub, patch_size: int, num_patches: int, mask_ratio: float,
                 masking_strategy: str, norm_pix_loss: bool,
                 generator: Optional[torch.Generator]) -> Callable:
    """``rec_loss(batch)``: the masking (replayed from the batch's
    ``ids_keep``/``mask``/``ids_restore`` when it holds them, else drawn
    from ``generator``), ``forward_rec`` and the reconstruction loss."""
    len_keep = int(num_patches * (1 - mask_ratio))

    def rec_loss(batch: dict) -> torch.Tensor:
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
        return reconstruct_loss(pred, batch["frame"], mask,
                                patch_size=patch_size,
                                norm_pix_loss=norm_pix_loss,
                                mask_ratio=mask_ratio)

    return rec_loss


def _queue_loss(q: torch.Tensor, k: torch.Tensor, queue: QueueState,
                temperature: float, queue_mode: str
                ) -> tuple[torch.Tensor, QueueState]:
    """Queue InfoNCE by scope (steps.py:85-98): "global" enqueues the
    batch into one queue; "local", one queue a device fed its own keys,
    needs a mesh, which comes with slice 6."""
    if queue_mode != "global":
        raise NotImplementedError(
            f"queue_mode={queue_mode!r} needs a device mesh: slice 6 "
            "(data parallelism) brings it")
    return token_infonce_queue(q, k, queue, temperature)


def _con_loss(hub, batch: dict, state: TrainState, use_queue: bool,
              temperature: float, queue_mode: str) -> torch.Tensor:
    """``forward_con`` on the batch's ``evg`` and ``clip_emb`` and the
    InfoNCE of its q and k: against the queue (whose buffer takes the
    keys in place, ``state.queue`` the new pointer) with ``use_queue``,
    else against the batch."""
    q, k, *_ = hub.forward_con(batch["evg"], batch["clip_emb"])
    if not use_queue:
        return global_token_infonce(q, k, temperature)
    loss, state.queue = _queue_loss(q, k, state.queue, temperature,
                                    queue_mode)
    return loss


def make_con_step(hub, *, use_queue: bool = False, temperature: float = 0.07,
                  queue_mode: str = "global",
                  generator: Optional[torch.Generator] = None) -> Callable:
    """``step(state, batch) -> metrics``: the stage-2/3 contrastive step
    (steps.py:163-220): ``forward_con`` in training mode (the projectors'
    BatchNorms on the batch's statistics, their running buffers moving in
    place), the InfoNCE of q against k (the queue's when ``use_queue``,
    ``state.queue`` then holding it; else the batch's other samples), the
    backward and one AdamW update. Stage 2 freezes the trunk on the module
    (``freeze_except_norm``) before the optimizer is built.

    ``batch = {'evg': (B, H, W, bins), 'clip_emb': (B, 1 + L, 512)}``;
    stochastic depth draws from ``generator``. ``metrics`` holds ``loss``
    and ``grad_norm`` (of the real gradients) as device tensors."""

    def step(state: TrainState, batch: dict) -> dict:
        hub.train()
        set_drop_path_source(hub, DropPathSource(generator))
        loss = _con_loss(hub, batch, state, use_queue, temperature,
                         queue_mode)
        loss.backward()
        grad_norm = state.apply_gradients()
        return {"loss": loss.detach(), "grad_norm": grad_norm}

    return step


def make_rec_and_con_step(hub, *, patch_size: int, num_patches: int,
                          mask_ratio: float = 0.75,
                          masking_strategy: str = "random",
                          norm_pix_loss: bool = True,
                          use_queue: bool = False,
                          temperature: float = 0.07,
                          queue_mode: str = "global",
                          generator: Optional[torch.Generator] = None
                          ) -> Callable:
    """``step(state, batch) -> metrics``: the joint step (steps.py:
    223-295): ``forward_rec`` and its reconstruction loss as in
    :func:`make_rec_step` (a batch's ``ids_keep``/``mask``/``ids_restore``
    replayed; JAX's joint step always draws them), then ``forward_con`` and
    its InfoNCE as in :func:`make_con_step`; one backward of their sum and
    one AdamW update. ``batch`` holds ``evg``, ``frame`` and ``clip_emb``.
    ``metrics`` holds ``loss``, ``rec_loss``, ``con_loss`` and
    ``grad_norm`` as device tensors."""
    rec_loss = _rec_loss_fn(hub, patch_size, num_patches, mask_ratio,
                            masking_strategy, norm_pix_loss, generator)

    def step(state: TrainState, batch: dict) -> dict:
        hub.train()
        set_drop_path_source(hub, DropPathSource(generator))
        rec = rec_loss(batch)
        con = _con_loss(hub, batch, state, use_queue, temperature,
                        queue_mode)
        loss = rec + con
        loss.backward()
        grad_norm = state.apply_gradients()
        return {"loss": loss.detach(), "rec_loss": rec.detach(),
                "con_loss": con.detach(), "grad_norm": grad_norm}

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


def _check_replayed(source: DropPathSource, what: str) -> None:
    """Raise unless a replay (``source.keep``) held exactly the masks the
    model asked for."""
    if source.keep is not None and source.used != len(source.keep):
        raise ValueError(f"{what} holds {len(source.keep)} masks, the model "
                         f"used {source.used}")


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
        _check_replayed(source, "drop_path_keep")
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


def make_semseg_train_step(hub, *, num_classes: int,
                           ignore_index: Optional[int] = None,
                           w_decode: float = 1.0, w_aux: float = 0.4,
                           sample_mode: str = "bilinear",
                           generator: Optional[torch.Generator] = None
                           ) -> Callable:
    """``step(state, batch) -> metrics``: the semantic-segmentation
    finetune step (steps.py:607-648). The hub runs in training mode
    (drop-path, the heads' channel dropout, BatchNorm on the batch's
    statistics, whose running averages move in place); both heads' logits
    are resized to the label resolution, the loss is ``w_decode * (CE +
    Dice)`` of the decode head plus ``w_aux * (CE + Dice)`` of the
    auxiliary head, and :class:`TrainState` applies one AdamW update.

    ``batch = {'evg': (B, H, W, C), 'label': (B, Hl, Wl) int}``. Drop-path
    and dropout masks are drawn from ``generator`` (on the batch's
    device); a batch that holds ``drop_path_keep`` (S, B) bool replays the
    drop-path masks and ``dropout_keep`` (the decode head's (B, C) mask,
    then the auxiliary head's) the dropout masks, each exactly as many as
    the model asks for. ``metrics`` holds ``loss``, ``decode_ce``,
    ``decode_dice`` and ``grad_norm`` as device tensors: no step
    synchronises.
    """

    def step(state: TrainState, batch: dict) -> dict:
        decode, aux = _dense_train_forward(hub, batch, generator)
        label = batch["label"]
        size = tuple(label.shape[1:3])
        d_ce, d_dice = semseg_loss(resize(decode, size, sample_mode), label,
                                   num_classes, ignore_index)
        a_ce, a_dice = semseg_loss(resize(aux, size, sample_mode), label,
                                   num_classes, ignore_index)
        loss = w_decode * (d_ce + d_dice) + w_aux * (a_ce + a_dice)
        loss.backward()
        grad_norm = state.apply_gradients()
        return {"loss": loss.detach(), "decode_ce": d_ce.detach(),
                "decode_dice": d_dice.detach(), "grad_norm": grad_norm}

    return step


def _dense_train_forward(hub, batch: dict,
                         generator: Optional[torch.Generator]):
    """The dense hub in training mode on ``batch['evg']``, drop-path and
    the heads' dropout drawn from ``generator`` or replayed from
    ``drop_path_keep`` / ``dropout_keep``: ``(decode, aux)`` logits."""
    hub.train()
    paths = DropPathSource(generator, batch.get("drop_path_keep"))
    drops = DropPathSource(generator, batch.get("dropout_keep"))
    set_drop_path_source(hub, paths)
    set_dropout_source(hub, drops)
    _, _, decode, aux = hub(batch["evg"])
    _check_replayed(paths, "drop_path_keep")
    _check_replayed(drops, "dropout_keep")
    return decode, aux


def make_semseg_eval_step(hub, *, num_classes: int,
                          ignore_label: Optional[int] = None,
                          sample_mode: str = "bilinear") -> Callable:
    """``step(batch) -> (num_classes, num_classes)`` int64 confusion counts
    of the batch (steps.py:651-675): eval mode (the BatchNorm running
    statistics), no gradients, the decode head's logits resized to the
    label resolution and their argmax against the labels; pad rows of a
    wrapped tail batch are left out. Sum the counts over batches and
    reduce them with ``miou_from_confusion``."""

    @torch.no_grad()
    def step(batch: dict) -> torch.Tensor:
        hub.eval()
        _, _, decode, _ = hub(batch["evg"])
        label = batch["label"]
        pred = resize(decode, tuple(label.shape[1:3]),
                      sample_mode).argmax(dim=-1)
        valid = _valid_row_mask(batch, pred.shape[0], pred.device)
        if valid is not None:
            valid = valid[:, None, None]
        return confusion_matrix(pred, label, num_classes, ignore_label,
                                valid=valid)

    return step


def make_flow_train_step(hub, *, max_flow: float = 400.0,
                         w_decode: float = 1.0, w_aux: float = 0.4,
                         sample_mode: str = "bilinear",
                         generator: Optional[torch.Generator] = None
                         ) -> Callable:
    """``step(state, batch) -> metrics``: the optical-flow finetune step
    (steps.py:679-717) of a dense hub with two output channels. Both
    heads' fields are resized to the label resolution with their vectors
    rescaled (``resize_flow``); the loss is ``w_decode`` times the decode
    head's L1 plus ``w_aux`` times the auxiliary head's, over the pixels
    whose ``valid`` is at least 0.5 and whose flow is shorter than
    ``max_flow``; :class:`TrainState` applies one AdamW update.

    ``batch = {'evg': (B, H, W, C), 'flow': (B, Hl, Wl, 2), 'valid': (B,
    Hl, Wl)}``, with the masks drawn or replayed as in
    :func:`make_semseg_train_step`. ``metrics`` holds ``loss``,
    ``decode_l1`` and ``grad_norm`` as device tensors."""

    def step(state: TrainState, batch: dict) -> dict:
        decode, aux = _dense_train_forward(hub, batch, generator)
        flow, valid = batch["flow"], batch["valid"]
        size = tuple(flow.shape[1:3])
        d_l1 = flow_l1_loss(resize_flow(decode, size, sample_mode), flow,
                            valid, max_flow)
        a_l1 = flow_l1_loss(resize_flow(aux, size, sample_mode), flow,
                            valid, max_flow)
        loss = w_decode * d_l1 + w_aux * a_l1
        loss.backward()
        grad_norm = state.apply_gradients()
        return {"loss": loss.detach(), "decode_l1": d_l1.detach(),
                "grad_norm": grad_norm}

    return step


def make_flow_eval_step(hub, *, sample_mode: str = "bilinear",
                        sparse_mask: bool = True) -> Callable:
    """``step(batch) -> {'epe_sum', 'outlier_sum', 'count'}`` of the batch
    (steps.py:720-761), f32 device tensors to sum over batches: AEE is
    ``epe_sum / count`` and the outlier share ``outlier_sum / count``. Eval
    mode, no gradients; the decode head's field is resized to the label
    resolution. A pixel counts where ``valid >= 0.5``, where events fell
    (``batch['event_mask'] > 0``, the pipeline's mask of the unaugmented
    grid; without one and with ``sparse_mask``, the nonzero pixels of
    ``evg`` nearest-resized), and in a real row of a wrapped tail batch."""

    @torch.no_grad()
    def step(batch: dict) -> dict:
        hub.eval()
        _, _, decode, _ = hub(batch["evg"])
        target = batch["flow"].float()
        size = tuple(target.shape[1:3])
        decode = resize_flow(decode, size, sample_mode).float()
        valid = batch["valid"] >= 0.5
        if "event_mask" in batch:
            valid = valid & (batch["event_mask"] > 0)
        elif sparse_mask:
            evg = batch["evg"].float()
            presence = ((evg * evg).sum(dim=-1) > 0).float()[..., None]
            valid = valid & (resize(presence, size, "nearest")[..., 0] > 0)
        vmask = _valid_row_mask(batch, valid.shape[0], valid.device)
        if vmask is not None:
            valid = valid & vmask[:, None, None]
        w = valid.float()
        epe = torch.sqrt(((decode - target) ** 2).sum(dim=-1))
        mag = torch.sqrt((target ** 2).sum(dim=-1))
        outlier = (epe > 3.0) & (epe / torch.clamp_min(mag, 1e-12) > 0.05)
        return {"epe_sum": (epe * w).sum(),
                "outlier_sum": (outlier.float() * w).sum(),
                "count": w.sum()}

    return step
