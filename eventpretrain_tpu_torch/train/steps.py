"""The pretrain steps of the three stages, the classification finetune
steps and the dense finetune steps (semantic segmentation and optical
flow).

Counterpart of eventpretrain_tpu/train/steps.py: ``make_rec_step``
:101-160, ``_queue_loss`` :85-98 (global scope), ``make_con_step``
:163-220, ``make_rec_and_con_step`` :223-295, the sparse Swin's
``_HostCellMasker`` :388-537, ``make_swin_rec_step`` :540-604 and
``make_swin_rec_and_con_step`` :877-948, ``make_cls_train_step``
:298-345, ``make_cls_eval_step`` :348-385, ``make_semseg_train_step``
:607-648, ``make_semseg_eval_step`` :651-675, ``make_flow_train_step``
:679-717, ``make_flow_eval_step`` :720-761 and ``make_ecdp_step``
:764-874, with ``_valid_row_mask`` :29-42. Stage 2's frozen trunk is ``requires_grad=False`` on the module
(``train/optim.py::freeze_except_norm``), JAX's ``trainable_mask``: the
trunk runs forward only, as under ``partitioned_value_and_grad``.
Under gradient accumulation (the optimizer's ``accum_steps`` k) each step
is a microstep: its own forward and backward, BatchNorm statistics and
the queue moving as every step's do, and its metrics the microstep's;
``TrainState.apply_gradients`` updates the parameters every k-th.
"""

from __future__ import annotations

import concurrent.futures
from typing import Callable, Optional

import numpy as np
import torch

from eventpretrain_tpu_torch.eval.metrics import (
    confusion_matrix,
    topk_accuracy,
)
from eventpretrain_tpu_torch.models.dense_heads import set_dropout_source
from eventpretrain_tpu_torch.models.ecdp_hub import forward_key
from eventpretrain_tpu_torch.models.layers import (
    DropPathSource,
    set_drop_path_source,
)
from eventpretrain_tpu_torch.models.swin import pack_plans_np, unpack_plans
from eventpretrain_tpu_torch.models.swin_plan import build_swin_plans
from eventpretrain_tpu_torch.objectives.cls import (
    cls_loss,
    per_sample_cls_loss,
)
from eventpretrain_tpu_torch.objectives.contrastive import (
    QueueState,
    global_token_infonce,
    token_infonce_queue,
)
from eventpretrain_tpu_torch.objectives.ecdp import (
    cosine_ema_momentum,
    ecdp_kl_loss,
    ema_update,
    global_sample_infonce,
    sample_infonce_queue,
    vector_project,
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
        pred, *_ = hub.forward_rec(evg, ids_keep, ids_restore, mask)
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


# the domain tags of the two Swin mask schedules (steps.py:388-391), which
# keep them apart from each other and from pipelines seeded alike
_SWIN_REC_TAG = 0x5717A5
_SWIN_REC_CON_TAG = 0x5717C0
# the steps the Swin masker plans and uploads ahead of the one it serves
_PLAN_AHEAD = 2


class _HostCellMasker:
    """The Swin step's shared cell mask and its plans, made on the host
    (steps.py:394-537). The mask of step ``s`` is
    ``np.random.default_rng([plan_seed, domain_tag, s])``'s noise argsorted,
    the first ``len_keep`` cells kept, pure numpy: the port plans JAX's
    masks bit for bit at the same step index, ``state.microsteps``: JAX's
    ``state.step``, here a host integer and so always exact, which a
    resumed run restores.

    One worker thread plans ``_PLAN_AHEAD`` steps ahead (the knapsack is tens
    of ms at Swin-T/224) and uploads each step's packed buffer
    (:func:`~eventpretrain_tpu_torch.models.swin.pack_plans_np`) to the
    card as one copy: from pinned memory, non-blocking, on the stream the
    step's kernels then run on. Each upload pins a fresh host buffer, and
    torch's pinned-memory cache hands a block out again only after the
    copy that read it has ended, so no host buffer is reused under a copy.
    ``uploads`` counts the copies."""

    def __init__(self, plan_seed: int, domain_tag: int, num_cells: int,
                 len_keep: int, *, input_resolution: int, window_size: int,
                 cell_grid: int, device):
        self.plan_seed = plan_seed
        self.domain_tag = domain_tag
        self.num_cells = num_cells
        self.len_keep = len_keep
        self.input_resolution = input_resolution
        self.window_size = window_size
        self.cell_grid = cell_grid
        self.device = torch.device(device)
        self.uploads = 0
        self._pending: dict = {}
        self._pool = concurrent.futures.ThreadPoolExecutor(
            max_workers=1, thread_name_prefix="swin-plan")

    def _compute_np(self, step: int):
        """``(flat int32, layout)`` of step ``step`` (steps.py:477-500)."""
        noise = np.random.default_rng(
            [self.plan_seed, self.domain_tag, step]).random(self.num_cells)
        ids_shuffle = np.argsort(noise)
        ids_restore = np.argsort(ids_shuffle)
        ids_keep = ids_shuffle[:self.len_keep]
        mask = np.ones(self.num_cells, np.float32)
        mask[ids_keep] = 0.0
        plans = build_swin_plans(
            mask.astype(bool),
            input_resolution=(self.input_resolution,) * 2,
            window_size=self.window_size, cell_grid=self.cell_grid)
        return pack_plans_np(plans, ids_keep, mask, ids_restore)

    def _upload(self, step: int):
        flat, layout = self._compute_np(step)
        host = torch.from_numpy(flat)
        if self.device.type == "cuda":
            host = host.pin_memory()
        self.uploads += 1
        return host.to(self.device, non_blocking=True), layout

    def flat_layout(self, state):
        """The uploaded buffer and layout of this call's step."""
        step = state.microsteps
        for s in range(step, step + _PLAN_AHEAD + 1):
            if s not in self._pending:
                self._pending[s] = self._pool.submit(self._upload, s)
        fut = self._pending.pop(step)
        for s in [s for s in self._pending if s < step]:
            self._pending.pop(s).cancel()
        return fut.result()

    def __call__(self, state, batch_size: int):
        """``(plans, ids_keep, mask, ids_restore)`` of this call's step on
        the card (``models/swin.py::unpack_plans``)."""
        flat, layout = self.flat_layout(state)
        return unpack_plans(flat, layout, batch_size)


def _swin_rec_loss_fn(hub, tag: int, cell_grid: int, mask_ratio: float,
                      decoder_patch_size: int, norm_pix_loss: bool,
                      input_resolution: int, window_size: int,
                      plan_seed: int):
    """``(rec_loss(state, batch), masker)``: the step's mask
    and plans from the schedule (a batch's ``ids_keep``/``mask`` are
    ignored, as in JAX), ``forward_rec`` under them, and the
    reconstruction loss."""
    num_cells = cell_grid ** 2
    masker = _HostCellMasker(
        plan_seed, tag, num_cells, int(num_cells * (1 - mask_ratio)),
        input_resolution=input_resolution, window_size=window_size,
        cell_grid=cell_grid, device=next(hub.parameters()).device)

    def rec_loss(state, batch: dict) -> torch.Tensor:
        evg = batch["evg"]
        plans, ids_keep, mask, ids_restore = masker(state, evg.shape[0])
        pred, *_ = hub.forward_rec(evg, ids_keep, ids_restore, plans=plans)
        return reconstruct_loss(pred, batch["frame"], mask,
                                patch_size=decoder_patch_size,
                                norm_pix_loss=norm_pix_loss,
                                mask_ratio=mask_ratio)

    return rec_loss, masker


def make_swin_rec_step(hub, *, cell_grid: int = 7, mask_ratio: float = 0.5,
                       decoder_patch_size: int = 32,
                       norm_pix_loss: bool = True,
                       input_resolution: int = 56, window_size: int = 7,
                       plan_seed: int = 0,
                       generator: Optional[torch.Generator] = None
                       ) -> Callable:
    """``step(state, batch) -> metrics``: stage 1 of the sparse Swin
    (steps.py:540-604): the batch-shared cell mask of the step's index
    ``state.microsteps`` and its plans (:class:`_HostCellMasker`, tag
    ``0x5717A5``), ``forward_rec``, the reconstruction loss over 32-pixel
    cells, the backward and one AdamW update. ``batch = {'evg', 'frame'}``;
    stochastic depth draws from ``generator``. ``step.masker`` is the
    schedule."""
    rec_loss, masker = _swin_rec_loss_fn(
        hub, _SWIN_REC_TAG, cell_grid, mask_ratio, decoder_patch_size,
        norm_pix_loss, input_resolution, window_size, plan_seed)

    def step(state: TrainState, batch: dict) -> dict:
        hub.train()
        set_drop_path_source(hub, DropPathSource(generator))
        loss = rec_loss(state, batch)
        loss.backward()
        grad_norm = state.apply_gradients()
        return {"loss": loss.detach(), "grad_norm": grad_norm}

    step.masker = masker
    return step


def make_swin_rec_and_con_step(hub, *, cell_grid: int = 7,
                               mask_ratio: float = 0.5,
                               decoder_patch_size: int = 32,
                               norm_pix_loss: bool = True,
                               input_resolution: int = 56,
                               window_size: int = 7, use_queue: bool = False,
                               temperature: float = 0.07,
                               plan_seed: int = 0,
                               queue_mode: str = "global",
                               generator: Optional[torch.Generator] = None
                               ) -> Callable:
    """``step(state, batch) -> metrics``: the joint step of the sparse
    Swin (steps.py:877-948): the reconstruction loss as in
    :func:`make_swin_rec_step` (its own schedule, tag ``0x5717C0``) plus
    ``forward_con``'s InfoNCE as in :func:`make_con_step`; one backward of
    their sum and one AdamW update. ``batch`` holds ``evg``, ``frame`` and
    ``clip_emb``; ``metrics`` ``loss``, ``rec_loss``, ``con_loss`` and
    ``grad_norm``."""
    rec_loss, masker = _swin_rec_loss_fn(
        hub, _SWIN_REC_CON_TAG, cell_grid, mask_ratio, decoder_patch_size,
        norm_pix_loss, input_resolution, window_size, plan_seed)

    def step(state: TrainState, batch: dict) -> dict:
        hub.train()
        set_drop_path_source(hub, DropPathSource(generator))
        rec = rec_loss(state, batch)
        con = _con_loss(hub, batch, state, use_queue, temperature,
                        queue_mode)
        loss = rec + con
        loss.backward()
        grad_norm = state.apply_gradients()
        return {"loss": loss.detach(), "rec_loss": rec.detach(),
                "con_loss": con.detach(), "grad_norm": grad_norm}

    step.masker = masker
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


def make_ecdp_step(model, *, num_patches: int = 196,
                   mask_ratio: float = 0.75, use_queue: bool = False,
                   t_image: float = 0.1, t_event: float = 0.2,
                   lambda_image: float = 1.0, lambda_event: float = 1.0,
                   lambda_kl: float = 2.0, base_ema_momentum: float = 0.99,
                   total_epochs: float = 100.0, steps_per_epoch: int = 1,
                   generator: Optional[torch.Generator] = None) -> Callable:
    """``step(state, batch) -> metrics``: the ECDP baseline's step
    (steps.py:764-874). First the key encoder ``state.key_encoder`` moves
    toward the query encoder's parameters before this update, ``m`` the
    cosine in ``state.step / steps_per_epoch``; then two independently
    masked views: the query through ``forward_query`` (training mode, the
    BatchNorms' running statistics moving), the key through the key
    encoder without gradients. The losses: the image InfoNCE of ``q_image``
    against the projected CLIP embedding, the event InfoNCE of the two
    event projections projected onto the CLIP direction (no l2 norm),
    against the queues ``state.queue = (image, event)`` with
    ``use_queue``, else against the batch (times 2T), and the sinkhorn-KL
    of ``q_image`` against the CLIP projection; one backward of their
    weighted sum and one AdamW update.

    ``batch = {'img_q', 'img_k': (B, H, W, 2), 'clip_emb': (B, 512)}``; a
    batch that also holds ``ids_keep_q``, ``mask_q``, ``ids_keep_k`` and
    ``mask_k`` replays those maskings, otherwise their noise is drawn from
    ``generator`` (on the batch's device), which also feeds stochastic
    depth. ``metrics`` holds ``loss``, ``loss_image``, ``loss_event``,
    ``loss_kl``, ``grad_norm`` as device tensors and ``ema_momentum``."""
    len_keep = int(num_patches * (1 - mask_ratio))

    def view_mask(batch: dict, view: str, img: torch.Tensor):
        if f"ids_keep_{view}" in batch:
            return batch[f"ids_keep_{view}"], batch[f"mask_{view}"]
        noise = torch.rand((img.shape[0], num_patches), generator=generator,
                           device=img.device)
        return make_mask_from_noise(noise, len_keep)[:2]

    def step(state: TrainState, batch: dict) -> dict:
        key_encoder = state.key_encoder
        model.train()
        key_encoder.train()
        source = DropPathSource(generator)
        set_drop_path_source(model, source)
        set_drop_path_source(key_encoder, source)
        momentum = cosine_ema_momentum(base_ema_momentum,
                                       state.step / steps_per_epoch,
                                       total_epochs)
        ema_update(model.encoder, key_encoder, momentum)
        ids_q, mask_q = view_mask(batch, "q", batch["img_q"])
        ids_k, mask_k = view_mask(batch, "k", batch["img_k"])
        q_event, q_image, clip_proj = model.forward_query(
            batch["img_q"], ids_q, batch["clip_emb"], mask_q)
        k_event = forward_key(key_encoder, batch["img_k"], ids_k, mask_k)
        q_event_p = vector_project(q_event, clip_proj)
        k_event_p = vector_project(k_event, clip_proj)
        if use_queue:
            queue_image, queue_event = state.queue
            loss_image, queue_image = sample_infonce_queue(
                q_image, clip_proj, queue_image, t_image)
            loss_event, queue_event = sample_infonce_queue(
                q_event_p, k_event_p, queue_event, t_event, l2_norm=False)
            state.queue = (queue_image, queue_event)
        else:
            loss_image = global_sample_infonce(q_image, clip_proj, t_image)
            loss_event = global_sample_infonce(q_event_p, k_event_p, t_event,
                                               l2_norm=False)
        loss_kl = ecdp_kl_loss(q_image, clip_proj, t_image)
        loss = (lambda_image * loss_image + lambda_event * loss_event
                + lambda_kl * loss_kl)
        loss.backward()
        grad_norm = state.apply_gradients()
        return {"loss": loss.detach(), "loss_image": loss_image.detach(),
                "loss_event": loss_event.detach(),
                "loss_kl": loss_kl.detach(), "ema_momentum": momentum,
                "grad_norm": grad_norm}

    return step


def make_cls_train_step(hub, *, smoothing: float = 0.0,
                        generator: Optional[torch.Generator] = None,
                        preprocess_fn: Optional[Callable] = None
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
    ``preprocess_fn`` (the frozen EvRepSL network) maps ``evg`` first,
    under ``torch.no_grad()``: JAX's ``stop_gradient`` (steps.py:314-315).
    It is not the hub's, so the optimizer never sees its parameters.
    """

    def step(state: TrainState, batch: dict) -> dict:
        hub.train()
        source = DropPathSource(generator, batch.get("drop_path_keep"))
        set_drop_path_source(hub, source)
        _, logits, _ = hub(_preprocessed(batch["evg"], preprocess_fn))
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


def _preprocessed(evg: torch.Tensor,
                  preprocess_fn: Optional[Callable]) -> torch.Tensor:
    if preprocess_fn is None:
        return evg
    with torch.no_grad():
        return preprocess_fn(evg)


def make_cls_eval_step(hub, preprocess_fn: Optional[Callable] = None
                       ) -> Callable:
    """``step(batch) -> metrics``: the validation step (steps.py:348-385)
    in eval mode without gradients, ``preprocess_fn`` mapping ``evg``
    first. Pad rows of a wrapped tail batch (``num_valid`` /
    ``valid_rows``) weigh 0: ``loss`` (unsmoothed) and the accuracies are
    means over the real rows, and ``_n`` is their count, the weight
    :func:`~eventpretrain_tpu_torch.train.loop.evaluate` gives the
    batch."""

    @torch.no_grad()
    def step(batch: dict) -> dict:
        hub.eval()
        _, logits, _ = hub(_preprocessed(batch["evg"], preprocess_fn))
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
