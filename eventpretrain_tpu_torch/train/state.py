"""Train state: the module, its optimizer, the lr schedule, the step
counter and the contrastive stages' queue.

Counterpart of eventpretrain_tpu/train/state.py:22-51. JAX threads an
immutable pytree through jitted steps; here the module and the optimizer
update in place, and the step counter is a host integer, so reading it
costs no device synchronisation. The projectors' BatchNorm running
statistics (JAX's ``batch_stats``) are buffers of the module; the queue
(``QueueState``, JAX's ``queue``) is held here and replaced by each
contrastive step, its buffer written in place.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Optional

import torch
from torch import nn

from eventpretrain_tpu_torch.objectives.contrastive import QueueState
from eventpretrain_tpu_torch.train.optim import (
    clip_by_safe_global_norm,
    global_grad_norm,
)


@dataclasses.dataclass
class TrainState:
    module: nn.Module
    optimizer: torch.optim.Optimizer
    schedule: Callable[[int], float]
    step: int = 0
    clip_grad: Optional[float] = None
    queue: Optional[QueueState] = None

    def apply_gradients(self) -> torch.Tensor:
        """One update from the gradients in ``.grad``; returns their
        overflow-safe global norm before the update (a device tensor).
        First, with ``clip_grad``, the gradients are clipped to that norm;
        then each group's lr is ``schedule(step) * lr_scale`` (the count
        before the update, as optax reads it); then the gradients are
        cleared and ``step`` advances."""
        grads = [p.grad for p in self.module.parameters()
                 if p.grad is not None]
        if self.clip_grad is not None:
            norm = clip_by_safe_global_norm(grads, self.clip_grad)
        else:
            norm = global_grad_norm(grads)
        lr = self.schedule(self.step)
        for group in self.optimizer.param_groups:
            group["lr"] = lr * group.get("lr_scale", 1.0)
        self.optimizer.step()
        self.optimizer.zero_grad(set_to_none=True)
        self.step += 1
        return norm
