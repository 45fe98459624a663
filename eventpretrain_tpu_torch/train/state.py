"""Train state: the module, its optimizer, the lr schedule, the step
counter and the contrastive stages' queue.

Counterpart of eventpretrain_tpu/train/state.py:22-51. JAX threads an
immutable pytree through jitted steps; here the module and the optimizer
update in place, and the step counter is a host integer, so reading it
costs no device synchronisation. Under gradient accumulation (the
optimizer's ``accum_steps`` k > 1, ``optax.MultiSteps``) each call of
``apply_gradients`` is a microstep and ``step`` counts updates. The projectors' BatchNorm running
statistics (JAX's ``batch_stats``) are buffers of the module; the queue
(``QueueState``, JAX's ``queue``; the ECDP step's pair of
``SampleQueueState``) is held here and replaced by each contrastive step.
The ECDP baseline's EMA key encoder (JAX's ``ema_params``) is
``key_encoder``, a module outside the optimizer that the ECDP step moves
in place.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, Optional

import torch
from torch import nn

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
    queue: Any = None
    micro_step: int = 0
    key_encoder: Optional[nn.Module] = None
    # the running mean of the window's gradients, one tensor per parameter
    # of the optimizer's groups in their order (optax's ``acc_grads``)
    acc_grads: Optional[list] = dataclasses.field(default=None, repr=False)

    @property
    def accum_steps(self) -> int:
        return self.optimizer.defaults.get("accum_steps", 1)

    @property
    def microsteps(self) -> int:
        """The count of ``apply_gradients`` calls so far: JAX's
        ``TrainState.step``, which counts microsteps under accumulation.
        The Swin steps key their mask schedule by it."""
        return self.step * self.accum_steps + self.micro_step

    def apply_gradients(self) -> torch.Tensor:
        """One update from the gradients in ``.grad``, or under
        accumulation one microstep; returns the overflow-safe global norm
        of the gradients in ``.grad`` (a device tensor), and clears them.

        An update: with ``clip_grad`` the gradients are first clipped to
        that norm; then each group's lr is ``schedule(step) * lr_scale``
        (the count before the update, as optax reads it); then ``step``
        advances. Under accumulation a microstep folds ``.grad`` into the
        running mean ``acc += (g - acc) / (micro_step + 1)`` of optax's
        ``MultiSteps``, and the k-th runs the update (the clip included)
        on that mean; parameters and Adam moments do not move in the
        microsteps between."""
        grads = [p.grad for p in self.module.parameters()
                 if p.grad is not None]
        k = self.accum_steps
        if k == 1:
            if self.clip_grad is not None:
                norm = clip_by_safe_global_norm(grads, self.clip_grad)
            else:
                norm = global_grad_norm(grads)
            self._update()
            return norm
        norm = global_grad_norm(grads)
        params = [p for group in self.optimizer.param_groups
                  for p in group["params"]]
        with torch.no_grad():
            if self.acc_grads is None:
                self.acc_grads = [torch.zeros_like(p) for p in params]
            n = self.micro_step
            for p, acc in zip(params, self.acc_grads):
                g = torch.zeros_like(p) if p.grad is None else p.grad
                if n == 0:
                    acc.copy_(g)
                else:
                    acc.add_((g - acc) / (n + 1))
        self.micro_step += 1
        if self.micro_step < k:
            self.optimizer.zero_grad(set_to_none=True)
            return norm
        for p, acc in zip(params, self.acc_grads):
            p.grad = acc
        if self.clip_grad is not None:
            clip_by_safe_global_norm([p.grad for p in params],
                                     self.clip_grad)
        self.micro_step = 0
        self._update()
        return norm

    def _update(self) -> None:
        lr = self.schedule(self.step)
        for group in self.optimizer.param_groups:
            group["lr"] = lr * group.get("lr_scale", 1.0)
        self.optimizer.step()
        self.optimizer.zero_grad(set_to_none=True)
        self.step += 1
