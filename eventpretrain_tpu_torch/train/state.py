"""Train state: the module, its optimizer, the lr schedule and the step
counter.

Counterpart of eventpretrain_tpu/train/state.py. JAX threads an immutable
pytree through jitted steps; here the module and the optimizer update in
place, and the step counter is a host integer, so reading it costs no
device synchronisation.
"""

from __future__ import annotations

import dataclasses
from typing import Callable

import torch
from torch import nn



@dataclasses.dataclass
class TrainState:
    module: nn.Module
    optimizer: torch.optim.Optimizer
    schedule: Callable[[int], float]
    step: int = 0

    def apply_gradients(self) -> None:
        """One update from the gradients in ``.grad``: each group's lr is
        ``schedule(step) * lr_scale`` (the count before the update, as
        optax reads it), then the gradients are cleared and ``step``
        advances."""
        lr = self.schedule(self.step)
        for group in self.optimizer.param_groups:
            group["lr"] = lr * group.get("lr_scale", 1.0)
        self.optimizer.step()
        self.optimizer.zero_grad(set_to_none=True)
        self.step += 1
