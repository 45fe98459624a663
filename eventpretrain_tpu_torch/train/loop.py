"""The host-side epoch loop.

Counterpart of eventpretrain_tpu/train/loop.py:37-84: iterate the
pipeline, call the step, and read the metrics back in bulk every
``print_freq`` steps (a per-step ``float()`` would synchronise the device
on every step).
"""

from __future__ import annotations

import time
from typing import Callable, Iterable, Optional


from eventpretrain_tpu_torch.train.state import TrainState


def train_one_epoch(step: Callable, state: TrainState, pipeline: Iterable,
                    *, epoch: int = 0, print_freq: int = 20,
                    header: Optional[str] = None) -> tuple[TrainState, dict]:
    """Run one epoch; returns the state and the epoch's mean metrics."""
    header = header or f"Epoch: [{epoch}]"
    sums: dict[str, float] = {}
    count = 0
    pending: list[dict] = []
    t0 = time.perf_counter()

    def flush():
        nonlocal count
        if not pending:
            return
        host = [{k: float(v) for k, v in m.items()} for m in pending]
        for m in host:
            for k, v in m.items():
                sums[k] = sums.get(k, 0.0) + v
        count += len(host)
        last = "  ".join(f"{k}: {v:.4f}" for k, v in host[-1].items())
        print(f"{header} [{count}]  {last}  "
              f"({time.perf_counter() - t0:.1f} s)", flush=True)
        pending.clear()

    for batch in pipeline:
        pending.append(step(state, batch))
        if len(pending) >= print_freq:
            flush()
    flush()
    return state, {k: v / max(count, 1) for k, v in sums.items()}
