"""The host-side epoch loop and the evaluation loop.

Counterpart of eventpretrain_tpu/train/loop.py:37-129: iterate the
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


def evaluate(eval_step: Callable, pipeline: Iterable, *,
             print_freq: int = 50, header: str = "Val:") -> dict:
    """Run ``eval_step`` over the pipeline; returns each metric's mean over
    the real samples: every batch weighs its ``_n`` (the count of its
    non-pad rows; 1 where that count is 0 or missing), as the JAX loop's
    meters do (loop.py:87-129)."""
    sums: dict[str, float] = {}
    total = 0
    pending: list[dict] = []

    def flush():
        nonlocal total
        for m in pending:
            vals = {k: float(v) for k, v in m.items()}
            n = int(vals.pop("_n", 1)) or 1
            total += n
            for k, v in vals.items():
                sums[k] = sums.get(k, 0.0) + v * n
        pending.clear()

    for batch in pipeline:
        pending.append(eval_step(batch))
        if len(pending) >= print_freq:
            flush()
    flush()
    out = {k: v / max(total, 1) for k, v in sums.items()}
    print(f"{header} {total} samples  "
          + "  ".join(f"{k}: {v:.4f}" for k, v in out.items()), flush=True)
    return out
