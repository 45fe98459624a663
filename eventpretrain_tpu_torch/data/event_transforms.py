"""Host-side event-stream transforms and batch packing (numpy,
variable-length).

Counterpart of eventpretrain_tpu/data/event_transforms.py:16-106 (the
windowing and the erase-and-add and noise augments, draw for draw with the
same ``numpy.random.Generator`` calls, so a seed gives the JAX package's
streams) and of the numpy path of
eventpretrain_tpu/native/__init__.py:76-115 (``pack_event_batch``). The
pipelines pack and augment with the C++ passes of
``eventpretrain_tpu_torch.native``, as the JAX package does; the pack here
is their numpy specification, and it and ``erase_and_add_events`` run
under ``native.BACKEND = "numpy-forced"``.

Events are ``(N, 4)`` float arrays ``[x, y, t, p]`` sorted by ``t``.
"""

from __future__ import annotations

from typing import Optional, Sequence

import numpy as np


def random_window(rng: np.random.Generator, num_events: int,
                  fix_events_num: int) -> tuple[int, int]:
    """Fixed-count random window ``[start, end)`` into a stream of
    ``num_events`` (event_transforms.py:16-27)."""
    if num_events > fix_events_num:
        start = int(rng.integers(0, num_events - fix_events_num))
        return start, start + fix_events_num
    return 0, num_events


def erase_and_add_events(rng: np.random.Generator, events: np.ndarray,
                         size: tuple[int, int]) -> np.ndarray:
    """Remove 0.1-1% of the events and add as many Gaussian-jittered copies
    of others (sigma 1.5 px, 1e-3 in t; coordinates clipped to the sensor
    ``size = (h, w)``), merge-inserted by time (event_transforms.py:39-82).
    The output length varies."""
    sensor_h, sensor_w = size
    n = events.shape[0]
    if int(0.01 * n) <= 0:
        return events

    erase_num = int(rng.integers(int(0.001 * n), int(0.01 * n)))
    erase_index = rng.choice(n, size=erase_num, replace=False, shuffle=False)

    add_num = int(rng.integers(int(0.001 * n), int(0.01 * n)))
    add_index = rng.choice(n, size=add_num, replace=False, shuffle=False)
    add_events = events[add_index].copy()
    add_events[:, 0] = np.clip(
        add_events[:, 0] + rng.normal(0, 1.5, add_num), 0, sensor_w - 1)
    add_events[:, 1] = np.clip(
        add_events[:, 1] + rng.normal(0, 1.5, add_num), 0, sensor_h - 1)
    add_events[:, 2] += rng.normal(0, 0.001, add_num)

    keep = np.ones(n, bool)
    keep[erase_index] = False
    kept = events[keep]

    order = np.argsort(add_events[:, 2], kind="stable")
    add_events = add_events[order]
    pos = np.searchsorted(kept[:, 2], add_events[:, 2])
    return np.insert(kept, pos, add_events, axis=0)


def add_noise_events(rng: np.random.Generator, events: np.ndarray,
                     size: tuple[int, int]) -> np.ndarray:
    """Add 10-50% uniform background-noise events, re-sorted by time
    (event_transforms.py:85-106; the robustness evaluation)."""
    sensor_h, sensor_w = size
    n = events.shape[0]
    add_num = int(rng.integers(int(0.1 * n), int(0.5 * n)))
    noise = np.concatenate(
        (
            rng.integers(0, sensor_w, size=(n, 1)).astype(events.dtype),
            rng.integers(0, sensor_h, size=(n, 1)).astype(events.dtype),
            rng.uniform(events[0, 2], events[-1, 2], size=(n, 1)),
            rng.integers(0, 2, size=(n, 1)).astype(events.dtype),
        ),
        axis=1,
    )
    add_index = rng.choice(n, size=add_num, replace=False)
    out = np.concatenate((events, noise[add_index]))
    return out[out[:, 2].argsort()]


def pack_event_batch(streams: Sequence[np.ndarray], capacity: int,
                     out: Optional[np.ndarray] = None,
                     ) -> tuple[np.ndarray, np.ndarray]:
    """Pack variable-length (N, 4) streams into a zero-padded
    ``(B, capacity, 4)`` float32 batch and ``(B,)`` int32 counts; a stream
    longer than ``capacity`` keeps its first ``capacity`` events (the
    numpy path of native/__init__.py:76-115 without its random start,
    which no pipeline asks for). ``out`` is reused when its shape fits."""
    batch = len(streams)
    if out is None or out.shape != (batch, capacity, 4):
        out = np.empty((batch, capacity, 4), np.float32)
    counts = np.empty(batch, np.int32)
    out.fill(0.0)
    for i, s in enumerate(streams):
        n = min(s.shape[0], capacity)
        out[i, :n] = s[:n]
        counts[i] = n
    return out, counts
