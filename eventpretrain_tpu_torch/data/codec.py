"""Compact event transfer codec: f32 xytp encoded on the host, decoded on
the device.

Counterpart of eventpretrain_tpu/data/codec.py: the numpy encoders
(``encode_events_u16`` :39, ``encode_for_transfer`` :89,
``encode_events_u32`` :115, which runs the C++ encoder of
``eventpretrain_tpu_torch.native`` unless the numpy one is forced,
``encode_events_u32_full`` :160) word for word, and the device decoders
(``decode_events_u16`` :77, ``decode_events_u32`` :193) in torch, bit for
bit.

* u16, 8 B/event: x and y in fixed point with 4 fractional bits (65535 is
  the out-of-range sentinel), t normalised to [0, 65535] over each
  sample's window, p + 1.
* u32, 4 B/event: x 11 bits (sentinel 2047 = out of frame), y 10 bits
  (sentinel 1023), t 10 bits over the window, the sign of p 1 bit. Every
  device rasteriser floors x and y to whole pixels and uses t only through
  its position in the window, so only t's 1/1023 quantisation moves a bin
  weight.

torch has few bitwise operations on unsigned types, so the words travel as
their signed views (``int16`` / ``int32``, the same bytes) and the
decoders shift and mask those; they also take the unsigned dtypes, viewed
the same way.
"""

from __future__ import annotations

import numpy as np
import torch

COORD_SCALE = 16.0
T_SCALE = 65535.0
X_SENTINEL = 0x7FF
Y_SENTINEL = 0x3FF
T32_SCALE = 1023.0


def encode_events_u16(packed: np.ndarray, counts: np.ndarray,
                      out: np.ndarray | None = None,
                      ) -> tuple[np.ndarray, np.ndarray]:
    """(B, E, 4) f32 xytp + (B,) counts -> ((B, E, 4) uint16, (B, 2) f32
    t-range). Out-of-range coordinates encode to the sentinel 65535
    (4095.94 px: out of frame for every supported sensor)."""
    b, e, _ = packed.shape
    if out is None or out.shape != (b, e, 4) or out.dtype != np.uint16:
        out = np.empty((b, e, 4), np.uint16)
    t_range = np.empty((b, 2), np.float32)
    for i in range(b):
        n = int(counts[i])
        ev = packed[i, :n]
        xq = ev[:, 0] * COORD_SCALE + 0.5
        yq = ev[:, 1] * COORD_SCALE + 0.5
        out[i, :n, 0] = np.where((xq < 0) | (xq > 65534), 65535, xq)
        out[i, :n, 1] = np.where((yq < 0) | (yq > 65534), 65535, yq)
        if n > 0:
            t0, t1 = float(ev[0, 2]), float(ev[n - 1, 2])
        else:
            t0 = t1 = 0.0
        dt = (t1 - t0) or 1.0
        out[i, :n, 2] = np.clip(
            (ev[:, 2] - t0) / dt * T_SCALE + 0.5, 0, 65535
        )
        out[i, :n, 3] = (ev[:, 3] + 1).astype(np.uint16)
        out[i, n:] = 0
        t_range[i] = (t0, t1)
    return out, t_range


def encode_events_u32(packed: np.ndarray, counts: np.ndarray,
                      out: np.ndarray | None = None,
                      ) -> tuple[np.ndarray, np.ndarray]:
    """(B, E, 4) f32 xytp + (B,) counts -> ((B, E) uint32, (B, 2) f32
    t-range). Word layout: x[0:11] | y[11:21] | t[21:31] | sign(p)[31].

    Runs the C++ encoder (``native.encode_events_u32_native``, word for
    word this loop) unless the caller forced the numpy specification
    below (``native.BACKEND = "numpy-forced"``), as codec.py:124-133
    does."""
    from eventpretrain_tpu_torch.native import encode_events_u32_native

    native = encode_events_u32_native(packed, counts, out=out)
    if native is not None:
        return native
    b, e, _ = packed.shape
    if out is None or out.shape != (b, e) or out.dtype != np.uint32:
        out = np.empty((b, e), np.uint32)
    t_range = np.empty((b, 2), np.float32)
    for i in range(b):
        n = int(counts[i])
        ev = packed[i, :n]
        x = ev[:, 0].astype(np.int64)
        y = ev[:, 1].astype(np.int64)
        x = np.where((x < 0) | (x >= X_SENTINEL), X_SENTINEL, x)
        y = np.where((y < 0) | (y >= Y_SENTINEL), Y_SENTINEL, y)
        if n > 0:
            t0, t1 = float(ev[0, 2]), float(ev[n - 1, 2])
        else:
            t0 = t1 = 0.0
        dt = (t1 - t0) or 1.0
        t = np.clip((ev[:, 2] - t0) / dt * T32_SCALE + 0.5, 0,
                    T32_SCALE).astype(np.int64)
        pos = (ev[:, 3] > 0).astype(np.int64)
        out[i, :n] = (x | (y << 11) | (t << 21) | (pos << 31)).astype(
            np.uint32)
        out[i, n:] = 0
        t_range[i] = (t0, t1)
    return out, t_range


def encode_events_u32_full(packed: np.ndarray, t_range: np.ndarray,
                           out: np.ndarray | None = None) -> np.ndarray:
    """u32-encode every slot of an already-bucketed batch against an
    explicit per-sample time window -> ``(B, E)`` uint32; validity rides
    on the coordinate sentinels. Decoded by :func:`decode_events_u32`."""
    b, e, _ = packed.shape
    if out is None or out.shape != (b, e) or out.dtype != np.uint32:
        out = np.empty((b, e), np.uint32)
    x = packed[..., 0].astype(np.int64)
    y = packed[..., 1].astype(np.int64)
    x = np.where((x < 0) | (x >= X_SENTINEL), X_SENTINEL, x)
    y = np.where((y < 0) | (y >= Y_SENTINEL), Y_SENTINEL, y)
    t0 = t_range[:, 0:1].astype(np.float32)
    t1 = t_range[:, 1:2].astype(np.float32)
    dt = np.where(t1 - t0 == 0, 1.0, t1 - t0)
    t = np.clip(
        (packed[..., 2] - t0) / dt * T32_SCALE + 0.5, 0, T32_SCALE
    ).astype(np.int64)
    pos = (packed[..., 3] > 0).astype(np.int64)
    np.copyto(out, (x | (y << 11) | (t << 21) | (pos << 31)).astype(np.uint32))
    return out


def encode_for_transfer(packed: np.ndarray, counts: np.ndarray,
                        enabled: bool, out: np.ndarray | None = None,
                        codec: str = "u16"):
    """Host half of the transfer: ``(events, t_range, out)`` as numpy, the
    encoded words in their signed view (``int16`` (B, E, 4) for "u16",
    ``int32`` (B, E) for "u32") or the f32 events when not ``enabled``
    (t_range zeros). ``out`` threads the reusable encode buffer back."""
    if enabled:
        enc_fn = encode_events_u32 if codec == "u32" else encode_events_u16
        enc, t_range = enc_fn(packed, counts, out=out)
        signed = np.int32 if codec == "u32" else np.int16
        return enc.view(signed), t_range, enc
    return packed, np.zeros((len(counts), 2), np.float32), out


def _signed(encoded: torch.Tensor, signed: torch.dtype) -> torch.Tensor:
    if encoded.dtype != signed:
        encoded = encoded.view(signed)
    return encoded


def decode_events_u16(encoded: torch.Tensor,
                      t_range: torch.Tensor) -> torch.Tensor:
    """(B, E, 4) int16/uint16 words -> (B, E, 4) f32 xytp, t mapped back to
    its window."""
    enc = (_signed(encoded, torch.int16).to(torch.int32) & 0xFFFF).float()
    x = enc[..., 0] / COORD_SCALE
    y = enc[..., 1] / COORD_SCALE
    t0 = t_range[:, 0:1]
    t1 = t_range[:, 1:2]
    t = t0 + enc[..., 2] / T_SCALE * (t1 - t0)
    p = enc[..., 3] - 1.0
    return torch.stack([x, y, t, p], dim=-1)


def decode_events_u32(encoded: torch.Tensor,
                      t_range: torch.Tensor) -> torch.Tensor:
    """(B, E) int32/uint32 words -> (B, E, 4) f32 xytp, p in {-1, +1}."""
    w = _signed(encoded, torch.int32)
    x = (w & X_SENTINEL).float()
    y = ((w >> 11) & Y_SENTINEL).float()
    tq = ((w >> 21) & 0x3FF).float()
    t0 = t_range[:, 0:1]
    t1 = t_range[:, 1:2]
    t = t0 + tq / T32_SCALE * (t1 - t0)
    p = ((w >> 31) & 1).float() * 2.0 - 1.0
    return torch.stack([x, y, t, p], dim=-1)
