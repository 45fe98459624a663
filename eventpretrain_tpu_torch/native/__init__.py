"""Host-side tile bucketing of event batches for the tiled splat (K6).

Counterpart of eventpretrain_tpu/native/__init__.py:201-212 (the tile
geometry and the pad sentinels), ``_bucket_layout`` :215,
``bucket_pack_event_batch`` :242 (its numpy branch, :303-337) and
``bucket_pack_event_batch_u32`` :404 as the numpy composition with
``encode_events_u32_full``. The JAX package runs a C++ bucketer when its
library builds; that bucketer is bit-exact with this numpy specification,
and the port runs the specification (the C++ one comes with the
infrastructure slice).

The tile geometry is defined here once, and the tiled splat
(``ops/splat_tiled.py``) takes its defaults from these names: a
``tile_h``/``tile_w`` mismatch between the bucketer and the kernel would
not fail, it would silently drop every event outside the tile the kernel
believes its chunk covers.
"""

from __future__ import annotations

from typing import Optional

import numpy as np

from eventpretrain_tpu_torch.data.codec import (
    X_SENTINEL,
    Y_SENTINEL,
    encode_events_u32_full,
)

BUCKET_X_SENTINEL = float(X_SENTINEL)  # 2047: survives the u32 codec and
BUCKET_Y_SENTINEL = float(Y_SENTINEL)  # 1023: decodes out of frame

TILE_H = 128
TILE_W = 128
TILE_CHUNK = 1024


def bucket_layout(cap: int, height: int, width: int, tile_h: int = TILE_H,
                  tile_w: int = TILE_W, chunk: int = TILE_CHUNK,
                  ) -> tuple[int, int, int, int, int]:
    """``(tiles_y, tiles_x, tiles, epad, n_chunks)`` of a batch of capacity
    ``cap``: every tile's segment is padded to a multiple of ``chunk`` and
    is at least one chunk long, so ``epad`` holds the capacity rounded up
    to a chunk plus one chunk per tile."""
    tiles_y = -(-height // tile_h)
    tiles_x = -(-width // tile_w)
    t = tiles_y * tiles_x
    epad = -(-cap // chunk) * chunk + t * chunk
    return tiles_y, tiles_x, t, epad, epad // chunk


def bucket_pack_event_batch(
    packed: np.ndarray,
    counts: np.ndarray,
    *,
    height: int,
    width: int,
    tile_h: int = TILE_H,
    tile_w: int = TILE_W,
    chunk: int = TILE_CHUNK,
    out: Optional[np.ndarray] = None,
) -> tuple[np.ndarray, np.ndarray, np.ndarray, np.ndarray]:
    """Group a packed ``(B, cap, 4)`` f32 xytp batch with ``(B,)`` counts
    by spatial tile: a stable counting sort, one pass per sample.

    Returns
      * ``bucketed (B, EPAD, 4)`` f32: each tile's events contiguous, in
        row-major tile order and in their time order, every segment padded
        to a multiple of ``chunk`` and at least one chunk long; pad slots
        hold ``(2047, 1023, t0, 0)``, out of frame after the u32 codec too;
      * ``tile_table (B, EPAD // chunk)`` i32: each chunk's tile,
        nondecreasing (trailing filler chunks belong to the last tile);
      * ``t_range (B, 2)`` f32: the first and last valid timestamps, the
        window the bin weights need once bucketing has broken time order;
      * ``chunk_trange (B, EPAD // chunk, 2)`` f32: the first and last
        timestamp of each chunk's events (``(t0, t0)`` for pad-only
        chunks), so a kernel can skip the bins a chunk cannot touch.

    Events outside the frame are routed to the nearest border tile; their
    coordinates lie outside that tile, so the tiled splat drops them.
    """
    batch, cap, _ = packed.shape
    tiles_y, tiles_x, t_total, epad, n_chunks = bucket_layout(
        cap, height, width, tile_h, tile_w, chunk
    )
    counts = np.asarray(counts, np.int32)
    if out is None or out.shape != (batch, epad, 4):
        out = np.empty((batch, epad, 4), np.float32)
    table = np.empty((batch, n_chunks), np.int32)
    t_range = np.empty((batch, 2), np.float32)
    chunk_trange = np.empty((batch, n_chunks, 2), np.float32)
    for i in range(batch):
        n = int(counts[i])
        ev = packed[i, :n]
        t0 = float(ev[0, 2]) if n else 0.0
        t1 = float(ev[n - 1, 2]) if n else 0.0
        t_range[i] = (t0, t1)
        chunk_trange[i] = t0
        xi = ev[:, 0].astype(np.int64)
        yi = ev[:, 1].astype(np.int64)
        tid = np.clip(yi // tile_h, 0, tiles_y - 1) * tiles_x + np.clip(
            xi // tile_w, 0, tiles_x - 1
        )
        cnts = np.bincount(tid, minlength=t_total).astype(np.int64)
        region = np.maximum(-(-cnts // chunk) * chunk, chunk)
        starts = np.concatenate([[0], np.cumsum(region)])
        order = np.argsort(tid, kind="stable")
        csum = np.concatenate([[0], np.cumsum(cnts)])
        sorted_tid = tid[order]
        dest = starts[sorted_tid] + (np.arange(n) - csum[sorted_tid])
        out[i] = (BUCKET_X_SENTINEL, BUCKET_Y_SENTINEL, t0, 0.0)
        out[i, dest] = ev[order]
        if n:
            # dest rises along the sorted order, so a chunk starts where
            # dest // chunk changes; the stable sort keeps time order
            # inside a tile, hence inside a chunk
            c_of = dest // chunk
            t_sorted = ev[order][:, 2]
            first = np.r_[True, c_of[1:] != c_of[:-1]]
            last = np.r_[c_of[1:] != c_of[:-1], True]
            chunk_trange[i, c_of[first], 0] = t_sorted[first]
            chunk_trange[i, c_of[last], 1] = t_sorted[last]
        used = int(starts[t_total]) // chunk
        table[i, :used] = np.repeat(
            np.arange(t_total, dtype=np.int32), region // chunk
        )
        table[i, used:] = t_total - 1
    return out, table, t_range, chunk_trange


def bucket_pack_event_batch_u32(
    packed: np.ndarray,
    counts: np.ndarray,
    *,
    height: int,
    width: int,
    tile_h: int = TILE_H,
    tile_w: int = TILE_W,
    chunk: int = TILE_CHUNK,
    out: Optional[np.ndarray] = None,
) -> tuple[np.ndarray, np.ndarray, np.ndarray, np.ndarray]:
    """:func:`bucket_pack_event_batch` with every slot u32-encoded against
    its sample's window: ``(enc (B, EPAD) uint32, tile_table, t_range,
    chunk_trange)``; the pad sentinels survive the encoding."""
    bucketed, table, t_range, chunk_trange = bucket_pack_event_batch(
        packed, counts, height=height, width=width, tile_h=tile_h,
        tile_w=tile_w, chunk=chunk,
    )
    enc = encode_events_u32_full(bucketed, t_range, out=out)
    return enc, table, t_range, chunk_trange
