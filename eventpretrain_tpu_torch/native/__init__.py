"""The pipelines' host code: batch packing, the fused stream augment, tile
bucketing and the u32 transfer encoding, in one multithreaded C++ pass
each (``event_pack.cpp``), built with g++ at first use and bound through
ctypes, which releases the interpreter lock for the call.

Counterpart of eventpretrain_tpu/native/__init__.py: ``pack_event_batch``
:76, ``augment_pack_event_batch`` :139, the tile geometry and the pad
sentinels :201-212, ``_bucket_layout`` :215, ``bucket_pack_event_batch``
:242, ``encode_events_u32_native`` :354, ``bucket_pack_event_batch_u32``
:404 and ``group_windows_native`` :470, over a copy of the same C++ source.

There is no silent fallback. A missing compiler or a failed build raises
with the compiler's message: a pipeline must not switch to another random
stream because a compiler was missing. The numpy versions here (and
``data/event_transforms.py::pack_event_batch``, ``data/codec.py``'s
encoders) are the specifications the C++ is held against, word for word;
they run only when a caller sets ``BACKEND = "numpy-forced"``, as the JAX
package's tests do. The fused augment and the window grouping have no
numpy version here: under ``"numpy-forced"`` they return None and the
caller runs the numpy augment, which draws another random stream.

The library is built without ``-march=native`` and its file name carries a
hash of the source, the flags and the compiler's version, so a library
built on one machine is loaded on another only where the same compiler
would have built the same file. It goes to ``build/host_native/`` at the
repository root (``build/`` is git-ignored), written under a name of its
own process and thread and renamed into place, so builds that race
(several test workers) each leave a whole file.

The tile geometry is defined here once, and the tiled splat
(``ops/splat_tiled.py``) takes its defaults from these names: a
``tile_h``/``tile_w`` mismatch between the bucketer and the kernel would
not fail, it would silently drop every event outside the tile the kernel
believes its chunk covers.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import threading
from pathlib import Path
from typing import Optional, Sequence

import numpy as np

from eventpretrain_tpu_torch.data.codec import (
    X_SENTINEL,
    Y_SENTINEL,
    encode_events_u32_full,
)
from eventpretrain_tpu_torch.data.event_transforms import (
    pack_event_batch as pack_event_batch_numpy,
)

BUCKET_X_SENTINEL = float(X_SENTINEL)  # 2047: survives the u32 codec and
BUCKET_Y_SENTINEL = float(Y_SENTINEL)  # 1023: decodes out of frame

TILE_H = 128
TILE_W = 128
TILE_CHUNK = 1024

# "native" (the C++ library, built at first use) or "numpy-forced" (the
# numpy specifications; set by callers that hold the two against each other)
BACKEND = "native"

SOURCE = Path(__file__).resolve().parent / "event_pack.cpp"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "host_native"
CXX = "g++"
# no FMA contraction: the u32 encoders are held word for word against
# numpy, which rounds the multiply and the add apart
CXX_FLAGS = ("-O3", "-shared", "-fPIC", "-std=c++17", "-ffp-contract=off",
             "-pthread")

_LIB: Optional[ctypes.CDLL] = None
_LIB_LOCK = threading.Lock()

_P = ctypes.c_void_p
_I64 = ctypes.c_int64
_I32P = ctypes.POINTER(ctypes.c_int32)
_I64P = ctypes.POINTER(ctypes.c_int64)
_F32P = ctypes.POINTER(ctypes.c_float)
_U64P = ctypes.POINTER(ctypes.c_uint64)
_SIGNATURES = {
    # streams, starts, lengths, batch, capacity, out, counts
    "pack_event_batch": [ctypes.POINTER(_P), _I64P, _I64P, _I64, _I64, _P,
                         _P],
    # streams, starts, lengths, hs, ws, seeds, batch, capacity, out, counts
    "augment_and_pack_batch": [ctypes.POINTER(_P), _I64P, _I64P, _F32P,
                               _F32P, _U64P, _I64, _I64, _P, _P],
    # capacity, weights, n, group_of, num_groups
    "group_windows_native": [_I64, _I32P, _I64, _I32P, _I32P],
    # packed, counts, batch, cap, tile_h, tile_w, tiles_x, tiles_y, chunk,
    # epad, out, table, t_range, chunk_trange
    "bucket_pack_batch": [_P, _I32P, *[_I64] * 8, _P, _P, _P, _P],
    "bucket_pack_batch_u32": [_P, _I32P, *[_I64] * 8, _P, _P, _P, _P],
    # packed, counts, batch, cap, out, t_range
    "encode_u32_prefix": [_P, _I32P, _I64, _I64, _P, _P],
}


def forced_numpy() -> bool:
    """Whether the callers run the numpy specifications (``BACKEND``)."""
    if BACKEND not in ("native", "numpy-forced"):
        raise ValueError(f"native.BACKEND = {BACKEND!r}: expected 'native' "
                         "or 'numpy-forced'")
    return BACKEND == "numpy-forced"


def _compiler_version() -> str:
    try:
        done = subprocess.run([CXX, "--version"], capture_output=True,
                              text=True, timeout=60)
    except FileNotFoundError as e:
        raise RuntimeError(f"the host code needs the C++ compiler {CXX!r}, "
                           "which was not found") from e
    if done.returncode != 0:
        raise RuntimeError(f"{CXX} --version failed: {done.stderr}")
    return done.stdout


def library_path() -> Path:
    """Where the library of this source, these flags and this compiler
    lives (it may not be built yet)."""
    key = hashlib.sha256()
    key.update(SOURCE.read_bytes())
    key.update("\0".join(CXX_FLAGS).encode())
    key.update(_compiler_version().encode())
    return BUILD_DIR / f"libeventpack-{key.hexdigest()[:16]}.so"


def _build(path: Path) -> None:
    path.parent.mkdir(parents=True, exist_ok=True)
    tmp = path.with_name(
        f"{path.name}.{os.getpid()}.{threading.get_ident()}.tmp")
    cmd = [CXX, *CXX_FLAGS, str(SOURCE), "-o", str(tmp)]
    try:
        done = subprocess.run(cmd, capture_output=True, text=True,
                              timeout=600)
        if done.returncode != 0:
            raise RuntimeError(f"building the host code failed ({' '.join(cmd)}"
                               f", exit {done.returncode}):\n{done.stderr}")
        os.replace(tmp, path)
    finally:
        tmp.unlink(missing_ok=True)


def library() -> ctypes.CDLL:
    """The C++ library, built on first use; raises when it cannot be."""
    global _LIB
    with _LIB_LOCK:
        if _LIB is None:
            path = library_path()
            if not path.exists():
                _build(path)
            lib = ctypes.CDLL(str(path))
            for name, argtypes in _SIGNATURES.items():
                fn = getattr(lib, name)
                fn.argtypes = argtypes
                fn.restype = None
            _LIB = lib
        return _LIB


def _ptr(a: np.ndarray):
    return a.ctypes.data_as(_P)


def _out_buffer(out: Optional[np.ndarray], shape: tuple, dtype) -> np.ndarray:
    """``out`` when it is a C-contiguous array of this shape and dtype (the
    pipelines reuse their buffers), else a new one."""
    if (out is None or out.shape != shape or out.dtype != dtype
            or not out.flags.c_contiguous or not out.flags.writeable):
        return np.empty(shape, dtype)
    return out


def _stream_table(streams: Sequence[np.ndarray], windows):
    """(contiguous f32 streams, their pointer array, starts, lengths): the
    row windows ``[start, end)`` checked against each stream."""
    contig = [np.ascontiguousarray(s, np.float32).reshape(-1, 4)
              for s in streams]
    starts = np.asarray([w[0] for w in windows], np.int64)
    lengths = np.asarray([w[1] - w[0] for w in windows], np.int64)
    for s, a, n in zip(contig, starts, lengths):
        if a < 0 or n < 0 or a + n > s.shape[0]:
            raise ValueError(f"window [{a}, {a + n}) outside a stream of "
                             f"{s.shape[0]} events")
    ptrs = (_P * len(contig))(*[s.ctypes.data for s in contig])
    return contig, ptrs, starts, lengths


def _packed_batch(packed: np.ndarray, counts: np.ndarray):
    """``(packed, counts)`` as the C++ reads them: C-contiguous (B, cap, 4)
    f32 and (B,) int32 with every count in ``[0, cap]``."""
    packed = np.ascontiguousarray(packed, np.float32)
    counts = np.ascontiguousarray(counts, np.int32)
    if packed.ndim != 3 or packed.shape[2] != 4:
        raise ValueError(f"packed of shape {packed.shape}: expected "
                         "(B, cap, 4)")
    if counts.shape != (packed.shape[0],) or (
            counts.size and (counts.min() < 0
                             or counts.max() > packed.shape[1])):
        raise ValueError(f"counts {counts} do not fit a batch of shape "
                         f"{packed.shape}")
    return packed, counts


def pack_event_batch(streams: Sequence[np.ndarray], capacity: int,
                     out: Optional[np.ndarray] = None,
                     ) -> tuple[np.ndarray, np.ndarray]:
    """Pack variable-length (N, 4) streams into a zero-padded
    ``(B, capacity, 4)`` float32 batch and ``(B,)`` int32 counts; a stream
    longer than ``capacity`` keeps its first ``capacity`` events (JAX's
    native pack without its random start, which no pipeline asks for).
    ``out`` is reused when its shape fits."""
    if forced_numpy():
        return pack_event_batch_numpy(streams, capacity, out=out)
    batch = len(streams)
    contig, ptrs, starts, lengths = _stream_table(
        streams, [(0, min(len(s), capacity)) for s in streams])
    out = _out_buffer(out, (batch, capacity, 4), np.float32)
    counts = np.empty(batch, np.int32)
    library().pack_event_batch(ptrs, starts.ctypes.data_as(_I64P),
                               lengths.ctypes.data_as(_I64P), batch,
                               capacity, _ptr(out), _ptr(counts))
    del contig  # the streams the pointers address lived until here
    return out, counts


def augment_pack_event_batch(streams: Sequence[np.ndarray],
                             windows: Sequence[tuple[int, int]],
                             sensor_hws: Sequence[tuple[float, float]],
                             capacity: int, seeds: Sequence[int],
                             out: Optional[np.ndarray] = None,
                             ) -> Optional[tuple[np.ndarray, np.ndarray]]:
    """The fused erase-and-add augment and pack: each sample's window
    ``[start, end)`` of its raw (N, 4) stream, 0.1-1% of its events erased
    and as many jittered copies of others merge-inserted by time (clipped
    to the sensor ``(h, w)``), from a ``std::mt19937_64`` seeded with its
    seed, packed into ``((B, capacity, 4) f32, (B,) int32)``. None under
    ``"numpy-forced"``: the caller then runs
    ``data/event_transforms.py::erase_and_add_events``, the same
    distribution from its numpy generator."""
    if forced_numpy():
        return None
    batch = len(streams)
    if not len(windows) == len(sensor_hws) == len(seeds) == batch:
        raise ValueError("one window, sensor size and seed per stream")
    contig, ptrs, starts, lengths = _stream_table(streams, windows)
    hs = np.asarray([hw[0] for hw in sensor_hws], np.float32)
    ws = np.asarray([hw[1] for hw in sensor_hws], np.float32)
    seed_arr = np.asarray(seeds, np.uint64)
    out = _out_buffer(out, (batch, capacity, 4), np.float32)
    counts = np.empty(batch, np.int32)
    library().augment_and_pack_batch(
        ptrs, starts.ctypes.data_as(_I64P), lengths.ctypes.data_as(_I64P),
        hs.ctypes.data_as(_F32P), ws.ctypes.data_as(_F32P),
        seed_arr.ctypes.data_as(_U64P), batch, capacity, _ptr(out),
        _ptr(counts))
    del contig
    return out, counts


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


def _bucket_native(fn: str, packed, counts, height, width, tile_h, tile_w,
                   chunk, out, dtype, slot_shape):
    packed, counts = _packed_batch(packed, counts)
    batch, cap, _ = packed.shape
    tiles_y, tiles_x, _, epad, n_chunks = bucket_layout(
        cap, height, width, tile_h, tile_w, chunk)
    out = _out_buffer(out, (batch, epad, *slot_shape), dtype)
    table = np.empty((batch, n_chunks), np.int32)
    t_range = np.empty((batch, 2), np.float32)
    chunk_trange = np.empty((batch, n_chunks, 2), np.float32)
    getattr(library(), fn)(
        _ptr(packed), counts.ctypes.data_as(_I32P), batch, cap, tile_h,
        tile_w, tiles_x, tiles_y, chunk, epad, _ptr(out), _ptr(table),
        _ptr(t_range), _ptr(chunk_trange))
    return out, table, t_range, chunk_trange


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
    if forced_numpy():
        return bucket_pack_event_batch_numpy(
            packed, counts, height=height, width=width, tile_h=tile_h,
            tile_w=tile_w, chunk=chunk, out=out)
    return _bucket_native("bucket_pack_batch", packed, counts, height, width,
                          tile_h, tile_w, chunk, out, np.float32, (4,))


def bucket_pack_event_batch_numpy(
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
    """The numpy specification of :func:`bucket_pack_event_batch`
    (JAX's native/__init__.py:303-337)."""
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
    chunk_trange)``; the pad sentinels survive the encoding. One C++ pass
    places each event as its word; its numpy specification is
    ``encode_events_u32_full`` of the numpy bucketer."""
    if forced_numpy():
        bucketed, table, t_range, chunk_trange = (
            bucket_pack_event_batch_numpy(
                packed, counts, height=height, width=width, tile_h=tile_h,
                tile_w=tile_w, chunk=chunk))
        enc = encode_events_u32_full(bucketed, t_range, out=out)
        return enc, table, t_range, chunk_trange
    return _bucket_native("bucket_pack_batch_u32", packed, counts, height,
                          width, tile_h, tile_w, chunk, out, np.uint32, ())


def encode_events_u32_native(packed: np.ndarray, counts: np.ndarray,
                             out: Optional[np.ndarray] = None,
                             ) -> Optional[tuple[np.ndarray, np.ndarray]]:
    """The prefix-layout u32 encoder in C++, word for word
    ``data/codec.py::encode_events_u32``'s numpy loop (which calls this
    first): ``((B, cap) uint32, (B, 2) f32 t-range)``. None under
    ``"numpy-forced"``."""
    if forced_numpy():
        return None
    packed, counts = _packed_batch(packed, counts)
    batch, cap, _ = packed.shape
    out = _out_buffer(out, (batch, cap), np.uint32)
    t_range = np.empty((batch, 2), np.float32)
    library().encode_u32_prefix(_ptr(packed), counts.ctypes.data_as(_I32P),
                                batch, cap, _ptr(out), _ptr(t_range))
    return out, t_range


def group_windows_native(capacity: int, weights: Sequence[int],
                         ) -> Optional[tuple[np.ndarray, int]]:
    """The sparse-Swin planner's greedy knapsack grouping of windows
    (JAX's models/swin_plan.py::group_windows, selection and ties
    included): ``(group_of (n,) int32, num_groups)``. None under
    ``"numpy-forced"``, where the planner (``models/swin_plan.py``) takes
    its numpy version."""
    if forced_numpy():
        return None
    w = np.ascontiguousarray(weights, np.int32)
    if capacity < 0 or (w.size and (w.min() < 0 or w.max() > capacity)):
        raise ValueError(f"window weights must lie in [0, {capacity}]")
    group_of = np.empty(w.shape[0], np.int32)
    num_groups = ctypes.c_int32(0)
    library().group_windows_native(capacity, w.ctypes.data_as(_I32P),
                                   w.shape[0], group_of.ctypes.data_as(_I32P),
                                   ctypes.byref(num_groups))
    return group_of, int(num_groups.value)
