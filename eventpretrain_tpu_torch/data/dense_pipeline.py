"""Dense-task input pipeline, semantic segmentation and optical flow: host
stream augment, packing, tile bucketing and encoding; device decode,
rasterisation, view and label augments, normalisation.

Counterpart of eventpretrain_tpu/data/dense_pipeline.py:
``DenseDataConfig`` :48-71, ``_device_preprocess`` :73-141, ``DensePipeline``
:144-333 and ``SyntheticDenseSource`` :521-568 (``MvsecSource`` is in
``data/mvsec.py``). The host draws every random number with the JAX
pipeline's ``numpy.random.Generator`` calls in the same order, so one seed
gives the same order, augmented streams and views. The stream augment, the
packing and the tile bucketing are the C++ passes of
``eventpretrain_tpu_torch.native`` (dense_pipeline.py:220-300), fed the
seeds drawn here, so the batches are the JAX pipeline's word for word when
its library builds too; with ``native.BACKEND = "numpy-forced"`` they are
its numpy fallback's.

``tiled_raster="auto"`` routes every sensor grid over 65536 cells (DSEC's
440x640, MVSEC's 260x346) through host tile bucketing and the tiled splat
(K6), on every device; JAX does so on a TPU only
(dense_pipeline.py:156-166), and elsewhere runs the exact scatter, which
computes the same grid.

JAX's ``stream_augment``, ``resize_mode`` and ``transfer_codec`` fields,
which no caller sets, are constants here: the training stream augment is
on, the event grid resizes bilinearly (the reference dense datasets
hardcode it), and the untiled route takes the u32 codec.

Flow ground truth travels as f16 under ``compact_transfer`` (about 1e-3
relative, as in JAX) and as f32 without it; the validity mask as uint8
either way (dense_pipeline.py:210-219).

Not ported yet: the DSEC and DDD17 readers (``DsecSource``,
``Ddd17Source``; they need ``h5py`` and ``PIL``).
"""

from __future__ import annotations

import dataclasses
import time
from typing import Iterator, Optional

import numpy as np
import torch

from eventpretrain_tpu_torch.data.codec import (
    decode_events_u16,
    decode_events_u32,
    encode_for_transfer,
)
from eventpretrain_tpu_torch.data.event_transforms import (
    erase_and_add_events,
)
from eventpretrain_tpu_torch.data.representations import (
    build_representation,
    normalize_representation,
)
from eventpretrain_tpu_torch.native import (
    augment_pack_event_batch,
    bucket_pack_event_batch,
    bucket_pack_event_batch_u32,
    pack_event_batch,
)
from eventpretrain_tpu_torch.ops.reshape import resize
from eventpretrain_tpu_torch.ops.view_augment import (
    ViewParams,
    apply_flow_label_augment,
    apply_flow_valid_augment,
    apply_semseg_label_augment,
    apply_view_augment,
    identity_view_params,
    sample_view_params,
)

# the largest grid the untiled splat takes in JAX (pallas_voxel.py:170-175)
MAX_UNTILED_CELLS = 256 * 256

TASKS = ("semseg", "flow")


@dataclasses.dataclass(frozen=True)
class DenseDataConfig:
    task: str                      # 'semseg' | 'flow'
    num_bins: int = 5
    input_size: int = 224
    fix_events_num: int = 200_000
    val_fix_events_num: int = 200_000
    sensor_height: int = 440
    sensor_width: int = 640
    crop_min: float = 0.8
    label_size: Optional[tuple[int, int]] = None  # None = input_size
    compact_transfer: bool = True   # u32 words (data/codec.py), or f32
    tiled_raster: str = "auto"      # "auto" | "on" | "off"


def uses_tiled_raster(cfg: DenseDataConfig) -> bool:
    """Whether ``cfg`` rasterises through host tile bucketing and K6:
    "on", or "auto" and a sensor grid over 65536 cells."""
    if cfg.tiled_raster == "auto":
        return cfg.sensor_height * cfg.sensor_width > MAX_UNTILED_CELLS
    if cfg.tiled_raster not in ("on", "off"):
        raise ValueError(f"tiled_raster={cfg.tiled_raster!r}: expected "
                         "'auto', 'on' or 'off'")
    return cfg.tiled_raster == "on"


def _device_preprocess(events: torch.Tensor, counts: torch.Tensor,
                       labels: torch.Tensor, params: ViewParams, *,
                       num_bins: int, height: int, width: int, out_size: int,
                       task: str, label_h: int, label_w: int,
                       valid: Optional[torch.Tensor] = None,
                       t_range: Optional[torch.Tensor] = None,
                       tile_table: Optional[torch.Tensor] = None,
                       tile_chunk_trange: Optional[torch.Tensor] = None,
                       ) -> dict:
    """f32 events (B, E, 4), or their u16 (B, E, 4) / u32 (B, E) words with
    ``t_range``, and the labels -> the batch. ``tile_table`` marks a
    tile-bucketed layout, rasterised by K6.

    semseg: ``labels`` (B, H, W) class ids -> ``{'evg': (B, S, S, C) f32,
    'label': (B, label_h, label_w) int64}``. flow: ``labels`` (B, H, W, 2)
    and ``valid`` (B, H, W) -> ``{'evg', 'flow': (B, label_h, label_w, 2)
    f32, 'valid': (B, label_h, label_w) f32, 'event_mask'}``, the last the
    pixels where events fell in the unaugmented grid (nearest-resized to
    the label size), which the eval step's sparse mask reads
    (dense_pipeline.py:120-135)."""
    if task not in TASKS:
        raise ValueError(f"task {task!r}: expected one of {TASKS}")
    if events.dtype in (torch.int16, torch.uint16):
        events = decode_events_u16(events, t_range)
    elif events.dtype in (torch.int32, torch.uint32):
        events = decode_events_u32(events, t_range)
    elif events.dtype != torch.float32:
        raise TypeError(f"events of {events.dtype}: expected f32 xytp or "
                        "the u16/u32 transfer words")
    evg_org = build_representation(
        events, counts, num_bins=num_bins, height=height, width=width,
        tile_table=tile_table, t_range=t_range,
        chunk_trange=tile_chunk_trange,
    )
    evg = apply_view_augment(evg_org, params, (out_size, out_size),
                             "bilinear", negate_on_tflip=num_bins in (5, 6))
    # the ECDP/MEM normalisation follows the view augment, as in the
    # reference dense datasets
    out = {"evg": normalize_representation(evg, num_bins)}
    if task == "semseg":
        # labels travel as uint8 and widen on the device
        label = apply_semseg_label_augment(labels.to(torch.int32), params,
                                           (label_h, label_w))
        out["label"] = label.long()
        return out
    # the wire's f16 gt and u8 valid widen before the resampling augments
    out["flow"] = apply_flow_label_augment(labels.float(), params,
                                           (label_h, label_w))
    out["valid"] = apply_flow_valid_augment(valid.float(), params,
                                            (label_h, label_w))
    grid = evg_org.float()
    presence = ((grid * grid).sum(dim=-1) > 0).float()
    if tuple(presence.shape[1:]) != (label_h, label_w):
        presence = resize(presence[..., None], (label_h, label_w),
                          "nearest")[..., 0]
    out["event_mask"] = presence
    return out


class DensePipeline:
    """Iterates batches ``{'evg', 'label', 'num_valid'}`` on ``device``; a
    short tail batch is padded by wrapping to the front of the epoch's order
    and ``num_valid`` counts its real rows. ``host_seconds`` and
    ``batches`` add up the host time spent building batches (loads,
    erase-and-add, packing, bucketing and encoding)."""

    def __init__(self, source, cfg: DenseDataConfig, batch_size: int,
                 train: bool, seed: int = 0, device="cuda"):
        if cfg.task not in TASKS:
            raise ValueError(f"task {cfg.task!r}: expected one of {TASKS}")
        self.source = source
        self.cfg = cfg
        self.batch_size = batch_size
        self.train = train
        self.rng = np.random.default_rng(seed)
        self.device = torch.device(device)
        self.tiled = uses_tiled_raster(cfg)
        # two of each host buffer, used in turns (as JAX does): a batch's
        # wire arrays are not written again while the next one is built
        self._pack_buffers = [None, None]
        self._enc_buffers = [None, None]
        self._buf_i = 0
        self.host_seconds = 0.0
        self.batches = 0

    def __len__(self) -> int:
        return max(len(self.source) // self.batch_size, 1)

    def _host_batch(self, idx: np.ndarray, cap: int):
        """Loads, stream augment and packing, in the JAX pipeline's order
        of draws: ``(packed, counts, targets)``, ``targets`` holding the
        stacked semseg maps (``labels``), or the flow fields (``labels``)
        and validity masks (``valid``)."""
        cfg = self.cfg
        streams, labels, valids = [], [], []
        for i in idx:
            item = self.source.load(int(i))
            streams.append(np.asarray(item["events"]))
            if cfg.task == "semseg":
                # class ids and the 255 ignore label fit in uint8, the wire
                # dtype; wider maps travel as int32 (dense_pipeline.py:
                # 196-207)
                lab = np.asarray(item["label"])
                labels.append(
                    lab if lab.dtype == np.uint8 else
                    lab.astype(np.uint8) if (lab.min() >= 0
                                             and lab.max() <= 255)
                    else lab.astype(np.int32))
            else:
                # f16 gt under compact_transfer; the 0/1 mask as uint8
                labels.append(np.asarray(
                    item["flow"],
                    np.float16 if cfg.compact_transfer else np.float32))
                valids.append(np.asarray(item["valid"]).astype(np.uint8))
        buf = self._pack_buffers[self._buf_i]
        if self.train:
            hw = (cfg.sensor_height, cfg.sensor_width)
            seeds = self.rng.integers(0, 2 ** 63, len(idx))
            done = augment_pack_event_batch(
                streams, [(0, s.shape[0]) for s in streams],
                [(float(hw[0]), float(hw[1]))] * len(idx), cap, seeds,
                out=buf)
            if done is None:  # "numpy-forced": the numpy specification
                streams = [
                    erase_and_add_events(
                        self.rng, s.astype(np.float64), hw
                    ).astype(np.float32) if s.shape[0] > 0 else
                    s.astype(np.float32)
                    for s in streams
                ]
                done = pack_event_batch(streams, cap, out=buf)
            packed, counts = done
        else:
            packed, counts = pack_event_batch(streams, cap, out=buf)
        self._pack_buffers[self._buf_i] = packed
        targets = {"labels": np.stack(labels)}
        if valids:
            targets["valid"] = np.stack(valids)
        return packed, counts, targets

    def _encode(self, packed: np.ndarray, counts: np.ndarray) -> dict:
        """The transfer layout: bucketed (u32 words, or f32 with
        ``compact_transfer=False``) with its table and time spans, or the
        prefix layout of ``encode_for_transfer``."""
        cfg = self.cfg
        i = self._buf_i
        if not self.tiled:
            events, t_range, self._enc_buffers[i] = encode_for_transfer(
                packed, counts, cfg.compact_transfer,
                out=self._enc_buffers[i], codec="u32")
            return {"events": events, "t_range": t_range}
        hw = dict(height=cfg.sensor_height, width=cfg.sensor_width)
        if cfg.compact_transfer:
            # a bucketed layout always takes the u32 codec, whose sentinels
            # and explicit-window encoder the tiled contract needs
            enc, table, t_range, chunk_tr = bucket_pack_event_batch_u32(
                packed, counts, out=self._enc_buffers[i], **hw)
            self._enc_buffers[i] = enc
            events = enc.view(np.int32)
        else:
            events, table, t_range, chunk_tr = bucket_pack_event_batch(
                packed, counts, out=self._enc_buffers[i], **hw)
            self._enc_buffers[i] = events
        return {"events": events, "t_range": t_range, "tile_table": table,
                "tile_chunk_trange": chunk_tr}

    def __iter__(self) -> Iterator[dict]:
        cfg = self.cfg
        order = np.arange(len(self.source))
        if self.train:
            self.rng.shuffle(order)
        bs = self.batch_size
        cap = cfg.fix_events_num if self.train else cfg.val_fix_events_num
        if self.train:
            # erase_and_add can grow a stream by up to int(0.01 * n) events
            cap = cap + max(cap // 100, 1)
        label_h, label_w = cfg.label_size or (cfg.input_size, cfg.input_size)
        dev = self.device
        for b in range(len(self)):
            t0 = time.perf_counter()
            idx = order[b * bs:(b + 1) * bs]
            num_valid = len(idx)
            if len(idx) < bs:
                idx = np.concatenate([idx, order[:bs - len(idx)]])
            self._buf_i ^= 1
            packed, counts, targets = self._host_batch(idx, cap)
            if self.train:
                params = sample_view_params(
                    self.rng, len(idx), cfg.sensor_height, cfg.sensor_width,
                    scale_min=cfg.crop_min, device=dev)
            else:
                params = identity_view_params(
                    len(idx), cfg.sensor_height, cfg.sensor_width, dev)
            wire = {**self._encode(packed, counts), **targets,
                    "counts": counts}
            self.host_seconds += time.perf_counter() - t0
            self.batches += 1
            # copied even to the CPU, where the host buffers would be
            # aliased; a copy to the card from pageable memory returns once
            # it is done, so the buffers are free again when it returns
            t = {k: torch.from_numpy(np.ascontiguousarray(v)).to(
                dev, copy=True) for k, v in wire.items()}
            batch = _device_preprocess(
                t.pop("events"), t.pop("counts"), t.pop("labels"), params,
                num_bins=cfg.num_bins, height=cfg.sensor_height,
                width=cfg.sensor_width, out_size=cfg.input_size,
                task=cfg.task, label_h=label_h, label_w=label_w, **t,
            )
            batch["num_valid"] = num_valid
            yield batch


class SyntheticDenseSource:
    """Synthetic events and labels for smoke training (dense_pipeline.py:
    521-568, draw for draw): the events fill one quadrant of the sensor,
    and the label marks that quadrant (semseg: class 1-4 there, 0
    elsewhere; flow: a unit vector per quadrant)."""

    def __init__(self, task: str, n: int = 16, num_classes: int = 6,
                 sensor_hw: tuple[int, int] = (64, 64),
                 num_events: int = 4000, seed: int = 0,
                 cache: bool = False):
        self.task = task
        self.n = n
        self.num_classes = num_classes
        self.sensor_hw = sensor_hw
        self.num_events = num_events
        self.seed = seed
        self._cache: Optional[dict[int, dict]] = {} if cache else None

    def __len__(self) -> int:
        return self.n

    def load(self, index: int) -> dict:
        if self._cache is not None:
            if index not in self._cache:
                self._cache[index] = self._generate(index)
            return self._cache[index]
        return self._generate(index)

    def _generate(self, index: int) -> dict:
        rng = np.random.default_rng(self.seed + index)
        h, w = self.sensor_hw
        qy, qx = rng.integers(0, 2), rng.integers(0, 2)
        y = rng.uniform(qy * h / 2, (qy + 1) * h / 2, self.num_events)
        x = rng.uniform(qx * w / 2, (qx + 1) * w / 2, self.num_events)
        t = np.sort(rng.uniform(0, 1, self.num_events))
        p = rng.integers(0, 2, self.num_events)
        events = np.stack([x, y, t, p], 1)
        yy, xx = np.mgrid[0:h, 0:w]
        region = ((yy >= qy * h / 2) & (yy < (qy + 1) * h / 2)
                  & (xx >= qx * w / 2) & (xx < (qx + 1) * w / 2))
        if self.task == "semseg":
            label = np.where(region, (qy * 2 + qx) + 1, 0).astype(np.int32)
            return {"events": events, "label": label}
        flow = np.zeros((h, w, 2), np.float32)
        flow[region] = [qx * 2 - 1, qy * 2 - 1]
        return {"events": events, "flow": flow,
                "valid": np.ones((h, w), np.float32)}
