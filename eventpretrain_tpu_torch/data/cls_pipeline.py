"""Classification input pipeline: host windowing, stream augment, packing
and encoding; device decode, rasterisation, view augment and
normalisation.

Counterpart of eventpretrain_tpu/data/cls_pipeline.py: ``ClsDataConfig``
:48-87, ``_device_preprocess`` :95-132, ``ClsPipeline`` :135-363 (train
and eval, the wrapped tail batch with ``num_valid``, the three sensor
rules, the coordinate rescale), ``NCarsSource`` :366-388 and
``SyntheticClsSource`` :391-420; the other sources are in
``data/cls_sources.py``. The host draws every random number with
the JAX pipeline's ``numpy.random.Generator`` calls in the same order, so
one seed gives the same windows, augmented streams and views. The stream
augment and the packing are the C++ passes of
``eventpretrain_tpu_torch.native`` (cls_pipeline.py:258-286), fed the
seeds drawn here, so the batches are the JAX pipeline's word for word when
its library builds too; with ``native.BACKEND = "numpy-forced"`` they are
its numpy fallback's. Loads run on the pool of ``data/io_pool.py``.

The sensor box each sample is augmented and viewed at comes from the
window's maxima (``infer_sensor_size``, N-Cars' rule), from the
dataset's fixed sensor (``sensor_height``/``sensor_width``), or from the
canvas; without a rescale it is clamped to the canvas. Under an active
rescale (``rescale_to_input``: "always" for N-ImageNet, "ecdp" for the
2-bin image of CIFAR10-DVS, DVS128 and UCF101-DVS) the packed
coordinates are scaled from the sensor to ``input_size`` after the
stream augment, in f64 and floored on the host, and rasterised at the
input's resolution (cls_pipeline.py:298-315).

Not ported yet: EvRep (it comes with the EvRepSL network).
"""

from __future__ import annotations

import dataclasses
import os
import time
from typing import Iterator, Optional, Sequence

import numpy as np
import torch

from eventpretrain_tpu_torch.data.codec import (
    decode_events_u16,
    decode_events_u32,
    encode_for_transfer,
)
from eventpretrain_tpu_torch.data.event_transforms import (
    erase_and_add_events,
    random_window,
)
from eventpretrain_tpu_torch.data.io_pool import make_pool, map_loads
from eventpretrain_tpu_torch.data.representations import (
    build_representation,
    normalize_representation,
)
from eventpretrain_tpu_torch.native import (
    augment_pack_event_batch,
    pack_event_batch,
)
from eventpretrain_tpu_torch.ops.view_augment import (
    ViewParams,
    apply_view_augment,
    identity_view_params,
    sample_crop,
)


@dataclasses.dataclass(frozen=True)
class ClsDataConfig:
    num_classes: int
    num_bins: int = 5
    input_size: int = 224
    fix_events_num: int = 30000
    val_fix_events_num: int = 30000
    canvas_height: int = 128        # >= the dataset's largest sensor height
    canvas_width: int = 128
    resize_mode: str = "bilinear"
    crop_min: float = 0.8
    infer_sensor_size: bool = True  # N-Cars: from the window's maxima
    event_noise: bool = False       # robustness eval (--val_event_noise)
    compact_transfer: bool = True   # the transfer codec (data/codec.py)
    transfer_codec: str = "u32"     # "u32" (4 B/event) | "u16" (8 B/event)
    # the true sensor for the stream augment where it differs from the
    # canvas (fixed-sensor sources)
    sensor_height: Optional[int] = None
    sensor_width: Optional[int] = None
    # where the coordinates are rescaled to the input after the stream
    # augment: "always" (N-ImageNet), "ecdp" (num_bins == 2 only: CIFAR10-
    # DVS, DVS128, UCF101-DVS) or "never" (N-Cars, N-Caltech101, ES-ImageNet)
    rescale_to_input: str = "never"

    @property
    def rescale_active(self) -> bool:
        return self.rescale_to_input == "always" or (
            self.rescale_to_input == "ecdp" and self.num_bins == 2)


def eval_view_params(sensor_hw: torch.Tensor) -> ViewParams:
    """The evaluation view (cls_pipeline.py:223-226): the whole sensor box
    ``(0, 0, h, w)`` of each sample, no flips."""
    return identity_view_params(
        sensor_hw.shape[0], 0, 0, sensor_hw.device
    )._replace(
        crop_h=sensor_hw[:, 0].to(torch.int32),
        crop_w=sensor_hw[:, 1].to(torch.int32),
    )


def _device_preprocess(events: torch.Tensor, counts: torch.Tensor,
                       sensor_hw: torch.Tensor, params: ViewParams, *,
                       num_bins: int, height: int, width: int, out_size: int,
                       mode: str,
                       t_range: Optional[torch.Tensor] = None) -> torch.Tensor:
    """(B, E, 4) f32 events, or their u16 (B, E, 4) / u32 (B, E) words with
    ``t_range``, -> (B, out_size, out_size, C) f32 input."""
    if events.dtype in (torch.int16, torch.uint16):
        events = decode_events_u16(events, t_range)
    elif events.dtype in (torch.int32, torch.uint32):
        events = decode_events_u32(events, t_range)
    elif events.dtype != torch.float32:
        raise TypeError(f"events of {events.dtype}: expected f32 xytp or "
                        "the u16/u32 transfer words")
    evg = build_representation(
        events, counts, num_bins=num_bins, height=height, width=width,
        sensor_hw=sensor_hw,
    )
    evg = apply_view_augment(
        evg, params, (out_size, out_size), mode,
        negate_on_tflip=num_bins in (5, 6),
    )
    return normalize_representation(evg, num_bins)


class ClsPipeline:
    """Iterates batches ``{'evg': (B, S, S, C) f32, 'label': (B,) int64,
    'num_valid': int}`` on ``device``; a short tail batch is padded by
    wrapping to the front of the epoch's order and ``num_valid`` counts its
    real rows. ``host_seconds`` and ``batches`` add up the host time spent
    building batches (loads, windows, augment, packing, encoding)."""

    def __init__(self, source, cfg: ClsDataConfig, batch_size: int,
                 train: bool, seed: int = 0, drop_last: Optional[bool] = None,
                 num_workers: int = 8, device="cuda"):
        self.source = source
        self.cfg = cfg
        self.batch_size = batch_size
        self.train = train
        self.rng = np.random.default_rng(seed)
        self.drop_last = train if drop_last is None else drop_last
        self.num_workers = num_workers
        self.device = torch.device(device)
        # two of each host buffer, used in turns (as JAX does): a batch's
        # wire arrays are not written again while the next one is built
        self._pack_buffers = [None, None]
        self._enc_buffers = [None, None]
        self._buf_i = 0
        self.host_seconds = 0.0
        self.batches = 0

    def __len__(self) -> int:
        n = len(self.source)
        if self.drop_last:
            return n // self.batch_size
        return (n + self.batch_size - 1) // self.batch_size

    def _augmenting(self) -> bool:
        return self.train or self.cfg.event_noise

    def _load_sample(self, loaded):
        """(f32 stream, (start, end) window, sensor (h, w), label)."""
        cfg = self.cfg
        events, label = loaded
        events = np.ascontiguousarray(events, np.float32)
        cap = cfg.fix_events_num if self.train else cfg.val_fix_events_num
        start, end = random_window(self.rng, events.shape[0], cap)
        if cfg.infer_sensor_size:
            view = events[start:end]
            sensor_h = int(view[:, 1].max()) + 1
            sensor_w = int(view[:, 0].max()) + 1
        elif cfg.sensor_height is not None:
            sensor_h, sensor_w = cfg.sensor_height, cfg.sensor_width
        else:
            sensor_h, sensor_w = cfg.canvas_height, cfg.canvas_width
        if not cfg.rescale_active:
            # the sensor box must fit the canvas; under a rescale the
            # raster is at input_size, and the augment keeps the true size
            sensor_h = min(sensor_h, cfg.canvas_height)
            sensor_w = min(sensor_w, cfg.canvas_width)
        return events, (start, end), (sensor_h, sensor_w), label

    def _sample_view(self, sensor_hw: Sequence[tuple[int, int]]) -> ViewParams:
        cfg = self.cfg
        boxes, hflips, tflips = [], [], []
        for h, w in sensor_hw:
            if self.train:
                boxes.append(sample_crop(self.rng, h, w, (cfg.crop_min, 1.0)))
                hflips.append(self.rng.random() < 0.5)
                tflips.append(self.rng.random() < 0.5)
            else:
                boxes.append((0, 0, h, w))
                hflips.append(False)
                tflips.append(False)
        boxes = np.asarray(boxes, np.int32)

        def t(a):
            return torch.from_numpy(np.ascontiguousarray(a)).to(self.device)

        return ViewParams(crop_y=t(boxes[:, 0]), crop_x=t(boxes[:, 1]),
                          crop_h=t(boxes[:, 2]), crop_w=t(boxes[:, 3]),
                          hflip=t(np.asarray(hflips)),
                          tflip=t(np.asarray(tflips)))

    def _host_batch(self, loaded: list, cap: int):
        """Windows, stream augment and packing of one batch, in the JAX
        pipeline's order of draws: ``(packed, counts, hws, labels)``."""
        samples = [self._load_sample(item) for item in loaded]
        hws = [s[2] for s in samples]
        labels = [s[3] for s in samples]
        buf = self._pack_buffers[self._buf_i]
        if self._augmenting():
            # the JAX pipeline erases and adds under --val_event_noise too
            # (cls_pipeline.py:276-286); add_noise_events is not called
            seeds = self.rng.integers(0, 2 ** 63, len(samples))
            done = augment_pack_event_batch(
                [s[0] for s in samples], [s[1] for s in samples], hws, cap,
                seeds, out=buf)
            if done is None:  # "numpy-forced": the numpy specification
                streams = [
                    erase_and_add_events(
                        self.rng, ev[a:b].astype(np.float64), hw
                    ).astype(np.float32)
                    for ev, (a, b), hw, _ in samples
                ]
                done = pack_event_batch(streams, cap, out=buf)
            packed, counts = done
        else:
            streams = [ev[a:b].astype(np.float64).astype(np.float32)
                       for ev, (a, b), _, _ in samples]
            packed, counts = pack_event_batch(streams, cap, out=buf)
        self._pack_buffers[self._buf_i] = packed
        if self.cfg.rescale_active:
            hws = self._rescale(packed, hws)
        return packed, counts, hws, labels

    def _rescale(self, packed: np.ndarray, hws: list) -> list:
        """Scale the packed x, y from each sensor to ``input_size`` in
        place (padded rows stay 0) and return the input's boxes. The
        product runs in f64 and is floored here: every rasteriser truncates
        the coordinates, and the f32 store of an unfloored product could
        round 223.999... up across a pixel."""
        size = self.cfg.input_size
        hw = np.asarray(hws, np.float64)
        sx = (size / hw[:, 1])[:, None]
        sy = (size / hw[:, 0])[:, None]
        packed[:, :, 0] = np.floor(packed[:, :, 0].astype(np.float64) * sx)
        packed[:, :, 1] = np.floor(packed[:, :, 1].astype(np.float64) * sy)
        return [(size, size)] * len(hws)

    def __iter__(self) -> Iterator[dict]:
        cfg = self.cfg
        cap = cfg.fix_events_num if self.train else cfg.val_fix_events_num
        if self._augmenting():
            # erase_and_add can grow a full window by up to int(0.01 * n)
            # events: the packed capacity keeps that headroom
            cap = cap + max(cap // 100, 1)
        order = np.arange(len(self.source))
        if self.train:
            self.rng.shuffle(order)
        bs = self.batch_size
        pool = make_pool(self.num_workers)
        try:
            for b in range(len(self)):
                t0 = time.perf_counter()
                idx = order[b * bs:(b + 1) * bs]
                num_valid = len(idx)
                if len(idx) < bs:
                    idx = np.concatenate([idx, order[:bs - len(idx)]])
                # loads draw no random numbers, so a pool keeps the stream
                loaded = map_loads(self.source.load, idx, pool)
                self._buf_i ^= 1
                packed, counts, hws, labels = self._host_batch(loaded, cap)
                params = self._sample_view(hws)
                i = self._buf_i
                events, t_range, self._enc_buffers[i] = encode_for_transfer(
                    packed, counts, cfg.compact_transfer,
                    out=self._enc_buffers[i], codec=cfg.transfer_codec,
                )
                self.host_seconds += time.perf_counter() - t0
                self.batches += 1
                dev = self.device
                # the host buffers are read here and not after: a copy to
                # the card from pageable memory returns once it is done,
                # and on the CPU the rasterisation below makes new tensors
                evg = _device_preprocess(
                    torch.from_numpy(events).to(dev),
                    torch.from_numpy(counts).to(dev),
                    torch.from_numpy(np.asarray(hws, np.int32)).to(dev),
                    params, num_bins=cfg.num_bins,
                    height=cfg.canvas_height, width=cfg.canvas_width,
                    out_size=cfg.input_size, mode=cfg.resize_mode,
                    t_range=torch.from_numpy(t_range).to(dev),
                )
                yield {
                    "evg": evg,
                    "label": torch.from_numpy(
                        np.asarray(labels, np.int64)).to(dev),
                    "num_valid": num_valid,
                }
        finally:
            if pool is not None:
                pool.shutdown(wait=True)


class NCarsSource:
    """The N-Cars layout: ``root/<class>/<class>_*.npy`` of xytp rows
    (cls_pipeline.py:366-388)."""

    def __init__(self, root: str):
        self.root = root
        self.classes = sorted(os.listdir(root))
        self.files: list[tuple[str, int]] = []
        for label, cls in enumerate(self.classes):
            cls_dir = os.path.join(root, cls)
            for name in sorted(os.listdir(cls_dir)):
                self.files.append((os.path.join(cls_dir, name), label))

    def __len__(self) -> int:
        return len(self.files)

    def load(self, index: int) -> tuple[np.ndarray, int]:
        path, label = self.files[index]
        return np.load(path), label


class SyntheticClsSource:
    """Synthetic event streams with a flip-invariant class signature: class
    k scatters events around a (k+1) x (k+1) grid of blobs, so a few
    optimizer steps lift accuracy above chance (cls_pipeline.py:391-420,
    draw for draw)."""

    def __init__(self, num_classes: int = 2, samples_per_class: int = 32,
                 num_events: int = 3000,
                 sensor_hw: tuple[int, int] = (100, 120), seed: int = 0):
        self.num_classes = num_classes
        self.n = num_classes * samples_per_class
        self.num_events = num_events
        self.sensor_hw = sensor_hw
        self.seed = seed

    def __len__(self) -> int:
        return self.n

    def load(self, index: int) -> tuple[np.ndarray, int]:
        rng = np.random.default_rng(self.seed + index)
        label = index % self.num_classes
        h, w = self.sensor_hw
        side = label + 1
        centers_y = (np.arange(side) + 0.5) / side * h
        centers_x = (np.arange(side) + 0.5) / side * w
        cy = np.repeat(centers_y, side)
        cx = np.tile(centers_x, side)
        pick = rng.integers(0, side * side, self.num_events)
        sigma = min(h, w) / (6.0 * side)
        x = np.clip(cx[pick] + rng.normal(0, sigma, self.num_events), 0,
                    w - 1)
        y = np.clip(cy[pick] + rng.normal(0, sigma, self.num_events), 0,
                    h - 1)
        t = np.sort(rng.uniform(0, 1, self.num_events))
        p = rng.integers(0, 2, self.num_events)
        return np.stack([x, y, t, p], 1), label
