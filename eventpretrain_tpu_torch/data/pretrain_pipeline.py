"""Pretrain input pipeline of the three stages (EF-ImageNet-format
tensors).

Counterpart of eventpretrain_tpu/data/pretrain_pipeline.py:41-141 and
144-273: per-image directories hold precomputed noisy event voxel grids,
temporal-difference sub-frames and CLIP token embeddings. The host loads
arrays (sequentially, or on the pool of ``data/io_pool.py``, whose loads
draw no random numbers) and samples one ``ViewParams`` per sample with
numpy, draw for draw as in JAX; the device applies the coupled augments to
the whole batch: the grid nearest (negated on time-flip for 5/6-bin signed
grids) and the sub-frame bicubic (sign-flipped on time-flip). The phase
picks what a batch holds: the frame where it reconstructs (``rec``,
``rec+con``), the precomputed CLIP embeddings, un-augmented f32 (1 + L,
512) token rows, where it contrasts (``adj``, ``con``, ``rec+con``).

The ECDP baseline's pipelines (pretrain_pipeline.py:276-345, 594-722)
yield two independently augmented views of each sample, ``img_q`` and
``img_k``, each normalised as ``(x / (amax + 1) - 0.5) * 2``, with the
CLIP class-token embedding (B, 512): from the precomputed 2-channel grids,
or from the raw streams through the 2-channel count image (K3).

The raw N-ImageNet path of ``adj-n`` and ``con-n`` (pretrain_pipeline.py:
354-500, 725-781) builds its grids from event streams instead: on the
host a fixed-count window, the C++ erase-and-add augment and packing
(``native``), the coordinates rescaled from the sensor to the input size
and the u32 encoding; on the device the cls pipeline's
``_device_preprocess`` at the input-size canvas, which rasterises through
K3. The paired image rides along, and ``ClipEncodingPipeline`` turns it
into CLIP's token embeddings on the device, inside the epoch loop.
"""

from __future__ import annotations

import dataclasses
import os
import time
from typing import Iterator, Optional

import numpy as np
import torch

from eventpretrain_tpu_torch.data.cls_pipeline import _device_preprocess
from eventpretrain_tpu_torch.data.codec import encode_for_transfer
from eventpretrain_tpu_torch.data.event_transforms import (
    erase_and_add_events,
)
from eventpretrain_tpu_torch.data.io_pool import make_pool, map_loads
from eventpretrain_tpu_torch.data.representations import (
    normalize_representation,
)
from eventpretrain_tpu_torch.models.clip import encode_images
from eventpretrain_tpu_torch.native import (
    augment_pack_event_batch,
    pack_event_batch,
)
from eventpretrain_tpu_torch.ops.view_augment import (
    apply_frame_augment,
    apply_view_augment,
    identity_view_params,
    sample_view_params,
)


@dataclasses.dataclass(frozen=True)
class PretrainDataConfig:
    pr_phase: str = "rec"  # rec | adj | con | rec+con
    num_bins: int = 5
    input_size: int = 224
    crop_min: float = 0.8
    # host->device dtype of the grids: "bfloat16" halves the bytes and is
    # exact for a bf16 model (the nearest augment does no arithmetic and
    # the first conv casts to bf16 anyway); frames and CLIP embeddings stay
    # f32 (loss targets)
    transfer_dtype: str = "float32"


class PretrainPipeline:
    """Yields batches on ``device`` for the phase's step: ``evg`` and, by
    ``cfg.pr_phase``, ``frame`` and ``clip_emb``."""

    def __init__(self, source, cfg: PretrainDataConfig, batch_size: int,
                 train: bool = True, seed: int = 0, num_workers: int = 8,
                 device="cuda"):
        self.source = source
        self.cfg = cfg
        self.batch_size = batch_size
        self.train = train
        self.rng = np.random.default_rng(seed)
        self.device = torch.device(device)
        self.num_workers = num_workers

    def __len__(self) -> int:
        return len(self.source) // self.batch_size

    def __iter__(self) -> Iterator[dict]:
        cfg = self.cfg
        order = np.arange(len(self.source))
        if self.train:
            self.rng.shuffle(order)
        bs = self.batch_size
        tdtype = (torch.bfloat16 if cfg.transfer_dtype == "bfloat16"
                  else torch.float32)
        need_frame = cfg.pr_phase in ("rec", "rec+con")
        need_clip = cfg.pr_phase in ("adj", "con", "rec+con")
        pool = make_pool(self.num_workers)
        try:
            for b in range(len(self)):
                idx = order[b * bs:(b + 1) * bs]
                evgs, frames, clips = [], [], []
                for item in map_loads(self.source.load, idx, pool):
                    evg = np.asarray(item["evg"], np.float32)
                    if cfg.num_bins == 1:
                        evg = evg.sum(axis=-1, keepdims=True)
                    evgs.append(evg)
                    if need_frame:
                        frames.append(np.asarray(item["frame"], np.float32))
                    if need_clip:
                        clips.append(np.asarray(item["clip_emb"],
                                                np.float32))
                evg = torch.from_numpy(np.stack(evgs)).to(tdtype)
                evg = evg.to(self.device, non_blocking=True)
                h, w = evg.shape[1], evg.shape[2]
                if self.train:
                    params = sample_view_params(
                        self.rng, len(idx), h, w, scale_min=cfg.crop_min,
                        device=self.device,
                    )
                else:
                    params = identity_view_params(len(idx), h, w,
                                                  self.device)
                size = (cfg.input_size, cfg.input_size)
                batch = {"evg": apply_view_augment(
                    evg, params, size, "nearest",
                    negate_on_tflip=cfg.num_bins in (5, 6),
                )}
                if need_frame:
                    frame = torch.from_numpy(np.stack(frames)).to(
                        self.device)
                    batch["frame"] = apply_frame_augment(frame, params, size,
                                                         "bicubic")
                if need_clip:
                    batch["clip_emb"] = torch.from_numpy(
                        np.stack(clips)).to(self.device)
                yield batch
        finally:
            if pool is not None:
                pool.shutdown(wait=True)


class EcdpPretrainPipeline:
    """ECDP batches ``{'img_q', 'img_k': (B, S, S, C), 'clip_emb': (B,
    512)}`` on ``device`` from precomputed grids (pretrain_pipeline.py:
    276-345): each view's grids from a load of its own (one pool round a
    view, so sources with stochastic frames give the views their own),
    the view parameters drawn for q then k, the nearest view augment and
    the per-image normalisation; the CLIP embedding from the q loads, its
    class token where the source holds the token grid."""

    def __init__(self, source, cfg: PretrainDataConfig, batch_size: int,
                 train: bool = True, seed: int = 0, num_workers: int = 8,
                 device="cuda"):
        self.source = source
        self.cfg = cfg
        self.batch_size = batch_size
        self.train = train
        self.rng = np.random.default_rng(seed)
        self.num_workers = num_workers
        self.device = torch.device(device)

    def __len__(self) -> int:
        return len(self.source) // self.batch_size

    def __iter__(self) -> Iterator[dict]:
        cfg = self.cfg
        order = np.arange(len(self.source))
        if self.train:
            self.rng.shuffle(order)
        bs = self.batch_size
        size = (cfg.input_size, cfg.input_size)
        pool = make_pool(self.num_workers)
        try:
            for b in range(len(self)):
                idx = order[b * bs:(b + 1) * bs]
                views, clips = ([], []), []
                for v in range(2):
                    for item in map_loads(self.source.load, idx, pool):
                        views[v].append(np.asarray(item["evg"], np.float32))
                        if v == 0:
                            clip = np.asarray(item["clip_emb"], np.float32)
                            clips.append(clip[0] if clip.ndim == 2 else clip)
                out = []
                for v in range(2):
                    evg = torch.from_numpy(np.stack(views[v])).to(
                        self.device, non_blocking=True)
                    h, w = evg.shape[1], evg.shape[2]
                    params = (sample_view_params(
                        self.rng, len(idx), h, w, scale_min=cfg.crop_min,
                        device=self.device) if self.train
                        else identity_view_params(len(idx), h, w,
                                                  self.device))
                    out.append(normalize_representation(apply_view_augment(
                        evg, params, size, "nearest",
                        negate_on_tflip=cfg.num_bins in (5, 6)), 2))
                yield {"img_q": out[0], "img_k": out[1],
                       "clip_emb": torch.from_numpy(np.stack(clips)).to(
                           self.device)}
        finally:
            if pool is not None:
                pool.shutdown(wait=True)


def _load_tensor(path: str) -> np.ndarray:
    if path.endswith(".pt"):
        return torch.load(path, map_location="cpu",
                          weights_only=False).numpy()
    return np.load(path)


class EFImageNetSource:
    """The reference EF-ImageNet layout (pretrain_pipeline.py:153-240):

    root/<class>/<image>/{<noisy_dir>/<image>_0K_noisy_events_voxel_grid.pt,
                          <sub_frames_dir>/<image>_0K_sub_frame.pt,
                          <image>_clip_emb.pt}

    CHW tensors are returned channels-last. The frame index K is drawn from
    (seed, index, visit), so thread-pool loads stay deterministic. The
    sub-frame is loaded for the phases that reconstruct, the CLIP
    embedding (squeezed) for those that contrast (``pr_phase``).
    """

    def __init__(self, root: str, pr_phase: str = "rec",
                 noisy_events_dir: str = "events/noisy",
                 sub_frames_dir: str = "sub_frames", num_frames: int = 10,
                 seed: int = 0, fixed_frame: Optional[int] = None):
        import threading

        self.root = root
        self.pr_phase = pr_phase
        self.noisy_events_dir = noisy_events_dir
        self.sub_frames_dir = sub_frames_dir
        self.num_frames = num_frames
        self.seed = seed
        self.fixed_frame = fixed_frame
        self._visits: dict[int, int] = {}
        self._visits_lock = threading.Lock()
        self.items: list[tuple[str, str]] = []
        for cls in sorted(os.listdir(root)):
            for image_name in sorted(os.listdir(os.path.join(root, cls))):
                self.items.append((cls, image_name))

    def __len__(self) -> int:
        return len(self.items)

    @staticmethod
    def _to_hwc(arr: np.ndarray) -> np.ndarray:
        if arr.ndim == 3 and arr.shape[0] < arr.shape[-1]:
            return arr.transpose(1, 2, 0)
        return arr

    def load(self, index: int) -> dict:
        cls, image_name = self.items[index]
        base = os.path.join(self.root, cls, image_name)
        if self.fixed_frame is not None:
            frame_index = int(self.fixed_frame)
        else:
            with self._visits_lock:
                visit = self._visits.get(index, 0)
                self._visits[index] = visit + 1
            frame_index = int(np.random.default_rng(
                [self.seed, index, visit]).integers(0, self.num_frames))
        evg = _load_tensor(os.path.join(
            base, self.noisy_events_dir,
            f"{image_name}_0{frame_index}_noisy_events_voxel_grid.pt"))
        out = {"evg": self._to_hwc(evg)}
        if self.pr_phase in ("rec", "rec+con"):
            frame = _load_tensor(os.path.join(
                base, self.sub_frames_dir,
                f"{image_name}_0{frame_index}_sub_frame.pt"))
            out["frame"] = self._to_hwc(frame)
        if self.pr_phase in ("adj", "con", "rec+con"):
            clip = _load_tensor(os.path.join(base,
                                             f"{image_name}_clip_emb.pt"))
            out["clip_emb"] = np.squeeze(clip)
        return out


class SyntheticPretrainSource:
    """Structured synthetic voxel grids, difference frames and CLIP token
    embeddings for smoke runs, the JAX source's draws
    (pretrain_pipeline.py:243-273): a few signed Gaussian blobs per
    sample, the frame their per-pixel net polarity, so the reconstruction
    loss has learnable signal, then a (clip_tokens, clip_dim) standard
    normal draw."""

    def __init__(self, n: int = 64, size: int = 224, num_bins: int = 5,
                 clip_dim: int = 512, clip_tokens: int = 197, seed: int = 0):
        self.n = n
        self.size = size
        self.num_bins = num_bins
        self.clip_dim = clip_dim
        self.clip_tokens = clip_tokens
        self.seed = seed

    def __len__(self) -> int:
        return self.n

    def load(self, index: int) -> dict:
        rng = np.random.default_rng(self.seed + index)
        s = self.size
        evg = np.zeros((s, s, self.num_bins), np.float32)
        yy, xx = np.mgrid[0:s, 0:s]
        for _ in range(4):
            cy, cx = rng.uniform(0.2 * s, 0.8 * s, 2)
            sig = rng.uniform(0.03 * s, 0.1 * s)
            blob = np.exp(-((yy - cy) ** 2 + (xx - cx) ** 2)
                          / (2 * sig ** 2))
            sign = rng.choice([-1.0, 1.0])
            for c in range(self.num_bins):
                evg[..., c] += sign * blob * rng.uniform(0.5, 1.5)
        frame = evg.sum(axis=-1, keepdims=True) / self.num_bins
        clip = rng.normal(size=(self.clip_tokens, self.clip_dim)).astype(
            np.float32)
        return {"evg": evg, "frame": frame, "clip_emb": clip}


# ---------------------------------------------------------------------------
# The raw N-ImageNet path (adj-n / con-n): event streams and paired images,
# CLIP's embeddings computed in the loop on the device.
# ---------------------------------------------------------------------------


class NImageNetPairedSource:
    """Raw N-ImageNet ``.npz`` event streams and their ImageNet JPEGs
    (pretrain_pipeline.py:354-425): ``event_data``'s x, y, t, p fields with
    t in seconds, on the 480x640 sensor; the image of the same name under
    ``imagenet_root/<class>/<name>.JPEG``, its short side resized bicubic
    to 224 and centre-cropped (CLIP's normalisation runs on the device,
    ``models/clip.py::preprocess_images``), or, with ``clip_emb_root``,
    the precomputed ``<class>/<name>/<name>_clip_emb.pt`` embedding
    instead. Exactly one of the two roots is given. PIL is imported when
    an image is read."""

    SENSOR_HW = (480, 640)

    def __init__(self, n_imagenet_root: str,
                 imagenet_root: Optional[str] = None,
                 num_classes: Optional[int] = None,
                 clip_emb_root: Optional[str] = None):
        if (imagenet_root is None) == (clip_emb_root is None):
            raise ValueError("pass exactly one of imagenet_root / "
                             "clip_emb_root")
        self.n_imagenet_root = n_imagenet_root
        self.imagenet_root = imagenet_root
        self.clip_emb_root = clip_emb_root
        classes = sorted(os.listdir(n_imagenet_root))
        if num_classes is not None:
            classes = classes[:num_classes]
        self.files: list[tuple[str, str]] = []
        for cls in classes:
            for f in sorted(os.listdir(os.path.join(n_imagenet_root, cls))):
                if f.endswith(".npz"):
                    self.files.append((cls, f[:-4]))

    def __len__(self) -> int:
        return len(self.files)

    def load(self, index: int) -> dict:
        cls, name = self.files[index]
        raw = np.load(os.path.join(self.n_imagenet_root, cls, name + ".npz"))
        ev = raw["event_data"]
        events = np.stack(
            [ev["x"], ev["y"], ev["t"].astype(np.float64) / 1e6, ev["p"]],
            axis=1,
        ).astype(np.float64)
        out = {"events": events, "hw": self.SENSOR_HW}
        if self.clip_emb_root is not None:
            emb = _load_tensor(os.path.join(self.clip_emb_root, cls, name,
                                            name + "_clip_emb.pt"))
            out["clip_emb"] = np.squeeze(np.asarray(emb, np.float32))
        else:
            out["image"] = self._load_image(cls, name)
        return out

    def _load_image(self, cls: str, name: str) -> np.ndarray:
        from PIL import Image

        path = os.path.join(self.imagenet_root, cls, name + ".JPEG")
        img = Image.open(path).convert("RGB")
        w, h = img.size
        scale = 224 / min(w, h)
        img = img.resize((round(w * scale), round(h * scale)),
                         Image.Resampling.BICUBIC)
        w, h = img.size
        left, top = (w - 224) // 2, (h - 224) // 2
        return np.asarray(img.crop((left, top, left + 224, top + 224)),
                          np.uint8)


class SyntheticRawPretrainSource:
    """Synthetic raw event streams and paired uint8 224x224 images for smoke
    runs, the JAX source's draws (pretrain_pipeline.py:428-452)."""

    def __init__(self, n: int = 64, hw: tuple = (128, 128),
                 num_events: int = 8192, seed: int = 0):
        self.n = n
        self.hw = hw
        self.num_events = num_events
        self.seed = seed

    def __len__(self) -> int:
        return self.n

    def load(self, index: int) -> dict:
        rng = np.random.default_rng(self.seed + index)
        h, w = self.hw
        n = self.num_events
        events = np.stack([
            rng.uniform(0, w - 1, n),
            rng.uniform(0, h - 1, n),
            np.sort(rng.uniform(0, 0.05, n)),
            rng.choice([-1.0, 1.0], n),
        ], axis=1)
        image = rng.integers(0, 256, (224, 224, 3), dtype=np.uint8)
        return {"events": events, "image": image, "hw": self.hw}


def _rescale_packed_coords(packed: np.ndarray, hws, out_size: int) -> None:
    """Scale a packed (B, E, 4) f32 batch's x and y in place from each
    sample's sensor ``(h, w)`` to ``out_size`` (pretrain_pipeline.py:455-
    462: the reference's events_reshape, after the stream augment and
    before rasterising at the input size); the factors in f32."""
    hw = np.asarray(hws, np.float32)  # (B, 2) = (h, w)
    packed[:, :, 0] *= (out_size / hw[:, 1])[:, None]
    packed[:, :, 1] *= (out_size / hw[:, 0])[:, None]


@dataclasses.dataclass(frozen=True)
class RawPretrainDataConfig:
    """pretrain_pipeline.py:725-734 without the fields that no caller
    sets, which are constants here: the grid is rasterised at the input
    size whatever the sensor (``canvas_height``/``canvas_width`` are read
    by nothing), the training stream augment is on (``stream_augment``),
    and the words travel in the u32 codec (``compact_transfer``,
    ``transfer_codec``)."""

    num_bins: int = 5
    input_size: int = 224
    crop_min: float = 0.8
    fix_events_num: int = 30000


def _pack_capacity(cap: int, augmenting: bool) -> int:
    """The packing capacity of ``cap``-event windows: erase_and_add can
    grow a full window by up to 1%."""
    return cap + max(cap // 100, 1) if augmenting else cap


def _draw_windows(rng, streams, cap: int, random_start: bool) -> list:
    """Each stream's window of ``cap`` events, in stream order: from a
    random start where ``random_start`` and the stream is longer, else
    from its first event."""
    windows = []
    for ev in streams:
        n = ev.shape[0]
        start = int(rng.integers(0, n - cap)) if random_start and n > cap \
            else 0
        windows.append((start, min(start + cap, n)))
    return windows


def _pack_windows(rng, streams, windows, hws, capacity: int,
                  augmenting: bool, out=None):
    """``(packed, counts)`` of the streams' windows: with ``augmenting``
    through the C++ erase-and-add augment with one seed a sample (the numpy
    augment under ``"numpy-forced"``), else the plain packing; into
    ``out`` where its shape fits."""
    if augmenting:
        seeds = rng.integers(0, 2 ** 63, len(streams))
        done = augment_pack_event_batch(streams, windows, hws, capacity,
                                        seeds, out=out)
        if done is not None:
            return done
        # "numpy-forced": the numpy specification
        return pack_event_batch([
            erase_and_add_events(
                rng, s[a:b].astype(np.float64), hw).astype(np.float32)
            for s, (a, b), hw in zip(streams, windows, hws)
        ], capacity, out=out)
    return pack_event_batch([s[a:b] for s, (a, b) in zip(streams, windows)],
                            capacity, out=out)


class RawPretrainPipeline:
    """Raw-event batches ``{'evg': (B, S, S, bins) f32, 'image': (B, 224,
    224, 3) uint8}`` on ``device`` for ``adj-n`` and ``con-n``, S =
    ``cfg.input_size`` (pretrain_pipeline.py:465-591).

    The host, in the JAX pipeline's order of draws: the epoch's shuffle;
    the loads on the pool of ``data/io_pool.py`` (they draw nothing); each
    sample's window of ``fix_events_num`` events from a random start (in
    training, where the stream is longer), in index order on this thread;
    the C++ erase-and-add augment and packing with one seed a sample and
    1% of packing headroom (``native.augment_pack_event_batch``; the numpy
    augment under ``"numpy-forced"``), or the plain packing without the
    augment; the coordinates rescaled in place to S; the view parameters;
    the transfer encoding. Packing and encoding write two host buffers in
    turns. The device decodes the words and rasterises them on the S x S
    canvas through K3, then crops, resizes and flips
    (``cls_pipeline._device_preprocess``, nearest). ``host_seconds`` and
    ``batches`` add up the host time spent building batches."""

    def __init__(self, source, cfg: RawPretrainDataConfig, batch_size: int,
                 train: bool = True, seed: int = 0, num_workers: int = 8,
                 device="cuda"):
        self.source = source
        self.cfg = cfg
        self.batch_size = batch_size
        self.train = train
        self.rng = np.random.default_rng(seed)
        self.num_workers = num_workers
        self.device = torch.device(device)
        self._pack_buffers = [None, None]
        self._enc_buffers = [None, None]
        self._buf_i = 0
        self.host_seconds = 0.0
        self.batches = 0

    def __len__(self) -> int:
        return max(len(self.source) // self.batch_size, 1)

    def __iter__(self) -> Iterator[dict]:
        cfg = self.cfg
        order = np.arange(len(self.source))
        if self.train:
            self.rng.shuffle(order)
        bs = self.batch_size
        cap = cfg.fix_events_num
        pack_cap = _pack_capacity(cap, self.train)
        size = cfg.input_size
        dev = self.device
        pool = make_pool(self.num_workers)
        try:
            for b in range(len(self)):
                t0 = time.perf_counter()
                idx = order[b * bs:(b + 1) * bs]
                streams, hws, images = [], [], []
                for item in map_loads(self.source.load, idx, pool):
                    streams.append(np.asarray(item["events"]).astype(
                        np.float32))
                    hws.append(tuple(item["hw"]))
                    images.append(np.asarray(item["image"], np.uint8))
                windows = _draw_windows(self.rng, streams, cap, self.train)
                self._buf_i ^= 1
                i = self._buf_i
                packed, counts = _pack_windows(
                    self.rng, streams, windows, hws, pack_cap, self.train,
                    out=self._pack_buffers[i])
                self._pack_buffers[i] = packed
                _rescale_packed_coords(packed, hws, size)
                if self.train:
                    params = sample_view_params(
                        self.rng, len(idx), size, size,
                        scale_min=cfg.crop_min, device=dev)
                else:
                    params = identity_view_params(len(idx), size, size, dev)
                events, t_range, self._enc_buffers[i] = encode_for_transfer(
                    packed, counts, True, out=self._enc_buffers[i],
                    codec="u32")
                image = np.stack(images)
                self.host_seconds += time.perf_counter() - t0
                self.batches += 1
                # the host buffers are read here and not after: a copy to
                # the card from pageable memory returns once it is done,
                # and on the CPU the rasterisation makes new tensors
                evg = _device_preprocess(
                    torch.from_numpy(events).to(dev),
                    torch.from_numpy(counts).to(dev),
                    torch.from_numpy(
                        np.full((len(idx), 2), size, np.int32)).to(dev),
                    params, num_bins=cfg.num_bins, height=size, width=size,
                    out_size=size, mode="nearest",
                    t_range=torch.from_numpy(t_range).to(dev))
                yield {"evg": evg, "image": torch.from_numpy(image).to(dev)}
        finally:
            if pool is not None:
                pool.shutdown(wait=True)


class EcdpRawPretrainPipeline:
    """Raw ECDP batches ``{'img_q', 'img_k': (B, S, S, 2) f32, 'image':
    (B, 224, 224, 3) uint8}`` on ``device``, or ``'clip_emb'`` (B, 512) in
    place of the image where the source holds precomputed embeddings
    (pretrain_pipeline.py:594-722), S = ``cfg.input_size``.

    Each view of a batch, q then k, from the once-loaded streams, in the
    JAX pipeline's order of draws: each sample's window of
    ``fix_events_num`` events (a random start wherever the stream is
    longer, also in evaluation), the C++ erase-and-add augment with one
    seed a sample in training (1% of packing headroom), the coordinates
    rescaled to S, the view parameters; then on the device the 2-channel
    count image on the S x S canvas through K3, the nearest view augment
    and the per-image normalisation (``cls_pipeline._device_preprocess``
    with ``num_bins=2``). The packed f32 events cross as they are, as in
    JAX. Packing writes one host buffer, read before the next view packs.
    ``host_seconds`` and ``batches`` add up the host time spent building
    batches."""

    def __init__(self, source, cfg: RawPretrainDataConfig, batch_size: int,
                 train: bool = True, seed: int = 0, num_workers: int = 8,
                 device="cuda"):
        self.source = source
        self.cfg = cfg
        self.batch_size = batch_size
        self.train = train
        self.rng = np.random.default_rng(seed)
        self.num_workers = num_workers
        self.device = torch.device(device)
        self._pack_buffer = None
        self.host_seconds = 0.0
        self.batches = 0

    def __len__(self) -> int:
        return max(len(self.source) // self.batch_size, 1)

    def _one_view(self, streams, hws) -> torch.Tensor:
        cfg = self.cfg
        t0 = time.perf_counter()
        windows = _draw_windows(self.rng, streams, cfg.fix_events_num, True)
        packed, counts = _pack_windows(
            self.rng, streams, windows, hws,
            _pack_capacity(cfg.fix_events_num, self.train), self.train,
            out=self._pack_buffer)
        self._pack_buffer = packed
        _rescale_packed_coords(packed, hws, cfg.input_size)
        size = cfg.input_size
        dev = self.device
        if self.train:
            params = sample_view_params(self.rng, len(streams), size, size,
                                        scale_min=cfg.crop_min, device=dev)
        else:
            params = identity_view_params(len(streams), size, size, dev)
        self.host_seconds += time.perf_counter() - t0
        # the buffer is read here and not after: a copy to the card from
        # pageable memory returns once it is done, and on the CPU the
        # rasterisation makes new tensors
        return _device_preprocess(
            torch.from_numpy(packed).to(dev),
            torch.from_numpy(counts).to(dev),
            torch.from_numpy(np.full((len(streams), 2), size,
                                     np.int32)).to(dev),
            params, num_bins=2, height=size, width=size, out_size=size,
            mode="nearest")

    def __iter__(self) -> Iterator[dict]:
        order = np.arange(len(self.source))
        if self.train:
            self.rng.shuffle(order)
        bs = self.batch_size
        pool = make_pool(self.num_workers)
        try:
            for b in range(len(self)):
                t0 = time.perf_counter()
                idx = order[b * bs:(b + 1) * bs]
                streams, hws, extras = [], [], []
                for item in map_loads(self.source.load, idx, pool):
                    streams.append(np.ascontiguousarray(item["events"],
                                                        np.float32))
                    hws.append(tuple(item["hw"]))
                    if "clip_emb" in item:
                        emb = np.asarray(item["clip_emb"], np.float32)
                        extras.append(emb[0] if emb.ndim == 2 else emb)
                    else:
                        extras.append(np.asarray(item["image"], np.uint8))
                self.host_seconds += time.perf_counter() - t0
                out = {"img_q": self._one_view(streams, hws),
                       "img_k": self._one_view(streams, hws)}
                key = "clip_emb" if extras[0].ndim == 1 else "image"
                out[key] = torch.from_numpy(np.stack(extras)).to(self.device)
                self.batches += 1
                yield out
        finally:
            if pool is not None:
                pool.shutdown(wait=True)


class ClipEncodingPipeline:
    """Wraps a ``{'evg', 'image', ...}`` pipeline and yields its batches
    with ``clip_emb`` in place of ``image``: the frozen CLIP tower's
    projected token sequence (B, 1 + L, D) in its compute dtype, or with
    ``cls_only`` the class token's (B, D) (pretrain_pipeline.py:737-781).
    uint8 images are divided by 255 before CLIP's preprocessing.

    The encode runs under ``torch.no_grad()`` inside ``__iter__``: grad
    mode is a thread's own, and the prefetcher iterates the pipeline in
    its producer thread. (``inference_mode`` would make the embeddings
    tensors that autograd may not save, and the contrastive heads'
    LayerNorm saves its input.)"""

    def __init__(self, inner, clip_model: torch.nn.Module,
                 cls_only: bool = False):
        self.inner = inner
        self.clip_model = clip_model
        self.cls_only = cls_only

    def __len__(self) -> int:
        return len(self.inner)

    def __iter__(self) -> Iterator[dict]:
        for batch in self.inner:
            out = {k: v for k, v in batch.items() if k != "image"}
            with torch.no_grad():
                emb = encode_images(self.clip_model, batch["image"])
            out["clip_emb"] = emb[:, 0, :] if self.cls_only else emb
            yield out
