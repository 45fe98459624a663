"""Pretrain input pipeline for the rec phase (EF-ImageNet-format tensors).

Counterpart of eventpretrain_tpu/data/pretrain_pipeline.py:41-141 and
144-273: per-image directories hold precomputed noisy event voxel grids and
temporal-difference sub-frames. The host loads arrays (sequentially, or on
the pool of ``data/io_pool.py``, whose loads draw no random numbers) and
samples one ``ViewParams`` per sample with numpy, draw for draw as in
JAX; the device applies the coupled augments to the whole batch: the grid
nearest (negated on time-flip for 5/6-bin signed grids) and the sub-frame
bicubic (sign-flipped on time-flip). The contrastive phases' CLIP embeddings come
with slice 4.
"""

from __future__ import annotations

import dataclasses
import os
from typing import Iterator, Optional

import numpy as np
import torch

from eventpretrain_tpu_torch.data.io_pool import make_pool, map_loads
from eventpretrain_tpu_torch.ops.view_augment import (
    apply_frame_augment,
    apply_view_augment,
    identity_view_params,
    sample_view_params,
)


@dataclasses.dataclass(frozen=True)
class PretrainDataConfig:
    num_bins: int = 5
    input_size: int = 224
    crop_min: float = 0.8
    # host->device dtype of the grids: "bfloat16" halves the bytes and is
    # exact for a bf16 model (the nearest augment does no arithmetic and
    # the first conv casts to bf16 anyway); frames stay f32 (loss targets)
    transfer_dtype: str = "float32"


class PretrainPipeline:
    """Yields ``{'evg', 'frame'}`` batches on ``device`` for the rec step."""

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
        pool = make_pool(self.num_workers)
        try:
            for b in range(len(self)):
                idx = order[b * bs:(b + 1) * bs]
                evgs, frames = [], []
                for item in map_loads(self.source.load, idx, pool):
                    evg = np.asarray(item["evg"], np.float32)
                    if cfg.num_bins == 1:
                        evg = evg.sum(axis=-1, keepdims=True)
                    evgs.append(evg)
                    frames.append(np.asarray(item["frame"], np.float32))
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
                frame = torch.from_numpy(np.stack(frames)).to(self.device)
                yield {
                    "evg": apply_view_augment(
                        evg, params, size, "nearest",
                        negate_on_tflip=cfg.num_bins in (5, 6),
                    ),
                    "frame": apply_frame_augment(frame, params, size,
                                                 "bicubic"),
                }
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
                          <sub_frames_dir>/<image>_0K_sub_frame.pt}

    CHW tensors are returned channels-last. The frame index K is drawn from
    (seed, index, visit), so thread-pool loads stay deterministic.
    """

    def __init__(self, root: str, noisy_events_dir: str = "events/noisy",
                 sub_frames_dir: str = "sub_frames", num_frames: int = 10,
                 seed: int = 0, fixed_frame: Optional[int] = None):
        import threading

        self.root = root
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
        frame = _load_tensor(os.path.join(
            base, self.sub_frames_dir,
            f"{image_name}_0{frame_index}_sub_frame.pt"))
        return {"evg": self._to_hwc(evg), "frame": self._to_hwc(frame)}


class SyntheticPretrainSource:
    """Structured synthetic voxel grids and difference frames for smoke
    runs, the JAX source's draws (pretrain_pipeline.py:243-273): a few
    signed Gaussian blobs per sample, the frame their per-pixel net
    polarity, so the reconstruction loss has learnable signal."""

    def __init__(self, n: int = 64, size: int = 224, num_bins: int = 5,
                 seed: int = 0):
        self.n = n
        self.size = size
        self.num_bins = num_bins
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
        return {"evg": evg, "frame": frame}
