"""Batched view augmentation (crop -> resize -> hflip -> time-flip), plain
PyTorch.

Counterpart of eventpretrain_tpu/ops/view_augment.py:27-313. Parameters
are drawn on the host with numpy, draw for draw as in JAX
(``sample_view_params``), and held as per-sample tensors; crop and resize
of a whole batch are two dense contractions with per-sample ``(out,
full)`` resampling matrices, which are torch-exact (``F.interpolate`` of
the crop, taps clamped to the crop border).
"""

from __future__ import annotations

import math
from typing import NamedTuple

import numpy as np
import torch


class ViewParams(NamedTuple):
    """Per-sample view-augmentation parameters (all tensors have leading B)."""

    crop_y: torch.Tensor  # int32 (B,)
    crop_x: torch.Tensor  # int32 (B,)
    crop_h: torch.Tensor  # int32 (B,)
    crop_w: torch.Tensor  # int32 (B,)
    hflip: torch.Tensor   # bool  (B,)
    tflip: torch.Tensor   # bool  (B,)


def identity_view_params(batch: int, height: int, width: int,
                         device=None) -> ViewParams:
    """Resize-only parameters (validation path)."""
    zeros = torch.zeros((batch,), dtype=torch.int32, device=device)
    no = torch.zeros((batch,), dtype=torch.bool, device=device)
    return ViewParams(
        crop_y=zeros,
        crop_x=zeros,
        crop_h=torch.full((batch,), height, dtype=torch.int32, device=device),
        crop_w=torch.full((batch,), width, dtype=torch.int32, device=device),
        hflip=no,
        tflip=no,
    )


def _cubic_w(frac: torch.Tensor, a: float = -0.75) -> torch.Tensor:
    """4-tap cubic-convolution weights (torch's bicubic, a = -0.75)."""

    def cc1(x):  # |x| <= 1
        return ((a + 2.0) * x - (a + 3.0)) * x * x + 1.0

    def cc2(x):  # 1 < |x| < 2
        return ((a * x - 5.0 * a) * x + 8.0 * a) * x - 4.0 * a

    return torch.stack(
        [cc2(frac + 1.0), cc1(frac), cc1(1.0 - frac), cc2(2.0 - frac)],
        dim=-1,
    )


def _resample_weights(crop0: torch.Tensor, crop_len: torch.Tensor,
                      out_len: int, full_len: int,
                      mode: str) -> torch.Tensor:
    """``(B, out_len, full_len)`` torch-convention resampling matrices.

    Source positions are computed inside each sample's crop window and every
    tap is clamped to the crop, so crop-then-resize replicates the crop
    border and never reads the surrounding canvas:
      nearest : src = floor(i * crop/out)
      bilinear: src = max((i+0.5) * crop/out - .5, 0), taps i0, i0+1
      bicubic : src = (i+0.5) * crop/out - .5, taps i0-1 .. i0+2, a=-0.75
    """
    dev = crop_len.device
    crop0 = crop0.long()[:, None, None]
    crop_len = crop_len.long()
    if mode == "nearest":
        src = (torch.arange(out_len, device=dev)[None] * crop_len[:, None]
               ) // out_len
        src = torch.minimum(src, crop_len[:, None] - 1)[..., None]
        taps = src + crop0
        weights = torch.ones(taps.shape, dtype=torch.float32, device=dev)
    else:
        i = torch.arange(out_len, dtype=torch.float32, device=dev)[None]
        src = (i + 0.5) * crop_len.float()[:, None] / out_len - 0.5
        if mode == "bilinear":
            src = torch.clamp_min(src, 0.0)
            i0 = torch.floor(src)
            frac = src - i0
            offs = torch.arange(2, device=dev)
            weights = torch.stack([1.0 - frac, frac], dim=-1)
        elif mode == "bicubic":
            i0 = torch.floor(src)
            frac = src - i0
            offs = torch.arange(-1, 3, device=dev)
            weights = _cubic_w(frac)
        else:
            raise ValueError(f"unknown resize mode: {mode}")
        taps = i0.long()[..., None] + offs
        hi = (crop_len - 1)[:, None, None]
        taps = torch.minimum(torch.clamp_min(taps, 0), hi) + crop0
    out = torch.zeros((crop_len.shape[0], out_len, full_len),
                      dtype=torch.float32, device=dev)
    return out.scatter_add_(2, taps, weights)


def apply_view_augment(views: torch.Tensor, params: ViewParams,
                       out_size: tuple[int, int], mode: str = "nearest", *,
                       negate_on_tflip: bool = True) -> torch.Tensor:
    """Crop -> resize -> hflip -> time-flip of a batch ``(B, H, W, C)``.

    Time-flip reverses the channel (bin) order and, for temporally-signed
    grids, negates the values; pass ``negate_on_tflip=False`` for
    count-based representations.
    """
    out_h, out_w = out_size
    _, h, w, _ = views.shape
    w_y = _resample_weights(params.crop_y, params.crop_h, out_h, h, mode)
    w_x = _resample_weights(params.crop_x, params.crop_w, out_w, w, mode)
    out = torch.einsum("boh,bhwc->bowc", w_y, views.float())
    out = torch.einsum("bowc,bpw->bopc", out, w_x)
    if views.dtype.is_floating_point:
        out = out.to(views.dtype)
    else:
        out = torch.round(out).to(views.dtype)  # nearest: exact one-hots
    hflip = params.hflip.view(-1, 1, 1, 1)
    out = torch.where(hflip, out.flip(2), out)
    flipped = -out.flip(3) if negate_on_tflip else out.flip(3)
    return torch.where(params.tflip.view(-1, 1, 1, 1), flipped, out)


def sample_crop(rng: np.random.Generator, height: int, width: int,
                scale: tuple[float, float] = (0.8, 1.0),
                ratio: tuple[float, float] = (3 / 4, 4 / 3)
                ) -> tuple[int, int, int, int]:
    """One random-resized-crop box ``(y, x, h, w)``, drawn with the JAX
    package's draws in the same order (view_augment.py:38-65): 10 attempts,
    aspect scaled by the sensor's w/h, a 50% side swap, else the full
    view."""
    area = width * height
    for _ in range(10):
        target_area = rng.uniform(scale[0], scale[1]) * area
        aspect = rng.uniform(width / height * ratio[0],
                             width / height * ratio[1])
        crop_w = int(round(math.sqrt(target_area * aspect)))
        crop_h = int(round(math.sqrt(target_area / aspect)))
        if rng.integers(0, 10) < 5:
            crop_w, crop_h = crop_h, crop_w
        if crop_w < width and crop_h < height:
            x0 = int(rng.integers(0, width - crop_w))
            y0 = int(rng.integers(0, height - crop_h))
            return y0, x0, crop_h, crop_w
    return 0, 0, height, width


def sample_view_params(rng: np.random.Generator, batch: int, height: int,
                       width: int, scale_min: float = 0.8,
                       hflip_prob: float = 0.5, tflip_prob: float = 0.5,
                       device=None) -> ViewParams:
    """A batch of view parameters drawn on the host from ``rng``
    (view_augment.py:68-89: the same draws as JAX for the same seed)."""
    boxes = np.array(
        [sample_crop(rng, height, width, (scale_min, 1.0))
         for _ in range(batch)],
        np.int32,
    ).reshape(batch, 4)
    hflip = rng.random(batch) < hflip_prob
    tflip = rng.random(batch) < tflip_prob

    def t(a):
        return torch.from_numpy(np.ascontiguousarray(a)).to(device)

    return ViewParams(crop_y=t(boxes[:, 0]), crop_x=t(boxes[:, 1]),
                      crop_h=t(boxes[:, 2]), crop_w=t(boxes[:, 3]),
                      hflip=t(hflip), tflip=t(tflip))


def apply_frame_augment(frames: torch.Tensor, params: ViewParams,
                        out_size: tuple[int, int],
                        mode: str = "bicubic") -> torch.Tensor:
    """Augment target frames coupled to an event view (view_augment.py:
    230-253): the same crop and hflip; a time-flipped view flips the
    temporal-difference frame's sign (no channel reversal)."""
    out = apply_view_augment(frames, params._replace(
        tflip=torch.zeros_like(params.tflip)), out_size, mode)
    return torch.where(params.tflip.view(-1, 1, 1, 1), -out, out)


def apply_semseg_label_augment(labels: torch.Tensor, params: ViewParams,
                               out_size: tuple[int, int]) -> torch.Tensor:
    """Augment integer label maps ``(B, H, W)`` coupled to an event view
    (view_augment.py:256-274): the same crop, a nearest resize and the
    same hflip; a time flip leaves labels alone."""
    out = apply_view_augment(
        labels[..., None], params._replace(
            tflip=torch.zeros_like(params.tflip)),
        out_size, "nearest", negate_on_tflip=False)
    return out[..., 0]


def apply_flow_label_augment(flows: torch.Tensor, params: ViewParams,
                             out_size: tuple[int, int], *,
                             use_tflip: bool = True) -> torch.Tensor:
    """Augment flow fields ``(B, H, W, 2)`` coupled to an event view
    (view_augment.py:277-305): the same crop and a nearest resize, the
    vectors scaled by ``(out_w / crop_w, out_h / crop_h)``; a horizontal
    flip mirrors the field and negates u, a time flip negates both
    components."""
    out_h, out_w = out_size
    no = torch.zeros_like(params.hflip)
    out = apply_view_augment(flows, params._replace(hflip=no, tflip=no),
                             out_size, "nearest", negate_on_tflip=False)
    cw, ch = params.crop_w.float(), params.crop_h.float()
    # tensor by tensor: a python number over a tensor is its reciprocal
    # times the number in torch, an ulp off JAX's quotient
    scale = torch.stack([torch.full_like(cw, out_w) / cw,
                         torch.full_like(ch, out_h) / ch], dim=-1)
    out = out * scale[:, None, None, :].to(out.dtype)
    mirror = torch.tensor([-1.0, 1.0], dtype=out.dtype, device=out.device)
    out = torch.where(params.hflip.view(-1, 1, 1, 1), out.flip(2) * mirror,
                      out)
    if use_tflip:
        out = torch.where(params.tflip.view(-1, 1, 1, 1), -out, out)
    return out


def apply_flow_valid_augment(valid: torch.Tensor, params: ViewParams,
                             out_size: tuple[int, int]) -> torch.Tensor:
    """Augment flow validity masks ``(B, H, W)`` as label maps
    (view_augment.py:308-313)."""
    return apply_semseg_label_augment(valid, params, out_size)
