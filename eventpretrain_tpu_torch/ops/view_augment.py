"""Batched view augmentation (crop -> resize -> hflip -> time-flip), plain
PyTorch.

Counterpart of eventpretrain_tpu/ops/view_augment.py:27-227. Parameters are
per-sample tensors; crop and resize of a whole batch are two dense
contractions with per-sample ``(out, full)`` resampling matrices, which are
torch-exact (``F.interpolate`` of the crop, taps clamped to the crop
border).
"""

from __future__ import annotations

from typing import NamedTuple

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
