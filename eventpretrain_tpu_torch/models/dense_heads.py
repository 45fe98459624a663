"""Dense prediction heads: UPerHead (pyramid pooling + FPN) and FCNHead,
channels-last.

Counterpart of eventpretrain_tpu/models/dense_heads.py:21-158, with the
parameter names the exporter writes (``decode_head.psp_modules.0.1.
conv_layer.weight``, ``...norm_layer.running_mean``), so a JAX-trained
head, BatchNorm running statistics included, loads strictly.

Two behaviours follow flax rather than torch's defaults:

* :class:`BatchNorm` is flax's ``nn.BatchNorm`` (dense_heads.py:56-60):
  statistics in f32 with var = E[x^2] - E[x]^2 (biased), eps 1e-5, and in
  training the running statistics move by ``0.99 * running + 0.01 *
  batch`` with the biased variance. ``nn.BatchNorm2d`` would move them by
  0.1 with the unbiased variance and diverge from flax's ``batch_stats``.
* The heads' dropout is flax's ``Dropout(broadcast_dims=(1, 2))``: one
  keep draw per (sample, channel). Its masks come from a
  :class:`~eventpretrain_tpu_torch.models.layers.DropPathSource` (a
  generator on the device, or masks replayed in call order), never from
  torch's global RNG.
"""

from __future__ import annotations

from typing import Optional, Sequence

import torch
import torch.nn.functional as F
from torch import nn

from eventpretrain_tpu_torch.models.layers import Conv2d, DropPathSource
from eventpretrain_tpu_torch.ops.reshape import resize

# the pyramid-pooling scales of every UPerHead of the repo
POOL_SCALES = (1, 2, 3, 6)


def adaptive_avg_pool(x: torch.Tensor, out_hw: tuple[int, int]
                      ) -> torch.Tensor:
    """``nn.AdaptiveAvgPool2d`` on ``(B, H, W, C)``: bin ``i`` of ``out``
    spans ``[floor(i * size / out), ceil((i + 1) * size / out))``."""
    def pool_axis(arr, size, out, axis):
        chunks = []
        for i in range(out):
            start = (i * size) // out
            end = -(-((i + 1) * size) // out)
            chunks.append(arr.narrow(axis, start, end - start).mean(
                dim=axis, keepdim=True))
        return torch.cat(chunks, dim=axis)

    x = pool_axis(x, x.shape[1], out_hw[0], 1)
    return pool_axis(x, x.shape[2], out_hw[1], 2)


class AdaptiveAvgPool(nn.Module):
    """The pooling stage of a pyramid-pooling branch (no parameters)."""

    def __init__(self, out_size: int):
        super().__init__()
        self.out_size = out_size

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return adaptive_avg_pool(x, (self.out_size, self.out_size))


class BatchNorm(nn.Module):
    """flax ``nn.BatchNorm`` over the channels of ``(B, H, W, C)``, in f32,
    returning f32; see the module docstring. The running statistics are
    buffers (``running_mean``, ``running_var``), updated in place in
    training mode and used in eval mode."""

    def __init__(self, channels: int, momentum: float = 0.99,
                 eps: float = 1e-5, device=None):
        super().__init__()
        self.momentum = momentum
        self.eps = eps
        self.weight = nn.Parameter(torch.ones(channels, device=device))
        self.bias = nn.Parameter(torch.zeros(channels, device=device))
        self.register_buffer("running_mean",
                             torch.zeros(channels, device=device))
        self.register_buffer("running_var",
                             torch.ones(channels, device=device))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = x.float()
        if self.training:
            dims = tuple(range(x.ndim - 1))
            mean = x.mean(dim=dims)
            var = torch.clamp_min((x * x).mean(dim=dims) - mean * mean, 0.0)
            with torch.no_grad():
                self.running_mean.mul_(self.momentum).add_(
                    (1.0 - self.momentum) * mean.detach())
                self.running_var.mul_(self.momentum).add_(
                    (1.0 - self.momentum) * var.detach())
        else:
            mean, var = self.running_mean, self.running_var
        mul = torch.rsqrt(var + self.eps) * self.weight
        return (x - mean) * mul + self.bias


class ConvModule(nn.Module):
    """conv -> BatchNorm (f32) -> ReLU (dense_heads.py:41-61), computed in
    ``dtype`` around the f32 statistics."""

    def __init__(self, in_channels: int, out_channels: int, kernel_size: int,
                 padding: int = 0, *, dtype=torch.float32, device=None):
        super().__init__()
        self.compute_dtype = dtype
        self.conv_layer = Conv2d(in_channels, out_channels, kernel_size, 1,
                                 padding=padding, dtype=dtype, device=device)
        self.norm_layer = BatchNorm(out_channels, device=device)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = self.conv_layer(x.permute(0, 3, 1, 2)).permute(0, 2, 3, 1)
        return F.relu(self.norm_layer(x).to(self.compute_dtype))


class ChannelDropout(nn.Module):
    """Dropout of whole channels per sample (flax ``Dropout`` with
    ``broadcast_dims=(1, 2)`` on ``(B, H, W, C)``), active in training
    mode only; keep masks ``(B, C)`` come from ``source``."""

    def __init__(self, rate: float):
        super().__init__()
        self.rate = rate
        self.source: Optional[DropPathSource] = None

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if self.rate == 0.0 or not self.training:
            return x
        keep_prob = 1.0 - self.rate
        source = self.source or DropPathSource()
        keep = source.draw((x.shape[0], x.shape[-1]), keep_prob, x.device)
        keep = keep[:, None, None, :]
        return torch.where(keep, x / keep_prob, torch.zeros_like(x))


def set_dropout_source(module: nn.Module,
                       source: Optional[DropPathSource]) -> None:
    """Point every ``ChannelDropout`` of ``module`` at ``source`` (one
    shared source: masks are drawn or replayed in call order, the decode
    head's first)."""
    for m in module.modules():
        if isinstance(m, ChannelDropout):
            m.source = source


class UPerHead(nn.Module):
    """Pyramid pooling on the coarsest level, top-down FPN fusion, all
    levels concatenated at the finest resolution (dense_heads.py:64-122).
    ``inputs``: the channels-last pyramid, finest first."""

    def __init__(self, in_channels: Sequence[int], channels: int,
                 num_classes: int, dropout_ratio: float = 0.1,
                 sample_mode: str = "bilinear", *, dtype=torch.float32,
                 device=None):
        super().__init__()
        kw = dict(dtype=dtype, device=device)
        self.sample_mode = sample_mode
        top = in_channels[-1]
        self.psp_modules = nn.ModuleList(
            nn.Sequential(AdaptiveAvgPool(s), ConvModule(top, channels, 1,
                                                         **kw))
            for s in POOL_SCALES)
        self.psp_bottleneck = ConvModule(
            top + len(POOL_SCALES) * channels, channels, 3, padding=1, **kw)
        self.lateral_convs = nn.ModuleList(
            ConvModule(c, channels, 1, **kw) for c in in_channels[:-1])
        self.fpn_convs = nn.ModuleList(
            ConvModule(channels, channels, 3, padding=1, **kw)
            for _ in in_channels[:-1])
        self.fpn_bottleneck = ConvModule(
            len(in_channels) * channels, channels, 3, padding=1, **kw)
        self.dropout = ChannelDropout(dropout_ratio)
        self.conv_dense = Conv2d(channels, num_classes, 1, 1, **kw)

    def forward(self, inputs: Sequence[torch.Tensor]) -> torch.Tensor:
        top = inputs[-1]
        size = tuple(top.shape[1:3])
        psp = [top] + [resize(m(top), size, self.sample_mode)
                       for m in self.psp_modules]
        psp = self.psp_bottleneck(torch.cat(psp, dim=-1))
        laterals = [conv(inputs[i])
                    for i, conv in enumerate(self.lateral_convs)]
        laterals.append(psp)
        for i in range(len(laterals) - 1, 0, -1):
            laterals[i - 1] = laterals[i - 1] + resize(
                laterals[i], tuple(laterals[i - 1].shape[1:3]),
                self.sample_mode)
        outs = [conv(laterals[i]) for i, conv in enumerate(self.fpn_convs)]
        outs.append(laterals[-1])
        size = tuple(outs[0].shape[1:3])
        for i in range(len(outs) - 1, 0, -1):
            outs[i] = resize(outs[i], size, self.sample_mode)
        feats = self.dropout(self.fpn_bottleneck(torch.cat(outs, dim=-1)))
        return self.conv_dense(feats.permute(0, 3, 1, 2)).permute(0, 2, 3, 1)


class FCNHead(nn.Module):
    """The auxiliary head on pyramid level ``in_index``
    (dense_heads.py:125-158): one 3x3 ConvModule, dropout, a 1x1 conv.
    JAX's ``num_convs``, ``kernel_size`` and ``concat_input``, which every
    hub leaves at 1, 3 and False, are not options here."""

    def __init__(self, in_channels: int, channels: int, num_classes: int,
                 in_index: int = 2, dropout_ratio: float = 0.1, *,
                 dtype=torch.float32, device=None):
        super().__init__()
        kw = dict(dtype=dtype, device=device)
        self.in_index = in_index
        self.convs = nn.ModuleList(
            [ConvModule(in_channels, channels, 3, padding=1, **kw)])
        self.dropout = ChannelDropout(dropout_ratio)
        self.conv_dense = Conv2d(channels, num_classes, 1, 1, **kw)

    def forward(self, inputs: Sequence[torch.Tensor]) -> torch.Tensor:
        feats = self.dropout(self.convs[0](inputs[self.in_index]))
        return self.conv_dense(feats.permute(0, 3, 1, 2)).permute(0, 2, 3, 1)
