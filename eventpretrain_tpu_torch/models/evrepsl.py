"""The EvRepSL representation network (EffWNet, "RepGen"), channels-last.

Counterpart of eventpretrain_tpu/models/evrepsl.py: an EfficientNet-style
W-Net over the 3-channel EvRep image that returns ``concat(x, clean_ie,
C)``, a 5-channel representation, applied frozen before the
classification backbone (``--use_evrepsl``). The factory's config: 12
channels at the first level, 4 levels, bilinear upsampling, matrix C;
6.66 M parameters in 571 tensors.

It copies flax's conventions where they differ from torch's defaults:

- ``GroupNorm(num_groups=1)`` has ε = 1e-6 and computes its statistics
  in f32 (``GroupNorm``);
- ``max_pool`` takes VALID windows, so at 224 px the levels are 224, 74,
  24, 12 and 6, and the edge rows past the last whole window are
  dropped;
- ``UpMB`` upsamples with ``jax.image.resize(..., "linear")``
  (half-pixel centres, ``ops.reshape.resize``), then zero-pads to its
  skip's size;
- ``MBConv`` adds its residual only where the shapes match.

Parameter names are the flax module names, as JAX's exporter writes them
(``inc.conv1.weight``, ``down_0.mbconv_0.fused.conv.weight``,
``up_2.mbconv_1.se.fc1.weight``, ``c_out.c2.gn.bias``, ...). Every conv
and Dense computes in ``dtype`` from f32 parameters (``layers.Conv2d``,
``layers.Linear``). The network is plain PyTorch, as JAX's is plain flax.
"""

from __future__ import annotations

import collections
from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from eventpretrain_tpu_torch.models.convvit import conv_nhwc
from eventpretrain_tpu_torch.models.layers import Conv2d, Linear, init_weights
from eventpretrain_tpu_torch.ops.reshape import resize


class GroupNorm(nn.Module):
    """flax ``GroupNorm(num_groups=1)`` over a ``(B, H, W, C)`` tensor:
    each sample normalised over all its values in f32 (ε = 1e-6), a scale
    and a bias a channel; returns the input's dtype."""

    def __init__(self, channels: int, eps: float = 1e-6, device=None):
        super().__init__()
        self.eps = eps
        self.weight = nn.Parameter(torch.ones(channels, device=device))
        self.bias = nn.Parameter(torch.zeros(channels, device=device))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = F.group_norm(x.float().permute(0, 3, 1, 2), 1, self.weight,
                         self.bias, self.eps)
        return y.permute(0, 2, 3, 1).to(x.dtype)


def _conv(cin: int, cout: int, k: int, groups: int = 1, bias: bool = True,
          **kw) -> Conv2d:
    """A stride-1 conv padded by ``k // 2`` (flax's "SAME" at odd k)."""
    return Conv2d(cin, cout, k, 1, k // 2, groups=groups, bias=bias, **kw)


class DoubleConv(nn.Module):
    """(3x3 conv, GroupNorm, SiLU) twice, the convs without bias."""

    def __init__(self, cin: int, cout: int, mid: Optional[int] = None, **kw):
        super().__init__()
        mid = mid or cout
        dev = kw.get("device")
        self.conv1 = _conv(cin, mid, 3, bias=False, **kw)
        self.gn1 = GroupNorm(mid, device=dev)
        self.conv2 = _conv(mid, cout, 3, bias=False, **kw)
        self.gn2 = GroupNorm(cout, device=dev)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = F.silu(self.gn1(conv_nhwc(self.conv1, x)))
        return F.silu(self.gn2(conv_nhwc(self.conv2, x)))


class ConvNormAct(nn.Module):
    """A k x k conv with bias (``groups``), GroupNorm, SiLU unless
    ``act`` is False."""

    def __init__(self, cin: int, cout: int, k: int = 3, groups: int = 1,
                 act: bool = True, **kw):
        super().__init__()
        self.act = act
        self.conv = _conv(cin, cout, k, groups=groups, **kw)
        self.gn = GroupNorm(cout, device=kw.get("device"))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = self.gn(conv_nhwc(self.conv, x))
        return F.silu(x) if self.act else x


class SEBlock(nn.Module):
    """Squeeze and excitation: the spatial mean, two bias-free Dense
    layers (ReLU, sigmoid) to a channel gate."""

    def __init__(self, channels: int, reduction: int = 12, **kw):
        super().__init__()
        self.fc1 = Linear(channels, max(channels // reduction, 1),
                          bias=False, **kw)
        self.fc2 = Linear(max(channels // reduction, 1), channels,
                          bias=False, **kw)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = torch.sigmoid(self.fc2(F.relu(self.fc1(x.mean(dim=(1, 2))))))
        return x * y[:, None, None, :]


class MBConv(nn.Module):
    """Inverted bottleneck at ``expansion`` x its input's channels:
    "depthwise" (1x1 ``pw``, 3x3 depthwise ``dw``, ``se``, 1x1 ``out``) or
    "fused" (3x3 ``fused``, ``se``, 1x1 ``out``); the residual where the
    shapes match."""

    def __init__(self, cin: int, cout: int, mbc_type: str = "depthwise",
                 expansion: int = 4, **kw):
        super().__init__()
        e = cin * expansion
        self.mbc_type = mbc_type
        if mbc_type == "depthwise":
            self.pw = ConvNormAct(cin, e, 1, **kw)
            self.dw = ConvNormAct(e, e, 3, groups=e, **kw)
        else:
            self.fused = ConvNormAct(cin, e, 3, **kw)
        self.se = SEBlock(e, **kw)
        self.out = ConvNormAct(e, cout, 1, act=False, **kw)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if self.mbc_type == "depthwise":
            y = self.dw(self.pw(x))
        else:
            y = self.fused(x)
        y = self.out(self.se(y))
        return x + y if x.shape == y.shape else y


class DownMB(nn.Sequential):
    """A VALID ``pool_size`` max-pool, then ``n_repeats`` MBConvs."""

    def __init__(self, cin: int, cout: int, mbc_type: str, expansion: int,
                 n_repeats: int = 2, pool_size: int = 2, **kw):
        super().__init__(collections.OrderedDict(
            (f"mbconv_{i}", MBConv(cin if i == 0 else cout, cout, mbc_type,
                                   expansion, **kw))
            for i in range(n_repeats)))
        self.pool_size = pool_size

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        p = self.pool_size
        x = F.max_pool2d(x.permute(0, 3, 1, 2), p, p).permute(0, 2, 3, 1)
        return super().forward(x)


class UpMB(nn.Sequential):
    """``x1`` resized by ``scale_factor`` (half-pixel linear), zero-padded
    to ``x2``'s size (the odd pixel after), ``concat(x2, x1)``, then
    ``n_repeats`` MBConvs at ``in_channels``, the last to
    ``out_channels``."""

    def __init__(self, in_channels: int, out_channels: int, mbc_type: str,
                 expansion: int, n_repeats: int = 2, scale_factor: int = 2,
                 **kw):
        super().__init__(collections.OrderedDict(
            (f"mbconv_{i}", MBConv(
                in_channels,
                out_channels if i == n_repeats - 1 else in_channels,
                mbc_type, expansion, **kw))
            for i in range(n_repeats)))
        self.scale_factor = scale_factor

    def forward(self, x1: torch.Tensor, x2: torch.Tensor) -> torch.Tensor:
        _, h, w, _ = x1.shape
        s = self.scale_factor
        x1 = resize(x1, (h * s, w * s), "bilinear")
        dy = x2.shape[1] - x1.shape[1]
        dx = x2.shape[2] - x1.shape[2]
        x1 = F.pad(x1, (0, 0, dx // 2, dx - dx // 2, dy // 2, dy - dy // 2))
        return super().forward(torch.cat([x2, x1], dim=-1))


class OutIE(nn.Module):
    """3x3 conv (no bias), GroupNorm, SiLU, 3x3 conv to ``cout``."""

    def __init__(self, cin: int, cout: int, **kw):
        super().__init__()
        self.conv1 = _conv(cin, cin, 3, bias=False, **kw)
        self.gn1 = GroupNorm(cin, device=kw.get("device"))
        self.conv2 = _conv(cin, cout, 3, **kw)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = F.silu(self.gn1(conv_nhwc(self.conv1, x)))
        return conv_nhwc(self.conv2, x)


class OutMatrixC(nn.Module):
    """Two 1x1 ``ConvNormAct`` (the second without SiLU), then ReLU."""

    def __init__(self, cin: int, mid: int, cout: int, **kw):
        super().__init__()
        self.c1 = ConvNormAct(cin, mid, 1, **kw)
        self.c2 = ConvNormAct(mid, cout, 1, act=False, **kw)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.relu(self.c2(self.c1(x)))


# the W-Net's levels (evrepsl.py:208-215)
_REP_DOWN = (2, 2, 4, 4, 6)
_TYPES = ("fused", "fused", "depthwise", "depthwise", "depthwise")
_REP_UP = (6, 4, 4, 2, 2)
_EXPANSIONS = (1, 2, 4, 4, 6)
_POOLS = (3, 3, 2, 2, 5)
_FACTOR = 2  # bilinear


class EffWNet(nn.Module):
    """evrepsl.py:198-246: ``x (B, H, W, n_channels)`` -> ``concat(x,
    clean_ie, C)`` (B, H, W, n_channels + 2 * out_depth), in the dtype
    both promote to."""

    def __init__(self, n_channels: int = 3, out_depth: int = 1,
                 n_lyr: int = 4, ch1: int = 12, *, dtype=torch.float32,
                 device="cuda"):
        super().__init__()
        kw = dict(dtype=dtype, device=device)
        self.n_lyr = n_lyr
        chs = [ch1 * 2 ** p for p in range(n_lyr + 1)]
        self.inc = DoubleConv(n_channels, chs[0], **kw)
        level = [chs[0]]
        for i in range(n_lyr):
            out = chs[i + 1] // _FACTOR if i == n_lyr - 1 else chs[i + 1]
            self.add_module(f"down_{i}", DownMB(
                level[-1], out, _TYPES[i], _EXPANSIONS[i], _REP_DOWN[i],
                _POOLS[i], **kw))
            level.append(out)
        for prefix in ("up", "c_up"):
            h = level[-1]
            for i in range(n_lyr):
                rev = n_lyr - i - 1
                out = chs[rev] if i == n_lyr - 1 else chs[rev] // _FACTOR
                self.add_module(f"{prefix}_{i}", UpMB(
                    h + level[rev], out, _TYPES[rev], _EXPANSIONS[rev],
                    _REP_UP[i], _POOLS[rev], **kw))
                h = out
        self.out_clean_ie = OutIE(chs[0], out_depth, **kw)
        self.c_out = OutMatrixC(chs[0], chs[0] // 2, out_depth, **kw)

    def _ups(self, prefix: str, xs: list) -> torch.Tensor:
        h = xs[-1]
        for i in range(self.n_lyr):
            h = getattr(self, f"{prefix}_{i}")(h, xs[self.n_lyr - i - 1])
        return h

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        xs = [self.inc(x)]
        for i in range(self.n_lyr):
            xs.append(getattr(self, f"down_{i}")(xs[-1]))
        clean_ie = self.out_clean_ie(self._ups("up", xs))
        c = self.c_out(self._ups("c_up", xs))
        dt = torch.promote_types(x.dtype, clean_ie.dtype)
        return torch.cat([x.to(dt), clean_ie.to(dt), c.to(dt)], dim=-1)


def evrepsl_net(*, dtype=torch.float32, device="cuda",
                generator: Optional[torch.Generator] = None) -> EffWNet:
    """evrepsl.py:249-251: EffWNet(3 channels in, depth 1 out, 4 levels,
    12 channels first) on ``device`` (the card unless the caller asks for
    the CPU), f32 parameters computed in ``dtype``, randomly initialised
    from ``generator`` (a CPU generator; seed 0 when None) as flax's
    defaults draw: LeCun-normal kernels, zero biases, GroupNorm 1 and 0."""
    net = EffWNet(n_channels=3, out_depth=1, n_lyr=4, ch1=12, dtype=dtype,
                  device=device)
    init_weights(net, generator or torch.Generator().manual_seed(0))
    return net
