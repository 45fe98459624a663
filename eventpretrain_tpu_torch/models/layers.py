"""Transformer building blocks: patch embedding, attention, MLP, pre-norm
ViT block and stochastic depth.

Counterpart of eventpretrain_tpu/models/layers.py:87-429, with the same
parameter names (so reference / exported checkpoints load strictly) and
channels-last activations at the public boundary.

Dtypes follow flax's split between ``param_dtype`` and ``dtype``: every
parameter is stored in f32, and Linear and Conv weights and biases are cast
to the compute ``dtype`` at use (``Linear``, ``Conv2d``, and the K1/K2
wrappers receive ``w.to(dtype)``). So an optimizer updates the f32 copy,
and a weight's gradient is the compute-dtype gradient of the cast, upcast,
as under flax. Every LayerNorm computes in f32 and returns the activation
dtype.

``ViTBlock`` takes the LN-fused sub-block kernels K1
(``fused_ln_attn_layer``) and K2 (``fused_ln_mlp``), forward and backward,
under the JAX gates of layers.py:343-380: a 2-byte compute dtype, no active
dropout or drop-path, no attention weights requested, shapes inside
``supports_*`` (K1's with the backward kernels' shared-memory bound and
the LayerNorm backward's width, C <= 768, where autograd records the
block: gradients on and its input or a parameter requiring one, so a
frozen trunk under enabled gradients is held to the forward's gate only
and saves nothing). A block that cannot fuse runs the unfused composition,
whose parts take their own kernels under the JAX conditions:
``Attention`` takes K4 (``fused_attn_layer``, layers.py:249-276) when no
attention weights are requested and ``attn_drop`` is 0, as in training
with drop-path; ``Mlp`` takes K5 (``fused_mlp``, layers.py:155-176) in
deterministic (eval) calls, as in the last block of an attention-map
forward. The JAX package enables all of them only on a TPU; here they are
always eligible, and each wrapper runs its plain version on CPU tensors.
``ViTBlock(use_fused_layer=False)`` forces the plain composition for all
four, as ``force_xla()`` does in JAX. ``Attention(use_fused_kernel=True)``
opts into K7 (``fused_mha``, layers.py:202,299): a call that takes neither
K4 nor the explicit path for attention weights or dropout runs its
multi-head core through K7 when ``supports_fused_mha`` holds and the compute
dtype is bf16 (the port's CUDA kernels take bf16 only), and the plain
product otherwise. JAX's module docstring calls K7 the default TPU path,
but its code makes it opt-in, and no hub or CLI sets the flag; the port
follows the code. ``GroupedBatchNorm`` and ``ProjectorMlp`` (layers.py:444,
510) are the contrastive stages' projection heads.

Stochastic depth draws its per-sample keep masks from a
:class:`DropPathSource`: an explicit ``torch.Generator`` on the
activations' device, or masks given to it in call order (the replay that
holds the port against JAX and the kernel path against the plain path).
"""

from __future__ import annotations

import collections
from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from eventpretrain_tpu_torch.ops.common import grad_needed
from eventpretrain_tpu_torch.ops.fused_attn_layer import (
    fused_attn_layer,
    fused_ln_attn_layer,
    supports_fused_attn_layer,
    supports_fused_ln_attn_layer,
)
from eventpretrain_tpu_torch.ops.fused_mha import (
    fused_mha,
    supports_fused_mha,
)
from eventpretrain_tpu_torch.ops.fused_mlp import (
    fused_ln_mlp,
    fused_mlp,
    supports_fused_ln_mlp,
    supports_fused_mlp,
)


class Linear(nn.Linear):
    """``nn.Linear`` with f32 parameters, computed in ``dtype``."""

    def __init__(self, in_features: int, out_features: int,
                 bias: bool = True, *, dtype=torch.float32, device=None):
        super().__init__(in_features, out_features, bias, device=device,
                         dtype=torch.float32)
        self.compute_dtype = dtype

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        dt = self.compute_dtype
        bias = None if self.bias is None else self.bias.to(dt)
        return F.linear(x.to(dt), self.weight.to(dt), bias)


class Conv2d(nn.Conv2d):
    """``nn.Conv2d`` with f32 parameters, computed in ``dtype``;
    ``groups`` = ``in_channels`` is a depthwise conv."""

    def __init__(self, in_channels: int, out_channels: int, kernel_size: int,
                 stride: int, padding: int = 0, *, groups: int = 1,
                 bias: bool = True, dtype=torch.float32, device=None):
        super().__init__(in_channels, out_channels, kernel_size, stride,
                         padding, groups=groups, bias=bias, device=device,
                         dtype=torch.float32)
        self.compute_dtype = dtype

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        dt = self.compute_dtype
        bias = None if self.bias is None else self.bias.to(dt)
        return self._conv_forward(x.to(dt), self.weight.to(dt), bias)


def layer_norm(x: torch.Tensor, norm: nn.LayerNorm) -> torch.Tensor:
    """``norm(x)`` computed in f32, returned in ``x.dtype``."""
    return F.layer_norm(
        x.float(), norm.normalized_shape, norm.weight.float(),
        norm.bias.float(), norm.eps,
    ).to(x.dtype)


class DropPathSource:
    """Where every ``DropPath`` of a model (and every ``ChannelDropout`` of
    the dense heads) takes its keep masks, in call order: the entries of
    ``keep`` when given (a replay: a (S, B) bool tensor, or a sequence of
    masks of each call's shape; each call takes the next), else
    ``torch.rand(shape) < keep_prob`` drawn from ``generator``, which must
    live on the activations' device. With neither, a drawing call raises:
    nothing reads torch's global RNG."""

    def __init__(self, generator: Optional[torch.Generator] = None,
                 keep=None):
        self.generator = generator
        self.keep = keep
        self.used = 0

    def draw(self, shape, keep_prob: float,
             device: torch.device) -> torch.Tensor:
        shape = (shape,) if isinstance(shape, int) else tuple(shape)
        if self.keep is not None:
            if self.used >= len(self.keep):
                raise ValueError(
                    f"DropPathSource: {len(self.keep)} replayed keep "
                    "masks, but the model asks for more")
            mask = self.keep[self.used].to(device=device, dtype=torch.bool)
            if tuple(mask.shape) != shape:
                raise ValueError(f"DropPathSource: keep mask {self.used} is "
                                 f"{tuple(mask.shape)}, expected {shape}")
            self.used += 1
            return mask
        if self.generator is None:
            raise ValueError(
                "DropPath is active (training, rate > 0) but has no "
                "generator: call set_drop_path_source(model, "
                "DropPathSource(generator)) first")
        return torch.rand(shape, generator=self.generator,
                          device=device) < keep_prob


def drop_path(x: torch.Tensor, rate: float,
              source: DropPathSource) -> torch.Tensor:
    """Stochastic depth: drop the whole residual branch per sample, kept
    samples scaled by ``1 / keep_prob`` (layers.py:87-96)."""
    if rate == 0.0:
        return x
    keep_prob = 1.0 - rate
    keep = source.draw(x.shape[0], keep_prob, x.device)
    keep = keep.view((x.shape[0],) + (1,) * (x.ndim - 1))
    return torch.where(keep, x / keep_prob, torch.zeros_like(x))


class DropPath(nn.Module):
    """Per-sample stochastic depth, active in training mode only, drawing
    from ``source`` (see :func:`set_drop_path_source`)."""

    def __init__(self, rate: float = 0.0):
        super().__init__()
        self.rate = rate
        self.source: Optional[DropPathSource] = None

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if self.rate == 0.0 or not self.training:
            return x
        return drop_path(x, self.rate, self.source or DropPathSource())


def set_drop_path_source(module: nn.Module,
                         source: Optional[DropPathSource]) -> None:
    """Point every ``DropPath`` of ``module`` at ``source`` (one shared
    source, so masks are drawn or replayed in the model's call order)."""
    for m in module.modules():
        if isinstance(m, DropPath):
            m.source = source


class Mlp(nn.Module):
    """fc1 -> exact GELU -> dropout -> fc2 -> dropout (layers.py:109-182).
    Deterministic calls inside the K5 gate take ``fused_mlp``."""

    def __init__(self, dim: int, hidden_dim: int, dropout: float = 0.0, *,
                 dtype=torch.float32, device=None):
        super().__init__()
        kw = dict(dtype=dtype, device=device)
        self.compute_dtype = dtype
        self.fc1 = Linear(dim, hidden_dim, **kw)
        self.fc2 = Linear(hidden_dim, dim, **kw)
        self.drop = nn.Dropout(dropout)

    def forward(self, x: torch.Tensor, fused: bool = True) -> torch.Tensor:
        dt = self.compute_dtype
        if (fused and not self.training and x.ndim == 3
                and supports_fused_mlp(x.shape[1], x.shape[2],
                                       self.fc1.out_features, dt)):
            return fused_mlp(
                x.to(dt).contiguous(), self.fc1.weight.to(dt),
                self.fc1.bias.to(dt), self.fc2.weight.to(dt),
                self.fc2.bias.to(dt),
            )
        x = F.gelu(self.fc1(x), approximate="none")
        x = self.drop(x)
        return self.drop(self.fc2(x))


class Attention(nn.Module):
    """Multi-head self-attention with a packed qkv projection
    (layers.py:185-307). The softmax runs in f32. The routes, in JAX's
    order: with ``fused``, a call that needs no attention weights and no
    attention dropout, inside the K4 gate, takes ``fused_attn_layer``;
    otherwise a call that needs either takes the explicit softmax path;
    otherwise, with ``use_fused_kernel``, a bf16 call inside
    ``supports_fused_mha`` takes ``fused_mha`` (K7) on the q, k, v slices of
    the packed projection; otherwise the plain product."""

    def __init__(self, dim: int, num_heads: int, qkv_bias: bool = True,
                 qk_scale: Optional[float] = None, attn_drop: float = 0.0,
                 proj_drop: float = 0.0, *, use_fused_kernel: bool = False,
                 dtype=torch.float32, device=None):
        super().__init__()
        kw = dict(dtype=dtype, device=device)
        self.compute_dtype = dtype
        self.num_heads = num_heads
        self.scale = qk_scale or (dim // num_heads) ** -0.5
        self.use_fused_kernel = use_fused_kernel
        self.attn_drop_rate = attn_drop
        self.qkv = Linear(dim, dim * 3, bias=qkv_bias, **kw)
        self.proj = Linear(dim, dim, **kw)
        self.attn_drop = nn.Dropout(attn_drop)
        self.proj_drop = nn.Dropout(proj_drop)

    def packed_qkv_bias(self) -> torch.Tensor:
        """The qkv bias in the compute dtype, zeros when there is none."""
        bias = self.qkv.bias
        if bias is None:
            bias = torch.zeros_like(self.qkv.weight[:, 0])
        return bias.to(self.compute_dtype)

    def forward(self, x: torch.Tensor, return_attn: bool = False,
                fused: bool = True):
        b, n, c = x.shape
        dt = self.compute_dtype
        if (fused and not return_attn and self.attn_drop_rate == 0.0
                and supports_fused_attn_layer(
                    n, c, self.num_heads, dt,
                    backward=grad_needed(x, *self.parameters()))):
            out = fused_attn_layer(
                x.to(dt).contiguous(), self.qkv.weight.to(dt),
                self.packed_qkv_bias(), self.proj.weight.to(dt),
                self.proj.bias.to(dt), num_heads=self.num_heads,
                scale=self.scale,
            )
            return self.proj_drop(out), None
        head_dim = c // self.num_heads
        qkv = self.qkv(x).view(b, n, 3, self.num_heads, head_dim)
        if (self.use_fused_kernel and not return_attn
                and self.attn_drop_rate == 0.0 and dt == torch.bfloat16
                and supports_fused_mha(n, head_dim)):
            out = fused_mha(qkv[:, :, 0], qkv[:, :, 1], qkv[:, :, 2],
                            scale=self.scale)
            return self.proj_drop(self.proj(out.reshape(b, n, c))), None
        q, k, v = qkv.permute(2, 0, 3, 1, 4)  # (b, h, n, d) each
        attn = torch.matmul(q, k.transpose(-1, -2)).float() * self.scale
        attn = attn.softmax(-1).to(x.dtype)
        weights = attn if return_attn else None
        out = torch.matmul(self.attn_drop(attn), v)
        out = out.transpose(1, 2).reshape(b, n, c)
        return self.proj_drop(self.proj(out)), weights


class ViTBlock(nn.Module):
    """Pre-norm transformer block (layers.py:310-396)."""

    def __init__(self, dim: int, num_heads: int, mlp_ratio: float = 4.0,
                 qkv_bias: bool = True, qk_scale: Optional[float] = None,
                 drop: float = 0.0, attn_drop: float = 0.0,
                 drop_path_rate: float = 0.0, layer_norm_eps: float = 1e-6,
                 use_fused_layer: Optional[bool] = None, *,
                 dtype=torch.float32, device=None):
        super().__init__()
        kw = dict(dtype=dtype, device=device)
        self.dtype = dtype
        self.num_heads = num_heads
        self.drop = drop
        self.attn_drop = attn_drop
        self.drop_path_rate = drop_path_rate
        self.layer_norm_eps = layer_norm_eps
        self.use_fused_layer = use_fused_layer
        self.norm1 = nn.LayerNorm(dim, eps=layer_norm_eps, device=device)
        self.attn = Attention(dim, num_heads, qkv_bias, qk_scale, attn_drop,
                              drop, **kw)
        self.drop_path = DropPath(drop_path_rate)
        self.norm2 = nn.LayerNorm(dim, eps=layer_norm_eps, device=device)
        self.mlp = Mlp(dim, int(dim * mlp_ratio), dropout=drop, **kw)

    def _fuse_block(self, x: torch.Tensor, return_attn: bool) -> bool:
        deterministic = not self.training
        return (
            self.use_fused_layer is not False
            and not return_attn
            and self.attn_drop == 0.0
            and (self.drop == 0.0 or deterministic)
            and (self.drop_path_rate == 0.0 or deterministic)
            and supports_fused_ln_attn_layer(
                x.shape[1], x.shape[2], self.num_heads, self.dtype,
                backward=grad_needed(x, *self.parameters()),
            )
        )

    def forward(self, x: torch.Tensor, return_attn: bool = False):
        if self._fuse_block(x, return_attn):
            dt = self.dtype
            x = x.to(dt).contiguous()
            x = fused_ln_attn_layer(
                x, self.norm1.weight, self.norm1.bias,
                self.attn.qkv.weight.to(dt), self.attn.packed_qkv_bias(),
                self.attn.proj.weight.to(dt), self.attn.proj.bias.to(dt),
                num_heads=self.num_heads, scale=self.attn.scale,
                eps=self.layer_norm_eps,
            )
            if supports_fused_ln_mlp(x.shape[1], x.shape[2],
                                     self.mlp.fc1.out_features, dt):
                return fused_ln_mlp(
                    x, self.norm2.weight, self.norm2.bias,
                    self.mlp.fc1.weight.to(dt), self.mlp.fc1.bias.to(dt),
                    self.mlp.fc2.weight.to(dt), self.mlp.fc2.bias.to(dt),
                    eps=self.layer_norm_eps,
                )
            return x + self.mlp(layer_norm(x, self.norm2))

        fused = self.use_fused_layer is not False
        y, attn = self.attn(layer_norm(x, self.norm1), return_attn, fused)
        x = x + self.drop_path(y)
        x = x + self.drop_path(self.mlp(layer_norm(x, self.norm2), fused))
        if return_attn:
            return x, attn
        return x


class PatchEmbed(nn.Module):
    """Strided-conv patch embedding with LayerNorm (eps 1e-5) + exact GELU
    (layers.py:399-429). ``(B, H, W, C)`` -> ``(B, H/p, W/p, embed_dim)``.
    ``use_norm_act=False`` is the plain conv of the ECDP/MEM backbones."""

    def __init__(self, patch_size: int, in_chans: int, embed_dim: int, *,
                 use_norm_act: bool = True, dtype=torch.float32,
                 device=None):
        super().__init__()
        self.proj = Conv2d(in_chans, embed_dim, patch_size, patch_size,
                           dtype=dtype, device=device)
        self.norm = (nn.LayerNorm(embed_dim, eps=1e-5, device=device)
                     if use_norm_act else None)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = self.proj(x.permute(0, 3, 1, 2)).permute(0, 2, 3, 1)
        if self.norm is None:
            return x
        return F.gelu(layer_norm(x, self.norm), approximate="none")


class GroupedBatchNorm(nn.Module):
    """BatchNorm over (N, C) rows with statistics per contiguous row group
    (layers.py:444-507): ``groups`` = 1 is global-batch statistics, G the
    statistics of each of G equal row blocks (per-device BatchNorm under
    data parallelism). Computes in f32 and returns f32. In training the
    variance is the mean of squared deviations (two passes: projector
    activations with a large mean lose digits to ``E[x^2] - mean^2``), and
    the running buffers move as flax's do, momentum 0.99 on the biased
    variance, averaged over the groups; in eval the running buffers
    normalise. ``affine=False`` has neither ``weight`` nor ``bias``.
    ``track_running_stats=False`` keeps no running buffers and always
    normalises with the batch's statistics: the ECDP key encoder, whose
    BatchNorm mutations JAX discards (steps.py:817-824)."""

    def __init__(self, num_features: int, groups: int = 1,
                 affine: bool = True, momentum: float = 0.99,
                 eps: float = 1e-5, *, track_running_stats: bool = True,
                 device=None):
        super().__init__()
        self.groups = groups
        self.momentum = momentum
        self.eps = eps
        self.track_running_stats = track_running_stats
        f32 = dict(dtype=torch.float32, device=device)
        if affine:
            self.weight = nn.Parameter(torch.ones(num_features, **f32))
            self.bias = nn.Parameter(torch.zeros(num_features, **f32))
        else:
            self.weight = self.bias = None
        if track_running_stats:
            self.register_buffer("running_mean",
                                 torch.zeros(num_features, **f32))
            self.register_buffer("running_var",
                                 torch.ones(num_features, **f32))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        feat = x.shape[-1]
        if self.training or not self.track_running_stats:
            xg = x.float().reshape(self.groups, -1, feat)
            mean = xg.mean(dim=1, keepdim=True)                # (G, 1, C)
            var = ((xg - mean) ** 2).mean(dim=1, keepdim=True)
            xn = ((xg - mean) * torch.rsqrt(var + self.eps)).reshape(x.shape)
            if self.track_running_stats:
                with torch.no_grad():
                    m = self.momentum
                    self.running_mean.mul_(m).add_(
                        (1 - m) * mean.mean(dim=(0, 1)))
                    self.running_var.mul_(m).add_(
                        (1 - m) * var.mean(dim=(0, 1)))
        else:
            xn = (x.float() - self.running_mean) * torch.rsqrt(
                self.running_var + self.eps)
        if self.weight is not None:
            xn = xn * self.weight + self.bias
        return xn


class ProjectorMlp(nn.Sequential):
    """Bias-free Linears with BatchNorm and ReLU between them and an
    affine-free BatchNorm at the end, over (B, L, C) tokens or (B, C) rows
    (layers.py:510-556; the reference's ``_build_mlp_2d``). The BatchNorms
    normalise over the B*L rows per feature. Layer ``i`` is the Linear at
    index ``3i``, its BatchNorm at ``3i + 1`` and its ReLU at ``3i + 2``,
    the reference's ``nn.Sequential`` indices, so the exporter's
    ``emb_h_proj.{3i}.weight`` and ``.{3i+1}.running_mean`` load strictly;
    with ``flax_names`` they are ``fc{i}``, ``bn{i}`` and ``relu{i}``, the
    exporter's keys of the ECDP heads. The Linears compute in ``dtype``,
    each BatchNorm in f32, its output cast back to ``dtype``;
    ``track_running_stats`` goes to every BatchNorm."""

    def __init__(self, in_dim: int, num_layers: int, mlp_dim: int,
                 out_dim: int, bn_groups: int = 1, *, flax_names: bool = False,
                 track_running_stats: bool = True, dtype=torch.float32,
                 device=None):
        layers: list[tuple[str, nn.Module]] = []
        dim = in_dim
        for i in range(num_layers):
            last = i == num_layers - 1
            dim2 = out_dim if last else mlp_dim
            names = ((f"fc{i}", f"bn{i}", f"relu{i}") if flax_names
                     else (str(3 * i), str(3 * i + 1), str(3 * i + 2)))
            layers.append((names[0], Linear(dim, dim2, bias=False,
                                             dtype=dtype, device=device)))
            layers.append((names[1], GroupedBatchNorm(
                dim2, bn_groups, affine=not last,
                track_running_stats=track_running_stats, device=device)))
            if not last:
                layers.append((names[2], nn.ReLU()))
            dim = dim2
        super().__init__(collections.OrderedDict(layers))
        self.compute_dtype = dtype

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        for layer in self:
            if isinstance(layer, GroupedBatchNorm):
                x = layer(x.reshape(-1, x.shape[-1])).reshape(x.shape).to(
                    self.compute_dtype)
            else:
                x = layer(x)
        return x


# the std of a standard normal truncated to [-2, 2] (flax's initializer
# divides by it)
_TRUNC2_STD = 0.87962566103423978


@torch.no_grad()
def init_weights(module: nn.Module, generator: torch.Generator) -> None:
    """Deterministic random init from an explicit CPU generator: Linear and
    Conv weights LeCun-normal (std 1/sqrt(fan_in), flax's default kernel
    scale), biases 0, LayerNorm 1 and 0, a Swin block's relative-position
    bias table as flax's ``truncated_normal(0.02)``: a normal truncated
    at 2 of its std, that std chosen so the truncated law's is 0.02. A
    module with ``zero_init_table`` (ViT-MEM's tables, zeros in flax) keeps
    its table as built."""
    for m in module.modules():
        table = getattr(m, "relative_position_bias_table", None)
        if (isinstance(table, nn.Parameter)
                and not getattr(m, "zero_init_table", False)):
            std = 0.02 / _TRUNC2_STD
            table.copy_(nn.init.trunc_normal_(
                torch.empty(table.shape), std=std, a=-2 * std, b=2 * std,
                generator=generator))
        if isinstance(m, (nn.Linear, nn.Conv2d)):
            fan_in = m.weight[0].numel()
            w = torch.randn(m.weight.shape, generator=generator)
            m.weight.copy_(w * fan_in ** -0.5)
            if m.bias is not None:
                m.bias.zero_()
        elif isinstance(m, nn.LayerNorm):
            m.weight.fill_(1.0)
            m.bias.zero_()
