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
``supports_*`` (K1's with the backward kernel's shared-memory bound while
gradients are on). A block that cannot fuse runs the unfused composition,
whose parts take their own kernels under the JAX conditions:
``Attention`` takes K4 (``fused_attn_layer``, layers.py:249-276) when no
attention weights are requested and ``attn_drop`` is 0, as in training
with drop-path; ``Mlp`` takes K5 (``fused_mlp``, layers.py:155-176) in
deterministic (eval) calls, as in the last block of an attention-map
forward. The JAX package enables all of them only on a TPU; here they are
always eligible, and each wrapper runs its plain version on CPU tensors.
``ViTBlock(use_fused_layer=False)`` forces the plain composition for all
four, as ``force_xla()`` does in JAX. K7 (``fused_mha``, opt-in in JAX) is
not ported; ``GroupedBatchNorm`` and ``ProjectorMlp`` are not ported yet.

Stochastic depth draws its per-sample keep masks from a
:class:`DropPathSource`: an explicit ``torch.Generator`` on the
activations' device, or masks given to it in call order (the replay that
holds the port against JAX and the kernel path against the plain path).
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from eventpretrain_tpu_torch.ops.fused_attn_layer import (
    fused_attn_layer,
    fused_ln_attn_layer,
    supports_fused_attn_layer,
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
    """``nn.Conv2d`` with f32 parameters, computed in ``dtype``."""

    def __init__(self, in_channels: int, out_channels: int, kernel_size: int,
                 stride: int, *, dtype=torch.float32, device=None):
        super().__init__(in_channels, out_channels, kernel_size, stride,
                         device=device, dtype=torch.float32)
        self.compute_dtype = dtype

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        dt = self.compute_dtype
        return self._conv_forward(x.to(dt), self.weight.to(dt),
                                  self.bias.to(dt))


def layer_norm(x: torch.Tensor, norm: nn.LayerNorm) -> torch.Tensor:
    """``norm(x)`` computed in f32, returned in ``x.dtype``."""
    return F.layer_norm(
        x.float(), norm.normalized_shape, norm.weight.float(),
        norm.bias.float(), norm.eps,
    ).to(x.dtype)


class DropPathSource:
    """Where every ``DropPath`` of a model takes its per-sample keep masks,
    in call order: the rows of ``keep`` (S, B) bool when given (a replay;
    each call takes the next row), else ``torch.rand(B) < keep_prob`` drawn
    from ``generator``, which must live on the activations' device. With
    neither, a drawing call raises: nothing reads torch's global RNG."""

    def __init__(self, generator: Optional[torch.Generator] = None,
                 keep: Optional[torch.Tensor] = None):
        self.generator = generator
        self.keep = keep
        self.used = 0

    def draw(self, batch: int, keep_prob: float,
             device: torch.device) -> torch.Tensor:
        if self.keep is not None:
            if self.used >= self.keep.shape[0]:
                raise ValueError(
                    f"DropPathSource: {self.keep.shape[0]} replayed keep "
                    "masks, but the model asks for more")
            mask = self.keep[self.used].to(device=device, dtype=torch.bool)
            if mask.shape != (batch,):
                raise ValueError(f"DropPathSource: keep mask {self.used} is "
                                 f"{tuple(mask.shape)}, expected ({batch},)")
            self.used += 1
            return mask
        if self.generator is None:
            raise ValueError(
                "DropPath is active (training, rate > 0) but has no "
                "generator: call set_drop_path_source(model, "
                "DropPathSource(generator)) first")
        return torch.rand((batch,), generator=self.generator,
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
    (layers.py:185-307). The softmax runs in f32. Calls that need no
    attention weights and no attention dropout, inside the K4 gate, take
    ``fused_attn_layer``."""

    def __init__(self, dim: int, num_heads: int, qkv_bias: bool = True,
                 qk_scale: Optional[float] = None, attn_drop: float = 0.0,
                 proj_drop: float = 0.0, *, dtype=torch.float32, device=None):
        super().__init__()
        kw = dict(dtype=dtype, device=device)
        self.compute_dtype = dtype
        self.num_heads = num_heads
        self.scale = qk_scale or (dim // num_heads) ** -0.5
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
                    backward=torch.is_grad_enabled())):
            out = fused_attn_layer(
                x.to(dt).contiguous(), self.qkv.weight.to(dt),
                self.packed_qkv_bias(), self.proj.weight.to(dt),
                self.proj.bias.to(dt), num_heads=self.num_heads,
                scale=self.scale,
            )
            return self.proj_drop(out), None
        qkv = self.qkv(x).view(b, n, 3, self.num_heads, c // self.num_heads)
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
            and supports_fused_attn_layer(
                x.shape[1], x.shape[2], self.num_heads, self.dtype,
                backward=torch.is_grad_enabled(),
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
    The plain variant of the ECDP/MEM backbones comes with them."""

    def __init__(self, patch_size: int, in_chans: int, embed_dim: int, *,
                 dtype=torch.float32, device=None):
        super().__init__()
        self.proj = Conv2d(in_chans, embed_dim, patch_size, patch_size,
                           dtype=dtype, device=device)
        self.norm = nn.LayerNorm(embed_dim, eps=1e-5, device=device)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = self.proj(x.permute(0, 3, 1, 2)).permute(0, 2, 3, 1)
        return F.gelu(layer_norm(x, self.norm), approximate="none")


@torch.no_grad()
def init_weights(module: nn.Module, generator: torch.Generator) -> None:
    """Deterministic random init from an explicit CPU generator: Linear and
    Conv weights LeCun-normal (std 1/sqrt(fan_in), flax's default kernel
    scale), biases 0, LayerNorm 1 and 0."""
    for m in module.modules():
        if isinstance(m, (nn.Linear, nn.Conv2d)):
            fan_in = m.weight[0].numel()
            w = torch.randn(m.weight.shape, generator=generator)
            m.weight.copy_(w * fan_in ** -0.5)
            if m.bias is not None:
                m.bias.zero_()
        elif isinstance(m, nn.LayerNorm):
            m.weight.fill_(1.0)
            m.bias.zero_()
