"""Transformer building blocks: patch embedding, attention, MLP, pre-norm
ViT block and stochastic depth.

Counterpart of eventpretrain_tpu/models/layers.py:87-429, with the same
parameter names (so reference / exported checkpoints load strictly) and
channels-last activations at the public boundary.

Dtypes follow flax's split between parameter and compute dtype: Linear and
Conv weights are stored in the compute ``dtype`` (flax casts them at use,
which gives the same values), LayerNorm parameters stay f32, and every
LayerNorm computes in f32 and returns the activation dtype.

``ViTBlock`` takes the LN-fused sub-block kernels K1
(``fused_ln_attn_layer``) and K2 (``fused_ln_mlp``) under the JAX gates of
layers.py:343-380: 2-byte activations, no active dropout or drop-path, no
attention weights requested, shapes inside ``supports_*``. The JAX package
enables them only on a TPU; here they are always eligible, and each wrapper
runs its plain version on CPU tensors. ``use_fused_layer=False`` forces the
unfused composition. The unfused paths' own kernels (K4 ``fused_attn_layer``,
K5 ``fused_mlp``, K7 ``fused_mha``) are not ported: they run plain PyTorch.
``GroupedBatchNorm`` and ``ProjectorMlp`` are not ported yet.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from eventpretrain_tpu_torch.ops.fused_attn_layer import (
    fused_ln_attn_layer,
    supports_fused_attn_layer,
)
from eventpretrain_tpu_torch.ops.fused_mlp import (
    fused_ln_mlp,
    supports_fused_ln_mlp,
)


def layer_norm(x: torch.Tensor, norm: nn.LayerNorm) -> torch.Tensor:
    """``norm(x)`` computed in f32, returned in ``x.dtype``."""
    return F.layer_norm(
        x.float(), norm.normalized_shape, norm.weight.float(),
        norm.bias.float(), norm.eps,
    ).to(x.dtype)


def drop_path(x: torch.Tensor, rate: float,
              generator: Optional[torch.Generator] = None) -> torch.Tensor:
    """Stochastic depth: drop the whole residual branch per sample."""
    if rate == 0.0:
        return x
    keep_prob = 1.0 - rate
    shape = (x.shape[0],) + (1,) * (x.ndim - 1)
    keep = torch.rand(shape, generator=generator, device=x.device) < keep_prob
    return torch.where(keep, x / keep_prob, torch.zeros_like(x))


class DropPath(nn.Module):
    """Per-sample stochastic depth, active in training mode only.

    ``generator`` (optional) is the explicit random stream; it must live on
    the activations' device.
    """

    def __init__(self, rate: float = 0.0,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.rate = rate
        self.generator = generator

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if self.rate == 0.0 or not self.training:
            return x
        return drop_path(x, self.rate, self.generator)


class Mlp(nn.Module):
    """fc1 -> exact GELU -> dropout -> fc2 -> dropout (layers.py:109-182)."""

    def __init__(self, dim: int, hidden_dim: int, dropout: float = 0.0, *,
                 dtype=torch.float32, device=None):
        super().__init__()
        kw = dict(dtype=dtype, device=device)
        self.fc1 = nn.Linear(dim, hidden_dim, **kw)
        self.fc2 = nn.Linear(hidden_dim, dim, **kw)
        self.drop = nn.Dropout(dropout)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = F.gelu(self.fc1(x), approximate="none")
        x = self.drop(x)
        return self.drop(self.fc2(x))


class Attention(nn.Module):
    """Multi-head self-attention with a packed qkv projection
    (layers.py:185-307). The softmax runs in f32."""

    def __init__(self, dim: int, num_heads: int, qkv_bias: bool = True,
                 qk_scale: Optional[float] = None, attn_drop: float = 0.0,
                 proj_drop: float = 0.0, *, dtype=torch.float32, device=None):
        super().__init__()
        kw = dict(dtype=dtype, device=device)
        self.num_heads = num_heads
        self.scale = qk_scale or (dim // num_heads) ** -0.5
        self.attn_drop_rate = attn_drop
        self.qkv = nn.Linear(dim, dim * 3, bias=qkv_bias, **kw)
        self.proj = nn.Linear(dim, dim, **kw)
        self.attn_drop = nn.Dropout(attn_drop)
        self.proj_drop = nn.Dropout(proj_drop)

    def forward(self, x: torch.Tensor, return_attn: bool = False):
        b, n, c = x.shape
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
            and supports_fused_attn_layer(x.shape[1], x.shape[2],
                                          self.num_heads, x.dtype)
        )

    def forward(self, x: torch.Tensor, return_attn: bool = False):
        if self._fuse_block(x, return_attn):
            qkv_bias = self.attn.qkv.bias
            if qkv_bias is None:
                qkv_bias = torch.zeros_like(self.attn.qkv.weight[:, 0])
            x = fused_ln_attn_layer(
                x, self.norm1.weight.float(), self.norm1.bias.float(),
                self.attn.qkv.weight, qkv_bias,
                self.attn.proj.weight, self.attn.proj.bias,
                num_heads=self.num_heads, scale=self.attn.scale,
                eps=self.layer_norm_eps,
            )
            if supports_fused_ln_mlp(x.shape[1], x.shape[2],
                                     self.mlp.fc1.out_features, x.dtype):
                return fused_ln_mlp(
                    x, self.norm2.weight.float(), self.norm2.bias.float(),
                    self.mlp.fc1.weight, self.mlp.fc1.bias,
                    self.mlp.fc2.weight, self.mlp.fc2.bias,
                    eps=self.layer_norm_eps,
                )
            return x + self.mlp(layer_norm(x, self.norm2))

        y, attn = self.attn(layer_norm(x, self.norm1), return_attn)
        x = x + self.drop_path(y)
        x = x + self.drop_path(self.mlp(layer_norm(x, self.norm2)))
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
        self.proj = nn.Conv2d(in_chans, embed_dim, patch_size, patch_size,
                              dtype=dtype, device=device)
        self.norm = nn.LayerNorm(embed_dim, eps=1e-5, device=device)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = x.to(self.proj.weight.dtype).permute(0, 3, 1, 2)
        x = self.proj(x).permute(0, 2, 3, 1)
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
