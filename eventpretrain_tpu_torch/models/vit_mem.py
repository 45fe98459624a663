"""ViT-MEM backbone (BEiT-style), the MEM baseline's encoder.

Counterpart of eventpretrain_tpu/models/vit_mem.py: a class token, the
plain conv patch embedding (``PatchEmbed(use_norm_act=False)``) and no
absolute position embedding; a relative-position bias table shared by
every block (``rel_pos_bias``) plus one table of each block's own; the
qkv projection without a bias, ``q_bias`` and ``v_bias`` added after it
(the k bias fixed at zero); layer-scale blocks (``gamma_1``, ``gamma_2``);
the mean of the patch tokens, then the final norm.

``AttentionMEM`` is plain PyTorch, as JAX's is plain ``jnp``: the
relative-position bias keeps it off K1 and K4. It rounds where JAX does
in a 2-byte compute dtype: the projection, then the bias added in the
compute dtype; ``q * scale``; the logits in the compute dtype, each bias
table cast to it and added after; the softmax in f32, cast back; then
``attn @ v``. The MLP is ``layers.Mlp``, which takes K5 in deterministic
calls inside its gate (ViT-MEM-S at 197 tokens; ViT-MEM-B's C=768 stays
plain, as JAX's gate keeps it).

The index of the bias tables, ``relative_position_index``, is a
non-persistent buffer, recomputed and left out of the state dict, as the
exporter omits it.
"""

from __future__ import annotations

from typing import Optional, Sequence

import numpy as np
import torch
from torch import nn

from eventpretrain_tpu_torch.models.layers import (
    DropPath,
    Linear,
    Mlp,
    PatchEmbed,
    layer_norm,
)
from eventpretrain_tpu_torch.ops.reshape import emb2patch_frame


def relative_position_index(window_size: tuple[int, int]) -> np.ndarray:
    """``(Wh*Ww + 1, Wh*Ww + 1)`` int64 index into a bias table of
    ``(2Wh-1)(2Ww-1) + 3`` rows (vit_mem.py:23-40): the patch pairs'
    relative offsets, then the class token's three entries (token to
    patch ``num_rel - 3``, patch to token ``num_rel - 2``, token to token
    ``num_rel - 1``)."""
    wh, ww = window_size
    coords = np.stack(np.meshgrid(np.arange(wh), np.arange(ww),
                                  indexing="ij"))
    flat = coords.reshape(2, -1)
    rel = flat[:, :, None] - flat[:, None, :]
    rel = rel.transpose(1, 2, 0).astype(np.int64)
    rel[:, :, 0] += wh - 1
    rel[:, :, 1] += ww - 1
    rel[:, :, 0] *= 2 * ww - 1
    num_rel = (2 * wh - 1) * (2 * ww - 1) + 3
    idx = np.zeros((wh * ww + 1, wh * ww + 1), np.int64)
    idx[1:, 1:] = rel.sum(-1)
    idx[0, 0:] = num_rel - 3
    idx[0:, 0] = num_rel - 2
    idx[0, 0] = num_rel - 1
    return idx


class _BiasTable(nn.Module):
    """A ``relative_position_bias_table`` (num_rel, heads), zeros at init,
    and its index buffer; ``bias()`` is the ``(heads, N, N)`` f32 bias.
    ``init_weights`` leaves the table at zeros, flax's init."""

    zero_init_table = True

    def __init__(self, window_size: tuple[int, int], num_heads: int,
                 device=None):
        super().__init__()
        wh, ww = window_size
        num_rel = (2 * wh - 1) * (2 * ww - 1) + 3
        self.relative_position_bias_table = nn.Parameter(
            torch.zeros((num_rel, num_heads), device=device))
        self.register_buffer(
            "relative_position_index",
            torch.from_numpy(relative_position_index(window_size)).to(device),
            persistent=False)

    def bias(self) -> torch.Tensor:
        idx = self.relative_position_index
        n = idx.shape[0]
        table = self.relative_position_bias_table
        return table.index_select(0, idx.reshape(-1)).view(
            n, n, -1).permute(2, 0, 1)


class RelativePositionBias(_BiasTable):
    """The bias table every block shares (vit_mem.py:43-63)."""

    def forward(self) -> torch.Tensor:
        return self.bias()


class AttentionMEM(_BiasTable):
    """Attention with the decomposed qkv bias and a table of its own
    (vit_mem.py:66-110); returns ``(out, attention weights)``, the
    weights those of the softmax before dropout."""

    def __init__(self, dim: int, num_heads: int,
                 window_size: tuple[int, int], attn_drop: float = 0.0,
                 proj_drop: float = 0.0, *, dtype=torch.float32,
                 device=None):
        super().__init__(window_size, num_heads, device=device)
        kw = dict(dtype=dtype, device=device)
        self.num_heads = num_heads
        self.compute_dtype = dtype
        self.scale = (dim // num_heads) ** -0.5
        self.qkv = Linear(dim, dim * 3, bias=False, **kw)
        self.q_bias = nn.Parameter(torch.zeros(dim, device=device))
        self.v_bias = nn.Parameter(torch.zeros(dim, device=device))
        self.proj = Linear(dim, dim, **kw)
        self.attn_drop = nn.Dropout(attn_drop)
        self.proj_drop = nn.Dropout(proj_drop)

    def forward(self, x: torch.Tensor,
                rel_pos_bias: Optional[torch.Tensor] = None):
        b, n, c = x.shape
        h = self.num_heads
        dt = self.compute_dtype
        bias = torch.cat([self.q_bias, torch.zeros_like(self.q_bias),
                          self.v_bias])
        qkv = self.qkv(x) + bias.to(dt)
        q, k, v = qkv.view(b, n, 3, h, c // h).permute(2, 0, 3, 1, 4)
        attn = torch.matmul(q * self.scale, k.transpose(-1, -2))
        attn = attn + self.bias()[None].to(attn.dtype)
        if rel_pos_bias is not None:
            attn = attn + rel_pos_bias[None].to(attn.dtype)
        attn = attn.float().softmax(-1).to(dt)
        out = torch.matmul(self.attn_drop(attn), v)
        out = out.transpose(1, 2).reshape(b, n, c)
        return self.proj_drop(self.proj(out)), attn


class ViTBlockMEM(nn.Module):
    """Pre-norm block with layer scale (vit_mem.py:113-161): ``x +
    drop_path(gamma_1 * attn(norm1(x)))``, then ``x + drop_path(gamma_2 *
    mlp(norm2(x)))``, the gammas cast to the branch's dtype.
    ``use_fused_layer=False`` keeps the MLP off K5, as ``ViTBlock``'s flag
    keeps its sub-blocks off K1/K2."""

    def __init__(self, dim: int, num_heads: int,
                 window_size: tuple[int, int], mlp_ratio: float = 4.0,
                 init_values: float = 0.1, drop: float = 0.0,
                 attn_drop: float = 0.0, drop_path_rate: float = 0.0,
                 layer_norm_eps: float = 1e-6, *, dtype=torch.float32,
                 device=None):
        super().__init__()
        kw = dict(dtype=dtype, device=device)
        self.use_fused_layer: Optional[bool] = None
        self.gamma_1 = nn.Parameter(
            torch.full((dim,), init_values, device=device))
        self.gamma_2 = nn.Parameter(
            torch.full((dim,), init_values, device=device))
        self.norm1 = nn.LayerNorm(dim, eps=layer_norm_eps, device=device)
        self.attn = AttentionMEM(dim, num_heads, window_size, attn_drop,
                                 drop, **kw)
        self.drop_path = DropPath(drop_path_rate)
        self.norm2 = nn.LayerNorm(dim, eps=layer_norm_eps, device=device)
        self.mlp = Mlp(dim, int(dim * mlp_ratio), dropout=drop, **kw)

    def forward(self, x: torch.Tensor,
                rel_pos_bias: Optional[torch.Tensor] = None,
                return_attn: bool = False):
        y, attn = self.attn(layer_norm(x, self.norm1), rel_pos_bias)
        x = x + self.drop_path(self.gamma_1.to(y.dtype) * y)
        y = self.mlp(layer_norm(x, self.norm2),
                     fused=self.use_fused_layer is not False)
        x = x + self.drop_path(self.gamma_2.to(y.dtype) * y)
        if return_attn:
            return x, attn
        return x


class ViTMEM(nn.Module):
    """vit_mem.py:164-252."""

    def __init__(self, input_size: int = 224, patch_size: int = 16,
                 embed_dim: int = 384, depth: int = 12, num_heads: int = 12,
                 mlp_ratio: float = 4.0,
                 out_indices: Sequence[int] = (3, 5, 7, 11),
                 num_bins: int = 3, init_values: float = 0.1,
                 drop_rate: float = 0.0, attn_drop_rate: float = 0.0,
                 drop_path_rate: float = 0.0, layer_norm_eps: float = 1e-6,
                 *, dtype=torch.float32, device="cuda"):
        super().__init__()
        kw = dict(dtype=dtype, device=device)
        self.dtype = dtype
        self.embed_dim = embed_dim
        self.depth = depth
        self.out_indices = tuple(out_indices)
        self.grid_size = input_size // patch_size
        self.num_patches = self.grid_size ** 2
        window = (self.grid_size, self.grid_size)
        self.patch_embed = PatchEmbed(patch_size, num_bins, embed_dim,
                                      use_norm_act=False, **kw)
        self.cls_token = nn.Parameter(torch.zeros((1, 1, embed_dim),
                                                  device=device))
        self.rel_pos_bias = RelativePositionBias(window, num_heads,
                                                 device=device)
        dpr = [float(r) for r in np.linspace(0, drop_path_rate, depth)]
        self.vit_block = nn.ModuleList(
            ViTBlockMEM(embed_dim, num_heads, window, mlp_ratio, init_values,
                        drop_rate, attn_drop_rate, dpr[i], layer_norm_eps,
                        **kw)
            for i in range(depth)
        )
        self.norm_layer = nn.LayerNorm(embed_dim, eps=layer_norm_eps,
                                       device=device)

    def encode_dense(self, x: torch.Tensor, return_attn: bool = False,
                     return_pyramid: bool = False):
        """``x (B, H, W, num_bins)`` -> ``(emb, out_embs, attn)``: ``emb``
        the final norm of the patch tokens' mean (B, C) (the mean before
        the norm, vit_mem.py:222-244), ``out_embs`` the patch tokens'
        (B, h, w, C) maps after the blocks ``out_indices`` with
        ``return_pyramid``, else empty, ``attn`` the last block's
        attention weights with ``return_attn``, else None."""
        x = self.patch_embed(x)
        x = x.reshape(x.shape[0], -1, x.shape[-1])
        cls = self.cls_token.to(x.dtype).expand(x.shape[0], -1, -1)
        x = torch.cat([cls, x], dim=1)
        bias = self.rel_pos_bias()
        attn, out_embs = None, []
        last = self.depth - 1
        for i, blk in enumerate(self.vit_block):
            if i == last and return_attn:
                x, attn = blk(x, bias, True)
            else:
                x = blk(x, bias)
            if return_pyramid and i in self.out_indices:
                out_embs.append(emb2patch_frame(x[:, 1:]))
        emb = layer_norm(x[:, 1:].mean(dim=1), self.norm_layer)
        return emb, out_embs, attn

    def forward(self, x: torch.Tensor):
        return self.encode_dense(x)


def vit_mem_small_patch16(**kwargs) -> ViTMEM:
    cfg = dict(input_size=224, patch_size=16, embed_dim=384, depth=12,
               num_heads=12)
    cfg.update(kwargs)
    return ViTMEM(**cfg)


def vit_mem_base_patch16(**kwargs) -> ViTMEM:
    cfg = dict(input_size=224, patch_size=16, embed_dim=768, depth=12,
               num_heads=12)
    cfg.update(kwargs)
    return ViTMEM(**cfg)
