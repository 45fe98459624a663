"""ViT backbone (no cls token, fixed sincos pos-embed): the dense path.

Counterpart of eventpretrain_tpu/models/vit.py:35-233. ``encode_dense``
returns the same taps, pyramid and optional last-block attention; the
masked path (``encode_masked``) comes with the pretraining slice.
"""

from __future__ import annotations

from typing import Sequence

import numpy as np
import torch
from torch import nn

from eventpretrain_tpu_torch.models.layers import (
    PatchEmbed,
    ViTBlock,
    layer_norm,
)
from eventpretrain_tpu_torch.ops.pos_embed import get_2d_sincos_pos_embed


def emb2patch_frame(emb: torch.Tensor) -> torch.Tensor:
    """``(B, L, C)`` -> ``(B, h, w, C)`` channels-last patch frame."""
    b, num_tokens, c = emb.shape
    grid = int(num_tokens ** 0.5)
    if grid * grid != num_tokens:
        raise ValueError(f"{num_tokens} tokens do not form a square grid")
    return emb.reshape(b, grid, grid, c)


class ViT(nn.Module):
    def __init__(self, input_size: int = 224, patch_size: int = 16,
                 embed_dim: int = 384, depth: int = 12, num_heads: int = 12,
                 mlp_ratio: float = 4.0,
                 out_indices: Sequence[int] = (3, 5, 7, 11),
                 num_bins: int = 5, drop_rate: float = 0.0,
                 attn_drop_rate: float = 0.0, drop_path_rate: float = 0.0,
                 dense_taps: Sequence[int] = (0, 1),
                 layer_norm_eps: float = 1e-6, *, dtype=torch.float32,
                 device=None):
        super().__init__()
        kw = dict(dtype=dtype, device=device)
        self.embed_dim = embed_dim
        self.depth = depth
        self.out_indices = tuple(out_indices)
        self.dense_taps = tuple(dense_taps)
        self.grid_size = input_size // patch_size
        self.patch_embed = PatchEmbed(patch_size, num_bins, embed_dim, **kw)
        dpr = [float(r) for r in np.linspace(0, drop_path_rate, depth)]
        self.vit_block = nn.ModuleList(
            ViTBlock(embed_dim, num_heads, mlp_ratio, qkv_bias=True,
                     drop=drop_rate, attn_drop=attn_drop_rate,
                     drop_path_rate=dpr[i], layer_norm_eps=layer_norm_eps,
                     **kw)
            for i in range(depth)
        )
        self.norm_layer = nn.LayerNorm(embed_dim, eps=layer_norm_eps,
                                       device=device)
        self.pos_drop = nn.Dropout(drop_rate)
        # fixed sincos table: recomputed, never saved (the exporter omits it)
        table = get_2d_sincos_pos_embed(embed_dim, self.grid_size)
        self.register_buffer(
            "pos_embed", torch.from_numpy(table)[None].to(device),
            persistent=False,
        )

    def _embed(self, x: torch.Tensor) -> torch.Tensor:
        x = self.patch_embed(x)  # (B, h, w, D)
        x = x.reshape(x.shape[0], -1, x.shape[-1])  # (B, L, D)
        x = x + self.pos_embed.to(x.dtype)
        return self.pos_drop(x)

    def encode_dense(self, x: torch.Tensor, return_attn: bool = False,
                     return_pyramid: bool = True):
        """Full-token encoding of ``x (B, H, W, num_bins)``.

        Returns ``(emb_l1, emb_l2, emb_h, out_embs, attn)``: the taps after
        ``dense_taps`` blocks, the normed last tokens, the ``(B, h, w, D)``
        maps at ``out_indices`` (empty unless ``return_pyramid``), and the
        last block's attention or None.
        """
        x = self._embed(x)
        taps = {}
        out_embs = []
        attn = None
        last = self.depth - 1
        for i, blk in enumerate(self.vit_block):
            if i == last and return_attn:
                x, attn = blk(x, True)
            else:
                x = blk(x)
            if i in self.dense_taps:
                taps[i] = x
            if return_pyramid and i in self.out_indices:
                out_embs.append(emb2patch_frame(x))
        emb_h = layer_norm(x, self.norm_layer)
        return (taps[self.dense_taps[0]], taps[self.dense_taps[1]], emb_h,
                out_embs, attn)

    def forward(self, x: torch.Tensor):
        """Dense encoding without pyramid or attention."""
        return self.encode_dense(x, return_attn=False, return_pyramid=False)


def vit_small_patch16(**kwargs) -> ViT:
    cfg = dict(input_size=224, patch_size=16, embed_dim=384, depth=12,
               num_heads=12, mlp_ratio=4.0, out_indices=(3, 5, 7, 11))
    cfg.update(kwargs)
    return ViT(**cfg)


def vit_base_patch16(**kwargs) -> ViT:
    cfg = dict(input_size=224, patch_size=16, embed_dim=768, depth=12,
               num_heads=12, mlp_ratio=4.0, out_indices=(3, 5, 7, 11))
    cfg.update(kwargs)
    return ViT(**cfg)
