"""ViT backbone (no cls token, fixed sincos pos-embed): the masked and the
dense paths.

Counterpart of eventpretrain_tpu/models/vit.py:35-233. ``encode_masked``
embeds only the kept patches and taps blocks ``masked_taps`` for the fused
feature; ``encode_dense`` returns the dense taps, the pyramid and the
optional last-block attention.
"""

from __future__ import annotations

from typing import Optional, Sequence

import numpy as np
import torch
from torch import nn

from eventpretrain_tpu_torch.models.layers import (
    PatchEmbed,
    ViTBlock,
    layer_norm,
)
from eventpretrain_tpu_torch.ops.pos_embed import get_2d_sincos_pos_embed
from eventpretrain_tpu_torch.ops.reshape import emb2patch_frame, frame2emb


class ViT(nn.Module):
    def __init__(self, input_size: int = 224, patch_size: int = 16,
                 embed_dim: int = 384, depth: int = 12, num_heads: int = 12,
                 mlp_ratio: float = 4.0,
                 out_indices: Sequence[int] = (3, 5, 7, 11),
                 num_bins: int = 5, drop_rate: float = 0.0,
                 attn_drop_rate: float = 0.0, drop_path_rate: float = 0.0,
                 use_feature_fusion: bool = True,
                 masked_taps: Sequence[int] = (1, 3),
                 dense_taps: Sequence[int] = (0, 1),
                 layer_norm_eps: float = 1e-6, *, dtype=torch.float32,
                 device="cuda"):
        super().__init__()
        kw = dict(dtype=dtype, device=device)
        self.dtype = dtype
        self.embed_dim = embed_dim
        self.depth = depth
        self.patch_size = patch_size
        self.out_indices = tuple(out_indices)
        self.use_feature_fusion = use_feature_fusion
        self.masked_taps = tuple(masked_taps)
        self.dense_taps = tuple(dense_taps)
        self.grid_size = input_size // patch_size
        self.num_patches = self.grid_size ** 2
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

    def _embed_gathered(self, x: torch.Tensor,
                        ids_keep: torch.Tensor) -> torch.Tensor:
        """Embed only the kept patches: gather before the patch conv.

        The stride-p conv, its LayerNorm and GELU are patch-local, so the
        same PatchEmbed on the (B*K) gathered p x p patches gives the values
        of ``_embed`` followed by a gather (vit.py:112-143).
        """
        b, k = ids_keep.shape
        p = self.patch_size
        patches = frame2emb(p, x)  # (B, L, p*p*bins)
        idx = ids_keep[..., None].expand(b, k, patches.shape[-1])
        patches = torch.gather(patches, 1, idx)
        patches = patches.reshape(b * k, p, p, x.shape[-1])
        emb = self.patch_embed(patches).reshape(b, k, self.embed_dim)
        emb = emb + self.pos_embed[0].to(emb.dtype)[ids_keep]
        return self.pos_drop(emb)

    def encode_masked(self, x: torch.Tensor, ids_keep: torch.Tensor,
                      mask: Optional[torch.Tensor] = None):
        """Visible-token encoding of ``x (B, H, W, num_bins)`` at
        ``ids_keep (B, K)``: ``(emb_l1, emb_l2, emb_lh)``, each (B, K, D),
        with ``emb_lh = norm(emb_l1 + emb_l2 + emb_h)`` under feature fusion,
        else ``norm(emb_h)`` (vit.py:145-173). The full ``mask``, which the
        ConvViT's conv stages need, is ignored, as in JAX."""
        x = self._embed_gathered(x, ids_keep)
        taps = {}
        for i, blk in enumerate(self.vit_block):
            x = blk(x)
            if i in self.masked_taps:
                taps[i] = x
        emb_l1 = taps[self.masked_taps[0]]
        emb_l2 = taps[self.masked_taps[1]]
        fused = emb_l1 + emb_l2 + x if self.use_feature_fusion else x
        return emb_l1, emb_l2, layer_norm(fused, self.norm_layer)

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
