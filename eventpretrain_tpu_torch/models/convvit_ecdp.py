"""ConvViT-ECDP backbone: the ConvViT's conv stages, then the two learned
[event, image] tokens prepended at stage 3.

Counterpart of eventpretrain_tpu/models/convvit_ecdp.py: ``PatchEmbed``
4x (LN + GELU) -> ``ConvBlock`` x depths[0] at 56^2 -> ``PatchEmbed`` 2x
-> ``ConvBlock`` x depths[0] at 28^2 (the reference sizes stage 2 with
``depths[0]``) -> ``PatchEmbed`` 2x -> Linear ``patch_embed4`` -> sincos
pos-embed -> gather -> ``tokens`` -> ``ViTBlock`` x depths[2] -> norm.
No stage decoders and no FPN. On the masked path the patch mask,
upsampled to each conv stage's grid, gates the conv blocks
(``models/convvit.py``); the dense path's pyramid is JAX's repair, four
14^2 maps of the patch tokens after the blocks ``out_indices``.
Drop-path rates run over ``sum(depths)`` sites in the reference's order.
"""

from __future__ import annotations

from typing import Optional, Sequence

import numpy as np
import torch
from torch import nn

from eventpretrain_tpu_torch.models.convvit import ConvBlock, upsample_mask
from eventpretrain_tpu_torch.models.layers import Linear, PatchEmbed, ViTBlock
from eventpretrain_tpu_torch.models.vit_ecdp import (
    prepend_tokens,
    run_token_blocks,
)
from eventpretrain_tpu_torch.ops.pos_embed import get_2d_sincos_pos_embed


class ConvViTECDP(nn.Module):
    def __init__(self, input_size: int = 224,
                 patch_sizes: Sequence[int] = (4, 2, 2),
                 embed_dims: Sequence[int] = (128, 256, 384),
                 depths: Sequence[int] = (2, 2, 11),
                 out_indices: Sequence[int] = (2, 4, 6, 10),
                 num_heads: int = 12, mlp_ratio: float = 4.0,
                 num_bins: int = 2, drop_rate: float = 0.0,
                 attn_drop_rate: float = 0.0, drop_path_rate: float = 0.0,
                 layer_norm_eps: float = 1e-6, *, dtype=torch.float32,
                 device="cuda"):
        super().__init__()
        kw = dict(dtype=dtype, device=device)
        d0, d1, d2 = embed_dims
        self.dtype = dtype
        self.patch_sizes = tuple(patch_sizes)
        self.embed_dim = d2
        self.pool_dim = 2 * d2
        self.out_indices = tuple(out_indices)
        self.patch_size = int(np.prod(self.patch_sizes))
        self.grid_size = input_size // self.patch_size
        self.num_patches = self.grid_size ** 2
        self.patch_embed1 = PatchEmbed(patch_sizes[0], num_bins, d0, **kw)
        self.patch_embed2 = PatchEmbed(patch_sizes[1], d0, d1, **kw)
        self.patch_embed3 = PatchEmbed(patch_sizes[2], d1, d2, **kw)
        self.patch_embed4 = Linear(d2, d2, **kw)
        self.tokens = nn.Parameter(torch.zeros((1, 2, d2), device=device))
        dpr = [float(r) for r in np.linspace(0, drop_path_rate, sum(depths))]
        self.conv_block1 = nn.ModuleList(
            ConvBlock(d0, 5, 4.0, drop_rate, dpr[i], **kw)
            for i in range(depths[0]))
        self.conv_block2 = nn.ModuleList(
            ConvBlock(d1, 5, 4.0, drop_rate, dpr[depths[0] + i], **kw)
            for i in range(depths[0]))
        first = depths[0] + depths[1]
        self.vit_block = nn.ModuleList(
            ViTBlock(d2, num_heads, mlp_ratio, qkv_bias=True, drop=drop_rate,
                     attn_drop=attn_drop_rate,
                     drop_path_rate=dpr[first + i],
                     layer_norm_eps=layer_norm_eps, **kw)
            for i in range(depths[2]))
        self.norm_layer = nn.LayerNorm(d2, eps=layer_norm_eps, device=device)
        table = get_2d_sincos_pos_embed(d2, self.grid_size)
        self.register_buffer(
            "pos_embed", torch.from_numpy(table)[None].to(device),
            persistent=False,
        )

    def _conv_stages(self, x: torch.Tensor, vis1=None,
                     vis2=None) -> torch.Tensor:
        x = self.patch_embed1(x)
        for blk in self.conv_block1:
            x = blk(x, vis1)
        x = self.patch_embed2(x)
        for blk in self.conv_block2:
            x = blk(x, vis2)
        x = self.patch_embed3(x)
        x = self.patch_embed4(x.reshape(x.shape[0], -1, x.shape[-1]))
        return x + self.pos_embed.to(x.dtype)

    def encode_masked(self, x: torch.Tensor, ids_keep: torch.Tensor,
                      mask: Optional[torch.Tensor] = None,
                      return_attn: bool = False):
        """``x (B, H, W, num_bins)``, the kept patches ``ids_keep (B, K)``
        and the full binary ``mask (B, L)`` (0 = keep) -> ``(emb_event,
        emb_image, attn)`` (convvit_ecdp.py:129-154)."""
        if mask is None:
            raise ValueError("ConvViTECDP.encode_masked needs the full mask")
        grid = self.grid_size
        vis1 = 1.0 - upsample_mask(mask, grid, self.patch_sizes[1]
                                   * self.patch_sizes[2])
        vis2 = 1.0 - upsample_mask(mask, grid, self.patch_sizes[2])
        x = self._conv_stages(x, vis1, vis2)
        x = torch.gather(x, 1, ids_keep[..., None].expand(-1, -1,
                                                          x.shape[-1]))
        x, _, attn = run_token_blocks(self.vit_block,
                                      prepend_tokens(self.tokens, x),
                                      self.norm_layer, return_attn)
        return x[:, 0], x[:, 1], attn

    def encode_dense(self, x: torch.Tensor, return_attn: bool = False,
                     return_pyramid: bool = False):
        """All patches -> ``(emb, out_embs, attn)`` as
        ``ViTECDP.encode_dense`` (convvit_ecdp.py:156-177)."""
        x = prepend_tokens(self.tokens, self._conv_stages(x))
        x, out_embs, attn = run_token_blocks(
            self.vit_block, x, self.norm_layer, return_attn,
            self.out_indices if return_pyramid else ())
        return torch.cat([x[:, 0], x[:, 1]], dim=1), out_embs, attn

    def forward(self, x: torch.Tensor):
        return self.encode_dense(x)


def convvit_ecdp_small_patch16(**kwargs) -> ConvViTECDP:
    cfg = dict(input_size=224, patch_sizes=(4, 2, 2),
               embed_dims=(128, 256, 384), depths=(2, 2, 11), num_heads=12)
    cfg.update(kwargs)
    return ConvViTECDP(**cfg)


def convvit_ecdp_base_patch16(**kwargs) -> ConvViTECDP:
    cfg = dict(input_size=224, patch_sizes=(4, 2, 2),
               embed_dims=(256, 384, 768), depths=(2, 2, 11), num_heads=12)
    cfg.update(kwargs)
    return ConvViTECDP(**cfg)
