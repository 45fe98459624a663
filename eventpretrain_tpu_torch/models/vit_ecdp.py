"""ViT-ECDP backbone: the ViT with two learned [event, image] tokens.

Counterpart of eventpretrain_tpu/models/vit_ecdp.py: the plain conv patch
embedding (``PatchEmbed(use_norm_act=False)``, no LayerNorm or GELU), the
fixed sincos pos-embed added to the patch tokens only, and the two learned
``tokens`` (1, 2, C), zeros at init, prepended after the masking gather.
``encode_masked`` returns the two token embeddings after the final norm;
``encode_dense`` returns their concatenation (B, 2C), with the pyramid's
maps taken from the patch tokens ``x[:, 2:]``. With 49 of 196 patches
kept the blocks see 51 tokens, with all of them 198; every block takes
K1/K2 under the ViT's gates.
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


def prepend_tokens(tokens: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """``tokens`` (1, 2, C) in ``x``'s dtype before ``x``'s (B, L, C)."""
    tok = tokens.to(x.dtype).expand(x.shape[0], -1, -1)
    return torch.cat([tok, x], dim=1)


def run_token_blocks(blocks, x: torch.Tensor, norm: nn.LayerNorm,
                     return_attn: bool,
                     taps: Sequence[int] = ()) -> tuple:
    """``x`` (B, 2 + L, C) through ``blocks``, the last one's attention
    with ``return_attn``; returns ``(normed x, the (B, h, w, C) maps of
    the patch tokens after the blocks ``taps``, attn)``."""
    attn, out_embs = None, []
    last = len(blocks) - 1
    for i, blk in enumerate(blocks):
        if i == last and return_attn:
            x, attn = blk(x, True)
        else:
            x = blk(x)
        if i in taps:
            out_embs.append(emb2patch_frame(x[:, 2:]))
    return layer_norm(x, norm), out_embs, attn


class ViTECDP(nn.Module):
    def __init__(self, input_size: int = 224, patch_size: int = 16,
                 embed_dim: int = 384, depth: int = 12, num_heads: int = 12,
                 mlp_ratio: float = 4.0,
                 out_indices: Sequence[int] = (3, 5, 7, 11),
                 num_bins: int = 2, drop_rate: float = 0.0,
                 attn_drop_rate: float = 0.0, drop_path_rate: float = 0.0,
                 layer_norm_eps: float = 1e-6, *, dtype=torch.float32,
                 device="cuda"):
        super().__init__()
        kw = dict(dtype=dtype, device=device)
        self.dtype = dtype
        self.embed_dim = embed_dim
        self.pool_dim = 2 * embed_dim
        self.patch_size = patch_size
        self.out_indices = tuple(out_indices)
        self.grid_size = input_size // patch_size
        self.num_patches = self.grid_size ** 2
        self.patch_embed = PatchEmbed(patch_size, num_bins, embed_dim,
                                      use_norm_act=False, **kw)
        self.tokens = nn.Parameter(torch.zeros((1, 2, embed_dim),
                                               device=device))
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
        table = get_2d_sincos_pos_embed(embed_dim, self.grid_size)
        self.register_buffer(
            "pos_embed", torch.from_numpy(table)[None].to(device),
            persistent=False,
        )

    def _embed(self, x: torch.Tensor) -> torch.Tensor:
        x = self.patch_embed(x)
        x = x.reshape(x.shape[0], -1, x.shape[-1])
        return self.pos_drop(x + self.pos_embed.to(x.dtype))

    def _embed_gathered(self, x: torch.Tensor,
                        ids_keep: torch.Tensor) -> torch.Tensor:
        """``_embed`` then the gather at ``ids_keep``, computed on the kept
        patches alone: the stride-p conv is patch-local."""
        b, k = ids_keep.shape
        p = self.patch_size
        patches = frame2emb(p, x)  # (B, L, p*p*bins)
        idx = ids_keep[..., None].expand(b, k, patches.shape[-1])
        patches = torch.gather(patches, 1, idx).reshape(b * k, p, p,
                                                          x.shape[-1])
        emb = self.patch_embed(patches).reshape(b, k, self.embed_dim)
        return self.pos_drop(emb + self.pos_embed[0].to(emb.dtype)[ids_keep])

    def encode_masked(self, x: torch.Tensor, ids_keep: torch.Tensor,
                      mask: Optional[torch.Tensor] = None,
                      return_attn: bool = False):
        """``x (B, H, W, num_bins)`` at the kept patches ``ids_keep (B,
        K)`` -> ``(emb_event, emb_image, attn)``: the two tokens after the
        final norm, (B, C) each (vit_ecdp.py:99-118). ``mask`` is unused,
        as in JAX."""
        x = prepend_tokens(self.tokens, self._embed_gathered(x, ids_keep))
        x, _, attn = run_token_blocks(self.vit_block, x, self.norm_layer,
                                      return_attn)
        return x[:, 0], x[:, 1], attn

    def encode_dense(self, x: torch.Tensor, return_attn: bool = False,
                     return_pyramid: bool = False):
        """All patches -> ``(emb, out_embs, attn)``: ``emb`` the two normed
        tokens concatenated (B, 2C), ``out_embs`` the patch tokens' (B, h,
        w, C) maps after the blocks ``out_indices`` with
        ``return_pyramid``, else empty (vit_ecdp.py:120-143)."""
        x = prepend_tokens(self.tokens, self._embed(x))
        x, out_embs, attn = run_token_blocks(
            self.vit_block, x, self.norm_layer, return_attn,
            self.out_indices if return_pyramid else ())
        return torch.cat([x[:, 0], x[:, 1]], dim=1), out_embs, attn

    def forward(self, x: torch.Tensor):
        return self.encode_dense(x)


def vit_ecdp_small_patch16(**kwargs) -> ViTECDP:
    cfg = dict(input_size=224, patch_size=16, embed_dim=384, depth=12,
               num_heads=12)
    cfg.update(kwargs)
    return ViTECDP(**cfg)


def vit_ecdp_base_patch16(**kwargs) -> ViTECDP:
    cfg = dict(input_size=224, patch_size=16, embed_dim=768, depth=12,
               num_heads=12)
    cfg.update(kwargs)
    return ViTECDP(**cfg)
