"""MAE-style reconstruction decoder for masked modeling.

Counterpart of eventpretrain_tpu/models/decoder.py: a linear embed of the
encoder's visible tokens, the learned ``mask_token`` (a ``(1, 1, C)``
parameter, zero-initialised) inserted and unshuffled by ``ids_restore``,
the fixed sincos pos-embed, ``depth`` ViT blocks (K1/K2 under the JAX
gates), a LayerNorm and a linear prediction of ``patch_size**2 *
frame_chans`` values per token. Parameter names follow the exporter's key
space (``pretrain_rec_decoder.*`` inside the hub).
"""

from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from eventpretrain_tpu_torch.models.layers import Linear, ViTBlock, layer_norm
from eventpretrain_tpu_torch.ops.pos_embed import get_2d_sincos_pos_embed


class RecDecoder(nn.Module):
    def __init__(self, encoder_dim: int, patch_size: int = 16,
                 num_patches: int = 196, embed_dim: int = 256, depth: int = 8,
                 num_heads: int = 8, mlp_ratio: float = 4.0,
                 frame_chans: int = 1, layer_norm_eps: float = 1e-6, *,
                 dtype=torch.float32, device="cuda"):
        super().__init__()
        kw = dict(dtype=dtype, device=device)
        self.dtype = dtype
        self.patch_size = patch_size
        self.frame_chans = frame_chans
        self.patch_embed = Linear(encoder_dim, embed_dim, **kw)
        self.mask_token = nn.Parameter(
            torch.zeros((1, 1, embed_dim), device=device))
        self.vit_block = nn.ModuleList(
            ViTBlock(embed_dim, num_heads, mlp_ratio, qkv_bias=True,
                     layer_norm_eps=layer_norm_eps, **kw)
            for _ in range(depth)
        )
        self.norm = nn.LayerNorm(embed_dim, eps=layer_norm_eps, device=device)
        self.pred = Linear(embed_dim, patch_size ** 2 * frame_chans, **kw)
        grid = int(num_patches ** 0.5)
        table = get_2d_sincos_pos_embed(embed_dim, grid)
        self.register_buffer(
            "pos_embed", torch.from_numpy(table)[None].to(device),
            persistent=False,
        )

    def forward(self, x: torch.Tensor,
                ids_restore: Optional[torch.Tensor] = None) -> torch.Tensor:
        """``x (B, K, D_enc)`` visible tokens -> ``(B, L, p*p*chans)``."""
        x = self.patch_embed(x)
        if ids_restore is not None:
            b, k, d = x.shape
            num_masked = ids_restore.shape[1] - k
            mask_tokens = self.mask_token.to(x.dtype).expand(b, num_masked, d)
            x = torch.cat([x, mask_tokens], dim=1)
            x = torch.gather(x, 1, ids_restore[..., None].expand(-1, -1, d))
        x = x + self.pos_embed.to(x.dtype)
        for blk in self.vit_block:
            x = blk(x)
        return self.pred(layer_norm(x, self.norm))


def rec_decoder_small_patch16(encoder_dim: int, frame_chans: int = 1,
                              **kwargs) -> RecDecoder:
    """decoder.py:82-87: C=256, depth 8, 8 heads."""
    cfg = dict(patch_size=16, embed_dim=256, depth=8, num_heads=8,
               frame_chans=frame_chans, num_patches=196)
    cfg.update(kwargs)
    return RecDecoder(encoder_dim, **cfg)


def rec_decoder_swin_tiny_patch32(encoder_dim: int, frame_chans: int = 1,
                                  **kwargs) -> RecDecoder:
    """decoder.py:90-96: the sparse Swin's, C=256, depth 8, 8 heads, one
    token a 32-pixel mask cell (49 at 224 px)."""
    cfg = dict(patch_size=32, embed_dim=256, depth=8, num_heads=8,
               frame_chans=frame_chans, num_patches=49)
    cfg.update(kwargs)
    return RecDecoder(encoder_dim, **cfg)


def rec_decoder_base_patch16(encoder_dim: int, frame_chans: int = 1,
                             **kwargs) -> RecDecoder:
    """decoder.py:98-103: C=512, depth 8, 16 heads."""
    cfg = dict(patch_size=16, embed_dim=512, depth=8, num_heads=16,
               frame_chans=frame_chans, num_patches=196)
    cfg.update(kwargs)
    return RecDecoder(encoder_dim, **cfg)
