"""ConvViT (ConvMAE-style) backbone: two convolutional stages, then a ViT
stage, with the masked and the dense paths.

Counterpart of eventpretrain_tpu/models/convvit.py:

- stage 1: ``PatchEmbed`` 4x (LN + GELU) -> ``ConvBlock`` x depths[0] at
  56^2, width d0;
- stage 2: ``PatchEmbed`` 2x -> ``ConvBlock`` x depths[0] at 28^2, width d1
  (the reference sizes ``conv_block2`` with ``depths[0]``, convvit.py:158);
- stage 3: ``PatchEmbed`` 2x -> Linear ``patch_embed4`` -> sincos pos-embed
  -> ``ViTBlock`` x depths[2] at 14^2, width d2 (K1/K2, K4 under their
  gates, as in the ViT).

Drop-path rates run over ``sum(depths)`` sites in the reference's order, so
the ViT blocks start at index ``depths[0] + depths[1]``; every ``DropPath``
draws from the model's :class:`DropPathSource` in call order (the conv
blocks' two draws each, then the ViT blocks'). LayerNorm eps is 1e-5 in the
conv blocks and the patch embeds, ``layer_norm_eps`` (1e-6) in the ViT
blocks and ``norm_layer``.

Layout: the conv stages keep their activations channels-last, ``(B, H, W,
C)`` contiguous, as JAX's are. Each conv sees them through a permuted view,
an NCHW tensor in ``torch.channels_last`` memory format, and returns the
same format, so no conv copies its input or output (cuDNN's NHWC kernels on
the card) and every LayerNorm reads contiguous rows of C. The convs (patch
embeds, 1x1 convs, the depthwise 5x5, the stage decoders, the FPN conv) are
library calls, as JAX computes them with ``nn.Conv`` outside any Pallas
kernel.

Parameter names are the exporter's (ckpt/torch_import.py:116, 140-144):
``conv_block1.0.attn.weight`` (the depthwise kernel, OIHW (C, 1, 5, 5)),
``vit_block.3.*``, ``stage1_output_decode``, ``norm_layer``, ``fpn.0``
(the 3x3 stride-2 conv) and ``fpn.1`` (its flax-style BatchNorm, running
statistics as buffers).
"""

from __future__ import annotations

from typing import Optional, Sequence

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from eventpretrain_tpu_torch.models.dense_heads import BatchNorm
from eventpretrain_tpu_torch.models.layers import (
    Conv2d,
    DropPath,
    Linear,
    PatchEmbed,
    ViTBlock,
    layer_norm,
)
from eventpretrain_tpu_torch.ops.pos_embed import get_2d_sincos_pos_embed
from eventpretrain_tpu_torch.ops.reshape import emb2patch_frame


def conv_nhwc(conv: nn.Module, x: torch.Tensor) -> torch.Tensor:
    """``conv`` on a channels-last ``(B, H, W, C)`` tensor, through the
    NCHW view (``channels_last`` memory); returns ``(B, H', W', C')``."""
    return conv(x.permute(0, 3, 1, 2)).permute(0, 2, 3, 1)


class CMlp(nn.Module):
    """1x1 conv -> exact GELU -> dropout -> 1x1 conv -> dropout
    (convvit.py:31-46), the dropout ``drop_rate``'s, as the ViT's ``Mlp``."""

    def __init__(self, dim: int, hidden_dim: int, dropout: float = 0.0, *,
                 dtype=torch.float32, device=None):
        super().__init__()
        kw = dict(dtype=dtype, device=device)
        self.fc1 = Conv2d(dim, hidden_dim, 1, 1, **kw)
        self.fc2 = Conv2d(hidden_dim, dim, 1, 1, **kw)
        self.drop = nn.Dropout(dropout)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = self.drop(F.gelu(conv_nhwc(self.fc1, x), approximate="none"))
        return self.drop(conv_nhwc(self.fc2, x))


class ConvBlock(nn.Module):
    """LN -> 1x1 conv -> (visibility mask) -> depthwise kxk -> 1x1 conv,
    residual with drop-path; then LN -> ``CMlp``, residual with drop-path
    (convvit.py:49-84). ``mask`` (B, H, W), 1 = visible, multiplies after
    ``conv1``."""

    def __init__(self, dim: int, kernel_size: int = 5, mlp_ratio: float = 4.0,
                 drop: float = 0.0, drop_path_rate: float = 0.0, *,
                 dtype=torch.float32, device=None):
        super().__init__()
        kw = dict(dtype=dtype, device=device)
        self.norm1 = nn.LayerNorm(dim, eps=1e-5, device=device)
        self.conv1 = Conv2d(dim, dim, 1, 1, **kw)
        self.attn = Conv2d(dim, dim, kernel_size, 1, kernel_size // 2,
                           groups=dim, **kw)
        self.conv2 = Conv2d(dim, dim, 1, 1, **kw)
        self.drop_path = DropPath(drop_path_rate)
        self.norm2 = nn.LayerNorm(dim, eps=1e-5, device=device)
        self.mlp = CMlp(dim, int(dim * mlp_ratio), drop, **kw)

    def forward(self, x: torch.Tensor,
                mask: Optional[torch.Tensor] = None) -> torch.Tensor:
        y = conv_nhwc(self.conv1, layer_norm(x, self.norm1))
        if mask is not None:
            y = y * mask[..., None].to(y.dtype)
        y = conv_nhwc(self.conv2, conv_nhwc(self.attn, y))
        x = x + self.drop_path(y)
        return x + self.drop_path(self.mlp(layer_norm(x, self.norm2)))


def upsample_mask(mask: torch.Tensor, grid: int,
                  factor: int) -> torch.Tensor:
    """``(B, grid^2)`` patch mask -> ``(B, grid*factor, grid*factor)``, each
    patch's value repeated over its ``factor x factor`` cells
    (convvit.py:87-91)."""
    m = mask.reshape(-1, grid, grid)
    return m.repeat_interleave(factor, 1).repeat_interleave(factor, 2)


class ConvViT(nn.Module):
    def __init__(self, input_size: int = 224,
                 patch_sizes: Sequence[int] = (4, 2, 2),
                 embed_dims: Sequence[int] = (128, 256, 384),
                 depths: Sequence[int] = (2, 2, 11), num_heads: int = 12,
                 mlp_ratio: float = 4.0, num_bins: int = 5,
                 drop_rate: float = 0.0, attn_drop_rate: float = 0.0,
                 drop_path_rate: float = 0.0, use_feature_fusion: bool = True,
                 with_rec_decoders: bool = True, with_fpn: bool = False,
                 layer_norm_eps: float = 1e-6, *, dtype=torch.float32,
                 device="cuda"):
        super().__init__()
        kw = dict(dtype=dtype, device=device)
        d0, d1, d2 = embed_dims
        self.dtype = dtype
        self.patch_sizes = tuple(patch_sizes)
        self.embed_dim = d2
        self.use_feature_fusion = use_feature_fusion
        self.patch_size = int(np.prod(self.patch_sizes))
        self.grid_size = input_size // self.patch_size
        self.num_patches = self.grid_size ** 2
        self.patch_embed1 = PatchEmbed(patch_sizes[0], num_bins, d0, **kw)
        self.patch_embed2 = PatchEmbed(patch_sizes[1], d0, d1, **kw)
        self.patch_embed3 = PatchEmbed(patch_sizes[2], d1, d2, **kw)
        self.patch_embed4 = Linear(d2, d2, **kw)
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
        if with_rec_decoders:
            self.stage1_output_decode = Conv2d(d0, d2, 4, 4, **kw)
            self.stage2_output_decode = Conv2d(d1, d2, 2, 2, **kw)
        self.norm_layer = nn.LayerNorm(d2, eps=layer_norm_eps, device=device)
        if with_fpn:
            self.fpn = nn.ModuleList([Conv2d(d2, d2, 3, 2, **kw),
                                      BatchNorm(d2, device=device)])
        table = get_2d_sincos_pos_embed(d2, self.grid_size)
        self.register_buffer(
            "pos_embed", torch.from_numpy(table)[None].to(device),
            persistent=False,
        )

    def _stages_to_tokens(self, x: torch.Tensor) -> torch.Tensor:
        x = self.patch_embed3(x)
        x = self.patch_embed4(x.reshape(x.shape[0], -1, x.shape[-1]))
        return x + self.pos_embed.to(x.dtype)

    def encode_masked(self, x: torch.Tensor, ids_keep: torch.Tensor,
                      mask: Optional[torch.Tensor] = None):
        """Masked encoding of ``x (B, H, W, num_bins)`` (convvit.py:
        206-248): the full binary ``mask (B, L)`` (0 = keep), upsampled to
        each conv stage's grid, gates the conv blocks; the stage decoders'
        outputs and the ViT stage's tokens are gathered at ``ids_keep (B,
        K)``. Returns ``(emb_l1, emb_l2, emb_lh)``: the stage maps (B, 56,
        56, d0) and (B, 28, 28, d1) at 224, and ``norm(s1 + s2 + s3)`` (B,
        K, d2) under feature fusion, else ``norm(s3)``."""
        if mask is None:
            raise ValueError("ConvViT.encode_masked needs the full mask")
        grid = self.grid_size
        vis1 = 1.0 - upsample_mask(mask, grid, self.patch_sizes[1]
                                   * self.patch_sizes[2])
        vis2 = 1.0 - upsample_mask(mask, grid, self.patch_sizes[2])
        idx = ids_keep[..., None].expand(-1, -1, self.embed_dim)

        def decode_kept(decode, feat):
            s = conv_nhwc(decode, feat)
            return torch.gather(s.reshape(s.shape[0], -1, s.shape[-1]), 1,
                                idx)

        x = self.patch_embed1(x)
        for blk in self.conv_block1:
            x = blk(x, vis1)
        emb_l1 = x
        s1 = decode_kept(self.stage1_output_decode, x)
        x = self.patch_embed2(x)
        for blk in self.conv_block2:
            x = blk(x, vis2)
        emb_l2 = x
        s2 = decode_kept(self.stage2_output_decode, x)
        x = torch.gather(self._stages_to_tokens(x), 1, idx)
        for blk in self.vit_block:
            x = blk(x)
        fused = s1 + s2 + x if self.use_feature_fusion else x
        return emb_l1, emb_l2, layer_norm(fused, self.norm_layer)

    def encode_dense(self, x: torch.Tensor, return_attn: bool = False,
                     return_pyramid: bool = True):
        """Full encoding of ``x (B, H, W, num_bins)`` (convvit.py:250-290).
        Returns ``(emb_l1, emb_l2, emb_h, out_embs, attn)``: the stage maps,
        the normed last tokens (B, L, d2), the 4-level channels-last pyramid
        ``[emb_l1, emb_l2, emb_h as a 14^2 map, GELU(BN(fpn conv))]`` with
        ``return_pyramid`` (the last level f32, from the f32 BatchNorm, as
        in JAX), else empty, and the last block's attention or None."""
        x = self.patch_embed1(x)
        for blk in self.conv_block1:
            x = blk(x)
        emb_l1 = x
        x = self.patch_embed2(x)
        for blk in self.conv_block2:
            x = blk(x)
        emb_l2 = x
        x = self._stages_to_tokens(x)
        attn = None
        last = len(self.vit_block) - 1
        for i, blk in enumerate(self.vit_block):
            if i == last and return_attn:
                x, attn = blk(x, True)
            else:
                x = blk(x)
        emb_h = layer_norm(x, self.norm_layer)
        out_embs = []
        if return_pyramid:
            emb_h1 = emb2patch_frame(emb_h)
            conv, bn = self.fpn
            emb_h2 = F.gelu(bn(conv_nhwc(conv, emb_h1)), approximate="none")
            out_embs = [emb_l1, emb_l2, emb_h1, emb_h2]
        return emb_l1, emb_l2, emb_h, out_embs, attn

    def forward(self, x: torch.Tensor):
        """Dense encoding without pyramid or attention."""
        return self.encode_dense(x, return_attn=False, return_pyramid=False)


def convvit_small_patch16(**kwargs) -> ConvViT:
    """convvit.py:296-303: widths (128, 256, 384), 12 heads."""
    cfg = dict(input_size=224, patch_sizes=(4, 2, 2),
               embed_dims=(128, 256, 384), depths=(2, 2, 11), num_heads=12,
               mlp_ratio=4.0)
    cfg.update(kwargs)
    return ConvViT(**cfg)


def convvit_base_patch16(**kwargs) -> ConvViT:
    """convvit.py:306-313: widths (256, 384, 768), 12 heads."""
    cfg = dict(input_size=224, patch_sizes=(4, 2, 2),
               embed_dims=(256, 384, 768), depths=(2, 2, 11), num_heads=12,
               mlp_ratio=4.0)
    cfg.update(kwargs)
    return ConvViT(**cfg)
