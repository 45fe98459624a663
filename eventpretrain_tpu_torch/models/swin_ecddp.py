"""The ECDDP baseline's Swin-T (dense, mmseg's shifted windows).

Counterpart of eventpretrain_tpu/models/swin_ecddp.py: the sparse Swin's
blocks (``models/swin.py``: ``PatchEmbedNorm``, ``SparseSwinBlock``,
``PatchMerging``) under the no-mask plans, with ECDDP's differences:

- stage 4's shifted blocks are not clamped: the lone 7x7 window is rolled
  and masked into 2x2 quadrant groups, so the plans are built with
  ``clamp_shift=False`` (``swin.dense_plans``, cached apart from the
  pretrain Swin's clamped ones);
- no final norm and no stage decoders; one LayerNorm for each output
  index (``norm0``-``norm3``); ``emb_h`` is the ``norm3``-applied stage-4
  tokens, and the low-level embeddings are the ``norm0``/``norm1``-applied
  stage tokens;
- drop-path 0.2 by default.

Parameter names are mmseg's, as JAX's exporter writes them
(ckpt/torch_import.py:104-107): ``patch_embed.{proj,norm}``,
``layers.S.blocks.B.*``, ``layers.S.downsample.{norm,reduction}``,
``norm{0..3}``; there is no ``norm_layer``.

JAX's ``ape`` and ``out_indices`` are left at their defaults (no absolute
position embedding; all four indices), as every factory and CLI leaves
them.
"""

from __future__ import annotations

from typing import Sequence

import torch
from torch import nn

from eventpretrain_tpu_torch.models.layers import layer_norm
from eventpretrain_tpu_torch.models.swin import (
    PatchEmbedNorm,
    dense_plans,
    run_stages,
    swin_stages,
)

# the mask-cell grid of JAX's SparseSwin, which the ECDDP Swin keeps at its
# default (49 cells); the no-mask plans do not read it
_CELL_GRID = 7


class SwinECDDP(nn.Module):
    """swin_ecddp.py:24-126 (without the optional classifier head: the
    cls hub adds its own)."""

    def __init__(self, input_size: int = 224, patch_size: int = 4,
                 embed_dims: Sequence[int] = (96, 192, 384, 768),
                 depths: Sequence[int] = (2, 2, 6, 2),
                 num_heads: Sequence[int] = (3, 6, 12, 24),
                 window_size: int = 7, mlp_ratio: float = 4.0,
                 num_bins: int = 5, drop_rate: float = 0.0,
                 attn_drop_rate: float = 0.0,
                 drop_path_rate: float = 0.2, layer_norm_eps: float = 1e-6,
                 *, dtype=torch.float32, device="cuda"):
        super().__init__()
        kw = dict(dtype=dtype, device=device)
        self.dtype = dtype
        self.embed_dims = tuple(embed_dims)
        self.embed_dim = embed_dims[-1]
        self.window_size = window_size
        self.patches_resolution = (input_size // patch_size,) * 2
        res = self.patches_resolution[0]
        self.patch_embed = PatchEmbedNorm(patch_size, num_bins, embed_dims[0],
                                          layer_norm_eps, **kw)
        self.pos_drop = nn.Dropout(drop_rate)
        self.layers = swin_stages(
            embed_dims, depths, num_heads, window_size, res, mlp_ratio,
            drop_rate, attn_drop_rate, drop_path_rate, layer_norm_eps, **kw)
        for i, dim in enumerate(embed_dims):
            self.add_module(f"norm{i}", nn.LayerNorm(
                dim, eps=layer_norm_eps, device=device))

    def encode_dense(self, x: torch.Tensor, return_attn: bool = False,
                     return_pyramid: bool = False):
        """``x (B, H, W, num_bins)`` -> ``(emb_l1, emb_l2, emb_h, out_embs,
        None)`` (swin_ecddp.py:75-119): the ``norm0``- and ``norm1``-applied
        stage-1 and stage-2 tokens, the ``norm3``-applied stage-4 tokens,
        and with ``return_pyramid`` the normed stages as channels-last
        maps (56^2 x 96, 28^2 x 192, 14^2 x 384, 7^2 x 768 at 224 px)."""
        plans = dense_plans(x.device, self.patches_resolution,
                            len(self.layers), self.window_size, _CELL_GRID,
                            clamp_shift=False)
        t = self.pos_drop(self.patch_embed(x)).index_select(
            1, plans[0].coords_flat)
        outs = run_stages(self.layers, t, plans)
        normed = [layer_norm(o, getattr(self, f"norm{i}"))
                  for i, o in enumerate(outs)]
        out_embs = []
        if return_pyramid:
            for i, o in enumerate(normed):
                h = self.patches_resolution[0] >> i
                out_embs.append(o.reshape(o.shape[0], h, h, o.shape[-1]))
        return normed[0], normed[1], normed[-1], out_embs, None

    def forward(self, x: torch.Tensor):
        return self.encode_dense(x)


def swin_ecddp_tiny_window7(**kwargs) -> SwinECDDP:
    """swin_ecddp.py:129-135: Swin-T, window 7."""
    cfg = dict(input_size=224, patch_size=4, embed_dims=(96, 192, 384, 768),
               depths=(2, 2, 6, 2), num_heads=(3, 6, 12, 24), window_size=7)
    cfg.update(kwargs)
    return SwinECDDP(**cfg)
