"""Classification hub: ViT backbone -> mean pool -> linear head.

Counterpart of eventpretrain_tpu/models/cls_hub.py:20-72 (the ViT hubs; the
ConvViT, Swin, ECDP and MEM hubs wait for their backbones).
"""

from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from eventpretrain_tpu_torch.models.layers import init_weights
from eventpretrain_tpu_torch.models.vit import (
    ViT,
    vit_base_patch16,
    vit_small_patch16,
)


class FtClsHub(nn.Module):
    """Mean-pooled tokens -> Linear(num_classes). The ECDP token-concat
    pool comes with the ECDP backbones."""

    def __init__(self, backbone: ViT, num_classes: int):
        super().__init__()
        self.backbone = backbone
        w = backbone.patch_embed.proj.weight
        self.classify_head = nn.Linear(backbone.embed_dim, num_classes,
                                       dtype=w.dtype, device=w.device)

    def forward(self, x: torch.Tensor, return_attn: bool = False):
        """``x (B, H, W, num_bins)`` -> ``(emb_h, logits, attn)``."""
        _, _, emb_h, _, attn = self.backbone.encode_dense(
            x, return_attn=return_attn, return_pyramid=False
        )
        return emb_h, self.classify_head(emb_h.mean(dim=1)), attn


def _hub(make_backbone, num_classes: int, num_bins: int, dtype, device,
         generator: Optional[torch.Generator], **bk) -> FtClsHub:
    hub = FtClsHub(
        make_backbone(num_bins=num_bins, dtype=dtype, device=device, **bk),
        num_classes,
    )
    if generator is None:
        generator = torch.Generator().manual_seed(0)
    init_weights(hub, generator)
    return hub


def cls_hub_vit_small(num_classes: int, num_bins: int = 5, *,
                      dtype=torch.float32, device=None,
                      generator: Optional[torch.Generator] = None,
                      **bk) -> FtClsHub:
    """ViT-S/16 hub, randomly initialised from ``generator`` (a CPU
    generator; seed 0 when None)."""
    return _hub(vit_small_patch16, num_classes, num_bins, dtype, device,
                generator, **bk)


def cls_hub_vit_base(num_classes: int, num_bins: int = 5, *,
                     dtype=torch.float32, device=None,
                     generator: Optional[torch.Generator] = None,
                     **bk) -> FtClsHub:
    """ViT-B/16 hub, randomly initialised from ``generator``."""
    return _hub(vit_base_patch16, num_classes, num_bins, dtype, device,
                generator, **bk)
