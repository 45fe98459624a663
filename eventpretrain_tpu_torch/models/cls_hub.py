"""Classification hub: ViT backbone -> mean pool -> linear head.

Counterpart of eventpretrain_tpu/models/cls_hub.py:20-73 (the ViT hubs; the
ConvViT, Swin, ECDP and MEM hubs wait for their backbones). The module's
mode is flax's ``train`` flag: ``hub.train()`` activates dropout and
stochastic depth (``drop_rate``, ``attn_drop_rate``, ``drop_path_rate``,
passed to the factories), whose masks come from the
:class:`~eventpretrain_tpu_torch.models.layers.DropPathSource` the train
step sets; ``hub.eval()`` is deterministic.
"""

from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from eventpretrain_tpu_torch.models.layers import Linear, init_weights
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
        self.classify_head = Linear(
            backbone.embed_dim, num_classes, dtype=backbone.dtype,
            device=backbone.patch_embed.proj.weight.device,
        )

    def forward(self, x: torch.Tensor, return_attn: bool = False):
        """``x (B, H, W, num_bins)`` -> ``(emb_h, logits, attn)``; ``attn``
        is the last block's (B, heads, L, L) attention with
        ``return_attn``, else None."""
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
                      dtype=torch.float32, device="cuda",
                      generator: Optional[torch.Generator] = None,
                      **bk) -> FtClsHub:
    """ViT-S/16 hub on ``device`` (the card unless the caller asks for the
    CPU), f32 parameters computed in ``dtype``, randomly initialised from
    ``generator`` (a CPU generator; seed 0 when None)."""
    return _hub(vit_small_patch16, num_classes, num_bins, dtype, device,
                generator, **bk)


def cls_hub_vit_base(num_classes: int, num_bins: int = 5, *,
                     dtype=torch.float32, device="cuda",
                     generator: Optional[torch.Generator] = None,
                     **bk) -> FtClsHub:
    """ViT-B/16 hub, randomly initialised from ``generator``."""
    return _hub(vit_base_patch16, num_classes, num_bins, dtype, device,
                generator, **bk)
