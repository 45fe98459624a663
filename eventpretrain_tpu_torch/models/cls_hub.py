"""Classification hub: ViT, ConvViT, sparse Swin, ViT-ECDP, ConvViT-ECDP,
ViT-MEM or Swin-ECDDP backbone -> pool -> linear head.

Counterpart of eventpretrain_tpu/models/cls_hub.py. A ConvViT or Swin
hub's backbone has no stage decoders (``with_rec_decoders=False``), and
the pool is the mean over its last tokens (14^2 of the ViT and ConvViT,
7^2 of either Swin, the ECDDP one's ``norm3``-applied), or with
``pool="token_concat"`` their concatenation; an ECDP or MEM backbone's
dense encode returns its pooled embedding itself (the two learned tokens
concatenated (B, 2C); the normed mean of the patch tokens (B, C)),
which the head takes as it is. The module's
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

from eventpretrain_tpu_torch.models.convvit import (
    convvit_base_patch16,
    convvit_small_patch16,
)
from eventpretrain_tpu_torch.models.convvit_ecdp import (
    convvit_ecdp_base_patch16,
    convvit_ecdp_small_patch16,
)
from eventpretrain_tpu_torch.models.layers import Linear, init_weights
from eventpretrain_tpu_torch.models.swin import swin_tiny_window7
from eventpretrain_tpu_torch.models.swin_ecddp import swin_ecddp_tiny_window7
from eventpretrain_tpu_torch.models.vit import (
    vit_base_patch16,
    vit_small_patch16,
)
from eventpretrain_tpu_torch.models.vit_ecdp import (
    vit_ecdp_base_patch16,
    vit_ecdp_small_patch16,
)
from eventpretrain_tpu_torch.models.vit_mem import (
    vit_mem_base_patch16,
    vit_mem_small_patch16,
)


class FtClsHub(nn.Module):
    """Pooled tokens -> Linear(num_classes) (cls_hub.py:20-55): ``pool``
    "mean" or "token_concat"; an ECDP backbone's embedding unpooled."""

    def __init__(self, backbone: nn.Module, num_classes: int,
                 pool: str = "mean"):
        super().__init__()
        if pool not in ("mean", "token_concat"):
            raise ValueError(pool)
        self.backbone = backbone
        self.pool = pool
        in_dim = getattr(backbone, "pool_dim", None) or (
            backbone.embed_dim * (backbone.num_patches
                                  if pool == "token_concat" else 1))
        self.classify_head = Linear(
            in_dim, num_classes, dtype=backbone.dtype,
            device=next(backbone.parameters()).device,
        )

    def forward(self, x: torch.Tensor, return_attn: bool = False):
        """``x (B, H, W, num_bins)`` -> ``(emb_h, logits, attn)``; ``attn``
        is the last block's (B, heads, L, L) attention with
        ``return_attn``, else None."""
        out = self.backbone.encode_dense(
            x, return_attn=return_attn, return_pyramid=False
        )
        if len(out) == 3:
            emb_h, _, attn = out
            pooled = emb_h
        else:
            emb_h, attn = out[2], out[4]
            pooled = (emb_h.mean(dim=1) if self.pool == "mean"
                      else emb_h.reshape(emb_h.shape[0], -1))
        return emb_h, self.classify_head(pooled), attn


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


def cls_hub_convvit_small(num_classes: int, num_bins: int = 5, *,
                          dtype=torch.float32, device="cuda",
                          generator: Optional[torch.Generator] = None,
                          **bk) -> FtClsHub:
    """ConvViT-S hub without stage decoders (cls_hub.py:75-84), randomly
    initialised from ``generator``."""
    return _hub(convvit_small_patch16, num_classes, num_bins, dtype, device,
                generator, with_rec_decoders=False, **bk)


def cls_hub_convvit_base(num_classes: int, num_bins: int = 5, *,
                         dtype=torch.float32, device="cuda",
                         generator: Optional[torch.Generator] = None,
                         **bk) -> FtClsHub:
    """ConvViT-B hub without stage decoders (cls_hub.py:87-95)."""
    return _hub(convvit_base_patch16, num_classes, num_bins, dtype, device,
                generator, with_rec_decoders=False, **bk)


def cls_hub_swin_tiny(num_classes: int, num_bins: int = 5, *,
                      dtype=torch.float32, device="cuda",
                      generator: Optional[torch.Generator] = None,
                      **bk) -> FtClsHub:
    """Swin-T hub without stage decoders, the mean over its 49 stage-4
    tokens at 224 px (cls_hub.py:97-106)."""
    return _hub(swin_tiny_window7, num_classes, num_bins, dtype, device,
                generator, with_rec_decoders=False, **bk)


def cls_hub_vit_ecdp_small(num_classes: int, num_bins: int = 2, *,
                           dtype=torch.float32, device="cuda",
                           generator: Optional[torch.Generator] = None,
                           **bk) -> FtClsHub:
    """ViT-ECDP-S hub over the concatenated [event, image] tokens
    (cls_hub.py:108-117), randomly initialised from ``generator``."""
    return _hub(vit_ecdp_small_patch16, num_classes, num_bins, dtype,
                device, generator, **bk)


def cls_hub_vit_ecdp_base(num_classes: int, num_bins: int = 2, *,
                          dtype=torch.float32, device="cuda",
                          generator: Optional[torch.Generator] = None,
                          **bk) -> FtClsHub:
    """ViT-ECDP-B hub (cls_hub.py:120-127)."""
    return _hub(vit_ecdp_base_patch16, num_classes, num_bins, dtype, device,
                generator, **bk)


def cls_hub_convvit_ecdp_small(num_classes: int, num_bins: int = 2, *,
                               dtype=torch.float32, device="cuda",
                               generator: Optional[torch.Generator] = None,
                               **bk) -> FtClsHub:
    """ConvViT-ECDP-S hub (cls_hub.py:130-141)."""
    return _hub(convvit_ecdp_small_patch16, num_classes, num_bins, dtype,
                device, generator, **bk)


def cls_hub_convvit_ecdp_base(num_classes: int, num_bins: int = 2, *,
                              dtype=torch.float32, device="cuda",
                              generator: Optional[torch.Generator] = None,
                              **bk) -> FtClsHub:
    """ConvViT-ECDP-B hub (cls_hub.py:144-155)."""
    return _hub(convvit_ecdp_base_patch16, num_classes, num_bins, dtype,
                device, generator, **bk)


def cls_hub_vit_mem_small(num_classes: int, num_bins: int = 3, *,
                          dtype=torch.float32, device="cuda",
                          generator: Optional[torch.Generator] = None,
                          **bk) -> FtClsHub:
    """ViT-MEM-S hub over the normed mean of its patch tokens
    (cls_hub.py:158-165), randomly initialised from ``generator``."""
    return _hub(vit_mem_small_patch16, num_classes, num_bins, dtype, device,
                generator, **bk)


def cls_hub_vit_mem_base(num_classes: int, num_bins: int = 3, *,
                         dtype=torch.float32, device="cuda",
                         generator: Optional[torch.Generator] = None,
                         **bk) -> FtClsHub:
    """ViT-MEM-B hub (cls_hub.py:168-174)."""
    return _hub(vit_mem_base_patch16, num_classes, num_bins, dtype, device,
                generator, **bk)


def cls_hub_swin_ecddp_tiny(num_classes: int, num_bins: int = 5, *,
                            dtype=torch.float32, device="cuda",
                            generator: Optional[torch.Generator] = None,
                            **bk) -> FtClsHub:
    """Swin-ECDDP-T hub, the mean over its 49 ``norm3``-applied stage-4
    tokens at 224 px (cls_hub.py:176-183)."""
    return _hub(swin_ecddp_tiny_window7, num_classes, num_bins, dtype,
                device, generator, **bk)
