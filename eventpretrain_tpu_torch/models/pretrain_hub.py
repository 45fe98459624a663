"""Pretrain hub: ViT backbone + MAE decoder (stage 1).

Counterpart of eventpretrain_tpu/models/pretrain_hub.py:33-115, 156-187
(``PrHub.forward_rec`` and the ViT factories). The projector heads and
``forward_con`` (stages 2/3) come with slice 3; so the hub's keys are those
of a ``forward_rec``-initialised JAX tree, and its export loads strictly.
"""

from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from eventpretrain_tpu_torch.models.decoder import (
    RecDecoder,
    rec_decoder_base_patch16,
    rec_decoder_small_patch16,
)
from eventpretrain_tpu_torch.models.layers import init_weights
from eventpretrain_tpu_torch.models.vit import (
    ViT,
    vit_base_patch16,
    vit_small_patch16,
)


class PrHub(nn.Module):
    """``backbone`` + ``pretrain_rec_decoder`` (the exporter's names)."""

    def __init__(self, backbone: ViT, decoder: RecDecoder):
        super().__init__()
        self.backbone = backbone
        self.pretrain_rec_decoder = decoder
        self.embed_dim = backbone.embed_dim
        self.num_patches = backbone.num_patches
        self.patch_size = backbone.patch_size

    def forward_rec(self, evg: torch.Tensor, ids_keep: torch.Tensor,
                    ids_restore: torch.Tensor):
        """Masked encode + reconstruction prediction: ``(pred, emb_l1,
        emb_l2, emb_lh)``; the loss is ``objectives.rec.reconstruct_loss``.
        """
        emb_l1, emb_l2, emb_lh = self.backbone.encode_masked(evg, ids_keep)
        pred = self.pretrain_rec_decoder(emb_lh, ids_restore)
        return pred, emb_l1, emb_l2, emb_lh


def _hub(make_backbone, make_decoder, num_bins: int, frame_chans: int,
         dtype, device, generator: Optional[torch.Generator],
         **bk) -> PrHub:
    backbone = make_backbone(num_bins=num_bins, dtype=dtype, device=device,
                             **bk)
    decoder = make_decoder(backbone.embed_dim, frame_chans=frame_chans,
                           num_patches=backbone.num_patches, dtype=dtype,
                           device=device)
    hub = PrHub(backbone, decoder)
    init_weights(hub, generator or torch.Generator().manual_seed(0))
    return hub


def pretrain_hub_small(num_bins: int = 5, frame_chans: int = 1, *,
                       dtype=torch.float32, device="cuda",
                       generator: Optional[torch.Generator] = None,
                       **bk) -> PrHub:
    """ViT-S/16 + the small decoder (C=256), on ``device`` (the card unless
    the caller asks for the CPU), f32 parameters computed in ``dtype``,
    randomly initialised from the CPU ``generator`` (seed 0 when None).
    The mask ratio is the step's business (``make_rec_step``)."""
    return _hub(vit_small_patch16, rec_decoder_small_patch16, num_bins,
                frame_chans, dtype, device, generator, **bk)


def pretrain_hub_base(num_bins: int = 5, frame_chans: int = 1, *,
                      dtype=torch.float32, device="cuda",
                      generator: Optional[torch.Generator] = None,
                      **bk) -> PrHub:
    """ViT-B/16 + the base decoder (C=512, 16 heads); as
    :func:`pretrain_hub_small` otherwise."""
    return _hub(vit_base_patch16, rec_decoder_base_patch16, num_bins,
                frame_chans, dtype, device, generator, **bk)
