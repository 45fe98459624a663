"""Pretrain hub: ViT backbone, MAE decoder and the contrastive projection
heads (stages 1-3).

Counterpart of eventpretrain_tpu/models/pretrain_hub.py:33-187 on the ViT
hubs: ``forward_rec`` (stage 1) and ``forward_con`` (stages 2 and 3) and
the ViT factories with ``with_decoder`` and ``bn_groups``. Its keys are
the exporter's, and its parts are those of the JAX tree the phase
initialises (cli/pretrain.py:314-405): the decoder where the phase
reconstructs, the heads where it contrasts (``with_heads``; flax creates
them only when ``forward_con`` runs). So the export of a ``forward_rec``
tree loads strictly into a hub without heads, that of a ``forward_con``
tree into one without a decoder, and that of both into the whole hub.
Stage 2's frozen trunk is the trainer's business
(``train/optim.py::freeze_except_norm``), not a branch of the model. The
swin hub's convolutional CLIP projection comes with the swin backbone.
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
from eventpretrain_tpu_torch.models.layers import (
    Linear,
    ProjectorMlp,
    init_weights,
    layer_norm,
)
from eventpretrain_tpu_torch.models.vit import (
    ViT,
    vit_base_patch16,
    vit_small_patch16,
)


class PrHub(nn.Module):
    """``backbone``, ``pretrain_rec_decoder`` (or None) and, with
    ``with_heads``, the heads of the contrastive stages (the exporter's
    names): ``emb_h_proj`` (3 layers) and ``emb_h_pred`` (2 layers) of
    width ``mlp_dim`` over the backbone's tokens, ``norm_clip_emb``
    (LayerNorm, eps 1e-5) and the bias-free ``clip_emb_proj`` from CLIP's
    width to the backbone's."""

    def __init__(self, backbone: ViT, decoder: Optional[RecDecoder], *,
                 with_heads: bool = False, mlp_dim: int = 4096,
                 proj_mlp_layers: int = 3, pred_mlp_layers: int = 2,
                 clip_emb_dim: int = 512,
                 bn_groups: int = 1, dtype=torch.float32, device=None):
        super().__init__()
        self.backbone = backbone
        self.pretrain_rec_decoder = decoder
        self.embed_dim = c = backbone.embed_dim
        self.num_patches = backbone.num_patches
        self.patch_size = backbone.patch_size
        self.compute_dtype = dtype
        if not with_heads:
            return
        kw = dict(bn_groups=bn_groups, dtype=dtype, device=device)
        self.emb_h_proj = ProjectorMlp(c, proj_mlp_layers, mlp_dim, c, **kw)
        self.emb_h_pred = ProjectorMlp(c, pred_mlp_layers, mlp_dim, c, **kw)
        self.norm_clip_emb = nn.LayerNorm(clip_emb_dim, eps=1e-5,
                                          device=device)
        self.clip_emb_proj = Linear(clip_emb_dim, c, bias=False, dtype=dtype,
                                    device=device)

    def forward_rec(self, evg: torch.Tensor, ids_keep: torch.Tensor,
                    ids_restore: torch.Tensor):
        """Masked encode + reconstruction prediction: ``(pred, emb_l1,
        emb_l2, emb_lh)``; the loss is ``objectives.rec.reconstruct_loss``.
        """
        emb_l1, emb_l2, emb_lh = self.backbone.encode_masked(evg, ids_keep)
        pred = self.pretrain_rec_decoder(emb_lh, ids_restore)
        return pred, emb_l1, emb_l2, emb_lh

    def forward_con(self, evg: torch.Tensor, clip_emb: torch.Tensor,
                    return_attn: bool = False):
        """Dense encode + projection heads (pretrain_hub.py:117-150):
        ``(q, k, emb_h_org, clip_emb_org, attn)`` with ``q =
        pred(proj(emb_h))`` over the backbone's normed last tokens and ``k
        = clip_emb_proj(norm_clip_emb(clip_emb[:, 1:]))`` (CLIP's cls token
        dropped); ``emb_h_org`` and ``clip_emb_org`` are those tokens
        detached, ``attn`` the last block's attention with
        ``return_attn``. The projectors' BatchNorms use the batch's
        statistics and move their running buffers in training mode, the
        running buffers in eval mode. The losses are in
        ``objectives.contrastive``."""
        _, _, emb_h, _, attn = self.backbone.encode_dense(
            evg, return_attn=return_attn, return_pyramid=False)
        clip_tokens = layer_norm(clip_emb[:, 1:, :], self.norm_clip_emb).to(
            self.compute_dtype)
        k = self.clip_emb_proj(clip_tokens)
        q = self.emb_h_pred(self.emb_h_proj(emb_h))
        return q, k, emb_h.detach(), clip_tokens.detach(), attn


def _hub(make_backbone, make_decoder, num_bins: int, frame_chans: int,
         with_decoder: bool, with_heads: bool, bn_groups: int, dtype, device,
         generator: Optional[torch.Generator], **bk) -> PrHub:
    backbone = make_backbone(num_bins=num_bins, dtype=dtype, device=device,
                             **bk)
    decoder = (make_decoder(backbone.embed_dim, frame_chans=frame_chans,
                            num_patches=backbone.num_patches, dtype=dtype,
                            device=device)
               if with_decoder else None)
    hub = PrHub(backbone, decoder, with_heads=with_heads, bn_groups=bn_groups,
                dtype=dtype, device=device)
    init_weights(hub, generator or torch.Generator().manual_seed(0))
    return hub


def pretrain_hub_small(num_bins: int = 5, frame_chans: int = 1,
                       with_decoder: bool = True, with_heads: bool = False,
                       bn_groups: int = 1, *,
                       dtype=torch.float32, device="cuda",
                       generator: Optional[torch.Generator] = None,
                       **bk) -> PrHub:
    """ViT-S/16 + the small decoder (C=256; none without ``with_decoder``)
    and, with ``with_heads``, the projection heads, on ``device``
    (the card unless the caller asks for the CPU), f32 parameters computed
    in ``dtype``, randomly initialised from the CPU ``generator`` (seed 0
    when None). ``bn_groups`` is the projectors' BatchNorm statistic
    scope. The mask ratio is the step's business (``make_rec_step``)."""
    return _hub(vit_small_patch16, rec_decoder_small_patch16, num_bins,
                frame_chans, with_decoder, with_heads, bn_groups, dtype,
                device, generator, **bk)


def pretrain_hub_base(num_bins: int = 5, frame_chans: int = 1,
                      with_decoder: bool = True, with_heads: bool = False,
                      bn_groups: int = 1, *,
                      dtype=torch.float32, device="cuda",
                      generator: Optional[torch.Generator] = None,
                      **bk) -> PrHub:
    """ViT-B/16 + the base decoder (C=512, 16 heads) and, with
    ``with_heads``, the projection heads; as :func:`pretrain_hub_small`
    otherwise."""
    return _hub(vit_base_patch16, rec_decoder_base_patch16, num_bins,
                frame_chans, with_decoder, with_heads, bn_groups, dtype,
                device, generator, **bk)
