"""Pretrain hub: ViT, ConvViT or sparse Swin backbone, MAE decoder and the
contrastive projection heads (stages 1-3).

Counterpart of eventpretrain_tpu/models/pretrain_hub.py: ``forward_rec``
(stage 1; with a Swin backbone under the step's host plans) and
``forward_con`` (stages 2 and 3) and the factories with ``with_decoder``
and ``bn_groups``; a ConvViT or Swin hub's ``with_decoder`` also gives its
backbone the stage decoders of the fused feature (``with_rec_decoders``).
Its keys are
the exporter's, and its parts are those of the JAX tree the phase
initialises (cli/pretrain.py:314-405): the decoder where the phase
reconstructs, the heads where it contrasts (``with_heads``; flax creates
them only when ``forward_con`` runs). So the export of a ``forward_rec``
tree loads strictly into a hub without heads, that of a ``forward_con``
tree into one without a decoder, and that of both into the whole hub.
Stage 2's frozen trunk is the trainer's business
(``train/optim.py::freeze_except_norm``), not a branch of the model. The
Swin hub pairs its 7x7 tokens with CLIP's 14x14 grid through a 2x2
stride-2 conv (``clip_proj_conv``, pretrain_hub.py:77-86, 141-146).
"""

from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from eventpretrain_tpu_torch.models.convvit import (
    convvit_base_patch16,
    convvit_small_patch16,
)
from eventpretrain_tpu_torch.models.convvit import conv_nhwc
from eventpretrain_tpu_torch.models.decoder import (
    RecDecoder,
    rec_decoder_base_patch16,
    rec_decoder_small_patch16,
    rec_decoder_swin_tiny_patch32,
)
from eventpretrain_tpu_torch.models.layers import (
    Conv2d,
    Linear,
    ProjectorMlp,
    init_weights,
    layer_norm,
)
from eventpretrain_tpu_torch.models.swin import swin_tiny_window7
from eventpretrain_tpu_torch.ops.reshape import (
    emb2patch_frame,
    patch_frame2emb,
)
from eventpretrain_tpu_torch.models.vit import (
    vit_base_patch16,
    vit_small_patch16,
)


class PrHub(nn.Module):
    """``backbone``, ``pretrain_rec_decoder`` (or None) and, with
    ``with_heads``, the heads of the contrastive stages (the exporter's
    names): ``emb_h_proj`` (3 layers) and ``emb_h_pred`` (2 layers) of
    width ``mlp_dim`` over the backbone's tokens, ``norm_clip_emb``
    (LayerNorm, eps 1e-5) and ``clip_emb_proj`` from CLIP's width to the
    backbone's: a bias-free Linear, or with ``clip_proj_conv`` a 2x2
    stride-2 conv over CLIP's token grid. ``patch_size`` is the masking
    unit, the decoder's patch where the hub has one; ``num_patches`` the
    count of its tokens, the backbone's unless given."""

    def __init__(self, backbone: nn.Module, decoder: Optional[RecDecoder], *,
                 with_heads: bool = False, mlp_dim: int = 4096,
                 proj_mlp_layers: int = 3, pred_mlp_layers: int = 2,
                 clip_emb_dim: int = 512, clip_proj_conv: bool = False,
                 num_patches: Optional[int] = None, bn_groups: int = 1,
                 dtype=torch.float32, device=None):
        super().__init__()
        self.backbone = backbone
        self.pretrain_rec_decoder = decoder
        self.embed_dim = c = backbone.embed_dim
        self.num_patches = num_patches or backbone.num_patches
        self.patch_size = (backbone.patch_size if decoder is None
                           else decoder.patch_size)
        self.compute_dtype = dtype
        self.clip_proj_conv = clip_proj_conv
        if not with_heads:
            return
        kw = dict(bn_groups=bn_groups, dtype=dtype, device=device)
        self.emb_h_proj = ProjectorMlp(c, proj_mlp_layers, mlp_dim, c, **kw)
        self.emb_h_pred = ProjectorMlp(c, pred_mlp_layers, mlp_dim, c, **kw)
        self.norm_clip_emb = nn.LayerNorm(clip_emb_dim, eps=1e-5,
                                          device=device)
        self.clip_emb_proj = (
            Conv2d(clip_emb_dim, c, 2, 2, dtype=dtype, device=device)
            if clip_proj_conv else
            Linear(clip_emb_dim, c, bias=False, dtype=dtype, device=device))

    def forward_rec(self, evg: torch.Tensor, ids_keep: torch.Tensor,
                    ids_restore: torch.Tensor,
                    mask: Optional[torch.Tensor] = None, plans=None):
        """Masked encode + reconstruction prediction: ``(pred, emb_l1,
        emb_l2, emb_lh)``; the loss is ``objectives.rec.reconstruct_loss``.
        ``mask`` (B, L), the full binary mask (0 = keep), gates a ConvViT's
        conv stages and is ignored by the ViT; ``plans``, the step's device
        plans (``models/swin.py::unpack_plans``), select the sparse Swin's
        path, whose ``emb_l1`` and ``emb_l2`` are its first two stages'
        visible tokens (pretrain_hub.py:88-116).
        """
        if plans is not None:
            outs, emb_lh = self.backbone.encode_masked(evg, ids_keep, plans)
            emb_l1, emb_l2 = outs[0], outs[1]
        else:
            emb_l1, emb_l2, emb_lh = self.backbone.encode_masked(
                evg, ids_keep, mask)
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
        if self.clip_proj_conv:
            k = patch_frame2emb(conv_nhwc(self.clip_emb_proj,
                                          emb2patch_frame(clip_tokens)))
        else:
            k = self.clip_emb_proj(clip_tokens)
        q = self.emb_h_pred(self.emb_h_proj(emb_h))
        return q, k, emb_h.detach(), clip_tokens.detach(), attn


def _hub(make_backbone, make_decoder, num_bins: int, frame_chans: int,
         with_decoder: bool, with_heads: bool, bn_groups: int, dtype, device,
         generator: Optional[torch.Generator], clip_proj_conv: bool = False,
         num_patches: Optional[int] = None, **bk) -> PrHub:
    backbone = make_backbone(num_bins=num_bins, dtype=dtype, device=device,
                             **bk)
    num_patches = num_patches or backbone.num_patches
    decoder = (make_decoder(backbone.embed_dim, frame_chans=frame_chans,
                            num_patches=num_patches, dtype=dtype,
                            device=device)
               if with_decoder else None)
    hub = PrHub(backbone, decoder, with_heads=with_heads, bn_groups=bn_groups,
                clip_proj_conv=clip_proj_conv, num_patches=num_patches,
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


def pretrain_hub_convvit_small(num_bins: int = 5, frame_chans: int = 1,
                               with_decoder: bool = True,
                               with_heads: bool = False, bn_groups: int = 1,
                               *, dtype=torch.float32, device="cuda",
                               generator: Optional[torch.Generator] = None,
                               **bk) -> PrHub:
    """ConvViT-S (widths 128, 256, 384) + the small decoder (C=256, 8
    blocks, 8 heads) and the stage decoders where ``with_decoder``
    (pretrain_hub.py:190-210); as :func:`pretrain_hub_small` otherwise."""
    return _hub(convvit_small_patch16, rec_decoder_small_patch16, num_bins,
                frame_chans, with_decoder, with_heads, bn_groups, dtype,
                device, generator, with_rec_decoders=with_decoder, **bk)


def pretrain_hub_convvit_base(num_bins: int = 5, frame_chans: int = 1,
                              with_decoder: bool = True,
                              with_heads: bool = False, bn_groups: int = 1,
                              *, dtype=torch.float32, device="cuda",
                              generator: Optional[torch.Generator] = None,
                              **bk) -> PrHub:
    """ConvViT-B (widths 256, 384, 768) + the base decoder (C=512, 16
    heads) and the stage decoders where ``with_decoder``
    (pretrain_hub.py:213-231)."""
    return _hub(convvit_base_patch16, rec_decoder_base_patch16, num_bins,
                frame_chans, with_decoder, with_heads, bn_groups, dtype,
                device, generator, with_rec_decoders=with_decoder, **bk)


def pretrain_hub_swin(num_bins: int = 5, frame_chans: int = 1,
                      with_decoder: bool = True, with_heads: bool = False,
                      bn_groups: int = 1, *, dtype=torch.float32,
                      device="cuda",
                      generator: Optional[torch.Generator] = None,
                      **bk) -> PrHub:
    """Swin-T (widths 96, 192, 384, 768, window 7, 49 mask cells of 32
    pixels) + the Swin decoder (C=256, 8 blocks, 8 heads, patch 32) and
    the stage decoders where ``with_decoder``, and the conv CLIP projection
    with ``with_heads`` (pretrain_hub.py:233-253). As in JAX, the hub and
    its decoder take ``(input_size // 32) ** 2`` tokens (49 at 224, the
    contrastive phases' pairing with CLIP); as :func:`pretrain_hub_small`
    otherwise."""
    return _hub(swin_tiny_window7, rec_decoder_swin_tiny_patch32, num_bins,
                frame_chans, with_decoder, with_heads, bn_groups, dtype,
                device, generator, clip_proj_conv=True,
                num_patches=(bk.get("input_size", 224) // 32) ** 2,
                with_rec_decoders=with_decoder, **bk)
