"""The ECDP baseline's model: the query encoder with its projection heads,
the predictors and the CLIP projection; the EMA key encoder beside it.

Counterpart of eventpretrain_tpu/models/ecdp_hub.py. ``EcdpEncoder`` is
the EMA-covered part: the backbone (ViT-ECDP or ConvViT-ECDP) and the
event and image projection heads (``ProjectorMlp``, 3 layers, 4096 wide,
256 out). ``EcdpModel`` adds the two predictors (2 layers) and
``clip_emb_proj`` (Linear 512 -> 256, no bias). JAX applies the model's
``encoder`` submodule with the EMA parameter tree; here the key encoder is
a second ``EcdpEncoder`` (:func:`make_key_encoder`), outside the
optimizer, whose BatchNorms keep no running statistics: JAX runs the key
path in training mode and discards its BatchNorm mutations
(steps.py:817-824), so it normalises with its batch's statistics and
leaves the query's running statistics alone. Parameter names are the
exporter's (``encoder.backbone.tokens``, ``encoder.event_head_proj.fc0``,
``bn0``, ..., ``clip_emb_proj.weight``), so JAX's trees load strictly.
"""

from __future__ import annotations

import copy
from typing import Optional

import torch
from torch import nn

from eventpretrain_tpu_torch.models.convvit_ecdp import (
    convvit_ecdp_base_patch16,
    convvit_ecdp_small_patch16,
)
from eventpretrain_tpu_torch.models.layers import (
    Linear,
    ProjectorMlp,
    init_weights,
)
from eventpretrain_tpu_torch.models.vit_ecdp import (
    vit_ecdp_base_patch16,
    vit_ecdp_small_patch16,
)


class EcdpEncoder(nn.Module):
    """The backbone and the event/image projection heads."""

    def __init__(self, backbone: nn.Module, proj_dim: int = 256,
                 mlp_dim: int = 4096, proj_mlp_layers: int = 3, *,
                 track_running_stats: bool = True):
        super().__init__()
        self.config = dict(proj_dim=proj_dim, mlp_dim=mlp_dim,
                           proj_mlp_layers=proj_mlp_layers)
        kw = dict(flax_names=True, track_running_stats=track_running_stats,
                  dtype=backbone.dtype,
                  device=backbone.norm_layer.weight.device)
        self.backbone = backbone
        self.event_head_proj = ProjectorMlp(backbone.embed_dim,
                                            proj_mlp_layers, mlp_dim,
                                            proj_dim, **kw)
        self.image_head_proj = ProjectorMlp(backbone.embed_dim,
                                            proj_mlp_layers, mlp_dim,
                                            proj_dim, **kw)

    def forward(self, img: torch.Tensor, ids_keep: torch.Tensor,
                mask: Optional[torch.Tensor] = None,
                project_image: bool = True):
        """``(ev, im, emb_event, emb_image, attn)``: the projected event
        and image tokens (``im`` None without ``project_image``) and the
        backbone's (ecdp_hub.py:31-53)."""
        emb_event, emb_image, attn = self.backbone.encode_masked(
            img, ids_keep, mask)
        ev = self.event_head_proj(emb_event)
        im = self.image_head_proj(emb_image) if project_image else None
        return ev, im, emb_event, emb_image, attn


class EcdpModel(nn.Module):
    """The query encoder, the predictors and the CLIP projection."""

    def __init__(self, encoder: EcdpEncoder, proj_dim: int = 256,
                 mlp_dim: int = 4096, pred_mlp_layers: int = 2,
                 clip_emb_dim: int = 512):
        super().__init__()
        backbone = encoder.backbone
        kw = dict(dtype=backbone.dtype,
                  device=backbone.norm_layer.weight.device)
        self.encoder = encoder
        self.event_head_pred = ProjectorMlp(proj_dim, pred_mlp_layers,
                                            mlp_dim, proj_dim,
                                            flax_names=True, **kw)
        self.image_head_pred = ProjectorMlp(proj_dim, pred_mlp_layers,
                                            mlp_dim, proj_dim,
                                            flax_names=True, **kw)
        self.clip_emb_proj = Linear(clip_emb_dim, proj_dim, bias=False, **kw)
        self.num_patches = backbone.num_patches
        self.patch_size = backbone.patch_size

    def forward_query(self, img_q: torch.Tensor, ids_keep: torch.Tensor,
                      clip_emb: torch.Tensor,
                      mask: Optional[torch.Tensor] = None):
        """``(q_event, q_image, clip_proj)`` (ecdp_hub.py:77-86)."""
        ev, im, *_ = self.encoder(img_q, ids_keep, mask)
        return (self.event_head_pred(ev), self.image_head_pred(im),
                self.clip_emb_proj(clip_emb))

    forward = forward_query


def forward_key(key_encoder: EcdpEncoder, img_k: torch.Tensor,
                ids_keep: torch.Tensor,
                mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """The key path, the event projection alone (ecdp_hub.py:88-99), run by
    the key encoder (training mode: batch statistics, its drop-path
    active) without gradients."""
    with torch.no_grad():
        return key_encoder(img_k, ids_keep, mask, project_image=False)[0]


def make_key_encoder(model: EcdpModel) -> EcdpEncoder:
    """A second ``EcdpEncoder`` of the query encoder's architecture whose
    BatchNorms keep no running statistics, its parameters a copy of the
    query encoder's (cli/pretrain.py:868-870), frozen."""
    key = EcdpEncoder(copy.deepcopy(model.encoder.backbone),
                      **model.encoder.config, track_running_stats=False)
    own = key.state_dict()
    key.load_state_dict({k: v for k, v in model.encoder.state_dict().items()
                         if k in own}, strict=True)
    return key.requires_grad_(False)


def _model(make_backbone, num_bins: int, dtype, device,
           generator: Optional[torch.Generator], **bk) -> EcdpModel:
    backbone = make_backbone(num_bins=num_bins, dtype=dtype, device=device,
                             **bk)
    model = EcdpModel(EcdpEncoder(backbone))
    if generator is None:
        generator = torch.Generator().manual_seed(0)
    init_weights(model, generator)
    return model


def ecdp_model_small(num_bins: int = 2, *, dtype=torch.float32,
                     device="cuda", generator: Optional[torch.Generator] = None,
                     **bk) -> EcdpModel:
    """ViT-ECDP-S/16 (ecdp_hub.py:105-114) on ``device`` (the card unless
    the caller asks for the CPU), f32 parameters computed in ``dtype``,
    randomly initialised from ``generator`` (a CPU generator; seed 0 when
    None)."""
    return _model(vit_ecdp_small_patch16, num_bins, dtype, device, generator,
                  **bk)


def ecdp_model_base(num_bins: int = 2, *, dtype=torch.float32,
                    device="cuda", generator: Optional[torch.Generator] = None,
                    **bk) -> EcdpModel:
    """ViT-ECDP-B/16 (ecdp_hub.py:117-125)."""
    return _model(vit_ecdp_base_patch16, num_bins, dtype, device, generator,
                  **bk)


def ecdp_model_convvit_small(num_bins: int = 2, *, dtype=torch.float32,
                             device="cuda",
                             generator: Optional[torch.Generator] = None,
                             **bk) -> EcdpModel:
    """ConvViT-ECDP-S (ecdp_hub.py:128-138)."""
    return _model(convvit_ecdp_small_patch16, num_bins, dtype, device,
                  generator, **bk)


def ecdp_model_convvit_base(num_bins: int = 2, *, dtype=torch.float32,
                            device="cuda",
                            generator: Optional[torch.Generator] = None,
                            **bk) -> EcdpModel:
    """ConvViT-ECDP-B (ecdp_hub.py:141-150)."""
    return _model(convvit_ecdp_base_patch16, num_bins, dtype, device,
                  generator, **bk)
