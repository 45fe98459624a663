"""Dense-task hub: the ViT, ConvViT, sparse Swin, ViT-ECDP,
ConvViT-ECDP, ViT-MEM or Swin-ECDDP backbone's pyramid -> UPerHead +
FCNHead.

Counterpart of eventpretrain_tpu/models/dense_hub.py (``FtDenseHub`` and
its factories). A ViT's pyramid is four 14^2 maps of its width, an ECDP
or MEM backbone's four 14^2 maps of its patch tokens (its dense encode
returns ``(emb, out_embs, attn)``, ``emb_h`` then the tokens'
concatenation or normed mean); a
ConvViT's is its two stage maps (56^2, 28^2), the 14^2 tokens and the FPN
level (6^2, the backbone's ``with_fpn``), of widths (d0, d1, d2, d2), and
its BatchNorm moves like the heads'; Swin-T's is its four stages' tokens
as maps (56^2 x 96, 28^2 x 192, 14^2 x 384, 7^2 x 768), Swin-ECDDP's
the same maps each through its own LayerNorm. The module's
mode is flax's ``train`` flag: ``hub.train()`` activates drop-path, the
heads' channel dropout and the BatchNorm statistics of the batch
(updating the running ones); ``hub.eval()`` is deterministic and uses the
running statistics.
Drop-path and dropout masks come from the
:class:`~eventpretrain_tpu_torch.models.layers.DropPathSource` the train
step sets.
"""

from __future__ import annotations

from typing import Optional, Sequence

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
from eventpretrain_tpu_torch.models.dense_heads import FCNHead, UPerHead
from eventpretrain_tpu_torch.models.layers import init_weights
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


# the heads' widths and the auxiliary head's pyramid level, which every
# hub of the repo leaves at JAX's defaults (dense_hub.py:23-26)
DECODE_CHANNELS = 384
AUX_CHANNELS = 256
AUX_IN_INDEX = 2


class FtDenseHub(nn.Module):
    def __init__(self, backbone: nn.Module, num_classes: int,
                 decode_in_channels: Sequence[int],
                 sample_mode: str = "bilinear", decode_dropout: float = 0.1):
        super().__init__()
        kw = dict(dtype=backbone.dtype,
                  device=next(backbone.parameters()).device)
        self.backbone = backbone
        self.num_classes = num_classes
        self.decode_head = UPerHead(
            decode_in_channels, DECODE_CHANNELS, num_classes,
            dropout_ratio=decode_dropout, sample_mode=sample_mode, **kw)
        self.auxiliary_head = FCNHead(
            decode_in_channels[AUX_IN_INDEX], AUX_CHANNELS, num_classes,
            in_index=AUX_IN_INDEX, dropout_ratio=decode_dropout, **kw)

    def forward(self, x: torch.Tensor):
        """``x (B, H, W, num_bins)`` -> ``(emb_h, out_embs, decode, aux)``:
        the normed last tokens, the pyramid, and both heads' logits
        ``(B, h, w, num_classes)`` at the pyramid's finest resolution."""
        out = self.backbone.encode_dense(x, return_attn=False,
                                         return_pyramid=True)
        emb_h, out_embs = out[:2] if len(out) == 3 else out[2:4]
        return (emb_h, out_embs, self.decode_head(out_embs),
                self.auxiliary_head(out_embs))


def _hub(make_backbone, widths: Sequence[int], num_classes: int,
         num_bins: int, dtype, device, generator: Optional[torch.Generator],
         sample_mode: str, decode_dropout: float, **bk) -> FtDenseHub:
    hub = FtDenseHub(
        make_backbone(num_bins=num_bins, dtype=dtype, device=device, **bk),
        num_classes, decode_in_channels=tuple(widths),
        sample_mode=sample_mode, decode_dropout=decode_dropout,
    )
    if generator is None:
        generator = torch.Generator().manual_seed(0)
    init_weights(hub, generator)
    return hub


def dense_hub_vit_small(num_classes: int, num_bins: int = 5, *,
                        dtype=torch.float32, device="cuda",
                        generator: Optional[torch.Generator] = None,
                        sample_mode: str = "bilinear",
                        decode_dropout: float = 0.1, **bk) -> FtDenseHub:
    """ViT-S/16: four 14^2 maps at C=384 into the heads, on ``device`` (the
    card unless the caller asks for the CPU), f32 parameters computed in
    ``dtype``, randomly initialised from ``generator`` (a CPU generator;
    seed 0 when None)."""
    return _hub(vit_small_patch16, (bk.get("embed_dim", 384),) * 4,
                num_classes, num_bins, dtype, device, generator, sample_mode,
                decode_dropout, **bk)


def dense_hub_vit_base(num_classes: int, num_bins: int = 5, *,
                       dtype=torch.float32, device="cuda",
                       generator: Optional[torch.Generator] = None,
                       sample_mode: str = "bilinear",
                       decode_dropout: float = 0.1, **bk) -> FtDenseHub:
    """ViT-B/16: four 14^2 maps at C=768 into the heads."""
    return _hub(vit_base_patch16, (bk.get("embed_dim", 768),) * 4,
                num_classes, num_bins, dtype, device, generator, sample_mode,
                decode_dropout, **bk)


def dense_hub_convvit_small(num_classes: int, num_bins: int = 5, *,
                            dtype=torch.float32, device="cuda",
                            generator: Optional[torch.Generator] = None,
                            sample_mode: str = "bilinear",
                            decode_dropout: float = 0.1,
                            **bk) -> FtDenseHub:
    """ConvViT-S: the pyramid 56^2 x 128, 28^2 x 256, 14^2 x 384, 6^2 x
    384 (dense_hub.py:91-104; the widths follow ``embed_dims``)."""
    d0, d1, d2 = bk.get("embed_dims", (128, 256, 384))
    return _hub(convvit_small_patch16, (d0, d1, d2, d2), num_classes,
                num_bins, dtype, device, generator, sample_mode,
                decode_dropout, with_rec_decoders=False, with_fpn=True, **bk)


def dense_hub_convvit_base(num_classes: int, num_bins: int = 5, *,
                           dtype=torch.float32, device="cuda",
                           generator: Optional[torch.Generator] = None,
                           sample_mode: str = "bilinear",
                           decode_dropout: float = 0.1,
                           **bk) -> FtDenseHub:
    """ConvViT-B: the pyramid at widths 256, 384, 768, 768
    (dense_hub.py:107-118)."""
    d0, d1, d2 = bk.get("embed_dims", (256, 384, 768))
    return _hub(convvit_base_patch16, (d0, d1, d2, d2), num_classes,
                num_bins, dtype, device, generator, sample_mode,
                decode_dropout, with_rec_decoders=False, with_fpn=True, **bk)


def dense_hub_swin_tiny(num_classes: int, num_bins: int = 5, *,
                        dtype=torch.float32, device="cuda",
                        generator: Optional[torch.Generator] = None,
                        sample_mode: str = "bilinear",
                        decode_dropout: float = 0.1, **bk) -> FtDenseHub:
    """Swin-T: the pyramid 56^2 x 96, 28^2 x 192, 14^2 x 384, 7^2 x 768
    (dense_hub.py:121-133; the widths follow ``embed_dims``)."""
    widths = bk.get("embed_dims", (96, 192, 384, 768))
    return _hub(swin_tiny_window7, widths, num_classes, num_bins, dtype,
                device, generator, sample_mode, decode_dropout,
                with_rec_decoders=False, **bk)


def dense_hub_vit_ecdp_small(num_classes: int, num_bins: int = 2, *,
                             dtype=torch.float32, device="cuda",
                             generator: Optional[torch.Generator] = None,
                             sample_mode: str = "bilinear",
                             decode_dropout: float = 0.1,
                             **bk) -> FtDenseHub:
    """ViT-ECDP-S: four 14^2 token maps at C=384 (dense_hub.py:137-149)."""
    return _hub(vit_ecdp_small_patch16, (bk.get("embed_dim", 384),) * 4,
                num_classes, num_bins, dtype, device, generator, sample_mode,
                decode_dropout, **bk)


def dense_hub_vit_ecdp_base(num_classes: int, num_bins: int = 2, *,
                            dtype=torch.float32, device="cuda",
                            generator: Optional[torch.Generator] = None,
                            sample_mode: str = "bilinear",
                            decode_dropout: float = 0.1,
                            **bk) -> FtDenseHub:
    """ViT-ECDP-B: four 14^2 token maps at C=768 (dense_hub.py:151-161)."""
    return _hub(vit_ecdp_base_patch16, (bk.get("embed_dim", 768),) * 4,
                num_classes, num_bins, dtype, device, generator, sample_mode,
                decode_dropout, **bk)


def dense_hub_convvit_ecdp_small(num_classes: int, num_bins: int = 2, *,
                                 dtype=torch.float32, device="cuda",
                                 generator: Optional[torch.Generator] = None,
                                 sample_mode: str = "bilinear",
                                 decode_dropout: float = 0.1,
                                 **bk) -> FtDenseHub:
    """ConvViT-ECDP-S: four 14^2 maps of the stage-3 tokens at C=384, JAX's
    repair of the reference's dense forward (dense_hub.py:164-179)."""
    return _hub(convvit_ecdp_small_patch16,
                (bk.get("embed_dims", (128, 256, 384))[2],) * 4, num_classes,
                num_bins, dtype, device, generator, sample_mode,
                decode_dropout, **bk)


def dense_hub_convvit_ecdp_base(num_classes: int, num_bins: int = 2, *,
                                dtype=torch.float32, device="cuda",
                                generator: Optional[torch.Generator] = None,
                                sample_mode: str = "bilinear",
                                decode_dropout: float = 0.1,
                                **bk) -> FtDenseHub:
    """ConvViT-ECDP-B: four 14^2 maps at C=768 (dense_hub.py:182-196)."""
    return _hub(convvit_ecdp_base_patch16,
                (bk.get("embed_dims", (256, 384, 768))[2],) * 4, num_classes,
                num_bins, dtype, device, generator, sample_mode,
                decode_dropout, **bk)


def dense_hub_vit_mem_small(num_classes: int, num_bins: int = 3, *,
                            dtype=torch.float32, device="cuda",
                            generator: Optional[torch.Generator] = None,
                            sample_mode: str = "bilinear",
                            decode_dropout: float = 0.1, **bk) -> FtDenseHub:
    """ViT-MEM-S: four 14^2 maps of its patch tokens at C=384
    (dense_hub.py:197-208)."""
    return _hub(vit_mem_small_patch16, (bk.get("embed_dim", 384),) * 4,
                num_classes, num_bins, dtype, device, generator, sample_mode,
                decode_dropout, **bk)


def dense_hub_vit_mem_base(num_classes: int, num_bins: int = 3, *,
                           dtype=torch.float32, device="cuda",
                           generator: Optional[torch.Generator] = None,
                           sample_mode: str = "bilinear",
                           decode_dropout: float = 0.1, **bk) -> FtDenseHub:
    """ViT-MEM-B: four 14^2 maps at C=768 (dense_hub.py:211-221)."""
    return _hub(vit_mem_base_patch16, (bk.get("embed_dim", 768),) * 4,
                num_classes, num_bins, dtype, device, generator, sample_mode,
                decode_dropout, **bk)


def dense_hub_swin_ecddp_tiny(num_classes: int, num_bins: int = 5, *,
                              dtype=torch.float32, device="cuda",
                              generator: Optional[torch.Generator] = None,
                              sample_mode: str = "bilinear",
                              decode_dropout: float = 0.1,
                              **bk) -> FtDenseHub:
    """Swin-ECDDP-T: its four normed stages, 56^2 x 96, 28^2 x 192, 14^2 x
    384, 7^2 x 768 (dense_hub.py:224-236; the widths follow
    ``embed_dims``)."""
    widths = bk.get("embed_dims", (96, 192, 384, 768))
    return _hub(swin_ecddp_tiny_window7, widths, num_classes, num_bins,
                dtype, device, generator, sample_mode, decode_dropout, **bk)
