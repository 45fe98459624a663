"""Carry weights across from the JAX package.

``eventpretrain_tpu/ckpt/torch_export.py:40-86`` turns flax params into the
reference PyTorch key space and layout (``export_torch_state_dict``) and
writes it as a ``.pth`` (``save_torch_checkpoint``: ``{"model": ...,
"epoch": ...}``). The port's modules use that key space, so loading is a
strict ``load_state_dict``: a missing or unexpected key raises. Buffers the
exporter omits (``pos_embed``) are non-persistent here. BatchNorm running
statistics (``running_mean``, ``running_var``, flax's ``batch_stats``) are
buffers of the port's dense heads and projectors and load with the
parameters (``export_torch_state_dict(params, batch_stats)``); only
``num_batches_tracked``, which the port's flax-style BatchNorm does not
keep, is skipped when a file carries it, and so are the sparse Swin's
``relative_position_index`` and ``attn_mask`` buffers of a reference file,
which the port recomputes from its plans (torch_import.py:216-221, JAX's
``_SKIP_SUBSTRINGS``). The Swin's tensors load as the exporter writes them
(torch_import.py:120-129): the relative-position bias tables as they are,
``swin_block.S.downsample.reduction`` as a bias-free Linear. The
ConvViT's tensors need nothing of their own: the exporter writes the
depthwise kernels in OIHW (C, 1, 5, 5) and ``fpn.1``'s ``batch_stats`` as
its running statistics (torch_export.py:31-37). ``init_from_state_dict`` is the finetune CLIs'
``--finetune``, JAX's ``init_variables_from(strict_backbone=True)``
(torch_import.py:316-349). A JAX ``QueueState`` (the
contrastive stages' queue, a (C, L, K) buffer and a pointer) crosses as
its two arrays (``load_jax_queue``). The CLIP tower, which the exporter
does not cover, crosses by ``clip_state_dict_from_flax``: the inverse of
``models/clip.py::load_clip_visual_weights``' mapping (clip.py:117-168)
into OpenAI's key space without its ``visual.`` prefix. The ECDP model's
keys are the exporter's as they are (``encoder.backbone.tokens``, the
heads' ``fc{i}``/``bn{i}``, ``clip_emb_proj.weight``), and its EMA tree
(JAX's ``ema_params``) crosses as a second state dict,
``export_torch_state_dict(ema_params)``, which the port's key encoder
loads strictly: it keeps no BatchNorm statistics, as the tree holds none.
The ECDP CLI's checkpoint carries it as ``"ema"`` beside ``"model"``
(``load_ecdp_checkpoint``); ``finetune_state_dict`` lifts its query
encoder to ``backbone.*`` for the finetune CLIs, as JAX's ECDP dialect
lifts ``encoder_q.*`` (torch_import.py:52-57).
"""

from __future__ import annotations

from typing import Mapping

import numpy as np
import torch
from torch import nn

from eventpretrain_tpu_torch.objectives.contrastive import QueueState


def load_torch_checkpoint(path: str) -> dict:
    """The ``"model"`` state dict of a ``save_torch_checkpoint`` file."""
    raw = torch.load(path, map_location="cpu", weights_only=True)
    if not isinstance(raw, dict) or "model" not in raw:
        raise ValueError(f"{path}: expected a {{'model': state_dict}} file")
    return raw["model"]


def load_ecdp_checkpoint(path: str) -> tuple[dict, dict]:
    """``(model, ema)`` state dicts of the ECDP CLI's checkpoint."""
    raw = torch.load(path, map_location="cpu", weights_only=True)
    if not isinstance(raw, dict) or "ema" not in raw:
        raise ValueError(f"{path}: expected an ECDP checkpoint with 'ema'")
    return raw["model"], raw["ema"]


def finetune_state_dict(sd: Mapping) -> dict:
    """A checkpoint's tensors as the finetune CLIs fill a hub from them:
    an ECDP model's query encoder (``encoder.backbone.*`` and its
    projection heads) lifted to ``backbone.*`` and ``*_head_proj.*``;
    any other file's keys as they are."""
    if not any(k.startswith("encoder.backbone.") for k in sd):
        return dict(sd)
    return {k.removeprefix("encoder."): v for k, v in sd.items()}


# buffers of a reference file that the port recomputes or does not keep
_SKIPPED = ("num_batches_tracked", "relative_position_index", "attn_mask")


def load_jax_state_dict(module: nn.Module, flat: Mapping) -> nn.Module:
    """Load ``{torch key: np.ndarray | torch.Tensor}`` into ``module``
    strictly (the buffers ``_SKIPPED`` names aside); each value is cast to
    its parameter's or buffer's dtype and device."""
    sd = {
        k: v if isinstance(v, torch.Tensor)
        else torch.from_numpy(np.array(v))
        for k, v in flat.items() if not any(s in k for s in _SKIPPED)
    }
    module.load_state_dict(sd, strict=True)
    return module


def init_from_state_dict(module: nn.Module, sd: Mapping,
                         strict_prefix: str = "backbone.") -> list[str]:
    """Fill ``module`` from ``sd`` as ``init_variables_from(...,
    strict_backbone=True)`` fills a flax tree: each parameter and buffer
    the file holds (the BatchNorm running statistics among them) is
    copied, a shape that differs raises (torch's "size mismatch"), a
    parameter under ``strict_prefix`` that the file lacks raises
    ``KeyError``, and every other tensor the file lacks keeps its init.
    Returns the file's keys the module has no use for (a rec
    checkpoint's decoders, say)."""
    own = module.state_dict()
    missing = [n for n, _ in module.named_parameters()
               if n.startswith(strict_prefix) and n not in sd]
    if missing:
        raise KeyError(f"{len(missing)} parameters under {strict_prefix!r} "
                       f"are not in the file (e.g. {missing[:4]})")
    module.load_state_dict({k: v for k, v in sd.items() if k in own},
                           strict=False)
    return sorted(k for k in sd if k not in own
                  and not any(s in k for s in _SKIPPED))


def load_jax_queue(buffer, ptr, device="cpu") -> QueueState:
    """A JAX ``QueueState``'s ``buffer`` (C, L, K) and ``ptr`` (numpy or
    any array ``np.asarray`` takes) as the port's: an f32 buffer of its
    own on ``device`` and a host int pointer."""
    buf = torch.from_numpy(np.array(buffer, np.float32)).to(device)
    return QueueState(buffer=buf, ptr=int(np.asarray(ptr)))


def clip_state_dict_from_flax(params: Mapping) -> dict:
    """The flax params of ``CLIPVisionTransformer`` (numpy arrays, or any
    array ``np.asarray`` takes) as the port's CLIP state dict: the patch
    kernel (P, P, 3, C) HWIO as (C, 3, P, P) OIHW, each Dense kernel
    transposed to (out, in), each LayerNorm's ``scale`` as ``weight``."""

    def a(x) -> torch.Tensor:
        return torch.from_numpy(np.array(x, np.float32))

    def ln(tree: Mapping, name: str) -> dict:
        return {f"{name}.weight": a(tree["scale"]),
                f"{name}.bias": a(tree["bias"])}

    def dense(tree: Mapping, name: str) -> dict:
        return {f"{name}.weight": a(tree["kernel"]).t().contiguous(),
                f"{name}.bias": a(tree["bias"])}

    sd = {"conv1.weight": a(params["conv1"]["kernel"]).permute(
              3, 2, 0, 1).contiguous(),
          "class_embedding": a(params["class_embedding"]),
          "positional_embedding": a(params["positional_embedding"]),
          "proj": a(params["proj"]),
          **ln(params["ln_pre"], "ln_pre"),
          **ln(params["ln_post"], "ln_post")}
    i = 0
    while f"resblock_{i}" in params:
        blk, pre = params[f"resblock_{i}"], f"transformer.resblocks.{i}"
        sd.update({f"{pre}.attn.in_proj_weight":
                   a(blk["in_proj"]["kernel"]).t().contiguous(),
                   f"{pre}.attn.in_proj_bias": a(blk["in_proj"]["bias"]),
                   **ln(blk["ln_1"], f"{pre}.ln_1"),
                   **ln(blk["ln_2"], f"{pre}.ln_2"),
                   **dense(blk["out_proj"], f"{pre}.attn.out_proj"),
                   **dense(blk["c_fc"], f"{pre}.mlp.c_fc"),
                   **dense(blk["c_proj"], f"{pre}.mlp.c_proj")})
        i += 1
    return sd
