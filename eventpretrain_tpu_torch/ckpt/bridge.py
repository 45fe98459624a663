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
keep, is skipped when a file carries it. A JAX ``QueueState`` (the
contrastive stages' queue, a (C, L, K) buffer and a pointer) crosses as
its two arrays (``load_jax_queue``). The CLIP tower, which the exporter
does not cover, crosses by ``clip_state_dict_from_flax``: the inverse of
``models/clip.py::load_clip_visual_weights``' mapping (clip.py:117-168)
into OpenAI's key space without its ``visual.`` prefix.
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


def load_jax_state_dict(module: nn.Module, flat: Mapping) -> nn.Module:
    """Load ``{torch key: np.ndarray | torch.Tensor}`` into ``module``
    strictly (``num_batches_tracked`` aside); each value is cast to its
    parameter's or buffer's dtype and device."""
    sd = {
        k: v if isinstance(v, torch.Tensor)
        else torch.from_numpy(np.array(v))
        for k, v in flat.items() if not k.endswith("num_batches_tracked")
    }
    module.load_state_dict(sd, strict=True)
    return module


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
