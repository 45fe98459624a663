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
its two arrays (``load_jax_queue``).
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
