"""AdamW with layer-wise lr scales, the cosine warmup schedule, and the
overflow-safe gradient norm.

Counterpart of eventpretrain_tpu/train/optim.py. The optax chain there is

    [clip] -> scale_by_adam(b1, b2, eps=1e-8) -> add_decayed_weights(wd,
    mask = ndim >= 2) -> [layer scales] -> scale_by_learning_rate(schedule)

so an update is ``-lr * scale * (m_hat / (sqrt(v_hat) + eps) + wd * p)``.
``torch.optim.AdamW`` computes the same update when each (weight decay,
lr scale) pair is its own param group and each group's ``lr`` is set to
``schedule(i) * scale`` before update ``i`` (:class:`TrainState` does
that). optax reads the step count before it increments it, so update ``i``
(from 0) uses ``schedule(i)`` and the first update of a warmup has lr 0.
The weight-decay mask is ``ndim >= 2``, so the decoder's ``(1, 1, C)``
``mask_token`` is decayed, as in JAX. The optional global-norm clip before
Adam runs in :class:`TrainState` (``clip_grad``), on the gradients before
the update. Frozen parameters (``requires_grad=False``: ``--linprob``'s
backbone, stage 2's trunk under JAX's ``frozen_except_norm_mask``, the
``trainable_mask`` of optim.py:123-135, 189-196) are left out of the
optimizer: no update, no moments, no weight decay, as optax's zeroed
updates leave them. Layer ids and masks are computed on the port's
parameter names, the exporter's torch key space
(``backbone.vit_block.3.attn.qkv.weight``). MultiSteps accumulation comes
with its slice.
"""

from __future__ import annotations

import math
from typing import Callable, Iterable

import torch
from torch import nn


def cosine_warmup_schedule(base_lr: float, min_lr: float,
                           warmup_epochs: float, total_epochs: float,
                           steps_per_epoch: int) -> Callable[[int], float]:
    """Per-step lr: linear warmup over ``warmup_epochs``, then a half cosine
    to ``min_lr`` at ``total_epochs`` (optim.py:25-45)."""

    def schedule(step: int) -> float:
        epoch = step / steps_per_epoch
        if epoch < warmup_epochs:
            return base_lr * epoch / max(warmup_epochs, 1e-8)
        progress = (epoch - warmup_epochs) / max(
            total_epochs - warmup_epochs, 1e-8)
        return min_lr + (base_lr - min_lr) * 0.5 * (
            1.0 + math.cos(math.pi * progress))

    return schedule


def vit_layer_id(name: str, num_layers: int,
                 layer_grafted: bool = False) -> int:
    """Layer id of a ViT parameter name (optim.py:52-94 on the torch keys;
    the ConvViT stage ids come with that backbone)."""
    parts = name.split(".")
    if parts[0] != "backbone":
        return 2 if layer_grafted else num_layers
    sub = parts[1] if len(parts) > 1 else ""
    block_id = int(parts[2]) if sub == "vit_block" else None
    if sub.startswith(("patch_embed", "pos_embed")):
        return 0
    if layer_grafted:
        return 2 if block_id is None else min(block_id // 4, 2)
    return num_layers if block_id is None else block_id + 1


def layer_scales(names: Iterable[str], num_layers: int,
                 layer_decay: float = 0.75,
                 layer_grafted: bool = False) -> dict[str, float]:
    """Per-parameter lr scales (optim.py:97-119)."""
    if layer_grafted:
        scales = [0.01, 0.1, 1.0]
    else:
        scales = [layer_decay ** (num_layers - i)
                  for i in range(num_layers + 1)]
    return {n: scales[vit_layer_id(n, num_layers, layer_grafted)]
            for n in names}


def weight_decay_mask(params: dict[str, torch.Tensor]) -> dict[str, bool]:
    """True where weight decay applies: every parameter of >= 2 dims."""
    return {n: p.ndim >= 2 for n, p in params.items()}


def frozen_except_norm_mask(names: Iterable[str]) -> dict[str, bool]:
    """Stage 2's ("adj") trainability, True = trainable (optim.py:123-135):
    a backbone parameter trains only when its name holds ``norm_layer``;
    every other parameter trains."""
    return {n: not n.startswith("backbone.") or "norm_layer" in n
            for n in names}


def freeze_except_norm(module: nn.Module) -> dict[str, bool]:
    """Set ``requires_grad`` by :func:`frozen_except_norm_mask`; returns
    the mask. The trunk's blocks then take no input that requires a
    gradient, so autograd records none of them: they run forward only
    and save nothing (``ops.common.grad_needed``)."""
    mask = frozen_except_norm_mask(n for n, _ in module.named_parameters())
    for n, p in module.named_parameters():
        p.requires_grad_(mask[n])
    return mask


def build_optimizer(module: nn.Module, *, weight_decay: float = 0.05,
                    betas: tuple[float, float] = (0.9, 0.95),
                    layer_decay: float = 1.0, num_layers: int = 12,
                    layer_grafted: bool = False) -> torch.optim.AdamW:
    """``torch.optim.AdamW`` over ``module``'s parameters, one param group
    per (weight decay, lr scale) pair; each group carries its ``lr_scale``
    and starts at lr 0 (:class:`TrainState` sets it before each update).
    Parameters that do not require a gradient are left out."""
    params = {n: p for n, p in module.named_parameters() if p.requires_grad}
    decay = weight_decay_mask(params)
    if layer_decay != 1.0 or layer_grafted:
        scale = layer_scales(params, num_layers, layer_decay, layer_grafted)
    else:
        scale = {n: 1.0 for n in params}
    groups: dict[tuple, dict] = {}
    for n, p in params.items():
        wd = weight_decay if (weight_decay and decay[n]) else 0.0
        g = groups.setdefault((wd, scale[n]), {
            "params": [], "names": [], "weight_decay": wd,
            "lr_scale": scale[n], "lr": 0.0,
        })
        g["params"].append(p)
        g["names"].append(n)
    return torch.optim.AdamW(list(groups.values()), lr=0.0, betas=betas,
                             eps=1e-8, weight_decay=0.0)


def global_grad_norm(grads: list[torch.Tensor]) -> torch.Tensor:
    """Overflow-safe global norm (optim.py:204-221): the leaves are
    pre-scaled by the global max-abs, because gradients through LayerNorms
    over all-zero event patches can reach ~1e19 and a plain sum of squares
    overflows f32. A device tensor; nothing synchronises."""
    if not grads:
        return torch.zeros(())
    max_abs = torch.stack([g.detach().abs().max() for g in grads]).max()
    max_abs = torch.clamp_min(max_abs.float(), 1e-30)
    sq = sum(((g.detach().float() / max_abs) ** 2).sum() for g in grads)
    return max_abs * torch.sqrt(sq)


@torch.no_grad()
def clip_by_safe_global_norm(grads: list[torch.Tensor],
                             max_norm: float) -> torch.Tensor:
    """Scale ``grads`` in place to a global norm of at most ``max_norm``
    (optim.py:224-237); returns the norm before clipping."""
    norm = global_grad_norm(grads)
    scale = torch.where(norm > max_norm, max_norm / norm,
                        torch.ones_like(norm))
    for g in grads:
        g.mul_(scale.to(g.dtype))
    return norm
