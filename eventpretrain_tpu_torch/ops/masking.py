"""Patch masking for masked modeling (random / density / anti-density).

Counterpart of eventpretrain_tpu/ops/masking.py. Masking decisions are
plain functions of a noise tensor, computed outside the model; the triple
they return is

  * ``ids_keep``    (B, len_keep) int64 — indices of the visible patches
  * ``mask``        (B, L) float32      — 0 = keep, 1 = removed
  * ``ids_restore`` (B, L) int64        — the inverse shuffle permutation

(int64 where the JAX package has int32: torch indexes with int64). The
argsorts are stable, as ``jnp.argsort`` is: density noise ties on empty
patches, and ties must break by patch index on both sides. Random noise
comes from an explicit ``torch.Generator``; it cannot reproduce
``jax.random``, so parity runs replay explicit masks instead.
"""

from __future__ import annotations

from typing import Optional

import torch


def make_mask_from_noise(noise: torch.Tensor, len_keep: int):
    """``(ids_keep, mask, ids_restore)`` from per-patch noise (B, L): the
    ``len_keep`` patches of smallest noise are kept."""
    batch, num_patches = noise.shape
    ids_shuffle = torch.argsort(noise, dim=1, stable=True)
    ids_restore = torch.argsort(ids_shuffle, dim=1, stable=True)
    ids_keep = ids_shuffle[:, :len_keep]
    mask = torch.ones((batch, num_patches), dtype=torch.float32,
                      device=noise.device)
    mask[:, :len_keep] = 0.0
    mask = torch.gather(mask, 1, ids_restore)
    return ids_keep, mask, ids_restore


def _uniform(generator: Optional[torch.Generator], shape, device):
    return torch.rand(shape, generator=generator, device=device)


def random_masking(generator: Optional[torch.Generator], batch: int,
                   num_patches: int, mask_ratio: float, device=None):
    """Uniform random masking; ``generator`` lives on ``device``."""
    len_keep = int(num_patches * (1 - mask_ratio))
    noise = _uniform(generator, (batch, num_patches), device)
    return make_mask_from_noise(noise, len_keep)


def density_noise(x: torch.Tensor, patch_size: int) -> torch.Tensor:
    """Per-patch event density of a grid ``(B, H, W, C)`` -> ``(B, L)``:
    the patch mean of ``|sum over bins|``, in ``x``'s dtype as in JAX."""
    sum_events = x.sum(-1).abs()  # (B, H, W)
    b, h, w = sum_events.shape
    gh, gw = h // patch_size, w // patch_size
    pooled = sum_events.reshape(b, gh, patch_size, gw, patch_size)
    return pooled.mean(dim=(2, 4)).reshape(b, gh * gw)


def masking_noise(generator: Optional[torch.Generator], x: torch.Tensor,
                  patch_size: int, strategy: str) -> torch.Tensor:
    """Noise for 'random' | 'density' | 'anti-density' masking of ``x``."""
    batch = x.shape[0]
    num = (x.shape[1] // patch_size) * (x.shape[2] // patch_size)
    if strategy == "random":
        return _uniform(generator, (batch, num), x.device)
    density = density_noise(x, patch_size)
    if strategy == "density":
        return density
    if strategy == "anti-density":
        return -density
    raise ValueError(f"unknown masking strategy: {strategy}")
