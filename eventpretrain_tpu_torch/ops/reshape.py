"""Token <-> frame reshapes (channels-last).

Counterpart of eventpretrain_tpu/ops/reshape.py:16-55. Images are
``(B, H, W, C)`` and token streams ``(B, L, D)``. The flattening order
inside a patch token is ``(p, q, c)``, as in the JAX package and the
reference's ``bchpwq->bhwpqc`` einsum, so reconstruction targets and
predictions keep the reference layout. ``resize`` and ``resize_flow`` come
with the dense slices.
"""

from __future__ import annotations

import torch


def _grid(num_tokens: int) -> int:
    grid = int(num_tokens ** 0.5)
    if grid * grid != num_tokens:
        raise ValueError(f"{num_tokens} tokens do not form a square grid")
    return grid


def frame2emb(patch_size: int, frame: torch.Tensor) -> torch.Tensor:
    """``(B, H, W, C)`` -> ``(B, L, patch_size**2 * C)``."""
    b, h, w, c = frame.shape
    gh, gw = h // patch_size, w // patch_size
    x = frame.reshape(b, gh, patch_size, gw, patch_size, c)
    x = x.permute(0, 1, 3, 2, 4, 5)  # (b, gh, gw, p, q, c)
    return x.reshape(b, gh * gw, patch_size * patch_size * c)


def emb2frame(patch_size: int, emb: torch.Tensor, chans: int) -> torch.Tensor:
    """``(B, L, patch_size**2 * C)`` -> ``(B, H, W, C)``."""
    b, num_tokens, _ = emb.shape
    grid = _grid(num_tokens)
    x = emb.reshape(b, grid, grid, patch_size, patch_size, chans)
    x = x.permute(0, 1, 3, 2, 4, 5)  # (b, gh, p, gw, q, c)
    return x.reshape(b, grid * patch_size, grid * patch_size, chans)


def emb2patch_frame(emb: torch.Tensor) -> torch.Tensor:
    """``(B, L, C)`` -> ``(B, h, w, C)`` channels-last patch frame."""
    b, num_tokens, c = emb.shape
    grid = _grid(num_tokens)
    return emb.reshape(b, grid, grid, c)


def patch_frame2emb(patch_frame: torch.Tensor) -> torch.Tensor:
    """``(B, h, w, C)`` -> ``(B, L, C)``."""
    b, h, w, c = patch_frame.shape
    return patch_frame.reshape(b, h * w, c)
