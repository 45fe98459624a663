"""2-D sine-cosine positional embeddings.

A numpy copy of eventpretrain_tpu/ops/pos_embed.py: that module needs no
jax, but importing it runs ``eventpretrain_tpu/ops/__init__.py``, which
does, so the port carries its own.

Parity with reference utils/pos_embed.py:4-55 (MAE / MoCo-v3 style): the grid
is built with ``w`` varying fastest inside ``meshgrid`` output index 0 — i.e.
the first half of the embedding encodes the *column* (w) coordinate when read
through the reference's ``grid[0]`` — and each 1-D embedding is
``[sin | cos]`` concatenated.
"""

from __future__ import annotations

import numpy as np


def get_1d_sincos_pos_embed_from_grid(embed_dim: int, pos: np.ndarray) -> np.ndarray:
    assert embed_dim % 2 == 0
    omega = np.arange(embed_dim // 2, dtype=np.float64)
    omega /= embed_dim / 2.0
    omega = 1.0 / 10000 ** omega
    pos = pos.reshape(-1)
    out = np.einsum("m,d->md", pos, omega)
    return np.concatenate([np.sin(out), np.cos(out)], axis=1)


def get_2d_sincos_pos_embed_from_grid(embed_dim: int, grid: np.ndarray) -> np.ndarray:
    assert embed_dim % 2 == 0
    emb_h = get_1d_sincos_pos_embed_from_grid(embed_dim // 2, grid[0])
    emb_w = get_1d_sincos_pos_embed_from_grid(embed_dim // 2, grid[1])
    return np.concatenate([emb_h, emb_w], axis=1)


def get_2d_sincos_pos_embed(
    embed_dim: int, grid_size: int, cls_token: bool = False
) -> np.ndarray:
    """Returns ``(grid_size**2 [+1], embed_dim)`` float32."""
    grid_h = np.arange(grid_size, dtype=np.float64)
    grid_w = np.arange(grid_size, dtype=np.float64)
    grid = np.meshgrid(grid_w, grid_h)  # w goes first, as in the reference
    grid = np.stack(grid, axis=0).reshape([2, 1, grid_size, grid_size])
    pos_embed = get_2d_sincos_pos_embed_from_grid(embed_dim, grid)
    if cls_token:
        pos_embed = np.concatenate(
            [np.zeros([1, embed_dim]), pos_embed], axis=0
        )
    return pos_embed.astype(np.float32)
