"""Token <-> frame reshapes and the resize (channels-last).

Counterpart of eventpretrain_tpu/ops/reshape.py:16-95. Images are
``(B, H, W, C)`` and token streams ``(B, L, D)``. The flattening order
inside a patch token is ``(p, q, c)``, as in the JAX package and the
reference's ``bchpwq->bhwpqc`` einsum, so reconstruction targets and
predictions keep the reference layout.
"""

from __future__ import annotations

import functools

import numpy as np
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


_METHODS = {"nearest": "nearest", "bilinear": "linear", "linear": "linear",
            "bicubic": "cubic", "cubic": "cubic"}


def _keys_cubic(x: torch.Tensor) -> torch.Tensor:
    """Keys' cubic kernel with a = -0.5 (jax.image's ``cubic``)."""
    out = ((1.5 * x - 2.5) * x) * x + 1.0
    out = torch.where(x >= 1.0, ((-0.5 * x + 2.5) * x - 4.0) * x + 2.0, out)
    return torch.where(x >= 2.0, 0.0, out)


@functools.lru_cache(maxsize=64)
def _resize_weights(in_len: int, out_len: int, method: str,
                    device: torch.device) -> torch.Tensor:
    """``(out_len, in_len)`` f32 weights of ``jax.image.resize`` along one
    axis with ``antialias=False``: half-pixel sample positions, the
    triangle (linear) or Keys (cubic) kernel over the input pixels, each
    row divided by its sum (so taps past the border are dropped and the
    rest renormalised), zero where the sample lies outside the input.
    Cached per shape and device: a train step resizes the same shapes at
    every call, and the callers only read the weights."""
    # JAX multiplies by the f32 rounding of in/out (a weakly typed scalar)
    inv_scale = float(np.float32(1.0 / (out_len / in_len)))
    sample = ((torch.arange(out_len, dtype=torch.float32, device=device)
               + 0.5) * inv_scale - 0.5)
    dist = (sample[:, None] - torch.arange(in_len, dtype=torch.float32,
                                           device=device)[None]).abs()
    if method == "linear":
        w = torch.clamp_min(1.0 - dist, 0.0)
    else:
        w = _keys_cubic(dist)
    total = w.sum(dim=1, keepdim=True)
    w = torch.where(total.abs() > 1000.0 * torch.finfo(torch.float32).eps,
                    w / torch.where(total != 0, total, 1.0), 0.0)
    inside = (sample >= -0.5) & (sample <= in_len - 0.5)
    return torch.where(inside[:, None], w, 0.0)


def _nearest_index(in_len: int, out_len: int, device) -> torch.Tensor:
    """jax.image's nearest: input pixel ``floor((i + 0.5) * in / out)``,
    computed in f32 (half-pixel centres; torch's ``nearest-exact``)."""
    i = torch.arange(out_len, dtype=torch.float32, device=device)
    return torch.floor((i + 0.5) * in_len / out_len).long()


def resize(x: torch.Tensor, size: tuple[int, int],
           mode: str = "bilinear") -> torch.Tensor:
    """Resize ``(..., H, W, C)`` to ``(..., size[0], size[1], C)`` as
    ``jax.image.resize(..., antialias=False)`` does (reshape.py:67).

    That is ``F.interpolate(align_corners=False)`` for bilinear, at any
    scale; its ``nearest`` is half-pixel (torch's ``nearest-exact``), and
    its ``cubic`` is Keys' kernel with a = -0.5 renormalised at the border,
    where torch's bicubic uses a = -0.75 and clamps. An axis whose size
    does not change is left as it is, as in JAX. The weights take ``x``'s
    dtype, as in JAX, and each axis is one contraction.
    """
    method = _METHODS[mode]
    h, w = x.shape[-3], x.shape[-2]
    out_h, out_w = size
    if method == "nearest":
        if out_h != h:
            x = x.index_select(-3, _nearest_index(h, out_h, x.device))
        if out_w != w:
            x = x.index_select(-2, _nearest_index(w, out_w, x.device))
        return x
    if not x.dtype.is_floating_point:
        x = x.float()
    if out_h != h:
        wy = _resize_weights(h, out_h, method, x.device).to(x.dtype)
        x = torch.einsum("oh,...hwc->...owc", wy, x)
    if out_w != w:
        wx = _resize_weights(w, out_w, method, x.device).to(x.dtype)
        x = torch.einsum("pw,...hwc->...hpc", wx, x)
    return x


def resize_flow(x: torch.Tensor, size: tuple[int, int],
                mode: str = "bilinear") -> torch.Tensor:
    """Resize a flow field ``(..., H, W, 2)`` and rescale its vectors
    (reshape.py:82): u by ``size[1] / W``, v by ``size[0] / H``, as
    scalars of ``x``'s dtype."""
    org_h, org_w = x.shape[-3], x.shape[-2]
    out = resize(x, size, mode)
    scale = torch.tensor([size[1] / org_w, size[0] / org_h],
                         dtype=out.dtype, device=out.device)
    return out * scale
