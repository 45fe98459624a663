"""The CLIP ViT-B/16 image tower and its OpenAI-checkpoint loader.

Counterpart of eventpretrain_tpu/models/clip.py: ``CLIP_IMAGE_MEAN`` and
``CLIP_IMAGE_STD`` :25-26, ``quick_gelu`` :29, ``CLIPBlock`` :33,
``CLIPVisionTransformer`` :57, ``preprocess_images`` :105,
``load_clip_visual_weights`` :117 and ``clip_vit_b16`` :172. The stages
``adj-n`` and ``con-n`` run the frozen tower inside the epoch loop
(``data/pretrain_pipeline.py::ClipEncodingPipeline``) and consume its whole
projected token sequence, (B, 1 + L, 512).

The parameters carry OpenAI's names without the ``visual.`` prefix
(``conv1.weight``, ``class_embedding``, ``positional_embedding``,
``ln_pre.*``, ``transformer.resblocks.{i}.{ln_1, attn.in_proj_weight,
attn.in_proj_bias, attn.out_proj, ln_2, mlp.c_fc, mlp.c_proj}``,
``ln_post.*``, ``proj``), so a released ``ViT-B-16.pt`` loads by a prefix
strip and a strict ``load_state_dict``. They are stored in f32 and cast to
the compute dtype at use; every LayerNorm (eps 1e-5) computes in f32 and
returns the activation dtype. Images are channels-last (B, H, W, 3), as in
JAX; the patch convolution runs on their NCHW view.

JAX reaches no Pallas kernel here: its attention is
``jax.nn.dot_product_attention`` and its products are ``nn.Dense``. So the
tower is plain PyTorch: ``F.linear`` for the products and
``F.scaled_dot_product_attention`` (scale ``head_dim ** -0.5``, JAX's
default) for the attention. Its blocks do not take K1/K2: CLIP's MLP uses
quick-GELU, which K2's erf GELU is not.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from eventpretrain_tpu_torch.models.layers import Conv2d, Linear, layer_norm
from eventpretrain_tpu_torch.ops.reshape import resize

CLIP_IMAGE_MEAN = (0.48145466, 0.4578275, 0.40821073)
CLIP_IMAGE_STD = (0.26862954, 0.26130258, 0.27577711)
CLIP_EPS = 1e-5


def quick_gelu(x: torch.Tensor) -> torch.Tensor:
    return x * torch.sigmoid(1.702 * x)


class CLIPAttention(nn.Module):
    """OpenAI's ``nn.MultiheadAttention`` parameters: one packed
    ``in_proj_weight`` (3C, C) with its bias (q, k, v rows in that order)
    and ``out_proj``."""

    def __init__(self, width: int, heads: int, *, dtype=torch.float32,
                 device=None):
        super().__init__()
        self.heads = heads
        self.compute_dtype = dtype
        self.in_proj_weight = nn.Parameter(
            torch.empty(3 * width, width, device=device))
        self.in_proj_bias = nn.Parameter(torch.empty(3 * width,
                                                     device=device))
        self.out_proj = Linear(width, width, dtype=dtype, device=device)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        b, n, c = x.shape
        dt = self.compute_dtype
        qkv = F.linear(x, self.in_proj_weight.to(dt),
                       self.in_proj_bias.to(dt))
        q, k, v = qkv.view(b, n, 3, self.heads, c // self.heads).permute(
            2, 0, 3, 1, 4)
        out = F.scaled_dot_product_attention(q, k, v)
        return self.out_proj(out.transpose(1, 2).reshape(b, n, c))


class CLIPMlp(nn.Module):
    """``c_fc`` -> quick-GELU -> ``c_proj``."""

    def __init__(self, width: int, *, dtype=torch.float32, device=None):
        super().__init__()
        self.c_fc = Linear(width, 4 * width, dtype=dtype, device=device)
        self.c_proj = Linear(4 * width, width, dtype=dtype, device=device)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.c_proj(quick_gelu(self.c_fc(x)))


class CLIPBlock(nn.Module):
    """Pre-LN block: ``x + attn(ln_1(x))``, then ``x + mlp(ln_2(x))``."""

    def __init__(self, width: int, heads: int, *, dtype=torch.float32,
                 device=None):
        super().__init__()
        self.ln_1 = nn.LayerNorm(width, eps=CLIP_EPS, device=device)
        self.attn = CLIPAttention(width, heads, dtype=dtype, device=device)
        self.ln_2 = nn.LayerNorm(width, eps=CLIP_EPS, device=device)
        self.mlp = CLIPMlp(width, dtype=dtype, device=device)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = x + self.attn(layer_norm(x, self.ln_1))
        return x + self.mlp(layer_norm(x, self.ln_2))


class CLIPTransformer(nn.Module):
    def __init__(self, width: int, layers: int, heads: int, *,
                 dtype=torch.float32, device=None):
        super().__init__()
        self.resblocks = nn.ModuleList(
            CLIPBlock(width, heads, dtype=dtype, device=device)
            for _ in range(layers))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        for block in self.resblocks:
            x = block(x)
        return x


class CLIPVisionTransformer(nn.Module):
    """OpenAI CLIP's visual tower: ``(B, H, W, 3)`` CLIP-normalised images
    -> the projected token sequence ``(B, 1 + L, output_dim)`` in the
    compute dtype (the class token first)."""

    def __init__(self, image_size: int = 224, patch_size: int = 16,
                 width: int = 768, layers: int = 12, heads: int = 12,
                 output_dim: int = 512, *, dtype=torch.float32,
                 device="cuda", generator: Optional[torch.Generator] = None):
        super().__init__()
        self.width = width
        self.grid = image_size // patch_size
        self.compute_dtype = dtype
        kw = dict(device=device)
        self.conv1 = Conv2d(3, width, patch_size, patch_size, bias=False,
                            dtype=dtype, **kw)
        self.class_embedding = nn.Parameter(torch.empty(width, **kw))
        self.positional_embedding = nn.Parameter(
            torch.empty(self.grid ** 2 + 1, width, **kw))
        self.ln_pre = nn.LayerNorm(width, eps=CLIP_EPS, **kw)
        self.transformer = CLIPTransformer(width, layers, heads, dtype=dtype,
                                           **kw)
        self.ln_post = nn.LayerNorm(width, eps=CLIP_EPS, **kw)
        self.proj = nn.Parameter(torch.empty(width, output_dim, **kw))
        init_clip_weights(self, generator or torch.Generator().manual_seed(0))

    def forward(self, images: torch.Tensor) -> torch.Tensor:
        dt = self.compute_dtype
        x = self.conv1(images.permute(0, 3, 1, 2))
        b = x.shape[0]
        x = x.flatten(2).transpose(1, 2)  # (B, L, width), row-major patches
        cls = self.class_embedding.to(dt).expand(b, 1, self.width)
        x = torch.cat([cls, x], dim=1) + self.positional_embedding.to(dt)
        x = self.transformer(layer_norm(x, self.ln_pre))
        return layer_norm(x, self.ln_post) @ self.proj.to(dt)


@torch.no_grad()
def init_clip_weights(module: CLIPVisionTransformer,
                      generator: torch.Generator) -> None:
    """flax's inits (clip.py:69-101), drawn from an explicit CPU generator:
    the products' and the patch convolution's weights LeCun-normal (std
    1/sqrt(fan_in)), biases 0, LayerNorms 1 and 0, ``class_embedding``,
    ``positional_embedding`` and ``proj`` normal with std 0.02."""

    def normal(p: torch.Tensor, std: float) -> None:
        p.copy_(torch.randn(p.shape, generator=generator) * std)

    for name, p in module.named_parameters():
        leaf = name.rsplit(".", 1)[-1]
        if name in ("class_embedding", "positional_embedding", "proj"):
            normal(p, 0.02)
        elif leaf in ("weight", "in_proj_weight") and p.ndim > 1:
            normal(p, p[0].numel() ** -0.5)
        elif leaf == "weight":
            p.fill_(1.0)
        else:
            p.zero_()


def preprocess_images(images: torch.Tensor) -> torch.Tensor:
    """``(B, H, W, 3)`` images -> CLIP-normalised f32 ``(B, 224, 224, 3)``:
    cast to f32 (no scaling: the caller divides uint8 images by 255, as
    ``ClipEncodingPipeline`` does), a bicubic resize to 224 where the size
    differs (``ops/reshape.py::resize``, which follows
    ``jax.image.resize``), then the mean and std normalisation."""
    x = images.float()
    if tuple(x.shape[1:3]) != (224, 224):
        x = resize(x, (224, 224), "bicubic")
    mean = torch.tensor(CLIP_IMAGE_MEAN, device=x.device)
    std = torch.tensor(CLIP_IMAGE_STD, device=x.device)
    return (x - mean) / std


def encode_images(model: CLIPVisionTransformer,
                  images: torch.Tensor) -> torch.Tensor:
    """The in-loop encode (pretrain_pipeline.py:772-778): uint8 images
    divided by 255 (float images are taken as they are), preprocessed,
    through ``model``."""
    x = images.float()
    if images.dtype == torch.uint8:
        x = x / 255.0
    return model(preprocess_images(x))


def load_clip_visual_weights(path: str,
                             model: CLIPVisionTransformer
                             ) -> CLIPVisionTransformer:
    """Fill ``model`` from an OpenAI CLIP checkpoint: a TorchScript archive
    (``torch.jit.load``, as ``ViT-B-16.pt`` is) or, where that raises
    ``RuntimeError``, a pickled state dict (``torch.load``). The
    ``visual.*`` entries, the prefix stripped, load strictly; each value
    is cast to the parameter's f32."""
    try:
        sd = torch.jit.load(path, map_location="cpu").state_dict()
    except RuntimeError:
        sd = torch.load(path, map_location="cpu", weights_only=True)
        if hasattr(sd, "state_dict"):
            sd = sd.state_dict()
    prefix = "visual."
    visual = {k[len(prefix):]: v for k, v in sd.items()
              if k.startswith(prefix)}
    model.load_state_dict(visual, strict=True)
    return model


def clip_vit_b16(*, dtype=torch.float32, device="cuda",
                 generator: Optional[torch.Generator] = None
                 ) -> CLIPVisionTransformer:
    """ViT-B/16 at 224: width 768, 12 layers of 12 heads, output 512, on
    ``device`` (the card unless the caller asks for the CPU), f32
    parameters computed in ``dtype``, randomly initialised from the CPU
    ``generator`` (seed 0 when None)."""
    return CLIPVisionTransformer(
        image_size=224, patch_size=16, width=768, layers=12, heads=12,
        output_dim=512, dtype=dtype, device=device, generator=generator)
