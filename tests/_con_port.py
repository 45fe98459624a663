"""The tiny pretrain hub the contrastive-stage port tests share: the JAX
hub and the port's with the same widths, their random variables and
numpy batches.

Two blocks of width 64 and 4 heads on 32x32 grids of 5 bins (16 patches
of 8 pixels), a one-block decoder, projectors of width 64, and 17 CLIP
tokens (a cls token and 16 patches) of width 32.
"""

import jax
import jax.numpy as jnp
import numpy as np
import torch

from eventpretrain_tpu.models.decoder import RecDecoder as JRecDecoder
from eventpretrain_tpu.models.pretrain_hub import PrHub as JPrHub
from eventpretrain_tpu.models.vit import ViT as JViT
from eventpretrain_tpu.ops import masking as jmask
from eventpretrain_tpu.train.state import merge_params
from eventpretrain_tpu_torch.models.decoder import RecDecoder
from eventpretrain_tpu_torch.models.layers import init_weights
from eventpretrain_tpu_torch.models.pretrain_hub import PrHub
from eventpretrain_tpu_torch.models.vit import ViT

EMBED = 64
ENC = dict(input_size=32, patch_size=8, embed_dim=EMBED, depth=2,
           num_heads=4, num_bins=5, out_indices=(0, 1), masked_taps=(0, 1))
DEC = dict(patch_size=8, num_patches=16, embed_dim=EMBED, depth=1,
           num_heads=4, frame_chans=1)
NUM_PATCHES, LEN_KEEP, PATCH = 16, 4, 8
MLP = 64
CLIP_DIM = 32
CLIP_TOKENS = 1 + NUM_PATCHES
# f32 steps on both sides, sums in other orders: losses, gradients and
# parameters after a few updates at 1e-4 of their scale
STEP_REL = 1e-4


def rel_err(got, want):
    return float(np.abs(got - want).max() / max(np.abs(want).max(), 1e-30))


def queue_buffer(length, seed=21):
    """A (EMBED, NUM_PATCHES, length) queue of normalised keys."""
    buf = np.random.default_rng(seed).normal(size=(EMBED, NUM_PATCHES,
                                                   length))
    return (buf / np.linalg.norm(buf, axis=0, keepdims=True)).astype(
        np.float32)


def jax_hub(bn_groups=1, with_decoder=True):
    dec = (JRecDecoder(**DEC, name="pretrain_rec_decoder")
           if with_decoder else None)
    return JPrHub(backbone=JViT(**ENC, name="backbone"), decoder=dec,
                  embed_dim=EMBED, num_patches=NUM_PATCHES, mlp_dim=MLP,
                  clip_emb_dim=CLIP_DIM, bn_groups=bn_groups)


def port_hub(with_decoder=True, bn_groups=1, *, input_size=32, patch_size=8,
             with_heads=True, dtype=torch.float32, device="cpu",
             clip_dim=CLIP_DIM):
    grid = input_size // patch_size
    enc = dict(ENC, input_size=input_size, patch_size=patch_size)
    dec = dict(DEC, patch_size=patch_size, num_patches=grid * grid)
    backbone = ViT(**enc, dtype=dtype, device=device)
    decoder = (RecDecoder(EMBED, **dec, dtype=dtype, device=device)
               if with_decoder else None)
    return PrHub(backbone, decoder, with_heads=with_heads, mlp_dim=MLP,
                 clip_emb_dim=clip_dim, bn_groups=bn_groups, dtype=dtype,
                 device=device)


_VARIABLES = {}


def jax_variables(bn_groups=1, with_decoder=True):
    """(params, batch_stats) of ``jax_hub``, initialised through
    ``forward_rec`` (with a decoder) and ``forward_con`` and merged as the
    JAX CLI does; the BatchNorms' scales, biases and running statistics
    and the decoder's mask token drawn away from their inits, so that
    every one of them is exercised."""
    key = (bn_groups, with_decoder)
    if key in _VARIABLES:
        return _VARIABLES[key]
    hub = jax_hub(bn_groups, with_decoder)
    evg0 = jnp.zeros((2, 32, 32, 5))
    v = jax.jit(lambda k, e, c: hub.init(k, e, c, method=hub.forward_con))(
        jax.random.key(0), evg0, jnp.zeros((2, CLIP_TOKENS, CLIP_DIM)))
    params = v["params"]
    if with_decoder:
        r = jax.jit(lambda k, e, a, b: hub.init(k, e, a, b,
                                                method=hub.forward_rec))(
            jax.random.key(1), evg0, jnp.arange(LEN_KEEP)[None],
            jnp.arange(NUM_PATCHES)[None])
        params = merge_params(v["params"], r["params"])
    rng = np.random.default_rng(11)

    def draw(path, leaf):
        names = [getattr(p, "key", str(p)) for p in path]
        if names[-1] == "scale" and names[-2].startswith("bn"):
            return jnp.asarray(1 + 0.2 * rng.normal(size=leaf.shape),
                               jnp.float32)
        if names[-1] == "bias" and names[-2].startswith("bn"):
            return jnp.asarray(0.2 * rng.normal(size=leaf.shape),
                               jnp.float32)
        if names[-1] == "mask_token":
            return jnp.asarray(0.02 * rng.normal(size=leaf.shape),
                               jnp.float32)
        if names[-1] == "mean":
            return jnp.asarray(0.1 * rng.normal(size=leaf.shape),
                               jnp.float32)
        if names[-1] == "var":
            return jnp.asarray(0.5 + rng.uniform(size=leaf.shape),
                               jnp.float32)
        return leaf

    params = jax.tree_util.tree_map_with_path(draw, params)
    stats = jax.tree_util.tree_map_with_path(draw, v["batch_stats"])
    _VARIABLES[key] = (params, stats)
    return params, stats


def numpy_batch(seed, b=4):
    """numpy evg, frame and CLIP embeddings, and an explicit masking."""
    rng = np.random.default_rng(seed)
    noise = rng.uniform(size=(b, NUM_PATCHES)).astype(np.float32)
    ids_keep, mask, ids_restore = jmask.make_mask_from_noise(
        jnp.asarray(noise), LEN_KEEP)
    return dict(
        evg=rng.normal(size=(b, 32, 32, 5)).astype(np.float32),
        frame=rng.normal(size=(b, 32, 32, 1)).astype(np.float32),
        clip_emb=(rng.normal(size=(b, CLIP_TOKENS, CLIP_DIM)) * 2
                  + 0.3).astype(np.float32),
        ids_keep=np.asarray(ids_keep), mask=np.asarray(mask),
        ids_restore=np.asarray(ids_restore))


def torch_batch(batch, keys):
    out = {k: torch.from_numpy(np.array(batch[k])) for k in keys}
    for k in ("ids_keep", "ids_restore"):
        if k in out:
            out[k] = out[k].long()
    return out


def zero_gradient_keys(name):
    """Parameters whose gradient is zero up to rounding, which Adam scales
    to a whole step of either sign: the attention's key bias (softmax
    ignores it) and the backbone's final LayerNorm bias (a constant a
    feature, which the projector's first BatchNorm removes)."""
    return name.endswith("attn.qkv.bias") or name == "backbone.norm_layer.bias"


def hold_params(hub, want, lr_sum, frozen_init):
    """Every parameter at 1e-4 of its scale (the zero-gradient ones within
    two steps' size); ``frozen_init``'s parameters as they were, bit for
    bit."""
    for n, p in hub.named_parameters():
        got, w = p.detach().numpy().copy(), want[n].copy()
        if n in frozen_init:
            assert np.array_equal(got, frozen_init[n]), n
        if zero_gradient_keys(n):
            sl = (slice(got.shape[0] // 3, 2 * got.shape[0] // 3)
                  if n.endswith("qkv.bias") else slice(None))
            assert np.abs(got[sl] - w[sl]).max() <= 2 * lr_sum, n
            got[sl] = w[sl] = 0.0
        assert rel_err(got, w) <= STEP_REL, (n, rel_err(got, w))


def tiny_cli_hub(num_bins=5, frame_chans=1, with_decoder=True,
                 with_heads=False, bn_groups=1, *, dtype, device, generator,
                 input_size, **_):
    """The CLI's hub factory at tiny widths, 196 patches (the CLIP grid)."""
    hub = port_hub(with_decoder, bn_groups, input_size=input_size,
                   patch_size=16, with_heads=with_heads, dtype=dtype,
                   device=device, clip_dim=512)
    init_weights(hub, generator)
    return hub


CLI_COMMON = ["--device", "cpu", "--no-bf16", "--batch_size", "8",
              "--epochs", "1", "--num_workers", "0", "--print_freq", "2"]
