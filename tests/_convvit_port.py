"""The tiny ConvViT hubs that the ConvViT and accumulation port tests share:
the JAX hub and the port's with the same widths and depths, and their
numpy batches.

Widths (16, 24, 32) on 64x64 grids of 5 bins, 4 heads: stage 1 at 16^2,
stage 2 at 8^2, 16 tokens of 16 pixels (4 kept), the FPN level at 1^2.
Depths (2, 1, 2): ``conv_block2`` is sized with ``depths[0]``, as in the
reference, so both conv stages hold two blocks, and the drop-path rates
``linspace(0, r, 5)`` index the ViT blocks from 3, the second conv stage's
last rate again. With drop-path, 5 blocks draw twice each (the first conv
block's rate is 0): ``SITES`` masks a step. The rec decoder has one block
of width 32.
"""

import jax
import jax.numpy as jnp
import numpy as np
import torch

from eventpretrain_tpu.ckpt.torch_import import import_torch_params
from eventpretrain_tpu.models.cls_hub import FtClsHub as JFtClsHub
from eventpretrain_tpu.models.convvit import ConvViT as JConvViT
from eventpretrain_tpu.models.decoder import RecDecoder as JRecDecoder
from eventpretrain_tpu.models.dense_hub import FtDenseHub as JFtDenseHub
from eventpretrain_tpu.models.pretrain_hub import PrHub as JPrHub
from eventpretrain_tpu.ops import masking as jmask
from eventpretrain_tpu_torch.models.cls_hub import cls_hub_convvit_small
from eventpretrain_tpu_torch.models.convvit import ConvViT
from eventpretrain_tpu_torch.models.decoder import RecDecoder
from eventpretrain_tpu_torch.models.dense_hub import dense_hub_convvit_small
from eventpretrain_tpu_torch.models.layers import init_weights
from eventpretrain_tpu_torch.models.pretrain_hub import PrHub

CFG = dict(input_size=64, patch_sizes=(4, 2, 2), embed_dims=(16, 24, 32),
           depths=(2, 1, 2), num_heads=4)
EMBED = 32
WIDTHS = (16, 24, 32, 32)
NUM_PATCHES, LEN_KEEP, PATCH = 16, 4, 16
SITES = 10
DEC = dict(patch_size=PATCH, num_patches=NUM_PATCHES, embed_dim=EMBED,
           depth=1, num_heads=4, frame_chans=1)


def rel_err(got, want):
    return float(np.abs(got - want).max() / max(np.abs(want).max(), 1e-30))


def jax_pretrain_hub():
    return JPrHub(backbone=JConvViT(**CFG, name="backbone"),
                  decoder=JRecDecoder(**DEC, name="pretrain_rec_decoder"),
                  embed_dim=EMBED, num_patches=NUM_PATCHES)


def port_pretrain_hub(**bk):
    return PrHub(ConvViT(**CFG, device="cpu", **bk),
                 RecDecoder(EMBED, **DEC, device="cpu"), device="cpu")


def jax_cls_hub(num_classes, **bk):
    return JFtClsHub(backbone=JConvViT(**CFG, with_rec_decoders=False,
                                       name="backbone", **bk),
                     num_classes=num_classes)


def port_cls_hub(num_classes, **bk):
    return cls_hub_convvit_small(num_classes, device="cpu", **CFG, **bk)


def jax_dense_hub(num_classes, **bk):
    return JFtDenseHub(
        backbone=JConvViT(**CFG, with_rec_decoders=False, with_fpn=True,
                          name="backbone", **bk),
        num_classes=num_classes, decode_in_channels=WIDTHS,
        decode_dropout=0.0)


def port_dense_hub(num_classes, **bk):
    return dense_hub_convvit_small(num_classes, device="cpu",
                                   decode_dropout=0.0, **CFG, **bk)


def port_twin(hub, jhub, *args, method=None, seed=0, **kw):
    """The JAX variables of ``jhub`` holding ``hub``'s weights: ``hub``
    (the port's, initialised from its seed) with its BatchNorm running
    statistics drawn away from their init, then its state dict imported
    into the shapes of ``jhub.init(key, *args, method=method, **kw)`` by
    JAX's own importer (every leaf filled, shapes checked). The port's
    init is cheap where ``jax.jit(jhub.init)`` compiles the whole hub."""
    rng = torch.Generator().manual_seed(seed + 6)
    with torch.no_grad():
        for name, buf in hub.named_buffers():
            if "running_" in name:
                buf.copy_(torch.rand(buf.shape, generator=rng) + 0.5)
    shapes = jax.eval_shape(
        lambda k: jhub.init(k, *args, method=method, **kw),
        jax.random.key(0))
    sd = {k: v.detach().numpy() for k, v in hub.state_dict().items()}
    out = {}
    for col, tree in shapes.items():
        out[col], missing, _ = import_torch_params(sd, tree, verbose=False)
        assert not missing, missing
    return out


def rec_twin(seed=0):
    """The tiny pretrain hubs, the port's from ``seed`` and JAX's
    variables holding its weights."""
    hub = port_pretrain_hub()
    init_weights(hub, torch.Generator().manual_seed(seed))
    b = rec_batch(seed, 2)
    jhub = jax_pretrain_hub()
    v = port_twin(hub, jhub, jnp.asarray(b["evg"]),
                  jnp.asarray(b["ids_keep"]), jnp.asarray(b["ids_restore"]),
                  mask=jnp.asarray(b["mask"]), method=jhub.forward_rec)
    return hub, jhub, v


def finetune_twin(kind, num_classes, seed=0, **bk):
    """The tiny cls (``kind`` "cls") or dense hubs, the port's from
    ``seed`` and JAX's variables holding its weights."""
    make_t, make_j = ((port_cls_hub, jax_cls_hub) if kind == "cls"
                      else (port_dense_hub, jax_dense_hub))
    hub = make_t(num_classes, generator=torch.Generator().manual_seed(seed),
                 **bk)
    jhub = make_j(num_classes, **bk)
    side = CFG["input_size"]
    return hub, jhub, port_twin(hub, jhub, jnp.zeros((1, side, side, 5)),
                                seed=seed)


def rec_batch(seed, b=3):
    """numpy evg and frame with an explicit masking."""
    rng = np.random.default_rng(seed)
    noise = rng.uniform(size=(b, NUM_PATCHES)).astype(np.float32)
    ids_keep, mask, ids_restore = jmask.make_mask_from_noise(
        jnp.asarray(noise), LEN_KEEP)
    return dict(evg=rng.normal(size=(b, 64, 64, 5)).astype(np.float32),
                frame=rng.normal(size=(b, 64, 64, 1)).astype(np.float32),
                ids_keep=np.asarray(ids_keep), mask=np.asarray(mask),
                ids_restore=np.asarray(ids_restore))


def torch_batch(batch):
    out = {k: torch.from_numpy(np.array(v)) for k, v in batch.items()}
    for k in ("ids_keep", "ids_restore", "label"):
        if k in out:
            out[k] = out[k].long()
    if "keep" in out:
        out["drop_path_keep"] = out.pop("keep")
    return out


def tiny_cli_hub(num_bins=5, frame_chans=1, with_decoder=True,
                 with_heads=False, bn_groups=1, *, dtype, device, generator,
                 input_size, **_):
    """``cli.pretrain``'s ConvViT hub factory at tiny widths, projectors of
    width 64, CLIP's 512-wide tokens."""
    backbone = ConvViT(**{**CFG, "input_size": input_size},
                       num_bins=num_bins, with_rec_decoders=with_decoder,
                       dtype=dtype, device=device)
    grid = backbone.num_patches
    decoder = (RecDecoder(EMBED, **{**DEC, "num_patches": grid,
                                    "frame_chans": frame_chans},
                          dtype=dtype, device=device)
               if with_decoder else None)
    hub = PrHub(backbone, decoder, with_heads=with_heads, mlp_dim=64,
                bn_groups=bn_groups, dtype=dtype, device=device)
    init_weights(hub, generator)
    return hub
