"""The tiny sparse-Swin hubs that the Swin port tests share: the JAX hub
and the port's with the same widths and depths, their plans and numpy
batches.

``CFG`` is Swin on 64x64 grids of 5 bins: patch 4, so stages at 16^2, 8^2,
4^2 and 2^2 tokens, window 4 (stage 1's second block shifted by 2; the
window covers the map from stage 3 on), depths (2, 1, 1, 1), widths (32,
64, 128, 256). Stage 3's width 128 with hidden 512 at 16 tokens opens K5's
gate (and stage 4's 256 at 4 tokens), so an eval forward takes the K5
branch of ``Mlp`` (on the CPU its plain version). The mask-cell grid is 2x2
(4 cells of 32 pixels, 2 kept at ratio 0.5): stage 1's 128 visible tokens
are grouped by the knapsack, the later stages run in masking mode. The rec
decoder has one block of width 32 over the 4 cells.
"""

import functools

import jax.numpy as jnp
import numpy as np
import torch

from eventpretrain_tpu.models.cls_hub import FtClsHub as JFtClsHub
from eventpretrain_tpu.models.decoder import RecDecoder as JRecDecoder
from eventpretrain_tpu.models.dense_hub import FtDenseHub as JFtDenseHub
from eventpretrain_tpu.models.pretrain_hub import PrHub as JPrHub
from eventpretrain_tpu.models.swin import SparseSwin as JSparseSwin
from eventpretrain_tpu.models.swin import plans_to_device as j_plans
from eventpretrain_tpu.models.swin_plan import build_swin_plans
from eventpretrain_tpu_torch.models.cls_hub import cls_hub_swin_tiny
from eventpretrain_tpu_torch.models.decoder import RecDecoder
from eventpretrain_tpu_torch.models.dense_hub import dense_hub_swin_tiny
from eventpretrain_tpu_torch.models.layers import init_weights
from eventpretrain_tpu_torch.models.pretrain_hub import PrHub
from eventpretrain_tpu_torch.models.swin import SparseSwin, plans_to_device

from tests._convvit_port import port_twin, rel_err  # noqa: F401

CFG = dict(input_size=64, patch_size=4, embed_dims=(32, 64, 128, 256),
           depths=(2, 1, 1, 1), num_heads=(2, 2, 4, 8), window_size=4,
           decoder_num_patches=4)
EMBED = 256
WIDTHS = (32, 64, 128, 256)
SIDE, RES, CELLS, LEN_KEEP, PATCH = 64, 16, 2, 2, 32
PLAN = dict(input_resolution=(RES, RES), num_stages=4, window_size=4,
            cell_grid=CELLS)
STEP = dict(cell_grid=CELLS, mask_ratio=0.5, decoder_patch_size=PATCH,
            input_resolution=RES, window_size=4)
DEC = dict(patch_size=PATCH, num_patches=CELLS ** 2, embed_dim=32, depth=1,
           num_heads=4, frame_chans=1)
CLIP_DIM, CLIP_TOKENS = 16, 16  # a 4x4 CLIP grid, 2x2 after the conv
MLP_DIM = 64


def jax_pretrain_hub():
    return JPrHub(backbone=JSparseSwin(**CFG, name="backbone"),
                  decoder=JRecDecoder(**DEC, name="pretrain_rec_decoder"),
                  embed_dim=EMBED, num_patches=CELLS ** 2, mlp_dim=MLP_DIM,
                  clip_emb_dim=CLIP_DIM, clip_proj_conv=True)


def port_pretrain_hub(with_decoder=True, with_heads=True, dtype=torch.float32,
                      device="cpu", clip_dim=CLIP_DIM, **bk):
    """The tiny pretrain hub; ``bk`` overrides ``CFG`` (its
    ``decoder_num_patches`` is the decoder's patch count too)."""
    cfg = {**CFG, **bk}
    backbone = SparseSwin(**cfg, with_rec_decoders=with_decoder,
                          dtype=dtype, device=device)
    decoder = (RecDecoder(EMBED, **{**DEC, "num_patches":
                                    cfg["decoder_num_patches"]},
                          dtype=dtype, device=device)
               if with_decoder else None)
    return PrHub(backbone, decoder, with_heads=with_heads, mlp_dim=MLP_DIM,
                 clip_emb_dim=clip_dim, clip_proj_conv=True, dtype=dtype,
                 device=device)


def jax_cls_hub(num_classes):
    return JFtClsHub(backbone=JSparseSwin(**CFG, with_rec_decoders=False,
                                          name="backbone"),
                     num_classes=num_classes)


def port_cls_hub(num_classes, **kw):
    return cls_hub_swin_tiny(num_classes, device="cpu", **CFG, **kw)


def jax_dense_hub(num_classes):
    return JFtDenseHub(
        backbone=JSparseSwin(**CFG, with_rec_decoders=False, name="backbone"),
        num_classes=num_classes, decode_in_channels=WIDTHS,
        decode_dropout=0.0)


def port_dense_hub(num_classes, **kw):
    return dense_hub_swin_tiny(num_classes, device="cpu", decode_dropout=0.0,
                               **CFG, **kw)


def mask_cells(seed):
    """A 2x2 cell mask with 2 cells kept, as the step's schedule draws
    it: ``(mask bool (4,), ids_keep (2,), ids_restore (4,))``."""
    noise = np.random.default_rng(seed).random(CELLS ** 2)
    shuffle = np.argsort(noise)
    keep = shuffle[:LEN_KEEP]
    mask = np.ones(CELLS ** 2, bool)
    mask[keep] = False
    return mask, keep, np.argsort(shuffle)


def plans_of(mask):
    """(JAX device plans, port plans on the CPU) of a cell mask."""
    host = build_swin_plans(mask, **PLAN)
    return j_plans(host), plans_to_device(host, "cpu")


def rec_batch(seed, b=2):
    rng = np.random.default_rng(seed)
    return dict(
        evg=rng.normal(size=(b, SIDE, SIDE, 5)).astype(np.float32),
        frame=rng.normal(size=(b, SIDE, SIDE, 1)).astype(np.float32),
        clip_emb=rng.normal(size=(b, 1 + CLIP_TOKENS, CLIP_DIM)).astype(
            np.float32))


@functools.lru_cache(maxsize=None)
def _rec_variables(seed):
    hub = port_pretrain_hub()
    init_weights(hub, torch.Generator().manual_seed(seed))
    jhub = jax_pretrain_hub()
    mask, keep, restore = mask_cells(0)
    jplans, _ = plans_of(mask)
    b = rec_batch(seed)
    x = jnp.asarray(b["evg"])
    vr = port_twin(hub, jhub, x, jnp.asarray(keep)[None],
                   jnp.asarray(restore)[None], plans=jplans,
                   method=jhub.forward_rec)
    vc = port_twin(hub, jhub, x, jnp.asarray(b["clip_emb"]),
                   method=jhub.forward_con)
    params = {**vc["params"], **vr["params"],
              "backbone": {**vc["params"]["backbone"],
                           **vr["params"]["backbone"]}}
    return hub.state_dict(), {"params": params,
                              "batch_stats": vc["batch_stats"]}


def rec_twin(seed=0):
    """The tiny pretrain hubs (decoder, stage decoders and heads), the
    port's from ``seed`` and JAX's variables holding its weights (both
    ``forward_rec``'s and ``forward_con``'s trees). The variables are made
    once a seed; each call gives a port hub of its own."""
    sd, v = _rec_variables(seed)
    hub = port_pretrain_hub()
    hub.load_state_dict(sd)
    return hub, jax_pretrain_hub(), v


@functools.lru_cache(maxsize=None)
def _finetune_variables(kind, num_classes, seed):
    make_t, make_j = ((port_cls_hub, jax_cls_hub) if kind == "cls"
                      else (port_dense_hub, jax_dense_hub))
    hub = make_t(num_classes, generator=torch.Generator().manual_seed(seed))
    v = port_twin(hub, make_j(num_classes), jnp.zeros((1, SIDE, SIDE, 5)),
                  seed=seed)
    return hub.state_dict(), v


def finetune_twin(kind, num_classes, seed=0):
    """The tiny cls (``kind`` "cls") or dense hubs, the port's from
    ``seed`` and JAX's variables holding its weights, made once a
    (kind, classes, seed)."""
    sd, v = _finetune_variables(kind, num_classes, seed)
    make_t, make_j = ((port_cls_hub, jax_cls_hub) if kind == "cls"
                      else (port_dense_hub, jax_dense_hub))
    hub = make_t(num_classes)
    hub.load_state_dict(sd)
    return hub, make_j(num_classes), v
