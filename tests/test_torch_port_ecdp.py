"""The ECDP baseline (``--pr_phase ecdp``) against the JAX package on the
CPU.

The same inputs go through the JAX function and its port: the objectives
(values and gradients), the 2-channel count image, ViT-ECDP and
ConvViT-ECDP (masked and dense encodes), ``forward_query`` and the key
path, three ``make_ecdp_step`` steps from one init (with and without the
queues, one queue length not a multiple of the batch), the cls and dense
ECDP hubs, both pipelines (on their C++ host code) and the weight bridge;
then the port's CLI for one epoch and a ``vit_ecdp`` cls finetune from
its checkpoint. A tiny f32 config: ViT-ECDP of width 64, depth 2, 4
heads on 32x32 inputs (16 patches of 8, 4 kept), ConvViT-ECDP of widths
(16, 32, 64) on 64x64 inputs, heads 64 wide with 32 out, CLIP embeddings
of 16. Every JAX step runs under ``jax.jit``.
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from eventpretrain_tpu import native as jnative
from eventpretrain_tpu.ckpt.torch_export import export_torch_state_dict
from eventpretrain_tpu.data import pretrain_pipeline as jpipe
from eventpretrain_tpu.models import cls_hub as jcls
from eventpretrain_tpu.models import dense_hub as jdense
from eventpretrain_tpu.models.convvit_ecdp import ConvViTECDP as JConvViTECDP
from eventpretrain_tpu.models.ecdp_hub import EcdpEncoder as JEcdpEncoder
from eventpretrain_tpu.models.ecdp_hub import EcdpModel as JEcdpModel
from eventpretrain_tpu.models.vit_ecdp import ViTECDP as JViTECDP
from eventpretrain_tpu.objectives import ecdp as jecdp
from eventpretrain_tpu.ops import events as jevents
from eventpretrain_tpu.ops import masking as jmask
from eventpretrain_tpu.train import optim as joptim
from eventpretrain_tpu.train.state import TrainState as JTrainState
from eventpretrain_tpu.train.steps import make_ecdp_step as j_make_ecdp_step
from eventpretrain_tpu_torch import native as tnative
from eventpretrain_tpu_torch.ckpt.bridge import (
    finetune_state_dict,
    load_ecdp_checkpoint,
    load_jax_state_dict,
    load_torch_checkpoint,
)
from eventpretrain_tpu_torch.cli import finetune_cls as cls_cli
from eventpretrain_tpu_torch.cli import finetune_flow as flow_cli
from eventpretrain_tpu_torch.cli import finetune_semseg as semseg_cli
from eventpretrain_tpu_torch.cli import pretrain as pretrain_cli
from eventpretrain_tpu_torch.data import pretrain_pipeline as tpipe
from eventpretrain_tpu_torch.data.representations import build_representation
from eventpretrain_tpu_torch.models import cls_hub as tcls
from eventpretrain_tpu_torch.models import dense_hub as tdense
from eventpretrain_tpu_torch.models.convvit_ecdp import ConvViTECDP
from eventpretrain_tpu_torch.models.ecdp_hub import (
    EcdpEncoder,
    EcdpModel,
    forward_key,
    make_key_encoder,
)
from eventpretrain_tpu_torch.models.layers import init_weights
from eventpretrain_tpu_torch.models.vit_ecdp import ViTECDP
from eventpretrain_tpu_torch.objectives import ecdp as tecdp
from eventpretrain_tpu_torch.ops import events as tevents
from eventpretrain_tpu_torch.train import optim as toptim
from eventpretrain_tpu_torch.train.state import TrainState
from eventpretrain_tpu_torch.train.steps import make_ecdp_step

from tests._port_threads import one_torch_thread  # noqa: F401

VIT = dict(input_size=32, patch_size=8, embed_dim=64, depth=2, num_heads=4,
           num_bins=2, out_indices=(0, 1))
CONV = dict(input_size=64, patch_sizes=(4, 2, 2), embed_dims=(16, 32, 64),
            depths=(1, 1, 2), num_heads=4, num_bins=2, out_indices=(0, 1))
HEADS = dict(proj_dim=32, mlp_dim=64)
CLIP_DIM = 16
NUM_PATCHES, LEN_KEEP, B = 16, 4, 4
# f32 on both sides, sums in other orders: objectives and single forwards
# at 1e-5 of their scale; losses, gradients and parameters after a few
# updates at 1e-4 of their scale (as the contrastive steps are held)
FWD_REL = 1e-5
# forwards through the projectors' BatchNorms over 4 rows, which scale
# the rounding by each feature's 1/std
BN_REL = 5e-5
STEP_REL = 1e-4


def rel_err(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.abs(got - want).max() / max(np.abs(want).max(), 1e-30))


def t(x, grad=False):
    return torch.tensor(np.asarray(x, np.float32), requires_grad=grad)


# ---------------------------------------------------------- objectives


def _qk(seed, b=6, c=8):
    rng = np.random.default_rng(seed)
    return (rng.normal(size=(b, c)).astype(np.float32),
            (rng.normal(size=(b, c)) * 2 + 0.3).astype(np.float32))


def _hold_fn(jfn, tfn, args, n_grad):
    """``tfn`` against ``jfn`` on the same arrays: the value and the
    gradient of its sum w.r.t. the first ``n_grad`` arguments, at
    ``FWD_REL``."""
    want = jfn(*map(jnp.asarray, args))
    targs = [t(a, i < n_grad) for i, a in enumerate(args)]
    got = tfn(*targs)
    assert rel_err(got.detach().numpy(), want) <= FWD_REL
    jgrads = jax.grad(lambda *a: jfn(*a).sum(), argnums=tuple(
        range(n_grad)))(*map(jnp.asarray, args))
    tgrads = torch.autograd.grad(got.sum(), targs[:n_grad])
    for i, (g, w) in enumerate(zip(tgrads, jgrads)):
        assert rel_err(g.numpy(), w) <= FWD_REL, i


@pytest.mark.parametrize("case", ["vector_project", "global_l2",
                                  "global_raw", "sinkhorn", "kl"])
def test_objective_matches_jax(case):
    """Each objective's value and gradients (the KL's through its
    sinkhorn target, whose column sums carry a gradient and whose total
    and row sums do not) against JAX's at 1e-5."""
    q, k = _qk(3)
    if case == "vector_project":
        _hold_fn(jecdp.vector_project, tecdp.vector_project, (q, k), 2)
    elif case.startswith("global"):
        l2 = case == "global_l2"
        _hold_fn(lambda a, b: jecdp.global_sample_infonce(a, b, 0.2, l2),
                 lambda a, b: tecdp.global_sample_infonce(a, b, 0.2, l2),
                 (q, k), 2)
    elif case == "sinkhorn":
        sim = (q @ q.T / 4).astype(np.float32)
        _hold_fn(lambda a: jecdp.sinkhorn(a) * jnp.arange(36.).reshape(6, 6),
                 lambda a: tecdp.sinkhorn(a) * torch.arange(36.).view(6, 6),
                 (sim,), 1)
    else:
        _hold_fn(lambda a, b: jecdp.ecdp_kl_loss(a, b, 0.1),
                 lambda a, b: tecdp.ecdp_kl_loss(a, b, 0.1), (q, k), 2)


@pytest.mark.parametrize("length,ptr", [(12, 0), (10, 8)],
                         ids=["multiple", "clamped"])
def test_queue_infonce_matches_jax(length, ptr):
    """The queue loss and its gradients at 1e-5, and the enqueue: at a
    pointer past ``K - B`` the keys land at ``K - B``, as
    ``dynamic_update_slice`` clamps, and the pointer wraps mod K; the old
    buffer is left as it was."""
    q, k = _qk(5, b=4)
    rng = np.random.default_rng(6)
    buf = rng.normal(size=(8, length)).astype(np.float32)
    jq = jecdp.SampleQueueState(jnp.asarray(buf), jnp.asarray(ptr))
    for l2 in (True, False):
        def jfn(a, b):
            return jecdp.sample_infonce_queue(a, b, jq, 0.2, l2)[0]

        def tfn(a, b):
            return tecdp.sample_infonce_queue(
                a, b, tecdp.SampleQueueState(torch.from_numpy(buf), ptr),
                0.2, l2)[0]

        _hold_fn(jfn, tfn, (q, k), 2)
        _, jnew = jecdp.sample_infonce_queue(jnp.asarray(q), jnp.asarray(k),
                                             jq, 0.2, l2)
        old = torch.from_numpy(buf.copy())
        _, tnew = tecdp.sample_infonce_queue(
            t(q), t(k), tecdp.SampleQueueState(old, ptr), 0.2, l2)
        assert tnew.ptr == int(jnew.ptr) == (ptr + 4) % length
        np.testing.assert_allclose(tnew.buffer.numpy(),
                                   np.asarray(jnew.buffer), atol=1e-6)
        assert np.array_equal(old.numpy(), buf)


def test_ema_update_and_momentum_match_jax():
    """The in-place EMA over a module's parameters against ``ema_update``
    over the tree, and the cosine momentum at a few epoch fractions."""
    rng = np.random.default_rng(8)
    a, b = torch.nn.Linear(3, 4), torch.nn.Linear(3, 4)
    with torch.no_grad():
        for p in list(a.parameters()) + list(b.parameters()):
            p.copy_(torch.from_numpy(rng.normal(size=p.shape)))
    want = jecdp.ema_update(
        {n: jnp.asarray(p.detach().numpy()) for n, p in a.named_parameters()},
        {n: jnp.asarray(p.detach().numpy()) for n, p in b.named_parameters()},
        jnp.float32(0.993))
    tecdp.ema_update(a, b, 0.993)
    for n, p in b.named_parameters():
        assert rel_err(p.detach().numpy(), want[n]) <= 1e-6, n
    for frac in (0.0, 0.37, 5.0, 100.0):
        assert abs(tecdp.cosine_ema_momentum(0.99, frac, 100.0) - float(
            jecdp.cosine_ema_momentum(0.99, jnp.float32(frac), 100.0))) < 1e-7


# --------------------------------------------------------- count image


def _events(seed, b=3, e=300, hw=(20, 24)):
    """Events with out-of-frame coordinates (negative, on and past the
    edges, -0.5 which truncates into the frame) and a padded tail past
    each count holding in-frame garbage."""
    rng = np.random.default_rng(seed)
    h, w = hw
    ev = np.stack([rng.uniform(-3, w + 3, (b, e)), rng.uniform(-3, h + 3,
                                                                (b, e)),
                   np.sort(rng.uniform(0, 1, (b, e)), axis=1),
                   rng.choice([-1.0, 0.0, 1.0], (b, e))], -1)
    ev[:, :4, :2] = [[-0.5, 3], [w, 2], [w - 1, h - 1], [1, h]]
    counts = np.array([e, e // 2, 0][:b], np.int32)
    return ev.astype(np.float32), counts


def test_count_image_matches_jax():
    """The batched count image (K3's plain version on the CPU, and through
    ``build_representation(num_bins=2)``) and the one-sample image against
    JAX's scatter (``use_mxu=False``), exactly."""
    ev, counts = _events(0)
    kw = dict(height=20, width=24)
    want = np.asarray(jevents.events_to_image_ecdp_batch(
        jnp.asarray(ev), jnp.asarray(counts), use_mxu=False, **kw))
    assert want.sum() > 0
    got = tevents.events_to_image_ecdp_batch(torch.from_numpy(ev),
                                             torch.from_numpy(counts), **kw)
    assert np.array_equal(got.numpy(), want)
    rep = build_representation(torch.from_numpy(ev), torch.from_numpy(counts),
                               num_bins=2, **kw)
    assert np.array_equal(rep.numpy(), want)
    one = tevents.events_to_image_ecdp(torch.from_numpy(ev[1]),
                                       int(counts[1]), **kw)
    assert np.array_equal(one.numpy(), want[1])
    pw = tevents._polarity_weights(torch.from_numpy(ev),
                                   torch.from_numpy(counts))
    assert np.array_equal(pw.numpy(), np.asarray(jevents._polarity_weights(
        jnp.asarray(ev), jnp.asarray(counts))))


# ------------------------------------------------------ models and hubs


def _jax_backbone(kind):
    return (JViTECDP(**VIT, name="backbone") if kind == "vit"
            else JConvViTECDP(**CONV, name="backbone"))


def _port_backbone(kind):
    return (ViTECDP(**VIT, device="cpu") if kind == "vit"
            else ConvViTECDP(**CONV, device="cpu"))


def _jax_model(kind):
    enc = JEcdpEncoder(backbone=_jax_backbone(kind), **HEADS, name="encoder")
    return JEcdpModel(encoder=enc, **HEADS, clip_emb_dim=CLIP_DIM)


def _port_model(kind):
    return EcdpModel(EcdpEncoder(_port_backbone(kind), **HEADS), **HEADS,
                     clip_emb_dim=CLIP_DIM)


def _size(kind):
    return VIT["input_size"] if kind == "vit" else CONV["input_size"]


def _redraw(tree, seed):
    """Every leaf redrawn from numpy: weights around their init scale,
    the tokens, BatchNorm scales and biases and running statistics away
    from their trivial inits."""
    rng = np.random.default_rng(seed)

    def draw(path, leaf):
        name = getattr(path[-1], "key", str(path[-1]))
        shape = leaf.shape
        if name in ("scale",):
            v = 1 + 0.2 * rng.normal(size=shape)
        elif name == "var":
            v = 0.5 + rng.uniform(size=shape)
        elif name in ("bias", "mean", "tokens"):
            v = 0.2 * rng.normal(size=shape)
        else:
            fan_in = int(np.prod(shape[:-1])) if len(shape) > 1 else 1
            v = rng.normal(size=shape) / np.sqrt(max(fan_in, 1))
        return jnp.asarray(v, jnp.float32)

    return jax.tree_util.tree_map_with_path(draw, tree)


_VARS = {}


def _jax_vars(kind):
    """(params, batch_stats) of ``_jax_model(kind)`` through
    ``forward_query``, redrawn."""
    if kind not in _VARS:
        m, s = _jax_model(kind), _size(kind)
        v = jax.jit(lambda key, x, ids, c: m.init(
            key, x, ids, c, mask=jnp.zeros((2, NUM_PATCHES)),
            method=m.forward_query))(
            jax.random.key(0), jnp.zeros((2, s, s, 2)),
            jnp.tile(jnp.arange(LEN_KEEP)[None], (2, 1)),
            jnp.zeros((2, CLIP_DIM)))
        _VARS[kind] = (_redraw(v["params"], 1), _redraw(v["batch_stats"], 2))
    return _VARS[kind]


def _masks(key, b=B):
    ids, mask, _ = jmask.make_mask_from_noise(
        jax.random.uniform(key, (b, NUM_PATCHES)), LEN_KEEP)
    return ids, mask


def _img(seed, kind, b=B):
    s = _size(kind)
    return np.random.default_rng(seed).normal(size=(b, s, s, 2)).astype(
        np.float32)


@pytest.mark.parametrize("kind", ["vit", "convvit"])
def test_backbone_encodes_match_jax(kind):
    """``encode_masked`` (the two tokens, 51 = 2 + 49 tokens' analogue
    here 2 + 4, and the last block's attention) and ``encode_dense``
    (the concatenated tokens and the pyramid of the patch tokens) at
    1e-5."""
    params, _ = _jax_vars(kind)
    bparams = params["encoder"]["backbone"]
    jb, tb = _jax_backbone(kind), _port_backbone(kind)
    load_jax_state_dict(tb, export_torch_state_dict(bparams))
    x = _img(4, kind)
    ids, mask = _masks(jax.random.key(3))
    we, wi, wa = jax.jit(lambda p, a, i, m: jb.apply(
        {"params": p}, a, i, mask=m, return_attn=True,
        method=jb.encode_masked))(bparams, jnp.asarray(x), ids, mask)
    ge, gi, ga = tb.encode_masked(t(x), torch.from_numpy(
        np.array(ids)).long(), t(mask), return_attn=True)
    assert ga.shape == (B, 4, 2 + LEN_KEEP, 2 + LEN_KEEP)
    for g, w in ((ge, we), (gi, wi), (ga, wa)):
        assert rel_err(g.detach().numpy(), w) <= FWD_REL
    wemb, wouts, _ = jax.jit(lambda p, a: jb.apply(
        {"params": p}, a, return_pyramid=True,
        method=jb.encode_dense))(bparams, jnp.asarray(x))
    gemb, gouts, _ = tb.encode_dense(t(x), return_pyramid=True)
    assert gemb.shape == (B, 128) and len(gouts) == len(wouts) == 2
    for g, w in zip([gemb] + gouts, [wemb] + list(wouts)):
        assert g.shape == w.shape
        assert rel_err(g.detach().numpy(), w) <= FWD_REL


@pytest.mark.parametrize("kind", ["vit", "convvit"])
def test_forward_query_and_key_match_jax(kind):
    """``forward_query`` in training mode (batch statistics; the running
    buffers move as flax's ``batch_stats``) and the key path through the
    key encoder (its BatchNorms on the batch's statistics, no buffers)
    against JAX's ``forward_query`` and ``forward_key`` at 5e-5."""
    params, stats = _jax_vars(kind)
    jm, tm = _jax_model(kind), _port_model(kind)
    load_jax_state_dict(tm, export_torch_state_dict(params, stats))
    key = make_key_encoder(tm)
    assert not [n for n, _ in key.named_buffers() if "running" in n]
    assert not any(p.requires_grad for p in key.parameters())
    x, c = _img(5, kind), np.random.default_rng(6).normal(
        size=(B, CLIP_DIM)).astype(np.float32)
    ids, mask = _masks(jax.random.key(4))
    tids = torch.from_numpy(np.array(ids)).long()
    (wq, wi, wc), upd = jax.jit(lambda v, a, i, cc, m: jm.apply(
        v, a, i, cc, train=True, mask=m, method=jm.forward_query,
        mutable=["batch_stats"]))({"params": params, "batch_stats": stats},
                                  jnp.asarray(x), ids, jnp.asarray(c), mask)
    tm.train()
    got = tm.forward_query(t(x), tids, t(c), t(mask))
    for g, w in zip(got, (wq, wi, wc)):
        assert rel_err(g.detach().numpy(), w) <= BN_REL
    want_sd = export_torch_state_dict(params, upd["batch_stats"])
    for n, buf in tm.named_buffers():
        if n in want_sd:
            assert rel_err(buf.numpy(), want_sd[n]) <= BN_REL, n
    wk, _ = jax.jit(lambda v, a, i, m: jm.apply(
        v, a, i, train=True, mask=m, method=jm.forward_key,
        mutable=["batch_stats"]))({"params": params, "batch_stats": stats},
                                  jnp.asarray(x), ids, mask)
    key.train()
    gk = forward_key(key, t(x), tids, t(mask))
    assert not gk.requires_grad
    assert rel_err(gk.numpy(), wk) <= BN_REL


@pytest.mark.parametrize("kind", ["vit", "convvit"])
def test_cls_and_dense_hubs_match_jax(kind):
    """The ECDP cls hub (Linear over the concatenated tokens, 2C) and the
    dense hub (UPerHead + FCNHead over four token maps: a backbone of four
    blocks), eval mode, at 1e-5; the ``token_concat`` pool's head
    width."""
    s = _size(kind)
    x = _img(7, kind, b=2)
    jc = jcls.FtClsHub(backbone=_jax_backbone(kind), num_classes=3)
    tc = tcls.FtClsHub(_port_backbone(kind), 3)
    cv = jax.jit(jc.init)(jax.random.key(1), jnp.zeros((1, s, s, 2)))
    cv = {"params": _redraw(cv["params"], 9)}
    load_jax_state_dict(tc, export_torch_state_dict(cv["params"]))
    _, wl, _ = jax.jit(jc.apply)(cv, jnp.asarray(x))
    tc.eval()
    emb, gl, _ = tc(t(x))
    assert emb.shape == (2, 128) and tc.classify_head.in_features == 128
    assert rel_err(gl.detach().numpy(), wl) <= FWD_REL
    bb = ({**VIT, "depth": 4} if kind == "vit"
          else {**CONV, "depths": (1, 1, 4)})
    bb = {k: v for k, v in bb.items() if k != "num_bins"}
    bb["out_indices"] = (0, 1, 2, 3)
    name = f"dense_hub_{kind}_ecdp_small"
    jd = getattr(jdense, name)(3, 2, **bb)
    td = getattr(tdense, name)(3, 2, device="cpu", **bb)
    dv = jax.jit(jd.init)(jax.random.key(2), jnp.zeros((1, s, s, 2)))
    dv = {"params": _redraw(dv["params"], 10),
          "batch_stats": _redraw(dv["batch_stats"], 11)}
    load_jax_state_dict(td, export_torch_state_dict(dv["params"],
                                                    dv["batch_stats"]))
    _, _, wdec, waux = jax.jit(jd.apply)(dv, jnp.asarray(x))
    td.eval()
    _, outs, gdec, gaux = td(t(x))
    assert len(outs) == 4
    for g, w in ((gdec, wdec), (gaux, waux)):
        assert g.shape == w.shape
        assert rel_err(g.detach().numpy(), w) <= FWD_REL
    concat = tcls.FtClsHub(tc.backbone, 3, pool="token_concat")
    assert concat.classify_head.in_features == 128  # the ECDP embedding
    vit_concat = tcls.cls_hub_vit_small(3, device="cpu", input_size=32,
                                        patch_size=8, embed_dim=64, depth=2,
                                        num_heads=4)
    vit_concat = tcls.FtClsHub(vit_concat.backbone, 3, pool="token_concat")
    assert vit_concat.classify_head.in_features == 16 * 64
    assert vit_concat(t(_img(1, "vit", b=2)[..., :1].repeat(5, -1)))[
        1].shape == (2, 3)


# ---------------------------------------------------------------- steps


def _schedule():
    return toptim.cosine_warmup_schedule(1e-3, 1e-5, 1, 3, 2)


def _zero_grad_key(name):
    """Gradients that are zero up to rounding, which Adam scales to a
    whole step of either sign: the attention's key bias (softmax ignores
    it) and the backbone's final LayerNorm bias (a constant a feature,
    which the projector's first BatchNorm removes)."""
    return name.endswith("attn.qkv.bias") or name.endswith(
        "backbone.norm_layer.bias")


def _hold_tree(named, want, scale):
    for n, p in named:
        got, w = p.detach().numpy().copy(), np.array(want[n])
        if _zero_grad_key(n):
            sl = (slice(got.shape[0] // 3, 2 * got.shape[0] // 3)
                  if n.endswith("qkv.bias") else slice(None))
            assert np.abs(got[sl] - w[sl]).max() <= 2 * scale, n
            got[sl] = w[sl] = 0.0
        assert rel_err(got, w) <= STEP_REL, (n, rel_err(got, w))


# the steps' batch: at 4 rows the projectors' BatchNorm statistics are
# ill-conditioned enough that three Adam updates part f32 trajectories by
# 2e-4 of the grad norm (ConvViT); 8 rows hold them well inside 1e-4
SB = 8


@pytest.mark.parametrize("kind,queue_len", [
    ("vit", None), ("vit", 20), ("convvit", None)],
    ids=["vit", "vit_queue_clamped", "convvit"])
def test_ecdp_step_trajectory_matches_jax(kind, queue_len):
    """Three steps from one init, batches and masks (the port's masks
    replayed from the JAX step's own draws): the loss, its three parts,
    the momentum and the grad norm at 1e-4 each step; then every
    parameter, the EMA tree (the key encoder) and the BatchNorm running
    buffers, and the two queues (a length of 20 at B=8: the third
    enqueue clamps to column 12)."""
    params, stats = _jax_vars(kind)
    jm, tm = _jax_model(kind), _port_model(kind)
    use_queue = queue_len is not None
    tx = joptim.build_optimizer(
        params, learning_rate=joptim.cosine_warmup_schedule(1e-3, 1e-5, 1, 3,
                                                            2),
        weight_decay=0.05)
    rng = np.random.default_rng(12)
    bufs = [rng.normal(size=(HEADS["proj_dim"], queue_len or 1)).astype(
        np.float32) for _ in range(2)]
    jqueue = (tuple(jecdp.SampleQueueState(jnp.asarray(b), jnp.asarray(
        0, jnp.int32)) for b in bufs) if use_queue else None)
    jstate = JTrainState.create(
        apply_fn=jm.apply, params=jax.tree.map(jnp.copy, params),
        batch_stats=jax.tree.map(jnp.copy, stats), tx=tx, queue=jqueue,
        ema_params=jax.tree.map(jnp.copy, params["encoder"]))
    kw = dict(num_patches=NUM_PATCHES, mask_ratio=0.75, use_queue=use_queue,
              total_epochs=3.0, steps_per_epoch=2, base_ema_momentum=0.9)
    jstep = j_make_ecdp_step(jm, **kw)
    load_jax_state_dict(tm, export_torch_state_dict(params, stats))
    state = TrainState(
        tm, toptim.build_optimizer(tm, weight_decay=0.05), _schedule(),
        queue=(tuple(tecdp.SampleQueueState(torch.from_numpy(b.copy()), 0)
                     for b in bufs) if use_queue else None),
        key_encoder=make_key_encoder(tm))
    step = make_ecdp_step(tm, **kw)
    for i in range(3):
        r = np.random.default_rng(40 + i)
        s = _size(kind)
        batch = {"img_q": r.normal(size=(SB, s, s, 2)),
                 "img_k": r.normal(size=(SB, s, s, 2)),
                 "clip_emb": r.normal(size=(SB, CLIP_DIM)) * 2 + 0.3}
        batch = {k: v.astype(np.float32) for k, v in batch.items()}
        key = jax.random.key(i)
        kq, kk, _, _ = jax.random.split(key, 4)
        jstate, jmet = jstep(jstate, {k: jnp.asarray(v)
                                      for k, v in batch.items()}, key)
        tb = {k: t(v) for k, v in batch.items()}
        for view, kv in (("q", kq), ("k", kk)):
            ids, mask = _masks(kv, SB)
            tb[f"ids_keep_{view}"] = torch.from_numpy(np.array(ids)).long()
            tb[f"mask_{view}"] = t(mask)
        tmet = step(state, tb)
        for name in ("loss", "loss_image", "loss_event", "loss_kl",
                     "ema_momentum", "grad_norm"):
            assert rel_err(float(tmet[name]), float(jmet[name])) <= STEP_REL, (
                i, name)
    lr_sum = sum(_schedule()(i) for i in range(3))
    want = export_torch_state_dict(jstate.params, jstate.batch_stats)
    _hold_tree(tm.named_parameters(), want, lr_sum)
    for n, buf in tm.named_buffers():
        if n in want:
            assert rel_err(buf.numpy(), want[n]) <= STEP_REL, n
    assert sum(n in want for n, _ in tm.named_buffers()) == 20
    want_ema = export_torch_state_dict(jstate.ema_params)
    assert set(want_ema) == set(state.key_encoder.state_dict())
    _hold_tree(state.key_encoder.named_parameters(), want_ema, lr_sum)
    if use_queue:
        for got, w in zip(state.queue, jstate.queue):
            assert got.ptr == int(w.ptr) == 3 * SB % queue_len
            np.testing.assert_allclose(got.buffer.numpy(),
                                       np.asarray(w.buffer), atol=1e-5)


# ------------------------------------------------------------ pipelines


@pytest.fixture(scope="module")
def jax_native_library(tmp_path_factory):
    """JAX's C++ library, built in this process's own directory when no
    other test of the process built it."""
    if jnative._LIB is None:
        old = os.environ.get("XDG_CACHE_HOME")
        os.environ["XDG_CACHE_HOME"] = str(tmp_path_factory.mktemp("jnat"))
        try:
            jnative._get_lib()
        finally:
            if old is None:
                del os.environ["XDG_CACHE_HOME"]
            else:
                os.environ["XDG_CACHE_HOME"] = old
    assert jnative.BACKEND == "native" and tnative.BACKEND == "native"


@pytest.mark.parametrize("train", [True, False], ids=["train", "eval"])
def test_pipeline_matches_jax(train):
    """Two batches of the synthetic 2-channel grids with one CLIP token:
    both views within 1e-5 of JAX's (the view draws in its order), the
    class-token embedding equal."""
    kw = dict(n=8, size=32, num_bins=2, clip_tokens=1, seed=3)
    cfg = dict(pr_phase="ecdp", num_bins=2, input_size=32)
    jp = jpipe.EcdpPretrainPipeline(jpipe.SyntheticPretrainSource(**kw),
                                    jpipe.PretrainDataConfig(**cfg), 4,
                                    train=train, seed=5, num_workers=2)
    tp = tpipe.EcdpPretrainPipeline(tpipe.SyntheticPretrainSource(**kw),
                                    tpipe.PretrainDataConfig(**cfg), 4,
                                    train=train, seed=5, num_workers=2,
                                    device="cpu")
    n = 0
    for want, got in zip(jp, tp):
        assert set(got) == set(want) == {"img_q", "img_k", "clip_emb"}
        assert got["clip_emb"].shape == (4, 512)
        for k in got:
            np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]),
                                       atol=1e-5, err_msg=k)
        assert not np.allclose(got["img_q"].numpy(), got["img_k"].numpy())\
            or not train
        n += 1
    assert n == len(tp) == 2


@pytest.mark.parametrize("train", [True, False], ids=["train", "eval"])
def test_raw_pipeline_matches_jax(jax_native_library, train):
    """Two batches of the synthetic raw source (a 96x96 sensor, windows of
    1024 of 2048 events rescaled to 64, the C++ augment in training, K3's
    plain version on the 2-channel count image): both views within 1e-5
    of JAX's, the images equal."""
    kw = dict(n=8, hw=(96, 96), num_events=2048, seed=7)
    cfg = dict(num_bins=2, input_size=64, fix_events_num=1024)
    jp = jpipe.EcdpRawPretrainPipeline(
        jpipe.SyntheticRawPretrainSource(**kw),
        jpipe.RawPretrainDataConfig(**cfg), 4, train=train, seed=2,
        num_workers=2)
    tp = tpipe.EcdpRawPretrainPipeline(
        tpipe.SyntheticRawPretrainSource(**kw),
        tpipe.RawPretrainDataConfig(**cfg), 4, train=train, seed=2,
        num_workers=2, device="cpu")
    n = 0
    for want, got in zip(jp, tp):
        assert set(got) == set(want) == {"img_q", "img_k", "image"}
        assert got["img_q"].shape == (4, 64, 64, 2)
        np.testing.assert_array_equal(got["image"].numpy(),
                                      np.asarray(want["image"]))
        for k in ("img_q", "img_k"):
            np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]),
                                       atol=1e-5, err_msg=k)
        n += 1
    assert n == 2 and tp.batches == 2 and tp.host_seconds > 0


# --------------------------------------------------------- bridge, CLIs


def test_bridge_loads_the_model_and_the_ema_tree_strictly():
    """JAX's ECDP tree (parameters and batch statistics) loads strictly
    into ``EcdpModel``, its EMA tree into the key encoder; a missing or
    an unexpected key raises; ``finetune_state_dict`` lifts the query
    encoder to ``backbone.*``."""
    params, stats = _jax_vars("vit")
    tm = _port_model("vit")
    sd = export_torch_state_dict(params, stats)
    load_jax_state_dict(tm, sd)
    assert "encoder.backbone.tokens" in sd and "clip_emb_proj.weight" in sd
    key = make_key_encoder(tm)
    ema = export_torch_state_dict(jax.tree.map(lambda a: a * 0.5,
                                               params["encoder"]))
    load_jax_state_dict(key, ema)
    np.testing.assert_array_equal(key.backbone.tokens.detach().numpy(),
                                  ema["backbone.tokens"])
    with pytest.raises(RuntimeError):
        load_jax_state_dict(key, sd)
    with pytest.raises(RuntimeError):
        load_jax_state_dict(tm, {k: v for k, v in sd.items()
                                 if k != "encoder.backbone.tokens"})
    lifted = finetune_state_dict({k: torch.from_numpy(np.array(v))
                                  for k, v in sd.items()})
    assert "backbone.vit_block.1.mlp.fc2.weight" in lifted
    assert "event_head_proj.fc0.weight" in lifted
    assert finetune_state_dict({"backbone.x": 1}) == {"backbone.x": 1}


def _tiny_ecdp(num_bins=2, *, dtype, device, generator, input_size, **_):
    model = EcdpModel(EcdpEncoder(ViTECDP(
        **{**VIT, "input_size": input_size, "num_bins": num_bins},
        dtype=dtype, device=device), **HEADS), **HEADS, clip_emb_dim=512)
    init_weights(model, generator)
    return model


def _tiny_cls(num_classes, num_bins=2, **kw):
    kw = {**kw, **{k: v for k, v in VIT.items() if k != "num_bins"},
          "input_size": kw["input_size"]}
    return tcls.cls_hub_vit_ecdp_small(num_classes, num_bins, **kw)


def _tiny_dense(num_classes, num_bins=2, **kw):
    kw = {**kw, **{k: v for k, v in CONV.items() if k != "num_bins"},
          "input_size": kw["input_size"], "depths": (1, 1, 4),
          "out_indices": (0, 1, 2, 3)}
    return tdense.dense_hub_convvit_ecdp_small(num_classes, num_bins, **kw)


DENSE_COMMON = ["--device", "cpu", "--no-bf16", "--epochs", "1",
                "--print_freq", "2"]
COMMON = DENSE_COMMON + ["--num_workers", "0"]


@pytest.fixture(scope="module")
def ecdp_checkpoint(tmp_path_factory):
    out = tmp_path_factory.mktemp("ecdp")
    mp = pytest.MonkeyPatch()
    mp.setattr(pretrain_cli, "ecdp_model_small", _tiny_ecdp)
    try:
        state = pretrain_cli.main(
            ["--pr_phase", "ecdp-ef", "--input_size", "32", "--batch_size",
             "8", "--use_queue", "--queue_length", "20", "--output_dir",
             str(out)] + COMMON)
    finally:
        mp.undo()
    return state, str(out / "checkpoint.pth")


def test_cli_ecdp_epoch_writes_model_ema_and_queues(ecdp_checkpoint):
    """``--pr_phase ecdp-ef`` (the alias) for one epoch of the synthetic
    source: 4 steps, the key encoder moved from the query encoder's init
    but apart from its final weights, and a checkpoint holding the model,
    the EMA tree and both queues (20 keys at B=8: the third enqueue
    clamped), each loading strictly."""
    state, path = ecdp_checkpoint
    assert state.step == 4
    sd, ema = load_ecdp_checkpoint(path)
    raw = torch.load(path, weights_only=True)
    assert raw["queue_image"].shape == (HEADS["proj_dim"], 20)
    assert int(raw["queue_event_ptr"][0]) == 32 % 20
    tm = _tiny_ecdp(dtype=torch.float32, device="cpu",
                    generator=torch.Generator().manual_seed(1),
                    input_size=32)
    load_jax_state_dict(tm, sd)
    key = make_key_encoder(tm)
    load_jax_state_dict(key, ema)
    moved = [n for n, p in key.named_parameters()
             if not torch.equal(p, dict(tm.encoder.named_parameters())[n])]
    assert moved


@pytest.mark.parametrize("argv,error", [
    (["--init_from", "x.pth"], ValueError),
    (["--accum_iter", "2"], ValueError),
    (["--dataset", "n_imagenet"], SystemExit),
], ids=["init_from", "accum_iter", "n_imagenet_roots"])
def test_cli_ecdp_refuses_what_it_does_not_read(tmp_path, argv, error):
    with pytest.raises(error):
        pretrain_cli.main(["--pr_phase", "ecdp", "--output_dir",
                           str(tmp_path)] + argv + COMMON)


def test_cls_cli_finetunes_vit_ecdp_from_the_ecdp_checkpoint(
        monkeypatch, tmp_path, ecdp_checkpoint):
    """``--backbone vit_ecdp --num_bins 2 --finetune`` from the ECDP
    checkpoint: the query encoder's backbone fills the hub (its tokens
    among it), the heads go unused; two steps run."""
    _, path = ecdp_checkpoint
    monkeypatch.setattr(cls_cli, "cls_hub_vit_ecdp_small", _tiny_cls)
    res = cls_cli.main([
        "--backbone", "vit_ecdp", "--num_bins", "2", "--input_size", "32",
        "--batch_size", "64", "--fix_events_num", "500",
        "--val_fix_events_num", "500", "--finetune", path,
        "--output_dir", str(tmp_path)] + COMMON)
    assert res["state"].step == 2
    assert np.isfinite(res["val"]["loss"])
    sd, _ = load_ecdp_checkpoint(path)
    hub = _tiny_cls(2, dtype=torch.float32, device="cpu",
                    generator=torch.Generator().manual_seed(0),
                    input_size=32)
    cls_cli.load_backbone(hub, path)
    assert torch.equal(hub.backbone.tokens, sd["encoder.backbone.tokens"])


@pytest.mark.parametrize("task", ["semseg", "flow"])
def test_dense_clis_run_convvit_ecdp(monkeypatch, tmp_path, task):
    """``--backbone convvit_ecdp --num_bins 2`` trains and validates;
    ``vit_mem`` and ``swin_ecddp`` are still refused."""
    cli = semseg_cli if task == "semseg" else flow_cli
    monkeypatch.setattr(cli, "dense_hub_convvit_ecdp_small", _tiny_dense)
    res = cli.main(["--backbone", "convvit_ecdp", "--num_bins", "2",
                    "--input_size", "64", "--batch_size", "16",
                    "--fix_events_num", "1000", "--val_fix_events_num",
                    "1000", "--output_dir", str(tmp_path)] + DENSE_COMMON)
    assert res["state"].step == 2
    for argv in (["--backbone", "vit_mem"], ["--backbone", "swin_ecddp"]):
        with pytest.raises(SystemExit):
            cli.main(argv + DENSE_COMMON)
