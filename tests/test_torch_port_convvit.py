"""The port's ConvViT slice against the JAX package on the CPU.

The same numpy-seeded inputs go through the JAX function and its port: a
tiny ConvViT's masked and dense encodes, the pretrain, cls and dense hubs
carried across with ``export_torch_state_dict`` -> ``load_jax_state_dict``
(strictly), the layer ids and lr scales of every parameter of the three
full-size ConvViT hubs, three rec steps with replayed masks, one cls, one
semseg and one flow step with replayed drop-path masks (the conv blocks'
draws among them), ``--finetune`` from a rec checkpoint against JAX's
``init_backbone_from`` / ``init_variables_from``, and each CLI at tiny
widths with ``--backbone convvit`` (the semseg and flow CLIs with their
default backbone). The JAX halves run under ``jax.jit`` at f32. Every test
passes ``device="cpu"``. The tiny hubs are ``tests/_convvit_port.py``'s.
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from eventpretrain_tpu.ckpt.torch_export import (
    export_torch_state_dict,
    save_torch_checkpoint,
)
from eventpretrain_tpu.ckpt.torch_import import (
    _flax_path_to_torch_key,
    init_backbone_from,
    init_variables_from,
)
from eventpretrain_tpu.models import cls_hub as jcls_hub
from eventpretrain_tpu.models import dense_hub as jdense_hub
from eventpretrain_tpu.models import layers as jlayers
from eventpretrain_tpu.models import pretrain_hub as jpretrain_hub
from eventpretrain_tpu.models.convvit import ConvViT as JConvViT
from eventpretrain_tpu.train import optim as joptim
from eventpretrain_tpu.train.state import TrainState as JTrainState
from eventpretrain_tpu.train.steps import (
    make_cls_train_step as j_make_cls,
    make_flow_train_step as j_make_flow,
    make_rec_step as j_make_rec,
    make_semseg_train_step as j_make_semseg,
)
from eventpretrain_tpu_torch.ckpt.bridge import (
    load_jax_state_dict,
    load_torch_checkpoint,
)
from eventpretrain_tpu_torch.cli import finetune_cls as cls_cli
from eventpretrain_tpu_torch.cli import finetune_flow as flow_cli
from eventpretrain_tpu_torch.cli import finetune_semseg as semseg_cli
from eventpretrain_tpu_torch.cli import pretrain as pretrain_cli
from eventpretrain_tpu_torch.models import cls_hub as tcls_hub
from eventpretrain_tpu_torch.models import dense_hub as tdense_hub
from eventpretrain_tpu_torch.models import pretrain_hub as tpretrain_hub
from eventpretrain_tpu_torch.models.convvit import ConvViT, upsample_mask
from eventpretrain_tpu_torch.models.layers import init_weights
from eventpretrain_tpu_torch.train import optim as toptim
from eventpretrain_tpu_torch.train.state import TrainState
from eventpretrain_tpu_torch.train.steps import (
    make_cls_train_step,
    make_flow_train_step,
    make_rec_step,
    make_semseg_train_step,
)

from tests._convvit_port import (
    CFG,
    NUM_PATCHES,
    PATCH,
    SITES,
    finetune_twin,
    port_cls_hub,
    port_dense_hub,
    port_pretrain_hub,
    port_twin,
    rec_batch,
    rec_twin,
    rel_err,
    tiny_cli_hub,
    torch_batch,
)
from tests._port_threads import one_torch_thread  # noqa: F401

# f32 on both sides, sums in other orders: activations of scale ~1 within
# 1e-5; losses, gradients and parameters after a few updates within 1e-4
# of their scale
ENCODE_ATOL = 1e-5
STEP_REL = 1e-4
NUM_CLASSES = 4
LABEL_HW = (12, 20)
B = 8  # the FPN and pyramid-pooling BatchNorms see B values a channel


class _ReplayDropPath:
    """Stands in for ``eventpretrain_tpu.models.layers.drop_path``: the
    keep masks of ``masks`` (S, B) in call order, JAX's arithmetic."""

    def __init__(self, masks):
        self.masks = masks
        self.calls = 0

    def __call__(self, key, x, rate):
        keep = jnp.asarray(self.masks[self.calls]).reshape(
            (x.shape[0],) + (1,) * (x.ndim - 1))
        self.calls += 1
        return jnp.where(keep, x / (1.0 - rate), 0.0)


def _keeping_grads(tx):
    """``tx`` that also keeps the gradients it was handed in its state."""
    def init(params):
        return tx.init(params), jax.tree.map(jnp.zeros_like, params)

    def update(grads, state, params=None):
        updates, inner = tx.update(grads, state[0], params)
        return updates, (inner, grads)

    return optax.GradientTransformation(init, update)


# ------------------------------------------------------------ encodes


def test_upsample_mask_matches_jax():
    from eventpretrain_tpu.models.convvit import _upsample_mask

    mask = np.random.default_rng(0).random((3, 16)) < 0.5
    got = upsample_mask(torch.from_numpy(mask.astype(np.float32)), 4, 4)
    want = _upsample_mask(jnp.asarray(mask, jnp.float32), 4, 4)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.fixture(scope="module")
def backbone_vars():
    """A tiny ConvViT with the stage decoders and the FPN (its statistics
    away from their init) and its JAX twin, whose variables cover both
    encodes."""
    tm = ConvViT(**CFG, with_fpn=True, device="cpu")
    init_weights(tm, torch.Generator().manual_seed(0))
    jm = JConvViT(**CFG, with_fpn=True)
    b = rec_batch(0, 2)
    x = jnp.asarray(b["evg"])
    vm = port_twin(tm, jm, x, jnp.asarray(b["ids_keep"]),
                   mask=jnp.asarray(b["mask"]), method=jm.encode_masked)
    vd = port_twin(tm, jm, x, method=jm.encode_dense, return_pyramid=True)
    return jm, {"params": {**vd["params"], **vm["params"]},
                "batch_stats": vd["batch_stats"]}, tm.eval()


def test_encode_masked_matches_jax(backbone_vars):
    """The stage maps and the fused feature ``norm(s1 + s2 + s3)``, the
    conv stages gated by the upsampled mask, within 1e-5."""
    jm, v, tm = backbone_vars
    b = rec_batch(1)
    b["evg"][0, :16, :16] = 0.0  # an empty kept-or-not corner
    want = jax.jit(lambda x, i, m: jm.apply(
        v, x, i, mask=m, method=jm.encode_masked))(
            jnp.asarray(b["evg"]), jnp.asarray(b["ids_keep"]),
            jnp.asarray(b["mask"]))
    t = torch_batch(b)
    got = tm.encode_masked(t["evg"], t["ids_keep"], t["mask"])
    for g, w, name in zip(got, want, ("emb_l1", "emb_l2", "emb_lh")):
        assert g.shape == w.shape, name
        np.testing.assert_allclose(g.detach().numpy(), np.asarray(w),
                                   atol=ENCODE_ATOL, err_msg=name)
    with pytest.raises(ValueError, match="full mask"):
        tm.encode_masked(t["evg"], t["ids_keep"])


def test_encode_dense_matches_jax(backbone_vars):
    """The stage maps, the normed tokens, the 4-level pyramid (the FPN's
    BatchNorm on its running statistics) and the last block's attention,
    within 1e-5."""
    jm, v, tm = backbone_vars
    x = rec_batch(2)["evg"]
    want = jax.jit(lambda x: jm.apply(v, x, method=jm.encode_dense,
                                      return_attn=True,
                                      return_pyramid=True))(jnp.asarray(x))
    with torch.no_grad():
        got = tm.encode_dense(torch.from_numpy(x), return_attn=True,
                              return_pyramid=True)
    pairs = list(zip(got[:3], want[:3])) + list(zip(got[3], want[3])) + [
        (got[4], want[4])]
    assert len(pairs) == 8
    for i, (g, w) in enumerate(pairs):
        assert tuple(g.shape) == w.shape, i
        np.testing.assert_allclose(g.numpy(), np.asarray(w),
                                   atol=ENCODE_ATOL, err_msg=str(i))
    assert tuple(got[3][3].shape) == (3, 1, 1, 32)


# --------------------------------------------------------------- hubs


def _twin_outputs(kind):
    """(port outputs, JAX outputs) of a ConvViT hub and its JAX twin on
    the same input: the rec prediction, the cls logits with the attention
    map, the dense hub's pyramid and both heads (eval mode: the running
    statistics)."""
    if kind == "pretrain":
        hub, jhub, v = rec_twin()
        b = rec_batch(4)
        want = jax.jit(lambda e, i, r, m: jhub.apply(
            v, e, i, r, mask=m, method=jhub.forward_rec))(*(
                jnp.asarray(b[k]) for k in ("evg", "ids_keep", "ids_restore",
                                            "mask")))
        t = torch_batch(b)
        got = hub.forward_rec(t["evg"], t["ids_keep"], t["ids_restore"],
                              t["mask"])
        return got, want
    hub, jhub, v = finetune_twin(kind, NUM_CLASSES)
    x = rec_batch(5)["evg"]
    if kind == "cls":
        want = jax.jit(lambda x: jhub.apply(v, x, return_attn=True))(
            jnp.asarray(x))
        return hub.eval()(torch.from_numpy(x), return_attn=True), want
    want = jax.jit(lambda x: jhub.apply(v, x))(jnp.asarray(x))
    got = hub.eval()(torch.from_numpy(x))
    return ((got[0], *got[1], got[2], got[3]),
            (want[0], *want[1], want[2], want[3]))


@pytest.mark.parametrize("kind", ["pretrain", "cls", "dense"])
def test_hub_outputs_match_jax(kind):
    """Each ConvViT hub against its JAX twin (the same weights): every
    output within 1e-5 of its scale."""
    got, want = _twin_outputs(kind)
    assert len(got) == len(want) == {"pretrain": 4, "cls": 3,
                                     "dense": 7}[kind]
    for i, (g, w) in enumerate(zip(got, want)):
        g, w = g.detach().numpy(), np.asarray(w)
        assert g.shape == w.shape, i
        assert rel_err(g, w) <= ENCODE_ATOL, (i, rel_err(g, w))


@pytest.mark.parametrize("kind", ["pretrain", "cls", "dense"])
def test_weight_bridge_is_strict(kind):
    """The exporter's state dict of each JAX hub loads strictly into a
    fresh port hub and gives back the weights it came from: every key,
    the depthwise kernels as OIHW (C, 1, 5, 5), the FPN BatchNorm's
    running statistics; a key left out or one too many raises."""
    if kind == "pretrain":
        hub, _, v = rec_twin()
        fresh = port_pretrain_hub()
    else:
        hub, _, v = finetune_twin(kind, NUM_CLASSES)
        fresh = (port_cls_hub if kind == "cls" else port_dense_hub)(
            NUM_CLASSES, generator=torch.Generator().manual_seed(9))
    sd = export_torch_state_dict(v["params"], v.get("batch_stats"))
    assert sd["backbone.conv_block2.1.attn.weight"].shape == (24, 1, 5, 5)
    assert ("backbone.stage1_output_decode.weight" in sd) == (
        kind == "pretrain")
    assert ("backbone.fpn.1.running_var" in sd) == (kind == "dense")
    load_jax_state_dict(fresh, sd)
    for k, t in hub.state_dict().items():
        np.testing.assert_array_equal(fresh.state_dict()[k].numpy(),
                                      t.numpy(), err_msg=k)
    key = sorted(sd)[len(sd) // 2]
    with pytest.raises(RuntimeError, match="Missing key"):
        load_jax_state_dict(fresh, {k: a for k, a in sd.items() if k != key})
    with pytest.raises(RuntimeError, match="Unexpected key"):
        load_jax_state_dict(fresh, {**sd, "backbone.fpn.2.weight":
                                    np.zeros(3, np.float32)})


# --------------------------------------------------------- layer ids


_FULL = {}


def _full_hubs(kind):
    """(the parameter tree of JAX's full-size ConvViT-B hub of ``kind`` by
    shape only, the port's hub's parameter names), once a kind."""
    if kind not in _FULL:
        _FULL[kind] = (_jax_full_tree(kind), [
            n for n, _ in _port_full_hub(kind).named_parameters()])
    return _FULL[kind]


def _jax_full_tree(kind):
    """The parameter tree of JAX's full-size ConvViT-B hub of ``kind``,
    by shape only."""
    x = jnp.zeros((1, 224, 224, 5))
    if kind == "pretrain":
        hub = jpretrain_hub.pretrain_hub_convvit_base()
        fn = lambda k: hub.init(k, x, jnp.arange(49)[None],  # noqa: E731
                                jnp.arange(196)[None],
                                mask=jnp.zeros((1, 196)),
                                method=hub.forward_rec)
    elif kind == "cls":
        hub = jcls_hub.cls_hub_convvit_base(NUM_CLASSES)
        fn = lambda k: hub.init(k, x)  # noqa: E731
    else:
        hub = jdense_hub.dense_hub_convvit_base(NUM_CLASSES)
        fn = lambda k: hub.init(k, x)  # noqa: E731
    return jax.eval_shape(fn, jax.random.key(0))["params"]


def _port_full_hub(kind):
    make = {"pretrain": lambda: tpretrain_hub.pretrain_hub_convvit_base(
                device="meta"),
            "cls": lambda: tcls_hub.cls_hub_convvit_base(NUM_CLASSES,
                                                         device="meta"),
            "dense": lambda: tdense_hub.dense_hub_convvit_base(
                NUM_CLASSES, device="meta")}
    return make[kind]()


@pytest.mark.parametrize("grafted", [False, True], ids=["decay", "grafted"])
@pytest.mark.parametrize("kind", ["pretrain", "cls", "dense"])
def test_layer_ids_and_scales_match_jax(kind, grafted):
    """Every parameter of the full-size ConvViT-B hubs (13 layer ids, as
    the CLIs set them): the port's id and lr scale of its torch name equal
    JAX's ``vit_layer_id(..., "convvit")`` and ``layer_scale_tree`` of the
    flax path the exporter maps to that name; both hubs hold the same
    names."""
    tree, names = _full_hubs(kind)
    scales = joptim.layer_scale_tree(tree, 13, 0.75, "convvit", grafted)
    want_id, want_scale = {}, {}

    def visit(path, leaf):
        names = [getattr(p, "key", str(p)) for p in path]
        key = _flax_path_to_torch_key(names)[0]
        want_id[key] = joptim.vit_layer_id(names, 13, "convvit", grafted)
        return leaf

    jax.tree_util.tree_map_with_path(visit, tree)
    jax.tree_util.tree_map_with_path(
        lambda path, s: want_scale.__setitem__(_flax_path_to_torch_key(
            [getattr(p, "key", str(p)) for p in path])[0], s), scales)
    assert set(names) == set(want_id)
    got_scale = toptim.layer_scales(names, 13, 0.75, "convvit", grafted)
    for n in names:
        assert toptim.vit_layer_id(n, 13, "convvit", grafted) == \
            want_id[n], n
        assert got_scale[n] == pytest.approx(want_scale[n], rel=1e-12), n
    ids = {toptim.vit_layer_id(n, 13, "convvit", grafted) for n in names}
    assert ids == ({0, 1, 2} if grafted else set(range(14)))


# ------------------------------------------------------------- steps


def _schedule():
    return (1e-3, 1e-5, 1, 3, 2)  # update 0 at lr 0, then warm, then cosine


def test_f32_rec_trajectory_matches_jax():
    """3 make_rec_step updates of the tiny ConvViT hub from the same init
    with the same replayed masks (the conv stages gated by them), layer
    decay over 13 ids: loss and grad norm at each step and the final
    parameters within 1e-4 of scale."""
    hub, jhub, v = rec_twin()
    sched = joptim.cosine_warmup_schedule(*_schedule())
    tx = joptim.build_optimizer(v["params"], learning_rate=sched,
                                weight_decay=0.05, layer_decay=0.75,
                                num_layers=13, backbone_type="convvit")
    jstate = JTrainState.create(apply_fn=jhub.apply, params=v["params"],
                                tx=tx)
    jstep = j_make_rec(jhub, patch_size=PATCH, num_patches=NUM_PATCHES)
    state = TrainState(hub, toptim.build_optimizer(
        hub, weight_decay=0.05, layer_decay=0.75, num_layers=13,
        backbone_type="convvit"), toptim.cosine_warmup_schedule(*_schedule()))
    step = make_rec_step(hub, patch_size=PATCH, num_patches=NUM_PATCHES)
    for i in range(3):
        b = rec_batch(10 + i)
        jstate, jm = jstep(jstate, {k: jnp.asarray(x) for k, x in b.items()},
                           jax.random.key(i))
        tm = step(state, torch_batch(b))
        for k in ("loss", "grad_norm"):
            np.testing.assert_allclose(float(tm[k]), float(jm[k]),
                                       rtol=STEP_REL, err_msg=f"{i} {k}")
    want = export_torch_state_dict(jstate.params)
    lr_sum = sum(sched(i) for i in range(3))
    for n, p in hub.named_parameters():
        got, w = p.detach().numpy().copy(), want[n].copy()
        if n.endswith("attn.qkv.bias"):
            # softmax ignores the key bias: its gradient is rounding, which
            # Adam scales to a step; hold that slice to the steps' size
            c = got.shape[0] // 3
            assert np.abs(got[c:2 * c] - w[c:2 * c]).max() <= 2 * lr_sum, n
            got[c:2 * c] = w[c:2 * c] = 0.0
        assert rel_err(got, w) <= STEP_REL, n


def _finetune_batch(kind, seed):
    rng = np.random.default_rng(seed)
    side = CFG["input_size"]
    b = {"evg": rng.normal(size=(B, side, side, 5)).astype(np.float32),
         "keep": rng.random((SITES, B)) < 0.8}
    if kind == "cls":
        b["label"] = rng.integers(0, NUM_CLASSES, B).astype(np.int32)
    elif kind == "semseg":
        b["label"] = rng.integers(0, NUM_CLASSES,
                                  (B,) + LABEL_HW).astype(np.int32)
    else:
        b["flow"] = rng.normal(size=(B,) + LABEL_HW + (2,)).astype(
            np.float32) * 3
        b["valid"] = (rng.random((B,) + LABEL_HW) < 0.8).astype(np.float32)
    return b


def _jax_finetune_step(kind, jhub, nc):
    return {"cls": lambda: j_make_cls(jhub),
            "semseg": lambda: j_make_semseg(jhub, num_classes=nc),
            "flow": lambda: j_make_flow(jhub)}[kind]()


# The dense steps' gradients are ill-conditioned at these sizes (ReLU
# gates and BatchNorms over few values): when the input moves by 1e-7 of
# itself, JAX's own gradient of a small tensor (a lateral conv of the
# head) moves by several percent of that tensor's scale. So a dense step's
# gradients are held against the step's largest gradient, each within
# 2e-4 of it; the cls step's each within 1e-4 of its own tensor's scale.
DENSE_GRAD_REL = 2e-4


@pytest.mark.parametrize("kind", ["cls", "semseg", "flow"])
def test_f32_finetune_step_matches_jax(monkeypatch, kind):
    """One train step of each finetune task on the tiny ConvViT hub at f32
    with drop-path 0.1, its 10 keep masks replayed on both sides in JAX's
    order (the conv blocks' first), and the CLI's AdamW with layer decay
    over 13 ids: the metrics within 1e-4 of the loss's scale, every
    gradient (see above), and every BatchNorm's running statistics (the
    FPN's among them) within 1e-4."""
    nc = 2 if kind == "flow" else NUM_CLASSES
    hub, jhub, v = finetune_twin("cls" if kind == "cls" else "dense", nc,
                                 drop_path_rate=0.1)
    b = _finetune_batch(kind, 20)
    replay = _ReplayDropPath(b["keep"])
    monkeypatch.setattr(jlayers, "drop_path", replay)
    sched = (1e-3, 1e-6, 0, 10, 2)
    tx = _keeping_grads(joptim.build_optimizer(
        v["params"], learning_rate=joptim.cosine_warmup_schedule(*sched),
        weight_decay=0.05, betas=(0.9, 0.999), layer_decay=0.75,
        num_layers=13, backbone_type="convvit", clip_grad=5.0))
    jstate = JTrainState.create(apply_fn=jhub.apply, params=v["params"],
                                batch_stats=v.get("batch_stats", {}), tx=tx)
    jnew, jm = _jax_finetune_step(kind, jhub, nc)(
        jstate, {k: jnp.asarray(x) for k, x in b.items() if k != "keep"},
        jax.random.key(0))
    assert replay.calls == SITES

    state = TrainState(hub, toptim.build_optimizer(
        hub, weight_decay=0.05, betas=(0.9, 0.999), layer_decay=0.75,
        num_layers=13, backbone_type="convvit"),
        toptim.cosine_warmup_schedule(*sched), clip_grad=5.0)
    grads = {}
    apply = state.apply_gradients

    def capture():
        grads.update({k: p.grad.clone() for k, p in hub.named_parameters()
                      if p.grad is not None})
        return apply()

    monkeypatch.setattr(state, "apply_gradients", capture)
    step = {"cls": lambda: make_cls_train_step(hub),
            "semseg": lambda: make_semseg_train_step(hub, num_classes=nc),
            "flow": lambda: make_flow_train_step(hub)}[kind]()
    tb = torch_batch(b)
    if kind == "semseg":
        tb["label"] = torch.from_numpy(b["label"])
    tm = step(state, tb)
    assert set(tm) == set(jm)
    scale = max(abs(float(jm["loss"])), 1.0)
    for k in tm:
        if k != "grad_norm":
            assert abs(float(tm[k]) - float(jm[k])) <= STEP_REL * scale, k
    np.testing.assert_allclose(float(tm["grad_norm"]), float(jm["grad_norm"]),
                               rtol=STEP_REL)
    want_g = export_torch_state_dict(jnew.opt_state[1])
    assert set(grads) == set(want_g)
    top = max(np.abs(g).max() for g in want_g.values())
    for k, g in grads.items():
        if kind == "cls":
            assert rel_err(g.numpy(), want_g[k]) <= STEP_REL, k
        else:
            assert np.abs(g.numpy() - want_g[k]).max() <= (
                DENSE_GRAD_REL * top), k
    if kind != "cls":
        want = export_torch_state_dict(jnew.params, jnew.batch_stats)
        stats = [k for k in hub.state_dict() if "running_" in k]
        assert "backbone.fpn.1.running_mean" in stats
        for k in stats:
            got = hub.state_dict()[k].numpy()
            assert rel_err(got, want[k]) <= STEP_REL, k
    assert state.step == 1


# ---------------------------------------------------- --finetune


@pytest.fixture(scope="module")
def rec_checkpoint(tmp_path_factory):
    """A JAX rec checkpoint of the tiny ConvViT hub (backbone with its
    stage decoders, the MAE decoder)."""
    path = str(tmp_path_factory.mktemp("rec") / "rec.pth")
    return save_torch_checkpoint(path, rec_twin(seed=7)[2]["params"])


def test_finetune_from_a_rec_checkpoint_as_jax(rec_checkpoint):
    """cls: the backbone from the rec checkpoint, its stage decoders and
    the MAE decoder unused, the head at its init, as JAX's
    ``init_backbone_from(strict_backbone=True)``. dense: the rec
    checkpoint lacks the FPN, so both raise ``KeyError``; from a dense
    checkpoint both fill the whole hub, statistics included, as
    ``init_variables_from``."""
    hub, _, v = finetune_twin("cls", NUM_CLASSES, seed=1)
    want = export_torch_state_dict(init_backbone_from(
        rec_checkpoint, v["params"], strict_backbone=True))
    cls_cli.load_backbone(hub, rec_checkpoint)
    for k, t in hub.state_dict().items():
        np.testing.assert_array_equal(t.numpy(), want[k], err_msg=k)
    rec = load_torch_checkpoint(rec_checkpoint)
    assert torch.equal(hub.state_dict()["backbone.norm_layer.weight"],
                       rec["backbone.norm_layer.weight"])

    hub, _, dv = finetune_twin("dense", NUM_CLASSES, seed=2)
    with pytest.raises(KeyError, match="fpn"):
        init_variables_from(rec_checkpoint, dict(dv), strict_backbone=True)
    with pytest.raises(KeyError, match="fpn"):
        semseg_cli.load_finetune(hub, rec_checkpoint)

    dense_path = rec_checkpoint.replace("rec.pth", "dense.pth")
    dv2 = finetune_twin("dense", NUM_CLASSES, seed=3)[2]
    save_torch_checkpoint(dense_path, dv2["params"], dv2["batch_stats"])
    want = init_variables_from(dense_path, dict(dv), strict_backbone=True)
    want = export_torch_state_dict(want["params"], want["batch_stats"])
    semseg_cli.load_finetune(hub, dense_path)
    for k, t in hub.state_dict().items():
        np.testing.assert_array_equal(t.numpy(), want[k], err_msg=k)


# ---------------------------------------------------------------- CLIs


def _cls_tiny(num_classes, num_bins=5, **kw):
    kw.update(CFG, input_size=kw["input_size"])
    return tcls_hub.cls_hub_convvit_small(num_classes, num_bins, **kw)


def _dense_tiny(num_classes, num_bins=5, **kw):
    kw.update(CFG, input_size=kw["input_size"])
    return tdense_hub.dense_hub_convvit_small(num_classes, num_bins, **kw)


def test_pretrain_cli_rec_and_con_with_convvit(monkeypatch, tmp_path):
    """``--backbone convvit``: rec at 64x64 writes a checkpoint with the
    stage decoders; con at 224 (CLIP's 196 tokens) chains from it through
    ``--init_from``, the backbone's weights carried over."""
    monkeypatch.setattr(pretrain_cli, "pretrain_hub_convvit_small",
                        tiny_cli_hub)
    common = ["--device", "cpu", "--no-bf16", "--backbone", "convvit",
              "--batch_size", "8", "--epochs", "1", "--num_workers", "0",
              "--print_freq", "2"]
    state = pretrain_cli.main(["--pr_phase", "rec", "--input_size", "64",
                               "--output_dir", str(tmp_path / "rec")]
                              + common)
    assert state.step == 4  # 32 synthetic samples / 8
    sd = load_torch_checkpoint(str(tmp_path / "rec" / "checkpoint.pth"))
    assert "backbone.stage2_output_decode.weight" in sd
    assert "backbone.conv_block1.1.attn.weight" in sd
    state = pretrain_cli.main(common + [
        "--pr_phase", "con", "--input_size", "224", "--init_from",
        str(tmp_path / "rec" / "checkpoint.pth"), "--epochs", "0",
        "--output_dir", str(tmp_path / "con")])
    got = state.module.state_dict()
    assert "backbone.stage1_output_decode.weight" not in got
    for k in ("backbone.conv_block2.0.attn.weight",
              "backbone.vit_block.1.mlp.fc1.weight"):
        assert torch.equal(got[k], sd[k]), k
    state = pretrain_cli.main(["--pr_phase", "con", "--input_size", "224",
                               "--output_dir", str(tmp_path / "con")]
                              + common)
    assert state.step == 4


def test_cls_cli_with_convvit_finetunes_from_a_rec_checkpoint(
        monkeypatch, tmp_path, rec_checkpoint):
    monkeypatch.setattr(cls_cli, "cls_hub_convvit_small", _cls_tiny)
    res = cls_cli.main([
        "--device", "cpu", "--no-bf16", "--backbone", "convvit",
        "--input_size", "64", "--batch_size", "32", "--epochs", "1",
        "--num_workers", "0", "--fix_events_num", "1000",
        "--val_fix_events_num", "1000", "--num_classes", "2",
        "--finetune", rec_checkpoint, "--output_dir", str(tmp_path)])
    assert res["state"].step == 4  # 128 synthetic samples / 32
    assert set(res["val"]) >= {"loss", "acc1"}
    assert np.isfinite(res["val"]["loss"])


@pytest.mark.parametrize("task", ["semseg", "flow"])
def test_dense_clis_run_with_their_default_backbone(monkeypatch, tmp_path,
                                                    task):
    """No ``--backbone`` flag: the JAX CLIs' default, convvit, trains,
    validates and writes a checkpoint with the FPN's statistics."""
    cli = semseg_cli if task == "semseg" else flow_cli
    assert cli.build_parser().parse_args([]).backbone == "convvit"
    monkeypatch.setattr(cli, "dense_hub_convvit_small", _dense_tiny)
    res = cli.main(["--device", "cpu", "--no-bf16", "--input_size", "64",
                    "--batch_size", "16", "--epochs", "1",
                    "--fix_events_num", "1000", "--val_fix_events_num",
                    "1000", "--print_freq", "1", "--output_dir",
                    str(tmp_path)])
    assert res["state"].step == 2  # 32 synthetic samples / 16
    sd = load_torch_checkpoint(str(tmp_path / "checkpoint.pth"))
    assert "backbone.fpn.1.running_var" in sd
    assert "backbone.conv_block1.0.attn.weight" in sd
