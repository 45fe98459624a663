"""The port's Swin-ECDDP against the JAX package on the CPU.

The same numpy-seeded inputs go through JAX's ``SwinECDDP`` and the
port's at a tiny size: 64 px of 5 bins, patch 4, so stages at 16^2, 8^2,
4^2 and 2^2 tokens, window 2 (so, as at Swin-T's stage 4, the last
stage's window covers its map and only the unclamped plan shifts it),
depths (2, 2, 2, 2), widths (16, 32, 64, 128). Every weight is drawn at
random (``tests/_finetune_twin.py``) and carried through
``export_torch_state_dict`` -> ``load_jax_state_dict``: ``encode_dense``
in f32 (two draws) and bf16, the unclamped shift (a
clamped plan gives another encode), Swin-T and Swin-ECDDP in one process
each equal to JAX's, the mmseg key space of the full-size backbone, the
cls and dense hubs, the layer scales and decay masks of the full-size
hubs name by name, 3-step f32 cls and semseg trajectories with replayed
drop-path masks (the dense heads ``HEAD_WIDTH`` wide), and the three
finetune CLIs with ``--backbone swin_ecddp`` (their hub arguments against
JAX's). The JAX halves run under ``jax.jit``.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from eventpretrain_tpu.cli import finetune_cls as jcls_cli
from eventpretrain_tpu.cli import finetune_flow as jflow_cli
from eventpretrain_tpu.ckpt.torch_import import _flax_path_to_torch_key
from eventpretrain_tpu.models import cls_hub as jcls_hub
from eventpretrain_tpu.models import dense_hub as jdense_hub
from eventpretrain_tpu.models import swin as jswin
from eventpretrain_tpu.models import swin_ecddp as jecddp
from eventpretrain_tpu_torch.cli import finetune_cls as cls_cli
from eventpretrain_tpu_torch.cli import finetune_flow as flow_cli
from eventpretrain_tpu_torch.cli import finetune_semseg as semseg_cli
from eventpretrain_tpu_torch.models import cls_hub as tcls_hub
from eventpretrain_tpu_torch.models import dense_hub as tdense_hub
from eventpretrain_tpu_torch.models import swin as tswin
from eventpretrain_tpu_torch.models import swin_ecddp as tecddp

from tests._finetune_twin import (
    BF16_REL,
    ENCODE_REL,
    check_layer_decay,
    cls_trajectory,
    narrow_heads,
    random_twin,
    rel_err,
    semseg_trajectory,
    t,
)
from tests._port_threads import one_torch_thread  # noqa: F401

CFG = dict(input_size=64, patch_size=4, embed_dims=(16, 32, 64, 128),
           depths=(2, 2, 2, 2), num_heads=(2, 2, 4, 4), window_size=2)
# the hubs' backbone: one block a stage but the last's two (its second
# the shifted one), fewer ops for JAX to compile in the steps
HUB_CFG = {**CFG, "depths": (1, 1, 1, 2)}
WIDTHS = CFG["embed_dims"]
NUM_CLASSES = 4
B = 8
# drop-path 0.1 over the hubs' 5 blocks: the first block's rate is 0, so 4
# blocks draw twice a step
SITES = 8
LABEL_HW = (12, 20)


def _x(seed, b=2):
    return np.random.default_rng(seed).normal(
        size=(b, 64, 64, 5)).astype(np.float32)


def _twin(seed=0):
    m = tecddp.SwinECDDP(**CFG, device="cpu").eval()
    jm = jecddp.SwinECDDP(**CFG)
    v = random_twin(m, jm, jnp.zeros((1, 64, 64, 5)), seed=seed,
                    method=jm.encode_dense)
    return m, jm, v


_ENCODERS = {}


def _jax_encode(jm, v, x, dtype=jnp.float32):
    """JAX's encode with the pyramid, compiled once for each dtype of
    ``CFG``."""
    key = jnp.dtype(dtype).name
    if key not in _ENCODERS:
        jm = jm.clone(dtype=dtype)
        _ENCODERS[key] = jax.jit(lambda v, x: jm.apply(
            v, x, return_pyramid=True, method=jm.encode_dense))
    return _ENCODERS[key](v, jnp.asarray(x))


def _flat(out):
    return [out[0], out[1], out[2], *out[3]]


@pytest.mark.parametrize("seed", [1, 9])
def test_encode_dense_matches_jax(seed):
    """The norm0/norm1-applied stage 1 and 2 tokens, the norm3-applied
    stage-4 tokens and the four normed pyramid maps within 1e-5 of their
    scale; no attention map."""
    m, jm, v = _twin(seed=seed)
    x = _x(seed + 1)
    want = _jax_encode(jm, v, x)
    with torch.no_grad():
        got = m.encode_dense(t(x), return_pyramid=True)
    assert got[4] is None and want[4] is None
    assert [tuple(o.shape) for o in got[3]] == [
        (2, 16, 16, 16), (2, 8, 8, 32), (2, 4, 4, 64), (2, 2, 2, 128)]
    for g, w in zip(_flat(got), _flat(want)):
        assert rel_err(g.numpy(), w) <= ENCODE_REL


def test_bf16_encode_matches_jax():
    """bf16 on both sides: every output within 2e-2 of its scale."""
    m, jm, v = _twin(seed=2)
    m16 = tecddp.SwinECDDP(**CFG, dtype=torch.bfloat16, device="cpu").eval()
    m16.load_state_dict(m.state_dict())
    x = _x(3)
    want = _jax_encode(jm, v, x, jnp.bfloat16)
    with torch.no_grad():
        got = m16.encode_dense(t(x), return_pyramid=True)
    for g, w in zip(_flat(got), _flat(want)):
        assert g.dtype == torch.bfloat16
        assert rel_err(g.float().numpy(), np.asarray(w, np.float32)) \
            <= BF16_REL


def test_stage_4_shift_is_not_clamped(monkeypatch):
    """The last stage's window covers its 2x2 map: the pretrain Swin's
    clamped plan does not shift its second block, ECDDP's does (mmseg's
    quadrant masking). The port's encode equals JAX's; the same weights
    under the clamped plans give a stage-4 output more than 1e-2 of its
    scale away, so the test tells the two apart. The two plan sets are
    cached apart."""
    m, jm, v = _twin(seed=3)
    x = _x(4)
    want = _jax_encode(jm, v, x)
    with torch.no_grad():
        got = m.encode_dense(t(x), return_pyramid=True)
    assert rel_err(got[2].numpy(), want[2]) <= ENCODE_REL
    geometry = (torch.device("cpu"), (16, 16), 4, 2, 7)
    clamped = tswin.dense_plans(*geometry)
    unclamped = tswin.dense_plans(*geometry, clamp_shift=False)
    assert clamped is not unclamped
    assert clamped[3].plan_odd is clamped[3].plan_even
    assert unclamped[3].plan_odd is not unclamped[3].plan_even
    monkeypatch.setattr(tecddp, "dense_plans",
                        lambda *a, clamp_shift: tswin.dense_plans(*a))
    with torch.no_grad():
        other = m.encode_dense(t(x), return_pyramid=True)
    assert rel_err(other[2].numpy(), want[2]) > 1e-2
    for i in range(3):  # stages 1-3 shift their odd blocks either way
        assert rel_err(other[3][i].numpy(), want[3][i]) <= ENCODE_REL


def test_swin_t_and_swin_ecddp_in_one_process():
    """A Swin-T of the same geometry (whose dense plans clamp) and the
    ECDDP Swin, run in turns in one process, each equal to JAX's: each
    finds its own plans in the cache."""
    m, jm, v = _twin(seed=4)
    sw = tswin.SparseSwin(**CFG, with_rec_decoders=False,
                          device="cpu").eval()
    jsw = jswin.SparseSwin(**CFG, with_rec_decoders=False)
    sv = random_twin(sw, jsw, jnp.zeros((1, 64, 64, 5)), seed=5,
                     method=jsw.encode_dense)
    x = _x(5)
    want_sw = jax.jit(lambda v, x: jsw.apply(
        v, x, method=jsw.encode_dense))(sv, jnp.asarray(x))[2]
    want_m = _jax_encode(jm, v, x)[2]
    with torch.no_grad():
        for _ in range(2):
            got_sw = sw.encode_dense(t(x))[2]
            got_m = m.encode_dense(t(x))[2]
            assert rel_err(got_sw.numpy(), want_sw) <= ENCODE_REL
            assert rel_err(got_m.numpy(), want_m) <= ENCODE_REL


@functools.cache
def _full_size_tree(kind):
    """The parameter shapes of JAX's Swin-ECDDP-T hub of ``kind`` at 224
    px, traced once."""
    jmake = getattr(jcls_hub if kind == "cls" else jdense_hub,
                    f"{kind}_hub_swin_ecddp_tiny")
    jhub = jmake(NUM_CLASSES)
    return jax.eval_shape(
        lambda k: jhub.init(k, jnp.zeros((1, 224, 224, 5))),
        jax.random.key(0))["params"]


def test_full_size_key_space_is_mmseg_s():
    """Swin-ECDDP-T's parameter names and shapes are those JAX's exporter
    writes (``layers.S.blocks.B``, ``layers.S.downsample`` with stage 0's
    merge norm 384 wide, ``norm0``-``norm3``, no ``norm_layer``), so a
    reference file loads strictly."""
    tree = _full_size_tree("cls")["backbone"]
    want = {}

    def visit(path, leaf):
        key, kind = _flax_path_to_torch_key(
            [getattr(p, "key", str(p)) for p in path])
        shape = leaf.shape
        if kind == "linear" and len(shape) == 2:
            shape = shape[::-1]
        elif kind == "linear" and len(shape) == 4:
            shape = (shape[3], shape[2], shape[0], shape[1])
        want[key] = tuple(shape)
        return leaf

    jax.tree_util.tree_map_with_path(visit, tree)
    m = tecddp.swin_ecddp_tiny_window7(device="meta")
    got = {k: tuple(v.shape) for k, v in m.state_dict().items()}
    assert got == want
    assert got["layers.0.downsample.norm.weight"] == (384,)
    assert "norm3.weight" in got and not any("norm_layer" in k for k in got)
    assert len([k for k in got if k.startswith("layers.2.blocks.")]) == 6 * 13


# ---------------------------------------------------------------- hubs


def _jax_hub(kind, heads, **kw):
    backbone = jecddp.SwinECDDP(**HUB_CFG, **kw, name="backbone")
    if kind == "cls":
        return jcls_hub.FtClsHub(backbone=backbone, num_classes=NUM_CLASSES)
    return jdense_hub.FtDenseHub(backbone=backbone, num_classes=NUM_CLASSES,
                                 decode_in_channels=WIDTHS,
                                 decode_dropout=0.0, **heads)


def _port_hub(kind, **kw):
    if kind == "cls":
        return tcls_hub.cls_hub_swin_ecddp_tiny(NUM_CLASSES, device="cpu",
                                                **HUB_CFG, **kw)
    return tdense_hub.dense_hub_swin_ecddp_tiny(
        NUM_CLASSES, device="cpu", decode_dropout=0.0, **HUB_CFG, **kw)


def _hub_twin(kind, monkeypatch, seed=0, **kw):
    """The tiny hubs of ``kind`` at drop-path 0.1, the dense heads
    narrowed by ``narrow_heads``."""
    heads = narrow_heads(monkeypatch) if kind == "dense" else {}
    kw = {"drop_path_rate": 0.1, **kw}
    hub, jhub = _port_hub(kind, **kw), _jax_hub(kind, heads, **kw)
    return hub, jhub, random_twin(hub, jhub, jnp.zeros((1, 64, 64, 5)),
                                  seed=seed)


@pytest.mark.parametrize("kind", ["cls", "dense"])
def test_hub_outputs_match_jax(monkeypatch, kind):
    """The cls hub's stage-4 tokens and logits (the mean of the normed
    tokens); the dense hub's tokens, pyramid, decode and auxiliary
    logits; each within 1e-5 of its scale. The hubs find their device
    without a ``norm_layer``. Evaluation draws no drop-path."""
    hub, jhub, v = _hub_twin(kind, monkeypatch)
    x = _x(6)
    want = jax.jit(lambda x: jhub.apply(v, x))(jnp.asarray(x))
    with torch.no_grad():
        got = hub.eval()(t(x))
    if kind == "cls":
        got, want = got[:2], want[:2]
    else:
        got, want = (got[0], *got[1], *got[2:]), (want[0], *want[1],
                                                   *want[2:])
        assert got[-2].shape == (2, 16, 16, NUM_CLASSES)
    for g, w in zip(got, want):
        assert rel_err(g.numpy(), w) <= ENCODE_REL


@pytest.mark.parametrize("kind", ["cls", "dense"])
def test_layer_scales_and_decay_masks_match_jax(kind):
    """Every parameter of the full-size Swin-ECDDP-T hubs (12 layer ids,
    as the CLIs set them): its lr scale and weight-decay flag equal JAX's
    for the flax path the exporter maps to its name. JAX reads
    ``('backbone', 'backbone_swin', ...)`` and ``('backbone', 'norm0',
    ...)``, which no rule matches, so every parameter is at layer 12,
    the patch embed too; the bias tables decay (ndim >= 2)."""
    tree = _full_size_tree(kind)
    tmake = getattr(tcls_hub if kind == "cls" else tdense_hub,
                    f"{kind}_hub_swin_ecddp_tiny")
    hub = tmake(NUM_CLASSES, device="meta")
    assert check_layer_decay(tree, hub, 12, "swin_ecddp") == {12}


# --------------------------------------------------------------- steps


def test_f32_cls_trajectory_matches_jax(monkeypatch):
    """3 make_cls_train_step updates of the tiny Swin-ECDDP cls hub with
    drop-path 0.1 (8 replayed masks a step), label smoothing 0.1, the
    clip at 5 and layer decay 0.75: loss, grad norm and accuracy at each
    step and every parameter after them within 1e-4 of JAX's."""
    hub, jhub, v = _hub_twin("cls", monkeypatch, seed=7)
    rng = np.random.default_rng(40)
    batches = [{"evg": rng.normal(size=(B, 64, 64, 5)).astype(np.float32),
                "label": rng.integers(0, NUM_CLASSES, B).astype(np.int32),
                "keep": rng.random((SITES, B)) < 0.8} for _ in range(3)]
    cls_trajectory(monkeypatch, hub, jhub, v, batches, sites=SITES,
                   backbone_type="swin_ecddp")


def test_f32_semseg_trajectory_matches_jax(monkeypatch):
    """3 make_semseg_train_step updates of the tiny Swin-ECDDP dense hub
    (batches of 8; the same 8 drop-path masks each step), the CLI's
    optimizer: the losses at each step within 1e-4 and every parameter
    and BatchNorm statistic after them as ``semseg_trajectory`` holds
    them."""
    hub, jhub, v = _hub_twin("dense", monkeypatch, seed=8)
    rng = np.random.default_rng(41)
    batches = [{"evg": rng.normal(size=(B, 64, 64, 5)).astype(np.float32),
                "label": rng.integers(0, NUM_CLASSES, (B,) + LABEL_HW)
                .astype(np.int32)} for _ in range(3)]
    semseg_trajectory(monkeypatch, hub, jhub, v, batches,
                      rng.random((SITES, B)) < 0.8, num_classes=NUM_CLASSES,
                      backbone_type="swin_ecddp")


# ---------------------------------------------------------------- CLIs


class _Stop(Exception):
    pass


def _capture(into: dict):
    def fn(*args, **kw):
        into["hub"] = (args, kw)
        raise _Stop
    return fn


def _tiny(make):
    def fn(num_classes, num_bins=5, **kw):
        return make(num_classes, num_bins, **{
            **kw, **{k: v for k, v in HUB_CFG.items()
                     if k != "input_size"}})
    return fn


@pytest.mark.parametrize("task", ["cls", "semseg", "flow"])
def test_clis_run_swin_ecddp(monkeypatch, tmp_path, task):
    """Each finetune CLI trains and validates ``--backbone swin_ecddp`` on
    the CPU (the hubs' tiny twin of Swin-ECDDP-T at 32 px: stages at 8^2,
    4^2, 2^2 and 1 token; the dense heads narrowed by ``narrow_heads``)
    and writes a checkpoint the hub loads strictly."""
    common = ["--device", "cpu", "--no-bf16", "--backbone", "swin_ecddp",
              "--model_size", "base", "--input_size", "32", "--epochs", "1",
              "--print_freq", "1", "--output_dir", str(tmp_path)]
    if task == "cls":
        monkeypatch.setattr(cls_cli, "cls_hub_swin_ecddp_tiny",
                            _tiny(tcls_hub.cls_hub_swin_ecddp_tiny))
        res = cls_cli.main(common + [
            "--batch_size", "64", "--num_workers", "0", "--fix_events_num",
            "500", "--val_fix_events_num", "500"])
        assert res["state"].step == 2 and 0 <= res["best_acc1"] <= 100
    else:
        cli = semseg_cli if task == "semseg" else flow_cli
        narrow_heads(monkeypatch)
        monkeypatch.setattr(cli, "dense_hub_swin_ecddp_tiny",
                            _tiny(tdense_hub.dense_hub_swin_ecddp_tiny))
        res = cli.main(common + [
            "--batch_size", "16", "--fix_events_num", "500",
            "--val_fix_events_num", "500"])
        assert res["state"].step == 2
    sd = torch.load(tmp_path / "checkpoint.pth", weights_only=True)["model"]
    assert "backbone.norm3.weight" in sd
    assert not any("norm_layer" in k and k.startswith("backbone.")
                   for k in sd)
    res["state"].module.load_state_dict(sd, strict=True)


@pytest.mark.parametrize("task", ["cls", "flow"])
def test_cli_hub_arguments_match_jax(monkeypatch, task):
    """``--backbone swin_ecddp --model_size base`` (Swin-ECDDP-T, as in
    JAX's tables): JAX's factory and the port's receive the same classes,
    channels, input size and rates (the CLI's drop-path 0.1 over the
    backbone's 0.2)."""
    argv = ["--backbone", "swin_ecddp", "--model_size", "base",
            "--input_size", "64"]
    want, got = {}, {}
    if task == "cls":
        monkeypatch.setattr(jcls_cli, "cls_hub_swin_ecddp_tiny",
                            _capture(want))
        monkeypatch.setattr(cls_cli, "cls_hub_swin_ecddp_tiny",
                            _capture(got))
        jmain, tmain = jcls_cli.main, cls_cli.main
    else:
        monkeypatch.setitem(jflow_cli.HUBS, ("swin_ecddp", "base"),
                            _capture(want))
        monkeypatch.setattr(flow_cli, "dense_hub_swin_ecddp_tiny",
                            _capture(got))
        jmain, tmain = jflow_cli.main, flow_cli.main
    with pytest.raises(_Stop):
        jmain(argv)
    with pytest.raises(_Stop):
        tmain(argv + ["--device", "cpu"])
    jkw, (targs, tkw) = want["hub"][1], got["hub"]
    assert targs[:2] == (jkw["num_classes"], jkw["num_bins"])
    for k in ("input_size", "drop_path_rate", "drop_rate",
              "attn_drop_rate"):
        assert tkw[k] == jkw[k], k
    assert tkw["drop_path_rate"] == 0.1
