"""The port's ViT-MEM against the JAX package on the CPU.

The same numpy-seeded inputs go through JAX's ViT-MEM and the port's at a
tiny size (64 px, patch 16: 16 patches and the class token; width 128, 4
heads, depth 4, every block in the pyramid), every weight drawn at random
(``tests/_finetune_twin.py``: the zero-init bias tables, ``q_bias``,
``v_bias`` and the 0.1 layer scales too) and carried through
``export_torch_state_dict`` -> ``load_jax_state_dict``: the relative
position index word for word, ``encode_dense`` in f32 and bf16, the K5
route of the bf16 eval, the cls and dense hubs, the layer scales and
decay masks of the four full-size hubs name by name, 3-step f32 cls and
semseg trajectories with replayed drop-path masks (the dense heads
``HEAD_WIDTH`` wide), and the three finetune CLIs with ``--backbone
vit_mem`` (their configs against JAX's). The JAX halves run under
``jax.jit``.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from eventpretrain_tpu.cli import finetune_cls as jcls_cli
from eventpretrain_tpu.cli import finetune_semseg as jsemseg_cli
from eventpretrain_tpu.data import cls_pipeline as jcp
from eventpretrain_tpu.models import cls_hub as jcls_hub
from eventpretrain_tpu.models import dense_hub as jdense_hub
from eventpretrain_tpu.models import vit_mem as jvit_mem
from eventpretrain_tpu_torch.cli import finetune_cls as cls_cli
from eventpretrain_tpu_torch.cli import finetune_flow as flow_cli
from eventpretrain_tpu_torch.cli import finetune_semseg as semseg_cli
from eventpretrain_tpu_torch.data import cls_pipeline as tcp
from eventpretrain_tpu_torch.models import cls_hub as tcls_hub
from eventpretrain_tpu_torch.models import dense_hub as tdense_hub
from eventpretrain_tpu_torch.models import layers as tlayers
from eventpretrain_tpu_torch.models import vit_mem as tvit_mem

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

CFG = dict(input_size=64, patch_size=16, embed_dim=128, depth=4,
           num_heads=4, out_indices=(0, 1, 2, 3))
NUM_CLASSES = 4
B = 8
# drop-path 0.1 over depth 4: the rates linspace(0, 0.1, 4), the first 0,
# so 3 blocks draw twice a step
SITES = 6
LABEL_HW = (12, 20)


def _x(seed, b=2):
    return np.random.default_rng(seed).normal(
        size=(b, 64, 64, 3)).astype(np.float32)


@pytest.mark.parametrize("window", [(4, 4), (14, 14), (3, 5)])
def test_relative_position_index_is_jax_s(window):
    """The index, class token entries and all, word for word; the port's
    buffers hold it and are left out of the state dict."""
    got = tvit_mem.relative_position_index(window)
    want = jvit_mem.relative_position_index(window)
    assert got.dtype == want.dtype
    np.testing.assert_array_equal(got, want)
    if window == (4, 4):
        m = tvit_mem.ViTMEM(**CFG, device="cpu")
        assert torch.equal(m.vit_block[2].attn.relative_position_index,
                           torch.from_numpy(want))
        assert not any("relative_position_index" in k
                       for k in m.state_dict())


@pytest.fixture(scope="module")
def backbone_twin():
    m = tvit_mem.ViTMEM(**CFG, device="cpu").eval()
    jm = jvit_mem.ViTMEM(**CFG)
    v = random_twin(m, jm, jnp.zeros((1, 64, 64, 3)),
                    method=jm.encode_dense)
    return m, jm, v


def _jax_encode(jm, v, x, dtype=jnp.float32):
    jm = jm.clone(dtype=dtype)
    return jax.jit(lambda v, x: jm.apply(
        v, x, return_attn=True, return_pyramid=True,
        method=jm.encode_dense))(v, jnp.asarray(x))


def test_encode_dense_matches_jax(backbone_twin):
    """The pooled-then-normed embedding, the 4 pyramid maps and the last
    block's attention weights within 1e-5 of their scale; no attention
    or pyramid unless asked."""
    m, jm, v = backbone_twin
    x = _x(1)
    want = _jax_encode(jm, v, x)
    with torch.no_grad():
        got = m.encode_dense(t(x), return_attn=True, return_pyramid=True)
    assert got[0].shape == (2, 128) and len(got[1]) == 4
    assert got[1][0].shape == (2, 4, 4, 128)
    assert got[2].shape == (2, 4, 17, 17)
    for g, w in zip([got[0], *got[1], got[2]], [want[0], *want[1], want[2]]):
        assert rel_err(g.numpy(), w) <= ENCODE_REL
    emb, pyr, attn = m.encode_dense(t(x))
    assert pyr == [] and attn is None


def test_bf16_encode_takes_k5_and_matches_jax(monkeypatch, backbone_twin):
    """In bf16 each block's eval MLP (17 tokens, C=128, hidden 512) takes
    the K5 branch of ``Mlp`` (on the CPU its plain version; C=64 would
    fail K5's gate, C % 128); the
    embedding, pyramid and attention within 2e-2 of their scale of JAX's
    bf16 ViT-MEM (its plain ``Mlp``). A training forward stays off K5."""
    m, jm, v = backbone_twin
    calls = []
    orig = tlayers.fused_mlp

    def spy(*a, **kw):
        calls.append(a[0].shape)
        return orig(*a, **kw)

    monkeypatch.setattr(tlayers, "fused_mlp", spy)
    m16 = tvit_mem.ViTMEM(**CFG, dtype=torch.bfloat16, device="cpu").eval()
    m16.load_state_dict(m.state_dict())
    x = _x(2)
    want = _jax_encode(jm, v, x, jnp.bfloat16)
    with torch.no_grad():
        got = m16.encode_dense(t(x), return_attn=True, return_pyramid=True)
    assert calls == [(2, 17, 128)] * 4
    for g, w in zip([got[0], *got[1], got[2]], [want[0], *want[1], want[2]]):
        assert g.dtype == torch.bfloat16
        assert rel_err(g.float().numpy(), np.asarray(w, np.float32)) \
            <= BF16_REL
    m16.train()
    with torch.no_grad():
        m16.encode_dense(t(x))
    assert len(calls) == 4


# ---------------------------------------------------------------- hubs


def _jax_hub(kind, heads, **kw):
    backbone = jvit_mem.ViTMEM(**CFG, **kw, name="backbone")
    if kind == "cls":
        return jcls_hub.FtClsHub(backbone=backbone, num_classes=NUM_CLASSES)
    return jdense_hub.FtDenseHub(backbone=backbone, num_classes=NUM_CLASSES,
                                 decode_in_channels=(128,) * 4,
                                 decode_dropout=0.0, **heads)


def _port_hub(kind, **kw):
    if kind == "cls":
        return tcls_hub.cls_hub_vit_mem_small(NUM_CLASSES, device="cpu",
                                              **CFG, **kw)
    return tdense_hub.dense_hub_vit_mem_small(NUM_CLASSES, device="cpu",
                                              decode_dropout=0.0, **CFG,
                                              **kw)


def _hub_twin(kind, monkeypatch, seed=0):
    """The tiny hubs of ``kind`` at drop-path 0.1, the dense heads
    narrowed by ``narrow_heads``."""
    heads = narrow_heads(monkeypatch) if kind == "dense" else {}
    kw = {"drop_path_rate": 0.1}
    hub, jhub = _port_hub(kind, **kw), _jax_hub(kind, heads, **kw)
    return hub, jhub, random_twin(hub, jhub, jnp.zeros((1, 64, 64, 3)),
                                  seed=seed)


@pytest.mark.parametrize("kind", ["cls", "dense"])
def test_hub_outputs_match_jax(monkeypatch, kind):
    """The cls hub's embedding and logits; the dense hub's embedding,
    pyramid, decode and auxiliary logits (the heads' BatchNorms on their
    drawn running statistics); each within 1e-5 of its scale. Evaluation
    draws no drop-path."""
    hub, jhub, v = _hub_twin(kind, monkeypatch)
    x = _x(3)
    want = jax.jit(lambda x: jhub.apply(v, x))(jnp.asarray(x))
    with torch.no_grad():
        got = hub.eval()(t(x))
    if kind == "cls":
        got, want = got[:2], want[:2]
        assert got[1].shape == (2, NUM_CLASSES)
    else:
        got, want = (got[0], *got[1], *got[2:]), (want[0], *want[1],
                                                   *want[2:])
        assert got[-2].shape == (2, 4, 4, NUM_CLASSES)
    for g, w in zip(got, want):
        assert rel_err(g.numpy(), w) <= ENCODE_REL


@pytest.mark.parametrize("kind", ["cls", "dense"])
@pytest.mark.parametrize("size", ["small", "base"])
def test_layer_scales_and_decay_masks_match_jax(kind, size):
    """Every parameter of the full-size hubs (12 layer ids, as the CLIs
    set them): its lr scale and weight-decay flag equal JAX's for the
    flax path the exporter maps to its name. The patch embed is at 0,
    block i at i + 1, the class token, the shared bias table, the final
    norm and the heads at 12; the class token and the bias tables decay
    (ndim >= 2), ``q_bias``, ``v_bias`` and the gammas do not."""
    x = jnp.zeros((1, 224, 224, 3))
    jmake = getattr(jcls_hub if kind == "cls" else jdense_hub,
                    f"{kind}_hub_vit_mem_{size}")
    jhub = jmake(NUM_CLASSES)
    tree = jax.eval_shape(lambda k: jhub.init(k, x),
                          jax.random.key(0))["params"]
    tmake = getattr(tcls_hub if kind == "cls" else tdense_hub,
                    f"{kind}_hub_vit_mem_{size}")
    hub = tmake(NUM_CLASSES, device="meta")
    ids = check_layer_decay(tree, hub, 12, "vit_mem")
    assert ids == set(range(13))
    params = dict(hub.named_parameters())
    assert params["backbone.cls_token"].ndim == 3
    assert params["backbone.rel_pos_bias.relative_position_bias_table"] \
        .ndim == 2


# --------------------------------------------------------------- steps


def _cls_batch(seed):
    rng = np.random.default_rng(seed)
    return {"evg": rng.normal(size=(B, 64, 64, 3)).astype(np.float32),
            "label": rng.integers(0, NUM_CLASSES, B).astype(np.int32),
            "keep": rng.random((SITES, B)) < 0.8}


def test_f32_cls_trajectory_matches_jax(monkeypatch):
    """3 make_cls_train_step updates of the tiny ViT-MEM cls hub with
    drop-path 0.1 (6 replayed masks a step), label smoothing 0.1, the
    clip at 5 and layer decay 0.75: loss, grad norm and accuracy at each
    step and every parameter after them within 1e-4 of JAX's."""
    hub, jhub, v = _hub_twin("cls", monkeypatch, seed=1)
    cls_trajectory(monkeypatch, hub, jhub, v,
                   [_cls_batch(10 + i) for i in range(3)], sites=SITES,
                   backbone_type="vit_mem")


def test_f32_semseg_trajectory_matches_jax(monkeypatch):
    """3 make_semseg_train_step updates of the tiny ViT-MEM dense hub
    (batches of 8; the same 6 drop-path masks each step), the CLI's
    optimizer: the losses at each step within 1e-4 and every parameter
    and BatchNorm statistic after them as ``semseg_trajectory`` holds
    them."""
    hub, jhub, v = _hub_twin("dense", monkeypatch, seed=2)
    rng = np.random.default_rng(30)
    batches = [{"evg": rng.normal(size=(B, 64, 64, 3)).astype(np.float32),
                "label": rng.integers(0, NUM_CLASSES, (B,) + LABEL_HW)
                .astype(np.int32)} for _ in range(3)]
    semseg_trajectory(monkeypatch, hub, jhub, v, batches,
                      rng.random((SITES, B)) < 0.8, num_classes=NUM_CLASSES,
                      backbone_type="vit_mem")


# ---------------------------------------------------------------- CLIs


class _Stop(Exception):
    pass


def _capture(into: dict, key: str, make=None):
    def fn(*args, **kw):
        into[key] = (args, kw) if make is None else make(*args, **kw)
        raise _Stop
    return fn


def _tiny(make):
    def fn(num_classes, num_bins=3, **kw):
        return make(num_classes, num_bins, **{
            **kw, "embed_dim": 64, "depth": 4, "num_heads": 4,
            "out_indices": (0, 1, 2, 3)})
    return fn


def test_cls_cli_config_matches_jax(monkeypatch):
    """``finetune_cls --backbone vit_mem --num_bins 3``: the data config
    field by field and the hub's arguments (3 channels, drop-path and
    dropout rates, input size) equal those of JAX's CLI."""
    argv = ["--backbone", "vit_mem", "--num_bins", "3", "--input_size",
            "64", "--model_size", "base"]
    want, got = {}, {}
    monkeypatch.setattr(jcls_cli, "ClsDataConfig",
                        _capture(want, "cfg", jcp.ClsDataConfig))
    with pytest.raises(_Stop):
        jcls_cli.main(argv)
    monkeypatch.setattr(jcls_cli, "ClsDataConfig", jcp.ClsDataConfig)
    monkeypatch.setattr(jcls_cli, "cls_hub_vit_mem_base",
                        _capture(want, "hub"))
    with pytest.raises(_Stop):
        jcls_cli.main(argv)
    monkeypatch.setattr(cls_cli, "ClsDataConfig",
                        _capture(got, "cfg", tcp.ClsDataConfig))
    with pytest.raises(_Stop):
        cls_cli.main(argv + ["--device", "cpu"])
    monkeypatch.setattr(cls_cli, "ClsDataConfig", tcp.ClsDataConfig)
    monkeypatch.setattr(cls_cli, "cls_hub_vit_mem_base",
                        _capture(got, "hub"))
    with pytest.raises(_Stop):
        cls_cli.main(argv + ["--device", "cpu"])
    for f in dataclasses.fields(got["cfg"]):
        assert getattr(got["cfg"], f.name) == getattr(want["cfg"], f.name)
    jkw, tkw = want["hub"][1], got["hub"][1]
    assert got["hub"][0][:2] == (jkw["num_classes"], jkw["num_bins"]) \
        == (2, 3)
    for k in ("input_size", "drop_path_rate", "drop_rate",
              "attn_drop_rate"):
        assert tkw[k] == jkw[k], k


@pytest.mark.parametrize("task", ["cls", "semseg", "flow"])
def test_clis_run_vit_mem(monkeypatch, tmp_path, task):
    """Each finetune CLI trains and validates ``--backbone vit_mem`` with
    the MEM image on the CPU (a narrow twin of ViT-MEM-S of the same
    code, the dense heads narrowed by ``narrow_heads``) and writes a
    checkpoint the hub loads strictly."""
    common = ["--device", "cpu", "--no-bf16", "--backbone", "vit_mem",
              "--num_bins", "3", "--input_size", "64", "--epochs", "1",
              "--print_freq", "1", "--output_dir", str(tmp_path)]
    if task == "cls":
        monkeypatch.setattr(cls_cli, "cls_hub_vit_mem_small",
                            _tiny(tcls_hub.cls_hub_vit_mem_small))
        res = cls_cli.main(common + [
            "--batch_size", "32", "--num_workers", "0", "--fix_events_num",
            "1000", "--val_fix_events_num", "1000"])
        assert res["state"].step == 4 and 0 <= res["best_acc1"] <= 100
    else:
        cli = semseg_cli if task == "semseg" else flow_cli
        narrow_heads(monkeypatch)
        monkeypatch.setattr(cli, "dense_hub_vit_mem_small",
                            _tiny(tdense_hub.dense_hub_vit_mem_small))
        res = cli.main(common + [
            "--batch_size", "16", "--fix_events_num", "1000",
            "--val_fix_events_num", "1000"])
        assert res["state"].step == 2
    sd = torch.load(tmp_path / "checkpoint.pth", weights_only=True)["model"]
    assert "backbone.rel_pos_bias.relative_position_bias_table" in sd
    assert not any("relative_position_index" in k for k in sd)
    res["state"].module.load_state_dict(sd, strict=True)


def test_semseg_cli_hub_arguments_match_jax(monkeypatch):
    """``finetune_semseg --backbone vit_mem``: JAX's ``HUBS`` entry and the
    port's factory receive the same classes, channels and rates."""
    argv = ["--backbone", "vit_mem", "--num_bins", "3", "--input_size",
            "64"]
    want, got = {}, {}
    monkeypatch.setitem(jsemseg_cli.HUBS, ("vit_mem", "small"),
                        _capture(want, "hub"))
    with pytest.raises(_Stop):
        jsemseg_cli.main(argv)
    monkeypatch.setattr(semseg_cli, "dense_hub_vit_mem_small",
                        _capture(got, "hub"))
    with pytest.raises(_Stop):
        semseg_cli.main(argv + ["--device", "cpu"])
    jkw, (targs, tkw) = want["hub"][1], got["hub"]
    assert targs[:2] == (jkw["num_classes"], jkw["num_bins"])
    for k in ("input_size", "drop_path_rate", "drop_rate",
              "attn_drop_rate"):
        assert tkw[k] == jkw[k], k
