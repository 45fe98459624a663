"""The port's EvRep image and EvRepSL network against the JAX package on
the CPU.

The same numpy-seeded inputs go through JAX's function and its port:
EvRep on streams with padding, out-of-frame coordinates, polarity 0 and
repeated (x, y, t) (the count and polarity channels word for word, the
std channel to one f32 ulp: the port adds each pixel's deltas in JAX's
order and rounds ``E[d^2] - mean^2`` as XLA's fused multiply-add does, but
where the f64 difference's rounding to f32 is a second rounding);
``ClsPipeline(use_evrep=True)`` (the host arrays word for word, ``evg``
within 1e-5 of its scale); EffWNet at 224 px (every weight drawn at random by
``tests/_finetune_twin.py``, carried through ``export_torch_state_dict``
-> ``load_jax_state_dict``), whose up-sampling pads 2 of the 74 and 224
rows and columns; the frozen preprocess of the cls steps; a 3-step f32
cls trajectory of a tiny ViT behind EffWNet at 64 px with replayed
drop-path masks; ``--evrepsl_checkpoint`` from a file the test writes with
JAX's ``save_torch_checkpoint``; and the cls CLI with ``--use_evrepsl``
(its config against JAX's). The JAX halves run under ``jax.jit``.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from eventpretrain_tpu import native as jnative
from eventpretrain_tpu.ckpt.torch_export import save_torch_checkpoint
from eventpretrain_tpu.cli import finetune_cls as jcls_cli
from eventpretrain_tpu.data import cls_pipeline as jcp
from eventpretrain_tpu.models import cls_hub as jcls_hub
from eventpretrain_tpu.models import evrepsl as jevrepsl
from eventpretrain_tpu.ops.events import events_to_evrep as j_evrep_one
from eventpretrain_tpu.ops.events import events_to_evrep_batch as j_evrep
from eventpretrain_tpu_torch import native as tnative
from eventpretrain_tpu_torch.cli import finetune_cls as cls_cli
from eventpretrain_tpu_torch.data import cls_pipeline as tcp
from eventpretrain_tpu_torch.data.representations import (
    build_representation,
)
from eventpretrain_tpu_torch.models import cls_hub as tcls_hub
from eventpretrain_tpu_torch.models import evrepsl as tevrepsl
from eventpretrain_tpu_torch.ops.events import events_to_evrep_batch
from eventpretrain_tpu_torch.train import optim as toptim
from eventpretrain_tpu_torch.train.state import TrainState
from eventpretrain_tpu_torch.train.steps import (
    make_cls_eval_step,
    make_cls_train_step,
)

from tests._finetune_twin import (
    ENCODE_REL,
    cls_trajectory,
    compiled,
    random_twin,
    rel_err,
    t,
)
from tests._port_threads import one_torch_thread  # noqa: F401

NUM_CLASSES = 3
B = 8
# the tiny ViT behind EffWNet: 64 px of EvRepSL's 5 channels, patch 16;
# drop-path 0.1 over depth 3, the first rate 0, so 2 blocks draw twice
VIT = dict(input_size=64, patch_size=16, embed_dim=64, depth=3,
           num_heads=4)
SITES = 4


# -------------------------------------------------------------- EvRep


def _streams(seed, b=3, e=600, h=12, w=16):
    """(B, E, 4) streams in microseconds: coordinates one past every edge
    (negatives truncate toward zero), polarity 0 and 1, a burst of
    repeated (x, y, t) rows, one sample padded past its count with noise,
    one empty."""
    rng = np.random.default_rng(seed)
    x = rng.integers(-2, w + 2, (b, e)) + rng.uniform(0, 1, (b, e))
    y = rng.integers(-2, h + 2, (b, e)) + rng.uniform(0, 1, (b, e))
    tt = np.sort(rng.uniform(0, 3e5, (b, e)), axis=1)
    p = rng.integers(0, 2, (b, e)).astype(np.float64)
    x[:, 100:130], y[:, 100:130], tt[:, 100:130] = x[:, 100:101], \
        y[:, 100:101], tt[:, 100:101]
    ev = np.stack([x, y, tt, p], -1).astype(np.float32)
    counts = np.array([e, e // 2, 0][:b], np.int32)
    ev[1, e // 2:] = rng.normal(size=(e - e // 2, 4)) * 5
    return ev, counts


# one f32 ulp of the std (see the module's docstring)
STD_RTOL = 2.0 ** -23


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_evrep_matches_jax(seed):
    """Counts and net polarity of every pixel equal JAX's
    ``events_to_evrep_batch`` bit for bit, its delta-t std to one ulp
    (the clip at 1000 reached); at B=1 it is the batch's row and JAX's
    one-sample ``events_to_evrep``."""
    ev, counts = _streams(seed)
    want = np.asarray(jax.jit(lambda a, c: j_evrep(
        a, c, height=12, width=16))(ev, counts))
    got = events_to_evrep_batch(t(ev), t(counts), height=12,
                                width=16).numpy()
    assert got.shape == (3, 12, 16, 3) and got.dtype == np.float32
    np.testing.assert_array_equal(got[..., :2], want[..., :2])
    np.testing.assert_allclose(got[..., 2], want[..., 2], rtol=STD_RTOL,
                               atol=0)
    assert want[..., 2].max() == 1000.0 and not want[2].any()
    one = events_to_evrep_batch(t(ev[1:2]), t(counts[1:2]), height=12,
                                width=16).numpy()[0]
    np.testing.assert_array_equal(one, got[1])
    want_one = np.asarray(jax.jit(lambda a, c: j_evrep_one(
        a, c, height=12, width=16))(ev[1], counts[1]))
    np.testing.assert_array_equal(one[..., :2], want_one[..., :2])
    np.testing.assert_allclose(one[..., 2], want_one[..., 2],
                               rtol=STD_RTOL, atol=0)


def test_evrep_representation_is_untiled_only():
    """``build_representation(use_evrep=True)`` is the EvRep image; JAX
    has no tiled EvRep, so a tile table is refused."""
    ev, counts = _streams(3)
    got = build_representation(t(ev), t(counts), num_bins=5, height=12,
                               width=16, use_evrep=True)
    np.testing.assert_array_equal(
        got.numpy(), events_to_evrep_batch(t(ev), t(counts), height=12,
                                           width=16).numpy())
    with pytest.raises(ValueError, match="tiled"):
        build_representation(t(ev), t(counts), num_bins=5, height=12,
                             width=16, use_evrep=True,
                             tile_table=torch.zeros((3, 1), dtype=torch.int32))


@pytest.mark.parametrize("train", [True, False], ids=["train", "eval"])
def test_cls_pipeline_with_evrep_matches_jax(monkeypatch, train):
    """Both pipelines (numpy host code) with ``use_evrep``: the host
    arrays each sends (f32 events, no codec; the counts) word for word,
    the labels, and ``evg`` (EvRep of microsecond timestamps, viewed,
    the temporal flip not negating, not normalised) within 1e-5 of its
    scale: the resize's contractions sum in other orders."""
    monkeypatch.setattr(jnative, "_LIB", None)
    monkeypatch.setattr(jnative, "BACKEND", "numpy-forced")
    monkeypatch.setattr(tnative, "BACKEND", "numpy-forced")
    sent = {"jax": [], "port": []}

    def spy(side, fn):
        def wrapped(packed, counts, enabled, **kw):
            assert not enabled
            sent[side].append((packed.copy(), counts.copy()))
            return fn(packed, counts, enabled, **kw)
        return wrapped

    monkeypatch.setattr(jcp, "encode_for_transfer",
                        spy("jax", jcp.encode_for_transfer))
    monkeypatch.setattr(tcp, "encode_for_transfer",
                        spy("port", tcp.encode_for_transfer))
    common = dict(num_classes=2, input_size=32, fix_events_num=800,
                  val_fix_events_num=800, canvas_height=48, canvas_width=56,
                  use_evrep=True)
    kw = dict(num_classes=2, samples_per_class=3, num_events=1000,
              sensor_hw=(40, 50), seed=4)
    want = list(jcp.ClsPipeline(jcp.SyntheticClsSource(**kw),
                                jcp.ClsDataConfig(**common), 4, train=train,
                                seed=7, num_workers=0))
    got = list(tcp.ClsPipeline(tcp.SyntheticClsSource(**kw),
                               tcp.ClsDataConfig(**common), 4, train=train,
                               seed=7, num_workers=0, device="cpu"))
    assert len(got) == len(want) == len(sent["port"]) == len(sent["jax"])
    for (gp, gc), (wp, wc) in zip(sent["port"], sent["jax"]):
        assert gp.dtype == np.float32
        np.testing.assert_array_equal(gp, wp)
        np.testing.assert_array_equal(gc, wc)
    for g, w in zip(got, want):
        assert g["evg"].shape == (4, 32, 32, 3)
        np.testing.assert_array_equal(g["label"].numpy(),
                                      np.asarray(w["label"]))
        assert rel_err(g["evg"].numpy(), w["evg"]) <= ENCODE_REL
    assert float(np.asarray(want[0]["evg"])[..., 2].max()) > 100.0


# ------------------------------------------------------------ EffWNet


@pytest.fixture(scope="module")
def repgen_64():
    """EffWNet at 64 px (levels 64, 21, 7, 3, 1) and JAX's variables."""
    net = tevrepsl.evrepsl_net(device="cpu")
    jnet = jevrepsl.evrepsl_net()
    v = random_twin(net, jnet, jnp.zeros((1, 64, 64, 3)), seed=11)
    return net, jnet, v


def test_effwnet_at_224_matches_jax(repgen_64):
    """The network the CLI builds (the fixture's: its parameters do not
    depend on the input's size): 571 tensors, 6.66 M parameters; at 224
    px its levels are 224, 74, 24, 12 and 6 (VALID pools), the 3x
    up-samplings give 72 and 222 rows, zero-padded by 1 each side; the
    5-channel output (the EvRep image, then clean_ie and C) within 1e-5
    of its scale of JAX's."""
    net, jnet, v = repgen_64
    assert len(net.state_dict()) == 571
    assert round(sum(p.numel() for p in net.parameters()) / 1e6, 2) == 6.66
    x = np.abs(np.random.default_rng(13).normal(
        size=(1, 224, 224, 3))).astype(np.float32) * 4
    shapes = []
    hooks = [getattr(net, f"up_{i}").register_forward_pre_hook(
        lambda m, a: shapes.append((a[0].shape[1], a[1].shape[1])))
        for i in range(4)]
    want = compiled(jax.jit(jnet.apply), v, jnp.asarray(x))(
        v, jnp.asarray(x))
    with torch.no_grad():
        got = net(t(x))
    for h in hooks:
        h.remove()
    assert shapes == [(6, 12), (12, 24), (24, 74), (74, 224)]
    assert got.shape == (1, 224, 224, 5)
    np.testing.assert_array_equal(got[..., :3].numpy(), x)
    assert rel_err(got.numpy(), want) <= ENCODE_REL


def test_effwnet_bf16_casts_its_output_to_its_input_s_dtype(repgen_64):
    """In bf16 compute the output is the input's f32, as JAX's
    concatenate promotes: the input's channels as they were, the two new
    ones within 5e-2 of f32's (bf16's 8 bits over some 70 convolutions
    and GroupNorms)."""
    net, _, _ = repgen_64
    net16 = tevrepsl.evrepsl_net(dtype=torch.bfloat16, device="cpu")
    net16.load_state_dict(net.state_dict())
    x = t(np.abs(np.random.default_rng(14).normal(
        size=(2, 64, 64, 3))).astype(np.float32))
    with torch.no_grad():
        got, want = net16(x), net(x)
    assert got.dtype == torch.float32
    assert torch.equal(got[..., :3], x)
    assert rel_err(got[..., 3:].numpy(), want[..., 3:].numpy()) <= 5e-2


# ---------------------------------------------------------- the steps


def _vit_twin(seed):
    hub = tcls_hub.cls_hub_vit_small(NUM_CLASSES, 5, device="cpu", **VIT,
                                     drop_path_rate=0.1)
    jhub = jcls_hub.cls_hub_vit_small(NUM_CLASSES, 5, **VIT,
                                      drop_path_rate=0.1)
    return hub, jhub, random_twin(hub, jhub, jnp.zeros((1, 64, 64, 5)),
                                  seed=seed)


def _batch(seed):
    rng = np.random.default_rng(seed)
    return {"evg": np.abs(rng.normal(size=(B, 64, 64, 3))).astype(
                np.float32) * 3,
            "label": rng.integers(0, NUM_CLASSES, B).astype(np.int32),
            "keep": rng.random((SITES, B)) < 0.8}


def test_f32_cls_trajectory_behind_effwnet_matches_jax(monkeypatch,
                                                        repgen_64):
    """3 make_cls_train_step updates of a tiny ViT over EffWNet's 5
    channels, EffWNet as ``preprocess_fn`` on both sides (JAX's under
    ``stop_gradient``), drop-path 0.1 (4 replayed masks a step), label
    smoothing 0.1, the clip at 5, layer decay 0.75: loss, grad norm and
    accuracy at each step and every hub parameter within 1e-4 of JAX's;
    EffWNet's parameters get no gradient and stay as they were."""
    net, jnet, v = repgen_64
    before = {k: p.detach().clone() for k, p in net.named_parameters()}
    net.requires_grad_(False).eval()
    hub, jhub, hv = _vit_twin(15)
    cls_trajectory(monkeypatch, hub, jhub, hv,
                   [_batch(20 + i) for i in range(3)], sites=SITES,
                   preprocess=net,
                   jpreprocess=lambda evg: jnet.apply(v, evg))
    for k, p in net.named_parameters():
        assert p.grad is None and torch.equal(p, before[k]), k


def test_preprocess_is_frozen_and_not_the_hub_s(repgen_64):
    """Under ``preprocess_fn`` the network runs without autograd even
    where its parameters require gradients (JAX's ``stop_gradient``):
    nothing reaches them, the optimizer holds none of them, and the hub's
    state dict has no key of theirs. The eval step maps ``evg`` by it
    too."""
    net, _, _ = repgen_64
    net.requires_grad_(True)
    hub, _, _ = _vit_twin(16)
    state = TrainState(hub, toptim.build_optimizer(hub), lambda s: 1e-3)
    held = {id(p) for g in state.optimizer.param_groups for p in g["params"]}
    assert not held & {id(p) for p in net.parameters()}
    b = _batch(30)
    tb = {"evg": t(b["evg"]), "label": t(b["label"], True),
          "drop_path_keep": t(b["keep"])}
    seen = []
    make_cls_train_step(hub, preprocess_fn=lambda x: seen.append(
        torch.is_grad_enabled()) or net(x))(state, tb)
    assert seen == [False]
    assert all(p.grad is None for p in net.parameters())
    assert not set(hub.state_dict()) & {f"backbone.{k}" for k in
                                        net.state_dict()}
    with_net = make_cls_eval_step(hub, preprocess_fn=net)(tb)
    with torch.no_grad():
        _, logits, _ = hub.eval()(net(tb["evg"]))
    acc = (logits.argmax(-1) == tb["label"]).float().mean() * 100
    assert float(with_net["acc1"]) == pytest.approx(float(acc))
    net.requires_grad_(False)


# ---------------------------------------------------------- the CLI


def test_evrepsl_checkpoint_loads_jax_s_export(tmp_path, capsys,
                                               repgen_64):
    """``--evrepsl_checkpoint``: JAX's ``save_torch_checkpoint`` of
    EffWNet's params (the reference key space) loads strictly into the
    port's network in the compute dtype, frozen and in eval mode; without
    a file JAX's warning is printed and the init is seed 7's; a file
    missing a tensor raises."""
    path = save_torch_checkpoint(str(tmp_path / "repgen.pth"),
                                 repgen_64[2]["params"])
    args = cls_cli.build_parser().parse_args(
        ["--use_evrepsl", "--evrepsl_checkpoint", path])
    rep = cls_cli.build_repgen(args, torch.bfloat16, torch.device("cpu"))
    sd = torch.load(path, weights_only=True)["model"]
    assert set(sd) == set(rep.state_dict())
    for k, p in rep.named_parameters():
        assert torch.equal(p, sd[k]) and not p.requires_grad, k
    assert not rep.training
    assert rep.inc.conv1.compute_dtype == torch.bfloat16
    assert "random RepGen" not in capsys.readouterr().out
    rep0 = cls_cli.build_repgen(cls_cli.build_parser().parse_args(
        ["--use_evrepsl"]), torch.float32, torch.device("cpu"))
    assert "random RepGen weights" in capsys.readouterr().out
    ref = tevrepsl.evrepsl_net(device="cpu",
                               generator=torch.Generator().manual_seed(7))
    for k, p in rep0.named_parameters():
        assert torch.equal(p, ref.state_dict()[k]), k
    del sd["c_out.c2.gn.bias"]
    torch.save({"model": sd}, tmp_path / "short.pth")
    args.evrepsl_checkpoint = str(tmp_path / "short.pth")
    with pytest.raises(RuntimeError, match="Missing key"):
        cls_cli.build_repgen(args, torch.float32, torch.device("cpu"))


class _Stop(Exception):
    pass


def test_cls_cli_config_matches_jax(monkeypatch):
    """``finetune_cls --use_evrepsl``: the data config (``use_evrep``)
    field by field and the hub's arguments (5 input channels) equal those
    of JAX's CLI."""
    argv = ["--use_evrepsl", "--input_size", "64"]
    want, got = {}, {}

    def keep_cfg(into, make):
        def fn(*a, **kw):
            into["cfg"] = make(*a, **kw)
            return into["cfg"]
        return fn

    def stop(into):
        def fn(*a, **kw):
            into["hub"] = (a, kw)
            raise _Stop
        return fn

    class Unbuilt:  # JAX's CLI initialises EffWNet before the hub
        def init(self, key, x):
            return {"params": {}}

    monkeypatch.setattr(jevrepsl, "evrepsl_net", lambda dtype: Unbuilt())
    monkeypatch.setattr(jcls_cli, "ClsDataConfig",
                        keep_cfg(want, jcp.ClsDataConfig))
    monkeypatch.setattr(jcls_cli, "cls_hub_vit_small", stop(want))
    with pytest.raises(_Stop):
        jcls_cli.main(argv)
    monkeypatch.setattr(cls_cli, "ClsDataConfig",
                        keep_cfg(got, tcp.ClsDataConfig))
    monkeypatch.setattr(cls_cli, "cls_hub_vit_small", stop(got))
    with pytest.raises(_Stop):
        cls_cli.main(argv + ["--device", "cpu"])
    for f in dataclasses.fields(got["cfg"]):
        assert getattr(got["cfg"], f.name) == getattr(want["cfg"], f.name)
    assert got["cfg"].use_evrep
    jkw, (targs, tkw) = want["hub"][1], got["hub"]
    assert targs[:2] == (jkw["num_classes"], jkw["num_bins"]) == (2, 5)
    for k in ("input_size", "drop_path_rate", "drop_rate",
              "attn_drop_rate"):
        assert tkw[k] == jkw[k], k


def test_cls_cli_runs_with_evrepsl(monkeypatch, tmp_path):
    """``finetune_cls --use_evrepsl --evrepsl_checkpoint`` trains and
    validates a narrow ViT over EffWNet on the CPU at 64 px; the hub's
    checkpoint holds the hub alone."""
    def tiny(num_classes, num_bins=5, **kw):
        return tcls_hub.cls_hub_vit_small(num_classes, num_bins, **{
            **kw, "embed_dim": 64, "depth": 2, "num_heads": 2})

    monkeypatch.setattr(cls_cli, "cls_hub_vit_small", tiny)
    path = str(tmp_path / "repgen.pth")
    net = tevrepsl.evrepsl_net(device="cpu",
                               generator=torch.Generator().manual_seed(3))
    torch.save({"model": net.state_dict()}, path)
    res = cls_cli.main([
        "--device", "cpu", "--no-bf16", "--use_evrepsl",
        "--evrepsl_checkpoint", path, "--input_size", "64",
        "--batch_size", "32", "--epochs", "1", "--num_workers", "0",
        "--fix_events_num", "1000", "--val_fix_events_num", "1000",
        "--print_freq", "1", "--output_dir", str(tmp_path / "out")])
    assert res["state"].step == 4 and 0 <= res["best_acc1"] <= 100
    sd = torch.load(tmp_path / "out" / "checkpoint.pth",
                    weights_only=True)["model"]
    assert sd["backbone.patch_embed.proj.weight"].shape[1] == 5
    assert not any(k.startswith(("inc.", "down_", "up_")) for k in sd)
