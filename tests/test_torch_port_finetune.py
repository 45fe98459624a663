"""The port's classification-finetune slice against the JAX package on the
CPU.

The same numpy-seeded inputs go through the JAX function and its port: the
event-stream transforms and packing, the transfer codec, the cls pipeline
in train and eval mode, the loss and metrics, the K4/K5 dispatch of the
ViT block, stochastic depth with replayed masks, short training
trajectories of a tiny ViT hub (depth 3, C=128, 4 heads, 32x32 input,
drop-path 0.1) carried across with ``export_torch_state_dict`` ->
``load_jax_state_dict``, the eval weighting and the CLI. ``jax.random``
cannot be reproduced, so drop-path masks are drawn with numpy and replayed
on both sides: the port through ``drop_path_keep``, JAX by replacing
``eventpretrain_tpu.models.layers.drop_path``, which ``DropPath`` looks up
at call time. Both pipelines run their C++ host code (JAX's library built
here from JAX's source, the port's from its copy), so one seed gives the
same batches; one case forces both to their numpy specifications
(``native.BACKEND = "numpy-forced"``), which also agree. Every test passes
``device="cpu"``.
"""

import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from eventpretrain_tpu import native as jnative
from eventpretrain_tpu.ckpt.torch_export import export_torch_state_dict
from eventpretrain_tpu.data import cls_pipeline as jcp
from eventpretrain_tpu.data import codec as jcodec
from eventpretrain_tpu.data import event_transforms as jet
from eventpretrain_tpu.eval.metrics import topk_accuracy as j_topk
from eventpretrain_tpu.models import layers as jlayers
from eventpretrain_tpu.models.cls_hub import cls_hub_vit_small as j_hub
from eventpretrain_tpu.objectives.cls import cls_loss as j_cls_loss
from eventpretrain_tpu.ops.pallas_common import force_fused
from eventpretrain_tpu.train import optim as joptim
from eventpretrain_tpu.train.loop import evaluate as j_evaluate
from eventpretrain_tpu.train.state import TrainState as JTrainState
from eventpretrain_tpu.train.steps import (
    make_cls_eval_step as j_make_eval,
    make_cls_train_step as j_make_train,
)
from eventpretrain_tpu_torch import native as tnative
from eventpretrain_tpu_torch.ckpt.bridge import (
    load_jax_state_dict,
    load_torch_checkpoint,
)
from eventpretrain_tpu_torch.data import cls_pipeline as tcp
from eventpretrain_tpu_torch.data import codec as tcodec
from eventpretrain_tpu_torch.data import event_transforms as tet
from eventpretrain_tpu_torch.eval.metrics import topk_accuracy
from eventpretrain_tpu_torch.models import layers as tlayers
from eventpretrain_tpu_torch.models.cls_hub import cls_hub_vit_small
from eventpretrain_tpu_torch.objectives.cls import cls_loss
from eventpretrain_tpu_torch.train import optim as toptim
from eventpretrain_tpu_torch.train.loop import evaluate
from eventpretrain_tpu_torch.train.state import TrainState
from eventpretrain_tpu_torch.train.steps import (
    make_cls_eval_step,
    make_cls_train_step,
)

from tests._port_threads import one_torch_thread  # noqa: F401

# the tiny hub: 32x32 input, patch 8 -> 16 tokens; drop-path rates
# linspace(0, 0.1, 3) = (0, 0.05, 0.1): blocks 1 and 2 draw, 2 calls each
TINY = dict(input_size=32, patch_size=8, embed_dim=128, depth=3, num_heads=4,
            drop_path_rate=0.1)
NUM_CLASSES = 2
SITES = 4
B = 4


@pytest.fixture(scope="module", autouse=True)
def jax_native_library(tmp_path_factory):
    """JAX's C++ library, built in this process's own directory when no
    other test of the process built it (JAX names its temporary file alike
    in every process, so parallel workers' builds may race)."""
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


@pytest.fixture
def numpy_native(monkeypatch):
    """Both packages' numpy specifications of their C++ host code."""
    monkeypatch.setattr(jnative, "_LIB", None)
    monkeypatch.setattr(jnative, "BACKEND", "numpy-forced")
    monkeypatch.setattr(tnative, "BACKEND", "numpy-forced")


@pytest.fixture(scope="module")
def jax_params():
    hub = j_hub(NUM_CLASSES, **TINY)
    v = jax.jit(hub.init)(jax.random.key(0), jnp.zeros((1, 32, 32, 5)))
    return v["params"]


def _carry(params, dtype=torch.float32):
    hub = cls_hub_vit_small(NUM_CLASSES, dtype=dtype, device="cpu", **TINY)
    return load_jax_state_dict(hub, export_torch_state_dict(params))


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


class _BatchReplayDropPath:
    """``_ReplayDropPath`` for a compiled step that serves every batch: the
    keep masks ride in the batch, on an extra channel of ``evg``, and the
    step's ``preprocess_fn`` takes them off (traced values, not constants
    of one trace)."""

    def __init__(self):
        self.masks = None
        self.calls = 0

    @staticmethod
    def pack(evg, keep):
        extra = np.zeros(evg.shape[:-1] + (1,), np.float32)
        extra[:, :keep.shape[0], 0, 0] = keep.T
        return np.concatenate([evg, extra], axis=-1)

    def preprocess(self, evg):
        self.masks = evg[:, :SITES, 0, -1].T > 0.5  # (S, B)
        self.calls = 0
        return evg[..., :-1]

    def __call__(self, key, x, rate):
        keep = self.masks[self.calls].reshape(
            (x.shape[0],) + (1,) * (x.ndim - 1))
        self.calls += 1
        return jnp.where(keep, x / (1.0 - rate), 0.0)


def _batch(seed, b=B):
    rng = np.random.default_rng(seed)
    return dict(evg=rng.normal(size=(b, 32, 32, 5)).astype(np.float32),
                label=rng.integers(0, NUM_CLASSES, b).astype(np.int32),
                keep=rng.random((SITES, b)) < 0.9)


def _tb(b):
    return {"evg": torch.from_numpy(b["evg"]),
            "label": torch.from_numpy(b["label"]).long(),
            "drop_path_keep": torch.from_numpy(b["keep"])}


def _rel_err(got, want):
    return float(np.abs(got - want).max() / max(np.abs(want).max(), 1e-30))


# ----------------------------------------------- host transforms, packing


def test_event_transforms_match_jax_draw_for_draw():
    rng = np.random.default_rng(0)
    n = 5000
    ev = np.stack([rng.uniform(0, 119, n), rng.uniform(0, 99, n),
                   np.sort(rng.uniform(0, 1, n)),
                   rng.integers(0, 2, n).astype(np.float64)], 1)
    for seed in range(3):
        a, b = np.random.default_rng(seed), np.random.default_rng(seed)
        assert tet.random_window(a, n, 3000) == jet.random_window(b, n, 3000)
        assert tet.random_window(a, 100, 3000) == (0, 100)
        assert jet.random_window(b, 100, 3000) == (0, 100)
        np.testing.assert_array_equal(
            tet.erase_and_add_events(a, ev, (100, 120)),
            jet.erase_and_add_events(b, ev, (100, 120)))
        np.testing.assert_array_equal(
            tet.add_noise_events(a, ev, (100, 120)),
            jet.add_noise_events(b, ev, (100, 120)))
    short = ev[:50]  # too short to augment: returned as it is
    assert tet.erase_and_add_events(np.random.default_rng(0), short,
                                    (100, 120)) is short


def test_pack_event_batch_matches_jax_numpy_path(numpy_native):
    rng = np.random.default_rng(1)
    streams = [rng.normal(size=(n, 4)) for n in (10, 0, 37)]
    want, wc = jnative.pack_event_batch(streams, 20)
    got, gc = tet.pack_event_batch(streams, 20)
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(gc, wc)
    assert got.dtype == np.float32 and gc.dtype == np.int32
    again, _ = tet.pack_event_batch(streams[:1], 20, out=np.ones((1, 20, 4),
                                                                  np.float32))
    assert not again[0, 10:].any()  # a reused buffer is cleared


# ------------------------------------------------------------- codec


def _packed(rng, b=3, e=400):
    ev = np.zeros((b, e, 4), np.float32)
    counts = np.array([e, 251, 0][:b], np.int32)
    for i in range(b):
        n = counts[i]
        ev[i, :n, 0] = rng.uniform(-4, 2100, n)  # some past both sentinels
        ev[i, :n, 1] = rng.uniform(-4, 1100, n)
        ev[i, :n, 2] = np.sort(rng.uniform(2.0, 2.5, n))
        ev[i, :n, 3] = rng.integers(0, 2, n)
    return ev, counts


@pytest.mark.parametrize("codec", ["u16", "u32"])
def test_codec_is_bit_for_bit_jax(codec):
    ev, counts = _packed(np.random.default_rng(2))
    enc_fn = {"u16": jcodec.encode_events_u16,
              "u32": jcodec.encode_events_u32}[codec]
    want_w, want_t = enc_fn(ev, counts)
    words, t_range, raw = tcodec.encode_for_transfer(ev, counts, True,
                                                     codec=codec)
    np.testing.assert_array_equal(raw, want_w)
    np.testing.assert_array_equal(t_range, want_t)
    assert words.dtype == (np.int32 if codec == "u32" else np.int16)
    dec_j = {"u16": jcodec.decode_events_u16,
             "u32": jcodec.decode_events_u32}[codec]
    dec_t = {"u16": tcodec.decode_events_u16,
             "u32": tcodec.decode_events_u32}[codec]
    want = np.asarray(dec_j(jnp.asarray(want_w), jnp.asarray(want_t)))
    for w in (words, raw):  # the signed view and the unsigned words
        got = dec_t(torch.from_numpy(w), torch.from_numpy(t_range)).numpy()
        assert got.dtype == np.float32
        np.testing.assert_array_equal(got.view(np.uint32),
                                      want.view(np.uint32))


def test_codec_full_encode_and_f32_transfer_match_jax():
    ev, counts = _packed(np.random.default_rng(3))
    t_range = np.array([[2.0, 2.5], [2.1, 2.1], [0.0, 1.0]], np.float32)
    np.testing.assert_array_equal(
        tcodec.encode_events_u32_full(ev, t_range),
        jcodec.encode_events_u32_full(ev, t_range))
    events, tr, _ = tcodec.encode_for_transfer(ev, counts, False)
    assert events is ev and not tr.any() and tr.shape == (3, 2)


# ---------------------------------------------------------- pipeline


def _cfgs(codec):
    common = dict(num_classes=NUM_CLASSES, input_size=32,
                  fix_events_num=1000, val_fix_events_num=1000,
                  canvas_height=48, canvas_width=56,
                  compact_transfer=codec != "f32",
                  transfer_codec="u16" if codec == "u16" else "u32")
    return jcp.ClsDataConfig(**common), tcp.ClsDataConfig(**common)


def _sources():
    kw = dict(num_classes=NUM_CLASSES, samples_per_class=3, num_events=1200,
              sensor_hw=(40, 50), seed=4)
    return jcp.SyntheticClsSource(**kw), tcp.SyntheticClsSource(**kw)


# the decoded events and the windows are exact; the rasterisation and the
# resize contractions sum in other orders
PIPE_ATOL = 1e-5


@pytest.mark.parametrize("codec", ["u32", "u16", "f32"])
@pytest.mark.parametrize("train", [True, False], ids=["train", "eval"])
def test_cls_pipeline_batches_match_jax(codec, train):
    """Both pipelines on their C++ host code: the fused augment and pack
    from the seeds each draws, the C++ u32 encoder."""
    _check_cls_pipelines(codec, train)


def test_cls_pipeline_batches_match_jax_numpy_specification(numpy_native):
    """Both pipelines on their numpy host code (erase-and-add from the
    pipeline's generator, the numpy pack and encoder)."""
    _check_cls_pipelines("u32", True)


def _check_cls_pipelines(codec, train):
    jcfg, tcfg = _cfgs(codec)
    jsrc, tsrc = _sources()
    for i in range(len(tsrc)):
        a, b = jsrc.load(i), tsrc.load(i)
        np.testing.assert_array_equal(a[0], b[0])
        assert a[1] == b[1]
    want = list(jcp.ClsPipeline(jsrc, jcfg, B, train=train, seed=7,
                                num_workers=0))
    pipe = tcp.ClsPipeline(tsrc, tcfg, B, train=train, seed=7,
                           num_workers=2, device="cpu")
    got = list(pipe)
    # train drops the tail; eval wraps it and counts its real rows
    assert len(got) == len(want) == (1 if train else 2)
    assert pipe.batches == len(got) and pipe.host_seconds > 0
    for g, w in zip(got, want):
        assert g["evg"].shape == (B, 32, 32, 5) and g["evg"].dtype == \
            torch.float32
        np.testing.assert_allclose(g["evg"].numpy(), np.asarray(w["evg"]),
                                   atol=PIPE_ATOL)
        np.testing.assert_array_equal(g["label"].numpy(),
                                      np.asarray(w["label"]))
        assert g["num_valid"] == int(w["num_valid"])
    if not train:
        assert got[-1]["num_valid"] == 2


def test_val_event_noise_augments_as_jax():
    """Under ``event_noise`` the JAX pipeline erases and adds events in
    eval too (its numpy fallback calls ``erase_and_add_events``)."""
    jcfg, tcfg = _cfgs("u32")
    jcfg = jcp.ClsDataConfig(**{**jcfg.__dict__, "event_noise": True})
    tcfg = tcp.ClsDataConfig(**{**tcfg.__dict__, "event_noise": True})
    jsrc, tsrc = _sources()
    want = next(iter(jcp.ClsPipeline(jsrc, jcfg, B, train=False, seed=1,
                                     num_workers=0)))
    got = next(iter(tcp.ClsPipeline(tsrc, tcfg, B, train=False, seed=1,
                                    num_workers=0, device="cpu")))
    np.testing.assert_allclose(got["evg"].numpy(), np.asarray(want["evg"]),
                               atol=PIPE_ATOL)


def test_ncars_source_lists_as_jax(tmp_path):
    rng = np.random.default_rng(5)
    for cls in ("cars", "background"):
        (tmp_path / cls).mkdir()
        for k in range(3):
            np.save(tmp_path / cls / f"{cls}_{k}.npy",
                    rng.normal(size=(20 + k, 4)))
    want, got = jcp.NCarsSource(str(tmp_path)), tcp.NCarsSource(
        str(tmp_path))
    assert got.files == want.files and len(got) == 6
    ev, label = got.load(4)
    np.testing.assert_array_equal(ev, want.load(4)[0])
    assert label == want.load(4)[1] == 1


# ----------------------------------------------------- loss and metrics


@pytest.mark.parametrize("smoothing", [0.0, 0.1])
def test_cls_loss_matches_jax(smoothing):
    rng = np.random.default_rng(6)
    logits = rng.normal(size=(8, 5)).astype(np.float32) * 3
    labels = rng.integers(0, 5, 8)
    want = float(j_cls_loss(jnp.asarray(logits), jnp.asarray(labels),
                            smoothing))
    got = cls_loss(torch.from_numpy(logits), torch.from_numpy(labels),
                   smoothing)
    assert got.dtype == torch.float32
    np.testing.assert_allclose(float(got), want, rtol=1e-6)
    bf = cls_loss(torch.from_numpy(logits).to(torch.bfloat16),
                  torch.from_numpy(labels), smoothing)
    assert bf.dtype == torch.float32  # computed in f32 whatever the logits


@pytest.mark.parametrize("k", [2, 7])
def test_topk_accuracy_matches_jax_with_ties_and_weights(k):
    rng = np.random.default_rng(k)
    logits = rng.integers(0, 3, (16, k)).astype(np.float32)  # many ties
    labels = rng.integers(0, k, 16)
    weights = (np.arange(16) < 11).astype(np.float32)
    topk = (1,) if k < 5 else (1, 5)
    for w in (None, weights):
        want = j_topk(jnp.asarray(logits), jnp.asarray(labels), topk,
                      None if w is None else jnp.asarray(w))
        got = topk_accuracy(torch.from_numpy(logits),
                            torch.from_numpy(labels), topk,
                            None if w is None else torch.from_numpy(w))
        assert set(got) == set(want)
        for name in want:
            np.testing.assert_allclose(float(got[name]), float(want[name]),
                                       rtol=1e-6)


# ------------------------------------------- drop-path and the dispatch


def test_drop_path_needs_an_explicit_source_and_replays():
    blk = tlayers.DropPath(0.25).train()
    x = torch.ones((4, 3, 2))
    with pytest.raises(ValueError, match="no generator"):
        blk(x)
    tlayers.set_drop_path_source(blk, tlayers.DropPathSource(
        torch.Generator().manual_seed(3)))
    a = blk(x)
    tlayers.set_drop_path_source(blk, tlayers.DropPathSource(
        torch.Generator().manual_seed(3)))
    torch.testing.assert_close(blk(x), a, rtol=0, atol=0)
    keep = torch.tensor([[True, False, True, True]])
    tlayers.set_drop_path_source(blk, tlayers.DropPathSource(keep=keep))
    got = blk(x)
    want = jnp.where(jnp.asarray(keep[0].numpy())[:, None, None],
                     jnp.ones((4, 3, 2)) / 0.75, 0.0)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    with pytest.raises(ValueError, match="asks for more"):
        blk(x)
    assert blk.eval()(x) is x  # deterministic: no draw


def _spy(monkeypatch, name):
    calls = []
    real = getattr(tlayers, name)

    def spy(*args, **kw):
        calls.append(args[0].shape)
        return real(*args, **kw)

    monkeypatch.setattr(tlayers, name, spy)
    return calls


def test_block_dispatch_takes_k4_in_training_and_k5_for_attention_maps(
        monkeypatch, jax_params):
    hub = _carry(jax_params, torch.bfloat16)
    calls = {n: _spy(monkeypatch, n) for n in (
        "fused_attn_layer", "fused_mlp", "fused_ln_attn_layer",
        "fused_ln_mlp")}
    tb = _tb(_batch(0))
    evg = tb["evg"]

    def counts():
        out = {n: len(c) for n, c in calls.items()}
        for c in calls.values():
            c.clear()
        return out

    hub.train()
    tlayers.set_drop_path_source(hub, tlayers.DropPathSource(
        keep=tb["drop_path_keep"]))
    hub(evg)[1].float().sum().backward()
    # block 0 (rate 0) fuses; blocks 1, 2 take K4 and the plain MLP
    assert counts() == {"fused_attn_layer": 2, "fused_mlp": 0,
                        "fused_ln_attn_layer": 1, "fused_ln_mlp": 1}
    hub.eval()
    with torch.no_grad():
        _, _, attn = hub(evg, return_attn=True)
    assert attn.shape == (B, 4, 16, 16)
    # the last block returns its weights, so it cannot fuse: its MLP is K5
    assert counts() == {"fused_attn_layer": 0, "fused_mlp": 1,
                        "fused_ln_attn_layer": 2, "fused_ln_mlp": 2}
    for blk in hub.backbone.vit_block:
        blk.use_fused_layer = False
    with torch.no_grad():
        hub(evg, return_attn=True)
    hub.train()
    tlayers.set_drop_path_source(hub, tlayers.DropPathSource(
        keep=tb["drop_path_keep"]))
    hub(evg)
    assert counts() == dict.fromkeys(calls, 0)


# BF16: both sides round at the same points in K1/K2/K4/K5 but sum in other
# orders, so a rounded intermediate may land one bf16 ulp apart; the
# differences add up over 3 blocks, forward and backward.
BF16_LOSS_REL = 5e-3
BF16_GRAD_REL = 5e-2


def test_bf16_train_step_through_k4_matches_jax_kernels(monkeypatch,
                                                        jax_params):
    """JAX under force_fused() runs K1/K2 on block 0 and K4 (Pallas, in
    interpret mode) on the drop-path blocks; the port runs their plain
    versions. Same init, the same replayed masks: loss and every gradient."""
    b = _batch(1)
    jhub = j_hub(NUM_CLASSES, dtype=jnp.bfloat16, **TINY)

    def loss_fn(params):
        _, logits, _ = jhub.apply({"params": params}, jnp.asarray(b["evg"]),
                                  train=True,
                                  rngs={"dropout": jax.random.key(0)})
        return j_cls_loss(logits, jnp.asarray(b["label"]), 0.1)

    replay = _ReplayDropPath(b["keep"])
    monkeypatch.setattr(jlayers, "drop_path", replay)
    with force_fused():
        want_loss, want_g = jax.value_and_grad(loss_fn)(jax_params)
    assert replay.calls == SITES
    want_g = export_torch_state_dict(want_g)
    hub = _carry(jax_params, torch.bfloat16).train()
    tb = _tb(b)
    tlayers.set_drop_path_source(hub, tlayers.DropPathSource(
        keep=tb["drop_path_keep"]))
    loss = cls_loss(hub(tb["evg"])[1], tb["label"], 0.1)
    loss.backward()
    assert abs(loss.item() - float(want_loss)) <= BF16_LOSS_REL * abs(
        float(want_loss))
    for n, p in hub.named_parameters():
        assert p.grad is not None and p.grad.dtype == torch.float32, n
        assert _rel_err(p.grad.numpy(), want_g[n]) <= BF16_GRAD_REL, n


def test_bf16_attention_map_forward_through_k5_matches_jax(jax_params):
    """``return_attn`` in eval: JAX under force_fused() runs the last
    block's MLP through K5 (Pallas, interpret mode) and the others through
    K1/K2; the port the plain versions of the same kernels."""
    b = _batch(2)
    jhub = j_hub(NUM_CLASSES, dtype=jnp.bfloat16, **TINY)
    with force_fused():
        _, want, want_attn = jax.jit(lambda p, x: jhub.apply(
            {"params": p}, x, return_attn=True))(jax_params,
                                                 jnp.asarray(b["evg"]))
    hub = _carry(jax_params, torch.bfloat16).eval()
    with torch.no_grad():
        _, got, attn = hub(torch.from_numpy(b["evg"]), return_attn=True)
    want = np.asarray(want, np.float32)
    assert _rel_err(got.float().numpy(), want) <= BF16_GRAD_REL
    np.testing.assert_allclose(attn.float().numpy(),
                               np.asarray(want_attn, np.float32), atol=2e-2)


# ------------------------------------------------------ trajectories


def _schedule():
    return (1e-3, 1e-5, 1, 3, 2)  # update 0 at lr 0, then warm, then cosine


@pytest.mark.parametrize("clip", [5.0, 0.05], ids=["clip5", "clip_binding"])
def test_f32_cls_trajectory_matches_jax(monkeypatch, jax_params, clip):
    """3 make_cls_train_step updates from the same init, with drop-path 0.1
    (replayed masks), label smoothing 0.1, the global-norm clip (5, the
    CLI's default, and 0.05, which binds at every step) and layer decay
    0.75: loss, grad norm and accuracy at each step and the final params
    agree at 1e-4 of scale (f32 on both sides; sums in other orders)."""
    jhub = j_hub(NUM_CLASSES, **TINY)
    sched = joptim.cosine_warmup_schedule(*_schedule())
    tx = joptim.build_optimizer(jax_params, learning_rate=sched,
                                weight_decay=0.05, betas=(0.9, 0.999),
                                layer_decay=0.75, num_layers=12,
                                clip_grad=clip)
    jstate = JTrainState.create(apply_fn=jhub.apply,
                                params=jax.tree.map(jnp.copy, jax_params),
                                tx=tx)
    hub = _carry(jax_params)
    opt = toptim.build_optimizer(hub, weight_decay=0.05, betas=(0.9, 0.999),
                                 layer_decay=0.75, num_layers=12)
    state = TrainState(hub, opt, toptim.cosine_warmup_schedule(*_schedule()),
                       clip_grad=clip)
    step = make_cls_train_step(hub, smoothing=0.1)
    # one compiled JAX step for the three: each batch carries its masks
    replay = _BatchReplayDropPath()
    monkeypatch.setattr(jlayers, "drop_path", replay)
    jstep = j_make_train(jhub, smoothing=0.1,
                         preprocess_fn=replay.preprocess)
    for i in range(3):
        b = _batch(10 + i)
        jstate, jm = jstep(jstate, {
            "evg": jnp.asarray(replay.pack(b["evg"], b["keep"])),
            "label": jnp.asarray(b["label"])}, jax.random.key(i))
        assert replay.calls == SITES
        tm = step(state, _tb(b))
        if clip < 1.0:
            assert float(jm["grad_norm"]) > clip
        for k in ("loss", "grad_norm", "acc1"):
            np.testing.assert_allclose(float(tm[k]), float(jm[k]), rtol=1e-4,
                                       err_msg=f"step {i} {k}")
    assert state.step == 3
    want = export_torch_state_dict(jstate.params)
    lr_sum = sum(toptim.cosine_warmup_schedule(*_schedule())(i)
                 for i in range(3))
    for n, p in hub.named_parameters():
        got, w = p.detach().numpy().copy(), want[n].copy()
        if n.endswith("attn.qkv.bias"):
            # softmax is invariant to the key bias, so its gradient is zero
            # up to rounding and Adam scales that noise to a whole step:
            # hold the key slice to the steps' size, the rest at 1e-4
            c = got.shape[0] // 3
            assert np.abs(got[c:2 * c] - w[c:2 * c]).max() <= 2 * lr_sum, n
            got[c:2 * c] = w[c:2 * c] = 0.0
        assert _rel_err(got, w) <= 1e-4, n


def test_replayed_mask_count_is_checked(jax_params):
    hub = _carry(jax_params)
    state = TrainState(hub, toptim.build_optimizer(hub), lambda s: 0.0)
    tb = _tb(_batch(3))
    tb["drop_path_keep"] = tb["drop_path_keep"][:SITES - 1]
    with pytest.raises(ValueError, match="asks for more"):
        make_cls_train_step(hub)(state, tb)
    tb = _tb(_batch(3))
    tb["drop_path_keep"] = torch.ones((SITES + 1, B), dtype=torch.bool)
    with pytest.raises(ValueError, match="the model used 4"):
        make_cls_train_step(hub)(state, tb)


def test_linprob_freezes_the_backbone(jax_params):
    """``requires_grad=False`` on the backbone (``--linprob``): only the
    head gets gradients and moves, as JAX's trainable mask does."""
    hub = _carry(jax_params)
    for n, p in hub.named_parameters():
        p.requires_grad_(n.startswith("classify_head."))
    before = {n: p.detach().clone() for n, p in hub.named_parameters()}
    state = TrainState(hub, toptim.build_optimizer(hub, betas=(0.9, 0.999)),
                       lambda s: 1e-2, clip_grad=5.0)
    m = make_cls_train_step(hub, smoothing=0.1,
                            generator=torch.Generator().manual_seed(0))(
        state, {k: v for k, v in _tb(_batch(4)).items()
                if k != "drop_path_keep"})
    assert np.isfinite(float(m["grad_norm"]))
    for n, p in hub.named_parameters():
        moved = not torch.equal(p.detach(), before[n])
        assert moved == n.startswith("classify_head."), n


def test_eval_step_and_evaluate_weight_pads_as_jax(jax_params):
    """Two batches, the second a wrapped tail with 3 real rows of 4: each
    batch's metrics and the weighted means over the epoch."""
    jhub = j_hub(NUM_CLASSES, **TINY)
    jstate = JTrainState.create(
        apply_fn=jhub.apply, params=jax_params,
        tx=joptim.build_optimizer(jax_params, learning_rate=0.0))
    jstep = j_make_eval(jhub)
    hub = _carry(jax_params)
    step = make_cls_eval_step(hub)
    batches = [_batch(20), _batch(21)]
    jb = [{"evg": jnp.asarray(b["evg"]), "label": jnp.asarray(b["label"]),
           "num_valid": jnp.asarray(n, jnp.int32)}
          for b, n in zip(batches, (B, 3))]
    tb = [{"evg": torch.from_numpy(b["evg"]),
           "label": torch.from_numpy(b["label"]).long(), "num_valid": n}
          for b, n in zip(batches, (B, 3))]
    for j, t in zip(jb, tb):
        want, got = jstep(jstate, j), step(t)
        assert set(got) == set(want)
        for k in want:
            np.testing.assert_allclose(float(got[k]), float(want[k]),
                                       rtol=1e-5, err_msg=k)
    want = j_evaluate(jstep, jstate, jb)
    got = evaluate(step, tb)
    assert set(got) == set(want)
    for k in want:
        np.testing.assert_allclose(got[k], want[k], rtol=1e-5, err_msg=k)
    assert not hub.training


# ------------------------------------------------------------------ CLI


def test_cli_trains_evaluates_and_writes_a_loadable_checkpoint(tmp_path):
    from eventpretrain_tpu_torch.cli.finetune_cls import build_parser, main

    assert build_parser().parse_args([]).device == "cuda"
    out = tmp_path / "ft"
    res = main(["--device", "cpu", "--input_size", "32", "--batch_size",
                "32", "--epochs", "1", "--num_workers", "0",
                "--fix_events_num", "1000", "--val_fix_events_num", "1000",
                "--print_freq", "2", "--output_dir", str(out)])
    assert res["state"].step == 4  # 128 synthetic samples / 32
    assert set(res["val"]) >= {"loss", "acc1", "infer_ms"}
    record = json.loads((out / "log.txt").read_text().splitlines()[-1])
    assert record["epoch"] == 0 and "train_loss" in record
    sd = load_torch_checkpoint(str(out / "checkpoint.pth"))
    hub = cls_hub_vit_small(NUM_CLASSES, device="cpu", input_size=32)
    load_jax_state_dict(hub, sd)
    for k, v in res["state"].module.state_dict().items():
        torch.testing.assert_close(hub.state_dict()[k], v, rtol=0, atol=0)


def test_cli_finetunes_from_a_pretrain_checkpoint(tmp_path):
    from eventpretrain_tpu_torch.cli.finetune_cls import load_backbone, main
    from eventpretrain_tpu_torch.cli.pretrain import main as pretrain_main

    pre = tmp_path / "pre"
    pretrain_main(["--pr_phase", "rec", "--device", "cpu", "--model_size",
                   "small", "--input_size", "32", "--batch_size", "16",
                   "--epochs", "1", "--num_workers", "0",
                   "--output_dir", str(pre)])
    ckpt = str(pre / "checkpoint.pth")
    sd = load_torch_checkpoint(ckpt)
    hub = cls_hub_vit_small(NUM_CLASSES, device="cpu", input_size=32)
    load_backbone(hub, ckpt)
    for k, v in hub.backbone.state_dict().items():
        torch.testing.assert_close(v, sd[f"backbone.{k}"], rtol=0, atol=0)
    # a backbone of another width does not load
    with pytest.raises(RuntimeError, match="size mismatch"):
        load_backbone(cls_hub_vit_small(NUM_CLASSES, device="cpu",
                                        input_size=32, embed_dim=128,
                                        num_heads=4), ckpt)
    res = main(["--device", "cpu", "--input_size", "32", "--batch_size",
                "64", "--epochs", "1", "--num_workers", "0",
                "--fix_events_num", "1000", "--val_fix_events_num", "1000",
                "--finetune", ckpt, "--linprob",
                "--output_dir", str(tmp_path / "ft")])
    assert res["state"].step == 2
    # --linprob: the loaded backbone did not move
    for k, v in res["state"].module.backbone.state_dict().items():
        torch.testing.assert_close(v, sd[f"backbone.{k}"], rtol=0, atol=0)


@pytest.mark.parametrize("flags", [
    ["--accum_iter", "0"], ["--resume", "x"], ["--visualize"],
    ["--export_torch", "x.pth"], ["--backbone", "swin_ecddp"],
    ["--dataset", "n_imagenet"], ["--num_bins", "3"],
], ids=lambda f: f[0].lstrip("-"))
def test_cli_refuses_flags_of_later_slices(flags):
    """Each flag of a later slice exits naming it; ``--accum_iter`` refuses
    only a count below 1. The other datasets, ``--num_bins 3`` and
    ``--backbone swin_ecddp`` are ported: a dataset exits only for want of
    its roots, and the MEM image and ECDDP's Swin (slice 5e) pass the
    refusals."""
    from eventpretrain_tpu_torch.cli.finetune_cls import (
        _refuse_unported,
        build_parser,
        main,
    )

    if flags[0] in ("--num_bins", "--backbone"):
        _refuse_unported(build_parser().parse_args(flags))
        return
    match = {"--accum_iter": "at least 1",
             "--dataset": "--train_root/--val_root"}.get(flags[0], "slice")
    with pytest.raises(SystemExit, match=match):
        main(["--device", "cpu", *flags])
