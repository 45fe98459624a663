"""The port's optical-flow slice against the JAX package on the CPU.

The same numpy-seeded inputs go through the JAX function and its port:
``resize_flow``, the flow label and validity augments, the L1 objective,
``flow_error``, the flow branch of the dense pipeline (both on their C++
host code, at a sensor whose last tile row and column are partial, as
MVSEC's 260x346 is), the train step of a tiny f32 dense hub with two
output channels carried across with ``export_torch_state_dict`` ->
``load_jax_state_dict`` (loss, gradients and one AdamW update), the eval
step's sums, the MVSEC reader on an HDF5 fixture in the reference layout,
and the CLI. Drop-path masks are drawn with numpy and replayed on both
sides; the heads' dropout is 0. Every test passes ``device="cpu"``.
"""

import os
import sys

import h5py
import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from eventpretrain_tpu import native as jnative
from eventpretrain_tpu.ckpt.torch_export import export_torch_state_dict
from eventpretrain_tpu.data import dense_pipeline as jdp
from eventpretrain_tpu.data import mvsec as jmvsec
from eventpretrain_tpu.eval.metrics import flow_error as j_flow_error
from eventpretrain_tpu.models import layers as jlayers
from eventpretrain_tpu.models.dense_hub import dense_hub_vit_small as j_hub
from eventpretrain_tpu.objectives.flow import flow_l1_loss as j_flow_l1
from eventpretrain_tpu.ops.reshape import resize_flow as j_resize_flow
from eventpretrain_tpu.ops.view_augment import (
    ViewParams as JViewParams,
    apply_flow_label_augment as j_flow_augment,
    apply_flow_valid_augment as j_valid_augment,
)
from eventpretrain_tpu.train import optim as joptim
from eventpretrain_tpu.train.state import TrainState as JTrainState
from eventpretrain_tpu.train.steps import (
    make_flow_eval_step as j_make_eval,
    make_flow_train_step as j_make_train,
)
from eventpretrain_tpu_torch import native as tnative
from eventpretrain_tpu_torch.ckpt.bridge import load_jax_state_dict
from eventpretrain_tpu_torch.cli import finetune_flow
from eventpretrain_tpu_torch.data import dense_pipeline as tdp
from eventpretrain_tpu_torch.data import mvsec as tmvsec
from eventpretrain_tpu_torch.eval.metrics import flow_error
from eventpretrain_tpu_torch.models.dense_hub import dense_hub_vit_small
from eventpretrain_tpu_torch.objectives.flow import flow_l1_loss
from eventpretrain_tpu_torch.ops.reshape import resize_flow
from eventpretrain_tpu_torch.ops.view_augment import (
    ViewParams,
    apply_flow_label_augment,
    apply_flow_valid_augment,
)
from eventpretrain_tpu_torch.train import optim as toptim
from eventpretrain_tpu_torch.train.state import TrainState
from eventpretrain_tpu_torch.train.steps import (
    make_flow_eval_step,
    make_flow_train_step,
)

from tests._port_threads import one_torch_thread  # noqa: F401

H, W, NB = 200, 300, 5  # 2x3 tiles of 128, the last row and column partial
# the tiny hub: 32x32 input, patch 8 -> 4x4 tokens, every block a pyramid
# level; drop-path rates linspace(0, 0.1, 4): blocks 1-3 draw, 2 calls each
TINY = dict(input_size=32, patch_size=8, embed_dim=64, depth=4, num_heads=2,
            out_indices=(0, 1, 2, 3), drop_path_rate=0.1)
SITES = 6
B = 4  # the pooled 1x1 map's BatchNorm needs a few samples (dense tests)
LABEL_HW = (12, 20)


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


def _rel_err(got, want):
    return float(np.abs(got - want).max() / max(np.abs(want).max(), 1e-30))


def _flows(rng, shape, invalid=True):
    flow = rng.normal(0, 4, shape + (2,)).astype(np.float32)
    valid = (rng.random(shape) < 0.8).astype(np.float32)
    if invalid:
        flow[..., :3, :] = 500.0  # over max_flow
    return flow, valid


# ------------------------------------------------ ops, objective, metric


@pytest.mark.parametrize("mode", ["bilinear", "nearest", "bicubic"])
def test_resize_flow_matches_jax(mode):
    """The resize and the vector scale, up and down, at f32 within 1e-5
    of the output's scale (the contractions sum in other orders)."""
    x, _ = _flows(np.random.default_rng(0), (2, 14, 22), invalid=False)
    for size in ((14, 22), (56, 88), (7, 9)):
        want = np.asarray(j_resize_flow(jnp.asarray(x), size, mode))
        got = resize_flow(torch.from_numpy(x), size, mode).numpy()
        assert got.shape == want.shape
        assert _rel_err(got, want) <= 1e-5, size


def _view_params(rng, b, h, w):
    ys = rng.integers(0, h // 3, b)
    xs = rng.integers(0, w // 3, b)
    hs = rng.integers(h // 2, h - h // 3, b)
    ws = rng.integers(w // 2, w - w // 3, b)
    hf = np.array([True, False, True, False][:b])
    tf = np.array([False, True, True, False][:b])
    arrays = [a.astype(np.int32) for a in (ys, xs, hs, ws)] + [hf, tf]
    return (JViewParams(*map(jnp.asarray, arrays)),
            ViewParams(*map(torch.from_numpy, arrays)))


def test_flow_augments_match_jax():
    """Crop, nearest resize, the vectors scaled by out / crop; hflip
    mirrors and negates u, a time flip negates both: equal to the bit, and
    the validity mask likewise."""
    rng = np.random.default_rng(1)
    flow, valid = _flows(rng, (4, 40, 60))
    jp, tp = _view_params(rng, 4, 40, 60)
    augment = jax.jit(j_flow_augment, static_argnums=2,
                      static_argnames="use_tflip")
    augment_valid = jax.jit(j_valid_augment, static_argnums=2)
    for size in ((40, 60), (24, 36), (50, 70)):
        want = np.asarray(augment(jnp.asarray(flow), jp, size))
        got = apply_flow_label_augment(torch.from_numpy(flow), tp, size)
        np.testing.assert_array_equal(got.numpy(), want)
        want_v = np.asarray(augment_valid(jnp.asarray(valid), jp, size))
        got_v = apply_flow_valid_augment(torch.from_numpy(valid), tp, size)
        np.testing.assert_array_equal(got_v.numpy(), want_v)
    want = np.asarray(augment(jnp.asarray(flow), jp, (24, 36),
                              use_tflip=False))
    got = apply_flow_label_augment(torch.from_numpy(flow), tp, (24, 36),
                                   use_tflip=False)
    np.testing.assert_array_equal(got.numpy(), want)


def test_flow_l1_loss_and_flow_error_match_jax():
    """The masked L1 (flows over max_flow and invalid pixels left out, an
    all-invalid batch divides by 1) and AEE / outlier share, within 1e-6
    relative."""
    rng = np.random.default_rng(2)
    target, valid = _flows(rng, (2, 10, 12))
    pred = target + rng.normal(0, 3, target.shape).astype(np.float32)
    for v in (valid, np.zeros_like(valid)):
        want = float(j_flow_l1(jnp.asarray(pred), jnp.asarray(target),
                               jnp.asarray(v), 400.0))
        got = float(flow_l1_loss(torch.from_numpy(pred),
                                 torch.from_numpy(target),
                                 torch.from_numpy(v), 400.0))
        np.testing.assert_allclose(got, want, rtol=1e-6)
    for v in (None, valid):
        want = j_flow_error(jnp.asarray(pred), jnp.asarray(target),
                            None if v is None else jnp.asarray(v))
        got = flow_error(torch.from_numpy(pred), torch.from_numpy(target),
                         None if v is None else torch.from_numpy(v))
        for g, w in zip(got, want):
            np.testing.assert_allclose(float(g), float(w), rtol=1e-6)


# ---------------------------------------------------------- the pipeline


@pytest.mark.parametrize("tiled,compact,train,label_hw", [
    ("on", False, True, (H, W)), ("on", True, False, (100, 150)),
    ("off", False, True, (100, 150))],
    ids=["tiled_f32_train", "tiled_u32_eval", "untiled_f32_train"])
def test_flow_pipeline_batches_match_jax(tiled, compact, train, label_hw):
    """Two batches of JAX's flow pipeline and the port's from one seed,
    both on their C++ host code: the flow, the validity and the event mask
    exactly (the gt as f16 on the wire under ``compact_transfer``, as in
    JAX), the grid within 1e-4 of its scale (JAX's tiled grid goes through
    the hi+lo kernel, the untiled one through the f32 scatter)."""
    kw = dict(task="flow", num_bins=NB, input_size=32, fix_events_num=3000,
              val_fix_events_num=3000, sensor_height=H, sensor_width=W,
              label_size=label_hw, tiled_raster=tiled,
              compact_transfer=compact)
    src = dict(n=4, sensor_hw=(H, W), num_events=3000)
    jpipe = jdp.DensePipeline(jdp.SyntheticDenseSource("flow", **src),
                              jdp.DenseDataConfig(**kw), 2, train, seed=7)
    tpipe = tdp.DensePipeline(tdp.SyntheticDenseSource("flow", **src),
                              tdp.DenseDataConfig(**kw), 2, train, seed=7,
                              device="cpu")
    assert tpipe.tiled == (tiled == "on")
    n = 0
    for jb, tb in zip(jpipe, tpipe):
        assert set(tb) == {"evg", "flow", "valid", "event_mask", "num_valid"}
        assert tb["flow"].shape == (2, *label_hw, 2)
        for k in ("flow", "valid", "event_mask"):
            assert tb[k].dtype == torch.float32
            np.testing.assert_array_equal(tb[k].numpy(), np.asarray(jb[k]),
                                          err_msg=k)
        assert tb["event_mask"].sum() > 0
        assert _rel_err(tb["evg"].numpy(), np.asarray(jb["evg"])) <= 1e-4
        n += 1
    assert n == 2


# ------------------------------------------------------- the hub's steps


@pytest.fixture(scope="module")
def jax_vars():
    hub = j_hub(2, **TINY).clone(decode_dropout=0.0)
    v = jax.jit(hub.init)(jax.random.key(0), jnp.zeros((1, 32, 32, NB)))
    rng = np.random.default_rng(6)
    # running statistics away from their init, so eval mode reads them
    stats = jax.tree.map(
        lambda a: jnp.asarray(rng.uniform(0.5, 1.5, a.shape), jnp.float32),
        v["batch_stats"])
    return {"params": v["params"], "batch_stats": stats}


def _carry(jv):
    hub = dense_hub_vit_small(2, device="cpu", decode_dropout=0.0, **TINY)
    return load_jax_state_dict(
        hub, export_torch_state_dict(jv["params"], jv["batch_stats"]))


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


def _step_batch(seed):
    rng = np.random.default_rng(seed)
    flow, valid = _flows(rng, (B,) + LABEL_HW)
    evg = rng.normal(size=(B, 32, 32, NB)).astype(np.float32)
    evg[:, :8] = 0.0  # no events in the top rows: the sparse mask
    return dict(evg=evg, flow=flow, valid=valid,
                keep=rng.random((SITES, B)) < 0.9)


def _keeping_grads(tx):
    """``tx`` that also keeps the gradients it was handed in its state, so
    JAX's step returns them beside the update it made of them."""
    def init(params):
        return tx.init(params), jax.tree.map(jnp.zeros_like, params)

    def update(grads, state, params=None):
        updates, inner = tx.update(grads, state[0], params)
        return updates, (inner, grads)

    return optax.GradientTransformation(init, update)


def test_f32_flow_train_step_matches_jax(monkeypatch, jax_vars):
    """One make_flow_train_step at f32 with drop-path 0.1 (replayed masks)
    and the CLI's AdamW (clip 3.0): the loss, the decode L1 and the grad
    norm within 1e-4 of the loss's scale; every gradient within 1e-4 of
    its tensor's scale; the BatchNorm statistics; then one AdamW update of
    JAX's gradients on the port's optimizer against the update JAX's step
    made of them."""
    sched = (1e-3, 1e-6, 0, 10, 2)  # no warmup: the first step moves
    b = _step_batch(20)
    replay = _ReplayDropPath(b["keep"])
    monkeypatch.setattr(jlayers, "drop_path", replay)
    jhub = j_hub(2, **TINY).clone(decode_dropout=0.0)
    tx = joptim.build_optimizer(
        jax_vars["params"], learning_rate=joptim.cosine_warmup_schedule(
            *sched), weight_decay=0.05, betas=(0.9, 0.999), clip_grad=3.0)
    # copies: the step donates its state
    jstate = JTrainState.create(
        apply_fn=jhub.apply, params=jax.tree.map(jnp.copy, jax_vars["params"]),
        batch_stats=jax.tree.map(jnp.copy, jax_vars["batch_stats"]),
        tx=_keeping_grads(tx))
    jnew, jm = j_make_train(jhub)(jstate, {
        k: jnp.asarray(b[k]) for k in ("evg", "flow", "valid")},
        jax.random.key(0))
    assert replay.calls == SITES

    hub = _carry(jax_vars)
    state = TrainState(
        hub, toptim.build_optimizer(hub, weight_decay=0.05,
                                    betas=(0.9, 0.999)),
        toptim.cosine_warmup_schedule(*sched), clip_grad=3.0)
    grads = {}
    apply = state.apply_gradients

    def capture():
        grads.update({k: p.grad.clone() for k, p in hub.named_parameters()
                      if p.grad is not None})
        return apply()

    monkeypatch.setattr(state, "apply_gradients", capture)
    tm = make_flow_train_step(hub)(state, {
        "evg": torch.from_numpy(b["evg"]), "flow": torch.from_numpy(b["flow"]),
        "valid": torch.from_numpy(b["valid"]),
        "drop_path_keep": torch.from_numpy(b["keep"])})
    assert set(tm) == set(jm) == {"loss", "decode_l1", "grad_norm"}
    scale = abs(float(jm["loss"]))
    for k in ("loss", "decode_l1"):
        assert abs(float(tm[k]) - float(jm[k])) <= 1e-4 * scale, k
    np.testing.assert_allclose(float(tm["grad_norm"]), float(jm["grad_norm"]),
                               rtol=1e-4)
    want_g = export_torch_state_dict(jnew.opt_state[1])
    assert set(grads) <= set(want_g)
    top = max(np.abs(g).max() for g in want_g.values())
    for k, g in grads.items():
        if k.endswith("conv_layer.bias"):
            # a conv bias before a BatchNorm: its gradient is zero but for
            # rounding, on both sides
            assert max(np.abs(g.numpy()).max(),
                       np.abs(want_g[k]).max()) <= 1e-6 * top, k
            continue
        assert _rel_err(g.numpy(), want_g[k]) <= 1e-4, k
    want = export_torch_state_dict(jnew.params, jnew.batch_stats)
    for k, v in hub.state_dict().items():
        if "running_" in k:
            assert _rel_err(v.numpy(), want[k]) <= 1e-4, k

    # the same gradients, JAX's, through the port's AdamW: each component
    # within 1e-3 of the step's lr of JAX's update (Adam divides by the
    # gradient's own size, so where it is near eps a rounding of the clip's
    # norm moves it)
    hub = _carry(jax_vars)
    state = TrainState(
        hub, toptim.build_optimizer(hub, weight_decay=0.05,
                                    betas=(0.9, 0.999)),
        toptim.cosine_warmup_schedule(*sched), clip_grad=3.0)
    for k, p in hub.named_parameters():
        p.grad = torch.tensor(want_g[k]) if k in grads else None
    norm = state.apply_gradients()
    np.testing.assert_allclose(float(norm), float(jm["grad_norm"]),
                               rtol=1e-5)
    lr = toptim.cosine_warmup_schedule(*sched)(0)
    init = export_torch_state_dict(jax_vars["params"])
    for k, v in hub.state_dict().items():
        if k in want and "running_" not in k:
            assert np.abs(v.numpy() - want[k]).max() <= 1e-3 * lr, k
            assert (k in grads) == (not np.array_equal(want[k], init[k])), k


def test_flow_eval_step_sums_match_jax(jax_vars):
    """The eval step's sums at f32 in eval mode: with the pipeline's event
    mask on a wrapped tail batch of 3 real rows, and with the mask taken
    from the grid on a full batch; the count exactly, the sums within 1e-5
    relative."""
    jhub = j_hub(2, **TINY).clone(decode_dropout=0.0)
    jstate = JTrainState.create(
        apply_fn=jhub.apply, params=jax_vars["params"],
        batch_stats=jax_vars["batch_stats"],
        tx=joptim.build_optimizer(jax_vars["params"], learning_rate=0.0))
    jstep = j_make_eval(jhub)
    step = make_flow_eval_step(_carry(jax_vars))
    b = _step_batch(40)
    mask = (np.random.default_rng(41).random((B,) + LABEL_HW) < 0.7
            ).astype(np.float32)
    for extra in ({"event_mask": mask, "num_valid": 3}, {}):
        batch = {**{k: b[k] for k in ("evg", "flow", "valid")}, **extra}
        want = jstep(jstate, {k: jnp.asarray(v) for k, v in batch.items()})
        got = step({k: torch.as_tensor(v) for k, v in batch.items()})
        assert float(got["count"]) == float(want["count"]) > 0
        for k in ("epe_sum", "outlier_sum"):
            np.testing.assert_allclose(float(got[k]), float(want[k]),
                                       rtol=1e-5)


# ------------------------------------------------------------- MVSEC


def _write_mvsec(root, seq, n_images, hw=(6, 8), seed=0):
    """``<seq>_data.hdf5`` and ``<seq>_gt.hdf5`` in the reference layout:
    events (x, y, t, p) at absolute epoch seconds between image
    timestamps 30 ms apart, and gt flow every 50 ms from an offset, so
    some spans lie inside one gt interval and others cross two."""
    rng = np.random.default_rng(seed)
    t0 = 1.5e9
    image_ts = t0 + 0.03 * np.arange(n_images)
    per = rng.integers(0, 6, n_images)
    inds = np.concatenate([[0], np.cumsum(per)[:-1]])
    n = int(per.sum())
    ev = np.stack([rng.integers(0, hw[1], n), rng.integers(0, hw[0], n),
                   np.sort(rng.uniform(image_ts[0], image_ts[-1], n)),
                   rng.choice([-1, 1], n)], 1)
    with h5py.File(os.path.join(root, f"{seq}_data.hdf5"), "w") as f:
        f["davis/left/events"] = ev
        f["davis/left/image_raw_ts"] = image_ts
        f["davis/left/image_raw_event_inds"] = inds
    gt_ts = t0 - 0.01 + 0.05 * np.arange(int(0.03 * n_images / 0.05) + 3)
    flow = rng.normal(0, 1.5, (len(gt_ts) - 1, 2) + hw).astype(np.float32)
    flow[:, :, 0, :2] = 0.0  # zero flow: invalid, and drops warps
    flow[:, 0, 1, 1] = 2000.0  # too long: invalid
    with h5py.File(os.path.join(root, f"{seq}_gt.hdf5"), "w") as f:
        f["davis/left/flow_dist"] = flow
        f["davis/left/flow_dist_ts"] = gt_ts


def test_mvsec_source_matches_jax(tmp_path):
    """Both readers on one fixture: indoor_flying1's seeded 1% train split
    and its complement, and indoor_flying2 with ``skip_num`` 2: the same
    indices and, sample for sample, the same events, flow and validity."""
    for seq in ("indoor_flying1", "indoor_flying2"):
        _write_mvsec(str(tmp_path), seq, 2200)
    for seq, kw in (("indoor_flying1", {}),
                    ("indoor_flying1", {"is_train": False}),
                    ("indoor_flying2", {"skip_num": 2})):
        j = jmvsec.MvsecSource(str(tmp_path), seq, **kw)
        t = tmvsec.MvsecSource(str(tmp_path), seq, **kw)
        assert t.raw_index == j.raw_index
        picks = [0, 1, len(t) // 2, len(t) - 1]
        for i in picks:
            a, b = j.load(i), t.load(i)
            assert set(a) == set(b) == {"events", "flow", "valid"}
            for k in a:
                np.testing.assert_array_equal(b[k], a[k], err_msg=(seq, k))
        assert t.load(picks[-1])["valid"].sum() > 0
        t.close()
    assert tmvsec.VALID_TIME_INDEX == jmvsec.VALID_TIME_INDEX


def test_mvsec_module_imports_without_h5py(monkeypatch):
    """The machine with the card has no h5py: the reader imports it when a
    source is opened, not with the module."""
    import importlib

    monkeypatch.setitem(sys.modules, "h5py", None)
    mod = importlib.reload(tmvsec)
    with pytest.raises(ImportError):
        mod.MvsecSource("/nonexistent", "indoor_flying2")
    monkeypatch.undo()
    importlib.reload(tmvsec)


def test_flow_propagation_matches_jax():
    """``gen_correspond_gt_flow`` over one gt interval (a scale) and over
    four (warped three times), and one ``prop_flow`` step, on fields with
    zero-flow holes."""
    rng = np.random.default_rng(9)
    flows = rng.normal(0, 2, (4, 2, 9, 11)).astype(np.float32)
    flows[:, :, 2:4, 3:5] = 0.0
    ts = np.array([10.0, 10.05, 10.1, 10.15, 10.2])
    for start, end in ((10.01, 10.04), (10.02, 10.19)):
        n = 1 if end <= ts[1] else 4
        want = jmvsec.gen_correspond_gt_flow(flows[:n], ts[:n + 1], start,
                                             end)
        got = tmvsec.gen_correspond_gt_flow(flows[:n], ts[:n + 1], start,
                                            end)
        np.testing.assert_array_equal(got, want)
    args = []
    for mod in (jmvsec, tmvsec):
        xi, yi = np.meshgrid(np.arange(11.0), np.arange(9.0))
        xi, yi = xi.astype(np.float32), yi.astype(np.float32)
        mx, my = np.ones((9, 11), bool), np.ones((9, 11), bool)
        mod.prop_flow(flows[0, 0], flows[0, 1], xi, yi, mx, my, 0.7)
        args.append((xi, yi, mx, my))
    for g, w in zip(args[1], args[0]):
        np.testing.assert_array_equal(g, w)


# ------------------------------------------------------------------ CLI


def test_cli_trains_and_validates_on_the_synthetic_source(monkeypatch,
                                                          tmp_path):
    """One epoch of the CLI on JAX's synthetic flow source, on a tiny hub:
    two steps, finite metrics, a log line and the checkpoints."""
    def tiny(*args, **kw):
        kw.update({k: v for k, v in TINY.items() if k != "input_size"})
        return dense_hub_vit_small(*args, **kw)

    monkeypatch.setattr(finetune_flow, "dense_hub_vit_small", tiny)
    assert finetune_flow.build_parser().parse_args([]).device == "cuda"
    out = tmp_path / "flow"
    res = finetune_flow.main([
        "--device", "cpu", "--backbone", "vit", "--no-bf16",
        "--input_size", "32", "--batch_size", "16", "--epochs", "1",
        "--fix_events_num", "1000", "--val_fix_events_num", "1000",
        "--print_freq", "1", "--output_dir", str(out)])
    assert res["state"].step == 2  # 32 synthetic samples / 16
    val = res["val"]["synthetic"]
    assert val["count"] > 0 and np.isfinite(val["aee"])
    assert res["best_aee"]["synthetic"] == val["aee"]
    assert (out / "log.txt").read_text().count("synthetic_aee") == 1
    assert (out / "checkpoint.pth").is_file()
    assert (out / "best_synthetic.pth").is_file()


@pytest.mark.parametrize("flags", [
    ["--backbone", "swin_ecddp"], ["--visualize"], ["--resume", "x"],
    ["--data_parallel"], ["--num_bins", "3"], ["--dataset", "mvsec"],
], ids=lambda f: f[0].lstrip("-"))
def test_cli_refuses_flags_of_later_slices(flags):
    """Each flag of a later slice exits naming it; MVSEC exits without
    ``--data_root``; ``--num_bins 3`` (the MEM image) and ``--backbone
    swin_ecddp`` (slice 5e) are ported and pass the refusals."""
    base = [] if flags[0] == "--backbone" else ["--backbone", "vit"]
    if flags[0] in ("--num_bins", "--backbone"):
        finetune_flow._refuse_unported(
            finetune_flow.build_parser().parse_args(base + flags))
        return
    match = "data_root" if flags[0] == "--dataset" else "slice"
    with pytest.raises(SystemExit, match=match):
        finetune_flow.main(["--device", "cpu", *base, *flags])
