"""The port's dense slice (semantic segmentation) against the JAX package on
the CPU.

The same numpy-seeded inputs go through the JAX function and its port: the
tile bucketer, the tiled splat K6 (its plain version against the Pallas
kernel in interpret mode), the resize, the label augment, the dense
pipeline with tiling on and off, the heads, the hub, the loss, the metrics,
short training trajectories of a tiny dense hub (depth 4, C=64, 2 heads,
32x32 input, the four blocks as the pyramid) carried across with
``export_torch_state_dict(params, batch_stats)`` ->
``load_jax_state_dict``, the eval step and the CLI. Drop-path masks are
drawn with numpy and replayed on both sides, as in the cls tests; the
heads' dropout is 0 where JAX's draws would have to be reproduced. Both
pipelines run their C++ host code (JAX's library built here from JAX's
source, the port's from its copy), so one seed gives the same batches; one
case forces both to their numpy specifications (``native.BACKEND =
"numpy-forced"``), which also agree. Every test passes ``device="cpu"``.
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
from eventpretrain_tpu.data import dense_pipeline as jdp
from eventpretrain_tpu.eval import metrics as jmetrics
from eventpretrain_tpu.models import dense_heads as jheads
from eventpretrain_tpu.models import layers as jlayers
from eventpretrain_tpu.models.dense_hub import dense_hub_vit_small as j_hub
from eventpretrain_tpu.objectives.semseg import semseg_loss as j_semseg_loss
from eventpretrain_tpu.ops.events import (
    polarity_weights_coordvalid as j_polarity,
)
from eventpretrain_tpu.ops.pallas_voxel import (
    splat_mxu_tiled,
    voxelize_batch_mxu_tiled,
)
from eventpretrain_tpu.ops.reshape import resize as j_resize
from eventpretrain_tpu.ops.view_augment import (
    ViewParams as JViewParams,
    apply_semseg_label_augment as j_label_augment,
)
from eventpretrain_tpu.train import optim as joptim
from eventpretrain_tpu.train.state import TrainState as JTrainState
from eventpretrain_tpu.train.steps import (
    make_semseg_eval_step as j_make_eval,
    make_semseg_train_step as j_make_train,
)
from eventpretrain_tpu_torch import native as tnative
from eventpretrain_tpu_torch.ckpt.bridge import (
    load_jax_state_dict,
    load_torch_checkpoint,
)
from eventpretrain_tpu_torch.data import dense_pipeline as tdp
from eventpretrain_tpu_torch.eval import metrics as tmetrics
from eventpretrain_tpu_torch.models import dense_heads as theads
from eventpretrain_tpu_torch.models.dense_hub import dense_hub_vit_small
from eventpretrain_tpu_torch.models.layers import (
    DropPathSource,
    set_drop_path_source,
)
from eventpretrain_tpu_torch.objectives.semseg import semseg_loss
from eventpretrain_tpu_torch.ops.events import polarity_weights_coordvalid
from eventpretrain_tpu_torch.ops.reshape import resize
from eventpretrain_tpu_torch.ops.splat_tiled import (
    splat_tiled,
    splat_tiled_launch_reference,
    splat_tiled_plan,
    voxelize_batch_tiled,
)
from eventpretrain_tpu_torch.ops.view_augment import (
    ViewParams,
    apply_semseg_label_augment,
)
from eventpretrain_tpu_torch.train import optim as toptim
from eventpretrain_tpu_torch.train.state import TrainState
from eventpretrain_tpu_torch.train.steps import (
    make_semseg_eval_step,
    make_semseg_train_step,
)

from tests._port_threads import one_torch_thread  # noqa: F401

H, W, NB = 200, 300, 5  # ragged tiles: 2x3 of 128x128 over 200x300
CHUNK = 256
# the tiny hub: 32x32 input, patch 8 -> 4x4 tokens; every block is a
# pyramid level; drop-path rates linspace(0, 0.1, 4): blocks 1-3 draw,
# 2 calls each
TINY = dict(input_size=32, patch_size=8, embed_dim=64, depth=4, num_heads=2,
            out_indices=(0, 1, 2, 3), drop_path_rate=0.1)
NUM_CLASSES = 4
IGNORE = 255
SITES = 6
# 4 samples: the pyramid-pooling branch's 1x1 map gives its BatchNorm B
# values per channel, and at B=2 the batch variance E[x^2] - E[x]^2
# cancels to a few ulps, which f32 sums in another order move by 1e-4
B = 4
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


@pytest.fixture
def numpy_native(monkeypatch):
    """Both packages' numpy specifications of their C++ host code."""
    monkeypatch.setattr(jnative, "_LIB", None)
    monkeypatch.setattr(jnative, "BACKEND", "numpy-forced")
    monkeypatch.setattr(tnative, "BACKEND", "numpy-forced")


def _make_batch(counts, cap, rng, strays=True):
    """Events on the 200x300 sensor; with ``strays``, sample 0's first 60
    events lie out of frame (rows and columns past the sensor, negative
    ones, a row inside the last tile row but past H)."""
    b = len(counts)
    ev = np.zeros((b, cap, 4), np.float32)
    for i, n in enumerate(counts):
        ev[i, :n, 0] = rng.integers(0, W, n)
        ev[i, :n, 1] = rng.integers(0, H, n)
        ev[i, :n, 2] = np.sort(rng.random(n).astype(np.float32) * 1e6)
        ev[i, :n, 3] = rng.integers(0, 2, n)
    if strays:
        ev[0, :60, 0] = rng.integers(-5, W + 40, 60)
        ev[0, :60, 1] = rng.integers(-5, 256 + 10, 60)
    return ev, np.asarray(counts, np.int32)


def _rel_err(got, want):
    return float(np.abs(got - want).max() / max(np.abs(want).max(), 1e-30))


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


# --------------------------------------------------------- tile bucketer


@pytest.mark.parametrize("codec", ["f32", "u32"])
def test_bucketer_matches_jax_word_for_word(codec):
    rng = np.random.default_rng(0)
    ev, counts = _make_batch([4000, 0, 700], 4000, rng)
    kw = dict(height=H, width=W, chunk=CHUNK)
    if codec == "u32":
        got = tnative.bucket_pack_event_batch_u32(ev, counts, **kw)
        want = jnative.bucket_pack_event_batch_u32(ev, counts, **kw)
        assert got[0].dtype == want[0].dtype == np.uint32
    else:
        got = tnative.bucket_pack_event_batch(ev, counts, **kw)
        want = jnative.bucket_pack_event_batch(ev, counts, **kw)
    assert len(got) == len(want) == 4
    for g, w in zip(got, want):
        assert g.dtype == w.dtype and g.shape == w.shape
        np.testing.assert_array_equal(g, w)


def test_tile_geometry_is_the_jax_bucketer_s():
    assert (tnative.TILE_H, tnative.TILE_W, tnative.TILE_CHUNK) == (
        jnative.TILE_H, jnative.TILE_W, jnative.TILE_CHUNK)
    assert (tnative.BUCKET_X_SENTINEL, tnative.BUCKET_Y_SENTINEL) == (
        jnative.BUCKET_X_SENTINEL, jnative.BUCKET_Y_SENTINEL)
    for cap in (0, 1, 200_000 + 2000):
        assert tnative.bucket_layout(cap, 440, 640) == jnative._bucket_layout(
            cap, 440, 640, 128, 128, 1024)


# ----------------------------------------------------------- K6, plain


@pytest.fixture(scope="module")
def bucketed():
    rng = np.random.default_rng(1)
    ev, counts = _make_batch([5000, 0, 1700], 5000, rng)
    # the port's bucketer, held word for word against JAX's above
    return ev, counts, tnative.bucket_pack_event_batch(
        ev, counts, height=H, width=W, chunk=CHUNK)


# the JAX kernel carries the weights as a bf16 hi+lo pair (relative error
# ~2^-16 per weight, a few weights per cell): 1e-4 absolute
K6_ATOL = 1e-4


@pytest.mark.parametrize("bins", [True, False], ids=["bin_range", "full"])
def test_voxelize_batch_tiled_matches_jax_kernel(bucketed, bins):
    _, _, (out, table, t_range, chunk_tr) = bucketed
    want = voxelize_batch_mxu_tiled(
        jnp.asarray(out), jnp.asarray(table), jnp.asarray(t_range),
        jnp.asarray(chunk_tr) if bins else None, num_bins=NB, height=H,
        width=W, chunk=CHUNK, interpret=True)
    got = voxelize_batch_tiled(
        torch.from_numpy(out), torch.from_numpy(table),
        torch.from_numpy(t_range),
        torch.from_numpy(chunk_tr) if bins else None, num_bins=NB, height=H,
        width=W, chunk=CHUNK)
    assert got.shape == (3, H, W, NB) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                               atol=K6_ATOL)
    assert np.abs(got[1].numpy()).max() == 0.0  # the zero-count sample


@pytest.mark.parametrize("bins", [True, False], ids=["bin_range", "full"])
def test_splat_tiled_matches_jax_kernel(bucketed, bins):
    """Arbitrary weights, events moved out of their chunk's tile (they add
    nothing), and a bin range that excludes channels which do hold
    weights (skipped, not summed)."""
    _, _, (out, table, _, _) = bucketed
    rng = np.random.default_rng(2)
    b, e, _ = out.shape
    y = out[..., 1].astype(np.int32)
    x = out[..., 0].astype(np.int32)
    x[2, :CHUNK] = 290  # sample 2's first chunk is tile 0: strays
    y[2, :CHUNK] = 150
    w = rng.normal(size=(b, NB, e)).astype(np.float32)
    br = None
    if bins:
        lo = rng.integers(0, NB, (b, e // CHUNK))
        br = np.stack([lo, np.minimum(lo + 1, NB - 1)], -1).astype(np.int32)
    want = splat_mxu_tiled(
        jnp.asarray(y), jnp.asarray(x), jnp.asarray(w), jnp.asarray(table),
        None if br is None else jnp.asarray(br), height=H, width=W,
        chunk=CHUNK, interpret=True)
    args = (torch.from_numpy(y), torch.from_numpy(x), torch.from_numpy(w),
            torch.from_numpy(table),
            None if br is None else torch.from_numpy(br))
    got = splat_tiled(*args, height=H, width=W, chunk=CHUNK)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                               atol=K6_ATOL)
    # the kernel's decomposition at its own plan (two CTAs of 3 and 2
    # channels) and at one channel a CTA
    for pins in ({}, {"cluster": 5}):
        got = splat_tiled_launch_reference(
            *args, height=H, width=W, chunk=CHUNK,
            plan=splat_tiled_plan(128, 128, NB, **pins))
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                                   atol=K6_ATOL)


def test_splat_tiled_refuses_a_layout_that_is_not_chunk_aligned():
    y = torch.zeros((1, 100), dtype=torch.int32)
    w = torch.zeros((1, NB, 100))
    with pytest.raises(ValueError, match="multiple of the chunk"):
        splat_tiled(y, y, w, torch.zeros((1, 1), dtype=torch.int32),
                    height=H, width=W, chunk=CHUNK)
    with pytest.raises(ValueError, match="tile_table"):
        splat_tiled(y[:, :0], y[:, :0], w[..., :0],
                    torch.zeros((1, 1), dtype=torch.int32), height=H,
                    width=W, chunk=CHUNK)


def test_polarity_weights_match_jax(bucketed):
    _, _, (out, _, _, _) = bucketed
    np.testing.assert_array_equal(
        polarity_weights_coordvalid(torch.from_numpy(out), H, W).numpy(),
        np.asarray(j_polarity(jnp.asarray(out), H, W)))


@pytest.mark.parametrize("bins", [NB, 2], ids=["voxel", "count_image"])
def test_tiled_representation_matches_jax(bins):
    """``build_representation`` over a bucketed layout at the default tile
    geometry (chunk 1024): the voxel grid and the 2-bin count image."""
    from eventpretrain_tpu.data.representations import (
        build_representation as j_build,
    )
    from eventpretrain_tpu_torch.data.representations import (
        build_representation,
    )

    rng = np.random.default_rng(3)
    ev, counts = _make_batch([3000, 1200], 3000, rng)
    out, table, t_range, chunk_tr = jnative.bucket_pack_event_batch(
        ev, counts, height=H, width=W)
    want = j_build(jnp.asarray(out), jnp.asarray(counts), num_bins=bins,
                   height=H, width=W, tile_table=jnp.asarray(table),
                   t_range=jnp.asarray(t_range),
                   chunk_trange=jnp.asarray(chunk_tr))
    got = build_representation(
        torch.from_numpy(out), torch.from_numpy(counts), num_bins=bins,
        height=H, width=W, tile_table=torch.from_numpy(table),
        t_range=torch.from_numpy(t_range),
        chunk_trange=torch.from_numpy(chunk_tr))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                               atol=K6_ATOL)


# ----------------------------------------------------- resize, augments


@pytest.mark.parametrize("mode", ["nearest", "bilinear", "bicubic"])
def test_resize_matches_jax_image_resize(mode):
    """Up (the PPM branch 6x6 -> 14x14, logits 4x4 -> label size), down and
    mixed, in f32: the weights agree to f32 rounding."""
    rng = np.random.default_rng(4)
    for shape, size in (((2, 6, 6, 3), (14, 14)), ((2, 4, 4, 5), (12, 20)),
                        ((1, 14, 14, 2), (5, 9)), ((2, 1, 1, 4), (3, 3)),
                        ((1, 3, 7, 2), (3, 20))):
        x = rng.normal(size=shape).astype(np.float32)
        want = np.asarray(j_resize(jnp.asarray(x), size, mode))
        got = resize(torch.from_numpy(x), size, mode).numpy()
        assert got.shape == want.shape
        np.testing.assert_allclose(got, want, rtol=0, atol=1e-5,
                                   err_msg=f"{shape} -> {size}")


def _view_params(rng, b, h, w):
    ys = rng.integers(0, h // 3, b)
    xs = rng.integers(0, w // 3, b)
    hs = rng.integers(h // 2, h - h // 3, b)
    ws = rng.integers(w // 2, w - w // 3, b)
    hf = np.array([True, False, True][:b])
    tf = np.array([False, True, True][:b])
    arrays = [a.astype(np.int32) for a in (ys, xs, hs, ws)] + [hf, tf]
    return (JViewParams(*map(jnp.asarray, arrays)),
            ViewParams(*map(torch.from_numpy, arrays)))


def test_semseg_label_augment_matches_jax():
    """Nearest crop-resize and hflip of integer maps, the ignore label
    included; a time flip does not touch labels."""
    rng = np.random.default_rng(5)
    labels = rng.integers(0, NUM_CLASSES, (3, 40, 60)).astype(np.int32)
    labels[:, :5] = IGNORE
    jp, tp = _view_params(rng, 3, 40, 60)
    augment = jax.jit(j_label_augment, static_argnums=2)
    for size in ((40, 60), (24, 36), (50, 70)):
        want = np.asarray(augment(jnp.asarray(labels), jp, size))
        got = apply_semseg_label_augment(torch.from_numpy(labels), tp, size)
        np.testing.assert_array_equal(got.numpy(), want)


# ---------------------------------------------------------- the pipeline


def _pipelines(tiled, compact, train):
    kw = dict(task="semseg", num_bins=NB, input_size=32,
              fix_events_num=3000, val_fix_events_num=3000,
              sensor_height=H, sensor_width=W, label_size=(H, W),
              tiled_raster=tiled, compact_transfer=compact)
    jsrc = jdp.SyntheticDenseSource("semseg", n=4, num_classes=5,
                                    sensor_hw=(H, W), num_events=3000)
    tsrc = tdp.SyntheticDenseSource("semseg", n=4, num_classes=5,
                                    sensor_hw=(H, W), num_events=3000)
    jpipe = jdp.DensePipeline(jsrc, jdp.DenseDataConfig(**kw), 2, train,
                              seed=7)
    tpipe = tdp.DensePipeline(tsrc, tdp.DenseDataConfig(**kw), 2, train,
                              seed=7, device="cpu")
    return jpipe, tpipe


@pytest.mark.parametrize("tiled,compact", [("on", True), ("on", False),
                                           ("off", True)],
                         ids=["tiled_u32", "tiled_f32", "untiled_u32"])
@pytest.mark.parametrize("train", [True, False], ids=["train", "eval"])
def test_dense_pipeline_batches_match_jax(tiled, compact, train):
    """Two batches of the JAX pipeline and the port's from one seed, both
    on their C++ host code: the same order, stream augment and views.
    Labels exactly; the grids within 1e-4 of their scale (JAX's tiled grid
    goes through the hi+lo kernel, the untiled one through the f32
    scatter)."""
    _check_dense_pipelines(tiled, compact, train)


def test_dense_pipeline_batches_match_jax_numpy_specification(numpy_native):
    """The same, both pipelines on their numpy host code (erase-and-add
    from the pipeline's generator, the numpy pack and bucketer)."""
    _check_dense_pipelines("on", True, True)


def _check_dense_pipelines(tiled, compact, train):
    jpipe, tpipe = _pipelines(tiled, compact, train)
    assert tpipe.tiled == (tiled == "on")
    n = 0
    for jb, tb in zip(jpipe, tpipe):
        assert tb["evg"].shape == (2, 32, 32, NB)
        np.testing.assert_array_equal(tb["label"].numpy(),
                                      np.asarray(jb["label"]))
        assert _rel_err(tb["evg"].numpy(), np.asarray(jb["evg"])) <= 1e-4
        assert tb["num_valid"] == int(jb["num_valid"])
        n += 1
    assert n == 2 and tpipe.batches == 2 and tpipe.host_seconds > 0


def test_auto_tiling_routes_by_grid_size_on_every_device():
    cfg = tdp.DenseDataConfig(task="semseg")  # DSEC: 440 x 640
    assert tdp.uses_tiled_raster(cfg)
    for hw, want in (((256, 256), False), ((260, 346), True),
                     ((64, 64), False)):
        c = tdp.DenseDataConfig(task="semseg", sensor_height=hw[0],
                                sensor_width=hw[1])
        assert tdp.uses_tiled_raster(c) == want, hw
    off = tdp.DenseDataConfig(task="semseg", tiled_raster="off")
    assert not tdp.uses_tiled_raster(off)
    flow = tdp.DensePipeline(tdp.SyntheticDenseSource("flow"),
                             tdp.DenseDataConfig(task="flow"), 2, True,
                             device="cpu")
    assert flow.tiled  # the flow task is ported
    with pytest.raises(ValueError, match="task"):
        tdp.DensePipeline(tdp.SyntheticDenseSource("semseg"),
                          tdp.DenseDataConfig(task="depth"), 2, True,
                          device="cpu")


# ------------------------------------------------------ heads and the hub


@pytest.fixture(scope="module")
def jax_vars():
    hub = j_hub(NUM_CLASSES, **TINY).clone(decode_dropout=0.0)
    v = jax.jit(hub.init)(jax.random.key(0), jnp.zeros((1, 32, 32, NB)))
    rng = np.random.default_rng(6)
    # running statistics away from their init, so eval mode reads them
    stats = jax.tree.map(
        lambda a: jnp.asarray(rng.uniform(0.5, 1.5, a.shape), jnp.float32),
        v["batch_stats"])
    return {"params": v["params"], "batch_stats": stats}


def _carry(jv, **kw):
    hub = dense_hub_vit_small(NUM_CLASSES, device="cpu", decode_dropout=0.0,
                              **TINY, **kw)
    return load_jax_state_dict(
        hub, export_torch_state_dict(jv["params"], jv["batch_stats"]))


@pytest.mark.parametrize("train", [False, True], ids=["eval", "train"])
def test_hub_forward_matches_jax(monkeypatch, jax_vars, train):
    """The pyramid and both heads' logits at f32, within 1e-5 of their
    scale; in training mode (drop-path masks replayed, no dropout) the
    BatchNorm running statistics after the forward too."""
    hub = j_hub(NUM_CLASSES, **TINY).clone(decode_dropout=0.0)
    x = np.random.default_rng(7).normal(size=(B, 32, 32, NB)).astype(
        np.float32)
    keep = np.random.default_rng(8).random((SITES, B)) < 0.9
    thub = _carry(jax_vars)
    if train:
        replay = _ReplayDropPath(keep)
        monkeypatch.setattr(jlayers, "drop_path", replay)
        (emb, pyr, dec, aux), upd = jax.jit(lambda v, x: hub.apply(
            v, x, train=True, rngs={"dropout": jax.random.key(0)},
            mutable=["batch_stats"]))(jax_vars, jnp.asarray(x))
        assert replay.calls == SITES
        thub.train()
        set_drop_path_source(thub, DropPathSource(keep=torch.from_numpy(keep)))
    else:
        emb, pyr, dec, aux = jax.jit(lambda v, x: hub.apply(
            v, x, train=False))(jax_vars, jnp.asarray(x))
        thub.eval()
    with torch.no_grad():
        t_emb, t_pyr, t_dec, t_aux = thub(torch.from_numpy(x))
    assert len(t_pyr) == 4
    for got, want in [(t_emb, emb), (t_dec, dec), (t_aux, aux),
                      *zip(t_pyr, pyr)]:
        assert got.shape == want.shape
        assert _rel_err(got.numpy(), np.asarray(want)) <= 1e-5
    if train:
        want = export_torch_state_dict(jax_vars["params"],
                                       upd["batch_stats"])
        for k, v in thub.state_dict().items():
            if "running_" in k:
                assert _rel_err(v.numpy(), want[k]) <= 1e-5, k


def test_bridge_carries_bn_statistics_and_skips_num_batches_tracked(
        jax_vars):
    """The exporter's dict loads strictly, running statistics included; a
    torch checkpoint's ``num_batches_tracked`` entries are skipped, any
    other stray key still fails."""
    sd = export_torch_state_dict(jax_vars["params"], jax_vars["batch_stats"])
    hub = dense_hub_vit_small(NUM_CLASSES, device="cpu", **TINY)
    k = "decode_head.psp_bottleneck.norm_layer.running_var"
    load_jax_state_dict(hub, {
        **sd, k.replace("running_var", "num_batches_tracked"): np.int64(3)})
    np.testing.assert_array_equal(hub.state_dict()[k].numpy(), sd[k])
    with pytest.raises(RuntimeError, match="Unexpected"):
        load_jax_state_dict(hub, {**sd, "decode_head.extra": np.zeros(1)})


def test_batchnorm_is_flax_s():
    """Batch statistics with the biased variance, eps 1e-5, running
    averages moved by 0.01 of the batch's; eval reads the running ones."""
    import flax.linen as fnn

    x = np.random.default_rng(9).normal(2.0, 3.0, (4, 5, 6, 8)).astype(
        np.float32)
    bn = fnn.BatchNorm(use_running_average=False, dtype=jnp.float32)
    v = bn.init(jax.random.key(0), jnp.asarray(x))
    y, upd = bn.apply(v, jnp.asarray(x), mutable=["batch_stats"])
    tbn = theads.BatchNorm(8)
    got = tbn(torch.from_numpy(x))
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(y),
                               rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(tbn.running_mean.numpy(),
                               np.asarray(upd["batch_stats"]["mean"]),
                               rtol=1e-6)
    np.testing.assert_allclose(tbn.running_var.numpy(),
                               np.asarray(upd["batch_stats"]["var"]),
                               rtol=1e-6)
    tbn.eval()
    y_eval = fnn.BatchNorm(use_running_average=True).apply(
        {"params": v["params"], "batch_stats": upd["batch_stats"]},
        jnp.asarray(x))
    np.testing.assert_allclose(tbn(torch.from_numpy(x)).detach().numpy(),
                               np.asarray(y_eval), rtol=1e-5, atol=1e-5)


def test_adaptive_pool_matches_jax():
    x = np.random.default_rng(10).normal(size=(2, 14, 9, 3)).astype(
        np.float32)
    for out in ((1, 1), (2, 2), (3, 3), (6, 6), (5, 4)):
        np.testing.assert_allclose(
            theads.adaptive_avg_pool(torch.from_numpy(x), out).numpy(),
            np.asarray(jheads.adaptive_avg_pool(jnp.asarray(x), out)),
            rtol=1e-6, atol=1e-6)


def test_channel_dropout_replays_and_needs_a_source():
    drop = theads.ChannelDropout(0.5)
    x = torch.ones((2, 3, 3, 4))
    assert torch.equal(drop.eval()(x), x)
    drop.train()
    with pytest.raises(ValueError, match="generator"):
        drop(x)
    keep = torch.tensor([[1, 0, 1, 1], [0, 0, 1, 0]], dtype=torch.bool)
    theads.set_dropout_source(drop, DropPathSource(keep=[keep]))
    want = keep[:, None, None, :].float() * 2.0
    assert torch.equal(drop(x), want.expand_as(x))
    theads.set_dropout_source(
        drop, DropPathSource(torch.Generator().manual_seed(0)))
    y = drop(torch.ones((64, 1, 1, 64)))
    assert set(y.unique().tolist()) == {0.0, 2.0}
    assert 0.4 < (y > 0).float().mean().item() < 0.6


# --------------------------------------------------- loss and metrics


@pytest.mark.parametrize("ignore", [None, IGNORE, 2],
                         ids=["none", "ignore255", "ignore_a_class"])
def test_semseg_loss_matches_jax(ignore):
    rng = np.random.default_rng(11)
    logits = rng.normal(size=(2, 12, 20, NUM_CLASSES)).astype(np.float32)
    labels = rng.integers(0, NUM_CLASSES, (2, 12, 20)).astype(np.int32)
    if ignore is not None:
        labels[:, :3] = ignore
    want = j_semseg_loss(jnp.asarray(logits), jnp.asarray(labels),
                         NUM_CLASSES, ignore)
    got = semseg_loss(torch.from_numpy(logits), torch.from_numpy(labels),
                      NUM_CLASSES, ignore)
    for g, w in zip(got, want):
        np.testing.assert_allclose(float(g), float(w), rtol=1e-6)


def test_confusion_and_miou_match_jax():
    """Exact integer counts with the ignore label in the targets, a
    prediction equal to the ignore label, and a tail batch's pad rows."""
    rng = np.random.default_rng(12)
    pred = rng.integers(0, NUM_CLASSES, (3, 9, 7)).astype(np.int32)
    target = rng.integers(0, NUM_CLASSES, (3, 9, 7)).astype(np.int32)
    target[:, 0] = IGNORE
    valid = np.array([True, True, False])[:, None, None]
    for ignore in (None, 2):
        want = jmetrics.confusion_matrix(
            jnp.asarray(pred), jnp.asarray(target), NUM_CLASSES, ignore,
            valid=jnp.asarray(valid))
        got = tmetrics.confusion_matrix(
            torch.from_numpy(pred), torch.from_numpy(target), NUM_CLASSES,
            ignore, valid=torch.from_numpy(valid))
        assert got.dtype == torch.int64
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
        for t, j in ((tmetrics.miou_from_confusion,
                      jmetrics.miou_from_confusion),
                     (tmetrics.macc_from_confusion,
                      jmetrics.macc_from_confusion)):
            # JAX reduces in f32 (x64 is off), the port in f64
            np.testing.assert_allclose(float(t(got)), float(j(want)),
                                       rtol=1e-6)


# ------------------------------------------------ train and eval steps


def _step_batch(seed, b=B):
    rng = np.random.default_rng(seed)
    label = rng.integers(0, NUM_CLASSES, (b,) + LABEL_HW).astype(np.int32)
    label[:, :2] = IGNORE
    return dict(evg=rng.normal(size=(b, 32, 32, NB)).astype(np.float32),
                label=label, keep=rng.random((SITES, b)) < 0.9)


def test_f32_semseg_trajectory_matches_jax(monkeypatch, jax_vars):
    """3 make_semseg_train_step updates of batches of 8 from the same init
    at f32, with drop-path 0.1 (replayed masks), the heads' dropout 0, the
    ignore label
    and the CLI's AdamW with layer decay 0.75: loss, decode CE and Dice and
    grad norm at each step within 1e-4 of the loss's scale, then the
    BatchNorm running statistics at 1e-4 of scale and the parameters
    (see below)."""
    jhub = j_hub(NUM_CLASSES, **TINY).clone(decode_dropout=0.0)
    sched = (1e-3, 1e-6, 1, 10, 2)
    tx = joptim.build_optimizer(
        jax_vars["params"], learning_rate=joptim.cosine_warmup_schedule(
            *sched), weight_decay=0.05, betas=(0.9, 0.999), layer_decay=0.75,
        num_layers=12)
    jstate = JTrainState.create(
        apply_fn=jhub.apply, params=jax.tree.map(jnp.copy, jax_vars["params"]),
        batch_stats=jax.tree.map(jnp.copy, jax_vars["batch_stats"]), tx=tx)
    hub = _carry(jax_vars)
    state = TrainState(
        hub, toptim.build_optimizer(hub, weight_decay=0.05,
                                    betas=(0.9, 0.999), layer_decay=0.75,
                                    num_layers=12),
        toptim.cosine_warmup_schedule(*sched))
    step = make_semseg_train_step(hub, num_classes=NUM_CLASSES,
                                  ignore_index=IGNORE)
    # one set of drop-path masks for the three steps: the JAX step is
    # traced once, with the replayed masks in it
    keep = _step_batch(19, 8)["keep"]
    replay = _ReplayDropPath(keep)
    monkeypatch.setattr(jlayers, "drop_path", replay)
    jstep = j_make_train(jhub, num_classes=NUM_CLASSES, ignore_index=IGNORE)
    for i in range(3):
        b = _step_batch(20 + i, 8)
        jstate, jm = jstep(jstate, {"evg": jnp.asarray(b["evg"]),
                                    "label": jnp.asarray(b["label"])},
                           jax.random.key(i))
        assert replay.calls == SITES
        tm = step(state, {"evg": torch.from_numpy(b["evg"]),
                          "label": torch.from_numpy(b["label"]),
                          "drop_path_keep": torch.from_numpy(keep)})
        assert set(tm) == set(jm)
        scale = abs(float(jm["loss"]))
        for k in ("loss", "decode_ce", "decode_dice"):
            assert abs(float(tm[k]) - float(jm[k])) <= 1e-4 * scale, (i, k)
        np.testing.assert_allclose(float(tm["grad_norm"]),
                                   float(jm["grad_norm"]), rtol=1e-4)
    assert state.step == 3
    want = export_torch_state_dict(jstate.params, jstate.batch_stats)
    init = export_torch_state_dict(jax_vars["params"],
                                   jax_vars["batch_stats"])
    sd = hub.state_dict()
    lr_sum = sum(toptim.cosine_warmup_schedule(*sched)(i) for i in range(3))
    worst = {}
    for k, w in want.items():
        got = sd[k].numpy()
        if "running_" in k:
            assert _rel_err(got, w) <= 1e-4, k
            continue
        # Adam divides each gradient component by its running RMS, so a
        # component small against its tensor's scale (the f32 gradients
        # agree to ~1e-4 of that scale: the BatchNorm of the pooled 1x1
        # map sees 8 values) may move by another fraction of a step, and
        # one whose gradient is zero up to rounding (the bias of a conv
        # before a BatchNorm, the key bias) by up to a whole step of noise.
        # So each component stays within 2 steps' lr, and each tensor's
        # update (from the common init) within 1% of its norm.
        assert np.abs(got - w).max() <= 2 * lr_sum, k
        if k.endswith("conv_layer.bias") or k.endswith("attn.qkv.bias"):
            continue
        moved = np.linalg.norm(w - init[k])
        if moved == 0.0:  # no gradient reaches it (the unused final LN)
            np.testing.assert_array_equal(got, w, err_msg=k)
            continue
        worst[k] = float(np.linalg.norm(got - w) / moved)
        assert worst[k] <= 1e-2, (k, worst[k])
    assert set(sd) == set(want)


def test_replayed_dropout_masks_are_counted(jax_vars):
    hub = dense_hub_vit_small(NUM_CLASSES, device="cpu", **TINY)
    state = TrainState(hub, toptim.build_optimizer(hub), lambda s: 0.0)
    b = _step_batch(30)
    batch = {"evg": torch.from_numpy(b["evg"]),
             "label": torch.from_numpy(b["label"]),
             "drop_path_keep": torch.from_numpy(b["keep"]),
             "dropout_keep": [torch.ones((B, 384), dtype=torch.bool)]}
    step = make_semseg_train_step(hub, num_classes=NUM_CLASSES,
                                  ignore_index=IGNORE)
    with pytest.raises(ValueError, match="asks for more"):
        step(state, batch)
    batch["dropout_keep"] = [torch.ones((B, 384), dtype=torch.bool),
                             torch.ones((B, 256), dtype=torch.bool)]
    m = step(state, batch)
    assert set(m) == {"loss", "decode_ce", "decode_dice", "grad_norm"}
    assert np.isfinite(float(m["loss"]))


def test_eval_step_confusion_matches_jax(jax_vars):
    """A full batch and a wrapped tail batch with 3 real rows of 4: the
    confusion counts of the decode head at label resolution, in eval mode
    (the running statistics)."""
    jhub = j_hub(NUM_CLASSES, **TINY).clone(decode_dropout=0.0)
    jstate = JTrainState.create(
        apply_fn=jhub.apply, params=jax_vars["params"],
        batch_stats=jax_vars["batch_stats"],
        tx=joptim.build_optimizer(jax_vars["params"], learning_rate=0.0))
    jstep = j_make_eval(jhub, num_classes=NUM_CLASSES, ignore_label=IGNORE)
    step = make_semseg_eval_step(_carry(jax_vars), num_classes=NUM_CLASSES,
                                 ignore_label=IGNORE)
    for seed, n in ((40, B), (41, 3)):
        b = _step_batch(seed)
        want = jstep(jstate, {"evg": jnp.asarray(b["evg"]),
                              "label": jnp.asarray(b["label"]),
                              "num_valid": jnp.asarray(n, jnp.int32)})
        got = step({"evg": torch.from_numpy(b["evg"]),
                    "label": torch.from_numpy(b["label"]), "num_valid": n})
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
        assert int(got.sum()) == n * (LABEL_HW[0] - 2) * LABEL_HW[1]


# ------------------------------------------------------------------ CLI


def test_cli_trains_evaluates_and_writes_a_loadable_checkpoint(tmp_path):
    from eventpretrain_tpu_torch.cli.finetune_semseg import (
        build_parser,
        load_finetune,
        main,
    )

    assert build_parser().parse_args([]).device == "cuda"
    out = tmp_path / "ss"
    args = ["--device", "cpu", "--backbone", "vit", "--input_size", "32",
            "--batch_size", "16", "--epochs", "1", "--fix_events_num",
            "1000", "--val_fix_events_num", "1000", "--print_freq", "1"]
    res = main(args + ["--output_dir", str(out)])
    assert res["state"].step == 2  # 32 synthetic samples / 16
    assert 0.0 <= res["miou"] <= 100.0
    record = json.loads((out / "log.txt").read_text().splitlines()[-1])
    assert record["epoch"] == 0 and "train_decode_ce" in record
    ckpt = str(out / "checkpoint.pth")
    sd = load_torch_checkpoint(ckpt)
    assert any(k.endswith("norm_layer.running_var") for k in sd)
    # the whole hub, BatchNorm statistics included, comes back strictly
    hub = dense_hub_vit_small(5, device="cpu", input_size=32)
    load_finetune(hub, ckpt)
    for k, v in res["state"].module.state_dict().items():
        torch.testing.assert_close(hub.state_dict()[k], v, rtol=0, atol=0)
    # and drives another run
    res2 = main(args + ["--finetune", ckpt,
                        "--output_dir", str(tmp_path / "ss2")])
    assert res2["state"].step == 2


@pytest.mark.parametrize("flags", [
    ["--backbone", "swin_ecddp"], ["--dataset", "dsec"], ["--resume", "x"],
    ["--export_torch", "x.pth"], ["--visualize"], ["--data_parallel"],
    ["--num_bins", "3"],
], ids=lambda f: f[0].lstrip("-"))
def test_cli_refuses_flags_of_later_slices(flags):
    """Each flag of a later slice exits naming it. DSEC and DDD17 are
    ported: a dataset exits only without ``--data_root``; ``--num_bins 3``
    (the MEM image) passes the refusals."""
    from eventpretrain_tpu_torch.cli.finetune_semseg import (
        _refuse_unported,
        build_parser,
        main,
    )

    base = [] if flags[0] == "--backbone" else ["--backbone", "vit"]
    if flags[0] == "--num_bins":
        _refuse_unported(build_parser().parse_args(base + flags))
        return
    match = "--data_root" if flags[0] == "--dataset" else "slice"
    with pytest.raises(SystemExit, match=match):
        main(["--device", "cpu", *base, *flags])
