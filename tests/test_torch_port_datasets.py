"""The port's dataset readers and the MEM count image against the JAX
package on the CPU.

Fixture trees in the reference's on-disk layouts are read by both
packages' sources: the six cls sources of ``data/cls_sources.py`` (as
tests/test_cls_sources.py writes them) and the DSEC and DDD17 readers (the
functions that write their trees are copies of
tests/test_dense_dataset_parity.py's, whose module loads the reference
code at import). Every item must be equal. Then the
cls pipeline under each rescale mode and sensor rule, its host arrays
word for word and its representation within 1e-5; the MEM image, its
hot-pixel removal and its representation, untiled and tiled; a 3-channel
ViT-S-shaped hub on it; a DDD17 dense batch; and the CLIs' sources and
data configs field by field, with one short run of each. Both pipelines
run their C++ host code (JAX's library built here), and once their numpy
specifications. Every test passes ``device="cpu"``.
"""

import dataclasses
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from eventpretrain_tpu import native as jnative
from eventpretrain_tpu.ckpt.torch_export import export_torch_state_dict
from eventpretrain_tpu.cli import finetune_cls as jcls_cli
from eventpretrain_tpu.cli import finetune_semseg as jsemseg_cli
from eventpretrain_tpu.data import cls_pipeline as jcp
from eventpretrain_tpu.data import cls_sources as jcs
from eventpretrain_tpu.data import dense_pipeline as jdp
from eventpretrain_tpu.data.representations import (
    build_representation as j_build,
)
from eventpretrain_tpu.models.cls_hub import cls_hub_vit_small as j_hub
from eventpretrain_tpu.ops import events as jev
from eventpretrain_tpu.ops.view_augment import ViewParams as JViewParams
from eventpretrain_tpu_torch import native as tnative
from eventpretrain_tpu_torch.ckpt.bridge import load_jax_state_dict
from eventpretrain_tpu_torch.cli import finetune_cls as tcls_cli
from eventpretrain_tpu_torch.cli import finetune_semseg as tsemseg_cli
from eventpretrain_tpu_torch.data import cls_pipeline as tcp
from eventpretrain_tpu_torch.data import cls_sources as tcs
from eventpretrain_tpu_torch.data import dense_pipeline as tdp
from eventpretrain_tpu_torch.data.representations import (
    build_representation,
    num_channels,
)
from eventpretrain_tpu_torch.models import cls_hub as tcls_hub
from eventpretrain_tpu_torch.models import dense_hub as tdense_hub
from eventpretrain_tpu_torch.ops import events as tev

from tests._port_threads import one_torch_thread  # noqa: F401

B = 4
INPUT = 32
FIX = 600
# the decoded events and the windows are exact; the rasterisation and the
# resize contractions sum in other orders
PIPE_ATOL = 1e-5
MEM_ATOL = 1e-6
# f32 on both sides; the ViT's matmuls and LayerNorms sum in other orders
LOGIT_ATOL = 1e-4


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


# ------------------------------------------------------ cls fixture trees


def _xytp(rng, n, h, w):
    return np.stack([rng.integers(0, w, n), rng.integers(0, h, n),
                     np.sort(rng.uniform(0, 0.1, n)), rng.integers(0, 2, n)],
                    axis=-1).astype(np.float64)


def write_cls_tree(root, dataset, rng, per_class=4, n=800,
                   classes=("alpha", "beta")):
    """One tree of ``dataset``'s layout under ``root`` (returns the extra
    path ES-ImageNet needs: its label file)."""
    os.makedirs(root, exist_ok=True)
    if dataset == "dvs128_gesture":
        classes = ("2", "10")
    for cls in classes:
        d = os.path.join(root, cls)
        os.makedirs(d, exist_ok=True)
        for i in range(per_class):
            if dataset in ("n_cars", "n_caltech101"):
                np.save(os.path.join(d, f"{cls}_{i}.npy"),
                        _xytp(rng, n, 180, 240)
                        if dataset == "n_caltech101"
                        else _xytp(rng, n, 100, 120))
            elif dataset == "cifar10_dvs":
                np.save(os.path.join(d, f"cifar10_{cls}_{i}.npy"),
                        _xytp(rng, n, 128, 128))
            elif dataset == "n_imagenet":
                arr = np.zeros(n, dtype=[("x", "<u2"), ("y", "<u2"),
                                         ("t", "<i8"), ("p", "?")])
                arr["x"] = rng.integers(0, 640, n)
                arr["y"] = rng.integers(0, 480, n)
                arr["t"] = np.sort(rng.integers(0, 100_000, n))
                arr["p"] = rng.integers(0, 2, n).astype(bool)
                np.savez(os.path.join(d, f"{cls}_{i}.npz"), event_data=arr)
            elif dataset == "dvs128_gesture":
                ev = _xytp(rng, n, 128, 128)
                np.savez(os.path.join(d, f"user{i:02d}.npz"), x=ev[:, 0],
                         y=ev[:, 1], t=ev[:, 2], p=ev[:, 3])
            elif dataset == "es_imagenet":
                m = n // 2
                pos = np.stack([rng.integers(0, 254, m),
                                rng.integers(0, 254, m),
                                rng.integers(1, 9, m)], axis=-1)
                neg = np.stack([rng.integers(0, 254, m),
                                rng.integers(0, 254, m),
                                rng.integers(1, 9, m)], axis=-1)
                np.savez(os.path.join(d, f"{cls}_{i}.npz"), pos=pos,
                         neg=neg)
            elif dataset == "ucf101_dvs":
                import scipy.io

                scipy.io.savemat(os.path.join(d, f"v_{cls}_{i}.mat"), {
                    "x": rng.integers(0, 240, (n, 1)),
                    "y": rng.integers(0, 180, (n, 1)),
                    "ts": np.sort(rng.uniform(0, 1, (n, 1)), 0),
                    "pol": rng.integers(0, 2, (n, 1))})
    if dataset != "es_imagenet":
        return None
    label_path = root + "_labels.txt"
    with open(label_path, "w") as f:
        for cls in classes:
            for i in range(per_class):
                a, b = rng.integers(200, 254, 2)
                f.write(f"{cls}_{i}.npz {a} {b} 0\n")
    return label_path


CLS_DATASETS = ("n_cars", "n_caltech101", "cifar10_dvs", "n_imagenet",
                "es_imagenet", "dvs128_gesture", "ucf101_dvs")


@pytest.fixture(scope="module")
def cls_trees(tmp_path_factory):
    base = tmp_path_factory.mktemp("cls")
    rng = np.random.default_rng(0)
    trees = {}
    for dataset in CLS_DATASETS:
        root = str(base / dataset)
        trees[dataset] = (root, write_cls_tree(root, dataset, rng))
    # an N-ImageNet robustness variant: another tree of the same layout
    variant = str(base / "val_mode_1")
    write_cls_tree(variant, "n_imagenet", rng, per_class=2)
    trees["variant"] = (variant, None)
    return trees


def _make_sources(pkg, dataset, root, label):
    if dataset == "n_cars":
        mod = jcp if pkg is jcs else tcp
        return mod.NCarsSource(root)
    if dataset == "es_imagenet":
        return pkg.EsImageNetSource(root, label, 2)
    return {"n_caltech101": pkg.NCaltech101Source,
            "cifar10_dvs": pkg.Cifar10DvsSource,
            "n_imagenet": lambda r: pkg.NImageNetSource(r, 2),
            "dvs128_gesture": pkg.Dvs128GestureSource,
            "ucf101_dvs": pkg.Ucf101DvsSource}[dataset](root)


def _same_source(got, want):
    assert type(got).__name__ == type(want).__name__
    assert got.files == want.files and len(got) == len(want)
    assert getattr(got, "sensor_hw", None) == getattr(want, "sensor_hw",
                                                      None)
    assert getattr(got, "offsets", None) == getattr(want, "offsets", None)


@pytest.mark.parametrize("dataset", CLS_DATASETS[1:])
def test_cls_sources_match_jax_bit_for_bit(cls_trees, dataset):
    """Every item of each source: the file list, the label (DVS128's from
    its directories '2' and '10'), the events bit for bit and their
    dtype."""
    root, label = cls_trees[dataset]
    want = _make_sources(jcs, dataset, root, label)
    got = _make_sources(tcs, dataset, root, label)
    _same_source(got, want)
    assert len(got) == 8
    for i in range(len(got)):
        (ge, gl), (we, wl) = got.load(i), want.load(i)
        assert ge.dtype == we.dtype and ge.shape == we.shape
        np.testing.assert_array_equal(ge, we)
        assert gl == wl
    if dataset == "dvs128_gesture":
        assert sorted({got.load(i)[1] for i in range(len(got))}) == [2, 10]


# ------------------------------------------------------------ cls pipeline


# (dataset, num_bins, rescale mode, transfer codec) of each case; the f32
# transfer carries the rescaled coordinates themselves, the u32 words
# their integer parts
PIPE_CASES = {
    "always_5": ("n_imagenet", 5, "always", "u32"),
    "always_5_f32": ("n_imagenet", 5, "always", "f32"),
    "ecdp_2_on": ("cifar10_dvs", 2, "ecdp", "u32"),
    "ecdp_5_off": ("cifar10_dvs", 5, "ecdp", "u32"),
    "never_fixed": ("n_caltech101", 5, "never", "u32"),
    "never_fixed_mem": ("n_caltech101", 3, "never", "u32"),
}


def _cls_cfgs(dataset, num_bins, rescale, codec="u32"):
    sensor = {"n_imagenet": (480, 640), "cifar10_dvs": (128, 128),
              "n_caltech101": (180, 240)}[dataset]
    active = rescale == "always" or (rescale == "ecdp" and num_bins == 2)
    canvas = (INPUT, INPUT) if active else sensor
    kw = dict(num_classes=2, num_bins=num_bins, input_size=INPUT,
              fix_events_num=FIX, val_fix_events_num=FIX,
              canvas_height=canvas[0], canvas_width=canvas[1],
              infer_sensor_size=False, sensor_height=sensor[0],
              sensor_width=sensor[1], rescale_to_input=rescale,
              compact_transfer=codec != "f32")
    jcfg, tcfg = jcp.ClsDataConfig(**kw), tcp.ClsDataConfig(**kw)
    assert tcfg.rescale_active == jcfg.rescale_active == active
    return jcfg, tcfg


class _Record:
    """Stands in for a pipeline module's ``_device_preprocess``: keeps its
    host-made inputs as numpy arrays and calls the original."""

    def __init__(self, fn):
        self.fn, self.calls = fn, []

    def __call__(self, events, counts, sensor_hw, params, **kw):
        def host(a):
            return (a.cpu().numpy() if isinstance(a, torch.Tensor)
                    else np.asarray(a))

        self.calls.append(dict(
            events=host(events), counts=host(counts),
            sensor_hw=host(sensor_hw), t_range=host(kw["t_range"]),
            **{f: host(getattr(params, f)) for f in params._fields}))
        return self.fn(events, counts, sensor_hw, params, **kw)


def _check_cls_pipelines(monkeypatch, trees, case, train):
    dataset, num_bins, rescale, codec = PIPE_CASES[case]
    root, label = trees[dataset]
    jcfg, tcfg = _cls_cfgs(dataset, num_bins, rescale, codec)
    jrec = _Record(jcp._device_preprocess)
    trec = _Record(tcp._device_preprocess)
    monkeypatch.setattr(jcp, "_device_preprocess", jrec)
    monkeypatch.setattr(tcp, "_device_preprocess", trec)
    want = list(jcp.ClsPipeline(_make_sources(jcs, dataset, root, label),
                                jcfg, B, train=train, seed=5,
                                num_workers=0))
    got = list(tcp.ClsPipeline(_make_sources(tcs, dataset, root, label),
                               tcfg, B, train=train, seed=5, num_workers=2,
                               device="cpu"))
    assert len(got) == len(want) == 2
    for g, w, gc, wc in zip(got, want, trec.calls, jrec.calls):
        assert set(gc) == set(wc)
        for k in wc:
            assert gc[k].shape == wc[k].shape, k
            # the host arrays word for word (the u32 words as bytes)
            assert gc[k].tobytes() == wc[k].tobytes(), k
        assert g["evg"].shape == (B, INPUT, INPUT, num_channels(num_bins))
        np.testing.assert_allclose(g["evg"].numpy(), np.asarray(w["evg"]),
                                   rtol=0, atol=PIPE_ATOL)
        np.testing.assert_array_equal(g["label"].numpy(),
                                      np.asarray(w["label"]))
    if tcfg.rescale_active:
        # the view boxes are the input's
        assert (trec.calls[0]["sensor_hw"] == INPUT).all()


@pytest.mark.parametrize("case", list(PIPE_CASES))
@pytest.mark.parametrize("train", [True, False], ids=["train", "eval"])
def test_cls_pipeline_matches_jax(monkeypatch, cls_trees, case, train):
    """Both pipelines on their C++ host code, one seed: N-ImageNet under
    "always", CIFAR10-DVS under "ecdp" at 2 bins (rescaled) and 5 (not),
    N-Caltech101's fixed sensor under "never" (the voxel grid and the MEM
    image)."""
    _check_cls_pipelines(monkeypatch, cls_trees, case, train)


@pytest.mark.parametrize("case", ["always_5", "ecdp_2_on"])
def test_cls_pipeline_rescale_matches_jax_numpy_specification(
        monkeypatch, numpy_native, cls_trees, case):
    """The same under both packages' numpy host code."""
    _check_cls_pipelines(monkeypatch, cls_trees, case, True)


def test_rescale_mode_and_sensor_rules():
    cfg = tcp.ClsDataConfig(num_classes=2, num_bins=2,
                            rescale_to_input="ecdp")
    assert cfg.rescale_active and cfg.infer_sensor_size
    assert not dataclasses.replace(cfg, num_bins=3).rescale_active
    assert dataclasses.replace(cfg, rescale_to_input="always",
                               num_bins=5).rescale_active
    # the canvas rule: no fixed sensor, so the canvas with inference
    pipe = tcp.ClsPipeline(None, dataclasses.replace(
        cfg, infer_sensor_size=False, canvas_height=40, canvas_width=50,
        rescale_to_input="never"), 2, train=False, device="cpu")
    ev = np.zeros((10, 4))
    ev[:, 0], ev[:, 1] = 70, 60
    assert pipe._load_sample((ev, 1))[2] == (40, 50)


# ------------------------------------------------------------ MEM image


def _raw(rng, b=3, e=700, hw=(30, 40), hot=True):
    ev = np.zeros((b, e, 4), np.float32)
    counts = np.array([e, 500, 0][:b], np.int32)
    h, w = hw
    for i in range(b):
        n = counts[i]
        ev[i, :n, 0] = rng.integers(-2, w + 2, n)  # strays off the frame
        ev[i, :n, 1] = rng.integers(-2, h + 2, n)
        ev[i, :n, 2] = np.sort(rng.uniform(0, 0.05, n))
        ev[i, :n, 3] = rng.integers(0, 2, n)
        if hot and n:
            ev[i, :n // 5, 0], ev[i, :n // 5, 1] = 7, 5  # a hot pixel
    return ev, counts


def test_mem_image_is_jax_s_exactly():
    ev, counts = _raw(np.random.default_rng(1))
    kw = dict(height=30, width=40)
    want = jev.events_to_image_mem_batch(jnp.asarray(ev),
                                         jnp.asarray(counts), use_mxu=False,
                                         **kw)
    got = tev.events_to_image_mem_batch(torch.from_numpy(ev),
                                        torch.from_numpy(counts), **kw)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    # one sample, as the reference's single-sample image gives it
    one = tev.events_to_image_mem_batch(torch.from_numpy(ev[1:2]),
                                        torch.from_numpy(counts[1:2]), **kw)
    np.testing.assert_array_equal(one.numpy()[0], np.asarray(want)[1])


@pytest.mark.parametrize("region", [False, True], ids=["canvas", "region"])
def test_remove_hot_pixels_is_jax_s_exactly(region):
    """A planted hot pixel in each count image is zeroed in both count
    channels, the rest kept: per sample, over the canvas or over each
    sample's top-left sensor region (one sample's region excludes the hot
    pixel)."""
    rng = np.random.default_rng(2)
    hist = rng.integers(0, 4, (3, 24, 32, 3)).astype(np.float32) / 255.0
    hist[..., 1] = 0.0
    hist[:, 5, 7, 0] = 200 / 255.0
    hist[1, 20, 30, 2] = 150 / 255.0
    region_hw = np.array([[20, 30], [24, 32], [4, 6]], np.int32)
    if region:
        want = jax.vmap(jev.remove_hot_pixels, in_axes=(0, None, 0))(
            jnp.asarray(hist), 10.0, jnp.asarray(region_hw))
        got = tev.remove_hot_pixels(torch.from_numpy(hist), 10.0,
                                    torch.from_numpy(region_hw))
        single = tev.remove_hot_pixels(torch.from_numpy(hist[2]), 10.0,
                                       torch.from_numpy(region_hw[2]))
    else:
        want = jax.vmap(jev.remove_hot_pixels)(jnp.asarray(hist))
        got = tev.remove_hot_pixels(torch.from_numpy(hist))
        single = tev.remove_hot_pixels(torch.from_numpy(hist[2]))
    want = np.asarray(want)
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(single.numpy(), want[2])
    assert got[0, 5, 7, 0] == 0 and got[1, 20, 30, 0] == 0
    assert (got.numpy() != hist).sum() > 0


def test_remove_hot_pixels_threshold_is_the_unbiased_std():
    """A 3x4 image whose pixel lies between the thresholds of the
    unbiased and the biased std (at 1.5 stds): the port zeroes it exactly
    where JAX does."""
    for seed in range(200):
        hist = np.random.default_rng(seed).integers(
            0, 9, (3, 4, 3)).astype(np.float32)
        hist[..., 1] = 0.0
        counts = hist[..., 0::2].astype(np.float64)
        hot = [(hist[..., 0] > counts.mean() + 1.5 * counts.std(ddof=d))
               | (hist[..., 2] > counts.mean() + 1.5 * counts.std(ddof=d))
               for d in (0, 1)]
        if (hot[0] != hot[1]).any():
            break
    else:
        pytest.fail("no image separates the two thresholds")
    want = np.asarray(jev.remove_hot_pixels(jnp.asarray(hist), 1.5))
    got = tev.remove_hot_pixels(torch.from_numpy(hist), 1.5).numpy()
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got[..., 0] == 0, hot[1] | (hist[..., 0]
                                                              == 0))


@pytest.mark.parametrize("tiled", [False, True], ids=["untiled", "tiled"])
def test_mem_representation_matches_jax(tiled):
    """``build_representation(num_bins=3)`` with each sample's sensor box:
    the untiled image (K3's plain version against JAX's scatter), and over
    a bucketed layout at 200x300 (2x3 tiles, the last row and column
    partial: K6's plain version against JAX's tiled kernel in interpret
    mode)."""
    rng = np.random.default_rng(3)
    hw = (200, 300) if tiled else (30, 40)
    ev, counts = _raw(rng, e=3000 if tiled else 700, hw=hw)
    sensor = np.array([[hw[0] - 10, hw[1] - 20], list(hw), [8, 8]],
                      np.int32)
    kw = dict(num_bins=3, height=hw[0], width=hw[1])
    jkw, tkw = dict(sensor_hw=jnp.asarray(sensor)), dict(
        sensor_hw=torch.from_numpy(sensor))
    if tiled:
        out, table, t_range, chunk_tr = jnative.bucket_pack_event_batch(
            ev, counts, height=hw[0], width=hw[1])
        ev = out
        jkw.update(tile_table=jnp.asarray(table),
                   t_range=jnp.asarray(t_range),
                   chunk_trange=jnp.asarray(chunk_tr))
        tkw.update(tile_table=torch.from_numpy(table),
                   t_range=torch.from_numpy(t_range),
                   chunk_trange=torch.from_numpy(chunk_tr))
    want = np.asarray(j_build(jnp.asarray(ev), jnp.asarray(counts), **kw,
                              **jkw))
    got = build_representation(torch.from_numpy(ev),
                               torch.from_numpy(counts), **kw, **tkw)
    assert got.shape == want.shape == (3, *hw, 3)
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=MEM_ATOL)
    assert (want[:2, ..., 0::2] > 0).any()
    assert (want[..., 1] == 0).all()


TINY = dict(embed_dim=128, depth=2, num_heads=4, input_size=64)


def test_mem_cls_hub_logits_match_jax():
    """A 3-channel ViT-S-shaped hub with JAX's exported weights on the MEM
    representation of raw events (rasterised, viewed, normalised by each
    package's ``_device_preprocess``): the logits within 1e-4."""
    hub = j_hub(2, num_bins=3, **TINY)
    variables = hub.init(jax.random.PRNGKey(0),
                         jnp.zeros((1, 64, 64, 3), jnp.float32))
    port = tcls_hub.cls_hub_vit_small(2, 3, device="cpu", **TINY)
    load_jax_state_dict(port, export_torch_state_dict(variables["params"]))
    port.eval()
    ev, counts = _raw(np.random.default_rng(4), hw=(48, 48))
    sensor = np.array([[40, 44], [48, 48], [48, 48]], np.int32)
    b = ev.shape[0]
    jparams = JViewParams(
        crop_y=jnp.zeros((b,), jnp.int32), crop_x=jnp.zeros((b,), jnp.int32),
        crop_h=jnp.asarray(sensor[:, 0]), crop_w=jnp.asarray(sensor[:, 1]),
        hflip=jnp.zeros((b,), bool), tflip=jnp.zeros((b,), bool))
    kw = dict(num_bins=3, height=48, width=48, out_size=64, mode="bilinear")
    evg_j = jcp._device_preprocess(jnp.asarray(ev), jnp.asarray(counts),
                                   jnp.asarray(sensor), jparams, **kw)
    sensor_t = torch.from_numpy(sensor)
    evg_t = tcp._device_preprocess(torch.from_numpy(ev),
                                   torch.from_numpy(counts), sensor_t,
                                   tcp.eval_view_params(sensor_t), **kw)
    np.testing.assert_allclose(evg_t.numpy(), np.asarray(evg_j), rtol=0,
                               atol=PIPE_ATOL)
    _, logits_j, _ = hub.apply(variables, evg_j, train=False)
    with torch.no_grad():
        _, logits_t, _ = port(evg_t)
    np.testing.assert_allclose(logits_t.numpy(), np.asarray(logits_j),
                               atol=LOGIT_ATOL)


# ------------------------------------------------ DSEC and DDD17 readers


DDD17_HW = (20, 34)  # scaled down from (200, 346)
DSEC_ORG_HW = (48, 64)  # scaled down from (480, 640)
DSEC_HW = (44, 64)  # the bottom rows removed, as 440 of 480


def build_ddd17_seq(root, seq, rng, n_events=9000, n_labels=3,
                    hw=DDD17_HW):
    """The reference's DDD17 layout: events.dat.t (int64 ns),
    events.dat.xyp (int16, with out-of-bounds rows the reader must drop),
    index/index_50ms.npy rows (t_ns, event_idx, event_idx_before), and
    segmentation_masks/<seq>_frame_<n>.png (1-based image index)."""
    from PIL import Image

    h, w = hw
    path = os.path.join(root, seq)
    os.makedirs(os.path.join(path, "index"))
    os.makedirs(os.path.join(path, "segmentation_masks"))
    t = np.sort(rng.integers(0, 5_000_000, n_events)).astype(np.int64)
    x = rng.integers(-2, w + 3, n_events).astype(np.int16)
    y = rng.integers(-2, h + 3, n_events).astype(np.int16)
    p = rng.integers(0, 2, n_events).astype(np.int16)
    np.asarray(t).tofile(os.path.join(path, "events.dat.t"))
    np.stack([x, y, p], 1).astype(np.int16).tofile(
        os.path.join(path, "events.dat.xyp"))
    n_images = n_labels + 2
    idx_table = np.zeros((n_images, 3), np.int64)
    for j in range(n_images):
        end = int(n_events * (j + 1) / n_images)
        idx_table[j] = (int(t[end - 1]), end, max(end - 4000, 0))
    np.save(os.path.join(path, "index", "index_50ms.npy"), idx_table)
    for k in range(n_labels):
        lab = rng.integers(0, 6, (h, w)).astype(np.uint8)
        Image.fromarray(lab).save(os.path.join(
            path, "segmentation_masks", f"{seq}_frame_{k + 2:06d}.png"))


def build_dsec_seq(root, seq, rng, n_events=9000, n_ts=10, t_offset=1000):
    """The reference's DSEC layout: events/left/events.h5
    {events/{p,x,y,t}, ms_to_idx, t_offset} and rectify_map.h5,
    semantic/left/{<seq>_semantic_timestamps.txt, 11classes/*.png}."""
    import h5py
    from PIL import Image

    oh, ow = DSEC_ORG_HW
    path = os.path.join(root, seq)
    os.makedirs(os.path.join(path, "events", "left"))
    os.makedirs(os.path.join(path, "semantic", "left", "11classes"))
    t = np.sort(rng.integers(0, 400_000, n_events)).astype(np.int64)
    x = rng.integers(0, ow, n_events).astype(np.uint16)
    y = rng.integers(0, oh, n_events).astype(np.uint16)
    p = rng.integers(0, 2, n_events).astype(np.uint8)
    max_ms = int(np.ceil(t[-1] / 1000)) + 2
    ms_to_idx = np.searchsorted(t, np.arange(max_ms) * 1000, side="left")
    with h5py.File(os.path.join(path, "events", "left", "events.h5"),
                   "w") as f:
        f.create_dataset("events/p", data=p)
        f.create_dataset("events/x", data=x)
        f.create_dataset("events/y", data=y)
        f.create_dataset("events/t", data=t)
        f.create_dataset("ms_to_idx", data=ms_to_idx.astype(np.int64))
        f.create_dataset("t_offset", data=np.int64(t_offset))
    # near-identity rectification with jitter; some rows land past the
    # cropped sensor's bottom, where the reader must drop them
    gy, gx = np.mgrid[0:oh, 0:ow]
    rect = np.stack([gx + rng.normal(0, 1.0, (oh, ow)),
                     gy + rng.normal(0, 1.0, (oh, ow))],
                    axis=-1).astype(np.float32)
    with h5py.File(os.path.join(path, "events", "left", "rectify_map.h5"),
                   "w") as f:
        f.create_dataset("rectify_map", data=rect)
    ts = (np.linspace(t[-1] * 0.55, t[-1] * 0.98, n_ts).astype(np.int64)
          + t_offset)
    np.savetxt(os.path.join(path, "semantic", "left",
                            f"{seq}_semantic_timestamps.txt"), ts, fmt="%d")
    for k in range(n_ts):
        lab = rng.integers(0, 11, DSEC_ORG_HW).astype(np.uint8)[:DSEC_HW[0]]
        Image.fromarray(lab).save(os.path.join(
            path, "semantic", "left", "11classes", f"{k:06d}.png"))


def _same_items(got, want):
    assert len(got) == len(want) > 0 and got.items == want.items
    for i in range(len(got)):
        g, w = got.load(i), want.load(i)
        assert g["events"].dtype == w["events"].dtype
        np.testing.assert_array_equal(g["events"], w["events"])
        np.testing.assert_array_equal(g["label"], w["label"])
        assert g["label"].dtype == w["label"].dtype


def test_dsec_source_matches_jax(tmp_path):
    """Two sequences, one timestamp file of each name: the skipped first
    labels, every other label, the ms_to_idx lookup refined by a binary
    search, the backward window, the rectify map and the bounds drop."""
    rng = np.random.default_rng(6)
    build_dsec_seq(str(tmp_path), "seq_a", rng)
    build_dsec_seq(str(tmp_path), "seq_b", rng, n_ts=9, t_offset=0)
    os.rename(tmp_path / "seq_b" / "semantic" / "left"
              / "seq_b_semantic_timestamps.txt",
              tmp_path / "seq_b" / "semantic" / "left" / "timestamps.txt")
    kw = dict(fix_events_num=3000, sensor_hw=DSEC_HW)
    want = jdp.DsecSource(str(tmp_path), ["seq_a", "seq_b"], **kw)
    got = tdp.DsecSource(str(tmp_path), ["seq_a", "seq_b"], **kw)
    _same_items(got, want)
    assert len(got) == 2 + 2  # 10 - 6 skipped -> 2; 9 - 6 -> (3 + 1) // 2


@pytest.fixture(scope="module")
def ddd17_tree(tmp_path_factory):
    root = tmp_path_factory.mktemp("ddd17")
    rng = np.random.default_rng(7)
    for seq in ("dir0", "dir1"):
        build_ddd17_seq(str(root), seq, rng)
    return str(root)


@pytest.mark.parametrize("window", [None, 5000], ids=["train", "val"])
def test_ddd17_source_matches_jax(ddd17_tree, window):
    kw = dict(fix_events_num=3000, window_events_num=window,
              sensor_hw=DDD17_HW)
    want = jdp.Ddd17Source(ddd17_tree, ["dir0", "dir1"], **kw)
    got = tdp.Ddd17Source(ddd17_tree, ["dir0", "dir1"], **kw)
    assert got.window_events_num == want.window_events_num
    _same_items(got, want)


@pytest.mark.parametrize("num_bins", [5, 3], ids=["voxel", "mem"])
def test_ddd17_dense_batch_matches_jax(ddd17_tree, num_bins):
    """One training batch of each package's ``DensePipeline`` from the
    DDD17 tree, one seed: the labels equal, the representation (the port
    through K6's plain version, JAX through its scatter) within 1e-5."""
    kw = dict(task="semseg", num_bins=num_bins, input_size=INPUT,
              fix_events_num=3000, val_fix_events_num=3000,
              sensor_height=DDD17_HW[0], sensor_width=DDD17_HW[1],
              label_size=DDD17_HW)
    src = dict(fix_events_num=3000, sensor_hw=DDD17_HW)
    jpipe = jdp.DensePipeline(
        jdp.Ddd17Source(ddd17_tree, ["dir0", "dir1"], **src),
        jdp.DenseDataConfig(**kw, tiled_raster="off"), 2, True, seed=3)
    tpipe = tdp.DensePipeline(
        tdp.Ddd17Source(ddd17_tree, ["dir0", "dir1"], **src),
        tdp.DenseDataConfig(**kw, tiled_raster="on"), 2, True, seed=3,
        device="cpu")
    jb, tb = next(iter(jpipe)), next(iter(tpipe))
    np.testing.assert_array_equal(tb["label"].numpy(),
                                  np.asarray(jb["label"]))
    assert tb["evg"].shape == (2, INPUT, INPUT, num_channels(num_bins))
    np.testing.assert_allclose(tb["evg"].numpy(), np.asarray(jb["evg"]),
                               rtol=0, atol=PIPE_ATOL)


# ------------------------------------------------------------------ CLIs


class _Stop(Exception):
    pass


def _capture(cls, into: dict):
    def make(*args, **kw):
        into["cfg"] = cls(*args, **kw)
        raise _Stop
    return make


def _cls_argv(dataset, trees, num_bins):
    if dataset == "synthetic":
        return ["--dataset", dataset, "--num_bins", str(num_bins)]
    root, label = trees[dataset]
    argv = ["--dataset", dataset, "--train_root", root, "--val_root", root,
            "--num_bins", str(num_bins)]
    if dataset == "es_imagenet":
        argv += ["--es_train_label", label, "--es_val_label", label]
    if dataset == "n_imagenet":
        argv += ["--val_variant_roots", trees["variant"][0]]
    return argv


@pytest.mark.parametrize("num_bins", [2, 5])
@pytest.mark.parametrize("dataset", ("synthetic",) + CLS_DATASETS)
def test_cls_cli_sources_and_config_match_jax(monkeypatch, cls_trees,
                                              dataset, num_bins):
    """``make_sources`` and the data config of each ``--dataset``, against
    JAX's CLI (stopped where it builds its config): the sources' files,
    sensors and label offsets, the variants, and every field of the
    port's ``ClsDataConfig``."""
    argv = _cls_argv(dataset, cls_trees, num_bins)
    want = {}
    monkeypatch.setattr(jcls_cli, "ClsDataConfig",
                        _capture(jcp.ClsDataConfig, want))
    with pytest.raises(_Stop):
        jcls_cli.main(argv)
    args = tcls_cli.build_parser().parse_args(argv + ["--device", "cpu"])
    tcls_cli._refuse_unported(args)
    train, val, variants, sensor_hw, rescale = tcls_cli.make_sources(args)
    got = tcls_cli.data_config(args, sensor_hw, rescale)
    for f in dataclasses.fields(got):
        assert getattr(got, f.name) == getattr(want["cfg"], f.name), f.name
    jargs = jcls_cli.build_parser().parse_args(argv)
    jtrain, jval, jvariants, jsensor, jrescale = jcls_cli.make_sources(jargs)
    assert (sensor_hw, rescale) == (jsensor, jrescale)
    assert set(variants) == set(jvariants)
    if dataset == "synthetic":  # the port's take the window's events
        assert (len(train), len(val)) == (len(jtrain), len(jval))
        return
    for g, w in [(train, jtrain), (val, jval)] + [
            (variants[k], jvariants[k]) for k in jvariants]:
        _same_source(g, w)


@pytest.mark.parametrize("dataset", ["dsec", "ddd17"])
def test_semseg_cli_sources_and_config_match_jax(monkeypatch, tmp_path,
                                                 dataset):
    rng = np.random.default_rng(8)
    if dataset == "dsec":
        for seq in (jdp.DsecSource.TRAIN_SEQUENCES
                    + jdp.DsecSource.VAL_SEQUENCES):
            build_dsec_seq(str(tmp_path), seq, rng, n_events=3000, n_ts=8)
    else:
        for seq in ("dir0", "dir1", "dir3", "dir4", "dir6", "dir7"):
            build_ddd17_seq(str(tmp_path), seq, rng, n_events=3000)
    argv = ["--dataset", dataset, "--data_root", str(tmp_path),
            "--num_bins", "3", "--fix_events_num", "2000",
            "--val_fix_events_num", "1500"]
    want, got = {}, {}
    monkeypatch.setattr(jsemseg_cli, "DenseDataConfig",
                        _capture(jdp.DenseDataConfig, want))
    monkeypatch.setattr(tsemseg_cli, "DenseDataConfig",
                        _capture(tdp.DenseDataConfig, got))
    with pytest.raises(_Stop):
        jsemseg_cli.main(argv)
    with pytest.raises(_Stop):
        tsemseg_cli.main(argv + ["--device", "cpu"])
    for f in dataclasses.fields(got["cfg"]):
        assert getattr(got["cfg"], f.name) == getattr(want["cfg"], f.name)
    jargs = jsemseg_cli.build_parser().parse_args(argv)
    targs = tsemseg_cli.build_parser().parse_args(argv + ["--device", "cpu"])
    jsrc, tsrc = jsemseg_cli.make_sources(jargs), tsemseg_cli.make_sources(
        targs)
    assert tsrc[2] == jsrc[2]
    for g, w in zip(tsrc[:2], jsrc[:2]):
        assert type(g).__name__ == type(w).__name__
        assert g.items == w.items and g.sensor_hw == w.sensor_hw
        assert g.fix_events_num == w.fix_events_num
        assert (getattr(g, "window_events_num", None)
                == getattr(w, "window_events_num", None))


def _tiny_cls_hub(num_classes, num_bins=5, **kw):
    return tcls_hub.cls_hub_vit_small(
        num_classes, num_bins, **{**kw, "embed_dim": 64, "depth": 2,
                                  "num_heads": 2})


def test_cls_cli_runs_n_imagenet_with_a_variant(monkeypatch, cls_trees,
                                                capsys, tmp_path):
    monkeypatch.setattr(tcls_cli, "cls_hub_vit_small", _tiny_cls_hub)
    root = cls_trees["n_imagenet"][0]
    variant = cls_trees["variant"][0]
    res = tcls_cli.main([
        "--dataset", "n_imagenet", "--train_root", root, "--val_root", root,
        "--val_variant_roots", variant, "--input_size", str(INPUT),
        "--batch_size", "4", "--epochs", "1", "--fix_events_num", "500",
        "--val_fix_events_num", "500", "--num_workers", "0", "--device",
        "cpu", "--no-bf16", "--print_freq", "1",
        "--output_dir", str(tmp_path)])
    out = capsys.readouterr().out
    assert res["state"].step == 2
    assert np.isfinite(res["val"]["loss"])
    assert "Val[val_mode_1]:" in out and "variant val_mode_1: acc1" in out
    assert np.isfinite(res["variants"]["val_mode_1"]["loss"])


def _tiny_dense_hub(num_classes, num_bins=5, **kw):
    return tdense_hub.dense_hub_vit_small(
        num_classes, num_bins, **{**kw, "embed_dim": 64, "depth": 4,
                                  "num_heads": 2,
                                  "out_indices": (0, 1, 2, 3)})


def test_semseg_cli_runs_ddd17(monkeypatch, tmp_path):
    """``--dataset ddd17`` at DDD17's own 200x346 sensor (tiled, K6's
    plain version), the MEM image."""
    rng = np.random.default_rng(9)
    for seq in ("dir0", "dir1", "dir3", "dir4", "dir6", "dir7"):
        build_ddd17_seq(str(tmp_path / "data"), seq, rng, n_events=3000,
                        n_labels=1, hw=(200, 346))
    monkeypatch.setattr(tsemseg_cli, "dense_hub_vit_small", _tiny_dense_hub)
    res = tsemseg_cli.main([
        "--dataset", "ddd17", "--data_root", str(tmp_path / "data"),
        "--backbone", "vit", "--num_classes", "6", "--num_bins", "3",
        "--input_size", str(INPUT), "--batch_size", "2", "--epochs", "1",
        "--fix_events_num", "1000", "--val_fix_events_num", "1000",
        "--device", "cpu", "--no-bf16", "--print_freq", "1",
        "--output_dir", str(tmp_path / "out")])
    assert res["state"].step == 2  # 5 training labels in batches of 2
    assert np.isfinite(res["miou"])
    record = json.loads((tmp_path / "out" / "log.txt").read_text())
    assert np.isfinite(record["train_loss"])
