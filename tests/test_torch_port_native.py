"""The port's host code (``eventpretrain_tpu_torch.native``, its C++ library
and its numpy specifications) and the load pool, against the JAX package
on the CPU.

Every C entry point of ``native/event_pack.cpp`` is held word for word
against JAX's library, built from JAX's own source here (g++ is present),
on the same numpy-seeded inputs and seeds, and against the port's numpy
specification where one exists (the pack, the bucketers, the u32 encoder;
the window grouping against JAX's numpy planner). A build that cannot run
raises; nothing falls back to numpy. The pipelines' host buffers are not
written again while a batch that came from them is held.
"""

import ctypes
import os
import threading

import numpy as np
import pytest
import torch

from eventpretrain_tpu import native as jnative
from eventpretrain_tpu.models.swin_plan import _group_windows_numpy
from eventpretrain_tpu_torch import native as tnative
from eventpretrain_tpu_torch.data import codec as tcodec
from eventpretrain_tpu_torch.data import cls_pipeline as tcp
from eventpretrain_tpu_torch.data import dense_pipeline as tdp
from eventpretrain_tpu_torch.data import event_transforms as tet
from eventpretrain_tpu_torch.data.io_pool import make_pool, map_loads

# the sensor of the bucketer cases: 2x3 tiles of 128, the last row and
# column partial, as MVSEC's 260x346 is
H, W = 200, 300


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
    assert jnative.BACKEND == "native" and jnative._LIB is not None
    assert tnative.BACKEND == "native"
    tnative.library()


def _forced(monkeypatch):
    monkeypatch.setattr(tnative, "BACKEND", "numpy-forced")


def _streams(rng, lengths, hw=(H, W)):
    out = []
    for n in lengths:
        ev = np.zeros((n, 4), np.float32)
        ev[:, 0] = rng.uniform(0, hw[1], n)
        ev[:, 1] = rng.uniform(0, hw[0], n)
        ev[:, 2] = np.sort(rng.uniform(3.0, 4.0, n))
        ev[:, 3] = rng.choice([-1.0, 1.0], n)
        out.append(ev)
    return out


def _packed(rng, counts, cap, strays=True):
    """A packed batch on the HxW sensor; with ``strays`` sample 0's first
    40 events lie out of frame, past both u32 sentinels included."""
    ev = np.zeros((len(counts), cap, 4), np.float32)
    for i, (s, n) in enumerate(zip(_streams(rng, counts), counts)):
        ev[i, :n] = s
    if strays:
        ev[0, :40, 0] = rng.uniform(-6, 2100, 40)
        ev[0, :40, 1] = rng.uniform(-6, 1100, 40)
    return ev, np.asarray(counts, np.int32)


# ------------------------------------------------------ the C entry points


def test_pack_is_jax_s_word_for_word(monkeypatch):
    rng = np.random.default_rng(0)
    streams = _streams(rng, (700, 0, 1300, 1000))  # over, empty, at cap
    want, wc = jnative.pack_event_batch(streams, 1000)
    got, gc = tnative.pack_event_batch(streams, 1000,
                                       out=np.ones((4, 1000, 4), np.float32))
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(gc, wc)
    _forced(monkeypatch)
    spec, sc = tnative.pack_event_batch(streams, 1000)
    np.testing.assert_array_equal(spec, want)
    np.testing.assert_array_equal(sc, wc)


def test_augment_and_pack_is_jax_s_word_for_word():
    """The fused erase-and-add: windows inside longer streams, one too
    short to augment (a plain copy), one whose growth the capacity clips,
    64-bit seeds."""
    rng = np.random.default_rng(1)
    streams = _streams(rng, (5000, 80, 3000, 4000))
    windows = [(100, 4100), (0, 80), (0, 3000), (500, 4000)]
    hws = [(float(H), float(W)), (60.0, 90.0), (float(H), float(W)),
           (100.0, 120.0)]
    seeds = rng.integers(0, 2 ** 63, 4)
    want = jnative.augment_pack_event_batch(streams, windows, hws, 3900,
                                            seeds)
    got = tnative.augment_pack_event_batch(streams, windows, hws, 3900,
                                           seeds)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)
    assert got[1][1] == 80 and got[1][0] == 3900  # copied; clipped
    again = tnative.augment_pack_event_batch(streams, windows, hws, 3900,
                                             seeds, out=got[0])
    assert again[0] is got[0]
    np.testing.assert_array_equal(again[1], want[1])


def test_augment_refuses_a_window_outside_its_stream():
    streams = _streams(np.random.default_rng(2), (100,))
    with pytest.raises(ValueError, match="outside a stream"):
        tnative.augment_pack_event_batch(streams, [(50, 151)], [(H, W)], 200,
                                         [0])


@pytest.mark.parametrize("fn", ["bucket_pack_event_batch",
                                "bucket_pack_event_batch_u32"],
                         ids=["f32", "u32"])
def test_bucketers_are_jax_s_word_for_word(monkeypatch, fn):
    """Both bucketers on a sensor with partial tiles, strays past every
    edge, an empty sample and a sample whose tiles fill whole chunks:
    against JAX's library and the port's numpy specification."""
    rng = np.random.default_rng(3)
    ev, counts = _packed(rng, (2500, 0, 1024, 1800), 2600)
    kw = dict(height=H, width=W, chunk=256)
    want = getattr(jnative, fn)(ev, counts, **kw)
    got = getattr(tnative, fn)(ev, counts, **kw)
    _forced(monkeypatch)
    spec = getattr(tnative, fn)(ev, counts, **kw)
    for g, s, w in zip(got, spec, want):
        assert g.dtype == w.dtype and g.shape == w.shape
        np.testing.assert_array_equal(g, w)
        np.testing.assert_array_equal(s, w)


def test_u32_encoder_is_jax_s_word_for_word(monkeypatch):
    rng = np.random.default_rng(4)
    ev, counts = _packed(rng, (900, 1, 0, 640), 900)
    ev[3, :640, 2] = 7.5  # one time window of zero length
    want = jnative.encode_events_u32_native(ev, counts)
    got = tnative.encode_events_u32_native(ev, counts)
    via_codec = tcodec.encode_events_u32(ev, counts)
    _forced(monkeypatch)
    assert tnative.encode_events_u32_native(ev, counts) is None
    spec = tcodec.encode_events_u32(ev, counts)
    for g, c, s, w in zip(got, via_codec, spec, want):
        np.testing.assert_array_equal(g, w)
        np.testing.assert_array_equal(c, w)
        np.testing.assert_array_equal(s, w)


def test_window_grouping_is_jax_s():
    """The sparse-Swin planner's knapsack grouping against JAX's library
    and JAX's numpy dynamic programme, ties included."""
    rng = np.random.default_rng(5)
    for _ in range(40):
        cap = int(rng.integers(1, 60))
        weights = rng.integers(1, cap + 1, int(rng.integers(1, 80))).tolist()
        group_of, n = tnative.group_windows_native(cap, weights)
        want_of, want_n = jnative.group_windows_native(cap, weights)
        np.testing.assert_array_equal(group_of, want_of)
        assert n == want_n
        sums, members = _group_windows_numpy(cap, weights)
        assert [np.flatnonzero(group_of == g).tolist()
                for g in range(n)] == members
    with pytest.raises(ValueError, match="weights"):
        tnative.group_windows_native(4, [5])


def test_checks_the_arrays_it_hands_the_library():
    ev, counts = _packed(np.random.default_rng(6), (50,), 50)
    with pytest.raises(ValueError, match="counts"):
        tnative.encode_events_u32_native(ev, np.array([51], np.int32))
    with pytest.raises(ValueError, match="expected"):
        tnative.bucket_pack_event_batch(ev[..., :3], counts, height=H,
                                        width=W)


# --------------------------------------------------- the build, no fallback


def _fresh_build(monkeypatch, tmp_path):
    monkeypatch.setattr(tnative, "_LIB", None)
    monkeypatch.setattr(tnative, "BUILD_DIR", tmp_path / "host_native")


def test_a_missing_compiler_raises_and_nothing_falls_back(monkeypatch,
                                                          tmp_path):
    _fresh_build(monkeypatch, tmp_path)
    monkeypatch.setattr(tnative, "CXX", "no-such-compiler-g++")
    streams = _streams(np.random.default_rng(7), (10,))
    with pytest.raises(RuntimeError, match="no-such-compiler-g"):
        tnative.pack_event_batch(streams, 16)
    with pytest.raises(RuntimeError, match="not found"):
        tnative.augment_pack_event_batch(streams, [(0, 10)], [(H, W)], 16,
                                         [1])
    assert tnative.BACKEND == "native" and tnative._LIB is None


def test_a_failed_build_raises_with_the_compiler_s_message(monkeypatch,
                                                           tmp_path):
    _fresh_build(monkeypatch, tmp_path)
    monkeypatch.setattr(tnative, "CXX_FLAGS",
                        tnative.CXX_FLAGS + ("-fno-such-option",))
    with pytest.raises(RuntimeError, match="no-such-option"):
        tnative.library()
    assert not list((tmp_path / "host_native").iterdir())  # no leftovers


def test_an_unknown_backend_is_refused(monkeypatch):
    monkeypatch.setattr(tnative, "BACKEND", "numpy")
    with pytest.raises(ValueError, match="numpy-forced"):
        tnative.pack_event_batch([np.zeros((1, 4), np.float32)], 4)


def test_builds_that_race_each_leave_a_whole_library(monkeypatch, tmp_path):
    """Two threads build one library at once (a one-function source, to
    keep the compiler's time short), each into a name of its own renamed
    into place: one whole library, no leftovers. The library's name
    follows its source, flags and compiler."""
    _fresh_build(monkeypatch, tmp_path)
    path = tnative.library_path()
    assert path.parent == tmp_path / "host_native"
    assert path.name.startswith("libeventpack-") and path.suffix == ".so"
    monkeypatch.setattr(tnative, "CXX_FLAGS", tnative.CXX_FLAGS + ("-g",))
    assert tnative.library_path() != path
    source = tmp_path / "one.cpp"
    source.write_text('extern "C" int one() { return 1; }\n')
    monkeypatch.setattr(tnative, "SOURCE", source)
    path = tnative.library_path()
    errors = []

    def build():
        try:
            tnative._build(path)
        except Exception as e:  # surfaced by the assert below
            errors.append(e)

    threads = [threading.Thread(target=build) for _ in range(2)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=120)
    assert not errors and not any(t.is_alive() for t in threads)
    assert [p.name for p in path.parent.iterdir()] == [path.name]
    assert ctypes.CDLL(str(path)).one() == 1


# --------------------------------------------------- load pool and buffers


def test_load_pool_keeps_index_order_and_raises_a_load_s_error():
    assert make_pool(0) is None
    with make_pool(3) as pool:
        assert map_loads(lambda i: i * i, np.arange(7)[::-1], pool) == [
            i * i for i in range(6, -1, -1)]

        def bad(i):
            raise KeyError(i)

        with pytest.raises(KeyError):
            map_loads(bad, [1], pool)
    assert map_loads(str, [3, 1], None) == ["3", "1"]


def _clone(batch):
    return {k: v.clone() if torch.is_tensor(v) else v
            for k, v in batch.items()}


@pytest.mark.parametrize("make", ["cls", "semseg_tiled", "flow"])
def test_held_batches_outlive_the_host_buffers(make):
    """Batches held while the pipeline builds the next ones equal batches
    copied the moment they came: no batch aliases a host buffer that a
    later batch writes (the packed events, the wire words, the labels)."""
    def pipe():
        if make == "cls":
            src = tcp.SyntheticClsSource(2, 5, num_events=900,
                                         sensor_hw=(40, 50))
            cfg = tcp.ClsDataConfig(num_classes=2, input_size=16,
                                    fix_events_num=800, canvas_height=48,
                                    canvas_width=56,
                                    compact_transfer=False)
            return tcp.ClsPipeline(src, cfg, 3, True, seed=1, num_workers=2,
                                   device="cpu")
        task = "flow" if make == "flow" else "semseg"
        src = tdp.SyntheticDenseSource(task, n=6, sensor_hw=(H, W),
                                       num_events=1500)
        cfg = tdp.DenseDataConfig(task=task, input_size=16,
                                  fix_events_num=1500, sensor_height=H,
                                  sensor_width=W, label_size=(20, 30),
                                  tiled_raster="on",
                                  compact_transfer=make != "flow")
        return tdp.DensePipeline(src, cfg, 2, True, seed=1, device="cpu")

    held = list(pipe())
    copied = [_clone(b) for b in pipe()]
    # three batches at least: batch 0's buffers come round again at batch 2
    assert len(held) == len(copied) >= 3
    for h, c in zip(held, copied):
        for k, v in c.items():
            if torch.is_tensor(v):
                assert torch.equal(h[k], v), k
            else:
                assert h[k] == v


def test_pack_event_batch_spec_clears_a_reused_buffer():
    streams = _streams(np.random.default_rng(8), (10,))
    for fn in (tet.pack_event_batch, tnative.pack_event_batch):
        out, _ = fn(streams, 20, out=np.ones((1, 20, 4), np.float32))
        assert not out[0, 10:].any()
