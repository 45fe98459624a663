"""Time the two splats, K3 (``csrc/splat.cu``) and K6
(``csrc/splat_tiled.cu``), of this checkout against another checkout's, in
turns on one card.

    git archive <commit> eventpretrain_tpu_torch/csrc | tar -x -C build/base
    python3 -m eventpretrain_tpu_torch.tools.compare_splat \\
        --baseline build/base/eventpretrain_tpu_torch/csrc

The baseline's ``splat.cu`` and ``splat_tiled.cu`` are built with this
checkout's ``nvcc`` flags into ``build/baseline_kernels/`` (beside a
second build of this checkout's, for ptxas's registers, spills and shared
memory of both) and called through the C entry points both have:
``splat_f32(y, x, w, out, B, C, E, H, W, stream)`` into a zeroed grid and
``splat_tiled_f32(y, x, w, table, bin_range, out, B, C, E, chunk, H, W,
tile_h, tile_w, stream)``.

The shapes are the main paths': K3 at (64, 5, 30000) on the 128x128 canvas
(the served call and the cls step), and at B=32 and B=8 (B=8 takes the
global route, below K3's batch threshold; the variants time the cluster
route there); K6 on the first semseg
batch's own wire data (B=16, DSEC's 440x640, 200000 events, the dense
pipeline's u32 words decoded), with and without bin ranges, and the 2-bin
count image of the same events; K3 on DSEC's 440x640x5 at B=16, where
``tiled_raster="off"`` sends the semseg batch. ``--variants`` adds this
checkout's launch plans other than the default (``plan_variants``:
other cluster sizes), each held against the plain version and graph-timed in turns,
with the number of its clusters the card holds at once.

Every build is held against the plain version (``splat_reference``,
``splat_tiled_reference``) within ``SPLAT_ATOL``. Times: CUDA events
around one call, the median of ``--reps`` event pairs after warm-up, in
the order baseline, this checkout, this checkout, baseline (the one-call
time carries the wrapper's host work, and the baseline K3's zero fill);
and the same from CUDA graphs of 10 calls, which time the card alone;
beside the bound (each input byte read once, each output byte written
once, over 3.35 TB/s; K6 counts the weights inside each chunk's bin range
only) and one ``index_put_(accumulate=True)`` on the cells and weights the
plain version selects. Prints one line per row and a last JSON line with
the card's name and power limit.
"""

from __future__ import annotations

import argparse
import ctypes
import functools
import json
import subprocess
from pathlib import Path

import numpy as np
import torch

from eventpretrain_tpu_torch import _build
from eventpretrain_tpu_torch.native import TILE_CHUNK, TILE_H, TILE_W
from eventpretrain_tpu_torch.ops import splat as k3
from eventpretrain_tpu_torch.ops import splat_tiled as k6
from eventpretrain_tpu_torch.ops.common import _stream
from eventpretrain_tpu_torch.ops.events import (
    bilinear_bin_weights,
    bilinear_bin_weights_windowed,
    polarity_weights_coordvalid,
)
from eventpretrain_tpu_torch.tools.compare_attention import compare, cuda_ms
from eventpretrain_tpu_torch.tools.compare_gemm import graph_ms

OUT_DIR = _build.BUILD_DIR.parent / "baseline_kernels"
PEAK_BYTES = 3.35e12  # H100 SXM device memory, bytes/s
# f32 sums of the same weights in another order; cells hold a few unit
# weights, so the reordering error is ~1e-6
SPLAT_ATOL = 1e-4
NUM_BINS = 5
CANVAS = (128, 128)  # N-Cars' 100x120 sensor on the cls canvas
NCARS_EVENTS = 30000
DSEC_HW = (440, 640)
DSEC_EVENTS = 200_000
DENSE_BATCH = 16
_P, _I = ctypes.c_void_p, ctypes.c_int
BASELINE_SIGNATURES = {
    "splat": {"splat_f32": [_P, _P, _P, _P, _I, _I, _I, _I, _I, _P]},
    "splat_tiled": {"splat_tiled_f32": [_P, _P, _P, _P, _P, _P, _I, _I, _I,
                                        _I, _I, _I, _I, _I, _P]},
}


def build_baseline(csrc: Path) -> tuple[dict, dict, dict]:
    """Compile the baseline's two splat sources, and this checkout's again
    beside them for their ptxas report: the baseline's libraries and
    ptxas's report of each kernel of both."""
    OUT_DIR.mkdir(parents=True, exist_ok=True)
    procs = {(who, name): subprocess.Popen(
        [_build.nvcc_path(), *_build.NVCC_FLAGS, "-o",
         str(OUT_DIR / f"lib{name}_{who}.so"), str(src / f"{name}.cu")],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        for who, src in (("baseline", csrc), ("now", _build.CSRC))
        for name in BASELINE_SIGNATURES}
    usage = {"baseline": {}, "now": {}}
    for (who, name), proc in procs.items():
        log = proc.communicate()[0]
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed for {who} {name}\n{log}")
        usage[who].update(_build.ptxas_usage(name, log))
    libs = {}
    for name, sigs in BASELINE_SIGNATURES.items():
        lib = ctypes.CDLL(str(OUT_DIR / f"lib{name}_baseline.so"))
        for fn, argtypes in sigs.items():
            getattr(lib, fn).argtypes = argtypes
            getattr(lib, fn).restype = ctypes.c_int
        lib.kernel_error_string.argtypes = [ctypes.c_int]
        lib.kernel_error_string.restype = ctypes.c_char_p
        libs[name] = lib
    return libs, usage["baseline"], usage["now"]


class Baseline:
    """The baseline's two splats behind this checkout's signatures."""

    def __init__(self, libs):
        self.libs = libs

    def splat(self, y, x, w, *, height, width):
        b, c, e = w.shape
        out = torch.zeros((b, height, width, c), dtype=torch.float32,
                          device=w.device)
        lib = self.libs["splat"]
        code = lib.splat_f32(y.data_ptr(), x.data_ptr(), w.data_ptr(),
                             out.data_ptr(), b, c, e, height, width,
                             _stream(w))
        _build.check(lib, "baseline splat_f32", code)
        return out

    def splat_tiled(self, y, x, w, table, bin_range=None, *, height, width):
        b, c, e = w.shape
        out = torch.empty((b, height, width, c), dtype=torch.float32,
                          device=w.device)
        lib = self.libs["splat_tiled"]
        code = lib.splat_tiled_f32(
            y.data_ptr(), x.data_ptr(), w.data_ptr(), table.data_ptr(),
            None if bin_range is None else bin_range.data_ptr(),
            out.data_ptr(), b, c, e, TILE_CHUNK, height, width, TILE_H,
            TILE_W, _stream(w))
        _build.check(lib, "baseline splat_tiled_f32", code)
        return out


def launch_k3(plan, y, x, w, *, height, width):
    """This checkout's K3 cluster route under ``plan`` (a variant's)."""
    b, c, e = w.shape
    out = torch.empty((b, height, width, c), dtype=torch.float32,
                      device=w.device)
    lib = _build.load("splat")
    code = lib.splat_cluster_f32(
        y.data_ptr(), x.data_ptr(), w.data_ptr(), out.data_ptr(), b, c, e,
        height, width, plan.cluster, plan.cp, plan.smem_bytes, _stream(w))
    _build.check(lib, "splat_cluster_f32", code)
    return out


def launch_k6(plan, y, x, w, table, bin_range, *, height, width):
    """This checkout's K6 under ``plan`` (a variant's)."""
    b, c, e = w.shape
    out = torch.empty((b, height, width, c), dtype=torch.float32,
                      device=w.device)
    lib = _build.load("splat_tiled")
    code = lib.splat_tiled_cluster_f32(
        y.data_ptr(), x.data_ptr(), w.data_ptr(), table.data_ptr(),
        None if bin_range is None else bin_range.data_ptr(), out.data_ptr(),
        b, c, e, TILE_CHUNK, height, width, TILE_H, TILE_W, plan.cluster,
        plan.cp, plan.groups, plan.smem_bytes, _stream(w))
    _build.check(lib, "splat_tiled_cluster_f32", code)
    return out


def k3_inputs(rng, batch: int, events: int, hw, dev):
    """Raw events on the grid ``hw`` with strays up to 8 past each edge,
    ragged counts (rows past a count weigh 0), and their (B, 5, E) bin
    weights, as the cls pipeline computes them for K3."""
    h, w = hw
    ev = np.zeros((batch, events, 4), np.float32)
    counts = rng.integers(events // 2, events + 1, batch).astype(np.int32)
    counts[0] = events
    for b in range(batch):
        n = counts[b]
        ev[b, :n, 0] = rng.integers(-8, w + 8, n)
        ev[b, :n, 1] = rng.integers(-8, h + 8, n)
        ev[b, :n, 2] = np.sort(rng.uniform(0.0, 0.1, n))
        ev[b, :n, 3] = rng.integers(0, 2, n)
    ev_t = torch.from_numpy(ev).to(dev)
    counts_t = torch.from_numpy(counts).to(dev)
    x = ev_t[..., 0].to(torch.int32).contiguous()
    y = ev_t[..., 1].to(torch.int32).contiguous()
    wb = bilinear_bin_weights(ev_t, counts_t, NUM_BINS).transpose(1, 2)
    return y, x, wb.contiguous()


class RecordedWire:
    """Within the block, every call of the dense pipeline's device half
    (``module._device_preprocess``) is recorded, arguments and options."""

    def __init__(self, module):
        self.module, self.real, self.calls = module, None, []

    def __enter__(self) -> list:
        self.real = self.module._device_preprocess

        def recorded(*args, **kwargs):
            self.calls.append((args, kwargs))
            return self.real(*args, **kwargs)

        self.module._device_preprocess = recorded
        return self.calls

    def __exit__(self, *exc):
        self.module._device_preprocess = self.real


def semseg_wire(dev) -> tuple:
    """The first semseg training batch's wire data, as the dense pipeline
    ships it to its device half (``chip_smoke.py`` phase 5c): y, x, the
    5-bin weights, the tile table, the chunks' bin ranges, and the 2-bin
    count image's polarity weights."""
    from eventpretrain_tpu_torch.data import dense_pipeline as dp
    from eventpretrain_tpu_torch.data.codec import decode_events_u32
    from eventpretrain_tpu_torch.ops.splat_tiled import chunk_bin_range

    source = dp.SyntheticDenseSource(
        "semseg", n=DENSE_BATCH, num_classes=11, sensor_hw=DSEC_HW,
        num_events=DSEC_EVENTS, seed=0)
    cfg = dp.DenseDataConfig(
        task="semseg", num_bins=NUM_BINS, input_size=224,
        fix_events_num=DSEC_EVENTS, val_fix_events_num=DSEC_EVENTS,
        sensor_height=DSEC_HW[0], sensor_width=DSEC_HW[1],
        label_size=DSEC_HW, tiled_raster="auto")
    with RecordedWire(dp) as calls:
        next(iter(dp.DensePipeline(source, cfg, DENSE_BATCH, train=True,
                                   seed=0, device=dev)))
    args, kw = calls[0]
    t_range, table = kw["t_range"], kw["tile_table"].contiguous()
    events = decode_events_u32(args[0], t_range)
    h, w = DSEC_HW
    x = events[..., 0].to(torch.int32).contiguous()
    y = events[..., 1].to(torch.int32).contiguous()
    valid = (x >= 0) & (x < w) & (y >= 0) & (y < h)
    wb = bilinear_bin_weights_windowed(events, valid, t_range[:, 0],
                                       t_range[:, 1], NUM_BINS)
    wb = wb.transpose(1, 2).contiguous()
    br = chunk_bin_range(t_range, kw["tile_chunk_trange"], NUM_BINS)
    count_w = polarity_weights_coordvalid(events, h, w)
    return y, x, wb, table.to(torch.int32), br, count_w


def index_put_call(y, x, w, hw, keep=None):
    """One ``index_put_(accumulate=True)`` of the in-frame cells (``keep``
    narrows them further) into a preallocated grid."""
    h, wd = hw
    b, c, _ = w.shape
    ok = (y >= 0) & (y < h) & (x >= 0) & (x < wd)
    if keep is not None:
        ok &= keep
    cell = ((torch.arange(b, device=y.device)[:, None] * h + y.long()) * wd
            + x.long())[ok]
    vals = w.transpose(1, 2)[ok].float()
    acc = torch.zeros((b * h * wd, c), device=y.device)
    return lambda: acc.index_put_((cell,), vals, accumulate=True)


def tile_keep(y, x, table):
    """Slots whose coordinates lie inside their chunk's tile."""
    tiles_x = -(-DSEC_HW[1] // TILE_W)
    tile = table.long().repeat_interleave(TILE_CHUNK, dim=1)
    ty0, tx0 = tile // tiles_x * TILE_H, tile % tiles_x * TILE_W
    return ((y >= ty0) & (y < ty0 + TILE_H) & (x >= tx0)
            & (x < tx0 + TILE_W))


def plan_variants(plan_fn) -> dict:
    """The launch plans to time beside the planner's (``plan_fn()``: 2 CTAs
    of 3 and 2 channels at a 128x128x5 plane, one CTA an SM): 2, 3 and 5
    CTAs where the planner's is another (more SMs, and more reads of the
    coordinates)."""
    base = plan_fn()
    plans = {"default": base}
    for n in (2, 3, 5):
        plan = plan_fn(cluster=n)
        if plan is not None and plan != base:
            plans[f"c{n}"] = plan
    return plans


def k3_variants(h: int, w: int, c: int) -> dict:
    return plan_variants(functools.partial(k3.splat_plan, h, w, c))


def k6_variants(c: int) -> dict:
    return plan_variants(functools.partial(k6.splat_tiled_plan, TILE_H,
                                           TILE_W, c))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--baseline", type=Path, required=True,
                    help="the other checkout's eventpretrain_tpu_torch/csrc")
    ap.add_argument("--reps", type=int, default=20)
    ap.add_argument("--variants", action="store_true",
                    help="also time this checkout's other launch plans")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("compare_splat: no CUDA device")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip()
    print(f"nvidia-smi: {smi}", flush=True)
    _build.build(tuple(BASELINE_SIGNATURES))
    libs, base_usage, usage = build_baseline(args.baseline.resolve())
    base = Baseline(libs)
    for kernel in sorted(set(usage) | set(base_usage)):
        print(f"ptxas {kernel}: " + "; ".join(
            f"{who} {u[kernel]['registers']} registers, "
            f"{u[kernel]['spill_stores']} B spill stores, "
            f"{u[kernel]['static_smem']} B static shared memory"
            for who, u in (("baseline", base_usage), ("now", usage))
            if kernel in u), flush=True)
    dev = torch.device("cuda", 0)
    rng = np.random.default_rng(31)
    rows, failed = [], []

    def variants(what, shape, want, make, plans):
        """This checkout's launch plans beside its default, each held
        against the plain version and graph-timed, in turns."""
        fns = {name: make(plan) for name, plan in plans.items()}
        for name, fn in fns.items():
            err = (fn() - want).abs().max().item()
            if not err <= SPLAT_ATOL:
                failed.append(f"{what} {shape} variant {name}: {err:.3g}")
        order = list(fns) + list(fns)[::-1]
        times = {}
        for name in order:
            t = graph_ms(fns[name], reps=args.reps)
            times[name] = min(times.get(name, t), t)
        for name, plan in plans.items():
            occ = (k3.max_active_clusters(
                "splat" if what.startswith("K3") else "splat_tiled",
                plan.cluster, plan.smem_bytes, 0))
            rows.append({"kernel": what, "shape": shape, "variant": name,
                         "plan": plan.__dict__, "device_ms": times[name],
                         "max_active_clusters": occ})
            print(f"{what} {shape} variant {name} ({plan}): graph-timed "
                  f"{times[name] * 1e3:.4g} us, {occ} clusters resident "
                  f"at once ({smi})", flush=True)

    def run(what, shape, theirs, mine, plain, nbytes, library, make=None,
            plans=None):
        want = plain()
        errs = [(f() - want).abs().max().item() for f in (theirs, mine)]
        if args.variants and plans:
            variants(what, shape, want, make, plans)
        del want
        if not max(errs) <= SPLAT_ATOL:
            failed.append(f"{what} {shape}: max_abs_err baseline {errs[0]:.3g}"
                          f", now {errs[1]:.3g}")
        times = compare(theirs, mine, 1, args.reps)
        b1, m1, m2, b2 = (graph_ms(f, reps=args.reps)
                          for f in (theirs, mine, mine, theirs))
        times.update(device_ms=min(m1, m2), baseline_device_ms=min(b1, b2),
                     bytes=nbytes, bound_ms=nbytes / PEAK_BYTES * 1e3,
                     library_ms=cuda_ms(library, 1, args.reps),
                     max_abs_err=errs[1], baseline_max_abs_err=errs[0])
        rows.append({"kernel": what, "shape": shape, **times})
        print(f"{what} {shape}: one call baseline {times['baseline_ms']:.4g}"
              f" ms, now {times['ms']:.4g} ms; graph-timed baseline "
              f"{times['baseline_device_ms'] * 1e3:.4g} us, now "
              f"{times['device_ms'] * 1e3:.4g} us, bound "
              f"{times['bound_ms'] * 1e3:.4g} us ("
              f"{times['bound_ms'] / times['device_ms']:.1%} of it); "
              f"index_put_ {times['library_ms']:.4g} ms; max_abs_err "
              f"{errs[1]:.3g} / {errs[0]:.3g} ({smi})", flush=True)

    # K3: the served call and cls step's batch, the served B=8, and DSEC's
    # grid untiled
    for b, e, hw in ((64, NCARS_EVENTS, CANVAS), (32, NCARS_EVENTS, CANVAS),
                     (8, NCARS_EVENTS, CANVAS),
                     (DENSE_BATCH, DSEC_EVENTS, DSEC_HW)):
        y, x, w = k3_inputs(rng, b, e, hw, dev)
        kw = dict(height=hw[0], width=hw[1])
        plans = (k3_variants(hw[0], hw[1], NUM_BINS)
                 if k3.splat_plan(*hw, NUM_BINS) is not None else None)
        run("K3 splat", [b, NUM_BINS, e, *hw],
            lambda: base.splat(y, x, w, **kw), lambda: k3.splat(y, x, w, **kw),
            lambda: k3.splat_reference(y, x, w, **kw),
            8 * b * e + 4 * w.numel() + 4 * b * hw[0] * hw[1] * NUM_BINS,
            index_put_call(y, x, w, hw),
            lambda plan: lambda: launch_k3(plan, y, x, w, **kw), plans)
        del y, x, w

    # K6 on the semseg batch: 5 bins with and without bin ranges, and the
    # 2-bin count image of the same events
    y, x, wb, table, br, count_w = semseg_wire(dev)
    keep = tile_keep(y, x, table)
    kw = dict(height=DSEC_HW[0], width=DSEC_HW[1])
    cells = 4 * DENSE_BATCH * DSEC_HW[0] * DSEC_HW[1]
    for what, w, bins in (("K6 splat_tiled+bins", wb, br),
                          ("K6 splat_tiled", wb, None),
                          ("K6 splat_tiled count image", count_w, None)):
        b, c, e = w.shape
        if bins is None:
            in_range = b * c * e
        else:
            ch = torch.arange(c, device=dev)[None, None]
            in_range = int(((ch >= bins[..., :1]) & (ch <= bins[..., 1:]))
                           .sum()) * TILE_CHUNK
        nbytes = (8 * b * e + 4 * in_range + 4 * table.numel()
                  + (0 if bins is None else 4 * bins.numel()) + cells * c)
        run(what, [b, c, e, *DSEC_HW],
            lambda w=w, bins=bins: base.splat_tiled(y, x, w, table, bins,
                                                    **kw),
            lambda w=w, bins=bins: k6.splat_tiled(y, x, w, table, bins, **kw),
            lambda w=w, bins=bins: k6.splat_tiled_reference(
                y, x, w, table, bins, **kw),
            nbytes, index_put_call(y, x, w, DSEC_HW, keep),
            lambda plan, w=w, bins=bins: lambda: launch_k6(
                plan, y, x, w, table, bins, **kw),
            k6_variants(c))
    print(json.dumps({"compare_splat": rows, "card": smi,
                      "ptxas": {"baseline": base_usage, "now": usage},
                      "reps": args.reps}))
    if failed:
        raise SystemExit("compare_splat: " + "; ".join(failed))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
