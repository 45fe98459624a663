#!/usr/bin/env python3
"""Drive the PyTorch port on one NVIDIA GPU, end to end, and check it.

    python3 chip_smoke.py

Phases (any failure exits non-zero; nothing is caught):

1. Environment: torch / CUDA versions, the card's name and power limit
   (nvidia-smi), TF32 off for the f32 comparisons; every CUDA kernel of the
   port built from ``eventpretrain_tpu_torch/csrc`` (one nvcc per source, all
   at once).
2. Kernel parity on the card, each kernel against its plain PyTorch version
   on the same inputs: the splat (K3) at B=8, E=30000, 128x128x5; the LN
   attention (K1) and LN MLP (K2) sub-blocks in bf16 at (8, 196, 384) and
   (8, 196, 768), 12 heads.
3. Main path: the ViT-S/16 classification hub (2 classes, N-Cars), full
   width, random weights from seed 0, bf16 on the card, fed synthetic raw
   N-Cars-shaped events (sensor 100x120 on a 128x128 canvas, E=30000, B=8)
   through ``make_cls_infer``. Launch counts are read from this one run;
   the logits are held against the unfused plain path and an f32 run.
4. Serving: ``make_server`` on an ephemeral port, POST /predict at batch 1,
   8 and 64 plus GET /healthz, each answer against a direct call.
5. Timing (CUDA events, median of 20 after warm-up): each kernel against
   its plain version at the B=64 main-path shapes, and the served
   function's samples/s at B=64 from raw events to logits.

The last line is ``{"ok": true, "device": {...}}``; the line before it the
per-kernel JSON record.
"""

from __future__ import annotations

import io
import json
import statistics
import subprocess
import sys
import threading
import time
import urllib.request

import numpy as np
import torch

NUM_CLASSES = 2
SENSOR_HW = (100, 120)  # N-Cars
CANVAS = (128, 128)
NUM_BINS = 5
EVENTS = 30000
DEPTH = 12
REPS = 20


def log(*args):
    print(*args, flush=True)


def make_events(rng: np.random.Generator, batch: int, sensor_hw=SENSOR_HW,
                capacity: int = EVENTS, out_of_frame: bool = False):
    """Synthetic raw events: integer xy on the sensor, sorted t in seconds,
    polarity in {0, 1}, ragged counts, rows past the count zero-padded."""
    h, w = sensor_hw
    ev = np.zeros((batch, capacity, 4), np.float32)
    counts = rng.integers(capacity // 2, capacity + 1, batch).astype(np.int32)
    counts[0] = capacity
    lo, hi = (-8, 8) if out_of_frame else (0, 0)
    for b in range(batch):
        n = counts[b]
        ev[b, :n, 0] = rng.integers(lo, w + hi, n)
        ev[b, :n, 1] = rng.integers(lo, h + hi, n)
        ev[b, :n, 2] = np.sort(rng.uniform(0.0, 0.1, n))
        ev[b, :n, 3] = rng.integers(0, 2, n)
    sensor = np.tile(np.asarray(sensor_hw, np.int32), (batch, 1))
    return ev, counts, sensor


def cuda_ms(fn, reps: int = REPS, warmup: int = 3) -> float:
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        stop = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        stop.record()
        stop.synchronize()
        times.append(start.elapsed_time(stop))
    return statistics.median(times)


def host_ms(fn, reps: int = REPS, warmup: int = 3) -> list[float]:
    """Host-clock times (ms) of ``reps`` synchronised calls, sorted."""
    for _ in range(warmup):
        fn()
    times = []
    for _ in range(reps):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    return sorted(times)


def require(cond: bool, what: str) -> None:
    if not cond:
        raise SystemExit(f"chip_smoke: FAILED: {what}")


# ---------------------------------------------------------------- phase 1


def phase_environment() -> str:
    from eventpretrain_tpu_torch import _build

    log(f"python {sys.version.split()[0]} torch {torch.__version__} "
        f"cuda {torch.version.cuda}")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip()
    log(f"nvidia-smi: {smi}")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    t0 = time.perf_counter()
    logs = _build.build()
    log(f"built {sorted(logs) or 'nothing (up to date)'} in "
        f"{time.perf_counter() - t0:.1f} s")
    for name, text in sorted(logs.items()):
        for line in text.splitlines():
            if "registers" in line or "spill" in line or "error" in line:
                log(f"  [{name}] {line.strip()}")
    return smi


# ---------------------------------------------------------------- phase 2


def _subblock_inputs(gen, b, l, c, dev):
    def rnd(*shape, std=1.0, dtype=torch.bfloat16):
        return (torch.randn(shape, generator=gen) * std).to(dev, dtype)

    return dict(
        x=rnd(b, l, c),
        ln_w=(1.0 + 0.1 * torch.randn(c, generator=gen)).to(dev),
        ln_b=(0.1 * torch.randn(c, generator=gen)).to(dev),
        std=c ** -0.5,
        rnd=rnd,
    )


def k1_args(gen, b, l, c, dev):
    a = _subblock_inputs(gen, b, l, c, dev)
    rnd, std = a["rnd"], a["std"]
    return (a["x"], a["ln_w"], a["ln_b"], rnd(3 * c, c, std=std),
            rnd(3 * c, std=0.1), rnd(c, c, std=std), rnd(c, std=0.1))


def k2_args(gen, b, l, c, dev):
    a = _subblock_inputs(gen, b, l, c, dev)
    rnd, std = a["rnd"], a["std"]
    return (a["x"], a["ln_w"], a["ln_b"], rnd(4 * c, c, std=std),
            rnd(4 * c, std=0.1), rnd(c, 4 * c, std=(4 * c) ** -0.5),
            rnd(c, std=0.1))


def splat_args(rng, batch, dev):
    from eventpretrain_tpu_torch.ops.events import bilinear_bin_weights

    ev, counts, _ = make_events(rng, batch, sensor_hw=CANVAS,
                                out_of_frame=True)
    ev = torch.from_numpy(ev).to(dev)
    counts = torch.from_numpy(counts).to(dev)
    x = ev[..., 0].to(torch.int32).contiguous()
    y = ev[..., 1].to(torch.int32).contiguous()
    wb = bilinear_bin_weights(ev, counts, NUM_BINS).transpose(1, 2)
    return y, x, wb.contiguous()


# bf16 sub-blocks: the kernel and the plain version round at the same
# points, but their f32 sums run in other orders, so a bf16 rounding of qkv,
# p, o or h can land one ulp apart and the output (|y| <~ 5, ulp 2^-6..2^-5)
# may differ by a few ulps: bound the error by 2% of the output's scale.
SUBBLOCK_REL_TOL = 2e-2
# f32 splat: atomics add in a run-dependent order; cells hold a few unit
# weights, so f32 reordering error is ~1e-6.
SPLAT_ATOL = 1e-4


def phase_kernel_parity(dev) -> dict:
    from eventpretrain_tpu_torch.ops.fused_attn_layer import (
        fused_ln_attn_layer,
        fused_ln_attn_layer_reference,
    )
    from eventpretrain_tpu_torch.ops.fused_mlp import (
        fused_ln_mlp,
        fused_ln_mlp_reference,
    )
    from eventpretrain_tpu_torch.ops.splat import splat, splat_reference

    errs = {}
    rng = np.random.default_rng(1)
    y, x, wb = splat_args(rng, 8, dev)
    hw = dict(height=CANVAS[0], width=CANVAS[1])
    got, ref = splat(y, x, wb, **hw), splat_reference(y, x, wb, **hw)
    torch.cuda.synchronize()
    err = (got - ref).abs().max().item()
    log(f"splat (8, {NUM_BINS}, {EVENTS}) -> {tuple(got.shape)}: "
        f"max_abs_err {err:.3g} (tol {SPLAT_ATOL}), "
        f"sum {got.sum().item():.6g} vs {ref.sum().item():.6g}")
    require(err <= SPLAT_ATOL, "splat disagrees with splat_reference")
    errs["splat"] = (err, SPLAT_ATOL)

    gen = torch.Generator().manual_seed(2)
    for c in (384, 768):
        heads, scale = 12, (c // 12) ** -0.5
        cases = (
            ("fused_ln_attn_layer", fused_ln_attn_layer,
             fused_ln_attn_layer_reference, k1_args(gen, 8, 196, c, dev),
             dict(num_heads=heads, scale=scale)),
            ("fused_ln_mlp", fused_ln_mlp, fused_ln_mlp_reference,
             k2_args(gen, 8, 196, c, dev), {}),
        )
        for name, fn, plain, args, kw in cases:
            got, ref = fn(*args, **kw).float(), plain(*args, **kw).float()
            torch.cuda.synchronize()
            require(bool(torch.isfinite(got).all()), f"{name} non-finite")
            err = (got - ref).abs().max().item()
            tol = SUBBLOCK_REL_TOL * ref.abs().max().item()
            mean = (got - ref).abs().mean().item()
            log(f"{name} (8, 196, {c}) bf16: max_abs_err {err:.4g} "
                f"(tol {tol:.4g}), mean_abs_err {mean:.3g}")
            require(err <= tol, f"{name} at C={c} disagrees with its plain "
                                "version")
            if c == 384:
                errs[name] = (err, tol)
    return errs


# ---------------------------------------------------------------- phase 3


def build_hub(dev, dtype):
    from eventpretrain_tpu_torch.models.cls_hub import cls_hub_vit_small

    return cls_hub_vit_small(
        NUM_CLASSES, NUM_BINS, dtype=dtype, device=dev,
        generator=torch.Generator().manual_seed(0), depth=DEPTH,
    )


def set_fused(hub, fused: bool) -> None:
    from eventpretrain_tpu_torch.models.layers import ViTBlock

    for m in hub.modules():
        if isinstance(m, ViTBlock):
            m.use_fused_layer = None if fused else False


def phase_main_path(dev, hub, infer, inputs) -> dict:
    from eventpretrain_tpu_torch.cli.serve import make_cls_infer
    from eventpretrain_tpu_torch.ops.fused_attn_layer import (
        fused_ln_attn_layer,
    )
    from eventpretrain_tpu_torch.ops.fused_mlp import fused_ln_mlp
    from eventpretrain_tpu_torch.ops.splat import splat

    wrappers = {"splat": splat, "fused_ln_attn_layer": fused_ln_attn_layer,
                "fused_ln_mlp": fused_ln_mlp}
    for w in wrappers.values():
        w.launches = 0
    logits = infer(*inputs)
    torch.cuda.synchronize()
    launches = {k: w.launches for k, w in wrappers.items()}
    log(f"main path: logits {logits.shape} {logits.dtype}, finite "
        f"{bool(np.isfinite(logits).all())}, launches {launches}")
    require(logits.shape == (inputs[0].shape[0], NUM_CLASSES), "logit shape")
    require(bool(np.isfinite(logits).all()), "non-finite logits")
    require(launches["splat"] >= 1, "splat not launched by the main path")
    require(launches["fused_ln_attn_layer"] == DEPTH,
            f"fused_ln_attn_layer launched {launches['fused_ln_attn_layer']}"
            f" times, expected {DEPTH}")
    require(launches["fused_ln_mlp"] == DEPTH,
            f"fused_ln_mlp launched {launches['fused_ln_mlp']} times, "
            f"expected {DEPTH}")

    # the same weights on the unfused plain path (bf16) and in f32
    set_fused(hub, False)
    plain = infer(*inputs)
    set_fused(hub, True)
    hub32 = build_hub(dev, torch.float32)
    hub32.load_state_dict(hub.state_dict())
    ref32 = make_cls_infer(hub32, num_bins=NUM_BINS, canvas=CANVAS)(*inputs)
    err_plain = float(np.abs(logits - plain).max())
    err_k32 = float(np.abs(logits - ref32).max())
    err_p32 = float(np.abs(plain - ref32).max())
    log(f"main path vs plain bf16 path: max_abs_err {err_plain:.4g}; vs f32: "
        f"kernels {err_k32:.4g}, plain bf16 {err_p32:.4g} "
        f"(|logits| max {np.abs(ref32).max():.4g})")
    # the kernel path must be as close to f32 as bf16 rounding allows: no
    # worse than twice the plain bf16 path's own error, plus 0.01
    require(err_k32 <= 2 * err_p32 + 1e-2,
            "kernel path drifts from the f32 model beyond bf16 rounding")
    del hub32
    return launches


# ---------------------------------------------------------------- phase 4


def _post_npz(url: str, arrays) -> np.ndarray:
    buf = io.BytesIO()
    np.savez(buf, *arrays)
    req = urllib.request.Request(url + "/predict", data=buf.getvalue(),
                                 method="POST")
    with urllib.request.urlopen(req, timeout=300) as r:
        return np.load(io.BytesIO(r.read()))


# Served and direct calls run the same code on the same inputs; only the
# order of the splat's atomic adds differs, which may move a bf16 rounding.
SERVE_ATOL = 5e-2


def phase_serving(infer, big_inputs) -> None:
    from eventpretrain_tpu_torch.cli.serve import make_server

    srv = make_server(infer, "chip_smoke", port=0)
    thread = threading.Thread(target=srv.serve_forever, daemon=True)
    thread.start()
    url = f"http://127.0.0.1:{srv.server_port}"
    try:
        with urllib.request.urlopen(url + "/healthz", timeout=60) as r:
            health = json.loads(r.read())
        require(health.get("ok") is True, f"/healthz answered {health}")
        for n in (1, 8, 64):
            arrays = tuple(a[:n] for a in big_inputs)
            got = _post_npz(url, arrays)
            want = infer(*arrays)
            err = float(np.abs(got - want).max())
            log(f"POST /predict batch {n}: {got.shape} {got.dtype}, "
                f"max_abs_err vs direct {err:.3g} (tol {SERVE_ATOL})")
            require(got.shape == want.shape and err <= SERVE_ATOL,
                    f"served batch {n} disagrees with the direct call")
    finally:
        srv.shutdown()
        srv.server_close()
        thread.join(timeout=30)
    require(not thread.is_alive(), "server thread did not stop")


# ---------------------------------------------------------------- phase 5


def phase_timing(dev, hub, infer, big_inputs, errs, launches, smi) -> None:
    from eventpretrain_tpu_torch.ops.fused_attn_layer import (
        fused_ln_attn_layer,
        fused_ln_attn_layer_reference,
    )
    from eventpretrain_tpu_torch.ops.fused_mlp import (
        fused_ln_mlp,
        fused_ln_mlp_reference,
    )
    from eventpretrain_tpu_torch.ops.splat import splat, splat_reference

    b = big_inputs[0].shape[0]
    rng = np.random.default_rng(3)
    y, x, wb = splat_args(rng, b, dev)
    hw = dict(height=CANVAS[0], width=CANVAS[1])
    gen = torch.Generator().manual_seed(4)
    a1 = k1_args(gen, b, 196, 384, dev)
    kw1 = dict(num_heads=12, scale=32 ** -0.5)
    a2 = k2_args(gen, b, 196, 384, dev)
    rows = [
        ("splat", "eventpretrain_tpu_torch/csrc/splat.cu", [],
         "eventpretrain_tpu/ops/pallas_voxel.py:227",
         lambda: splat(y, x, wb, **hw),
         lambda: splat_reference(y, x, wb, **hw)),
        ("fused_ln_attn_layer", "eventpretrain_tpu_torch/csrc/attention.cu",
         ["eventpretrain_tpu_torch/csrc/ln_gemm.cu"],
         "eventpretrain_tpu/ops/fused_attn_layer.py:471",
         lambda: fused_ln_attn_layer(*a1, **kw1),
         lambda: fused_ln_attn_layer_reference(*a1, **kw1)),
        ("fused_ln_mlp", "eventpretrain_tpu_torch/csrc/ln_gemm.cu", [],
         "eventpretrain_tpu/ops/fused_mlp.py:484",
         lambda: fused_ln_mlp(*a2), lambda: fused_ln_mlp_reference(*a2)),
    ]
    kernels = []
    for name, source, also, replaces, fn, plain in rows:
        # plain, kernel, kernel, plain: both see the same clocks
        p1, k1, k2, p2 = (cuda_ms(f) for f in (plain, fn, fn, plain))
        ms, plain_ms = min(k1, k2), min(p1, p2)
        err, tol = errs[name]
        log(f"time {name} at B={b}: kernel {ms:.4g} ms, plain {plain_ms:.4g}"
            f" ms ({smi})")
        kernels.append({
            "name": name, "route": "cuda", "source": source,
            "also": also, "replaces": replaces,
            "launches": launches[name], "max_abs_err": err, "tol": tol,
            "ms": ms, "plain_ms": plain_ms, "shape_batch": b,
        })

    # served function, raw numpy events -> numpy logits; kernel and plain
    # (unfused bf16) paths in turns: plain, kernel, kernel, plain
    runs = {True: [], False: []}
    for fused in (False, True, True, False):
        set_fused(hub, fused)
        runs[fused] += host_ms(lambda: infer(*big_inputs), reps=REPS // 2)
    set_fused(hub, True)
    e2e = {"batch": b, "reps": REPS, "card": smi}
    for fused, key in ((True, ""), (False, "plain_")):
        q1, med, q3 = statistics.quantiles(runs[fused], n=4)
        e2e.update({
            f"{key}ms": med, f"{key}ms_q1": q1, f"{key}ms_q3": q3,
            f"{key}samples_per_s": b / med * 1e3,
        })
    log(json.dumps({"e2e": e2e}))
    log(json.dumps({"kernels": kernels}))


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this script "
              "needs an NVIDIA GPU", file=sys.stderr)
        return 1
    dev = torch.device("cuda", 0)
    smi = phase_environment()
    errs = phase_kernel_parity(dev)

    from eventpretrain_tpu_torch.cli.serve import make_cls_infer

    hub = build_hub(dev, torch.bfloat16)
    infer = make_cls_infer(hub, num_bins=NUM_BINS, canvas=CANVAS)
    rng = np.random.default_rng(0)
    big_inputs = make_events(rng, 64)
    launches = phase_main_path(dev, hub, infer,
                               tuple(a[:8] for a in big_inputs))
    phase_serving(infer, big_inputs)
    phase_timing(dev, hub, infer, big_inputs, errs, launches, smi)
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
