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
   (8, 196, 768), 12 heads; the bare attention layer (K4) at (8, 196, 384)
   and (8, 196, 768), 12 heads, and the bare MLP (K5) at (8, 196, 384) and
   (8, 196, 512); their backward kernels with the same ``dy`` at K1
   (8, 49, 768) H=12, (8, 196, 512) H=16, (8, 196, 384) H=12, K2 C=768,
   512, 384, K4 C=384, 768 and K5 C=384, 512.
3. Slice 1, serving: the ViT-S/16 classification hub (2 classes, N-Cars),
   full width, random weights from seed 0, bf16 on the card, fed synthetic
   raw N-Cars-shaped events (sensor 100x120 on a 128x128 canvas, E=30000,
   B=8) through ``make_cls_infer``. Launch counts are read from this one
   run; the logits are held against the unfused plain path and an f32 run.
4. Serving: ``make_server`` on an ephemeral port, POST /predict at batch 1,
   8 and 64 plus GET /healthz, each answer against a direct call.
5. Slice 2, stage-1 rec training: ``pretrain_hub_base`` (ViT-B/16 encoder
   on the 49 kept patches, the C=512 decoder on all 196), full width, bf16
   compute with f32 parameters, random weights from seed 0, B=64 batches of
   ``SyntheticPretrainSource(size=224)`` through ``PretrainPipeline``; 10
   ``make_rec_step`` steps on the kernel path (launch counts read from this
   run) and 10 on the plain path from the same init and the same replayed
   masks, both loss curves and their gap; then ``cli.pretrain.main`` for
   one epoch (4 steps).
5b. Slice 2b, cls finetuning: ``cls_hub_vit_small`` at full width with
   drop-path 0.1, bf16, seed 0; ``SyntheticClsSource`` streams of N-Cars
   shape (30000 events, sensor 100x120) through ``ClsPipeline(train=True)``
   at B=64 with the u32 codec; 10 ``make_cls_train_step`` steps on the
   kernel path (pipeline and steps in one counted run: per step K3 1,
   K1/K2 1+1, K4 11+11, K5 0) and 10 on the plain path with the same
   batches and replayed drop-path masks; one ``make_cls_eval_step`` (K1/K2
   12 each) and one attention-map forward (K5 1, K1/K2 11 each), each
   counted on its own, its logits (and the attention weights) against the
   plain bf16 path and an f32 run;
   ``cli.finetune_cls.main`` for one epoch of ViT-S, and of ViT-B with
   ``--finetune`` from phase 5's rec checkpoint.
6. Timing (CUDA events, median of 20 after warm-up; plain, kernel, kernel,
   plain): each kernel, first held against its plain version at the main
   path's batch (B=64) as in phase 2, then timed beside it with its bound
   (and, for K4, one ``F.multi_head_attention_forward`` call); the served
   function's samples/s at B=64, the rec and cls train steps' ms,
   samples/s and peak memory on both paths, the cls pipeline's host time
   per batch; then a
   ``torch.profiler`` window over each kernel path for its device time by
   kernel and busy share.

The last line is ``{"ok": true, "device": {...}}``; the lines before it
hold the card's name and power limit, the end-to-end record and the
per-kernel JSON record.
"""

from __future__ import annotations

import copy
import io
import json
import os
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
# slice 2: pretrain_hub_base at the CLI's batch; 12 encoder + 8 decoder
# blocks, each one K1 and one K2 call forward and backward per step
TRAIN_BATCH = 64
TRAIN_INPUT = 224
TRAIN_STEPS = 10
TRAIN_BLOCKS = 12 + 8
# the card's published peaks (H100 SXM data sheet, dense): bf16 tensor
# cores and device-memory bandwidth
PEAK_FLOPS = 989e12
PEAK_BYTES = 3.35e12


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


def k4_args(gen, b, l, c, dev):
    """K1's inputs without the LayerNorm parameters."""
    a = k1_args(gen, b, l, c, dev)
    return (a[0],) + a[3:]


def k5_args(gen, b, l, c, dev):
    a = k2_args(gen, b, l, c, dev)
    return (a[0],) + a[3:]


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
# Logits of a 12-block bf16 ViT (|logits| < 1, a bf16 ulp <= 2^-8) on the
# kernel path against the plain bf16 path: each path rounds in its own
# places, and each was within 9.8e-3 of the f32 model on the H100 (ViT-S,
# B=8 and B=64), so the two may differ by about their sum, 2e-2; bound it
# at 2.5e-2.
LOGIT_ATOL = 2.5e-2
# Attention weights lie in [0, 1], where a bf16 ulp is at most 2^-8; the
# last block's weights on the two paths differ only through its input:
# bound them at two ulps at the top of the range (read: 4.9e-4).
ATTN_WEIGHT_ATOL = 2.0 ** -7
# f32 splat: atomics add in a run-dependent order; cells hold a few unit
# weights, so f32 reordering error is ~1e-6.
SPLAT_ATOL = 1e-4


def hold(name: str, shape: list, got, want, names=("y",)
         ) -> tuple[float, float, float]:
    """Require each output of a kernel (``got``: a tensor, or a tuple of
    gradients named ``names``) within ``SUBBLOCK_REL_TOL`` of its own
    scale of the plain version's output (``want``). Returns the largest
    absolute error, the largest error over its scale and the largest
    absolute tolerance."""
    if isinstance(got, torch.Tensor):
        got, want = (got,), (want,)
    require(len(got) == len(want) == len(names),
            f"{name}: {len(got)} outputs, expected {len(names)}")
    torch.cuda.synchronize()
    worst_abs = worst_rel = worst_tol = 0.0
    for g, w, gname in zip(got, want, names):
        g, w = g.float(), w.float()
        require(bool(torch.isfinite(g).all()),
                f"{name} {gname} at {shape} non-finite")
        scale = w.abs().max().item()
        err = (g - w).abs().max().item()
        rel = err / max(scale, 1e-30)
        require(rel <= SUBBLOCK_REL_TOL,
                f"{name} {gname} at {shape} off by {rel:.3g} of its scale "
                f"(tol {SUBBLOCK_REL_TOL})")
        worst_abs, worst_rel = max(worst_abs, err), max(worst_rel, rel)
        worst_tol = max(worst_tol, SUBBLOCK_REL_TOL * scale)
    log(f"{name} {shape} bf16: worst error {worst_rel:.3g} of its scale "
        f"(tol {SUBBLOCK_REL_TOL}), max_abs_err {worst_abs:.4g}")
    return worst_abs, worst_rel, worst_tol


def phase_kernel_parity(dev) -> dict:
    from eventpretrain_tpu_torch.ops.fused_attn_layer import (
        fused_attn_layer,
        fused_attn_layer_reference,
        fused_ln_attn_layer,
        fused_ln_attn_layer_reference,
    )
    from eventpretrain_tpu_torch.ops.fused_mlp import (
        fused_ln_mlp,
        fused_ln_mlp_reference,
        fused_mlp,
        fused_mlp_reference,
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
            err, _, tol = hold(name, [8, 196, c], fn(*args, **kw),
                               plain(*args, **kw))
            if c == 384:
                errs[name] = (err, tol)
    # K4 at the cls train step's widths (ViT-S, ViT-B), K5 at ViT-S and the
    # widest C its gate takes
    for name, fn, plain, make, shapes in (
            ("fused_attn_layer", fused_attn_layer, fused_attn_layer_reference,
             k4_args, ((384, 12), (768, 12))),
            ("fused_mlp", fused_mlp, fused_mlp_reference, k5_args,
             ((384, 0), (512, 0)))):
        for c, h in shapes:
            args = make(gen, 8, 196, c, dev)
            kw = dict(num_heads=h, scale=(c // h) ** -0.5) if h else {}
            err, _, tol = hold(name, [8, 196, c], fn(*args, **kw),
                               plain(*args, **kw))
            prev = errs.get(name, (0.0, 0.0))
            errs[name] = (max(prev[0], err), max(prev[1], tol))
    errs.update(phase_backward_parity(dev))
    return errs


GRAD_NAMES = ("dx", "dgamma", "dbeta", "dw_in", "db_in", "dw_out", "db_out")
BARE_GRAD_NAMES = ("dx", "dw_in", "db_in", "dw_out", "db_out")


def phase_backward_parity(dev) -> dict:
    """K1, K2, K4 and K5 backward kernels against their plain backward
    versions, bf16, the same ``dy``. Both round at the same points (do, p,
    ds, dq, dk, dv, dh_pre, dx, and every weight gradient once), but their
    f32 sums run in other orders, so a rounded value may land one bf16 ulp apart;
    the weight gradients, sums of such values over B*L tokens, move by a
    few ulps of their scale. Each gradient is bounded at 2% of its own
    scale, as the forward outputs are."""
    from eventpretrain_tpu_torch.ops.fused_attn_layer import (
        fused_attn_layer_bwd,
        fused_attn_layer_bwd_reference,
        fused_ln_attn_layer_bwd,
        fused_ln_attn_layer_bwd_reference,
    )
    from eventpretrain_tpu_torch.ops.fused_mlp import (
        fused_ln_mlp_bwd,
        fused_ln_mlp_bwd_reference,
        fused_mlp_bwd,
        fused_mlp_bwd_reference,
    )

    gen = torch.Generator().manual_seed(5)
    errs = {}
    cases = [("fused_ln_attn_layer_bwd", l, c, h)
             for l, c, h in ((49, 768, 12), (196, 512, 16), (196, 384, 12))]
    cases += [("fused_ln_mlp_bwd", 196 if c != 768 else 49, c, 0)
              for c in (768, 512, 384)]
    cases += [("fused_attn_layer_bwd", 196, c, 12) for c in (384, 768)]
    cases += [("fused_mlp_bwd", 196, c, 0) for c in (384, 512)]
    for name, l, c, h in cases:
        kw = dict(num_heads=h, scale=(c // h) ** -0.5) if h else {}
        make, fn, plain, names, nin = {
            "fused_ln_attn_layer_bwd": (
                k1_args, fused_ln_attn_layer_bwd,
                fused_ln_attn_layer_bwd_reference, GRAD_NAMES, 6),
            "fused_ln_mlp_bwd": (k2_args, fused_ln_mlp_bwd,
                                 fused_ln_mlp_bwd_reference, GRAD_NAMES, 6),
            "fused_attn_layer_bwd": (
                k4_args, fused_attn_layer_bwd,
                fused_attn_layer_bwd_reference, BARE_GRAD_NAMES, 4),
            "fused_mlp_bwd": (k5_args, fused_mlp_bwd,
                              fused_mlp_bwd_reference, BARE_GRAD_NAMES, 4),
        }[name]
        args = make(gen, 8, l, c, dev)
        dy = (torch.randn((8, l, c), generator=gen)).to(dev, torch.bfloat16)
        worst_abs, worst, _ = hold(
            name, [8, l, c] + ([h] if h else []), fn(*args, dy, **kw),
            plain(*args[:nin], dy, **kw), names)
        prev = errs.get(name, (0.0, SUBBLOCK_REL_TOL, 0.0))
        errs[name] = (max(prev[0], worst_abs), SUBBLOCK_REL_TOL,
                      max(prev[2], worst))
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


COUNTED = {}  # kernel row name -> (wrapper, counter attribute)


def counters() -> dict:
    if not COUNTED:
        from eventpretrain_tpu_torch.ops.fused_attn_layer import (
            fused_attn_layer,
            fused_ln_attn_layer,
        )
        from eventpretrain_tpu_torch.ops.fused_mlp import (
            fused_ln_mlp,
            fused_mlp,
        )
        from eventpretrain_tpu_torch.ops.splat import splat

        COUNTED.update({
            "splat": (splat, "launches"),
            "fused_ln_attn_layer": (fused_ln_attn_layer, "launches"),
            "fused_ln_attn_layer_bwd": (fused_ln_attn_layer, "launches_bwd"),
            "fused_ln_mlp": (fused_ln_mlp, "launches"),
            "fused_ln_mlp_bwd": (fused_ln_mlp, "launches_bwd"),
            "fused_attn_layer": (fused_attn_layer, "launches"),
            "fused_attn_layer_bwd": (fused_attn_layer, "launches_bwd"),
            "fused_mlp": (fused_mlp, "launches"),
            "fused_mlp_bwd": (fused_mlp, "launches_bwd"),
        })
    return COUNTED


def reset_counts() -> None:
    for fn, attr in counters().values():
        setattr(fn, attr, 0)


def read_counts() -> dict:
    return {k: getattr(fn, attr) for k, (fn, attr) in counters().items()}


def phase_main_path(dev, hub, infer, inputs) -> dict:
    from eventpretrain_tpu_torch.cli.serve import make_cls_infer

    reset_counts()
    logits = infer(*inputs)
    torch.cuda.synchronize()
    launches = read_counts()
    log(f"main path (serve): logits {logits.shape} {logits.dtype}, finite "
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
    require(launches["fused_ln_attn_layer_bwd"] == 0
            and launches["fused_ln_mlp_bwd"] == 0,
            "a backward kernel ran while serving")
    require(launches["fused_attn_layer"] == launches["fused_mlp"] == 0,
            "an unfused block's kernel ran while serving (every block fuses)")

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
    log(f"main path vs plain bf16 path: max_abs_err {err_plain:.4g} (tol "
        f"{LOGIT_ATOL}); vs f32: "
        f"kernels {err_k32:.4g}, plain bf16 {err_p32:.4g} "
        f"(|logits| max {np.abs(ref32).max():.4g})")
    require(err_plain <= LOGIT_ATOL,
            "kernel path logits disagree with the plain bf16 path")
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


def build_pretrain_hub(dev):
    from eventpretrain_tpu_torch.models.pretrain_hub import pretrain_hub_base

    return pretrain_hub_base(dtype=torch.bfloat16, device=dev,
                             generator=torch.Generator().manual_seed(0),
                             input_size=TRAIN_INPUT)


def rec_batches(dev, steps: int) -> list[dict]:
    """``steps`` B=64 batches of the synthetic source through the pipeline,
    each with an explicit random masking (replayed on both paths)."""
    from eventpretrain_tpu_torch.data.pretrain_pipeline import (
        PretrainDataConfig,
        PretrainPipeline,
        SyntheticPretrainSource,
    )
    from eventpretrain_tpu_torch.ops.masking import random_masking

    source = SyntheticPretrainSource(n=TRAIN_BATCH * steps, size=TRAIN_INPUT,
                                     seed=0)
    cfg = PretrainDataConfig(input_size=TRAIN_INPUT,
                             transfer_dtype="bfloat16")
    num_patches = (TRAIN_INPUT // 16) ** 2
    gen = torch.Generator(dev).manual_seed(0)
    batches = []
    for batch in PretrainPipeline(source, cfg, TRAIN_BATCH, seed=0,
                                  device=dev):
        ids_keep, mask, ids_restore = random_masking(
            gen, TRAIN_BATCH, num_patches, 0.75, device=dev)
        batch.update(ids_keep=ids_keep, mask=mask, ids_restore=ids_restore)
        batches.append(batch)
    return batches


def make_trainer(hub, steps_per_epoch: int):
    """The CLI's optimizer and step (cli/pretrain.py) with its defaults:
    lr 1e-3 * 64 / 256, wd 0.05, betas (0.9, 0.95); the warmup is one
    epoch of the 10 steps here, so the steps do move the weights."""
    from eventpretrain_tpu_torch.train.optim import (
        build_optimizer,
        cosine_warmup_schedule,
    )
    from eventpretrain_tpu_torch.train.state import TrainState
    from eventpretrain_tpu_torch.train.steps import make_rec_step

    schedule = cosine_warmup_schedule(1e-3 * TRAIN_BATCH / 256, 0.0, 1, 400,
                                      steps_per_epoch)
    state = TrainState(hub, build_optimizer(hub, weight_decay=0.05), schedule)
    step = make_rec_step(hub, patch_size=16, num_patches=hub.num_patches)
    return state, step


def run_steps(step, state, batches) -> list[dict]:
    metrics = [step(state, b) for b in batches]
    torch.cuda.synchronize()
    return [{k: float(v) for k, v in m.items()} for m in metrics]


# The kernel and plain paths start from the same weights and see the same
# batches and masks; both compute in bf16 but round in other places (the
# plain path's cuBLAS GEMMs and softmax round their own outputs), so the
# loss, a mean over 64 * 147 * 256 squared errors, differs by ~1e-3 at the
# first step and the gap may grow as the updates compound: bound it at 2%.
LOSS_GAP_REL = 2e-2


def phase_training(dev):
    hub = build_pretrain_hub(dev)
    plain_hub = copy.deepcopy(hub)
    set_fused(plain_hub, False)
    t0 = time.perf_counter()
    batches = rec_batches(dev, TRAIN_STEPS)
    log(f"rec batches: {len(batches)} x evg {tuple(batches[0]['evg'].shape)}"
        f" {batches[0]['evg'].dtype}, frame "
        f"{tuple(batches[0]['frame'].shape)} in "
        f"{time.perf_counter() - t0:.1f} s")
    state, step = make_trainer(hub, TRAIN_STEPS)
    pstate, pstep = make_trainer(plain_hub, TRAIN_STEPS)

    reset_counts()
    kern = run_steps(step, state, batches)
    launches = read_counts()
    plain = run_steps(pstep, pstate, batches)
    require(read_counts()["fused_ln_attn_layer"]
            == launches["fused_ln_attn_layer"],
            "the plain path launched K1")
    lk = [m["loss"] for m in kern]
    lp = [m["loss"] for m in plain]
    gap = max(abs(a - b) / abs(b) for a, b in zip(lk, lp))
    log("rec loss, kernel path: " + " ".join(f"{v:.5f}" for v in lk))
    log("rec loss, plain path:  " + " ".join(f"{v:.5f}" for v in lp))
    log("grad norm, kernel path: "
        + " ".join(f"{m['grad_norm']:.4g}" for m in kern))
    log(f"largest loss gap {gap:.3g} of the plain loss (bound "
        f"{LOSS_GAP_REL}); launches over {TRAIN_STEPS} steps {launches}")
    require(all(np.isfinite([*lk, *lp])), "non-finite rec loss")
    require(all(np.isfinite([m["grad_norm"] for m in kern])),
            "non-finite grad norm")
    require(gap <= LOSS_GAP_REL, "kernel path loss leaves the plain path's")
    for name in ("fused_ln_attn_layer", "fused_ln_attn_layer_bwd",
                 "fused_ln_mlp", "fused_ln_mlp_bwd"):
        per_step = launches[name] / TRAIN_STEPS
        require(per_step == TRAIN_BLOCKS,
                f"{name}: {per_step} launches per step, expected "
                f"{TRAIN_BLOCKS}")
    return dict(hub=hub, plain_hub=plain_hub, state=state, step=step,
                pstate=pstate, pstep=pstep, batches=batches,
                launches=launches, loss_gap=gap, losses=lk, plain_losses=lp)


def phase_cli(dev) -> None:
    from eventpretrain_tpu_torch.ckpt.bridge import load_torch_checkpoint
    from eventpretrain_tpu_torch.cli.pretrain import main as pretrain_main

    out = os.path.join("build", "chip_smoke_pretrain")
    t0 = time.perf_counter()
    state = pretrain_main([
        "--pr_phase", "rec", "--dataset", "synthetic", "--model_size",
        "base", "--batch_size", str(TRAIN_BATCH), "--epochs", "1",
        "--output_dir", out, "--print_freq", "1",
        "--input_size", str(TRAIN_INPUT), "--device", str(dev),
    ])
    sd = load_torch_checkpoint(os.path.join(out, "checkpoint.pth"))
    log(f"cli.pretrain: {state.step} steps in "
        f"{time.perf_counter() - t0:.1f} s, checkpoint of {len(sd)} tensors")
    require(state.step == 4, f"the CLI ran {state.step} steps, expected 4")
    require(set(sd) == set(state.module.state_dict()),
            "the checkpoint's keys are not the hub's")


# --------------------------------------------------------------- phase 5b
#
# slice 2b: finetune cls_hub_vit_small from raw events, drop-path 0.1 (the
# CLI's default): block 0 (rate 0) fuses into K1/K2; blocks 1-11 train with
# drop-path and take K4 for their attention, the plain MLP beside it.

CLS_STEPS = 10
CLS_DROP_PATH = 0.1
CLS_K4_BLOCKS = DEPTH - 1
# two DropPath calls per block with a rate above 0, in call order
CLS_SITE_RATES = np.repeat(np.linspace(0, CLS_DROP_PATH, DEPTH)[1:], 2)


def build_cls_train_hub(dev, dtype=torch.bfloat16):
    from eventpretrain_tpu_torch.models.cls_hub import cls_hub_vit_small

    return cls_hub_vit_small(
        NUM_CLASSES, NUM_BINS, dtype=dtype, device=dev,
        generator=torch.Generator().manual_seed(0),
        drop_path_rate=CLS_DROP_PATH,
    )


def cls_pipeline(dev, train: bool, batches: int):
    """N-Cars-shaped synthetic streams (sensor 100x120, 30000 events)
    through the cls pipeline at B=64 with the u32 codec."""
    from eventpretrain_tpu_torch.data.cls_pipeline import (
        ClsDataConfig,
        ClsPipeline,
        SyntheticClsSource,
    )

    source = SyntheticClsSource(
        num_classes=NUM_CLASSES,
        samples_per_class=TRAIN_BATCH * batches // NUM_CLASSES,
        num_events=EVENTS, sensor_hw=SENSOR_HW, seed=0 if train else 1000)
    cfg = ClsDataConfig(num_classes=NUM_CLASSES, transfer_codec="u32")
    return ClsPipeline(source, cfg, TRAIN_BATCH, train=train, seed=0,
                       device=dev)


def make_cls_trainer(hub, dev, steps_per_epoch: int):
    """The finetune CLI's optimizer and step (cli/finetune_cls.py) with its
    defaults: lr 2.5e-4 * 64 / 256, wd 0.05, betas (0.9, 0.999), clip 5,
    smoothing 0.1; the warmup is one epoch of the 10 steps here, so the
    steps do move the weights."""
    from eventpretrain_tpu_torch.train.optim import (
        build_optimizer,
        cosine_warmup_schedule,
    )
    from eventpretrain_tpu_torch.train.state import TrainState
    from eventpretrain_tpu_torch.train.steps import make_cls_train_step

    schedule = cosine_warmup_schedule(2.5e-4 * TRAIN_BATCH / 256, 1e-6, 1,
                                      100, steps_per_epoch)
    optimizer = build_optimizer(hub, weight_decay=0.05, betas=(0.9, 0.999))
    state = TrainState(hub, optimizer, schedule, clip_grad=5.0)
    step = make_cls_train_step(
        hub, smoothing=0.1, generator=torch.Generator(dev).manual_seed(0))
    return state, step


def phase_cls_training(dev):
    """10 cls train steps on the kernel path, each batch built by the
    pipeline inside the counted run (so K3 counts too), then 10 on the
    plain path from the same init with the same batches and the same
    replayed drop-path masks."""
    hub = build_cls_train_hub(dev)
    plain_hub = copy.deepcopy(hub)
    set_fused(plain_hub, False)
    state, step = make_cls_trainer(hub, dev, CLS_STEPS)
    pstate, pstep = make_cls_trainer(plain_hub, dev, CLS_STEPS)
    rng = np.random.default_rng(7)
    keep_prob = (1.0 - CLS_SITE_RATES)[:, None]
    pipe = cls_pipeline(dev, True, CLS_STEPS)

    reset_counts()
    t0 = time.perf_counter()
    batches, kern = [], []
    for batch in pipe:
        batch["drop_path_keep"] = torch.from_numpy(
            rng.random((len(CLS_SITE_RATES), TRAIN_BATCH)) < keep_prob
        ).to(dev)
        batches.append(batch)
        kern.append(step(state, batch))
    torch.cuda.synchronize()
    launches = read_counts()
    wall = time.perf_counter() - t0
    kern = [{k: float(v) for k, v in m.items()} for m in kern]
    plain = run_steps(pstep, pstate, batches)
    require(read_counts() == launches, "the plain path launched a kernel")
    host_ms = pipe.host_seconds / pipe.batches * 1e3
    log(f"cls batches: {len(batches)} x evg {tuple(batches[0]['evg'].shape)}"
        f" {batches[0]['evg'].dtype}; host build {host_ms:.1f} ms per batch "
        f"(windows, erase-and-add, packing, u32 encode); pipeline + "
        f"{CLS_STEPS} kernel-path steps {wall:.1f} s")
    lk = [m["loss"] for m in kern]
    lp = [m["loss"] for m in plain]
    gap = max(abs(a - b) / abs(b) for a, b in zip(lk, lp))
    log("cls loss, kernel path: " + " ".join(f"{v:.5f}" for v in lk))
    log("cls loss, plain path:  " + " ".join(f"{v:.5f}" for v in lp))
    log("acc1, kernel path: " + " ".join(f"{m['acc1']:.1f}" for m in kern))
    log("grad norm, kernel path: "
        + " ".join(f"{m['grad_norm']:.4g}" for m in kern))
    log(f"largest cls loss gap {gap:.3g} of the plain loss (bound "
        f"{LOSS_GAP_REL}); launches over {CLS_STEPS} steps {launches}")
    require(all(np.isfinite([*lk, *lp])), "non-finite cls loss")
    require(all(np.isfinite([m["grad_norm"] for m in kern])),
            "non-finite cls grad norm")
    require(gap <= LOSS_GAP_REL, "cls kernel path loss leaves the plain "
                                 "path's")
    per_step = {"fused_ln_attn_layer": 1, "fused_ln_attn_layer_bwd": 1,
                "fused_ln_mlp": 1, "fused_ln_mlp_bwd": 1,
                "fused_attn_layer": CLS_K4_BLOCKS,
                "fused_attn_layer_bwd": CLS_K4_BLOCKS,
                "fused_mlp": 0, "fused_mlp_bwd": 0, "splat": 1}
    for name, want in per_step.items():
        require(launches[name] == want * CLS_STEPS,
                f"{name}: {launches[name]} launches over {CLS_STEPS} cls "
                f"steps, expected {want} per step")
    return dict(hub=hub, plain_hub=plain_hub, state=state, step=step,
                pstate=pstate, pstep=pstep, batches=batches,
                launches=launches, loss_gap=gap, losses=lk, plain_losses=lp,
                host_ms=host_ms)


def phase_cls_eval(dev, cls) -> dict:
    """One ``make_cls_eval_step`` on a validation batch built by the
    pipeline, then the attention-map forward (``return_attn``) of the
    trained hub on the first train batch; each run counted on its own.
    Returns ``{path: launches}``."""
    from eventpretrain_tpu_torch.train.steps import make_cls_eval_step

    hub = cls["hub"]
    reset_counts()
    val = next(iter(cls_pipeline(dev, False, 1)))
    metrics = {k: float(v) for k, v in make_cls_eval_step(hub)(val).items()}
    torch.cuda.synchronize()
    ev = read_counts()
    log(f"cls eval step B={TRAIN_BATCH}: {metrics}; launches {ev}")
    require(all(np.isfinite(list(metrics.values()))), "non-finite eval")
    require(metrics["_n"] == TRAIN_BATCH, "eval weighed pads")
    for name, want in (("splat", 1), ("fused_ln_attn_layer", DEPTH),
                       ("fused_ln_mlp", DEPTH)):
        require(ev[name] == want, f"eval: {name} launched {ev[name]} times, "
                                  f"expected {want}")
    require(sum(ev.values()) == 1 + 2 * DEPTH, "eval launched another kernel")

    evg = cls["batches"][0]["evg"]
    reset_counts()
    hub.eval()
    with torch.no_grad():
        _, logits, attn = hub(evg, return_attn=True)
    torch.cuda.synchronize()
    am = read_counts()
    log(f"attention-map forward B={TRAIN_BATCH}: logits "
        f"{tuple(logits.shape)}, attn {tuple(attn.shape)} {attn.dtype}; "
        f"launches {am}")
    require(attn.shape == (TRAIN_BATCH, 12, 196, 196), "attention shape")
    for name, want in (("fused_mlp", 1), ("fused_ln_attn_layer", DEPTH - 1),
                       ("fused_ln_mlp", DEPTH - 1)):
        require(am[name] == want, f"attention map: {name} launched "
                                  f"{am[name]} times, expected {want}")
    require(sum(am.values()) == 1 + 2 * (DEPTH - 1),
            "the attention-map forward launched another kernel")
    # the same weights on the plain bf16 path and in f32
    plain_hub = copy.deepcopy(hub)
    set_fused(plain_hub, False)
    hub32 = build_cls_train_hub(dev, torch.float32)
    hub32.load_state_dict(hub.state_dict())
    with torch.no_grad():
        _, plain, pattn = plain_hub.eval()(evg, return_attn=True)
        _, ref32, _ = hub32.eval()(evg, return_attn=True)
    err_plain = (logits.float() - plain.float()).abs().max().item()
    err_k32 = (logits.float() - ref32).abs().max().item()
    err_p32 = (plain.float() - ref32).abs().max().item()
    attn_err = (attn.float() - pattn.float()).abs().max().item()
    log(f"attention-map logits vs plain bf16 path: max_abs_err "
        f"{err_plain:.4g} (tol {LOGIT_ATOL}); vs f32: kernels {err_k32:.4g}, "
        f"plain bf16 {err_p32:.4g} (|logits| max "
        f"{ref32.abs().max().item():.4g}); attention weights vs plain bf16: "
        f"max_abs_err {attn_err:.3g} (tol {ATTN_WEIGHT_ATOL})")
    require(err_plain <= LOGIT_ATOL,
            "attention-map logits disagree with the plain bf16 path")
    require(attn_err <= ATTN_WEIGHT_ATOL,
            "attention weights disagree with the plain bf16 path")
    require(err_k32 <= 2 * err_p32 + 1e-2,
            "attention-map logits drift from the f32 model beyond bf16 "
            "rounding")
    del plain_hub, hub32
    return {"cls_eval": ev, "cls_attn_map": am}


def phase_finetune_cli(dev) -> None:
    """``cli.finetune_cls.main`` for one epoch of the synthetic source
    (ViT-S), then ViT-B initialised with ``--finetune`` from the rec
    checkpoint phase 5's ``cli.pretrain`` run wrote (a strict backbone
    load)."""
    from eventpretrain_tpu_torch.ckpt.bridge import load_torch_checkpoint
    from eventpretrain_tpu_torch.cli.finetune_cls import main as finetune

    rec_ckpt = os.path.join("build", "chip_smoke_pretrain", "checkpoint.pth")
    for size, extra in (("small", []), ("base", ["--finetune", rec_ckpt])):
        out = os.path.join("build", f"chip_smoke_finetune_{size}")
        t0 = time.perf_counter()
        reset_counts()
        res = finetune([
            "--dataset", "synthetic", "--model_size", size, "--batch_size",
            str(TRAIN_BATCH), "--epochs", "1", "--output_dir", out,
            "--print_freq", "1", "--device", str(dev), *extra,
        ])
        launches = read_counts()
        state = res["state"]
        log(f"cli.finetune_cls --model_size {size} {' '.join(extra)}: "
            f"{state.step} steps, val {res['val']} in "
            f"{time.perf_counter() - t0:.1f} s; launches {launches}")
        require(state.step == 2, f"the CLI ran {state.step} steps, "
                                 "expected 2")
        require(np.isfinite(res["val"]["loss"]), "non-finite val loss")
        require(launches["fused_attn_layer_bwd"] == 2 * CLS_K4_BLOCKS,
                "the CLI's train steps did not take K4")
        sd = load_torch_checkpoint(os.path.join(out, "checkpoint.pth"))
        require(set(sd) == set(state.module.state_dict()),
                "the checkpoint's keys are not the hub's")
        if extra:
            rec = load_torch_checkpoint(rec_ckpt)
            require(set(k for k in rec if k.startswith("backbone."))
                    == set(k for k in sd if k.startswith("backbone.")),
                    "the finetuned backbone's keys are not the rec one's")


# ---------------------------------------------------------------- phase 6


def bound(flops: float, nbytes: float) -> tuple[float, str]:
    """The least time (ms) the card could take: the larger of operations
    over the bf16 tensor-core peak and bytes over the memory rate."""
    t_ops, t_bytes = flops / PEAK_FLOPS, nbytes / PEAK_BYTES
    return max(t_ops, t_bytes) * 1e3, (
        "operations" if t_ops >= t_bytes else "bytes")


def k1_work(b, l, c, h, backward=False, ln=True) -> tuple[float, float]:
    """(FLOPs, bytes) of K1 (``ln``) or K4 on these shapes. Forward: qkv,
    per-head q.k and p.v, out projection; x in, y out, weights in.
    Backward: dWo, do, the attention backward (s recomputed, dp, dv, dq,
    dk), dWqkv, du; x, dy, the saved qkv and o in, dx and every gradient
    out."""
    m, d = b * l, c // h
    weights = (4 * c * c + 4 * c) * 2 + (2 * c * 4 if ln else 0)
    if not backward:
        return (2 * m * c * 4 * c + 4 * b * h * l * l * d,
                2 * m * c * 2 + weights)
    return (2 * m * c * 8 * c + 10 * b * h * l * l * d,
            (2 + 4 + 1) * m * c * 2 + 2 * weights)


def k2_work(b, l, c, backward=False, ln=True) -> tuple[float, float]:
    """(FLOPs, bytes) of K2 (``ln``) or K5. Forward: fc1 and fc2.
    Backward: the h_pre recompute, dW2, dh, dW1, du; x, dy in, dx and
    every gradient out."""
    m = b * l
    weights = (8 * c * c + 5 * c) * 2 + (2 * c * 4 if ln else 0)
    if not backward:
        return 2 * m * c * 8 * c, 2 * m * c * 2 + weights
    return 2 * m * c * 20 * c, 3 * m * c * 2 + 2 * weights


def device_profile(fn, calls: int) -> dict:
    """``calls`` calls of ``fn`` under ``torch.profiler``: device time per
    kernel (the 10 largest), device time and host-clock wall time per call,
    and the device's busy share of the wall time (kernels and copies run on
    one stream, so their times add; the profiler's own host cost lengthens
    the wall time, so the share is a lower bound)."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3
    per: dict[str, float] = {}
    for e in prof.key_averages():
        # device work only: user-annotated ranges (Optimizer.step#..., with
        # a '#' where the flag is missing) carry the device time of the
        # kernels inside them, which are counted on their own
        if (e.device_type != torch.autograd.DeviceType.CUDA
                or getattr(e, "is_user_annotation", False) or "#" in e.key):
            continue
        us = getattr(e, "self_device_time_total", None)
        if us is None:
            us = e.self_cuda_time_total
        per[e.key] = per.get(e.key, 0.0) + us / 1e3
    busy = sum(per.values())
    top = sorted(per.items(), key=lambda kv: -kv[1])[:10]
    return {"calls": calls, "wall_ms": wall / calls,
            "device_ms": busy / calls,
            "busy_share": busy / wall if busy else None,
            "top_ms": [[k[:90], v / calls] for k, v in top]}


def log_profile(what: str, prof: dict) -> None:
    if prof["busy_share"] is None:
        log(f"profile {what}: the profiler recorded no device time")
        return
    log(f"profile {what}: {prof['device_ms']:.4g} ms of device time in "
        f"{prof['wall_ms']:.4g} ms per call (busy {prof['busy_share']:.1%})")
    for name, ms in prof["top_ms"]:
        log(f"  {ms:9.4f} ms  {name}")


def time_pair(fn, plain) -> tuple[float, float]:
    """plain, kernel, kernel, plain: both see the same clocks."""
    p1, k1, k2, p2 = (cuda_ms(f) for f in (plain, fn, fn, plain))
    return min(k1, k2), min(p1, p2)


def timed_steps(paths: dict, batches: list) -> tuple[dict, dict]:
    """Host-clock ms of ``step(state, batch)`` calls on each path in turns
    (plain, kernel, kernel, plain), each call a real update of its own
    path's state; and the peak device memory a step adds above what is
    resident, in GiB."""
    runs = {True: [], False: []}
    peak = {}
    for fused in (False, True, True, False):
        step, state = paths[fused]
        torch.cuda.synchronize()
        base = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        calls = [0]

        def one_step():
            calls[0] += 1
            return step(state, batches[calls[0] % len(batches)])

        runs[fused] += host_ms(one_step, reps=REPS // 2, warmup=2)
        peak[fused] = max(peak.get(fused, 0.0),
                          (torch.cuda.max_memory_allocated() - base) / 2**30)
    return runs, peak


def step_record(runs: dict, peak: dict, batch: int) -> dict:
    out = {}
    for fused, key in ((True, ""), (False, "plain_")):
        q1, med, q3 = statistics.quantiles(runs[fused], n=4)
        out.update({
            f"{key}step_ms": med, f"{key}step_ms_q1": q1,
            f"{key}step_ms_q3": q3,
            f"{key}samples_per_s": batch / med * 1e3,
            f"{key}peak_step_gib": peak[fused],
        })
    return out


def phase_timing(dev, hub, infer, big_inputs, errs, launches, train, cls,
                 smi) -> None:
    import torch.nn.functional as F

    from eventpretrain_tpu_torch.ops import fused_attn_layer as ka
    from eventpretrain_tpu_torch.ops import fused_mlp as km
    from eventpretrain_tpu_torch.ops.splat import splat, splat_reference

    b = big_inputs[0].shape[0]
    rng = np.random.default_rng(3)
    y, x, wb = splat_args(rng, b, dev)
    hw = dict(height=CANVAS[0], width=CANVAS[1])
    gen = torch.Generator().manual_seed(4)

    def k1_case(l, c, h, backward):
        a = k1_args(gen, b, l, c, dev)
        kw = dict(num_heads=h, scale=(c // h) ** -0.5)
        if not backward:
            return (lambda: ka.fused_ln_attn_layer(*a, **kw),
                    lambda: ka.fused_ln_attn_layer_reference(*a, **kw))
        dy = torch.randn((b, l, c), generator=gen).to(dev, torch.bfloat16)
        x_, g_, be_, wqkv, bqkv, wo, bo = a
        with torch.no_grad():
            _, qkv, o = ka._layer_cuda(x_, wqkv, bqkv, wo, bo, h,
                                       kw["scale"], ln=(g_, be_, 1e-6))
        return (lambda: ka._ln_backward_cuda(x_, g_, be_, wqkv, wo, qkv, o,
                                             dy, h, kw["scale"], 1e-6),
                lambda: ka.fused_ln_attn_layer_bwd_reference(*a[:6], dy,
                                                             **kw))

    def k4_case(l, c, h, backward):
        a = k4_args(gen, b, l, c, dev)
        kw = dict(num_heads=h, scale=(c // h) ** -0.5)
        if not backward:
            return (lambda: ka.fused_attn_layer(*a, **kw),
                    lambda: ka.fused_attn_layer_reference(*a, **kw))
        dy = torch.randn((b, l, c), generator=gen).to(dev, torch.bfloat16)
        x_, wqkv, bqkv, wo, bo = a
        with torch.no_grad():
            _, qkv, o = ka._layer_cuda(x_, wqkv, bqkv, wo, bo, h,
                                       kw["scale"])
        return (lambda: ka._backward_cuda(x_, wqkv, wo, qkv, o, dy, h,
                                          kw["scale"]),
                lambda: ka.fused_attn_layer_bwd_reference(*a[:4], dy, **kw))

    def k2_case(l, c, backward):
        a = k2_args(gen, b, l, c, dev)
        if not backward:
            return (lambda: km.fused_ln_mlp(*a),
                    lambda: km.fused_ln_mlp_reference(*a))
        dy = torch.randn((b, l, c), generator=gen).to(dev, torch.bfloat16)
        return (lambda: km._ln_backward_cuda(*a[:6], dy, 1e-6),
                lambda: km.fused_ln_mlp_bwd_reference(*a[:6], dy))

    def k5_case(l, c, backward):
        a = k5_args(gen, b, l, c, dev)
        if not backward:
            return (lambda: km.fused_mlp(*a),
                    lambda: km.fused_mlp_reference(*a))
        dy = torch.randn((b, l, c), generator=gen).to(dev, torch.bfloat16)
        return (lambda: km._backward_cuda(*a[:4], dy),
                lambda: km.fused_mlp_bwd_reference(*a[:4], dy))

    def sdpa(l, c, h, backward):
        q, kk, v = (torch.randn((b, h, l, c // h), generator=gen).to(
            dev, torch.bfloat16) for _ in range(3))
        if not backward:
            return cuda_ms(lambda: F.scaled_dot_product_attention(q, kk, v))
        q, kk, v = (t.requires_grad_() for t in (q, kk, v))
        out = F.scaled_dot_product_attention(q, kk, v)
        do = torch.randn_like(out)
        return cuda_ms(lambda: torch.autograd.grad(out, (q, kk, v), do,
                                                   retain_graph=True))

    def mha(l, c, h, backward):
        """K4's function as one PyTorch call: multi_head_attention_forward
        (packed in-projection, attention, out-projection) on the same
        bf16 operands, tokens (L, B, C)."""
        xx, wqkv, bqkv, wo, bo = (t.detach().requires_grad_(backward)
                                  for t in k4_args(gen, b, l, c, dev))
        xt = xx.detach().transpose(0, 1).contiguous().requires_grad_(
            backward)

        def call():
            return F.multi_head_attention_forward(
                xt, xt, xt, c, h, wqkv, bqkv, None, None, False, 0.0, wo,
                bo, training=False, need_weights=False)[0]

        if not backward:
            return cuda_ms(call)
        out = call()
        do = torch.randn_like(out)
        leaves = (xt, wqkv, bqkv, wo, bo)
        return cuda_ms(lambda: torch.autograd.grad(out, leaves, do,
                                                   retain_graph=True))

    # (name, source, also, replaces, shapes, backward, case, work, library):
    # the first shape is the row's; the others follow in "shapes". K1/K2
    # forward keep slice 1's shape (ViT-S, L=196, C=384) and add the rec
    # path's two; their backward rows are the rec path's decoder and
    # encoder blocks. K4 runs in the cls train step (ViT-S, and ViT-B for
    # the CLI's --finetune run), K5 in the attention-map forward (ViT-S)
    # and up to the widest C of its gate.
    csrc = "eventpretrain_tpu_torch/csrc/"
    attn = [csrc + "ln_gemm.cu"]
    attn_bwd = [csrc + "ln_gemm.cu", csrc + "ln_bwd.cu", csrc + "attention.cu"]
    rows = [
        ("fused_ln_attn_layer", csrc + "attention.cu", attn,
         "eventpretrain_tpu/ops/fused_attn_layer.py:357",
         [(196, 384, 12), (49, 768, 12), (196, 512, 16)], False, k1_case,
         k1_work, None),
        ("fused_ln_attn_layer_bwd", csrc + "attention_bwd.cu", attn_bwd,
         "eventpretrain_tpu/ops/fused_attn_layer.py:386",
         [(196, 512, 16), (49, 768, 12)], True, k1_case, k1_work, None),
        ("fused_ln_mlp", csrc + "ln_gemm.cu", [],
         "eventpretrain_tpu/ops/fused_mlp.py:329",
         [(196, 384, 0), (49, 768, 0), (196, 512, 0)], False, k2_case,
         k2_work, None),
        ("fused_ln_mlp_bwd", csrc + "ln_gemm.cu", [csrc + "ln_bwd.cu"],
         "eventpretrain_tpu/ops/fused_mlp.py:356 (C<=512), :416 (C=768)",
         [(196, 512, 0), (49, 768, 0)], True, k2_case, k2_work, None),
        ("fused_attn_layer", csrc + "attention.cu", attn,
         "eventpretrain_tpu/ops/fused_attn_layer.py:202",
         [(196, 384, 12), (196, 768, 12)], False, k4_case, k1_work, mha),
        ("fused_attn_layer_bwd", csrc + "attention_bwd.cu", attn_bwd,
         "eventpretrain_tpu/ops/fused_attn_layer.py:220",
         [(196, 384, 12), (196, 768, 12)], True, k4_case, k1_work, mha),
        ("fused_mlp", csrc + "ln_gemm.cu", [],
         "eventpretrain_tpu/ops/fused_mlp.py:152",
         [(196, 384, 0), (196, 512, 0)], False, k5_case, k2_work, None),
        ("fused_mlp_bwd", csrc + "ln_gemm.cu", [csrc + "ln_bwd.cu"],
         "eventpretrain_tpu/ops/fused_mlp.py:173",
         [(196, 384, 0), (196, 512, 0)], True, k5_case, k2_work, None),
    ]
    total = {k: sum(launches[p].get(k, 0) for p in launches)
             for k in counters()}
    kernels = []
    # the library call: index_put_(accumulate=True) alone, on the in-frame
    # cells and weights splat_reference computes first
    ok = (y >= 0) & (y < CANVAS[0]) & (x >= 0) & (x < CANVAS[1])
    cell = ((torch.arange(b, device=dev)[:, None] * CANVAS[0] + y.long())
            * CANVAS[1] + x.long())[ok]
    vals = wb.transpose(1, 2)[ok].float()
    acc = torch.zeros((b * CANVAS[0] * CANVAS[1], NUM_BINS), device=dev)
    ms, plain_ms = time_pair(lambda: splat(y, x, wb, **hw),
                             lambda: splat_reference(y, x, wb, **hw))
    lib_ms = cuda_ms(lambda: acc.index_put_((cell,), vals, accumulate=True))
    nbytes = (y.numel() + x.numel()) * 4 + wb.numel() * 4 + acc.numel() * 4
    bms, bby = bound(wb.numel(), nbytes)
    err, tol = errs["splat"]
    kernels.append({
        "name": "splat", "route": "cuda", "source": csrc + "splat.cu",
        "also": [], "replaces": "eventpretrain_tpu/ops/pallas_voxel.py:227",
        "launches": total["splat"],
        "launches_by_path": {p: launches[p]["splat"] for p in launches},
        "max_abs_err": err, "tol": tol, "ms": ms, "plain_ms": plain_ms,
        "bound_ms": bms, "bound_by": bby, "library_ms": lib_ms,
        "library": "index_put_(accumulate=True)",
        "shape": [b, NUM_BINS, EVENTS], "flops": wb.numel(),
        "bytes": nbytes,
    })
    log(f"time splat B={b}: kernel {ms:.4g} ms, plain {plain_ms:.4g} ms, "
        f"index_put_ {lib_ms:.4g} ms, bound {bms:.4g} ms ({bby}) ({smi})")
    for (name, source, also, replaces, shapes, backward, case, work,
         library) in rows:
        ln = name.startswith("fused_ln")
        names = ((GRAD_NAMES if ln else BARE_GRAD_NAMES) if backward
                 else ("y",))
        per_shape = []
        for l, c, h in shapes:
            fn, plain = (case(l, c, h, backward) if h
                         else case(l, c, backward))
            # held at the main path's batch before it is timed
            shape = [b, l, c] + ([h] if h else [])
            err, rel, tol = hold(name, shape, fn(), plain(), names)
            prev = errs[name]
            errs[name] = ((max(prev[0], err), SUBBLOCK_REL_TOL,
                           max(prev[2], rel)) if backward
                          else (max(prev[0], err), max(prev[1], tol)))
            ms, plain_ms = time_pair(fn, plain)
            flops, nbytes = (work(b, l, c, h, backward, ln) if h
                             else work(b, l, c, backward, ln))
            bms, bby = bound(flops, nbytes)
            entry = {"shape": shape, "max_abs_err": err, "max_rel_err": rel,
                     "ms": ms,
                     "plain_ms": plain_ms, "bound_ms": bms, "bound_by": bby,
                     "flops": flops, "bytes": nbytes,
                     "library_ms": (library(l, c, h, backward)
                                    if library else None)}
            if h:
                entry["sdpa_ms"] = sdpa(l, c, h, backward)
            per_shape.append(entry)
            del fn, plain
            log(f"time {name} {entry['shape']}: kernel {ms:.4g} ms, plain "
                f"{plain_ms:.4g} ms, bound {bms:.4g} ms ({bby})"
                + (f", mha {entry['library_ms']:.4g} ms" if library else "")
                + (f", sdpa {entry['sdpa_ms']:.4g} ms" if h else "")
                + f" ({smi})")
        err, tol = errs[name][:2]
        head = per_shape[0]
        kernels.append({
            "name": name, "route": "cuda", "source": source, "also": also,
            "replaces": replaces, "launches": total[name],
            "launches_by_path": {p: launches[p][name] for p in launches},
            "max_abs_err": err, "tol": tol,
            **({"max_rel_err": errs[name][2],
                "tol_is": "max_rel_err, of each gradient's scale"}
               if backward else {}),
            "ms": head["ms"],
            "plain_ms": head["plain_ms"], "bound_ms": head["bound_ms"],
            "bound_by": head["bound_by"], "library_ms": head["library_ms"],
            **({"library": "F.multi_head_attention_forward"
                + (" + autograd.grad" if backward else "")}
               if library else {}),
            "shape": head["shape"], "flops": head["flops"],
            "bytes": head["bytes"], "shapes": per_shape[1:],
        })

    # served function, raw numpy events -> numpy logits; kernel and plain
    # (unfused bf16) paths in turns: plain, kernel, kernel, plain
    runs = {True: [], False: []}
    for fused in (False, True, True, False):
        set_fused(hub, fused)
        runs[fused] += host_ms(lambda: infer(*big_inputs), reps=REPS // 2)
    set_fused(hub, True)
    e2e = {"serve": {"batch": b, "reps": REPS, "card": smi}}
    for fused, key in ((True, ""), (False, "plain_")):
        q1, med, q3 = statistics.quantiles(runs[fused], n=4)
        e2e["serve"].update({
            f"{key}ms": med, f"{key}ms_q1": q1, f"{key}ms_q3": q3,
            f"{key}samples_per_s": b / med * 1e3,
        })

    # the rec and cls train steps, B=64, host clock around synchronised
    # steps, each on both paths in turns
    for key, run, model in (("rec_train", train, "pretrain_hub_base"),
                            ("cls_train", cls, "cls_hub_vit_small")):
        paths = {True: (run["step"], run["state"]),
                 False: (run["pstep"], run["pstate"])}
        step_runs, peak = timed_steps(paths, run["batches"])
        e2e[key] = {"model": model, "batch": TRAIN_BATCH, "reps": REPS,
                    "card": smi, "loss_gap": run["loss_gap"],
                    "resident_gib": torch.cuda.memory_allocated() / 2**30,
                    **step_record(step_runs, peak, TRAIN_BATCH)}
        log(f"{key} step B={TRAIN_BATCH}: kernel "
            f"{e2e[key]['step_ms']:.4g} ms, plain "
            f"{e2e[key]['plain_step_ms']:.4g} ms ({smi})")
    e2e["cls_train"]["host_batch_ms"] = cls["host_ms"]
    e2e["cls_train"]["drop_path_rate"] = CLS_DROP_PATH

    # where the time goes, every main path on the kernel path
    e2e["serve"]["profile"] = device_profile(lambda: infer(*big_inputs), 5)
    log_profile("serve B=64", e2e["serve"]["profile"])
    for key, run, calls in (("rec_train", train, 3), ("cls_train", cls, 5)):
        step, state = run["step"], run["state"]
        batch = run["batches"][0]
        e2e[key]["profile"] = device_profile(lambda: step(state, batch),
                                             calls)
        log_profile(f"{key} step B={TRAIN_BATCH}", e2e[key]["profile"])
    log(smi)
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
    launches = {"serve": phase_main_path(dev, hub, infer,
                                         tuple(a[:8] for a in big_inputs))}
    phase_serving(infer, big_inputs)
    train = phase_training(dev)
    launches["rec_train"] = train["launches"]
    phase_cli(dev)
    cls = phase_cls_training(dev)
    launches["cls_train"] = cls["launches"]
    launches.update(phase_cls_eval(dev, cls))
    phase_finetune_cli(dev)
    phase_timing(dev, hub, infer, big_inputs, errs, launches, train, cls,
                 smi)
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
