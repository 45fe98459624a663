"""Time K8, the per-event scatter voxelizer (``csrc/voxel_scatter.cu``), of
this checkout against another checkout's, in turns on one card.

    git archive <commit> eventpretrain_tpu_torch/csrc | tar -x -C build/base
    python3 -m eventpretrain_tpu_torch.tools.compare_scatter \\
        --baseline build/base/eventpretrain_tpu_torch/csrc

The baseline's ``voxel_scatter.cu`` is built with this checkout's ``nvcc``
flags into ``build/baseline_kernels/`` (beside a second build of this
checkout's, for ptxas's registers and spills of both) and called through
its C entry point ``voxel_scatter_f32(events, counts, out, B, E, H, W,
bins, chunk, stream)`` into a grid zeroed by ``torch.zeros``, as its
wrapper did.

Two shapes: DSEC's (B=16, 200000 events, 440x640x5: the batch of grids is
90 MB, almost twice the L2) and N-Cars' (B=64, 30000 events, 128x128x5: 21
MB). Events as ``chip_smoke.py`` makes them: fractional coordinates from 2
before to 2 past the sensor, sorted t, polarity in {0, 1}, ragged counts
with a 0 and a 1. Both builds are held against the plain version
(``voxelize_batch_scatter_reference``) within ``SPLAT_ATOL``. Times: CUDA
events around one call, the median of ``--reps`` event pairs after
warm-up, in the order baseline, this checkout, this checkout, baseline
(the one-call time carries the wrapper's host work, and the baseline's
fill); and the same from CUDA graphs of 10 calls, which time the card
alone. Beside them: the baseline's fill alone (``torch.zeros`` of the
grid) and its scatter alone, graph-timed; the bound (the events below the
counts read once, 16 bytes each, the counts, the grids written once, over
3.35 TB/s); this build's plan and resident CTAs. ``--variants`` adds,
each held against the plain version and graph-timed in turns: other
``chunk`` sizes, other look-aheads (0, one more, the whole batch: no L2
budget), as many CTAs as the card holds, and the alternative design,
waves of D + 1 samples as launch pairs (a ``zero_`` of the wave's grids,
then the baseline's scatter of its samples). Prints one line per row and
a last JSON line with the card's name and power limit.
"""

from __future__ import annotations

import argparse
import ctypes
import dataclasses
import json
import subprocess
from pathlib import Path

import numpy as np
import torch

from eventpretrain_tpu_torch import _build
from eventpretrain_tpu_torch.ops import splat as k8
from eventpretrain_tpu_torch.tools.compare_attention import compare
from eventpretrain_tpu_torch.tools.compare_gemm import graph_ms
from eventpretrain_tpu_torch.tools.compare_splat import (
    PEAK_BYTES,
    SPLAT_ATOL,
)

OUT_DIR = _build.BUILD_DIR.parent / "baseline_kernels"
NUM_BINS = 5
SHAPES = ((16, 200_000, (440, 640)),  # DSEC, the K8 path's batch
          (64, 30_000, (128, 128)))   # N-Cars' canvas, the cls batch
BASELINE_CHUNK = 512  # the baseline wrapper's default
_P, _I = ctypes.c_void_p, ctypes.c_int


def build_baseline(csrc: Path) -> tuple[ctypes.CDLL, dict, dict]:
    """Compile the baseline's voxel_scatter.cu, and this checkout's again
    beside it for its ptxas report: the baseline's library and ptxas's
    report of each kernel of both."""
    OUT_DIR.mkdir(parents=True, exist_ok=True)
    procs = {who: subprocess.Popen(
        [_build.nvcc_path(), *_build.NVCC_FLAGS, "-o",
         str(OUT_DIR / f"libvoxel_scatter_{who}.so"),
         str(src / "voxel_scatter.cu")],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        for who, src in (("baseline", csrc), ("now", _build.CSRC))}
    usage = {}
    for who, proc in procs.items():
        log = proc.communicate()[0]
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed for {who} voxel_scatter\n{log}")
        usage[who] = _build.ptxas_usage("voxel_scatter", log)
    lib = ctypes.CDLL(str(OUT_DIR / "libvoxel_scatter_baseline.so"))
    lib.voxel_scatter_f32.argtypes = [_P, _P, _P, *[_I] * 6, _P]
    lib.voxel_scatter_f32.restype = ctypes.c_int
    lib.kernel_error_string.argtypes = [ctypes.c_int]
    lib.kernel_error_string.restype = ctypes.c_char_p
    return lib, usage["baseline"], usage["now"]


def baseline_scatter(lib, events, counts, out, *, num_bins, height,
                     width) -> torch.Tensor:
    """The baseline's kernel adding ``events`` into ``out`` as it is."""
    b, e, _ = events.shape
    code = lib.voxel_scatter_f32(
        events.data_ptr(), counts.data_ptr(), out.data_ptr(), b, e, height,
        width, num_bins, BASELINE_CHUNK,
        torch.cuda.current_stream(events.device).cuda_stream)
    _build.check(lib, "baseline voxel_scatter_f32", code)
    return out


def scatter_inputs(rng, batch: int, capacity: int, hw, dev):
    """``chip_smoke.py``'s K8 events on the card, and int32 counts."""
    h, w = hw
    ev = np.empty((batch, capacity, 4), np.float32)
    ev[..., 0] = rng.uniform(-2.0, w + 2.0, (batch, capacity))
    ev[..., 1] = rng.uniform(-2.0, h + 2.0, (batch, capacity))
    ev[..., 2] = np.sort(rng.uniform(0.0, 0.1, (batch, capacity)), axis=1)
    ev[..., 3] = rng.integers(0, 2, (batch, capacity))
    counts = rng.integers(capacity // 2, capacity + 1, batch).astype(np.int32)
    counts[0] = capacity
    counts[1], counts[2] = 0, 1
    return torch.from_numpy(ev).to(dev), torch.from_numpy(counts).to(dev)


def plan_variants(plan: k8.ScatterPlan, events: int, resident: int) -> dict:
    """This checkout's plans to time beside the default: other chunks,
    look-ahead 0, one more and the whole batch, and as many CTAs as the card
    holds (``resident``)."""
    out = {}
    for chunk in (1024, 4096):
        if chunk != plan.chunk:
            out[f"chunk{chunk}"] = dataclasses.replace(
                plan, chunk=chunk, add_items=-(-events // chunk))
    for d in sorted({0, min(plan.batch, plan.lookahead + 1), plan.batch}):
        if d != plan.lookahead:
            out[f"lookahead{d}"] = dataclasses.replace(plan, lookahead=d)
    if resident != plan.ctas:
        out[f"ctas{resident}"] = dataclasses.replace(plan, ctas=resident)
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--baseline", type=Path, required=True,
                    help="the other checkout's eventpretrain_tpu_torch/csrc")
    ap.add_argument("--reps", type=int, default=20)
    ap.add_argument("--variants", action="store_true",
                    help="also time other plans and the wave design")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("compare_scatter: no CUDA device")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip()
    print(f"nvidia-smi: {smi}", flush=True)
    _build.build(("voxel_scatter",))
    lib, base_usage, usage = build_baseline(args.baseline.resolve())
    for kernel in sorted(set(usage) | set(base_usage)):
        print(f"ptxas {kernel}: " + "; ".join(
            f"{who} {u[kernel]['registers']} registers, "
            f"{u[kernel]['spill_stores']} B spill stores"
            for who, u in (("baseline", base_usage), ("now", usage))
            if kernel in u), flush=True)
    dev = torch.device("cuda", 0)
    l2_bytes, sms, per_sm = k8.voxel_scatter_device(0)
    resident = sms * per_sm
    print(f"L2 {l2_bytes} B; {sms} SMs, {per_sm} CTAs of K8 an SM resident "
          f"at once", flush=True)
    rng = np.random.default_rng(41)
    rows, failed = [], []
    for batch, events, hw in SHAPES:
        ev, counts = scatter_inputs(rng, batch, events, hw, dev)
        kw = dict(num_bins=NUM_BINS, height=hw[0], width=hw[1])
        shape = [batch, events, *hw, NUM_BINS]
        grid = (batch, *hw, NUM_BINS)
        plan = k8.voxel_scatter_plan(batch, *hw, NUM_BINS, events,
                                     chunk=k8.SCATTER_CHUNK,
                                     l2_bytes=l2_bytes, sms=sms)
        want = k8.voxelize_batch_scatter_reference(ev, counts, **kw)

        def theirs():
            out = torch.zeros(grid, dtype=torch.float32, device=dev)
            return baseline_scatter(lib, ev, counts, out, **kw)

        def mine():
            return k8.voxelize_batch_scatter(ev, counts, **kw)

        def held(what, fn):
            """``fn`` into a grid of NaN, against the plain version."""
            got = fn(torch.full(grid, float("nan"), device=dev))
            err = (got - want).abs().max().item()
            if not err <= SPLAT_ATOL:
                failed.append(f"{what} {shape}: max_abs_err {err:.3g}")
            return err

        errs = [held("baseline", lambda out: baseline_scatter(
                    lib, ev, counts, out.zero_(), **kw)),
                held("now", lambda out: k8._voxel_scatter_into(
                    ev, counts, out, **kw))]
        times = compare(theirs, mine, 1, args.reps)
        b1, m1, m2, b2 = (graph_ms(f, reps=args.reps)
                          for f in (theirs, mine, mine, theirs))
        acc = torch.zeros(grid, dtype=torch.float32, device=dev)
        fill_ms = graph_ms(lambda: torch.zeros(grid, dtype=torch.float32,
                                               device=dev), reps=args.reps)
        scatter_ms = graph_ms(lambda: baseline_scatter(lib, ev, counts, acc,
                                                       **kw), reps=args.reps)
        del acc
        read = int(counts.clamp(max=events).sum())
        nbytes = 16 * read + 4 * batch + 4 * int(np.prod(grid))
        times.update(device_ms=min(m1, m2), baseline_device_ms=min(b1, b2),
                     baseline_fill_ms=fill_ms,
                     baseline_scatter_ms=scatter_ms, bytes=nbytes,
                     bound_ms=nbytes / PEAK_BYTES * 1e3,
                     max_abs_err=errs[1], baseline_max_abs_err=errs[0],
                     plan=dataclasses.asdict(plan), resident_ctas=resident)
        rows.append({"kernel": "K8 voxelize_batch_scatter", "shape": shape,
                     **times})
        print(f"K8 {shape}: one call baseline {times['baseline_ms']:.4g} ms,"
              f" now {times['ms']:.4g} ms; graph-timed baseline "
              f"{times['baseline_device_ms'] * 1e3:.4g} us (its fill "
              f"{fill_ms * 1e3:.4g}, its scatter {scatter_ms * 1e3:.4g}), "
              f"now {times['device_ms'] * 1e3:.4g} us, bound "
              f"{times['bound_ms'] * 1e3:.4g} us ("
              f"{times['bound_ms'] / times['device_ms']:.1%} of it); plan "
              f"{plan}; max_abs_err {errs[1]:.3g} / {errs[0]:.3g} ({smi})",
              flush=True)
        if not args.variants:
            continue
        fns = {"default": mine}
        for name, p in plan_variants(plan, events, resident).items():
            fns[name] = (lambda p=p: k8._voxel_scatter_into(
                ev, counts, torch.empty(grid, device=dev), plan=p, **kw))
        wave = plan.lookahead + 1

        def waves(out=None):
            out = torch.empty(grid, device=dev) if out is None else out
            for s0 in range(0, batch, wave):
                part = out[s0:s0 + wave]
                part.zero_()
                baseline_scatter(lib, ev[s0:s0 + wave],
                                 counts[s0:s0 + wave], part, **kw)
            return out

        fns[f"waves{wave}"] = waves
        for name, fn in fns.items():
            got = fn()
            err = (got - want).abs().max().item()
            if not err <= SPLAT_ATOL:
                failed.append(f"K8 {shape} variant {name}: {err:.3g}")
        order = list(fns) + list(fns)[::-1]
        best = {}
        for name in order:
            t = graph_ms(fns[name], reps=args.reps)
            best[name] = min(best.get(name, t), t)
        for name, t in best.items():
            rows.append({"kernel": "K8 voxelize_batch_scatter",
                         "shape": shape, "variant": name, "device_ms": t})
            print(f"K8 {shape} variant {name}: graph-timed {t * 1e3:.4g} us "
                  f"({smi})", flush=True)
        del ev, counts, want
    print(json.dumps({"compare_scatter": rows, "card": smi,
                      "ptxas": {"baseline": base_usage, "now": usage},
                      "reps": args.reps}))
    if failed:
        raise SystemExit("compare_scatter: " + "; ".join(failed))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
