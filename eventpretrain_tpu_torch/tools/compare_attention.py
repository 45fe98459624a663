"""Time K7 (``fused_mha``) and the K1/K4 attention core of this checkout
against the kernels of another checkout's sources, in turns on one card.

    git archive <commit> eventpretrain_tpu_torch/csrc | tar -x -C build/base
    python3 -m eventpretrain_tpu_torch.tools.compare_attention \\
        --baseline build/base/eventpretrain_tpu_torch/csrc

The baseline's ``mha.cu``, ``attention.cu`` and ``attention_bwd.cu`` are
built with this checkout's ``nvcc`` flags into ``build/baseline_kernels/``
and called through the C entry points both checkouts have: K7's tiled
``mha_fwd_bf16`` and ``mha_bwd_bf16`` (every input strided, outputs
contiguous; before the one-pass route, K7's only kernels), and the
attention core's ``attention_bf16`` and ``attention_bwd_bf16`` on packed
qkv rows.

Each function is timed as ``chip_smoke.py`` times the attention core: CUDA
events around ``--calls`` calls in a row, the median of ``--reps`` event
pairs after warm-up, in the order baseline, this checkout, this checkout,
baseline, the better of each pair. K7's forward goes through ``fused_mha``
here and through an ``autograd.Function`` with the same checks there, so
both carry their wrapper's host work; each backward starts from its own
forward's saved statistics. The outputs are compared: the core's must be
equal bit for bit (the same arithmetic), K7's within 2% of their scale (the
baseline's forward takes its row sum online). Prints one line per row and a
last JSON line with the card's name and power limit.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import statistics
import subprocess
from pathlib import Path

import torch

from eventpretrain_tpu_torch import _build
from eventpretrain_tpu_torch.ops import fused_attn_layer as ka
from eventpretrain_tpu_torch.ops import fused_mha as km

# (B, L, H, D): the MAE decoder's, ViT-S's and the ViT-B encoder's heads
K7_SHAPES = ((64, 196, 16, 32), (64, 196, 12, 32), (64, 49, 12, 64))
# and the dense ViT-B's at the semseg batch, for the core
CORE_SHAPES = ((64, 196, 12, 32), (64, 49, 12, 64), (64, 196, 16, 32),
               (16, 196, 12, 64))
OUT_DIR = _build.BUILD_DIR.parent / "baseline_kernels"
# K7 against the baseline: each output within 2% of its scale, as
# chip_smoke.py holds it against its plain version
REL_TOL = 2e-2

BASELINE_SIGNATURES = {
    "mha": {fn: _build.SIGNATURES["mha"][fn]
            for fn in ("mha_fwd_bf16", "mha_bwd_bf16")},
    "attention": _build.SIGNATURES["attention"],
    "attention_bwd": _build.SIGNATURES["attention_bwd"],
}


def build_baseline(csrc: Path) -> tuple[dict, dict]:
    """Compile the baseline sources in parallel: ``{name: ctypes.CDLL}``
    and ptxas's registers and spills of each kernel."""
    OUT_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = _build.nvcc_path()
    procs = {}
    for name in BASELINE_SIGNATURES:
        out = OUT_DIR / f"lib{name}.so"
        procs[name] = subprocess.Popen(
            [nvcc, *_build.NVCC_FLAGS, "-o", str(out),
             str(csrc / f"{name}.cu")],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    libs, usage = {}, {}
    for name, proc in procs.items():
        log = proc.communicate()[0]
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed for baseline {name}\n{log}")
        usage.update(_build.ptxas_usage(name, log))
        lib = ctypes.CDLL(str(OUT_DIR / f"lib{name}.so"))
        for fn, argtypes in BASELINE_SIGNATURES[name].items():
            getattr(lib, fn).argtypes = argtypes
            getattr(lib, fn).restype = ctypes.c_int
        lib.kernel_error_string.argtypes = [ctypes.c_int]
        lib.kernel_error_string.restype = ctypes.c_char_p
        libs[name] = lib
    return libs, usage


def cuda_ms(fn, calls: int, reps: int, warmup: int = 3) -> float:
    """Median device ms per call of ``fn`` over ``reps`` event pairs, each
    around ``calls`` calls in a row."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        stop = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(calls):
            fn()
        stop.record()
        stop.synchronize()
        times.append(start.elapsed_time(stop) / calls)
    return statistics.median(times)


def _stream(t):
    return torch.cuda.current_stream(t.device).cuda_stream


def _strided(t):
    return [t.data_ptr(), *t.stride()]


class Baseline:
    """The baseline's launchers behind this checkout's host checks."""

    def __init__(self, libs):
        self.libs = libs
        outer = self

        class _Fwd(torch.autograd.Function):
            @staticmethod
            def forward(ctx, q, k, v, scale):
                return outer.mha_fwd(q, k, v, scale)[0]

        self._fwd = _Fwd

    def _call(self, name, fn, *args):
        lib = self.libs[name]
        code = getattr(lib, fn)(*args)
        _build.check(lib, f"baseline {fn}", code)

    def mha_fwd(self, q, k, v, scale):
        b, l, h, d = q.shape
        out = torch.empty((b, l, h, d), dtype=q.dtype, device=q.device)
        stats = torch.empty((2, b, h, l), dtype=torch.float32,
                            device=q.device)
        with torch.cuda.device(q.device):
            self._call("mha", "mha_fwd_bf16", *_strided(q), *_strided(k),
                       *_strided(v), out.data_ptr(), stats.data_ptr(), b, l,
                       h, d, float(scale), _stream(q))
        return out, stats

    def fused_mha(self, q, k, v, scale):
        km._check_cuda("fused_mha", q=q, k=k, v=v)
        return self._fwd.apply(q, k, v, float(scale))

    def mha_bwd(self, q, k, v, do, stats, scale):
        b, l, h, d = q.shape
        dq, dk, dv = (torch.empty((b, l, h, d), dtype=q.dtype,
                                  device=q.device) for _ in range(3))
        delta = torch.empty((b, h, l), dtype=torch.float32, device=q.device)
        with torch.cuda.device(q.device):
            self._call("mha", "mha_bwd_bf16", *_strided(q), *_strided(k),
                       *_strided(v), *_strided(do), stats.data_ptr(),
                       delta.data_ptr(), dq.data_ptr(), dk.data_ptr(),
                       dv.data_ptr(), b, l, h, d, float(scale), _stream(q))
        return dq, dk, dv

    def core(self, qkv, b, l, h, scale):
        c = qkv.shape[-1] // 3
        out = torch.empty((b * l, c), dtype=qkv.dtype, device=qkv.device)
        with torch.cuda.device(qkv.device):
            self._call("attention", "attention_bf16", qkv.data_ptr(),
                       out.data_ptr(), b, l, h, c // h, float(scale),
                       _stream(qkv))
        return out

    def core_bwd(self, qkv, do, b, l, h, scale):
        c = do.shape[-1]
        dqkv = torch.empty((b * l, 3 * c), dtype=qkv.dtype,
                           device=qkv.device)
        stats = ka.attention_bwd_scratch(b, l, h, qkv.device)
        with torch.cuda.device(qkv.device):
            self._call("attention_bwd", "attention_bwd_bf16",
                       qkv.data_ptr(), do.data_ptr(), dqkv.data_ptr(),
                       stats.data_ptr(), b, l, h, c // h, float(scale),
                       _stream(qkv))
        return dqkv


def _rel_err(got, want) -> float:
    if isinstance(got, torch.Tensor):
        got, want = (got,), (want,)
    return max(((g.float() - w.float()).abs().max()
                / w.float().abs().max().clamp_min(1e-30)).item()
               for g, w in zip(got, want))


def _equal(got, want) -> bool:
    if isinstance(got, torch.Tensor):
        got, want = (got,), (want,)
    return all(torch.equal(g, w) for g, w in zip(got, want))


def compare(base, mine, calls, reps) -> dict:
    """baseline, this checkout, this checkout, baseline."""
    b1, m1, m2, b2 = (cuda_ms(f, calls, reps) for f in (base, mine, mine,
                                                         base))
    return {"baseline_ms": min(b1, b2), "ms": min(m1, m2),
            "speedup": min(b1, b2) / min(m1, m2)}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--baseline", type=Path, required=True,
                    help="the other checkout's eventpretrain_tpu_torch/csrc")
    ap.add_argument("--calls", type=int, default=10)
    ap.add_argument("--reps", type=int, default=20)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("compare_attention: no CUDA device")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip()
    usage = {}
    built = _build.build(("mha", "attention", "attention_bwd"))
    for name, log in built.items():
        usage.update(_build.ptxas_usage(name, log))
    libs, base_usage = build_baseline(args.baseline.resolve())
    base = Baseline(libs)
    for kernel in sorted(set(usage) | set(base_usage)):
        print(f"ptxas {kernel}: " + "; ".join(
            f"{who} {u[kernel]['registers']} registers, "
            f"{u[kernel]['spill_stores']} B spill stores"
            for who, u in (("baseline", base_usage), ("now", usage))
            if kernel in u), flush=True)
    dev = torch.device("cuda", 0)
    gen = torch.Generator().manual_seed(21)
    rows, failed = [], []

    def record(kind, shape, direction, rel, equal, times):
        rows.append({"kernel": kind, "direction": direction, "shape": shape,
                     "max_rel_err_vs_baseline": rel,
                     "equal_to_baseline": equal, **times})
        if not (equal if kind == "attention_core" else rel <= REL_TOL):
            failed.append(f"{kind} {direction} {shape}")
        print(f"{kind} {direction} {shape}: baseline "
              f"{times['baseline_ms']:.4g} ms, now {times['ms']:.4g} ms "
              f"({times['speedup']:.3g}x); against the baseline: "
              f"{'equal' if equal else f'{rel:.3g} of scale'} ({smi})",
              flush=True)

    for b, l, h, d in K7_SHAPES:
        scale = d ** -0.5
        qkv = torch.randn((b, l, 3, h, d), generator=gen).to(dev,
                                                              torch.bfloat16)
        q, k, v = qkv.unbind(2)
        dy = torch.randn((b, l, h, d), generator=gen).to(dev, torch.bfloat16)
        shape = [b, l, h, d]
        got, want = (km.fused_mha(q, k, v, scale=scale),
                     base.fused_mha(q, k, v, scale))
        record("fused_mha", shape, "forward", _rel_err(got, want),
               _equal(got, want),
               compare(lambda: base.fused_mha(q, k, v, scale),
                       lambda: km.fused_mha(q, k, v, scale=scale),
                       args.calls, args.reps))
        _, stats, _ = km._forward_cuda(q, k, v, scale)
        _, bstats = base.mha_fwd(q, k, v, scale)
        got = km._backward_cuda(q, k, v, dy, scale, stats)[0]
        want = base.mha_bwd(q, k, v, dy, bstats, scale)
        record("fused_mha", shape, "backward", _rel_err(got, want),
               _equal(got, want),
               compare(lambda: base.mha_bwd(q, k, v, dy, bstats, scale),
                       lambda: km._backward_cuda(q, k, v, dy, scale,
                                                 stats)[0],
                       args.calls, args.reps))
    for b, l, h, d in CORE_SHAPES:
        scale = d ** -0.5
        qkv = torch.randn((b * l, 3 * h * d), generator=gen).to(
            dev, torch.bfloat16)
        do = torch.randn((b * l, h * d), generator=gen).to(dev,
                                                           torch.bfloat16)
        shape = [b, l, h, d]
        got, want = (ka._attention(qkv, b, l, h, scale),
                     base.core(qkv, b, l, h, scale))
        record("attention_core", shape, "forward", _rel_err(got, want),
               _equal(got, want),
               compare(lambda: base.core(qkv, b, l, h, scale),
                       lambda: ka._attention(qkv, b, l, h, scale),
                       args.calls, args.reps))
        got, want = (ka._attention_bwd(qkv, do, b, l, h, scale),
                     base.core_bwd(qkv, do, b, l, h, scale))
        record("attention_core", shape, "backward", _rel_err(got, want),
               _equal(got, want),
               compare(lambda: base.core_bwd(qkv, do, b, l, h, scale),
                       lambda: ka._attention_bwd(qkv, do, b, l, h, scale),
                       args.calls, args.reps))
    print(json.dumps({"compare_attention": rows, "card": smi,
                      "ptxas": {"baseline": base_usage, "now": usage},
                      "calls_per_event_pair": args.calls, "reps": args.reps}))
    if failed:
        raise SystemExit("compare_attention: disagrees with the baseline: "
                         + "; ".join(failed))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
