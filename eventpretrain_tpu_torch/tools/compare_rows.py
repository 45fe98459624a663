"""Time the row and column reductions of the K1/K2/K4/K5 backward
(``csrc/ln_bwd.cu``: ``ln_backward`` and ``colsum``) and the K1/K2/K4
backwards whole, of this checkout against another checkout's
``ln_bwd.cu``, in turns on one card.

    git archive <commit> eventpretrain_tpu_torch/csrc | tar -x -C build/base
    python3 -m eventpretrain_tpu_torch.tools.compare_rows \\
        --baseline build/base/eventpretrain_tpu_torch/csrc

The baseline's ``ln_bwd.cu`` is built with this checkout's ``nvcc`` flags
into ``build/baseline_kernels/`` (beside a second build of this
checkout's, for ptxas's registers, spills and shared memory of both) and
called through the C entry points it had before the redesign of its
reductions: ``ln_backward_bf16(x, g, eps, dy, dyln, dx, part, dg, db, M, C,
rows, stream)`` and ``colsum_bf16(in, part, out, M, N, rows, stream)``,
with (.., ceil(M / 64), N) f32 partial scratch. The backwards whole run
this checkout's GEMM and attention core on both sides, with the baseline's
``ln_backward`` and ``colsum`` put in place of this checkout's.

Each kernel alone runs at every main-path shape: ``ln_backward`` at the
ViT-S / decoder / ViT-B encoder rows (12544, 384), (12544, 512), (3136,
768), ``colsum`` at N = C, 3C and 4C of each. Both builds are held against
the plain versions (``ln_backward_reference``; the f32 column sum rounded
once): dx and the bias sums within one bf16 step, dgamma and dbeta within
1e-4 of their scale; this checkout's outputs must also come out equal bit
for bit on a repeat. Times: CUDA events around ``--calls`` calls in a row,
the median of ``--reps`` event pairs after warm-up, in the order baseline,
this checkout, this checkout, baseline (``compare_attention.py``'s timer);
each kernel alone also from CUDA graphs of 10 calls, which time the card
without the wrapper's host work, beside its bound (bytes over 3.35 TB/s)
and, for ``colsum``, ``torch.sum(x, 0, dtype=torch.float32)``. Prints one
line per row and a last JSON line with the card's name and power limit.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import subprocess
from pathlib import Path

import torch

from eventpretrain_tpu_torch import _build
from eventpretrain_tpu_torch.ops import common as cm
from eventpretrain_tpu_torch.ops import fused_attn_layer as ka
from eventpretrain_tpu_torch.ops import fused_mlp as km
from eventpretrain_tpu_torch.tools.compare_attention import _rel_err, compare
from eventpretrain_tpu_torch.tools.compare_gemm import (
    _block_cases,
    _inputs,
    graph_ms,
)

OUT_DIR = _build.BUILD_DIR.parent / "baseline_kernels"
EPS = 1e-6
PEAK_BYTES = 3.35e12  # H100 SXM device memory, bytes/s
# dgamma and dbeta: f32 sums of the same values in another order
SUM_REL_TOL = 1e-4
# the backwards whole, against the baseline's: the same function
BLOCK_REL_TOL = 2e-2
_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
BASELINE_SIGNATURES = {
    "ln_backward_bf16": [_P, _P, _F, _P, _P, _P, _P, _P, _P, _I, _I, _I, _P],
    "colsum_bf16": [_P, _P, _P, _I, _I, _I, _P],
}
BASELINE_ROWS = 64
# (M, C) of the LayerNorm rows on the main paths at B = 64: ViT-S (cls,
# semseg block 0), the MAE decoder, the ViT-B encoder's kept tokens
ROWS = ((12544, 384), (12544, 512), (3136, 768))
# the backwards whole: (kernel, B, L, C, heads)
BLOCKS = [("K1", 64, 196, 512, 16), ("K1", 64, 49, 768, 12),
          ("K2", 64, 196, 512, 0), ("K2", 64, 49, 768, 0),
          ("K4", 64, 196, 384, 12), ("K4", 64, 196, 768, 12)]


def build_baseline(csrc: Path) -> tuple[ctypes.CDLL, dict, dict]:
    """Compile the baseline's ln_bwd.cu, and this checkout's again beside
    it for its ptxas report: the baseline's library and ptxas's report of
    each kernel of both."""
    OUT_DIR.mkdir(parents=True, exist_ok=True)
    procs = {who: subprocess.Popen(
        [_build.nvcc_path(), *_build.NVCC_FLAGS, "-o",
         str(OUT_DIR / f"libln_bwd_{who}.so"), str(src / "ln_bwd.cu")],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        for who, src in (("baseline", csrc), ("now", _build.CSRC))}
    usage = {}
    for who, proc in procs.items():
        log = proc.communicate()[0]
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed for {who} ln_bwd\n{log}")
        usage[who] = _build.ptxas_usage("ln_bwd", log)
    lib = ctypes.CDLL(str(OUT_DIR / "libln_bwd_baseline.so"))
    for fn, argtypes in BASELINE_SIGNATURES.items():
        getattr(lib, fn).argtypes = argtypes
        getattr(lib, fn).restype = ctypes.c_int
    lib.kernel_error_string.argtypes = [ctypes.c_int]
    lib.kernel_error_string.restype = ctypes.c_char_p
    return lib, usage["baseline"], usage["now"]


class Baseline:
    """The baseline's two reductions behind this checkout's signatures."""

    def __init__(self, lib):
        self.lib = lib

    def ln_backward(self, x, gamma, eps, dy, d_yln):
        m, c = x.shape
        nblk = -(-m // BASELINE_ROWS)
        dx = torch.empty_like(x)
        part = torch.empty((2, nblk, c), dtype=torch.float32,
                           device=x.device)
        dg = torch.empty((c,), dtype=torch.float32, device=x.device)
        db = torch.empty((c,), dtype=torch.float32, device=x.device)
        code = self.lib.ln_backward_bf16(
            x.data_ptr(), gamma.data_ptr(), float(eps), dy.data_ptr(),
            d_yln.data_ptr(), dx.data_ptr(), part.data_ptr(), dg.data_ptr(),
            db.data_ptr(), m, c, BASELINE_ROWS, cm._stream(x))
        _build.check(self.lib, "baseline ln_backward_bf16", code)
        return dx, dg, db

    def colsum(self, x):
        m, n = x.shape
        nblk = -(-m // BASELINE_ROWS)
        part = torch.empty((nblk, n), dtype=torch.float32, device=x.device)
        out = torch.empty((n,), dtype=torch.bfloat16, device=x.device)
        code = self.lib.colsum_bf16(x.data_ptr(), part.data_ptr(),
                                    out.data_ptr(), m, n, BASELINE_ROWS,
                                    cm._stream(x))
        _build.check(self.lib, "baseline colsum_bf16", code)
        return out


def within_bf16_step(got, want) -> bool:
    """Each value at most one bf16 step of the plain value from it, plus
    1e-5 of the output's scale near zero, where the f32 values before the
    rounding, summed in another order, cancel."""
    want = want.float()
    step = torch.ldexp(torch.ones_like(want),
                       torch.frexp(want).exponent - 8)
    slack = 1e-5 * want.abs().max()
    return bool(((got.float() - want).abs() <= step + slack).all())


def ln_outputs_ok(got, want) -> bool:
    dx, dg, db = got
    wdx, wdg, wdb = want
    return within_bf16_step(dx, wdx) and all(
        _rel_err(g, w) <= SUM_REL_TOL for g, w in ((dg, wdg), (db, wdb)))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--baseline", type=Path, required=True,
                    help="the other checkout's eventpretrain_tpu_torch/csrc")
    ap.add_argument("--calls", type=int, default=1)
    ap.add_argument("--reps", type=int, default=20)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("compare_rows: no CUDA device")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip()
    print(f"nvidia-smi: {smi}", flush=True)
    _build.build(("ln_gemm", "ln_bwd", "attention", "attention_bwd"))
    lib, base_usage, usage = build_baseline(args.baseline.resolve())
    base = Baseline(lib)
    for kernel in sorted(set(usage) | set(base_usage)):
        print(f"ptxas {kernel}: " + "; ".join(
            f"{who} {u[kernel]['registers']} registers, "
            f"{u[kernel]['spill_stores']} B spill stores, "
            f"{u[kernel]['static_smem']} B static shared memory"
            for who, u in (("baseline", base_usage), ("now", usage))
            if kernel in u), flush=True)
    dev = torch.device("cuda", 0)
    gen = torch.Generator().manual_seed(29)
    rows, failed = [], []

    def rnd(*shape, dtype=torch.bfloat16):
        return torch.randn(shape, generator=gen).to(dev, dtype)

    def timed(what, shape, theirs, mine, nbytes, library=None):
        times = compare(theirs, mine, args.calls, args.reps)
        b1, m1, m2, b2 = (graph_ms(f) for f in (theirs, mine, mine, theirs))
        times.update(device_ms=min(m1, m2), baseline_device_ms=min(b1, b2),
                     bytes=nbytes, bound_ms=nbytes / PEAK_BYTES * 1e3)
        if library is not None:
            times["library_device_ms"] = graph_ms(library)
        rows.append({"kernel": what, "shape": list(shape), **times})
        print(f"{what} {shape}: baseline {times['baseline_ms']:.4g} ms, now "
              f"{times['ms']:.4g} ms ({times['speedup']:.3g}x); device "
              f"alone: baseline {times['baseline_device_ms'] * 1e3:.4g} us,"
              f" now {times['device_ms'] * 1e3:.4g} us, bound "
              f"{times['bound_ms'] * 1e3:.4g} us ("
              f"{times['bound_ms'] / times['device_ms']:.1%} of it)"
              + (f", torch.sum {times['library_device_ms'] * 1e3:.4g} us"
                 if library is not None else "") + f" ({smi})", flush=True)

    for m, c in ROWS:
        x, dy = rnd(m, c), rnd(m, c)
        d_yln = rnd(m, c, dtype=torch.float32)
        g = (1.0 + 0.1 * torch.randn(c, generator=gen)).to(dev)
        want = cm.ln_backward_reference(x, g, EPS, dy, d_yln)

        def mine():
            return cm.ln_backward(x, g, EPS, dy, d_yln)

        def theirs():
            return base.ln_backward(x, g, EPS, dy, d_yln)

        got, again = mine(), mine()
        ok = ln_outputs_ok(got, want) and ln_outputs_ok(theirs(), want)
        same = all(torch.equal(a, b) for a, b in zip(got, again))
        if not (ok and same):
            failed.append(f"ln_backward ({m}, {c}): plain {ok}, repeat "
                          f"{same}")
        timed("ln_backward", (m, c), theirs, mine, 10 * m * c + 12 * c)
        for n in (c, 3 * c, 4 * c):
            t = rnd(m, n)
            want = t.float().sum(0).to(torch.bfloat16)
            got = cm.colsum(t)
            ok = (within_bf16_step(got, want)
                  and within_bf16_step(base.colsum(t), want))
            same = torch.equal(got, cm.colsum(t))
            if not (ok and same):
                failed.append(f"colsum ({m}, {n}): plain {ok}, repeat "
                              f"{same}")
            timed("colsum", (m, n), lambda t=t: base.colsum(t),
                  lambda t=t: cm.colsum(t), 2 * m * n + 2 * n,
                  library=lambda t=t: torch.sum(t, 0, dtype=torch.float32))

    # the backwards whole, the baseline's reductions in place of these
    for kernel, b, l, c, h in BLOCKS:
        hidden = 3 * c if kernel in ("K1", "K4") else 4 * c
        a = _inputs(gen, dev, b, l, c, hidden)
        mine = _block_cases(None, kernel, a, h)["backward"][1]

        def theirs(mine=mine):
            saved = {(mod, name): getattr(mod, name) for mod in (ka, km)
                     for name in ("ln_backward", "colsum")}
            for mod in (ka, km):
                mod.ln_backward, mod.colsum = base.ln_backward, base.colsum
            try:
                return mine()
            finally:
                for (mod, name), fn in saved.items():
                    setattr(mod, name, fn)

        rel = _rel_err(mine(), theirs())
        times = compare(theirs, mine, args.calls, args.reps)
        shape = [b, l, c] + ([h] if h else [])
        rows.append({"kernel": f"{kernel} backward", "shape": shape,
                     "max_rel_err_vs_baseline": rel, **times})
        if not rel <= BLOCK_REL_TOL:
            failed.append(f"{kernel} backward {shape}")
        print(f"{kernel} backward {shape}: baseline "
              f"{times['baseline_ms']:.4g} ms, now {times['ms']:.4g} ms "
              f"({times['speedup']:.3g}x); against the baseline {rel:.3g} "
              f"of scale ({smi})", flush=True)
    print(json.dumps({"compare_rows": rows, "card": smi,
                      "ptxas": {"baseline": base_usage, "now": usage},
                      "calls_per_event_pair": args.calls, "reps": args.reps}))
    if failed:
        raise SystemExit("compare_rows: " + "; ".join(failed))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
