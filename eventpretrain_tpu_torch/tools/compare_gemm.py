"""Time the GEMM under K1/K2/K4/K5 (``csrc/ln_gemm.cu``) and the four
sub-blocks, forward and backward, of this checkout against another
checkout's ``ln_gemm.cu``, in turns on one card, with ``torch.matmul``
beside each GEMM launch.

    git archive <commit> eventpretrain_tpu_torch/csrc | tar -x -C build/base
    python3 -m eventpretrain_tpu_torch.tools.compare_gemm \\
        --baseline build/base/eventpretrain_tpu_torch/csrc

The baseline's ``ln_gemm.cu`` is built with this checkout's ``nvcc`` flags
into ``build/baseline_kernels/`` (beside a second build of this checkout's,
for ptxas's registers and spills of both) and called through the C entry
point it
had before the tensor-core redesign, ``gemm_bf16(a, ln_w, ln_b, eps,
use_ln, a_trans, b_kn, w, bias, residual, aux, out, out2, M, N, K,
epilogue, stream)``. On the baseline the sub-blocks compose that GEMM as
the baseline did: K1's and K2's forward normalise inside the GEMM's
prologue, and K2's backward recomputes ``h_pre`` with the prologue on
``x``. Every other kernel (the attention core, the LayerNorm rows and
backward, the column sums) is this checkout's on both sides.

Each function is timed as ``chip_smoke.py`` times the kernel rows: CUDA
events around ``--calls`` calls in a row, the median of ``--reps`` event
pairs after warm-up, in the order baseline, this checkout, this checkout,
baseline, the better of each pair (``compare_attention.py``'s timer). Each
GEMM launch is also timed as one ``torch.matmul`` in the same layout, and
all three again from CUDA graphs of 10 calls, which time the card alone
(a GEMM wrapper's host work can take as long as the smaller products).
Checks: every GEMM launch and every sub-block output within 2% of its scale
of the baseline's (the same function, summed in another order), and the
LayerNorm rows this checkout's K1/K2 forward GEMM reads (``ln_rows``) equal
bit for bit to the values the baseline's prologue staged (read back through
the baseline GEMM on an identity weight with the f32 epilogue, where every
product is exact). Prints one line per row and a last JSON line with the
card's name and power limit.
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
from eventpretrain_tpu_torch.tools.compare_attention import (
    _rel_err,
    compare,
    cuda_ms,
)

OUT_DIR = _build.BUILD_DIR.parent / "baseline_kernels"
# the same function summed in another order: each output within 2% of its
# scale, as chip_smoke.py holds the sub-blocks against their plain versions
REL_TOL = 2e-2
EPS = 1e-6
_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
BASELINE_GEMM = [_P, _P, _P, _F, _I, _I, _I, _P, _P, _P, _P, _P, _P, _I, _I,
                 _I, _I, _P]
F, D, W = cm.LAYOUT_FORWARD, cm.LAYOUT_DGRAD, cm.LAYOUT_WGRAD
# each GEMM launch of the main paths at B=64 (M x N x K in the operand order
# of ops/common.py::_gemm; a weight gradient's K is the token count): K4/K1
# at ViT-S C=384, K2/K5 at the decoder's C=512 (rec), K2's weight gradients
# at the ViT-B encoder's C=768 on 49 kept tokens; "+ln": K1's and K2's
# first GEMM with its LayerNorm (here the ln_rows pass, then the GEMM; the
# baseline's in its prologue)
GEMMS = [
    ("qkv+ln", F, 12544, 1152, 384, cm.EPI_BIAS),
    ("qkv", F, 12544, 1152, 384, cm.EPI_BIAS),
    ("proj", F, 12544, 384, 384, cm.EPI_BIAS_RESIDUAL),
    ("dWo", W, 384, 384, 12544, cm.EPI_BIAS),
    ("do", D, 12544, 384, 384, cm.EPI_BIAS),
    ("dWqkv", W, 1152, 384, 12544, cm.EPI_BIAS),
    ("du", D, 12544, 384, 1152, cm.EPI_F32),
    ("fc1+ln", F, 12544, 2048, 512, cm.EPI_BIAS_GELU),
    ("fc1", F, 12544, 2048, 512, cm.EPI_BIAS_GELU),
    ("fc2", F, 12544, 512, 2048, cm.EPI_BIAS_RESIDUAL),
    ("h_pre", F, 12544, 2048, 512, cm.EPI_F32),
    ("dW2", W, 512, 2048, 12544, cm.EPI_BIAS),
    ("dW1", W, 2048, 512, 12544, cm.EPI_BIAS),
    ("dh_pre", D, 12544, 2048, 512, cm.EPI_DGELU),
    ("du_mlp", D, 12544, 512, 2048, cm.EPI_F32),
    ("dW2_enc", W, 768, 3072, 3136, cm.EPI_BIAS),
    ("dW1_enc", W, 3072, 768, 3136, cm.EPI_BIAS),
]
# the sub-block rows of PERF.md's kernel table: (kernel, B, L, C, heads)
BLOCKS = [
    ("K1", 64, 196, 384, 12), ("K1", 64, 49, 768, 12),
    ("K1", 64, 196, 512, 16), ("K2", 64, 196, 384, 0),
    ("K2", 64, 49, 768, 0), ("K2", 64, 196, 512, 0),
    ("K4", 64, 196, 384, 12), ("K4", 64, 196, 768, 12),
    ("K5", 64, 196, 384, 0), ("K5", 64, 196, 512, 0),
]


def graph_ms(fn, calls: int = 10, reps: int = 20) -> float:
    """Device ms of one call of ``fn`` replayed from a CUDA graph of
    ``calls`` calls: the card's time without the wrapper's host work."""
    for _ in range(2):
        fn()
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(calls):
            fn()
    try:
        return cuda_ms(graph.replay, 1, reps) / calls
    finally:
        del graph


def build_baseline(csrc: Path) -> tuple[ctypes.CDLL, dict, dict]:
    """Compile the baseline's ln_gemm.cu, and this checkout's again beside
    it for its ptxas report: the baseline's library and ptxas's registers
    and spills of each kernel of both."""
    OUT_DIR.mkdir(parents=True, exist_ok=True)
    procs = {who: subprocess.Popen(
        [_build.nvcc_path(), *_build.NVCC_FLAGS, "-o",
         str(OUT_DIR / f"libln_gemm_{who}.so"), str(src / "ln_gemm.cu")],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        for who, src in (("baseline", csrc), ("now", _build.CSRC))}
    usage = {}
    for who, proc in procs.items():
        log = proc.communicate()[0]
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed for {who} ln_gemm\n{log}")
        usage[who] = _build.ptxas_usage("ln_gemm", log)
    lib = ctypes.CDLL(str(OUT_DIR / "libln_gemm_baseline.so"))
    lib.gemm_bf16.argtypes = BASELINE_GEMM
    lib.gemm_bf16.restype = ctypes.c_int
    lib.kernel_error_string.argtypes = [ctypes.c_int]
    lib.kernel_error_string.restype = ctypes.c_char_p
    return lib, usage["baseline"], usage["now"]


class Baseline:
    """The baseline GEMM behind its own wrappers, and the sub-blocks
    composed on it as the baseline composed them."""

    def __init__(self, lib):
        self.lib = lib

    def gemm(self, a, w, *, m, n, k, a_trans, b_kn, epilogue, bias=None,
             ln=None, residual=None, aux=None, gelu_out=False):
        out = torch.empty((m, n), dtype=torch.float32
                          if epilogue == cm.EPI_F32 else torch.bfloat16,
                          device=a.device)
        out2 = (torch.empty((m, n), dtype=torch.bfloat16, device=a.device)
                if gelu_out else None)
        ptr = cm._ptr
        with torch.cuda.device(a.device):
            code = self.lib.gemm_bf16(
                a.data_ptr(), ptr(ln[0]) if ln else None,
                ptr(ln[1]) if ln else None, float(ln[2]) if ln else 0.0,
                int(ln is not None), int(a_trans), int(b_kn), w.data_ptr(),
                ptr(bias), ptr(residual), ptr(aux), out.data_ptr(),
                ptr(out2), m, n, k, int(epilogue), cm._stream(a))
        _build.check(self.lib, "baseline gemm_bf16", code)
        return (out, out2) if gelu_out else out

    def ln_gemm(self, a, w, bias, *, epilogue, ln=None, residual=None,
                gelu_out=False):
        return self.gemm(a, w, m=a.shape[0], n=w.shape[0], k=a.shape[1],
                         a_trans=False, b_kn=False, epilogue=epilogue,
                         bias=bias, ln=ln, residual=residual,
                         gelu_out=gelu_out)

    def gemm_dgrad(self, dy, w, *, epilogue=cm.EPI_BIAS, aux=None):
        return self.gemm(dy, w, m=dy.shape[0], n=w.shape[1], k=dy.shape[1],
                         a_trans=False, b_kn=True, epilogue=epilogue,
                         aux=aux)

    def gemm_wgrad(self, dy, x):
        return self.gemm(dy, x, m=dy.shape[1], n=x.shape[1], k=dy.shape[0],
                         a_trans=True, b_kn=True, epilogue=cm.EPI_BIAS)

    def launch(self, layout, a, w, epilogue, **kw):
        if layout == F:
            return self.ln_gemm(a, w, kw.get("bias"), epilogue=epilogue,
                                ln=kw.get("ln"), residual=kw.get("residual"),
                                gelu_out=kw.get("gelu_out", False))
        if layout == D:
            return self.gemm_dgrad(a, w, epilogue=epilogue,
                                   aux=kw.get("aux"))
        return self.gemm_wgrad(a, w)

    # the sub-blocks (ops/fused_attn_layer.py, ops/fused_mlp.py as the
    # baseline had them)
    def layer(self, x, wqkv, bqkv, wo, bo, h, scale, ln=None):
        b, l, c = x.shape
        x2 = x.view(b * l, c)
        qkv = self.ln_gemm(x2, wqkv, bqkv, epilogue=cm.EPI_BIAS, ln=ln)
        o = ka._attention(qkv, b, l, h, scale)
        if ln is None:
            y = self.ln_gemm(o, wo, bo, epilogue=cm.EPI_BIAS)
        else:
            y = self.ln_gemm(o, wo, bo, epilogue=cm.EPI_BIAS_RESIDUAL,
                             residual=x2)
        return y.view(b, l, c), qkv, o

    def layer_bwd(self, u2, wqkv, wo, qkv, o, dy2, b, l, h, scale, du_epi):
        dwo = self.gemm_wgrad(dy2, o)
        dbo = cm.colsum(dy2)
        do = self.gemm_dgrad(dy2, wo)
        dqkv = ka._attention_bwd(qkv, do, b, l, h, scale)
        dwqkv = self.gemm_wgrad(dqkv, u2)
        dbqkv = cm.colsum(dqkv)
        du = self.gemm_dgrad(dqkv, wqkv, epilogue=du_epi)
        return du, dwqkv, dbqkv, dwo, dbo

    def ln_layer_bwd(self, x, g, beta, wqkv, wo, qkv, o, dy, h, scale):
        b, l, c = x.shape
        x2, dy2 = x.view(b * l, c), dy.view(b * l, c)
        yln = cm.ln_rows(x2, g, beta, EPS)
        d_yln, *grads = self.layer_bwd(yln, wqkv, wo, qkv, o, dy2, b, l, h,
                                       scale, cm.EPI_F32)
        dx, dg, db = cm.ln_backward(x2, g, EPS, dy2, d_yln)
        return (dx.view(b, l, c), dg, db, *grads)

    def layer_bwd_bare(self, x, wqkv, wo, qkv, o, dy, h, scale):
        b, l, c = x.shape
        dx, *grads = self.layer_bwd(x.view(b * l, c), wqkv, wo, qkv, o,
                                    dy.view(b * l, c), b, l, h, scale,
                                    cm.EPI_BIAS)
        return (dx.view(b, l, c), *grads)

    def mlp(self, x, w1, b1, w2, b2, ln=None):
        b, l, c = x.shape
        x2 = x.view(b * l, c)
        hid = self.ln_gemm(x2, w1, b1, epilogue=cm.EPI_BIAS_GELU, ln=ln)
        if ln is None:
            y = self.ln_gemm(hid, w2, b2, epilogue=cm.EPI_BIAS)
        else:
            y = self.ln_gemm(hid, w2, b2, epilogue=cm.EPI_BIAS_RESIDUAL,
                             residual=x2)
        return y.view(b, l, c)

    def mlp_bwd(self, x2, w1, b1, w2, dy2, u2, du_epi, ln=None):
        h_pre, hid = self.ln_gemm(x2, w1, b1, epilogue=cm.EPI_F32, ln=ln,
                                  gelu_out=True)
        dw2 = self.gemm_wgrad(dy2, hid)
        db2 = cm.colsum(dy2)
        dh_pre = self.gemm_dgrad(dy2, w2, epilogue=cm.EPI_DGELU, aux=h_pre)
        del h_pre, hid
        dw1 = self.gemm_wgrad(dh_pre, u2)
        db1 = cm.colsum(dh_pre)
        du = self.gemm_dgrad(dh_pre, w1, epilogue=du_epi)
        return du, dw1, db1, dw2, db2

    def ln_mlp_bwd(self, x, g, beta, w1, b1, w2, dy):
        b, l, c = x.shape
        x2, dy2 = x.view(b * l, c), dy.view(b * l, c)
        yln = cm.ln_rows(x2, g, beta, EPS)
        d_yln, *grads = self.mlp_bwd(x2, w1, b1, w2, dy2, yln, cm.EPI_F32,
                                     ln=(g, beta, EPS))
        dx, dg, db = cm.ln_backward(x2, g, EPS, dy2, d_yln)
        return (dx.view(b, l, c), dg, db, *grads)

    def mlp_bwd_bare(self, x, w1, b1, w2, dy):
        b, l, c = x.shape
        x2 = x.view(b * l, c)
        dx, *grads = self.mlp_bwd(x2, w1, b1, w2, dy.view(b * l, c), x2,
                                  cm.EPI_BIAS)
        return (dx.view(b, l, c), *grads)


def _inputs(gen, dev, b, l, c, hidden):
    def rnd(*shape, std=1.0):
        return (torch.randn(shape, generator=gen) * std).to(dev,
                                                            torch.bfloat16)

    return dict(
        x=rnd(b, l, c), dy=rnd(b, l, c),
        g=(1.0 + 0.1 * torch.randn(c, generator=gen)).to(dev),
        beta=(0.1 * torch.randn(c, generator=gen)).to(dev),
        w1=rnd(hidden, c, std=c ** -0.5), b1=rnd(hidden, std=0.1),
        w2=rnd(c, hidden, std=hidden ** -0.5) if hidden != 3 * c
        else rnd(c, c, std=c ** -0.5),
        b2=rnd(c, std=0.1))


def _block_cases(base, kernel, a, h):
    """{direction: (baseline fn, this checkout's fn)} of one sub-block."""
    x, g, beta, dy = a["x"], a["g"], a["beta"], a["dy"]
    w1, b1, w2, b2 = a["w1"], a["b1"], a["w2"], a["b2"]
    if kernel in ("K1", "K4"):
        c = x.shape[-1]
        scale = (c // h) ** -0.5
        ln = (g, beta, EPS) if kernel == "K1" else None
        with torch.no_grad():
            _, qkv, o = ka._layer_cuda(x, w1, b1, w2, b2, h, scale, ln=ln)
        fwd = (lambda: base.layer(x, w1, b1, w2, b2, h, scale, ln=ln)[0],
               lambda: ka._layer_cuda(x, w1, b1, w2, b2, h, scale,
                                      ln=ln)[0])
        if kernel == "K1":
            bwd = (lambda: base.ln_layer_bwd(x, g, beta, w1, w2, qkv, o, dy,
                                             h, scale),
                   lambda: ka._ln_backward_cuda(x, g, beta, w1, w2, qkv, o,
                                                dy, h, scale, EPS))
        else:
            bwd = (lambda: base.layer_bwd_bare(x, w1, w2, qkv, o, dy, h,
                                               scale),
                   lambda: ka._backward_cuda(x, w1, w2, qkv, o, dy, h,
                                             scale))
        return {"forward": fwd, "backward": bwd}
    ln = (g, beta, EPS) if kernel == "K2" else None
    fwd = (lambda: base.mlp(x, w1, b1, w2, b2, ln=ln),
           lambda: km._mlp_cuda(x, w1, b1, w2, b2, ln=ln))
    if kernel == "K2":
        bwd = (lambda: base.ln_mlp_bwd(x, g, beta, w1, b1, w2, dy),
               lambda: km._ln_backward_cuda(x, g, beta, w1, b1, w2, dy, EPS))
    else:
        bwd = (lambda: base.mlp_bwd_bare(x, w1, b1, w2, dy),
               lambda: km._backward_cuda(x, w1, b1, w2, dy))
    return {"forward": fwd, "backward": bwd}


def _gemm_operands(gen, dev, layout, m, n, k, epilogue, ln):
    def rnd(*shape, std=1.0, dtype=torch.bfloat16):
        return (torch.randn(shape, generator=gen) * std).to(dev, dtype)

    a = rnd(k, m) if layout == W else rnd(m, k)
    w = rnd(n, k, std=k ** -0.5) if layout == F else rnd(k, n,
                                                         std=k ** -0.5)
    kw = {}
    if layout == F:
        kw["bias"] = rnd(n, std=0.1)
    if epilogue == cm.EPI_BIAS_RESIDUAL:
        kw["residual"] = rnd(m, n)
    if epilogue == cm.EPI_DGELU:
        kw["aux"] = rnd(m, n, dtype=torch.float32)
    if layout == F and epilogue == cm.EPI_F32:
        kw["gelu_out"] = True
    if ln:
        kw["ln"] = ((1.0 + 0.1 * torch.randn(k, generator=gen)).to(dev),
                    (0.1 * torch.randn(k, generator=gen)).to(dev), EPS)
    if layout == F:
        matmul = (lambda: a @ w.t())
    elif layout == D:
        matmul = (lambda: a @ w)
    else:
        matmul = (lambda: a.t() @ w)
    return a, w, kw, matmul


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--baseline", type=Path, required=True,
                    help="the other checkout's eventpretrain_tpu_torch/csrc")
    ap.add_argument("--calls", type=int, default=1)
    ap.add_argument("--reps", type=int, default=20)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("compare_gemm: no CUDA device")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip()
    print(f"nvidia-smi: {smi}", flush=True)
    _build.build(("ln_gemm", "ln_bwd", "attention", "attention_bwd"))
    lib, base_usage, usage = build_baseline(args.baseline.resolve())
    base = Baseline(lib)
    for kernel in sorted(k for k in set(usage) | set(base_usage)
                         if k.startswith("ln_gemm:")):
        print(f"ptxas {kernel}: " + "; ".join(
            f"{who} {u[kernel]['registers']} registers, "
            f"{u[kernel]['spill_stores']} B spill stores"
            for who, u in (("baseline", base_usage), ("now", usage))
            if kernel in u), flush=True)
    dev = torch.device("cuda", 0)
    gen = torch.Generator().manual_seed(23)
    rows, failed = [], []

    # the LayerNorm rows against the baseline prologue's staged values
    ln_equal = True
    for b, l, c in ((64, 196, 384), (64, 49, 768), (64, 196, 512)):
        a = _inputs(gen, dev, b, l, c, 4 * c)
        x2 = a["x"].view(b * l, c)
        eye = torch.eye(c, device=dev, dtype=torch.bfloat16)
        staged = base.ln_gemm(x2, eye, None, epilogue=cm.EPI_F32,
                              ln=(a["g"], a["beta"], EPS))
        rows_now = cm.ln_rows(x2, a["g"], a["beta"], EPS)
        same = bool(torch.equal(rows_now.float(), staged))
        ln_equal &= same
        print(f"ln_rows ({b * l}, {c}) against the baseline prologue: "
              f"{'equal bit for bit' if same else 'DIFFERENT'}", flush=True)
    if not ln_equal:
        failed.append("ln_rows against the baseline prologue")

    for name, layout, m, n, k, epilogue in GEMMS:
        a, w, kw, matmul = _gemm_operands(gen, dev, layout, m, n, k,
                                          epilogue, name.endswith("+ln"))

        def mine():
            if layout == F:
                return cm.ln_gemm(a, w, kw.get("bias"), epilogue=epilogue,
                                  ln=kw.get("ln"),
                                  residual=kw.get("residual"),
                                  gelu_out=kw.get("gelu_out", False))
            return cm._gemm(a, w, m=m, n=n, k=k, layout=layout,
                            epilogue=epilogue, **kw)

        def theirs():
            return base.launch(layout, a, w, epilogue, **kw)

        rel = _rel_err(mine(), theirs())
        times = compare(theirs, mine, args.calls, args.reps)
        times["matmul_ms"] = compare(matmul, matmul, args.calls,
                                     args.reps)["ms"]
        # the card's time alone, in turns: baseline, this, matmul, matmul,
        # this, baseline
        b1, m1, t1, t2, m2, b2 = (graph_ms(f) for f in (
            theirs, mine, matmul, matmul, mine, theirs))
        times.update(device_ms=min(m1, m2), baseline_device_ms=min(b1, b2),
                     matmul_device_ms=min(t1, t2))
        flops = 2.0 * m * n * k
        rows.append({"gemm": name, "layout": layout, "epilogue": epilogue,
                     "shape": [m, n, k], "gflop": flops / 1e9,
                     "max_rel_err_vs_baseline": rel, **times})
        if not rel <= REL_TOL:
            failed.append(f"gemm {name}")
        print(f"gemm {name} layout {layout} ({m},{n},{k}): baseline "
              f"{times['baseline_ms']:.4g} ms, now {times['ms']:.4g} ms "
              f"({times['speedup']:.3g}x), matmul {times['matmul_ms']:.4g} "
              f"ms; device alone: baseline "
              f"{times['baseline_device_ms']:.4g}, now "
              f"{times['device_ms']:.4g} "
              f"({flops / times['device_ms'] / 1e9:.0f} TFLOP/s), matmul "
              f"{times['matmul_device_ms']:.4g}; against the baseline "
              f"{rel:.3g} of scale ({smi})", flush=True)

    for kernel, b, l, c, h in BLOCKS:
        hidden = 3 * c if kernel in ("K1", "K4") else 4 * c
        a = _inputs(gen, dev, b, l, c, hidden)
        for direction, (theirs, mine) in _block_cases(base, kernel, a,
                                                      h).items():
            rel = _rel_err(mine(), theirs())
            times = compare(theirs, mine, args.calls, args.reps)
            shape = [b, l, c] + ([h] if h else [])
            rows.append({"kernel": kernel, "direction": direction,
                         "shape": shape, "max_rel_err_vs_baseline": rel,
                         **times})
            if not rel <= REL_TOL:
                failed.append(f"{kernel} {direction} {shape}")
            print(f"{kernel} {direction} {shape}: baseline "
                  f"{times['baseline_ms']:.4g} ms, now {times['ms']:.4g} ms "
                  f"({times['speedup']:.3g}x); against the baseline "
                  f"{rel:.3g} of scale ({smi})", flush=True)
    print(json.dumps({"compare_gemm": rows, "card": smi,
                      "ln_rows_equal_to_baseline_prologue": ln_equal,
                      "ptxas": {"baseline": base_usage, "now": usage},
                      "calls_per_event_pair": args.calls, "reps": args.reps}))
    if failed:
        raise SystemExit("compare_gemm: disagrees with the baseline: "
                         + "; ".join(failed))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
