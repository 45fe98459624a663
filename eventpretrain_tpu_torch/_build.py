"""Build the port's CUDA kernels with ``nvcc`` and bind them with ``ctypes``.

Each ``csrc/<name>.cu`` compiles on its own into
``build/torch_kernels/lib<name>.so`` at the repository root (``build/`` is
git-ignored) for ``sm_90a``, and exports plain C launchers that take
pointers and the stream as ``void*`` and return a ``cudaError_t``. A
library is built at its first use, and rebuilt when its source or a shared
header is newer than it. :func:`build` starts one ``nvcc`` per stale source,
all at once, and waits for them.

There is no fallback: a missing ``nvcc``, a failed build or a failed load
raises. Nothing here runs at import time.
"""

from __future__ import annotations

import ctypes
import os
import re
import shutil
import subprocess
import threading
from pathlib import Path

_PKG = Path(__file__).resolve().parent
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG.parent / "build" / "torch_kernels"

_P = ctypes.c_void_p
_I = ctypes.c_int
_F = ctypes.c_float
_L = ctypes.c_longlong
# a strided (B, L, H, D) operand of csrc/mha.cu: pointer and four strides
_STRIDED = [_P, _L, _L, _L, _L]
# a (B, L, H, D) operand of csrc/mha.cu's one-pass route (onepass::Heads):
# pointer and its batch, row and head strides, columns contiguous
_HEADS = [_P, _L, _L, _L]

# Every exported launcher, with its C argument types (all return int).
SIGNATURES: dict[str, dict[str, list]] = {
    "splat": {"splat_f32": [_P, _P, _P, _P, _I, _I, _I, _I, _I, _P]},
    "splat_tiled": {
        "splat_tiled_f32": [_P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I,
                            _I, _I, _P],
    },
    "ln_gemm": {
        "gemm_bf16": [_P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I,
                      _I, _P],
    },
    "attention": {"attention_bf16": [_P, _P, _I, _I, _I, _I, _F, _P]},
    "attention_bwd": {
        "attention_bwd_bf16": [_P, _P, _P, _P, _I, _I, _I, _I, _F, _P],
    },
    "ln_bwd": {
        "ln_rows_bf16": [_P, _P, _P, _F, _P, _I, _I, _P],
        "ln_backward_bf16": [_P, _P, _F, _P, _P, _P, _P, _P, _P, _P, _I, _I,
                             _I, _I, _P],
        "colsum_bf16": [_P, _P, _P, _P, _I, _I, _I, _I, _P],
        "row_kernel_occupancy": [_I, _I],
    },
    "mha": {
        "mha_onepass_fwd_bf16": [*_HEADS * 4, _P, _I, _I, _I, _I, _F, _P],
        "mha_onepass_bwd_bf16": [*_HEADS * 7, _P, _I, _I, _I, _I, _F, _P],
        "mha_fwd_bf16": [*_STRIDED * 3, _P, _P, _I, _I, _I, _I, _F, _P],
        "mha_bwd_bf16": [*_STRIDED * 4, _P, _P, _P, _P, _P, _I, _I, _I, _I,
                         _F, _P],
    },
    "voxel_scatter": {
        "voxel_scatter_f32": [_P, _P, _P, _I, _I, _I, _I, _I, _I, _P],
    },
}

NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-Xptxas", "-v", "-shared", "-Xcompiler", "-fPIC",
)

_LOCK = threading.RLock()
_LIBS: dict[str, ctypes.CDLL] = {}


def nvcc_path() -> str:
    cand = Path(os.environ.get("CUDA_HOME", "/usr/local/cuda")) / "bin" / "nvcc"
    if cand.exists():
        return str(cand)
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError(
            "nvcc not found (looked in $CUDA_HOME/bin, /usr/local/cuda/bin "
            "and PATH); the port's CUDA kernels cannot be built"
        )
    return found


def lib_path(name: str) -> Path:
    return BUILD_DIR / f"lib{name}.so"


def _stale(name: str) -> bool:
    lib = lib_path(name)
    if not lib.exists():
        return True
    deps = [CSRC / f"{name}.cu", *CSRC.glob("*.cuh")]
    return lib.stat().st_mtime < max(d.stat().st_mtime for d in deps)


def build(names=tuple(SIGNATURES)) -> dict[str, str]:
    """Compile every stale library of ``names`` in parallel.

    Returns ``{name: compiler output}`` for the sources it compiled (with
    ``-Xptxas -v``: registers, shared memory and spills of each kernel).
    Raises ``RuntimeError`` with the compiler's output if any build fails.
    """
    with _LOCK:
        todo = [n for n in names if _stale(n)]
        if not todo:
            return {}
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        nvcc = nvcc_path()
        jobs = {}
        for name in todo:
            # compile to a private name, then rename: a concurrent reader
            # never sees a half-written library
            tmp = BUILD_DIR / f"lib{name}.{os.getpid()}.tmp.so"
            cmd = [nvcc, *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
            proc = subprocess.Popen(
                cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                text=True,
            )
            jobs[name] = (proc, tmp)
        logs, failed = {}, []
        for name, (proc, tmp) in jobs.items():
            logs[name] = proc.communicate()[0]
            if proc.returncode == 0:
                os.replace(tmp, lib_path(name))
            else:
                failed.append(name)
        if failed:
            raise RuntimeError(
                "nvcc failed for "
                + ", ".join(failed)
                + "\n"
                + "\n".join(logs[n] for n in failed)
            )
        return logs


def load(name: str) -> ctypes.CDLL:
    """The ``ctypes`` handle of ``lib<name>.so``, built first if needed."""
    with _LOCK:
        lib = _LIBS.get(name)
        if lib is not None:
            return lib
        build((name,))
        lib = ctypes.CDLL(str(lib_path(name)))
        for fn, argtypes in SIGNATURES[name].items():
            getattr(lib, fn).argtypes = argtypes
            getattr(lib, fn).restype = ctypes.c_int
        lib.kernel_error_string.argtypes = [ctypes.c_int]
        lib.kernel_error_string.restype = ctypes.c_char_p
        _LIBS[name] = lib
        return lib


def check(lib: ctypes.CDLL, fn: str, code: int) -> None:
    """Raise if a launcher returned a CUDA error code."""
    if code != 0:
        msg = lib.kernel_error_string(code).decode()
        raise RuntimeError(f"{fn}: CUDA error {code} ({msg})")


def ptxas_usage(source: str, text: str) -> dict:
    """Each kernel's registers, stack frame, spill bytes and static shared
    memory from ``nvcc -Xptxas -v``: its 'Function properties for <mangled
    name>' line, the stack and spill line after it, then its 'Used N
    registers, ..., M bytes smem' line. A
    kernel is named by the length-prefixed identifier ending in '_kernel'
    inside its mangled name, with its integer template arguments ('ILi13EE'
    -> '<13>', 'ILi0ELi3EE' -> '<0,3>') where it has them."""
    out, name, frame = {}, None, (0, 0, 0)
    for line in text.splitlines():
        m = re.search(r"Function properties for (\S+)", line)
        if m:
            mangled, name = m.group(1), None
            for n in re.finditer(r"(\d+)(?=[A-Za-z_])", mangled):
                ident = mangled[n.end():n.end() + int(n.group(1))]
                if ident.endswith("_kernel"):
                    args = re.match(r"I((?:Li\d+E)+)",
                                    mangled[n.end() + len(ident):])
                    name = ident + ("<" + ",".join(re.findall(
                        r"Li(\d+)E", args.group(1))) + ">" if args else "")
                    break
            continue
        m = re.search(r"(\d+) bytes stack frame, (\d+) bytes spill stores, "
                      r"(\d+) bytes spill loads", line)
        if m:
            frame = tuple(int(x) for x in m.groups())
            continue
        m = re.search(r"Used (\d+) registers", line)
        if m and name is not None:
            smem = re.search(r"(\d+) bytes smem", line)
            out[f"{source}:{name}"] = {
                "registers": int(m.group(1)), "stack_frame": frame[0],
                "spill_stores": frame[1], "spill_loads": frame[2],
                "static_smem": int(smem.group(1)) if smem else 0}
            name, frame = None, (0, 0, 0)
    return out
