"""Build, load and launch the port's CUDA kernels.

Every source under `csrc/` is compiled by ONE `nvcc` call into one shared
library with a plain C interface (no PyTorch headers, so the build takes
seconds), at first use, into `_build/` beside this file (listed in
.gitignore).  The library's name carries a digest of the sources, so an
edited source is rebuilt.  It is loaded with ctypes; each C entry point
takes device pointers, sizes and the CUDA stream, launches its kernel on
that stream and returns `cudaGetLastError()`, which `launch` turns into an
exception.

Nothing here runs when the module is imported: the CPU tests import every
module, and the CPU has no nvcc.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path

import torch

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parent / "_build"
SOURCES = ("hull_sweep.cu", "newton_solve.cu", "chain_probe.cu", "chain_latency.cu",
           "span_mark.cu")
# -fmad=false: no multiply-add contraction, so every product and sum rounds
# as in the plain PyTorch versions' separate elementwise ops; with
# contraction on, the solver parted from its plain version far beyond the
# float32 noise floor (the line search has knife edges at rounding level)
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-fmad=false", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)

_lib = None
build_info = {}  # seconds, command, compiler output of the last build


def _nvcc():
    found = shutil.which("nvcc")
    if found:
        return found
    for cand in (os.environ.get("CUDA_HOME", ""), "/usr/local/cuda"):
        path = Path(cand) / "bin" / "nvcc"
        if cand and path.exists():
            return str(path)
    raise RuntimeError("nvcc not found: the CUDA kernels cannot be built")


def library():
    """The loaded kernel library, building it first if needed."""
    global _lib
    if _lib is None:
        _lib = _load(_build())
    return _lib


def _build() -> Path:
    srcs = [CSRC / s for s in SOURCES]
    digest = hashlib.sha256(b"".join(s.read_bytes() for s in srcs)
                            + " ".join(NVCC_FLAGS).encode()).hexdigest()[:16]
    out = BUILD_DIR / f"libgst_kernels_{digest}.so"
    if out.exists():
        build_info.update(seconds=0.0, cached=True, path=str(out))
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), *map(str, srcs)]
    t0 = time.perf_counter()
    res = subprocess.run(cmd, capture_output=True, text=True)
    seconds = time.perf_counter() - t0
    if res.returncode != 0:
        raise RuntimeError(
            f"nvcc failed ({res.returncode}):\n{' '.join(cmd)}\n{res.stdout}{res.stderr}"
        )
    os.replace(tmp, out)
    build_info.update(seconds=seconds, cached=False, path=str(out),
                      command=" ".join(cmd), log=res.stdout + res.stderr)
    return out


_P = ctypes.c_void_p
_I = ctypes.c_int
_F = ctypes.c_float
_SIGNATURES = {
    # p, R, verts, D, counts, i1, i2, out, G, ND, P, Vmax, Vtot, B, stream
    "gst_hull_sweep": ([_P] * 8 + [_I] * 6 + [_P], ctypes.c_int),
    # G, ND, P, Vtot, shape[3]
    "gst_hull_sweep_shape": ([_I] * 4 + [_P], None),
    # J, aref, D, aux, us, qMl, x0, warm, out,
    # nv, NE, neq, nf, nl, K, B, max_iters, ls_len, bracket_len, tol, stream
    "gst_newton_solve": ([_P] * 9 + [_I] * 10 + [_F, _P], ctypes.c_int),
    # nv, NE, neq, nf, nl, K, shape[3]
    "gst_newton_solve_shape": ([_I] * 6 + [_P], None),
    # q, v, M, out, n, B, stream
    "gst_chain_probe": ([_P] * 4 + [_I] * 2 + [_P], ctypes.c_int),
    # B, shape[3]
    "gst_chain_probe_shape": ([_I, _P], None),
    # in, out, res, kind, iters, stream (a measurement of the card)
    "gst_chain_latency": ([_P] * 3 + [_I] * 2 + [_P], ctypes.c_int),
    # span, stream (a stage mark of the trace, profiling.py)
    "gst_span_mark": ([_I, _P], ctypes.c_int),
}


def _load(path: Path):
    lib = ctypes.CDLL(str(path))
    for name, (argtypes, restype) in _SIGNATURES.items():
        fn = getattr(lib, name)
        fn.argtypes = argtypes
        fn.restype = restype
    return lib


def launch_shape(name, *sizes):
    """(envs per block, threads per block, bytes of dynamic shared memory)
    of kernel `name` at these sizes, from its C entry point `name_shape`."""
    shape = (ctypes.c_int * 3)()
    getattr(library(), f"{name}_shape")(*sizes, ctypes.cast(shape, ctypes.c_void_p))
    return tuple(shape)


def check(t: torch.Tensor, shape, dtype, name):
    """Raise unless `t` is a contiguous CUDA tensor of `shape` and `dtype`."""
    if t.device.type != "cuda":
        raise ValueError(f"{name}: expected a CUDA tensor, got {t.device}")
    if t.dtype != dtype:
        raise TypeError(f"{name}: expected {dtype}, got {t.dtype}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name}: expected shape {tuple(shape)}, got {tuple(t.shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name}: expected a contiguous tensor")


def launch(name, *args):
    """Call C entry point `name` with tensors passed as device pointers and
    Python ints/floats as they are, on the current CUDA stream."""
    fn = getattr(library(), name)
    conv = []
    for a in args:
        conv.append(a.data_ptr() if isinstance(a, torch.Tensor) else a)
    stream = torch.cuda.current_stream().cuda_stream
    err = fn(*conv, stream)
    if err != 0:
        raise RuntimeError(f"{name}: CUDA error {err} at launch")
