"""Lazy `nvcc` build of the port's CUDA sources, loaded through `ctypes`.

Each `csrc/<name>.cu` exposes a plain C interface (`extern "C"` launchers
that take device pointers, sizes and the CUDA stream, and return
`cudaGetLastError()`).  It is compiled at first use for `sm_90a` into a
shared library under `<repo>/build/repro_torch/`, named by a hash of the
source and the flags so an edited source never reuses a stale library.
Importing this module needs no `nvcc`: nothing is compiled until a kernel
is launched on a CUDA tensor (or `build_all` is called).
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path
from typing import Callable, Dict, Iterable

import torch

CSRC = Path(__file__).resolve().parent.parent / "csrc"
# <repo>/src/repro_torch/kernels/_build.py -> <repo>/build/repro_torch
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "repro_torch"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")
SOURCES = ("mx_matmul", "baseline_matmul", "mx_flash_decode")

_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1, torch.int8: 2}  # csrc/common.cuh
FLOATS = (torch.float32, torch.bfloat16)

_lock = threading.Lock()
_libs: Dict[str, ctypes.CDLL] = {}


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    cand = Path(os.environ.get("CUDA_HOME", "/usr/local/cuda")) / "bin" / "nvcc"
    if cand.exists():
        return str(cand)
    raise RuntimeError("nvcc not found (PATH, $CUDA_HOME/bin, /usr/local/cuda/bin)"
                       ": the CUDA kernels are built from csrc/ at first use")


def _target(name: str) -> Path:
    h = hashlib.sha256((CSRC / f"{name}.cu").read_bytes())
    for header in sorted(CSRC.glob("*.cuh")):
        h.update(header.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"{name}-{h.hexdigest()[:16]}.so"


def _start(name: str):
    """Start one nvcc for `name`; returns (target, tmp, log, Popen) or None
    when the library is already built."""
    out = _target(name)
    if out.exists():
        return None
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    log = out.with_suffix(".log")
    cmd = [_nvcc(), *NVCC_FLAGS, "-I", str(CSRC), "-o", str(tmp),
           str(CSRC / f"{name}.cu")]
    with open(log, "w") as fh:
        proc = subprocess.Popen(cmd, stdout=fh, stderr=subprocess.STDOUT)
    return out, tmp, log, proc


def _finish(name: str, job) -> None:
    out, tmp, log, proc = job
    rc = proc.wait()
    if rc != 0:
        raise RuntimeError(f"nvcc failed for csrc/{name}.cu (rc={rc}):\n"
                           + log.read_text()[-4000:])
    os.replace(tmp, out)


def build_all(names: Iterable[str] = SOURCES) -> float:
    """Build every named source in parallel (one nvcc each, all started
    together); returns the wall seconds spent."""
    t0 = time.perf_counter()
    with _lock:
        jobs = {n: _start(n) for n in names}
        for n, job in jobs.items():
            if job is not None:
                _finish(n, job)
    return time.perf_counter() - t0


def ptxas_report(name: str) -> str:
    """The `-Xptxas -v` lines (registers, shared memory, spills) of the
    last build of `name`, empty if it was built in an earlier process."""
    log = _target(name).with_suffix(".log")
    return log.read_text() if log.exists() else ""


def load(name: str) -> ctypes.CDLL:
    """The loaded shared library for csrc/<name>.cu, built if needed."""
    lib = _libs.get(name)
    if lib is not None:
        return lib
    build_all([name])
    with _lock:
        lib = _libs.get(name)
        if lib is None:
            lib = ctypes.CDLL(str(_target(name)))
            lib.repro_cuda_error_string.argtypes = [ctypes.c_int]
            lib.repro_cuda_error_string.restype = ctypes.c_char_p
            _libs[name] = lib
    return lib


def function(name: str, symbol: str, argtypes, restype=ctypes.c_int) -> Callable:
    """C function `symbol` of csrc/<name>.cu with its argument types set
    (c_void_p for every pointer and the stream, so none is cut to 32 bits);
    a launcher's result is its cudaError_t (int)."""
    fn = getattr(load(name), symbol)
    if fn.argtypes is None:
        fn.argtypes = list(argtypes)
        fn.restype = restype
    return fn


def check(err: int, name: str, what: str) -> None:
    """Raise on a non-zero cudaError_t returned by a C launcher."""
    if err != 0:
        msg = load(name).repro_cuda_error_string(err).decode()
        raise RuntimeError(f"{what}: CUDA launch failed: {msg} ({err})")


def dtype_code(dtype: torch.dtype, what: str, allowed=FLOATS) -> int:
    """The kernels' dtype code (csrc/common.cuh ReproDType) of an operand
    that may be any of `allowed` (int8 only for KV pages, with scales)."""
    if dtype not in allowed:
        names = " or ".join(str(t).removeprefix("torch.") for t in allowed)
        raise TypeError(f"{what}: the CUDA kernels take {names}, got {dtype}")
    return _DTYPE_CODES[dtype]


def stream_ptr(t: torch.Tensor) -> int:
    """PyTorch's current stream on t's device, as the raw cudaStream_t."""
    return torch.cuda.current_stream(t.device).cuda_stream
