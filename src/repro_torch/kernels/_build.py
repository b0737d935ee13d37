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
import functools
import hashlib
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path
from typing import Callable, Dict, Iterable, NamedTuple

import torch

CSRC = Path(__file__).resolve().parent.parent / "csrc"
# <repo>/src/repro_torch/kernels/_build.py -> <repo>/build/repro_torch
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "repro_torch"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")
SOURCES = ("mx_matmul", "mx_matmul_sparse", "mx_matmul_abft", "baseline_matmul",
           "mx_flash_decode", "mx_grouped_matmul", "mx_grouped_matmul_sparse",
           "mx_grouped_matmul_abft", "ssd_scan", "mx_flash_attention")

_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1, torch.int8: 2,
                torch.float8_e4m3fn: 3}  # csrc/common.cuh ReproDType
FLOATS = (torch.float32, torch.bfloat16)
QUANTIZED = (torch.int8, torch.float8_e4m3fn)  # payloads that carry f32 scales

_lock = threading.Lock()
_libs: Dict[str, ctypes.CDLL] = {}
NVCC_CPU_SECONDS: Dict[str, float] = {}  # per source built in this process


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
    _, status, usage = os.wait4(proc.pid, 0)  # nvcc and the tools it waited for
    proc.returncode = rc = os.waitstatus_to_exitcode(status)
    NVCC_CPU_SECONDS[name] = usage.ru_utime + usage.ru_stime
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
    that may be any of `allowed` (int8 / fp8 only as payloads with scales)."""
    if dtype not in allowed:
        names = " or ".join(str(t).removeprefix("torch.") for t in allowed)
        raise TypeError(f"{what}: the CUDA kernels take {names}, got {dtype}")
    return _DTYPE_CODES[dtype]


# (A, B) operand pairs of both GEMM kernels (csrc/mx_matmul.cu,
# csrc/mx_grouped_matmul.cu): the dense pairs and those that
# core/precision.NAMED_POLICIES produce from f32 or bf16 inputs
GEMM_PAIRS = (
    (torch.float32, torch.float32), (torch.bfloat16, torch.bfloat16),
    (torch.bfloat16, torch.int8), (torch.bfloat16, torch.float8_e4m3fn),
    (torch.int8, torch.int8), (torch.float8_e4m3fn, torch.float8_e4m3fn),
)


# the pairs of the 2:4 sparse variants (csrc/*_sparse.cu): "sparse24" on f32
# and bf16 models, "sparse24_int8"
SPARSE_PAIRS = (
    (torch.float32, torch.float32), (torch.bfloat16, torch.bfloat16),
    (torch.bfloat16, torch.int8),
)


def pair_codes(a: torch.Tensor, b: torch.Tensor, what: str, sparse: bool = False):
    """The dtype codes of a GEMM's (A, B) operands; TypeError for a pair
    the kernels (the 2:4 sparse variants with `sparse`) are not built for."""
    pairs = SPARSE_PAIRS if sparse else GEMM_PAIRS
    if (a.dtype, b.dtype) not in pairs:
        names = ", ".join(f"({str(x).removeprefix('torch.')}, "
                          f"{str(y).removeprefix('torch.')})" for x, y in pairs)
        kind = "2:4 sparse " if sparse else ""
        raise TypeError(f"{what}: operand pair ({a.dtype}, {b.dtype}) is not one the "
                        f"{kind}CUDA kernels take: {names}")
    return _DTYPE_CODES[a.dtype], _DTYPE_CODES[b.dtype]


# The one tile rule of the GEMM kernels: every launch takes its tile from
# this module (the launchers take these and refuse any other).  gemm_tile's
# (BM, BN, BK) are the CTA tiles of the 2:4 and ABFT variants
# (csrc/mx_matmul.cuh `dispatch`) at every M and of the dense kernels
# (csrc/mx_matmul.cu, csrc/baseline_matmul.cu) at M > 16; the ABFT flag
# map's grid, the fault operands' grid, abft_rtol and the plain versions'
# ABFT tiling all read them, on the CPU too.  The dense kernels' decode rows
# (M <= 16) launch decode_tile's.
def gemm_tile(M: int):
    """The MX GEMM's (BM, BN, BK) for M rows: decode (M <= 16, bytes
    bound: narrow tiles for more CTAs), a prefill chunk (M <= 64), larger
    M.  The tile the 2:4 and ABFT variants launch at every M, and the dense
    kernels at M > 16; it gives every ABFT flag map its grid.  The dense
    decode rows launch `decode_tile`'s loop instead."""
    if M <= 16:
        return 16, 16, 128
    if M <= 64:
        return 32, 64, 16
    return 64, 64, 16


SMS = 132                # streaming multiprocessors of the H100 SXM
SMEM_PER_CTA = 232448    # 227 KB: a CTA's dynamic shared memory, with the opt-in
SMEM_PER_SM = 233472     # 228 KB per SM, of which 1 KB per resident CTA is reserved
DECODE_MAX_M = 16        # rows that take the decode tile (csrc/decode_tile.cuh)
DECODE_MAX_THREADS = 512
DECODE_MIN_THREADS = 256   # copy issuers per CTA (threads past the outputs only copy)
DECODE_STAGE_BYTES = 32768  # weight bytes per ring stage (the weight's own width)
DECODE_IN_FLIGHT = 32768    # weight bytes the ring keeps in flight per SM
DECODE_MAX_STAGES = 8
COPY_BYTES = 16          # the widest copy (cp.async.cg)
DECODE_SUB = 64          # K rows per MAC block (csrc/decode_tile.cuh kDecodeSub)


class DecodeTile(NamedTuple):
    """The dense decode launch of csrc/mx_matmul.cu / baseline_matmul.cu."""
    bn: int       # output columns per CTA (a power of two, >= 16 bytes of weight)
    bk: int       # K rows per ring stage
    tm: int       # output rows per thread (divides M)
    vec: int      # copy width in bytes for 16-byte aligned rows
    stages: int   # ring slots
    threads: int  # per CTA: M / tm * bn compute, the rest (up to 256) only copy
    smem: int     # dynamic shared memory per CTA, bytes
    ctas: int     # ceil(N / bn)


def decode_slot_bytes(M: int, bn: int, bk: int, ea: int, eb: int, gated: bool) -> int:
    """One ring slot of csrc/decode_tile.cuh (`decode_slot`): A's M rows of
    bk elements padded by 16 bytes, B's (and the gate's) bk x bn tile."""
    return M * (bk * ea + 16) + bk * bn * eb * (2 if gated else 1)


def _waves_used(ctas: int) -> float:
    """The share of the SMs' CTA slots a grid fills in its last wave."""
    return ctas / (-(-ctas // SMS) * SMS)


@functools.lru_cache(maxsize=None)  # a pure function of the launch's shape
def decode_tile(M: int, N: int, a_dtype: torch.dtype, b_dtype: torch.dtype,
                gated: bool = False) -> DecodeTile:
    """The dense GEMMs' decode tile for M <= 16 rows (csrc/decode_tile.cuh).

    - bn, the columns per CTA: from one 16-byte copy per weight row (4 f32,
      8 bf16, 16 int8 / fp8), doubled up to 64 while the wider strip still
      gives about one CTA per SM (ceil(N / bn) >= 0.9 * SMS) and fills at
      least 80% of the last wave's slots, and M * bn stays within 512
      threads at the largest tm M allows; then halved while the ring would
      hold fewer than 4 stages;
    - bk, the K rows per ring stage: DECODE_STAGE_BYTES of weight (both
      matrices when gated), between one 64-row MAC block and 512 rows, so
      a narrow weight takes deeper K steps for the same bytes; halved while
      fewer than 4 slots fit (A's M rows take the rest of a slot);
    - stages: the fewest, from 4, that keep DECODE_IN_FLIGHT bytes of
      weight in flight per SM (stages - 1 of them, in each CTA an SM holds
      at once: ceil(ctas / SMS), at most 2, since a larger grid runs in
      waves), as shared memory allows, at most DECODE_MAX_STAGES;
    - tm, the rows per thread: the smallest of 1, 2, 4 that divides M and
      keeps M / tm * bn <= 256 computing threads (else the largest that
      divides M); each computing thread owns one column, so none computes a
      padding row;
    - threads: those that compute, and copy-only threads up to
      DECODE_MIN_THREADS, so the ring's copies are issued by many warps.

    The constants (about one CTA per SM, 32 KB stages, 4 stages, 256
    threads) are those that timed best on an H100 among candidate tiles at
    llama3.2-1b's and zamba2-2.7b's decode shapes.
    """
    if not 1 <= M <= DECODE_MAX_M:
        raise ValueError(f"the decode tile takes 1 <= M <= {DECODE_MAX_M}, got {M}")
    ea, eb = a_dtype.itemsize, b_dtype.itemsize
    mats = 2 if gated else 1
    tm_max = max(t for t in (1, 2, 4) if M % t == 0)
    narrowest = COPY_BYTES // eb
    bn = narrowest
    while (bn < 64 and -(-N // (2 * bn)) >= 0.9 * SMS
           and _waves_used(-(-N // (2 * bn))) >= 0.8
           and M // tm_max * 2 * bn <= DECODE_MAX_THREADS):
        bn *= 2

    def ring(bn):  # (bk, stages) of a bn-wide strip
        ctas = -(-N // bn)
        resident = min(-(-ctas // SMS), 2)  # CTAs an SM holds at once
        budget = min(SMEM_PER_CTA, SMEM_PER_SM // resident - 1024)

        def fits(bk):  # slots that fit the budget
            slot = decode_slot_bytes(M, bn, bk, ea, eb, gated)
            return min(DECODE_MAX_STAGES, budget // slot)

        bk = min(512, max(DECODE_SUB, DECODE_STAGE_BYTES // (bn * eb * mats)))
        while bk > DECODE_SUB and fits(bk) < 4:  # A's rows crowd the ring
            bk //= 2
        stage = bk * bn * eb * mats * resident  # weight bytes per stage and SM
        want = max(4, 1 + -(-DECODE_IN_FLIGHT // stage))
        return bk, min(want, fits(bk))

    bk, stages = ring(bn)
    while stages < 4 and bn > narrowest:  # a narrower strip for a 4-deep ring
        bn //= 2
        bk, stages = ring(bn)
    tm = next((t for t in (1, 2, 4) if M % t == 0 and M // t * bn <= 256), tm_max)
    smem = stages * decode_slot_bytes(M, bn, bk, ea, eb, gated)
    threads = max(M // tm * bn, DECODE_MIN_THREADS)
    return DecodeTile(bn, bk, tm, COPY_BYTES, stages, threads, smem, -(-N // bn))


def copy_width(row_bytes: int, *addresses: int, vec: int = COPY_BYTES) -> int:
    """The widest copy, in bytes (a power of two up to `vec`), that divides
    a row's bytes and every base address given: 16 for aligned operands;
    a ragged row (K or N off 16 bytes) or a misaligned base takes the
    narrow copies (8 or 4 bytes by cp.async, 2 or 1 by plain loads) in the
    same kernel."""
    v = vec
    while v > 1 and (row_bytes % v or any(p % v for p in addresses)):
        v //= 2
    return v


def grouped_tile(T: int, G: int):
    """The grouped GEMM's tile, by the mean rows per group T / G (the rows
    one expert's weights are streamed for), as the JAX dispatch plans for
    max(T // G, 1)."""
    mean = T // max(G, 1)
    if mean <= 8:
        return 8, 128, 32
    if mean <= 64:
        return 32, 64, 16
    return 64, 64, 16


def stream_ptr(t: torch.Tensor) -> int:
    """PyTorch's current stream on t's device, as the raw cudaStream_t."""
    return torch.cuda.current_stream(t.device).cuda_stream
