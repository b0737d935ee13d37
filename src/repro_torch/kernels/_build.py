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
_libs: Dict[tuple, ctypes.CDLL] = {}
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


def _target(name: str, defines: tuple = ()) -> Path:
    """The library of csrc/<name>.cu, or of a timing variant of it compiled
    with `defines` (macros such as PREFILL_TIMING_NO_PRODUCTS, never set by
    the package's own launches)."""
    h = hashlib.sha256((CSRC / f"{name}.cu").read_bytes())
    for header in sorted(CSRC.glob("*.cuh")):
        h.update(header.read_bytes())
    h.update(" ".join(NVCC_FLAGS + tuple(defines)).encode())
    tag = "".join(f"+{d}" for d in defines)
    return BUILD_DIR / f"{name}{tag}-{h.hexdigest()[:16]}.so"


def _start(name: str, defines: tuple = ()):
    """Start one nvcc for `name`; returns (target, tmp, log, Popen) or None
    when the library is already built."""
    out = _target(name, defines)
    if out.exists():
        return None
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    log = out.with_suffix(".log")
    cmd = [_nvcc(), *NVCC_FLAGS, *(f"-D{d}" for d in defines), "-I", str(CSRC), "-o",
           str(tmp), str(CSRC / f"{name}.cu")]
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


def build_all(names: Iterable[str] = SOURCES, variants: Iterable = ()) -> float:
    """Build every named source, and every (name, defines) timing variant,
    in parallel (one nvcc each, all started together); returns the wall
    seconds spent."""
    t0 = time.perf_counter()
    with _lock:
        jobs = {(n, ()): _start(n) for n in names}
        jobs.update({(n, tuple(d)): _start(n, tuple(d)) for n, d in variants})
        for (n, d), job in jobs.items():
            if job is not None:
                _finish(n + "".join(f"+{m}" for m in d), job)
    return time.perf_counter() - t0


def ptxas_report(name: str) -> str:
    """The `-Xptxas -v` lines (registers, shared memory, spills) of the
    last build of `name`, empty if it was built in an earlier process."""
    log = _target(name).with_suffix(".log")
    return log.read_text() if log.exists() else ""


def load(name: str, defines: tuple = ()) -> ctypes.CDLL:
    """The loaded shared library for csrc/<name>.cu (or its timing variant
    with `defines`), built if needed."""
    key = (name, tuple(defines))
    lib = _libs.get(key)
    if lib is not None:
        return lib
    build_all([] if defines else [name], [key] if defines else [])
    with _lock:
        lib = _libs.get(key)
        if lib is None:
            lib = ctypes.CDLL(str(_target(name, tuple(defines))))
            lib.repro_cuda_error_string.argtypes = [ctypes.c_int]
            lib.repro_cuda_error_string.restype = ctypes.c_char_p
            _libs[key] = lib
    return lib


def function(name: str, symbol: str, argtypes, restype=ctypes.c_int,
             defines: tuple = ()) -> Callable:
    """C function `symbol` of csrc/<name>.cu (or of its timing variant with
    `defines`) with its argument types set (c_void_p for every pointer and
    the stream, so none is cut to 32 bits); a launcher's result is its
    cudaError_t (int)."""
    fn = getattr(load(name, defines), symbol)
    if fn.argtypes is None:
        fn.argtypes = list(argtypes)
        fn.restype = restype
    return fn


def check(err: int, name: str, what: str) -> None:
    """Raise on a non-zero cudaError_t returned by a C launcher."""
    if err != 0:
        msg = load(name).repro_cuda_error_string(err).decode()
        raise RuntimeError(f"{what}: CUDA launch failed: {msg} ({err})")


def refuse_grad(entry: str, *operands) -> None:
    """Raise when autograd would need a kernel's gradient: a kernel writes
    its output through raw pointers, so the output has no `grad_fn`, and a
    backward pass would give every operand behind it no gradient, silently.
    The kernels have no backward (JAX's Pallas kernels cannot be
    differentiated either); training runs the "torch" backend.  Checked
    before the device, so the plain versions on CPU tensors refuse alike."""
    if torch.is_grad_enabled() and any(isinstance(t, torch.Tensor) and t.requires_grad
                                       for t in operands):
        raise RuntimeError(
            f"{entry}: an operand requires grad in a grad-enabled region, and the kernel "
            "has no backward; differentiate through the \"torch\" backend "
            "(core.ops.MXPolicy(\"torch\"), as launch.steps.make_train_step does), or "
            "run under torch.no_grad()")


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
# (BM, BN, BK): at every M the ABFT flag map's grid, the fault operands'
# grid, abft_rtol and the plain versions' ABFT tiling, on the CPU too; at
# M > 16 the ABFT prefill launch's CTA tile.  The decode rows (M <= 16) of
# every variant launch decode_tile's; the rows at M > 16 of every pair and
# variant launch prefill_tile's, whose CTA tile is a whole multiple of
# gemm_tile's (the ABFT variant's is gemm_tile's).
def gemm_tile(M: int):
    """The MX GEMM's (BM, BN, BK) for M rows: decode (M <= 16), a prefill
    chunk (M <= 64), larger M.  Every ABFT flag map takes its grid from
    (BM, BN) -- at M <= 16 one row of 16-column tiles, which the decode
    tile's ABFT launch flags -- and the ABFT prefill launch (M > 16) its
    CTA tile.  BK is the plain version's ABFT step, and no launch's."""
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
DECODE_VARIANTS = ("dense", "sparse", "abft")
ABFT_FLAG_COLS = 16      # an ABFT flag tile's columns at M <= 16 (gemm_tile)
ABFT_HOOK_THREADS = 128  # the ABFT checksums' own warps (csrc/decode_tile.cuh), at least


class DecodeTile(NamedTuple):
    """The decode launch (M <= 16) of csrc/mx_matmul*.cu / baseline_matmul.cu."""
    bn: int       # output columns per CTA (a power of two, >= 16 bytes of weight)
    bk: int       # K rows per ring stage
    tm: int       # output rows per thread (divides M)
    vec: int      # copy width in bytes for 16-byte aligned rows
    stages: int   # ring slots
    threads: int  # per CTA: M / tm * bn compute, the rest (up to 256) only copy
    smem: int     # dynamic shared memory per CTA, bytes
    ctas: int     # ceil(N / bn)


def decode_slot_bytes(M: int, bn: int, bk: int, ea: int, eb: int, gated: bool,
                      variant: str = "dense") -> int:
    """One ring slot of csrc/decode_tile.cuh (`decode_slot`): A's M rows of
    bk elements padded by 16 bytes, and B's (and the gate's) bk x bn tile
    -- for "sparse" the payload's bk/2 x bn tile in its own width and the
    metadata's bk/8 x bn bytes."""
    mats = 2 if gated else 1
    if variant == "sparse":
        weight = (bk // 2) * bn * eb + (bk // 8) * bn
    else:
        weight = bk * bn * eb
    return M * (bk * ea + 16) + mats * weight


def decode_threads(M: int, bn: int, variant: str = "dense", gated: bool = False,
                   eb: int = 4):
    """(tm, threads) of a decode CTA of M rows and bn columns (a weight of
    eb-byte elements): tm, the rows per thread, the smallest of 1, 2, 4
    that divides M and keeps M / tm * bn <= 256 computing threads (else the
    largest that divides M) -- for "sparse", whose expansion of each K row
    feeds all of a thread's rows, the largest that divides M up to 4
    gated, 2 for an f32 or int8 payload, 1 for bf16 (as timed best on an
    H100 at llama3.2-1b's decode projections), within 256 computing
    threads where M allows;
    threads, those that compute and copy-only threads up to
    DECODE_MIN_THREADS -- for "abft" at least ABFT_HOOK_THREADS past the
    computing threads' last warp, which keep the checksums."""
    tm_max = max(t for t in (1, 2, 4) if M % t == 0)
    tm = next((t for t in (1, 2, 4) if M % t == 0 and M // t * bn <= 256), tm_max)
    if variant == "sparse":
        want = 4 if gated else 1 if eb == 2 else 2
        fit = [t for t in (1, 2, 4) if M % t == 0 and M // t * bn <= 256] or [tm_max]
        tm = max((t for t in fit if t <= want), default=fit[0])
    compute = M // tm * bn
    if variant == "abft":
        return tm, max(-(-compute // 32) * 32 + ABFT_HOOK_THREADS, DECODE_MIN_THREADS)
    return tm, max(compute, DECODE_MIN_THREADS)


def decode_abft_bytes(M: int, bn: int, bk: int) -> int:
    """The ABFT checksums' scratch after a decode ring
    (csrc/decode_tile.cuh `decode_abft_bytes`): a staged step's colsum(A)
    and rowsum(B) per 16-column flag tile with their |.|-sums, or after the
    loop the hook threads' partial checksums (4 columns' and one row
    item's each) and the accumulator's sums."""
    nt = bn // ABFT_FLAG_COLS
    threads = decode_threads(M, bn, "abft")[1]
    return 4 * max(bk * (2 + 2 * nt), 10 * threads + M * bn + M * nt + nt)


def decode_smem(M: int, bn: int, bk: int, ea: int, eb: int, stages: int, gated: bool,
                variant: str = "dense") -> int:
    """A decode launch's dynamic shared memory (csrc/decode_tile.cuh
    `decode_smem`): the ring, and after it the ABFT scratch."""
    return stages * decode_slot_bytes(M, bn, bk, ea, eb, gated, variant) + _decode_extra(
        M, bn, bk, variant)


def _decode_extra(M: int, bn: int, bk: int, variant: str) -> int:
    return decode_abft_bytes(M, bn, bk) if variant == "abft" else 0


def _waves_used(ctas: int) -> float:
    """The share of the SMs' CTA slots a grid fills in its last wave."""
    return ctas / (-(-ctas // SMS) * SMS)


@functools.lru_cache(maxsize=None)  # a pure function of the launch's shape
def decode_tile(M: int, N: int, a_dtype: torch.dtype, b_dtype: torch.dtype,
                gated: bool = False, variant: str = "dense") -> DecodeTile:
    """The GEMMs' decode tile for M <= 16 rows (csrc/decode_tile.cuh), for
    kernel 1's "dense", "sparse" (b_dtype the 2:4 payload's) or "abft"
    launch; kernel 2's is the dense one.

    - bn, the columns per CTA: from one 16-byte copy per weight row (4 f32,
      8 bf16, 16 int8 / fp8; "abft" at least one 16-column flag tile),
      doubled up to 64 while the wider strip still gives about one CTA per
      SM (ceil(N / bn) >= 0.9 * SMS) and fills at least 80% of the last
      wave's slots, and M * bn (and the ABFT checksums' warps) stay within
      512 threads at the largest tm M allows; then halved while the ring
      would hold fewer than 4 stages;
    - bk, the K rows per ring stage: the most (a power of two) whose weight
      bytes -- both matrices when gated; payload and metadata for "sparse"
      -- stay within DECODE_STAGE_BYTES, between one 64-row MAC block and
      512 rows, so a narrow or compressed weight takes deeper K steps for
      the same bytes; halved while fewer than 4 slots fit (A's M rows, and
      for "abft" the checksums' scratch, take the rest);
    - stages: the fewest, from 4, that keep DECODE_IN_FLIGHT bytes of
      weight in flight per SM (stages - 1 of them, in each CTA an SM holds
      at once: ceil(ctas / SMS), at most 2, since a larger grid runs in
      waves), as shared memory allows, at most DECODE_MAX_STAGES;
    - tm and threads: `decode_threads`; each computing thread owns one
      column, so none computes a padding row, and the threads past them
      only issue the ring's copies.

    The constants (about one CTA per SM, 32 KB stages, 4 stages, 256
    threads) are those that timed best on an H100 among candidate tiles at
    llama3.2-1b's and zamba2-2.7b's decode shapes.
    """
    if not 1 <= M <= DECODE_MAX_M:
        raise ValueError(f"the decode tile takes 1 <= M <= {DECODE_MAX_M}, got {M}")
    if variant not in DECODE_VARIANTS:
        raise ValueError(f"variant must be one of {DECODE_VARIANTS}, got {variant!r}")
    ea, eb = a_dtype.itemsize, b_dtype.itemsize
    mats = 2 if gated else 1
    tm_max = max(t for t in (1, 2, 4) if M % t == 0)
    narrowest = COPY_BYTES // eb
    hook = 0  # the ABFT checksums' own threads
    if variant == "abft":
        narrowest, hook = max(narrowest, ABFT_FLAG_COLS), ABFT_HOOK_THREADS
    bn = narrowest
    while (bn < 64 and -(-N // (2 * bn)) >= 0.9 * SMS
           and _waves_used(-(-N // (2 * bn))) >= 0.8
           and M // tm_max * 2 * bn + hook <= DECODE_MAX_THREADS):
        bn *= 2

    def ring(bn):  # (bk, stages) of a bn-wide strip
        ctas = -(-N // bn)
        resident = min(-(-ctas // SMS), 2)  # CTAs an SM holds at once
        budget = min(SMEM_PER_CTA, SMEM_PER_SM // resident - 1024)

        def row_bytes(bk):  # weight bytes per K row of one matrix
            return decode_slot_bytes(0, bn, bk, ea, eb, False, variant) / bk

        def fits(bk):  # slots that fit the budget
            slot = decode_slot_bytes(M, bn, bk, ea, eb, gated, variant)
            free = budget - _decode_extra(M, bn, bk, variant)
            return min(DECODE_MAX_STAGES, free // slot)

        bk = DECODE_SUB
        while bk < 512 and 2 * bk * row_bytes(2 * bk) * mats <= DECODE_STAGE_BYTES:
            bk *= 2
        while bk > DECODE_SUB and fits(bk) < 4:  # A's rows crowd the ring
            bk //= 2
        stage = bk * row_bytes(bk) * mats * resident  # weight bytes per stage and SM
        want = max(4, 1 + -(-DECODE_IN_FLIGHT // int(stage)))
        return bk, min(want, fits(bk))

    bk, stages = ring(bn)
    while stages < 4 and bn > narrowest:  # a narrower strip for a 4-deep ring
        bn //= 2
        bk, stages = ring(bn)
    tm, threads = decode_threads(M, bn, variant, gated, eb)
    smem = decode_smem(M, bn, bk, ea, eb, stages, gated, variant)
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


# The tensor-core prefill tile (csrc/prefill_tile.cuh): the operand pairs
# it takes -- every pair of the GEMMs: f32 (3xTF32), bf16, an int8 or e4m3
# weight beside bf16 activations widened to bf16 in shared memory, int8 x
# int8 and e4m3 x e4m3 both in their own byte (the s8 m16n8k32 MMA; e4m3
# widened exactly to f16 in registers) -- its CTA tiles (bm,
# bn), largest first (2 x bn / 32 warps of (bm / 2) x 32 outputs), and its
# K parts.
MMA_PAIRS = GEMM_PAIRS
PREFILL_TILES = ((64, 128), (64, 64), (32, 64))
PREFILL_VARIANTS = ("dense", "sparse", "abft", "baseline")
PREFILL_STAGE_ROW = 128   # bytes of each A row per ring stage: BK = 32 f32, 64 bf16, 128 8-bit
PREFILL_PART_ROWS = 512   # K rows per part at least
PREFILL_MAX_PARTS = 8     # a portable cluster
PREFILL_MAX_STAGES = 4
PREFILL_SPLIT_BELOW = 1.5  # split K across a cluster below this many tiles per SM
PREFILL_ABFT_STATIC = 2048  # the ABFT checksums' static shared memory (at most, bk <= 64)
BYTE_ROW_PAD = 32         # bytes past an 8-bit B row's bn (csrc/prefill_tile.cuh kBStride)
# int8 x int8 sums exactly in int32: |sum| <= K * 127^2 < 2^31 for K < 133,143
# (csrc/gemm_tile.cuh's note)
INT8_MAX_K = 133_142


def prefill_abft_static(bk: int) -> int:
    """The ABFT checksums' static shared memory beside a prefill ring (at
    most): csrc/abft_tile.cuh AbftPrefillHook::Sm of a 64 x 64 tile, four
    f32 sums per row and column and four per K row of a stage."""
    return max(PREFILL_ABFT_STATIC, 1024 + 16 * bk)


def check_int8_k(a_dtype: torch.dtype, b_dtype: torch.dtype, K: int, what: str) -> None:
    """Refuse an int8 x int8 launch whose exact int32 sums could pass 2^31
    (K > INT8_MAX_K): the kernels' sums would wrap where JAX's dot_f32
    would not."""
    if a_dtype == b_dtype == torch.int8 and K > INT8_MAX_K:
        raise ValueError(f"{what}: int8 x int8 sums in int32 hold K <= {INT8_MAX_K} "
                         f"(K * 127^2 < 2^31), got K={K}")


class PrefillTile(NamedTuple):
    """The M > 16 launch of the GEMMs: route "mma" (csrc/prefill_tile.cuh)
    for every pair."""
    route: str    # "mma"
    bm: int       # CTA tile rows (a multiple of gemm_tile(M)[0])
    bn: int       # CTA tile columns (a multiple of gemm_tile(M)[1])
    bk: int       # K rows per ring stage
    stages: int   # ring slots
    split: int    # CTAs per cluster: 1, or `parts` (one part each)
    parts: int    # equal K parts, each summed from zero, folded in order
    threads: int  # per CTA
    smem: int     # dynamic shared memory per CTA, bytes
    ctas: int     # CTAs of the grid (tiles x split)


def prefill_parts(K: int, bk: int) -> int:
    """The K parts of the prefill tile: the largest power of two up to
    PREFILL_MAX_PARTS that leaves every part at least PREFILL_PART_ROWS
    rows and divides the K steps.  A function of K and the pair's bk only,
    so every launch at one K -- dense, 2:4, ABFT, any M, N or tile, a
    recomputed ABFT tile -- sums the same parts in the same order and gets
    the same bits."""
    steps = -(-K // bk)
    p = PREFILL_MAX_PARTS
    while p > 1 and (p * PREFILL_PART_ROWS > K or steps % p):
        p //= 2
    return p


def prefill_slot_bytes(bm: int, bn: int, bk: int, ea: int, eb: int, gated: bool,
                       sparse: bool) -> int:
    """One ring slot of csrc/prefill_tile.cuh (`PrefillCfg::kSlot`): A's bm
    rows of bk elements (ea bytes each) padded by 16 bytes, B's (and the
    gate's) bk rows of bn + 8 elements in A's type (8-bit pairs: bn bytes
    and BYTE_ROW_PAD), and the raw rows they come from when they are 2:4
    payloads (with metadata) or narrower than A (eb < ea).  A narrow dense
    weight on a 16-row tile is widened in registers (`kRegWiden`): its raw
    rows alone, padded by 16 bytes."""
    mats = 2 if gated else 1
    a = bm * (bk * ea + 16)
    if ea == 1:  # int8 x int8, e4m3 x e4m3: both in their own byte
        return a + mats * bk * (bn + BYTE_ROW_PAD)
    if sparse:
        raw = (bk // 2) * bn * eb + (bk // 8) * bn
    elif eb != ea and bm == 16:
        return a + mats * bk * (bn * eb + 16)
    else:
        raw = bk * bn * eb if eb != ea else 0
    return a + mats * (bk * (bn + 8) * ea + raw)


def prefill_smem(bm: int, bn: int, bk: int, ea: int, eb: int, stages: int, split: int,
                 parts: int, gated: bool, sparse: bool, epilogue: bool = True) -> int:
    """A launch's dynamic shared memory (csrc/prefill_tile.cuh
    `prefill_smem`): the ring, and the tile Cs (and the gate's; f32, or
    int32 for int8 x int8), which has its own room only when one CTA folds
    several parts."""
    ring = stages * prefill_slot_bytes(bm, bn, bk, ea, eb, gated, sparse)
    if not epilogue:
        return ring
    cs = bm * (bn + 8) * 4 * (2 if gated else 1)
    return ring + cs if split == 1 and parts > 1 else max(ring, cs)


@functools.lru_cache(maxsize=None)  # a pure function of the launch's shape
def prefill_tile(M: int, N: int, K: int, a_dtype: torch.dtype, b_dtype: torch.dtype,
                 gated: bool = False, variant: str = "dense") -> PrefillTile:
    """The GEMMs' tile for M > 16 rows: every pair takes the tensor-core
    loop (route "mma"; int8 x int8 and e4m3 x e4m3 in their own byte):
    - parts: `prefill_parts(K, bk)`, bk = 128 bytes of A row per stage;
    - a small grid (fewer than PREFILL_SPLIT_BELOW * SMS tiles of 64 x 64,
      or 32 x 64 for M <= 32): those tiles, each part its own CTA in a
      cluster of `parts` (the dense and 2:4 variants; the baseline, which
      cannot split, takes 32 x 64 tiles when 64 x 64 ones leave SMs idle);
    - a large grid: 64 x 128 tiles (the small ones where 64 x 128 leaves
      no room for a ring of 3), one CTA walking all parts;
    - the ABFT variant: gemm_tile's own CTA tile, one CTA per flag, split 1;
    - stages: up to PREFILL_MAX_STAGES, as many as fit two CTAs per SM
      (at least 3) when the grid has more CTAs than SMs, else one.
    Every CTA tile is a whole multiple of gemm_tile(M)'s (bm, bn).  The
    thresholds are those that timed best on an H100 among the tiles of
    PREFILL_TILES at llama3.2-1b's and zamba2-2.7b's shapes, M = 64 to 2048
    (PERF.md section 6).
    """
    if M <= DECODE_MAX_M:
        raise ValueError(f"the prefill tile takes M > {DECODE_MAX_M}, got {M}")
    if variant not in PREFILL_VARIANTS:
        raise ValueError(f"variant must be one of {PREFILL_VARIANTS}, got {variant!r}")
    gm, gn, _ = gemm_tile(M)
    if (a_dtype, b_dtype) not in MMA_PAIRS:
        raise ValueError(f"no prefill tile for the pair ({a_dtype}, {b_dtype})")
    e, eb = a_dtype.itemsize, b_dtype.itemsize
    bk = PREFILL_STAGE_ROW // e
    baseline = variant == "baseline"  # no parts, no Cs: its partials go to the output
    parts = 1 if baseline else prefill_parts(K, bk)
    sparse = variant == "sparse"

    def tiles(bm, bn):
        return -(-M // bm) * -(-N // bn)

    small = (32, 64) if M <= 32 else (64, 64)
    if variant == "abft":
        (bm, bn), split = (gm, gn), 1
    elif tiles(*small) >= PREFILL_SPLIT_BELOW * SMS:
        (bm, bn), split = (64, 128), 1
    elif baseline:
        (bm, bn), split = (small if tiles(*small) >= SMS else (gm, gn)), 1
    else:
        (bm, bn), split = small, parts
    reserve = prefill_abft_static(bk) if variant == "abft" else 0

    def ring(bm, bn, split):  # the most stages that fit, two CTAs per SM first
        for budget in ((SMEM_PER_SM // 2 - 1024 - reserve) if tiles(bm, bn) * split > SMS
                       else 0, SMEM_PER_CTA - reserve):
            stages = max((s for s in range(2, PREFILL_MAX_STAGES + 1)
                          if prefill_smem(bm, bn, bk, e, eb, s, split, parts, gated,
                                          sparse, not baseline) <= budget), default=0)
            if stages >= 3:
                break
        return stages

    stages = ring(bm, bn, split)
    if stages < 3 and (bm, bn) == (64, 128):  # a gated 2:4 slot: the narrower tile
        (bm, bn) = small
        stages = ring(bm, bn, split)
    ctas = tiles(bm, bn) * split
    if stages < 2:
        raise ValueError(f"no ring fits the prefill tile ({bm} x {bn}, {variant})")
    return PrefillTile("mma", bm, bn, bk, stages, split, parts, 2 * bn,
                       prefill_smem(bm, bn, bk, e, eb, stages, split, parts, gated,
                                    sparse, not baseline), ctas)


# The grouped GEMM (csrc/mx_grouped_matmul*.cu), route "mma"
# (csrc/grouped_mma.cuh) for every pair: prefill_tile.cuh's K loop run once
# per group that owns rows of a CTA tile, on the tiles GROUPED_TILES (the
# ABFT launch on GROUPED_ABFT_TILES, the flag map's).  The tile height
# follows the mean rows per group T / G (the rows one expert's weights are
# streamed for), as the JAX dispatch plans for max(T // G, 1): decode height
# (<= 8, an MoE's capacity floor), up to 64, an expert-major prefill chunk.
GROUPED_MEANS = (8, 64)            # mean rows per group: the regimes' upper edges
GROUPED_ROWS = (16, 32, 64)        # CTA tile rows per regime
GROUPED_TILES = ((16, 128), (32, 64), (64, 128), (64, 64))
GROUPED_ABFT_TILES = ((16, 64), (32, 64), (64, 64))
GROUPED_STAGES = (2, 3, 3)  # ring slots per regime (fewer where they do not fit)
GROUPED_DEEP_STAGES = 6     # ring slots of a grid of at most one CTA per SM
GROUPED_MAX_RESIDENT = 4    # CTAs an SM is counted to hold at most
GROUPED_WARPS = 16          # resident warps per SM counted at most
GROUPED_SPLIT_GAIN = 1.25   # a cluster split must score this much above one CTA per tile


class GroupedTile(NamedTuple):
    """The launch of the grouped GEMM: route "mma" (csrc/grouped_mma.cuh)
    for every pair."""
    route: str    # "mma"
    bm: int       # CTA tile rows
    bn: int       # CTA tile columns
    bk: int       # K rows per ring stage
    stages: int   # ring slots
    split: int    # CTAs per cluster: 1, or `parts` (one part each)
    parts: int    # equal K parts, each summed from zero, folded in order
    threads: int  # per CTA
    smem: int     # dynamic shared memory per CTA, bytes
    ctas: int     # CTAs of the grid (tiles x split)


def _grouped_regime(T: int, G: int) -> int:
    mean = T // max(G, 1)
    return sum(mean > m for m in GROUPED_MEANS)


def grouped_flag_tile(T: int, G: int, a_dtype: torch.dtype, b_dtype: torch.dtype):
    """(bm, bn) of the grouped GEMM's ABFT flag map: the CTA tile of its ABFT
    launch (one CTA per flag), by the mean rows per group, for every pair
    (`a_dtype`, `b_dtype`: one of MMA_PAIRS).  abft_rtol, the fault
    operands' grid and the plain version's flag map (kernels/ref._grouped_flags)
    read it."""
    if (a_dtype, b_dtype) not in MMA_PAIRS:
        raise ValueError(f"no grouped tile for the pair ({a_dtype}, {b_dtype})")
    return GROUPED_ABFT_TILES[_grouped_regime(T, G)]


def _mma_threads(bm: int, bn: int) -> int:
    """Threads of a prefill_tile.cuh CTA: (1 if bm == 16 else 2) x bn / 32 warps."""
    return 32 * (1 if bm == 16 else 2) * (bn // 32)


def _resident(smem: int, threads: int) -> int:
    """CTAs of this shared memory and width an SM is counted to hold."""
    return max(1, min(GROUPED_MAX_RESIDENT, SMEM_PER_SM // (smem + 1024),
                      2048 // threads))


@functools.lru_cache(maxsize=None)  # a pure function of the launch's shape
def grouped_tile(T: int, N: int, K: int, G: int, a_dtype: torch.dtype,
                 b_dtype: torch.dtype, gated: bool = False,
                 variant: str = "dense") -> GroupedTile:
    """The grouped GEMM's tile for x (T, K), w (G, K, N).

    Every pair takes the tensor-core loop, one visit per group that owns
    rows of a tile (route "mma"; int8 x int8 and e4m3 x e4m3 the 8-bit
    MMAs):
    - bm: 16, 32 or 64 rows by the mean rows per group (<= 8, <= 64, more):
      at an MoE's decode height (8 rows per expert) a 16-row tile covers two
      groups, and each expert's weight is streamed once;
    - parts: `prefill_parts(K, bk)`, bk = 128 bytes of x row per stage, the
      fused prefill tile's, so a grouped launch and a fused launch on one
      expert's rows sum the same parts in the same order;
    - stages: up to GROUPED_STAGES per regime, as many as fit two CTAs per
      SM (else one): 2 at decode height, where more resident CTAs stream
      more bytes than a deeper ring (grok's f32 up+gate projection 4.40 ms
      at 2 against 5.05 at 3), up to 3 above (grok's (bf16, int8) prefill
      down projection: 2.79 ms at 2 stages, two CTAs per SM, against 4.35
      at 3, one); a grid of at most one CTA per SM (K in one part, as at
      K = 6100 in f32) up to GROUPED_DEEP_STAGES, each CTA's ring then its
      only copies in flight;
    - bn: 128 (a CTA of 4 warps at bm = 16, 8 at bm = 64), but 64 at
      bm = 32 and for f32 without a gate at bm = 64 (grok's f32 prefill down
      projection: 10.8 ms at 64 against 12.6 at 128);
    - split: at decode height, `parts` (a cluster per tile) where the
      resident warps per SM (CTAs by shared memory, at most
      GROUPED_MAX_RESIDENT; their warps at most GROUPED_WARPS) times the
      share of the waves' CTA slots the grid fills scores GROUPED_SPLIT_GAIN
      above one CTA per tile (grok's 192- and 1024-tile grids split, kimi's
      3072 tiles do not); 1 above decode height;
    - the ABFT variant: the flag map's tile (GROUPED_ABFT_TILES), split 1.
    The choices are those that timed best on an H100 with
    tools/grouped_variants.py at grok-1's and kimi-k2's expert shapes
    (PERF.md section 6).
    """
    if variant not in ("dense", "sparse", "abft"):
        raise ValueError(f"variant must be dense, sparse or abft, got {variant!r}")
    r = _grouped_regime(T, G)
    if (a_dtype, b_dtype) not in MMA_PAIRS:
        raise ValueError(f"no grouped tile for the pair ({a_dtype}, {b_dtype})")
    e, eb = a_dtype.itemsize, b_dtype.itemsize
    bk = PREFILL_STAGE_ROW // e
    parts = prefill_parts(K, bk)
    sparse = variant == "sparse"
    bm = GROUPED_ROWS[r]
    reserve = prefill_abft_static(bk) if variant == "abft" else 0
    if variant == "abft":
        bn = GROUPED_ABFT_TILES[r][1]
    elif bm == 32 or (bm == 64 and a_dtype == torch.float32 and not gated):
        bn = 64
    else:
        bn = 128
    threads = _mma_threads(bm, bn)

    def launch(split):  # (score, stages, smem, ctas) of one split
        ctas = -(-T // bm) * -(-N // bn) * split
        deep = ctas <= SMS  # one CTA per SM: a deep ring hides the copies' latency
        stages = 0
        for budget in ((SMEM_PER_CTA,) if deep else (SMEM_PER_SM // 2 - 1024, SMEM_PER_CTA)):
            cap = GROUPED_DEEP_STAGES if deep else GROUPED_STAGES[r]
            stages = max((s for s in range(2, cap + 1)
                          if prefill_smem(bm, bn, bk, e, eb, s, split, parts, gated, sparse)
                          + reserve <= budget), default=0)
            if stages:
                break
        smem = prefill_smem(bm, bn, bk, e, eb, stages, split, parts, gated, sparse)
        resident = _resident(smem + reserve, threads)
        slots = SMS * resident
        fill = ctas / (-(-ctas // slots) * slots)
        return min(resident * threads // 32, GROUPED_WARPS) * fill, stages, smem, ctas

    one = (1, *launch(1))
    pick = one
    if bm == 16 and variant != "abft" and parts > 1:
        cluster = (parts, *launch(parts))
        if cluster[1] > GROUPED_SPLIT_GAIN * one[1]:
            pick = cluster
    split, _, stages, smem, ctas = pick
    if stages < 2:
        raise ValueError(f"no ring fits the grouped tile ({bm} x {bn}, {variant})")
    return GroupedTile("mma", bm, bn, bk, stages, split, parts, threads, smem, ctas)


# The paged attention's split (csrc/mx_flash_decode.cu, decode and verify):
# a slot's positions are cut into spans of whole pages, one cluster of CTAs
# per (slot, kv head, window row) computes them, rank r the spans r, r + C,
# ..., and rank 0 folds their partials in span order.
SPAN_BYTES = 16384      # K and V bytes per span, at least one page
SPAN_MAX_POSITIONS = 128  # positions per span at most (a warp's score pass)
SPLIT_MAX_CLUSTER = 8   # a portable cluster
SPLIT_RING_SPANS = 2    # spans of K/V a CTA's ring holds (the kernel takes 4 slots)
SPLIT_MAX_GROUP_SPANS = 2  # consecutive spans a lone CTA computes per round
SPLIT_FILL_CTAS = 2 * SMS  # CTAs a launch aims for before it stops widening clusters
SPLIT_MAX_WARPS = 16    # one warp per query row, two rows per warp past 16
SPLIT_MAX_GROUP = 32
SPLIT_MAX_DIM = 256


class DecodeSplit(NamedTuple):
    """The launch of csrc/mx_flash_decode.cu's one kernel (decode is S = 1)."""
    span_pages: int  # pages per span (decode_span: ps, d and page dtype alone)
    group: int       # consecutive spans a CTA computes per round
    ring: int        # ring slots (of `group` spans) per CTA
    cluster: int     # CTAs per (slot, kv head, window row)
    threads: int     # per CTA: a warp per query row, at most 16
    smem: int        # dynamic shared memory per CTA, bytes
    ctas: int        # cluster * B * Hkv * S


def _split_row_bytes(d: int, elt: int) -> int:
    """csrc/mx_flash_decode.cu `split_row_bytes`: a K or V row's d elements
    rounded up to an odd number of 16-byte chunks."""
    return 16 * (-(-(d * elt) // 16) | 1)


def decode_split_smem(G: int, d: int, ps: int, elt: int, scaled: bool, span_pages: int,
                      group: int, ring: int, cluster: int, W: int) -> int:
    """A CTA's dynamic shared memory (csrc/mx_flash_decode.cu `split_layout`):
    G query rows of d (f32, d rounded up to 16), `ring` slots of `group`
    spans of `span_pages` pages (K rows, V rows and, with scales, their scale
    rows), a score row of a span's positions per query row, two buffers of
    the cluster's partial rows (m, l, acc) per span of a round and query
    row, rank 0's running row per query row, the CTA's own partial rows of a
    round, and the page ids of a CTA's spans of a table of W pages."""
    row = _split_row_bytes(d, elt)
    page = -(-(2 * ps * row + (8 * ps if scaled else 0)) // 16) * 16
    q = G * (-(-d // 16) * 16) * 4
    ids = -(-(-(-W // span_pages)) // (cluster * group)) * group * span_pages
    return (q + ring * group * span_pages * page + G * span_pages * ps * 4
            + (2 * cluster * group + 1 + group) * G * (d + 2) * 4 + -(-ids * 4 // 16) * 16)


@functools.lru_cache(maxsize=None)
def decode_span(ps: int, d: int, page_dtype: torch.dtype) -> int:
    """Pages per span of the paged attention: SPAN_BYTES of K and V rows
    (at least one page), at most SPAN_MAX_POSITIONS positions.  A function
    of the page size, the head dim and the page dtype alone: a span's
    partial, and so every output's bits, never depend on the batch, the
    table width, the grid or the cluster size."""
    page = 2 * ps * d * page_dtype.itemsize
    return max(1, min(SPAN_BYTES // page, SPAN_MAX_POSITIONS // ps))


@functools.lru_cache(maxsize=None)  # a pure function of the launch's shape
def decode_split(B: int, S: int, Hkv: int, G: int, d: int, ps: int, W: int,
                 page_dtype: torch.dtype, scaled: bool) -> DecodeSplit:
    """The paged attention's launch for B slots of S window rows (decode:
    S = 1), Hkv kv heads of G query rows of d, pages of ps rows and a table
    of W pages:
    - span_pages: `decode_span(ps, d, page_dtype)`;
    - cluster: the fewest CTAs per (slot, kv head, window row) that give the
      grid SPLIT_FILL_CTAS, at most one per span of a full table and at
      most SPLIT_MAX_CLUSTER;
    - group: the consecutive spans a CTA computes per round: up to
      SPLIT_MAX_GROUP_SPANS for a cluster of one CTA (a large grid, as a
      verify window), one in a cluster (one cluster barrier per span);
    - ring: slots of a group for SPLIT_RING_SPANS spans in flight, no more
      than the rounds a CTA walks (more slots cost CTAs per SM);
    where shared memory runs out, fewer slots, then a smaller group, then a
    smaller cluster (a span that does not fit one CTA alone raises).  The
    choices are those that timed best on an H100 with
    tools/split_variants.py at llama3.2-1b's decode, verify and long-context
    shapes (PERF.md section 6).
    """
    if not 1 <= G <= SPLIT_MAX_GROUP or not 1 <= d <= SPLIT_MAX_DIM:
        raise ValueError(f"the paged attention takes G <= {SPLIT_MAX_GROUP} query rows per "
                         f"kv head and d <= {SPLIT_MAX_DIM}, got G={G}, d={d}")
    span = decode_span(ps, d, page_dtype)
    spans = -(-W // span)  # spans of a full table
    pairs = B * S * Hkv
    cluster = max(1, min(SPLIT_MAX_CLUSTER, spans, -(-SPLIT_FILL_CTAS // max(pairs, 1))))
    elt = page_dtype.itemsize
    per_cta = -(-spans // cluster)  # spans a CTA walks in a full table
    group = min(SPLIT_MAX_GROUP_SPANS, per_cta) if cluster == 1 else 1

    def fit(cluster, group):  # (ring, smem) of a cluster size and group
        ring = max(1, min(SPLIT_RING_SPANS // group, -(-per_cta // group)))
        while ring > 1 and decode_split_smem(G, d, ps, elt, scaled, span, group, ring, cluster,
                                             W) > SMEM_PER_CTA:
            ring -= 1
        return ring, decode_split_smem(G, d, ps, elt, scaled, span, group, ring, cluster, W)

    ring, smem = fit(cluster, group)
    while smem > SMEM_PER_CTA and (group > 1 or cluster > 1):
        if group > 1:
            group -= 1
        else:
            cluster -= 1
        ring, smem = fit(cluster, group)
    if smem > SMEM_PER_CTA:
        raise ValueError(f"the paged attention: G={G}, d={d}, page_size={ps} needs {smem} "
                         f"bytes of shared memory for one page, past the {SMEM_PER_CTA} a "
                         f"block can use")
    return DecodeSplit(span, group, ring, cluster, 32 * min(G, SPLIT_MAX_WARPS), smem,
                       cluster * pairs)


# The chunked SSD scan (csrc/ssd_scan.cu): one CTA of 8 warps per (sequence,
# head), each warp 16 rows of a chunk, its four products on the tensor cores.
SSD_WARPS = 8
SSD_MAX_DIM = 128  # chunk, P and S at most


class SsdTile(NamedTuple):
    """The launch of csrc/ssd_scan.cu."""
    stages: int   # chunk slots: 2 (the next chunk in flight) where two fit, else 1
    threads: int  # per CTA
    smem: int     # dynamic shared memory per CTA, bytes


def ssd_p_tiles(P: int) -> int:
    """P's n8 tiles as csrc/ssd_scan.cu instantiates its kernel
    (`ssd_p_tiles`): ceil(P / 8) rounded up to a power of two."""
    n = 1
    while n * 8 < P:
        n *= 2
    return n


def _ssd_row_bytes(cols: int, elt: int) -> int:
    """csrc/ssd_scan.cu `ssd_row_bytes`: `cols` columns rounded up to 16
    bytes past a multiple of 128."""
    return (cols * elt + 111) // 128 * 128 + 16


def ssd_smem(Q: int, P: int, S: int, elt: int, stages: int) -> int:
    """A CTA's dynamic shared memory (csrc/ssd_scan.cu `ssd_layout`):
    `stages` chunk slots of x rows (P padded to its n8 tiles), b and c rows
    (S padded to 8) and a_log (Q padded to 16 rows), the f32 state (S
    padded to 16 rows of P's tiles, 8 floats past a multiple of 32 apart)
    and three f32 rows of Q."""
    pc = 8 * ssd_p_tiles(P)
    q16 = -(-Q // 16) * 16
    stage = q16 * (_ssd_row_bytes(pc, elt) + 2 * _ssd_row_bytes(-(-S // 8) * 8, elt)) + 4 * q16
    hrow = (pc + 23) // 32 * 32 + 8
    return stages * stage + -(-S // 16) * 16 * hrow * 4 + 3 * q16 * 4


@functools.lru_cache(maxsize=None)
def ssd_tile(Q: int, P: int, S: int, dtype: torch.dtype) -> SsdTile:
    """The SSD scan's launch for chunk Q, head dim P and state S: two chunk
    slots where they fit a CTA's shared memory (the next chunk's copies run
    under this chunk's products), else one; ValueError past SSD_MAX_DIM or
    when one slot does not fit."""
    if not (1 <= Q <= SSD_MAX_DIM and 1 <= P <= SSD_MAX_DIM and 1 <= S <= SSD_MAX_DIM):
        raise ValueError(f"ssd_scan takes chunk, P and S of at most {SSD_MAX_DIM}, got "
                         f"chunk={Q}, P={P}, S={S}")
    for stages in (2, 1):
        smem = ssd_smem(Q, P, S, dtype.itemsize, stages)
        if smem <= SMEM_PER_CTA:
            return SsdTile(stages, 32 * SSD_WARPS, smem)
    raise ValueError(f"ssd_scan: chunk={Q}, P={P}, S={S} needs {smem} bytes of shared memory "
                     f"for one chunk, past the {SMEM_PER_CTA} a block can use")


def stream_ptr(t: torch.Tensor) -> int:
    """PyTorch's current stream on t's device, as the raw cudaStream_t."""
    return torch.cuda.current_stream(t.device).cuda_stream
