"""Time the dense GEMM kernels of a checkout on the card, for A/B comparisons
of kernel code (one JSON line per run):

    PYTHONPATH=src python -m repro_torch.launch.gemm_times            # this checkout
    PYTHONPATH=src python -m repro_torch.launch.gemm_times --src <checkout>/src

`--src` runs this file in a fresh process with only that directory on the
path, so the same measurement times the other checkout's `repro_torch`
(its kernels built into that checkout's `build/`), which need not have
this module: two versions of the kernels compare inside one call on one
card; run them in turns (parent, change, change, parent).  Times: CUDA
events, each window behind a spin kernel that outlasts its enqueue (so
the device is timed, not the host), the median of 5 windows of 10 calls (20 for the dense GEMMs,
cycling 4 weight copies so every call reads its weight from HBM), at
llama3.2-1b's decode (M = 1, 8, 16) and chunk shapes, zamba2-2.7b's in_proj,
the quantized operand pairs at the decode down projection, the baseline
GEMM at the paper's A/B shape and grok-1's decode expert shapes, f32 and
bf16; `torch.addmm` at the f32 down projection as the yardstick.  The
prefill rows (M = 40: a verify step, 64: a prefill chunk, 256, 2048:
zamba2's forward), f32 and bf16: the MX GEMM at the down projection
(K = 8192, N = 2048, + residual) beside `torch.addmm`, and the MX and
baseline GEMMs at the paper's A/B shape (K = 2048, N = 8192) beside
`torch.matmul`, each with its bound (`bounds_ms`: `core/roofline.bound_ms`,
the larger of its bytes at 3.35 TB/s and its operations at the type's
peak, 67 TFLOP/s f32 off the tensor cores, 989 bf16; read from this file's
own tree, since under --src the other checkout may predate it).  The
ptxas lines (registers, spills) of the GEMM
sources come with them.
"""
from __future__ import annotations

import argparse
import importlib.util
import json
import os
import statistics
import subprocess
import sys
import time


def _timeit(torch, fn, windows=5, iters=10):
    """Median ms per call over `windows` windows of `iters` calls.  Each
    window starts behind a spin kernel that outlasts its enqueue, so the
    calls run back to back and the events time the device, not the
    wrappers' host overhead."""
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(3):
        fn()
    host_s = (time.perf_counter() - t0) / 3
    torch.cuda.synchronize()
    per = []
    for _ in range(windows):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(int(1.5 * iters * host_s * 2.0e9) + 100_000)  # <= 2 GHz SM clock
        start.record()
        for _ in range(iters):
            fn()
        end.record()
        end.synchronize()
        per.append(start.elapsed_time(end) / iters)
    return statistics.median(per)


def _bound_ms():
    """`bound_ms` of this file's own `core/roofline.py` (a module of the
    standard library alone), loaded by path."""
    path = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "core",
                        "roofline.py")
    spec = importlib.util.spec_from_file_location("_gemm_times_roofline", path)
    mod = importlib.util.module_from_spec(spec)
    sys.modules[spec.name] = mod  # its dataclasses look their module up
    spec.loader.exec_module(mod)
    return mod.bound_ms


def measure() -> dict:
    """The times of the dense kernels of the `repro_torch` on sys.path
    (absolute imports: under --src, the other checkout's)."""
    import torch

    from repro_torch.core.precision import NAMED_POLICIES
    bound_ms = _bound_ms()
    from repro_torch.kernels import _build
    from repro_torch.kernels.baseline_matmul import baseline_matmul
    from repro_torch.kernels.mx_grouped_matmul import mx_grouped_matmul
    from repro_torch.kernels.mx_matmul import Epilogue, mx_matmul_fused
    from repro_torch.kernels.quant import quantize_operand

    if not torch.cuda.is_available():
        raise RuntimeError("gemm_times measures the CUDA kernels: no GPU is visible")
    t0 = time.perf_counter()
    _build.build_all(["mx_matmul", "mx_grouped_matmul", "baseline_matmul"])
    build_s = time.perf_counter() - t0
    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(0)
    ms = {}

    def cycled(make, fn):
        """fn over 4 copies of make()'s operands, one copy per call."""
        copies = [make() for _ in range(4)]
        calls = [0]

        def call():
            args = copies[calls[0] % 4]
            calls[0] += 1
            return fn(*args)
        return _timeit(torch, call, iters=20)

    for dt in (torch.float32, torch.bfloat16):
        name = str(dt).removeprefix("torch.")
        for label, T, K, N, act in (("grok decode up+gate", 64, 6144, 32768, "swiglu"),
                                    ("grok decode down", 64, 32768, 6144, "none")):
            x = torch.randn((T, K), generator=g, device=dev).to(dt)
            w = (torch.randn((8, K, N), generator=g, device=dev) / K ** 0.5).to(dt)
            wg = w.clone() if act == "swiglu" else None
            sizes = torch.full((8,), 8, dtype=torch.int32, device=dev)
            ms[f"{label} {name}"] = _timeit(torch, lambda: mx_grouped_matmul(
                x, w, sizes, w_gate=wg, activation=act))
            del w, wg
            torch.cuda.empty_cache()
        for label, M, K, N, ep in (("decode down", 8, 8192, 2048, dict(residual=True)),
                                   ("decode down M=1", 1, 8192, 2048, dict(residual=True)),
                                   ("decode down M=16", 16, 8192, 2048, dict(residual=True)),
                                   ("decode up", 8, 2048, 8192, dict(activation="swiglu")),
                                   ("zamba2 in_proj", 8, 2560, 10448, dict()),
                                   ("chunk up", 64, 2048, 8192, dict(activation="swiglu"))):
            e = Epilogue(**ep)

            def make():
                return (torch.randn((M, K), generator=g, device=dev).to(dt),
                        (torch.randn((K, N), generator=g, device=dev) / K ** 0.5).to(dt),
                        (torch.randn((K, N), generator=g, device=dev) / K ** 0.5).to(dt)
                        if e.has_gate else None,
                        torch.randn((M, N), generator=g, device=dev).to(dt)
                        if e.residual else None)

            ms[f"{label} {name}"] = cycled(make, lambda a, b, bg, res: mx_matmul_fused(
                a, b, epilogue=e, b_gate=bg, residual=res))
            if label == "decode down" and dt == torch.float32:
                ms[f"{label} {name} torch.addmm"] = cycled(
                    make, lambda a, b, bg, res: torch.addmm(res, a, b))
        # the paper's A/B: the baseline GEMM at M = 8 (the MX time: "decode up")
        ms[f"baseline M=8 K=2048 N=8192 {name}"] = cycled(
            lambda: (torch.randn((8, 2048), generator=g, device=dev).to(dt),
                     (torch.randn((2048, 8192), generator=g, device=dev) / 45).to(dt)),
            lambda a, b: baseline_matmul(a, b, bk=128))
        ms[f"mx M=8 K=2048 N=8192 {name}"] = cycled(
            lambda: (torch.randn((8, 2048), generator=g, device=dev).to(dt),
                     (torch.randn((2048, 8192), generator=g, device=dev) / 45).to(dt)),
            lambda a, b: mx_matmul_fused(a, b))
    bounds = {}
    for dt in (torch.float32, torch.bfloat16):  # the prefill rows
        name = str(dt).removeprefix("torch.")
        e = dt.itemsize
        for M in (40, 64, 256, 2048):
            for label, K, N, res in (("prefill down", 8192, 2048, True),
                                     ("prefill A/B", 2048, 8192, False)):
                def make():
                    return (torch.randn((M, K), generator=g, device=dev).to(dt),
                            (torch.randn((K, N), generator=g, device=dev) / K ** 0.5).to(dt),
                            torch.randn((M, N), generator=g, device=dev).to(dt)
                            if res else None)

                key = f"{label} M={M} K={K} N={N} {name}"
                ep = Epilogue(residual=res)
                ms[key] = cycled(make, lambda a, b, r: mx_matmul_fused(
                    a, b, epilogue=ep, residual=r))
                if res:
                    ms[f"{key} torch.addmm"] = cycled(
                        make, lambda a, b, r: torch.addmm(r, a, b))
                else:
                    ms[f"{key} baseline"] = cycled(
                        make, lambda a, b, r: baseline_matmul(a, b, bk=128))
                    ms[f"{key} torch.matmul"] = cycled(
                        make, lambda a, b, r: torch.matmul(a, b))
                nbytes = e * (M * K + K * N + M * N * (2 if res else 1))
                bounds[key] = bound_ms(nbytes, 2 * M * N * K, str(dt).removeprefix("torch."))[0]
    for pol in ("int8", "int8_all", "fp8"):  # the quantized pairs at the decode down
        P = NAMED_POLICIES[pol]
        e = Epilogue(residual=True, a_scale=P.a.quantized, b_scale=P.b.quantized)

        def make():
            qa, a_s = quantize_operand(torch.randn((8, 8192), generator=g, device=dev), P.a, "a")
            qb, b_s = quantize_operand(
                torch.randn((8192, 2048), generator=g, device=dev) / 90.5, P.b, "b")
            return qa.contiguous(), qb, a_s, b_s, torch.randn((8, 2048), generator=g, device=dev)

        ms[f"decode down {pol}"] = cycled(make, lambda a, b, a_s, b_s, res: mx_matmul_fused(
            a, b, epilogue=e, residual=res, a_scale=a_s, b_scale=b_s,
            out_dtype=torch.float32))
    ptxas = {}
    for source in ("mx_grouped_matmul", "mx_matmul", "baseline_matmul"):
        entry = ""
        for line in _build.ptxas_report(source).splitlines():
            if "Compiling entry function" in line:
                entry = line.split("'")[1]
            elif "Used" in line or ("spill" in line and " 0 bytes spill stores" not in line):
                ptxas.setdefault(source, []).append(f"{entry[:70]}: {line.strip()}")
    return dict(build_s=build_s, ms=ms, bounds_ms=bounds, ptxas=ptxas,
                device=torch.cuda.get_device_name(0))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--src", help="another checkout's src directory (A/B)")
    args = ap.parse_args(argv)
    if args.src:
        env = dict(os.environ, PYTHONPATH=os.path.abspath(args.src))
        out = subprocess.run([sys.executable, os.path.abspath(__file__)], env=env,
                             check=True, capture_output=True, text=True).stdout
        result = json.loads(out.strip().splitlines()[-1])
        result["src"] = args.src
    else:
        result = measure()
        result["src"] = os.path.dirname(os.path.dirname(os.path.dirname(
            os.path.abspath(__file__))))
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())
