"""Time the dense GEMM kernels of a checkout on the card, for A/B comparisons
of kernel code (one JSON line per run):

    PYTHONPATH=src python -m repro_torch.launch.gemm_times            # this checkout
    PYTHONPATH=src python -m repro_torch.launch.gemm_times --src <checkout>/src

`--src` runs this file in a fresh process with only that directory on the
path, so the same measurement times the other checkout's `repro_torch`
(its kernels built into that checkout's `build/`), which need not have
this module: two versions of the kernels compare inside one call on one
card; run them in turns (parent, change, change, parent).  Times: CUDA
events, the median of 5 windows of 10 calls (20 for the dense GEMM,
cycling 4 weight copies), at llama3.2-1b's decode and chunk shapes and
grok-1's decode expert shapes, f32 and bf16.  The ptxas lines (registers,
spills) of the two dense GEMM sources come with them.
"""
from __future__ import annotations

import argparse
import json
import os
import statistics
import subprocess
import sys
import time


def _timeit(torch, fn, windows=5, iters=10):
    fn()
    torch.cuda.synchronize()
    per = []
    for _ in range(windows):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(iters):
            fn()
        end.record()
        end.synchronize()
        per.append(start.elapsed_time(end) / iters)
    return statistics.median(per)


def measure() -> dict:
    """The times of the dense kernels of the `repro_torch` on sys.path
    (absolute imports: under --src, the other checkout's)."""
    import torch

    from repro_torch.kernels import _build
    from repro_torch.kernels.mx_grouped_matmul import mx_grouped_matmul
    from repro_torch.kernels.mx_matmul import Epilogue, mx_matmul_fused

    if not torch.cuda.is_available():
        raise RuntimeError("gemm_times measures the CUDA kernels: no GPU is visible")
    t0 = time.perf_counter()
    _build.build_all(["mx_matmul", "mx_grouped_matmul"])
    build_s = time.perf_counter() - t0
    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(0)
    ms = {}
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
                                   ("decode up", 8, 2048, 8192, dict(activation="swiglu")),
                                   ("chunk up", 64, 2048, 8192, dict(activation="swiglu"))):
            a = torch.randn((M, K), generator=g, device=dev).to(dt)
            copies = [tuple((torch.randn((K, N), generator=g, device=dev) / K ** 0.5).to(dt)
                            for _ in range(2)) for _ in range(4)]
            e = Epilogue(**ep)
            res = torch.randn((M, N), generator=g, device=dev).to(dt) if e.residual else None
            calls = [0]

            def fused():
                b, bg = copies[calls[0] % 4]
                calls[0] += 1
                return mx_matmul_fused(a, b, epilogue=e, b_gate=bg if e.has_gate else None,
                                       residual=res)

            ms[f"{label} {name}"] = _timeit(torch, fused, iters=20)
    ptxas = {}
    for source in ("mx_grouped_matmul", "mx_matmul"):
        entry = ""
        for line in _build.ptxas_report(source).splitlines():
            if "Compiling entry function" in line:
                entry = line.split("'")[1]
            elif "Used" in line or ("spill" in line and " 0 bytes spill stores" not in line):
                ptxas.setdefault(source, []).append(f"{entry[:70]}: {line.strip()}")
    return dict(build_s=build_s, ms=ms, ptxas=ptxas)


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
