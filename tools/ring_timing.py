"""Where a one-card ring's time goes: time the ring collective GEMMs of
`chip_smoke.py` phase 12a over `LocalRing(8)` on the card with one ring
call per timing window and with five, beside the host's enqueue time per
call and `torch.profiler`'s device busy time and device events of one call
(one JSON line per shape and direction):

    PYTHONPATH=src python tools/ring_timing.py

A bring-up tool, not part of the package.  A ring call enqueues 130-350
kernels and copies (64 chunk GEMMs on kernel 1, the hops' copies, the
reduce-scatter ring's additions, the bidir ring's concatenations);
`chip_smoke._time_ms` keeps a spin kernel ahead of the host so that the
events time the device, and this shows whether a window of several ring
calls outruns that.  Shapes: llama3.2-1b's q (all-gather) and out and down
(reduce-scatter, the residual fused) projections at M = 64, f32, "fwd" and
"bidir"; operands from chip_smoke's phase-12 helpers.  Times are the
median of 5 windows (CUDA events); the profile is one call after the
timing.
"""
from __future__ import annotations

import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
SHAPES = (("q M=64", "allgather", 64, 2048, 2048), ("out M=64", "reduce_scatter", 64, 2048, 2048),
          ("down M=64", "reduce_scatter", 64, 8192, 2048))


def device_profile(torch, call):
    """(device busy ms, device events) of one call, from torch.profiler:
    the kernels and copies themselves (an aten op carries its kernels'
    device time too, so the ops on the host side are left out)."""
    act = torch.profiler.ProfilerActivity
    with torch.profiler.profile(activities=[act.CPU, act.CUDA]) as prof:
        call()
        torch.cuda.synchronize()
    busy = events = 0
    for e in prof.key_averages():
        if str(e.device_type).endswith("CUDA"):
            busy += e.self_device_time_total
            events += e.count
    return busy / 1e3, events


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("ring_timing: no CUDA device is visible", file=sys.stderr)
        return 2
    sys.path[:0] = [str(ROOT / "src"), str(ROOT)]
    import chip_smoke as cs
    from repro_torch.kernels import _build
    from repro_torch.kernels import mx_collective_matmul as cm
    from repro_torch.kernels import mx_matmul as mm
    from repro_torch.parallel.ring import LocalRing

    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda")
    _build.build_all(("mx_matmul",))
    ring = LocalRing(8)
    for label, mode, M, K, N in SHAPES:
        ep_kw = dict(residual=True) if mode == "reduce_scatter" else {}
        op = cs._ring_operands(torch, dev, M, K, N, "float32", ep_kw, 7)
        xs, ws, kw = cs._ring_shards(op, mode, ring.size)
        fn = cm.ring_allgather_matmul if mode == "allgather" else cm.ring_matmul_reduce_scatter
        for direction in ("fwd", "bidir"):
            def call():
                return fn(ring, xs, ws, compute=cm.ChunkCompute("cuda_mx"),
                          epilogue=mm.Epilogue(**ep_kw), direction=direction, **kw)

            out = dict(label=label, mode=mode, direction=direction, M=M, K=K, N=N)
            for iters in (1, 5):
                t = cs._time_ms(torch, {"ms": (lambda *_: call(), [()])}, windows=5,
                                iters=iters, warmup=2)
                out[f"ms_{iters}_per_window"] = t["ms"]
                out[f"windows_{iters}"] = t["windows_ms"]["ms"]
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            for _ in range(5):
                call()
            out["host_ms_per_call"] = 1e3 * (time.perf_counter() - t0) / 5
            torch.cuda.synchronize()
            out["device_busy_ms"], out["device_events"] = device_profile(torch, call)
            print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
