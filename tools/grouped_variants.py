"""Where the grouped GEMM's time goes: time `mx_grouped_matmul`'s tensor-core
route (csrc/grouped_mma.cuh) at candidate tiles and with parts of its loop
cut, at grok-1's and kimi-k2's expert shapes, on the card (one JSON line):

    PYTHONPATH=src python tools/grouped_variants.py [--quick]

A bring-up tool, not part of the package.  Each shape is launched through
the package's C entry (`_LAUNCHERS[("dense", "mma")]`) at the tile
`kernels/_build.grouped_tile` picks and at the candidate tiles `CANDIDATES`
lists, and, for the table's tile, through timing variants of the source
(`_build` compiles them with a macro, in parallel with the package's own
build): "copies" (PREFILL_TIMING_NO_PRODUCTS: the ring's copies without the
MMAs) and "products" (PREFILL_TIMING_NO_COPIES: the MMAs without the copies
once the ring is primed), wrong results, timing only; and for a narrow
weight "b_in_smem" (PREFILL_TIMING_B_IN_SMEM: the shared-memory widening
pass instead of widening in registers).  Beside them
`torch.bmm` where one call computes the same function.  Every
candidate tile's output must be bitwise the table tile's (an output
element's bits depend on K and the pair only), and the table tile's within
1e-4 (f32) or 2e-2 (bf16) * max|ref| of `grouped_matmul_ref`.  Times: the
best of 3 windows of `iters` launches, CUDA events; each call reads its
weights cold (every stack is past the 50 MB L2).  --quick: the decode-height
shapes only.
"""
from __future__ import annotations

import json
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]

VARIANTS = {"copies": ("PREFILL_TIMING_NO_PRODUCTS",),
            "products": ("PREFILL_TIMING_NO_COPIES",),
            "b_in_smem": ("PREFILL_TIMING_B_IN_SMEM",)}  # narrow weights only

# (label, T, rows per group, K, N, gated, pair)
SHAPES = [
    ("grok decode down", 64, 8, 32768, 6144, False, "f32"),
    ("grok decode down", 64, 8, 32768, 6144, False, "bf16"),
    ("grok decode down", 64, 8, 32768, 6144, False, "int8"),
    ("grok decode up+gate", 64, 8, 6144, 32768, True, "f32"),
    ("grok decode up+gate", 64, 8, 6144, 32768, True, "bf16"),
    ("grok decode up+gate", 64, 8, 6144, 32768, True, "int8"),
    ("kimi decode", 3072, 8, 7168, 2048, False, "bf16"),
    ("grok prefill down", 1024, 128, 32768, 6144, False, "f32"),
    ("grok prefill down", 1024, 128, 32768, 6144, False, "bf16"),
    ("grok prefill down", 1024, 128, 32768, 6144, False, "int8"),
    ("grok prefill up+gate", 1024, 128, 6144, 32768, True, "f32"),
    ("grok prefill up+gate", 1024, 128, 6144, 32768, True, "bf16"),
]
# (bm, bn, stages, split): tried beside the table's tile where they fit
CANDIDATES = {16: [(16, 128, 2, 8), (16, 128, 3, 8), (16, 128, 2, 1), (16, 128, 3, 1)],
              64: [(64, 128, 3, 1), (64, 64, 3, 1), (64, 128, 2, 1), (64, 64, 4, 1)]}


def main() -> int:
    sys.path.insert(0, str(ROOT / "src"))
    import torch

    from repro_torch.kernels import _build
    from repro_torch.kernels.mx_grouped_matmul import _LAUNCHERS, launch_tile
    from repro_torch.kernels.ref import grouped_matmul_ref

    if not torch.cuda.is_available():
        raise RuntimeError("grouped_variants times CUDA kernels: no GPU is visible")
    quick = "--quick" in sys.argv
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         check=True).stdout.strip()
    t0 = time.perf_counter()
    build_s = _build.build_all(["mx_grouped_matmul"],
                               [("mx_grouped_matmul", d) for d in VARIANTS.values()])
    dev = torch.device("cuda")
    torch.backends.cuda.matmul.allow_tf32 = False
    dts = {"f32": (torch.float32, torch.float32), "bf16": (torch.bfloat16, torch.bfloat16),
           "int8": (torch.bfloat16, torch.int8)}

    def timed(fn, iters):
        fn()
        torch.cuda.synchronize()
        best = float("inf")
        for _ in range(3):
            s, e = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            s.record()
            for _ in range(iters):
                fn()
            e.record()
            e.synchronize()
            best = min(best, s.elapsed_time(e) / iters)
        return best

    rows = []
    for label, T, C, K, N, gated, pair in SHAPES:
        if quick and C > 8:
            continue
        a_dt, b_dt = dts[pair]
        G = T // C
        gen = torch.Generator(device=dev).manual_seed(7)

        def stack():
            w = torch.empty((G, K, N), dtype=b_dt, device=dev)
            for g in range(G):
                if b_dt == torch.int8:
                    w[g] = torch.randint(-127, 128, (K, N), generator=gen, device=dev,
                                         dtype=torch.int8)
                else:
                    w[g].normal_(generator=gen).mul_(K ** -0.5)
            return w

        x = torch.randn((T, K), generator=gen, device=dev).to(a_dt)
        w = stack()
        wg = stack() if gated else None
        sizes = torch.full((G,), C, dtype=torch.int32, device=dev)
        b_s = (torch.rand((G, N), generator=gen, device=dev) / 127 / K ** 0.5
               if b_dt == torch.int8 else None)
        bg_s = b_s.clone() if b_s is not None and gated else None
        out_dt = torch.float32 if b_dt == torch.int8 else a_dt
        act = 4 if gated else 0  # swiglu / none (kernels/mx_matmul.ACT_CODES)
        nbytes = (x.element_size() * T * K + (2 if gated else 1) * w.element_size() * G * K * N
                  + torch.finfo(out_dt).bits // 8 * T * N)
        iters = 5 if C > 8 else 10
        route, table = launch_tile(x, w, wg)
        va, vb, vm = table[5:]

        def run(tile, defines=(), out=None):
            src, sym, argtypes = _LAUNCHERS["dense", "mma"]
            fn = _build.function(src, sym, argtypes, defines=defines)
            out = torch.empty((T, N), dtype=out_dt, device=dev) if out is None else out
            args = [x.data_ptr(), w.data_ptr(), None if wg is None else wg.data_ptr(), None,
                    None if b_s is None else b_s.data_ptr(),
                    None if bg_s is None else bg_s.data_ptr(), sizes.data_ptr(),
                    out.data_ptr(), _build.dtype_code(out_dt, "out"), T, N, K, G,
                    _build.dtype_code(a_dt, "x", _build.FLOATS),
                    _build.dtype_code(b_dt, "w", _build.FLOATS + _build.QUANTIZED), act,
                    *tile, va, vb, vm, _build.stream_ptr(x)]
            err = fn(*args)
            return err, out

        row = dict(label=label, pair=pair, T=T, G=G, K=K, N=N, gated=gated, route=route,
                   table=list(table[:5]), bytes=nbytes)
        err, ref_out = run(table[:5])
        torch.cuda.synchronize()
        if err:
            raise RuntimeError(f"{label} {pair}: the table's tile was refused ({err})")
        kw = dict(w_gate=wg, activation="swiglu" if gated else "none",
                  b_scale=None if b_s is None else b_s[:, None],
                  bg_scale=None if bg_s is None else bg_s[:, None], out_dtype=out_dt)
        plain = grouped_matmul_ref(x, w, sizes, **kw).float()
        rel = ((ref_out.float() - plain).abs().max() / plain.abs().max()).item()
        row["rel_err"] = rel
        row["ok"] = rel <= (1e-4 if a_dt == torch.float32 else 2e-2)
        del plain
        out = torch.empty_like(ref_out)
        row["ms"] = timed(lambda: run(table[:5], out=out), iters)
        row["tb_s"] = nbytes / row["ms"] / 1e9
        for v, d in VARIANTS.items():
            if v == "b_in_smem" and b_dt.itemsize == a_dt.itemsize:
                continue
            row[f"{v}_ms"] = timed(lambda: run(table[:5], d, out), iters)
            row[f"{v}_tb_s"] = nbytes / row[f"{v}_ms"] / 1e9
        cands = []
        for bm, bn, st, sp in CANDIDATES.get(table[0], []):
            tile = (bm, bn, st, sp if sp == 1 else table[4], table[4])
            if tile == tuple(table[:5]):
                continue
            e, o = run(tile, out=out)
            torch.cuda.synchronize()
            if e:
                cands.append(dict(tile=list(tile), refused=e))
                continue
            cands.append(dict(tile=list(tile), bitwise=bool(torch.equal(o, ref_out)),
                              ms=timed(lambda: run(tile, out=out), iters)))
        row["candidates"] = cands
        if not gated and b_dt != torch.int8:
            xe = x.view(G, C, K)
            row["bmm_ms"] = timed(lambda: torch.bmm(xe, w), iters)
        rows.append(row)
        print(json.dumps(row), file=sys.stderr, flush=True)
        del x, w, wg, out, ref_out
        torch.cuda.empty_cache()
    print(json.dumps(dict(device=smi, build_s=build_s, seconds=time.perf_counter() - t0,
                          rows=rows)))
    return 0


if __name__ == "__main__":
    sys.exit(main())
