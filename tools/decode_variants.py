"""Kernel 1's decode-height 2:4 and ABFT launches beside an earlier
checkout's, on the card (one JSON line per row):

    PYTHONPATH=src python tools/decode_variants.py [--parent <checkout>]

A bring-up tool, not part of the package.  The package's kernels are built
by `kernels/_build`; with `--parent`, that checkout's
csrc/mx_matmul_sparse.cu, csrc/mx_matmul_abft.cu and csrc/mx_matmul.cu are
compiled too (one nvcc each, started together with the package's, into
`build/decode_variants/`), loaded with ctypes and called through their own
C entries (`mx_matmul_sparse_launch`, `mx_matmul_abft_launch`, whose tile
argument was gemm_tile's (16, 16, 128), and the dense decode tile's
`mx_matmul_decode_launch`, "parent_dense", beside this tree's) on the same
inputs, in the same process.  Rows, all at M = 8 (a decode step of 8 slots):

  - `chip_smoke.py` phase 3s's decode rows: each 2:4 pair ("sparse24" f32
    and bf16, "sparse24_int8") at llama3.2-1b's up+gate (K=2048 N=8192
    swiglu), down (K=8192 N=2048, with and without the residual) and
    qwen2's K=896 N=128 with bias; beside the dense decode tile on
    expand_24's weight;
  - phase 3a's decode rows: ABFT on the six dense pairs and the three 2:4
    policies (expanded first) at K=2048 N=8192 swiglu; beside ABFT off;
  - llama3.2-1b's six decode projections (q, k, v, o + residual, up+gate
    swiglu, down + residual) under "sparse24" (f32), "sparse24_int8" and
    ABFT f32: the GEMMs of serving runs (g), (h) and (i).

Every row is first checked: the 2:4 launch bitwise the dense decode tile on
the expanded weight, ABFT on bitwise off with no flag, and the parent's
kernels bitwise both (with the same flag map).  Times: `chip_smoke._time_ms`
(CUDA events, the median of 5 windows of 20 calls, inputs past L2, each
window behind a spin kernel, the versions taking turns window by window);
each row prints every window as its spread.
"""
from __future__ import annotations

import argparse
import ctypes
import json
import math
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
OUT = ROOT / "build" / "decode_variants"
FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3", "-shared",
         "-Xcompiler", "-fPIC")
P, I, F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
EPI = [I, P, I, P] + [I] * 8 + [F]  # bias_dt .. out_scale
PARENT_ARGTYPES = {  # the parent's C entries: gemm_tile's (bm, bn, bk) as the tile
    "mx_matmul_sparse": [P] * 9 + EPI + [I] * 3 + [P],
    "mx_matmul_abft": [P] * 7 + EPI + [I] * 3 + [P] * 4 + [F, F, P],
    "mx_matmul": [P] * 7 + EPI + [I] * 7 + [P],  # its dense decode tile
}
PARENT_SYMBOLS = {"mx_matmul_sparse": "mx_matmul_sparse_launch",
                  "mx_matmul_abft": "mx_matmul_abft_launch",
                  "mx_matmul": "mx_matmul_decode_launch"}
M = 8
LLAMA = (("q", 2048, 2048, {}), ("k", 2048, 512, {}), ("v", 2048, 512, {}),
         ("o", 2048, 2048, dict(residual=True)), ("up+gate", 2048, 8192,
                                                  dict(activation="swiglu")),
         ("down", 8192, 2048, dict(residual=True)))


def start_parent(nvcc: str, parent: Path) -> dict:
    """name -> (library path, running nvcc) for the parent's three sources."""
    OUT.mkdir(parents=True, exist_ok=True)
    pc = parent / "src" / "repro_torch" / "csrc"
    jobs = {}
    for name in PARENT_ARGTYPES:
        lib = OUT / f"parent_{name}.so"
        cmd = [nvcc, *FLAGS, "-I", str(pc), "-o", str(lib), str(pc / f"{name}.cu")]
        jobs[name] = (lib, subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                            stderr=subprocess.STDOUT, text=True))
    return jobs


def finish_parent(jobs: dict) -> dict:
    """name -> the parent's C entry, its argument types set."""
    fns = {}
    for name, (lib, p) in jobs.items():
        out, _ = p.communicate()
        if p.returncode:
            raise RuntimeError(f"nvcc failed for the parent's {name}:\n{out[-3000:]}")
        fn = getattr(ctypes.CDLL(str(lib)), PARENT_SYMBOLS[name])
        fn.argtypes = PARENT_ARGTYPES[name]
        fn.restype = ctypes.c_int
        fns[name] = fn
    return fns


def parent_call(torch, fn, a, b, kw, b_meta=None, bg_meta=None, abft=None, dense=False):
    """One launch of the parent's decode-height kernel on the operands of a
    `mx_matmul_fused` call (its arguments, assembled as the parent's
    wrapper did; `dense`: its dense decode tile, with this tree's dense
    decode tile arguments): returns out, or (out, flags)."""
    from repro_torch.kernels import _build
    from repro_torch.kernels import mx_matmul as mm

    ep = kw["epilogue"]
    Mr, K = a.shape
    N = b.shape[1]
    sparse = b_meta is not None
    a_dt, b_dt = _build.pair_codes(a, b, "parent", sparse=sparse)
    scales = [mm._scale_vec(kw.get(k), n, k, a.device)
              for k, n in (("a_scale", Mr), ("b_scale", N), ("bg_scale", N))]
    out_dtype = kw.get("out_dtype") or a.dtype
    out = torch.empty((Mr, N), dtype=out_dtype, device=a.device)
    bias, res, gate = kw.get("bias"), kw.get("residual"), kw.get("b_gate")
    head = [a.data_ptr(), b.data_ptr(), mm._ptr(gate)]
    if sparse:
        head += [b_meta.data_ptr(), mm._ptr(bg_meta)]
    args = [*head, *(mm._ptr(t) for t in scales), mm._ptr(bias),
            0 if bias is None else _build.dtype_code(bias.dtype, "bias"), mm._ptr(res),
            0 if res is None else _build.dtype_code(res.dtype, "residual"), out.data_ptr(),
            _build.dtype_code(out_dtype, "out_dtype"), Mr, N, K, a_dt, b_dt,
            mm.ACT_CODES[ep.activation], int(ep.out_scale is not None),
            float(ep.out_scale or 0.0),
            *(mm.decode_launch_tile(a, b, gate) if dense else _build.gemm_tile(Mr))]
    flags = None
    if abft is not None:
        flags = torch.zeros((1, -(-N // 16)), dtype=torch.int32, device=a.device)
        args += [flags.data_ptr(), None, None, None, abft.rtol, abft.atol]
    err = fn(*args, _build.stream_ptr(a))
    if err:
        raise RuntimeError(f"the parent's launch failed ({err})")
    return out if flags is None else (out, flags)


def sparse_row(torch, cs, parent, pol, K, N, ep_kw, seed, label):
    """One 2:4 row: the launch, the dense decode tile on expand_24's weight,
    the parent's kernel."""
    from repro_torch.kernels import mx_matmul as mm
    from repro_torch.kernels.sparse import expand_24, sparse_b_bytes_per_elem

    gen = torch.Generator(device="cuda").manual_seed(seed)
    gated = ep_kw.get("activation") == "swiglu"
    a0, (qb0, _, _), _ = cs._sparse_operands(torch, "cuda", pol, M, K, N, gated, gen)
    nmat = 2 if gated else 1
    nbytes = nmat * K * N * sparse_b_bytes_per_elem(qb0.element_size())
    sets = []
    for _ in range(cs._copies(nbytes)):
        a, (qb, bs, bm), (qg, gs, gm) = cs._sparse_operands(torch, "cuda", pol, M, K, N,
                                                            gated, gen)
        od = torch.float32 if qb.dtype == torch.int8 else a.dtype
        ep = mm.Epilogue(**ep_kw, b_scale=bs is not None)
        kw = dict(epilogue=ep, b_gate=qg, b_scale=bs, bg_scale=gs, out_dtype=od,
                  bias=torch.randn((N,), generator=gen, device="cuda").to(od)
                  if ep.bias else None,
                  residual=torch.randn((M, N), generator=gen, device="cuda").to(od)
                  if ep.residual else None)
        dense = dict(kw, b_gate=expand_24(qg, gm) if gated else None)
        sets.append((a, qb, bm, gm, kw, expand_24(qb, bm), dense))

    def change(a, qb, bm, gm, kw, db, dkw):
        return mm.mx_matmul_fused(a, qb, b_sparse=True, b_meta=bm, bg_meta=gm, **kw)

    def dense(a, qb, bm, gm, kw, db, dkw):
        return mm.mx_matmul_fused(a, db, **dkw)

    fns = dict(change=(change, sets), dense=(dense, sets))
    got = change(*sets[0])
    ok = bool(torch.equal(got, dense(*sets[0])))
    if parent is not None:
        def old(a, qb, bm, gm, kw, db, dkw):
            return parent_call(torch, parent["mx_matmul_sparse"], a, qb, kw, bm, gm)

        def old_dense(a, qb, bm, gm, kw, db, dkw):
            return parent_call(torch, parent["mx_matmul"], a, db, dkw, dense=True)
        ok = ok and bool(torch.equal(old(*sets[0]), got))
        ok = ok and bool(torch.equal(old_dense(*sets[0]), got))
        fns["parent"] = (old, sets)
        fns["parent_dense"] = (old_dense, sets)
    if not ok:
        raise AssertionError(f"{label} {pol}: the 2:4 launch is not bitwise the dense "
                             f"decode tile and the parent's kernel")
    a, qb, bm, gm = sets[0][:4]
    tile = mm.decode_launch_tile(a, qb, sets[0][4]["b_gate"], bm, gm, "sparse")
    return dict(row=label, variant="sparse", pol=pol, M=M, K=K, N=N, epilogue=ep_kw,
                tile=tile, weight_bytes=nbytes, **timed(torch, cs, fns, "dense"))


def abft_row(torch, cs, parent, pol, K, N, ep_kw, seed, label):
    """One ABFT row: on, off, the parent's kernel on."""
    from repro_torch.kernels import mx_matmul as mm

    gen = torch.Generator(device="cuda").manual_seed(seed)
    gated = ep_kw.get("activation") == "swiglu"
    nbytes = (2 if gated else 1) * K * N * 4
    sets = []
    for _ in range(cs._copies(nbytes)):
        x, a_s, (w, bs), (wg, gs) = cs._dense_pair(torch, "cuda", pol, M, K, N, gated, gen)
        ep = mm.Epilogue(**ep_kw, a_scale=a_s is not None, b_scale=bs is not None)
        kw = dict(epilogue=ep, b_gate=wg, a_scale=a_s, b_scale=bs, bg_scale=gs,
                  out_dtype=torch.float32,
                  residual=torch.randn((M, N), generator=gen, device="cuda")
                  if ep.residual else None)
        sets.append((x, w, kw, mm.abft_spec_for(x, w)))

    def on(x, w, kw, spec):
        return mm.mx_matmul_fused(x, w, abft=spec, **kw)

    def off(x, w, kw, spec):
        return mm.mx_matmul_fused(x, w, **kw)

    fns = dict(change=(on, sets), off=(off, sets))
    got, flags = on(*sets[0])
    ok = bool(torch.equal(got, off(*sets[0]))) and not bool(flags.any())
    if parent is not None:
        def old(x, w, kw, spec):
            return parent_call(torch, parent["mx_matmul_abft"], x, w, kw, abft=spec)

        def old_dense(x, w, kw, spec):
            return parent_call(torch, parent["mx_matmul"], x, w, kw, dense=True)
        pout, pflags = old(*sets[0])
        ok = ok and bool(torch.equal(pout, got)) and bool(torch.equal(pflags, flags))
        ok = ok and bool(torch.equal(old_dense(*sets[0]), got))
        fns["parent"] = (old, sets)
        fns["parent_dense"] = (old_dense, sets)
    if not ok:
        raise AssertionError(f"{label} {pol}: ABFT on is not bitwise off (no flag) and "
                             f"the parent's kernel")
    x, w, kw, _ = sets[0]
    tile = mm.decode_launch_tile(x, w, kw["b_gate"], variant="abft")
    return dict(row=label, variant="abft", pol=pol, M=M, K=K, N=N, epilogue=ep_kw,
                tile=tile, **timed(torch, cs, fns, "off"))


def timed(torch, cs, fns, base):
    """Median ms per call of each version, every window, and the ratios."""
    import statistics

    keyed = {f"k{i}": v for i, v in enumerate(fns.values())}
    per = cs._time_ms(torch, keyed)["windows_ms"]
    windows = {name: per[f"k{i}"] for i, name in enumerate(fns)}
    ms = {name: statistics.median(w) for name, w in windows.items()}
    out = dict(ms=ms, windows_ms=windows, vs_base=ms["change"] / ms[base])
    if "parent" in ms:
        out["parent_over_change"] = ms["parent"] / ms["change"]
        out["dense_vs_parent_dense"] = ms[base] / ms["parent_dense"]
    return out


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--parent", type=Path, default=None)
    args = ap.parse_args()
    sys.path.insert(0, str(ROOT / "src"))
    sys.path.insert(0, str(ROOT))
    import torch

    import chip_smoke as cs
    from repro_torch.kernels import _build

    if not torch.cuda.is_available():
        print("decode_variants: no CUDA device is visible", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         check=True).stdout.strip().splitlines()[0]
    t0 = time.perf_counter()
    jobs = start_parent(_build._nvcc(), args.parent) if args.parent else None
    _build.build_all(["mx_matmul", "mx_matmul_sparse", "mx_matmul_abft"])
    parent = finish_parent(jobs) if jobs else None
    print(json.dumps(dict(device=smi, build_s=time.perf_counter() - t0,
                          parent=str(args.parent) if args.parent else None)), flush=True)
    seed = 900
    rows = []
    for pol in cs.SPARSE_POLICIES:  # phase 3s's decode rows
        for K, N, ep in ((2048, 8192, dict(activation="swiglu")),
                         (8192, 2048, dict(residual=True)), (8192, 2048, {}),
                         (896, 128, dict(bias=True))):
            seed += 1
            rows.append(sparse_row(torch, cs, parent, pol, K, N, ep, seed, "3s"))
            print(json.dumps(rows[-1]), flush=True)
    for pol in cs.ABFT_PAIRS:  # phase 3a's decode rows
        seed += 1
        rows.append(abft_row(torch, cs, parent, pol, 2048, 8192, dict(activation="swiglu"),
                             seed, "3a"))
        print(json.dumps(rows[-1]), flush=True)
    for name, K, N, ep in LLAMA:  # the GEMMs of (g), (h) and (i)'s decode steps
        for pol in ("sparse24 f32", "sparse24_int8"):
            seed += 1
            rows.append(sparse_row(torch, cs, parent, pol, K, N, ep, seed, f"llama {name}"))
            print(json.dumps(rows[-1]), flush=True)
        seed += 1
        rows.append(abft_row(torch, cs, parent, "f32", K, N, ep, seed, f"llama {name}"))
        print(json.dumps(rows[-1]), flush=True)
    step = {}
    for r in rows:
        if r["row"].startswith("llama"):
            key = r["pol"] if r["variant"] == "sparse" else "abft f32"
            s = step.setdefault(key, {k: 0.0 for k in r["ms"]})
            for k, v in r["ms"].items():
                s[k] += v
    # 16 layers: one decode step's fused GEMMs (the tied head is dense)
    print(json.dumps(dict(step_ms_16_layers={k: {n: 16 * v for n, v in s.items()}
                                             for k, s in step.items()},
                          seconds=time.perf_counter() - t0)))
    slower = [r for r in rows if r.get("parent_over_change", math.inf) <= 1.0]
    dense = [r["dense_vs_parent_dense"] for r in rows if "dense_vs_parent_dense" in r]
    print(json.dumps(dict(rows=len(rows), not_faster_than_parent=[
        (r["row"], r["pol"], r["K"], r["N"]) for r in slower],
        dense_over_parent_dense=[min(dense), max(dense)] if dense else None)))
    return 0


if __name__ == "__main__":
    sys.exit(main())
