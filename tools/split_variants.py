"""Where the paged attention's and the SSD scan's time goes: time
`mx_flash_decode` / `mx_flash_verify` at every cluster size, ring depth
and span length of their split, and `ssd_scan`, beside an earlier checkout's kernels, on
the card (one JSON line per shape):

    PYTHONPATH=src python tools/split_variants.py [--parent <checkout>]

A bring-up tool, not part of the package.  The package's kernels are built
by `kernels/_build`; with `--parent`, that checkout's
csrc/mx_flash_decode.cu and csrc/ssd_scan.cu are compiled too (one nvcc
each, started together, into `build/split_variants/`), loaded with ctypes
and called through their own C launchers on the same inputs.  Shapes:
llama3.2-1b's decode (B = 8, H = 32 / 8, d = 64, pages of 16, lengths to
160; f32 pages), the same at 2048 positions per slot (f32 and bf16 pages),
a k = 4 verify window (S = 5), and zamba2-2.7b's scan (8 x 80 heads, L =
512, P = S = 64, chunk 128; f32 and bf16); and the paged attention's
timing variants (FLASH_SPLIT_TIMING_NO_MATH: no per-span arithmetic;
FLASH_SPLIT_TIMING_NO_CLUSTER: every CTA folds only its own spans, with no
cluster barrier; wrong results) at the table's launch.  Every kernel is first held
against its plain version (f32 within 1e-4 * max|ref|, bf16 2e-2).  Times:
`chip_smoke._time_ms` (CUDA events, the median of 5 windows of 20 calls,
inputs past L2, each window behind a spin kernel, the versions taking turns
window by window).
"""
from __future__ import annotations

import argparse
import ctypes
import json
import math
import statistics
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
OUT = ROOT / "build" / "split_variants"
FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3", "-shared",
         "-Xcompiler", "-fPIC")
P, I, F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
LLAMA = (128, 160, 0, 97, 143, 1, 129, 150)


def build_parent(nvcc: str, parent: Path) -> dict:
    """name -> the parent's loaded library, both nvcc started together."""
    OUT.mkdir(parents=True, exist_ok=True)
    pc = parent / "src" / "repro_torch" / "csrc"
    jobs = {}
    for name in ("mx_flash_decode", "ssd_scan"):
        lib = OUT / f"parent_{name}.so"
        cmd = [nvcc, *FLAGS, "-I", str(pc), "-o", str(lib), str(pc / f"{name}.cu")]
        jobs[name] = (lib, subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                            stderr=subprocess.STDOUT, text=True))
    libs = {}
    for name, (lib, p) in jobs.items():
        out, _ = p.communicate()
        if p.returncode:
            raise RuntimeError(f"nvcc failed for the parent's {name}:\n{out[-3000:]}")
        libs[name] = ctypes.CDLL(str(lib))
    return libs


def medians(torch, chip_smoke, fns: dict) -> dict:
    """name -> median ms per call of `name -> (fn, arg_sets)`."""
    keyed = {f"k{i}": v for i, v in enumerate(fns.values())}
    per = chip_smoke._time_ms(torch, keyed)["windows_ms"]
    return {name: statistics.median(per[f"k{i}"]) for i, name in enumerate(fns)}


def paged(torch, chip_smoke, parent, label, lengths, dtype_name, S=None):
    """The split at its table's launch and at every cluster size (ring as
    the table picks it, and every ring at the table's cluster), beside the
    parent's kernel."""
    from repro_torch.kernels import _build
    from repro_torch.kernels.mx_flash_decode import _launch, mx_flash_decode, mx_flash_verify
    from repro_torch.kernels.ref import paged_decode_ref, paged_verify_ref

    B, H, Hkv, d, ps = 8, 32, 8, 64, 16
    sets, table, lns, W, nbytes = chip_smoke._attn_inputs(
        torch, "cuda", B, H, Hkv, d, ps, lengths, dtype_name, 120, False, "same", S=S)
    fn = mx_flash_decode if S is None else mx_flash_verify
    ref_fn = paged_decode_ref if S is None else paged_verify_ref
    q, kp, vp, _ = sets[0]
    ref = ref_fn(q, kp, vp, table, lns).float()
    tol = (1e-4 if dtype_name == "float32" else 2e-2) * ref.abs().max().item()
    base = _build.decode_split(B, S or 1, Hkv, H // Hkv, d, ps, W, kp.dtype, False)
    splits = {"table": base}
    for c in range(1, 9):
        splits[f"cluster {c}"] = base._replace(cluster=c)
    for r in (1, 2, 3):
        splits[f"ring {r}"] = base._replace(ring=r)
    for n in (1, 2, 3, 4):
        for r in (1, 2):
            splits[f"group {n} ring {r}"] = base._replace(group=n, ring=r)
    for n in (1, 2, 4, 8):  # other span lengths (other bits: timing only)
        splits[f"span {n}"] = base._replace(span_pages=n)
    fns, err = {}, {}
    for name, sp in list(splits.items()):
        smem = _build.decode_split_smem(H // Hkv, d, ps, kp.dtype.itemsize, False,
                                        sp.span_pages, sp.group, sp.ring, sp.cluster, W)
        if smem > _build.SMEM_PER_CTA:  # a variant past a block's shared memory
            del splits[name]
            continue

        def call(q_, k_, v_, kw_, sp=sp):
            qq = q_[:, None] if S is None else q_
            return _launch(fn, qq, k_, v_, table, lns, None, None, sp)
        got = call(*sets[0])
        err[name] = ((got[:, 0] if S is None else got).float() - ref).abs().max().item()
        if err[name] > tol:
            raise AssertionError(f"{label} {name}: error {err[name]} past {tol}")
        fns[name] = (call, sets)
    if parent is not None:
        lib = parent["mx_flash_decode"]
        dq = dp = _build.dtype_code(q.dtype, "q")
        if S is None:
            pf = lib.mx_flash_decode_launch
            pf.argtypes = [P] * 8 + [I] * 8 + [F, P]
        else:
            pf = lib.mx_flash_verify_launch
            pf.argtypes = [P] * 8 + [I] * 9 + [F, P]

        def old(q_, k_, v_, kw_):
            out = torch.empty_like(q_)
            dims = (B, H, Hkv, d, ps, W) if S is None else (B, S, H, Hkv, d, ps, W)
            e = pf(q_.data_ptr(), k_.data_ptr(), v_.data_ptr(), None, None, table.data_ptr(),
                   lns.data_ptr(), out.data_ptr(), *dims, dq, dp, 1.0 / math.sqrt(d),
                   torch.cuda.current_stream().cuda_stream)
            if e:
                raise RuntimeError(f"the parent's launch failed ({e})")
            return out
        err["parent"] = (old(*sets[0]).float() - ref).abs().max().item()
        fns["parent"] = (old, sets)
    ms = medians(torch, chip_smoke, fns)
    return dict(label=label, S=S, dtype=dtype_name, lengths=list(lengths), W=W,
                bytes=nbytes, bound_ms=chip_smoke._bound_ms(nbytes, 0, dtype_name)[0],
                table=base._asdict(), err=err, ms=ms)


TIMING = {"no math": "FLASH_SPLIT_TIMING_NO_MATH",
          "no cluster": "FLASH_SPLIT_TIMING_NO_CLUSTER"}


def timing_variants(torch, chip_smoke, label, lengths, S=None):
    """The table's launch beside csrc/mx_flash_decode.cu's timing variants
    (wrong results): without the per-span arithmetic, and with every CTA
    folding only its own spans (no cluster barrier)."""
    from repro_torch.kernels import _build
    from repro_torch.kernels.mx_flash_decode import _ARGTYPES

    B, H, Hkv, d, ps = 8, 32, 8, 64, 16
    sets, table, lns, W, _ = chip_smoke._attn_inputs(
        torch, "cuda", B, H, Hkv, d, ps, lengths, "float32", 121, False, "same", S=S)
    sp = _build.decode_split(B, S or 1, Hkv, H // Hkv, d, ps, W, torch.float32, False)
    fns = {}
    for name, macro in {"table": None, **TIMING}.items():
        fn = _build.function("mx_flash_decode", "mx_flash_paged_launch", _ARGTYPES,
                             defines=() if macro is None else (macro,))

        def call(q_, k_, v_, kw_, fn=fn):
            out = torch.empty_like(q_)
            e = fn(q_.data_ptr(), k_.data_ptr(), v_.data_ptr(), None, None, table.data_ptr(),
                   lns.data_ptr(), out.data_ptr(), B, S or 1, H, Hkv, d, ps, W, 0, 0,
                   1.0 / math.sqrt(d), sp.span_pages, sp.group, sp.ring, sp.cluster,
                   torch.cuda.current_stream().cuda_stream)
            if e:
                raise RuntimeError(f"{name}: launch failed ({e})")
            return out
        fns[name] = (call, sets)
    return dict(label=f"{label} timing variants", S=S, table=sp._asdict(),
                ms=medians(torch, chip_smoke, fns))


def scan(torch, chip_smoke, parent, dtype_name):
    """ssd_scan at zamba2's 8 x 80 heads, L = 512, beside the parent's."""
    from repro_torch.kernels import _build
    from repro_torch.kernels.ref import ssd_scan_plain
    from repro_torch.kernels.ssd_scan import ssd_scan

    B, L, H, G, Pd, Sd, Q = 8, 512, 80, 1, 64, 64, 128
    dt = getattr(torch, dtype_name)
    g = torch.Generator(device="cuda").manual_seed(1)

    def inputs():
        return ((torch.randn((B, L, H, Pd), generator=g, device="cuda")).to(dt),
                -torch.rand((B, L, H), generator=g, device="cuda") * 0.3,
                (torch.randn((B, L, G, Sd), generator=g, device="cuda") * 0.3).to(dt),
                (torch.randn((B, L, G, Sd), generator=g, device="cuda") * 0.3).to(dt))

    sets = [inputs() for _ in range(2)]
    ref = ssd_scan_plain(*sets[0], Q).float()
    tol = (1e-4 if dtype_name == "float32" else 2e-2) * ref.abs().max().item()
    fns = {"kernel": (lambda *a: ssd_scan(*a, chunk=Q), sets)}
    err = {"kernel": (ssd_scan(*sets[0], chunk=Q).float() - ref).abs().max().item()}
    if err["kernel"] > tol:
        raise AssertionError(f"ssd_scan {dtype_name}: error {err['kernel']} past {tol}")
    if parent is not None:
        pf = parent["ssd_scan"].ssd_scan_launch
        pf.argtypes = [P] * 5 + [I] * 8 + [P]
        code = _build.dtype_code(dt, "x")

        def old(x, a, b, c):
            y = torch.empty_like(x)
            e = pf(x.data_ptr(), a.data_ptr(), b.data_ptr(), c.data_ptr(), y.data_ptr(), B, L,
                   H, G, Pd, Sd, Q, code, torch.cuda.current_stream().cuda_stream)
            if e:
                raise RuntimeError(f"the parent's ssd_scan failed ({e})")
            return y
        err["parent"] = (old(*sets[0]).float() - ref).abs().max().item()
        fns["parent"] = (old, sets)
    return dict(label="zamba2 L=512", dtype=dtype_name, tile=_build.ssd_tile(Q, Pd, Sd, dt)
                ._asdict(), err=err, ms=medians(torch, chip_smoke, fns))


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--parent", type=Path, default=None)
    args = ap.parse_args()
    sys.path.insert(0, str(ROOT / "src"))
    sys.path.insert(0, str(ROOT))
    import torch

    import chip_smoke
    from repro_torch.kernels import _build

    if not torch.cuda.is_available():
        print("split_variants: no CUDA device is visible", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         check=True).stdout.strip().splitlines()[0]
    t0 = time.perf_counter()
    _build.build_all(["mx_flash_decode", "ssd_scan"],
                     [("mx_flash_decode", (m,)) for m in TIMING.values()])
    parent = build_parent(_build._nvcc(), args.parent) if args.parent else None
    print(json.dumps(dict(device=smi, build_s=time.perf_counter() - t0)), flush=True)
    for label, lengths, dtype_name, S in (
            ("llama decode", LLAMA, "float32", None),
            ("long context", (2048,) * 8, "float32", None),
            ("long context", (2048,) * 8, "bfloat16", None),
            ("llama verify", tuple(n + 5 if n else 0 for n in LLAMA), "float32", 5)):
        print(json.dumps(paged(torch, chip_smoke, parent, label, lengths, dtype_name, S)),
              flush=True)
    for label, lengths, S in (("llama decode", LLAMA, None),
                              ("long context", (2048,) * 8, None),
                              ("llama verify", tuple(n + 5 if n else 0 for n in LLAMA), 5)):
        print(json.dumps(timing_variants(torch, chip_smoke, label, lengths, S)), flush=True)
    for dtype_name in ("float32", "bfloat16"):
        print(json.dumps(scan(torch, chip_smoke, parent, dtype_name)), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
