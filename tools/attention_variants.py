"""Where the attention kernels' time goes: time `mx_flash_attention` at its
CTA tiles and timing variants, and `mx_flash_verify`, on the card, beside
an earlier checkout's kernels and SDPA (one JSON line per shape):

    PYTHONPATH=src python tools/attention_variants.py [--parent <checkout>]

A bring-up tool, not part of the package.  csrc/mx_flash_attention.cu is
compiled three ways (one nvcc each, all started together, into
`build/attention_variants/`): "full" (as committed), "copies"
(FLASH_TIMING_NO_PRODUCTS: the copy ring and the softmax without the
MMAs) and "products" (FLASH_TIMING_NO_COPIES: no copies once the ring is
primed); wrong results, timing only.  With `--parent`, that checkout's
csrc/mx_flash_attention.cu and csrc/mx_flash_decode.cu are compiled too and
their kernels timed on the same inputs.  Each library is loaded with
ctypes and called through its C launcher.  "full" is first held against
`flash_attention_plain` (f32 within 1e-4 * max|ref|, bf16 2e-2) at every
tile.  Shapes: zamba2-2.7b's shared block (B = 8, H = 32, d = 80, L = 512,
causal; f32 and bf16) and the llama draft forward (B = 4, H = 32 / 8,
d = 64, L = 256, f32), at (warps, stages) in TILES; verify at llama's
window (B = 8, S = 5, H = 32 / 8, d = 64, lengths to 160 + 5) over f32 and
fp8 pages (the split's cluster sizes and groups: tools/split_variants.py).
Times: CUDA events, the median of 5 windows of 20 calls, each window
behind a spin kernel that outlasts its enqueue, the versions taking turns
window by window; SDPA on (B, H, L, d) views as the yardstick.
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
CSRC = ROOT / "src" / "repro_torch" / "csrc"
OUT = ROOT / "build" / "attention_variants"
FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3", "-shared",
         "-Xcompiler", "-fPIC")
VARIANTS = {"full": None, "copies": "FLASH_TIMING_NO_PRODUCTS",
            "products": "FLASH_TIMING_NO_COPIES"}
TILES = ((4, 2), (4, 3), (8, 2), (8, 3))
P, I, F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float


def build(nvcc: str, parent: Path | None) -> dict:
    """name -> loaded library, every nvcc started together."""
    OUT.mkdir(parents=True, exist_ok=True)
    jobs = {}
    srcs = {v: (CSRC / "mx_flash_attention.cu", CSRC, m) for v, m in VARIANTS.items()}
    if parent is not None:
        pc = parent / "src" / "repro_torch" / "csrc"
        srcs["parent attention"] = (pc / "mx_flash_attention.cu", pc, None)
        srcs["parent decode"] = (pc / "mx_flash_decode.cu", pc, None)
    for name, (src, inc, macro) in srcs.items():
        lib = OUT / (name.replace(" ", "_") + ".so")
        cmd = [nvcc, *FLAGS, *(() if macro is None else (f"-D{macro}",)), "-I", str(inc),
               "-o", str(lib), str(src)]
        jobs[name] = (lib, subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                            stderr=subprocess.STDOUT, text=True))
    libs = {}
    for name, (lib, p) in jobs.items():
        out, _ = p.communicate()
        if p.returncode:
            raise RuntimeError(f"nvcc failed for {name}:\n{out[-3000:]}")
        libs[name] = ctypes.CDLL(str(lib))
    return libs


def timeit(torch, fns: dict, windows=5, iters=20) -> dict:
    """name -> median ms per call; the functions take turns window by window."""
    for fn in fns.values():
        fn()
    torch.cuda.synchronize()
    host = {}
    for name, fn in fns.items():
        t0 = time.perf_counter()
        for _ in range(3):
            fn()
        host[name] = (time.perf_counter() - t0) / 3
        torch.cuda.synchronize()
    per = {name: [] for name in fns}
    for _ in range(windows):
        for name, fn in fns.items():
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            torch.cuda._sleep(int(1.5 * iters * host[name] * 2.0e9) + 100_000)
            start.record()
            for _ in range(iters):
                fn()
            end.record()
            end.synchronize()
            per[name].append(start.elapsed_time(end) / iters)
    return {name: sorted(v)[len(v) // 2] for name, v in per.items()}


def attention(torch, libs, label, B, L, H, Hkv, d, dtype, seed):
    import torch.nn.functional as Fn

    from repro_torch.kernels import _build
    from repro_torch.kernels.ref import flash_attention_plain

    g = torch.Generator(device="cuda").manual_seed(seed)
    q = torch.randn((B, L, H, d), generator=g, device="cuda").to(dtype)
    k = torch.randn((B, L, Hkv, d), generator=g, device="cuda").to(dtype)
    v = torch.randn((B, L, Hkv, d), generator=g, device="cuda").to(dtype)
    out = torch.empty_like(q)
    dt = _build.dtype_code(dtype, "q")
    scale = 1.0 / math.sqrt(d)
    stream = torch.cuda.current_stream().cuda_stream
    ref = flash_attention_plain(q, k, v, causal=True).float()
    tol = (1e-4 if dtype == torch.float32 else 2e-2) * ref.abs().max().item()
    res = dict(label=label, B=B, L=L, H=H, Hkv=Hkv, d=d, dtype=str(dtype).split(".")[1],
               ctas={}, err={}, ms={})
    fns = {}
    for variant in VARIANTS:
        fn = libs[variant].mx_flash_attention_launch
        fn.argtypes = [P] * 4 + [I] * 8 + [F, I, I, P]
        for warps, stages in TILES:
            def call(fn=fn, warps=warps, stages=stages):
                err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), B, L, L,
                         H, Hkv, d, 1, dt, scale, warps, stages, stream)
                if err:
                    raise RuntimeError(f"launch failed ({err}) at {warps} warps {stages}")
            name = f"{variant} {warps}x{stages}"
            if variant == "full":
                call()
                torch.cuda.synchronize()
                e = (out.float() - ref).abs().max().item()
                res["err"][name] = e
                if e > tol:
                    raise AssertionError(f"{label} {name}: error {e} past {tol}")
                res["ctas"][name] = B * H * -(-L // (16 * warps))
            fns[name] = call
    if "parent attention" in libs:
        fn = libs["parent attention"].mx_flash_attention_launch
        fn.argtypes = [P] * 4 + [I] * 8 + [F, P]
        fns["parent"] = lambda: fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
                                   B, L, L, H, Hkv, d, 1, dt, scale, stream)
    qt, kt, vt = (t.transpose(1, 2) for t in (q, k, v))
    fns["sdpa"] = lambda: Fn.scaled_dot_product_attention(qt, kt, vt, is_causal=True,
                                                          enable_gqa=H != Hkv)
    res["ms"] = timeit(torch, fns)
    return res


def verify(torch, libs, pages):
    """mx_flash_verify at llama's window against the parent's kernel and SDPA."""
    import torch.nn.functional as Fn

    sys.path.insert(0, str(ROOT))
    import chip_smoke
    from repro_torch.kernels import _build
    from repro_torch.kernels.mx_flash_decode import mx_flash_verify

    S, lengths = 5, (128, 160, 0, 97, 143, 1, 129, 150)
    wl = tuple(n + S if n else 0 for n in lengths)
    sets, table, lns, W, _ = chip_smoke._attn_inputs(torch, "cuda", 8, 32, 8, 64, 16, wl,
                                                     "float32", 104, False, pages, S=S)
    q, kp, vp, kw = sets[0]
    out = torch.empty_like(q)
    equal_parent = None
    fns = {"kernel": lambda: mx_flash_verify(q, kp, vp, table, lns, **kw)}
    dp = _build.dtype_code(kp.dtype, "pages", (torch.float32, torch.float8_e4m3fn))
    ks = kw["k_scale"].data_ptr() if kw else None
    vs = kw["v_scale"].data_ptr() if kw else None
    stream = torch.cuda.current_stream().cuda_stream
    for name in ["parent decode"]:
        if name not in libs:
            continue
        fn = libs[name].mx_flash_verify_launch
        fn.argtypes = [P] * 8 + [I] * 9 + [F, P]
        fns[name] = lambda fn=fn: fn(q.data_ptr(), kp.data_ptr(), vp.data_ptr(), ks, vs,
                                     table.data_ptr(), lns.data_ptr(), out.data_ptr(), 8, S,
                                     32, 8, 64, 16, W, 0, dp, 0.125, stream)
    if "parent decode" in libs:
        fns["parent decode"]()
        equal_parent = bool(torch.equal(out, fns["kernel"]()))
    if pages == "same":
        kpos = torch.arange(W * 16, device="cuda")
        last = (lns - S)[:, None] + torch.arange(S, device="cuda")
        mask = (kpos[None, None, :] <= last[:, :, None])[:, None]
        qd = q.transpose(1, 2)
        kd, vd = chip_smoke._dense_kv(torch, table, kp, vp, 4)
        fns["sdpa"] = lambda: Fn.scaled_dot_product_attention(qd, kd, vd, attn_mask=mask)
    return dict(pages=pages, ctas=8 * 8 * S, equal_parent=equal_parent,
                ms=timeit(torch, fns))


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--parent", type=Path, default=None)
    args = ap.parse_args()
    sys.path.insert(0, str(ROOT / "src"))
    import torch

    from repro_torch.kernels import _build

    if not torch.cuda.is_available():
        print("attention_variants: no CUDA device is visible", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         check=True).stdout.strip().splitlines()[0]
    t0 = time.perf_counter()
    libs = build(_build._nvcc(), args.parent)
    build_s = time.perf_counter() - t0
    print(json.dumps(dict(device=smi, build_s=build_s)), flush=True)
    for args in (("zamba2 shared block", 8, 512, 32, 32, 80, torch.float32, 5),
                 ("zamba2 shared block", 8, 512, 32, 32, 80, torch.bfloat16, 8),
                 ("llama draft", 4, 256, 32, 8, 64, torch.float32, 6)):
        print(json.dumps(attention(torch, libs, *args)), flush=True)
    for pages in ("same", "fp8"):
        print(json.dumps(verify(torch, libs, pages)), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
