"""How far the f32 GEMM routes stand from float64, per GEMM and through
xlstm-125m's forward, on the card (plain text):

    PYTHONPATH=src python tools/accumulation_witness.py

A bring-up tool, not part of the package.  Per GEMM, at xlstm-125m's
forward projections (M = 2048 rows: 768 x 3072, 1536 x 1536, 1536 x 768,
768 x 768; A ~ N(0, 1), B ~ N(0, 1 / K), seeded), each route's max / mean
absolute error, mean signed error and relative RMS error against the f64
product: the kernel (`mx_matmul_fused`, the prefill tile's 3xTF32),
cuBLAS f32 (`torch.matmul`, TF32 off) and "emul3", the same three TF32
products (lo*hi, hi*lo, hi*hi of round-to-nearest TF32 splits) summed
exactly in f64 -- the route's arithmetic without the tensor cores'
accumulation.  Then xlstm-125m at full width (weights from seed 0) on 4 x
512 tokens, its logits against its plain path in f64 (weights, states and
GEMMs in f64) for the kernel path, the plain path, the plain path with
each GEMM's K summed in two halves, and the plain path with emul3 GEMMs.
`--cpu` runs the xLSTM part at smoke size on the host (no kernel).

    PYTHONPATH=src python tools/accumulation_witness.py --attention-scan [--parent <checkout>]

runs instead the f32 `mx_flash_attention` (zamba2-2.7b's shared block, B=8
H=32 d=80 L=512 causal; internvl2-26b's B=2 H=48 Hkv=8 d=128 L=1088 causal)
and `ssd_scan` (zamba2's 8 x 80 heads, P = S = 64, L = 512, chunk 128) on
inputs drawn as `chip_smoke.py` phase 3 draws them, each against an f64
reference (the softmax over whole rows; the scan's recurrence one position
at a time): the kernel's, the plain version's and, with `--parent`, the
parent checkout's kernel's distance, and their times (`chip_smoke._time_ms`:
CUDA events behind a spin, operand sets past L2).

    PYTHONPATH=src python tools/accumulation_witness.py --fp8 [--parent <checkout>]

runs instead the e4m3 x e4m3 GEMMs on "fp8_all" payloads and scales
(`core/precision.NAMED_POLICIES`, drawn as `chip_smoke.py` phase 3 draws
them): kernel 1 at llama3.2-1b's 64-row prefill chunk, the down projection
(K = 8192, N = 2048) and the up + gate projection (K = 2048, N = 8192,
swiglu), and kernel 5 at grok-1's decode down projection (8 experts x 8
rows, K = 32768, N = 6144), each output's max and relative-RMS distance to
the f64 computation of the same payloads and scales (the swiglu in f64
too), for the kernel (two f16 products of the exactly widened operands per
k32 step), the plain version and, with `--parent`, the parent checkout's
kernel (its gemm_tile.cuh CUDA-core loop on its own tiles); the gate is the
kernel at most twice the plain version's distance.
"""
from __future__ import annotations

import contextlib
import ctypes
import json
import math
import statistics
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
SHAPES = ((768, 3072), (1536, 1536), (1536, 768), (768, 768))  # (K, N)


def _rna_tf32(torch, x):
    """x rounded to TF32 (10 mantissa bits), to nearest, ties away (cvt.rna)."""
    i = x.contiguous().view(torch.int32)
    return ((i + 0x1000) & ~0x1FFF).view(torch.float32)


def emul3(torch, a, b):
    """3xTF32 with exact sums: lo*hi + hi*lo + hi*hi in f64, rounded to f32."""
    def split(x):
        hi = _rna_tf32(torch, x.float())
        return hi, _rna_tf32(torch, x.float() - hi)

    (ah, al), (bh, bl) = split(a), split(b)
    d = lambda u, v: torch.matmul(u.double(), v.double())  # noqa: E731
    return (d(al, bh) + d(ah, bl) + d(ah, bh)).float()


@contextlib.contextmanager
def plain_with(torch, dot):
    """The plain path ("torch") with the MX dispatch's GEMMs computed by `dot`."""
    from repro_torch.core import ops

    orig = ops.dot_f32
    ops.dot_f32 = dot
    try:
        with ops.use_policy(ops.MXPolicy("torch")), torch.no_grad():
            yield
    finally:
        ops.dot_f32 = orig


@contextlib.contextmanager
def plain_f64(torch):
    """The plain path in float64: the default dtype f64 (states, maxima),
    every `.float()` of the model code left at f64, the GEMMs f64."""
    to_f32, default = torch.Tensor.float, torch.get_default_dtype()
    torch.Tensor.float = lambda t, *a, **k: t if t.dtype == torch.float64 else to_f32(t, *a, **k)
    torch.set_default_dtype(torch.float64)
    try:
        with plain_with(torch, lambda a, b: torch.matmul(a.double(), b.double())):
            yield
    finally:
        torch.Tensor.float = to_f32
        torch.set_default_dtype(default)


def widened(tree):
    """A nested dict of tensors with every float tensor in f64."""
    if isinstance(tree, dict):
        return {k: widened(v) for k, v in tree.items()}
    return tree.double() if tree.is_floating_point() else tree


def _stats(x, ref):
    d = x.double() - ref.double()
    return (f"max {d.abs().max().item():.3e} mean {d.abs().mean().item():.3e} "
            f"bias {d.mean().item():+.2e} relrms "
            f"{(d.pow(2).mean().sqrt() / ref.double().pow(2).mean().sqrt()).item():.2e}")


def gemms(torch, dev):
    from repro_torch.kernels import mx_matmul as mm

    for K, N in SHAPES:
        g = torch.Generator(device=dev).manual_seed(K + N)
        a = torch.randn((2048, K), generator=g, device=dev)
        b = torch.randn((K, N), generator=g, device=dev) / math.sqrt(K)
        ref = torch.matmul(a.double(), b.double())
        rows = dict(kernel=mm.mx_matmul_fused(a, b), cublas=torch.matmul(a, b),
                    emul3=emul3(torch, a, b))
        print(f"M=2048 K={K} N={N} " + " | ".join(f"{k}: {_stats(v, ref)}"
                                                  for k, v in rows.items()), flush=True)


def forward(torch, dev, name, B, L):
    from repro_torch.configs import get_config
    from repro_torch.core import ops
    from repro_torch.launch.steps import make_prefill_step
    from repro_torch.models import build_model

    def halves(a, b):
        k = a.shape[-1] // 2
        return (torch.matmul(a[..., :k].float(), b[:k].float())
                + torch.matmul(a[..., k:].float(), b[k:].float()))

    cfg = get_config(name)
    model = build_model(cfg)
    params = model.init(0, device=dev)
    toks = torch.randint(0, cfg.vocab, (B, L), device=dev,
                         generator=torch.Generator(device=dev).manual_seed(0))
    step = make_prefill_step(model, cfg)
    with plain_f64(torch):
        ref = step(widened(params), {"tokens": toks})
    assert ref.dtype == torch.float64, ref.dtype
    out = {}
    for what, dot in (("plain", ops.dot_f32), ("halves", halves),
                      ("emul3", lambda a, b: emul3(torch, a, b))):
        with plain_with(torch, dot):
            out[what] = step(params, {"tokens": toks})
    if dev.type == "cuda":
        with ops.use_policy(ops.MXPolicy("cuda_mx")), torch.no_grad():
            out["kernel"] = step(params, {"tokens": toks})
    print(f"{name} {B} x {L} tokens: max|logit| in f64 {ref.abs().max().item():.4e}")
    for what, v in out.items():
        print(f"  {what:7s} to f64: {_stats(v, ref)}; to plain max "
              f"{(v - out['plain']).abs().max().item():.3e}", flush=True)


ATTENTION_SHAPES = (("zamba2 shared block", 8, 512, 32, 32, 80),
                    ("internvl2 forward", 2, 1088, 48, 8, 128))  # (B, L, H, Hkv, d), causal
SCAN_SHAPE = ("zamba2 L=512", 8, 512, 80, 1, 64, 64, 128)  # (B, L, H, G, P, S, chunk)


def attention_f64(torch, q, k, v):
    """Causal softmax attention in f64 over whole rows: q (B, L, H, d), k
    and v (B, L, Hkv, d), query head h reading kv head h // (H / Hkv)."""
    B, L, H, d = q.shape
    heads = torch.arange(H, device=q.device) // (H // k.shape[2])
    qd = q.double().transpose(1, 2)
    kd, vd = (t.double()[:, :, heads].transpose(1, 2) for t in (k, v))
    s = torch.matmul(qd, kd.transpose(-1, -2)) / math.sqrt(d)
    mask = torch.ones((L, L), dtype=torch.bool, device=q.device).tril()
    p = torch.softmax(s.masked_fill(~mask, float("-inf")), dim=-1)
    return torch.matmul(p, vd).transpose(1, 2)


def ssd_f64(torch, x, a_log, b, c):
    """The SSD recurrence in f64, one position at a time: h_t = exp(a_t)
    h_{t-1} + b_t^T x_t, y_t = c_t h_t (head h reads group h // (H / G))."""
    B, L, H, P = x.shape
    heads = torch.arange(H, device=x.device) // (H // b.shape[2])
    xd, ad = x.double(), a_log.double()
    bd, cd = (t.double()[:, :, heads] for t in (b, c))
    h = torch.zeros((B, H, bd.shape[-1], P), dtype=torch.float64, device=x.device)
    y = torch.empty(x.shape, dtype=torch.float64, device=x.device)
    for t in range(L):
        h = torch.exp(ad[:, t])[..., None, None] * h + bd[:, t, :, :, None] * xd[:, t, :, None]
        y[:, t] = torch.einsum("bhs,bhsp->bhp", cd[:, t], h)
    return y


def _parent_launchers(parent: Path) -> dict:
    """The parent checkout's attention and scan launchers, both nvcc started
    together with the package's own flags."""
    import importlib

    from repro_torch.kernels import _build

    out = ROOT / "build" / "witness_parent"
    out.mkdir(parents=True, exist_ok=True)
    pc = parent / "src" / "repro_torch" / "csrc"
    procs = {name: subprocess.Popen(
        [_build._nvcc(), *_build.NVCC_FLAGS, "-I", str(pc), "-o", str(out / f"{name}.so"),
         str(pc / f"{name}.cu")], stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        for name in ("mx_flash_attention", "ssd_scan")}
    fns = {}
    for name, proc in procs.items():
        argtypes = importlib.import_module(f"repro_torch.kernels.{name}")._ARGTYPES
        text = proc.communicate()[0]
        if proc.returncode:
            raise RuntimeError(f"nvcc failed for the parent's {name}:\n{text[-3000:]}")
        fn = getattr(ctypes.CDLL(str(out / f"{name}.so")), f"{name}_launch")
        fn.argtypes, fn.restype = list(argtypes), ctypes.c_int
        fns[name] = fn
    return fns


def _dist(torch, got, ref):
    d = got.double() - ref
    return dict(max=d.abs().max().item(),
                relrms=(d.pow(2).mean().sqrt() / ref.pow(2).mean().sqrt()).item())


def _witness(torch, cs, what, fns, inputs, exact):
    """Distances to `exact` of each function of `fns` on one input set and
    their times over copies past L2 ("library_ms" is the parent's kernel);
    one JSON line and one plain line."""
    args = inputs()
    ref = exact(*args)
    names = {"ms": "kernel", "plain_ms": "plain", "library_ms": "parent kernel"}
    dist = {names[k]: _dist(torch, fn(*args), ref) for k, fn in fns.items()}
    torch.cuda.synchronize()
    del ref
    nbytes = sum(t.numel() * t.element_size() for t in args) * 2
    sets = [args] + [inputs() for _ in range(cs._copies(nbytes) - 1)]
    t = cs._time_ms(torch, {k: (fn, sets) for k, fn in fns.items()})
    times = {names[k]: t[k] for k in fns}
    ratio = dist["kernel"]["max"] / dist["plain"]["max"]
    print(json.dumps(dict(what=what, distance_to_f64=dist, kernel_over_plain=ratio, ms=times,
                          windows_ms={names[k]: t["windows_ms"][k] for k in fns})), flush=True)
    print(f"{what}: to f64 max " + ", ".join(f"{n} {v['max']:.3e} (relrms {v['relrms']:.2e})"
                                             for n, v in dist.items())
          + f"; kernel / plain {ratio:.2f}; ms "
          + ", ".join(f"{n} {v:.4f}" for n, v in times.items()), flush=True)


def attention_scan(torch, dev, parent):
    """The f32 attention's and scan's distances to f64 beside the plain
    versions' (and the parent checkout's kernels'), with their times."""
    sys.path.insert(0, str(ROOT))
    import chip_smoke as cs
    import importlib

    from repro_torch.kernels import _build
    from repro_torch.kernels.ref import flash_attention_plain, ssd_scan_plain
    fa = importlib.import_module("repro_torch.kernels.mx_flash_attention")
    from repro_torch.kernels.ssd_scan import ssd_scan

    old = _parent_launchers(parent) if parent is not None else {}
    for label, B, L, H, Hkv, d in ATTENTION_SHAPES:
        g = torch.Generator(device=dev).manual_seed(L + d)

        def inputs():
            return tuple(torch.randn((B, L, h, d), generator=g, device=dev)
                         for h in (H, Hkv, Hkv))

        def parent_attention(q, k, v):
            out = torch.empty_like(q)
            _build.check(old["mx_flash_attention"](
                q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), B, L, L, H, Hkv, d,
                1, 0, 1.0 / math.sqrt(d), *fa.TILES[torch.float32], _build.stream_ptr(q)),
                "mx_flash_attention", "the parent's attention")
            return out

        fns = {"ms": lambda q, k, v: fa.mx_flash_attention(q, k, v, causal=True),
               "plain_ms": lambda q, k, v: flash_attention_plain(q, k, v, causal=True)}
        if old:
            fns["library_ms"] = parent_attention
        _witness(torch, cs, f"mx_flash_attention {label} B={B} L={L} H={H} Hkv={Hkv} d={d}",
                 fns, inputs, lambda q, k, v: attention_f64(torch, q, k, v))
    label, B, L, H, G, P, S, chunk = SCAN_SHAPE
    g = torch.Generator(device=dev).manual_seed(1)

    def scan_inputs():
        return (torch.randn((B, L, H, P), generator=g, device=dev),
                -torch.rand((B, L, H), generator=g, device=dev) * 0.3,
                torch.randn((B, L, G, S), generator=g, device=dev) * 0.3,
                torch.randn((B, L, G, S), generator=g, device=dev) * 0.3)

    def parent_scan(x, a, b, c):
        y = torch.empty_like(x)
        _build.check(old["ssd_scan"](
            x.data_ptr(), a.data_ptr(), b.data_ptr(), c.data_ptr(), y.data_ptr(), B, L, H, G,
            P, S, chunk, 0, _build.ssd_tile(chunk, P, S, torch.float32).stages,
            _build.stream_ptr(x)), "ssd_scan", "the parent's scan")
        return y

    fns = {"ms": lambda *a: ssd_scan(*a, chunk=chunk),
           "plain_ms": lambda *a: ssd_scan_plain(*a, chunk)}
    if old:
        fns["library_ms"] = parent_scan
    _witness(torch, cs, f"ssd_scan {label} B={B} H={H} P={P} S={S} chunk={chunk}", fns,
             scan_inputs, lambda *a: ssd_f64(torch, *a))


def _parent_gemms(parent: Path) -> dict:
    """The parent checkout's fused and grouped GEMM entries on gemm_tile.cuh's
    CUDA-core loop (mx_matmul_fused_launch, mx_grouped_matmul_launch), both
    nvcc started together with the package's own flags."""
    from repro_torch.kernels import _build

    P, I, F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    argtypes = {
        "mx_matmul": ("mx_matmul_fused_launch",
                      (P,) * 7 + (I, P, I, P) + (I,) * 8 + (F,) + (I,) * 3 + (P,)),
        "mx_grouped_matmul": ("mx_grouped_matmul_launch", (P,) * 8 + (I,) * 11 + (P,))}
    out = ROOT / "build" / "witness_parent"
    out.mkdir(parents=True, exist_ok=True)
    pc = parent / "src" / "repro_torch" / "csrc"
    procs = {name: subprocess.Popen(
        [_build._nvcc(), *_build.NVCC_FLAGS, "-I", str(pc), "-o", str(out / f"{name}.so"),
         str(pc / f"{name}.cu")], stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        for name in argtypes}
    fns = {}
    for name, proc in procs.items():
        text = proc.communicate()[0]
        if proc.returncode:
            raise RuntimeError(f"nvcc failed for the parent's {name}:\n{text[-3000:]}")
        symbol, types = argtypes[name]
        fn = getattr(ctypes.CDLL(str(out / f"{name}.so")), symbol)
        fn.argtypes, fn.restype = list(types), ctypes.c_int
        fns[name] = fn
    return fns


def fp8(torch, dev, parent):
    """The e4m3 x e4m3 GEMMs' distances to f64 (kernel, plain, parent
    kernel) at llama's prefill chunk and grok's decode down
    projection, with their times."""
    sys.path.insert(0, str(ROOT))
    import chip_smoke as cs

    from repro_torch.core.precision import NAMED_POLICIES
    from repro_torch.kernels import _build
    from repro_torch.kernels import mx_matmul as mm
    from repro_torch.kernels.mx_grouped_matmul import mx_grouped_matmul
    from repro_torch.kernels.quant import quantize_operand
    from repro_torch.kernels.ref import grouped_matmul_ref

    P = NAMED_POLICIES["fp8_all"]
    _build.build_all(names=("mx_matmul", "mx_grouped_matmul"))
    old = _parent_gemms(parent) if parent is not None else {}
    code = _build.dtype_code(torch.float8_e4m3fn, "fp8", _build.QUANTIZED)
    for label, M, K, N, gated in (("llama M=64 down", 64, 8192, 2048, False),
                                  ("llama M=64 up+gate", 64, 2048, 8192, True)):
        g = torch.Generator(device=dev).manual_seed(K + N)

        def inputs():
            qa, a_s = quantize_operand(torch.randn((M, K), generator=g, device=dev), P.a, "a")
            qb, b_s = quantize_operand(
                torch.randn((K, N), generator=g, device=dev) / math.sqrt(K), P.b, "b")
            qg, bg_s = quantize_operand(
                torch.randn((K, N), generator=g, device=dev) / math.sqrt(K), P.b, "b")
            return qa.contiguous(), a_s, qb, b_s, qg, bg_s

        ep = mm.Epilogue(activation="swiglu" if gated else "none", a_scale=True, b_scale=True)

        def kw(a_s, b_s, qg, bg_s):
            return dict(epilogue=ep, a_scale=a_s, b_scale=b_s, out_dtype=torch.float32,
                        b_gate=qg if gated else None, bg_scale=bg_s if gated else None)

        def kernel(qa, a_s, qb, b_s, qg, bg_s):
            return mm.mx_matmul_fused(qa, qb, **kw(a_s, b_s, qg, bg_s))

        def plain(qa, a_s, qb, b_s, qg, bg_s):
            return mm.mx_matmul_fused_plain(qa, qb, **kw(a_s, b_s, qg, bg_s))

        def parent_kernel(qa, a_s, qb, b_s, qg, bg_s):
            out = torch.empty((M, N), device=dev)
            bm, bn, bk = _build.gemm_tile(M)
            _build.check(old["mx_matmul"](
                qa.data_ptr(), qb.data_ptr(), qg.data_ptr() if gated else None,
                a_s.data_ptr(), b_s.data_ptr(), bg_s.data_ptr() if gated else None, None, 0,
                None, 0, out.data_ptr(), 0, M, N, K, code, code, 4 if gated else 0, 0, 0.0,
                bm, bn, bk, _build.stream_ptr(qa)), "mx_matmul", "the parent's fused GEMM")
            return out

        def exact(qa, a_s, qb, b_s, qg, bg_s):
            a64 = qa.double() * a_s.double()
            y = a64 @ (qb.double() * b_s.double())
            if gated:
                gt = a64 @ (qg.double() * bg_s.double())
                y = gt / (1 + torch.exp(-gt)) * y
            return y

        fns = {"ms": kernel, "plain_ms": plain}
        if old:
            fns["library_ms"] = parent_kernel
        _witness_fp8(torch, cs, f"mx_matmul_fused fp8 x fp8 {label} K={K} N={N}", fns,
                     inputs, exact)
    T, C, K, N = 64, 8, 32768, 6144
    G = T // C
    g = torch.Generator(device=dev).manual_seed(5)
    gs = torch.full((G,), C, dtype=torch.int32, device=dev)

    def ginputs():
        qx, a_s = quantize_operand(torch.randn((T, K), generator=g, device=dev), P.a, "a")
        w = torch.empty((G, K, N), dtype=torch.float8_e4m3fn, device=dev)
        sc = torch.empty((G, 1, N), device=dev)
        for e in range(G):
            w[e], sc[e] = quantize_operand(
                torch.randn((K, N), generator=g, device=dev) / math.sqrt(K), P.b, "b")
        return qx.contiguous(), a_s, w, sc

    def gkw(a_s, sc):
        return dict(activation="none", a_scale=a_s, b_scale=sc, out_dtype=torch.float32)

    def gparent(qx, a_s, w, sc):
        out = torch.empty((T, N), device=dev)
        _build.check(old["mx_grouped_matmul"](
            qx.data_ptr(), w.data_ptr(), None, a_s.data_ptr(), sc.data_ptr(), None,
            gs.data_ptr(), out.data_ptr(), 0, T, N, K, G, code, code, 0, 8, 128, 32,
            _build.stream_ptr(qx)), "mx_grouped_matmul", "the parent's grouped GEMM")
        return out

    def gexact(qx, a_s, w, sc):
        a64 = qx.double() * a_s.double()
        return torch.cat([a64[e * C:(e + 1) * C] @ (w[e].double() * sc[e].double())
                          for e in range(G)])

    fns = {"ms": lambda qx, a_s, w, sc: mx_grouped_matmul(qx, w, gs, **gkw(a_s, sc)),
           "plain_ms": lambda qx, a_s, w, sc: grouped_matmul_ref(qx, w, gs, **gkw(a_s, sc))}
    if old:
        fns["library_ms"] = gparent
    _witness_fp8(torch, cs, f"mx_grouped_matmul fp8 x fp8 grok decode down T={T} G={G} "
                 f"K={K} N={N}", fns, ginputs, gexact, copies=1)


def _witness_fp8(torch, cs, what, fns, inputs, exact, copies=None):
    """`_witness` of the kernel, the plain version and the parent's kernel:
    one JSON line and one plain line, and the gate
    (the kernel's relative RMS and max at most twice the plain version's)."""
    args = inputs()
    ref = exact(*args)
    names = {"ms": "kernel", "plain_ms": "plain", "library_ms": "parent kernel"}
    dist = {names[k]: _dist(torch, fn(*args), ref) for k, fn in fns.items()}
    torch.cuda.synchronize()
    del ref
    nbytes = sum(t.numel() * t.element_size() for t in args) * 2
    n = copies or cs._copies(nbytes)
    sets = [args] + [inputs() for _ in range(n - 1)]
    t = cs._time_ms(torch, {k: (fn, sets) for k, fn in fns.items()}, iters=5 if copies else 20)
    times = {names[k]: statistics.median(t["windows_ms"][k]) for k in fns}
    k, p = dist["kernel"], dist["plain"]
    gate = k["relrms"] <= 2 * p["relrms"] and k["max"] <= 2 * p["max"]
    print(json.dumps(dict(what=what, distance_to_f64=dist, ms=times, gate=gate)), flush=True)
    print(f"{what}: to f64 " + ", ".join(f"{n} max {v['max']:.3e} relrms {v['relrms']:.3e}"
                                         for n, v in dist.items())
          + f"; kernel / plain relrms {k['relrms'] / p['relrms']:.2f} "
          + f"({'within' if gate else 'PAST'} 2x); ms "
          + ", ".join(f"{n} {v:.4f}" for n, v in times.items()), flush=True)
    if not gate:
        raise AssertionError(f"{what}: the kernel stands more than twice as far from f64 "
                             f"as the plain version: {dist}")


def main() -> int:
    sys.path.insert(0, str(ROOT / "src"))
    import torch

    if "--cpu" in sys.argv:
        forward(torch, torch.device("cpu"), "xlstm-125m-smoke", 2, 40)
        return 0
    if not torch.cuda.is_available():
        raise RuntimeError("accumulation_witness runs the kernels: no GPU is visible")
    from repro_torch.kernels import _build

    torch.backends.cuda.matmul.allow_tf32 = False
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip())
    dev = torch.device("cuda")
    parent = Path(sys.argv[sys.argv.index("--parent") + 1]) if "--parent" in sys.argv else None
    if "--fp8" in sys.argv:
        fp8(torch, dev, parent)
        return 0
    if "--attention-scan" in sys.argv:
        _build.build_all(names=("mx_flash_attention", "ssd_scan"))
        for name in ("mx_flash_attention", "ssd_scan"):
            print(_build.ptxas_report(name)[-2000:], flush=True)
        attention_scan(torch, dev, parent)
        return 0
    _build.build_all(names=("mx_matmul",))
    gemms(torch, dev)
    forward(torch, dev, "xlstm-125m", 4, 512)
    return 0


if __name__ == "__main__":
    sys.exit(main())
