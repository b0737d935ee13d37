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
"""
from __future__ import annotations

import contextlib
import math
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
    _build.build_all(names=("mx_matmul",))
    dev = torch.device("cuda")
    gemms(torch, dev)
    forward(torch, dev, "xlstm-125m", 4, 512)
    return 0


if __name__ == "__main__":
    sys.exit(main())
