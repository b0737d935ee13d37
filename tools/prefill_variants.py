"""Where the prefill tile's time goes: time variants of csrc/prefill_tile.cuh's
K loop and its CTA tiles on the card (one JSON line):

    PYTHONPATH=src python tools/prefill_variants.py

A bring-up tool, not part of the package.  Each variant is the header as
committed, compiled with one of its timing macros: "full" (none), "copies"
(PREFILL_TIMING_NO_PRODUCTS: the ring without the tensor-core products),
"products" (PREFILL_TIMING_NO_COPIES: the products without the copies
after the ring is primed), "one_tf32" (PREFILL_TIMING_ONE_TF32: f32 with
one TF32 product per step instead of 3xTF32's three; wrong results, timing
only) and "mma_acc" (PREFILL_TIMING_MMA_ACC: f32 accumulated in the MMAs,
truncating, as before the rounding FADD of each k8 step's three
products).  Each compiles a small standalone timing program (one nvcc per
variant, all started together, into `build/prefill_variants/<variant>/`)
that launches the dense MX kernel's body (`prefill_sweep` + `prefill_store`,
no epilogue operands) through `prefill_launch` at the given tile, and times
5 windows of 20 launches with CUDA events (the best window's mean).  The
operands are filled on the card; `SHAPES` lists (f32, M, N, K, bm, bn,
stages, split, parts): llama3.2-1b's prefill-chunk projections and
zamba2-2.7b's and xlstm-125m's M = 2048 ones, at the tiles
`kernels/_build.prefill_tile` chooses among, and the baseline A/B's shape (M = 40, 64; K = 2048, N =
8192) at MX's tile (64 x 64 split 4) and at the baseline's (32 x 64, one
CTA per tile, split 1).

    PYTHONPATH=src python tools/prefill_variants.py --bytes

times instead the 8-bit pairs (int8 x int8, e4m3 x e4m3; "int8_all" and
"fp8_all" payloads with their scales) through the package's own C entries,
each source built once per variant (`_build.build_all` with the macros, one
nvcc each, all started together): "full" (the B fragments transposed in
registers, e4m3 widened exactly to f16 for two f16 products per k32 step)
and "copies" (PREFILL_TIMING_NO_PRODUCTS: the ring alone; wrong results).
Kernel 1 at llama3.2-1b's prefill-chunk down and up + gate projections (M = 64) and at M = 256 and 2048 (K = 2048, N =
8192), at `_build.prefill_tile`'s tile and at candidate tiles; kernel 5 at
grok-1's decode down and prefill up + gate projections at
`_build.grouped_tile`'s tile and at candidate stages.  Times are
`chip_smoke._time_ms`'s (CUDA events behind a spin, the median window).
"""
from __future__ import annotations

import json
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
CSRC = ROOT / "src" / "repro_torch" / "csrc"
OUT = ROOT / "build" / "prefill_variants"

VARIANTS = {"full": None, "copies": "PREFILL_TIMING_NO_PRODUCTS",
            "products": "PREFILL_TIMING_NO_COPIES", "one_tf32": "PREFILL_TIMING_ONE_TF32",
            "mma_acc": "PREFILL_TIMING_MMA_ACC"}
F32_ONLY = ("one_tf32", "mma_acc")

HARNESS = r'''
#include <cstdio>
#include <cstdlib>
#include "prefill_tile.cuh"
struct Args {
  const float *a_scale, *b_scale, *bg_scale;
  const void* bias; int bias_dt; const void* res; int res_dt; void* out;
  int out_dt, M, N, K, act, has_scale; float out_scale;
};
template <typename T, int BM, int BN>
__device__ __forceinline__ void body(const PrefillShape& d, const Args& r) {
  NoHook hook;
  const float* Cs = prefill_sweep<T, BM, BN, false, false>(d, hook);
  prefill_store<PrefillCfg<T, BM, BN, false, false>, BM, BN, false>(r, d, Cs);
}
template <typename T, int BM, int BN>
__global__ void __launch_bounds__(PrefillCfg<T, BM, BN, false, false>::kThreads)
kern(const PrefillShape d, const Args r) { body<T, BM, BN>(d, r); }
template <typename T, int BM, int BN>  // as csrc/mx_matmul.cu: PrefillCfg::kTwoPerSm
__global__ void __launch_bounds__(PrefillCfg<T, BM, BN, false, false>::kThreads, 2)
kern2(const PrefillShape d, const Args r) { body<T, BM, BN>(d, r); }
template <typename T> __global__ void fill(T* p, size_t n, unsigned seed) {
  for (size_t i = blockIdx.x * (size_t)blockDim.x + threadIdx.x; i < n;
       i += (size_t)gridDim.x * blockDim.x) {
    unsigned h = (unsigned)i * 2654435761u ^ seed;
    h ^= h >> 13; h *= 0x5bd1e995; h ^= h >> 15;
    from_f32(p + i, ((h & 0xFFFF) / 65536.0f - 0.5f) * 0.05f);
  }
}
template <typename T, int BM, int BN>
float run(int M, int N, int K, int stages, int split, int parts) {
  T *a, *b; float* out;
  cudaMalloc(&a, (size_t)M * K * sizeof(T)); cudaMalloc(&b, (size_t)K * N * sizeof(T));
  cudaMalloc(&out, (size_t)M * N * 4);
  fill<<<1024, 256>>>(a, (size_t)M * K, 1); fill<<<1024, 256>>>(b, (size_t)K * N, 2);
  PrefillShape d{a, b, nullptr, nullptr, nullptr, M, N, K, stages, split, parts, 16, 16, 16};
  Args r{nullptr, nullptr, nullptr, nullptr, 0, nullptr, 0, out, 0, M, N, K, 0, 0, 0.f};
  auto launch = [&]() {
    using Cfg = PrefillCfg<T, BM, BN, false, false>;
    if constexpr (Cfg::kTwoPerSm)
      return prefill_launch<kern2<T, BM, BN>, Cfg, false>(d, 0, true, d, r);
    else
      return prefill_launch<kern<T, BM, BN>, Cfg, false>(d, 0, true, d, r);
  };
  if (int e = launch()) { printf("launch error %d\n", e); return -1; }
  cudaDeviceSynchronize();
  cudaEvent_t s0, s1; cudaEventCreate(&s0); cudaEventCreate(&s1);
  float best = 1e9;
  for (int w = 0; w < 5; ++w) {
    cudaEventRecord(s0);
    for (int i = 0; i < 20; ++i) launch();
    cudaEventRecord(s1); cudaEventSynchronize(s1);
    float ms; cudaEventElapsedTime(&ms, s0, s1);
    if (ms / 20 < best) best = ms / 20;
  }
  if (cudaGetLastError() != cudaSuccess) return -1;
  cudaFree(a); cudaFree(b); cudaFree(out);
  return best;
}
int main(int argc, char** argv) {  // f32 M N K bm bn stages split parts
  int f32 = atoi(argv[1]), M = atoi(argv[2]), N = atoi(argv[3]), K = atoi(argv[4]);
  int bm = atoi(argv[5]), bn = atoi(argv[6]), st = atoi(argv[7]), sp = atoi(argv[8]);
  int pa = atoi(argv[9]);
  float ms = -1;
#define CASE(T, BM_, BN_) if (bm == BM_ && bn == BN_) ms = run<T, BM_, BN_>(M, N, K, st, sp, pa);
  if (f32) { CASE(float, 64, 128) CASE(float, 64, 64) CASE(float, 32, 64) }
  else { CASE(__nv_bfloat16, 64, 128) CASE(__nv_bfloat16, 64, 64) CASE(__nv_bfloat16, 32, 64) }
  printf("%.5f\n", ms);
  return 0;
}
'''

SHAPES = []
for _f32 in (1, 0):
    SHAPES += [
        (_f32, 64, 2048, 8192, 64, 128, 4, 8, 8), (_f32, 64, 2048, 8192, 64, 64, 4, 8, 8),
        (_f32, 64, 2048, 8192, 64, 64, 4, 1, 8), (_f32, 64, 2048, 8192, 32, 64, 4, 8, 8),
        (_f32, 64, 2048, 2048, 64, 64, 4, 4, 4), (_f32, 64, 2048, 2048, 32, 64, 4, 4, 4),
        (_f32, 64, 8192, 2048, 64, 64, 4, 4, 4), (_f32, 64, 8192, 2048, 64, 64, 4, 1, 4),
        (_f32, 256, 2048, 8192, 64, 64, 4, 8, 8), (_f32, 256, 2048, 8192, 64, 128, 3, 1, 8),
        (_f32, 256, 8192, 2048, 64, 128, 3, 1, 4), (_f32, 256, 8192, 2048, 64, 64, 3, 1, 4),
        (_f32, 2048, 10448, 2560, 64, 128, 3, 1, 4), (_f32, 2048, 10448, 2560, 64, 64, 3, 1, 4),
        # the baseline A/B (K = 2048, N = 8192): MX's tile, then the baseline's
        (_f32, 40, 8192, 2048, 64, 64, 4, 4, 4), (_f32, 40, 8192, 2048, 32, 64, 4, 1, 4),
        (_f32, 64, 8192, 2048, 32, 64, 4, 1, 4),
    ]
SHAPES += [  # xlstm-125m's forward projections (4 x 512 tokens, f32)
    (1, 2048, 3072, 768, 64, 128, 4, 1, 1), (1, 2048, 1536, 1536, 64, 128, 3, 1, 2),
    (1, 2048, 768, 1536, 64, 128, 3, 1, 2), (1, 2048, 768, 768, 64, 128, 4, 1, 1),
]


def build(nvcc: str) -> None:
    OUT.mkdir(parents=True, exist_ok=True)
    src = OUT / "time.cu"
    src.write_text(HARNESS)
    jobs = {}
    for v, macro in VARIANTS.items():
        (OUT / v).mkdir(exist_ok=True)
        cmd = [nvcc, "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
               *(() if macro is None else (f"-D{macro}",)), "-I", str(CSRC),
               "-o", str(OUT / v / "time"), str(src)]
        jobs[v] = subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                                   text=True)
    for v, p in jobs.items():
        out, _ = p.communicate()
        if p.returncode:
            raise RuntimeError(f"nvcc failed for variant {v}:\n{out[-3000:]}")


BYTE_VARIANTS = {"full": (), "copies": ("PREFILL_TIMING_NO_PRODUCTS",)}
# kernel 1: (label, M, K, N, gated, candidate (bm, bn, stages, split) beside the table's)
BYTE_FUSED = (("llama down", 64, 8192, 2048, False, ((64, 64, 4, 1), (32, 64, 4, 8))),
              ("llama up+gate", 64, 2048, 8192, True, ((64, 128, 3, 1), (32, 64, 4, 4))),
              ("M=256", 256, 2048, 8192, False, ((64, 128, 3, 1), (64, 64, 3, 1))),
              ("M=2048", 2048, 2048, 8192, False, ((64, 64, 3, 1),)))
# kernel 5: (label, T, G, K, N, gated, candidate stages beside the table's)
BYTE_GROUPED = (("grok decode down", 64, 8, 32768, 6144, False, (3, 4)),
                ("grok prefill up+gate", 1024, 8, 6144, 32768, True, (2, 3)))


def bytes_main(torch, _build, smi) -> int:
    """The 8-bit pairs' variants and candidate tiles (module docstring)."""
    import statistics

    sys.path.insert(0, str(ROOT))
    import chip_smoke as cs

    from repro_torch.core.precision import NAMED_POLICIES
    from repro_torch.kernels.mx_grouped_matmul import _LAUNCHERS as GROUPED, launch_tile
    from repro_torch.kernels.mx_matmul import _LAUNCHERS as FUSED
    from repro_torch.kernels.quant import quantize_operand

    t0 = time.perf_counter()
    _build.build_all(["mx_matmul", "mx_grouped_matmul"],
                     [(n, d) for n in ("mx_matmul", "mx_grouped_matmul")
                      for d in BYTE_VARIANTS.values() if d])
    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(0)
    rows = []

    def quant(pol, shape, side, scale=1.0):
        q, sc = quantize_operand(torch.randn(shape, generator=g, device=dev) * scale,
                                 getattr(NAMED_POLICIES[pol], side), side)
        return q.contiguous(), sc

    def median(fns):
        """Each launch's median ms."""
        t = cs._time_ms(torch, {k: (fn, [()]) for k, fn in fns.items()}, iters=10)
        return {k: statistics.median(t["windows_ms"][k]) for k in fns}

    for pol in ("int8_all", "fp8_all"):
        for label, M, K, N, gated, cands in BYTE_FUSED:
            a, a_s = quant(pol, (M, K), "a")
            b, b_s = quant(pol, (K, N), "b", K ** -0.5)
            bg, bg_s = quant(pol, (K, N), "b", K ** -0.5) if gated else (None, None)
            out = torch.empty((M, N), device=dev)
            t = _build.prefill_tile(M, N, K, a.dtype, b.dtype, gated)
            code = _build.dtype_code(a.dtype, "a", _build.QUANTIZED)

            def launch(defines, tile):
                fn = _build.function(*FUSED["dense prefill"], defines=defines)
                return lambda: _build.check(fn(
                    a.data_ptr(), b.data_ptr(), None if bg is None else bg.data_ptr(),
                    a_s.data_ptr(), b_s.data_ptr(), None if bg_s is None else bg_s.data_ptr(),
                    None, 0, None, 0, out.data_ptr(), 0, M, N, K, code, code,
                    4 if gated else 0, 0, 0.0, *tile, 16, 16, 16, _build.stream_ptr(a)),
                    "mx_matmul", label)
            table = (t.bm, t.bn, t.stages, t.split, t.parts)
            fns = {f"{v}_ms": launch(d, table) for v, d in BYTE_VARIANTS.items()}
            for bm, bn, st, sp in cands:
                fns[f"{bm}x{bn} stages {st} split {sp}_ms"] = launch((), (bm, bn, st, sp, t.parts))
            nbytes = a.numel() + b.numel() * (2 if gated else 1) + 4 * M * N
            bound = _build_bound(cs, nbytes, 2 * M * N * K * (2 if gated else 1), pol)
            rows.append(dict(kernel="mx_matmul_fused", pol=pol, label=label, M=M, K=K, N=N,
                             tile=t._asdict(), bound_ms=bound, **median(fns)))
            print(json.dumps(rows[-1]), flush=True)
        for label, T, G, K, N, gated, stages in BYTE_GROUPED:
            x, x_s = quant(pol, (T, K), "a")
            ws = [quant(pol, (G, K, N), "b", K ** -0.5) for _ in range(2 if gated else 1)]
            w, b_s = ws[0][0], ws[0][1]
            out = torch.empty((T, N), device=dev)
            sz = torch.full((G,), T // G, dtype=torch.int32, device=dev)
            route, tile = launch_tile(x, w, ws[1][0] if gated else None)
            code = _build.dtype_code(x.dtype, "x", _build.QUANTIZED)

            def glaunch(defines, tile):
                fn = _build.function(*GROUPED["dense", "mma"], defines=defines)
                return lambda: _build.check(fn(
                    x.data_ptr(), w.data_ptr(), ws[1][0].data_ptr() if gated else None,
                    x_s.data_ptr(), b_s.data_ptr(), ws[1][1].data_ptr() if gated else None,
                    sz.data_ptr(), out.data_ptr(), 0, T, N, K, G, code, code,
                    4 if gated else 0, *tile, _build.stream_ptr(x)), "mx_grouped_matmul", label)
            fns = {f"{v}_ms": glaunch(d, tile) for v, d in BYTE_VARIANTS.items()}
            for st in stages:
                fns[f"stages {st}_ms"] = glaunch((), tile[:2] + (st,) + tile[3:])
            nbytes = x.numel() + G * K * N * (2 if gated else 1) + 4 * T * N
            bound = _build_bound(cs, nbytes, 2 * T * K * N * (2 if gated else 1), pol)
            rows.append(dict(kernel="mx_grouped_matmul", pol=pol, label=label, T=T, G=G, K=K,
                             N=N, route=route, tile=tile, bound_ms=bound, **median(fns)))
            print(json.dumps(rows[-1]), flush=True)
            del ws, w
            torch.cuda.empty_cache()
    print(json.dumps(dict(device=smi, seconds=time.perf_counter() - t0, rows=rows)))
    return 0


def _build_bound(cs, nbytes, flops, pol):
    """The roofline bound (ms) at the pair's 8-bit peak (chip_smoke._bound_ms)."""
    return cs._bound_ms(nbytes, flops, "int8" if pol == "int8_all" else "float8_e4m3fn")[0]


def main() -> int:
    sys.path.insert(0, str(ROOT / "src"))
    import torch

    from repro_torch.kernels import _build

    if not torch.cuda.is_available():
        raise RuntimeError("prefill_variants times CUDA kernels: no GPU is visible")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         check=True).stdout.strip()
    if "--bytes" in sys.argv:
        return bytes_main(torch, _build, smi)
    t0 = time.perf_counter()
    build(_build._nvcc())
    rows = []
    for shape in SHAPES:
        row = dict(f32=bool(shape[0]), M=shape[1], N=shape[2], K=shape[3], bm=shape[4],
                   bn=shape[5], stages=shape[6], split=shape[7], parts=shape[8])
        for v in VARIANTS:
            if v in F32_ONLY and not shape[0]:
                continue
            out = subprocess.run([str(OUT / v / "time"), *map(str, shape)],
                                 capture_output=True, text=True, check=True).stdout
            row[f"{v}_ms"] = float(out.strip().splitlines()[-1])
        rows.append(row)
    print(json.dumps(dict(device=smi, seconds=time.perf_counter() - t0, rows=rows)))
    return 0


if __name__ == "__main__":
    sys.exit(main())
