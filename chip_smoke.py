#!/usr/bin/env python3
"""Chip smoke test of the PyTorch + CUDA port on one NVIDIA GPU (H100).

    python3 chip_smoke.py

Phases (any failure exits non-zero; nothing is caught and skipped):
  1. device check: requires CUDA, prints the card's name and power limit,
     turns TF32 off (the plain versions and the tied head run in full f32);
  2. builds the CUDA kernels from src/repro_torch/csrc with nvcc (sm_90a),
     one nvcc per source, all started together;
  3. holds each kernel against its plain PyTorch version at the shapes of
     the main path (llama3.2-1b, plus qwen2-0.5b's ragged widths), in f32
     and bf16: max error against 1e-4 * max|ref| (f32) / 2e-2 * max|ref|
     (bf16), kernel / plain / library time from CUDA events (the median of
     5 windows of 20 calls, taken in turns; every window's time goes to the
     JSON file), and the bound (the larger of bytes / 3.35 TB/s and
     FLOPs / peak);
  4. serves llama3.2-1b at full width (16 layers, f32, random weights from
     seed 0) through the port's paged continuous batcher with the prefix
     cache: 8 slots, 16 requests of 128 tokens sharing a 96-token system
     prompt, 32 new tokens each -- once on the MX kernels and once, shorter,
     on the baseline GEMM -- and requires every kernel's launch count > 0;
  5. holds the kernel path against the plain path: one prefill chunk and
     one decode step on the same cache state under "cuda_mx" and "torch"
     (logits within 1e-3 * max|ref|), profiles a prefill chunk and four
     decode steps (device time by kernel, busy share), and requires
     identical token streams of the two backends at smoke size.
The line before the last is the kernel summary JSON; the last line is
{"ok": true, "device": {...}}.  Details go to chiprun_out/chip_smoke.json.
"""
from __future__ import annotations

import json
import math
import statistics
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
HBM_BYTES_PER_S = 3.35e12  # H100 SXM (NVIDIA data sheet)
PEAK_FLOPS = {"float32": 67e12, "bfloat16": 989e12}  # dense; f32 off the tensor cores
REL_TOL = {"float32": 1e-4, "bfloat16": 2e-2}
L2_BYTES = 50 * 2**20
TPU_KERNELS = {  # file:line of the Pallas wrapper each CUDA kernel replaces
    "mx_matmul_fused": "src/repro/kernels/mx_matmul.py:382",
    "baseline_matmul": "src/repro/kernels/baseline_matmul.py:45",
    "mx_flash_decode": "src/repro/kernels/mx_flash_decode.py:108",
}
SOURCES = {
    "mx_matmul_fused": "src/repro_torch/csrc/mx_matmul.cu",
    "baseline_matmul": "src/repro_torch/csrc/baseline_matmul.cu",
    "mx_flash_decode": "src/repro_torch/csrc/mx_flash_decode.cu",
}


def _bound_ms(nbytes: float, flops: float, dtype: str):
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / PEAK_FLOPS[dtype] * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def _time_ms(torch, fns, windows=5, iters=20, warmup=3):
    """Time each `name -> (fn, arg_sets)` of `fns` with CUDA events over
    `windows` windows of `iters` calls, the functions taking turns window by
    window, each call cycling through its `arg_sets` (copies of the inputs
    that together exceed L2, so every call reads cold).  Returns `ms`,
    `plain_ms` and `library_ms` as the median of the windows' mean ms per
    call (None where `fns` lacks the name) and `windows_ms`, every window's
    mean, as the spread."""
    for fn, arg_sets in fns.values():
        for i in range(warmup):
            fn(*arg_sets[i % len(arg_sets)])
    torch.cuda.synchronize()
    per = {name: [] for name in fns}
    for _ in range(windows):
        for name, (fn, arg_sets) in fns.items():
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            for i in range(iters):
                fn(*arg_sets[i % len(arg_sets)])
            end.record()
            end.synchronize()
            per[name].append(start.elapsed_time(end) / iters)
    out = {k: statistics.median(per[k]) if k in per else None
           for k in ("ms", "plain_ms", "library_ms")}
    out["windows_ms"] = per
    return out


def _spread(c) -> float:
    """The kernel's spread across windows, (max - min) / median."""
    w = c["windows_ms"]["ms"]
    return (max(w) - min(w)) / c["ms"]


def _copies(nbytes: int) -> int:
    return max(1, min(16, math.ceil(2 * L2_BYTES / max(nbytes, 1))))


def _err(torch, got, ref, dtype: str):
    ref = ref.float()
    err = (got.float() - ref).abs().max().item()
    tol = REL_TOL[dtype] * ref.abs().max().item()
    return err, tol


# ---------------------------------------------------------------------------
# phase 3: each kernel against its plain version
# ---------------------------------------------------------------------------


def check_gemm(torch, dev, M, K, N, dtype_name, ep_kw, seed):
    from repro_torch.kernels import mx_matmul as mm

    dt = getattr(torch, dtype_name)
    ep = mm.Epilogue(**ep_kw)
    g = torch.Generator(device=dev).manual_seed(seed)

    def make():
        a = torch.randn((M, K), generator=g, device=dev).to(dt)
        b = (torch.randn((K, N), generator=g, device=dev) / math.sqrt(K)).to(dt)
        kw = dict(
            b_gate=(torch.randn((K, N), generator=g, device=dev) / math.sqrt(K)).to(dt)
            if ep.has_gate else None,
            bias=torch.randn((N,), generator=g, device=dev).to(dt) if ep.bias else None,
            residual=torch.randn((M, N), generator=g, device=dev).to(dt)
            if ep.residual else None)
        return a, b, kw

    el = torch.finfo(dt).bits // 8
    nbytes = el * (M * K + K * N * (2 if ep.has_gate else 1) + M * N
                   + (N if ep.bias else 0) + (M * N if ep.residual else 0))
    flops = 2 * M * N * K * (2 if ep.has_gate else 1)
    sets = [make() for _ in range(_copies(nbytes))]
    a, b, kw = sets[0]
    got = mm.mx_matmul_fused(a, b, epilogue=ep, **kw)
    ref = mm.mx_matmul_fused_plain(a, b, epilogue=ep, **kw)
    torch.cuda.synchronize()
    err, tol = _err(torch, got, ref, dtype_name)
    fns = dict(
        ms=(lambda a_, b_, kw_: mm.mx_matmul_fused(a_, b_, epilogue=ep, **kw_), sets),
        plain_ms=(lambda a_, b_, kw_: mm.mx_matmul_fused_plain(a_, b_, epilogue=ep, **kw_),
                  sets))
    # one PyTorch call computes the same function only for A@B (+ bias or
    # residual); no single call computes the swiglu pair
    library = None
    if ep_kw == {}:
        library = "torch.matmul"
        fns["library_ms"] = (lambda a_, b_, kw_: torch.matmul(a_, b_), sets)
    elif set(ep_kw) in ({"bias"}, {"residual"}):
        library = "torch.addmm"
        fns["library_ms"] = (lambda a_, b_, kw_: torch.addmm(
            kw_["bias"] if ep.bias else kw_["residual"], a_, b_), sets)
    bound, by = _bound_ms(nbytes, flops, dtype_name)
    return dict(kernel="mx_matmul_fused", M=M, K=K, N=N, dtype=dtype_name,
                epilogue=ep_kw, max_abs_err=err, tol=tol, **_time_ms(torch, fns),
                library=library, bound_ms=bound, bound_by=by)


def check_baseline(torch, dev, M, K, N, dtype_name, seed, bk=128):
    from repro_torch.kernels.baseline_matmul import baseline_matmul
    from repro_torch.kernels.ref import baseline_matmul_ref

    dt = getattr(torch, dtype_name)
    g = torch.Generator(device=dev).manual_seed(seed)
    el = torch.finfo(dt).bits // 8
    nbytes = el * (M * K + K * N + M * N)
    sets = [(torch.randn((M, K), generator=g, device=dev).to(dt),
             (torch.randn((K, N), generator=g, device=dev) / math.sqrt(K)).to(dt))
            for _ in range(_copies(nbytes))]
    a, b = sets[0]
    got = baseline_matmul(a, b, bk=bk)
    ref = baseline_matmul_ref(a, b, bk, dt)
    torch.cuda.synchronize()
    err, tol = _err(torch, got, ref, dtype_name)
    times = _time_ms(torch, dict(
        ms=(lambda a_, b_: baseline_matmul(a_, b_, bk=bk), sets),
        plain_ms=(lambda a_, b_: baseline_matmul_ref(a_, b_, bk, dt), sets),
        library_ms=(lambda a_, b_: torch.matmul(a_, b_), sets)))
    bound, by = _bound_ms(nbytes, 2 * M * N * K, dtype_name)
    return dict(kernel="baseline_matmul", M=M, K=K, N=N, dtype=dtype_name, bk=bk,
                max_abs_err=err, tol=tol, **times, library="torch.matmul",
                bound_ms=bound, bound_by=by)


def check_decode(torch, dev, B, H, Hkv, d, ps, lengths, dtype_name, seed, poison=False):
    import numpy as np
    import torch.nn.functional as F

    from repro_torch.kernels.mx_flash_decode import mx_flash_decode
    from repro_torch.kernels.ref import paged_decode_ref
    from repro_torch.runtime.kv_pages import PagePool

    dt = getattr(torch, dtype_name)
    W = max(1, -(-max(lengths) // ps))
    P = B * W + 1
    pool = PagePool(P - 1, ps)
    for s, ln in enumerate(lengths):
        if ln:
            pool.reserve(s, ln)
            pool.set_length(s, ln)
    table = torch.as_tensor(pool.page_table(B, W), device=dev)
    lns = torch.as_tensor(pool.lengths(B), device=dev)
    g = torch.Generator(device=dev).manual_seed(seed)
    el = torch.finfo(dt).bits // 8
    live_rows = sum(lengths)
    nbytes = el * (2 * B * H * d + 2 * live_rows * Hkv * d) + 4 * (B * W + B)
    flops = 4 * live_rows * H * d
    pool_bytes = el * 2 * P * ps * Hkv * d

    def make():
        q = torch.randn((B, H, d), generator=g, device=dev).to(dt)
        kp = torch.randn((P, ps, Hkv, d), generator=g, device=dev).to(dt)
        vp = torch.randn((P, ps, Hkv, d), generator=g, device=dev).to(dt)
        if poison:  # every non-live row (stale pages, the dump page) poisoned
            live = np.zeros((P, ps), bool)
            tb = table.cpu().numpy()
            for s, ln in enumerate(lengths):
                for pos in range(ln):
                    live[tb[s, pos // ps], pos % ps] = True
            dead = torch.as_tensor(~live, device=dev)[:, :, None, None]
            kp, vp = kp.masked_fill(dead, 1e30), vp.masked_fill(dead, 1e30)
        return q, kp, vp

    sets = [make() for _ in range(_copies(pool_bytes))]
    q, kp, vp = sets[0]
    got = mx_flash_decode(q, kp, vp, table, lns)
    ref = paged_decode_ref(q, kp, vp, table, lns)
    torch.cuda.synchronize()
    err, tol = _err(torch, got, ref, dtype_name)
    zero_rows = all(bool(torch.all(got[i] == 0)) for i, ln in enumerate(lengths) if ln == 0)
    finite = bool(torch.isfinite(got).all())
    # library yardstick: SDPA over the same rows gathered densely beforehand
    G = H // Hkv
    L = W * ps
    mask = (torch.arange(L, device=dev)[None, :] < lns[:, None])[:, None, None, :]

    def dense(q_, k_, v_):
        k = k_[table.long()].reshape(B, L, Hkv, d).permute(0, 2, 1, 3)
        v = v_[table.long()].reshape(B, L, Hkv, d).permute(0, 2, 1, 3)
        return (q_[:, :, None, :], k.repeat_interleave(G, 1).contiguous(),
                v.repeat_interleave(G, 1).contiguous())

    times = _time_ms(torch, dict(
        ms=(lambda q_, k_, v_: mx_flash_decode(q_, k_, v_, table, lns), sets),
        plain_ms=(lambda q_, k_, v_: paged_decode_ref(q_, k_, v_, table, lns), sets),
        library_ms=(lambda q_, k_, v_: F.scaled_dot_product_attention(
            q_, k_, v_, attn_mask=mask), [dense(*s) for s in sets])))
    bound, by = _bound_ms(nbytes, flops, dtype_name)
    return dict(kernel="mx_flash_decode", B=B, H=H, Hkv=Hkv, d=d, ps=ps,
                lengths=list(lengths), poison=poison, dtype=dtype_name, max_abs_err=err,
                tol=tol, zero_rows_exact=zero_rows, finite=finite, **times,
                library="F.scaled_dot_product_attention on pre-gathered dense K/V",
                bound_ms=bound, bound_by=by)


def phase_kernels(torch, dev):
    checks = []
    gemm_shapes = [  # (K, N, epilogue): every llama3.2-1b projection, qwen2 widths
        (2048, 2048, dict()),  # q
        (2048, 512, dict()),  # k, v
        (2048, 2048, dict(residual=True)),  # wo
        (2048, 8192, dict(activation="swiglu")),  # up + gate
        (8192, 2048, dict(residual=True)),  # down
        (2048, 8192, dict()),  # the paper's A/B against the baseline GEMM
        (896, 128, dict(bias=True)),  # qwen2-0.5b k, v (qkv bias)
        (4864, 896, dict(residual=True)),  # qwen2-0.5b down
    ]
    seed = 0
    for dtype_name in ("float32", "bfloat16"):
        for M in (8, 64, 256):  # decode slots, a prefill chunk, a large batch
            for K, N, ep in gemm_shapes:
                seed += 1
                checks.append(check_gemm(torch, dev, M, K, N, dtype_name, ep, seed))
            seed += 1
            checks.append(check_baseline(torch, dev, M, 2048, 8192, dtype_name, seed))
        lengths = (128, 160, 0, 97, 143, 1, 129, 150)  # ragged, one free slot
        checks.append(check_decode(torch, dev, 8, 32, 8, 64, 16, lengths, dtype_name, 100))
        checks.append(check_decode(torch, dev, 4, 14, 2, 64, 16, (33, 0, 160, 7),
                                   dtype_name, 101))  # G = 7
        checks.append(check_decode(torch, dev, 8, 32, 8, 64, 16, lengths, dtype_name, 102,
                                   poison=True))
    for c in checks:
        shape = (f"M={c['M']} K={c['K']} N={c['N']} {c.get('epilogue', '')}"
                 if "M" in c else
                 f"B={c['B']} H={c['H']} Hkv={c['Hkv']} d={c['d']} "
                 f"{'poisoned' if c['poison'] else ''}")
        ok = c["max_abs_err"] <= c["tol"] and c.get("zero_rows_exact", True) \
            and c.get("finite", True)
        c["ok"] = ok
        lib = "none" if c["library_ms"] is None else f"{c['library_ms']:.4f}"
        print(f"  {c['kernel']:16s} {c['dtype']:8s} {shape:40s} err {c['max_abs_err']:.3e} "
              f"(tol {c['tol']:.3e}) {'ok' if ok else 'FAIL'}  ms {c['ms']:.4f} "
              f"(spread {100 * _spread(c):.0f}%) plain "
              f"{c['plain_ms']:.4f} lib {lib} bound {c['bound_ms']:.4f} ({c['bound_by']})")
    bad = [c for c in checks if not c["ok"]]
    if bad:
        raise AssertionError(f"{len(bad)} kernel check(s) disagree with the plain "
                             f"version: {bad}")
    return checks


# ---------------------------------------------------------------------------
# phase 4: the main path at full width
# ---------------------------------------------------------------------------


def serve(torch, model, params, cfg, backend, n_req, gen, prompt_len=128, slots=8):
    from repro_torch import kernels
    from repro_torch.core import ops
    from repro_torch.launch.serve import make_trace
    from repro_torch.runtime.batcher import ContinuousBatcher

    max_len = prompt_len + gen
    ps = 16
    with ops.use_policy(ops.MXPolicy(backend)):
        batcher = ContinuousBatcher(
            model, params, batch_slots=slots, max_len=max_len, page_size=ps,
            num_pages=(slots + 2) * -(-max_len // ps), prefix_cache=True,
            prefill_chunk=64)
        reqs = make_trace(cfg, n_req, prompt_len, gen, prefix_cache=True)
        torch.cuda.synchronize()
        kernels.reset_launch_counts()
        t0 = time.perf_counter()
        for r in reqs:
            batcher.submit(r)
        finished = batcher.run_to_completion()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        counts = kernels.launch_counts()
    step_dt = {h.step: h.dt_s for h in batcher.health}
    ttft_steps = [r.first_token_at - r.submitted_at for r in finished.values()]
    ttft_ms = [1e3 * sum(step_dt[s] for s in range(r.submitted_at, r.first_token_at + 1))
               for r in finished.values()]
    generated = sum(len(r.output) for r in finished.values())
    out = dict(
        backend=backend, requests=len(finished), slots=slots, prompt_len=prompt_len,
        gen=gen, wall_s=wall, steps=batcher.steps_run,
        prefill_launches=batcher.prefill_launches, generated_tokens=generated,
        generated_tok_per_s=generated / wall,
        total_tok_per_s=sum(len(r.prompt) + len(r.output)
                            for r in finished.values()) / wall,
        ttft_steps_mean=sum(ttft_steps) / len(ttft_steps), ttft_steps_max=max(ttft_steps),
        ttft_ms_mean=sum(ttft_ms) / len(ttft_ms), ttft_ms_max=max(ttft_ms),
        finish_reasons=batcher.health_summary()["finish_reasons"],
        pool=batcher.pool_stats().as_dict(), prefix=batcher.prefix_stats(),
        launches=counts)
    assert len(finished) == n_req, finished.keys()
    assert all(r.finish_reason == "max_new" and len(r.output) == gen
               for r in finished.values()), out["finish_reasons"]
    return out, batcher, finished


# ---------------------------------------------------------------------------
# phase 5: kernel path against plain path
# ---------------------------------------------------------------------------


def _step_inputs(torch, dev, cfg, num_pages):
    """One 64-token prefill chunk for slot 0 and one decode step over 8
    slots at ragged depths (slot 3 free), against the serving cache."""
    from repro_torch.runtime.kv_pages import PagePool

    B, ps = 8, 16
    pool = PagePool(num_pages, ps)
    for s in range(B):
        pool.reserve(s, 160)
    table = torch.as_tensor(pool.page_table(B, 10), device=dev)
    g = torch.Generator(device=dev).manual_seed(5)
    toks = torch.randint(0, cfg.vocab, (1, 64), generator=g, device=dev)
    tok = torch.randint(0, cfg.vocab, (B, 1), generator=g, device=dev)
    index = torch.tensor([64, 10, 50, 0, 100, 3, 127, 30], device=dev)
    lengths = (index + 1).to(torch.int32)
    lengths[3] = 0  # a free slot
    return table, toks, tok, index, lengths


def hold_steps(torch, dev, model, params, cfg, cache0, num_pages):
    from repro_torch import kernels
    from repro_torch.core import ops

    table, toks, tok, index, lengths = _step_inputs(torch, dev, cfg, num_pages)
    res = {}
    for backend in ("cuda_mx", "torch"):
        cache = {seg: {k: v.clone() for k, v in leaves.items()}
                 for seg, leaves in cache0.items()}
        with ops.use_policy(ops.MXPolicy(backend)):
            kernels.reset_launch_counts()
            pl, cache = model.prefill_step_paged(params, toks, cache,
                                                 torch.tensor([0], device=dev), table[:1])
            torch.cuda.synchronize()
            pre = kernels.launch_counts()
            kernels.reset_launch_counts()
            dl, cache = model.decode_step_paged(params, tok, cache, index, table, lengths)
            torch.cuda.synchronize()
            dec = kernels.launch_counts()
        res[backend] = (pl, dl, pre, dec)
    out = {}
    for i, what in ((0, "prefill_logits"), (1, "decode_logits")):
        got, ref = res["cuda_mx"][i], res["torch"][i]
        err = (got - ref).abs().max().item()
        tol = 1e-3 * ref.abs().max().item()
        out[what] = dict(max_abs_err=err, tol=tol, ok=err <= tol,
                         argmax_equal=bool(torch.equal(got.argmax(-1), ref.argmax(-1))))
    out["launches_per_prefill_chunk"] = res["cuda_mx"][2]
    out["launches_per_decode_step"] = res["cuda_mx"][3]
    out["torch_backend_launches"] = [res["torch"][2], res["torch"][3]]
    return out


def profile_steps(torch, dev, model, params, cfg, cache, num_pages, n_decode=4):
    """torch.profiler over one prefill chunk and `n_decode` decode steps on
    the kernel path: device time by kernel and the device's busy share of
    the window.  A profiler that records no device time reports
    "not measured"."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.core import ops

    table, toks, tok, index, lengths = _step_inputs(torch, dev, cfg, num_pages)
    with ops.use_policy(ops.MXPolicy("cuda_mx")):
        model.decode_step_paged(params, tok, cache, index, table, lengths)  # warm
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            model.prefill_step_paged(params, toks, cache, torch.tensor([0], device=dev),
                                     table[:1])
            for _ in range(n_decode):
                model.decode_step_paged(params, tok, cache, index, table, lengths)
            torch.cuda.synchronize()
            wall_ms = (time.perf_counter() - t0) * 1e3
    rows = []
    for e in prof.key_averages():
        # device-side events only (kernels, copies): a CPU op's "self device
        # time" is the kernels it launched, which appear as their own rows
        if e.device_type == DeviceType.CPU:
            continue
        us = e.self_device_time_total
        if us > 0:
            rows.append((e.key, us / 1e3, e.count))
    rows.sort(key=lambda r: -r[1])
    device_ms = sum(r[1] for r in rows)
    if device_ms == 0:
        return dict(measured=False, window_ms=wall_ms)
    return dict(measured=True, window_ms=wall_ms, device_ms=device_ms,
                busy_share=device_ms / wall_ms, n_decode=n_decode,
                top=[dict(name=k[:90], ms=ms, calls=n) for k, ms, n in rows[:12]])


def smoke_streams(torch, dev):
    from repro_torch.configs import get_config
    from repro_torch.models import build_model

    cfg = get_config("llama3.2-1b-smoke")
    model = build_model(cfg)
    params = model.init(0, device=dev)
    streams = {}
    for backend in ("cuda_mx", "torch"):
        _, _, fin = serve(torch, model, params, cfg, backend, n_req=6, gen=8,
                          prompt_len=24, slots=2)
        streams[backend] = {r: fin[r].output for r in sorted(fin)}
    return streams["cuda_mx"] == streams["torch"], streams


# ---------------------------------------------------------------------------


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is visible; this smoke test needs a GPU",
              file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch import kernels
    from repro_torch.configs import get_config
    from repro_torch.kernels import _build
    from repro_torch.models import build_model
    from repro_torch.models.modules import param_count

    dev = torch.device("cuda")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
    print(smi)
    print(f"[1] device: {smi} | torch {torch.__version__} cuda {torch.version.cuda}")

    build_s = _build.build_all()
    print(f"[2] built {len(_build.SOURCES)} CUDA sources for sm_90a in {build_s:.1f} s")
    for name in _build.SOURCES:
        for line in _build.ptxas_report(name).splitlines():
            if "registers" in line or "spill" in line:
                print(f"    {name}: {line.strip()}")
    sass = sass_rmw_counts()
    print(f"    output read-modify-write in the SASS (ld/st.global.cg = *.STRONG.GPU): "
          f"{sass}")
    if not (sass["baseline_matmul"][0] and sass["baseline_matmul"][1]):
        raise AssertionError("the baseline kernel's output round trip was compiled away")

    print("[3] kernels against their plain versions")
    checks = phase_kernels(torch, dev)

    print("[4] serving llama3.2-1b (f32, full width) through the paged batcher")
    cfg = get_config("llama3.2-1b")
    model = build_model(cfg)
    t0 = time.perf_counter()
    params = model.init(0, device=dev)
    torch.cuda.synchronize()
    print(f"    init {time.perf_counter() - t0:.1f} s, "
          f"{param_count(params) / 1e9:.3f} B params")
    main_run, batcher, _ = serve(torch, model, params, cfg, "cuda_mx", n_req=16, gen=32)
    _print_serve(main_run)
    base_run, _, _ = serve(torch, model, params, cfg, "cuda_baseline", n_req=8, gen=8)
    _print_serve(base_run)
    launches = dict(main_run["launches"])
    launches["baseline_matmul"] = base_run["launches"]["baseline_matmul"]
    for name, n in launches.items():
        if n <= 0:
            raise AssertionError(f"kernel {name} was not launched on its serving path")
    if main_run["launches"]["baseline_matmul"] or base_run["launches"]["mx_matmul_fused"]:
        raise AssertionError(f"backends leaked into each other: {main_run['launches']} "
                             f"/ {base_run['launches']}")

    print("[5] kernel path against plain path")
    held = hold_steps(torch, dev, model, params, cfg, batcher.cache,
                      batcher.pool.total_pages)
    for what in ("prefill_logits", "decode_logits"):
        h = held[what]
        print(f"    {what}: err {h['max_abs_err']:.3e} (tol {h['tol']:.3e}) "
              f"argmax equal {h['argmax_equal']}")
        if not h["ok"]:
            raise AssertionError(f"{what}: cuda_mx disagrees with torch: {h}")
    print(f"    launches per prefill chunk (64 tokens): {held['launches_per_prefill_chunk']}")
    print(f"    launches per decode step (8 slots): {held['launches_per_decode_step']}")
    prof = profile_steps(torch, dev, model, params, cfg, batcher.cache,
                         batcher.pool.total_pages)
    if prof["measured"]:
        print(f"    profile (1 prefill chunk + {prof['n_decode']} decode steps): window "
              f"{prof['window_ms']:.2f} ms, device busy {prof['device_ms']:.2f} ms "
              f"({100 * prof['busy_share']:.1f}%)")
        for r in prof["top"]:
            print(f"      {r['ms']:9.3f} ms  x{r['calls']:<5d} {r['name']}")
    else:
        print(f"    profile: device time not measured (window {prof['window_ms']:.2f} ms)")
    same, streams = smoke_streams(torch, dev)
    print(f"    smoke-size token streams cuda_mx == torch: {same}")
    if not same:
        raise AssertionError(f"token streams differ: {streams}")

    headline = {  # a decode-step call of each kernel on the main path, f32
        # the down projection: one library call (addmm) computes the same function
        "mx_matmul_fused": dict(M=8, K=8192, N=2048, epilogue=dict(residual=True)),
        "baseline_matmul": dict(M=8, K=2048, N=8192),
        "mx_flash_decode": dict(B=8, H=32, poison=False),
    }
    summary = []
    for name, sel in headline.items():
        c = next(c for c in checks if c["kernel"] == name and c["dtype"] == "float32"
                 and all(c.get(k) == v for k, v in sel.items()))
        summary.append(dict(
            name=name, route="cuda", source=SOURCES[name], replaces=TPU_KERNELS[name],
            launches=launches[name], max_abs_err=c["max_abs_err"], ms=c["ms"],
            plain_ms=c["plain_ms"], bound_ms=c["bound_ms"], bound_by=c["bound_by"],
            library_ms=c["library_ms"],
            shape={k: c[k] for k in ("M", "K", "N", "B", "H", "Hkv", "d") if k in c},
            dtype="float32"))
    out_dir = ROOT / "chiprun_out"
    out_dir.mkdir(exist_ok=True)
    (out_dir / "chip_smoke.json").write_text(json.dumps(dict(
        device=smi, build_s=build_s, checks=checks, serve=main_run,
        serve_baseline=base_run, hold=held, profile=prof, kernels=summary), indent=1, default=str))
    print(json.dumps({"kernels": summary}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


def sass_rmw_counts():
    """(loads, stores) marked .STRONG.GPU -- what ld/st.global.cg compile to
    -- in each GEMM library's SASS: the baseline must keep its per-chunk
    output round trip, the MX kernel has none."""
    from repro_torch.kernels import _build

    cuobjdump = Path(_build._nvcc()).with_name("cuobjdump")
    out = {}
    for name, lib in (("mx_matmul_fused", "mx_matmul"),
                      ("baseline_matmul", "baseline_matmul")):
        text = subprocess.run([str(cuobjdump), "-sass", str(_build._target(lib))],
                              capture_output=True, text=True, check=True).stdout
        lines = [ln for ln in text.splitlines() if "STRONG.GPU" in ln]
        out[name] = (sum("LDG" in ln for ln in lines), sum("STG" in ln for ln in lines))
    return out


def _print_serve(r):
    print(f"    [{r['backend']}] {r['requests']} requests x {r['gen']} new tokens through "
          f"{r['slots']} slots: {r['wall_s']:.2f} s, {r['generated_tok_per_s']:.1f} "
          f"generated tok/s ({r['total_tok_per_s']:.1f} incl. prompt), "
          f"{r['steps']} steps + {r['prefill_launches']} prefill chunks")
    print(f"      TTFT {r['ttft_steps_mean']:.1f} steps mean / {r['ttft_steps_max']} max, "
          f"{r['ttft_ms_mean']:.1f} ms mean / {r['ttft_ms_max']:.1f} ms max")
    p, x = r["pool"], r["prefix"]
    print(f"      pool high water {p['high_water']}/{p['num_pages']} pages; prefix hits "
          f"{x['hits']}/{x['hits'] + x['misses']}, {x['tokens_saved']} tokens skipped, "
          f"{x['cow_copies']} COW copies, {x['evicted_pages']} evicted")
    print(f"      launches {r['launches']}; finish {r['finish_reasons']}")


if __name__ == "__main__":
    sys.exit(main())
