#!/usr/bin/env python3
"""Chip smoke test of the PyTorch + CUDA port on one NVIDIA GPU (H100).

    python3 chip_smoke.py

Phases (any failure exits non-zero; nothing is caught and skipped):
  1. device check: requires CUDA, prints the card's name and power limit,
     turns TF32 off (the plain versions and the tied head run in full f32);
  2. builds the CUDA kernels from src/repro_torch/csrc with nvcc (sm_90a),
     one nvcc per source, all started together, and prints each kernel's
     registers and spills;
  3. holds each kernel against its plain PyTorch version at the shapes of
     the main path (llama3.2-1b, plus qwen2-0.5b's ragged widths), in f32
     and bf16: the GEMMs; flash decode with f32/bf16 and with int8 pages
     and scales; flash verify at S = 5 and 9, G = 7, poisoned stale pages
     and S = 1 (also against the decode kernel), with the same page types.
     Max error against 1e-4 * max|ref| (f32) / 2e-2 * max|ref| (bf16),
     kernel / plain / library time from CUDA events (the median of 5
     windows of 20 calls, taken in turns; every window's time goes to the
     JSON file), and the bound (the larger of bytes / 3.35 TB/s and
     FLOPs / peak; int8 pages count their payload and f32 scales);
  4. serves llama3.2-1b at full width (16 layers, f32, random weights from
     seed 0) through the port's paged continuous batcher with the prefix
     cache: 8 slots, 16 requests of 128 tokens sharing a 96-token system
     prompt, 32 new tokens each -- on the MX kernels, shorter on the
     baseline GEMM, then with speculation (k = 4; a trace drafter over the
     plain streams, and the n-gram drafter), with int8 pages (plain and
     k = 4 n-gram), and a short pass with the target itself as the draft
     model -- and requires every kernel's launch count > 0 on its path and
     every speculative stream equal to its plain stream (a divergence
     passes only at a near tie, see phase 5);
  5. holds the kernel path against the plain path: one prefill chunk, one
     decode step and one verify step (S = 5, f32 and int8 pages) on the
     same cache state under "cuda_mx" and "torch" (logits within 1e-3 *
     max|ref|; the verify step's plain path and the decode step that its
     row 0 is checked against attend over the pages the kernel path wrote;
     int8 pages the two paths write on their own within one quantum),
     profiles a prefill
     chunk and four decode steps and one verify step (device time by
     kernel, busy share), and requires identical token streams at smoke
     size across backends, plain and speculative, for f32 and int8 pages.
The line before the last is the kernel summary JSON; the last line is
{"ok": true, "device": {...}}.  Details go to chiprun_out/chip_smoke.json.
"""
from __future__ import annotations

import contextlib
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
    "mx_flash_verify": "src/repro/kernels/mx_flash_decode.py:257",
}
SOURCES = {
    "mx_matmul_fused": "src/repro_torch/csrc/mx_matmul.cu",
    "baseline_matmul": "src/repro_torch/csrc/baseline_matmul.cu",
    "mx_flash_decode": "src/repro_torch/csrc/mx_flash_decode.cu",
    "mx_flash_verify": "src/repro_torch/csrc/mx_flash_decode.cu",
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


def _attn_inputs(torch, dev, B, H, Hkv, d, ps, lengths, dtype_name, seed, poison, pages,
                 S=None):
    """Copies (together past L2) of q ((B, H, d), or (B, S, H, d) for a
    window) and the page pools over a table that reserves each slot's
    length, plus the table, the lengths and the bytes one call must move.
    pages "same": pools in q's dtype; "int8": int8 payloads quantized per
    row and head as the cache stores them, with f32 scale pages.  poison:
    every non-live row (stale pages, the dump page) is 1e30 -- for int8 the
    1e30 lands in the row's scale."""
    import numpy as np

    from repro_torch.core.precision import QuantSpec
    from repro_torch.kernels.quant import quantize
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
    pel = 1 if pages == "int8" else el
    live_rows = sum(lengths)
    rows_q = B * H * d * (S or 1)
    nbytes = (2 * el * rows_q + 2 * pel * live_rows * Hkv * d + 4 * (B * W + B)
              + (2 * 4 * live_rows * Hkv if pages == "int8" else 0))
    dead = None
    if poison:
        live = np.zeros((P, ps), bool)
        tb = table.cpu().numpy()
        for s, ln in enumerate(lengths):
            for pos in range(ln):
                live[tb[s, pos // ps], pos % ps] = True
        dead = torch.as_tensor(~live, device=dev)[:, :, None, None]

    def make():
        q = torch.randn((B, H, d) if S is None else (B, S, H, d), generator=g,
                        device=dev).to(dt)
        kp, vp = (torch.randn((P, ps, Hkv, d), generator=g, device=dev) for _ in "kv")
        if dead is not None:
            kp, vp = kp.masked_fill(dead, 1e30), vp.masked_fill(dead, 1e30)
        if pages != "int8":
            return q, kp.to(dt), vp.to(dt), {}
        (qk, ks), (qv, vs) = (quantize(t, QuantSpec("int8"), axis=-1) for t in (kp, vp))
        return q, qk, qv, dict(k_scale=ks[..., 0].contiguous(),
                               v_scale=vs[..., 0].contiguous())

    pool_bytes = P * ps * Hkv * (2 * pel * d + (8 if pages == "int8" else 0))
    sets = [make() for _ in range(_copies(pool_bytes))]
    return sets, table, lns, W, nbytes


def _dense_kv(torch, table, k_, v_, G):
    """The library yardstick's input: K/V gathered densely beforehand,
    (B, H, W*ps, d) with the kv heads repeated G times."""
    B, W = table.shape
    _, ps, Hkv, d = k_.shape
    L = W * ps
    k = k_[table.long()].reshape(B, L, Hkv, d).permute(0, 2, 1, 3)
    v = v_[table.long()].reshape(B, L, Hkv, d).permute(0, 2, 1, 3)
    return k.repeat_interleave(G, 1).contiguous(), v.repeat_interleave(G, 1).contiguous()


def check_decode(torch, dev, B, H, Hkv, d, ps, lengths, dtype_name, seed, poison=False,
                 pages="same"):
    import torch.nn.functional as F

    from repro_torch.kernels.mx_flash_decode import mx_flash_decode
    from repro_torch.kernels.ref import paged_decode_ref

    sets, table, lns, W, nbytes = _attn_inputs(torch, dev, B, H, Hkv, d, ps, lengths,
                                               dtype_name, seed, poison, pages)
    flops = 4 * sum(lengths) * H * d
    q, kp, vp, kw = sets[0]
    got = mx_flash_decode(q, kp, vp, table, lns, **kw)
    ref = paged_decode_ref(q, kp, vp, table, lns, **kw)
    torch.cuda.synchronize()
    err, tol = _err(torch, got, ref, dtype_name)
    zero_rows = all(bool(torch.all(got[i] == 0)) for i, ln in enumerate(lengths) if ln == 0)
    finite = bool(torch.isfinite(got).all())
    fns = dict(
        ms=(lambda q_, k_, v_, kw_: mx_flash_decode(q_, k_, v_, table, lns, **kw_), sets),
        plain_ms=(lambda q_, k_, v_, kw_: paged_decode_ref(q_, k_, v_, table, lns, **kw_),
                  sets))
    library = None
    if pages != "int8":  # no single call dequantizes int8 pages
        # library yardstick: SDPA over the same rows gathered densely beforehand
        library = "F.scaled_dot_product_attention on pre-gathered dense K/V"
        mask = (torch.arange(W * ps, device=dev)[None, :] < lns[:, None])[:, None, None, :]
        fns["library_ms"] = (lambda q_, k_, v_: F.scaled_dot_product_attention(
            q_, k_, v_, attn_mask=mask), [(q_[:, :, None, :], *_dense_kv(
                torch, table, k_, v_, H // Hkv)) for q_, k_, v_, _ in sets])
    bound, by = _bound_ms(nbytes, flops, dtype_name)
    return dict(kernel="mx_flash_decode", B=B, H=H, Hkv=Hkv, d=d, ps=ps,
                lengths=list(lengths), poison=poison, pages=pages, dtype=dtype_name,
                max_abs_err=err, tol=tol, zero_rows_exact=zero_rows, finite=finite,
                **_time_ms(torch, fns), library=library, bound_ms=bound, bound_by=by)


def check_verify(torch, dev, B, H, Hkv, d, ps, S, lengths, dtype_name, seed, poison=False,
                 pages="same"):
    """mx_flash_verify against paged_verify_ref; at S = 1 also against the
    decode kernel on the same inputs (within 1e-6 * max|decode|)."""
    import torch.nn.functional as F

    from repro_torch.kernels.mx_flash_decode import mx_flash_decode, mx_flash_verify
    from repro_torch.kernels.ref import paged_verify_ref

    sets, table, lns, W, nbytes = _attn_inputs(torch, dev, B, H, Hkv, d, ps, lengths,
                                               dtype_name, seed, poison, pages, S=S)
    # each window row r sees positions <= len - S + r
    flops = 4 * H * d * sum(max(0, ln - S + r + 1) for ln in lengths if ln
                            for r in range(S))
    q, kp, vp, kw = sets[0]
    got = mx_flash_verify(q, kp, vp, table, lns, **kw)
    ref = paged_verify_ref(q, kp, vp, table, lns, **kw)
    torch.cuda.synchronize()
    err, tol = _err(torch, got, ref, dtype_name)
    out = dict(zero_rows_exact=all(bool(torch.all(got[i] == 0))
                                   for i, ln in enumerate(lengths) if ln == 0),
               finite=bool(torch.isfinite(got).all()))
    if S == 1:
        dec = mx_flash_decode(q[:, 0].contiguous(), kp, vp, table, lns, **kw)
        torch.cuda.synchronize()
        out.update(decode_err=(got[:, 0].float() - dec.float()).abs().max().item(),
                   decode_tol=1e-6 * dec.float().abs().max().item(),
                   decode_bitwise=bool(torch.equal(got[:, 0], dec)))
    fns = dict(
        ms=(lambda q_, k_, v_, kw_: mx_flash_verify(q_, k_, v_, table, lns, **kw_), sets),
        plain_ms=(lambda q_, k_, v_, kw_: paged_verify_ref(q_, k_, v_, table, lns, **kw_),
                  sets))
    library = None
    if pages != "int8":
        library = "F.scaled_dot_product_attention on pre-gathered dense K/V, window mask"
        kpos = torch.arange(W * ps, device=dev)
        last = (lns - S)[:, None] + torch.arange(S, device=dev)  # (B, S)
        mask = (kpos[None, None, :] <= last[:, :, None])[:, None]  # (B, 1, S, L)
        fns["library_ms"] = (lambda q_, k_, v_: F.scaled_dot_product_attention(
            q_, k_, v_, attn_mask=mask), [(q_.transpose(1, 2), *_dense_kv(
                torch, table, k_, v_, H // Hkv)) for q_, k_, v_, _ in sets])
    bound, by = _bound_ms(nbytes, flops, dtype_name)
    return dict(kernel="mx_flash_verify", B=B, S=S, H=H, Hkv=Hkv, d=d, ps=ps,
                lengths=list(lengths), poison=poison, pages=pages, dtype=dtype_name,
                max_abs_err=err, tol=tol, **out, **_time_ms(torch, fns),
                library=library, bound_ms=bound, bound_by=by)


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
        qwen = (33, 0, 160, 7)
        for pages in ("same", "int8"):
            checks.append(check_decode(torch, dev, 8, 32, 8, 64, 16, lengths, dtype_name,
                                       100, pages=pages))
            checks.append(check_decode(torch, dev, 4, 14, 2, 64, 16, qwen, dtype_name,
                                       101, pages=pages))  # G = 7
            if pages == "same":
                checks.append(check_decode(torch, dev, 8, 32, 8, 64, 16, lengths,
                                           dtype_name, 102, poison=True))
            # verify windows as the batcher passes them: every active length >= S
            for S, shape, lns, poison in (
                    (5, (8, 32, 8), lengths, False), (5, (4, 14, 2), qwen, False),
                    (9, (8, 32, 8), lengths, False), (5, (8, 32, 8), lengths, True),
                    (1, (8, 32, 8), lengths, False)):
                wl = tuple(ln + S if ln else 0 for ln in lns)
                checks.append(check_verify(torch, dev, *shape, 64, 16, S, wl, dtype_name,
                                           103 + S, poison=poison, pages=pages))
    for c in checks:
        if "M" in c:
            shape = f"M={c['M']} K={c['K']} N={c['N']} {c.get('epilogue', '')}"
        else:
            shape = (f"B={c['B']} {'S=%d ' % c['S'] if 'S' in c else ''}H={c['H']} "
                     f"Hkv={c['Hkv']} {'int8 ' if c['pages'] == 'int8' else ''}"
                     f"{'poisoned' if c['poison'] else ''}")
        ok = c["max_abs_err"] <= c["tol"] and c.get("zero_rows_exact", True) \
            and c.get("finite", True) and c.get("decode_err", 0) <= c.get("decode_tol", 0)
        c["ok"] = ok
        lib = "none" if c["library_ms"] is None else f"{c['library_ms']:.4f}"
        extra = (f" vs decode {c['decode_err']:.1e} bitwise {c['decode_bitwise']}"
                 if "decode_err" in c else "")
        print(f"  {c['kernel']:16s} {c['dtype']:8s} {shape:40s} err {c['max_abs_err']:.3e} "
              f"(tol {c['tol']:.3e}){extra} {'ok' if ok else 'FAIL'}  ms {c['ms']:.4f} "
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


def serve(torch, model, params, cfg, backend, n_req, gen, prompt_len=128, slots=8,
          label=None, **kw):
    """The trace of `make_trace` through the paged batcher with the prefix
    cache under `backend`; `kw` (kv_quant, speculate, drafter) goes to the
    batcher.  Launch counts are set to 0 just before the run and read just
    after it."""
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
            prefill_chunk=64, **kw)
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
    # steps that admitted nobody run no prefill chunk: pure decode / verify
    admit_steps = {at for r in finished.values() for kind, at in r.events
                   if kind in ("admitted", "resumed")}
    plain_steps = [1e3 * dt for st, dt in step_dt.items() if st not in admit_steps]
    ttft_steps = [r.first_token_at - r.submitted_at for r in finished.values()]
    ttft_ms = [1e3 * sum(step_dt[s] for s in range(r.submitted_at, r.first_token_at + 1))
               for r in finished.values()]
    generated = sum(len(r.output) for r in finished.values())
    out = dict(
        label=label or backend, backend=backend, requests=len(finished), slots=slots,
        prompt_len=prompt_len, kv_cache="int8" if kw.get("kv_quant") else "f32",
        speculate=kw.get("speculate", 0), spec=batcher.spec_stats(),
        gen=gen, wall_s=wall, steps=batcher.steps_run,
        prefill_launches=batcher.prefill_launches, generated_tokens=generated,
        generated_tok_per_s=generated / wall,
        total_tok_per_s=sum(len(r.prompt) + len(r.output)
                            for r in finished.values()) / wall,
        ttft_steps_mean=sum(ttft_steps) / len(ttft_steps), ttft_steps_max=max(ttft_steps),
        ttft_ms_mean=sum(ttft_ms) / len(ttft_ms), ttft_ms_max=max(ttft_ms),
        step_ms_median=statistics.median(plain_steps) if plain_steps else None,
        steps_without_admission=len(plain_steps),
        finish_reasons=batcher.health_summary()["finish_reasons"],
        pool=batcher.pool_stats().as_dict(), prefix=batcher.prefix_stats(),
        launches=counts, streams={r: finished[r].output for r in sorted(finished)},
        prompts={r: finished[r].prompt.tolist() for r in sorted(finished)})
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


def _verify_inputs(torch, dev, cfg, num_pages, S=5):
    """One speculative window of S tokens over 8 slots at ragged depths
    (slot 3 free) against the serving cache, and the decode step that is
    its row 0 on the same state."""
    table, _, _, index, lengths = _step_inputs(torch, dev, cfg, num_pages)
    g = torch.Generator(device=dev).manual_seed(6)
    win = torch.randint(0, cfg.vocab, (table.shape[0], S), generator=g, device=dev)
    vlen = (index + S).to(torch.int32)
    vlen[lengths == 0] = 0
    return table, win, index, vlen, lengths


def _clone(cache0):
    return {seg: {k: v.clone() for k, v in leaves.items()} for seg, leaves in cache0.items()}


@contextlib.contextmanager
def _pages_frozen():
    """Attention's page writes become no-ops inside the block: a step then
    attends over the pages exactly as they are."""
    from repro_torch.models.layers import Attention

    write = Attention.__dict__["_write_kv_pages"]
    Attention._write_kv_pages = staticmethod(lambda cache, *_: cache)
    try:
        yield
    finally:
        Attention._write_kv_pages = write


def hold_verify(torch, dev, model, params, cfg, cache0, num_pages, rel_tol=1e-3):
    """One verify step (S = 5, 8 slots) on the kernel path ("cuda_mx"),
    held against the plain path ("torch") on one page state: the plain
    step, and the decode step that row 0 is checked against, run on copies
    of the cache the kernel path wrote, with page writes frozen, so all
    three attend over identical pages.  Logits within rel_tol * max|ref|.
    For an int8 cache it also counts the page entries the two paths write
    differently on their own (a window row quantized from projections
    summed in another order may round one quantum apart)."""
    from repro_torch import kernels
    from repro_torch.core import ops

    table, win, index, vlen, dlen = _verify_inputs(torch, dev, cfg, num_pages)
    cache_k = _clone(cache0)
    with ops.use_policy(ops.MXPolicy("cuda_mx")):
        kernels.reset_launch_counts()
        vl, _ = model.verify_step_paged(params, win, cache_k, index, table, vlen)
        torch.cuda.synchronize()
        launches = kernels.launch_counts()
        with _pages_frozen():
            dl, _ = model.decode_step_paged(params, win[:, :1], _clone(cache_k), index,
                                            table, dlen)
    with ops.use_policy(ops.MXPolicy("torch")):
        kernels.reset_launch_counts()
        with _pages_frozen():
            rl, _ = model.verify_step_paged(params, win, _clone(cache_k), index, table,
                                            vlen)
        torch.cuda.synchronize()
        torch_launches = kernels.launch_counts()
    out = {}
    for what, got, ref in (("verify_logits", vl, rl),
                           ("verify_row0_vs_decode", vl[:, :1], dl)):
        err = (got - ref).abs().max().item()
        tol = rel_tol * ref.abs().max().item()
        out[what] = dict(max_abs_err=err, tol=tol, ok=err <= tol,
                         argmax_equal=bool(torch.equal(got.argmax(-1), ref.argmax(-1))))
    out["launches_per_verify_step"] = launches
    out["torch_backend_launches"] = torch_launches
    seg = next(iter(cache0))
    if cache0[seg]["k_pages"].dtype == torch.int8:
        cache_p = _clone(cache0)
        with ops.use_policy(ops.MXPolicy("torch")):
            model.verify_step_paged(params, win, cache_p, index, table, vlen)
        diff = torch.cat([(cache_k[seg][k].int() - cache_p[seg][k].int()).abs().flatten()
                          for k in ("k_pages", "v_pages")])
        out["int8_entries_differing"] = int((diff > 0).sum())
        out["int8_max_quanta_apart"] = int(diff.max())
        out["int8_entries_written"] = 2 * cfg.n_layers * int((vlen > 0).sum()) * \
            win.shape[1] * cfg.n_kv_heads * cfg.hd
    return out


def profile_verify(torch, dev, model, params, cfg, cache, num_pages):
    """torch.profiler over one verify step (S = 5, 8 slots) on the kernel
    path, as `profile_steps` does for prefill and decode."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.core import ops

    table, win, index, vlen, _ = _verify_inputs(torch, dev, cfg, num_pages)
    with ops.use_policy(ops.MXPolicy("cuda_mx")):
        model.verify_step_paged(params, win, cache, index, table, vlen)  # warm
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            model.verify_step_paged(params, win, cache, index, table, vlen)
            torch.cuda.synchronize()
            wall_ms = (time.perf_counter() - t0) * 1e3
    rows = sorted(((e.key, e.self_device_time_total / 1e3, e.count)
                   for e in prof.key_averages()
                   if e.device_type != DeviceType.CPU and e.self_device_time_total > 0),
                  key=lambda r: -r[1])
    device_ms = sum(r[1] for r in rows)
    if device_ms == 0:
        return dict(measured=False, window_ms=wall_ms)
    return dict(measured=True, window_ms=wall_ms, device_ms=device_ms,
                busy_share=device_ms / wall_ms,
                top=[dict(name=k[:90], ms=ms, calls=n) for k, ms, n in rows[:8]])


def smoke_streams(torch, dev):
    """Token streams at smoke size: "cuda_mx" and "torch" plain, and, for
    f32 and int8 pages, "cuda_mx" speculative, "cuda_mx" plain and "torch"
    speculative (k = 4, n-gram drafter) must agree within each page type."""
    from repro_torch.configs import get_config
    from repro_torch.core.precision import QuantSpec
    from repro_torch.models import build_model

    cfg = get_config("llama3.2-1b-smoke")
    model = build_model(cfg)
    params = model.init(0, device=dev)
    streams = {}
    for kv in (None, "int8"):
        for backend, k in (("cuda_mx", 0), ("torch", 0), ("cuda_mx", 4), ("torch", 4)):
            if kv and (backend, k) == ("torch", 0):
                continue
            r, _, _ = serve(torch, model, params, cfg, backend, n_req=6, gen=8,
                            prompt_len=24, slots=2, speculate=k,
                            kv_quant=QuantSpec(kv) if kv else None)
            streams[f"{backend} {kv or 'f32'} k={k}"] = r["streams"]
    groups = {kv: [v for n, v in streams.items() if kv in n] for kv in ("f32", "int8")}
    same = all(all(v == vs[0] for v in vs) for vs in groups.values())
    return same, streams


def _plain_logits(torch, model, params, ctx, kv_quant, chunk=64, ps=16):
    """The plain serving path's next-token logits after `ctx`, on a cache
    of the run's page type: the context but its last token in prefill
    chunks, the last token through a decode step (as the batcher feeds a
    prompt)."""
    from repro_torch.core import ops
    from repro_torch.models.modules import param_device

    dev = param_device(params)
    n = len(ctx)
    pages = -(-n // ps)
    cache = model.make_paged_cache(pages + 1, ps, device=dev, kv_quant=kv_quant)
    table = torch.arange(1, pages + 1, dtype=torch.int32, device=dev)[None]
    toks = torch.as_tensor(ctx, device=dev)[None]
    with ops.use_policy(ops.MXPolicy("cuda_mx")), torch.no_grad():
        for s in range(0, n - 1, chunk):
            model.prefill_step_paged(params, toks[:, s:min(s + chunk, n - 1)], cache,
                                     torch.tensor([s], device=dev), table)
        logits, _ = model.decode_step_paged(
            params, toks[:, n - 1:], cache, torch.tensor([n - 1], device=dev), table,
            torch.tensor([n], dtype=torch.int32, device=dev))
    return logits.reshape(-1)


def divergences(torch, model, params, plain, other, kv_quant=None):
    """For each stream of `other` that leaves the plain greedy stream: the
    first divergent token and the plain path's top-2 logit gap there, over
    prompt + the shared prefix on pages of the run's type."""
    out = []
    for rid, toks in other["streams"].items():
        ref = plain["streams"][rid]
        if toks == ref:
            continue
        t = next(i for i, (a, b) in enumerate(zip(toks, ref)) if a != b)
        ctx = list(other["prompts"][rid]) + ref[:t]
        top2 = _plain_logits(torch, model, params, ctx, kv_quant).topk(2).values
        out.append(dict(rid=rid, token=t, plain=ref[t], got=toks[t],
                        top2_gap=(top2[0] - top2[1]).item()))
    return out


# ---------------------------------------------------------------------------


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is visible; this smoke test needs a GPU",
              file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch.configs import get_config
    from repro_torch.core.precision import QuantSpec
    from repro_torch.kernels import _build
    from repro_torch.models import build_model
    from repro_torch.models.modules import param_count
    from repro_torch.runtime.speculative import DraftModelProposer, NGramDrafter, TraceDrafter

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
        entry = ""
        for line in _build.ptxas_report(name).splitlines():
            if "Compiling entry function" in line:
                entry = line.split("'")[1][:48]  # the mangled kernel name
            elif "registers" in line or "spill" in line:
                print(f"    {name} {entry}: {line.strip()}")
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
    # this slice's runs on the same trace: speculation (k = 4) and int8 pages
    traces = [main_run["prompts"][r] + main_run["streams"][r] for r in main_run["streams"]]
    int8 = QuantSpec("int8")
    spec_runs = {}
    for label, kw in (
            ("(a) spec4 trace overlap 1.0", dict(speculate=4,
                                                 drafter=TraceDrafter(traces))),
            ("(b) spec4 ngram", dict(speculate=4, drafter=NGramDrafter())),
            ("(c) int8 plain", dict(kv_quant=int8)),
            ("(c) int8 spec4 ngram", dict(kv_quant=int8, speculate=4,
                                          drafter=NGramDrafter()))):
        run, b, _ = serve(torch, model, params, cfg, "cuda_mx", n_req=16, gen=32,
                          label=label, **kw)
        spec_runs[label] = run
        if label == "(c) int8 spec4 ngram":
            int8_batcher = b
    # every speculative stream against its plain counterpart (int8 pages
    # round K/V, so the int8 plain stream is the int8 reference; its
    # agreement with the f32 stream is recorded, not required)
    for label, run in spec_runs.items():
        if run["speculate"]:
            plain = spec_runs["(c) int8 plain"] if "int8" in label else main_run
            run["plain_is"] = plain["label"]
            run["streams_equal"] = sum(run["streams"][r] == plain["streams"][r]
                                       for r in run["streams"])
            run["divergences"] = divergences(torch, model, params, plain, run,
                                             int8 if "int8" in label else None)
        else:
            run["streams_equal_f32"] = sum(run["streams"][r] == main_run["streams"][r]
                                           for r in run["streams"])
        _print_serve(run)
    # the draft model: the target's own weights, context past max_len
    draft = DraftModelProposer(model, params, max_context=256)
    dm_run, _, _ = serve(torch, model, params, cfg, "cuda_mx", n_req=4, gen=8,
                         label="draft-model spec4", speculate=4, drafter=draft)
    dm_run["forwards"] = draft.forwards
    dm_run["plain_is"] = main_run["label"]
    dm_run["streams_equal"] = sum(dm_run["streams"][r] == main_run["streams"][r][:8]
                                  for r in dm_run["streams"])
    dm_run["divergences"] = divergences(
        torch, model, params, dict(streams={r: main_run["streams"][r][:8]
                                            for r in dm_run["streams"]}), dm_run)
    _print_serve(dm_run)
    spec_runs[dm_run["label"]] = dm_run

    launches = dict(main_run["launches"])
    launches["baseline_matmul"] = base_run["launches"]["baseline_matmul"]
    launches["mx_flash_verify"] = spec_runs["(b) spec4 ngram"]["launches"]["mx_flash_verify"]
    for name, n in launches.items():
        if n <= 0:
            raise AssertionError(f"kernel {name} was not launched on its serving path")
    if main_run["launches"]["baseline_matmul"] or base_run["launches"]["mx_matmul_fused"]:
        raise AssertionError(f"backends leaked into each other: {main_run['launches']} "
                             f"/ {base_run['launches']}")
    for label, run in spec_runs.items():
        n = run["launches"]
        want_verify, want_decode = run["speculate"] > 0, run["speculate"] == 0
        if (n["mx_flash_verify"] > 0) != want_verify or \
                (n["mx_flash_decode"] > 0) != want_decode or not n["mx_matmul_fused"]:
            raise AssertionError(f"{label}: unexpected kernel launches {n}")

    print("[5] kernel path against plain path")
    held = hold_steps(torch, dev, model, params, cfg, batcher.cache,
                      batcher.pool.total_pages)
    held_v = hold_verify(torch, dev, model, params, cfg, batcher.cache,
                         batcher.pool.total_pages)
    # int8: on their own, the two paths may write a window row one quantum
    # (amax / 127 of its row) apart; the logits are held on one page state,
    # and the pages at one quantum
    held_v8 = hold_verify(torch, dev, model, params, cfg, int8_batcher.cache,
                          int8_batcher.pool.total_pages)
    print(f"    int8 verify step: {held_v8['int8_entries_differing']} of "
          f"{held_v8['int8_entries_written']} written page entries differ between the "
          f"paths, at most {held_v8['int8_max_quanta_apart']} quantum apart")
    if held_v8["int8_max_quanta_apart"] > 1:
        raise AssertionError(f"int8 pages differ by more than one quantum: {held_v8}")
    for what, h in (("prefill_logits", held["prefill_logits"]),
                    ("decode_logits", held["decode_logits"]),
                    ("verify_logits", held_v["verify_logits"]),
                    ("verify_row0_vs_decode", held_v["verify_row0_vs_decode"]),
                    ("int8 verify_logits", held_v8["verify_logits"]),
                    ("int8 verify_row0_vs_decode", held_v8["verify_row0_vs_decode"])):
        print(f"    {what}: err {h['max_abs_err']:.3e} (tol {h['tol']:.3e}) "
              f"argmax equal {h['argmax_equal']}")
        if not h["ok"]:
            raise AssertionError(f"{what}: the kernel path disagrees: {h}")
    print(f"    launches per prefill chunk (64 tokens): {held['launches_per_prefill_chunk']}")
    print(f"    launches per decode step (8 slots): {held['launches_per_decode_step']}")
    print(f"    launches per verify step (8 slots x 5 rows): "
          f"{held_v['launches_per_verify_step']}")
    prof = profile_steps(torch, dev, model, params, cfg, batcher.cache,
                         batcher.pool.total_pages)
    prof_v = profile_verify(torch, dev, model, params, cfg, batcher.cache,
                            batcher.pool.total_pages)
    for what, p in ((f"1 prefill chunk + {prof.get('n_decode')} decode steps", prof),
                    ("1 verify step, S = 5", prof_v)):
        if p["measured"]:
            print(f"    profile ({what}): window {p['window_ms']:.2f} ms, device busy "
                  f"{p['device_ms']:.2f} ms ({100 * p['busy_share']:.1f}%)")
            for r in p["top"]:
                print(f"      {r['ms']:9.3f} ms  x{r['calls']:<5d} {r['name']}")
        else:
            print(f"    profile ({what}): device time not measured "
                  f"(window {p['window_ms']:.2f} ms)")
    same, streams = smoke_streams(torch, dev)
    print(f"    smoke-size token streams equal across cuda_mx / torch, plain / "
          f"speculative, f32 and int8 (each within its page type): {same}")
    if not same:
        raise AssertionError(f"token streams differ: {streams}")
    # greedy-exact: a full-width speculative stream may leave the plain one
    # only at a near tie, a top-2 logit gap below the kernel path's error
    near_tie = max(held["decode_logits"]["max_abs_err"],
                   held_v["verify_logits"]["max_abs_err"])
    for label, run in spec_runs.items():
        bad = [d for d in run.get("divergences", ()) if d["top2_gap"] > near_tie]
        if bad:
            raise AssertionError(f"{label}: streams leave the plain ones away from a "
                                 f"near tie (kernel-path error {near_tie:.3e}): {bad}")

    headline = {  # a decode-step call of each kernel on the main path, f32
        # the down projection: one library call (addmm) computes the same function
        "mx_matmul_fused": dict(M=8, K=8192, N=2048, epilogue=dict(residual=True)),
        "baseline_matmul": dict(M=8, K=2048, N=8192),
        "mx_flash_decode": dict(B=8, H=32, poison=False, pages="same"),
        # the llama decode window (k = 4): f32 q and pages
        "mx_flash_verify": dict(B=8, H=32, S=5, poison=False, pages="same"),
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
            shape={k: c[k] for k in ("M", "K", "N", "B", "S", "H", "Hkv", "d") if k in c},
            dtype="float32"))
    out_dir = ROOT / "chiprun_out"
    out_dir.mkdir(exist_ok=True)
    (out_dir / "chip_smoke.json").write_text(json.dumps(dict(
        device=smi, build_s=build_s, checks=checks, serve=main_run,
        serve_baseline=base_run, serve_spec=spec_runs, hold=held,
        hold_verify=held_v, hold_verify_int8=held_v8, profile=prof, profile_verify=prof_v,
        smoke_streams=streams, kernels=summary), indent=1, default=str))
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
    print(f"    [{r['label']}] {r['requests']} requests x {r['gen']} new tokens through "
          f"{r['slots']} slots: {r['wall_s']:.2f} s, {r['generated_tok_per_s']:.1f} "
          f"generated tok/s ({r['total_tok_per_s']:.1f} incl. prompt), "
          f"{r['steps']} steps + {r['prefill_launches']} prefill chunks")
    print(f"      TTFT {r['ttft_steps_mean']:.1f} steps mean / {r['ttft_steps_max']} max, "
          f"{r['ttft_ms_mean']:.1f} ms mean / {r['ttft_ms_max']:.1f} ms max; median step "
          f"without admission {r['step_ms_median'] or float('nan'):.2f} ms "
          f"({r['steps_without_admission']} steps)")
    p, x = r["pool"], r["prefix"]
    print(f"      pool high water {p['high_water']}/{p['num_pages']} pages; prefix hits "
          f"{x['hits']}/{x['hits'] + x['misses']}, {x['tokens_saved']} tokens skipped, "
          f"{x['cow_copies']} COW copies, {x['evicted_pages']} evicted")
    print(f"      launches {r['launches']}; finish {r['finish_reasons']}")
    if r["spec"]:
        sp = r["spec"]
        print(f"      speculation: {sp['accepted']}/{sp['drafted']} drafts accepted "
              f"({100 * sp['acceptance_rate']:.1f}%), {sp['emitted']} tokens over "
              f"{sp['launches']} verify steps ({sp['tokens_per_launch']:.2f} tokens per "
              f"step){', %d draft forwards' % r['forwards'] if 'forwards' in r else ''}")
    if "streams_equal" in r:
        print(f"      streams equal to [{r['plain_is']}]: {r['streams_equal']}/"
              f"{len(r['streams'])}; divergences {r['divergences']}")
    if "streams_equal_f32" in r:
        print(f"      streams equal to the f32-page streams: {r['streams_equal_f32']}/"
              f"{len(r['streams'])} (recorded, not required)")


if __name__ == "__main__":
    sys.exit(main())
