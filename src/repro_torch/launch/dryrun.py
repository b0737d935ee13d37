"""Dry run: every (arch x shape) cell priced on one H100 without running it
there (port of `repro/launch/dryrun.py`).

For each cell this module
  1. builds the cell's arguments on the "meta" device (`launch/specs.py`:
     parameters, AdamW state, batch, the dense cache or recurrent state;
     shapes and dtypes, no storage),
  2. runs the step the cell names on them (`launch/steps.py`: the train
     step, with AdamW updating in place as the launcher's donated buffers
     do in JAX; the prefill step; the serve step) under the op census
     (`core/op_census.py`, the counterpart of JAX's HLO census),
  3. records the step's FLOPs, bytes and live peak, the H100 roofline
     (`core/roofline.RooflineReport`), MODEL_FLOPS and the transfer-model
     reports, one JSON file per cell.

JAX lowers and compiles each cell for a TPU pod (`make_production_mesh`,
16x16 or 2x16x16); the port invents no GPU pod layout.  `--mesh DxT`
(default 1x1: the one card) names a data x model mesh: argument bytes per
device follow the specs (`parallel/sharding.tree_specs`), the census's
other counts are divided evenly over the D*T cards (a process of the port
holds whole tensors, so the step is counted once, whole), and the
collective bytes are modelled: at T > 1 the tensor-parallel rings of
`transfer_model.RingCollectiveGemm` (each transformer layer's q/k/v,
attention-out, MLP up and down rings and the head's; a train step runs
them three times: forward, the backward's re-gather and its gradient
reduce-scatter), and in a train cell at D > 1 the gradients' ring
all-reduce, 2(D-1)/D x 4N/T bytes per device.  On one card they are 0.

Usage:
  python -m repro_torch.launch.dryrun --arch llama3.2-1b --shape decode_32k
  python -m repro_torch.launch.dryrun --all [--mesh 1x1] [--out experiments/dryrun_torch]
"""
from __future__ import annotations

import argparse
import json
import math
import time
import traceback
from pathlib import Path

import torch

from ..configs import ARCH_IDS, SHAPES, cell_applicable, get_config
from ..core.op_census import census, top_ops
from ..core.precision import resolve_precision
from ..core.roofline import HBM_BW, HBM_CAPACITY, NVLINK_BW, PEAK_FLOPS, RooflineReport
from ..core.transfer_model import (AbftGemm, GemmProblem, HopperGemmTiling, PagedKVDecode,
                                   RingCollectiveGemm, SharedPrefixPrefill, SparseGemm)
from ..launch.mesh import make_mesh
from ..launch.specs import cell_specs
from ..launch.steps import make_prefill_step, make_serve_step, make_train_step
from ..models import build_model
from ..optim.adamw import AdamW
from ..optim.schedules import warmup_cosine
from ..parallel.sharding import autotune_collective_policy, make_rules, use_rules

DEFAULT_OUT = "experiments/dryrun_torch"


def _block_gemms(cfg, M: int) -> dict:
    """(M, N, K) of a layer's four projections; a gated (SwiGLU) up
    projection carries the gate beside it (doubled N)."""
    d, hd = cfg.d_model, cfg.hd
    ff = cfg.d_ff or 4 * d
    return {
        "qkv": (M, (cfg.n_heads + 2 * cfg.n_kv_heads) * hd, d),
        "attn_out": (M, d, cfg.n_heads * hd),
        "mlp_up": (M, 2 * ff if cfg.activation == "silu" else ff, d),
        "mlp_down": (M, d, ff),
    }


def collective_gemm_reports(cfg, mesh, tokens_per_step: int) -> dict:
    """Per-layer overlap model for the TP ring collective GEMMs: one record
    per projection kind (qkv / attn-out / mlp-up / mlp-down / lm_head) with
    exposed-comm bytes/time from `transfer_model.RingCollectiveGemm`, at
    NVLink's rate and the bf16 tensor-core peak.  The ring's direction is
    autotuned from the same model (`autotune_collective_policy`).  Empty
    on a mesh without a model axis of more than one card."""
    P = int(mesh.shape.get("model", 1))
    if P <= 1:
        return {}
    dp = max(math.prod(mesh.shape.values()) // P, 1)
    M = max(tokens_per_step // dp, 1)  # rows entering each TP ring
    shapes = _block_gemms(cfg, M)
    modes = {"qkv": "allgather", "attn_out": "reduce_scatter", "mlp_up": "allgather",
             "mlp_down": "reduce_scatter"}
    gemms = {k: (modes[k], GemmProblem(*shapes[k], 2)) for k in modes}
    gemms["lm_head"] = ("allgather", GemmProblem(M, cfg.vocab, cfg.d_model, 2))
    policy, schedule = autotune_collective_policy(
        mesh, gemms.values(), ici_bw=NVLINK_BW, peak_flops=PEAK_FLOPS["bfloat16"])
    bidir = policy.direction == "bidir"
    out = {"schedule": schedule}
    for name, (mode, prob) in gemms.items():
        ring = RingCollectiveGemm(mode=mode, axis_size=P, bidirectional=bidir)
        out[name] = ring.report(prob, ici_bw=NVLINK_BW, peak_flops=PEAK_FLOPS["bfloat16"])
    return out


def quantized_gemm_reports(cfg, tokens_per_step: int) -> dict:
    """Per-layer quantized-traffic model for the block projections: the
    policy's per-operand HBM bytes at a 128^3 tiling and the narrow-operand
    traffic credit against bf16.  ``active`` marks whether the config
    declares the policy; otherwise the report is the counterfactual for
    "int8" (weights int8 per tile, activations bf16)."""
    name = getattr(cfg, "precision", "none")
    active = name not in ("none", "f32")
    prec = resolve_precision(name if active else "int8")
    if prec is None:
        return {}
    tiling = HopperGemmTiling(128, 128, 128)
    out = {"policy": name if active else "int8", "active": active}
    total_q = total_base = 0
    for gname, (m, n, k) in _block_gemms(cfg, max(tokens_per_step, 1)).items():
        base = GemmProblem(m, n, k, 2)  # bf16 activations and weights
        quant = GemmProblem(m, n, k, prec.a.bytes_for(2), b_bytes=prec.b.bytes_for(2),
                            out_bytes=2)
        qb, bb = tiling.hbm_bytes(quant), tiling.hbm_bytes(base)
        total_q += qb
        total_base += bb
        out[gname] = {
            "a_bytes": quant.a_elem_bytes, "b_bytes": quant.b_elem_bytes,
            "out_bytes": quant.out_elem_bytes,
            "hbm_bytes": qb, "hbm_bytes_bf16": bb,
            "traffic_credit_bytes": bb - qb,
            "bytes_ratio": qb / bb if bb else 1.0,
        }
    out["total_hbm_bytes"] = total_q
    out["total_hbm_bytes_bf16"] = total_base
    out["total_traffic_credit_bytes"] = total_base - total_q
    out["bytes_ratio"] = total_q / total_base if total_base else 1.0
    return out


def sparse_gemm_reports(cfg, tokens_per_step: int) -> dict:
    """What 2:4 structured-sparse weights would save on the block
    projections: the `SparseGemm` stream model at a 128^3 tiling.
    ``active`` marks a config that declares a sparse policy; otherwise the
    counterfactual at "sparse24"'s own operand bytes."""
    name = getattr(cfg, "precision", "none")
    prec = resolve_precision(name) if name not in ("none",) else None
    active = prec is not None and prec.b_sparse is not None
    if not active:
        prec = resolve_precision("sparse24")
    model = SparseGemm(bm=128, bn=128, bk=128)
    out = {"policy": name if active else "sparse24", "active": active}
    total_sparse = total_dense = 0
    for gname, (m, n, k) in _block_gemms(cfg, max(tokens_per_step, 1)).items():
        prob = GemmProblem(m, n, k, prec.a.bytes_for(2), b_bytes=prec.b.bytes_for(2),
                           out_bytes=2)
        rec = model.report(prob)
        total_sparse += rec["weight_stream_bytes"]
        total_dense += rec["dense_weight_stream_bytes"]
        out[gname] = rec
    out["total_weight_stream_bytes"] = total_sparse
    out["total_dense_weight_stream_bytes"] = total_dense
    out["weight_ratio"] = (total_sparse / total_dense) if total_dense else 1.0
    return out


def abft_gemm_reports(cfg, tokens_per_step: int) -> dict:
    """What checksummed GEMMs would cost on the block projections: the
    `AbftGemm` overhead model at a 128x128 tiling, float tolerance (a pure
    counterfactual: ABFT is a dispatch flag, not a config property)."""
    model = AbftGemm(bm=128, bn=128, exact=False)
    out = {"bm": 128, "bn": 128, "exact": False}
    macs = extra = 0
    for gname, (m, n, k) in _block_gemms(cfg, max(tokens_per_step, 1)).items():
        prob = GemmProblem(m, n, k, 2)
        rec = model.report(prob)
        macs += prob.macs
        extra += rec["checksum_macs"]
        out[gname] = rec
    out["total_checksum_macs"] = extra
    out["total_overhead_ratio"] = extra / macs if macs else 0.0
    return out


def _paged_attn_layers(cfg) -> int:
    """Attention-block count when the paged serving paths cover `cfg`
    (attention-only segments, no shared block, prefix or encoder), else 0."""
    paged_capable = (not cfg.shared_attn_every and not cfg.frontend_dim
                     and not cfg.enc_layers
                     and all(kind in ("dense", "moe") for kind, _ in cfg.blocks))
    if not paged_capable:
        return 0
    return sum(n for kind, n in cfg.blocks if kind in ("dense", "moe"))


def paged_kv_decode_reports(cfg, preset, *, page_size: int = 128) -> dict:
    """Decode-step KV traffic: the dense (slots, max_len) rectangle against
    the pages resident at fills of 1/4 to 1 of the preset's length, bf16
    cache elements, at the card's HBM rate."""
    n_attn = _paged_attn_layers(cfg)
    if not n_attn:
        return {}
    model = PagedKVDecode(batch_slots=preset.global_batch, max_len=preset.seq_len,
                          page_size=page_size, n_kv_heads=cfg.n_kv_heads, head_dim=cfg.hd,
                          n_layers=n_attn, kv_bytes=2)
    out = {"page_size": page_size, "n_attn_layers": n_attn, "fills": {}}
    for fill in (0.25, 0.5, 0.75, 1.0):
        lengths = [max(1, int(fill * preset.seq_len))] * preset.global_batch
        out["fills"][f"{fill:.2f}"] = model.report(lengths, hbm_bw=HBM_BW)
    return out


def shared_prefix_reports(cfg, preset, *, page_size: int = 128) -> dict:
    """Prefill FLOPs and HBM bytes a prefix-cache hit saves at prompt
    overlaps of 0, 1/2 and 9/10 of the preset's length, in seconds at the
    card's bf16 peak and HBM rate."""
    n_attn = _paged_attn_layers(cfg)
    if not n_attn:
        return {}
    model = SharedPrefixPrefill(d_model=cfg.d_model, d_ff=cfg.d_ff, n_heads=cfg.n_heads,
                                n_kv_heads=cfg.n_kv_heads, head_dim=cfg.hd, n_layers=n_attn,
                                gated_mlp=(cfg.activation == "silu"), act_bytes=2,
                                kv_bytes=2, page_size=page_size)
    return model.report(preset.seq_len, overlaps=(0.0, 0.5, 0.9),
                        flops_rate=PEAK_FLOPS["bfloat16"], hbm_bw=HBM_BW)


def parse_mesh(mesh: str) -> tuple:
    """"DxT" -> (D, T)."""
    try:
        d, t = (int(v) for v in mesh.lower().split("x"))
    except ValueError:
        raise ValueError(f"--mesh takes DxT (data x model), got {mesh!r}") from None
    if d < 1 or t < 1:
        raise ValueError(f"--mesh {mesh!r}: each axis needs at least one card")
    return d, t


def _sharded_bytes(mesh, arg, spec) -> int:
    """Bytes per device of an argument tree under its spec tree."""
    if isinstance(arg, torch.Tensor):
        ways = 1
        for entry in spec:
            for axis in (entry,) if isinstance(entry, str) else (entry or ()):
                ways *= mesh.shape[axis]
        return arg.numel() * arg.element_size() // ways
    if isinstance(arg, dict):
        return sum(_sharded_bytes(mesh, arg[k], spec[k]) for k in arg)
    if isinstance(arg, (tuple, list)):
        return sum(_sharded_bytes(mesh, a, s) for a, s in zip(arg, spec))
    return 0  # the decode index, a host int


def collective_bytes(cfg, mesh, kind: str, tokens_per_step: int, reports: dict) -> dict:
    """Modelled collective bytes per device of one step, by kind."""
    out = {}
    T, D = int(mesh.shape["model"]), int(mesh.shape["data"])
    if reports:
        layers = sum(n for k, n in cfg.blocks if k in ("dense", "moe", "encdec"))
        layers += cfg.enc_layers
        per_layer = sum(reports[k]["comm_bytes_total"]
                        for k in ("qkv", "attn_out", "mlp_up", "mlp_down"))
        ring = per_layer * layers + reports["lm_head"]["comm_bytes_total"]
        out["tp_rings"] = float(ring * (3 if kind == "train" else 1))
    if kind == "train" and D > 1:
        out["grad_all_reduce"] = 2 * (D - 1) / D * 4 * cfg.n_params() / T
    return out


def run_cell(arch: str, shape: str, mesh: str = "1x1", *, extra: dict | None = None) -> dict:
    """Census one cell on the meta device; returns the result record.
    `extra` takes JAX's "microbatch" (the train step's gradient
    accumulation).  Parameters are bf16, as JAX's dry run abstracts them."""
    cfg = get_config(arch)
    preset = SHAPES[shape]
    ok, reason = cell_applicable(cfg, preset)
    if not ok:
        return {"arch": arch, "shape": shape, "mesh": mesh, "status": "skipped",
                "reason": reason}
    extra = extra or {}
    D, T = parse_mesh(mesh)
    mesh_obj = make_mesh((D, T), ("data", "model"))
    chips = D * T
    rules = make_rules(mesh_obj, profile=cfg.parallelism, fsdp=cfg.fsdp)
    model = build_model(cfg)
    opt = AdamW(lr=warmup_cosine(3e-4, 100, 10_000))
    param_dtype = torch.bfloat16
    specs = cell_specs(cfg, preset, rules, param_dtype=param_dtype, opt=opt)
    if specs.kind == "train":
        step = make_train_step(model, cfg, opt, microbatch=extra.get("microbatch", 1),
                               inplace=True)
    elif specs.kind == "prefill":
        step = make_prefill_step(model, cfg)
    else:
        step = make_serve_step(model, cfg)

    t0 = time.perf_counter()
    with use_rules(rules):
        cen, _ = census(step, *specs.args)
    t_census = time.perf_counter() - t0

    arg_dev = sum(_sharded_bytes(mesh_obj, a, s) for a, s in zip(specs.args, specs.in_specs))
    out_dev, temp_dev = cen.output_bytes / chips, cen.temp_bytes / chips
    alias_dev = cen.alias_bytes / chips
    peak_dev = arg_dev + out_dev + temp_dev - alias_dev
    per_dev_flops = cen.flops / chips
    per_dev_bytes = arg_dev + (cen.floor_bytes - cen.argument_bytes) / chips
    coll_reports = collective_gemm_reports(cfg, mesh_obj, specs.tokens_per_step)
    coll = collective_bytes(cfg, mesh_obj, specs.kind, specs.tokens_per_step, coll_reports)
    per_dev_coll = sum(coll.values())

    n_active = cfg.n_active_params()
    factor = 6.0 if specs.kind == "train" else 2.0
    model_flops = factor * n_active * specs.tokens_per_step
    dtype_name = str(param_dtype).removeprefix("torch.")
    report = RooflineReport(hlo_flops=per_dev_flops * chips, hlo_bytes=per_dev_bytes * chips,
                            collective_bytes=per_dev_coll * chips, chips=chips,
                            model_flops=model_flops, peak_flops=PEAK_FLOPS[dtype_name])
    return {
        "arch": arch,
        "shape": shape,
        "mesh": mesh,
        "status": "ok",
        "kind": specs.kind,
        "chips": chips,
        "param_dtype": dtype_name,
        "census_s": round(t_census, 2),
        "memory": {
            "argument_bytes_per_device": arg_dev,
            "output_bytes_per_device": out_dev,
            "temp_bytes_per_device": temp_dev,
            "alias_bytes_per_device": alias_dev,
            "peak_bytes_per_device": peak_dev,
            "fits_h100_80gb": bool(peak_dev < HBM_CAPACITY),
        },
        "cost": {
            "per_device_flops": per_dev_flops,
            "per_device_bytes": per_dev_bytes,
            "op_bytes_per_device": cen.op_bytes / chips,
            "per_device_collective_bytes": per_dev_coll,
            "collective_bytes_by_kind": coll,
            "census_flops": cen.flops,
            "census_floor_bytes": cen.floor_bytes,
            "census_op_bytes": cen.op_bytes,
            "census_peak_live_bytes": cen.peak_live_bytes,
            "top_ops_by_flops": top_ops(cen, key="flops"),
            "top_ops_by_bytes": top_ops(cen, key="bytes"),
        },
        "roofline": report.as_dict(),
        "collective_gemms": coll_reports,
        "quantized_gemms": quantized_gemm_reports(cfg, specs.tokens_per_step),
        "sparse_gemms": sparse_gemm_reports(cfg, specs.tokens_per_step),
        "abft_gemms": abft_gemm_reports(cfg, specs.tokens_per_step),
        "paged_kv_decode": (paged_kv_decode_reports(cfg, preset)
                            if specs.kind == "decode" else {}),
        "shared_prefix_prefill": (shared_prefix_reports(cfg, preset)
                                  if specs.kind == "decode" else {}),
        "n_params": cfg.n_params(),
        "n_active_params": n_active,
        "tokens_per_step": specs.tokens_per_step,
        "dropped_shardings": len(rules.dropped),
    }


def summary_table(out: Path, mesh: str = "1x1") -> str:
    """A markdown table of the records under `out` for `mesh`, one row per
    cell: peak GiB per device, fits, the bound's term, MODEL_FLOPS over the
    census's FLOPs (skipped cells with their reason)."""
    rows = ["| arch | shape | kind | peak GiB / device | fits 80 GB | bound | "
            "model / census FLOPs |", "|---|---|---|---|---|---|---|"]
    for path in sorted(out.glob(f"*__*__{mesh}.json")):
        rec = json.loads(path.read_text())
        if rec["status"] == "ok":
            m, r = rec["memory"], rec["roofline"]
            rows.append(f"| {rec['arch']} | {rec['shape']} | {rec['kind']} | "
                        f"{m['peak_bytes_per_device'] / 2**30:.2f} | "
                        f"{'yes' if m['fits_h100_80gb'] else 'no'} | {r['bound']} | "
                        f"{r['useful_flops_ratio']:.4f} |")
        else:
            rows.append(f"| {rec['arch']} | {rec['shape']} | {rec['status']} | "
                        f"{rec.get('reason') or rec.get('error')} | | | |")
    return "\n".join(rows)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--arch", choices=ARCH_IDS)
    ap.add_argument("--shape", choices=tuple(SHAPES))
    ap.add_argument("--mesh", default="1x1", help="DxT: data x model cards (default 1x1)")
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--out", default=DEFAULT_OUT)
    ap.add_argument("--microbatch", type=int, default=1)
    ap.add_argument("--skip-existing", action="store_true")
    args = ap.parse_args(argv)
    parse_mesh(args.mesh)

    out = Path(args.out)
    out.mkdir(parents=True, exist_ok=True)
    if args.all:
        cells = [(a, s) for a in ARCH_IDS for s in SHAPES]
    else:
        if not (args.arch and args.shape):
            ap.error("give --arch and --shape, or --all")
        cells = [(args.arch, args.shape)]

    failures = 0
    for arch, shape in cells:
        path = out / f"{arch}__{shape}__{args.mesh}.json"
        if args.skip_existing and path.exists():
            print(f"[skip-existing] {path}")
            continue
        print(f"=== {arch} x {shape} x {args.mesh} ===", flush=True)
        try:
            rec = run_cell(arch, shape, args.mesh, extra={"microbatch": args.microbatch})
        except Exception as e:  # noqa: BLE001 -- record the failure, keep going
            traceback.print_exc()
            rec = {"arch": arch, "shape": shape, "mesh": args.mesh, "status": "error",
                   "error": f"{type(e).__name__}: {e}"}
            failures += 1
        path.write_text(json.dumps(rec, indent=2, default=str))
        if rec["status"] == "ok":
            r, m = rec["roofline"], rec["memory"]
            print(f"  bound={r['bound']} compute={r['compute_s']:.4f}s "
                  f"mem={r['memory_s']:.4f}s coll={r['collective_s']:.4f}s "
                  f"peak={m['peak_bytes_per_device'] / 2**30:.2f}GiB "
                  f"fits_h100_80gb={m['fits_h100_80gb']} "
                  f"useful_flops={r['useful_flops_ratio']:.4f} "
                  f"(census {rec['census_s']}s)", flush=True)
        elif rec["status"] == "skipped":
            print(f"  skipped: {rec['reason']}")
    if args.all:
        print(summary_table(out, args.mesh))
    print(f"done; {failures} failures")
    return 1 if failures else 0


if __name__ == "__main__":
    raise SystemExit(main())
