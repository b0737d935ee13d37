"""Quickstart for the PyTorch + CUDA port: the MX core in a few minutes.

  PYTHONPATH=src python examples/torch/quickstart.py                 # on the card
  PYTHONPATH=src python examples/torch/quickstart.py --device cpu    # on the host

1. the paper's transfer calculus (Table I/II) on a real GEMM,
2. the Hopper tile pricer on the tile kernel 1 launches for it,
3. kernel 1 (`mx_matmul_fused`) against its plain version (on the CPU the
   wrapper runs the plain version itself),
4. a tiny LM trained for a few steps (the plain path under autograd).
"""
import argparse

import torch

from repro_torch.configs import get_config
from repro_torch.core.device import resolve_device
from repro_torch.core.tiling import plan_matmul_tiles
from repro_torch.core.transfer_model import BaselineKernel, GemmProblem, MXKernel
from repro_torch.data.pipeline import SyntheticLM
from repro_torch.kernels.mx_matmul import dot_f32, mx_matmul_fused
from repro_torch.launch.steps import make_train_step
from repro_torch.models import build_model
from repro_torch.optim.adamw import AdamW

KERNEL_TOL = 1e-4  # f32 kernel against its plain version, times max|ref|


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    ap.add_argument("--steps", type=int, default=6)
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)

    # --- 1. the paper's calculus -------------------------------------
    p = GemmProblem(64, 64, 64, elem_bytes=8)
    base = BaselineKernel(4, 32, 1)
    mx = MXKernel(8, 16, 4, 8, 4, 4)
    print("== paper Table II at 64^3 FP64 ==")
    print(f" baseline MEM<->VRF transfers: {base.mem_to_vrf(p).total}")
    print(f" MX       MEM<->VRF transfers: {mx.mem_to_vrf(p).total}")
    print(f" VRF-access reduction:         {mx.vrf_access_reduction_vs(base, p):.2f}x")

    # --- 2. the Hopper tile pricer -----------------------------------
    M, N, K = 2048, 8192, 2048  # llama3.2-1b's up projection over a 2048-token prefill
    plan = plan_matmul_tiles(M, N, K, torch.bfloat16, torch.bfloat16)
    print("\n== kernel 1's tile for llama3.2-1b's up projection (bf16, M=2048) ==")
    print(f" route {plan.route}, CTA tile (bm, bn, bk) = ({plan.bm}, {plan.bn}, {plan.bk}), "
          f"{plan.stages} stages, {plan.ctas} CTAs")
    print(f" shared memory     = {plan.smem_bytes / 2**10:.1f} KiB per CTA")
    print(f" HBM traffic       = {plan.hbm_bytes / 2**20:.1f} MiB "
          f"(AI = {plan.arithmetic_intensity:.0f} FLOP/B)")

    # --- 3. the kernel against its plain version ---------------------
    g = torch.Generator(device=dev).manual_seed(0)
    a = torch.randn((96, 160), generator=g, device=dev)
    b = torch.randn((160, 224), generator=g, device=dev)
    out = mx_matmul_fused(a, b)
    ref = dot_f32(a, b)
    err = float((out - ref).abs().max() / ref.abs().max())
    ok = err <= KERNEL_TOL
    where = "kernel 1 on the card" if dev.type == "cuda" else "its plain version on the host"
    print(f"\n== mx_matmul_fused ({where}) ==\n kernel vs plain: max |err| {err:.2e} * "
          f"max|ref| (tol {KERNEL_TOL:g}) {'ok' if ok else 'FAILED'}")

    # --- 4. a tiny LM ------------------------------------------------
    cfg = get_config("llama3.2-1b-smoke")
    model = build_model(cfg)
    params = model.init(0, device=dev)
    opt = AdamW(lr=3e-3, weight_decay=0.0)
    state = opt.init(params)
    step = make_train_step(model, cfg, opt)
    batch = SyntheticLM(cfg, seq_len=32, global_batch=4).next_batch()
    print("\n== training a smoke LM (same batch, loss must fall) ==")
    losses = []
    for i in range(args.steps):
        params, state, m = step(params, state, batch)
        losses.append(float(m["loss"]))
        print(f" step {i}: loss {losses[-1]:.4f}")
    fell = losses[-1] < losses[0]
    print(f" loss fell: {fell}")
    return 0 if ok and fell else 1


if __name__ == "__main__":
    raise SystemExit(main())
