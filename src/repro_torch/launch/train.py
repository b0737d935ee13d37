"""End-to-end training launcher (port of `repro/launch/train.py`).

A real training loop on one device: the seeded synthetic data pipeline,
AdamW with a warmup-cosine schedule, async checkpointing, the
fault-tolerant restart loop, straggler detection, a metrics CSV, and resume
from the latest checkpoint in --ckpt-dir.  The step differentiates the
plain PyTorch path (`launch/steps.make_train_step`, `MXPolicy("torch")`)
and updates in place, as JAX's donated buffers; TF32 stays off.  Runs on
the card unless `--device cpu` is given.

Examples:
  PYTHONPATH=src python -m repro_torch.launch.train --arch llama3.2-1b --smoke \\
      --steps 50 --batch 8 --seq 64 --ckpt-dir /tmp/ckpt
  PYTHONPATH=src python -m repro_torch.launch.train --arch qwen2-0.5b --smoke \\
      --steps 20 --inject-failure 7 --device cpu
"""
from __future__ import annotations

import argparse
import csv
import os
import sys
import tempfile
import time

import torch

from ..checkpoint.manager import CheckpointManager
from ..configs import ARCH_IDS, get_config
from ..core.device import resolve_device
from ..data.pipeline import SyntheticLM
from ..launch.mesh import make_mesh
from ..launch.steps import make_train_step
from ..models import build_model
from ..optim.adamw import AdamW
from ..optim.schedules import warmup_cosine
from ..parallel.sharding import make_rules, use_rules
from ..runtime.fault import FaultInjector, TrainLoop


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", choices=ARCH_IDS, default="llama3.2-1b")
    ap.add_argument("--smoke", action="store_true",
                    help="use the reduced config (CPU-sized)")
    ap.add_argument("--steps", type=int, default=50)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=64)
    ap.add_argument("--lr", type=float, default=1e-3)
    ap.add_argument("--ckpt-dir", default=os.path.join(tempfile.gettempdir(), "repro_ckpt"))
    ap.add_argument("--ckpt-every", type=int, default=20)
    ap.add_argument("--inject-failure", type=int, default=None,
                    help="simulate a node failure at this step (tests recovery)")
    ap.add_argument("--mesh", default=None,
                    help="mesh shape, e.g. 2x2 (defaults to 1x<ndevices>); a process "
                         "holds whole tensors, so the shape sets the axis rules only")
    ap.add_argument("--metrics-csv", default=None)
    ap.add_argument("--param-dtype", default="float32")
    ap.add_argument("--device", default="cuda",
                    help="cuda (default; raises without a GPU) or cpu")
    args = ap.parse_args(argv)

    device = resolve_device(args.device)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cfg = get_config(args.arch + ("-smoke" if args.smoke else ""))
    shape = tuple(int(x) for x in args.mesh.split("x")) if args.mesh else (1, 1)
    mesh = make_mesh(shape, ("data", "model"))
    rules = make_rules(mesh, profile=cfg.parallelism, fsdp=cfg.fsdp)
    dtype = getattr(torch, args.param_dtype)

    model = build_model(cfg)
    opt = AdamW(lr=warmup_cosine(args.lr, max(args.steps // 10, 1), args.steps))
    print(f"arch={cfg.name} params≈{cfg.n_params()/1e6:.1f}M mesh={dict(mesh.shape)}")

    with use_rules(rules):
        params = model.init(0, device=device, dtype=dtype)
        opt_state = opt.init(params)
        step_fn = make_train_step(model, cfg, opt, inplace=True)

        data = SyntheticLM(cfg, seq_len=args.seq, global_batch=args.batch)
        ckpt = CheckpointManager(args.ckpt_dir)
        injector = FaultInjector(
            fail_at_steps=(args.inject_failure,) if args.inject_failure else ())
        rows = []

        def on_metrics(step, metrics):
            m = {k: float(v) for k, v in metrics.items()}
            rows.append({"step": step, **m})
            if step % 5 == 0 or step == args.steps - 1:
                print(f"step {step:5d} loss {m.get('loss', float('nan')):.4f} "
                      f"gnorm {m.get('grad_norm', float('nan')):.3f}", flush=True)

        loop = TrainLoop(train_step=step_fn, ckpt=ckpt, checkpoint_every=args.ckpt_every,
                         fault_injector=injector, on_metrics=on_metrics)
        start = ckpt.latest_step() or 0
        if start:
            print(f"resuming from checkpoint step {start}")
            state = ckpt.restore({"params": params, "opt": opt_state, "step": 0})
            params, opt_state = state["params"], state["opt"]
        t0 = time.time()
        params, opt_state, hist = loop.run(params, opt_state, data, total_steps=args.steps,
                                           start_step=start)
        if device.type == "cuda":
            torch.cuda.synchronize(device)
        wall = time.time() - t0

    print(f"done: {hist['steps_run']} steps in {wall:.1f}s "
          f"({hist['restarts']} restarts, stragglers at {hist['stragglers']})")
    if rows:
        first, last = rows[0], rows[-1]
        print(f"loss {first['loss']:.4f} -> {last['loss']:.4f}")
    if args.metrics_csv and rows:
        with open(args.metrics_csv, "w", newline="") as f:
            w = csv.DictWriter(f, fieldnames=list(rows[0]))
            w.writeheader()
            w.writerows(rows)
    return 0


if __name__ == "__main__":
    sys.exit(main())
