"""End-to-end training example for the PyTorch + CUDA port: xlstm-125m
through the full substrate (synthetic data, AdamW + cosine, checkpoints,
the fault-tolerant loop), as the launcher runs it.

  PYTHONPATH=src python examples/torch/train_lm.py [--steps 300] [--device cpu]

The default is the smoke config (reduced depth and width, so a few hundred
steps finish in minutes); --full-depth trains the real 12-layer config.
"""
import argparse
import os
import tempfile

from repro_torch.launch.train import main as train_main


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--steps", type=int, default=300)
    ap.add_argument("--full-depth", action="store_true")
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--ckpt-dir", default=os.path.join(tempfile.gettempdir(), "repro_train_lm"))
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args = ap.parse_args(argv)
    train_argv = [
        "--arch", "xlstm-125m",
        "--steps", str(args.steps),
        "--batch", str(args.batch), "--seq", str(args.seq),
        "--lr", "3e-4",
        "--ckpt-dir", args.ckpt_dir,
        "--ckpt-every", "50",
        "--metrics-csv", os.path.join(tempfile.gettempdir(), "train_lm_metrics.csv"),
        "--device", args.device,
    ]
    if not args.full_depth:
        train_argv += ["--smoke"]
    return train_main(train_argv)


if __name__ == "__main__":
    raise SystemExit(main())
