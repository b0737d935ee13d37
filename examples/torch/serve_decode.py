"""Batched serving example for the PyTorch + CUDA port: prefill + greedy
decode for three architecture families through one code path (dense GQA,
hybrid SSM, xLSTM), at smoke size.

  PYTHONPATH=src python examples/torch/serve_decode.py                 # on the card
  PYTHONPATH=src python examples/torch/serve_decode.py --device cpu    # on the host
"""
import argparse

from repro_torch.launch.serve import main as serve_main

ARCHS = ["llama3.2-1b", "zamba2-2.7b", "xlstm-125m"]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args = ap.parse_args(argv)
    for arch in ARCHS:
        print(f"\n===== {arch} (smoke config) =====")
        rc = serve_main(["--arch", arch, "--smoke", "--batch", "2", "--prompt-len", "8",
                         "--gen", "8", "--device", args.device])
        if rc:
            return rc
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
