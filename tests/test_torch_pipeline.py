"""GPipe forward of the port: `gpipe_apply` over 4 stages against the stages
run in sequence, over `LocalRing(4)` in this process and over `DistRing`
in a gloo group of 4 CPU processes (one spawn for the file), and the
bubble fraction."""
import json
import os
import socket
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.launch.mesh import make_mesh  # noqa: E402
from repro_torch.parallel.pipeline import bubble_fraction, gpipe_apply  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
S, D = 4, 16


def _setup(M=8, mb=2, seed=0):
    rng = np.random.default_rng(seed)
    params = {"w": torch.from_numpy((rng.normal(size=(S, D, D)) / np.sqrt(D)).astype(np.float32)),
              "b": torch.from_numpy((rng.normal(size=(S, D)) * 0.1).astype(np.float32))}
    x = torch.from_numpy(rng.normal(size=(M, mb, D)).astype(np.float32))
    return params, x


def _stage(p, h):
    return torch.tanh(h @ p["w"] + p["b"])


def _sequential(params, x):
    for s in range(S):
        x = _stage({k: v[s] for k, v in params.items()}, x)
    return x


@pytest.mark.parametrize("M", [1, 4, 8])
def test_gpipe_local_ring_matches_sequential(M):
    params, x = _setup(M)
    out = gpipe_apply(_stage, params, x, mesh=make_mesh((S,), ("pod",)))
    np.testing.assert_allclose(out.numpy(), _sequential(params, x).numpy(), rtol=2e-5,
                               atol=2e-5)


_WORKER = r'''
import json, sys
import torch
import torch.distributed as dist
import torch.multiprocessing as mp


def worker(rank, port, path):
    import numpy as np
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.parallel.pipeline import gpipe_apply
    from repro_torch.parallel.ring import DistRing

    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"tcp://127.0.0.1:{port}", rank=rank,
                            world_size=4)
    rng = np.random.default_rng(0)
    S, D, M, mb = 4, 16, 8, 2
    params = {"w": torch.from_numpy((rng.normal(size=(S, D, D)) / np.sqrt(D)).astype(np.float32)),
              "b": torch.from_numpy((rng.normal(size=(S, D)) * 0.1).astype(np.float32))}
    x = torch.from_numpy(rng.normal(size=(M, mb, D)).astype(np.float32))
    stage = lambda p, h: torch.tanh(h @ p["w"] + p["b"])
    got = gpipe_apply(stage, params, x, mesh=make_mesh((S,), ("pod",),
                                                      rings={"pod": DistRing()}))
    local = gpipe_apply(stage, params, x, mesh=make_mesh((S,), ("pod",)))
    ref = x
    for s in range(S):
        ref = stage({k: v[s] for k, v in params.items()}, ref)
    dist.destroy_process_group()
    with open(f"{path}.{rank}", "w") as f:
        json.dump(dict(bitwise_local=torch.equal(got, local),
                       max_err=(got - ref).abs().max().item()), f)


if __name__ == "__main__":
    mp.spawn(worker, args=(int(sys.argv[1]), sys.argv[2]), nprocs=4)
'''


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def test_gpipe_dist_ring_matches_sequential_and_the_local_ring(tmp_path):
    script = tmp_path / "worker.py"
    script.write_text(_WORKER)
    path = tmp_path / "result"
    r = subprocess.run([sys.executable, str(script), str(_free_port()), str(path)],
                       capture_output=True, text=True, timeout=180, cwd=ROOT,
                       env={**os.environ, "PYTHONPATH": str(ROOT / "src")})
    assert r.returncode == 0, r.stderr[-4000:]
    for rank in range(4):
        res = json.loads(Path(f"{path}.{rank}").read_text())
        assert res["bitwise_local"], rank  # every stage holds the last stage's output
        assert res["max_err"] <= 2e-5, (rank, res)


def test_gpipe_stages_of_a_transformer_layer():
    """Stages that are whole layers (a dict of weights each): 4 llama-style
    blocks at smoke width against the blocks in sequence."""
    from repro_torch.models.transformer import TransformerBlock

    blk = TransformerBlock(d_model=32, n_heads=4, n_kv_heads=2, d_ff=64)
    layers = [blk.init(s, device="cpu") for s in range(S)]
    stacked = {k: torch.stack([lp[k] for lp in layers]) if not isinstance(layers[0][k], dict)
               else {kk: torch.stack([lp[k][kk] for lp in layers]) for kk in layers[0][k]}
               for k in layers[0]}
    x = torch.from_numpy(np.random.default_rng(1).normal(size=(4, 1, 8, 32)).astype(np.float32))
    out = gpipe_apply(lambda p, h: blk(p, h)[0], stacked, x, mesh=make_mesh((S,), ("pod",)))
    ref = x
    for lp in layers:
        ref = torch.stack([blk(lp, r)[0] for r in ref])
    np.testing.assert_allclose(out.numpy(), ref.numpy(), rtol=1e-5, atol=1e-5)


def test_bubble_fraction():
    assert bubble_fraction(1, 4) == 0.75  # worst case: one microbatch
    assert bubble_fraction(8, 4) == 3 / 11
    assert bubble_fraction(128, 2) < 0.01  # many microbatches amortize
