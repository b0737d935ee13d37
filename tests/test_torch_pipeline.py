"""GPipe in the port: `gpipe_apply` over 4 stages against the stages run in
sequence, over `LocalRing(4)` in this process and over `DistRing` in a
gloo group of 4 CPU processes (one spawn for the file), and the bubble
fraction.  Its gradient (autograd through the ring's hops and psum)
against the sequential stages' and against `jax.grad` of JAX's
`gpipe_apply` on a 4-device host mesh (a JAX subprocess), within 1e-5;
over `DistRing` bitwise `LocalRing(4)`'s."""
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


def _loss_grads(out, ct, params, x):
    return torch.autograd.grad((out * ct).sum(), [params["w"], params["b"], x])


def _grad_inputs(M, seed=0):
    params, x = _setup(M, seed=seed)
    params = {k: v.requires_grad_() for k, v in params.items()}
    ct = torch.from_numpy(np.random.default_rng(seed + 100).normal(
        size=tuple(x.shape)).astype(np.float32))
    return params, x.requires_grad_(), ct


@pytest.mark.parametrize("M", [1, 4, 8])
def test_gpipe_gradient_matches_sequential(M):
    params, x, ct = _grad_inputs(M)
    got = _loss_grads(gpipe_apply(_stage, params, x, mesh=make_mesh((S,), ("pod",))), ct,
                      params, x)
    want = _loss_grads(_sequential(params, x), ct, params, x)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), w.numpy(), rtol=1e-5, atol=1e-5)


def test_gpipe_without_grad_builds_no_graph():
    params, x, _ = _grad_inputs(4)
    with torch.no_grad():
        out = gpipe_apply(_stage, params, x, mesh=make_mesh((S,), ("pod",)))
    assert out.grad_fn is None and not out.requires_grad
    plain, x0 = _setup(4)
    assert torch.equal(out, gpipe_apply(_stage, plain, x0, mesh=make_mesh((S,), ("pod",))))


_JAX_GRAD = r"""
import os, sys
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
import jax, jax.numpy as jnp, numpy as np
from repro.launch.mesh import make_mesh
from repro.parallel.pipeline import gpipe_apply
S, D, M, mb = 4, 16, 8, 2
rng = np.random.default_rng(0)
w = (rng.normal(size=(S, D, D)) / np.sqrt(D)).astype(np.float32)
b = (rng.normal(size=(S, D)) * 0.1).astype(np.float32)
x = rng.normal(size=(M, mb, D)).astype(np.float32)
ct = np.random.default_rng(100).normal(size=(M, mb, D)).astype(np.float32)
mesh = make_mesh((S,), ("pod",))
stage = lambda p, h: jnp.tanh(h @ p["w"] + p["b"])
def loss(params, x):
    return jnp.sum(gpipe_apply(stage, params, x, mesh=mesh, axis="pod") * ct)
(gp, gx) = jax.grad(loss, argnums=(0, 1))({"w": jnp.asarray(w), "b": jnp.asarray(b)},
                                          jnp.asarray(x))
np.savez(sys.argv[1], w=np.asarray(gp["w"]), b=np.asarray(gp["b"]), x=np.asarray(gx))
"""


def test_gpipe_gradient_matches_jax_grad(tmp_path):
    path = tmp_path / "grads.npz"
    r = subprocess.run([sys.executable, "-c", _JAX_GRAD, str(path)], capture_output=True,
                       text=True, timeout=300, cwd=ROOT,
                       env={**os.environ, "PYTHONPATH": "src", "JAX_PLATFORMS": "cpu"})
    assert r.returncode == 0, r.stderr[-3000:]
    want = np.load(path)
    params, x, ct = _grad_inputs(8)
    got = _loss_grads(gpipe_apply(_stage, params, x, mesh=make_mesh((S,), ("pod",))), ct,
                      params, x)
    for g, k in zip(got, ("w", "b", "x")):
        np.testing.assert_allclose(g.numpy(), want[k], rtol=1e-5, atol=1e-5)


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
    # the gradient: every rank runs the backward (each process holds its
    # copy of the output; rank 0's carries the loss), then the ranks'
    # gradients summed in rank order against the LocalRing's
    ct = torch.from_numpy(np.random.default_rng(100).normal(size=(M, mb, D)).astype(np.float32))
    pg = {k: v.clone().requires_grad_() for k, v in params.items()}
    xg = x.clone().requires_grad_()
    out = gpipe_apply(stage, pg, xg, mesh=make_mesh((S,), ("pod",), rings={"pod": DistRing()}))
    mine = torch.autograd.grad((out * (ct if rank == 0 else torch.zeros_like(ct))).sum(),
                               [pg["w"], pg["b"], xg], allow_unused=True)
    mine = [torch.zeros_like(t) if g is None else g for g, t in zip(mine, (pg["w"], pg["b"], xg))]
    summed = []
    for g in mine:
        parts = [torch.empty_like(g) for _ in range(S)]
        dist.all_gather(parts, g)
        total = parts[0]
        for p in parts[1:]:
            total = total + p
        summed.append(total)
    pl = {k: v.clone().requires_grad_() for k, v in params.items()}
    xl = x.clone().requires_grad_()
    outl = gpipe_apply(stage, pl, xl, mesh=make_mesh((S,), ("pod",)))
    want = torch.autograd.grad((outl * ct).sum(), [pl["w"], pl["b"], xl])
    dist.destroy_process_group()
    with open(f"{path}.{rank}", "w") as f:
        json.dump(dict(bitwise_local=torch.equal(got, local),
                       max_err=(got - ref).abs().max().item(),
                       grad_bitwise_local=all(torch.equal(a, b) for a, b in zip(summed, want)),
                       grad_max_err=max((a - b).abs().max().item()
                                        for a, b in zip(summed, want))), f)


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
        assert res["grad_bitwise_local"], (rank, res)


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
