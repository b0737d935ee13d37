"""Gradient compression in the port: the int8 wire format and error
feedback bitwise JAX's, the properties test_compression.py checks, the
stochastic quantizer (unbiased, pure in its generator's seed), and
`compressed_grad_sync` against JAX's on 1 and on 4 host devices (a JAX
subprocess: XLA_FLAGS must precede JAX's initialisation) and over a gloo
`DistRing` of 4 CPU processes bitwise `LocalRing(4)`."""
import json
import os
import socket
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
from hypothesis import given, settings, strategies as st

torch = pytest.importorskip("torch")

from repro.kernels.quant import quantize_int8_tensor as jquantize  # noqa: E402
from repro.optim import compression as jcomp  # noqa: E402
from repro_torch.kernels.quant import quantize_int8_stochastic  # noqa: E402
from repro_torch.launch.mesh import make_mesh  # noqa: E402
from repro_torch.optim.compression import (compress_with_feedback,  # noqa: E402
                                           compressed_grad_sync, dequantize,
                                           init_error_state, quantize)

ROOT = Path(__file__).resolve().parents[1]


def _x(seed, n=128, scale=1.0):
    return (np.random.default_rng(seed).normal(size=(n,)) * scale).astype(np.float32)


@settings(max_examples=25, deadline=None)
@given(scale=st.floats(1e-3, 1e3), seed=st.integers(0, 1000))
def test_quantize_bounded_error_and_bitwise_jax(scale, seed):
    x = _x(seed, scale=scale)
    q, s = quantize(torch.from_numpy(x))
    jq, js = jquantize(jnp.asarray(x))
    assert q.dtype == torch.int8 and s.dtype == torch.float32 and s.dim() == 0
    assert q.numpy().tobytes() == np.asarray(jq).tobytes()
    assert s.numpy().tobytes() == np.asarray(js).tobytes()
    err = (dequantize(q, s) - torch.from_numpy(x)).abs()
    assert err.max().item() <= float(s) * 0.5 + 1e-6  # half-ULP rounding bound


def test_quantize_zero_tensor():
    q, s = quantize(torch.zeros(16))
    assert float(dequantize(q, s).abs().max()) == 0.0 and float(s) == 1.0


def test_compress_with_feedback_is_bitwise_jax():
    g = _x(1, 256, 3.0)
    err_t, err_j = torch.zeros(256), jnp.zeros((256,))
    for i in range(5):
        q, s, err_t = compress_with_feedback(torch.from_numpy(g * (i + 1)), err_t)
        jq, js, err_j = jcomp.compress_with_feedback(jnp.asarray(g * (i + 1)), err_j)
        assert q.numpy().tobytes() == np.asarray(jq).tobytes()
        assert s.numpy().tobytes() == np.asarray(js).tobytes()
        assert err_t.numpy().tobytes() == np.asarray(err_j).tobytes()


def test_error_feedback_makes_updates_unbiased():
    g_true = torch.from_numpy(_x(0, 256))
    err, total_sent, n = torch.zeros(256), torch.zeros(256), 50
    for _ in range(n):
        q, s, err = compress_with_feedback(g_true, err)
        total_sent = total_sent + dequantize(q, s)
    np.testing.assert_allclose((total_sent / n).numpy(), g_true.numpy(), atol=2e-2)
    assert float(err.abs().max()) < float(g_true.abs().max())


def test_without_feedback_bias_persists():
    g_true = torch.from_numpy(_x(0, 256, 1000.0))
    q, s = quantize(g_true)
    bias = (dequantize(q, s) - g_true).abs().mean().item()
    err, total = torch.zeros(256), torch.zeros(256)
    for _ in range(20):
        q2, s2, err = compress_with_feedback(g_true, err)
        total = total + dequantize(q2, s2)
    assert (total / 20 - g_true).abs().mean().item() < bias


def test_stochastic_quantizer_is_unbiased_and_pure_in_its_seed():
    # every element's x / scale has fractional part 0.3: round-to-nearest
    # is 0.3 of a step off for each, stochastic rounding is not
    base = torch.tensor([127.0, -127.0] + [float(k) + 0.3 for k in range(-60, 60)])
    scale = 1.0 / 3
    x = (base * scale).expand(4000, -1).contiguous()
    gen = torch.Generator().manual_seed(7)
    q, s = quantize_int8_stochastic(x, gen)
    assert q.dtype == torch.int8 and abs(float(s) - scale) < 1e-6
    mean = dequantize(q, s).mean(dim=0)
    sigma = 0.5 * scale / np.sqrt(x.shape[0])
    assert (mean - x[0]).abs().max().item() < 6 * sigma
    rtn = dequantize(*quantize(x[0]))
    assert (rtn - x[0])[2:].abs().min().item() > 0.25 * scale
    again, _ = quantize_int8_stochastic(x, torch.Generator().manual_seed(7))
    other, _ = quantize_int8_stochastic(x, torch.Generator().manual_seed(8))
    assert torch.equal(q, again) and not torch.equal(q, other)
    rows, _ = quantize_int8_stochastic(x[:3], torch.Generator().manual_seed(1), axis=1)
    assert rows.shape == (3, x.shape[1])


def _grads():
    return {"w": np.ones((8, 8), np.float32) * 0.5,
            "b": np.arange(4, dtype=np.float32), "z": _x(3, 64, 0.01)}


def test_compressed_sync_one_device_matches_jax():
    from jax.sharding import Mesh

    g = _grads()
    tg = {k: torch.from_numpy(v) for k, v in g.items()}
    synced, new_err = compressed_grad_sync(tg, init_error_state(tg),
                                           make_mesh((1,), ("pod",)), axis="pod")
    jg = jax.tree.map(jnp.asarray, g)
    mesh = Mesh(np.array(jax.devices()[:1]).reshape(1), ("pod",))
    jsynced, jerr = jcomp.compressed_grad_sync(jg, jcomp.init_error_state(jg), mesh, "pod")
    np.testing.assert_allclose(synced["w"].numpy(), g["w"], atol=1e-2)
    np.testing.assert_allclose(synced["b"].numpy(), g["b"], atol=1e-1)
    for k in g:
        assert synced[k].numpy().tobytes() == np.asarray(jsynced[k]).tobytes()
        assert new_err[k].numpy().tobytes() == np.asarray(jerr[k]).tobytes()


_JAX_SYNC = r"""
import os, sys
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
import jax, jax.numpy as jnp, numpy as np
from jax.sharding import Mesh
from repro.optim.compression import compressed_grad_sync, init_error_state
rng = np.random.default_rng(0)
g = {"w": (rng.normal(size=(16, 8)) * 0.3).astype(np.float32),
     "b": rng.normal(size=(8,)).astype(np.float32)}
e = {"w": (rng.normal(size=(16, 8)) * 1e-3).astype(np.float32),
     "b": np.zeros(8, np.float32)}
mesh = Mesh(np.array(jax.devices()[:4]).reshape(4), ("pod",))
s, ne = compressed_grad_sync(jax.tree.map(jnp.asarray, g), jax.tree.map(jnp.asarray, e),
                             mesh, axis="pod")
np.savez(sys.argv[1], **{f"g_{k}": v for k, v in g.items()},
         **{f"e_{k}": v for k, v in e.items()},
         **{f"s_{k}": np.asarray(v) for k, v in s.items()},
         **{f"ne_{k}": np.asarray(v) for k, v in ne.items()})
"""


def test_compressed_sync_on_four_devices_matches_jax(tmp_path):
    path = tmp_path / "sync.npz"
    r = subprocess.run([sys.executable, "-c", _JAX_SYNC, str(path)], capture_output=True,
                       text=True, timeout=300, cwd=ROOT,
                       env={**os.environ, "PYTHONPATH": "src", "JAX_PLATFORMS": "cpu"})
    assert r.returncode == 0, r.stderr[-3000:]
    z = np.load(path)
    g = {k: torch.from_numpy(z[f"g_{k}"]) for k in ("w", "b")}
    e = {k: torch.from_numpy(z[f"e_{k}"]) for k in ("w", "b")}
    mesh = make_mesh((4,), ("pod",))
    synced, new_err = compressed_grad_sync(g, e, mesh, axis="pod")
    for k in ("w", "b"):
        np.testing.assert_allclose(synced[k].numpy(), z[f"s_{k}"], rtol=1e-6,
                                   atol=1e-6 * np.abs(z[f"s_{k}"]).max())
        assert new_err[k].numpy().tobytes() == z[f"ne_{k}"].tobytes()
    assert mesh.ring("pod").bytes_moved == 0  # a LocalRing's psum moves nothing


_WORKER = r'''
import json, sys
import torch
import torch.distributed as dist
import torch.multiprocessing as mp


def worker(rank, port, path):
    import numpy as np
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.optim.compression import (compress_with_feedback, compressed_grad_sync,
                                               dequantize)
    from repro_torch.parallel.ring import DistRing

    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"tcp://127.0.0.1:{port}", rank=rank,
                            world_size=4)

    def grads(seed):
        rng = np.random.default_rng(seed)
        return {"w": torch.from_numpy((rng.normal(size=(16, 8)) * 0.3).astype(np.float32)),
                "b": torch.from_numpy(rng.normal(size=(8,)).astype(np.float32))}

    zero = {k: torch.zeros_like(v) for k, v in grads(0).items()}
    dmesh = make_mesh((4,), ("pod",), rings={"pod": DistRing()})
    # replicated gradients: bitwise the LocalRing(4) sync in one process
    got, gerr = compressed_grad_sync(grads(0), zero, dmesh, axis="pod")
    local, lerr = compressed_grad_sync(grads(0), zero, make_mesh((4,), ("pod",)), axis="pod")
    same = all(torch.equal(got[k], local[k]) and torch.equal(gerr[k], lerr[k]) for k in got)
    # each rank its own gradients: the ranks' dequantized payloads summed in
    # rank order, over 4
    mine, _ = compressed_grad_sync(grads(10 + rank), zero, dmesh, axis="pod")
    want = {}
    for k in zero:
        parts = []
        for r in range(4):
            q, s, _ = compress_with_feedback(grads(10 + r)[k], zero[k])
            parts.append(dequantize(q, s))
        total = parts[0]
        for p in parts[1:]:
            total = total + p
        want[k] = total / 4.0
    own = all(torch.equal(mine[k], want[k]) for k in zero)
    dist.destroy_process_group()
    with open(f"{path}.{rank}", "w") as f:
        json.dump(dict(bitwise_local=same, per_rank=own), f)


if __name__ == "__main__":
    mp.spawn(worker, args=(int(sys.argv[1]), sys.argv[2]), nprocs=4)
'''


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def test_compressed_sync_over_dist_ring_is_bitwise_the_local_ring(tmp_path):
    script = tmp_path / "worker.py"
    script.write_text(_WORKER)
    path = tmp_path / "result"
    r = subprocess.run([sys.executable, str(script), str(_free_port()), str(path)],
                       capture_output=True, text=True, timeout=180, cwd=ROOT,
                       env={**os.environ, "PYTHONPATH": str(ROOT / "src")})
    assert r.returncode == 0, r.stderr[-4000:]
    for rank in range(4):
        res = json.loads(Path(f"{path}.{rank}").read_text())
        assert res == {"bitwise_local": True, "per_rank": True}, (rank, res)
