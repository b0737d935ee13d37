"""The ring transports agree: a gloo group of 4 CPU processes runs the ring
GEMMs, the ring linears, the ABFT rings, a transformer block and a MoE
layer through `DistRing`, and every process holds its results BITWISE
against the same calls over `LocalRing(4)` in that process.  One spawn for
the file (each process on one thread, so that both transports run the same
CPU kernels)."""
import json
import os
import socket
import subprocess
import sys
from pathlib import Path

import pytest

torch = pytest.importorskip("torch")

ROOT = Path(__file__).resolve().parents[1]
WORLD = 4

_WORKER = r'''
import json, sys
import numpy as np
import torch
import torch.distributed as dist
import torch.multiprocessing as mp


def cases():
    from repro_torch.core import ops
    from repro_torch.kernels import abft as A
    from repro_torch.kernels import mx_collective_matmul as cm
    from repro_torch.kernels.mx_matmul import Epilogue
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.models.moe import MoE
    from repro_torch.models.transformer import TransformerBlock
    from repro_torch.parallel.ring import DistRing, LocalRing
    from repro_torch.parallel.sharding import collective_policy

    P = 4
    rng = np.random.default_rng(0)
    t = lambda *s, sc=1.0: torch.from_numpy((rng.normal(size=s) * sc).astype(np.float32))
    M, K, N = 32, 24, 40
    x, w, wg, b, res = t(M, K), t(K, N, sc=0.1), t(K, N, sc=0.1), t(N), t(M, N)
    dring = DistRing()
    out = {}

    def shards_ag(ranks):
        m, n = M // P, N // P
        c = [slice(r * n, (r + 1) * n) for r in ranks]
        return ([x[r * m:(r + 1) * m] for r in ranks], [w[:, s].contiguous() for s in c],
                dict(bias=[b[s] for s in c], residual=[res[:, s].contiguous() for s in c]),
                [wg[:, s].contiguous() for s in c])

    def shards_rs(ranks):
        k, m = K // P, M // P
        return ([x[:, r * k:(r + 1) * k].contiguous() for r in ranks],
                [w[r * k:(r + 1) * k] for r in ranks],
                dict(bias=[b] * len(ranks), residual=[res[r * m:(r + 1) * m] for r in ranks]))

    def both(name, fn):
        """fn(ring) -> a tensor (or a tuple of them) on the global layout."""
        got, ref = fn(dring), fn(LocalRing(P))
        got = got if isinstance(got, tuple) else (got,)
        ref = ref if isinstance(ref, tuple) else (ref,)
        out[name] = all(torch.equal(g, r) for g, r in zip(got, ref))

    ep = Epilogue(activation="gelu", bias=True, residual=True)
    for backend in ("torch", "cuda_mx"):
        cc = cm.ChunkCompute(backend)
        for d in ("fwd", "bwd", "bidir"):
            def ag(ring, d=d):
                xs, ws, kw, _ = shards_ag(ring.ranks)
                return ring.gather(cm.ring_allgather_matmul(ring, xs, ws, compute=cc,
                                                            epilogue=ep, direction=d, **kw), 1)
            both(f"allgather-{d}-{backend}", ag)

            def rs(ring, d=d):
                xs, ws, kw = shards_rs(ring.ranks)
                return ring.gather(cm.ring_matmul_reduce_scatter(
                    ring, xs, ws, compute=cc, epilogue=Epilogue(bias=True, residual=True),
                    direction=d, **kw), 0)
            both(f"reduce_scatter-{d}-{backend}", rs)

        def swiglu(ring):
            xs, ws, _, gs = shards_ag(ring.ranks)
            return ring.gather(cm.ring_allgather_matmul(
                ring, xs, ws, b_gate=gs, compute=cc, epilogue=Epilogue(activation="swiglu")), 1)
        both(f"swiglu-{backend}", swiglu)

        def relu(ring):
            xs, ws, kw = shards_rs(ring.ranks)
            return ring.gather(cm.ring_matmul_reduce_scatter(
                ring, xs, ws, bias=kw["bias"], compute=cc,
                epilogue=Epilogue(activation="relu", bias=True)), 0)
        both(f"reduce_scatter-relu-{backend}", relu)

        def serialized(ring):
            xs, ws, kw, _ = shards_ag(ring.ranks)
            ag = ring.gather(cm.serialized_allgather_matmul(ring, xs, ws, compute=cc,
                                                            epilogue=ep, **kw), 1)
            xs, ws, kw = shards_rs(ring.ranks)
            rs = ring.gather(cm.serialized_matmul_psum(
                ring, xs, ws, compute=cc, epilogue=Epilogue(bias=True, residual=True),
                **kw), 0)
            return ag, rs
        both(f"serialized-{backend}", serialized)

        for mode, fault in (("allgather", (2, 1, 2, 5.0)), ("reduce_scatter", (1, 1, 2, 5.0))):
            def faulted(ring, mode=mode, fault=fault):
                cca = cm.ChunkCompute(backend, abft=True)
                if mode == "allgather":
                    xs, ws, kw, _ = shards_ag(ring.ranks)
                    o, nf = cm.ring_allgather_matmul(ring, xs, ws, compute=cca, epilogue=ep,
                                                     direction="bidir", fault=fault, **kw)
                    return ring.gather(o, 1), nf
                xs, ws, kw = shards_rs(ring.ranks)
                o, nf = cm.ring_matmul_reduce_scatter(
                    ring, xs, ws, compute=cca, epilogue=Epilogue(bias=True, residual=True),
                    direction="fwd", fault=fault, **kw)
                return ring.gather(o, 0), nf
            both(f"abft-{mode}-{backend}", faulted)
            out[f"abft-{mode}-{backend}-flags"] = int(faulted(dring)[1]) == 1

        def linears(ring):
            mesh = make_mesh((1, P), ("data", "model"), rings={"model": ring})
            with ops.use_policy(ops.MXPolicy(backend)), collective_policy(mesh):
                got = (ops.linear(x, w, b, activation="gelu", residual=res, tp_mode="allgather"),
                       ops.linear(x, w, b, residual=res, tp_mode="reduce_scatter"),
                       ops.linear(x, w, b, tp_mode="allgather", precision="int8"),
                       ops.linear(x, w, b, tp_mode="reduce_scatter", precision="int8"),
                       ops.linear(x.reshape(4, 8, K), w, b, tp_mode="allgather"),
                       ops.linear(x[:7], w, b, tp_mode="allgather"))  # the fallback
                if backend == "cuda_mx":
                    cfg = A.AbftConfig(fault=A.TileFault(1, 0, 1, 2, 5.0))
                    got += (ops.linear(x, w, b, tp_mode="allgather", abft=cfg),
                            ops.linear(x, w, b, tp_mode="reduce_scatter", abft=cfg))
            return got
        both(f"linear-{backend}", linears)

    blk = TransformerBlock(d_model=32, n_heads=4, n_kv_heads=4, d_ff=64)
    bp = blk.init(0, device="cpu")
    xb = t(2, 8, 32)
    moe = MoE(d_model=32, d_ff=64, n_experts=4, top_k=2, n_groups=1)
    mpar = moe.init(1, device="cpu")

    def model(ring):
        mesh = make_mesh((1, P), ("data", "model"), rings={"model": ring})
        with collective_policy(mesh):
            return blk(bp, xb)[0], *moe(mpar, xb)
    cm.reset_ring_stats()
    both("block-and-moe", model)
    s = cm.ring_stats()
    out["block-and-moe-rang"] = s["allgather"] > 0 and s["reduce_scatter"] > 0
    # a multi-rank group without a collective policy: tp_mode is inert, as in JAX
    out["inert-under-a-group-without-policy"] = torch.equal(
        ops.linear(x, w, b, tp_mode="allgather"), ops.linear(x, w, b))
    return out


def worker(rank, port, path):
    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"tcp://127.0.0.1:{port}", rank=rank,
                            world_size=4)
    try:
        res = cases()
    finally:
        dist.destroy_process_group()
    with open(f"{path}.{rank}", "w") as f:
        json.dump(res, f)


if __name__ == "__main__":
    mp.spawn(worker, args=(int(sys.argv[1]), sys.argv[2]), nprocs=4)
'''


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


@pytest.fixture(scope="module")
def results(tmp_path_factory):
    d = tmp_path_factory.mktemp("ring_dist")
    script = d / "worker.py"
    script.write_text(_WORKER)
    path = d / "result"
    r = subprocess.run([sys.executable, str(script), str(_free_port()), str(path)],
                       capture_output=True, text=True, timeout=240, cwd=ROOT,
                       env={**os.environ, "PYTHONPATH": str(ROOT / "src")})
    assert r.returncode == 0, r.stderr[-4000:]
    return [json.loads(Path(f"{path}.{k}").read_text()) for k in range(WORLD)]


BACKENDS = ("torch", "cuda_mx")
CASES = sorted(
    [f"{kind}-{d}-{b}" for b in BACKENDS for kind in ("allgather", "reduce_scatter")
     for d in ("fwd", "bwd", "bidir")]
    + [f"{k}-{b}" for b in BACKENDS for k in ("swiglu", "reduce_scatter-relu", "serialized",
                                              "abft-allgather", "abft-reduce_scatter",
                                              "linear")]
    + [f"abft-{m}-{b}-flags" for b in BACKENDS for m in ("allgather", "reduce_scatter")]
    + ["block-and-moe", "block-and-moe-rang", "inert-under-a-group-without-policy"])


@pytest.mark.parametrize("case", CASES)
def test_dist_ring_is_bitwise_the_local_ring(results, case):
    for rank, res in enumerate(results):
        assert res[case] is True, (rank, case)


def test_every_case_ran(results):
    assert all(sorted(r) == sorted(results[0]) for r in results)
    assert set(CASES) <= set(results[0])
