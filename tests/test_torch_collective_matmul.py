"""The ring collective GEMMs of the port against JAX's own rings.

One JAX subprocess on an 8-device host mesh (XLA_FLAGS must precede JAX's
initialisation, so it cannot run in the suite's process) runs JAX's ring
bodies under `shard_map` and saves inputs and outputs; the port's rings run
the same inputs over `LocalRing(8)`, with the chunk GEMMs on the plain
reference ("torch") and on kernel 1's wrapper ("cuda_mx", its plain version
on CPU tensors).  Tolerance: rtol = atol = 1e-5 (f32); ABFT flag counts
exactly equal.  Also: the dispatch of `ops.linear(tp_mode=...)` (fallback
on a misfit, leading batch dims, bidir with odd chunk rows running "fwd"),
the serialized references, ABFT recovery, the weight shard cache and the
overlap model."""
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.core import ops  # noqa: E402
from repro_torch.core.transfer_model import GemmProblem, RingCollectiveGemm  # noqa: E402
from repro_torch.kernels import abft as A  # noqa: E402
from repro_torch.kernels import mx_collective_matmul as cm  # noqa: E402
from repro_torch.kernels.mx_matmul import Epilogue  # noqa: E402
from repro_torch.launch.mesh import make_mesh  # noqa: E402
from repro_torch.parallel.ring import LocalRing  # noqa: E402
from repro_torch.parallel.sharding import (CollectivePolicy, collective_policy,  # noqa: E402
                                           current_collectives, ring_topology)

ROOT = Path(__file__).resolve().parents[1]
TOL = dict(rtol=1e-5, atol=1e-5)
PZ = 8
DIRS = ("fwd", "bwd", "bidir")
BACKENDS = ("torch", "cuda_mx")
AG_FAULT = (3, 1, 2, 5.0)   # (step, row, col, delta) on rank 0's traveling x chunk
RS_FAULT = (2, 1, 2, 5.0)   # on a partial rank 0 receives

_JAX_CODE = r"""
import os, sys
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=8"
import jax, jax.numpy as jnp, numpy as np
from jax.sharding import PartitionSpec as P
from repro.core import ops
from repro.kernels.abft import make_abft_spec
from repro.kernels.mx_collective_matmul import (
    ChunkCompute, ring_allgather_matmul, ring_matmul_reduce_scatter)
from repro.kernels.mx_matmul import Epilogue
from repro.launch.mesh import make_mesh
from repro.parallel.sharding import collective_policy, shard_map

mesh = make_mesh((1, 8), ("data", "model"))
PZ, M, K, N = 8, 64, 32, 48
rng = np.random.default_rng(0)
f32 = np.float32
save = dict(x=rng.normal(size=(M, K)).astype(f32),
            w=(rng.normal(size=(K, N)) * 0.1).astype(f32),
            wg=(rng.normal(size=(K, N)) * 0.1).astype(f32),
            bias=rng.normal(size=(N,)).astype(f32),
            res=rng.normal(size=(M, N)).astype(f32))
x, w, wg, bias, res = (jnp.asarray(save[k]) for k in ("x", "w", "wg", "bias", "res"))
cc = ChunkCompute(backend="xla")

def sm(fn, in_specs, out_specs):
    return jax.jit(shard_map(fn, mesh=mesh, in_specs=in_specs, out_specs=out_specs,
                             check_vma=False))

AG = (P("model", None), P(None, "model"), P("model"), P(None, "model"))
RS = (P(None, "model"), P("model", None), P(None), P("model", None))
ep = Epilogue(activation="gelu", bias=True, residual=True)
for d in ("fwd", "bwd", "bidir"):
    save["ag_" + d] = sm(lambda xs, ws, bs, rs, d=d: ring_allgather_matmul(
        xs, ws, axis_name="model", axis_size=PZ, compute=cc, epilogue=ep, bias=bs,
        residual=rs, out_dtype=jnp.float32, direction=d), AG, P(None, "model"))(
        x, w, bias, res)
save["ag_swiglu"] = sm(lambda xs, ws, gs: ring_allgather_matmul(
    xs, ws, axis_name="model", axis_size=PZ, compute=cc,
    epilogue=Epilogue(activation="swiglu"), b_gate=gs, out_dtype=jnp.float32,
    direction="bidir"), (P("model", None), P(None, "model"), P(None, "model")),
    P(None, "model"))(x, w, wg)
ep2 = Epilogue(bias=True, residual=True)
for d in ("fwd", "bwd", "bidir"):
    save["rs_" + d] = sm(lambda xs, ws, bs, rs, d=d: ring_matmul_reduce_scatter(
        xs, ws, axis_name="model", axis_size=PZ, compute=cc, epilogue=ep2, bias=bs,
        residual=rs, out_dtype=jnp.float32, direction=d), RS, P("model", None))(
        x, w, bias, res)
save["rs_relu"] = sm(lambda xs, ws, bs: ring_matmul_reduce_scatter(
    xs, ws, axis_name="model", axis_size=PZ, compute=cc,
    epilogue=Epilogue(activation="relu", bias=True), bias=bs, out_dtype=jnp.float32,
    direction="bidir"), RS[:3], P("model", None))(x, w, bias)
with collective_policy(mesh, axis="model"):
    for prec in ("int8", "int8_all"):
        save["ag_" + prec] = ops.linear(x, w, bias, tp_mode="allgather", precision=prec,
                                        out_dtype=jnp.float32)
# ABFT: the reference chunk compute reports no tile flags, so the ring's
# count is its sidecars' (one RingFault per mode)
cca = ChunkCompute(backend="xla", abft=make_abft_spec(jnp.float32, jnp.float32, K, 8, 8))
out, nf = sm(lambda xs, ws, bs, rs: ring_allgather_matmul(
    xs, ws, axis_name="model", axis_size=PZ, compute=cca, epilogue=ep, bias=bs,
    residual=rs, out_dtype=jnp.float32, direction="fwd", fault=(3, 1, 2, 5.0)),
    AG, (P(None, "model"), P()))(x, w, bias, res)
save["abft_ag"], save["abft_ag_flags"] = out, nf
out, nf = sm(lambda xs, ws, bs, rs: ring_matmul_reduce_scatter(
    xs, ws, axis_name="model", axis_size=PZ, compute=cca, epilogue=ep2, bias=bs,
    residual=rs, out_dtype=jnp.float32, direction="bidir", fault=(2, 1, 2, 5.0)),
    RS, (P("model", None), P()))(x, w, bias, res)
save["abft_rs"], save["abft_rs_flags"] = out, nf
np.savez(sys.argv[1], **{k: np.asarray(v) for k, v in save.items()})
print("JAX_RINGS_OK")
"""


@pytest.fixture(scope="module")
def jx(tmp_path_factory):
    """JAX's rings on the 8-device host mesh (one subprocess, twelve rings)."""
    path = tmp_path_factory.mktemp("jax_rings") / "rings.npz"
    r = subprocess.run([sys.executable, "-c", _JAX_CODE, str(path)], capture_output=True,
                       text=True, timeout=300, cwd=ROOT,
                       env={**os.environ, "PYTHONPATH": "src", "JAX_PLATFORMS": "cpu"})
    assert "JAX_RINGS_OK" in r.stdout, f"stdout={r.stdout}\nstderr={r.stderr[-3000:]}"
    d = np.load(path)
    return {k: d[k] for k in d.files}


def _t(a):
    return torch.from_numpy(np.array(a))


def _ag_args(jx, P=PZ):
    """Per-rank shards of the all-gather ring: x rows, w / bias / residual
    columns (contiguous, as the dispatch keeps them)."""
    x, w, bias, res = (_t(jx[k]) for k in ("x", "w", "bias", "res"))
    m, n = x.shape[0] // P, w.shape[1] // P
    cols = [slice(r * n, (r + 1) * n) for r in range(P)]
    return ([x[r * m:(r + 1) * m] for r in range(P)],
            [w[:, c].contiguous() for c in cols],
            dict(bias=[bias[c] for c in cols], residual=[res[:, c].contiguous() for c in cols]))


def _rs_args(jx, P=PZ):
    x, w, bias, res = (_t(jx[k]) for k in ("x", "w", "bias", "res"))
    k, m = x.shape[1] // P, x.shape[0] // P
    return ([x[:, r * k:(r + 1) * k].contiguous() for r in range(P)],
            [w[r * k:(r + 1) * k] for r in range(P)],
            dict(bias=[bias] * P, residual=[res[r * m:(r + 1) * m] for r in range(P)]))


GELU_RES = Epilogue(activation="gelu", bias=True, residual=True)
BIAS_RES = Epilogue(bias=True, residual=True)


@pytest.mark.parametrize("backend", BACKENDS)
@pytest.mark.parametrize("direction", DIRS)
def test_allgather_ring_matches_jax(jx, direction, backend):
    xs, ws, kw = _ag_args(jx)
    outs = cm.ring_allgather_matmul(LocalRing(PZ), xs, ws, compute=cm.ChunkCompute(backend),
                                    epilogue=GELU_RES, direction=direction, **kw)
    np.testing.assert_allclose(torch.cat(outs, 1).numpy(), jx["ag_" + direction], **TOL)


@pytest.mark.parametrize("backend", BACKENDS)
def test_allgather_swiglu_matches_jax(jx, backend):
    xs, ws, _ = _ag_args(jx)
    _, gs, _ = _ag_args(dict(jx, w=jx["wg"]))
    outs = cm.ring_allgather_matmul(LocalRing(PZ), xs, ws, b_gate=gs,
                                    compute=cm.ChunkCompute(backend),
                                    epilogue=Epilogue(activation="swiglu"))
    np.testing.assert_allclose(torch.cat(outs, 1).numpy(), jx["ag_swiglu"], **TOL)


@pytest.mark.parametrize("backend", BACKENDS)
@pytest.mark.parametrize("direction", DIRS)
def test_reduce_scatter_ring_matches_jax(jx, direction, backend):
    xs, ws, kw = _rs_args(jx)
    outs = cm.ring_matmul_reduce_scatter(LocalRing(PZ), xs, ws,
                                         compute=cm.ChunkCompute(backend),
                                         epilogue=BIAS_RES, direction=direction, **kw)
    np.testing.assert_allclose(torch.cat(outs, 0).numpy(), jx["rs_" + direction], **TOL)


@pytest.mark.parametrize("backend", BACKENDS)
def test_reduce_scatter_activation_sees_the_full_sum(jx, backend):
    """relu on the reduced sum: the last step runs the raw GEMM, then the
    epilogue unfused, as JAX's does."""
    xs, ws, kw = _rs_args(jx)
    outs = cm.ring_matmul_reduce_scatter(LocalRing(PZ), xs, ws, bias=kw["bias"],
                                         compute=cm.ChunkCompute(backend),
                                         epilogue=Epilogue(activation="relu", bias=True))
    np.testing.assert_allclose(torch.cat(outs, 0).numpy(), jx["rs_relu"], **TOL)


@pytest.mark.parametrize("backend", BACKENDS)
@pytest.mark.parametrize("prec", ["int8", "int8_all"])
def test_quantized_allgather_matches_jax(jx, prec, backend):
    """Operands quantized once, globally: "int8" (bf16 activations, int8
    weights with per-column scales resident with their shard) and
    "int8_all" (int8 activations too, each chunk's per-row scales riding
    the ring with it)."""
    x, w, bias = _t(jx["x"]), _t(jx["w"]), _t(jx["bias"])
    cm.reset_ring_stats()
    with ops.use_policy(ops.MXPolicy(backend)), collective_policy(make_mesh((1, PZ),
                                                                            ("data", "model"))):
        got = ops.linear(x, w, bias, tp_mode="allgather", precision=prec,
                         out_dtype=torch.float32)
    assert cm.ring_stats()["allgather"] == 1
    np.testing.assert_allclose(got.numpy(), jx["ag_" + prec], **TOL)


@pytest.mark.parametrize("backend", BACKENDS)
@pytest.mark.parametrize("mode", ["allgather", "reduce_scatter"])
def test_abft_ring_fault_flags_match_jax(jx, mode, backend):
    """One RingFault per mode: the port flags it exactly as often as JAX's
    ring, and its corrupted output is JAX's corrupted output."""
    if mode == "allgather":
        xs, ws, kw = _ag_args(jx)
        outs, nf = cm.ring_allgather_matmul(
            LocalRing(PZ), xs, ws, compute=cm.ChunkCompute(backend, abft=True),
            epilogue=GELU_RES, direction="fwd", fault=AG_FAULT, **kw)
        got, key = torch.cat(outs, 1), "abft_ag"
    else:
        xs, ws, kw = _rs_args(jx)
        outs, nf = cm.ring_matmul_reduce_scatter(
            LocalRing(PZ), xs, ws, compute=cm.ChunkCompute(backend, abft=True),
            epilogue=BIAS_RES, direction="bidir", fault=RS_FAULT, **kw)
        got, key = torch.cat(outs, 0), "abft_rs"
    assert int(nf) == int(jx[key + "_flags"]) == 1
    np.testing.assert_allclose(got.numpy(), jx[key], **TOL)


def _xw(M=64, K=32, N=48, seed=0):
    rng = np.random.default_rng(seed)
    return (torch.from_numpy(rng.normal(size=(M, K)).astype(np.float32)),
            torch.from_numpy((rng.normal(size=(K, N)) * 0.1).astype(np.float32)),
            torch.from_numpy(rng.normal(size=(N,)).astype(np.float32)))


@pytest.mark.parametrize("mode", ["allgather", "reduce_scatter"])
def test_linear_dispatch_runs_the_ring(mode):
    """ops.linear(tp_mode=...) under the policy runs the ring (counted) and
    agrees with the single-device dispatch."""
    x, w, b = _xw()
    ref = ops.linear(x, w, b)
    cm.reset_ring_stats()
    with collective_policy(make_mesh((1, PZ), ("data", "model"))):
        got = ops.linear(x, w, b, tp_mode=mode)
    s = cm.ring_stats()
    assert s[mode] == 1 and s["fallbacks"] == 0
    np.testing.assert_allclose(got.numpy(), ref.numpy(), **TOL)


def test_misfit_falls_back_and_is_counted():
    """M = 7 does not divide over 8 ranks: the single-device dispatch runs,
    as in JAX, and the fallback is counted."""
    x, w, b = _xw()
    cm.reset_ring_stats()
    with collective_policy(make_mesh((1, PZ), ("data", "model"))):
        got = ops.linear(x[:7], w, b, tp_mode="allgather")
        got_rs = ops.linear(x[:, :30], w[:30], b, tp_mode="reduce_scatter")  # K = 30
    assert torch.equal(got, ops.linear(x[:7], w, b))
    assert torch.equal(got_rs, ops.linear(x[:, :30], w[:30], b))
    s = cm.ring_stats()
    assert s["allgather"] == s["reduce_scatter"] == 0 and s["fallbacks"] == 2


def test_leading_batch_dims_flatten_onto_the_ring():
    x, w, b = _xw()
    x3 = x.reshape(4, 16, 32)
    with collective_policy(make_mesh((1, PZ), ("data", "model"))):
        got = ops.linear(x3, w, b, tp_mode="allgather")
    assert got.shape == (4, 16, 48)
    np.testing.assert_allclose(got.numpy(), ops.linear(x3, w, b).numpy(), **TOL)


@pytest.mark.parametrize("mode", ["allgather", "reduce_scatter"])
def test_bidir_with_odd_chunk_rows_runs_fwd(mode):
    """M = 8 over 8 ranks leaves one row per chunk: bidir becomes "fwd",
    bitwise the "fwd" ring."""
    x, w, b = _xw(M=8)
    mesh = make_mesh((1, PZ), ("data", "model"))
    with collective_policy(mesh, direction="bidir"):
        got = ops.linear(x, w, b, tp_mode=mode)
    with collective_policy(mesh, direction="fwd"):
        fwd = ops.linear(x, w, b, tp_mode=mode)
    with collective_policy(mesh, direction="bwd"):
        bwd = ops.linear(x, w, b, tp_mode=mode)
    assert torch.equal(got, fwd)
    assert mode == "allgather" or not torch.equal(got, bwd)  # the order of the sums moves
    np.testing.assert_allclose(got.numpy(), ops.linear(x, w, b).numpy(), **TOL)


@pytest.mark.parametrize("backend", BACKENDS)
def test_serialized_references_agree_with_the_rings(jx, backend):
    ring, cc = LocalRing(PZ), cm.ChunkCompute(backend)
    xs, ws, kw = _ag_args(jx)
    ser = cm.serialized_allgather_matmul(ring, xs, ws, compute=cc, epilogue=GELU_RES, **kw)
    np.testing.assert_allclose(torch.cat(ser, 1).numpy(), jx["ag_bidir"], **TOL)
    xs, ws, kw = _rs_args(jx)
    ser = cm.serialized_matmul_psum(ring, xs, ws, compute=cc, epilogue=BIAS_RES, **kw)
    np.testing.assert_allclose(torch.cat(ser, 0).numpy(), jx["rs_bidir"], **TOL)
    with pytest.raises(ValueError, match="ABFT"):
        cm.serialized_matmul_psum(ring, xs, ws, compute=cm.ChunkCompute(backend, abft=True))


@pytest.mark.parametrize("direction", DIRS)
@pytest.mark.parametrize("mode", ["allgather", "reduce_scatter"])
def test_abft_ring_recovery_is_bitwise(mode, direction):
    """A TileFault mapped onto a RingFault: flagged, the ring rerun clean,
    the output bitwise the fault-free ring's, the counters advanced; on
    "torch" ABFT does not engage (as JAX's xla)."""
    x, w, b = _xw()
    res = torch.from_numpy(np.random.default_rng(3).normal(size=(64, 48)).astype(np.float32))
    cfg = A.AbftConfig(fault=A.TileFault(3, 0, 1, 2, 5.0))
    with ops.use_policy(ops.MXPolicy("cuda_mx")), collective_policy(
            make_mesh((1, PZ), ("data", "model")), direction=direction):
        clean = ops.linear(x, w, b, residual=res, tp_mode=mode)
        A.reset_abft_stats()
        got = ops.linear(x, w, b, residual=res, tp_mode=mode, abft=cfg)
        stats = A.abft_stats()
        assert torch.equal(got, clean)
        assert stats == dict(gemms_verified=1, tiles_flagged=1, tiles_recovered=1,
                             sdc_errors=0)
    with ops.use_policy(ops.MXPolicy("torch")), collective_policy(
            make_mesh((1, PZ), ("data", "model")), direction=direction):
        A.reset_abft_stats()
        ops.linear(x, w, b, residual=res, tp_mode=mode, abft=cfg)
        assert A.abft_stats()["gemms_verified"] == 0


def test_weight_shard_cache_keeps_one_copy_per_parameter_version():
    x, w, b = _xw()
    ops.clear_shard_cache()
    with collective_policy(make_mesh((1, PZ), ("data", "model"))):
        ops.linear(x, w, b, tp_mode="allgather")
        nbytes = ops.shard_cache_bytes()
        assert nbytes == w.numel() * 4
        ops.linear(x, w, b, tp_mode="allgather")
        assert ops.shard_cache_bytes() == nbytes  # kept, not copied again
        ops.linear(x, w, b, tp_mode="reduce_scatter")  # row shards are views
        assert ops.shard_cache_bytes() == nbytes
        w.mul_(2.0)  # an in-place update: a new version, new shards
        got = ops.linear(x, w, b, tp_mode="allgather")
        np.testing.assert_allclose(got.numpy(), ops.linear(x, w, b).numpy(), **TOL)
    del w
    import gc
    gc.collect()
    assert ops.shard_cache_bytes() == 0  # the entry goes with the weight


def test_ring_topology_and_policy_context():
    mesh = make_mesh((1, 4), ("data", "model"))
    topo = ring_topology(mesh, "model")
    assert topo["size"] == 4
    assert (0, 1) in topo["fwd"] and (3, 0) in topo["fwd"]
    assert (0, 3) in topo["bwd"] and (1, 0) in topo["bwd"]
    with pytest.raises(ValueError):
        ring_topology(mesh, "expert")
    assert current_collectives() is None
    with collective_policy(mesh, axis="model") as pol:
        assert isinstance(pol, CollectivePolicy)
        assert current_collectives() is pol
        assert pol.axis_size == 4 and pol.ring.size == 4
        with collective_policy(policy=CollectivePolicy(mesh, enabled=False)):
            assert current_collectives() is None  # a disabled policy hides
        assert current_collectives() is pol
    assert current_collectives() is None
    with pytest.raises(ValueError):
        CollectivePolicy(mesh, direction="sideways")


def test_tp_mode_validation_and_inert_without_policy():
    x, w, _ = _xw(M=8, K=16, N=8)
    with pytest.raises(ValueError):
        ops.linear(x, w, tp_mode="ring")
    cm.reset_ring_stats()
    assert torch.equal(ops.linear(x, w, tp_mode="allgather"), ops.linear(x, w))
    assert cm.ring_stats()["allgather"] == 0


def test_ring_gemm_model_validation():
    with pytest.raises(ValueError):
        RingCollectiveGemm("gather", 8)
    with pytest.raises(ValueError):
        RingCollectiveGemm("allgather", 0)


def test_ring_gemm_comm_volume_and_steps():
    p = GemmProblem(1024, 512, 256, 2)
    ring = RingCollectiveGemm("allgather", 8, bidirectional=False)
    assert ring.steps == 8 and ring.sends == 7
    assert ring.chunk_comm_bytes(p) == (1024 // 8) * 256 * 2
    bidir = RingCollectiveGemm("allgather", 8, bidirectional=True)
    assert bidir.chunk_comm_bytes(p) == ring.chunk_comm_bytes(p) // 2
    assert bidir.total_comm_bytes(p) == ring.total_comm_bytes(p)
    rs = RingCollectiveGemm("reduce_scatter", 8, bidirectional=False)
    assert rs.chunk_comm_bytes(p) == (1024 // 8) * 512 * 4


def test_exposed_comm_is_max0_comm_minus_compute():
    p = GemmProblem(2048, 2048, 2048, 2)
    ring = RingCollectiveGemm("allgather", 4)
    assert ring.exposed_comm_s(p, ici_bw=1e12, peak_flops=1e12) == 0.0
    tc, tm = ring.step_compute_s(p, 1e18), ring.step_comm_s(p, 1e6)
    assert ring.exposed_comm_s(p, ici_bw=1e6, peak_flops=1e18) == pytest.approx(
        ring.sends * (tm - tc))
    assert 0.0 <= ring.overlap_efficiency(p, ici_bw=1e6, peak_flops=1e18) <= 1.0


def test_overlapped_never_slower_than_serialized():
    p = GemmProblem(4096, 1024, 8192, 2)
    for mode in ("allgather", "reduce_scatter"):
        for P in (2, 4, 8):
            ring = RingCollectiveGemm(mode, P)
            assert ring.overlapped_time_s(p, ici_bw=50e9, peak_flops=197e12) <= \
                ring.serialized_time_s(p, ici_bw=50e9, peak_flops=197e12) + 1e-12
            rep = ring.report(p, ici_bw=50e9, peak_flops=197e12)
            assert rep["exposed_comm_s"] >= 0.0 and rep["comm_bytes_total"] > 0
