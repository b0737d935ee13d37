"""The paper's analytics in the port against the JAX package's, on the CPU:
the transfer model (Tables I-II, the Hopper mapping, the serving models),
Table IV's data, the fitted energy model, the roofline and
`executed_gemm_bytes`.  Counts are held equal exactly, floats at rel 1e-12
(one formula in two packages on the same inputs: only the last bit may
move), and JAX's own asserted values are mirrored, with H100 figures where
JAX used TPU ones."""
import dataclasses
import itertools
import re
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro.core import energy as je  # noqa: E402
from repro.core import paper_data as jpd  # noqa: E402
from repro.core import roofline as jr  # noqa: E402
from repro.core import tiling as jt  # noqa: E402
from repro.core import transfer_model as jm  # noqa: E402
from repro.kernels import quant as jq  # noqa: E402
from repro_torch.core import energy as te  # noqa: E402
from repro_torch.core import paper_data as tpd  # noqa: E402
from repro_torch.core import roofline as tr  # noqa: E402
from repro_torch.core import tiling as tt  # noqa: E402
from repro_torch.core import transfer_model as tm  # noqa: E402
from repro_torch.kernels import quant as tq  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
REL = 1e-12


def _close(a, b):
    return a == b or abs(a - b) <= REL * max(abs(a), abs(b))


def _same_record(got: dict, want: dict):
    """Two report dicts: the same keys, counts equal, floats at rel 1e-12."""
    assert got.keys() == want.keys()
    for k in want:
        g, w = got[k], want[k]
        if isinstance(w, dict):
            _same_record(g, w)
        elif isinstance(w, float):
            assert _close(g, w), (k, g, w)
        else:
            assert g == w and type(g) is type(w), (k, g, w)


def _problems():
    """(port, JAX) GemmProblem pairs: aligned and ragged shapes, element
    sizes 1 / 2 / 4 / 8, narrow weights, a wide store, 2:4 weights."""
    out = []
    for (M, N, K), (eb, bb, ob), sparse in itertools.product(
            [(64, 64, 64), (8, 2048, 8192), (100, 70, 300), (1, 16, 2048), (256, 512, 33)],
            [(8, None, None), (4, None, None), (2, 1, 2), (1, 1, 4), (2, None, 4)],
            [False, True]):
        kw = dict(b_bytes=bb, out_bytes=ob, b_sparse=sparse)
        out.append((tm.GemmProblem(M, N, K, eb, **kw), jm.GemmProblem(M, N, K, eb, **kw)))
    return out


PROBLEMS = _problems()
TILES = [(8, 8, 8), (16, 32, 16), (64, 128, 32), (32, 64, 128), (128, 16, 512)]


# --------------------------- Table IV and Tables I-II ---------------------------


def _row_kernel(mod, row):
    if row.config == "baseline":
        return mod.BaselineKernel(*row.tile)
    return mod.MXKernel(*row.tile, *row.subtile)


def test_table4_data_is_the_papers():
    assert [dataclasses.astuple(r) for r in tpd.TABLE4] == [
        dataclasses.astuple(r) for r in jpd.TABLE4]
    assert tpd.HEADLINE == jpd.HEADLINE
    for name in ("DUAL_CORE_PEAK_FLOP_PER_CYCLE", "DUAL_CORE_TT_HZ",
                 "MEMPOOL_PEAK_FLOP_PER_CYCLE", "MEMPOOL_TT_HZ"):
        assert getattr(tpd, name) == getattr(jpd, name)
    for cluster, config, size in itertools.product(("dual", "64c"), ("baseline", "mx"),
                                                   (16, 64)):
        if jpd.rows(cluster, config) and any(r.size == size for r in jpd.rows(cluster)):
            assert (dataclasses.astuple(tpd.best_row(cluster, config, size))
                    == dataclasses.astuple(jpd.best_row(cluster, config, size)))
    assert len(tpd.rows("dual")) == len(jpd.rows("dual")) == 18


@pytest.mark.parametrize("i", range(len(jpd.TABLE4)))
def test_table4_mem_vrf_transfers_and_intensity(i):
    """The "Mem-VRF Transfers" column exactly (the one deviating row gives
    the closed form's 1536, as in JAX), the arithmetic intensity to the
    paper's printed precision, every count equal to JAX's."""
    row, jrow = tpd.TABLE4[i], jpd.TABLE4[i]
    p = tm.GemmProblem(row.size, row.size, row.size, row.elem_bytes)
    jp = jm.GemmProblem(row.size, row.size, row.size, row.elem_bytes)
    k, jk = _row_kernel(tm, row), _row_kernel(jm, jrow)
    got = k.mem_to_vrf(p)
    assert dataclasses.astuple(got) == dataclasses.astuple(jk.mem_to_vrf(jp))
    assert got.total == (1536 if row.formula_deviates else row.mem_vrf_transfers)
    if not row.formula_deviates:
        assert k.arithmetic_intensity(p) == pytest.approx(row.arithmetic_intensity, abs=0.005)
    assert _close(k.arithmetic_intensity(p), jk.arithmetic_intensity(jp))
    assert k.vector_instructions(p) == jk.vector_instructions(jp)
    assert _close(k.simd_ratio(p), jk.simd_ratio(jp))


@pytest.mark.parametrize("pi", range(0, len(PROBLEMS), 3))
def test_tables_i_ii_counts_equal_jax(pi):
    p, jp = PROBLEMS[pi]
    for (m, n, k), ib, c0 in itertools.product(TILES, (False, True), (False, True)):
        assert (dataclasses.astuple(tm.mem_to_vrf(p, m, n, k, inter_k_buffering=ib,
                                                  c_is_zero=c0))
                == dataclasses.astuple(jm.mem_to_vrf(jp, m, n, k, inter_k_buffering=ib,
                                                     c_is_zero=c0)))
        for kb, kv in ((False, False), (True, False), (False, True)):
            kw = dict(inter_k_buffering_buf=kb, inter_k_buffering_vrf=kv, c_is_zero=c0)
            assert (dataclasses.astuple(tm.vrf_to_buf(p, m, n, k, m, max(n // 2, 1), 4, **kw))
                    == dataclasses.astuple(jm.vrf_to_buf(jp, m, n, k, m, max(n // 2, 1), 4,
                                                         **kw)))
        assert (dataclasses.astuple(tm.buf_to_fpu(p, m, n, k, 4, 8))
                == dataclasses.astuple(jm.buf_to_fpu(jp, m, n, k, 4, 8)))
    base, jbase = tm.BaselineKernel(4, 32), jm.BaselineKernel(4, 32)
    mx, jmx = tm.MXKernel(8, 16, 4, 8, 4, 4), jm.MXKernel(8, 16, 4, 8, 4, 4)
    for a, b in ((base, jbase), (mx, jmx)):
        assert dataclasses.astuple(a.mem_to_vrf(p)) == dataclasses.astuple(b.mem_to_vrf(jp))
        assert a.vector_instructions(p) == b.vector_instructions(jp)
    assert dataclasses.astuple(base.vrf_to_fpu(p)) == dataclasses.astuple(jbase.vrf_to_fpu(jp))
    assert dataclasses.astuple(mx.vrf_to_buf(p)) == dataclasses.astuple(jmx.vrf_to_buf(jp))
    assert dataclasses.astuple(mx.buf_to_fpu(p)) == dataclasses.astuple(jmx.buf_to_fpu(jp))
    assert _close(mx.vrf_access_reduction_vs(base, p), jmx.vrf_access_reduction_vs(jbase, jp))


def test_mx_claims_hold_in_the_port():
    """JAX's §III-B.6 and SIMD-ratio assertions, on the port's classes."""
    p = tm.GemmProblem(64, 64, 64, 8)
    base, mx = tm.BaselineKernel(4, 32, 1), tm.MXKernel(8, 16, 4, 8, 4, 4)
    assert mx.vrf_access_reduction_vs(base, p) > 2.0
    assert mx.simd_ratio(p) >= 1.5 * base.simd_ratio(p)
    for M, N, K in ((16, 32, 48), (64, 128, 256)):
        q = tm.GemmProblem(M, N, K, 8)
        t1 = tm.mem_to_vrf(q, 8, 8, 8, inter_k_buffering=True)
        t2 = tm.vrf_to_buf(q, 8, 8, 8, 8, 4, 4, inter_k_buffering_vrf=True)
        t3 = tm.buf_to_fpu(q, 8, 4, 4, t_a=4, t_b=4)
        assert t3.total >= t2.total >= t1.total


# --------------------------- the Hopper mapping ---------------------------


@pytest.mark.parametrize("acc", [True, False])
@pytest.mark.parametrize("pi", range(len(PROBLEMS)))
def test_hopper_tiling_is_pallas_tiling_on_the_same_tile(pi, acc):
    """`HopperGemmTiling`'s traffic formulas give `PallasGemmTiling`'s
    numbers for the same (bm, bn, bk): inter-k buffering on and off, the C
    reset on and off, 0-3 fused epilogue ops, an explicit store size."""
    p, jp = PROBLEMS[pi]
    for (bm, bn, bk), c0, ops_ in itertools.product(TILES, (True, False), (0, 3)):
        h = tm.HopperGemmTiling(bm, bn, bk, accumulate_in_registers=acc, c_is_zero=c0,
                                fused_epilogue_ops=ops_)
        j = jm.PallasGemmTiling(bm, bn, bk, accumulate_in_vmem=acc, c_is_zero=c0,
                                fused_epilogue_ops=ops_)
        assert dataclasses.astuple(h.hbm_transfers(p)) == dataclasses.astuple(
            j.hbm_transfers(jp))
        for ob in (None, 2):
            assert h.hbm_bytes(p, ob) == j.hbm_bytes(jp, ob)
            assert h.epilogue_saved_bytes(p, ob) == j.epilogue_saved_bytes(jp, ob)
            assert h.unfused_chain_bytes(p, ob) == j.unfused_chain_bytes(jp, ob)
        assert h.grid_steps(p) == j.grid_steps(jp)
        assert _close(h.arithmetic_intensity(p), j.arithmetic_intensity(jp))
        assert _close(h.simd_ratio(p), j.simd_ratio(jp))
        if acc and -(-p.K // bk) > 1:  # JAX's: accumulation strictly reduces the bytes
            base = dataclasses.replace(h, accumulate_in_registers=False)
            assert h.hbm_bytes(p) < base.hbm_bytes(p)


def test_hopper_tiling_gate_adds_one_weight_panel():
    p = tm.GemmProblem(64, 8192, 2048, 4)
    plain, gated = tm.HopperGemmTiling(64, 64, 32), tm.HopperGemmTiling(64, 64, 32, gated=True)
    t = plain.hbm_transfers(p)
    assert gated.hbm_bytes(p) - plain.hbm_bytes(p) == t.b_down * 4
    assert gated.acc_register_bytes(p) == 2 * plain.acc_register_bytes(p) == 2 * 64 * 64 * 4


# --------------------------- ABFT, 2:4, serving ---------------------------


@pytest.mark.parametrize("pi", range(0, len(PROBLEMS), 2))
def test_abft_and_sparse_reports_equal_jax(pi):
    p, jp = PROBLEMS[pi]
    p, jp = dataclasses.replace(p, b_sparse=False), dataclasses.replace(jp, b_sparse=False)
    for (bm, bn, _), exact, inject in itertools.product(TILES, (False, True), (False, True)):
        got = tm.AbftGemm(bm, bn, exact=exact, inject=inject).report(p)
        want = jm.AbftGemm(bm, bn, exact=exact, inject=inject).report(jp)
        want["extra_smem_bytes"] = want.pop("extra_vmem_bytes")
        _same_record(got, want)
    for (bm, bn, bk), ops_ in itertools.product(TILES, (0, 2)):
        got = tm.SparseGemm(bm, bn, bk, fused_epilogue_ops=ops_).report(p)
        want = jm.SparseGemm(bm, bn, bk, fused_epilogue_ops=ops_).report(jp)
        assert got.pop("smem_bytes") > 0
        want.pop("vmem_bytes")
        _same_record(got, want)


def test_sparse_smem_is_the_launchers():
    from repro_torch.kernels import _build

    p = tm.GemmProblem(64, 2048, 8192, 2, b_bytes=1)
    got = tm.SparseGemm(64, 64, 64).smem_bytes(p)
    assert got == _build.prefill_smem(64, 64, 64, 2, 1, 2, 1, 1, False, True)


LENGTHS = ([256] * 8, [128] * 8, [64] * 8, [9] * 8, [0] * 8, [10, 33, 64, 0, 1, 255, 16, 17])


@pytest.mark.parametrize("kv_bytes,scale_bytes", [(2, 0), (4, 0), (1, 4)])
def test_paged_kv_decode_and_migration_equal_jax(kv_bytes, scale_bytes):
    kw = dict(page_size=8, n_kv_heads=4, head_dim=32, n_layers=2, kv_bytes=kv_bytes,
              scale_bytes=scale_bytes)
    m, j = tm.PagedKVDecode(8, 256, **kw), jm.PagedKVDecode(8, 256, **kw)
    for lengths in LENGTHS:
        _same_record(m.report(lengths, hbm_bw=tr.HBM_BW), j.report(lengths, hbm_bw=tr.HBM_BW))
        _same_record(m.report(lengths), j.report(lengths))
    # JAX's asserted values
    assert m.dense_step_bytes([128] * 8) == m.dense_step_bytes([256] * 8)
    assert m.paged_step_bytes([256] * 8) == m.dense_step_bytes([256] * 8)
    assert abs(m.traffic_ratio([128] * 8) - 0.5) < 0.01
    assert m.paged_step_bytes([9] * 8) == m.paged_step_bytes([16] * 8)
    assert m.paged_step_bytes([0] * 8) == 0
    mig, jmig = tm.PageMigration(**kw), jm.PageMigration(**kw)
    assert mig.row_bytes == m.row_bytes and mig.page_bytes == 8 * m.row_bytes * 2
    for pages in (0, 5, -3):
        _same_record(mig.report(pages, bw=1e9), jmig.report(pages, bw=1e9))
    assert mig.handoff_bytes(5, shared_pool=True) == 0
    assert mig.migrate_bytes(5) == 2 * 5 * mig.page_bytes


@pytest.mark.parametrize("gated,act,kv", [(True, 2, 2), (False, 4, 1)])
def test_shared_prefix_and_speculation_equal_jax(gated, act, kv):
    kw = dict(d_model=2048, d_ff=8192, n_heads=32, n_kv_heads=8, head_dim=64, n_layers=16,
              gated_mlp=gated, act_bytes=act, kv_bytes=kv, scale_bytes=4 if kv == 1 else 0)
    got = tm.SharedPrefixPrefill(**kw).report(128, flops_rate=tr.PEAK_FLOPS["bfloat16"],
                                              hbm_bw=tr.HBM_BW)
    want = jm.SharedPrefixPrefill(**kw).report(128, flops_rate=tr.PEAK_FLOPS["bfloat16"],
                                               hbm_bw=tr.HBM_BW)
    _same_record(got, want)
    for k, ratio in ((1, 0.0), (4, 0.0), (4, 0.1), (8, 0.05)):
        _same_record(tm.SpeculativeDecode(k, ratio).report(),
                     jm.SpeculativeDecode(k, ratio).report())
    with pytest.raises(ValueError):
        tm.SpeculativeDecode(0)


@pytest.mark.parametrize("mode", ["allgather", "reduce_scatter"])
@pytest.mark.parametrize("P,bidir", [(1, True), (4, False), (8, True)])
def test_ring_collective_gemm_equals_jax(mode, P, bidir):
    for p, jp in PROBLEMS[::4]:
        got = tm.RingCollectiveGemm(mode, P, bidirectional=bidir).report(
            p, ici_bw=tr.NVLINK_BW, peak_flops=tr.PEAK_FLOPS["bfloat16"])
        want = jm.RingCollectiveGemm(mode, P, bidirectional=bidir).report(
            jp, ici_bw=tr.NVLINK_BW, peak_flops=tr.PEAK_FLOPS["bfloat16"])
        _same_record(got, want)


# --------------------------- executed bytes ---------------------------


def _operands(kind, M, K, N, rng):
    """(a, b) numpy payloads of one operand pair, and their scale arrays."""
    a = rng.standard_normal((M, K)).astype(np.float32)
    b = rng.standard_normal((K, N)).astype(np.float32)
    if kind == "float":
        return a, b, ()
    if kind == "int8":
        a, b = (np.clip(np.round(x * 20), -127, 127).astype(np.int8) for x in (a, b))
    return a, b, (rng.random((M, 1)).astype(np.float32), rng.random((1, N)).astype(np.float32))


def _jax_tensor(x, kind):
    return jnp.asarray(x, jnp.float8_e4m3fn) if kind == "fp8" else jnp.asarray(x)


def _torch_tensor(x, kind):
    t = torch.from_numpy(x)
    return t.to(torch.float8_e4m3fn) if kind == "fp8" else t


@pytest.mark.parametrize("kind", ["float", "int8", "fp8"])
@pytest.mark.parametrize("M,K,N", [(8, 2048, 512), (64, 256, 96), (17, 300, 70)])
def test_executed_gemm_bytes_equal_jax(kind, M, K, N):
    rng = np.random.default_rng(M + K + N)
    a, b, scales = _operands(kind, M, K, N, rng)
    ja, jb = _jax_tensor(a, kind), _jax_tensor(b, kind)
    ta, tb = _torch_tensor(a, kind), _torch_tensor(b, kind)
    js, ts = tuple(map(jnp.asarray, scales)), tuple(map(torch.from_numpy, scales))
    meta = rng.integers(0, 255, (K // 8, N), dtype=np.uint8)
    for (bm, bn, bk), ob in itertools.product(TILES, (4, 2)):
        kw = dict(bm=bm, bn=bn, bk=bk, out_itemsize=ob)
        assert (tq.executed_gemm_bytes(ta, tb, scales=ts, **kw)
                == jq.executed_gemm_bytes(ja, jb, scales=js, **kw))
        assert (tq.executed_gemm_bytes(ta, tb, scales=(None, *ts), **kw)
                == jq.executed_gemm_bytes(ja, jb, scales=(None, *js), **kw))
        half_t, half_j = tb[: K // 2], jb[: K // 2]  # a 2:4 payload and its metadata
        assert (tq.executed_gemm_bytes(ta, half_t, b_meta=torch.from_numpy(meta), **kw)
                == jq.executed_gemm_bytes(ja, half_j, b_meta=jnp.asarray(meta), **kw))


@pytest.mark.parametrize("dt", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("M,K,N", [(8, 2048, 2048), (64, 8192, 2048), (40, 2056, 200)])
def test_launch_bytes_at_the_priced_tile(dt, M, K, N):
    """Kernel 1's and kernel 2's launches each at their own tile; on an
    aligned problem the executed bytes are the tiling's model bytes."""
    a, b = torch.zeros((M, K), dtype=dt), torch.zeros((K, N), dtype=dt)
    for variant in ("dense", "baseline"):
        plan = tt.plan_matmul_tiles(M, N, K, dt, dt, variant)
        got = tq.launch_gemm_bytes(a, b, variant=variant)
        want = tq.executed_gemm_bytes(a, b, bm=plan.bm, bn=plan.bn, bk=plan.bk,
                                      out_itemsize=dt.itemsize)
        trips = -(-K // tt.BASELINE_BK) - 1 if variant == "baseline" else 0
        bm_, bn_ = min(plan.bm, M), min(plan.bn, N)
        assert got == want + 2 * trips * (-(-M // bm_) * bm_) * (-(-N // bn_) * bn_) * dt.itemsize
        if M % bm_ == 0 and N % bn_ == 0 and K % min(plan.bk, K) == 0:
            assert got == plan.hbm_bytes
    gp = tt.plan_matmul_tiles(M, N, K, dt, dt, gated=True)  # a swiglu launch: its own tile
    bm_, bn_, bk_ = min(gp.bm, M), min(gp.bn, N), min(gp.bk, K)
    gate = -(-M // bm_) * (-(-K // bk_) * bk_) * (-(-N // bn_) * bn_) * dt.itemsize
    assert tq.launch_gemm_bytes(a, b, b_gate=b) == gate + tq.executed_gemm_bytes(
        a, b, bm=gp.bm, bn=gp.bn, bk=gp.bk, out_itemsize=dt.itemsize)


# --------------------------- energy ---------------------------


def _fit_pairs():
    dual, tdual = jpd.rows("dual"), tpd.rows("dual")
    return [
        (te.fit_energy_model(tdual, "dual"), je.fit_energy_model(dual, "dual"), "dual", 64),
        (te.fit_energy_model([r for r in tdual if r.size < 64], "dual"),
         je.fit_energy_model([r for r in dual if r.size < 64], "dual"), "dual", 64),
        (te.fit_energy_model(tpd.rows("64c"), "64c"), je.fit_energy_model(jpd.rows("64c"), "64c"),
         "64c", 64),
        (te.fit_energy_model(tdual, "dual", features=("mem", "vrf", "mac")),
         je.fit_energy_model(dual, "dual", features=("mem", "vrf", "mac")), "dual", 32),
    ]


@pytest.mark.parametrize("i", range(4))
def test_energy_fit_equals_jax(i):
    model, jmodel, cluster, size = _fit_pairs()[i]
    assert model.coef.keys() == jmodel.coef.keys() == set(te.FEATURES)
    for f in te.FEATURES:
        assert _close(model.coef[f], jmodel.coef[f]), (f, model.coef[f], jmodel.coef[f])
    _same_record(te.modeled_gain(model, cluster, size), je.modeled_gain(jmodel, cluster, size))
    for row, jrow in zip(tpd.rows(cluster), jpd.rows(cluster)):
        assert te.access_counters(row) == je.access_counters(jrow)
        assert _close(model.energy_j(row), jmodel.energy_j(jrow))


def test_energy_model_mirrors_jax_assertions():
    small = te.access_counters(tpd.best_row("dual", "mx", 16))
    big = te.access_counters(tpd.best_row("dual", "mx", 64))
    assert all(big[k] > small[k] for k in ("mem", "vrf", "mac"))
    model = te.fit_energy_model(tpd.rows("dual"), "dual")
    g = te.modeled_gain(model, "dual", 64)
    assert abs(g["modeled"] - g["paper"]) < 0.05 and g["paper"] == pytest.approx(0.109, abs=0.01)
    held = te.fit_energy_model([r for r in tpd.rows("dual") if r.size < 64], "dual")
    g = te.modeled_gain(held, "dual", 64)
    assert g["modeled"] > 0.0 and abs(g["modeled"] - g["paper"]) < 0.10
    c = model.coef
    assert c["mem"] >= 0 and c["vrf"] >= 0 and c["mac"] >= 0
    assert c["vrf"] == 0 or c["mem"] + 1e-18 >= c["vrf"] * 0.5
    a = np.array([[1.0, 2.0], [3.0, 4.0], [5.0, 7.0]])
    b = np.array([1.0, -2.0, 0.5])
    assert np.array_equal(te._nnls(a, b), je._nnls(a, b))


def test_paper_subtile_space_is_jaxs():
    assert list(tt.paper_subtile_space()) == list(jt.paper_subtile_space())
    assert all(m * n * 8 <= 256 for m, n, _ in tt.paper_subtile_space())


# --------------------------- the roofline ---------------------------


@pytest.mark.parametrize("model_flops", [None, 0.0, 3e15])
@pytest.mark.parametrize("coll", [0.0, 4e11, 9e12])
def test_roofline_report_equals_jax_at_equal_rates(coll, model_flops):
    kw = dict(hlo_flops=5e15, hlo_bytes=2e12, collective_bytes=coll, chips=4,
              model_flops=model_flops, peak_flops=tr.PEAK_FLOPS["bfloat16"], hbm_bw=tr.HBM_BW)
    got = tr.RooflineReport(**kw, link_bw=tr.NVLINK_BW).as_dict()
    want = jr.RooflineReport(**kw, ici_bw=tr.NVLINK_BW).as_dict()
    _same_record(got, want)
    assert tr.kv_decode_memory_s(3.2e6, 2) == jr.kv_decode_memory_s(3.2e6, 2, hbm_bw=tr.HBM_BW)
    assert tr.dense_model_flops(1234, 56) == jr.dense_model_flops(1234, 56)
    assert tr.inference_model_flops(1234, 56) == jr.inference_model_flops(1234, 56)


def test_roofline_report_math_on_the_h100():
    """JAX's `test_roofline_report_math` with the card's rates."""
    peak, bw = tr.PEAK_FLOPS["bfloat16"], tr.HBM_BW
    r = tr.RooflineReport(hlo_flops=peak * 256, hlo_bytes=bw * 256 * 2, collective_bytes=0.0,
                          chips=256, model_flops=peak * 128)
    assert r.compute_s == pytest.approx(1.0)
    assert r.memory_s == pytest.approx(2.0)
    assert r.bound == "memory"
    assert r.useful_flops_ratio == pytest.approx(0.5)
    assert r.roofline_fraction == pytest.approx(0.25)
    assert (r.peak_flops, r.hbm_bw, r.link_bw) == (989e12, 3.35e12, 450e9)


def test_the_bounds_perf_md_gives():
    """The training step's bound (the sum of its two terms, not their
    max), the f32 decode down projection's and the M = 2048 one's."""
    from repro_torch.configs import get_config
    from repro_torch.models import build_model
    from repro_torch.models.modules import param_count

    n = param_count(build_model(get_config("llama3.2-1b")).init(0, device="meta"))
    assert n == 1235814400
    assert round(tr.train_step_bound_s(n, 8 * 128) * 1e3, 2) == 123.66
    lb = tr.RooflineReport(hlo_flops=tr.dense_model_flops(n, 1024),
                           hlo_bytes=tr.adamw_step_bytes(n), collective_bytes=0.0, chips=1,
                           peak_flops=tr.PEAK_FLOPS["float32"])
    assert round(lb.step_time_lower_bound_s * 1e3, 2) == 113.33  # the max, not the bound used
    ms, by = tr.bound_ms(4 * (8 * 8192 + 8192 * 2048 + 2 * 8 * 2048), 2 * 8 * 8192 * 2048,
                         "float32")
    assert (round(ms, 4), by) == (0.0201, "bytes")
    ms, by = tr.bound_ms(4 * (2048 * 8192 + 8192 * 2048 + 2 * 2048 * 2048),
                         2 * 2048 * 8192 * 2048, "float32")
    assert (round(ms, 4), by) == (1.0257, "operations")


def test_chip_smoke_bounds_are_the_hand_formulas_to_the_bit():
    """`chip_smoke.py`'s bounds, now read from the roofline, are bit for bit
    the formulas it computed by hand before: the kernel bound, the TF32
    route's bound and the training step's bound."""
    import sys

    sys.path.insert(0, str(ROOT))
    import chip_smoke as cs

    peaks = {"float32": 67e12, "bfloat16": 989e12, "int8": 1979e12, "float8_e4m3fn": 1979e12}
    rng = np.random.default_rng(0)
    for nbytes, flops in zip(rng.integers(1, 2 ** 40, 200), rng.integers(1, 2 ** 46, 200)):
        nbytes, flops = int(nbytes), int(flops)
        for dtype, peak in peaks.items():
            t_bytes, t_ops = nbytes / 3.35e12 * 1e3, flops / peak * 1e3
            want = (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")
            assert cs._bound_ms(nbytes, flops, dtype) == want
        assert cs._route_bound_ms(nbytes, 3 * flops) == max(nbytes / 3.35e12,
                                                            3 * flops / 495e12) * 1e3
    for n, tokens in ((1235814400, 1024), (494032768, 2048), (7, 3)):
        assert tr.train_step_bound_s(n, tokens) * 1e3 == (
            6 * n * tokens / 67e12 + 7 * 4 * n / 3.35e12) * 1e3


def test_no_tpu_constant_in_the_port():
    """Neither the port nor chip_smoke.py holds a TPU v5e constant or JAX's
    TPU energy table."""
    pat = re.compile(r"(?<![\w.])(819e9|197e12|50e9)(?![\w.])|TPU_ENERGY")
    files = sorted((ROOT / "src" / "repro_torch").rglob("*.py")) + [ROOT / "chip_smoke.py"]
    assert len(files) > 40
    hits = [f"{f.relative_to(ROOT)}:{i}" for f in files
            for i, line in enumerate(f.read_text().splitlines(), 1) if pat.search(line)]
    assert not hits, hits
    assert pat.search("ICI_BW = 50e9") and not pat.search("NVLINK_BW = 450e9")
