"""ABFT (checksummed GEMMs, tile recovery, the logits audit) in the port,
as tests/test_abft.py pins it in the JAX package (its jit and ring cases
aside: the port's dispatch is eager and has no ring GEMM yet), with the
JAX package as the reference for every output.

- `kernels/abft.py`: specs, fault operands, the ambient config, counters.
- The kernel wrappers (`mx_matmul_fused`, `mx_grouped_matmul` with
  ``abft=``; on CPU tensors their plain versions, which take JAX's checksum
  arithmetic over the CUDA kernels' tiles, `_build.gemm_tile` /
  `grouped_flag_tile`): clean runs bitwise equal to ABFT off with no flag, an
  injected fault flags exactly its tile.
- The dispatch (`core/ops.py` on "cuda_mx"): detection and bitwise recovery,
  the typed SDCError, int8 x int8 exact (a unit delta), every precision
  policy, sparse weights expanded first, grouped recovery per overlapping
  expert, and a hypothesis sweep with no false positive.  Outputs equal
  JAX's (pallas_mx in interpret mode) within 1e-5 * max|ref|.
- The batcher's ``abft=True``: streams equal to JAX's batcher and to
  ``abft=False`` (llama and grok smoke, plain and speculative) with zero
  counters, and a corrupted host copy of the logits detected and fetched
  again.

The recovery's bits on the CPU rest on torch.matmul giving a tile's rows
and columns the bits of the whole product, which holds at these sizes
(K <= 256); on the card each output element is one MAC chain over K in
every tile shape (tests/test_torch_cuda.py)."""
import dataclasses

import numpy as np
import pytest
from hypothesis import given, settings, strategies as st

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.core import ops as jops  # noqa: E402
from repro_torch.core import ops as tops  # noqa: E402
from repro_torch.kernels import _build  # noqa: E402
from repro_torch.kernels import abft as ab  # noqa: E402
from repro_torch.kernels.abft import (AbftConfig, SDCError, TileFault,  # noqa: E402
                                      abft_rtol, abft_stats, build_fault_operands,
                                      make_abft_spec, reset_abft_stats, use_abft)
from repro_torch.kernels.mx_grouped_matmul import abft_spec_for as grouped_spec  # noqa: E402
from repro_torch.kernels.mx_grouped_matmul import mx_grouped_matmul  # noqa: E402
from repro_torch.kernels.mx_matmul import Epilogue, abft_spec_for, mx_matmul_fused  # noqa: E402

MX = tops.MXPolicy("cuda_mx")
J_PALLAS = jops.MXPolicy("pallas_mx", bm=32, bn=32, bk=32, interpret=True)
BIG = 2.0 ** 16  # an exponent-bit flip, far above the float tolerance here


def _rand(seed, shape, scale=1.0):
    return (np.random.default_rng(seed).standard_normal(shape) * scale).astype(np.float32)


def _t(a, dtype=torch.float32):
    return torch.from_numpy(a).to(dtype)


def _close(got, ref, rel=1e-5):
    ref = np.asarray(ref, np.float32)
    err = np.abs(np.asarray(got, np.float32) - ref).max()
    assert err <= rel * np.abs(ref).max(), (err, np.abs(ref).max())


# ---------------------------------------------------------------------------
# spec / fault operands / ambient config / counters
# ---------------------------------------------------------------------------


def test_spec_selects_exact_iff_both_integer_as_jax():
    from repro.kernels import abft as jab

    assert make_abft_spec(torch.int8, torch.int8, 64, 32, 32).exact
    for a, b in ((torch.float32, torch.float32), (torch.bfloat16, torch.bfloat16),
                 (torch.bfloat16, torch.int8), (torch.int8, torch.float32),
                 (torch.float8_e4m3fn, torch.float8_e4m3fn)):
        s = make_abft_spec(a, b, 64, 32, 32)
        assert not s.exact and s.rtol == abft_rtol(64, 32, 32) > 0.0 and s.atol > 0.0
    for K, bm, bn in ((64, 32, 32), (2048, 16, 16), (8192, 64, 64)):
        assert abft_rtol(K, bm, bn) == jab.abft_rtol(K, bm, bn)
    s = make_abft_spec(torch.float32, torch.float32, 64, 32, 32)
    assert dataclasses.asdict(s) == dataclasses.asdict(
        jab.make_abft_spec(jnp.float32, jnp.float32, 64, 32, 32))
    assert not s.inject and s.with_inject(True).inject


def test_fault_operands_reduce_mod_grid_and_tile():
    fd, fr, fc = build_fault_operands(TileFault(5, 7, 70, 99, 3.0), 2, 3, 32, 32)
    assert fd.shape == fr.shape == fc.shape == (2, 3)
    assert fr.dtype == fc.dtype == torch.int32 and fd.dtype == torch.float32
    assert float(fd[5 % 2, 7 % 3]) == 3.0 and float(fd.abs().sum()) == 3.0
    assert int(fr[0, 0]) == 70 % 32 and int(fc[0, 0]) == 99 % 32
    assert build_fault_operands(None, 2, 3, 32, 32) is None


def test_use_abft_ambient_nesting_and_restore():
    assert ab.current_abft() is None
    with use_abft() as cfg:
        assert ab.current_abft() is cfg and cfg.max_retries == 2
        inner = AbftConfig(max_retries=5)
        with use_abft(inner):
            assert ab.current_abft() is inner
        assert ab.current_abft() is cfg
    assert ab.current_abft() is None


def test_stats_reset_and_keys():
    reset_abft_stats()
    assert abft_stats() == {"gemms_verified": 0, "tiles_flagged": 0,
                            "tiles_recovered": 0, "sdc_errors": 0}


# ---------------------------------------------------------------------------
# the kernel wrappers (plain versions on CPU tensors)
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
@pytest.mark.parametrize("activation", ["none", "swiglu"])
@pytest.mark.parametrize("M", [5, 45, 90])  # the three tiles of gemm_tile
def test_kernel_clean_run_bitwise_and_unflagged(dtype, activation, M):
    K, N = 70, 52  # off every tile
    x, w = _t(_rand(0, (M, K)), dtype), _t(_rand(1, (K, N)), dtype)
    wg = _t(_rand(2, (K, N)), dtype) if activation == "swiglu" else None
    kw = dict(epilogue=Epilogue(activation=activation), b_gate=wg, out_dtype=torch.float32)
    plain = mx_matmul_fused(x, w, **kw)
    out, flags = mx_matmul_fused(x, w, abft=abft_spec_for(x, w), **kw)
    bm, bn, _ = _build.gemm_tile(M)
    assert tuple(flags.shape) == (-(-M // bm), -(-N // bn)) and flags.dtype == torch.int32
    assert not flags.any()
    assert torch.equal(out, plain)


def test_kernel_flags_exactly_the_corrupted_tile():
    M = K = N = 128  # 64 x 64 tiles: a 2 x 2 grid
    x, w = _t(_rand(0, (M, K))), _t(_rand(1, (K, N)))
    assert _build.gemm_tile(M)[:2] == (64, 64)
    plain = mx_matmul_fused(x, w)
    fd, fr, fc = build_fault_operands(TileFault(1, 0, 3, 5, BIG), 2, 2, 64, 64)
    out, flags = mx_matmul_fused(x, w, abft=abft_spec_for(x, w, inject=True),
                                 fault_delta=fd, fault_row=fr, fault_col=fc)
    assert flags.tolist() == [[0, 0], [1, 0]]
    diff = (out - plain).abs()
    assert diff[64 + 3, 5] > BIG / 2 and int((diff != 0).sum()) == 1
    with pytest.raises(ValueError, match="iff abft.inject"):
        mx_matmul_fused(x, w, abft=abft_spec_for(x, w), fault_delta=fd, fault_row=fr,
                        fault_col=fc)
    with pytest.raises(ValueError, match="grid"):
        mx_matmul_fused(x, w, abft=abft_spec_for(x, w, inject=True), fault_delta=fd[:1],
                        fault_row=fr[:1], fault_col=fc[:1])


def test_grouped_kernel_ors_the_visits_and_leaves_uncovered_tiles_clean():
    T, K, N, G = 40, 32, 24, 3
    x, w = _t(_rand(0, (T, K))), _t(_rand(1, (G, K, N)))
    sizes = torch.tensor([15, 0, 20])  # tile 0 straddles experts 0 and 2; rows 35+ no group
    bm, bn = _build.grouped_flag_tile(T, G, x.dtype, w.dtype)
    assert (bm, bn) == (32, 64)
    plain = mx_grouped_matmul(x, w, sizes)
    out, flags = mx_grouped_matmul(x, w, sizes, abft=grouped_spec(x, w))
    assert torch.equal(out, plain) and not flags.any()
    for ti in (0, 1):
        fd, fr, fc = build_fault_operands(TileFault(ti, 0, 1, 4, BIG), 2, 1, bm, bn)
        out, flags = mx_grouped_matmul(x, w, sizes, abft=grouped_spec(x, w, inject=True),
                                       fault_delta=fd, fault_row=fr, fault_col=fc)
        assert flags[:, 0].tolist() == [int(ti == 0), int(ti == 1)]
        diff = (out - plain).abs()  # rows 1 and 33 are owned (groups 0 and 2)
        assert diff[ti * bm + 1, 4] > BIG / 2 and int((diff != 0).sum()) == 1
    # a tile no group covers stores zeros and flag 0, faulted or not
    fd, fr, fc = build_fault_operands(TileFault(1, 0, 3, 4, BIG), 2, 1, bm, bn)
    out, flags = mx_grouped_matmul(x, w, torch.tensor([15, 0, 10]),
                                   abft=grouped_spec(x, w, inject=True),
                                   fault_delta=fd, fault_row=fr, fault_col=fc)
    assert flags[1, 0] == 0 and not out[32:].any()


# ---------------------------------------------------------------------------
# the dispatch: detection, bitwise recovery, the typed error
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("activation", ["none", "gelu", "swiglu"])
def test_linear_detects_and_recovers_bitwise(activation):
    reset_abft_stats()
    xn, wn, wgn = _rand(0, (48, 64)), _rand(1, (64, 48)), _rand(2, (64, 48))
    x, w = _t(xn), _t(wn)
    wg = _t(wgn) if activation == "swiglu" else None
    kw = dict(activation=activation, w_gate=wg, policy=MX)
    base = tops.linear(x, w, abft=False, **kw)
    clean = tops.linear(x, w, abft=True, **kw)
    assert torch.equal(clean, base)
    assert abft_stats()["tiles_flagged"] == 0 and abft_stats()["gemms_verified"] == 1
    got = tops.linear(x, w, abft=AbftConfig(fault=TileFault(0, 1, 2, 3, BIG)), **kw)
    assert torch.equal(got, base)
    s = abft_stats()
    assert s["tiles_flagged"] == 1 and s["tiles_recovered"] == 1 and s["sdc_errors"] == 0
    want = jops.linear(jnp.asarray(xn), jnp.asarray(wn), activation=activation,
                       w_gate=jnp.asarray(wgn) if wg is not None else None,
                       policy=J_PALLAS, abft=True)
    _close(got, want)


def test_unrecoverable_corruption_raises_typed_sdc_error():
    reset_abft_stats()
    x, w = _t(_rand(0, (32, 32))), _t(_rand(1, (32, 32)))
    cfg = AbftConfig(max_retries=0, fault=TileFault(0, 0, 0, 0, BIG))
    with pytest.raises(SDCError) as ei:
        tops.linear(x, w, policy=MX, abft=cfg)
    assert ei.value.flagged == ((0, 0),) and ei.value.attempts == 0
    assert "(0, 0)" in str(ei.value)
    assert abft_stats()["sdc_errors"] == 1


def test_ambient_context_arms_and_false_disarms():
    reset_abft_stats()
    x, w = _t(_rand(0, (32, 48))), _t(_rand(1, (48, 32)))
    base = tops.linear(x, w, policy=MX)
    with use_abft(AbftConfig(fault=TileFault(0, 0, 0, 0, BIG))):
        assert torch.equal(tops.linear(x, w, policy=MX), base)
        assert abft_stats()["tiles_flagged"] >= 1
        before = abft_stats()["gemms_verified"]
        tops.linear(x, w, policy=MX, abft=False)   # per-call False wins
        tops.linear(x, w, policy=tops.MXPolicy("torch"))  # the plain backend: no ABFT
        tops.linear(x, w, policy=tops.MXPolicy("cuda_baseline"))  # nor the baseline
        assert abft_stats()["gemms_verified"] == before
        assert torch.equal(tops.matmul(x, w, policy=MX), base)  # raw matmul too
        assert abft_stats()["gemms_verified"] == before + 1


def test_grouped_detects_and_recovers_bitwise():
    reset_abft_stats()
    T, K, N, G = 40, 32, 24, 3
    xn, wn = _rand(0, (T, K)), _rand(1, (G, K, N))
    x, w = _t(xn), _t(wn)
    gs = torch.tensor([15, 0, 25], dtype=torch.int32)  # row tile 0 straddles
    base = tops.grouped_matmul(x, w, gs, policy=MX, abft=False)
    assert torch.equal(tops.grouped_matmul(x, w, gs, policy=MX, abft=True), base)
    assert abft_stats()["tiles_flagged"] == 0
    for ti in (0, 1):  # the straddled tile (two experts) and a plain one
        got = tops.grouped_matmul(x, w, gs, policy=MX,
                                  abft=AbftConfig(fault=TileFault(ti, 0, 3, 4, BIG)))
        assert torch.equal(got, base), ti
    s = abft_stats()
    assert s["tiles_flagged"] == 2 and s["tiles_recovered"] == 2 and s["sdc_errors"] == 0
    with pytest.raises(SDCError, match="grouped tile"):
        tops.grouped_matmul(x, w, gs, policy=MX, activation="swiglu", w_gate=w,
                            abft=AbftConfig(max_retries=0, fault=TileFault(0, 0, 3, 4, BIG)))
    with jops.use_policy(J_PALLAS):
        want = jops.grouped_matmul(jnp.asarray(xn), jnp.asarray(wn), jnp.asarray(gs.numpy()),
                                   abft=True)
    _close(base, want)


# ---------------------------------------------------------------------------
# precision interplay
# ---------------------------------------------------------------------------


def test_int8_exact_path_detects_unit_delta():
    reset_abft_stats()
    x, w = _t(_rand(0, (32, 64))), _t(_rand(1, (64, 32), 0.1))
    kw = dict(precision="int8_all", policy=MX, out_dtype=torch.float32)
    base = tops.linear(x, w, abft=False, **kw)
    got = tops.linear(x, w, abft=AbftConfig(fault=TileFault(0, 0, 3, 4, 1.0)), **kw)
    assert torch.equal(got, base)
    s = abft_stats()
    assert s["tiles_flagged"] == 1 and s["tiles_recovered"] == 1
    # the float path cannot see a unit delta under its rounding tolerance
    reset_abft_stats()
    tops.linear(x, w, abft=AbftConfig(fault=TileFault(0, 0, 3, 4, 1e-3)), policy=MX)
    assert abft_stats()["tiles_flagged"] == 0


@pytest.mark.parametrize("name", ["int8", "int8_tensor", "fp8", "fp8_all", "bf16",
                                  "sparse24", "sparse24_int8"])
def test_quantized_and_sparse_policies_detect_flip_and_recover(name):
    reset_abft_stats()
    xn, wn = _rand(0, (32, 64)), _rand(1, (64, 32), 0.1)
    x, w = _t(xn), _t(wn)
    kw = dict(precision=name, policy=MX, out_dtype=torch.float32)
    base = tops.linear(x, w, abft=False, **kw)
    got = tops.linear(x, w, abft=AbftConfig(fault=TileFault(0, 0, 1, 2, BIG)), **kw)
    assert torch.equal(got, base)
    s = abft_stats()
    assert s["tiles_flagged"] == 1 and s["tiles_recovered"] == 1 and s["sdc_errors"] == 0
    want = jops.linear(jnp.asarray(xn), jnp.asarray(wn), precision=name, policy=J_PALLAS,
                       out_dtype=jnp.float32, abft=True)
    _close(got, want)


def test_sparse_with_abft_expands_before_the_checksummed_launch():
    from repro_torch.kernels.sparse import prune_24

    x, w = _t(_rand(17, (16, 32))), _t(_rand(18, (32, 24), 0.1))
    calls = []
    fused = tops.mx_matmul_fused

    def spy(*a, **k):
        calls.append((k.get("b_sparse", False), k.get("abft") is not None))
        return fused(*a, **k)

    tops.mx_matmul_fused = spy
    try:
        y = tops.linear(x, w, policy=MX, precision="sparse24", abft=AbftConfig())
        y_sparse = tops.linear(x, w, policy=MX, precision="sparse24")
    finally:
        tops.mx_matmul_fused = fused
    assert calls == [(False, True), (True, False)]
    assert torch.equal(y, tops.linear(x, prune_24(w), policy=MX, abft=AbftConfig()))
    assert torch.equal(y, y_sparse)


def test_no_false_positives_across_precision_policies():
    x, w = _t(_rand(0, (48, 64), 3.0)), _t(_rand(1, (64, 48), 0.2))
    for name in (None, "bf16", "int8", "int8_all", "int8_tensor", "fp8", "fp8_all",
                 "sparse24", "sparse24_int8"):
        reset_abft_stats()
        kw = dict(precision=name, policy=MX, out_dtype=torch.float32)
        base = tops.linear(x, w, abft=False, **kw)
        assert torch.equal(tops.linear(x, w, abft=True, **kw), base), name
        s = abft_stats()
        assert s["tiles_flagged"] == 0 and s["gemms_verified"] == 1, (name, s)


@settings(max_examples=20, deadline=None)
@given(m=st.integers(min_value=1, max_value=72), k=st.integers(min_value=8, max_value=96),
       n=st.integers(min_value=8, max_value=72), use_bf16=st.booleans(),
       scale=st.floats(min_value=0.05, max_value=30.0), seed=st.integers(0, 2**16))
def test_float_checksums_never_false_positive(m, k, n, use_bf16, scale, seed):
    dt = torch.bfloat16 if use_bf16 else torch.float32
    x, w = _t(_rand(seed, (m, k), scale), dt), _t(_rand(seed + 1, (k, n), scale), dt)
    plain = mx_matmul_fused(x, w, out_dtype=torch.float32)
    out, flags = mx_matmul_fused(x, w, out_dtype=torch.float32, abft=abft_spec_for(x, w))
    assert not flags.any(), (m, k, n, dt, scale)
    assert torch.equal(out, plain)


# ---------------------------------------------------------------------------
# the batcher
# ---------------------------------------------------------------------------


def _batcher_runs(name, speculate):
    from repro.configs import get_config as j_get_config
    from repro.models import build_model as j_build
    from repro.runtime.batcher import ContinuousBatcher as JBatcher
    from repro.runtime.lifecycle import Request as JRequest
    from repro_torch.configs import get_config
    from repro_torch.models import build_model, from_jax_params
    from repro_torch.runtime.batcher import ContinuousBatcher
    from repro_torch.runtime.lifecycle import Request

    jm = j_build(j_get_config(name))
    jp = jm.init(jax.random.PRNGKey(0))
    cfg = get_config(name)
    tm, tp = build_model(cfg), from_jax_params(jax.tree.map(np.asarray, jp), cfg,
                                               device="cpu")
    rng = np.random.default_rng(3)
    sys_p = rng.integers(0, cfg.vocab, 6)
    trace = [(r, np.concatenate([sys_p, rng.integers(0, cfg.vocab, 1 + r % 3)]).astype(
        np.int32), 5) for r in range(5)]
    kw = dict(batch_slots=2, max_len=24, page_size=4, prefix_cache=True, prefill_chunk=4,
              speculate=speculate)
    jb = JBatcher(jm, jp, paged=True, abft=True, **kw)
    with jops.use_policy(jops.MXPolicy("xla")):
        for rid, prompt, n in trace:
            jb.submit(JRequest(rid=rid, prompt=prompt, max_new=n))
        jfin = jb.run_to_completion()
    runs = {}
    for abft in (True, False):
        reset_abft_stats()
        b = ContinuousBatcher(tm, tp, abft=abft, **kw)
        with tops.use_policy(MX):
            for rid, prompt, n in trace:
                b.submit(Request(rid=rid, prompt=prompt, max_new=n))
            fin = b.run_to_completion()
        runs[abft] = (b, {r: fin[r].output for r in fin}, abft_stats())
    return {r: jfin[r].output for r in jfin}, jb, runs


@pytest.mark.parametrize("speculate", [0, 2])
@pytest.mark.parametrize("name", ["llama3.2-1b-smoke", "grok-1-314b-smoke"])
def test_batcher_abft_streams_equal_jax_and_abft_off(name, speculate):
    jstreams, jb, runs = _batcher_runs(name, speculate)
    b, streams, stats = runs[True]
    assert streams == jstreams == runs[False][1]
    assert b.health_summary()["abft"] == jb.health_summary()["abft"] == {
        "sdc_detected": 0, "sdc_corrected": 0}
    assert runs[False][0].health_summary()["abft"] is None
    assert stats["gemms_verified"] > 0 and stats["tiles_flagged"] == 0
    assert stats["sdc_errors"] == 0
    assert runs[False][2]["gemms_verified"] == 0


def test_abft_host_logits_detects_and_refetches_a_corrupted_copy():
    from repro_torch.configs import get_config
    from repro_torch.models import build_model
    from repro_torch.runtime.batcher import ContinuousBatcher

    cfg = get_config("llama3.2-1b-smoke")
    tm = build_model(cfg)
    b = ContinuousBatcher(tm, tm.init(0, device="cpu"), batch_slots=2, max_len=8,
                          abft=True)
    logits = torch.from_numpy(_rand(5, (2, 3, 11)))
    fetches = []

    def to_host(t):
        host = t.detach().to("cpu", copy=True)
        if not fetches:  # the first transfer flips a bit of row (1, 2)
            host.view(torch.int32)[1, 2, 7] ^= 1 << 22
        fetches.append(1)
        return host

    b._to_host = to_host
    host = b._abft_host_logits(logits)
    assert len(fetches) == 2 and torch.equal(host, logits)
    assert b.health_summary()["abft"] == {"sdc_detected": 1, "sdc_corrected": 1}
    # the checksum is exact and order-free: the same on any copy of the data
    assert torch.equal(b._logit_checksum(logits), b._logit_checksum(logits.clone()))
