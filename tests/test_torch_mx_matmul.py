"""GEMM parity: the port's plain MX / baseline GEMMs and its dispatch layer
against the JAX Pallas kernels (interpret mode) on the same numpy inputs.

Tolerance: rtol = atol = 1e-5 in f32, the JAX suite's own between
backends (the summation order differs; every product is exact in f32)."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro.core import ops as jops  # noqa: E402
from repro.kernels.baseline_matmul import baseline_matmul as j_baseline  # noqa: E402
from repro.kernels.mx_matmul import Epilogue as JEpilogue  # noqa: E402
from repro.kernels.mx_matmul import mx_matmul_fused as j_fused  # noqa: E402
from repro_torch.core import ops as tops  # noqa: E402
from repro_torch.kernels import mx_matmul as tmm  # noqa: E402
from repro_torch.kernels.baseline_matmul import baseline_matmul as t_baseline  # noqa: E402

TOL = dict(rtol=1e-5, atol=1e-5)
# ragged against every block: M, K, N divide none of bm=8, bk=16, bn=16
M, K, N = 13, 37, 45
BLOCKS = dict(bm=8, bn=16, bk=16)

EPILOGUES = {
    "none": dict(),
    "bias": dict(bias=True),
    "relu": dict(activation="relu"),
    "gelu": dict(activation="gelu"),
    "silu": dict(activation="silu"),
    "swiglu": dict(activation="swiglu"),
    "swiglu_bias": dict(activation="swiglu", bias=True),
    "residual": dict(residual=True),
    "out_scale": dict(out_scale=0.37),
    "all": dict(activation="gelu", bias=True, residual=True, out_scale=1.7),
    "all_swiglu": dict(activation="swiglu", bias=True, residual=True, out_scale=0.5),
}


def _operands(seed, m=M, k=K, n=N):
    rng = np.random.default_rng(seed)
    return dict(a=rng.standard_normal((m, k)).astype(np.float32),
                b=rng.standard_normal((k, n)).astype(np.float32),
                g=rng.standard_normal((k, n)).astype(np.float32),
                bias=rng.standard_normal((n,)).astype(np.float32),
                res=rng.standard_normal((m, n)).astype(np.float32))


@pytest.mark.parametrize("name", sorted(EPILOGUES))
def test_fused_plain_matches_jax_kernel(name):
    kw = EPILOGUES[name]
    x = _operands(1)
    j_ep, t_ep = JEpilogue(**kw), tmm.Epilogue(**kw)
    assert j_ep.n_fused_ops == t_ep.n_fused_ops
    gated = t_ep.has_gate
    want = j_fused(
        jnp.asarray(x["a"]), jnp.asarray(x["b"]), epilogue=j_ep,
        b_gate=jnp.asarray(x["g"]) if gated else None,
        bias=jnp.asarray(x["bias"]) if t_ep.bias else None,
        residual=jnp.asarray(x["res"]) if t_ep.residual else None,
        interpret=True, **BLOCKS)
    T = {k: torch.from_numpy(v) for k, v in x.items()}
    got = tmm.mx_matmul_fused(
        T["a"], T["b"], epilogue=t_ep, b_gate=T["g"] if gated else None,
        bias=T["bias"] if t_ep.bias else None,
        residual=T["res"] if t_ep.residual else None)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


def test_mx_matmul_general_gemm_matches_jax():
    from repro.kernels.mx_matmul import mx_matmul as j_mx

    x = _operands(2)
    want = j_mx(jnp.asarray(x["a"]), jnp.asarray(x["b"]), jnp.asarray(x["res"]),
                interpret=True, **BLOCKS)
    got = tmm.mx_matmul(torch.from_numpy(x["a"]), torch.from_numpy(x["b"]),
                        torch.from_numpy(x["res"]))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


@pytest.mark.parametrize("out_dtype", ["float32", "bfloat16"])
def test_baseline_plain_matches_jax_kernel(out_dtype):
    """bf16 output rounds the partial sum after every bk chunk of K: the
    same bk gives the same rounding points as the JAX kernel."""
    x = _operands(3, m=9, k=70, n=20)
    bk = 16
    want = j_baseline(jnp.asarray(x["a"]), jnp.asarray(x["b"]), bm=8, bn=16, bk=bk,
                      out_dtype=jnp.dtype(out_dtype), interpret=True)
    got = t_baseline(torch.from_numpy(x["a"]), torch.from_numpy(x["b"]), bk=bk,
                     out_dtype=getattr(torch, out_dtype))
    want32 = np.asarray(want.astype(jnp.float32))
    got32 = got.float().numpy()
    if out_dtype == "float32":
        np.testing.assert_allclose(got32, want32, **TOL)
    else:
        # one bf16 ulp where f32 summation order flips a rounding
        np.testing.assert_allclose(got32, want32, rtol=8e-3, atol=8e-3)
        assert np.mean(got32 == want32) > 0.95


@pytest.mark.parametrize("out_dtype", ["float32", "bfloat16"])
def test_matmul_ref_matches_jax(out_dtype):
    from repro.kernels.ref import matmul_ref as j_ref
    from repro_torch.kernels.ref import matmul_ref as t_ref

    x = _operands(6)
    want = j_ref(jnp.asarray(x["a"]), jnp.asarray(x["b"]), out_dtype=jnp.dtype(out_dtype))
    got = t_ref(torch.from_numpy(x["a"]), torch.from_numpy(x["b"]),
                out_dtype=getattr(torch, out_dtype))
    assert got.dtype == getattr(torch, out_dtype)
    # bf16: one ulp where the f32 summation order flips a rounding
    tol = TOL if out_dtype == "float32" else dict(rtol=8e-3, atol=8e-3)
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want.astype(jnp.float32)), **tol)


JAX_POLICY = jops.MXPolicy("pallas_mx", interpret=True, bm=16, bn=32, bk=16)


@pytest.mark.parametrize("backend", ["torch", "cuda_mx"])
def test_linear_module_matches_jax(backend):
    """The `Linear` module (bias on) with the same weights in both packages."""
    import jax

    from repro.models.layers import Linear as JLinear
    from repro_torch.models.layers import Linear as TLinear

    params = jax.tree.map(np.asarray, JLinear(24, 40, bias=True).init(jax.random.PRNGKey(0)))
    params["b"] = np.random.default_rng(7).standard_normal(40).astype(np.float32)
    x = np.random.default_rng(8).standard_normal((2, 5, 24)).astype(np.float32)
    with jops.use_policy(JAX_POLICY):
        want = JLinear(24, 40, bias=True)({k: jnp.asarray(v) for k, v in params.items()},
                                          jnp.asarray(x))
    with tops.use_policy(tops.MXPolicy(backend)):
        got = TLinear(24, 40, bias=True)({k: torch.tensor(v) for k, v in params.items()},
                                         torch.from_numpy(x))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


@pytest.mark.parametrize("backend", ["torch", "cuda_mx", "cuda_baseline"])
@pytest.mark.parametrize("case", ["plain", "bias_residual_3d", "swiglu", "gelu"])
def test_ops_linear_matches_jax(backend, case):
    """Port `ops.linear` on every backend (CPU tensors: the CUDA backends'
    wrappers take their plain versions) against JAX `ops.linear` through
    the Pallas MX kernel."""
    rng = np.random.default_rng(4)
    lead = (2, 5) if case == "bias_residual_3d" else (11,)
    x = rng.standard_normal((*lead, 24)).astype(np.float32)
    w = rng.standard_normal((24, 40)).astype(np.float32)
    kw_j, kw_t = {}, {}
    if case == "bias_residual_3d":
        b = rng.standard_normal((40,)).astype(np.float32)
        r = rng.standard_normal((*lead, 40)).astype(np.float32)
        kw_j = dict(b=jnp.asarray(b), residual=jnp.asarray(r))
        kw_t = dict(b=torch.from_numpy(b), residual=torch.from_numpy(r))
    elif case == "swiglu":
        g = rng.standard_normal((24, 40)).astype(np.float32)
        kw_j = dict(activation="swiglu", w_gate=jnp.asarray(g))
        kw_t = dict(activation="swiglu", w_gate=torch.from_numpy(g))
    elif case == "gelu":
        kw_j = kw_t = dict(activation="gelu", out_scale=0.25)
    with jops.use_policy(JAX_POLICY):
        want = jops.linear(jnp.asarray(x), jnp.asarray(w), **kw_j)
    with tops.use_policy(tops.MXPolicy(backend)):
        got = tops.linear(torch.from_numpy(x), torch.from_numpy(w), **kw_t)
    assert tuple(got.shape) == tuple(want.shape)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


@pytest.mark.parametrize("backend", ["torch", "cuda_mx", "cuda_baseline"])
def test_ops_matmul_matches_jax(backend):
    rng = np.random.default_rng(5)
    a = rng.standard_normal((3, 7, 33)).astype(np.float32)
    b = rng.standard_normal((33, 19)).astype(np.float32)
    with jops.use_policy(JAX_POLICY):
        want = jops.matmul(jnp.asarray(a), jnp.asarray(b))
    got = tops.matmul(torch.from_numpy(a), torch.from_numpy(b),
                      policy=tops.MXPolicy(backend))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


def test_default_backend_is_torch_on_cpu():
    assert tops.MXPolicy().resolve(torch.zeros(1)) == "torch"
    with pytest.raises(ValueError):
        tops.MXPolicy("xla")


@pytest.mark.parametrize("bad", [
    dict(b_sparse=True),
    dict(b_sparse=True, activation="swiglu"),
    dict(abft=True),
    dict(abft=True, inject=True),
])
def test_kernel_unported_arguments_raise(bad):
    """The 2:4 and ABFT slots raised while unported; now each case matches
    JAX's kernel (interpret mode) on the same inputs: the 2:4 payload and
    metadata (gated too), and the ABFT flag map with and without a fault at
    tile (0, 0), element (0, 0) (the tiles differ between the packages, that
    tile and element do not).  A slot given without its partner raises
    ValueError, as in JAX."""
    from repro.kernels import abft as jab
    from repro.kernels import sparse as jsp
    from repro_torch.kernels import abft as tab
    from repro_torch.kernels import sparse as tsp

    rng = np.random.default_rng(3)
    Kp = 40  # the 2:4 wire format tiles K in 8s
    a = rng.standard_normal((M, Kp)).astype(np.float32)
    b = (rng.standard_normal((Kp, N)) * 0.2).astype(np.float32)
    bg = (rng.standard_normal((Kp, N)) * 0.2).astype(np.float32)
    gated = bad.get("activation") == "swiglu"
    ep, jep = tmm.Epilogue(activation=bad.get("activation", "none")), JEpilogue(
        activation=bad.get("activation", "none"))
    ta, tb, tg = (torch.from_numpy(t) for t in (a, b, bg))
    if bad.get("b_sparse"):
        (pb, mb), (pg, mg) = (tsp.compress_24(tsp.prune_24(t)) for t in (tb, tg))
        got = tmm.mx_matmul_fused(ta, pb, epilogue=ep, b_gate=pg if gated else None,
                                  b_sparse=True, b_meta=mb, bg_meta=mg if gated else None)
        (jpb, jmb), (jpg, jmg) = (jsp.compress_24(jsp.prune_24(jnp.asarray(t)))
                                  for t in (b, bg))
        want = j_fused(jnp.asarray(a), jpb, epilogue=jep, b_gate=jpg if gated else None,
                       b_sparse=True, b_meta=jmb, bg_meta=jmg if gated else None,
                       bm=8, bn=16, bk=16, interpret=True)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
        with pytest.raises(ValueError, match="iff b_sparse"):
            tmm.mx_matmul_fused(ta, pb, b_sparse=True)
        with pytest.raises(ValueError, match="iff b_sparse"):
            tmm.mx_matmul_fused(ta, tb, b_meta=mb)
        return
    inject = bad.get("inject", False)
    spec = tmm.abft_spec_for(ta, tb, inject=inject)
    kw = {}
    jspec = jab.make_abft_spec(jnp.float32, jnp.float32, Kp, 8, 16, inject=inject)
    jkw = {}
    if inject:
        fault = tab.TileFault(0, 0, 0, 0, 2.0 ** 16)
        bm, bn, _ = tmm._build.gemm_tile(M)
        kw = dict(zip(("fault_delta", "fault_row", "fault_col"),
                      tab.build_fault_operands(fault, -(-M // bm), -(-N // bn), bm, bn)))
        jkw = dict(zip(("fault_delta", "fault_row", "fault_col"),
                       jab.build_fault_operands(jab.TileFault(0, 0, 0, 0, 2.0 ** 16),
                                                2, 3, 8, 16)))
    got, flags = tmm.mx_matmul_fused(ta, tb, abft=spec, **kw)
    want, jflags = j_fused(jnp.asarray(a), jnp.asarray(b), abft=jspec, bm=8, bn=16, bk=16,
                           interpret=True, **jkw)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    assert int(flags.sum()) == int(np.asarray(jflags).sum()) == int(inject)
    assert int(flags[0, 0]) == int(np.asarray(jflags)[0, 0]) == int(inject)
    zeros = dict(fault_delta=torch.zeros(1, 3), fault_row=torch.zeros(1, 3, dtype=torch.int32),
                 fault_col=torch.zeros(1, 3, dtype=torch.int32))
    with pytest.raises(ValueError, match="iff abft.inject"):  # faults without inject, or
        tmm.mx_matmul_fused(ta, tb, abft=spec, **({} if inject else zeros))  # the reverse


@pytest.mark.parametrize("bad", [dict(precision="sparse24"), dict(abft=True)])
def test_ops_unported_arguments_raise(bad):
    """Raised while 2:4 and ABFT were unported; now linear and matmul take
    them on every backend and match JAX's Pallas path (interpret mode)."""
    rng = np.random.default_rng(4)
    x = rng.standard_normal((4, 16)).astype(np.float32)
    w = rng.standard_normal((16, 6)).astype(np.float32)
    pol = jops.MXPolicy("pallas_mx", interpret=True, **BLOCKS)
    for backend in tops.BACKENDS:
        p = tops.MXPolicy(backend)
        got = tops.linear(torch.from_numpy(x), torch.from_numpy(w), policy=p, **bad)
        np.testing.assert_allclose(
            got.numpy(), np.asarray(jops.linear(jnp.asarray(x), jnp.asarray(w), policy=pol,
                                                **bad)), **TOL)
        got = tops.matmul(torch.from_numpy(x), torch.from_numpy(w), policy=p, **bad)
        np.testing.assert_allclose(
            got.numpy(), np.asarray(jops.matmul(jnp.asarray(x), jnp.asarray(w), policy=pol,
                                                **bad)), **TOL)


def test_tp_mode_is_inert_without_a_process_group():
    x, w = torch.ones(4, 8), torch.ones(8, 6)
    out = tops.linear(x, w, tp_mode="allgather")
    assert torch.equal(out, torch.full((4, 6), 8.0))
    with pytest.raises(ValueError):
        tops.linear(x, w, tp_mode="bogus")
