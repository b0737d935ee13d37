"""2:4 structured sparsity in the port against the JAX package, on the same
numpy inputs.

- The wire format (`kernels/sparse.py`): `prune_24`, `compress_24` and
  `expand_24` byte-equal to JAX's, ties to the lower K position, the fixed
  point prune(prune(w)) == prune(w), f32 / bf16 / int8, (G, K, N) stacks,
  the K % 4 / K % 8 errors.
- The sparse dispatch (`core/ops.py`): `linear`, `matmul` and
  `grouped_matmul` under "sparse24" / "sparse24_int8" against JAX's xla
  reference and its Pallas kernels in interpret mode, within 1e-5 *
  max|ref| (f32 sums in another order); bitwise against the dense-masked
  (pruned) weight within the port, as JAX's own tests are bitwise
  (tests/test_sparse.py); the K % 8 != 0 dense-masked fallback; the kept
  compressed payload reused, then rebuilt after an in-place update; an MoE
  layer with sparse experts.

The port's CUDA backends run here on CPU tensors, so "cuda_mx" exercises
the dispatch through the kernel wrappers' plain versions (`expand_24` then
the dense plain GEMM); the on-card kernels are held by
tests/test_torch_cuda.py and chip_smoke.py."""
import dataclasses

import numpy as np
import pytest
from hypothesis import given, settings, strategies as st

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.core import ops as jops  # noqa: E402
from repro.core.precision import PrecisionPolicy as JPolicy  # noqa: E402
from repro.core.precision import QuantSpec as JQuantSpec  # noqa: E402
from repro.core.precision import SparsitySpec as JSparsity  # noqa: E402
from repro.kernels import sparse as jsp  # noqa: E402
from repro.models.moe import MoE as JMoE  # noqa: E402
from repro_torch.core import ops as tops  # noqa: E402
from repro_torch.core.precision import (PrecisionPolicy, QuantSpec,  # noqa: E402
                                        SparsitySpec, use_precision)
from repro_torch.kernels import _build  # noqa: E402
from repro_torch.kernels import mx_matmul as tmm  # noqa: E402
from repro_torch.kernels import sparse as tsp  # noqa: E402
from repro_torch.kernels.mx_grouped_matmul import mx_grouped_matmul  # noqa: E402
from repro_torch.models.moe import MoE  # noqa: E402

JAX_POLICIES = {"xla": jops.MXPolicy("xla"),
                "pallas_mx": jops.MXPolicy("pallas_mx", bm=32, bn=32, bk=32,
                                           interpret=True)}
SPARSE = ["sparse24", "sparse24_int8"]
INT8_SPARSE = PrecisionPolicy(a=QuantSpec("int8"), b=QuantSpec("int8"),
                              b_sparse=SparsitySpec())
INT8_DENSE = PrecisionPolicy(a=QuantSpec("int8"), b=QuantSpec("int8"))
J_INT8_SPARSE = JPolicy(a=JQuantSpec("int8", "tile"), b=JQuantSpec("int8", "tile"),
                        b_sparse=JSparsity())
DTYPES = {"float32": (np.float32, torch.float32, jnp.float32),
          "bfloat16": (np.float32, torch.bfloat16, jnp.bfloat16),
          "int8": (np.int8, torch.int8, jnp.int8)}


def _rand(shape, seed, scale=1.0):
    return (np.random.default_rng(seed).standard_normal(shape) * scale).astype(np.float32)


def _weight(shape, seed, dtype):
    """Weights with ties, all-zero groups and groups of one nonzero."""
    np_dt, t_dt, j_dt = DTYPES[dtype]
    rng = np.random.default_rng(seed)
    w = (rng.integers(-3, 4, shape) if np_dt == np.int8
         else rng.standard_normal(shape)).astype(np.float32)
    w[..., 0:4, 0] = 1.0                       # a four-way tie
    w[..., 4:8, 0] = np.array([0, -2, 2, 0])   # |.| tie of a pair
    w[..., 8:12, 0] = 0                        # an all-zero group
    w[..., 12:16, 0] = np.array([0, 0, -1, 0])  # one nonzero
    return torch.from_numpy(w).to(t_dt), jnp.asarray(w).astype(j_dt)


def _bits(a):
    a = np.asarray(a.float() if isinstance(a, torch.Tensor) else jnp.asarray(a, jnp.float32))
    return a.view(np.uint32) if a.dtype == np.float32 else a


def _close(got, ref, rel=1e-5):
    ref = np.asarray(ref, np.float32)
    err = np.abs(np.asarray(got, np.float32) - ref).max()
    assert err <= rel * np.abs(ref).max(), (err, np.abs(ref).max())


# ---------------------------------------------------------------------------
# the wire format
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("shape", [(16, 8), (24, 3), (3, 32, 5)])
@pytest.mark.parametrize("dtype", sorted(DTYPES))
def test_wire_format_byte_equal_to_jax(dtype, shape):
    tw, jw = _weight(shape, 1, dtype)
    tp, jp = tsp.prune_24(tw), jsp.prune_24(jw)
    assert tp.dtype == tw.dtype and np.array_equal(_bits(tp), _bits(jp))
    (tpl, tm), (jpl, jm) = tsp.compress_24(tp), jsp.compress_24(jp)
    assert tm.dtype == torch.uint8 and tuple(tm.shape) == tuple(jm.shape)
    assert np.array_equal(tm.numpy(), np.asarray(jm))
    assert tpl.dtype == tw.dtype and np.array_equal(_bits(tpl), _bits(jpl))
    te, je = tsp.expand_24(tpl, tm), jsp.expand_24(jpl, jm)
    assert np.array_equal(_bits(te), _bits(je))
    assert torch.equal(te, tp)  # the round trip is exact


def test_prune_ties_go_to_the_lower_position_and_prune_is_a_fixed_point():
    tw, _ = _weight((16, 4), 2, "float32")
    p = tsp.prune_24(tw)
    assert p[0:4, 0].tolist() == [1.0, 1.0, 0.0, 0.0]
    assert p[4:8, 0].tolist() == [0.0, -2.0, 2.0, 0.0]
    assert torch.equal(tsp.prune_24(p), p)
    meta = tsp.compress_24(p)[1]
    # group 0 keeps (0, 1): nibble 0b0100; group 1 keeps (1, 2): 0b1001
    assert int(meta[0, 0]) == (0 | 1 << 2) | ((1 | 2 << 2) << 4)


@settings(max_examples=20, deadline=None)
@given(k_groups=st.integers(min_value=1, max_value=6), n=st.sampled_from([1, 3, 8, 17]),
       dtype=st.sampled_from(sorted(DTYPES)), seed=st.integers(0, 2**31 - 1))
def test_roundtrip_exact_and_equal_to_jax(k_groups, n, dtype, seed):
    tw, jw = _weight((8 * k_groups + 8, n), seed, dtype)
    tp = tsp.prune_24(tw)
    tpl, tm = tsp.compress_24(tp)
    assert torch.equal(tsp.expand_24(tpl, tm), tp)
    jpl, jm = jsp.compress_24(jsp.prune_24(jw))
    assert np.array_equal(tm.numpy(), np.asarray(jm))
    assert np.array_equal(_bits(tpl), _bits(jpl))


def test_wire_format_rejects_bad_k():
    with pytest.raises(ValueError, match="divisible by 4"):
        tsp.prune_24(torch.ones(6, 3))
    with pytest.raises(ValueError, match="divisible by 8"):
        tsp.compress_24(torch.ones(12, 3))
    with pytest.raises(ValueError, match="metadata shape"):
        tsp.expand_24(torch.ones(8, 3), torch.zeros(1, 3, dtype=torch.uint8))


def test_sparse_bytes_per_element_equal_jax():
    for size in (1, 2, 4):
        assert tsp.sparse_b_bytes_per_elem(size) == jsp.sparse_b_bytes_per_elem(size)
    assert tsp.sparse_b_bytes_per_elem(4) / 4 == 0.53125
    assert tsp.sparse_b_bytes_per_elem(1) / 4 == 0.15625


@pytest.mark.parametrize("dt,gran", [("f32", "tile"), ("bf16", "tile"), ("int8", "tile"),
                                     ("int8", "tensor")])
def test_stack_operand_equals_jax_whole_stack_pipeline(dt, gran):
    """prune -> quantize -> compress on a (G, K, N) stack, one expert at a
    time in the port, is JAX's pipeline on the whole stack, byte for byte."""
    from repro.kernels.quant import quantize_operand as j_quantize_operand

    w = _rand((3, 32, 12), 3)
    payload, scale, meta = tops._sparse_operand(torch.from_numpy(w), QuantSpec(dt, gran))
    jq, js = j_quantize_operand(jsp.prune_24(jnp.asarray(w)), JQuantSpec(dt, gran), "b")
    jpl, jm = jsp.compress_24(jq)
    assert np.array_equal(meta.numpy(), np.asarray(jm))
    assert np.array_equal(_bits(payload), _bits(jpl))
    if js is None:
        assert scale is None
    else:
        assert np.array_equal(scale.numpy(), np.asarray(js, np.float32))


# ---------------------------------------------------------------------------
# the dispatch
# ---------------------------------------------------------------------------


def _inputs(seed, M=19, K=72, N=45):
    rng = np.random.default_rng(seed)
    return dict(x=rng.standard_normal((2, M, K)).astype(np.float32),
                w=(rng.standard_normal((K, N)) * 0.1).astype(np.float32),
                wg=(rng.standard_normal((K, N)) * 0.1).astype(np.float32),
                b=rng.standard_normal((N,)).astype(np.float32),
                res=rng.standard_normal((2, M, N)).astype(np.float32))


@pytest.mark.parametrize("jax_backend", sorted(JAX_POLICIES))
@pytest.mark.parametrize("backend", ["torch", "cuda_mx"])
@pytest.mark.parametrize("act", ["gelu", "swiglu"])
@pytest.mark.parametrize("name", SPARSE)
def test_sparse_linear_matches_jax(name, act, backend, jax_backend):
    d = _inputs(4)
    gated = act == "swiglu"
    kw = dict(activation=act, residual=d["res"], out_scale=0.5)
    with jops.use_policy(JAX_POLICIES[jax_backend]):
        want = jops.linear(jnp.asarray(d["x"]), jnp.asarray(d["w"]), jnp.asarray(d["b"]),
                           w_gate=jnp.asarray(d["wg"]) if gated else None,
                           precision=name, **{**kw, "residual": jnp.asarray(d["res"])})
    got = tops.linear(torch.from_numpy(d["x"]), torch.from_numpy(d["w"]),
                      torch.from_numpy(d["b"]),
                      w_gate=torch.from_numpy(d["wg"]) if gated else None,
                      precision=name, policy=tops.MXPolicy(backend),
                      **{**kw, "residual": torch.from_numpy(d["res"])})
    _close(got, want)
    dense = tops.linear(torch.from_numpy(d["x"]), torch.from_numpy(d["w"]),
                        torch.from_numpy(d["b"]),
                        w_gate=torch.from_numpy(d["wg"]) if gated else None,
                        policy=tops.MXPolicy(backend),
                        **{**kw, "residual": torch.from_numpy(d["res"])})
    assert not torch.allclose(got, dense, rtol=1e-3, atol=1e-3)  # it really pruned


@pytest.mark.parametrize("backend", ["torch", "cuda_mx"])
def test_sparse_matmul_and_ambient_context_match_jax(backend):
    d = _inputs(5)
    x, w = torch.from_numpy(d["x"]), torch.from_numpy(d["w"])
    want = jops.matmul(jnp.asarray(d["x"]), jnp.asarray(d["w"]), precision="sparse24",
                       policy=JAX_POLICIES["xla"])
    pol = tops.MXPolicy(backend)
    _close(tops.matmul(x, w, precision="sparse24", policy=pol), want)
    with use_precision("sparse24_int8"):
        got = tops.linear(x, w, policy=pol)
    _close(got, jops.linear(jnp.asarray(d["x"]), jnp.asarray(d["w"]),
                            precision="sparse24_int8", policy=JAX_POLICIES["xla"]))


@pytest.mark.parametrize("act", ["none", "swiglu"])
def test_sparse_linear_bitwise_vs_dense_masked(act):
    """Within the port, as tests/test_sparse.py pins within JAX: the sparse
    GEMM equals the dense GEMM on the pruned weight bit for bit, and the
    int8 x int8 path is exact."""
    d = _inputs(6)
    x, w, wg = (torch.from_numpy(d[k]) for k in ("x", "w", "wg"))
    gated = act == "swiglu"
    pol = tops.MXPolicy("cuda_mx")
    kw = dict(activation=act, policy=pol)
    got = tops.linear(x, w, w_gate=wg if gated else None, precision="sparse24", **kw)
    ref = tops.linear(x, tsp.prune_24(w), w_gate=tsp.prune_24(wg) if gated else None, **kw)
    assert torch.equal(got, ref)
    got8 = tops.linear(x, w, w_gate=wg if gated else None, precision=INT8_SPARSE, **kw)
    ref8 = tops.linear(x, tsp.prune_24(w), w_gate=tsp.prune_24(wg) if gated else None,
                       precision=INT8_DENSE, **kw)
    assert torch.equal(got8, ref8)
    with jops.use_policy(JAX_POLICIES["pallas_mx"]):
        j8 = jops.linear(jnp.asarray(d["x"]), jnp.asarray(d["w"]),
                         w_gate=jnp.asarray(d["wg"]) if gated else None,
                         activation=act, precision=J_INT8_SPARSE)
    if not gated:  # the int8 x int8 MAC is exact in both packages
        assert np.array_equal(got8.numpy(), np.asarray(j8))
    else:
        _close(got8, j8)


def test_k_unaligned_falls_back_to_dense_pruned():
    """K % 8 != 0: no compression (the wire format cannot tile); the pruned
    weight runs dense-masked, bitwise the dense GEMM on it, as in JAX."""
    x, w = torch.from_numpy(_rand((8, 12), 15)), torch.from_numpy(_rand((12, 16), 16, 0.1))
    pol = tops.MXPolicy("cuda_mx")
    assert tops._sparse_operand(w, QuantSpec())[2] is None
    got = tops.linear(x, w, precision="sparse24", policy=pol)
    assert torch.equal(got, tops.linear(x, tsp.prune_24(w), policy=pol))
    want = jops.linear(jnp.asarray(x.numpy()), jnp.asarray(w.numpy()), precision="sparse24",
                       policy=JAX_POLICIES["pallas_mx"])
    _close(got, want)


def test_kept_sparse_payload_is_reused_then_rebuilt_after_an_update():
    tops.clear_weight_cache()
    x, w = torch.from_numpy(_rand((4, 32), 7)), torch.from_numpy(_rand((32, 6), 8))
    spec, sp = QuantSpec("int8"), SparsitySpec()
    first = tops._weight_operand(w, spec, sp)
    again = tops._weight_operand(w, spec, sp)
    assert all(a is b for a, b in zip(first, again))   # kept, not rebuilt
    dense = tops._weight_operand(w, spec)               # its own key
    assert dense[2] is None and dense[0].shape == w.shape
    y0 = tops.linear(x, w, precision="sparse24_int8", policy=tops.MXPolicy("cuda_mx"))
    w.mul_(-2.0)                                        # an in-place update
    rebuilt = tops._weight_operand(w, spec, sp)
    fresh = tops._sparse_operand(w.clone(), spec)
    assert rebuilt[0] is not first[0]
    assert all(torch.equal(a, b) for a, b in zip(rebuilt, fresh))
    y1 = tops.linear(x, w, precision="sparse24_int8", policy=tops.MXPolicy("cuda_mx"))
    assert not torch.equal(y0, y1)
    tops.clear_weight_cache()


def test_sparse_kernel_arguments_follow_jax_rules():
    a, w = torch.from_numpy(_rand((4, 16), 9)), torch.from_numpy(_rand((16, 6), 10))
    payload, meta = tsp.compress_24(tsp.prune_24(w))
    with pytest.raises(ValueError, match="iff b_sparse"):
        tmm.mx_matmul_fused(a, payload, b_sparse=True)
    with pytest.raises(ValueError, match="inconsistent"):
        tmm.mx_matmul_fused(a, w, b_sparse=True, b_meta=meta)
    with pytest.raises(ValueError, match="uint8"):
        tmm.mx_matmul_fused(a, payload, b_sparse=True, b_meta=meta.to(torch.int32))
    from repro_torch.kernels.abft import make_abft_spec

    with pytest.raises(ValueError, match="compose"):
        tmm.mx_matmul_fused(a, payload, b_sparse=True, b_meta=meta,
                            abft=make_abft_spec(a.dtype, w.dtype, 16, 16, 16))
    out = tmm.mx_matmul_fused(a, payload, b_sparse=True, b_meta=meta)
    assert torch.equal(out, tmm.mx_matmul_fused(a, tsp.prune_24(w)))
    # the 2:4 kernels are built for the pairs the sparse policies produce
    _build.pair_codes(a.bfloat16(), payload.to(torch.int8), "t", sparse=True)
    with pytest.raises(TypeError, match="2:4 sparse"):
        _build.pair_codes(a.to(torch.int8), payload.to(torch.int8), "t", sparse=True)
    with pytest.raises(TypeError, match="2:4 sparse"):
        _build.pair_codes(a.bfloat16(), payload.to(torch.float8_e4m3fn), "t", sparse=True)


# ---------------------------------------------------------------------------
# grouped GEMMs and MoE
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("jax_backend", sorted(JAX_POLICIES))
@pytest.mark.parametrize("act", ["gelu", "swiglu"])
@pytest.mark.parametrize("name", SPARSE)
def test_sparse_grouped_matmul_matches_jax(name, act, jax_backend):
    G, K, N = 3, 32, 24
    sizes = np.array([16, 0, 9], np.int32)  # ragged, an empty expert
    x, w, wg = _rand((25, K), 19), _rand((G, K, N), 20, 0.1), _rand((G, K, N), 21, 0.1)
    gated = act == "swiglu"
    with jops.use_policy(JAX_POLICIES[jax_backend]):
        want = jops.grouped_matmul(jnp.asarray(x), jnp.asarray(w), jnp.asarray(sizes),
                                   activation=act, w_gate=jnp.asarray(wg) if gated else None,
                                   precision=name)
    for backend in ("torch", "cuda_mx"):
        got = tops.grouped_matmul(torch.from_numpy(x), torch.from_numpy(w),
                                  torch.from_numpy(sizes), activation=act,
                                  w_gate=torch.from_numpy(wg) if gated else None,
                                  precision=name, policy=tops.MXPolicy(backend))
        _close(got, want)


def test_sparse_grouped_bitwise_vs_dense_masked_and_kernel_rules():
    G, K, N = 3, 32, 24
    sizes = torch.tensor([16, 0, 9], dtype=torch.int32)
    x, w = torch.from_numpy(_rand((25, K), 22)), torch.from_numpy(_rand((G, K, N), 23, 0.1))
    pol = tops.MXPolicy("cuda_mx")
    got = tops.grouped_matmul(x, w, sizes, precision="sparse24", policy=pol)
    assert torch.equal(got, tops.grouped_matmul(x, tsp.prune_24(w), sizes, policy=pol))
    payload, meta = tsp.compress_24(tsp.prune_24(w))
    assert torch.equal(mx_grouped_matmul(x, payload, sizes, b_sparse=True, w_meta=meta), got)
    with pytest.raises(ValueError, match="iff b_sparse"):
        mx_grouped_matmul(x, payload, sizes, b_sparse=True)
    with pytest.raises(ValueError, match="gate metadata"):
        mx_grouped_matmul(x, payload, sizes, b_sparse=True, w_meta=meta, w_gate=payload,
                          activation="swiglu")
    with pytest.raises(ValueError, match="uint8"):
        mx_grouped_matmul(x, payload, sizes, b_sparse=True, w_meta=meta[:2])


@pytest.mark.parametrize("jax_backend", sorted(JAX_POLICIES))
@pytest.mark.parametrize("groups", [1, 4])
@pytest.mark.parametrize("name", SPARSE)
def test_moe_with_sparse_experts_matches_jax(name, groups, jax_backend):
    """Sparse experts run through grouped_matmul unchanged: the expert-major
    single launch (and, at G = 4, its per-routing-group activation rows)
    composes with the per-expert payloads; the router stays dense."""
    kw = dict(d_model=32, d_ff=48, n_experts=8, top_k=2, n_groups=groups,
              precision=name)
    jm = JMoE(**kw)
    tree = jax.tree.map(np.asarray, jm.init(jax.random.PRNGKey(3)))
    x = _rand((2, 8, 32), 4)
    with jops.use_policy(JAX_POLICIES[jax_backend]):
        jy, jaux = jm(jax.tree.map(jnp.asarray, tree), jnp.asarray(x))
    tm = MoE(**kw)
    tp = {k: torch.from_numpy(np.array(v)) for k, v in tree.items()}
    for backend in ("torch", "cuda_mx"):
        with tops.use_policy(tops.MXPolicy(backend)):
            ty, taux = tm(tp, torch.from_numpy(x))
        _close(ty.numpy(), jy)
        np.testing.assert_allclose(float(taux), float(jaux), rtol=1e-5, atol=1e-5)
    dense, _ = dataclasses.replace(tm, precision=None)(tp, torch.from_numpy(x))
    assert not torch.allclose(dense, ty, rtol=1e-4, atol=1e-4)
