"""Precision metadata and operand quantization: the port's `core/precision.py`
and `kernels/quant.quantize_operand` against the JAX package's.

The registry, the context semantics ("none" falls through to the ambient
context, "f32" forces full precision) and the calibration mirror JAX; the
payloads and scales of every named policy's operands, per row, per column,
per tensor and per expert, are BITWISE equal to JAX's on the same numpy
inputs (both packages quantize with the same f32 arithmetic), and so is a
per-routing-group tensor scale against JAX quantizing one group per call."""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro.core import ops as jops  # noqa: E402
from repro.core import precision as jprec  # noqa: E402
from repro.kernels.quant import quantize_operand as j_quantize_operand  # noqa: E402
from repro_torch.core import ops as tops  # noqa: E402
from repro_torch.core import precision as tprec  # noqa: E402
from repro_torch.kernels.quant import quantize_operand  # noqa: E402

QUANTIZING = ["bf16", "int8", "int8_all", "int8_tensor", "fp8", "fp8_all"]


def _spec_tuple(s):
    return None if s is None else (s.dtype, s.granularity, s.static_scale)


def _policy_tuple(p):
    if p is None:
        return None
    return (_spec_tuple(p.a), _spec_tuple(p.b), p.acc, p.out,
            None if p.b_sparse is None else p.b_sparse.kind)


def _bits(t: torch.Tensor) -> np.ndarray:
    """The payload's bits (numpy has no bf16 / fp8, torch.equal no fp8 on
    the CPU): narrow floats viewed as integers of their width."""
    t = t.contiguous()
    if t.dtype == torch.float8_e4m3fn:
        return t.view(torch.uint8).numpy()
    if t.dtype == torch.bfloat16:
        return t.view(torch.int16).numpy()
    return t.numpy()


def _jbits(a) -> np.ndarray:
    a = np.asarray(a)
    if a.dtype.name == "float8_e4m3fn":
        return a.view(np.uint8)
    if a.dtype.name == "bfloat16":
        return a.view(np.int16)
    return a


def test_registry_mirrors_jax():
    assert list(tprec.NAMED_POLICIES) == list(jprec.NAMED_POLICIES)
    for name, p in tprec.NAMED_POLICIES.items():
        j = jprec.NAMED_POLICIES[name]
        assert _policy_tuple(p) == _policy_tuple(j), name
        if p is None:
            continue
        assert p.any_quantized == j.any_quantized
        for dts in ((torch.float32, jnp.float32), (torch.bfloat16, jnp.bfloat16)):
            assert p.is_noop_for(dts[0], dts[0]) == j.is_noop_for(dts[1], dts[1]), name
        for spec_t, spec_j in ((p.a, j.a), (p.b, j.b)):
            assert spec_t.bytes_for(4) == spec_j.bytes_for(4)
    out = tprec.PrecisionPolicy(b=tprec.QuantSpec("int8"), out="bf16")
    assert out.out_torch_dtype == torch.bfloat16
    assert tprec.NAMED_POLICIES["f32"].out_torch_dtype is None


def test_policy_validation_mirrors_jax():
    for mod in (tprec, jprec):
        with pytest.raises(ValueError, match="accumulation"):
            mod.PrecisionPolicy(acc="bf16")
        with pytest.raises(ValueError, match="out dtype"):
            mod.PrecisionPolicy(out="f16")
        with pytest.raises(ValueError, match="sparsity"):
            mod.SparsitySpec("1:2")
        with pytest.raises(ValueError, match="unknown precision"):
            mod.resolve_precision("int4")
    p = tprec.NAMED_POLICIES["int8"]
    assert tprec.resolve_precision(p) is p
    assert tprec.resolve_precision(None) is None
    assert tprec.resolve_precision("none") is None
    assert tprec.resolve_precision("f32") == tprec.PrecisionPolicy()
    assert hash(p) == hash(dataclasses.replace(p))


@pytest.mark.parametrize("ambient", [None, "int8_all"])
@pytest.mark.parametrize("declared", [None, "none", "f32", "int8", "fp8"])
def test_ambient_context_semantics_match_jax(declared, ambient):
    """Explicit declarations win; None and "none" fall through to the
    ambient context; "f32" is an identity policy that forces full
    precision and is then dropped as a no-op."""
    with tprec.use_precision(ambient), jprec.use_precision(ambient):
        t = tops._ambient_precision(declared)
        j = jops._ambient_precision(declared)
        assert _policy_tuple(t) == _policy_tuple(j)
        te = tops._effective_precision(t, torch.float32, torch.float32)
        je = jops._effective_precision(j, jnp.float32, jnp.float32)
        assert _policy_tuple(te) == _policy_tuple(je)
        assert _policy_tuple(tprec.current_precision()) == \
            _policy_tuple(jprec.current_precision())


def test_use_precision_nests_and_restores():
    assert tprec.current_precision() is None
    with tprec.use_precision("int8") as outer:
        assert outer is tprec.NAMED_POLICIES["int8"]
        with tprec.use_precision("fp8_all"):
            assert tprec.current_precision() is tprec.NAMED_POLICIES["fp8_all"]
        assert tprec.current_precision() is outer
        with pytest.raises(RuntimeError), tprec.use_precision("bf16"):
            raise RuntimeError("boom")
        assert tprec.current_precision() is outer
    assert tprec.current_precision() is None


@pytest.mark.parametrize("margin", [1.0, 1.25])
@pytest.mark.parametrize("dtype", ["int8", "fp8_e4m3"])
def test_calibrate_static_scale_matches_jax(dtype, margin):
    rng = np.random.default_rng(3)
    samples = [rng.standard_normal((4, 16)).astype(np.float32) * s for s in (1, 7, 3)]
    t = tprec.calibrate_static_scale(tprec.QuantSpec(dtype), samples, margin=margin)
    j = jprec.calibrate_static_scale(jprec.QuantSpec(dtype), samples, margin=margin)
    assert t.static_scale == j.static_scale and t.dtype == dtype
    zero = tprec.calibrate_static_scale(tprec.QuantSpec("int8"), [np.zeros(3)])
    assert zero.static_scale == 1.0
    with pytest.raises(ValueError, match="cast-only"):
        tprec.calibrate_static_scale(tprec.QuantSpec("bf16"), samples)
    with pytest.raises(ValueError, match="margin"):
        tprec.calibrate_static_scale(tprec.QuantSpec("int8"), samples, margin=0)


def _operands(seed):
    rng = np.random.default_rng(seed)
    a = rng.standard_normal((2, 9, 40)).astype(np.float32)
    a[0, 3] = 0.0  # an all-zero row: scale 1.0
    a[1, 2, :4] = [900.0, -1e-3, 0.5, -7.0]  # one row with a wide range
    b = (rng.standard_normal((40, 24)) * 0.2).astype(np.float32)
    b[:, 5] = 0.0  # an all-zero column
    stack = (rng.standard_normal((3, 40, 24)) * 0.1).astype(np.float32)
    stack[1] *= 30.0  # one expert far wider than the others
    return a, b, stack


@pytest.mark.parametrize("name", QUANTIZING)
def test_quantize_operand_bitwise_equal_to_jax(name):
    """Every named policy's A (per row, 3-D activations), B (per column)
    and expert stack (per expert and column, or one amax over the stack)
    payloads and scales, against JAX's, bit for bit."""
    pol_t, pol_j = tprec.NAMED_POLICIES[name], jprec.NAMED_POLICIES[name]
    a, b, stack = _operands(0)
    for x, operand in ((a, "a"), (b, "b"), (stack, "b"), (a[0], "a")):
        spec_t = pol_t.a if operand == "a" else pol_t.b
        spec_j = pol_j.a if operand == "a" else pol_j.b
        tq, ts = quantize_operand(torch.from_numpy(x), spec_t, operand)
        jq, js = j_quantize_operand(jnp.asarray(x), spec_j, operand)
        assert str(tq.dtype).removeprefix("torch.") == str(jq.dtype)
        np.testing.assert_array_equal(_bits(tq), _jbits(jq))
        if js is None:
            assert ts is None
        else:
            assert tuple(ts.shape) == tuple(js.shape)
            np.testing.assert_array_equal(ts.numpy(), np.asarray(js))


def test_quantize_operand_cast_only_and_identity():
    x = torch.randn(4, 8)
    same, s = quantize_operand(x, tprec.QuantSpec("f32"), "a")
    assert same is x and s is None
    bf, s = quantize_operand(x, tprec.QuantSpec("bf16"), "b")
    assert bf.dtype == torch.bfloat16 and s is None
    with pytest.raises(ValueError, match="operand"):
        quantize_operand(x, tprec.QuantSpec("int8"), "c")


@pytest.mark.parametrize("spec", [tprec.QuantSpec("int8", "tensor"),
                                  tprec.QuantSpec("fp8_e4m3", "tensor")])
def test_row_groups_take_one_amax_per_routing_group(spec):
    """The MoE's expert-major buffer (E, R, C) rows: one tensor scale per
    routing group g equals JAX quantizing group g's (E*C) rows alone."""
    E, R, C, D = 3, 4, 5, 16
    rng = np.random.default_rng(4)
    buf = rng.standard_normal((R, E, C, D)).astype(np.float32)  # JAX's (G, E, C, D)
    buf *= np.array([1.0, 40.0, 0.01, 3.0], np.float32)[:, None, None, None]
    buf[2, 1] = 0.0
    xe = torch.from_numpy(np.ascontiguousarray(buf.transpose(1, 0, 2, 3))).reshape(-1, D)
    tq, ts = quantize_operand(xe, spec, "a", row_groups=(E, R, C))
    assert tuple(ts.shape) == (E * R * C, 1)
    jspec = jprec.QuantSpec(spec.dtype, "tensor")
    for g in range(R):
        jq, js = j_quantize_operand(jnp.asarray(buf[g].reshape(E * C, D)), jspec, "a")
        rows = torch.arange(E * R * C).reshape(E, R, C)[:, g].reshape(-1)
        np.testing.assert_array_equal(_bits(tq[rows]), _jbits(jq))
        np.testing.assert_array_equal(ts[rows].numpy(), np.asarray(js))
    # a static scale ignores the groups, as it ignores the amax
    st = dataclasses.replace(spec, static_scale=0.05)
    q1, s1 = quantize_operand(xe, st, "a", row_groups=(E, R, C))
    q2, s2 = quantize_operand(xe, st, "a")
    np.testing.assert_array_equal(_bits(q1), _bits(q2))
    np.testing.assert_array_equal(s1.numpy(), s2.numpy())


def test_static_scale_rides_quantize_operand_like_jax():
    a, b, stack = _operands(5)
    for gran in ("tile", "tensor"):
        for operand, x in (("a", a), ("b", b), ("b", stack)):
            t = tprec.QuantSpec("int8", gran, static_scale=0.01)
            j = jprec.QuantSpec("int8", gran, static_scale=0.01)
            tq, ts = quantize_operand(torch.from_numpy(x), t, operand)
            jq, js = j_quantize_operand(jnp.asarray(x), j, operand)
            np.testing.assert_array_equal(tq.numpy(), np.asarray(jq))
            np.testing.assert_array_equal(ts.numpy(), np.asarray(js))
