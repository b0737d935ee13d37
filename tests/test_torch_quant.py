"""Symmetric quantization: the port's `compute_scale` / `quantize` /
`dequantize` against the JAX package's on the same numpy inputs.  The int8
payload must be bitwise equal (it is what the KV pages store), the scales
equal to f32 rounding, rounding half to even on exact .5 ties, and an
all-zero row gets scale 1.0."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro.core.precision import QuantSpec as JQuantSpec  # noqa: E402
from repro.kernels import quant as jq  # noqa: E402
from repro_torch.core.precision import DTYPES, QuantSpec  # noqa: E402
from repro_torch.kernels import quant as tq  # noqa: E402


def _rows(seed):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((6, 3, 16)).astype(np.float32) * 3
    x[1, 2] = 0.0  # an all-zero row
    # amax 127 -> scale exactly 1.0, so these land exactly on .5 ties
    x[2, 0, :8] = [127.0, 0.5, 1.5, 2.5, -0.5, -1.5, -2.5, 126.5]
    x[3, 1] = 1e-30  # tiny, non-zero amax
    return x


@pytest.mark.parametrize("axis", [-1, None, 0])
def test_int8_quantize_matches_jax(axis):
    x = _rows(0)
    jp, js = jq.quantize(jnp.asarray(x), JQuantSpec("int8", "tile"), axis=axis)
    tp, ts = tq.quantize(torch.from_numpy(x), QuantSpec("int8", "tile"), axis=axis)
    assert tp.dtype == torch.int8 and ts.dtype == torch.float32
    assert tuple(ts.shape) == np.asarray(js).shape
    np.testing.assert_array_equal(tp.numpy(), np.asarray(jp))
    np.testing.assert_array_equal(ts.numpy(), np.asarray(js))
    np.testing.assert_array_equal(tq.dequantize(tp, ts).numpy(),
                                  np.asarray(jq.dequantize(jp, js)))


def test_ties_round_half_to_even_and_zero_rows():
    x = _rows(1)
    tp, ts = tq.quantize(torch.from_numpy(x), QuantSpec("int8"), axis=-1)
    assert ts[2, 0, 0].item() == 1.0
    assert tp[2, 0, :8].tolist() == [127, 0, 2, 2, 0, -2, -2, 126]
    assert ts[1, 2, 0].item() == 1.0 and torch.all(tp[1, 2] == 0)


@pytest.mark.parametrize("qmax", [127.0, 448.0])
def test_compute_scale_matches_jax(qmax):
    x = _rows(2)
    for axis in (-1, None):
        want = np.asarray(jq.compute_scale(jnp.asarray(x), qmax, axis=axis))
        got = tq.compute_scale(torch.from_numpy(x), qmax, axis=axis).numpy()
        np.testing.assert_array_equal(got, want)


def test_static_scale_and_fp8_match_jax():
    x = _rows(3)
    jp, js = jq.quantize(jnp.asarray(x), JQuantSpec("int8", static_scale=0.02), axis=-1)
    tp, ts = tq.quantize(torch.from_numpy(x), QuantSpec("int8", static_scale=0.02),
                         axis=-1)
    np.testing.assert_array_equal(tp.numpy(), np.asarray(jp))  # saturates at +-127
    np.testing.assert_array_equal(ts.numpy(), np.asarray(js))
    jp, js = jq.quantize(jnp.asarray(x), JQuantSpec("fp8_e4m3"), axis=-1)
    tp, ts = tq.quantize(torch.from_numpy(x), QuantSpec("fp8_e4m3"), axis=-1)
    np.testing.assert_array_equal(tp.float().numpy(), np.asarray(jp).astype(np.float32))


def test_quant_spec_mirrors_jax():
    assert set(DTYPES) == {"f32", "bf16", "int8", "fp8_e4m3"}
    for name in DTYPES:
        t, j = QuantSpec(name), JQuantSpec(name)
        assert (t.qmax, t.quantized, t.bytes_for(4)) == (j.qmax, j.quantized, j.bytes_for(4))
    assert QuantSpec("int8").torch_dtype == torch.int8
    assert not QuantSpec("f32").transforms(torch.float32)
    assert QuantSpec("bf16").transforms(torch.float32)
    with pytest.raises(ValueError):
        QuantSpec("int4")
    with pytest.raises(ValueError):
        QuantSpec("f32", static_scale=1.0)
    with pytest.raises(ValueError, match="cast-only"):
        tq.quantize(torch.ones(2), QuantSpec("f32"))
