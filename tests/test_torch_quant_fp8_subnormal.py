"""The e4m3 round trip where the reference's own bound does not hold.

JAX's `tests/test_quant.py::test_fp8_roundtrip_relative_error` holds every
element's relative e4m3 error to 2^-3.  On seeds 387, 408 and 925 of its
draw (16 x 32, N(0, 1) * 5.0, "tile" scales per column of operand "b")
one element sits about 1e-4 of its column scale from zero, in e4m3's
subnormal range, where the spacing is absolute (2^-9 of the scale), not
relative; the relative error there reaches 0.30-1.0 in both packages.
Here the port's payloads, scales and round trip are pinned bit for bit to
JAX's on those seeds, and the round trip is held to e4m3's own bound: 2^-3
relative where |x| / scale >= 2^-6 (the normal range), at most
scale * 2^-10 absolute below it (half the subnormal spacing)."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro.core.precision import QuantSpec as JQuantSpec  # noqa: E402
from repro.kernels import quant as jq  # noqa: E402
from repro_torch.core.precision import QuantSpec  # noqa: E402
from repro_torch.kernels import quant as tq  # noqa: E402

SEEDS = (387, 408, 925)  # the draws of the reference test that its bound fails


def _draw(seed):
    """The reference test's input: `_rand((16, 32), seed, 5.0)`."""
    return (np.random.default_rng(seed).normal(size=(16, 32)) * 5.0).astype(np.float32)


def _round_trips(seed):
    x = _draw(seed)
    jqv, js = jq.quantize_operand(jnp.asarray(x), JQuantSpec("fp8_e4m3", "tile"), "b")
    tqv, ts = tq.quantize_operand(torch.from_numpy(x), QuantSpec("fp8_e4m3", "tile"), "b")
    return x, (jqv, js, np.asarray(jq.dequantize(jqv, js))), (tqv, ts, tq.dequantize(tqv, ts))


@pytest.mark.parametrize("seed", SEEDS)
def test_fp8_round_trip_bitwise_jax_where_its_relative_bound_fails(seed):
    x, (jqv, js, jd), (tqv, ts, td) = _round_trips(seed)
    assert np.array_equal(np.asarray(jqv.view(jnp.uint8)), tqv.view(torch.uint8).numpy())
    assert np.array_equal(np.asarray(js), ts.numpy())
    assert np.array_equal(jd.view(np.uint32), td.numpy().view(np.uint32))
    # the reference's bound fails on this draw, in both packages alike
    rel = np.abs(jd - x) / (np.abs(x) + 1e-9)
    assert rel.max() > 2.0 ** -3 + 1e-6


@pytest.mark.parametrize("seed", SEEDS)
def test_fp8_round_trip_within_e4m3_bounds(seed):
    x, _, (_, ts, td) = _round_trips(seed)
    s = ts.numpy()  # (1, 32): the column scales
    err = np.abs(td.numpy() - x)
    normal = np.abs(x) / s >= 2.0 ** -6
    assert normal.any() and (~normal).any()
    assert (err[normal] <= 2.0 ** -3 * np.abs(x[normal])).all()
    assert (err <= np.broadcast_to(s * 2.0 ** -10, x.shape))[~normal].all()
