"""SSD scan parity: the port's plain `ssd_scan` (the CUDA wrapper's CPU
path), its sequential oracle and `models.ssm.ssd_chunked` against the JAX
Pallas kernel (interpret mode), oracle and batched jnp scan, on the same
numpy inputs.

Tolerance: rtol = atol = 2e-4, tests/test_kernels_ssd.py's own (the
chunked form sums in another order than the sequential scan); the port's
plain forms against each other at 1e-5."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro.kernels.ref import ssd_scan_ref as j_ref  # noqa: E402
from repro.kernels.ssd_scan import ssd_scan as j_scan  # noqa: E402
from repro.models.ssm import ssd_chunked as j_chunked  # noqa: E402
from repro_torch.core import ops  # noqa: E402
from repro_torch.kernels.ref import ssd_scan_plain, ssd_scan_ref  # noqa: E402
from repro_torch.kernels.ssd_scan import ssd_scan  # noqa: E402
from repro_torch.models.ssm import ssd_chunked  # noqa: E402

TOL = dict(rtol=2e-4, atol=2e-4)


def _head(rng, L, P, S, decay=0.2):
    x = rng.standard_normal((L, P)).astype(np.float32)
    a_log = (-np.abs(rng.standard_normal(L)) * decay).astype(np.float32)
    b = (rng.standard_normal((L, S)) * 0.3).astype(np.float32)
    c = (rng.standard_normal((L, S)) * 0.3).astype(np.float32)
    return x, a_log, b, c


def _t(*arrays):
    return [torch.from_numpy(np.ascontiguousarray(a)) for a in arrays]


@pytest.mark.parametrize("L,P,S,chunk", [
    (64, 16, 8, 16),
    (96, 32, 16, 32),
    (50, 8, 8, 32),    # ragged length
    (128, 64, 32, 64),
])
def test_ssd_scan_matches_jax_kernel_and_oracle(L, P, S, chunk):
    """JAX's four kernel cases: the port's scan against the Pallas kernel and
    the exact sequential oracle, and the port's oracle against JAX's."""
    args = _head(np.random.default_rng(L * P), L, P, S)
    got = ssd_scan(*_t(*args), chunk=chunk).numpy()
    want = np.asarray(j_scan(*map(jnp.asarray, args), chunk=chunk, interpret=True))
    np.testing.assert_allclose(got, want, **TOL)
    np.testing.assert_allclose(got, np.asarray(j_ref(*map(jnp.asarray, args), chunk=chunk)),
                               **TOL)
    np.testing.assert_allclose(ssd_scan_ref(*_t(*args)).numpy(),
                               np.asarray(j_ref(*map(jnp.asarray, args), chunk=chunk)),
                               rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("G", [1, 2, 4])
def test_ssd_chunked_grouped_matches_jax(G):
    """Batched (B = 2, H = 4 heads) with b / c per group: the port reads
    group h // (H / G) where JAX's ssd_chunked takes them repeated to H;
    a ragged L over three chunks."""
    rng = np.random.default_rng(G)
    B, L, H, P, S, chunk = 2, 70, 4, 16, 8, 32
    x = rng.standard_normal((B, L, H, P)).astype(np.float32)
    a_log = (-np.abs(rng.standard_normal((B, L, H))) * 0.3).astype(np.float32)
    b = (rng.standard_normal((B, L, G, S)) * 0.3).astype(np.float32)
    c = (rng.standard_normal((B, L, G, S)) * 0.3).astype(np.float32)
    rep = H // G
    want = np.asarray(j_chunked(jnp.asarray(x), jnp.asarray(a_log),
                                jnp.asarray(np.repeat(b, rep, axis=2)),
                                jnp.asarray(np.repeat(c, rep, axis=2)), chunk=chunk))
    got = ssd_chunked(*_t(x, a_log, b, c), chunk=chunk).numpy()
    np.testing.assert_allclose(got, want, **TOL)
    # the kernel wrapper's CPU path under "cuda_mx" is the same plain scan
    with ops.use_policy(ops.MXPolicy("cuda_mx")):
        via_kernel = ssd_chunked(*_t(x, a_log, b, c), chunk=chunk).numpy()
    np.testing.assert_array_equal(via_kernel, got)


def test_ssd_batched_matches_single_head():
    """One head of the batched layout is JAX's single-head kernel call
    (tests/test_kernels_ssd.py::test_ssd_batched_matches_kernel)."""
    args = _head(np.random.default_rng(7), 64, 16, 8)
    x, a, b, c = _t(*args)
    batched = ssd_scan(x[None, :, None], a[None, :, None], b[None, :, None],
                       c[None, :, None], chunk=16)[0, :, 0]
    kern = np.asarray(j_scan(*map(jnp.asarray, args), chunk=16, interpret=True))
    np.testing.assert_allclose(batched.numpy(), kern, **TOL)


@pytest.mark.parametrize("chunk", [8, 16, 32, 64])
def test_ssd_chunking_invariance(chunk):
    """The chunk size does not change the result (inter-chunk recurrence +
    intra-chunk quadratic == the scan)."""
    rng = np.random.default_rng(chunk)
    x = rng.standard_normal((1, 64, 2, 8)).astype(np.float32)
    a_log = (-np.abs(rng.standard_normal((1, 64, 2))) * 1.5).astype(np.float32)
    b = (rng.standard_normal((1, 64, 2, 4)) * 0.3).astype(np.float32)
    c = (rng.standard_normal((1, 64, 2, 4)) * 0.3).astype(np.float32)
    t = _t(x, a_log, b, c)
    np.testing.assert_allclose(ssd_scan_plain(*t, chunk).numpy(),
                               ssd_scan_plain(*t, 64).numpy(), rtol=3e-4, atol=3e-4)


def test_ssd_hard_reset_does_not_leak_state():
    """a_log = -50 at t = 16 cuts the dependence on earlier inputs (the
    decay is masked before the exp, so nothing overflows either)."""
    rng = np.random.default_rng(3)
    x, _, b, c = _head(rng, 32, 8, 4)
    a_log = np.zeros(32, np.float32)
    a_log[16] = -50.0
    x2 = x.copy()
    x2[:8] = rng.standard_normal((8, 8))
    y = ssd_scan(*_t(x, a_log, b, c), chunk=8).numpy()
    y2 = ssd_scan(*_t(x2, a_log, b, c), chunk=8).numpy()
    assert np.isfinite(y).all()
    np.testing.assert_allclose(y[17:], y2[17:], rtol=1e-4, atol=1e-4)
    want = np.asarray(j_scan(*map(jnp.asarray, (x, a_log, b, c)), chunk=8, interpret=True))
    np.testing.assert_allclose(y, want, **TOL)


def test_ssd_bf16_inputs_accumulate_in_f32():
    """bf16 x / b / c: the scan runs in f32 and rounds once at the output."""
    args = _head(np.random.default_rng(5), 40, 16, 8)
    x, a, b, c = _t(*args)
    got = ssd_scan(x.bfloat16(), a, b.bfloat16(), c.bfloat16(), chunk=16)
    assert got.dtype == torch.bfloat16
    ref = ssd_scan_ref(x.bfloat16().float(), a, b.bfloat16().float(), c.bfloat16().float())
    np.testing.assert_allclose(got.float().numpy(), ref.numpy(), rtol=3e-2, atol=3e-2)


def test_ssd_scan_checks_shapes_and_counts_no_cpu_launch():
    rng = np.random.default_rng(0)
    x, a, b, c = _t(*_head(rng, 16, 8, 4))
    xb, ab, bb, cb = x[None, :, None], a[None, :, None], b[None, :, None], c[None, :, None]
    with pytest.raises(ValueError, match="a_log"):
        ssd_scan(xb, ab[..., :0], bb, cb)
    with pytest.raises(ValueError, match="groups"):
        ssd_scan(xb.expand(1, 16, 3, 8), ab.expand(1, 16, 3), bb.expand(1, 16, 2, 4),
                 cb.expand(1, 16, 2, 4))
    before = ssd_scan.launches
    ssd_scan(xb, ab, bb, cb, chunk=8)
    assert ssd_scan.launches == before  # the plain path counts nothing
