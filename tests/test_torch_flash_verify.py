"""Speculative-window attention and int8 scale pages: the port's plain
versions (the CUDA wrappers' CPU path) against the JAX Pallas kernels in
interpret mode, on the same numpy inputs.

Tolerance: rtol = atol = 1e-5 in f32 (tests/test_flash_decode.py's own);
free slots must give exactly-zero rows; S = 1 verify equals decode."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro.kernels.mx_flash_decode import mx_flash_decode as j_decode  # noqa: E402
from repro.kernels.mx_flash_decode import mx_flash_verify as j_verify  # noqa: E402
from repro.kernels.ref import paged_prefill_ref as j_prefill  # noqa: E402
from repro_torch.kernels.mx_flash_decode import mx_flash_decode as t_decode  # noqa: E402
from repro_torch.kernels.mx_flash_decode import mx_flash_verify as t_verify  # noqa: E402
from repro_torch.kernels.ref import paged_verify_ref  # noqa: E402
from repro_torch.runtime.kv_pages import PagePool  # noqa: E402

TOL = dict(rtol=1e-5, atol=1e-5)


def _setup(rng, B, Hkv, d, ps, W, lengths, int8=False):
    """Page pools (f32, or int8 with f32 scale pages), a table reserving
    each slot's length, and the lengths."""
    P = B * W + 1
    if int8:
        kp = rng.integers(-127, 128, (P, ps, Hkv, d)).astype(np.int8)
        vp = rng.integers(-127, 128, (P, ps, Hkv, d)).astype(np.int8)
        ks = rng.uniform(0.001, 0.05, (P, ps, Hkv)).astype(np.float32)
        vs = rng.uniform(0.001, 0.05, (P, ps, Hkv)).astype(np.float32)
    else:
        kp = rng.standard_normal((P, ps, Hkv, d)).astype(np.float32)
        vp = rng.standard_normal((P, ps, Hkv, d)).astype(np.float32)
        ks = vs = None
    pool = PagePool(P - 1, ps)
    for s, ln in enumerate(lengths):
        if ln > 0:
            pool.reserve(s, ln)
            pool.set_length(s, ln)
    return kp, vp, ks, vs, pool.page_table(B, W), pool.lengths(B)


def _jax(fn, q, kp, vp, ks, vs, table, lns):
    kw = {} if ks is None else dict(k_scale=jnp.asarray(ks), v_scale=jnp.asarray(vs))
    return np.asarray(fn(jnp.asarray(q), jnp.asarray(kp), jnp.asarray(vp),
                         jnp.asarray(table), jnp.asarray(lns), interpret=True, **kw))


def _port(fn, q, kp, vp, ks, vs, table, lns):
    t = [torch.from_numpy(np.ascontiguousarray(a)) for a in (q, kp, vp, table, lns)]
    kw = {} if ks is None else dict(k_scale=torch.from_numpy(ks),
                                    v_scale=torch.from_numpy(vs))
    return fn(*t, **kw).numpy()


@pytest.mark.parametrize("int8", [False, True], ids=["f32", "int8"])
@pytest.mark.parametrize(
    "B,H,Hkv,d,ps,W,S,lengths",
    [
        (2, 4, 4, 16, 8, 3, 4, (9, 17)),        # MHA, ragged, window spans pages
        (3, 8, 2, 32, 8, 4, 5, (5, 13, 32)),    # GQA groups=4, length == S
        (4, 6, 3, 8, 4, 4, 5, (12, 0, 5, 16)),  # free slot + S > page_size
        (3, 14, 2, 16, 4, 5, 5, (9, 0, 20)),    # G = 7 (qwen2: 14 / 2)
        (2, 8, 2, 16, 4, 5, 9, (9, 18)),        # S = 9 (k = 8)
    ],
)
def test_verify_matches_jax_kernel(int8, B, H, Hkv, d, ps, W, S, lengths):
    rng = np.random.default_rng(0)
    q = rng.standard_normal((B, S, H, d)).astype(np.float32)
    kp, vp, ks, vs, table, lns = _setup(rng, B, Hkv, d, ps, W, lengths, int8)
    want = _jax(j_verify, q, kp, vp, ks, vs, table, lns)
    got = _port(t_verify, q, kp, vp, ks, vs, table, lns)
    assert got.shape == (B, S, H, d) and got.dtype == np.float32
    np.testing.assert_allclose(got, want, **TOL)
    for i, ln in enumerate(lengths):
        if ln == 0:  # free slots produce exactly-zero rows
            assert np.all(got[i] == 0.0)


@pytest.mark.parametrize("int8", [False, True], ids=["f32", "int8"])
def test_verify_stale_and_rejected_rows_are_dead(int8):
    """Poisoning every (page, row) past each slot's length -- stale rows of
    a recycled page, rejected drafts past the window, unowned pages and the
    dump page -- must not change the output."""
    rng = np.random.default_rng(2)
    B, H, Hkv, d, ps, W, S = 2, 4, 2, 16, 4, 4, 3
    lengths = (7, 10)
    q = rng.standard_normal((B, S, H, d)).astype(np.float32)
    kp, vp, ks, vs, table, lns = _setup(rng, B, Hkv, d, ps, W, lengths, int8)
    clean = _port(t_verify, q, kp, vp, ks, vs, table, lns)
    live = np.zeros(kp.shape[:2], bool)
    for s, ln in enumerate(lengths):
        for pos in range(ln):
            live[table[s, pos // ps], pos % ps] = True
    if int8:  # the poison rides the scales: 1e30 per dequantized row
        pks = np.where(live[:, :, None], ks, 1e30).astype(np.float32)
        pvs = np.where(live[:, :, None], vs, 1e30).astype(np.float32)
        pk, pv = kp, vp
    else:
        pks = pvs = None
        pk = np.where(live[:, :, None, None], kp, 1e30).astype(np.float32)
        pv = np.where(live[:, :, None, None], vp, 1e30).astype(np.float32)
    got = _port(t_verify, q, pk, pv, pks, pvs, table, lns)
    want = _jax(j_verify, q, pk, pv, pks, pvs, table, lns)
    np.testing.assert_allclose(got, want, **TOL)
    np.testing.assert_allclose(got, clean, **TOL)


def test_verify_causal_within_window():
    """Row r does not see rows r+1..S-1 of its own window."""
    rng = np.random.default_rng(4)
    B, H, Hkv, d, ps, W, S = 1, 2, 2, 8, 4, 3, 3
    q = rng.standard_normal((B, S, H, d)).astype(np.float32)
    kp, vp, _, _, table, lns = _setup(rng, B, Hkv, d, ps, W, (9,))
    base = _port(t_verify, q, kp, vp, None, None, table, lns)
    pg, row = table[0, 8 // ps], 8 % ps  # the last window row's K/V
    kp[pg, row], vp[pg, row] = 99.0, -99.0
    pert = _port(t_verify, q, kp, vp, None, None, table, lns)
    np.testing.assert_array_equal(pert[:, :2], base[:, :2])
    assert not np.allclose(pert[:, 2], base[:, 2])


@pytest.mark.parametrize("int8", [False, True], ids=["f32", "int8"])
def test_verify_s1_matches_decode(int8):
    """The one-row window is a decode step, in the port and in JAX."""
    rng = np.random.default_rng(2)
    B, H, Hkv, d, ps, W = 3, 14, 2, 16, 8, 3
    lengths = (7, 0, 20)
    q = rng.standard_normal((B, H, d)).astype(np.float32)
    kp, vp, ks, vs, table, lns = _setup(rng, B, Hkv, d, ps, W, lengths, int8)
    ver = _port(t_verify, q[:, None], kp, vp, ks, vs, table, lns)[:, 0]
    dec = _port(t_decode, q, kp, vp, ks, vs, table, lns)
    np.testing.assert_allclose(ver, dec, rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(dec, _jax(j_decode, q, kp, vp, ks, vs, table, lns),
                               **TOL)


@pytest.mark.parametrize(
    "B,H,Hkv,d,ps,W,lengths",
    [
        (3, 8, 4, 16, 8, 3, (20, 3, 24)),    # tests/test_flash_decode.py's shape
        (4, 14, 2, 16, 4, 4, (9, 0, 16, 1)),  # G = 7 with a free slot
    ],
)
def test_decode_int8_scale_pages_match_jax_kernel(B, H, Hkv, d, ps, W, lengths):
    rng = np.random.default_rng(1)
    q = rng.standard_normal((B, H, d)).astype(np.float32)
    kp, vp, ks, vs, table, lns = _setup(rng, B, Hkv, d, ps, W, lengths, int8=True)
    got = _port(t_decode, q, kp, vp, ks, vs, table, lns)
    np.testing.assert_allclose(got, _jax(j_decode, q, kp, vp, ks, vs, table, lns),
                               **TOL)
    for i, ln in enumerate(lengths):
        if ln == 0:
            assert np.all(got[i] == 0.0)


def test_verify_ref_is_prefill_ref_at_window_start():
    """The plain version is JAX's prefill oracle at index = lengths - S,
    with free slots' rows zeroed where that oracle gives NaN."""
    rng = np.random.default_rng(5)
    B, H, Hkv, d, ps, W, S = 3, 4, 2, 8, 4, 4, 3
    q = rng.standard_normal((B, S, H, d)).astype(np.float32)
    kp, vp, ks, vs, table, lns = _setup(rng, B, Hkv, d, ps, W, (6, 0, 13), int8=True)
    want = np.asarray(j_prefill(jnp.asarray(q), jnp.asarray(kp), jnp.asarray(vp),
                                jnp.asarray(table), jnp.asarray(lns - S),
                                k_scale=jnp.asarray(ks), v_scale=jnp.asarray(vs)))
    assert np.isnan(want[1]).all()
    got = paged_verify_ref(*(torch.from_numpy(a) for a in (q, kp, vp, table, lns)),
                           k_scale=torch.from_numpy(ks), v_scale=torch.from_numpy(vs))
    np.testing.assert_allclose(got.numpy()[[0, 2]], want[[0, 2]], **TOL)
    assert np.all(got.numpy()[1] == 0.0)


def test_wrappers_reject_bad_scale_pages():
    q = torch.zeros(1, 2, 8)
    kp = torch.zeros(3, 4, 1, 8, dtype=torch.int8)
    table, lns = torch.zeros(1, 1, dtype=torch.int32), torch.ones(1, dtype=torch.int32)
    with pytest.raises(ValueError, match="k_scale"):
        t_decode(q, kp, kp, table, lns)  # int8 pages without scales
    with pytest.raises(ValueError, match="together"):
        t_verify(q[:, None], kp, kp, table, lns, k_scale=torch.ones(3, 4, 1))
    with pytest.raises(ValueError, match=r"\(P, ps, Hkv\)"):
        t_decode(q, kp, kp, table, lns, k_scale=torch.ones(3, 4, 2),
                 v_scale=torch.ones(3, 4, 2))


@pytest.mark.parametrize("kernel", ["decode", "verify"])
def test_wrappers_on_cpu_tensors_run_the_plain_version_and_count_nothing(kernel):
    """A CPU tensor takes the plain version: no kernel launch, no count."""
    from repro_torch import kernels
    from repro_torch.kernels.ref import paged_decode_ref

    rng = np.random.default_rng(7)
    kp, vp, ks, vs, table, lns = _setup(rng, 2, 2, 8, 4, 3, (5, 9), int8=True)
    shape = (2, 4, 8) if kernel == "decode" else (2, 3, 4, 8)
    args = [torch.from_numpy(a) for a in (rng.standard_normal(shape).astype(np.float32),
                                          kp, vp, table, lns)]
    kw = dict(k_scale=torch.from_numpy(ks), v_scale=torch.from_numpy(vs))
    fn, ref = ((t_decode, paged_decode_ref) if kernel == "decode"
               else (t_verify, paged_verify_ref))
    kernels.reset_launch_counts()
    got = fn(*args, **kw)
    assert kernels.launch_counts() == {k: 0 for k in kernels.WRAPPERS}
    assert torch.equal(got, ref(*args, **kw))
    assert got.shape == shape and torch.isfinite(got).all()
