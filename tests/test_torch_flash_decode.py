"""Paged attention parity: the port's plain flash decode (the CUDA
wrapper's CPU path) and paged prefill oracle against the JAX Pallas kernel
(interpret mode) and oracle, on the same numpy inputs.

Tolerance: rtol = atol = 1e-5 in f32 (tests/test_flash_decode.py's own);
free slots must give exactly-zero rows."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro.kernels.mx_flash_decode import mx_flash_decode as j_decode  # noqa: E402
from repro.kernels.ref import paged_prefill_ref as j_prefill  # noqa: E402
from repro_torch.kernels.mx_flash_decode import mx_flash_decode as t_decode  # noqa: E402
from repro_torch.kernels.ref import paged_prefill_ref as t_prefill  # noqa: E402
from repro_torch.runtime.kv_pages import PagePool  # noqa: E402

TOL = dict(rtol=1e-5, atol=1e-5)


def _paged_setup(rng, B, Hkv, d, ps, W, lengths):
    P = B * W + 1
    kp = rng.standard_normal((P, ps, Hkv, d)).astype(np.float32)
    vp = rng.standard_normal((P, ps, Hkv, d)).astype(np.float32)
    pool = PagePool(P - 1, ps)
    for s, ln in enumerate(lengths):
        if ln > 0:
            pool.reserve(s, ln)
            pool.set_length(s, ln)
    return kp, vp, pool.page_table(B, W), pool.lengths(B)


def _both(q, kp, vp, table, lns):
    want = j_decode(jnp.asarray(q), jnp.asarray(kp), jnp.asarray(vp),
                    jnp.asarray(table), jnp.asarray(lns), interpret=True)
    got = t_decode(*(torch.from_numpy(np.ascontiguousarray(a))
                     for a in (q, kp, vp, table, lns)))
    return got.numpy(), np.asarray(want)


@pytest.mark.parametrize(
    "B,H,Hkv,d,ps,W,lengths",
    [
        (2, 4, 4, 16, 8, 2, (5, 16)),          # MHA, ragged
        (3, 8, 2, 32, 8, 4, (1, 17, 32)),      # GQA groups=4
        (4, 6, 3, 8, 4, 3, (12, 0, 3, 7)),     # free slot + odd heads
        (1, 2, 1, 64, 16, 1, (16,)),           # single page
        (3, 14, 2, 16, 4, 4, (9, 0, 16)),      # G = 7 (qwen2: 14 / 2)
    ],
)
def test_decode_matches_jax_kernel(B, H, Hkv, d, ps, W, lengths):
    rng = np.random.default_rng(0)
    q = rng.standard_normal((B, H, d)).astype(np.float32)
    kp, vp, table, lns = _paged_setup(rng, B, Hkv, d, ps, W, lengths)
    got, want = _both(q, kp, vp, table, lns)
    np.testing.assert_allclose(got, want, **TOL)
    for i, ln in enumerate(lengths):
        if ln == 0:  # free slots produce exactly-zero rows
            assert np.all(got[i] == 0.0)


def test_stale_page_contents_are_dead():
    """Poisoning every non-live (page, row) with huge values -- rows past a
    slot's length inside its pages and whole unowned pages, the dump page
    included -- must not change the output."""
    rng = np.random.default_rng(2)
    B, H, Hkv, d, ps, W = 2, 4, 2, 16, 4, 4
    lengths = (6, 3)
    q = rng.standard_normal((B, H, d)).astype(np.float32)
    kp, vp, table, lns = _paged_setup(rng, B, Hkv, d, ps, W, lengths)
    clean, _ = _both(q, kp, vp, table, lns)
    live = np.zeros(kp.shape[:2], bool)
    for s, ln in enumerate(lengths):
        for pos in range(ln):
            live[table[s, pos // ps], pos % ps] = True
    mask = live[:, :, None, None]
    pk, pv = np.where(mask, kp, 1e30), np.where(mask, vp, 1e30)
    got, want = _both(q, pk.astype(np.float32), pv.astype(np.float32), table, lns)
    np.testing.assert_allclose(got, want, **TOL)
    np.testing.assert_allclose(got, clean, **TOL)


def test_all_free_slots_give_exact_zeros():
    rng = np.random.default_rng(3)
    B, H, Hkv, d, ps, W = 3, 4, 2, 8, 4, 2
    q = rng.standard_normal((B, H, d)).astype(np.float32)
    kp, vp, table, lns = _paged_setup(rng, B, Hkv, d, ps, W, (0, 0, 0))
    got, want = _both(q, kp, vp, table, lns)
    assert np.all(got == 0.0) and np.all(want == 0.0)


def test_scale_pages_match_jax_kernel():
    """Per-row dequant scale pages steered by the same table, on f32 pages
    that hold int8 values (the layout of tests/test_flash_decode.py); the
    int8 page dtype itself is held in tests/test_torch_flash_verify.py."""
    rng = np.random.default_rng(1)
    B, H, Hkv, d, ps, W = 3, 8, 4, 16, 8, 3
    q = rng.standard_normal((B, H, d)).astype(np.float32)
    kp, vp, table, lns = _paged_setup(rng, B, Hkv, d, ps, W, (20, 3, 24))
    kp, vp = np.round(kp * 40).astype(np.float32), np.round(vp * 40).astype(np.float32)
    ks = rng.uniform(0.001, 0.05, kp.shape[:3]).astype(np.float32)
    vs = rng.uniform(0.001, 0.05, kp.shape[:3]).astype(np.float32)
    want = j_decode(jnp.asarray(q), jnp.asarray(kp), jnp.asarray(vp), jnp.asarray(table),
                    jnp.asarray(lns), k_scale=jnp.asarray(ks), v_scale=jnp.asarray(vs),
                    interpret=True)
    got = t_decode(*(torch.from_numpy(a) for a in (q, kp, vp, table, lns)),
                   k_scale=torch.from_numpy(ks), v_scale=torch.from_numpy(vs))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


@pytest.mark.parametrize("S,index", [(1, (0, 5)), (4, (3, 9)), (5, (0, 0))])
def test_paged_prefill_ref_matches_jax(S, index):
    rng = np.random.default_rng(4)
    B, H, Hkv, d, ps, W = 2, 6, 2, 8, 4, 4
    q = rng.standard_normal((B, S, H, d)).astype(np.float32)
    kp, vp, table, _ = _paged_setup(rng, B, Hkv, d, ps, W, (16, 16))
    idx = np.asarray(index, np.int32)
    want = j_prefill(jnp.asarray(q), jnp.asarray(kp), jnp.asarray(vp),
                     jnp.asarray(table), jnp.asarray(idx))
    got = t_prefill(torch.from_numpy(q), torch.from_numpy(kp), torch.from_numpy(vp),
                    torch.from_numpy(table), torch.from_numpy(idx))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
