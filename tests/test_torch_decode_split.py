"""The paged attention's split on the CPU: `kernels/_build.decode_span` and
`decode_split` (the span length, the group of spans per round, the ring,
the cluster size and the shared memory that `csrc/mx_flash_decode.cu`
launches with), and a plain mirror of the kernel's span-ordered combine.

The kernel runs only on the card (`tests/test_torch_cuda.py`): here the
table is held against the limits of an H100 -- 232,448 bytes of shared
memory per CTA, 65,536 registers per SM, a portable cluster of 8 -- and
against the rule that keeps the output's bits a function of the positions,
the page size and the page dtype alone: the span length depends on
(page size, head dim, page dtype) and on nothing else.  The mirror cuts a
slot's positions into those spans, computes each span's partial (m, l, acc)
from zero, and folds the partials in span order, skipping a span with no
visible position; it is held against JAX's `mx_flash_decode` /
`mx_flash_verify` in interpret mode at the suite's rtol = atol = 1e-5 (f32).
"""
import math

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro.kernels.mx_flash_decode import mx_flash_decode as j_decode  # noqa: E402
from repro.kernels.mx_flash_decode import mx_flash_verify as j_verify  # noqa: E402
from repro_torch.kernels import _build  # noqa: E402
from repro_torch.runtime.kv_pages import PagePool  # noqa: E402

TOL = dict(rtol=1e-5, atol=1e-5)
PAGE_DTYPES = (torch.float32, torch.bfloat16, torch.int8, torch.float8_e4m3fn)
REGISTERS_PER_SM = 65536
MAX_CLUSTER = 8
MAX_THREADS = 512  # the kernel's launch bound: 16 warps, so 128 registers a thread


def _ids(dt):
    return str(dt).removeprefix("torch.")


@pytest.mark.parametrize("page_dtype", PAGE_DTYPES, ids=_ids)
def test_split_fits_the_card(page_dtype):
    """Every launch the table gives fits one CTA on an SM and one portable
    cluster, for every page type at the repo's head shapes, page sizes 1-64,
    batches of 1-64 slots, windows of 1-9 rows and tables of 1-8192 pages;
    the table refuses a shape only where one page alone is past the card."""
    scaled = page_dtype in _build.QUANTIZED
    for G, d in ((1, 16), (4, 64), (7, 64), (16, 128), (32, 256), (6, 128), (1, 5)):
        for ps in (1, 4, 16, 64):
            for B, S, Hkv in ((1, 1, 1), (8, 1, 8), (8, 5, 8), (64, 9, 8), (4, 1, 2)):
                for W in (1, 7, 160, 8192):
                    try:
                        sp = _build.decode_split(B, S, Hkv, G, d, ps, W, page_dtype, scaled)
                    except ValueError:  # only when one page alone is past the card
                        assert _build.decode_split_smem(G, d, ps, page_dtype.itemsize, scaled,
                                                        1, 1, 1, 1, W) > _build.SMEM_PER_CTA
                        continue
                    what = (G, d, ps, B, S, Hkv, W, sp)
                    assert sp.smem <= _build.SMEM_PER_CTA, what
                    assert sp.smem == _build.decode_split_smem(
                        G, d, ps, page_dtype.itemsize, scaled, sp.span_pages, sp.group,
                        sp.ring, sp.cluster, W), what
                    assert 1 <= sp.cluster <= MAX_CLUSTER, what
                    assert sp.cluster <= max(1, math.ceil(W / sp.span_pages)), what
                    assert sp.threads == 32 * min(G, _build.SPLIT_MAX_WARPS) <= MAX_THREADS, what
                    assert sp.threads * (REGISTERS_PER_SM // MAX_THREADS) <= REGISTERS_PER_SM
                    assert sp.ring >= 1 and sp.group >= 1, what
                    assert sp.group == 1 or sp.cluster == 1, what
                    assert sp.ctas == sp.cluster * B * S * Hkv, what


def test_split_refuses_a_page_past_shared_memory():
    """One page of 512 rows of 16 query rows at d = 128 in f32 needs more
    shared memory than a block can use; the message names the 227 KB."""
    with pytest.raises(ValueError, match="232448"):
        _build.decode_split(1, 2, 2, 16, 128, 512, 1, torch.float32, False)
    with pytest.raises(ValueError, match="G <= 32"):
        _build.decode_split(1, 1, 1, 33, 64, 16, 4, torch.float32, False)


@pytest.mark.parametrize("page_dtype", PAGE_DTYPES, ids=_ids)
@pytest.mark.parametrize("ps,d", [(16, 64), (16, 128), (4, 16), (1, 64), (64, 256), (8, 80)])
def test_span_depends_on_page_size_head_dim_and_dtype_alone(page_dtype, ps, d):
    """The launch's span is `decode_span(ps, d, dtype)` whatever the batch,
    window, kv heads, group or table width: the output's bits never depend
    on them.  A span is whole pages, at least one."""
    span = _build.decode_span(ps, d, page_dtype)
    assert span >= 1
    assert span * ps <= max(ps, _build.SPAN_MAX_POSITIONS)
    for B, S, Hkv, G in ((1, 1, 1, 4), (8, 5, 8, 4), (32, 9, 2, 7), (3, 1, 4, 1)):
        for W in (1, 3, 10, 128, 4096):
            sp = _build.decode_split(B, S, Hkv, G, min(d, 256), ps, W, page_dtype,
                                     page_dtype in _build.QUANTIZED)
            assert sp.span_pages == span, (B, S, Hkv, G, W)


def test_span_table_at_llama_pages():
    """llama3.2-1b's pages (16 rows of d = 64): 16 KB of K and V per span,
    2 pages in f32, 4 in bf16, 8 (128 positions) in int8 and fp8."""
    got = [_build.decode_span(16, 64, dt) for dt in PAGE_DTYPES]
    assert got == [2, 4, 8, 8]


# ---------------------------------------------------------------------------
# the span-ordered combine, mirrored in plain PyTorch
# ---------------------------------------------------------------------------


def split_mirror(q, kp, vp, table, lengths, span_pages, k_scale=None, v_scale=None):
    """csrc/mx_flash_decode.cu's arithmetic in plain f32 PyTorch: q (B, S,
    H, d); every span of `span_pages` pages of the table (those wholly past
    a row's length are all masked) gives a partial (m, l, acc) from zero --
    scores masked before the max, p = exp(s - m), l = sum p, acc = p V --
    and the partials are folded in span order, a span with no visible
    position skipped; a free slot (length 0) gives exact zeros."""
    B, S, H, d = q.shape
    _, ps, Hkv, _ = kp.shape
    G, W = H // Hkv, table.shape[1]

    def rows(pages, scale):
        x = pages.float()
        if scale is not None:
            x = x * scale[..., None]
        return x[table.long()].reshape(B, W * ps, Hkv, d)

    k, v = rows(kp, k_scale), rows(vp, v_scale)
    out = torch.zeros((B, S, H, d))
    npos = span_pages * ps
    for b in range(B):
        if int(lengths[b]) == 0:
            continue
        for s in range(S):
            visible = int(lengths[b]) - S + s + 1
            qh = q[b, s].float().reshape(Hkv, G, d)
            m = torch.full((Hkv, G), -math.inf)
            lsum = torch.zeros((Hkv, G))
            acc = torch.zeros((Hkv, G, d))
            for t0 in range(0, W * ps, npos):
                pos = torch.arange(t0, min(t0 + npos, W * ps))
                sc = torch.einsum("hgd,thd->hgt", qh, k[b, pos]) / math.sqrt(d)
                sc = sc.masked_fill((pos >= visible)[None, None, :], -math.inf)
                mi = sc.max(-1).values
                live = mi > -math.inf  # a span with a visible position
                p = torch.exp(sc - torch.where(live, mi, 0.0)[..., None])
                li, ai = p.sum(-1), torch.einsum("hgt,thd->hgd", p, v[b, pos])
                m_new = torch.maximum(m, mi)
                a = torch.where(m > -math.inf, torch.exp(m - m_new), 0.0)
                bq = torch.where(live, torch.exp(mi - m_new), 0.0)
                lsum = torch.where(live, lsum * a + li * bq, lsum)
                acc = torch.where(live[..., None], acc * a[..., None] + ai * bq[..., None], acc)
                m = torch.where(live, m_new, m)
            out[b, s] = (acc / torch.clamp(lsum, min=1e-30)[..., None]).reshape(H, d)
    return out


def _setup(rng, B, Hkv, d, ps, W, lengths, int8):
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


@pytest.mark.parametrize("int8", [False, True], ids=["f32", "int8"])
@pytest.mark.parametrize(
    "B,H,Hkv,d,ps,W,S,lengths",
    [
        # decode: a length on a span boundary (2 spans of 2 pages of 4), a
        # free slot, one position, and spans wholly past the length (W = 6)
        (4, 4, 2, 16, 4, 6, 1, (16, 0, 1, 9)),
        # decode, G = 7 (qwen2: 14 / 2), lengths just past a boundary
        (3, 14, 2, 16, 4, 5, 1, (17, 8, 0)),
        # verify (k = 4): window rows on both sides of a span boundary
        (3, 8, 2, 16, 4, 6, 5, (16, 0, 11)),
        # verify (k = 8) over pages of 8 rows
        (2, 4, 4, 8, 8, 4, 9, (9, 24)),
    ],
)
def test_span_ordered_combine_matches_jax(int8, B, H, Hkv, d, ps, W, S, lengths):
    """The mirror of the kernel's split, at spans of 2 pages (so every case
    has several spans and some wholly masked), and at the span the table
    gives, against JAX's kernels in interpret mode."""
    rng = np.random.default_rng(B * 100 + W)
    q = rng.standard_normal((B, S, H, d)).astype(np.float32)
    kp, vp, ks, vs, table, lns = _setup(rng, B, Hkv, d, ps, W, lengths, int8)
    kw_j = {} if ks is None else dict(k_scale=jnp.asarray(ks), v_scale=jnp.asarray(vs))
    args_j = (jnp.asarray(kp), jnp.asarray(vp), jnp.asarray(table), jnp.asarray(lns))
    if S == 1:
        want = np.asarray(j_decode(jnp.asarray(q[:, 0]), *args_j, interpret=True,
                                   **kw_j))[:, None]
    else:
        want = np.asarray(j_verify(jnp.asarray(q), *args_j, interpret=True, **kw_j))
    dtype = torch.int8 if int8 else torch.float32
    kw_t = {} if ks is None else dict(k_scale=torch.from_numpy(ks),
                                      v_scale=torch.from_numpy(vs))
    for span in (2, _build.decode_span(ps, d, dtype)):
        got = split_mirror(torch.from_numpy(q), torch.from_numpy(kp), torch.from_numpy(vp),
                           torch.from_numpy(table), torch.from_numpy(lns), span, **kw_t)
        np.testing.assert_allclose(got.numpy(), want, **TOL)
        for i, ln in enumerate(lengths):
            if ln == 0:  # a free slot stores exact zeros
                assert np.all(got[i].numpy() == 0.0)


def test_stale_rows_do_not_enter_the_combine():
    """Rows past a slot's length inside its last span, unowned pages and the
    dump page poisoned with 1e30: the mirror's output does not move (they
    are masked before each span's max)."""
    rng = np.random.default_rng(5)
    B, H, Hkv, d, ps, W, lengths = 2, 4, 2, 16, 4, 6, (6, 13)
    q = torch.from_numpy(rng.standard_normal((B, 1, H, d)).astype(np.float32))
    kp, vp, _, _, table, lns = _setup(rng, B, Hkv, d, ps, W, lengths, False)
    args = (torch.from_numpy(table), torch.from_numpy(lns), 2)
    clean = split_mirror(q, torch.from_numpy(kp), torch.from_numpy(vp), *args)
    live = np.zeros(kp.shape[:2], bool)
    for s, ln in enumerate(lengths):
        for pos in range(ln):
            live[table[s, pos // ps], pos % ps] = True
    pk = np.where(live[:, :, None, None], kp, 1e30).astype(np.float32)
    pv = np.where(live[:, :, None, None], vp, 1e30).astype(np.float32)
    got = split_mirror(q, torch.from_numpy(pk), torch.from_numpy(pv), *args)
    np.testing.assert_allclose(got.numpy(), clean.numpy(), **TOL)
