"""Model parity: JAX parameters carried across with `from_jax_params`, then
paged prefill and paged decode through both packages on the same inputs.
JAX runs its Pallas kernels in interpret mode; the port runs its default
CPU path.  Logits and the written page pools agree to rtol = atol = 1e-5
(f32)."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import get_config as j_get_config  # noqa: E402
from repro.core import ops as jops  # noqa: E402
from repro.models import build_model as j_build  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.models import build_model, from_jax_params  # noqa: E402
from repro_torch.runtime.kv_pages import PagePool  # noqa: E402

TOL = dict(rtol=1e-5, atol=1e-5)
JAX_POLICY = jops.MXPolicy("pallas_mx", interpret=True, bm=16, bn=32, bk=16)


def _models(name, seed=0):
    jm = j_build(j_get_config(name))
    jp = jm.init(jax.random.PRNGKey(seed))
    tree = jax.tree.map(np.asarray, jp)
    if j_get_config(name).qkv_bias:
        # JAX inits the qkv biases to zeros; make the bias epilogue count
        rng = np.random.default_rng(7)
        seg = tree["seg0"]["attn"]
        for k in ("bq", "bk", "bv"):
            seg[k] = (0.1 * rng.standard_normal(seg[k].shape)).astype(np.float32)
        jp = jax.tree.map(jnp.asarray, tree)
    tm = build_model(get_config(name))
    tp = from_jax_params(tree, get_config(name), device="cpu")
    return jm, jp, tm, tp


def _pages(cache):
    return {k: v for k, v in cache["seg0"].items()}


@pytest.mark.parametrize("name", ["llama3.2-1b-smoke", "qwen2-0.5b-smoke"])
def test_paged_prefill_and_decode_match_jax(name):
    cfg = get_config(name)
    jm, jp, tm, tp = _models(name)
    ps, B = 4, 3
    pool = PagePool(12, ps)
    pool.reserve(0, 12)
    pool.reserve(1, 12)  # slot 2 stays free: dump-page table row, length 0
    table = pool.page_table(B, 4)
    rng = np.random.default_rng(1)
    jc = jm.make_paged_cache(pool.total_pages, ps, dtype=jnp.float32)
    tc = tm.make_paged_cache(pool.total_pages, ps, device="cpu")

    # one prefill chunk: slot 0 from position 0, slot 1 from position 2
    toks = rng.integers(0, cfg.vocab, (2, 5)).astype(np.int32)
    index = np.asarray([0, 2], np.int32)
    with jops.use_policy(JAX_POLICY):
        jl, jc = jm.prefill_step_paged(jp, jnp.asarray(toks), jc,
                                       jnp.asarray(index), jnp.asarray(table[:2]))
    tl, tc = tm.prefill_step_paged(tp, torch.from_numpy(toks).long(), tc,
                                   torch.from_numpy(index).long(),
                                   torch.from_numpy(table[:2]))
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **TOL)
    for k, v in _pages(tc).items():
        np.testing.assert_allclose(v.numpy(), np.asarray(jc["seg0"][k]), **TOL)

    # one decode step over the pages, slot 2 free
    tok = rng.integers(0, cfg.vocab, (B, 1)).astype(np.int32)
    index = np.asarray([5, 7, 0], np.int32)
    lengths = np.asarray([6, 8, 0], np.int32)
    with jops.use_policy(JAX_POLICY):
        jl, jc = jm.decode_step_paged(jp, jnp.asarray(tok), jc, jnp.asarray(index),
                                      jnp.asarray(table), jnp.asarray(lengths))
    tl, tc = tm.decode_step_paged(tp, torch.from_numpy(tok).long(), tc,
                                  torch.from_numpy(index).long(),
                                  torch.from_numpy(table), torch.from_numpy(lengths))
    assert tl.dtype == torch.float32 and tuple(tl.shape) == (B, 1, cfg.vocab)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **TOL)
    for k, v in _pages(tc).items():
        np.testing.assert_allclose(v.numpy(), np.asarray(jc["seg0"][k]), **TOL)


def test_from_jax_params_keeps_layout_and_rejects_mismatch():
    name = "llama3.2-1b-smoke"
    cfg = get_config(name)
    jp = j_build(j_get_config(name)).init(jax.random.PRNGKey(0))
    tree = jax.tree.map(np.asarray, jp)
    tp = from_jax_params(tree, cfg, device="cpu")
    wq = tp["seg0"]["attn"]["wq"]
    assert tuple(wq.shape) == (2, cfg.d_model, cfg.n_heads * cfg.hd)
    np.testing.assert_array_equal(wq.numpy(), tree["seg0"]["attn"]["wq"])
    tree["seg0"]["attn"]["wq"] = tree["seg0"]["attn"]["wq"][:, :, :-1]
    with pytest.raises(ValueError, match="shape"):
        from_jax_params(tree, cfg, device="cpu")


def test_own_init_matches_jax_distributions_and_layout():
    """The port's seeded init: same tree and shapes as JAX, ones for norms,
    zeros for biases, std 1/sqrt(fan_in) for matrices, 0.02 for the table;
    deterministic in the seed."""
    name = "qwen2-0.5b-smoke"
    cfg = get_config(name)
    jp = jax.tree.map(np.asarray, j_build(j_get_config(name)).init(jax.random.PRNGKey(0)))
    tp = build_model(cfg).init(3, device="cpu")
    flat_j = jax.tree_util.tree_flatten_with_path(jp)[0]
    for path, leaf in flat_j:
        keys = [p.key for p in path]
        t = tp
        for k in keys:
            t = t[k]
        assert tuple(t.shape) == leaf.shape, keys
    assert torch.all(tp["ln_f"] == 1) and torch.all(tp["seg0"]["attn"]["bq"] == 0)
    wi = tp["seg0"]["ffn"]["wi"]
    assert abs(wi.std().item() * np.sqrt(cfg.d_model) - 1.0) < 0.05
    assert abs(tp["embed"]["table"].std().item() / 0.02 - 1.0) < 0.05
    again = build_model(cfg).init(3, device="cpu")
    assert torch.equal(again["seg0"]["attn"]["wq"], tp["seg0"]["attn"]["wq"])
    assert not torch.equal(build_model(cfg).init(4, device="cpu")["embed"]["table"],
                           tp["embed"]["table"])


@pytest.mark.parametrize("name", ["llama3.2-1b-smoke", "qwen2-0.5b-smoke"])
def test_full_forward_matches_jax(name):
    """`DecoderLM.__call__` (the draft model's forward) against JAX's
    `model(params, tokens)`: f32 logits, and a zero aux loss for dense
    blocks."""
    cfg = get_config(name)
    jm, jp, tm, tp = _models(name)
    toks = np.random.default_rng(3).integers(0, cfg.vocab, (2, 11)).astype(np.int32)
    jl, jaux = jm(jp, jnp.asarray(toks))
    tl, taux = tm(tp, torch.from_numpy(toks).long())
    assert tl.dtype == torch.float32 and tuple(tl.shape) == (2, 11, cfg.vocab)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **TOL)
    assert float(taux) == float(jaux) == 0.0


@pytest.mark.parametrize("causal,q_offset", [(True, 0), (True, 5), (False, 0)])
def test_full_and_chunked_attention_match_jax(causal, q_offset):
    """Both attention forms against JAX's; chunked at block_kv = 3 over 13
    keys, so the last block is ragged and, under the causal mask, the
    later blocks are masked throughout for the first query rows."""
    from repro.models import layers as jl
    from repro_torch.models import layers as tl

    rng = np.random.default_rng(4)
    q = rng.standard_normal((2, 8, 4, 8)).astype(np.float32)
    k = rng.standard_normal((2, 13, 4, 8)).astype(np.float32)
    v = rng.standard_normal((2, 13, 4, 8)).astype(np.float32)
    jq, jk, jv = (jnp.asarray(a) for a in (q, k, v))
    tq, tk, tv = (torch.from_numpy(a) for a in (q, k, v))
    want = jl.full_attention(jq, jk, jv, causal=causal, q_offset=q_offset)
    got = tl.full_attention(tq, tk, tv, causal=causal, q_offset=q_offset)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    want = jl.chunked_attention(jq, jk, jv, causal=causal, block_kv=3, q_offset=q_offset)
    got = tl.chunked_attention(tq, tk, tv, causal=causal, block_kv=3, q_offset=q_offset)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


def test_attention_call_chunked_route_matches_jax():
    """`Attention.__call__` past `chunked_threshold` takes the chunked
    form, with GQA repeat and the fused residual."""
    from repro.models.layers import Attention as JAttention
    from repro_torch.models.layers import Attention as TAttention

    kw = dict(d_model=32, n_heads=4, n_kv_heads=2, chunked_threshold=4)
    jp = JAttention(**kw).init(jax.random.PRNGKey(2))
    tp = {k: torch.from_numpy(np.array(v)) for k, v in jp.items()}
    x = np.random.default_rng(5).standard_normal((2, 9, 32)).astype(np.float32)
    want = JAttention(**kw)(jp, jnp.asarray(x), residual=jnp.asarray(x))
    got = TAttention(**kw)(tp, torch.from_numpy(x), residual=torch.from_numpy(x))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


@pytest.mark.parametrize("kv", ["f32", "int8"])
def test_verify_step_paged_matches_jax(kv):
    """A prefill chunk, then one speculative window of S = 4 over three
    slots (slot 2 free), through both packages: logits and every written
    page -- int8 payloads and scale pages included -- agree."""
    from repro.core.precision import QuantSpec as JQuantSpec
    from repro_torch.core.precision import QuantSpec

    name = "llama3.2-1b-smoke"
    cfg = get_config(name)
    jm, jp, tm, tp = _models(name)
    ps, B, S = 4, 3, 4
    pool = PagePool(12, ps)
    pool.reserve(0, 16)
    pool.reserve(1, 16)
    table = pool.page_table(B, 5)  # wider than the slots' pages: dump-page pad
    jkw = dict(kv_quant=JQuantSpec("int8")) if kv == "int8" else {}
    tkw = dict(kv_quant=QuantSpec("int8")) if kv == "int8" else {}
    jc = jm.make_paged_cache(pool.total_pages, ps, dtype=jnp.float32, **jkw)
    tc = tm.make_paged_cache(pool.total_pages, ps, device="cpu", **tkw)
    assert set(tc["seg0"]) == set(jc["seg0"])
    rng = np.random.default_rng(6)
    toks = rng.integers(0, cfg.vocab, (2, 6)).astype(np.int32)
    index = np.asarray([0, 3], np.int32)
    with jops.use_policy(JAX_POLICY):
        _, jc = jm.prefill_step_paged(jp, jnp.asarray(toks), jc, jnp.asarray(index),
                                      jnp.asarray(table[:2]))
    tm.prefill_step_paged(tp, torch.from_numpy(toks).long(), tc,
                          torch.from_numpy(index).long(), torch.from_numpy(table[:2]))

    win = rng.integers(0, cfg.vocab, (B, S)).astype(np.int32)
    index = np.asarray([6, 9, 0], np.int32)
    lengths = np.asarray([6 + S, 9 + S, 0], np.int32)
    with jops.use_policy(JAX_POLICY):
        jl, jc = jm.verify_step_paged(jp, jnp.asarray(win), jc, jnp.asarray(index),
                                      jnp.asarray(table), jnp.asarray(lengths))
    tl, tc = tm.verify_step_paged(tp, torch.from_numpy(win).long(), tc,
                                  torch.from_numpy(index).long(),
                                  torch.from_numpy(table), torch.from_numpy(lengths))
    assert tl.dtype == torch.float32 and tuple(tl.shape) == (B, S, cfg.vocab)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **TOL)
    for k, v in _pages(tc).items():
        want = np.asarray(jc["seg0"][k])
        assert v.dtype == (torch.int8 if want.dtype == np.int8 else torch.float32), k
        np.testing.assert_allclose(v.numpy(), want, **TOL)

    # row 0 of the window is the plain decode step on the same state
    tc0 = tm.make_paged_cache(pool.total_pages, ps, device="cpu", **tkw)
    tm.prefill_step_paged(tp, torch.from_numpy(toks).long(), tc0,
                          torch.tensor([0, 3]), torch.from_numpy(table[:2]))
    dl, _ = tm.decode_step_paged(tp, torch.from_numpy(win[:, :1]).long(), tc0,
                                 torch.from_numpy(index).long(), torch.from_numpy(table),
                                 torch.from_numpy(np.where(lengths > 0, index + 1, 0)
                                                  .astype(np.int32)))
    np.testing.assert_allclose(dl[:, 0].numpy(), tl[:, 0].numpy(), **TOL)
