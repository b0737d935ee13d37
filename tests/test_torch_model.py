"""Model parity: JAX parameters carried across with `from_jax_params`, then
paged prefill and paged decode through both packages on the same inputs,
for dense (llama, qwen2) and MoE (grok-1, kimi-k2) smoke configs.  JAX
runs its Pallas kernels in interpret mode; the port runs its default CPU
path.  Logits, aux losses and the written page pools agree to rtol = atol
= 1e-5 (f32).  Quantized models (`Config.precision`, int8 / fp8 KV pages)
carry the same payload bytes in both packages: their page payloads and
scales are compared as written."""
import dataclasses

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


def _models(name, seed=0, precision="none"):
    jcfg = dataclasses.replace(j_get_config(name), precision=precision)
    cfg = dataclasses.replace(get_config(name), precision=precision)
    jm = j_build(jcfg)
    jp = jm.init(jax.random.PRNGKey(seed))
    tree = jax.tree.map(np.asarray, jp)
    if jcfg.qkv_bias:
        # JAX inits the qkv biases to zeros; make the bias epilogue count
        rng = np.random.default_rng(7)
        seg = tree["seg0"]["attn"]
        for k in ("bq", "bk", "bv"):
            seg[k] = (0.1 * rng.standard_normal(seg[k].shape)).astype(np.float32)
        jp = jax.tree.map(jnp.asarray, tree)
    tm = build_model(cfg)
    tp = from_jax_params(tree, cfg, device="cpu")
    return jm, jp, tm, tp


def _pages(cache):
    return {k: v for k, v in cache["seg0"].items()}


MOE = ["grok-1-314b-smoke", "kimi-k2-1t-a32b-smoke"]


@pytest.mark.parametrize("name", ["llama3.2-1b-smoke", "qwen2-0.5b-smoke"] + MOE)
def test_paged_prefill_and_decode_match_jax(name):
    _paged_parity(name)


QUANT_CASES = {  # id -> (arch, Config.precision, KV page type)
    "llama-int8": ("llama3.2-1b-smoke", "int8", None),
    "llama-int8_all": ("llama3.2-1b-smoke", "int8_all", None),
    "llama-int8_tensor": ("llama3.2-1b-smoke", "int8_tensor", None),
    "llama-fp8-fp8_pages": ("llama3.2-1b-smoke", "fp8", "fp8_e4m3"),
    "llama-fp8_pages": ("llama3.2-1b-smoke", "none", "fp8_e4m3"),
    "qwen2-int8": ("qwen2-0.5b-smoke", "int8", None),
    "grok-int8": ("grok-1-314b-smoke", "int8", None),
    "grok-int8_all-int8_pages": ("grok-1-314b-smoke", "int8_all", "int8"),
}


@pytest.mark.parametrize("case", sorted(QUANT_CASES))
def test_quantized_paged_prefill_and_decode_match_jax(case):
    """A declared `Config.precision` (every block projection and the MoE
    experts; the head stays full) and int8 / fp8 KV pages: logits and the
    written page payloads and scales against JAX's."""
    _paged_parity(*QUANT_CASES[case])


def _kv_quant(kv):
    from repro.core.precision import QuantSpec as JQuantSpec
    from repro_torch.core.precision import QuantSpec

    if kv is None:
        return {}, {}
    return dict(kv_quant=JQuantSpec(kv)), dict(kv_quant=QuantSpec(kv))


def _pages_close(tc, jc):
    """Every page pool as written, in its own dtype: quantized payloads
    compared as their f32 values (so equal), f32 pages and scale pages
    within the tolerance."""
    for k, v in _pages(tc).items():
        want = np.asarray(jc["seg0"][k])
        assert str(v.dtype).removeprefix("torch.") == str(want.dtype), k
        np.testing.assert_allclose(v.float().numpy(), want.astype(np.float32), **TOL)


def _paged_parity(name, precision="none", kv=None):
    cfg = get_config(name)
    jm, jp, tm, tp = _models(name, precision=precision)
    jkw, tkw = _kv_quant(kv)
    ps, B = 4, 3
    pool = PagePool(12, ps)
    pool.reserve(0, 12)
    pool.reserve(1, 12)  # slot 2 stays free: dump-page table row, length 0
    table = pool.page_table(B, 4)
    rng = np.random.default_rng(1)
    jc = jm.make_paged_cache(pool.total_pages, ps, dtype=jnp.float32, **jkw)
    tc = tm.make_paged_cache(pool.total_pages, ps, device="cpu", **tkw)

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
    _pages_close(tc, jc)

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
    _pages_close(tc, jc)


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


@pytest.mark.parametrize("name", ["llama3.2-1b-smoke", "qwen2-0.5b-smoke"] + MOE)
def test_full_forward_matches_jax(name):
    """`DecoderLM.__call__` (the draft model's forward) against JAX's
    `model(params, tokens)`: f32 logits, and the aux loss -- the MoE
    blocks' summed load-balancing losses, zero for dense blocks."""
    cfg = get_config(name)
    jm, jp, tm, tp = _models(name)
    toks = np.random.default_rng(3).integers(0, cfg.vocab, (2, 11)).astype(np.int32)
    jl, jaux = jm(jp, jnp.asarray(toks))
    tl, taux = tm(tp, torch.from_numpy(toks).long())
    assert tl.dtype == torch.float32 and tuple(tl.shape) == (2, 11, cfg.vocab)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **TOL)
    np.testing.assert_allclose(float(taux), float(jaux), **TOL)
    assert (float(taux) > 0) == (name in MOE)


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


@pytest.mark.parametrize("kv", ["f32", "int8", "fp8_e4m3"])
def test_verify_step_paged_matches_jax(kv):
    """A prefill chunk, then one speculative window of S = 4 over three
    slots (slot 2 free), through both packages: logits and every written
    page -- int8 / fp8 payloads and scale pages included -- agree."""
    _verify_parity("llama3.2-1b-smoke", kv)


@pytest.mark.parametrize("name", MOE)
def test_moe_verify_step_paged_matches_jax(name):
    """The same window over MoE blocks: 3 slots x 4 rows through routing
    (G = 1) and the expert GEMMs."""
    _verify_parity(name, "f32")


def _verify_parity(name, kv):
    from repro.core.precision import QuantSpec as JQuantSpec
    from repro_torch.core.precision import QuantSpec

    cfg = get_config(name)
    jm, jp, tm, tp = _models(name)
    ps, B, S = 4, 3, 4
    pool = PagePool(12, ps)
    pool.reserve(0, 16)
    pool.reserve(1, 16)
    table = pool.page_table(B, 5)  # wider than the slots' pages: dump-page pad
    jkw = dict(kv_quant=JQuantSpec(kv)) if kv != "f32" else {}
    tkw = dict(kv_quant=QuantSpec(kv)) if kv != "f32" else {}
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
    _pages_close(tc, jc)

    # row 0 of the window is the plain decode step on the same state
    tc0 = tm.make_paged_cache(pool.total_pages, ps, device="cpu", **tkw)
    tm.prefill_step_paged(tp, torch.from_numpy(toks).long(), tc0,
                          torch.tensor([0, 3]), torch.from_numpy(table[:2]))
    dl, _ = tm.decode_step_paged(tp, torch.from_numpy(win[:, :1]).long(), tc0,
                                 torch.from_numpy(index).long(), torch.from_numpy(table),
                                 torch.from_numpy(np.where(lengths > 0, index + 1, 0)
                                                  .astype(np.int32)))
    np.testing.assert_allclose(dl[:, 0].numpy(), tl[:, 0].numpy(), **TOL)


@pytest.mark.parametrize("name", MOE)
def test_from_jax_params_carries_moe_trees(name):
    """Router and expert stacks keep the JAX layout, (n_layers, E, d, f)."""
    cfg = get_config(name)
    tree = jax.tree.map(np.asarray, j_build(j_get_config(name)).init(jax.random.PRNGKey(0)))
    tp = from_jax_params(tree, cfg, device="cpu")
    ffn = tp["seg0"]["ffn"]
    assert set(ffn) == {"router", "wi", "wg", "wo"}
    n = cfg.blocks[0][1]
    assert tuple(ffn["wi"].shape) == (n, cfg.n_experts, cfg.d_model, cfg.d_ff)
    assert tuple(ffn["wo"].shape) == (n, cfg.n_experts, cfg.d_ff, cfg.d_model)
    assert tuple(ffn["router"].shape) == (n, cfg.d_model, cfg.n_experts)
    for k in ffn:
        np.testing.assert_array_equal(ffn[k].numpy(), tree["seg0"]["ffn"][k])
    assert tuple(tp["lm_head"].shape) == (cfg.d_model, cfg.vocab)  # untied head
    del tree["seg0"]["ffn"]["wg"]
    with pytest.raises(ValueError, match="keys"):
        from_jax_params(tree, cfg, device="cpu")


@pytest.mark.parametrize("name", ["llama3.2-1b-smoke"] + MOE)
def test_stacked_init_fills_in_place_with_the_per_layer_values(name):
    """`Builder.stacked` draws each layer into a preallocated stack; every
    leaf equals what building the layers one by one and stacking them gave."""
    from repro_torch.models.modules import Builder
    from repro_torch.models.transformer import make_block

    cfg = get_config(name)
    tp = build_model(cfg).init(5, device="cpu")
    layers = [make_block(cfg.blocks[0][0], cfg).build(
        Builder(5, torch.device("cpu"), path=("seg0", str(i)))) for i in range(cfg.blocks[0][1])]

    def check(got, parts, path):
        if isinstance(got, dict):
            for k in got:
                check(got[k], [p[k] for p in parts], path + (k,))
        else:
            assert torch.equal(got, torch.stack(parts)), path

    check(tp["seg0"], layers, ())


@pytest.mark.parametrize("name", ["llama3.2-1b-smoke", "grok-1-314b-smoke"])
def test_ambient_precision_reaches_the_untied_head_only(name):
    """Under an ambient use_precision("int8") JAX quantizes grok's untied
    head (ops.linear with no declaration) and never the tied head
    (Embedding.attend); a config-declared precision leaves either head at
    full precision.  The heads of both packages on the same input, and
    grok's whole forward under the ambient context."""
    from repro.core.precision import use_precision as j_use_precision
    from repro_torch.core.precision import use_precision

    cfg = get_config(name)
    jm, jp, tm, tp = _models(name)
    jm_d, jp_d, tm_d, tp_d = _models(name, precision="int8")
    x = np.random.default_rng(8).standard_normal((2, 5, cfg.d_model)).astype(np.float32)
    jx, tx = jnp.asarray(x), torch.from_numpy(x)
    full = tm._head(tp, tx)
    with j_use_precision("int8"), use_precision("int8"):
        for jmod, jpar, tmod, tpar in ((jm, jp, tm, tp), (jm_d, jp_d, tm_d, tp_d)):
            got = tmod._head(tpar, tx)
            np.testing.assert_allclose(got.numpy(), np.asarray(jmod._head(jpar, jx)), **TOL)
            assert torch.equal(got, full) == cfg.tie_embeddings
    for jmod, jpar, tmod, tpar in ((jm, jp, tm, tp), (jm_d, jp_d, tm_d, tp_d)):
        assert torch.equal(tmod._head(tpar, tx), full)  # no context: full precision
    if not cfg.tie_embeddings:
        toks = np.random.default_rng(9).integers(0, cfg.vocab, (2, 7)).astype(np.int32)
        with j_use_precision("int8"):
            jl, jaux = jm(jp, jnp.asarray(toks))
        with use_precision("int8"):
            tl, taux = tm(tp, torch.from_numpy(toks).long())
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **TOL)
        np.testing.assert_allclose(float(taux), float(jaux), **TOL)


def test_transformer_block_precision_declaration_matches_jax():
    """A block declaring "int8" (every attention and MLP projection)
    against JAX's, and against the same block at full precision."""
    from repro.models.transformer import TransformerBlock as JBlock
    from repro_torch.models.transformer import TransformerBlock

    kw = dict(d_model=64, n_heads=4, n_kv_heads=2, d_ff=128)
    jparams = JBlock(**kw).init(jax.random.PRNGKey(0))
    tparams = jax.tree.map(lambda a: torch.from_numpy(np.array(a)), jparams)
    x = np.random.default_rng(1).standard_normal((2, 8, 64)).astype(np.float32)
    for prec in ("int8", "int8_all", "fp8"):
        jy, jaux = JBlock(**kw, precision=prec)(jparams, jnp.asarray(x))
        ty, taux = TransformerBlock(**kw, precision=prec)(tparams, torch.from_numpy(x))
        np.testing.assert_allclose(ty.numpy(), np.asarray(jy), **TOL)
        assert float(taux) == float(jaux) == 0.0
    full, _ = TransformerBlock(**kw)(tparams, torch.from_numpy(x))
    assert not torch.allclose(full, ty, rtol=1e-5, atol=1e-5)
