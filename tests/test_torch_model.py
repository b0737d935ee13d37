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
