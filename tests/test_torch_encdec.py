"""The encoder-decoder (seamless) and the modality prefix (internvl2)
against JAX: cross-attention (`Attention.__call__(kv=)`), `EncDecLM`'s
encode / forward / decode steps, the prefix forward through
`frontend_proj`, the step builders of `launch/steps.py`, and every
registry config's tree, on the same numpy inputs and JAX weights carried
across with `from_jax_params`.

Tolerance: rtol = atol = 1e-5 in f32 (the port's other model parities).
Measured on 150-token inputs: seamless-smoke's logits 3.4e-7 apart at max
|ref| 0.65, internvl2-smoke's prefix forward 7.1e-6 at max |ref| 4.8."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro import configs as j_configs  # noqa: E402
from repro.launch import steps as j_steps  # noqa: E402
from repro.models import build_model as j_build  # noqa: E402
from repro.models.layers import Attention as JAttention  # noqa: E402
from repro_torch.configs import ARCH_IDS, get_config  # noqa: E402
from repro_torch.core import ops  # noqa: E402
from repro_torch.launch import steps  # noqa: E402
from repro_torch.models import EncDecLM, build_model, from_jax_params  # noqa: E402
from repro_torch.models.layers import Attention  # noqa: E402

TOL = dict(rtol=1e-5, atol=1e-5)
SEAMLESS = "seamless-m4t-medium-smoke"
INTERNVL = "internvl2-26b-smoke"
POLICIES = ("torch", "cuda_mx")  # cuda_mx: the kernel wrappers' CPU paths


def _np_tree(tree):
    return jax.tree.map(np.array, tree)


def _torch_tree(tree):
    return jax.tree.map(lambda a: torch.from_numpy(np.array(a)), tree)


@pytest.fixture(scope="module")
def models():
    """(JAX model, JAX params, port model, port params) per smoke config."""
    out = {}

    def get(name):
        if name not in out:
            jm = j_build(j_configs.get_config(name))
            jp = jm.init(jax.random.PRNGKey(0))
            cfg = get_config(name)
            out[name] = (jm, jp, build_model(cfg),
                         from_jax_params(_np_tree(jp), cfg, device="cpu"))
        return out[name]

    return get


# ---------------------------------------------------------------------------
# cross-attention
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("Sk,repeated,threshold", [
    (9, False, 2048),   # GQA K/V (2 kv heads for 4 query heads), full form
    (9, True, 2048),    # K/V already repeated to the query heads (JAX's _enc_kv)
    (1, False, 2048),   # one key
    (20, False, 8),     # past the chunk threshold: the online-softmax form
])
def test_cross_attention_matches_jax(Sk, repeated, threshold):
    """`Attention.__call__(kv=)`: no causal mask, no rope (seamless's
    cross-attention module), q from x, K / V given, the residual fused; Lq
    = 5 against Sk keys, and Lq = 1 (a decode step)."""
    jatt = JAttention(64, 4, 2, 16, causal=False, use_rope=False,
                      chunked_threshold=threshold)
    jp = jatt.init(jax.random.PRNGKey(3))
    att = Attention(64, 4, 2, 16, causal=False, use_rope=False, chunked_threshold=threshold)
    tp = _torch_tree(jp)
    rng = np.random.default_rng(Sk)
    hk = 4 if repeated else 2
    k = rng.standard_normal((2, Sk, hk, 16)).astype(np.float32)
    v = rng.standard_normal((2, Sk, hk, 16)).astype(np.float32)
    for Lq in (5, 1):
        x = rng.standard_normal((2, Lq, 64)).astype(np.float32)
        res = rng.standard_normal((2, Lq, 64)).astype(np.float32)
        want = np.asarray(jatt(jp, jnp.asarray(x), kv=(jnp.asarray(k), jnp.asarray(v)),
                               residual=jnp.asarray(res)))
        for policy in POLICIES:
            with ops.use_policy(ops.MXPolicy(policy)):
                got = att(tp, torch.from_numpy(x), kv=(torch.from_numpy(k), torch.from_numpy(v)),
                          residual=torch.from_numpy(res))
            np.testing.assert_allclose(got.numpy(), want, **TOL, err_msg=f"{policy} Lq={Lq}")


def test_cross_attention_projects_q_alone(monkeypatch):
    """JAX's cross-attention also projects x's own k and v and drops them;
    the port projects q and the output only (a deliberate difference: the
    same function, two GEMMs fewer)."""
    att = Attention(64, 4, 4, 16, causal=False, use_rope=False)
    tp = att.init(0, device="cpu")
    names = []
    real = ops.linear
    monkeypatch.setattr(ops, "linear", lambda x, w, *a, **k: names.append(
        next(n for n, t in tp.items() if t is w)) or real(x, w, *a, **k))
    kv = torch.zeros((1, 3, 4, 16)), torch.zeros((1, 3, 4, 16))
    att(tp, torch.ones((1, 2, 64)), kv=kv)
    assert names == ["wq", "wo"]


# ---------------------------------------------------------------------------
# the encoder-decoder
# ---------------------------------------------------------------------------


def _frames(cfg, B, S, seed):
    return (np.random.default_rng(seed).standard_normal((B, S, cfg.frontend_dim))
            * 0.1).astype(np.float32)


def test_encdec_tree_and_cache_are_jaxs(models):
    jm, jp, tm, tp = models(SEAMLESS)
    assert isinstance(tm, EncDecLM)
    assert jax.tree.map(lambda a: a.shape, jp) == jax.tree.map(lambda a: tuple(a.shape), tp)
    assert set(tp["dec"]) >= {"ln_x", "xattn"} and "wq" in tp["dec"]["xattn"]
    jc = jm.make_cache(3, 7, mode="init")
    tc = tm.make_cache(3, 7, device="cpu")
    assert jax.tree.map(lambda a: (a.shape, str(a.dtype)), jc) == \
        jax.tree.map(lambda a: (tuple(a.shape), str(a.dtype).removeprefix("torch.")), tc)


@pytest.mark.parametrize("S_enc,S", [(12, 8), (40, 3)])
def test_encode_and_forward_match_jax(models, S_enc, S):
    """`encode` (frontend_proj, the non-causal encoder with rope, enc_ln)
    and the full forward (the decoder's causal self-attention and its
    cross-attention over every layer's K / V of the encoder output), also
    through `launch.steps.make_prefill_step` against JAX's."""
    jm, jp, tm, tp = models(SEAMLESS)
    cfg = get_config(SEAMLESS)
    frames = _frames(cfg, 2, S_enc, S_enc)
    toks = np.random.default_rng(S).integers(0, cfg.vocab, (2, S)).astype(np.int32)
    want_enc = np.asarray(jm.encode(jp, jnp.asarray(frames)))
    want = np.asarray(j_steps.make_prefill_step(jm, j_configs.get_config(SEAMLESS))(
        jp, {"frames": jnp.asarray(frames), "tokens": jnp.asarray(toks)}))
    step = steps.make_prefill_step(tm, cfg)
    for policy in POLICIES:
        with ops.use_policy(ops.MXPolicy(policy)):
            enc = tm.encode(tp, torch.from_numpy(frames))
            got = step(tp, {"frames": torch.from_numpy(frames),
                            "tokens": torch.from_numpy(toks).long()})
        np.testing.assert_allclose(enc.numpy(), want_enc, **TOL, err_msg=policy)
        np.testing.assert_allclose(got.numpy(), want, **TOL, err_msg=policy)


def test_decode_steps_match_jax_and_the_forward(models):
    """JAX's test_encdec_decode_matches_forward: eight tokens through
    `make_serve_step` against one encoder output, each step's logits equal
    JAX's and the forward's at 1e-5, and the self-attention cache equals
    JAX's (f32 cache)."""
    jm, jp, tm, tp = models(SEAMLESS)
    cfg = get_config(SEAMLESS)
    frames = _frames(cfg, 2, 12, 2)
    toks = np.random.default_rng(1).integers(0, cfg.vocab, (2, 8)).astype(np.int32)
    full, _ = tm(tp, torch.from_numpy(frames), torch.from_numpy(toks).long())
    jenc = jm.encode(jp, jnp.asarray(frames))
    enc = tm.encode(tp, torch.from_numpy(frames))
    jc = jm.make_cache(2, 10, mode="init", dtype=jnp.float32)
    tc = tm.make_cache(2, 10, dtype=torch.float32, device="cpu")
    jstep = j_steps.make_serve_step(jm, j_configs.get_config(SEAMLESS))
    tstep = steps.make_serve_step(tm, cfg)
    for t in range(8):
        index = t if t < 6 else np.array([t, t])  # scalar, then per slot
        jl, jc = jstep(jp, jc, jnp.asarray(toks[:, t:t + 1]), jnp.asarray(index), jenc)
        tl, tc = tstep(tp, tc, torch.from_numpy(toks[:, t:t + 1]).long(),
                       torch.as_tensor(index), enc)
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **TOL)
        np.testing.assert_allclose(tl[:, 0].numpy(), full[:, t].numpy(), **TOL)
    for key in ("k", "v"):
        np.testing.assert_allclose(tc["dec"][key].numpy(), np.asarray(jc["dec"][key]), **TOL)


def test_encdec_has_no_chunked_prefill_step():
    cfg = get_config(SEAMLESS)
    with pytest.raises(ValueError, match="decoder-only"):
        steps.make_chunked_prefill_step(build_model(cfg), cfg)


# ---------------------------------------------------------------------------
# the modality prefix (internvl2)
# ---------------------------------------------------------------------------


def _prefix_batch(cfg, B, S, seed):
    rng = np.random.default_rng(seed)
    return dict(tokens=rng.integers(0, cfg.vocab, (B, S)).astype(np.int32),
                pixel_embeds=rng.standard_normal((B, cfg.frontend_tokens, cfg.frontend_dim))
                .astype(np.float32))


@pytest.mark.parametrize("S", [6, 150])
def test_prefix_forward_matches_jax(models, S):
    """`__call__(prefix_embeds=)`: the projected prefix ahead of the token
    embeddings, causal attention over both; logits at every position
    (prefix included) equal JAX's."""
    jm, jp, tm, tp = models(INTERNVL)
    cfg = get_config(INTERNVL)
    b = _prefix_batch(cfg, 2, S, S)
    want = np.asarray(jm(jp, jnp.asarray(b["tokens"]),
                         prefix_embeds=jnp.asarray(b["pixel_embeds"]))[0])
    assert want.shape[1] == cfg.frontend_tokens + S
    for policy in POLICIES:
        with ops.use_policy(ops.MXPolicy(policy)):
            got, aux = tm(tp, torch.from_numpy(b["tokens"]).long(),
                          prefix_embeds=torch.from_numpy(b["pixel_embeds"]))
        np.testing.assert_allclose(got.numpy(), want, **TOL, err_msg=policy)
        assert float(aux) == 0.0


def test_prefix_prefill_step_matches_jax(models):
    """`make_prefill_step` on the pixel-embeds batch keeps the text
    positions only (logits[:, frontend_tokens:]), as JAX's forward does."""
    jm, jp, tm, tp = models(INTERNVL)
    cfg = get_config(INTERNVL)
    b = _prefix_batch(cfg, 2, 7, 0)
    want = np.asarray(j_steps.make_prefill_step(jm, j_configs.get_config(INTERNVL))(
        jp, {k: jnp.asarray(v) for k, v in b.items()}))
    got = steps.make_prefill_step(tm, cfg)(
        tp, {"tokens": torch.from_numpy(b["tokens"]).long(),
             "pixel_embeds": torch.from_numpy(b["pixel_embeds"])})
    assert got.shape == (2, 7, cfg.vocab) == want.shape
    np.testing.assert_allclose(got.numpy(), want, **TOL)


def test_decode_step_with_a_prefix_is_refused_as_jax_cannot_run_it(models):
    """JAX's decode_step(prefix_embeds=) raises a TypeError (Attention.decode
    reshapes the P + 1 rows as one token); the port refuses it with a
    ValueError that names the full forward.  Text-only decode (how JAX's
    launcher serves internvl2) runs and equals JAX's."""
    jm, jp, tm, tp = models(INTERNVL)
    cfg = get_config(INTERNVL)
    b = _prefix_batch(cfg, 2, 1, 1)
    jc = jm.make_cache(2, 16, mode="init", dtype=jnp.float32)
    with pytest.raises(TypeError, match="reshape"):
        jm.decode_step(jp, jnp.asarray(b["tokens"]), jc, 0,
                       prefix_embeds=jnp.asarray(b["pixel_embeds"]))
    tc = tm.make_cache(2, 16, dtype=torch.float32, device="cpu")
    with pytest.raises(ValueError, match="full forward"):
        tm.decode_step(tp, torch.from_numpy(b["tokens"]).long(), tc, 0,
                       prefix_embeds=torch.from_numpy(b["pixel_embeds"]))
    jl, _ = jm.decode_step(jp, jnp.asarray(b["tokens"]), jc, 0)
    tl, _ = tm.decode_step(tp, torch.from_numpy(b["tokens"]).long(), tc, 0)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **TOL)
    assert not tm.supports_paged() and not tm.supports_chunked_prefill()


# ---------------------------------------------------------------------------
# every configuration of the registry
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("name", ARCH_IDS)
def test_build_model_builds_every_full_config(name):
    """Every registry config builds at full width (shapes only, on the meta
    device) with JAX's tree: the same keys and shapes as `jax.eval_shape`
    of JAX's init."""
    tree = build_model(get_config(name)).init(0, device="meta")
    jm = j_build(j_configs.get_config(name))
    want = jax.eval_shape(lambda: jm.init(jax.random.PRNGKey(0)))
    assert jax.tree.map(lambda a: a.shape, want) == \
        jax.tree.map(lambda a: tuple(a.shape), tree)


@pytest.mark.parametrize("name", [a + "-smoke" for a in ARCH_IDS])
def test_from_jax_params_takes_every_smoke_tree(models, name):
    """JAX's `init` tree of every smoke config converts (the walk checks
    keys and shapes against the port's own build)."""
    _, jp, tm, tp = models(name)
    assert jax.tree.map(lambda a: a.shape, jp) == jax.tree.map(lambda a: tuple(a.shape), tp)
