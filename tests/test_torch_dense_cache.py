"""The dense-cache slice against JAX: Mamba2 blocks, the dense K/V cache
steps of `Attention` / `DecoderLM` (and zamba2's weight-tied shared block),
the dense continuous batcher and the static launcher, on the same numpy
inputs and JAX weights carried across with `from_jax_params`.

Tolerance: rtol = atol = 1e-5 in f32 for steps, blocks and logits (the
port's other model parities); token streams, finish reasons, events and
launcher samples exactly equal.  The zamba2 forward over two SSD chunks
(150 tokens) is held at 3e-5: its logits (max |ref| 0.74) differ by up to
8.9e-6, at position 88 of the first chunk, where 24 tokens differ by 2.2e-6.
The gap grows with the number of terms each sum runs over -- the chunk's
masked product sums up to 128 positions and the shared block's attention
up to 150 keys, in another order in each package -- and not with the
chunk boundary: the second chunk's positions differ by 3.9e-6, and
running the port with JAX's cumsum leaves the gap where it is (measured
on this smoke model)."""
import argparse
import contextlib
import io

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import get_config as j_get_config  # noqa: E402
from repro.launch import serve as j_serve  # noqa: E402
from repro.models import build_model as j_build  # noqa: E402
from repro.models.layers import Attention as JAttention  # noqa: E402
from repro.models.ssm import Mamba2Block as JMamba2  # noqa: E402
from repro.runtime.batcher import ContinuousBatcher as JBatcher  # noqa: E402
from repro.runtime.lifecycle import Request as JRequest  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.core import ops  # noqa: E402
from repro_torch.launch import serve  # noqa: E402
from repro_torch.launch.steps import make_prefill_step  # noqa: E402
from repro_torch.models import build_model, from_jax_params  # noqa: E402
from repro_torch.models.layers import Attention  # noqa: E402
from repro_torch.models.ssm import Mamba2Block  # noqa: E402
from repro_torch.runtime.batcher import ContinuousBatcher  # noqa: E402
from repro_torch.runtime.lifecycle import Request  # noqa: E402

TOL = dict(rtol=1e-5, atol=1e-5)
ZAMBA = "zamba2-2.7b-smoke"
LLAMA = "llama3.2-1b-smoke"
XLSTM = "xlstm-125m-smoke"
INTERNVL = "internvl2-26b-smoke"


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
            jm = j_build(j_get_config(name))
            jp = jm.init(jax.random.PRNGKey(0))
            cfg = get_config(name)
            out[name] = (jm, jp, build_model(cfg),
                         from_jax_params(_np_tree(jp), cfg, device="cpu"))
        return out[name]

    return get


# ---------------------------------------------------------------------------
# blocks
# ---------------------------------------------------------------------------


def test_mamba2_block_call_and_decode_match_jax():
    """zamba2-smoke's Mamba2 block (d_model 64, state 16, 2 heads of 64):
    the chunked full-sequence call, then five recurrent decode steps with
    their conv window and SSM state."""
    cfg = get_config(ZAMBA)
    jblk = JMamba2(cfg.d_model, d_state=cfg.ssm_state, chunk=cfg.ssm_chunk)
    jp = jblk.init(jax.random.PRNGKey(3))
    rng = np.random.default_rng(3)
    jp = dict(jp, a_log=jnp.asarray(rng.standard_normal(jp["a_log"].shape) * 0.5,
                                    jnp.float32),
              dt_bias=jnp.asarray(rng.standard_normal(jp["dt_bias"].shape) * 0.5,
                                  jnp.float32))
    blk = Mamba2Block(cfg.d_model, d_state=cfg.ssm_state, chunk=cfg.ssm_chunk)
    tp = _torch_tree(jp)
    x = rng.standard_normal((2, 20, cfg.d_model)).astype(np.float32)
    np.testing.assert_allclose(blk(tp, torch.from_numpy(x)).numpy(),
                               np.asarray(jblk(jp, jnp.asarray(x))), **TOL)
    jstate = jblk.init_state(2)
    state = blk.init_state(2, device="cpu")
    for t in range(5):
        jy, jstate = jblk.decode(jp, jnp.asarray(x[:, t:t + 1]), jstate)
        y, state = blk.decode(tp, torch.from_numpy(x[:, t:t + 1]), state)
        np.testing.assert_allclose(y.numpy(), np.asarray(jy), **TOL)
        for k in ("conv", "ssm"):
            np.testing.assert_allclose(state[k].numpy(), np.asarray(jstate[k]), **TOL)


@pytest.mark.parametrize("cache_dtype", ["float32", "bfloat16"])
def test_dense_attention_decode_and_prefill_match_jax(cache_dtype):
    """A 6-token prefill chunk at index 2, a decode step at a scalar index
    and one at per-slot indices, over a GQA cache that starts random (the
    mask must hide what was never written); a bf16 cache promotes as
    jnp.einsum does."""
    jatt = JAttention(64, 4, 2, 16)
    jp = jatt.init(jax.random.PRNGKey(5))
    att = Attention(64, 4, 2, 16)
    tp = _torch_tree(jp)
    rng = np.random.default_rng(5)
    B, Smax = 3, 12
    k0 = rng.standard_normal((B, Smax, 2, 16)).astype(np.float32)
    v0 = rng.standard_normal((B, Smax, 2, 16)).astype(np.float32)
    jdt = getattr(jnp, cache_dtype)
    jcache = {"k": jnp.asarray(k0, jdt), "v": jnp.asarray(v0, jdt)}
    cache = {"k": torch.from_numpy(k0).to(getattr(torch, cache_dtype)),
             "v": torch.from_numpy(v0).to(getattr(torch, cache_dtype))}
    x = rng.standard_normal((B, 6, 64)).astype(np.float32)
    res = rng.standard_normal((B, 6, 64)).astype(np.float32)
    jo, jcache = jatt.prefill(jp, jnp.asarray(x), jcache, 2, residual=jnp.asarray(res))
    o, cache = att.prefill(tp, torch.from_numpy(x), cache, 2, residual=torch.from_numpy(res))
    np.testing.assert_allclose(o.numpy(), np.asarray(jo), **TOL)
    for index in (8, np.array([8, 3, 11])):
        xd = rng.standard_normal((B, 1, 64)).astype(np.float32)
        jo, jcache = jatt.decode(jp, jnp.asarray(xd), jcache, jnp.asarray(index))
        o, cache = att.decode(tp, torch.from_numpy(xd), cache, torch.as_tensor(index))
        np.testing.assert_allclose(o.numpy(), np.asarray(jo), **TOL)
    for k in ("k", "v"):
        np.testing.assert_allclose(cache[k].float().numpy(),
                                   np.asarray(jcache[k].astype(jnp.float32)), **TOL)


# ---------------------------------------------------------------------------
# the stack
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("name", [LLAMA, "qwen2-0.5b-smoke", "grok-1-314b-smoke", ZAMBA,
                                  INTERNVL])
def test_decoder_cache_steps_match_jax(models, name):
    """make_cache / prefill_step (attention-only models: a 5-token chunk) /
    decode_step at a scalar, then per-slot, index; every step's logits and
    the final cache at 1e-5.  zamba2 steps its prompt token by token and
    refuses the chunk, as JAX does."""
    jm, jp, tm, tp = models(name)
    cfg = get_config(name)
    rng = np.random.default_rng(1)
    B, Smax = 2, 12
    toks = rng.integers(0, cfg.vocab, (B, 9)).astype(np.int32)
    jc = jm.make_cache(B, Smax, mode="init", dtype=jnp.float32)
    tc = tm.make_cache(B, Smax, dtype=torch.float32, device="cpu")
    assert jax.tree.map(lambda a: a.shape, jc) == jax.tree.map(lambda a: tuple(a.shape), tc)
    t = 0
    if tm.supports_chunked_prefill():
        jl, jc = jm.prefill_step(jp, jnp.asarray(toks[:, :5]), jc, 0)
        tl, tc = tm.prefill_step(tp, torch.from_numpy(toks[:, :5]).long(), tc, 0)
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **TOL)
        t = 5
    else:
        assert not jm.supports_chunked_prefill()
        with pytest.raises(ValueError, match="chunked prefill"):
            tm.prefill_step(tp, torch.from_numpy(toks[:, :5]).long(), tc, 0)
    for i in range(t, 9):
        index = i if i < 7 else np.array([i, i - 1])  # scalar, then per slot
        jl, jc = jm.decode_step(jp, jnp.asarray(toks[:, i:i + 1]), jc, jnp.asarray(index))
        tl, tc = tm.decode_step(tp, torch.from_numpy(toks[:, i:i + 1]).long(), tc,
                                torch.as_tensor(index))
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **TOL)
    jflat = jax.tree_util.tree_leaves_with_path(jc)
    tflat = dict(jax.tree_util.tree_leaves_with_path(_np_tree(tc)))
    for path, leaf in jflat:
        np.testing.assert_allclose(tflat[path], np.asarray(leaf), **TOL, err_msg=str(path))


@pytest.mark.parametrize("name", [LLAMA, ZAMBA])
def test_decode_matches_forward(models, name):
    """Token-stepping decode equals the full forward at every position
    (tests/test_decode.py's parity, here at 1e-5)."""
    _, _, tm, tp = models(name)
    cfg = get_config(name)
    toks = torch.from_numpy(np.random.default_rng(2).integers(0, cfg.vocab, (2, 10))).long()
    full, _ = tm(tp, toks)
    cache = tm.make_cache(2, 12, dtype=torch.float32, device="cpu")
    for t in range(10):
        lg, cache = tm.decode_step(tp, toks[:, t:t + 1], cache, t)
        np.testing.assert_allclose(lg[:, 0].numpy(), full[:, t].numpy(), **TOL)


@pytest.mark.parametrize("L,tol", [(24, 1e-5), (150, 3e-5)])
def test_zamba2_forward_matches_jax(models, L, tol):
    """zamba2's full forward (4 Mamba2 layers, the shared block after every
    2) through `make_prefill_step`, on the plain path and under "cuda_mx"
    (the kernel wrappers' CPU paths)."""
    jm, jp, tm, tp = models(ZAMBA)
    cfg = get_config(ZAMBA)
    toks = np.random.default_rng(L).integers(0, cfg.vocab, (2, L)).astype(np.int32)
    want = np.asarray(jm(jp, jnp.asarray(toks))[0])
    step = make_prefill_step(tm, cfg)
    for policy in ("torch", "cuda_mx"):
        with ops.use_policy(ops.MXPolicy(policy)):
            got = step(tp, {"tokens": torch.from_numpy(toks).long()}).numpy()
        np.testing.assert_allclose(got, want, rtol=tol, atol=tol, err_msg=policy)


# ---------------------------------------------------------------------------
# the dense continuous batcher
# ---------------------------------------------------------------------------


def _script(b, make_req, vocab):
    """More requests than slots (slot reuse), a request that runs into
    max_len, a preemption and a cancel, and a request admitted late into a
    slot left free for several steps."""
    rng = np.random.default_rng(13)

    def prompt(n):
        return rng.integers(0, vocab, n).astype(np.int32)

    b.submit(make_req(rid=0, prompt=prompt(3), max_new=5))
    b.submit(make_req(rid=1, prompt=prompt(5), max_new=3))
    b.submit(make_req(rid=2, prompt=prompt(2), max_new=4))
    b.submit(make_req(rid=3, prompt=prompt(6), max_new=20))  # hits max_len
    for _ in range(4):
        b.step()
    b.preempt(1)
    b.submit(make_req(rid=4, prompt=prompt(4), max_new=3))
    b.step()
    b.cancel(2)
    while b.queue or b.active > 1:
        b.step()
    for _ in range(3):  # one slot stays free while rid 3 decodes
        b.step()
    b.submit(make_req(rid=5, prompt=prompt(4), max_new=4))  # the late admission
    return b.run_to_completion()


def _dense_pair(models, name, script=_script):
    jm, jp, tm, tp = models(name)
    vocab = get_config(name).vocab
    kw = dict(batch_slots=2, max_len=16)
    jb = JBatcher(jm, jp, cache_dtype=jnp.float32, **kw)
    jfin = script(jb, JRequest, vocab)
    tb = ContinuousBatcher(tm, tp, paged=False, **kw)
    tfin = script(tb, Request, vocab)
    return jb, jfin, tb, tfin


@pytest.mark.parametrize("name", [LLAMA, ZAMBA, XLSTM, INTERNVL])
def test_dense_batcher_matches_jax(models, name):
    jb, jfin, tb, tfin = _dense_pair(models, name)
    assert sorted(tfin) == sorted(jfin) == list(range(6))
    for rid in jfin:
        j, t = jfin[rid], tfin[rid]
        assert (t.output, t.finish_reason, t.preemptions, t.events) == \
            (j.output, j.finish_reason, j.preemptions, j.events), rid
    reasons = {r.finish_reason for r in tfin.values()}
    assert {"max_new", "max_len", "cancelled"} <= reasons
    assert tb.steps_run == jb.steps_run and tb.pool_stats() is None
    js, ts = jb.health_summary(), tb.health_summary()
    for key in ts:
        if key != "stragglers":  # wall-clock watchdog
            assert ts[key] == js[key], key


def _alone(models, name, rid):
    """Request `rid` of `_script` served alone in a fresh dense batcher."""
    got = {}

    def capture(b, make_req, vocab):
        fin = _script(b, make_req, vocab)
        got["req"] = fin[rid]
        return fin

    _, _, tm, tp = models(name)
    _dense_pair(models, name, capture)
    req = got["req"]
    b = ContinuousBatcher(tm, tp, paged=False, batch_slots=2, max_len=16)
    b.submit(Request(rid=rid, prompt=req.prompt, max_new=req.max_new))
    return req.output, b.run_to_completion()[rid].output


def test_late_admission_into_a_free_slot(models):
    """Pinned as JAX does it (test_dense_batcher_matches_jax holds the
    streams equal): a free slot steps token 0 at index 0 and is reset at
    finish / preempt, not at admission.  An attention cache hides what the
    free steps wrote (the next request overwrites position 0 first: llama,
    and internvl2 served text only); a recurrent state drifts while its
    slot is free (Mamba2's conv window and SSM state, xLSTM's C, n, h, c
    and maxima, the maxima reset to 0 rather than -1e30), so zamba2's and
    xlstm's late requests decode from a state that is not their initial
    one and their streams differ from the same request served alone."""
    for name in (LLAMA, INTERNVL):
        late, alone = _alone(models, name, 5)
        assert late == alone, name
    for name in (ZAMBA, XLSTM):
        late, alone = _alone(models, name, 5)
        assert late != alone, name


def test_slot_reset_zeroes_the_xlstm_maxima_as_jax_does(models):
    """A finished dense slot has every cache leaf zeroed, xLSTM's running
    maxima m included: 0, not the initial -1e30, in both packages (JAX's
    _reset_slot_cache zeroes every leaf).  The other slot, free throughout,
    has stepped token 0 from -1e30 and drifted (not compared here)."""
    jm, jp, tm, tp = models(XLSTM)
    prompt = np.arange(1, 5, dtype=np.int32)
    caches = []
    for cls, req, kw in ((JBatcher, JRequest, dict(cache_dtype=jnp.float32)),
                         (ContinuousBatcher, Request, dict(paged=False))):
        b = cls(*((jm, jp) if cls is JBatcher else (tm, tp)), batch_slots=2, max_len=8, **kw)
        b.submit(req(rid=0, prompt=prompt, max_new=2))
        fin = b.run_to_completion()
        assert fin[0].finish_reason == "max_new"
        caches.append(b.cache)
    jc, tc = caches
    assert {key for seg in tc.values() for key in seg} == {"C", "n", "m", "h", "c"}
    for seg in tc:
        for key, t in tc[seg].items():
            assert not t[:, 0].any() and not np.asarray(jc[seg][key])[:, 0].any(), (seg, key)


def test_dense_and_paged_llama_streams_are_equal(models):
    """The port's dense and paged backends on one trace (JAX's
    test_kv_pages parity)."""
    _, _, tm, tp = models(LLAMA)
    cfg = get_config(LLAMA)

    def run(**kw):
        b = ContinuousBatcher(tm, tp, batch_slots=2, max_len=16, **kw)
        for r in serve.make_trace(cfg, 5, 8, 4, prefix_cache=False):
            b.submit(r)
        return {r: v.output for r, v in b.run_to_completion().items()}

    dense = run(paged=False)
    assert run(paged=True, page_size=4) == dense
    assert run(paged=True, page_size=4, prefix_cache=True, prefill_chunk=3) == dense


def test_dense_batcher_refuses_page_options(models):
    """The prefix cache, chunked prefill, speculation and kv_quant need the
    page pool (ValueError, as in JAX); zamba2 has no paged path."""
    from repro_torch.core.precision import QuantSpec

    _, _, tm, tp = models(LLAMA)
    for bad in (dict(prefix_cache=True), dict(prefill_chunk=4), dict(speculate=2),
                dict(kv_quant=QuantSpec("int8"))):
        with pytest.raises(ValueError):
            ContinuousBatcher(tm, tp, batch_slots=1, max_len=8, paged=False, **bad)
    _, _, zm, zp = models(ZAMBA)
    with pytest.raises(ValueError, match="paged"):
        ContinuousBatcher(zm, zp, batch_slots=1, max_len=8, paged=True)


def test_dense_batcher_with_abft_streams_equal(models):
    """abft=True on the dense step (under "cuda_mx", the checksummed plain
    GEMMs on the CPU) gives the streams of abft=False and flags nothing."""
    _, _, tm, tp = models(ZAMBA)
    cfg = get_config(ZAMBA)

    def run(abft):
        with ops.use_policy(ops.MXPolicy("cuda_mx")):
            b = ContinuousBatcher(tm, tp, batch_slots=2, max_len=12, paged=False, abft=abft)
            for r in serve.make_trace(cfg, 3, 6, 3, prefix_cache=False):
                b.submit(r)
            fin = b.run_to_completion()
        return {r: v.output for r, v in fin.items()}, b.health_summary()["abft"]

    plain, _ = run(False)
    checked, counters = run(True)
    assert checked == plain
    assert counters == {"sdc_detected": 0, "sdc_corrected": 0}


# ---------------------------------------------------------------------------
# the static launcher
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("arch,extra", [("llama3.2-1b", ["--prefill-chunk", "8"]),
                                        ("zamba2-2.7b", []), ("xlstm-125m", []),
                                        ("internvl2-26b", []), ("seamless-m4t-medium", [])])
def test_static_launcher_matches_jax(models, arch, extra):
    """JAX `serve.main`'s static path (bf16 dense cache, chunked prefill for
    llama, token stepping for the others; seamless decodes against the
    encoder output of 32 frames drawn after the prompt) and the port's on
    JAX's weights: the printed sample tokens are equal."""
    argv = ["--arch", arch, "--smoke", "--batch", "2", "--prompt-len", "12", "--gen", "6",
            *extra]
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        assert j_serve.main(argv) == 0
    want = [ln for ln in buf.getvalue().splitlines() if ln.startswith("sample:")]
    _, _, tm, tp = models(arch + "-smoke")
    args = argparse.Namespace(batch=2, prompt_len=12, gen=6, max_len=None,
                              prefill_chunk=int(extra[1]) if extra else 0)
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        assert serve._run_static(tm, get_config(arch + "-smoke"), tp, args) == 0
    got = [ln for ln in buf.getvalue().splitlines() if ln.startswith("sample:")]
    assert len(want) == 1 and got == want


def test_shared_block_is_tied_and_cached_per_application(models):
    """zamba2-smoke: one shared parameter tree, and a dense K/V cache per
    application (4 layers / every 2 = 2)."""
    _, jp, tm, tp = models(ZAMBA)
    assert set(tp) == set(jp) and "shared" in tp
    cache = tm.make_cache(3, 7, device="cpu")
    assert cache["shared0"]["k"].shape == (2, 3, 7, 4, 16)
    assert cache["shared0"]["k"].dtype == torch.bfloat16  # JAX's default
    assert cache["seg0"]["ssm"].shape == (4, 3, 2, 16, 64)
    assert cache["seg0"]["ssm"].dtype == torch.float32
