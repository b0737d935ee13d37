"""Speculative decoding in the port against the JAX package: the drafters,
the greedy-exact accept rule and its accounting, the draft model's
proposals, and whole batcher traces, on the request mix and settings of
tests/test_speculative.py (3 slots, max_len 24, 4-token pages, prefill
chunks of 4).  The JAX batcher runs its Pallas kernels in interpret mode;
the port runs its CPU path.  Token streams, finish reasons, `SpecStats` and
`PoolStats` must be identical, and every speculative stream must equal the
port's own plain greedy stream."""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402

from repro.configs import get_config as j_get_config  # noqa: E402
from repro.core import ops as jops  # noqa: E402
from repro.core.precision import QuantSpec as JQuantSpec  # noqa: E402
from repro.models import build_model as j_build  # noqa: E402
from repro.runtime import speculative as jspec  # noqa: E402
from repro.runtime.batcher import ContinuousBatcher as JBatcher  # noqa: E402
from repro.runtime.lifecycle import Request as JRequest  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.core.precision import QuantSpec  # noqa: E402
from repro_torch.models import build_model, from_jax_params  # noqa: E402
from repro_torch.runtime import speculative as tspec  # noqa: E402
from repro_torch.runtime.batcher import ContinuousBatcher  # noqa: E402
from repro_torch.runtime.lifecycle import Request  # noqa: E402

NAME = "llama3.2-1b-smoke"
JAX_POLICY = jops.MXPolicy("pallas_mx", interpret=True, bm=16, bn=32, bk=16)
BASE = dict(batch_slots=3, max_len=24, page_size=4, prefill_chunk=4)


@pytest.fixture(scope="module")
def models():
    jm = j_build(j_get_config(NAME))
    jp = jm.init(jax.random.PRNGKey(0))
    tm = build_model(get_config(NAME))
    tp = from_jax_params(jax.tree.map(np.asarray, jp), get_config(NAME), device="cpu")
    return jm, jp, tm, tp


def _requests(make, vocab, n=5, seed=0, max_new=6):
    rng = np.random.default_rng(seed)
    return [make(rid=i, prompt=rng.integers(0, vocab, (6, 9, 13)[i % 3]).astype(np.int32),
                 max_new=max_new) for i in range(n)]


def _run(b, reqs, script=None):
    for r in reqs:
        b.submit(r)
    if script is not None:
        script(b)
    return b, {rid: (r.finish_reason, tuple(r.output))
               for rid, r in b.run_to_completion().items()}


def _port(tm, tp, n=5, max_new=6, script=None, **kw):
    b = ContinuousBatcher(tm, tp, **{**BASE, **kw})
    return _run(b, _requests(Request, get_config(NAME).vocab, n=n, max_new=max_new),
                script)


def _jax(jm, jp, n=5, max_new=6, script=None, **kw):
    b = JBatcher(jm, jp, paged=True, **{**BASE, **kw})
    with jops.use_policy(JAX_POLICY):
        return _run(b, _requests(JRequest, get_config(NAME).vocab, n=n, max_new=max_new),
                    script)


def _traces(out, n=5):
    reqs = _requests(Request, get_config(NAME).vocab, n=n)
    return [tuple(int(t) for t in r.prompt) + out[r.rid][1] for r in reqs]


# ---------------------------------------------------------------------------
# host-side pieces against the JAX package
# ---------------------------------------------------------------------------


def test_drafters_match_jax():
    rng = np.random.default_rng(0)
    for trial in range(40):
        # short alphabets repeat, so n-grams match at every length
        seq = rng.integers(0, 2 + trial % 5, int(rng.integers(1, 30))).astype(np.int32)
        for k in (0, 1, 4):
            for kw in (dict(), dict(max_n=2), dict(max_n=4, min_n=2)):
                np.testing.assert_array_equal(
                    tspec.NGramDrafter(**kw).propose(seq, k),
                    jspec.NGramDrafter(**kw).propose(seq, k))
    traces = [tuple(rng.integers(0, 50, 20)) for _ in range(3)]
    for overlap in (1.0, 0.5, 0.0):
        for seed in (0, 3):
            t = tspec.TraceDrafter(traces, overlap=overlap, seed=seed)
            j = jspec.TraceDrafter(traces, overlap=overlap, seed=seed)
            for tr in traces:
                for L in (0, 5, 19, 20):
                    hist = np.asarray(tr[:L], np.int32)
                    np.testing.assert_array_equal(t.propose(hist, 4), j.propose(hist, 4))
    with pytest.raises(ValueError):
        tspec.NGramDrafter(max_n=1, min_n=2)
    with pytest.raises(ValueError):
        tspec.TraceDrafter(traces, overlap=1.5)


def test_accept_greedy_and_spec_stats_match_jax():
    rng = np.random.default_rng(1)
    for _ in range(200):
        k = int(rng.integers(0, 6))
        rows = rng.integers(0, 3, k + 1)
        drafts = rng.integers(0, 3, k)
        assert tspec.accept_greedy(drafts, rows) == jspec.accept_greedy(drafts, rows)
    kw = dict(launches=4, windows=3, drafted=9, accepted=6, emitted=13)
    assert tspec.SpecStats(**kw).as_dict() == jspec.SpecStats(**kw).as_dict()
    assert tspec.SpecStats().as_dict() == jspec.SpecStats().as_dict()


@pytest.mark.parametrize("overlap", [1.0, 0.6])
def test_draft_model_proposer_matches_jax(models, overlap):
    """Greedy lookahead through the full forward of a draft model, with the
    JAX weights carried across: the same proposals (the numpy corruption
    draws are shared) and the same number of forwards."""
    jm, jp, tm, tp = models
    j = jspec.DraftModelProposer(jm, jp, max_context=8, overlap=overlap, seed=2)
    t = tspec.DraftModelProposer(tm, tp, max_context=8, overlap=overlap, seed=2)
    rng = np.random.default_rng(2)
    for n in (1, 3, 8, 13):
        seq = rng.integers(0, tm.cfg.vocab, n).astype(np.int32)
        np.testing.assert_array_equal(t.propose(seq, 3), j.propose(seq, 3))
    assert t.propose(np.zeros(0, np.int32), 3).size == 0
    assert t.forwards == j.forwards == 12


# ---------------------------------------------------------------------------
# whole batcher traces against the JAX batcher
# ---------------------------------------------------------------------------


def _same_as_jax(jb, jout, tb, tout):
    assert tout == jout
    assert tb.spec_stats() == jb.spec_stats()
    assert dataclasses.asdict(tb.pool_stats()) == dataclasses.asdict(jb.pool_stats())
    assert tb.steps_run == jb.steps_run and tb.prefill_launches == jb.prefill_launches


def test_ngram_speculation_matches_jax_and_plain(models):
    jm, jp, tm, tp = models
    _, ref = _port(tm, tp, max_new=8)
    jb, jout = _jax(jm, jp, max_new=8, speculate=4,
                    drafter=jspec.NGramDrafter())
    tb, tout = _port(tm, tp, max_new=8, speculate=4)  # NGramDrafter by default
    assert isinstance(tb.drafter, tspec.NGramDrafter)
    _same_as_jax(jb, jout, tb, tout)
    assert tout == ref
    evs = [kind for r in tb.finished.values() for kind, _ in r.events]
    assert tb.spec.launches > 0 and tb.spec_stats()["emitted"] > 0
    assert tb.spec.windows == sum(kind.startswith("speculated:") for kind in evs)


def test_int8_pages_speculation_matches_jax_and_plain(models):
    """Quantize-on-write int8 pages: the speculative stream equals the plain
    int8 stream, and both batchers agree."""
    jm, jp, tm, tp = models
    _, ref = _port(tm, tp, kv_quant=QuantSpec("int8"))
    tr = _traces(ref)
    jb, jout = _jax(jm, jp, speculate=3, kv_quant=JQuantSpec("int8"),
                    drafter=jspec.TraceDrafter(tr, overlap=0.7, seed=3))
    tb, tout = _port(tm, tp, speculate=3, kv_quant=QuantSpec("int8"),
                     drafter=tspec.TraceDrafter(tr, overlap=0.7, seed=3))
    _same_as_jax(jb, jout, tb, tout)
    assert tout == ref
    assert 0 < tb.spec.accepted < tb.spec.drafted
    assert tb.cache["seg0"]["k_pages"].dtype == torch.int8


def test_preemption_mid_request_matches_jax_and_plain(models):
    """A decoding request is preempted mid-stream after a speculative step,
    resumes through page-backed recompute and speculates on; the stream
    still equals the plain one without preemption, and the lifecycle events
    equal the JAX batcher's."""
    jm, jp, tm, tp = models

    def script(b):
        for _ in range(3):
            b.step()
        running = [s.req.rid for s in b.slots if not s.free and s.req.output]
        assert running
        b.preempt(running[0])

    _, ref = _port(tm, tp, max_new=8)
    tr = _traces(ref)
    kw = dict(max_new=8, speculate=2, prefix_cache=True, script=script)
    jb, jout = _jax(jm, jp, drafter=jspec.TraceDrafter(tr, overlap=0.5, seed=1), **kw)
    tb, tout = _port(tm, tp, drafter=tspec.TraceDrafter(tr, overlap=0.5, seed=1), **kw)
    _same_as_jax(jb, jout, tb, tout)
    assert tout == ref
    assert tb.health_summary()["preemptions"] == 1 and tb.resumes_total == 1
    for rid, r in tb.finished.items():
        assert r.events == jb.finished[rid].events, rid


# ---------------------------------------------------------------------------
# speculative streams equal the port's own plain streams
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("k,overlap,max_new", [
    (1, 1.0, 6),   # the smallest window, every draft right
    (4, 1.0, 8),   # full windows of 5 rows cross 4-token pages
    (3, 0.5, 6),   # half the drafts corrupted and rejected
    (3, 0.0, 6),   # every draft rejected
    (6, 1.0, 3),   # drafts longer than the remaining budget
])
def test_trace_speculation_equals_plain(models, k, overlap, max_new):
    _, _, tm, tp = models
    _, ref = _port(tm, tp, max_new=max_new)
    reqs = _requests(Request, get_config(NAME).vocab, max_new=max_new)
    tr = [tuple(int(t) for t in r.prompt) + ref[r.rid][1] for r in reqs]
    b, out = _port(tm, tp, max_new=max_new, speculate=k,
                   drafter=tspec.TraceDrafter(tr, overlap=overlap, seed=7))
    assert out == ref
    st = b.spec
    if overlap == 1.0:
        assert st.accepted == st.drafted > 0
    if overlap == 0.0:
        assert st.accepted == 0 and st.drafted > 0
    assert all(len(toks) <= max_new for _, toks in out.values())


def test_draft_model_speculation_equals_plain(models):
    """The target's own weights as the draft model: every draft accepted."""
    _, _, tm, tp = models
    _, ref = _port(tm, tp, n=3)
    b, out = _port(tm, tp, n=3, speculate=3,
                   drafter=tspec.DraftModelProposer(tm, tp, max_context=32))
    assert out == ref
    assert b.spec.accepted == b.spec.drafted > 0 and b.drafter.forwards > 0


def test_speculate_must_not_be_negative(models):
    _, _, tm, tp = models
    with pytest.raises(ValueError):
        ContinuousBatcher(tm, tp, speculate=-1, **BASE)
    b, _ = _port(tm, tp, n=2)
    assert b.spec_stats() is None
