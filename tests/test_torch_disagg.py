"""The disaggregated prefill/decode engine in the port against the JAX
package (the twelve tests of tests/test_disagg.py, each run on both).

Whatever the engine does -- shared-pool handoff, page migration, worker
kill / hang recovery, handoff drops, degraded decode-side fallback -- the
port's token streams, finish reasons, per-request event logs and engine
`summary()` must equal JAX's `DisaggEngine` on the same requests and fault
schedule (the wall-clock straggler fields of the workers and of the
batcher's watchdog aside), and greedy decode must give the streams of a
plain paged `ContinuousBatcher` run.  JAX runs its default "xla" policy,
the port its "torch" backend, on llama3.2-1b-smoke with JAX's weights
carried across."""
import dataclasses
from collections import Counter

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402

from repro.configs import get_config as j_get_config  # noqa: E402
from repro.models import build_model as j_build  # noqa: E402
from repro.runtime import lifecycle as jlife  # noqa: E402
from repro.runtime.disagg import DisaggEngine as JEngine  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.models import build_model, from_jax_params  # noqa: E402
from repro_torch.runtime import lifecycle as tlife  # noqa: E402
from repro_torch.runtime.batcher import ContinuousBatcher  # noqa: E402
from repro_torch.runtime.disagg import HANDOFF_SLOT_BASE, DisaggEngine  # noqa: E402
from repro_torch.runtime.lifecycle import FinishReason, Request  # noqa: E402

NAME = "llama3.2-1b-smoke"
BASE = dict(prefill_workers=2, batch_slots=2, max_len=24, page_size=4, prefill_chunk=4)


@pytest.fixture(scope="module")
def models():
    jm = j_build(j_get_config(NAME))
    jp = jm.init(jax.random.PRNGKey(0))
    tm = build_model(get_config(NAME))
    tp = from_jax_params(jax.tree.map(np.asarray, jp), get_config(NAME), device="cpu")
    return jm, jp, tm, tp


def _requests(make, n=6, seed=0, max_new=3):
    """tests/test_disagg.py's mix: prompts of 12, 8 and 17 tokens, every
    third sharing an 8-token prefix."""
    vocab = get_config(NAME).vocab
    rng = np.random.default_rng(seed)
    common = rng.integers(0, vocab // 2, 8)
    reqs = []
    for i in range(n):
        plen = (12, 8, 17)[i % 3]
        if i % 3 == 0:
            tail = rng.integers(vocab // 2, vocab, plen - 8)
            tail[0] = vocab // 2 + i
            prompt = np.concatenate([common, tail]).astype(np.int32)
        else:
            prompt = rng.integers(0, vocab, plen).astype(np.int32)
        reqs.append(make(rid=i, prompt=prompt, max_new=max_new))
    return reqs


_REFERENCES = {}


def _reference(models, n=6, seed=0, max_new=3):
    """The plain paged batcher's streams of the same requests (port)."""
    key = (n, seed, max_new)
    if key not in _REFERENCES:
        _, _, tm, tp = models
        b = ContinuousBatcher(tm, tp, batch_slots=2, max_len=24, page_size=4)
        for r in _requests(Request, n, seed, max_new):
            b.submit(r)
        _REFERENCES[key] = {k: v.output for k, v in b.run_to_completion().items()}
    return _REFERENCES[key]


def _engines(models, chaos=None, **kw):
    """(JAX engine, port engine), each built with `kw` over BASE and the
    fault mix `chaos` (ChaosConfig fields), nothing submitted yet."""
    jm, jp, tm, tp = models
    out = []
    for pkg, E, m, p in ((jlife, JEngine, jm, jp), (tlife, DisaggEngine, tm, tp)):
        inj = pkg.ChaosInjector(pkg.ChaosConfig(**chaos)) if chaos is not None else None
        out.append(E(m, p, chaos=inj, **{**BASE, **kw}))
    return out


def _run(models, *, n=6, seed=0, max_new=3, chaos=None, **kw):
    """Both engines through the same requests; returns the port's engine and
    finished dict after holding it against JAX's."""
    engines = _engines(models, chaos, **kw)
    for eng, pkg in zip(engines, (jlife, tlife)):
        for r in _requests(pkg.Request, n, seed, max_new):
            eng.submit(r)
        eng.run_to_completion(max_steps=2000)
    _assert_same_engine(*engines)
    return engines[1], engines[1].finished


_FAULT_FREE = {}


def _fault_free(models, *, n, seed, max_new, **kw):
    """The port engine's streams without faults (cached per setting)."""
    key = (n, seed, max_new, tuple(sorted(kw.items())))
    if key not in _FAULT_FREE:
        _, _, tm, tp = models
        eng = DisaggEngine(tm, tp, **{**BASE, **kw})
        for r in _requests(Request, n, seed, max_new):
            eng.submit(r)
        _FAULT_FREE[key] = _outputs(eng.run_to_completion(max_steps=2000))
    return _FAULT_FREE[key]


def _summary(eng):
    s = eng.summary()
    s["workers"] = [{k: v for k, v in w.items() if k != "straggler_flags"}
                    for w in s["workers"]]
    s["batcher"] = {k: v for k, v in s["batcher"].items() if k != "stragglers"}
    return s


def _assert_same_engine(je, te):
    assert sorted(te.finished) == sorted(je.finished)
    for rid, j in je.finished.items():
        t = te.finished[rid]
        assert (t.output, t.finish_reason, t.events) == (j.output, j.finish_reason, j.events), rid
    assert _summary(te) == _summary(je)
    if je.chaos is not None:
        assert te.chaos.summary() == je.chaos.summary()
        assert [(e.step, e.kind, e.detail) for e in te.chaos.events] == \
            [(e.step, e.kind, e.detail) for e in je.chaos.events]
    for jp, tp in ((je.pool_p, te.pool_p), (je.pool_d, te.pool_d)):
        assert dataclasses.asdict(tp.stats()) == dataclasses.asdict(jp.stats())


def _outputs(fin):
    return {k: v.output for k, v in fin.items()}


def test_shared_pool_handoff_exact_and_zero_copy(models):
    eng, fin = _run(models)
    assert _outputs(fin) == _reference(models)
    s = eng.summary()
    assert s["handoffs_completed"] == 6 and s["migrated_pages"] == 0
    assert s["recoveries"] == 0 and s["reroutes"] == 0
    for r in fin.values():
        kinds = [k for k, _ in r.events]
        assert "prefill_done" in kinds and "handoff" in kinds


def test_migration_handoff_exact_and_priced(models):
    """shared_pool=False: full pages copied across, one per full page of
    each prompt but its last token, the copies bitwise their sources."""
    engines = _engines(models, shared_pool=False)
    te = engines[1]
    held = []
    migrate = te._migrate_pages

    def checked(dst, src):
        migrate(dst, src)
        for name, seg in te.batcher.cache.items():
            for leaf, t in seg.items():
                held.append(torch.equal(t[:, dst], te.cache_p[name][leaf][:, src]))

    te._migrate_pages = checked
    for eng, pkg in zip(engines, (jlife, tlife)):
        for r in _requests(pkg.Request):
            eng.submit(r)
        eng.run_to_completion(max_steps=2000)
    _assert_same_engine(*engines)
    assert _outputs(te.finished) == _reference(models)
    expect = sum((len(r.prompt) - 1) // 4 for r in _requests(Request))
    assert te.summary()["migrated_pages"] == expect > 0
    assert held and all(held)


def test_worker_kill_recovers_bitwise_exact(models):
    eng, fin = _run(models, chaos=dict(seed=0, kill_worker_at=((2, 0),)))
    assert _outputs(fin) == _reference(models)
    s = eng.summary()
    assert s["recoveries"] == 1 and eng.chaos.worker_kills_injected == 1
    assert any(w["state"] == "dead" for w in s["workers"])
    lost = [r for r in fin.values() if any(k.startswith("worker_lost") for k, _ in r.events)]
    assert lost and all(r.finish_reason in FinishReason.COMPLETED for r in lost)


def test_worker_hang_detected_then_worker_rejoins(models):
    eng, fin = _run(models, chaos=dict(seed=0, hang_worker_at=((2, 0, 8),)))
    assert _outputs(fin) == _reference(models)
    s = eng.summary()
    assert s["recoveries"] == 1 and eng.chaos.worker_hangs_injected == 1
    assert s["workers"][0]["state"] == "healthy" and not s["workers"][0]["suspected"]


def test_handoff_drops_retry_with_backoff_exact(models):
    eng, fin = _run(models, chaos=dict(seed=0, drop_handoff_at=(2, 3, 4)))
    assert _outputs(fin) == _reference(models)
    s = eng.summary()
    assert s["handoff_drops"] >= 1 and s["handoffs_completed"] == 6
    assert any(any(k == "chaos_handoff_drop" for k, _ in r.events) for r in fin.values())


def test_degraded_mode_completes_everything(models):
    eng, fin = _run(models, chaos=dict(seed=0, kill_worker_at=((0, 0), (0, 1))))
    assert _outputs(fin) == _reference(models)
    assert eng.degraded() and eng.summary()["degraded_forwards"] == 6
    assert all(r.finish_reason in FinishReason.COMPLETED for r in fin.values())


@pytest.mark.parametrize("fallback", [True, False])
def test_handoff_failed_only_when_fallback_disabled(models, fallback):
    """Every handoff dropped forever: with fallback the decode pool prefills
    (everything completes); without, HANDOFF_FAILED, typed."""
    _, fin = _run(models, n=2, chaos=dict(seed=0, handoff_drop_rate=1.0),
                  degraded_fallback=fallback, handoff_max_retries=1, reroutes_max=1)
    assert set(fin) == {0, 1}
    if fallback:
        assert all(r.finish_reason in FinishReason.COMPLETED for r in fin.values())
        assert all(any(k == "handoff_fallback_decode" for k, _ in r.events)
                   for r in fin.values())
    else:
        assert all(r.finish_reason == FinishReason.HANDOFF_FAILED for r in fin.values())


def test_engine_stamps_ttft_across_prefill_wait(models):
    engines = _engines(models, prefill_workers=1)
    for eng, pkg in zip(engines, (jlife, tlife)):
        reqs = _requests(pkg.Request, n=4)
        reqs[3].ttft_steps = 2  # cannot possibly prefill 3 prompts in 2 steps
        for r in reqs:
            eng.submit(r)
        eng.run_to_completion(max_steps=2000)
    _assert_same_engine(*engines)
    fin = engines[1].finished
    assert fin[3].finish_reason == FinishReason.DEADLINE
    assert any(k == "expired" for k, _ in fin[3].events)
    for rid in (0, 1, 2):
        assert fin[rid].submitted_at == 0 and fin[rid].first_token_at > 0


def test_single_token_prompt_bypasses_prefill(models):
    engines = _engines(models)
    for eng, pkg in zip(engines, (jlife, tlife)):
        eng.submit(pkg.Request(rid=0, prompt=np.asarray([5], np.int32), max_new=3))
        eng.run_to_completion(max_steps=200)
    _assert_same_engine(*engines)
    fin, s = engines[1].finished, engines[1].summary()
    assert fin[0].finish_reason in FinishReason.COMPLETED and len(fin[0].output) == 3
    assert s["bypassed"] == 1 and s["prefill_launches"] == 0


@pytest.mark.parametrize("seed", range(4))
def test_randomized_disagg_chaos_sweep(models, seed):
    """tests/test_disagg.py's sweep mix (kills, hangs, drops, step failures,
    latency spikes), seeds 0-3, in both pool modes in turn: equal to JAX's
    engine, and every completed request equal to the fault-free run."""
    kw = dict(n=8, seed=3, max_new=3, prefill_workers=3, shared_pool=seed % 2 == 0)
    ref = _fault_free(models, **kw)
    eng, fin = _run(models, chaos=dict(
        seed=seed, step_failure_rate=0.05, latency_spike_rate=0.10, worker_kill_rate=0.02,
        worker_hang_rate=0.05, worker_hang_steps=4, handoff_drop_rate=0.15), **kw)
    assert set(fin) == set(ref)
    for rid, r in fin.items():
        assert r.finish_reason in FinishReason.ALL
        if r.finish_reason in FinishReason.COMPLETED:
            assert r.output == ref[rid], (seed, rid, r.events)
    assert eng.chaos.summary()["events"] > 0


def _assert_pool_invariants(pool, index, where):
    """tests/test_disagg.py's structural invariants: refcounts conserve
    against ownership and index pins, the free list is duplicate-free and
    disjoint, lengths fit reservations, serving and parked stats partition
    the total."""
    expect = Counter()
    for pages in pool._owned.values():
        expect.update(int(p) for p in pages)

    def walk(level):
        for node in level.values():
            expect[int(node.page)] += 1
            walk(node.children)

    walk(index._roots)
    got = Counter({int(p): c for p, c in pool._refs.items()})
    assert expect == got, where
    free = list(pool._free)
    assert len(set(free)) == len(free) and not set(free) & set(got), where
    assert len(free) + len(set(got)) == pool.num_pages, where
    assert set(pool._lengths) == set(pool._owned) == set(pool._mounted), where
    for slot, ln in pool._lengths.items():
        assert ln <= len(pool._owned[slot]) * pool.page_size, where
    st = pool.stats()
    assert st.live_tokens + st.tokens_parked == sum(pool._lengths.values()), where


@pytest.mark.parametrize("n,seed,chaos", [
    (8, 1, dict(seed=0, handoff_drop_rate=0.3)),
    (4, 2, dict(seed=0, drop_handoff_at=(2, 3, 4))),
])
def test_pool_invariants_and_parked_split_under_drops(models, n, seed, chaos):
    """Both engines stepped in lockstep under handoff drops: equal pool
    statistics after every step, the structural invariants hold, a staged
    handoff is parked freight (its tokens under tokens_parked, not
    live_tokens), and the drained pool reports zero everywhere."""
    engines = _engines(models, chaos)
    for eng, pkg in zip(engines, (jlife, tlife)):
        for r in _requests(pkg.Request, n=n, seed=seed):
            eng.submit(r)
    je, te = engines
    pool, seen_parked = te.pool_p, False
    for step in range(2000):
        active = [eng.step() for eng in engines][1]
        assert dataclasses.asdict(pool.stats()) == dataclasses.asdict(je.pool_p.stats()), step
        _assert_pool_invariants(pool, te.index_p, f"step {step}")
        staged = [s for s in pool._owned if s >= HANDOFF_SLOT_BASE]
        st = pool.stats()
        if staged:
            assert all(pool.parked(s) for s in staged)
            assert st.tokens_parked == sum(pool._lengths[s] for s in staged)
            assert st.live_tokens == sum(ln for s, ln in pool._lengths.items()
                                         if s not in staged)
            seen_parked |= st.tokens_parked > 0
        else:
            assert st.tokens_parked == 0 and st.pages_parked == 0
        if not (active or te.queue or te.handoffs or any(w.busy for w in te.workers)
                or te.batcher.queue or te.batcher.active):
            break
    _assert_same_engine(je, te)
    assert seen_parked and te.summary()["handoff_drops"] >= 1
    st = pool.stats()
    assert (st.live_tokens, st.pages_touched, st.tokens_parked, st.pages_parked) == (0, 0, 0, 0)
