"""Chaos injection and the non-finite quarantine in the port against the JAX
package: the fault schedules, and whole batcher runs under faults.

The schedules are pure in (seed, step, stream) and drawn from numpy on both
sides, so the port's plans, injections, event logs and counters must equal
JAX's draw for draw.  Batcher runs under the same faults (the ports of
tests/test_lifecycle.py's chaos tests, tests/test_abft.py's bit-flip stream
and batcher audit, and tests/test_speculative.py's chaos sweep) must give
identical token streams, finish reasons, per-request event logs, per-step
health records and `health_summary()` (the wall-clock `stragglers` count
aside) and identical `chaos.summary()` and chaos events.  JAX runs its
default "xla" policy, the port its "torch" backend, on llama3.2-1b-smoke
with JAX's weights carried across."""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402

from repro.configs import get_config as j_get_config  # noqa: E402
from repro.core.precision import QuantSpec as JQuantSpec  # noqa: E402
from repro.models import build_model as j_build  # noqa: E402
from repro.runtime import lifecycle as jlife  # noqa: E402
from repro.runtime import speculative as jspec  # noqa: E402
from repro.runtime.batcher import ContinuousBatcher as JBatcher  # noqa: E402
from repro.runtime.kv_pages import PagePool as JPagePool  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.core.precision import QuantSpec  # noqa: E402
from repro_torch.models import build_model, from_jax_params  # noqa: E402
from repro_torch.runtime import lifecycle as tlife  # noqa: E402
from repro_torch.runtime import speculative as tspec  # noqa: E402
from repro_torch.runtime.batcher import ContinuousBatcher  # noqa: E402
from repro_torch.runtime.fault import DeviceFailure  # noqa: E402
from repro_torch.runtime.kv_pages import PagePool  # noqa: E402
from repro_torch.runtime.lifecycle import (  # noqa: E402
    ChaosConfig, ChaosInjector, ChaosStream, FinishReason, Request, RetryPolicy,
)
from repro_torch.runtime.prefix_cache import PrefixIndex  # noqa: E402

NAME = "llama3.2-1b-smoke"

# every fault family at once, rate and schedule paths both
FULL_MIX = dict(step_failure_rate=0.3, fail_at_steps=(5,), poison_rate=0.2,
                poison_at_steps=(7,), pool_pressure_rate=0.2, pressure_at_steps=(3,),
                pool_pressure_pages=2, latency_spike_rate=0.3, worker_kill_rate=0.2,
                kill_worker_at=((4, 1),), worker_hang_rate=0.2, hang_worker_at=((6, 0, 2),),
                handoff_drop_rate=0.3, drop_handoff_at=(9,), bitflip_rate=0.3,
                bitflip_at_steps=(2,))


@pytest.fixture(scope="module")
def models():
    jm = j_build(j_get_config(NAME))
    jp = jm.init(jax.random.PRNGKey(0))
    tm = build_model(get_config(NAME))
    tp = from_jax_params(jax.tree.map(np.asarray, jp), get_config(NAME), device="cpu")
    return jm, jp, tm, tp


def _prompt(n, seed=0):
    return np.random.default_rng(seed).integers(0, get_config(NAME).vocab, n).astype(np.int32)


def _events(inj):
    return [(e.step, e.kind, e.detail) for e in inj.events]


def _pair(models, prompts, chaos=None, *, max_new=6, priorities=None, jax_kw=None,
          port_kw=None, **kw):
    """The same requests and fault mix through JAX's batcher and the
    port's; returns (jax batcher, port batcher)."""
    jm, jp, tm, tp = models
    out = []
    for pkg, B, m, p, extra in (
            (jlife, JBatcher, jm, jp, jax_kw or {}),
            (tlife, ContinuousBatcher, tm, tp, port_kw or {})):
        inj = pkg.ChaosInjector(pkg.ChaosConfig(**chaos)) if chaos is not None else None
        b = B(m, p, chaos=inj, **kw, **extra)
        for i, pr in enumerate(prompts):
            b.submit(pkg.Request(rid=i, prompt=pr, max_new=max_new,
                                 priority=priorities[i] if priorities else 0))
        b.run_to_completion(max_steps=2000)
        out.append(b)
    return out


def _port_run(models, prompts, *, max_new=6, priorities=None, **kw):
    """The port's batcher alone, without faults: the reference streams."""
    _, _, tm, tp = models
    b = ContinuousBatcher(tm, tp, **kw)
    for i, pr in enumerate(prompts):
        b.submit(Request(rid=i, prompt=pr, max_new=max_new,
                         priority=priorities[i] if priorities else 0))
    return {r: v.output for r, v in b.run_to_completion(max_steps=2000).items()}


def _assert_same_run(jb, tb):
    """Streams, finish reasons, event logs, per-step health, the health
    summary (but the wall-clock straggler count) and the chaos record."""
    assert sorted(tb.finished) == sorted(jb.finished)
    for rid, j in jb.finished.items():
        t = tb.finished[rid]
        assert (t.output, t.finish_reason, t.events, t.preemptions) == \
            (j.output, j.finish_reason, j.events, j.preemptions), rid
    js, ts = jb.health_summary(), tb.health_summary()
    assert set(ts) == set(js)
    for key in ts:
        if key != "stragglers":
            assert ts[key] == js[key], key
    skip = ("dt_s", "straggler")
    assert [{k: v for k, v in h.as_dict().items() if k not in skip} for h in tb.health] == \
        [{k: v for k, v in h.as_dict().items() if k not in skip} for h in jb.health]
    if jb.chaos is not None:
        assert tb.chaos.summary() == jb.chaos.summary()
        assert _events(tb.chaos) == _events(jb.chaos)
    if jb.pool is not None:
        assert dataclasses.asdict(tb.pool_stats()) == dataclasses.asdict(jb.pool_stats())
    return ts


# ---------------------------------------------------------------------------
# the schedules
# ---------------------------------------------------------------------------


def test_chaos_stream_ids_distinct_stable_and_jax_s():
    assert len(set(ChaosStream.ALL)) == len(ChaosStream.ALL) == 12
    assert ChaosStream.ALL == jlife.ChaosStream.ALL == tuple(range(12))
    assert (ChaosStream.BITFLIP_GATE, ChaosStream.BITFLIP_SITE) == (10, 11)


@pytest.mark.parametrize("seed", range(8))
def test_chaos_plans_and_injections_equal_jax(seed):
    """Seeds 0-7: `plan` for 64 steps, then every mutating path in step
    order (with the same alive / candidate / active lists and shapes), then
    the pressure episodes over two pools: equal results, counters, events."""
    cfg = dict(FULL_MIX, seed=seed)
    j, t = jlife.ChaosInjector(jlife.ChaosConfig(**cfg)), ChaosInjector(ChaosConfig(**cfg))
    assert [t.plan(s) for s in range(64)] == [j.plan(s) for s in range(64)]
    assert t.events == [] and t.summary() == j.summary()
    jpool, tpool = JPagePool(12, 4), PagePool(12, 4)
    for s in range(64):
        alive = [w for w in range(3) if (s + w) % 5]
        assert t.wants_failure(s) == j.wants_failure(s)
        assert t.poison_slot(s, alive) == j.poison_slot(s, alive)
        assert t.latency_spike(s) == j.latency_spike(s)
        assert t.kill_worker(s, alive) == j.kill_worker(s, alive)
        assert t.hang_worker(s, alive) == j.hang_worker(s, alive)
        assert t.drops_handoff(s) == j.drops_handoff(s)
        assert t.bitflip(s, (3, 5, 7)) == j.bitflip(s, (3, 5, 7))
        tf, jf = t.gemm_fault(s), j.gemm_fault(s)
        assert (tf is None) == (jf is None)
        if tf is not None:
            assert dataclasses.asdict(tf) == dataclasses.asdict(jf)
        t.begin_step(s, tpool)
        j.begin_step(s, jpool)
        assert tpool.pages_free == jpool.pages_free, s
    t.end(tpool)
    j.end(jpool)
    assert tpool.pages_free == jpool.pages_free == 12
    assert t.summary() == j.summary()
    assert _events(t) == _events(j)
    assert t.summary()["pressure_episodes"] > 0 and t.summary()["bitflips_injected"] > 0


def test_chaos_plan_is_pure_and_matches_injection():
    """`plan(step)` changes no injector state, and what it predicts is what
    the mutating paths then inject (tests/test_lifecycle.py's check)."""
    inj = ChaosInjector(ChaosConfig(seed=11, step_failure_rate=0.3, worker_kill_rate=0.2,
                                    worker_hang_rate=0.2, handoff_drop_rate=0.3,
                                    latency_spike_rate=0.2, kill_worker_at=((4, 1),),
                                    drop_handoff_at=(6,)))
    plans = [inj.plan(s) for s in range(12)]
    assert [inj.plan(s) for s in reversed(range(12))] == plans[::-1]
    assert inj.summary()["events"] == 0 and inj.events == []
    assert plans[4]["worker_kill_scheduled"] == [1] and plans[6]["handoff_drop"] is True
    kills = hangs = 0
    for s in range(12):
        assert inj.wants_failure(s) == plans[s]["step_failure"]
        assert inj.drops_handoff(s) == plans[s]["handoff_drop"]
        killed = inj.kill_worker(s, alive=[0, 1, 2])
        hung = inj.hang_worker(s, candidates=[0, 1, 2])
        assert len(killed) == len(plans[s]["worker_kill_scheduled"]) + plans[s]["worker_kill"]
        assert len(hung) == len(plans[s]["worker_hang_scheduled"]) + plans[s]["worker_hang"]
        kills += len(killed)
        hangs += len(hung)
    assert (inj.worker_kills_injected, inj.worker_hangs_injected) == (kills, hangs)
    assert inj.failures_injected == sum(p["step_failure"] for p in plans)


def test_bitflip_stream_pure_and_independent():
    """The ABFT chaos stream (tests/test_abft.py's check): pure in (seed,
    step), counted, and turning it on shifts no other family's draws; its
    GEMM fault is the port's own `TileFault`."""
    from repro_torch.kernels.abft import TileFault

    a = ChaosInjector(ChaosConfig(seed=3, bitflip_at_steps=(2, 5)))
    b = ChaosInjector(ChaosConfig(seed=3, bitflip_at_steps=(2, 5)))
    assert a.bitflip(1, (4, 9)) is None
    assert a.bitflip(2, (4, 9)) == b.bitflip(2, (4, 9))
    assert a.gemm_fault(5) == b.gemm_fault(5) and isinstance(a.gemm_fault(5), TileFault)
    assert a.gemm_fault(4) is None
    assert a.summary()["bitflips_injected"] == 3
    c1 = ChaosInjector(ChaosConfig(seed=7, poison_rate=0.5, step_failure_rate=0.5))
    c2 = ChaosInjector(ChaosConfig(seed=7, poison_rate=0.5, step_failure_rate=0.5,
                                   bitflip_rate=1.0))
    for s in range(12):
        assert c1._wants_poison(s) == c2._wants_poison(s)
        assert c1._wants_step_failure(s) == c2._wants_step_failure(s)


# ---------------------------------------------------------------------------
# the batcher under faults
# ---------------------------------------------------------------------------


def test_transient_failures_retry_exact(models):
    """Injected step failures retry; the streams equal JAX's, and so do the
    retries per step."""
    p = _prompt(2, seed=9)
    jb, tb = _pair(models, [p], dict(fail_at_steps=(1, 3)), batch_slots=1, max_len=8,
                   retry=RetryPolicy(max_retries=2), paged=False)
    hs = _assert_same_run(jb, tb)
    assert hs["retries"] == 2 and tb.chaos.failures_injected == 2
    assert [h.retries for h in tb.health if h.retries] == [1, 1]
    assert tb.finished[0].finish_reason == FinishReason.MAX_NEW


def test_retry_exhaustion_reraises(models):
    """A device that keeps failing: the initial try and max_retries retries
    fail, then the DeviceFailure reaches the caller."""
    _, _, tm, tp = models
    b = ContinuousBatcher(tm, tp, batch_slots=1, max_len=8, paged=False,
                          retry=RetryPolicy(max_retries=2))
    b.submit(Request(rid=0, prompt=_prompt(2), max_new=2))

    class _Dead:
        def decode_step(self, *a, **k):
            raise DeviceFailure("permafail")

    b.model = _Dead()
    with pytest.raises(DeviceFailure):
        b.step()
    assert b.retries_total == 3


@pytest.mark.parametrize("kv", [None, "int8"])
@pytest.mark.parametrize("speculate", [0, 2])
def test_retried_step_leaves_the_pages_bitwise_unfailed(models, kv, speculate):
    """The step writes the pages in place; the injected failure comes before
    the device call, so after every step a run with failures holds the
    pages (int8 payloads and scale pages too) bitwise equal to a run
    without, and emits the same streams."""
    _, _, tm, tp = models
    runs = []
    for chaos in (None, ChaosInjector(ChaosConfig(fail_at_steps=(0, 1, 2, 4, 6, 9)))):
        b = ContinuousBatcher(tm, tp, batch_slots=2, max_len=20, page_size=4,
                              prefill_chunk=4, prefix_cache=True, speculate=speculate,
                              kv_quant=QuantSpec(kv) if kv else None, chaos=chaos,
                              retry=RetryPolicy(max_retries=1))
        for i in range(3):
            b.submit(Request(rid=i, prompt=_prompt(5 + 3 * i, seed=20 + i), max_new=5))
        runs.append(b)
    caches = []
    while any(b.queue or b.active for b in runs):
        for b in runs:
            b.step()
        leaves = [[t for seg in b.cache.values() for t in seg.values()] for b in runs]
        assert all(torch.equal(x, y) for x, y in zip(*leaves))
        caches.append(leaves[0])
    assert runs[1].retries_total == 6 and runs[0].retries_total == 0
    assert {r: v.output for r, v in runs[0].finished.items()} == \
        {r: v.output for r, v in runs[1].finished.items()}
    if kv:
        assert any(t.dtype == torch.int8 for t in caches[-1])


def test_poison_quarantines_only_victim(models):
    """Non-finite logits fail exactly one slot; the other request's stream
    is the fault-free one, and both runs equal JAX's."""
    prompts = [_prompt(2, seed=10), _prompt(3, seed=11)]
    kw = dict(batch_slots=2, max_len=12, paged=False, nonfinite_guard=True)
    ref = _port_run(models, prompts, **kw)
    jb, tb = _pair(models, prompts, dict(seed=3, poison_at_steps=(3,)), **kw)
    _assert_same_run(jb, tb)
    failed = [r for r in tb.finished.values() if r.finish_reason == FinishReason.FAILED]
    assert len(failed) == 1 and ("quarantined", 3) in failed[0].events
    survivor = next(r for r in tb.finished.values() if r.finish_reason != FinishReason.FAILED)
    assert survivor.output == ref[survivor.rid]


def test_pool_pressure_backpressures_then_recovers(models):
    """A pressure episode seizes pages under slot -99 before admission; the
    request waits it out and decodes exactly.  The seized pages are never
    rendered into the page table or the lengths."""
    p = _prompt(4, seed=12)
    cfg = dict(pressure_at_steps=(0,), pool_pressure_pages=3, pool_pressure_steps=3)
    jb, tb = _pair(models, [p], cfg, max_new=4, batch_slots=1, max_len=8, paged=True,
                   page_size=4, num_pages=4)
    _assert_same_run(jb, tb)
    assert tb.chaos.pressure_episodes == 1
    assert ("admitted", 3) in tb.finished[0].events
    assert tb.pool.pages_free == 4
    pool = PagePool(6, 4)
    inj = ChaosInjector(ChaosConfig(pressure_at_steps=(0,), pool_pressure_pages=2))
    inj.begin_step(0, pool)
    assert pool.owned(ChaosInjector.PRESSURE_SLOT) and pool.pages_free == 4
    assert (pool.page_table(2, 3) == 0).all() and (pool.lengths(2) == 0).all()


def test_health_records_and_summary(models):
    """Latency spikes feed the watchdog's step times; the health records
    and summaries equal JAX's."""
    jb, tb = _pair(models, [_prompt(2)], dict(latency_spike_rate=1.0, latency_spike_s=0.05),
                   max_new=3, batch_slots=1, max_len=8, paged=False)
    hs = _assert_same_run(jb, tb)
    assert len(tb.health) == tb.steps_run
    assert all(h.dt_s >= 0.05 for h in tb.health)
    assert hs["chaos"]["spikes_injected"] == tb.steps_run
    assert hs["finish_reasons"] == {FinishReason.MAX_NEW: 1}


@pytest.mark.parametrize("seed", [0, 1])
def test_randomized_chaos_sweep_matches_jax(models, seed):
    """tests/test_lifecycle.py's sweep (step failures, poisons, pressure
    episodes and latency spikes together over the paged batcher with the
    prefix cache): equal to JAX's run, and every completed request equal to
    the fault-free run."""
    prompts = [_prompt(6, seed=100 + i) for i in range(4)]
    kw = dict(max_new=8, priorities=[i % 2 for i in range(4)], batch_slots=2, max_len=16,
              paged=True, page_size=4, num_pages=10, prefix_cache=True,
              retry=RetryPolicy(max_retries=4))
    ref = _port_run(models, prompts, **kw)
    jb, tb = _pair(models, prompts, dict(seed=seed, step_failure_rate=0.10, poison_rate=0.03,
                                         latency_spike_rate=0.10, pool_pressure_rate=0.05,
                                         pool_pressure_pages=2), **kw)
    _assert_same_run(jb, tb)
    for rid, r in tb.finished.items():
        if r.finish_reason in FinishReason.COMPLETED:
            assert r.output == ref[rid], rid
    assert tb.pool.pages_free == 10 - tb.prefix.entries
    assert sum(tb.chaos.summary()[k] for k in ("failures_injected", "pressure_episodes")) > 0


def test_batcher_abft_guard_end_to_end(models):
    """tests/test_abft.py's serving audit: every host-copy bit flip is
    detected and corrected, the streams are those without flips, and the
    counters equal JAX's."""
    rng = np.random.default_rng(1)
    prompts = [rng.integers(0, get_config(NAME).vocab, 4).astype(np.int32) for _ in range(3)]
    kw = dict(max_new=5, batch_slots=2, max_len=12, paged=False)
    base = _port_run(models, prompts, **kw)
    jb, tb = _pair(models, prompts, dict(seed=0, bitflip_at_steps=(1, 3)), abft=True, **kw)
    hs = _assert_same_run(jb, tb)
    assert {r: v.output for r, v in tb.finished.items()} == base
    assert tb.sdc_detected == tb.sdc_corrected == tb.chaos.bitflips_injected > 0
    assert hs["abft"] == {"sdc_detected": tb.sdc_detected, "sdc_corrected": tb.sdc_corrected}


def _spec_requests(n=6, seed=2, max_new=5):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, get_config(NAME).vocab, (6, 9, 13)[i % 3]).astype(np.int32)
            for i in range(n)]


@pytest.mark.parametrize("seed,overlap,k,pages,mix", [
    # tests/test_speculative.py's sweep mix (seed 0 and 3) ...
    (0, 0.0, 1, 16, dict(step_failure_rate=0.05, poison_rate=0.02, latency_spike_rate=0.05,
                         pool_pressure_rate=0.10, pool_pressure_pages=2)),
    (3, 0.75, 4, 16, dict(step_failure_rate=0.05, poison_rate=0.02, latency_spike_rate=0.05,
                          pool_pressure_rate=0.10, pool_pressure_pages=2)),
    # ... its mid-request preemption case, and poisons with bit flips
    (0, 1.0, 3, 14, dict(pool_pressure_rate=0.3, pool_pressure_pages=3)),
    (5, 0.5, 4, 16, dict(poison_rate=0.2, step_failure_rate=0.2, bitflip_rate=0.3)),
])
def test_speculation_chaos_sweep_matches_jax(models, seed, overlap, k, pages, mix):
    """Speculation under faults: the verify step's retries, quarantine and
    pressure-driven preemption give JAX's streams, events and counters, and
    every completed request the fault-free plain stream."""
    prompts = _spec_requests()
    base = dict(batch_slots=3, max_len=24, paged=True, page_size=4, prefill_chunk=4)
    ref = _port_run(models, prompts, max_new=5, **base)
    traces = [tuple(int(t) for t in p) + tuple(ref[i]) for i, p in enumerate(prompts)]
    abft = "bitflip_rate" in mix
    jb, tb = _pair(models, prompts, dict(seed=seed, **mix), max_new=5, speculate=k,
                   num_pages=pages, retry=RetryPolicy(max_retries=3), abft=abft,
                   jax_kw=dict(drafter=jspec.TraceDrafter(traces, overlap=overlap, seed=seed)),
                   port_kw=dict(drafter=tspec.TraceDrafter(traces, overlap=overlap, seed=seed)),
                   **base)
    _assert_same_run(jb, tb)
    assert tb.spec_stats() == jb.spec_stats()
    for rid, r in tb.finished.items():
        if r.finish_reason in FinishReason.COMPLETED:
            assert r.output == ref[rid], rid
    if abft:
        assert tb.sdc_detected == tb.sdc_corrected == tb.chaos.bitflips_injected > 0
    assert tb.chaos.summary()["events"] > 0


def test_external_pool_and_prefix_index_validated_as_jax_does(models):
    """`pool=` / `prefix_index=` take JAX's checks: paged only, and the
    index must sit on the pool it comes with; an external pool sets the
    page size and capacity."""
    _, _, tm, tp = models
    pool = PagePool(9, 4)
    with pytest.raises(ValueError, match="paged"):
        ContinuousBatcher(tm, tp, batch_slots=1, max_len=8, paged=False, pool=pool)
    with pytest.raises(ValueError, match="prefix_index"):
        ContinuousBatcher(tm, tp, batch_slots=1, max_len=8, prefix_index=PrefixIndex(pool))
    with pytest.raises(ValueError, match="prefix_index"):
        ContinuousBatcher(tm, tp, batch_slots=1, max_len=8, pool=PagePool(9, 4),
                          prefix_index=PrefixIndex(pool))
    index = PrefixIndex(pool)
    b = ContinuousBatcher(tm, tp, batch_slots=2, max_len=8, page_size=16, pool=pool,
                          prefix_index=index, chaos=ChaosInjector(ChaosConfig()))
    assert b.pool is pool and b.prefix is index and b.page_size == 4 and b.guard
    assert ContinuousBatcher(tm, tp, batch_slots=1, max_len=8, prefix_cache=True,
                             prefix_max_pinned=2).prefix.stats()["max_pinned_pages"] == 2
    assert not ContinuousBatcher(tm, tp, batch_slots=1, max_len=8,
                                 chaos=ChaosInjector(ChaosConfig()),
                                 nonfinite_guard=False).guard


def test_jax_quantspec_pages_under_chaos_match(models):
    """int8 pages under step failures, poisons and pressure: JAX's run and
    the port's are the same."""
    prompts = [_prompt(7, seed=40 + i) for i in range(4)]
    kw = dict(max_new=5, batch_slots=2, max_len=16, paged=True, page_size=4, num_pages=9,
              prefix_cache=True, prefill_chunk=4, retry=RetryPolicy(max_retries=3))
    jb, tb = _pair(models, prompts, dict(seed=2, step_failure_rate=0.2, poison_rate=0.1,
                                         pool_pressure_rate=0.2, pool_pressure_pages=2),
                   priorities=[0, 1, 0, 1], jax_kw=dict(kv_quant=JQuantSpec("int8")),
                   port_kw=dict(kv_quant=QuantSpec("int8")), **kw)
    _assert_same_run(jb, tb)
    assert tb.chaos.summary()["events"] > 0
