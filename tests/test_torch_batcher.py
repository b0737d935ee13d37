"""The slice as a whole: one request trace through the JAX paged batcher
(Pallas kernels in interpret mode) and through the port's batcher on the
CPU, with the JAX weights carried across.  Token streams, finish reasons,
pool statistics and prefix-cache statistics must be identical -- also for
quantized serving: a `Config.precision` ("int8", "int8_all") and fp8 KV
pages."""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402

from repro.configs import get_config as j_get_config  # noqa: E402
from repro.core import ops as jops  # noqa: E402
from repro.models import build_model as j_build  # noqa: E402
from repro.runtime.batcher import ContinuousBatcher as JBatcher  # noqa: E402
from repro.runtime.lifecycle import Request as JRequest  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.models import build_model, from_jax_params  # noqa: E402
from repro_torch.runtime.batcher import ContinuousBatcher  # noqa: E402
from repro_torch.runtime.lifecycle import Request  # noqa: E402

NAME = "llama3.2-1b-smoke"
JAX_POLICY = jops.MXPolicy("pallas_mx", interpret=True, bm=16, bn=32, bk=16)


def _trace(vocab):
    """Two system prompts (A shared by most requests, B by two), ragged
    tails, more requests than slots, one request that runs into max_len
    and one over-long prompt that is truncated."""
    rng = np.random.default_rng(11)
    sys_a = rng.integers(0, vocab, 8)
    sys_b = rng.integers(0, vocab, 6)
    spec = [  # (system prompt, tail length, max_new)
        (sys_a, 1, 4), (sys_a, 3, 4), (sys_b, 2, 3), (sys_a, 5, 4),
        (sys_a, 2, 14), (sys_b, 4, 3), (sys_a, 4, 4), (None, 22, 3),
    ]
    out = []
    for rid, (sysp, tail, max_new) in enumerate(spec):
        t = rng.integers(0, vocab, tail)
        prompt = t if sysp is None else np.concatenate([sysp, t])
        out.append((rid, prompt.astype(np.int32), max_new))
    return out


KW = dict(batch_slots=2, max_len=20, page_size=4, num_pages=11,
          prefix_cache=True, prefill_chunk=4)


def _run_jax(jm, jp, trace, **kw):
    b = JBatcher(jm, jp, paged=True, **KW, **kw)
    with jops.use_policy(JAX_POLICY):
        for rid, prompt, max_new in trace:
            b.submit(JRequest(rid=rid, prompt=prompt, max_new=max_new))
        fin = b.run_to_completion()
    return b, fin


def _run_port(tm, tp, trace, **kw):
    b = ContinuousBatcher(tm, tp, **KW, **kw)
    for rid, prompt, max_new in trace:
        b.submit(Request(rid=rid, prompt=prompt, max_new=max_new))
    return b, b.run_to_completion()


def test_batcher_trace_matches_jax():
    _trace_parity(NAME)


def test_moe_batcher_trace_matches_jax():
    """grok-1 (smoke): every decode step and prefill chunk routes through
    the MoE blocks; the streams still equal the JAX batcher's."""
    _trace_parity("grok-1-314b-smoke")


QUANT_CASES = {  # id -> (arch, Config.precision, KV page type)
    "llama-int8": (NAME, "int8", None),
    "llama-int8_all": (NAME, "int8_all", None),
    "llama-fp8_pages": (NAME, "none", "fp8_e4m3"),
    "grok-int8": ("grok-1-314b-smoke", "int8", None),
    "llama-sparse24": (NAME, "sparse24", None),
    "llama-sparse24_int8": (NAME, "sparse24_int8", None),
    "grok-sparse24_int8": ("grok-1-314b-smoke", "sparse24_int8", None),
}


@pytest.mark.parametrize("case", sorted(QUANT_CASES))
def test_quantized_batcher_trace_matches_jax(case):
    _trace_parity(*QUANT_CASES[case])


def _trace_parity(name, precision="none", kv=None):
    from repro.core.precision import QuantSpec as JQuantSpec
    from repro_torch.core.precision import QuantSpec

    jcfg = dataclasses.replace(j_get_config(name), precision=precision)
    cfg = dataclasses.replace(get_config(name), precision=precision)
    jm = j_build(jcfg)
    jp = jm.init(jax.random.PRNGKey(0))
    tm = build_model(cfg)
    tp = from_jax_params(jax.tree.map(np.asarray, jp), cfg, device="cpu")
    trace = _trace(cfg.vocab)

    jb, jfin = _run_jax(jm, jp, trace, **(dict(kv_quant=JQuantSpec(kv)) if kv else {}))
    tb, tfin = _run_port(tm, tp, trace, **(dict(kv_quant=QuantSpec(kv)) if kv else {}))

    assert sorted(tfin) == sorted(jfin) == list(range(len(trace)))
    assert {r: tfin[r].output for r in tfin} == {r: jfin[r].output for r in jfin}
    assert {r: tfin[r].finish_reason for r in tfin} == \
        {r: jfin[r].finish_reason for r in jfin}
    # the trace exercises what it is meant to
    reasons = {r.finish_reason for r in tfin.values()}
    assert {"max_new", "max_len", "truncated"} <= reasons
    assert dataclasses.asdict(tb.pool_stats()) == dataclasses.asdict(jb.pool_stats())
    tstats, jstats = tb.prefix_stats(), jb.prefix_stats()
    assert tstats == jstats
    assert tstats["hits"] > 0 and tstats["cow_copies"] > 0
    assert tstats["evicted_pages"] > 0  # the tight pool forced eviction
    assert tb.prefill_launches == jb.prefill_launches
    assert tb.steps_run == jb.steps_run


def _lifecycle_script(b, make_req, vocab):
    """Priorities, a late high-priority arrival under pool pressure
    (preemption with page-backed resume), a step deadline and a cancel --
    applied identically to either batcher."""
    rng = np.random.default_rng(12)
    sysp = rng.integers(0, vocab, 8)

    def prompt(n):
        return np.concatenate([sysp, rng.integers(0, vocab, n)]).astype(np.int32)

    b.submit(make_req(rid=0, prompt=prompt(1), max_new=6))
    b.submit(make_req(rid=1, prompt=prompt(3), max_new=5))
    b.submit(make_req(rid=2, prompt=prompt(2), max_new=5, deadline_steps=6))
    b.submit(make_req(rid=3, prompt=prompt(4), max_new=4))
    for _ in range(3):
        b.step()
    b.submit(make_req(rid=4, prompt=prompt(2), max_new=4, priority=1))
    b.step()
    b.cancel(3)
    return b.run_to_completion()


def test_lifecycle_trace_matches_jax():
    jm = j_build(j_get_config(NAME))
    jp = jm.init(jax.random.PRNGKey(1))
    tm = build_model(get_config(NAME))
    tp = from_jax_params(jax.tree.map(np.asarray, jp), get_config(NAME), device="cpu")
    vocab = get_config(NAME).vocab
    kw = dict(batch_slots=2, max_len=16, page_size=4, num_pages=5,
              prefix_cache=True, prefill_chunk=4)
    jb = JBatcher(jm, jp, paged=True, **kw)
    with jops.use_policy(JAX_POLICY):
        jfin = _lifecycle_script(jb, JRequest, vocab)
    tb = ContinuousBatcher(tm, tp, **kw)
    tfin = _lifecycle_script(tb, Request, vocab)

    for rid in jfin:
        j, t = jfin[rid], tfin[rid]
        assert (t.output, t.finish_reason, t.preemptions, t.events) == \
            (j.output, j.finish_reason, j.preemptions, j.events), rid
    js, ts = jb.health_summary(), tb.health_summary()
    for key in ts:
        if key != "stragglers":  # wall-clock watchdog
            assert ts[key] == js[key], key
    assert ts["preemptions"] >= 1 and ts["resumes"] >= 1
    assert {"cancelled", "deadline", "max_new"} <= set(ts["finish_reasons"])
    assert dataclasses.asdict(tb.pool_stats()) == dataclasses.asdict(jb.pool_stats())
    assert tb.prefix_stats() == jb.prefix_stats()


def test_unported_options_raise():
    """The options that raised until they were ported now serve.  Chaos
    injection: a `ChaosInjector` run (step failures and a poisoned slot
    under the non-finite guard) gives JAX's streams, finish reasons and
    chaos counters (the full parity: tests/test_torch_chaos.py).  The dense
    cache (paged=False) serves a short trace with the JAX dense batcher's
    streams and finish reasons; abft=True builds a batcher with the audit
    armed (its streams: tests/test_torch_abft.py)."""
    from repro.runtime.lifecycle import ChaosConfig as JChaosConfig
    from repro.runtime.lifecycle import ChaosInjector as JChaosInjector
    from repro_torch.runtime.lifecycle import ChaosConfig, ChaosInjector

    jm = j_build(j_get_config(NAME))
    jp = jm.init(jax.random.PRNGKey(0))
    tm = build_model(get_config(NAME))
    tp = from_jax_params(jax.tree.map(np.asarray, jp), get_config(NAME), device="cpu")
    faults = dict(seed=1, fail_at_steps=(1, 4), poison_at_steps=(5,))
    chaos_trace = [(rid, p[:5], m) for rid, p, m in _trace(get_config(NAME).vocab)[:3]]
    jb = JBatcher(jm, jp, batch_slots=2, max_len=12, chaos=JChaosInjector(JChaosConfig(**faults)))
    tb = ContinuousBatcher(tm, tp, batch_slots=2, max_len=12, paged=False,
                           chaos=ChaosInjector(ChaosConfig(**faults)))
    for b, make in ((jb, JRequest), (tb, Request)):
        for rid, prompt, max_new in chaos_trace:
            b.submit(make(rid=rid, prompt=prompt, max_new=max_new))
    jfin, tfin = jb.run_to_completion(), tb.run_to_completion()
    assert {r: (v.output, v.finish_reason) for r, v in tfin.items()} == \
        {r: (v.output, v.finish_reason) for r, v in jfin.items()}
    assert tb.chaos.summary() == jb.chaos.summary()
    assert tb.retries_total == 2 and "failed" in tb.health_summary()["finish_reasons"]
    trace = [(rid, p[:6], m) for rid, p, m in _trace(get_config(NAME).vocab)[:4]]
    jb = JBatcher(jm, jp, batch_slots=2, max_len=12)
    for rid, prompt, max_new in trace:
        jb.submit(JRequest(rid=rid, prompt=prompt, max_new=max_new))
    jfin = jb.run_to_completion()
    tb = ContinuousBatcher(tm, tp, batch_slots=2, max_len=12, paged=False)
    for rid, prompt, max_new in trace:
        tb.submit(Request(rid=rid, prompt=prompt, max_new=max_new))
    tfin = tb.run_to_completion()
    assert {r: (v.output, v.finish_reason) for r, v in tfin.items()} == \
        {r: (v.output, v.finish_reason) for r, v in jfin.items()}
    assert tb.steps_run == jb.steps_run and tb.pool_stats() is None
    b = ContinuousBatcher(tm, tp, batch_slots=1, max_len=8, abft=True)
    assert b.abft and b.health_summary()["abft"] == {"sdc_detected": 0, "sdc_corrected": 0}
