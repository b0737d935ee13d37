"""Fault-tolerant training in the port: every case of test_fault.py (the
failure / restart loop, straggler detection, elastic restore, the data
pipeline's seek, host sharding and prefetch, typed checkpoint events, the
non-finite loss), a recovered run's final state bitwise an uninterrupted
run's, `SyntheticLM` bitwise JAX's for every family, and `rescale`
bitwise."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.configs import ARCH_IDS  # noqa: E402
from repro.configs import get_config as jget_config  # noqa: E402
from repro.data.pipeline import SyntheticLM as JaxSyntheticLM  # noqa: E402
from repro_torch.checkpoint.manager import CheckpointManager  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.core import tree as T  # noqa: E402
from repro_torch.data.pipeline import Prefetcher, SyntheticLM  # noqa: E402
from repro_torch.launch.mesh import make_mesh  # noqa: E402
from repro_torch.launch.steps import make_train_step  # noqa: E402
from repro_torch.models import build_model  # noqa: E402
from repro_torch.optim.adamw import AdamW  # noqa: E402
from repro_torch.runtime.elastic import rescale, shardings_for  # noqa: E402
from repro_torch.runtime.fault import (DeviceFailure, FaultInjector, NanLossError,  # noqa: E402
                                       StragglerDetector, TrainLoop)


@pytest.fixture(scope="module")
def setup():
    cfg = get_config("llama3.2-1b-smoke")
    model = build_model(cfg)
    params = model.init(0, device="cpu")
    opt = AdamW(lr=1e-3)
    opt_state = opt.init(params)
    step = make_train_step(model, cfg, opt)
    return cfg, params, opt_state, step


def _same(a, b):
    for x, y in zip(T.leaves(a), T.leaves(b)):
        assert x.dtype == y.dtype and torch.equal(x, y)


def test_recovery_from_injected_failure(setup, tmp_path):
    cfg, params, opt_state, step = setup
    data = SyntheticLM(cfg, seq_len=16, global_batch=2)
    ckpt = CheckpointManager(tmp_path)
    loop = TrainLoop(train_step=step, ckpt=ckpt, checkpoint_every=4,
                     fault_injector=FaultInjector(fail_at_steps=(6,)))
    p, o, hist = loop.run(params, opt_state, data, total_steps=10)
    assert hist["restarts"] == 1
    assert hist["steps_run"] == 12  # steps 4..5 re-run after the step-4 restore
    assert ckpt.latest_step() == 10


@pytest.mark.parametrize("inplace", [False, True])
def test_recovered_run_is_bitwise_the_uninterrupted_run(tmp_path, inplace):
    cfg = get_config("llama3.2-1b-smoke")
    model = build_model(cfg)
    opt = AdamW(lr=1e-3)
    step = make_train_step(model, cfg, opt, inplace=inplace)
    runs = []
    for name, fail in (("plain", ()), ("failed", (6,))):
        params = model.init(0, device="cpu")
        loop = TrainLoop(train_step=step, ckpt=CheckpointManager(tmp_path / name),
                         checkpoint_every=4, fault_injector=FaultInjector(fail_at_steps=fail))
        runs.append(loop.run(params, opt.init(params), SyntheticLM(cfg, seq_len=16,
                                                                    global_batch=2),
                             total_steps=10))
    (p0, o0, h0), (p1, o1, h1) = runs
    assert (h0["restarts"], h1["restarts"]) == (0, 1)
    _same(p0, p1)
    _same(o0, o1)


def test_failure_before_first_checkpoint(setup, tmp_path):
    cfg, params, opt_state, step = setup
    data = SyntheticLM(cfg, seq_len=16, global_batch=2)
    ckpt = CheckpointManager(tmp_path)
    loop = TrainLoop(train_step=step, ckpt=ckpt, checkpoint_every=100,
                     fault_injector=FaultInjector(fail_at_steps=(2,)))
    p, o, hist = loop.run(params, opt_state, data, total_steps=5)
    assert hist["restarts"] == 1
    assert ckpt.latest_step() == 5


def test_too_many_failures_raises(setup, tmp_path):
    cfg, params, opt_state, step = setup
    data = SyntheticLM(cfg, seq_len=16, global_batch=2)

    class AlwaysFail(FaultInjector):
        def check(self, s):
            raise DeviceFailure("permafail")

    loop = TrainLoop(train_step=step, ckpt=CheckpointManager(tmp_path),
                     fault_injector=AlwaysFail(), max_restarts=2)
    with pytest.raises(DeviceFailure):
        loop.run(params, opt_state, data, total_steps=5)


def test_straggler_detection():
    det = StragglerDetector(z_threshold=3.0, min_steps=5, abs_floor_s=0.0)
    for i in range(20):
        assert not det.observe(i, 0.10 + 0.001 * (i % 3))
    assert det.observe(20, 0.5)
    assert det.flagged == [20]
    assert not det.observe(21, 0.10)


def test_data_pipeline_seek_determinism():
    cfg = get_config("llama3.2-1b-smoke")
    d1 = SyntheticLM(cfg, seq_len=16, global_batch=4, seed=3)
    batches = [d1.next_batch() for _ in range(5)]
    d1.seek(2)
    np.testing.assert_array_equal(batches[2]["tokens"], d1.next_batch()["tokens"])


def test_data_pipeline_host_sharding():
    cfg = get_config("llama3.2-1b-smoke")
    h0 = SyntheticLM(cfg, seq_len=16, global_batch=4, host_id=0, host_count=2)
    h1 = SyntheticLM(cfg, seq_len=16, global_batch=4, host_id=1, host_count=2)
    b0, b1 = h0.next_batch(), h1.next_batch()
    assert b0["tokens"].shape == (2, 16)
    assert not np.array_equal(b0["tokens"], b1["tokens"])


def test_prefetcher():
    cfg = get_config("llama3.2-1b-smoke")
    pf = Prefetcher(SyntheticLM(cfg, seq_len=16, global_batch=2), depth=2)
    try:
        assert all(pf.next_batch()["tokens"].shape == (2, 16) for _ in range(4))
    finally:
        pf.close()


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_synthetic_batches_are_bitwise_jax(arch):
    """Every family's batch layout (decoder LM, prefix embeddings,
    encoder-decoder frames), after a seek, under host sharding."""
    for host_id in (0, 1):
        kw = dict(seq_len=24, global_batch=4, seed=5, host_id=host_id, host_count=2)
        ours = SyntheticLM(get_config(arch + "-smoke"), **kw)
        theirs = JaxSyntheticLM(jget_config(arch + "-smoke"), **kw)
        ours.seek(3)
        theirs.seek(3)
        for _ in range(2):
            a, b = ours.next_batch(), theirs.next_batch()
            assert sorted(a) == sorted(b)
            for k in a:
                assert a[k].dtype == b[k].dtype and a[k].shape == b[k].shape
                assert a[k].tobytes() == b[k].tobytes(), (arch, k)
        assert ours.step == theirs.step == 5


def test_elastic_rescale(tmp_path):
    """Save during a run, then resume on another mesh shape: every leaf
    bitwise, the step, and the new mesh's rules."""
    cfg = get_config("llama3.2-1b-smoke")
    model = build_model(cfg)
    opt = AdamW(lr=1e-3)
    params = model.init(0, device="cpu")
    opt_state = opt.init(params)
    ckpt = CheckpointManager(tmp_path)
    ckpt.save(42, {"params": params, "opt": opt_state, "step": 42}, blocking=True)
    new_mesh = make_mesh((1, 1), ("data", "model"))
    p2, o2, step, rules = rescale(ckpt, model, opt, cfg, new_mesh, torch.float32,
                                  device="cpu")
    assert step == 42 and rules.mesh is new_mesh
    _same(params, p2)
    _same(opt_state, o2)


def test_elastic_rescale_onto_more_devices(tmp_path):
    """Scale up: a checkpoint restores for a mesh of more ranks, values
    bitwise; the rules are the bigger mesh's (a process holds whole
    tensors, so only the rules change)."""
    cfg = get_config("llama3.2-1b-smoke")
    model = build_model(cfg)
    opt = AdamW(lr=1e-3)
    params = model.init(0, device="cpu")
    opt_state = opt.init(params)
    ckpt = CheckpointManager(tmp_path)
    ckpt.save(7, {"params": params, "opt": opt_state, "step": 7}, blocking=True)
    big_mesh = make_mesh((2, 2), ("data", "model"))
    p2, o2, step, rules = rescale(ckpt, model, opt, cfg, big_mesh, torch.float32,
                                  device="cpu")
    assert step == 7
    assert rules.mesh.shape == {"data": 2, "model": 2}
    assert rules.spec((8, 64), ("batch", "mlp")) == ("data", "model")
    _same(params, p2)
    _same(opt_state, o2)
    aparams, aopt, _ = shardings_for(model, opt, big_mesh, cfg, torch.float32)
    assert all(t.device.type == "meta" for t in T.leaves((aparams, aopt)))


def test_elastic_rescale_roundtrip_through_one_device(tmp_path):
    cfg = get_config("llama3.2-1b-smoke")
    model = build_model(cfg)
    opt = AdamW(lr=1e-3)
    params = model.init(1, device="cpu")
    opt_state = opt.init(params)
    ckpt = CheckpointManager(tmp_path)
    ckpt.save(3, {"params": params, "opt": opt_state, "step": 3}, blocking=True)
    tiny = make_mesh((1, 1), ("data", "model"))
    p1, o1, step, _ = rescale(ckpt, model, opt, cfg, tiny, torch.float32, device="cpu")
    assert step == 3
    ckpt.save(4, {"params": p1, "opt": o1, "step": 4}, blocking=True)
    back = make_mesh((4, 1), ("data", "model"))
    p2, o2, step2, _ = rescale(ckpt, model, opt, cfg, back, torch.float32, device="cpu")
    assert step2 == 4
    _same(params, p2)
    _same(opt_state, o2)


def test_rescale_defaults_to_the_card(tmp_path, monkeypatch):
    cfg = get_config("llama3.2-1b-smoke")
    model = build_model(cfg)
    opt = AdamW()
    params = model.init(0, device="cpu")
    ckpt = CheckpointManager(tmp_path)
    ckpt.save(1, {"params": params, "opt": opt.init(params), "step": 1}, blocking=True)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        rescale(ckpt, model, opt, cfg, make_mesh((1, 1), ("data", "model")), torch.float32)


def test_failed_ckpt_save_logged_as_typed_event(setup, tmp_path):
    cfg, params, opt_state, _ = setup

    def ok_step(params, opt_state, batch):
        return params, opt_state, {"loss": torch.tensor(1.0)}

    ckpt = CheckpointManager(tmp_path)
    real = ckpt._write_leaves
    state = {"failed": False}

    def fail_once(tmp, leaves):
        if not state["failed"]:
            state["failed"] = True
            raise OSError("boom: transient storage outage")
        real(tmp, leaves)

    ckpt._write_leaves = fail_once
    data = SyntheticLM(cfg, seq_len=16, global_batch=2)
    loop = TrainLoop(train_step=ok_step, ckpt=ckpt, checkpoint_every=2)
    _, _, hist = loop.run(params, opt_state, data, total_steps=6)
    events = hist["ckpt_events"]
    assert len(events) == 1
    kind, step, cause = events[0]
    assert kind == "save_failed" and step == 2 and "boom" in cause
    assert ckpt.latest_step() == 6


def test_nan_loss_raises(setup, tmp_path):
    cfg, params, opt_state, _ = setup

    def nan_step(params, opt_state, batch):
        return params, opt_state, {"loss": torch.tensor(float("nan"))}

    data = SyntheticLM(cfg, seq_len=16, global_batch=2)
    loop = TrainLoop(train_step=nan_step, ckpt=CheckpointManager(tmp_path))
    with pytest.raises(NanLossError, match="non-finite"):
        loop.run(params, opt_state, data, total_steps=3)


def test_jax_and_port_loops_take_the_same_path(tmp_path):
    """The same fault schedule gives JAX's loop and the port's the same
    history: restarts, steps run, checkpoints kept."""
    from repro.checkpoint.manager import CheckpointManager as JaxManager
    from repro.runtime.fault import FaultInjector as JaxInjector, TrainLoop as JaxLoop

    cfg = get_config("llama3.2-1b-smoke")
    seen = {"jax": [], "port": []}

    def counting(name):
        def step(params, opt_state, batch):
            seen[name].append(int(batch["tokens"][0, 0]))
            return params, opt_state, {"loss": np.float32(1.0)}
        return step

    hists = {}
    for name, Loop, Mgr, Inj, Data in (
            ("jax", JaxLoop, JaxManager, JaxInjector, JaxSyntheticLM),
            ("port", TrainLoop, CheckpointManager, FaultInjector, SyntheticLM)):
        c = jget_config("llama3.2-1b-smoke") if name == "jax" else cfg
        params = {"w": np.zeros(3, np.float32)} if name == "jax" else {"w": torch.zeros(3)}
        loop = Loop(train_step=counting(name), ckpt=Mgr(tmp_path / name), checkpoint_every=3,
                    fault_injector=Inj(fail_at_steps=(4, 8)))
        _, _, hists[name] = loop.run(params, params, Data(c, seq_len=8, global_batch=2),
                                     total_steps=10)
    assert seen["jax"] == seen["port"]
    for k in ("restarts", "steps_run", "ckpt_events"):
        assert hists["jax"][k] == hists["port"][k]
    assert sorted(CheckpointManager(tmp_path / "port").all_steps()) == \
        sorted(JaxManager(tmp_path / "jax").all_steps())
