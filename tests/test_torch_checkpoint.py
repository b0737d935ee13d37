"""The port's checkpoint manager: every case of test_checkpoint.py
(roundtrip, async double buffering, typed failure surfacing, monotonic
LATEST, GC, atomicity, stale pointer, shape check, restore onto a device),
and the two packages reading each other's checkpoints bitwise, bf16
leaves included."""
import threading
import time

import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.checkpoint.manager import CheckpointManager as JaxManager  # noqa: E402
from repro.optim.adamw import AdamWState as JaxState  # noqa: E402
from repro_torch.checkpoint.manager import CheckpointError, CheckpointManager  # noqa: E402
from repro_torch.core import tree as T  # noqa: E402
from repro_torch.optim.adamw import AdamWState  # noqa: E402


def _tree(key=0):
    rng = np.random.default_rng(key)
    return {
        "params": {"w": torch.from_numpy(rng.normal(size=(8, 16)).astype(np.float32)),
                   "b": torch.zeros((16,), dtype=torch.bfloat16)},
        "opt": {"m": torch.ones((8, 16)), "count": torch.tensor(7, dtype=torch.int32)},
        "step": 7,
    }


def _equal(a, b):
    a = a if isinstance(a, torch.Tensor) else torch.as_tensor(a)
    b = b if isinstance(b, torch.Tensor) else torch.as_tensor(b)
    assert a.dtype == b.dtype and a.shape == b.shape
    assert torch.equal(a.view(torch.uint8) if a.dtype == torch.bfloat16 else a,
                       b.view(torch.uint8) if b.dtype == torch.bfloat16 else b)


def test_roundtrip(tmp_path):
    mgr = CheckpointManager(tmp_path)
    t = _tree()
    mgr.save(10, t, blocking=True)
    assert mgr.latest_step() == 10
    out = mgr.restore(t)
    for a, b in zip(T.leaves(t), T.leaves(out)):
        _equal(b, torch.as_tensor(a) if not isinstance(a, torch.Tensor) else a)
    assert out["params"]["b"].dtype == torch.bfloat16  # bf16 survives as raw bytes
    assert list(out) == list(t) and out["step"].dtype == torch.int64


def test_async_save_then_wait(tmp_path):
    mgr = CheckpointManager(tmp_path)
    mgr.save(1, _tree(1))
    mgr.save(2, _tree(2))
    mgr.wait()
    assert sorted(mgr.all_steps()) == [1, 2]


def test_save_snapshots_before_returning(tmp_path):
    """The host copy is taken inside save(): updating the tensors in place
    right after (the in-place train step) does not reach the files."""
    mgr = CheckpointManager(tmp_path)
    gate = threading.Event()
    real = mgr._write_leaves

    def gated(tmp, leaves):
        assert gate.wait(timeout=30)
        real(tmp, leaves)

    mgr._write_leaves = gated
    t = _tree(3)
    want = t["params"]["w"].clone()
    mgr.save(1, t)
    t["params"]["w"].add_(1.0)
    gate.set()
    mgr.wait()
    _equal(mgr.restore(_tree())["params"]["w"], want)


def test_double_buffered_saves_do_not_stall(tmp_path):
    mgr = CheckpointManager(tmp_path, max_inflight=2)
    gate = threading.Event()
    real = mgr._write_leaves

    def gated(tmp, leaves):
        assert gate.wait(timeout=30), "gate never opened"
        real(tmp, leaves)

    mgr._write_leaves = gated
    t0 = time.perf_counter()
    mgr.save(1, _tree(1))
    mgr.save(2, _tree(2))  # second staging buffer: must not join save(1)
    assert time.perf_counter() - t0 < 5.0
    assert mgr.inflight_saves == 2
    gate.set()
    mgr.wait()
    assert mgr.inflight_saves == 0
    assert sorted(mgr.all_steps()) == [1, 2]
    assert mgr.latest_step() == 2


def test_failed_async_save_surfaces_on_wait(tmp_path):
    mgr = CheckpointManager(tmp_path)
    real = mgr._write_leaves

    def failing(tmp, leaves):
        raise OSError("disk on fire")

    mgr._write_leaves = failing
    mgr.save(1, _tree(1))
    with pytest.raises(CheckpointError) as ei:
        mgr.wait()
    assert ei.value.step == 1
    assert isinstance(ei.value.cause, OSError)
    assert mgr.latest_step() is None
    mgr._write_leaves = real
    mgr.save(2, _tree(2))
    mgr.wait()
    assert mgr.latest_step() == 2


def test_failed_async_save_surfaces_on_next_save(tmp_path):
    mgr = CheckpointManager(tmp_path)

    def failing(tmp, leaves):
        raise OSError("nope")

    mgr._write_leaves = failing
    mgr.save(1, _tree(1))
    for t in list(mgr._inflight):
        t.join()
    with pytest.raises(CheckpointError):
        mgr.save(2, _tree(2))
    assert mgr.all_steps() == []


def test_failed_async_save_surfaces_on_restore(tmp_path):
    mgr = CheckpointManager(tmp_path)
    mgr.save(1, _tree(1), blocking=True)

    def failing(tmp, leaves):
        raise OSError("late")

    mgr._write_leaves = failing
    mgr.save(2, _tree(2))
    with pytest.raises(CheckpointError):
        mgr.restore(_tree())


def test_latest_pointer_monotonic_under_out_of_order_saves(tmp_path):
    mgr = CheckpointManager(tmp_path)
    mgr.save(5, _tree(5), blocking=True)
    mgr.save(3, _tree(3), blocking=True)
    assert mgr.latest_step() == 5
    assert sorted(mgr.all_steps()) == [3, 5]


def test_gc_keeps_last_k(tmp_path):
    mgr = CheckpointManager(tmp_path, keep_last_k=2)
    for s in (1, 2, 3, 4):
        mgr.save(s, _tree(s), blocking=True)
    assert sorted(mgr.all_steps()) == [3, 4]
    assert mgr.latest_step() == 4


def test_atomicity_partial_dir_ignored(tmp_path):
    mgr = CheckpointManager(tmp_path)
    mgr.save(5, _tree(5), blocking=True)
    bad = tmp_path / ".tmp_step_000000006"
    bad.mkdir()
    (bad / "leaf_00000.npy").write_bytes(b"garbage")
    assert mgr.latest_step() == 5
    out = mgr.restore(_tree())
    assert int(out["opt"]["count"]) == 7


def test_stale_latest_pointer_falls_back(tmp_path):
    mgr = CheckpointManager(tmp_path)
    mgr.save(5, _tree(5), blocking=True)
    (tmp_path / "LATEST").write_text("999")
    assert mgr.latest_step() == 5


def test_shape_mismatch_rejected(tmp_path):
    mgr = CheckpointManager(tmp_path)
    mgr.save(1, {"w": torch.zeros((4, 4))}, blocking=True)
    with pytest.raises(ValueError, match="shape"):
        mgr.restore({"w": torch.zeros((8, 8))})


def test_restore_onto_a_device_from_meta_leaves(tmp_path):
    """The elastic path's restore: a tree of shapes only ("meta" tensors)
    filled on the device asked for (here the CPU), bitwise."""
    mgr = CheckpointManager(tmp_path)
    t = {"w": torch.arange(64, dtype=torch.float32).reshape(8, 8)}
    mgr.save(1, t, blocking=True)
    out = mgr.restore({"w": torch.empty((8, 8), device="meta")}, device=torch.device("cpu"))
    assert out["w"].device.type == "cpu"
    _equal(out["w"], t["w"])


# ---------------------------------------------------------------------------
# each package reads the other's files
# ---------------------------------------------------------------------------


def _jax_state_tree(seed):
    rng = np.random.default_rng(seed)
    params = {"embed": rng.normal(size=(16, 8)).astype(np.float32),
              "seg0": {"wq": rng.normal(size=(2, 8, 8)).astype(np.float32),
                       "ln": rng.normal(size=(2, 8)).astype(ml_dtypes.bfloat16)}}
    m = jax.tree.map(lambda a: (a.astype(np.float32) * 0.1), params)
    v = jax.tree.map(lambda a: (a.astype(np.float32) ** 2), params)
    return params, m, v


def _to_port(a):
    a = np.asarray(a)
    if a.dtype == ml_dtypes.bfloat16:
        return torch.from_numpy(a.view(np.int16).copy()).view(torch.bfloat16)
    return torch.from_numpy(np.array(a))


def test_port_restores_a_jax_checkpoint_bitwise(tmp_path):
    params, m, v = _jax_state_tree(0)
    jtree = {"params": jax.tree.map(jnp.asarray, params),
             "opt": JaxState(jnp.asarray(3, jnp.int32), jax.tree.map(jnp.asarray, m),
                             jax.tree.map(jnp.asarray, v)), "step": 3}
    JaxManager(tmp_path).save(3, jtree, blocking=True)
    like = {"params": jax.tree.map(_to_port, params),
            "opt": AdamWState(torch.tensor(0, dtype=torch.int32), jax.tree.map(_to_port, m),
                              jax.tree.map(_to_port, v)), "step": 0}
    mgr = CheckpointManager(tmp_path)
    assert mgr.latest_step() == 3
    out = mgr.restore(like)
    assert isinstance(out["opt"], AdamWState) and int(out["opt"].count) == 3
    assert out["params"]["seg0"]["ln"].dtype == torch.bfloat16
    want = [_to_port(a) for a in jax.tree.leaves(jtree)]
    for a, b in zip(T.leaves(out), want):
        _equal(a, b)


def test_jax_restores_a_port_checkpoint_bitwise(tmp_path):
    params, m, v = _jax_state_tree(1)
    ptree = {"params": jax.tree.map(_to_port, params),
             "opt": AdamWState(torch.tensor(5, dtype=torch.int32), jax.tree.map(_to_port, m),
                               jax.tree.map(_to_port, v)), "step": 5}
    CheckpointManager(tmp_path).save(5, ptree, blocking=True)
    jlike = {"params": jax.tree.map(jnp.asarray, params),
             "opt": JaxState(jnp.asarray(0, jnp.int32), jax.tree.map(jnp.asarray, m),
                             jax.tree.map(jnp.asarray, v)), "step": 0}
    mgr = JaxManager(tmp_path)
    assert mgr.latest_step() == 5
    out = mgr.restore(jlike)
    assert out["params"]["seg0"]["ln"].dtype == jnp.bfloat16
    assert int(out["opt"].count) == 5 and int(out["step"]) == 5
    for a, b in zip(jax.tree.leaves(out)[:-1], T.leaves(ptree)[:-1]):  # the step: above
        got = np.asarray(a)
        want = np.asarray(b) if not isinstance(b, torch.Tensor) else (
            b.view(torch.int16).numpy().view(ml_dtypes.bfloat16)
            if b.dtype == torch.bfloat16 else b.numpy())
        assert got.dtype == want.dtype and got.tobytes() == want.tobytes()
