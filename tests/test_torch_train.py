"""The port's training step against the JAX package's, on the CPU.

Inputs come from numpy with a seed, weights from JAX's `model.init(
PRNGKey(0))` through `from_jax_params`.  Held here: `cross_entropy`, both
schedules, `global_norm` and `AdamW.update` (clip engaged and not, a
callable lr, bf16 parameters) within 1e-6 relative (a tree's leaves within
1e-6 * max|ref| each: the moments of later steps cancel, and the global
norm's summation order moves the clip scale by an ulp) on the same inputs;
`make_train_step` on llama3.2-1b-smoke and qwen2-0.5b-smoke at microbatch
1 and 2 (`hold_step`: metrics within 1e-5 relative, moments and parameters
within 1e-5 * max|ref| per leaf); the in-place update bitwise the
functional one; the kernel entries' refusal under grad; the launcher.
"""
import os
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.configs import get_config  # noqa: E402
from repro.data.pipeline import SyntheticLM  # noqa: E402
from repro.launch import steps as jsteps  # noqa: E402
from repro.models import build_model  # noqa: E402
from repro.optim import schedules as jsched  # noqa: E402
from repro.optim.adamw import AdamW as JAdamW, global_norm as jglobal_norm  # noqa: E402
from repro_torch.configs import get_config as tget_config  # noqa: E402
from repro_torch.core import ops  # noqa: E402
from repro_torch.core import tree as T  # noqa: E402
from repro_torch.kernels import (baseline_matmul, mx_flash_attention,  # noqa: E402
                                 mx_flash_decode, mx_flash_verify, mx_grouped_matmul,
                                 mx_matmul_fused, ssd_scan)
from repro_torch.launch import steps as tsteps  # noqa: E402
from repro_torch.models import build_model as tbuild_model, from_jax_params  # noqa: E402
from repro_torch.optim import schedules as tsched  # noqa: E402
from repro_torch.optim.adamw import AdamW, AdamWState, global_norm  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
RTOL = 1e-6


def _np_tree(tree):
    return jax.tree.map(np.asarray, tree)


def _close(got, want, rtol=RTOL, atol=0.0):
    np.testing.assert_allclose(np.asarray(got, dtype=np.float64),
                               np.asarray(want, dtype=np.float64), rtol=rtol, atol=atol)


def _close_leaf(got, want, rtol=RTOL):
    """max|got - want| <= rtol * max|want| over one leaf."""
    got, want = np.asarray(got, dtype=np.float64), np.asarray(want, dtype=np.float64)
    assert np.abs(got - want).max() <= rtol * np.abs(want).max(), (
        np.abs(got - want).max(), np.abs(want).max())


def hold_step(jax_out, port_out, cfg, *, lr, weight_decay, tol=1e-5):
    """One train step of the port against JAX's, from the same parameters
    and zero moments, by `chip_smoke._hold_step` (the rule phase 13 holds
    the card's step to): metrics within `tol` relative; per leaf, m within
    tol * max|ref| and v (a square) within 2 * tol * max|ref|; parameters
    within tol * max|ref| where the step's gradient is at least 1e3 * eps.
    Where it is smaller, the first Adam step's direction g / (|g| + eps)
    turns rounding noise in g into an update of any size up to lr, so
    there the parameters are held to the update's bound, 2 * lr * (1 +
    weight_decay * |p|) (JAX's own jitted and eager f32 gradients differ
    at that level)."""
    jp, js, jm = jax_out
    assert int(port_out[1].count) == int(js.count) == 1
    ref = (from_jax_params(_np_tree(jp), cfg, device="cpu"),
           AdamWState(torch.tensor(int(js.count), dtype=torch.int32),
                      from_jax_params(_np_tree(js.m), cfg, device="cpu"),
                      from_jax_params(_np_tree(js.v), cfg, device="cpu")),
           {k: float(v) for k, v in jm.items()})
    rec, ok = _chip_smoke()._hold_step(torch, ref, port_out, tol, lr, weight_decay)
    assert ok and abs(float(port_out[2]["aux_loss"]) - float(jm["aux_loss"])) <= \
        tol * abs(float(jm["aux_loss"])), rec
    return rec


def _chip_smoke():
    if str(ROOT) not in sys.path:
        sys.path.insert(0, str(ROOT))
    import chip_smoke

    return chip_smoke


def _setup(arch, batch=2, seq=32):
    cfg = get_config(arch + "-smoke")
    model = build_model(cfg)
    params = model.init(jax.random.PRNGKey(0))
    tcfg = tget_config(arch + "-smoke")
    return cfg, model, params, tcfg, tbuild_model(tcfg), SyntheticLM(
        cfg, seq_len=seq, global_batch=batch).next_batch()


# ---------------------------------------------------------------------------
# the pieces on the same inputs
# ---------------------------------------------------------------------------


def test_cross_entropy_matches_jax():
    rng = np.random.default_rng(0)
    logits = (rng.normal(size=(3, 7, 50)) * 4).astype(np.float32)
    labels = rng.integers(0, 50, (3, 7)).astype(np.int32)
    want = jsteps.cross_entropy(jnp.asarray(logits), jnp.asarray(labels))
    got = tsteps.cross_entropy(torch.from_numpy(logits), torch.from_numpy(labels))
    _close(got, want)


@pytest.mark.parametrize("kind", ["warmup_cosine", "constant"])
def test_schedules_match_jax(kind):
    if kind == "constant":
        js, ts = jsched.constant(3e-4), tsched.constant(3e-4)
    else:
        js, ts = jsched.warmup_cosine(1e-3, 5, 50), tsched.warmup_cosine(1e-3, 5, 50)
    for step in range(0, 60):
        want = js(jnp.asarray(step, jnp.int32))
        got = ts(torch.tensor(step, dtype=torch.int32))
        assert got.dtype == torch.float32
        _close(got, want)


def _grads(scale, seed=0):
    rng = np.random.default_rng(seed)
    return {"b": (rng.normal(size=(16,)) * scale).astype(np.float32),
            "w": {"a": (rng.normal(size=(8, 16)) * scale).astype(np.float32),
                  "z": (rng.normal(size=(4, 4, 3)) * scale).astype(np.float32)}}


def _to_torch(tree, dtype=None):
    return T.map(lambda a: torch.from_numpy(np.asarray(a, np.float32)).to(dtype or
                                                                          torch.float32), tree)


def test_global_norm_matches_jax():
    g = _grads(3.0)
    got = global_norm(_to_torch(g))
    assert got.dtype == torch.float32 and got.dim() == 0
    _close(got, jglobal_norm(jax.tree.map(jnp.asarray, g)))


@pytest.mark.parametrize("case", ["clipped", "unclipped", "no_clip", "callable_lr", "bf16"])
def test_adamw_update_matches_jax(case):
    scale = 5.0 if case == "clipped" else 1e-2
    kw = dict(grad_clip_norm=None) if case == "no_clip" else {}
    jlr, tlr = ((jsched.warmup_cosine(1e-2, 2, 10), tsched.warmup_cosine(1e-2, 2, 10))
                if case == "callable_lr" else (1e-2, 1e-2))
    jopt, topt = JAdamW(lr=jlr, **kw), AdamW(lr=tlr, **kw)
    params = _grads(1.0, seed=1)
    jdt = jnp.bfloat16 if case == "bf16" else jnp.float32
    jparams = jax.tree.map(lambda a: jnp.asarray(a).astype(jdt), params)
    tparams = _to_torch(params, torch.bfloat16 if case == "bf16" else torch.float32)
    jstate, tstate = jopt.init(jparams), topt.init(tparams)
    for step in range(3):
        g = _grads(scale, seed=10 + step)
        jparams, jstate, jm = jopt.update(jax.tree.map(jnp.asarray, g), jstate, jparams)
        tparams, tstate, tm = topt.update(_to_torch(g), tstate, tparams)
        for k in ("grad_norm", "lr"):
            _close(tm[k], jm[k])
        assert int(tstate.count) == int(jstate.count) == step + 1
        for got, want in ((tstate.m, jstate.m), (tstate.v, jstate.v)):
            for a, b in zip(T.leaves(got), jax.tree.leaves(want)):
                assert a.dtype == torch.float32
                _close_leaf(a, b)
        for a, b in zip(T.leaves(tparams), jax.tree.leaves(jparams)):
            assert a.dtype == (torch.bfloat16 if case == "bf16" else torch.float32)
            _close_leaf(a.float(), b.astype(jnp.float32))
    if case == "clipped":
        assert float(jm["grad_norm"]) > jopt.grad_clip_norm


def test_adamw_inplace_gives_the_functional_bits():
    opt = AdamW(lr=tsched.warmup_cosine(1e-2, 2, 10))
    p1 = _to_torch(_grads(1.0, seed=1))
    p2 = T.map(torch.clone, p1)
    s1, s2 = opt.init(p1), opt.init(p2)
    for step in range(4):
        g = _to_torch(_grads(0.5, seed=20 + step))
        p1, s1, m1 = opt.update(g, s1, p1)
        out_p, out_s, m2 = opt.update(g, s2, p2, inplace=True)
        assert out_p is p2 and out_s is s2
    assert isinstance(s2, AdamWState) and s2.count.dtype == torch.int32
    for a, b in zip(T.leaves((p1, s1)), T.leaves((p2, s2))):
        assert torch.equal(a, b)


# ---------------------------------------------------------------------------
# the train step
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("arch", ["llama3.2-1b", "qwen2-0.5b"])
@pytest.mark.parametrize("microbatch", [1, 2])
def test_train_step_matches_jax(arch, microbatch):
    cfg, model, params, tcfg, tmodel, batch = _setup(arch, batch=2 * microbatch)
    jopt = JAdamW(lr=1e-3)
    jout = jax.jit(jsteps.make_train_step(model, cfg, jopt, microbatch=microbatch))(
        params, jopt.init(params), {k: jnp.asarray(v) for k, v in batch.items()})
    topt = AdamW(lr=1e-3)
    tp = from_jax_params(_np_tree(params), tcfg, device="cpu")
    tout = tsteps.make_train_step(tmodel, tcfg, topt, microbatch=microbatch)(
        tp, topt.init(tp), batch)
    assert set(tout[2]) == {"loss", "aux_loss", "grad_norm", "lr"}
    hold_step(jout, tout, tcfg, lr=1e-3, weight_decay=0.1)


def test_train_step_inplace_and_microbatch_agree():
    """`inplace` gives the functional step's bits; microbatch 2 on a batch
    of two equal halves gives microbatch 1's gradient up to rounding."""
    _, _, params, tcfg, tmodel, batch = _setup("llama3.2-1b", batch=4)
    opt = AdamW(lr=1e-3)
    tp = from_jax_params(_np_tree(params), tcfg, device="cpu")
    a = tsteps.make_train_step(tmodel, tcfg, opt)(tp, opt.init(tp), batch)
    tp2 = T.map(torch.clone, tp)
    b = tsteps.make_train_step(tmodel, tcfg, opt, inplace=True)(tp2, opt.init(tp2), batch)
    assert b[0] is tp2
    for x, y in zip(T.leaves(a), T.leaves(b)):
        assert torch.equal(x, y)
    half = {k: np.concatenate([v[:2], v[:2]]) for k, v in batch.items()}
    one = tsteps.make_train_step(tmodel, tcfg, opt)(tp, opt.init(tp), half)
    two = tsteps.make_train_step(tmodel, tcfg, opt, microbatch=2)(tp, opt.init(tp), half)
    for k in ("loss", "grad_norm"):
        _close(two[2][k], one[2][k], rtol=1e-5)
    for x, y in zip(T.leaves(two[1].m), T.leaves(one[1].m)):
        assert (x - y).abs().max() <= 1e-5 * y.abs().max()


def test_train_step_never_inherits_the_kernel_backend():
    """Under an ambient "cuda_mx" policy the step still differentiates the
    plain path (the kernels would refuse a grad-enabled operand)."""
    _, _, params, tcfg, tmodel, batch = _setup("llama3.2-1b")
    opt = AdamW(lr=1e-3)
    tp = from_jax_params(_np_tree(params), tcfg, device="cpu")
    plain = tsteps.make_train_step(tmodel, tcfg, opt)(tp, opt.init(tp), batch)
    with ops.use_policy(ops.MXPolicy("cuda_mx")):
        got = tsteps.make_train_step(tmodel, tcfg, opt)(tp, opt.init(tp), batch)
    for x, y in zip(T.leaves(got), T.leaves(plain)):
        assert torch.equal(x, y)


# ---------------------------------------------------------------------------
# the kernels refuse a grad-enabled operand that requires grad
# ---------------------------------------------------------------------------


def _kernel_calls(rg):
    """Each kernel entry on small CPU operands (its plain version), with
    the first operand requiring grad when `rg`."""
    g = torch.Generator().manual_seed(0)

    def r(*shape, dtype=torch.float32):
        return torch.randn(*shape, generator=g).to(dtype)

    a, b = r(5, 16).requires_grad_(rg), r(16, 8)
    x, w, sizes = r(6, 16).requires_grad_(rg), r(2, 16, 8), torch.tensor([3, 3])
    q, k, v = r(1, 8, 2, 16).requires_grad_(rg), r(1, 8, 2, 16), r(1, 8, 2, 16)
    sx, sa, sb, sc = (r(1, 16, 2, 4).requires_grad_(rg), -r(1, 16, 2).abs(), r(1, 16, 1, 4),
                      r(1, 16, 1, 4))
    qd, pages = r(2, 2, 16).requires_grad_(rg), r(3, 4, 2, 16)
    table, lengths = torch.tensor([[1, 2], [2, 1]], dtype=torch.int32), torch.tensor([5, 3])
    qv = r(2, 2, 2, 16).requires_grad_(rg)
    return {
        "mx_matmul_fused": lambda: mx_matmul_fused(a, b),
        "baseline_matmul": lambda: baseline_matmul(a, b),
        "mx_grouped_matmul": lambda: mx_grouped_matmul(x, w, sizes),
        "mx_flash_attention": lambda: mx_flash_attention(q, k, v),
        "ssd_scan": lambda: ssd_scan(sx, sa, sb, sc, chunk=8),
        "mx_flash_decode": lambda: mx_flash_decode(qd, pages, pages, table, lengths),
        "mx_flash_verify": lambda: mx_flash_verify(qv, pages, pages, table, lengths),
    }


@pytest.mark.parametrize("entry", list(_kernel_calls(False)))
def test_kernel_entries_refuse_grad_and_keep_their_bits_without_it(entry):
    with pytest.raises(RuntimeError, match=r"requires grad.*\"torch\" backend"):
        _kernel_calls(True)[entry]()
    plain = _kernel_calls(False)[entry]()
    with torch.no_grad():  # the operand requires grad, but no graph is built
        got = _kernel_calls(True)[entry]()
    assert torch.equal(got, plain)


@pytest.mark.parametrize("what", ["linear", "kept_int8", "ring_shards"])
def test_dispatch_refuses_grad_under_cuda_mx(what):
    """A "cuda_mx" linear, a kept quantized payload and the ring's kept
    weight shards refuse a weight that requires grad; under no_grad they
    give the bits of a weight that does not."""
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.parallel.sharding import collective_policy

    g = torch.Generator().manual_seed(1)
    x, w = torch.randn(8, 16, generator=g), torch.randn(16, 8, generator=g)

    def run(weight):
        if what == "linear":
            return ops.linear(x, weight, policy=ops.MXPolicy("cuda_mx"))
        if what == "kept_int8":
            return ops.linear(x, weight, policy=ops.MXPolicy("torch"), precision="int8")
        with collective_policy(make_mesh((1, 2), ("data", "model"))):
            return ops.linear(x, weight, policy=ops.MXPolicy("torch"), tp_mode="allgather")

    plain = run(w)
    ops.clear_weight_cache()
    ops.clear_shard_cache()
    wg = w.clone().requires_grad_()
    with pytest.raises(RuntimeError, match="requires grad"):
        run(wg)
    with torch.no_grad():
        assert torch.equal(run(wg), plain)
    if what == "linear":  # the "torch" backend differentiates
        ops.linear(x, wg, policy=ops.MXPolicy("torch")).sum().backward()
        assert wg.grad is not None and wg.grad.abs().sum() > 0


# ---------------------------------------------------------------------------
# the launcher
# ---------------------------------------------------------------------------


def _train(*args, timeout=300):
    return subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.train", *args], capture_output=True,
        text=True, timeout=timeout, cwd=ROOT,
        env={**os.environ, "PYTHONPATH": str(ROOT / "src")})


def test_train_launcher_end_to_end(tmp_path):
    csv = tmp_path / "m.csv"
    r = _train("--arch", "llama3.2-1b", "--smoke", "--steps", "8", "--batch", "2", "--seq",
               "16", "--ckpt-dir", str(tmp_path / "ck"), "--metrics-csv", str(csv),
               "--device", "cpu")
    assert r.returncode == 0, r.stderr[-2000:]
    assert "arch=llama3.2-1b-smoke" in r.stdout and "mesh={'data': 1, 'model': 1}" in r.stdout
    assert "done: 8 steps" in r.stdout and "0 restarts" in r.stdout
    assert csv.read_text().splitlines()[0] == "step,loss,aux_loss,grad_norm,lr"
    # a second run resumes from the last checkpoint and has nothing left to do
    r = _train("--arch", "llama3.2-1b", "--smoke", "--steps", "8", "--batch", "2", "--seq",
               "16", "--ckpt-dir", str(tmp_path / "ck"), "--device", "cpu")
    assert r.returncode == 0, r.stderr[-2000:]
    assert "resuming from checkpoint step 8" in r.stdout and "done: 0 steps" in r.stdout


def test_train_launcher_failure_recovery(tmp_path):
    r = _train("--arch", "llama3.2-1b", "--smoke", "--steps", "20", "--inject-failure", "7",
               "--ckpt-dir", str(tmp_path / "ck"), "--device", "cpu")
    assert r.returncode == 0, r.stderr[-2000:]
    assert "1 restarts" in r.stdout
    r = _train("--arch", "llama3.2-1b", "--smoke", "--steps", "10", "--batch", "2", "--seq",
               "16", "--ckpt-every", "4", "--inject-failure", "6",
               "--ckpt-dir", str(tmp_path / "ck2"), "--device", "cpu")
    assert r.returncode == 0, r.stderr[-2000:]
    assert "done: 12 steps" in r.stdout and "1 restarts" in r.stdout


def test_train_launcher_refuses_to_fall_back_to_the_cpu(monkeypatch, tmp_path):
    from repro_torch.launch import train

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        train.main(["--smoke", "--steps", "2", "--ckpt-dir", str(tmp_path / "ck")])
