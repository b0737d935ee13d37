"""The xLSTM slice against JAX: `mlstm_chunkwise`, `mlstm_recurrent_step`,
`MLSTMBlock` and `SLSTMBlock`, and the xlstm-125m smoke model's forward
and dense-cache steps, on the same numpy inputs and JAX weights carried
across with `from_jax_params`.

Tolerance: rtol = atol = 1e-5 in f32 against JAX (the port's other model
parities) for the cells, the blocks and the logits, and JAX's own
tolerances where the port is held against itself (tests/test_xlstm.py:
chunkwise against recurrent at 2e-4, block decode against the parallel
form at 5e-4).  The model's recurrent states after ten decode steps are
held per leaf at 2e-5 * max|ref| (test_decode_steps_match_forward_and_jax
says why).  Measured on these inputs: the chunkwise form against JAX's
up to 6.7e-6 (at max |ref| 20.4, f bias 6), the smoke model's 150-token forward
(two chunks, the second ragged) 7.7e-6 at max |ref| 0.74, inside 1e-5;
the sums over up to 128 positions run in another order in each package."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import get_config as j_get_config  # noqa: E402
from repro.models import build_model as j_build  # noqa: E402
from repro.models import xlstm as jx  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.core import ops  # noqa: E402
from repro_torch.launch.steps import make_prefill_step  # noqa: E402
from repro_torch.models import build_model, from_jax_params  # noqa: E402
from repro_torch.models import xlstm as tx  # noqa: E402
from repro_torch.models.transformer import STATE_KINDS, make_block  # noqa: E402

TOL = dict(rtol=1e-5, atol=1e-5)
XLSTM = "xlstm-125m-smoke"


def _np_tree(tree):
    return jax.tree.map(np.array, tree)


def _torch_tree(tree):
    return jax.tree.map(lambda a: torch.from_numpy(np.array(a)), tree)


def _gates(rng, B, L, H, D, fbias=0.0):
    q, k, v = (rng.standard_normal((B, L, H, D)).astype(np.float32) for _ in range(3))
    i_pre = rng.standard_normal((B, L, H)).astype(np.float32)
    f_pre = (rng.standard_normal((B, L, H)) + fbias).astype(np.float32)
    return q, k, v, i_pre, f_pre


def _recurrent(step, C, n, m, q, k, v, i_pre, f_pre):
    ys = []
    for t in range(q.shape[1]):
        C, n, m, y = step(C, n, m, q[:, t], k[:, t], v[:, t], i_pre[:, t], f_pre[:, t])
        ys.append(y)
    return ys


# ---------------------------------------------------------------------------
# the cells
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("L,chunk,fbias", [
    (16, 4, 0.0), (24, 8, -2.0), (33, 8, 6.0),  # 33: a ragged last chunk (padded)
    (33, 16, 1.5), (16, 16, 3.0), (7, 16, 0.5),  # 7: one chunk, mostly padding
])
def test_chunkwise_matches_jax_and_the_recurrent_form(L, chunk, fbias):
    """JAX's test_chunkwise_equals_recurrent cases: the port's chunkwise
    form equals JAX's at 1e-5, and the port's recurrent form at JAX's 2e-4,
    for chunks that divide L and ones that pad it."""
    B, H, D = 2, 2, 8
    args = _gates(np.random.default_rng(L * chunk + 7), B, L, H, D, fbias)
    want = np.asarray(jx.mlstm_chunkwise(*map(jnp.asarray, args), chunk=chunk))
    got = tx.mlstm_chunkwise(*map(torch.from_numpy, args), chunk=chunk)
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, **TOL)
    state = (torch.zeros((B, H, D, D)), torch.zeros((B, H, D)),
             torch.full((B, H), tx.M_INIT))
    rec = torch.stack(_recurrent(tx.mlstm_recurrent_step, *state,
                                 *map(torch.from_numpy, args)), dim=1)
    np.testing.assert_allclose(got.numpy(), rec.numpy(), rtol=2e-4, atol=2e-4)


def test_recurrent_step_matches_jax():
    """Twelve recurrent steps from the initial state (m = -1e30): every
    output and the final (C, n, m) at 1e-5."""
    B, L, H, D = 2, 12, 3, 8
    args = _gates(np.random.default_rng(4), B, L, H, D, 1.0)
    jstate = (jnp.zeros((B, H, D, D)), jnp.zeros((B, H, D)), jnp.full((B, H), -1e30))
    tstate = (torch.zeros((B, H, D, D)), torch.zeros((B, H, D)),
              torch.full((B, H), tx.M_INIT))
    jout, tout = [], []
    for t in range(L):
        *jstate, jy = jx.mlstm_recurrent_step(*jstate, *(jnp.asarray(a[:, t]) for a in args))
        *tstate, ty = tx.mlstm_recurrent_step(*tstate, *(torch.from_numpy(a[:, t])
                                                         for a in args))
        jout.append(np.asarray(jy))
        tout.append(ty.numpy())
    np.testing.assert_allclose(np.stack(tout), np.stack(jout), **TOL)
    for j, t in zip(jstate, tstate):
        np.testing.assert_allclose(t.numpy(), np.asarray(j), **TOL)


@pytest.mark.parametrize("i_gate,f_gate", [(40.0, -40.0), (40.0, 40.0), (-40.0, -40.0)])
def test_extreme_gates_stay_finite_and_match_jax(i_gate, f_gate):
    """JAX's test_extreme_gates_no_nan (e^40 would overflow unstabilized;
    the exponent above the diagonal is masked with `where`, never by a
    product): finite, and JAX's values at 1e-5, ragged chunks included."""
    B, L, H, D = 1, 30, 2, 8
    rng = np.random.default_rng(0)
    q, k, v = (rng.standard_normal((B, L, H, D)).astype(np.float32) for _ in range(3))
    i_pre = np.full((B, L, H), i_gate, np.float32)
    f_pre = np.full((B, L, H), f_gate, np.float32)
    args = (q, k, v, i_pre, f_pre)
    got = tx.mlstm_chunkwise(*map(torch.from_numpy, args), chunk=8)
    want = np.asarray(jx.mlstm_chunkwise(*map(jnp.asarray, args), chunk=8))
    assert bool(torch.isfinite(got).all()) and np.isfinite(want).all()
    np.testing.assert_allclose(got.numpy(), want, **TOL)


def test_chunkwise_keeps_bf16_inputs_bf16():
    """The cast to v's dtype comes last: bf16 q / k / v give a bf16 y equal
    to JAX's bf16 result (both compute in f32 and round once)."""
    args = _gates(np.random.default_rng(9), 2, 20, 2, 8)
    jargs = [jnp.asarray(a, jnp.bfloat16) if a.ndim == 4 else jnp.asarray(a) for a in args]
    targs = [torch.from_numpy(a).bfloat16() if a.ndim == 4 else torch.from_numpy(a)
             for a in args]
    want = jx.mlstm_chunkwise(*jargs, chunk=8)
    got = tx.mlstm_chunkwise(*targs, chunk=8)
    assert got.dtype == torch.bfloat16 and want.dtype == jnp.bfloat16
    np.testing.assert_allclose(got.float().numpy(), np.asarray(want.astype(jnp.float32)),
                               rtol=1e-2, atol=1e-2)


# ---------------------------------------------------------------------------
# the blocks
# ---------------------------------------------------------------------------


def _block_pair(kind, seed):
    jblk = {"mlstm": jx.MLSTMBlock, "slstm": jx.SLSTMBlock}[kind](d_model=16, n_heads=2)
    tblk = {"mlstm": tx.MLSTMBlock, "slstm": tx.SLSTMBlock}[kind](d_model=16, n_heads=2)
    jp = jblk.init(jax.random.PRNGKey(seed))
    return jblk, jp, tblk, _torch_tree(jp)


@pytest.mark.parametrize("kind,L", [("mlstm", 12), ("slstm", 10), ("mlstm", 150)])
def test_block_call_and_decode_match_jax(kind, L):
    """JAX's test_mlstm_block_decode_matches_parallel and
    test_slstm_block_decode_matches_parallel on the same weights: the
    parallel call and every decode step (with its state) equal JAX's at
    1e-5, and decode equals the parallel form at JAX's 5e-4.  L = 150 runs
    mLSTM over two chunks of 128, the second padded."""
    jblk, jp, tblk, tp = _block_pair(kind, 0)
    x = np.random.default_rng(1).standard_normal((2, L, 16)).astype(np.float32)
    want = np.asarray(jblk(jp, jnp.asarray(x)))
    for policy in ("torch", "cuda_mx"):  # cuda_mx: the kernel wrappers' CPU paths
        with ops.use_policy(ops.MXPolicy(policy)):
            full = tblk(tp, torch.from_numpy(x))
        np.testing.assert_allclose(full.numpy(), want, **TOL, err_msg=policy)
    jstate = jblk.init_state(2)
    state = tblk.init_state(2, device="cpu")
    assert set(state) == set(jstate)
    steps = []
    for t in range(min(L, 12)):
        jy, jstate = jblk.decode(jp, jnp.asarray(x[:, t:t + 1]), jstate)
        y, state = tblk.decode(tp, torch.from_numpy(x[:, t:t + 1]), state)
        np.testing.assert_allclose(y.numpy(), np.asarray(jy), **TOL)
        for key in state:
            np.testing.assert_allclose(state[key].numpy(), np.asarray(jstate[key]), **TOL,
                                       err_msg=key)
        steps.append(y)
    np.testing.assert_allclose(torch.cat(steps, dim=1).numpy(), full[:, :len(steps)].numpy(),
                               rtol=5e-4, atol=5e-4)


@pytest.mark.parametrize("kind", ["mlstm", "slstm"])
def test_init_state_is_jaxs(kind):
    """Shapes, f32, zeros and m at -1e30: mLSTM's m is (B, H), sLSTM's (B, H,
    hd); the head dim of mLSTM is 2 d_model / n_heads (384 at xlstm-125m's
    full width)."""
    jblk, _, tblk, _ = _block_pair(kind, 0)
    jstate, state = jblk.init_state(3), tblk.init_state(3, device="cpu")
    for key in jstate:
        assert state[key].dtype == torch.float32
        np.testing.assert_array_equal(state[key].numpy(), np.asarray(jstate[key]))
    full = make_block("mlstm", get_config("xlstm-125m"))
    assert full.hd == 384 and full.init_state(1, device="meta")["m"].shape == (1, 4)
    assert tuple(make_block("slstm", get_config("xlstm-125m"))
                 .init_state(1, device="meta")["m"].shape) == (1, 4, 192)


def test_slstm_state_tensors_are_separate():
    """decode writes h, c and n in place, so they must not share storage
    (JAX's init_state hands one zeros array to all three)."""
    state = tx.SLSTMBlock(16, 2).init_state(2, device="cpu")
    ptrs = {state[k].data_ptr() for k in state}
    assert len(ptrs) == 4


# ---------------------------------------------------------------------------
# the xlstm-125m smoke model
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def xlstm():
    jm = j_build(j_get_config(XLSTM))
    jp = jm.init(jax.random.PRNGKey(0))
    cfg = get_config(XLSTM)
    return jm, jp, build_model(cfg), from_jax_params(_np_tree(jp), cfg, device="cpu")


def test_blocks_are_state_kinds_and_the_tree_is_jaxs(xlstm):
    _, jp, tm, tp = xlstm
    assert {"mlstm", "slstm"} <= set(STATE_KINDS)
    assert jax.tree.map(lambda a: a.shape, jp) == jax.tree.map(lambda a: tuple(a.shape), tp)
    assert not tm.supports_paged() and not tm.supports_chunked_prefill()


@pytest.mark.parametrize("L", [24, 150])
def test_forward_matches_jax(xlstm, L):
    """The smoke model's full forward (9 blocks, 3 mLSTM + 1 sLSTM x 3, cut
    as smoke configs are) through `make_prefill_step`, on the plain path and
    under "cuda_mx" (the kernel wrappers' CPU paths)."""
    jm, jp, tm, tp = xlstm
    cfg = get_config(XLSTM)
    toks = np.random.default_rng(L).integers(0, cfg.vocab, (2, L)).astype(np.int32)
    want = np.asarray(jm(jp, jnp.asarray(toks))[0])
    step = make_prefill_step(tm, cfg)
    for policy in ("torch", "cuda_mx"):
        with ops.use_policy(ops.MXPolicy(policy)):
            got = step(tp, {"tokens": torch.from_numpy(toks).long()}).numpy()
        np.testing.assert_allclose(got, want, **TOL, err_msg=policy)


def test_decode_steps_match_forward_and_jax(xlstm):
    """Ten tokens through decode_step from make_cache: each step's logits
    equal JAX's at 1e-5 and the forward's (JAX's test_decode parity at
    1e-5); the final state equals JAX's leaf by leaf within 2e-5 * max|ref|
    of the leaf.  The states grow with the steps they sum (mLSTM's C to
    max |ref| 19.4 after ten steps, 5.2e-5 apart there: 2.7e-6 of max
    |ref|), and a stabilizer m that drifts by an ulp a step rescales the
    sLSTM's c and n with it (the last block's m 1.7e-5 apart at 2.7, its c
    3.6e-5 at 2.6: 1.35e-5 of max |ref|; its output h, which the ratio
    c / n gives, 5.3e-6 at 0.77), where the logits are 3.0e-6 apart at max
    |ref| 0.53 (measured on these inputs)."""
    jm, jp, tm, tp = xlstm
    cfg = get_config(XLSTM)
    toks = np.random.default_rng(2).integers(0, cfg.vocab, (2, 10)).astype(np.int32)
    full, _ = tm(tp, torch.from_numpy(toks).long())
    jc = jm.make_cache(2, 12, mode="init", dtype=jnp.float32)
    tc = tm.make_cache(2, 12, dtype=torch.float32, device="cpu")
    assert jax.tree.map(lambda a: (a.shape, str(a.dtype)), jc) == \
        jax.tree.map(lambda a: (tuple(a.shape), str(a.dtype).removeprefix("torch.")), tc)
    for t in range(10):
        index = t if t < 7 else np.array([t, t])  # scalar, then per slot
        jl, jc = jm.decode_step(jp, jnp.asarray(toks[:, t:t + 1]), jc, jnp.asarray(index))
        tl, tc = tm.decode_step(tp, torch.from_numpy(toks[:, t:t + 1]).long(), tc,
                                torch.as_tensor(index))
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **TOL)
        np.testing.assert_allclose(tl[:, 0].numpy(), full[:, t].numpy(), **TOL)
    tflat = dict(jax.tree_util.tree_leaves_with_path(_np_tree(tc)))
    for path, leaf in jax.tree_util.tree_leaves_with_path(jc):
        ref = np.asarray(leaf)
        err = np.abs(tflat[path] - ref).max()
        assert err <= 2e-5 * np.abs(ref).max(), (path, err, np.abs(ref).max())


def test_decode_step_runs_the_projections_through_the_dispatch(xlstm, monkeypatch):
    """A decode step makes one `ops.matmul` per projection: 5 per mLSTM
    block (up, wq, wk, wv, down) and 2 per sLSTM block (w_in, out), 51 at
    xlstm-125m's 9 + 3 blocks (the tied head stays plain, as in JAX)."""
    _, _, tm, tp = xlstm
    calls = []
    real = ops.matmul
    monkeypatch.setattr(ops, "matmul", lambda *a, **k: calls.append(a[1].shape) or real(*a, **k))
    cache = tm.make_cache(2, 4, dtype=torch.float32, device="cpu")
    tm.decode_step(tp, torch.zeros((2, 1), dtype=torch.long), cache, 0)
    n = {kind: sum(c for k, c in get_config(XLSTM).blocks if k == kind)
         for kind in ("mlstm", "slstm")}
    assert len(calls) == 5 * n["mlstm"] + 2 * n["slstm"]
    full = get_config("xlstm-125m").blocks
    assert 5 * sum(c for k, c in full if k == "mlstm") + \
        2 * sum(c for k, c in full if k == "slstm") == 51
