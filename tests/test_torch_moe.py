"""MoE parity: the port's `MoE` against JAX's on the same weights and
inputs -- the output and the Switch-style aux loss -- across routing
groups, capacity drops, exact router ties and both expert widths; and the
port's expert-major single launch against JAX's per-group loop.

JAX runs its plain ("xla") path and its Pallas path (interpret mode); the
port its "torch" backend and, on CPU tensors, its CUDA backends (the
grouped wrapper's plain version).  Tolerance: rtol = atol = 1e-5 (f32).
Under a precision (declared or ambient) every backend routes the experts
through `ops.grouped_matmul`'s quantized path, the router stays full
precision (so the aux loss is unchanged), and a "tensor"-granularity
activation scale is one amax per routing group, as in JAX's per-group
calls.  Quantized outputs are held within 1e-5 * max|ref|, the bound of
tests/test_torch_quant_gemm.py: jax.nn.gelu / silu and torch's differ in
the last bit of about a third of their values, and a quantized (bf16 /
int8) activation can round such a value across a rounding midpoint, which
moves one element by one quantum."""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.core import ops as jops  # noqa: E402
from repro.models.moe import MoE as JMoE  # noqa: E402
from repro_torch.core import ops as tops  # noqa: E402
from repro_torch.models.moe import MoE  # noqa: E402

TOL = dict(rtol=1e-5, atol=1e-5)
JAX_POLICIES = {"xla": jops.MXPolicy("xla"),
                "pallas_mx": jops.MXPolicy("pallas_mx", interpret=True, bm=16, bn=32,
                                           bk=16)}
CASES = {  # name -> (MoE kwargs, x shape (B, S), zero router)
    "g1": (dict(n_groups=1), (2, 5), False),
    "g2": (dict(n_groups=2), (2, 6), False),
    "g4": (dict(n_groups=4), (2, 8), False),
    "g4_indivisible": (dict(n_groups=4), (1, 7), False),  # T % 4 != 0: G = 1
    "drops": (dict(n_groups=1, capacity_factor=0.01), (3, 16), False),
    "zero_router_ties": (dict(n_groups=2), (2, 6), True),
    "e16_k4": (dict(n_experts=16, top_k=4, n_groups=2), (2, 10), False),
    "gelu_experts": (dict(activation="gelu", n_groups=1), (2, 5), False),
}


def _setup(name, seed=0):
    kw, (B, S), zero = CASES[name]
    kw = dict(dict(d_model=32, d_ff=48, n_experts=8, top_k=2), **kw)
    jm = JMoE(**kw)
    tree = jax.tree.map(np.asarray, jm.init(jax.random.PRNGKey(seed)))
    if zero:
        tree["router"] = np.zeros_like(tree["router"])
    x = np.random.default_rng(seed + 1).standard_normal((B, S, 32)).astype(np.float32)
    tp = {k: torch.from_numpy(np.array(v)) for k, v in tree.items()}
    return jm, jax.tree.map(jnp.asarray, tree), MoE(**kw), tp, x


@pytest.mark.parametrize("jax_backend", sorted(JAX_POLICIES))
@pytest.mark.parametrize("name", sorted(CASES))
def test_moe_matches_jax(name, jax_backend):
    jm, jp, tm, tp, x = _setup(name)
    with jops.use_policy(JAX_POLICIES[jax_backend]):
        jy, jaux = jm(jp, jnp.asarray(x))
    for backend in ("torch", "cuda_mx"):
        with tops.use_policy(tops.MXPolicy(backend)):
            ty, taux = tm(tp, torch.from_numpy(x))
        assert ty.dtype == torch.float32 and tuple(ty.shape) == x.shape
        np.testing.assert_allclose(ty.numpy(), np.asarray(jy), **TOL)
        np.testing.assert_allclose(float(taux), float(jaux), **TOL)


def test_capacity_drops_happen_and_ties_go_to_the_lower_index():
    """The "drops" case really drops (a roomy capacity changes the output),
    and a zero router sends every token to experts 0..k-1, whose gates are
    1/k each: the output is the mean of those experts' outputs."""
    _, _, tm, tp, x = _setup("drops")
    y, _ = tm(tp, torch.from_numpy(x))
    roomy, _ = dataclasses.replace(tm, capacity_factor=100.0)(tp, torch.from_numpy(x))
    assert not torch.allclose(y, roomy)

    _, _, tm, tp, x = _setup("zero_router_ties")
    y, aux = tm(tp, torch.from_numpy(x))
    xt = torch.from_numpy(x).reshape(-1, 32)
    want = sum(torch.nn.functional.silu(xt @ tp["wg"][e]) * (xt @ tp["wi"][e]) @ tp["wo"][e]
               for e in range(tm.top_k)) / tm.top_k
    np.testing.assert_allclose(y.reshape(-1, 32).numpy(), want.numpy(), **TOL)


def test_expert_major_launch_matches_the_per_group_loop():
    """One grouped launch per projection over the expert-major buffer
    (E, G*C, D) against JAX's loop of one launch per routing group over
    (E*C, D) rows: the same function of each row."""
    _, _, tm, tp, _ = _setup("g4")
    G, E, C, D = 4, tm.n_experts, 8, tm.d_model
    buf = torch.from_numpy(np.random.default_rng(9).standard_normal((G, E, C, D))
                           .astype(np.float32))
    sizes = torch.full((E,), C, dtype=torch.int32)
    with tops.use_policy(tops.MXPolicy("cuda_mx")):
        per_group = []
        for g in range(G):
            h = tops.grouped_matmul(buf[g].reshape(E * C, D), tp["wi"], sizes,
                                    activation="swiglu", w_gate=tp["wg"])
            per_group.append(tops.grouped_matmul(h, tp["wo"], sizes).reshape(E, C, D))
        want = torch.stack(per_group)  # (G, E, C, D)
        got = tm._expert_ffn(tp, buf.transpose(0, 1).reshape(E, G * C, D))
    np.testing.assert_allclose(got.reshape(E, G, C, D).transpose(0, 1).numpy(),
                               want.numpy(), **TOL)
    with tops.use_policy(tops.MXPolicy("torch")):
        plain = tm._expert_ffn(tp, buf.transpose(0, 1).reshape(E, G * C, D))
    np.testing.assert_allclose(plain.numpy(), got.numpy(), **TOL)


def test_unported_moe_options_raise(monkeypatch):
    """2:4 sparse experts and the collective branch raised until ported.
    The sparse experts now match JAX's MoE (the full parity is
    tests/test_torch_sparse.py); the collective branch runs under a
    collective policy (tests/test_torch_tp_model.py), and a multi-rank
    process group without one leaves the layer as it is, as in JAX."""
    import torch.distributed as dist

    jm, jp, tm, tp, x = _setup("g1")
    with jops.use_policy(JAX_POLICIES["xla"]):
        jy, _ = dataclasses.replace(jm, precision="sparse24")(jp, jnp.asarray(x))
    ty, _ = dataclasses.replace(tm, precision="sparse24")(tp, torch.from_numpy(x))
    np.testing.assert_allclose(ty.numpy(), np.asarray(jy), **TOL)
    ref, _ = tm(tp, torch.from_numpy(x))
    monkeypatch.setattr(dist, "is_initialized", lambda: True)
    monkeypatch.setattr(dist, "get_world_size", lambda: 2)
    got, _ = tm(tp, torch.from_numpy(x))
    assert torch.equal(got, ref)


PRECISIONS = ["int8", "int8_all", "int8_tensor", "fp8"]


def _close_max(got, ref):
    ref = np.asarray(ref)
    err = np.abs(np.asarray(got) - ref).max()
    assert err <= 1e-5 * np.abs(ref).max(), (err, np.abs(ref).max())


@pytest.mark.parametrize("jax_backend", sorted(JAX_POLICIES))
@pytest.mark.parametrize("name", ["g1", "g4", "gelu_experts"])
@pytest.mark.parametrize("prec", PRECISIONS)
def test_quantized_moe_matches_jax(prec, name, jax_backend):
    """A declared expert precision against JAX's; "g4" runs G = 4 routing
    groups in one expert-major launch, where "int8_tensor" takes one
    activation amax per group."""
    jm, jp, tm, tp, x = _setup(name)
    jm, tm = dataclasses.replace(jm, precision=prec), dataclasses.replace(tm, precision=prec)
    with jops.use_policy(JAX_POLICIES[jax_backend]):
        jy, jaux = jm(jp, jnp.asarray(x))
    for backend in ("torch", "cuda_mx"):
        with tops.use_policy(tops.MXPolicy(backend)):
            ty, taux = tm(tp, torch.from_numpy(x))
        _close_max(ty.numpy(), jy)
        np.testing.assert_allclose(float(taux), float(jaux), **TOL)
    full, aux_full = dataclasses.replace(tm, precision=None)(tp, torch.from_numpy(x))
    assert float(aux_full) == float(taux)  # the router stays full precision
    assert not torch.allclose(full, ty, rtol=1e-5, atol=1e-5)


def test_ambient_int8_tensor_takes_one_amax_per_routing_group():
    """The ambient context reaches the experts: at G = 4 routing groups of
    very different ranges (one amax per group, in one expert-major launch)
    and at G = 1, the port matches JAX."""
    from repro.core.precision import use_precision as j_use_precision
    from repro_torch.core.precision import use_precision

    jm, jp, tm, tp, x = _setup("g4")
    x = x * np.linspace(0.1, 10.0, x.shape[1], dtype=np.float32)[None, :, None]
    with j_use_precision("int8_tensor"), jops.use_policy(JAX_POLICIES["xla"]):
        jy, _ = jm(jp, jnp.asarray(x))
    with use_precision("int8_tensor"):
        ty, _ = tm(tp, torch.from_numpy(x))
        one, _ = dataclasses.replace(tm, n_groups=1)(tp, torch.from_numpy(x))
    _close_max(ty.numpy(), jy)
    with j_use_precision("int8_tensor"), jops.use_policy(JAX_POLICIES["xla"]):
        jone, _ = dataclasses.replace(jm, n_groups=1)(jp, jnp.asarray(x))
    _close_max(one.numpy(), jone)
