"""`core/ops.einsum` against JAX's: the routing cases of
tests/test_fused_ops.py (structural matmul specs to `matmul`, everything
else to `torch.einsum`), the same routed / fallback split from both
parsers, and values within 1e-5 * max|ref| of JAX's `ops.einsum` under its
Pallas policy (interpret mode) on the same seeded inputs."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro.core import ops as jops  # noqa: E402
from repro.core.ops import MXPolicy as JMXPolicy  # noqa: E402
from repro.core.ops import _parse_matmul_subscripts as j_parse  # noqa: E402
from repro_torch.core import ops  # noqa: E402
from repro_torch.core.ops import _parse_matmul_subscripts  # noqa: E402

JPALLAS = JMXPolicy(backend="pallas_mx", bm=32, bn=32, bk=32, interpret=True)
KERNEL = ops.MXPolicy("cuda_mx")  # on CPU tensors the wrapper runs its plain version
TOL = 1e-5

CASES = [  # JAX's test_einsum_routing and test_einsum_routing_edge_cases
    ("mk,kn->mn", [(8, 16), (16, 8)], True),
    ("bsd,df->bsf", [(2, 8, 16), (16, 8)], True),       # the real model shape
    ("abck,kn->abcn", [(2, 3, 4, 8), (8, 5)], True),
    ("mk,kn", [(8, 16), (16, 8)], True),                 # implicit out == mn
    ("bsd,df", [(2, 8, 16), (16, 8)], False),            # implicit out is bfs
    ("k,kn->n", [(16,), (16, 8)], False),                # 1-D lhs: rank contract
    ("bqhd,bkhd->bhqk", [(2, 4, 2, 8), (2, 4, 2, 8)], False),  # attention scores
    ("mk,nk->mn", [(8, 16), (8, 16)], False),            # rhs transposed
    ("kd,kn->dn", [(8, 16), (8, 5)], False),             # contraction not last on lhs
    ("md,dm->m", [(8, 16), (16, 8)], False),             # output sums a lhs dim
    ("kn,mk->mn", [(16, 8), (8, 16)], False),            # operands swapped
    ("km,kn->mn", [(16, 8), (16, 8)], False),            # lhs contraction first
    ("bbk,kn->bn", [(2, 2, 8), (8, 5)], False),          # repeated batch dim in lhs
    ("mk,kk->mk", [(8, 16), (16, 16)], False),           # repeated dim in rhs
    ("abk,kn", [(2, 3, 8), (8, 5)], True),               # implicit out "abn"
    ("zak,kn", [(2, 3, 8), (8, 5)], False),              # ...sorts to "anz": no
    ("...k,kn->...n", [(2, 3, 8), (8, 5)], False),       # ellipsis: fallback
    ("mk,kn->nm", [(8, 16), (16, 5)], False),            # transposed output
    ("mk,kn,nq->mq", [(8, 16), (16, 5), (5, 4)], False),  # 3 operands: fallback
    ("m k, k n -> m n", [(8, 16), (16, 5)], True),       # spaces are stripped
]
IDS = ["mk_kn", "bsd_df", "deep_batch", "implicit", "implicit_sorted", "lhs_1d", "attn",
       "rhs_T", "lhs_k_first", "sum_out", "swapped", "lhs_kfirst", "rep_batch", "rep_rhs",
       "implicit_3d", "implicit_sorted_3d", "ellipsis", "out_T", "three_operands", "spaces"]


def _operands(shapes, seed=0):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal(s).astype(np.float32) for s in shapes]


@pytest.mark.parametrize("spec,shapes,routed", CASES, ids=IDS)
def test_einsum_routing_and_values_are_jaxs(spec, shapes, routed, monkeypatch):
    xs = _operands(shapes)
    if len(xs) == 2:
        assert (j_parse(spec, xs[0].ndim, xs[1].ndim) is not None) == routed
        assert (_parse_matmul_subscripts(spec, xs[0].ndim, xs[1].ndim) is not None) == routed
    calls = []
    kernel = ops.mx_matmul_fused
    monkeypatch.setattr(ops, "mx_matmul_fused", lambda *a, **k: calls.append(1) or kernel(*a, **k))
    got = ops.einsum(spec, *[torch.from_numpy(x) for x in xs], policy=KERNEL)
    assert len(calls) == int(routed)  # routed: one kernel-1 call; else torch.einsum
    want = np.asarray(jops.einsum(spec, *[jnp.asarray(x) for x in xs], policy=JPALLAS))
    assert got.shape == want.shape
    np.testing.assert_allclose(got.numpy(), want, rtol=0,
                               atol=TOL * max(float(np.abs(want).max()), 1e-30))


def test_einsum_parse_never_raises():
    """The structural parser returns None (never throws) on garbage."""
    for spec in ("", "->", "mk", "mk->mk", "mk,kn->", ",->", "mk,,kn->mn",
                 "mk,kn->mnq", "m,n->mn", "...,...->...", "mk,kn->mn->x"):
        assert _parse_matmul_subscripts(spec, 2, 2) is None, spec
        assert j_parse(spec, 2, 2) is None, spec


def test_einsum_on_the_plain_backend_never_reaches_the_kernel(monkeypatch):
    """"torch" (the CPU default, JAX's "xla") takes torch.einsum even for a
    matmul-shaped spec, as JAX's einsum takes jnp.einsum on "xla"."""
    monkeypatch.setattr(ops, "mx_matmul_fused", lambda *a, **k: pytest.fail("kernel called"))
    a, b = (torch.from_numpy(x) for x in _operands([(2, 8, 32), (32, 16)]))
    assert torch.equal(ops.einsum("bsd,df->bsf", a, b), torch.einsum("bsd,df->bsf", a, b))
    assert torch.equal(ops.einsum("bsd,df->bsf", a, b, policy=ops.MXPolicy("torch")),
                       torch.einsum("bsd,df->bsf", a, b))


@pytest.mark.parametrize("policy", [KERNEL, ops.MXPolicy("torch")], ids=["kernel", "torch"])
def test_einsum_preferred_element_type_is_the_out_dtype(policy):
    """bf16 operands with preferred_element_type=f32 accumulate and return
    f32 on both paths, within 1e-5 * max|ref| of JAX's; any other keyword
    is refused, not dropped."""
    xa, xb = _operands([(8, 64), (64, 16)], seed=1)
    a, b = (torch.from_numpy(x).to(torch.bfloat16) for x in (xa, xb))
    got = ops.einsum("mk,kn->mn", a, b, policy=policy, preferred_element_type=torch.float32)
    assert got.dtype == torch.float32
    ja, jb = (jnp.asarray(x, dtype=jnp.bfloat16) for x in (xa, xb))
    want = np.asarray(jops.einsum("mk,kn->mn", ja, jb, policy=JPALLAS,
                                  preferred_element_type=jnp.float32))
    np.testing.assert_allclose(got.numpy(), want, rtol=0,
                               atol=TOL * float(np.abs(want).max()))
    with pytest.raises(TypeError):
        ops.einsum("mk,kn->mn", a, b, policy=policy, precision="highest")
