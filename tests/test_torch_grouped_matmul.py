"""Grouped GEMM parity: the port's plain grouped GEMM (`grouped_matmul_ref`,
`mx_grouped_matmul` on CPU tensors) and `ops.grouped_matmul` against JAX's
Pallas `mx_grouped_matmul` (interpret mode) and `grouped_matmul_reference`
on the same numpy inputs.

Tolerance: rtol = atol = 1e-5 in f32 (the summation order differs; every
product is exact in f32), 2e-2 in bf16 (one bf16 rounding of the output).
Rows at or past sum(sizes) must be exact zeros in both packages."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro.kernels.mx_grouped_matmul import grouped_matmul_reference as j_ref  # noqa: E402
from repro.kernels.mx_grouped_matmul import mx_grouped_matmul as j_grouped  # noqa: E402
from repro_torch import kernels  # noqa: E402
from repro_torch.core import ops as tops  # noqa: E402
from repro_torch.kernels.mx_grouped_matmul import mx_grouped_matmul  # noqa: E402
from repro_torch.kernels.ref import grouped_matmul_ref  # noqa: E402

TOL = {"float32": dict(rtol=1e-5, atol=1e-5), "bfloat16": dict(rtol=2e-2, atol=2e-2)}
BLOCKS = dict(bm=8, bn=16, bk=16)  # T, K, N below divide none of them
T, K, N = 40, 37, 45
SIZES = {  # sizes (G groups) -> what the row tiles of bm = 8 see
    "empty_groups_tail": [5, 0, 12, 3, 11],  # sum 31: rows 31..39 are zeros
    "straddle_three": [2, 3, 1, 0, 9, 0, 25],  # rows 0..7 span four groups
    "exact": [16, 24],
    "all_empty": [0, 0, 0],
    "oversubscribed": [30, 20],  # sum 50 > T: rows past T do not exist
}
ACTS = ("none", "relu", "gelu", "silu", "swiglu")


def _inputs(seed, G, t=T, k=K, n=N):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((t, k)).astype(np.float32),
            rng.standard_normal((G, k, n)).astype(np.float32),
            rng.standard_normal((G, k, n)).astype(np.float32))


def _clamped(sizes, t=T):
    """The sizes JAX's reference sees for an oversubscribed call: each
    group's range cut at t."""
    out, start = [], 0
    for s in sizes:
        end = min(start + s, t)
        out.append(end - start)
        start = end
    return out


@pytest.mark.parametrize("act", ACTS)
@pytest.mark.parametrize("case", sorted(SIZES))
def test_plain_grouped_matmul_matches_jax_kernel(case, act):
    sizes = SIZES[case]
    x, w, wg = _inputs(1, len(sizes))
    gate = act == "swiglu"
    want = j_grouped(jnp.asarray(x), jnp.asarray(w), jnp.asarray(sizes, jnp.int32),
                     w_gate=jnp.asarray(wg) if gate else None, activation=act,
                     interpret=True, **BLOCKS)
    want_ref = j_ref(jnp.asarray(x), jnp.asarray(w), jnp.asarray(_clamped(sizes), jnp.int32),
                     w_gate=jnp.asarray(wg) if gate else None, activation=act)
    tw = torch.from_numpy(wg) if gate else None
    got = grouped_matmul_ref(torch.from_numpy(x), torch.from_numpy(w), torch.tensor(sizes),
                             w_gate=tw, activation=act)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL["float32"])
    np.testing.assert_allclose(got.numpy(), np.asarray(want_ref), **TOL["float32"])
    total = min(sum(sizes), T)
    assert torch.all(got[total:] == 0)
    # the wrapper and the dispatch on CPU tensors run the same plain version
    kernels.reset_launch_counts()
    for policy in ("torch", "cuda_mx", "cuda_baseline"):
        via = tops.grouped_matmul(torch.from_numpy(x), torch.from_numpy(w),
                                  torch.tensor(sizes, dtype=torch.int32), activation=act,
                                  w_gate=tw, policy=tops.MXPolicy(policy))
        assert torch.equal(via, got), policy
    assert torch.equal(mx_grouped_matmul(torch.from_numpy(x), torch.from_numpy(w),
                                         torch.tensor(sizes), w_gate=tw, activation=act),
                       got)
    assert kernels.launch_counts()["mx_grouped_matmul"] == 0


@pytest.mark.parametrize("act", ["none", "swiglu"])
def test_plain_grouped_matmul_bf16_matches_jax(act):
    sizes = SIZES["empty_groups_tail"]
    x, w, wg = (a.astype(jnp.bfloat16) for a in _inputs(2, len(sizes)))
    gate = act == "swiglu"
    want = j_grouped(jnp.asarray(x), jnp.asarray(w), jnp.asarray(sizes, jnp.int32),
                     w_gate=jnp.asarray(wg) if gate else None, activation=act,
                     interpret=True, **BLOCKS)
    tb = [torch.from_numpy(np.asarray(a, np.float32)).to(torch.bfloat16) for a in (x, w, wg)]
    got = grouped_matmul_ref(tb[0], tb[1], torch.tensor(sizes),
                             w_gate=tb[2] if gate else None, activation=act)
    assert got.dtype == torch.bfloat16
    np.testing.assert_allclose(got.float().numpy(), np.asarray(want, np.float32),
                               **TOL["bfloat16"])
    assert torch.all(got[sum(sizes):] == 0)
    f32 = grouped_matmul_ref(tb[0], tb[1], torch.tensor(sizes),
                             w_gate=tb[2] if gate else None, activation=act,
                             out_dtype=torch.float32)
    assert f32.dtype == torch.float32


def test_grouped_matmul_rejects_bad_inputs():
    x, w, wg = (torch.from_numpy(a) for a in _inputs(3, 2))
    sizes = torch.tensor([20, 20])
    with pytest.raises(ValueError, match="group_sizes"):
        mx_grouped_matmul(x, w, torch.tensor([40]))
    with pytest.raises(ValueError, match="w_gate"):
        mx_grouped_matmul(x, w, sizes, activation="swiglu")
    with pytest.raises(ValueError, match="w_gate"):
        mx_grouped_matmul(x, w, sizes, w_gate=wg, activation="gelu")
    with pytest.raises(ValueError, match="contraction"):
        mx_grouped_matmul(x[:, :-1], w, sizes)
    with pytest.raises(ValueError, match="expected x"):
        mx_grouped_matmul(x, w[0], sizes)
    with pytest.raises(ValueError, match="activation"):
        mx_grouped_matmul(x, w, sizes, activation="tanh")
    with pytest.raises(ValueError, match="b_scale"):
        mx_grouped_matmul(x, w, sizes, b_scale=torch.ones(2, N))
    # the 2:4 and ABFT slots (once unported): a payload without its metadata
    # and an ABFT flag that is not a spec are bad inputs; through the
    # dispatch both run, the sparse policy on the pruned weights and ABFT
    # bitwise equal to ABFT off
    with pytest.raises(ValueError, match="iff b_sparse"):
        mx_grouped_matmul(x, w, sizes, b_sparse=True)
    with pytest.raises(TypeError, match="AbftSpec"):
        mx_grouped_matmul(x, w, sizes, abft=True)
    from repro_torch.kernels.sparse import prune_24

    mx = tops.MXPolicy("cuda_mx")
    k8 = x.shape[1] // 8 * 8  # the 2:4 wire format tiles K in 8s
    x8, w8 = x[:, :k8], w[:, :k8].contiguous()
    got = tops.grouped_matmul(x8, w8, sizes, precision="sparse24_int8", policy=mx)
    want = tops.grouped_matmul(x8, prune_24(w8), sizes, precision="int8", policy=mx)
    assert torch.equal(got, want)
    assert torch.equal(tops.grouped_matmul(x, w, sizes, abft=True, policy=mx),
                       tops.grouped_matmul(x, w, sizes, policy=mx))
