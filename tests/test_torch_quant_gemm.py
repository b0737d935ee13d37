"""Quantized GEMMs: the port's `ops.linear`, `ops.matmul` and
`ops.grouped_matmul` under every named precision policy against the JAX
package's, on the same numpy inputs.

JAX runs its plain ("xla") reference and its Pallas kernels in interpret
mode (`POL_MX`, bm = bn = bk = 32, as tests/test_quant.py does); the port
its "torch" reference and, on CPU tensors, its CUDA backends (the kernel
wrappers' plain versions).  Tolerance: 1e-5 * max|ref| (f32 sums in
another order over the same payloads); the "int8_all" product (an exact
integer MAC in both packages) is bitwise.  Also pinned: the kept weight
payloads equal fresh quantization and refresh after an in-place write,
and the sparse policies and ABFT, which raised until they were ported,
match JAX."""
import gc

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro.core import ops as jops  # noqa: E402
from repro.core.precision import use_precision as j_use_precision  # noqa: E402
from repro.kernels.mx_matmul import dot_f32 as j_dot_f32  # noqa: E402
from repro.kernels.quant import quantize_operand as j_quantize_operand  # noqa: E402
from repro.core.precision import NAMED_POLICIES as J_POLICIES  # noqa: E402
from repro_torch.core import ops as tops  # noqa: E402
from repro_torch.core.precision import NAMED_POLICIES, PrecisionPolicy, QuantSpec  # noqa: E402
from repro_torch.core.precision import use_precision  # noqa: E402
from repro_torch.kernels import mx_matmul as tmm  # noqa: E402
from repro_torch.kernels.mx_grouped_matmul import mx_grouped_matmul  # noqa: E402
from repro_torch.kernels.quant import quantize_operand  # noqa: E402

QUANTIZING = ["bf16", "int8", "int8_all", "int8_tensor", "fp8", "fp8_all"]
JAX_POLICIES = {"xla": jops.MXPolicy("xla"),
                "pallas_mx": jops.MXPolicy("pallas_mx", bm=32, bn=32, bk=32,
                                           interpret=True)}
PORT_BACKENDS = ("torch", "cuda_mx", "cuda_baseline")
EPILOGUES = {
    "all": dict(activation="gelu", bias=True, residual=True, out_scale=1.7),
    "all_swiglu": dict(activation="swiglu", bias=True, residual=True, out_scale=0.5),
}


def _close(got, ref):
    ref = np.asarray(ref, np.float32)
    err = np.abs(np.asarray(got, np.float32) - ref).max()
    assert err <= 1e-5 * np.abs(ref).max(), (err, np.abs(ref).max())


def _linear_inputs(seed):
    rng = np.random.default_rng(seed)
    M, K, N = 19, 70, 45  # ragged against the 32-blocks
    return dict(x=rng.standard_normal((2, M, K)).astype(np.float32),
                w=(rng.standard_normal((K, N)) * 0.1).astype(np.float32),
                wg=(rng.standard_normal((K, N)) * 0.1).astype(np.float32),
                b=rng.standard_normal((N,)).astype(np.float32),
                res=rng.standard_normal((2, M, N)).astype(np.float32))


@pytest.mark.parametrize("jax_backend", sorted(JAX_POLICIES))
@pytest.mark.parametrize("ep", sorted(EPILOGUES))
@pytest.mark.parametrize("name", QUANTIZING)
def test_linear_matches_jax(name, ep, jax_backend):
    kw = EPILOGUES[ep]
    d = _linear_inputs(1)
    gated = kw["activation"] == "swiglu"

    def call(mod, conv, **extra):
        return mod.linear(conv(d["x"]), conv(d["w"]), conv(d["b"]),
                          activation=kw["activation"],
                          w_gate=conv(d["wg"]) if gated else None,
                          residual=conv(d["res"]), out_scale=kw["out_scale"],
                          out_dtype=extra.pop("out_dtype"), precision=name, **extra)

    with jops.use_policy(JAX_POLICIES[jax_backend]):
        want = call(jops, jnp.asarray, out_dtype=jnp.float32)
    for backend in PORT_BACKENDS:
        got = call(tops, torch.from_numpy, out_dtype=torch.float32,
                   policy=tops.MXPolicy(backend))
        assert got.dtype == torch.float32 and tuple(got.shape) == want.shape
        _close(got.numpy(), want)


@pytest.mark.parametrize("backend", PORT_BACKENDS)
def test_int8_all_product_is_bitwise(backend):
    """The int8 x int8 product is an exact integer MAC in both packages:
    the raw product of JAX's payloads, and the scaled product through the
    dispatch, equal JAX's bit for bit."""
    d = _linear_inputs(2)
    pol, jpol = NAMED_POLICIES["int8_all"], J_POLICIES["int8_all"]
    x2 = d["x"].reshape(-1, d["x"].shape[-1]) * 40.0  # large integer sums
    jqa, _ = j_quantize_operand(jnp.asarray(x2), jpol.a, "a")
    jqb, _ = j_quantize_operand(jnp.asarray(d["w"]), jpol.b, "b")
    qa, _ = quantize_operand(torch.from_numpy(x2), pol.a, "a")
    qb, _ = quantize_operand(torch.from_numpy(d["w"]), pol.b, "b")
    np.testing.assert_array_equal(tmm.dot_f32(qa, qb).numpy(),
                                  np.asarray(j_dot_f32(jqa, jqb)))
    with jops.use_policy(JAX_POLICIES["xla"]):
        want = jops.matmul(jnp.asarray(d["x"]), jnp.asarray(d["w"]),
                           out_dtype=jnp.float32, precision="int8_all")
    got = tops.matmul(torch.from_numpy(d["x"]), torch.from_numpy(d["w"]),
                      policy=tops.MXPolicy(backend), out_dtype=torch.float32,
                      precision="int8_all")
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def _grouped_inputs(seed, act):
    rng = np.random.default_rng(seed)
    G, T, K, N = 4, 96, 64, 48
    return dict(x=rng.standard_normal((T, K)).astype(np.float32),
                w=(rng.standard_normal((G, K, N)) * 0.1).astype(np.float32),
                wg=(rng.standard_normal((G, K, N)) * 0.1).astype(np.float32)
                if act == "swiglu" else None,
                sizes=np.asarray([20, 0, 37, 15], np.int32))  # ragged, empty, tail


@pytest.mark.parametrize("jax_backend", sorted(JAX_POLICIES))
@pytest.mark.parametrize("act", ["none", "swiglu", "gelu"])
@pytest.mark.parametrize("name", QUANTIZING)
def test_grouped_matmul_matches_jax(name, act, jax_backend):
    """Per-row activation scales and per-expert weight scales over ragged
    and empty groups; rows past sum(sizes) stay exact zeros."""
    d = _grouped_inputs(3, act)

    def call(mod, conv, **extra):
        return mod.grouped_matmul(conv(d["x"]), conv(d["w"]), conv(d["sizes"]),
                                  activation=act,
                                  w_gate=None if d["wg"] is None else conv(d["wg"]),
                                  precision=name, **extra)

    with jops.use_policy(JAX_POLICIES[jax_backend]):
        want = call(jops, jnp.asarray, out_dtype=jnp.float32)
    for backend in PORT_BACKENDS:
        got = call(tops, torch.from_numpy, out_dtype=torch.float32,
                   policy=tops.MXPolicy(backend))
        _close(got.numpy(), want)
        assert torch.all(got[int(d["sizes"].sum()):] == 0)


def test_grouped_ambient_precision_and_tensor_stack_scale():
    """The ambient context reaches grouped_matmul; "int8_tensor" takes one
    amax over the whole expert stack, as JAX does."""
    d = _grouped_inputs(4, "none")
    d["w"][2] *= 50.0
    with j_use_precision("int8_tensor"), jops.use_policy(JAX_POLICIES["xla"]):
        want = jops.grouped_matmul(jnp.asarray(d["x"]), jnp.asarray(d["w"]),
                                   jnp.asarray(d["sizes"]), out_dtype=jnp.float32)
    with use_precision("int8_tensor"):
        got = tops.grouped_matmul(torch.from_numpy(d["x"]), torch.from_numpy(d["w"]),
                                  torch.from_numpy(d["sizes"]), out_dtype=torch.float32)
    _close(got.numpy(), want)


def test_matmul_ignores_the_ambient_context_and_out_overrides():
    d = _linear_inputs(5)
    x, w = torch.from_numpy(d["x"]), torch.from_numpy(d["w"])
    plain = tops.matmul(x, w)
    with use_precision("int8_all"):
        assert torch.equal(tops.matmul(x, w), plain)
        ctx = tops.linear(x, w)
        forced = tops.linear(x, w, precision="f32")
        inherit = tops.linear(x, w, precision="none")
    assert not torch.equal(ctx, plain)
    assert torch.equal(forced, tops.linear(x, w))
    assert torch.equal(inherit, ctx)
    assert torch.equal(ctx, tops.linear(x, w, precision="int8_all"))
    y = tops.linear(x, w, precision=PrecisionPolicy(b=QuantSpec("int8"), out="bf16"))
    assert y.dtype == torch.bfloat16


def test_weight_cache_same_bits_and_refreshes_after_an_in_place_write():
    """The kept payload equals fresh quantization; a view of the same
    stacked leaf hits; an in-place write (the version counter) refreshes
    it; the entry goes with the tensor."""
    spec = QuantSpec("int8", "tile")
    stack = torch.from_numpy(_grouped_inputs(6, "none")["w"].copy())
    tops.clear_weight_cache()
    q1, s1, meta = tops._weight_operand(stack[1], spec)
    fq, fs = quantize_operand(stack[1], spec, "b")
    assert torch.equal(q1, fq) and torch.equal(s1, fs) and meta is None
    q2, _, _ = tops._weight_operand(stack[1], spec)  # a new view of the same layer
    assert q2 is q1
    assert tops._weight_operand(stack[2], spec)[0] is not q1
    stack[1].mul_(3.0)  # in place: the version counter moves
    q3, s3, _ = tops._weight_operand(stack[1], spec)
    fq, fs = quantize_operand(stack[1], spec, "b")
    assert q3 is not q1 and torch.equal(q3, fq) and torch.equal(s3, fs)
    x = torch.randn(5, stack.shape[1])
    fresh = tops.linear(x, stack[1].clone(), precision="int8")
    assert torch.equal(tops.linear(x, stack[1], precision="int8"), fresh)
    assert tops._weights
    del stack
    gc.collect()
    assert not tops._weights
    # a cast-only spec on a weight already of its dtype is not kept
    w = torch.randn(4, 3)
    assert tops._weight_operand(w, QuantSpec("f32"))[0] is w and not tops._weights


@pytest.mark.parametrize("name", ["sparse24", "sparse24_int8"])
def test_sparse_policies_and_abft_still_raise(name):
    """Once raising (2:4 and ABFT were not ported), now parity cases: the
    sparse policies through linear, matmul, grouped_matmul and the ambient
    context, and ABFT under a quantizing policy, against JAX's reference
    (within 1e-5 * max|ref|; ABFT on bitwise equal to off)."""
    rng = np.random.default_rng(13)
    xn = rng.standard_normal((4, 16)).astype(np.float32)
    wn = rng.standard_normal((16, 6)).astype(np.float32)
    x, w = torch.from_numpy(xn), torch.from_numpy(wn)
    jx, jw = jnp.asarray(xn), jnp.asarray(wn)
    xla = JAX_POLICIES["xla"]
    for backend in ("torch", "cuda_mx"):
        pol = tops.MXPolicy(backend)
        _close(tops.linear(x, w, precision=name, policy=pol),
               jops.linear(jx, jw, precision=name, policy=xla))
        _close(tops.matmul(x, w, precision=name, policy=pol),
               jops.matmul(jx, jw, precision=name, policy=xla))
        _close(tops.grouped_matmul(x, w[None], torch.tensor([4]), precision=name,
                                   policy=pol),
               jops.grouped_matmul(jx, jw[None], jnp.asarray([4]), precision=name,
                                   policy=xla))
        with use_precision(name):
            got = tops.linear(x, w, policy=pol)
        with j_use_precision(name):
            _close(got, jops.linear(jx, jw, policy=xla))
    mx = tops.MXPolicy("cuda_mx")
    on = tops.linear(x, w, precision="int8", abft=True, policy=mx)
    assert torch.equal(on, tops.linear(x, w, precision="int8", policy=mx))
    _close(on, jops.linear(jx, jw, precision="int8", abft=True, policy=JAX_POLICIES["pallas_mx"]))


def test_kernel_scale_slots_validate_like_jax():
    a = torch.randint(-127, 128, (6, 8), dtype=torch.int8)
    b = torch.randint(-127, 128, (8, 5), dtype=torch.int8)
    ep = tmm.Epilogue(a_scale=True, b_scale=True)
    ok = dict(a_scale=torch.rand(6, 1), b_scale=torch.rand(1, 5), out_dtype=torch.float32)
    got = tmm.mx_matmul_fused(a, b, epilogue=ep, **ok)
    want = (a.double() @ b.double()).float() * ok["a_scale"] * ok["b_scale"]
    assert torch.equal(got, want)
    with pytest.raises(ValueError, match="a_scale operand"):
        tmm.mx_matmul_fused(a, b, a_scale=ok["a_scale"], out_dtype=torch.float32)
    with pytest.raises(ValueError, match="a_scale must be"):
        tmm.mx_matmul_fused(a, b, epilogue=ep, a_scale=torch.rand(1, 6),
                            b_scale=ok["b_scale"])
    with pytest.raises(ValueError, match="bg_scale"):
        tmm.mx_matmul_fused(a, b, epilogue=tmm.Epilogue(activation="swiglu", b_scale=True),
                            b_gate=b, b_scale=ok["b_scale"])
    x = torch.randn(7, 8)
    w = torch.randn(2, 8, 5)
    with pytest.raises(ValueError, match="a_scale must be"):
        mx_grouped_matmul(x, w, torch.tensor([3, 4]), a_scale=torch.ones(1, 7))
    with pytest.raises(ValueError, match="bg_scale"):
        mx_grouped_matmul(x, w, torch.tensor([3, 4]), activation="swiglu", w_gate=w,
                          b_scale=torch.ones(2, 1, 5))


BYTE_NAMES = ["int8_all", "fp8_all"]  # int8 x int8, e4m3 x e4m3: the card's 8-bit route


def _parts_product(qa, qb, bk, parts):
    """The payload product A @ B summed in the order of the card's 8-bit
    prefill tile: K in staged steps of bk rows, cut into `parts` equal
    parts (part p from step p * steps // parts on), each part's partial from
    zero, the partials folded in part order.  int8 x int8: exact integer
    partials.  e4m3 x e4m3: each k32 product exact in f64 (32 products of
    e4m3 values), rounded to f32 and added to the part's f32 sum."""
    K = qa.shape[1]
    steps = -(-K // bk)
    a, b = qa.double(), qb.double()
    total = None
    for p in range(parts):
        k0, k1 = p * steps // parts * bk, min((p + 1) * steps // parts * bk, K)
        if qa.dtype == torch.int8:
            part = a[:, k0:k1] @ b[k0:k1]
        else:
            part = torch.zeros((a.shape[0], b.shape[1]))
            for k in range(k0, k1, 32):
                part = part + (a[:, k:k + 32] @ b[k:k + 32]).float()
        total = part if total is None else total + part
    return total.float()


@pytest.mark.parametrize("K,parts", [(300, 1), (1024, 2), (2048, 4), (4096, 8)])
@pytest.mark.parametrize("name", BYTE_NAMES)
def test_8bit_pairs_at_the_prefill_tiles_k_parts_match_jax(name, K, parts):
    """"int8_all" and "fp8_all" at 40 rows, where the card runs the 8-bit
    prefill tile (128 K rows a stage, K cut into `parts`): the tile table
    gives these parts; the port's fused GEMM (its plain GEMM on the CPU)
    matches JAX's, plain and Pallas in interpret mode, with every epilogue
    operand; and the payload product summed part by part in the tile's
    order matches JAX's dot_f32, as the port's plain one does (int8
    bitwise)."""
    from repro_torch.kernels import _build

    M, N = 40, 77
    pol = NAMED_POLICIES[name]
    tile = _build.prefill_tile(M, N, K, pol.a.torch_dtype, pol.b.torch_dtype)
    assert (tile.route, tile.bk, tile.parts) == ("mma", 128, parts)
    rng = np.random.default_rng(K)
    x = rng.standard_normal((M, K)).astype(np.float32)
    w, wg = ((rng.standard_normal((K, N)) / np.sqrt(K)).astype(np.float32) for _ in range(2))
    b, res = rng.standard_normal((N,)).astype(np.float32), rng.standard_normal(
        (M, N)).astype(np.float32)

    def call(mod, conv, **extra):
        return mod.linear(conv(x), conv(w), conv(b), activation="swiglu", w_gate=conv(wg),
                          residual=conv(res), precision=name, **extra)

    for jax_backend in sorted(JAX_POLICIES):
        with jops.use_policy(JAX_POLICIES[jax_backend]):
            want = call(jops, jnp.asarray, out_dtype=jnp.float32)
        for backend in PORT_BACKENDS:
            got = call(tops, torch.from_numpy, out_dtype=torch.float32,
                       policy=tops.MXPolicy(backend))
            _close(got.numpy(), want)
    jpol = J_POLICIES[name]
    jqa, _ = j_quantize_operand(jnp.asarray(x), jpol.a, "a")
    jqb, _ = j_quantize_operand(jnp.asarray(w), jpol.b, "b")
    qa, _ = quantize_operand(torch.from_numpy(x), pol.a, "a")
    qb, _ = quantize_operand(torch.from_numpy(w), pol.b, "b")
    want = np.asarray(j_dot_f32(jqa, jqb))
    for got in (tmm.dot_f32(qa, qb), _parts_product(qa, qb, tile.bk, tile.parts)):
        if name == "int8_all":
            np.testing.assert_array_equal(got.numpy(), want)
        else:
            _close(got.numpy(), want)


@pytest.mark.parametrize("sizes", [[8] * 8, [0, 40, 3, 0, 21], [70, 0, 66]])  # every height
@pytest.mark.parametrize("name", BYTE_NAMES)
def test_8bit_grouped_at_every_height_matches_jax(name, sizes):
    """"int8_all" and "fp8_all" through the port's grouped GEMM at decode
    height (8 rows per expert: 16-row tiles over two groups), a ragged
    middle and an expert-major chunk, with K = 1024 (two parts of the 8-bit
    tile), against JAX's plain and Pallas GEMMs; rows past the groups stay
    exact zeros."""
    T, K, N = sum(sizes) + 3, 1024, 40
    rng = np.random.default_rng(len(sizes) + T)
    x = rng.standard_normal((T, K)).astype(np.float32)
    w, wg = ((rng.standard_normal((len(sizes), K, N)) / np.sqrt(K)).astype(np.float32)
             for _ in range(2))
    gs = np.asarray(sizes, np.int32)

    def call(mod, conv, **extra):
        return mod.grouped_matmul(conv(x), conv(w), conv(gs), activation="swiglu",
                                  w_gate=conv(wg), precision=name, **extra)

    for jax_backend in sorted(JAX_POLICIES):
        with jops.use_policy(JAX_POLICIES[jax_backend]):
            want = call(jops, jnp.asarray, out_dtype=jnp.float32)
        for backend in PORT_BACKENDS:
            got = call(tops, torch.from_numpy, out_dtype=torch.float32,
                       policy=tops.MXPolicy(backend))
            _close(got.numpy(), want)
            assert torch.all(got[sum(sizes):] == 0)
