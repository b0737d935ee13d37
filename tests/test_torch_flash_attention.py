"""Flash attention parity: the port's plain `mx_flash_attention` (the CUDA
wrapper's CPU path, `_flash_kernel`'s online softmax) against the JAX
Pallas kernel (interpret mode) and oracle on the same numpy inputs, and
`Attention.__call__` under "cuda_mx" (which routes through the kernel
wrapper) against JAX's `Attention.__call__`.

Tolerance: rtol = atol = 2e-4 in f32, as in tests/test_kernels_flash.py;
bf16 bitwise against the Pallas kernel (both keep the probabilities in f32
for the PV product: JAX's kernel widens v to f32 first); the module-level
calls at 1e-5 (the online softmax against JAX's one-shot softmax, both in
f32)."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.kernels.mx_flash_attention import mx_flash_attention as j_flash  # noqa: E402
from repro.kernels.ref import flash_attention_ref as j_ref  # noqa: E402
from repro.models.layers import Attention as JAttention  # noqa: E402
from repro_torch.core import ops  # noqa: E402
from repro_torch.kernels.mx_flash_attention import mx_flash_attention  # noqa: E402
from repro_torch.kernels.ref import flash_attention_plain, flash_attention_ref  # noqa: E402
from repro_torch.models.layers import Attention  # noqa: E402

TOL = dict(rtol=2e-4, atol=2e-4)


def _qkv(seed, lq, lk, d, dtype=np.float32):
    rng = np.random.default_rng(seed)
    return tuple(rng.standard_normal(s).astype(dtype) for s in ((lq, d), (lk, d), (lk, d)))


@pytest.mark.parametrize("lq,lk,d,bq,bk,causal", [
    (64, 64, 32, 16, 16, True),
    (64, 64, 32, 16, 16, False),
    (96, 96, 16, 32, 16, True),
    (50, 50, 16, 16, 16, True),    # ragged lengths (padding path)
    (33, 70, 8, 16, 32, False),    # cross-attention shape
    (128, 128, 64, 64, 32, True),
    (72, 72, 80, 32, 32, True),    # zamba2's head_dim, not a power of two
])
def test_flash_matches_jax_kernel(lq, lk, d, bq, bk, causal):
    """JAX's six kernel cases plus d = 80: the port against the Pallas kernel
    (its tiles bq / bk) and the oracle."""
    q, k, v = _qkv(lq * lk + d, lq, lk, d)
    got = mx_flash_attention(*map(torch.from_numpy, (q, k, v)), causal=causal).numpy()
    want = np.asarray(j_flash(*map(jnp.asarray, (q, k, v)), bq=bq, bk=bk, causal=causal,
                              interpret=True))
    np.testing.assert_allclose(got, want, **TOL)
    np.testing.assert_allclose(got, np.asarray(j_ref(*map(jnp.asarray, (q, k, v)),
                                                      causal=causal)), **TOL)


def _bf16_pair(q, k, v, causal, **tiles):
    """The port's bf16 output and the Pallas kernel's on the same bf16
    values, both as f32 numpy arrays."""
    tq, tk, tv = (torch.from_numpy(a).bfloat16() for a in (q, k, v))
    got = mx_flash_attention(tq, tk, tv, causal=causal)
    assert got.dtype == torch.bfloat16
    jq, jk, jv = (jnp.asarray(t.float().numpy()).astype(jnp.bfloat16) for t in (tq, tk, tv))
    want = j_flash(jq, jk, jv, causal=causal, interpret=True, **tiles)
    return got.float().numpy(), np.asarray(want, np.float32)


def test_flash_bf16():
    """bf16 at JAX's tiles (32 x 32): bitwise the Pallas kernel."""
    got, want = _bf16_pair(*_qkv(0, 64, 64, 32), True, bq=32, bk=32)
    np.testing.assert_array_equal(got, want)


def test_flash_bf16_full_is_bitwise_jax():
    got, want = _bf16_pair(*_qkv(0, 64, 64, 32), False, bq=32, bk=32)
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("qs", [[0.0648], list(np.linspace(0.05, 3.0, 400))],
                         ids=["crafted", "sweep"])
def test_flash_bf16_probabilities_stay_f32(qs):
    """Two keys, k = [[0, 0], [1, 0]], v = I: the output is the softmax
    itself, so a probability rounded to bf16 before the PV product shows.
    q = 0.0648 gives 0.48828125 in JAX and gave 0.49023438 (one bf16 ulp
    off) while the port rounded p; over the sweep 103 of 400 rows did."""
    q = np.stack([np.asarray(qs, np.float32), np.zeros(len(qs), np.float32)], 1)
    k = np.array([[0, 0], [1, 0]], np.float32)
    got, want = _bf16_pair(q, k, np.eye(2, dtype=np.float32), False)
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("causal", [True, False])
def test_flash_oracle_matches_jax_oracle(causal):
    """The port's oracle is JAX's, its causal mask aligned bottom-right."""
    q, k, v = _qkv(4, 24, 40, 16)
    got = flash_attention_ref(*map(torch.from_numpy, (q, k, v)), causal=causal).numpy()
    want = np.asarray(j_ref(*map(jnp.asarray, (q, k, v)), causal=causal))
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("H,Hkv,causal", [(4, 4, True), (8, 2, True), (6, 3, False)])
def test_flash_batched_gqa_equals_per_head(H, Hkv, causal):
    """(B, S, H, d) with GQA: query head h reads kv head h // (H / Hkv);
    each (batch, head) equals the single-head call on its own rows."""
    rng = np.random.default_rng(H * Hkv)
    B, Lq, Lk, d = 2, 40, 40 if causal else 56, 16
    q = torch.from_numpy(rng.standard_normal((B, Lq, H, d)).astype(np.float32))
    k = torch.from_numpy(rng.standard_normal((B, Lk, Hkv, d)).astype(np.float32))
    v = torch.from_numpy(rng.standard_normal((B, Lk, Hkv, d)).astype(np.float32))
    out = mx_flash_attention(q, k, v, causal=causal)
    for b in range(B):
        for h in range(H):
            hk = h // (H // Hkv)
            one = flash_attention_plain(q[b:b + 1, :, h:h + 1], k[b:b + 1, :, hk:hk + 1],
                                        v[b:b + 1, :, hk:hk + 1], causal=causal)
            np.testing.assert_allclose(out[b, :, h].numpy(), one[0, :, 0].numpy(),
                                       rtol=1e-6, atol=1e-6)


def test_flash_tile_invariance():
    """The KV tile does not change the result (exact running statistics)."""
    q, k, v = (torch.from_numpy(a)[None, :, None] for a in _qkv(1, 96, 96, 16))
    outs = [flash_attention_plain(q, k, v, bk=bk).numpy() for bk in (16, 48, 96, 128)]
    for o in outs[1:]:
        np.testing.assert_allclose(o, outs[0], rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("H,Hkv,hd,bias,S", [
    (4, 2, 16, False, 24),   # llama-smoke GQA
    (4, 2, 16, True, 24),    # qwen2-smoke qkv bias
    (4, 4, 16, False, 40),   # zamba2-smoke's shared block
    (32, 32, 80, False, 9),  # zamba2-2.7b's shared block head shape
])
def test_attention_call_under_cuda_mx_matches_jax(H, Hkv, hd, bias, S):
    """`Attention.__call__` under MXPolicy("cuda_mx") on CPU tensors: the
    kernel wrapper's plain path in place of JAX's full_attention."""
    d_model = 64
    jatt = JAttention(d_model, H, Hkv, hd, qkv_bias=bias)
    jp = jatt.init(jax.random.PRNGKey(H + hd))
    rng = np.random.default_rng(S)
    if bias:  # non-zero biases so the epilogue is exercised
        jp = {k: (jnp.asarray(rng.standard_normal(v.shape).astype(np.float32) * 0.1)
                  if k.startswith("b") else v) for k, v in jp.items()}
    x = rng.standard_normal((2, S, d_model)).astype(np.float32)
    want = np.asarray(jatt(jp, jnp.asarray(x)))
    att = Attention(d_model, H, Hkv, hd, qkv_bias=bias)
    tp = {k: torch.from_numpy(np.array(v)) for k, v in jp.items()}
    with ops.use_policy(ops.MXPolicy("cuda_mx")):
        got = att(tp, torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)
    with ops.use_policy(ops.MXPolicy("torch")):
        plain = att(tp, torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(plain, want, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("H,Hkv,hd,S", [
    (4, 2, 16, 24),    # llama-smoke GQA
    (32, 32, 80, 64),  # zamba2-2.7b's shared block head shape
])
def test_attention_call_bf16_under_cuda_mx_within_the_bf16_gate(H, Hkv, hd, S):
    """`Attention.__call__` in bf16 under MXPolicy("cuda_mx") (the flash
    kernel's plain version, which keeps the probabilities in f32 for the PV
    product, as JAX's kernel does) against JAX's `Attention.__call__`, whose
    full_attention rounds them to bf16: a deliberate difference, within the
    bf16 gate of 2e-2 * max|ref|; the "torch" backend follows JAX's model."""
    d_model = 64
    jatt = JAttention(d_model, H, Hkv, hd)
    jp = {k: v.astype(jnp.bfloat16) for k, v in jatt.init(jax.random.PRNGKey(0)).items()}
    x = np.random.default_rng(0).standard_normal((2, S, d_model)).astype(np.float32)
    xj = jnp.asarray(x).astype(jnp.bfloat16)
    want = np.asarray(jatt(jp, xj).astype(jnp.float32))
    att = Attention(d_model, H, Hkv, hd)
    tp = {k: torch.from_numpy(np.array(v.astype(jnp.float32))).bfloat16()
          for k, v in jp.items()}
    xt = torch.from_numpy(np.array(xj.astype(jnp.float32))).bfloat16()
    gate = 2e-2 * np.abs(want).max()
    for backend in ("cuda_mx", "torch"):
        with ops.use_policy(ops.MXPolicy(backend)):
            got = att(tp, xt)
        assert got.dtype == torch.bfloat16
        err = np.abs(got.float().numpy() - want).max()
        assert err <= gate, (backend, err, gate)


def test_flash_wrapper_checks_shapes():
    q = torch.zeros((1, 4, 3, 8))
    with pytest.raises(ValueError, match="multiple"):
        mx_flash_attention(q, torch.zeros((1, 4, 2, 8)), torch.zeros((1, 4, 2, 8)))
    with pytest.raises(ValueError):
        mx_flash_attention(q, torch.zeros((1, 4, 3, 8)), torch.zeros((1, 5, 3, 8)))
    before = mx_flash_attention.launches
    mx_flash_attention(q, q, q)
    assert mx_flash_attention.launches == before  # the plain path counts nothing
