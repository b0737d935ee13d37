"""The port's CUDA kernels against their plain PyTorch versions, on the card.

Every test carries the `requires_cuda` marker and takes the `cuda` fixture,
which skips when no GPU is visible (the CPU suite), so this file runs only
on an NVIDIA H100:
    PYTHONPATH=src python -m pytest -q --noconftest -m requires_cuda tests/test_torch_cuda.py
It imports no JAX (the machine with the card has none, hence --noconftest:
tests/conftest.py clears JAX caches at module teardown): the JAX parity of
the plain versions is held by the other tests/test_torch_*.py files.

Tolerances, kernel against plain version on the same inputs: f32 within
1e-4 * max|ref| (summation order differs), bf16 within 2e-2 * max|ref|
(one bf16 rounding of an f32 result); free slots exactly zero.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch import kernels  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.core import ops  # noqa: E402
from repro_torch.kernels import _build  # noqa: E402
from repro_torch.kernels import mx_matmul as mm  # noqa: E402
from repro_torch.kernels.baseline_matmul import baseline_matmul  # noqa: E402
from repro_torch.core.precision import QuantSpec  # noqa: E402
from repro_torch.kernels.mx_flash_decode import mx_flash_decode, mx_flash_verify  # noqa: E402
from repro_torch.kernels.quant import quantize  # noqa: E402
from repro_torch.kernels.ref import (  # noqa: E402
    baseline_matmul_ref, paged_decode_ref, paged_verify_ref,
)
from repro_torch.models import build_model  # noqa: E402
from repro_torch.runtime.batcher import ContinuousBatcher  # noqa: E402
from repro_torch.runtime.kv_pages import PagePool  # noqa: E402
from repro_torch.runtime.lifecycle import Request  # noqa: E402
from repro_torch.runtime.speculative import NGramDrafter, TraceDrafter  # noqa: E402

pytestmark = pytest.mark.requires_cuda

REL_TOL = {torch.float32: 1e-4, torch.bfloat16: 2e-2}


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (CUDA kernels have no CPU mode)")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    _build.build_all()
    return torch.device("cuda")


def _close(got, ref, dtype):
    ref = ref.float()
    err = (got.float() - ref).abs().max().item()
    bound = REL_TOL[dtype] * max(ref.abs().max().item(), 1e-30)
    assert err <= bound, (err, bound)


def _randn(shape, dtype, dev, seed):
    g = torch.Generator(device=dev).manual_seed(seed)
    return torch.randn(shape, generator=g, device=dev).to(dtype)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("M", [1, 8, 13, 40, 100])  # all three tile shapes
@pytest.mark.parametrize("ep", [
    dict(), dict(bias=True), dict(activation="relu"), dict(activation="gelu"),
    dict(activation="silu"), dict(activation="swiglu", bias=True),
    dict(residual=True, out_scale=0.5),
    dict(activation="gelu", bias=True, residual=True, out_scale=1.5),
])
def test_mx_matmul_kernel_matches_plain(cuda, dtype, M, ep):
    K, N = 300, 77  # ragged against every tile
    e = mm.Epilogue(**ep)
    a, b = _randn((M, K), dtype, cuda, 0), _randn((K, N), dtype, cuda, 1)
    kw = dict(b_gate=_randn((K, N), dtype, cuda, 2) if e.has_gate else None,
              bias=_randn((N,), dtype, cuda, 3) if e.bias else None,
              residual=_randn((M, N), dtype, cuda, 4) if e.residual else None)
    before = mm.mx_matmul_fused.launches
    got = mm.mx_matmul_fused(a, b, epilogue=e, **kw)
    torch.cuda.synchronize()
    assert mm.mx_matmul_fused.launches == before + 1
    assert got.dtype == dtype and got.shape == (M, N)
    _close(got, mm.mx_matmul_fused_plain(a, b, epilogue=e, **kw), dtype)


def test_mx_matmul_kernel_f32_out_from_bf16(cuda):
    a = _randn((8, 256), torch.bfloat16, cuda, 0)
    b = _randn((256, 64), torch.bfloat16, cuda, 1)
    res = _randn((8, 64), torch.float32, cuda, 2)
    e = mm.Epilogue(residual=True)
    got = mm.mx_matmul_fused(a, b, epilogue=e, residual=res, out_dtype=torch.float32)
    want = mm.mx_matmul_fused_plain(a, b, epilogue=e, residual=res,
                                    out_dtype=torch.float32)
    _close(got, want, torch.float32)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("M", [8, 40, 70])
def test_baseline_kernel_matches_plain(cuda, dtype, M):
    K, N = 517, 96
    a, b = _randn((M, K), dtype, cuda, 5), _randn((K, N), dtype, cuda, 6)
    got = baseline_matmul(a, b, bk=128)
    _close(got, baseline_matmul_ref(a, b, 128, dtype), dtype)
    with pytest.raises(ValueError, match="multiple"):
        baseline_matmul(a, b, bk=16)


def _pages(B, H, Hkv, d, ps, W, lengths, dtype, dev, poison=False, S=None):
    """q ((B, H, d), or (B, S, H, d) for a window), page pools with every
    non-live row poisoned on request, the table and the lengths."""
    P = B * W + 1
    q = _randn((B, H, d) if S is None else (B, S, H, d), dtype, dev, 7)
    kp = _randn((P, ps, Hkv, d), dtype, dev, 8)
    vp = _randn((P, ps, Hkv, d), dtype, dev, 9)
    pool = PagePool(P - 1, ps)
    for s, ln in enumerate(lengths):
        if ln:
            pool.reserve(s, ln)
            pool.set_length(s, ln)
    table = pool.page_table(B, W)
    if poison:
        live = np.zeros((P, ps), bool)
        for s, ln in enumerate(lengths):
            for pos in range(ln):
                live[table[s, pos // ps], pos % ps] = True
        dead = torch.as_tensor(~live, device=dev)[:, :, None, None]
        kp = kp.masked_fill(dead, 1e30)
        vp = vp.masked_fill(dead, 1e30)
    return (q, kp, vp, torch.as_tensor(table, device=dev),
            torch.as_tensor(pool.lengths(B), device=dev))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("B,H,Hkv,d,ps,W,lengths,poison", [
    (8, 32, 8, 64, 16, 16, (1, 17, 0, 160, 33, 64, 250, 5), False),  # llama3.2-1b
    (3, 14, 2, 64, 16, 4, (9, 0, 64), False),                        # G = 7
    (2, 4, 2, 16, 4, 4, (6, 3), True),                               # stale pages
    (3, 4, 2, 16, 4, 2, (0, 0, 0), False),                           # all free
])
def test_flash_decode_kernel_matches_plain(cuda, dtype, B, H, Hkv, d, ps, W,
                                           lengths, poison):
    q, kp, vp, table, lns = _pages(B, H, Hkv, d, ps, W, lengths, dtype, cuda, poison)
    got = mx_flash_decode(q, kp, vp, table, lns)
    want = paged_decode_ref(q, kp, vp, table, lns)
    torch.cuda.synchronize()
    assert torch.isfinite(got).all()
    _close(got, want, dtype)
    for i, ln in enumerate(lengths):
        if ln == 0:
            assert torch.all(got[i] == 0)


def _int8(kp, vp):
    """The pages quantized per row and head as the int8 cache stores them:
    (k payload, v payload, k scales, v scales)."""
    (qk, ks), (qv, vs) = (quantize(t, QuantSpec("int8"), axis=-1) for t in (kp, vp))
    return qk, qv, ks[..., 0].contiguous(), vs[..., 0].contiguous()


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("B,H,Hkv,d,ps,W,lengths", [
    (8, 32, 8, 64, 16, 16, (1, 17, 0, 160, 33, 64, 250, 5)),  # llama3.2-1b
    (3, 14, 2, 64, 16, 4, (9, 0, 64)),                        # G = 7
])
def test_flash_decode_int8_scale_pages_match_plain(cuda, dtype, B, H, Hkv, d, ps, W,
                                                   lengths):
    q, kp, vp, table, lns = _pages(B, H, Hkv, d, ps, W, lengths, torch.float32, cuda)
    kp, vp, ks, vs = _int8(kp, vp)
    q = q.to(dtype)
    got = mx_flash_decode(q, kp, vp, table, lns, k_scale=ks, v_scale=vs)
    want = paged_decode_ref(q, kp, vp, table, lns, k_scale=ks, v_scale=vs)
    torch.cuda.synchronize()
    _close(got, want, dtype)


@pytest.mark.parametrize("pages", ["same", "int8"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("B,H,Hkv,d,ps,W,S,lengths,poison", [
    (8, 32, 8, 64, 16, 16, 5, (5, 17, 0, 160, 33, 64, 250, 9), False),  # llama, k=4
    (8, 32, 8, 64, 16, 16, 9, (9, 17, 0, 160, 33, 64, 250, 12), False),  # k = 8
    (4, 14, 2, 64, 16, 11, 5, (33, 0, 160, 7), False),                 # qwen2, G = 7
    (2, 4, 2, 16, 4, 4, 3, (6, 9), True),                              # stale pages
    (3, 4, 2, 16, 4, 2, 2, (0, 0, 0), False),                          # all free
])
def test_flash_verify_kernel_matches_plain(cuda, pages, dtype, B, H, Hkv, d, ps, W,
                                           S, lengths, poison):
    q, kp, vp, table, lns = _pages(B, H, Hkv, d, ps, W, lengths,
                                   dtype if pages == "same" else torch.float32,
                                   cuda, poison, S=S)
    kw = {}
    if pages == "int8":
        kp, vp, ks, vs = _int8(kp, vp)  # a poisoned row keeps its 1e30 in the scale
        kw = dict(k_scale=ks, v_scale=vs)
        q = q.to(dtype)
    before = mx_flash_verify.launches
    got = mx_flash_verify(q, kp, vp, table, lns, **kw)
    want = paged_verify_ref(q, kp, vp, table, lns, **kw)
    torch.cuda.synchronize()
    assert mx_flash_verify.launches == before + 1
    assert got.dtype == dtype and got.shape == q.shape and torch.isfinite(got).all()
    _close(got, want, dtype)
    for i, ln in enumerate(lengths):
        if ln == 0:
            assert torch.all(got[i] == 0)


@pytest.mark.parametrize("pages", ["f32", "int8"])
def test_flash_verify_one_row_equals_decode_kernel(cuda, pages):
    lengths = (1, 17, 0, 160, 33, 64, 250, 5)
    q, kp, vp, table, lns = _pages(8, 32, 8, 64, 16, 16, lengths, torch.float32, cuda)
    kw = {}
    if pages == "int8":
        kp, vp, ks, vs = _int8(kp, vp)
        kw = dict(k_scale=ks, v_scale=vs)
    ver = mx_flash_verify(q[:, None].contiguous(), kp, vp, table, lns, **kw)[:, 0]
    dec = mx_flash_decode(q, kp, vp, table, lns, **kw)
    torch.cuda.synchronize()
    assert torch.equal(ver, dec)


def test_flash_verify_refuses_a_window_past_shared_memory(cuda):
    q = torch.zeros(1, 64, 32, 128, device=cuda)
    kp = torch.zeros(2, 16, 2, 128, device=cuda)
    with pytest.raises(ValueError, match="232448"):
        mx_flash_verify(q, kp, kp, torch.zeros(1, 1, dtype=torch.int32, device=cuda),
                        torch.ones(1, dtype=torch.int32, device=cuda))


def test_verify_shared_memory_covers_every_paged_config_to_k8(cuda):
    """The verify CTA keeps q and the accumulator in shared memory: every
    paged config of the repo fits at k = 8 with 16-token pages (sizes read
    from the library the kernel is launched from)."""
    from repro_torch.configs import ARCH_IDS
    from repro_torch.kernels.mx_flash_decode import _limit

    limit = _limit("mx_flash_max_smem_bytes")
    assert limit == 232448
    for name in ARCH_IDS:
        cfg = get_config(name)
        if cfg.n_kv_heads and not cfg.shared_attn_every and not cfg.frontend_dim \
                and all(kind in ("dense", "moe") for kind, _ in cfg.blocks):
            G = cfg.n_heads // cfg.n_kv_heads
            assert _limit("mx_flash_verify_smem_bytes", 9, G, cfg.hd, 16) <= limit, name


@pytest.mark.parametrize("kernel", ["mx_flash_decode", "mx_flash_verify"])
def test_attention_counts_only_launches(cuda, kernel):
    """An empty batch launches nothing and counts nothing; a real call
    counts one."""
    fn = {"mx_flash_decode": mx_flash_decode, "mx_flash_verify": mx_flash_verify}[kernel]
    kp = torch.zeros(3, 4, 2, 16, device=cuda)

    def call(B):
        q = torch.zeros((B, 4, 16) if fn is mx_flash_decode else (B, 2, 4, 16),
                        device=cuda)
        return fn(q, kp, kp, torch.ones(B, 1, dtype=torch.int32, device=cuda),
                  torch.full((B,), 2, dtype=torch.int32, device=cuda))

    kernels.reset_launch_counts()
    assert call(0).shape[0] == 0
    assert kernels.launch_counts()[kernel] == 0
    call(2)
    torch.cuda.synchronize()
    assert kernels.launch_counts()[kernel] == 1


def test_model_steps_kernel_path_matches_plain_path(cuda):
    cfg = get_config("qwen2-0.5b-smoke")  # qkv bias + G = 2
    model = build_model(cfg)
    params = model.init(0, device=cuda)
    for k in ("bq", "bk", "bv"):
        t = params["seg0"]["attn"][k]
        t.copy_(0.1 * _randn(t.shape, t.dtype, cuda, 10))
    pool = PagePool(12, 4)
    pool.reserve(0, 12)
    pool.reserve(1, 12)
    table = torch.as_tensor(pool.page_table(3, 4), device=cuda)
    toks = torch.randint(0, cfg.vocab, (2, 5), device=cuda)
    index = torch.tensor([0, 2], device=cuda)
    caches, logits = [], []
    for backend in ("cuda_mx", "torch"):
        cache = model.make_paged_cache(pool.total_pages, 4, device=cuda)
        with ops.use_policy(ops.MXPolicy(backend)):
            pl, cache = model.prefill_step_paged(params, toks, cache, index, table[:2])
            dl, cache = model.decode_step_paged(
                params, toks[:, :1].repeat(2, 1)[:3], cache,
                torch.tensor([5, 7, 0], device=cuda), table,
                torch.tensor([6, 8, 0], dtype=torch.int32, device=cuda))
        caches.append(cache)
        logits.append((pl, dl))
    for got, want in zip(logits[0], logits[1]):
        _close(got, want, torch.float32)
    for k in ("k_pages", "v_pages"):
        _close(caches[0]["seg0"][k], caches[1]["seg0"][k], torch.float32)


def test_batcher_streams_equal_across_backends(cuda):
    cfg = get_config("llama3.2-1b-smoke")
    model = build_model(cfg)
    params = model.init(0, device=cuda)
    rng = np.random.default_rng(0)
    sysp = rng.integers(0, cfg.vocab, 12)
    prompts = [np.concatenate([sysp, rng.integers(0, cfg.vocab, n)]).astype(np.int32)
               for n in (1, 3, 5, 2, 4)]
    outs = {}
    for backend in ("cuda_mx", "torch"):
        kernels.reset_launch_counts()
        with ops.use_policy(ops.MXPolicy(backend)):
            b = ContinuousBatcher(model, params, batch_slots=2, max_len=24, page_size=4,
                                  num_pages=20, prefix_cache=True, prefill_chunk=4)
            for i, p in enumerate(prompts):
                b.submit(Request(rid=i, prompt=p, max_new=6))
            fin = b.run_to_completion()
        outs[backend] = {r: fin[r].output for r in fin}
        counts = kernels.launch_counts()
        if backend == "cuda_mx":
            assert counts["mx_matmul_fused"] > 0 and counts["mx_flash_decode"] > 0
        else:
            assert counts == {k: 0 for k in counts}
    assert outs["cuda_mx"] == outs["torch"]


@pytest.mark.parametrize("kv", [None, "int8"])
def test_verify_step_kernel_path_matches_plain_path(cuda, kv):
    cfg = get_config("llama3.2-1b-smoke")
    model = build_model(cfg)
    params = model.init(0, device=cuda)
    kv_quant = QuantSpec(kv) if kv else None
    pool = PagePool(12, 4)
    pool.reserve(0, 16)
    pool.reserve(1, 16)
    table = torch.as_tensor(pool.page_table(3, 8), device=cuda)
    toks = torch.randint(0, cfg.vocab, (2, 6), device=cuda)
    win = torch.randint(0, cfg.vocab, (3, 4), device=cuda)
    index = torch.tensor([6, 9, 0], device=cuda)
    lengths = torch.tensor([10, 13, 0], dtype=torch.int32, device=cuda)
    res = []
    for backend in ("cuda_mx", "torch"):
        cache = model.make_paged_cache(pool.total_pages, 4, device=cuda, kv_quant=kv_quant)
        with ops.use_policy(ops.MXPolicy(backend)):
            model.prefill_step_paged(params, toks, cache, torch.tensor([0, 3], device=cuda),
                                     table[:2])
            kernels.reset_launch_counts()
            vl, cache = model.verify_step_paged(params, win, cache, index, table, lengths)
            torch.cuda.synchronize()
        res.append((vl, cache, kernels.launch_counts()))
    _close(res[0][0], res[1][0], torch.float32)
    assert res[0][2]["mx_flash_verify"] == cfg.n_layers
    assert res[1][2]["mx_flash_verify"] == 0
    for k, v in res[0][1]["seg0"].items():
        if v.dtype == torch.int8:  # the projections differ in summation order:
            # a row may round one quantum apart
            assert (v.int() - res[1][1]["seg0"][k].int()).abs().max() <= 1
        else:
            _close(v, res[1][1]["seg0"][k], torch.float32)


@pytest.mark.parametrize("kv", [None, "int8"])
def test_speculative_streams_equal_plain_streams_on_the_card(cuda, kv):
    cfg = get_config("llama3.2-1b-smoke")
    model = build_model(cfg)
    params = model.init(0, device=cuda)
    rng = np.random.default_rng(1)
    prompts = [rng.integers(0, cfg.vocab, n).astype(np.int32) for n in (6, 9, 13, 7)]
    kv_quant = QuantSpec(kv) if kv else None

    def run(speculate, drafter=None):
        kernels.reset_launch_counts()
        b = ContinuousBatcher(model, params, batch_slots=3, max_len=24, page_size=4,
                              prefill_chunk=4, kv_quant=kv_quant, speculate=speculate,
                              drafter=drafter)
        for i, p in enumerate(prompts):
            b.submit(Request(rid=i, prompt=p, max_new=8))
        fin = b.run_to_completion()
        return {r: fin[r].output for r in fin}, kernels.launch_counts()

    plain, counts = run(0)
    assert counts["mx_flash_decode"] > 0 and counts["mx_flash_verify"] == 0
    traces = [tuple(int(t) for t in p) + tuple(plain[i]) for i, p in enumerate(prompts)]
    for drafter in (NGramDrafter(), TraceDrafter(traces, overlap=0.5, seed=3)):
        spec, counts = run(4, drafter)
        assert spec == plain
        assert counts["mx_flash_verify"] > 0 and counts["mx_flash_decode"] == 0
