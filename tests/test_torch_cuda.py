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
from repro_torch.kernels.mx_flash_decode import mx_flash_decode  # noqa: E402
from repro_torch.kernels.ref import baseline_matmul_ref, paged_decode_ref  # noqa: E402
from repro_torch.models import build_model  # noqa: E402
from repro_torch.runtime.batcher import ContinuousBatcher  # noqa: E402
from repro_torch.runtime.kv_pages import PagePool  # noqa: E402
from repro_torch.runtime.lifecycle import Request  # noqa: E402

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


def _pages(B, H, Hkv, d, ps, W, lengths, dtype, dev, poison=False):
    P = B * W + 1
    q = _randn((B, H, d), dtype, dev, 7)
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
