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
(one bf16 rounding of an f32 result); free slots exactly zero.  Quantized
GEMMs (int8 / fp8 payloads with scales, f32 output) within 1e-4 * max|ref|,
and "int8_all" with scales only bitwise (an exact integer MAC on both
sides, then the same two f32 multiplies).  The 2:4 sparse kernels are
bitwise the dense kernels on the expanded weight; the ABFT kernels are
bitwise the kernels without ABFT, and their flag maps equal the plain
versions'.  The dense decode tile (M <= 16, csrc/decode_tile.cuh) is held
on every operand pair, epilogue and ragged or misaligned operand, and the
baseline's at bk = 128 and 256.  The tensor-core prefill tile (f32, bf16,
bf16 x int8 / fp8; M > 16, csrc/prefill_tile.cuh) at M = 17, 40, 64, 65,
256 and 2048 with ragged and misaligned K / N, its 2:4 and ABFT variants
bitwise the dense kernel, ABFT recovery bitwise, and the baseline on it; in
f32 at xlstm-125m's M = 2048 projections also no more than twice as far
from the f64 product as cuBLAS f32, and the f32 attention at zamba2's and
internvl2's shapes no more than twice as far from the softmax in f64 as
its plain version.
`ssd_scan` and `mx_flash_attention` (f32
within 1e-4 * max|ref|, bf16 within 2e-2 * max|ref|) against
`ssd_scan_plain` / the sequential oracle and `flash_attention_plain`; the
tensor-core attention at d = 5, 8, 16 (zero padded to the MMA's K step) and
one row past a 64-row tile, and bitwise on a bf16 case where a probability
rounded to bf16 would show.  Verify at S = 1 is bitwise decode for every
page type, also when the window is longer than its copy ring; the paged
attention's bits do not depend on the batch, the table width, the cluster,
the ring or the spans per round, and hold at 2048 positions.  `ssd_scan`
holds at the edges of its MMA shapes (P = 128, S = 4, chunk 16 and 20),
with HMMA in its SASS.  For the xLSTM, encoder-decoder and prefix models: the
attention kernel at seamless's encoder and cross-attention shapes (Lq = 1
included) and internvl2's (d = 128, 48 / 8 heads, 1088 positions), the
xlstm-125m decode step's 51 decode-tile GEMMs, and the seamless and
internvl2 smoke forwards against the plain path.  Chaos and disaggregated
serving on the kernels: a retried step leaves the pages (f32 and int8)
bitwise those of an unfailed step, every injected host-copy bit flip under
abft=True is detected and corrected, migrated pages are bitwise their
sources, and the disaggregated engine emits the paged batcher's streams.
Training (chip_smoke.py phase 13): the kernels refuse an operand that
requires grad, a smoke train step on the card against the CPU's, GPipe's
gradient over LocalRing(4) on CUDA tensors, the deterministic recovery
child and the train launcher.  The dry run (chip_smoke.py phase 15): the op
census of a smoke train step and a dense decode step on "meta" equals
FlopCounterMode's count of the same steps on the card.
"""
import ctypes

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch import kernels  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.core import ops  # noqa: E402
from repro_torch.kernels import _build  # noqa: E402
from repro_torch.kernels import mx_matmul as mm  # noqa: E402
from repro_torch.kernels.baseline_matmul import baseline_matmul  # noqa: E402
from repro_torch.core.precision import NAMED_POLICIES, QuantSpec, use_precision  # noqa: E402
from repro_torch.kernels.mx_flash_decode import mx_flash_decode, mx_flash_verify  # noqa: E402
from repro_torch.kernels.mx_grouped_matmul import mx_grouped_matmul  # noqa: E402
from repro_torch.kernels.quant import quantize, quantize_operand  # noqa: E402
from repro_torch.kernels.mx_flash_attention import mx_flash_attention  # noqa: E402
from repro_torch.kernels.ref import (  # noqa: E402
    baseline_matmul_ref, flash_attention_plain, grouped_matmul_ref, paged_decode_ref,
    paged_verify_ref, ssd_scan_plain, ssd_scan_ref,
)
from repro_torch.kernels.ssd_scan import ssd_scan  # noqa: E402
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
    """A verify CTA holds a ring of at least two of its slot's pages: 512-row
    pages of 16 query rows at d = 128 need more than a block can use."""
    q = torch.zeros(1, 2, 32, 128, device=cuda)
    kp = torch.zeros(2, 512, 2, 128, device=cuda)
    with pytest.raises(ValueError, match="232448"):
        mx_flash_verify(q, kp, kp, torch.zeros(1, 1, dtype=torch.int32, device=cuda),
                        torch.ones(1, dtype=torch.int32, device=cuda))


@pytest.mark.parametrize("pages", ["f32", "int8"])
def test_flash_verify_runs_the_window_the_old_kernel_refused(cuda, pages):
    """S = 64, G = 16, d = 128 (the window the shared-memory accumulator of
    the port's earlier verify kernel refused) against paged_verify_ref."""
    lengths = (100, 0, 80)
    q, kp, vp, table, lns = _pages(3, 32, 2, 128, 16, 7, lengths, torch.float32, cuda,
                                   poison=True, S=64)
    kw = {}
    if pages == "int8":
        kp, vp, ks, vs = _int8(kp, vp)
        kw = dict(k_scale=ks, v_scale=vs)
    got = mx_flash_verify(q, kp, vp, table, lns, **kw)
    want = paged_verify_ref(q, kp, vp, table, lns, **kw)
    torch.cuda.synchronize()
    assert torch.isfinite(got).all() and torch.all(got[1] == 0)
    _close(got, want, torch.float32)


@pytest.mark.parametrize("pages", ["f32", "int8", "bf16"])
def test_flash_verify_window_past_the_copy_ring(cuda, pages):
    """Windows of 75 and 40 four-row pages: a CTA's span ring holds fewer
    pages than the window (its spans run in rounds past the ring), and at
    S = 1 verify still equals decode bitwise."""
    dt = torch.bfloat16 if pages == "bf16" else torch.float32
    pdt = torch.int8 if pages == "int8" else dt
    lengths = (300, 160, 0, 7)
    sp = _build.decode_split(4, 5, 2, 2, 16, 4, 75, pdt, pages == "int8")
    assert sp.ring * sp.span_pages < 75 and sp.smem <= _build.SMEM_PER_CTA
    for S in (5, 1):
        q, kp, vp, table, lns = _pages(4, 4, 2, 16, 4, 75, lengths, dt, cuda, poison=True,
                                       S=S)
        kw = {}
        if pages == "int8":
            kp, vp, ks, vs = _int8(kp, vp)
            kw = dict(k_scale=ks, v_scale=vs)
        got = mx_flash_verify(q, kp, vp, table, lns, **kw)
        _close(got, paged_verify_ref(q, kp, vp, table, lns, **kw), dt)
        if S == 1:
            dec = mx_flash_decode(q[:, 0].contiguous(), kp, vp, table, lns, **kw)
            torch.cuda.synchronize()
            assert torch.equal(got[:, 0], dec)


def test_verify_shared_memory_covers_every_paged_config_to_k8(cuda):
    """A CTA of the paged attention keeps its query rows, a ring of spans
    and its partials in shared memory: every paged config of the repo fits,
    with 16-token pages of every page type, at k = 8 and any table width
    (the layout read from the library the kernel is launched from equals
    `_build.decode_split_smem`, which the launch table uses)."""
    from repro_torch.configs import ARCH_IDS
    from repro_torch.kernels.mx_flash_decode import _limit

    limit = _limit("mx_flash_max_smem_bytes")
    assert limit == 232448 == _build.SMEM_PER_CTA
    for name in ARCH_IDS:
        cfg = get_config(name)
        if cfg.n_kv_heads and not cfg.shared_attn_every and not cfg.frontend_dim \
                and all(kind in ("dense", "moe") for kind, _ in cfg.blocks):
            G = cfg.n_heads // cfg.n_kv_heads
            assert G <= _limit("mx_flash_verify_max_group"), name
            assert cfg.hd <= _limit("mx_flash_verify_max_dim"), name
            for code, dt in enumerate((torch.float32, torch.bfloat16, torch.int8,
                                       torch.float8_e4m3fn)):
                scaled = dt in _build.QUANTIZED
                for W in (1, 16, 512):
                    sp = _build.decode_split(8, 9, cfg.n_kv_heads, G, cfg.hd, 16, W, dt,
                                             scaled)
                    c_smem = _limit("mx_flash_split_smem_bytes", G, cfg.hd, 16, code,
                                    int(scaled), sp.span_pages, sp.group, sp.ring,
                                    sp.cluster, W)
                    assert c_smem == sp.smem <= limit, (name, code, W)


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


def _quantized_pages(kp, vp, pages):
    """The pages as the cache stores them for `pages` ("f32", "bf16",
    "int8", "fp8"): (k, v, {k_scale, v_scale} or {})."""
    if pages in ("f32", "bf16"):
        dt = torch.float32 if pages == "f32" else torch.bfloat16
        return kp.to(dt), vp.to(dt), {}
    spec = QuantSpec({"int8": "int8", "fp8": "fp8_e4m3"}[pages])
    (qk, ks), (qv, vs) = (quantize(t, spec, axis=-1) for t in (kp, vp))
    return qk, qv, dict(k_scale=ks[..., 0].contiguous(), v_scale=vs[..., 0].contiguous())


@pytest.mark.parametrize("S", [1, 5])
@pytest.mark.parametrize("pages", ["f32", "bf16", "int8", "fp8"])
def test_paged_attention_bits_independent_of_batch_table_and_cluster(cuda, pages, S):
    """The split's output bits depend on the positions, the page size and
    the page dtype alone: every cluster size (1-8), ring depth and group of
    spans per round gives the launch table's bits, and each slot decoded
    alone, over a table cut to its own pages, equals its row in the full
    batch."""
    from repro_torch.kernels.mx_flash_decode import _launch

    lengths = tuple(n + S - 1 if n else 0 for n in (1, 17, 0, 160, 33, 64, 250, 5))
    q, kp, vp, table, lns = _pages(8, 32, 8, 64, 16, 16, lengths, torch.float32, cuda,
                                   poison=True, S=S)
    kp, vp, kw = _quantized_pages(kp, vp, pages)
    fn = mx_flash_decode if S == 1 else mx_flash_verify
    qq = q[:, 0].contiguous() if S == 1 else q
    want = fn(qq, kp, vp, table, lns, **kw)
    base = _build.decode_split(8, S, 8, 4, 64, 16, 16, kp.dtype, bool(kw))
    for cluster in range(1, 9):
        for ring, group in ((1, 1), (2, 2), (3, 1), (1, 3)):
            split = base._replace(cluster=cluster, ring=ring, group=group)
            got = _launch(fn, q, kp, vp, table, lns, kw.get("k_scale"), kw.get("v_scale"),
                          split)
            torch.cuda.synchronize()
            assert torch.equal(got[:, 0] if S == 1 else got, want), (cluster, ring, group)
    for i, ln in enumerate(lengths):
        if ln == 0:
            assert torch.all(want[i] == 0)
            continue
        w = -(-ln // 16)
        alone = fn(qq[i:i + 1].contiguous(), kp, vp, table[i:i + 1, :w].contiguous(),
                   lns[i:i + 1].contiguous(), **kw)
        torch.cuda.synchronize()
        assert torch.equal(alone[0], want[i]), i
    _close(want, (paged_decode_ref(qq, kp, vp, table, lns, **kw) if S == 1 else
                  paged_verify_ref(q, kp, vp, table, lns, **kw)), torch.float32)


@pytest.mark.parametrize("pages", ["f32", "bf16", "int8", "fp8"])
def test_paged_attention_long_context_matches_plain(cuda, pages):
    """2048 positions per slot (llama3.2-1b's heads): decode and a k = 4
    verify window against the plain versions, lengths on and off span
    boundaries, one free slot (every active length at least the window)."""
    lengths = (2048, 2047, 0, 5, 1024, 2000, 32, 1537)
    q, kp, vp, table, lns = _pages(8, 32, 8, 64, 16, 128, lengths, torch.float32, cuda,
                                   poison=True)
    kp, vp, kw = _quantized_pages(kp, vp, pages)
    dt = torch.bfloat16 if pages == "bf16" else torch.float32
    q = q.to(dt)
    got = mx_flash_decode(q, kp, vp, table, lns, **kw)
    torch.cuda.synchronize()
    assert torch.isfinite(got).all() and torch.all(got[2] == 0)
    _close(got, paged_decode_ref(q, kp, vp, table, lns, **kw), dt)
    qv = _randn((8, 5, 32, 64), dt, cuda, 11)
    got = mx_flash_verify(qv, kp, vp, table, lns, **kw)
    torch.cuda.synchronize()
    assert torch.isfinite(got).all() and torch.all(got[2] == 0)
    _close(got, paged_verify_ref(qv, kp, vp, table, lns, **kw), dt)


@pytest.mark.parametrize("pages", ["f32", "bf16", "int8", "fp8"])
def test_flash_verify_one_row_equals_decode_every_page_type(cuda, pages):
    """Verify at S = 1 is decode's launch: bitwise equal for every page type,
    with f32 and bf16 queries."""
    lengths = (1, 17, 0, 160, 33, 64, 250, 5)
    q, kp, vp, table, lns = _pages(8, 32, 8, 64, 16, 16, lengths, torch.float32, cuda)
    kp, vp, kw = _quantized_pages(kp, vp, pages)
    for dt in (torch.float32, torch.bfloat16):
        qd = q.to(dt)
        ver = mx_flash_verify(qd[:, None].contiguous(), kp, vp, table, lns, **kw)[:, 0]
        dec = mx_flash_decode(qd, kp, vp, table, lns, **kw)
        torch.cuda.synchronize()
        assert torch.equal(ver, dec), dt


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


GROUPED_SIZES = {  # T = 70 rows; every tile shape (mean rows 3, 8, 17, 70)
    "ragged_tail": [5, 0, 12, 3, 11, 0, 7, 2, 9, 0, 4, 1, 6, 0, 3, 0, 2, 0, 1, 0],  # sum 66
    "decode_8": [8] * 8 + [0],  # sum 64: the tail rows stay zero
    "straddle": [2, 3, 1, 0, 9, 20, 0, 35],  # sum 70: exact
    "oversubscribed": [50, 40],  # sum 90 > T
    "one_group": [70],
}


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("act", ["none", "relu", "gelu", "silu", "swiglu"])
@pytest.mark.parametrize("case", sorted(GROUPED_SIZES))
def test_grouped_kernel_matches_plain(cuda, case, act, dtype):
    sizes = GROUPED_SIZES[case]
    T, K, N, G = 70, 300, 77, len(sizes)  # K, N ragged against every tile
    x = _randn((T, K), dtype, cuda, 0)
    w = (_randn((G, K, N), torch.float32, cuda, 1) / K ** 0.5).to(dtype)
    wg = (_randn((G, K, N), torch.float32, cuda, 2) / K ** 0.5).to(dtype) \
        if act == "swiglu" else None
    gs = torch.tensor(sizes, dtype=torch.int32, device=cuda)
    got = mx_grouped_matmul(x, w, gs, w_gate=wg, activation=act)
    ref = grouped_matmul_ref(x, w, gs, w_gate=wg, activation=act)
    torch.cuda.synchronize()
    assert got.dtype == dtype and got.shape == (T, N)
    _close(got, ref, dtype)
    assert torch.all(got[min(sum(sizes), T):] == 0)
    f32 = mx_grouped_matmul(x, w, gs, w_gate=wg, activation=act, out_dtype=torch.float32)
    _close(f32, grouped_matmul_ref(x, w, gs, w_gate=wg, activation=act,
                                   out_dtype=torch.float32), dtype)


def test_grouped_kernel_counts_only_launches(cuda):
    """T = 0 launches nothing and counts nothing; a real call counts one,
    and int64 sizes are taken."""
    w = torch.ones(2, 8, 4, device=cuda)
    kernels.reset_launch_counts()
    out = mx_grouped_matmul(torch.ones(0, 8, device=cuda), w,
                            torch.zeros(2, dtype=torch.int32, device=cuda))
    assert out.shape == (0, 4) and kernels.launch_counts()["mx_grouped_matmul"] == 0
    out = mx_grouped_matmul(torch.ones(3, 8, device=cuda), w,
                            torch.tensor([1, 2], device=cuda))
    torch.cuda.synchronize()
    assert kernels.launch_counts()["mx_grouped_matmul"] == 1
    assert torch.all(out == 8)
    with pytest.raises(ValueError, match="group_sizes is on"):
        mx_grouped_matmul(torch.ones(3, 8, device=cuda), w, torch.tensor([1, 2]))


def test_grouped_kernel_int64_weight_offsets(cuda):
    """kimi-k2's expert stack, (384, 7168, 2048) in bf16, is 5.64 G elements,
    past int32: the last experts' rows must match the plain version."""
    G, K, N = 384, 7168, 2048
    gen = torch.Generator(device=cuda).manual_seed(3)
    w = torch.empty((G, K, N), dtype=torch.bfloat16, device=cuda)
    for g in range(G):
        w[g].normal_(generator=gen).mul_(K ** -0.5)
    sizes = torch.zeros(G, dtype=torch.int32, device=cuda)
    sizes[[0, 200, 381, 383]] = torch.tensor([3, 5, 8, 8], dtype=torch.int32, device=cuda)
    x = _randn((24, K), torch.bfloat16, cuda, 4)
    got = mx_grouped_matmul(x, w, sizes)
    ref = grouped_matmul_ref(x, w, sizes)
    torch.cuda.synchronize()
    _close(got, ref, torch.bfloat16)
    _close(got[16:], ref[16:], torch.bfloat16)  # experts 381 and 383
    del w


def test_stacked_init_on_the_card_equals_the_per_layer_stack(cuda):
    """`Builder.stacked` draws each layer into its preallocated stack; on the
    card too that equals building the layers one by one and stacking."""
    from repro_torch.models.modules import Builder
    from repro_torch.models.transformer import make_block

    cfg = get_config("grok-1-314b-smoke")
    seg = build_model(cfg).init(5, device=cuda)["seg0"]
    layers = [make_block("moe", cfg).build(Builder(5, cuda, path=("seg0", str(i))))
              for i in range(cfg.blocks[0][1])]
    for k in ("router", "wi", "wg", "wo"):
        assert torch.equal(seg["ffn"][k], torch.stack([lay["ffn"][k] for lay in layers]))
    assert torch.equal(seg["attn"]["wq"],
                       torch.stack([lay["attn"]["wq"] for lay in layers]))


@pytest.mark.parametrize("name", ["grok-1-314b-smoke", "kimi-k2-1t-a32b-smoke"])
def test_moe_streams_equal_across_backends(cuda, name):
    """MoE serving at smoke size: the grouped kernel on every MoE layer of
    every step and chunk, two launches each, and the plain path's streams."""
    cfg = get_config(name)
    model = build_model(cfg)
    params = model.init(0, device=cuda)
    rng = np.random.default_rng(2)
    prompts = [rng.integers(0, cfg.vocab, n).astype(np.int32) for n in (6, 9, 13, 7)]
    out = {}
    for backend in ("cuda_mx", "torch"):
        with ops.use_policy(ops.MXPolicy(backend)):
            kernels.reset_launch_counts()
            b = ContinuousBatcher(model, params, batch_slots=3, max_len=24, page_size=4,
                                  prefill_chunk=4)
            for i, p in enumerate(prompts):
                b.submit(Request(rid=i, prompt=p, max_new=8))
            fin = b.run_to_completion()
            steps = sum(h.active > 0 for h in b.health)
            out[backend] = ({r: fin[r].output for r in fin}, kernels.launch_counts(),
                            steps + b.prefill_launches)
    assert out["cuda_mx"][0] == out["torch"][0]
    assert out["cuda_mx"][1]["mx_grouped_matmul"] == 2 * cfg.n_layers * out["cuda_mx"][2]
    assert out["torch"][1]["mx_grouped_matmul"] == 0


QUANTIZED = ["bf16", "int8", "int8_all", "int8_tensor", "fp8", "fp8_all"]


def _quantized(pol, x, w, wg=None):
    P = NAMED_POLICIES[pol]
    qa, a_s = quantize_operand(x, P.a, "a")
    qb, b_s = quantize_operand(w, P.b, "b")
    qg, bg_s = quantize_operand(wg, P.b, "b") if wg is not None else (None, None)
    return qa.contiguous(), a_s, qb, b_s, qg, bg_s


@pytest.mark.parametrize("M", [1, 8, 40, 100])  # all three tile shapes
@pytest.mark.parametrize("ep", [dict(), dict(activation="swiglu"),
                                dict(activation="gelu", bias=True, residual=True,
                                     out_scale=0.5)])
@pytest.mark.parametrize("pol", QUANTIZED)
def test_quantized_mx_matmul_kernel_matches_plain(cuda, pol, ep, M):
    K, N = 300, 77  # ragged against every tile
    x, w = _randn((M, K), torch.float32, cuda, 0), _randn((K, N), torch.float32, cuda, 1)
    gated = ep.get("activation") == "swiglu"
    wg = _randn((K, N), torch.float32, cuda, 2) if gated else None
    qa, a_s, qb, b_s, qg, bg_s = _quantized(pol, x, w, wg)
    e = mm.Epilogue(**ep, a_scale=a_s is not None, b_scale=b_s is not None)
    kw = dict(b_gate=qg, a_scale=a_s, b_scale=b_s,
              bg_scale=bg_s if gated and b_s is not None else None,
              bias=_randn((N,), torch.float32, cuda, 3) if e.bias else None,
              residual=_randn((M, N), torch.float32, cuda, 4) if e.residual else None,
              out_dtype=torch.float32)
    before = mm.mx_matmul_fused.launches
    got = mm.mx_matmul_fused(qa, qb, epilogue=e, **kw)
    ref = mm.mx_matmul_fused_plain(qa, qb, epilogue=e, **kw)
    torch.cuda.synchronize()
    assert mm.mx_matmul_fused.launches == before + 1
    _close(got, ref, torch.float32)
    if pol == "int8_all" and not ep:
        assert torch.equal(got, ref)


# ---------------------------------------------------------------------------
# the dense decode tile (M <= 16, csrc/decode_tile.cuh) of both dense GEMMs
# ---------------------------------------------------------------------------

DECODE_PAIRS = ["f32", "bf16", "int8", "fp8", "int8_all", "fp8_all"]  # every GEMM pair
DECODE_EPILOGUES = {"none": {}, "bias": dict(bias=True), "residual": dict(residual=True),
                    "swiglu": dict(activation="swiglu")}
_DECODE_INPUTS = {}


def _decode_inputs(M, K, N, dev):
    """f32 activations, weight, gate weight, bias and residual, drawn once per
    shape (the widest weights are 342 MB) and quantized per test."""
    key = (M, K, N)
    if key not in _DECODE_INPUTS:
        if len(_DECODE_INPUTS) > 4:  # at most a few of the 342 MB weights at once
            _DECODE_INPUTS.clear()
        _DECODE_INPUTS[key] = (
            _randn((M, K), torch.float32, dev, 0), _randn((K, N), torch.float32, dev, 1),
            _randn((K, N), torch.float32, dev, 2), _randn((N,), torch.float32, dev, 3),
            _randn((M, N), torch.float32, dev, 4))
    return _DECODE_INPUTS[key]


def _decode_call(pol, ep, x, w, wg, bias, res):
    gated = ep.get("activation") == "swiglu"
    qa, a_s, qb, b_s, qg, bg_s = _quantized(pol, x, w, wg if gated else None)
    out_dtype = torch.bfloat16 if pol == "bf16" else torch.float32
    e = mm.Epilogue(**ep, a_scale=a_s is not None, b_scale=b_s is not None)
    kw = dict(epilogue=e, b_gate=qg, a_scale=a_s, b_scale=b_s,
              bg_scale=bg_s if gated and b_s is not None else None,
              bias=bias.to(out_dtype) if e.bias else None,
              residual=res.to(out_dtype) if e.residual else None, out_dtype=out_dtype)
    return qa, qb, kw, out_dtype


@pytest.mark.parametrize("ep", sorted(DECODE_EPILOGUES))
@pytest.mark.parametrize("pol", DECODE_PAIRS)
@pytest.mark.parametrize("K", [296, 8192])
@pytest.mark.parametrize("N", [77, 512, 2048, 10448])
@pytest.mark.parametrize("M", [1, 7, 8, 13, 16])
def test_decode_tile_matches_plain(cuda, M, N, K, pol, ep):
    """The dense decode tile on every operand pair and epilogue, at ragged
    and real widths (zamba2's N = 10448, llama's K = 8192), against
    mx_matmul_fused_plain: 1e-4 * max|ref| (f32 out), 2e-2 (bf16); int8 x
    int8 with scales only bitwise."""
    qa, qb, kw, out_dtype = _decode_call(pol, DECODE_EPILOGUES[ep],
                                         *_decode_inputs(M, K, N, cuda))
    kernels.reset_launch_counts()
    got = mm.mx_matmul_fused(qa, qb, **kw)
    ref = mm.mx_matmul_fused_plain(qa, qb, **kw)
    torch.cuda.synchronize()
    assert kernels.decode_launch_counts()["mx_matmul_fused"] == 1
    assert got.dtype == out_dtype and got.shape == (M, N)
    _close(got, ref, out_dtype)
    if pol == "int8_all" and ep == "none":
        assert torch.equal(got, ref)


def _offset_view(t, nbytes=4):
    """A contiguous copy of t whose data starts `nbytes` past a 16-byte
    boundary."""
    buf = torch.empty(t.numel() + 16, dtype=t.dtype, device=t.device)
    v = buf[nbytes // t.element_size():][:t.numel()].view(t.shape)
    v.copy_(t)
    assert v.is_contiguous() and v.data_ptr() % 16 == nbytes
    return v


@pytest.mark.parametrize("which", ["a", "b", "b_gate"])
@pytest.mark.parametrize("pol", DECODE_PAIRS)
def test_decode_tile_takes_a_misaligned_operand(cuda, pol, which):
    """One operand a contiguous view at a 4-byte offset: its rows take the
    4-byte copies, in the same kernel, and the result holds the plain
    version's."""
    M, K, N = 8, 2048, 2048
    qa, qb, kw, out_dtype = _decode_call(pol, dict(activation="swiglu", residual=True),
                                         *_decode_inputs(M, K, N, cuda))
    if which == "a":
        qa = _offset_view(qa)
    elif which == "b":
        qb = _offset_view(qb)
    else:
        kw["b_gate"] = _offset_view(kw["b_gate"])
    *_, va, vb = mm.decode_launch_tile(qa, qb, kw["b_gate"])  # the copy widths
    assert (va, vb) == ((4, 16) if which == "a" else (16, 4))
    got = mm.mx_matmul_fused(qa, qb, **kw)
    ref = mm.mx_matmul_fused_plain(qa, qb, **kw)
    torch.cuda.synchronize()
    _close(got, ref, out_dtype)


@pytest.mark.parametrize("K,N", [(517, 96), (2048, 8192)])
@pytest.mark.parametrize("bk", [128, 256])
@pytest.mark.parametrize("M", [1, 8, 16])
@pytest.mark.parametrize("dtype,out_dtype", [(torch.float32, torch.float32),
                                             (torch.float32, torch.bfloat16),
                                             (torch.bfloat16, torch.bfloat16)])
def test_baseline_decode_tile_matches_plain(cuda, dtype, out_dtype, M, bk, K, N):
    """The baseline on the decode tile: the partial rounded into the output
    dtype after every bk-wide chunk, as baseline_matmul_ref does."""
    a = _randn((M, K), dtype, cuda, 5)
    b = (_randn((K, N), torch.float32, cuda, 6) / K ** 0.5).to(dtype)
    kernels.reset_launch_counts()
    got = baseline_matmul(a, b, bk=bk, out_dtype=out_dtype)
    ref = baseline_matmul_ref(a, b, bk, out_dtype)
    torch.cuda.synchronize()
    assert kernels.decode_launch_counts()["baseline_matmul"] == 1
    assert got.dtype == out_dtype
    _close(got, ref, out_dtype)


# ---------------------------------------------------------------------------
# the tensor-core prefill tile (f32 / bf16 activations, M > 16, csrc/prefill_tile.cuh)
# ---------------------------------------------------------------------------

PREFILL_ROWS = [17, 40, 64, 65, 256, 2048]
PREFILL_DTYPES = {"f32": torch.float32, "bf16": torch.bfloat16}
PREFILL_EPILOGUES = {"none": {}, "residual": dict(residual=True),
                     "swiglu": dict(activation="swiglu", bias=True)}


def _prefill_inputs(M, K, N, dt, ep, dev, seed=0):
    e = mm.Epilogue(**ep)
    a = _randn((M, K), dt, dev, seed)
    b = (_randn((K, N), torch.float32, dev, seed + 1) / K ** 0.5).to(dt)
    kw = dict(epilogue=e,
              b_gate=(_randn((K, N), torch.float32, dev, seed + 2) / K ** 0.5).to(dt)
              if e.has_gate else None,
              bias=_randn((N,), dt, dev, seed + 3) if e.bias else None,
              residual=_randn((M, N), dt, dev, seed + 4) if e.residual else None)
    return a, b, kw


@pytest.mark.parametrize("ep", sorted(PREFILL_EPILOGUES))
@pytest.mark.parametrize("K,N", [(300, 77), (2048, 512), (8192, 200)])  # ragged, parts 1-8
@pytest.mark.parametrize("dt", sorted(PREFILL_DTYPES))
@pytest.mark.parametrize("M", PREFILL_ROWS)
def test_prefill_tile_matches_plain(cuda, M, dt, K, N, ep):
    """The dense kernel on the prefill tile (one launch, counted as such)
    against its plain version, K and N off every tile."""
    dtype = PREFILL_DTYPES[dt]
    a, b, kw = _prefill_inputs(M, K, N, dtype, PREFILL_EPILOGUES[ep], cuda)
    kernels.reset_launch_counts()
    got = mm.mx_matmul_fused(a, b, **kw)
    ref = mm.mx_matmul_fused_plain(a, b, **kw)
    torch.cuda.synchronize()
    assert kernels.prefill_launch_counts()["mx_matmul_fused"] == 1
    assert kernels.launch_counts()["mx_matmul_fused"] == 1
    assert got.dtype == dtype and got.shape == (M, N)
    _close(got, ref, dtype)


@pytest.mark.parametrize("K,N", [(768, 3072), (1536, 1536), (1536, 768), (768, 768)])
@pytest.mark.parametrize("gated", [False, True])
def test_prefill_tile_f32_as_close_to_f64_as_cublas(cuda, K, N, gated):
    """The f32 prefill tile (3xTF32) at xlstm-125m's forward projections
    (M = 2048; gated: swiglu, through both accumulators): its max error to
    the product in f64 within twice the plain version's (cuBLAS f32).
    Accumulated in the MMAs, which truncate, the tile stood 3.5-8.5x as far
    (tools/accumulation_witness.py)."""
    a = _randn((2048, K), torch.float32, cuda, K + N)
    b = _randn((K, N), torch.float32, cuda, K + N + 1) / K ** 0.5
    bg = _randn((K, N), torch.float32, cuda, K + N + 2) / K ** 0.5 if gated else None
    ep = mm.Epilogue(activation="swiglu") if gated else mm.Epilogue()
    got = mm.mx_matmul_fused(a, b, epilogue=ep, b_gate=bg)
    plain = mm.mx_matmul_fused_plain(a, b, epilogue=ep, b_gate=bg)
    exact = torch.matmul(a.double(), b.double())
    if gated:
        exact = torch.nn.functional.silu(torch.matmul(a.double(), bg.double())) * exact
    torch.cuda.synchronize()
    err = (got.double() - exact).abs().max().item()
    ref = (plain.double() - exact).abs().max().item()
    assert err <= 2 * ref, (err, ref)


@pytest.mark.parametrize("B,L,H,Hkv,d", [(8, 512, 32, 32, 80),  # zamba2's shared block
                                         (2, 1088, 48, 8, 128)])  # internvl2's forward
def test_flash_attention_f32_as_close_to_f64_as_plain(cuda, B, L, H, Hkv, d):
    """The f32 attention (3xTF32, each k8 step's products added to S and the
    output tile with rounding FADDs): its max error to the causal softmax
    in f64 within twice the plain version's.  Summed in the truncating
    MMAs it stood 3.3x as far at both shapes
    (tools/accumulation_witness.py --attention-scan)."""
    q = _randn((B, L, H, d), torch.float32, cuda, L + d)
    k = _randn((B, L, Hkv, d), torch.float32, cuda, L + d + 1)
    v = _randn((B, L, Hkv, d), torch.float32, cuda, L + d + 2)
    got = mx_flash_attention(q, k, v, causal=True)
    plain = flash_attention_plain(q, k, v, causal=True)
    heads = torch.arange(H, device=cuda) // (H // Hkv)
    kd, vd = (t.double()[:, :, heads].transpose(1, 2) for t in (k, v))
    s = torch.matmul(q.double().transpose(1, 2), kd.transpose(-1, -2)) / d ** 0.5
    mask = torch.ones((L, L), dtype=torch.bool, device=cuda).tril()
    exact = torch.matmul(torch.softmax(s.masked_fill(~mask, float("-inf")), dim=-1),
                         vd).transpose(1, 2)
    torch.cuda.synchronize()
    err = (got.double() - exact).abs().max().item()
    ref = (plain.double() - exact).abs().max().item()
    assert err <= 2 * ref, (err, ref)


@pytest.mark.parametrize("which", ["a", "b", "b_gate"])
@pytest.mark.parametrize("dt", sorted(PREFILL_DTYPES))
@pytest.mark.parametrize("M", [17, 64, 256])
def test_prefill_tile_takes_a_misaligned_operand(cuda, M, dt, which):
    """One operand a contiguous view at a 4-byte offset: its rows take the
    4-byte copies, in the same kernel."""
    dtype = PREFILL_DTYPES[dt]
    a, b, kw = _prefill_inputs(M, 296, 96, dtype, PREFILL_EPILOGUES["swiglu"], cuda)
    if which == "a":
        a = _offset_view(a)
    elif which == "b":
        b = _offset_view(b)
    else:
        kw["b_gate"] = _offset_view(kw["b_gate"])
    va, vb = mm.prefill_launch_tile(a, b, kw["b_gate"])[5:7]
    assert (va, vb) == ((4, 16) if which == "a" else (16, 4))
    got = mm.mx_matmul_fused(a, b, **kw)
    ref = mm.mx_matmul_fused_plain(a, b, **kw)
    torch.cuda.synchronize()
    _close(got, ref, dtype)


@pytest.mark.parametrize("ep", [dict(), dict(activation="swiglu"),
                                dict(activation="gelu", bias=True, residual=True)])
@pytest.mark.parametrize("pol", ["int8", "fp8"])  # bf16 x int8 / e4m3, widened to bf16
@pytest.mark.parametrize("M", PREFILL_ROWS)
def test_prefill_tile_widened_pairs_match_plain(cuda, M, pol, ep):
    """An int8 or e4m3 weight beside bf16 activations on the prefill tile:
    copied in its own width, widened to bf16 in shared memory, the bf16
    MMAs, the scales at the store; against the plain version in f32."""
    K, N = 2056, 200  # K off the stage, N off the tile
    x, w = _randn((M, K), torch.float32, cuda, 0), _randn((K, N), torch.float32, cuda, 1)
    gated = ep.get("activation") == "swiglu"
    wg = _randn((K, N), torch.float32, cuda, 2) if gated else None
    qa, a_s, qb, b_s, qg, bg_s = _quantized(pol, x, w, wg)
    e = mm.Epilogue(**ep, a_scale=a_s is not None, b_scale=True)
    kw = dict(b_gate=qg, a_scale=a_s, b_scale=b_s, bg_scale=bg_s if gated else None,
              bias=_randn((N,), torch.float32, cuda, 3) if e.bias else None,
              residual=_randn((M, N), torch.float32, cuda, 4) if e.residual else None,
              out_dtype=torch.float32)
    kernels.reset_launch_counts()
    got = mm.mx_matmul_fused(qa, qb, epilogue=e, **kw)
    ref = mm.mx_matmul_fused_plain(qa, qb, epilogue=e, **kw)
    torch.cuda.synchronize()
    assert kernels.prefill_launch_counts()["mx_matmul_fused"] == 1
    _close(got, ref, torch.float32)


BYTE_POLICIES = ["int8_all", "fp8_all"]  # int8 x int8, e4m3 x e4m3: the 8-bit route


def _byte_inputs(pol, M, K, N, ep, dev):
    """Quantized operands of one 8-bit pair with scales and the epilogue's
    operands: (a, b, kw) for mx_matmul_fused."""
    x, w = _randn((M, K), torch.float32, dev, 0), _randn((K, N), torch.float32, dev, 1)
    gated = ep.get("activation") == "swiglu"
    wg = _randn((K, N), torch.float32, dev, 2) if gated else None
    qa, a_s, qb, b_s, qg, bg_s = _quantized(pol, x, w, wg)
    e = mm.Epilogue(**ep, a_scale=True, b_scale=True)
    return qa, qb, dict(epilogue=e, b_gate=qg, a_scale=a_s, b_scale=b_s,
                        bg_scale=bg_s if gated else None,
                        bias=_randn((N,), torch.float32, dev, 3) if e.bias else None,
                        residual=_randn((M, N), torch.float32, dev, 4) if e.residual else None,
                        out_dtype=torch.float32)


@pytest.mark.parametrize("ep", [dict(), dict(residual=True, bias=True),
                                dict(activation="swiglu"),
                                dict(activation="gelu", residual=True)])
@pytest.mark.parametrize("K,N", [(2048, 2048), (301, 77), (2056, 200)])  # ragged off 16 bytes
@pytest.mark.parametrize("pol", BYTE_POLICIES)
@pytest.mark.parametrize("M", PREFILL_ROWS)
def test_prefill_tile_8bit_pairs_match_plain(cuda, M, pol, K, N, ep):
    """int8 x int8 and e4m3 x e4m3 on the prefill tile's 8-bit route (both
    operands in their own byte, B transposed in registers; the s8 MMA, e4m3
    widened to f16): one tensor-core
    launch; int8 bitwise the plain version wherever the epilogue has no
    activation (exact int32 sums, the same f32 roundings after), else and
    for fp8 within 1e-4 * max|ref|."""
    a, b, kw = _byte_inputs(pol, M, K, N, ep, cuda)
    assert mm.fused_route(M, N, K, a.dtype, b.dtype, kw["b_gate"] is not None) == "mma"
    kernels.reset_launch_counts()
    got = mm.mx_matmul_fused(a, b, **kw)
    ref = mm.mx_matmul_fused_plain(a, b, **kw)
    torch.cuda.synchronize()
    assert kernels.prefill_launch_counts()["mx_matmul_fused"] == 1
    _close(got, ref, torch.float32)
    if pol == "int8_all" and "activation" not in ep:
        assert torch.equal(got, ref)


@pytest.mark.parametrize("K", [301, 2048])
@pytest.mark.parametrize("pol", BYTE_POLICIES)
@pytest.mark.parametrize("M", PREFILL_ROWS)
def test_prefill_8bit_abft_bitwise_flags_and_recovery(cuda, M, pol, K):
    """ABFT on the 8-bit prefill tile (gemm_tile's CTA tile, split 1; int8
    checksums exact in wrapping 32-bit sums): on is bitwise off with no flag,
    a fault flags exactly its tile as the plain version's map does, and the
    flagged last row tile recomputed alone is bitwise the clean launch."""
    from repro_torch.kernels import abft as ab

    N = 200
    a, b, kw = _byte_inputs(pol, M, K, N, dict(activation="swiglu"), cuda)
    spec = mm.abft_spec_for(a, b)
    assert mm.fused_route(M, N, K, a.dtype, b.dtype, True, "abft") == "mma"
    off = mm.mx_matmul_fused(a, b, **kw)
    on, flags = mm.mx_matmul_fused(a, b, abft=spec, **kw)
    torch.cuda.synchronize()
    assert torch.equal(on, off) and not flags.any()
    bm, bn, _ = _build.gemm_tile(M)
    gm, gn = flags.shape
    fault = ab.TileFault(gm - 1, gn - 1, 1, 5, 1e8)
    fd, fr, fc = ab.build_fault_operands(fault, gm, gn, bm, bn, device=cuda)
    fkw = dict(abft=spec.with_inject(True), fault_delta=fd, fault_row=fr, fault_col=fc)
    _, kflags = mm.mx_matmul_fused(a, b, **fkw, **kw)
    _, pflags = mm.mx_matmul_fused_plain(a, b, **fkw, **kw)
    assert kflags.sum() == 1 and kflags[gm - 1, gn - 1] == 1
    assert torch.equal(kflags, pflags)
    ab.reset_abft_stats()
    rkw = dict(ep=kw["epilogue"], bias=None, residual=None, w_gate=kw["b_gate"],
               a_s=kw["a_scale"], b_s=kw["b_scale"], bg_s=kw["bg_scale"],
               out_dtype=torch.float32)
    clean = ops._abft_fused_gemm(a, b, cfg=ab.AbftConfig(), **rkw)
    got = ops._abft_fused_gemm(
        a, b, cfg=ab.AbftConfig(fault=ab.TileFault(gm - 1, gn - 1, 0, 7, 1e8)), **rkw)
    torch.cuda.synchronize()
    assert torch.equal(clean, off) and torch.equal(got, clean)
    assert ab.abft_stats()["tiles_recovered"] == 1


@pytest.mark.parametrize("M,K,N,gated", [(64, 8192, 2048, False), (64, 2048, 8192, True)])
def test_prefill_fp8_as_close_to_f64_as_plain(cuda, M, K, N, gated):
    """e4m3 x e4m3 at llama3.2-1b's prefill-chunk down and up+gate widths:
    the kernel (each k32 product from zero, added with rounding FADDs) is no
    more than twice as far from the f64 product of the same payloads and
    scales as the plain version (relative RMS and max): the tensor cores'
    truncating accumulation would not be."""
    a, b, kw = _byte_inputs("fp8_all", M, K, N,
                            dict(activation="swiglu") if gated else {}, cuda)
    kw = dict(kw, epilogue=mm.Epilogue(a_scale=True, b_scale=True), b_gate=None,
              bg_scale=None)
    got = mm.mx_matmul_fused(a, b, **kw)
    ref = mm.mx_matmul_fused_plain(a, b, **kw)
    r64 = (a.double() * kw["a_scale"].double()) @ (b.double() * kw["b_scale"].double())
    torch.cuda.synchronize()

    def dist(y):
        d = y.double() - r64
        return d.abs().max().item(), (d.pow(2).mean() / r64.pow(2).mean()).sqrt().item()

    (kmax, krms), (pmax, prms) = dist(got), dist(ref)
    assert krms <= 2 * prms and kmax <= 2 * pmax, ((kmax, krms), (pmax, prms))


@pytest.mark.parametrize("pol", BYTE_POLICIES)
def test_abft_grouped_8bit_recovery_at_decode_height_is_bitwise(cuda, pol):
    """grok's decode height for the 8-bit pairs (16-row flag tiles over two
    8-row groups, K in 8 parts): every row tile's fault is flagged and
    recovered through `_abft_grouped_gemm` on the tensor-core route, bitwise
    the clean launch; int8 bitwise the plain version."""
    from repro_torch.kernels import abft as ab

    T, K, N, G = 64, 4096, 200, 8
    x = _randn((T, K), torch.float32, cuda, 0)
    w, wg = (_randn((G, K, N), torch.float32, cuda, s) / K ** 0.5 for s in (1, 2))
    qa, a_s, qb, b_s, qg, bg_s = _quantized(pol, x, w, wg)
    sz = torch.full((G,), 8, dtype=torch.int32, device=cuda)
    assert mm.grouped_route(T, N, K, G, qa.dtype, qb.dtype, True, "abft") == "mma"
    assert _build.grouped_flag_tile(T, G, qa.dtype, qb.dtype) == (16, 64)
    ab.reset_abft_stats()
    kw = dict(activation="swiglu", w_gate=qg, a_s=a_s, b_s=b_s, bg_s=bg_s,
              out_dtype=torch.float32)
    clean = ops._abft_grouped_gemm(qa, qb, sz, cfg=ab.AbftConfig(), **kw)
    gkw = dict(w_gate=qg, activation="swiglu", a_scale=a_s, b_scale=b_s, bg_scale=bg_s,
               out_dtype=torch.float32)
    assert torch.equal(clean, mx_grouped_matmul(qa, qb, sz, **gkw))
    if pol == "int8_all":
        bare = dict(gkw, w_gate=None, activation="none", bg_scale=None)
        assert torch.equal(mx_grouped_matmul(qa, qb, sz, **bare),
                           grouped_matmul_ref(qa, qb, sz, **bare))
    for ti in range(T // 16):
        fault = ab.TileFault(ti, 2, 9 if ti % 2 else 3, 7, 1e8)
        got = ops._abft_grouped_gemm(qa, qb, sz, cfg=ab.AbftConfig(fault=fault), **kw)
        torch.cuda.synchronize()
        assert torch.equal(got, clean), ti
    s = ab.abft_stats()
    assert s["tiles_flagged"] == T // 16 and s["tiles_recovered"] == T // 16


@pytest.mark.parametrize("act", ["none", "swiglu"])
@pytest.mark.parametrize("K", [296, 4096])
@pytest.mark.parametrize("pair", ["sparse24 bf16", "sparse24 f32", "sparse24_int8"])
@pytest.mark.parametrize("M", PREFILL_ROWS)
def test_prefill_sparse_bitwise_equals_dense_kernel(cuda, M, pair, K, act):
    """The 2:4 kernel on the prefill tile (the payload expanded in shared
    memory) is bitwise the dense kernel on the expanded weight, on the same
    tile and split."""
    from repro_torch.kernels.sparse import expand_24

    N = 200
    x, w, wg = (_randn(s, torch.float32, cuda, i) for i, s in
                enumerate(((M, K), (K, N), (K, N))))
    xa, pb, bs, mb = _sparse(pair, x, w)
    _, pg, gs, mg = _sparse(pair, x, wg)
    gated = act == "swiglu"
    kw = dict(epilogue=mm.Epilogue(activation=act, residual=True, b_scale=bs is not None),
              b_gate=pg if gated else None, b_scale=bs, bg_scale=gs if gated else None,
              out_dtype=torch.float32, residual=_randn((M, N), torch.float32, cuda, 5))
    kernels.reset_launch_counts()
    got = mm.mx_matmul_fused(xa, pb, b_sparse=True, b_meta=mb, bg_meta=mg if gated else None,
                             **kw)
    dense = mm.mx_matmul_fused(xa, expand_24(pb, mb),
                               **dict(kw, b_gate=expand_24(pg, mg) if gated else None))
    ref = mm.mx_matmul_fused_plain(xa, pb, b_meta=mb, bg_meta=mg if gated else None, **kw)
    torch.cuda.synchronize()
    assert kernels.variant_launch_counts()["mx_matmul_fused sparse"] == 1
    assert kernels.prefill_launch_counts()["mx_matmul_fused"] == 2
    assert torch.equal(got, dense)
    _close(got, ref, torch.float32)


@pytest.mark.parametrize("K", [300, 2048])
@pytest.mark.parametrize("dt", sorted(PREFILL_DTYPES))
@pytest.mark.parametrize("M", PREFILL_ROWS)
def test_prefill_abft_bitwise_flags_and_recovery(cuda, M, dt, K):
    """ABFT on the prefill tile (gemm_tile's CTA tile, split 1, the same K
    parts folded in the same order): on is bitwise off with no flag; a fault
    flags exactly its tile, as the plain version's map does; the flagged
    last row tile recomputed alone is bitwise the clean launch."""
    from repro_torch.kernels import abft as ab

    dtype = PREFILL_DTYPES[dt]
    N = 200
    a, b, kw = _prefill_inputs(M, K, N, dtype, dict(activation="swiglu"), cuda)
    kw["out_dtype"] = torch.float32
    spec = mm.abft_spec_for(a, b)
    off = mm.mx_matmul_fused(a, b, **kw)
    kernels.reset_launch_counts()
    on, flags = mm.mx_matmul_fused(a, b, abft=spec, **kw)
    torch.cuda.synchronize()
    assert kernels.prefill_launch_counts()["mx_matmul_fused"] == 1
    assert torch.equal(on, off) and not flags.any()
    bm, bn, _ = _build.gemm_tile(M)
    gm, gn = flags.shape
    assert (gm, gn) == (-(-M // bm), -(-N // bn))
    fault = ab.TileFault(gm - 1, gn - 1, 1, 5, 1e8)
    fd, fr, fc = ab.build_fault_operands(fault, gm, gn, bm, bn, device=cuda)
    fkw = dict(abft=spec.with_inject(True), fault_delta=fd, fault_row=fr, fault_col=fc)
    _, kflags = mm.mx_matmul_fused(a, b, **fkw, **kw)
    _, pflags = mm.mx_matmul_fused_plain(a, b, **fkw, **kw)
    assert kflags.sum() == 1 and kflags[gm - 1, gn - 1] == 1
    assert torch.equal(kflags, pflags)
    ab.reset_abft_stats()
    with ops.use_policy(ops.MXPolicy("cuda_mx")):
        clean = ops.linear(a, b, activation="swiglu", w_gate=kw["b_gate"],
                           out_dtype=torch.float32)
        kernels.reset_launch_counts()
        # the last row tile (8 rows at M = 40, 1 at M = 65) is recomputed on
        # the launch's own tensor-core route, not on its few rows' route
        got = ops.linear(a, b, activation="swiglu", w_gate=kw["b_gate"],
                         out_dtype=torch.float32,
                         abft=ab.AbftConfig(fault=ab.TileFault(gm - 1, gn - 1, 0, 7, 1e8)))
    torch.cuda.synchronize()
    assert torch.equal(got, clean)
    assert ab.abft_stats()["tiles_recovered"] == 1
    assert kernels.prefill_launch_counts()["mx_matmul_fused"] == 2


@pytest.mark.parametrize("bk", [128, 256])
@pytest.mark.parametrize("K,N", [(517, 96), (2048, 2048)])
@pytest.mark.parametrize("dtype,out_dtype", [(torch.float32, torch.float32),
                                             (torch.float32, torch.bfloat16),
                                             (torch.bfloat16, torch.bfloat16)])
@pytest.mark.parametrize("M", PREFILL_ROWS)
def test_baseline_prefill_tile_matches_plain(cuda, M, dtype, out_dtype, K, N, bk):
    """The baseline on the prefill tile: each bk-wide chunk's partial from
    the MMAs, rounded into the output dtype, as baseline_matmul_ref does."""
    a = _randn((M, K), dtype, cuda, 5)
    b = (_randn((K, N), torch.float32, cuda, 6) / K ** 0.5).to(dtype)
    kernels.reset_launch_counts()
    got = baseline_matmul(a, b, bk=bk, out_dtype=out_dtype)
    ref = baseline_matmul_ref(a, b, bk, out_dtype)
    torch.cuda.synchronize()
    assert kernels.prefill_launch_counts()["baseline_matmul"] == 1
    assert got.dtype == out_dtype
    _close(got, ref, out_dtype)


def test_kernels_refuse_an_operand_pair_they_are_not_built_for(cuda):
    a = torch.zeros(4, 8, device=cuda)
    b = torch.zeros(8, 6, dtype=torch.int8, device=cuda)
    with pytest.raises(TypeError, match="operand pair"):
        mm.mx_matmul_fused(a, b)
    with pytest.raises(TypeError, match="operand pair"):
        mx_grouped_matmul(a, b[None], torch.tensor([4], dtype=torch.int32, device=cuda))


@pytest.mark.parametrize("act", ["none", "swiglu", "gelu"])
@pytest.mark.parametrize("case", ["ragged_tail", "decode_8", "straddle"])
@pytest.mark.parametrize("pol", QUANTIZED)
def test_quantized_grouped_kernel_matches_plain(cuda, pol, case, act):
    """Per-row and per-expert scales; a straddling tile applies each
    group's own scales to its rows; tail rows stay exact zeros."""
    sizes = GROUPED_SIZES[case]
    T, K, N, G = 70, 300, 77, len(sizes)
    x = _randn((T, K), torch.float32, cuda, 0)
    w = _randn((G, K, N), torch.float32, cuda, 1) / K ** 0.5
    w = w * torch.linspace(0.1, 10.0, G, device=cuda)[:, None, None]  # experts' ranges
    wg = _randn((G, K, N), torch.float32, cuda, 2) / K ** 0.5 if act == "swiglu" else None
    qa, a_s, qb, b_s, qg, bg_s = _quantized(pol, x, w, wg)
    gs = torch.tensor(sizes, dtype=torch.int32, device=cuda)
    kw = dict(w_gate=qg, activation=act, a_scale=a_s, b_scale=b_s,
              bg_scale=bg_s if act == "swiglu" and b_s is not None else None,
              out_dtype=torch.float32)
    got = mx_grouped_matmul(qa, qb, gs, **kw)
    ref = grouped_matmul_ref(qa, qb, gs, **kw)
    torch.cuda.synchronize()
    _close(got, ref, torch.float32)
    assert torch.all(got[min(sum(sizes), T):] == 0)
    if pol == "int8_all" and act == "none":
        assert torch.equal(got, ref)


# group heights at the MMA's edges (1, 15, 16, 17 and 129 rows), a 16-row
# tile straddling five groups, empty first and last groups; T and G put each
# case in one regime of _build.grouped_tile (mean rows per group <= 8: 16-row
# tiles; <= 64: 32; more: 64)
GROUPED_EDGES = {
    "edges_decode": (190, [0, 1, 15, 16, 17, 129] + [0] * 18 + [2, 0]),  # mean 7
    "edges_mid": (190, [0, 1, 15, 16, 17, 129, 2, 0]),                     # mean 23
    "edges_prefill": (600, [0, 1, 15, 16, 17, 129, 400, 0]),               # mean 75
    "straddle5": (48, [3, 2, 4, 1, 5, 6, 9, 8, 0]),                         # rows 0-15: 6 groups
    "empty_ends": (48, [0, 8, 8, 8, 8, 8, 8, 0]),
}


@pytest.mark.parametrize("act", ["none", "swiglu"])
@pytest.mark.parametrize("pol", ["f32", "bf16", "int8", "fp8", "int8_all", "fp8_all"])
@pytest.mark.parametrize("case", sorted(GROUPED_EDGES))
def test_grouped_kernel_at_mma_edges(cuda, case, pol, act):
    """The tensor-core route at group heights around the MMA's 16 rows:
    within tolerance of the plain version, tail rows exact zeros, and every
    group's rows bitwise the fused GEMM's tensor-core tile on that group's
    rows and expert (`recompute_fused` on "mma", the ABFT recovery's
    loop): an output element's bits depend on K and the pair only."""
    T, sizes = GROUPED_EDGES[case]
    K, N, G = 1100, 72, len(sizes)  # K: 2 parts of 550 rows in f32, 1 in bf16 (18 steps)
    x = _randn((T, K), torch.float32, cuda, 0)
    w = _randn((G, K, N), torch.float32, cuda, 1) / K ** 0.5
    wg = _randn((G, K, N), torch.float32, cuda, 2) / K ** 0.5 if act == "swiglu" else None
    if pol == "f32":
        qa, a_s, qb, b_s, qg, bg_s = x, None, w, None, wg, None
    else:
        qa, a_s, qb, b_s, qg, bg_s = _quantized(pol, x, w, wg)
    gated = act == "swiglu"
    sz = torch.tensor(sizes, dtype=torch.int32, device=cuda)
    out_dtype = torch.float32
    kw = dict(w_gate=qg, activation=act, a_scale=a_s, b_scale=b_s,
              bg_scale=bg_s if gated and b_s is not None else None, out_dtype=out_dtype)
    assert mm.grouped_route(T, N, K, G, qa.dtype, qb.dtype, gated) == "mma"
    got = mx_grouped_matmul(qa, qb, sz, **kw)
    ref = grouped_matmul_ref(qa, qb, sz, **kw)
    torch.cuda.synchronize()
    _close(got, ref, torch.float32 if pol in ("f32", "int8_all", "fp8_all") else torch.bfloat16)
    assert torch.all(got[min(sum(sizes), T):] == 0)
    if pol == "int8_all" and act == "none":  # exact int32 sums
        assert torch.equal(got, ref)
    ep = mm.Epilogue(activation=act, a_scale=a_s is not None, b_scale=b_s is not None)
    start = 0
    for g, n in enumerate(sizes):
        s, e = start, min(start + n, T)
        start = e
        if e <= s:
            continue
        xs, ws = qa[s:e], qb[g]
        one, _ = mm.recompute_fused(
            "mma", xs, ws, epilogue=ep, b_gate=None if qg is None else qg[g],
            a_scale=None if a_s is None else a_s[s:e],
            b_scale=None if b_s is None else b_s[g],
            bg_scale=None if bg_s is None or not gated else bg_s[g], out_dtype=out_dtype,
            abft=mm.abft_spec_for(xs, ws))
        assert torch.equal(one, got[s:e]), (g, s, e)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_abft_grouped_recovery_at_decode_height_is_bitwise(cuda, dtype):
    """grok's decode height (8 experts x 8 rows: 16-row tiles over two
    groups) with K in 8 parts: a fault in each row tile is flagged and
    recovered through `_abft_grouped_gemm` on the tensor-core route, bitwise
    the clean launch."""
    from repro_torch.kernels import abft as ab

    T, K, N, G = 64, 4096, 200, 8
    x = _randn((T, K), dtype, cuda, 0)
    w = (_randn((G, K, N), torch.float32, cuda, 1) / K ** 0.5).to(dtype)
    wg = (_randn((G, K, N), torch.float32, cuda, 2) / K ** 0.5).to(dtype)
    sz = torch.full((G,), 8, dtype=torch.int32, device=cuda)
    assert mm.grouped_route(T, N, K, G, dtype, dtype, True, "abft") == "mma"
    assert _build.grouped_flag_tile(T, G, dtype, dtype) == (16, 64)
    ab.reset_abft_stats()
    kw = dict(activation="swiglu", w_gate=wg, a_s=None, b_s=None, bg_s=None,
              out_dtype=dtype)
    clean = ops._abft_grouped_gemm(x, w, sz, cfg=ab.AbftConfig(), **kw)
    assert torch.equal(clean, mx_grouped_matmul(x, w, sz, w_gate=wg, activation="swiglu"))
    for ti in range(T // 16):
        fault = ab.TileFault(ti, 2, 9 if ti % 2 else 3, 7, 1e8)
        got = ops._abft_grouped_gemm(x, w, sz, cfg=ab.AbftConfig(fault=fault), **kw)
        torch.cuda.synchronize()
        assert torch.equal(got, clean), ti
    s = ab.abft_stats()
    assert s["tiles_flagged"] == T // 16 and s["tiles_recovered"] == T // 16


@pytest.mark.parametrize("pol", ["f32", "bf16", "int8", "fp8", "int8_all", "fp8_all"])
def test_grouped_route_launches_its_loop(cuda, monkeypatch, pol):
    """grouped_route is "mma" for every pair (int8 x int8 and e4m3 x e4m3
    in their own byte), and each launch enters the "mma" C entry (the dense
    and ABFT variants alike)."""
    from repro_torch.kernels.mx_grouped_matmul import abft_spec_for

    T, K, N, G = 64, 256, 128, 8
    x = _randn((T, K), torch.float32, cuda, 0)
    w = _randn((G, K, N), torch.float32, cuda, 1) / K ** 0.5
    qa, a_s, qb, b_s, _, _ = (x, None, w, None, None, None) if pol == "f32" \
        else _quantized(pol, x, w)
    want = "mma"
    assert (qa.dtype, qb.dtype) in _build.MMA_PAIRS
    assert mm.grouped_route(T, N, K, G, qa.dtype, qb.dtype) == want
    symbols = []
    real = _build.function

    def spy(source, symbol, argtypes, *a, **k):
        symbols.append(symbol)
        return real(source, symbol, argtypes, *a, **k)

    monkeypatch.setattr(_build, "function", spy)
    sz = torch.full((G,), 8, dtype=torch.int32, device=cuda)
    kw = dict(a_scale=a_s, b_scale=b_s, out_dtype=torch.float32)
    mx_grouped_matmul(qa, qb, sz, **kw)
    mx_grouped_matmul(qa, qb, sz, abft=abft_spec_for(qa, qb), **kw)
    torch.cuda.synchronize()
    assert symbols == [f"mx_grouped_matmul{v}{'_mma' if want == 'mma' else ''}_launch"
                       for v in ("", "_abft")]


def _fp8(kp, vp):
    (qk, ks), (qv, vs) = (quantize(t, QuantSpec("fp8_e4m3"), axis=-1) for t in (kp, vp))
    return qk, qv, ks[..., 0].contiguous(), vs[..., 0].contiguous()


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("S", [None, 1, 5])
def test_flash_fp8_pages_match_plain(cuda, dtype, S):
    """fp8 pages with their scale pages, stale rows poisoned: decode, and
    verify at S = 5 and at S = 1, where it must equal decode bitwise."""
    lengths = (6, 17, 0, 160, 33, 64, 250, 9)
    q, kp, vp, table, lns = _pages(8, 32, 8, 64, 16, 16, lengths, torch.float32, cuda,
                                   poison=True, S=S)
    kp, vp, ks, vs = _fp8(kp, vp)
    kw = dict(k_scale=ks, v_scale=vs)
    q = q.to(dtype)
    if S is None:
        got = mx_flash_decode(q, kp, vp, table, lns, **kw)
        want = paged_decode_ref(q, kp, vp, table, lns, **kw)
    else:
        got = mx_flash_verify(q, kp, vp, table, lns, **kw)
        want = paged_verify_ref(q, kp, vp, table, lns, **kw)
    torch.cuda.synchronize()
    assert torch.isfinite(got).all()
    _close(got, want, dtype)
    if S == 1:
        assert torch.equal(got[:, 0], mx_flash_decode(q[:, 0].contiguous(), kp, vp, table,
                                                      lns, **kw))
    with pytest.raises(ValueError, match="need k_scale"):
        mx_flash_decode(q if S is None else q[:, 0].contiguous(), kp, vp, table, lns)


def test_quantized_linear_runs_the_kernel_or_raises_on_the_card(cuda):
    """On a CUDA tensor a quantized linear launches the kernel (cuda_mx) or
    raises (cuda_baseline has no scale slots); it never runs the plain
    version.  The kept weight payload is the fresh one."""
    x = _randn((8, 256), torch.float32, cuda, 0)
    w = _randn((256, 96), torch.float32, cuda, 1)
    kernels.reset_launch_counts()
    with ops.use_policy(ops.MXPolicy("cuda_mx")):
        got = ops.linear(x, w, precision="int8")
        again = ops.linear(x, w, precision="int8")
    torch.cuda.synchronize()
    assert kernels.launch_counts()["mx_matmul_fused"] == 2 and torch.equal(got, again)
    with ops.use_policy(ops.MXPolicy("torch")):
        _close(got, ops.linear(x, w, precision="int8"), torch.float32)
    q, s, meta = ops._weight_operand(w, QuantSpec("int8"))
    fq, fs = quantize_operand(w, QuantSpec("int8"), "b")
    assert torch.equal(q, fq) and torch.equal(s, fs) and meta is None
    with ops.use_policy(ops.MXPolicy("cuda_baseline")):
        with pytest.raises(NotImplementedError, match="scale slots"):
            ops.linear(x, w, precision="int8")
        with use_precision("int8_all"), pytest.raises(NotImplementedError):
            ops.linear(x, w)
        assert ops.linear(x, w).shape == (8, 96)  # no precision: the baseline GEMM


QUANT_SERVING = [("llama3.2-1b-smoke", "int8", None),
                 ("llama3.2-1b-smoke", "int8_all", None),
                 ("llama3.2-1b-smoke", "fp8", "fp8_e4m3"),
                 ("llama3.2-1b-smoke", "none", "fp8_e4m3"),
                 ("grok-1-314b-smoke", "int8", None),
                 ("kimi-k2-1t-a32b-smoke", "int8_all", None)]


@pytest.mark.parametrize("name,precision,kv", QUANT_SERVING)
def test_quantized_streams_equal_across_backends(cuda, name, precision, kv):
    """Quantized serving at smoke size: the kernel path's streams equal the
    plain path's, every kernel of the path launched (2 grouped launches
    per MoE layer per step or chunk), none on the plain path."""
    import dataclasses

    cfg = dataclasses.replace(get_config(name), precision=precision)
    model = build_model(cfg)
    params = model.init(0, device=cuda)
    rng = np.random.default_rng(3)
    prompts = [rng.integers(0, cfg.vocab, n).astype(np.int32) for n in (6, 9, 13, 7)]
    out = {}
    for backend in ("cuda_mx", "torch"):
        with ops.use_policy(ops.MXPolicy(backend)):
            kernels.reset_launch_counts()
            b = ContinuousBatcher(model, params, batch_slots=3, max_len=24, page_size=4,
                                  prefill_chunk=4, kv_quant=QuantSpec(kv) if kv else None)
            for i, p in enumerate(prompts):
                b.submit(Request(rid=i, prompt=p, max_new=8))
            fin = b.run_to_completion()
            steps = sum(h.active > 0 for h in b.health) + b.prefill_launches
            out[backend] = ({r: fin[r].output for r in fin}, kernels.launch_counts(), steps)
    assert out["cuda_mx"][0] == out["torch"][0]
    got = out["cuda_mx"][1]
    assert got["mx_matmul_fused"] > 0 and got["mx_flash_decode"] > 0
    if cfg.n_experts:
        assert got["mx_grouped_matmul"] == 2 * cfg.n_layers * out["cuda_mx"][2]
    assert out["torch"][1] == {k: 0 for k in got}


# ---------------------------------------------------------------------------
# stages 1c / 5c (2:4 sparse weights) and 1d / 5d (ABFT)
# ---------------------------------------------------------------------------

SPARSE_PAIRS = {"sparse24 f32": (torch.float32, QuantSpec("f32")),
                "sparse24 bf16": (torch.bfloat16, QuantSpec("bf16")),
                "sparse24_int8": (torch.bfloat16, QuantSpec("int8"))}


def _sparse(pair, x, w):
    adt, spec = SPARSE_PAIRS[pair]
    payload, scale, meta = ops._sparse_operand(w, spec)
    return x.to(adt).contiguous(), payload, scale, meta


@pytest.mark.parametrize("M", [1, 8, 40, 100])  # all three tiles
@pytest.mark.parametrize("act", ["none", "swiglu"])
@pytest.mark.parametrize("pair", sorted(SPARSE_PAIRS))
def test_sparse_kernel_bitwise_equals_dense_kernel_on_expanded_weight(cuda, pair, act, M):
    from repro_torch.kernels.sparse import expand_24

    K, N = 296, 77  # K % 8 == 0, off every BK; N ragged
    x, w, wg = (_randn(s, torch.float32, cuda, i) for i, s in
                enumerate(((M, K), (K, N), (K, N))))
    xa, pb, bs, mb = _sparse(pair, x, w)
    _, pg, gs, mg = _sparse(pair, x, wg)
    gated = act == "swiglu"
    e = mm.Epilogue(activation=act, b_scale=bs is not None, residual=True)
    kw = dict(epilogue=e, b_gate=pg if gated else None, b_scale=bs,
              bg_scale=gs if gated else None, out_dtype=torch.float32,
              residual=_randn((M, N), torch.float32, cuda, 5))
    kernels.reset_launch_counts()
    got = mm.mx_matmul_fused(xa, pb, b_sparse=True, b_meta=mb,
                             bg_meta=mg if gated else None, **kw)
    dense = mm.mx_matmul_fused(xa, expand_24(pb, mb),
                               **dict(kw, b_gate=expand_24(pg, mg) if gated else None))
    ref = mm.mx_matmul_fused_plain(xa, pb, b_meta=mb, bg_meta=mg if gated else None, **kw)
    torch.cuda.synchronize()
    assert kernels.variant_launch_counts()["mx_matmul_fused sparse"] == 1
    assert torch.equal(got, dense)
    _close(got, ref, torch.float32)


@pytest.mark.parametrize("act", ["none", "swiglu"])
@pytest.mark.parametrize("case", ["ragged_tail", "decode_8", "straddle"])
@pytest.mark.parametrize("pair", sorted(SPARSE_PAIRS))
def test_sparse_grouped_kernel_bitwise_equals_dense_on_expanded(cuda, pair, case, act):
    from repro_torch.kernels.sparse import expand_24

    sizes = GROUPED_SIZES[case]
    T, K, N, G = 70, 296, 77, len(sizes)
    x = _randn((T, K), torch.float32, cuda, 0)
    w, wg = (_randn((G, K, N), torch.float32, cuda, s) / K ** 0.5 for s in (1, 2))
    xa, pb, bs, mb = _sparse(pair, x, w)
    _, pg, gs, mg = _sparse(pair, x, wg)
    gated = act == "swiglu"
    sz = torch.tensor(sizes, dtype=torch.int32, device=cuda)
    kw = dict(activation=act, b_scale=bs, bg_scale=gs if gated else None,
              out_dtype=torch.float32)
    got = mx_grouped_matmul(xa, pb, sz, w_gate=pg if gated else None, b_sparse=True,
                            w_meta=mb, wg_meta=mg if gated else None, **kw)
    dense = mx_grouped_matmul(xa, expand_24(pb, mb), sz,
                              w_gate=expand_24(pg, mg) if gated else None, **kw)
    ref = grouped_matmul_ref(xa, pb, sz, w_gate=pg if gated else None, w_meta=mb,
                             wg_meta=mg if gated else None, **kw)
    torch.cuda.synchronize()
    assert torch.equal(got, dense)
    _close(got, ref, torch.float32)


ABFT_PAIRS = ["f32", "bf16", "int8", "int8_all", "fp8", "fp8_all"]


@pytest.mark.parametrize("M", [8, 40, 100])
@pytest.mark.parametrize("pol", ABFT_PAIRS)
def test_abft_kernel_bitwise_and_flag_maps_equal_plain(cuda, pol, M):
    """ABFT on is bitwise ABFT off with no flag; a fault flags exactly its
    tile, and the flag map equals the plain version's (the same tiles)."""
    from repro_torch.kernels import abft as ab

    K, N = 300, 200
    x, w, wg = (_randn(s, torch.float32, cuda, i) for i, s in
                enumerate(((M, K), (K, N), (K, N))))
    qa, a_s, qb, b_s, qg, bg_s = _quantized(pol, x, w, wg)
    e = mm.Epilogue(activation="swiglu", a_scale=a_s is not None, b_scale=b_s is not None)
    kw = dict(epilogue=e, b_gate=qg, a_scale=a_s, b_scale=b_s, bg_scale=bg_s,
              out_dtype=torch.float32)
    spec = mm.abft_spec_for(qa, qb)
    off = mm.mx_matmul_fused(qa, qb, **kw)
    kernels.reset_launch_counts()
    on, flags = mm.mx_matmul_fused(qa, qb, abft=spec, **kw)
    assert kernels.variant_launch_counts()["mx_matmul_fused abft"] == 1
    assert torch.equal(on, off) and not flags.any()
    bm, bn, _ = _build.gemm_tile(M)
    gm, gn = flags.shape
    assert (gm, gn) == (-(-M // bm), -(-N // bn))
    fault = ab.TileFault(gm - 1, gn - 1, 3, 5, 1.0 if spec.exact else 1e8)
    fd, fr, fc = ab.build_fault_operands(fault, gm, gn, bm, bn, device=cuda)
    fkw = dict(abft=spec.with_inject(True), fault_delta=fd, fault_row=fr, fault_col=fc)
    _, kflags = mm.mx_matmul_fused(qa, qb, **fkw, **kw)
    _, pflags = mm.mx_matmul_fused_plain(qa, qb, **fkw, **kw)
    assert kflags.sum() == 1 and kflags[gm - 1, gn - 1] == 1
    assert torch.equal(kflags, pflags)


@pytest.mark.parametrize("case", ["ragged_tail", "decode_8", "straddle"])
@pytest.mark.parametrize("pol", ABFT_PAIRS)
def test_abft_grouped_kernel_flag_maps_equal_plain(cuda, pol, case):
    from repro_torch.kernels import abft as ab
    from repro_torch.kernels.mx_grouped_matmul import abft_spec_for

    sizes = GROUPED_SIZES[case]
    T, K, N, G = 70, 300, 200, len(sizes)
    x = _randn((T, K), torch.float32, cuda, 0)
    w, wg = (_randn((G, K, N), torch.float32, cuda, s) / K ** 0.5 for s in (1, 2))
    qa, a_s, qb, b_s, qg, bg_s = _quantized(pol, x, w, wg)
    sz = torch.tensor(sizes, dtype=torch.int32, device=cuda)
    kw = dict(w_gate=qg, activation="swiglu", a_scale=a_s, b_scale=b_s, bg_scale=bg_s,
              out_dtype=torch.float32)
    spec = abft_spec_for(qa, qb)
    off = mx_grouped_matmul(qa, qb, sz, **kw)
    on, flags = mx_grouped_matmul(qa, qb, sz, abft=spec, **kw)
    assert torch.equal(on, off) and not flags.any()
    bm, bn = _build.grouped_flag_tile(T, G, qa.dtype, qb.dtype)
    gm, gn = flags.shape
    assert (gm, gn) == (-(-T // bm), -(-N // bn))
    for ti in range(gm):  # every row tile: straddled, single-group, uncovered
        fault = ab.TileFault(ti, 1, 1, 5, 1.0 if spec.exact else 1e8)
        fd, fr, fc = ab.build_fault_operands(fault, gm, gn, bm, bn, device=cuda)
        fkw = dict(abft=spec.with_inject(True), fault_delta=fd, fault_row=fr, fault_col=fc)
        _, kflags = mx_grouped_matmul(qa, qb, sz, **fkw, **kw)
        _, pflags = grouped_matmul_ref(qa, qb, sz, **fkw, **kw)
        assert torch.equal(kflags, pflags.to(kflags.device)), ti
        assert kflags.sum() <= 1


def test_one_tile_rule_the_kernels_take_the_python_table_and_nothing_else(cuda):
    """The tile of every launch comes from _build: prefill_tile for every
    pair's rows at M > 16 (the tensor-core loop, every variant); decode_tile
    for the decode rows (M <= 16) of every variant (the ABFT one's bn whole
    16-column flag tiles); gemm_tile for every ABFT flag map; grouped_tile
    for the grouped GEMM, every pair.  Each launcher takes its table's
    tiles and refuses any other."""
    from repro_torch.kernels.mx_matmul import _LAUNCHERS

    x = _randn((100, 64), torch.float32, cuda, 0)
    w = _randn((64, 48), torch.float32, cuda, 1)
    out = torch.empty((100, 48), device=cuda)
    flags = torch.zeros(64, dtype=torch.int32, device=cuda)
    afn = _build.function(*_LAUNCHERS["abft"])
    dfn = _build.function(*_LAUNCHERS["decode"])
    pfn = _build.function(*_LAUNCHERS["dense prefill"])

    def launch(M, tile, f=None, a=x, K=64):
        abft = f is None  # the ABFT launcher: its decode tile
        return (afn if abft else f)(
            a.data_ptr(), w.data_ptr(), None, None, None, None, None, 0, None, 0,
            out.data_ptr(), 0, M, 48, K, 0, 0, 0, 0, 0.0, *tile,
            *((flags.data_ptr(), None, None, None, 1e-3, 1e-3) if abft else ()),
            _build.stream_ptr(x))

    for M in (1, 8, 13, 16):  # the ABFT decode tile: whole flag tiles per CTA
        t = _build.decode_tile(M, 48, torch.float32, torch.float32, variant="abft")
        assert t.bn % 16 == 0
        assert launch(M, (t.bn, t.bk, t.tm, t.stages, t.threads, 16, 16)) == 0
    t = _build.decode_tile(8, 48, torch.float32, torch.float32, variant="abft")
    agood = (t.bn, t.bk, t.tm, t.stages, t.threads, 16, 16)
    assert launch(17, agood) != 0 and launch(100, agood) != 0  # the prefill tile's rows
    assert launch(8, (8,) + agood[1:]) != 0  # half a flag tile per CTA
    assert launch(8, agood[:4] + (272,) + agood[5:]) != 0  # threads off whole warps
    for M in (17, 64, 65, 100):  # the prefill tile's
        t = _build.prefill_tile(M, 48, 64, torch.float32, torch.float32)
        assert launch(M, (t.bm, t.bn, t.stages, t.split, t.parts, 16, 16, 16), pfn) == 0
    t = _build.prefill_tile(100, 48, 64, torch.float32, torch.float32)
    good = (t.bm, t.bn, t.stages, t.split, t.parts, 16, 16, 16)
    for bad in ((32, 32), (128, 128), (16, 16)):  # CTA tiles it does not build
        assert launch(100, bad + good[2:], pfn) != 0
    for i, v in ((2, 1), (2, 9), (3, 3), (4, 3), (4, 16), (5, 3)):  # stages, split, parts, va
        tile = list(good)
        tile[i] = v
        assert launch(100, tuple(tile), pfn) != 0, (i, v)
    assert launch(100, good[:4] + (4,) + good[5:], pfn, K=96) != 0  # 4 parts of 3 steps
    for M in (1, 8, 13, 16):
        t = _build.decode_tile(M, 48, torch.float32, torch.float32)
        assert launch(M, (t.bn, t.bk, t.tm, t.stages, t.threads, t.vec, t.vec), dfn) == 0
    t = _build.decode_tile(8, 48, torch.float32, torch.float32)
    for bad_m, bad in ((8, dict(tm=3)), (1, dict(tm=2)), (8, dict(stages=9)),
                       (8, dict(bk=96)), (8, dict(bn=2)), (8, dict(threads=1024)),
                       (8, dict(threads=8)), (17, {})):
        tile = t._replace(**bad)
        assert launch(bad_m, (tile.bn, tile.bk, tile.tm, tile.stages, tile.threads, 16, 16),
                      dfn) != 0
    shifted = _offset_view(x[:8].contiguous())  # 16-byte copies need an aligned A
    tile = (t.bn, t.bk, t.tm, t.stages, t.threads)
    assert launch(8, (*tile, 16, 16), dfn, shifted) != 0
    assert launch(8, (*tile, 4, 16), dfn, shifted) == 0
    # the grouped GEMM: "mma" launches take grouped_tile's tile and refuse a
    # CTA tile, ring, split or parts outside the table, for every pair
    xg, wg_ = _randn((520, 64), torch.float32, cuda, 3), _randn((8, 64, 48), torch.float32,
                                                                cuda, 2)
    gout = torch.empty((520, 48), device=cuda)
    sz = torch.full((8,), 8, dtype=torch.int32, device=cuda)
    qdt = _build.FLOATS + _build.QUANTIZED
    from repro_torch.kernels.mx_grouped_matmul import _LAUNCHERS as GL

    def glaunch(tile, route="mma", variant="dense", T=64, a=xg, b=wg_):
        f = _build.function(*GL[variant, route])
        args = [a.data_ptr(), b.data_ptr(), None, None, None, None, sz.data_ptr(),
                gout.data_ptr(), 0, T, 48, 64, 8, _build.dtype_code(a.dtype, "x", qdt),
                _build.dtype_code(b.dtype, "w", qdt), 0, *tile]
        if variant == "abft":
            flags = torch.zeros(64, dtype=torch.int32, device=cuda)
            args += [flags.data_ptr(), None, None, None, 1e-3, 1e-3]
        return f(*args, _build.stream_ptr(x))

    assert {_build.grouped_tile(T, 48, 64, 8, torch.float32, torch.float32).bm
            for T in (64, 70, 512, 1024)} == {16, 32, 64}
    for T in (64, 72, 520):
        t = _build.grouped_tile(T, 48, 64, 8, torch.float32, torch.float32)
        good = (t.bm, t.bn, t.stages, t.split, t.parts, 16, 16, 16)
        assert glaunch(good, T=T) == 0
    t = _build.grouped_tile(64, 48, 64, 8, torch.float32, torch.float32)
    good = (t.bm, t.bn, t.stages, t.split, t.parts, 16, 16, 16)
    for bad in ((32, 128), (8, 128), (128, 64), (16, 32), (16, 64)):  # tiles it does not build
        assert glaunch(bad + good[2:]) != 0, bad
    for i, v in ((2, 1), (2, 9), (3, 3), (4, 3), (5, 3)):  # stages, split, parts, va
        tile = list(good)
        tile[i] = v
        assert glaunch(tuple(tile)) != 0, (i, v)
    ta = _build.grouped_tile(64, 48, 64, 8, torch.float32, torch.float32, variant="abft")
    agood = (ta.bm, ta.bn, ta.stages, ta.split, ta.parts, 16, 16, 16)
    assert (ta.bm, ta.bn) == _build.grouped_flag_tile(64, 8, torch.float32, torch.float32)
    assert glaunch(agood, variant="abft") == 0
    assert glaunch((16, 128) + agood[2:], variant="abft") != 0  # not a flag map's tile
    for dt in (torch.int8, torch.float8_e4m3fn):  # the 8-bit pairs: the same table
        q = torch.zeros((64, 64), dtype=dt, device=cuda)
        qw = torch.zeros((8, 64, 48), dtype=dt, device=cuda)
        t8 = _build.grouped_tile(64, 48, 64, 8, dt, dt)
        good8 = (t8.bm, t8.bn, t8.stages, t8.split, t8.parts, 16, 16, 16)
        assert glaunch(good8, a=q, b=qw) == 0
        for bad in ((8, 128), (16, 32)):
            assert glaunch(bad + good8[2:], a=q, b=qw) != 0
        t8 = _build.grouped_tile(64, 48, 64, 8, dt, dt, variant="abft")
        assert glaunch((t8.bm, t8.bn, t8.stages, t8.split, t8.parts, 16, 16, 16), a=q, b=qw,
                       variant="abft") == 0
    for M in (5, 40, 100):
        _, flags = mm.mx_matmul_fused(x[:M], w, abft=mm.abft_spec_for(x[:M], w))
        bm, bn, _ = _build.gemm_tile(M)
        assert tuple(flags.shape) == (-(-M // bm), -(-48 // bn))
    torch.cuda.synchronize()


@pytest.mark.parametrize("grouped", [False, True])
def test_abft_recovery_is_bitwise_on_the_card(cuda, grouped):
    """A flagged tile recomputed alone (the fused kernel on slices, per
    overlapping expert for the grouped GEMM) is bitwise the fault-free
    launch: every output element is one MAC chain over K in any tile."""
    from repro_torch.kernels import abft as ab

    x = _randn((100, 512), torch.float32, cuda, 0)
    ab.reset_abft_stats()
    with ops.use_policy(ops.MXPolicy("cuda_mx")):
        if grouped:
            w = _randn((3, 512, 200), torch.float32, cuda, 1) / 512 ** 0.5
            sz = torch.tensor([30, 0, 60], dtype=torch.int32, device=cuda)
            clean = ops.grouped_matmul(x, w, sz)
            got = ops.grouped_matmul(x, w, sz, abft=ab.AbftConfig(
                fault=ab.TileFault(0, 2, 5, 7, 1e8)))
        else:
            w = _randn((512, 200), torch.float32, cuda, 1)
            clean = ops.linear(x, w, activation="gelu")
            got = ops.linear(x, w, activation="gelu", abft=ab.AbftConfig(
                fault=ab.TileFault(1, 2, 5, 7, 1e8)))
    torch.cuda.synchronize()
    assert torch.equal(got, clean)
    s = ab.abft_stats()
    assert s["tiles_flagged"] == 1 and s["tiles_recovered"] == 1


def test_sparse_and_abft_dispatch_launch_their_kernels_or_raise(cuda):
    """No fallback: on CUDA tensors a sparse policy launches the 2:4 kernel
    and abft= the ABFT kernel (the sparse weight expanded first); the
    baseline backend raises on a sparse policy."""
    x = _randn((8, 256), torch.float32, cuda, 0)
    w = _randn((256, 96), torch.float32, cuda, 1)
    kernels.reset_launch_counts()
    with ops.use_policy(ops.MXPolicy("cuda_mx")):
        sp = ops.linear(x, w, precision="sparse24")
        sa = ops.linear(x, w, precision="sparse24", abft=True)
        ops.linear(x, w, abft=True)
    torch.cuda.synchronize()
    v = kernels.variant_launch_counts()
    assert v["mx_matmul_fused sparse"] == 1 and v["mx_matmul_fused abft"] == 2
    assert v["mx_matmul_fused dense"] == 0 and torch.equal(sp, sa)
    with ops.use_policy(ops.MXPolicy("cuda_baseline")):
        with pytest.raises(NotImplementedError, match="2:4"):
            ops.linear(x, w, precision="sparse24")


@pytest.mark.parametrize("offset", [None, "a", "payload", "meta"])
@pytest.mark.parametrize("act", ["none", "swiglu"])
@pytest.mark.parametrize("pair", sorted(SPARSE_PAIRS))
@pytest.mark.parametrize("M", [1, 8, 16])
def test_sparse_decode_tile_bitwise_equals_dense_decode_tile(cuda, pair, act, M, offset):
    """The 2:4 launch at decode height (the decode tile, payload and
    metadata expanded in registers) at qwen2's ragged widths (K = 896, N =
    128, with bias) is bitwise the dense decode tile on expand_24's weight;
    also with A or the payloads 4 bytes off a 16-byte boundary, or the
    metadata 1 byte off (their rows then take the narrow copies)."""
    from repro_torch.kernels.sparse import expand_24

    K, N = 896, 128
    x, w, wg = (_randn(s, torch.float32, cuda, 10 + i) for i, s in
                enumerate(((M, K), (K, N), (K, N))))
    xa, pb, bs, mb = _sparse(pair, x, w)
    _, pg, gs, mg = _sparse(pair, x, wg)
    gated = act == "swiglu"
    pg, mg, gs = (pg, mg, gs) if gated else (None, None, None)
    if offset == "a":
        xa = _offset_view(xa)
    elif offset == "payload":
        pb, pg = _offset_view(pb), pg if pg is None else _offset_view(pg)
    elif offset == "meta":
        mb, mg = _offset_view(mb, 1), mg if mg is None else _offset_view(mg, 1)
    bn, *_, va, vb, vm = mm.decode_launch_tile(xa, pb, pg, mb, mg, "sparse")
    wide = min(16, bn)  # a metadata row is bn bytes
    assert (va, vb, vm) == {None: (16, 16, wide), "a": (4, 16, wide),
                            "payload": (16, 4, wide), "meta": (16, 16, 1)}[offset]
    out_dtype = torch.float32 if pb.dtype == torch.int8 else xa.dtype
    e = mm.Epilogue(activation=act, b_scale=bs is not None, bias=True)
    kw = dict(epilogue=e, b_gate=pg, b_scale=bs, bg_scale=gs, out_dtype=out_dtype,
              bias=_randn((N,), out_dtype, cuda, 5))
    kernels.reset_launch_counts()
    got = mm.mx_matmul_fused(xa, pb, b_sparse=True, b_meta=mb, bg_meta=mg, **kw)
    assert kernels.decode_launch_counts()["mx_matmul_fused"] == 1
    dense = mm.mx_matmul_fused(xa, expand_24(pb, mb),
                               **dict(kw, b_gate=None if pg is None else expand_24(pg, mg)))
    ref = mm.mx_matmul_fused_plain(xa, pb, b_meta=mb, bg_meta=mg, **kw)
    torch.cuda.synchronize()
    assert kernels.decode_launch_counts()["mx_matmul_fused"] == 2
    assert torch.equal(got, dense)
    _close(got, ref, out_dtype)


@pytest.mark.parametrize("act", ["none", "swiglu"])
@pytest.mark.parametrize("pair", sorted(SPARSE_PAIRS))
def test_sparse_decode_tile_expands_odd_metadata_as_expand_24(cuda, pair, act):
    """Metadata compress_24 never writes -- nibbles out of order, and for f32
    payloads nibbles naming one row twice (expand_24 adds the pair there;
    the kernel's f32 add is expand_24's own for f32, not its bf16 rounding
    or int8 wrap) -- and kept -0.0 payloads (read back as +0.0): the
    decode tile's 2:4 launch is still bitwise the dense decode tile on
    expand_24's weight."""
    from repro_torch.kernels.sparse import expand_24

    M, K, N = 8, 1024, 256
    x, w, wg = (_randn(s, torch.float32, cuda, 30 + i) for i, s in
                enumerate(((M, K), (K, N), (K, N))))
    xa, pb, bs, mb = _sparse(pair, x, w)
    _, pg, gs, mg = _sparse(pair, x, wg)
    g = torch.Generator(device=cuda).manual_seed(7)
    odd = [0x21, 0x63, 0xB7, 0x12, 0x76, 0x3B, 0xE4, 0x1B]  # nibbles (i0, i1) with i0 > i1
    if pb.dtype == torch.float32:
        odd += [0x00, 0x55, 0xAA, 0xFF, 0x05, 0x50]  # and i0 == i1
    odd = torch.tensor(odd, dtype=torch.uint8, device=cuda)
    for meta, payload in ((mb, pb), (mg, pg)):
        pick = torch.rand(meta.shape, generator=g, device=cuda) < 0.25
        meta[pick] = odd[torch.randint(0, len(odd), meta.shape, generator=g, device=cuda)][pick]
        if payload.dtype != torch.int8:
            payload[torch.rand(payload.shape, generator=g, device=cuda) < 0.05] = -0.0
    gated = act == "swiglu"
    pg, mg, gs = (pg, mg, gs) if gated else (None, None, None)
    out_dtype = torch.float32 if pb.dtype == torch.int8 else xa.dtype
    e = mm.Epilogue(activation=act, b_scale=bs is not None)
    kw = dict(epilogue=e, b_gate=pg, b_scale=bs, bg_scale=gs, out_dtype=out_dtype)
    got = mm.mx_matmul_fused(xa, pb, b_sparse=True, b_meta=mb, bg_meta=mg, **kw)
    dense = mm.mx_matmul_fused(xa, expand_24(pb, mb),
                               **dict(kw, b_gate=None if pg is None else expand_24(pg, mg)))
    torch.cuda.synchronize()
    assert torch.equal(got, dense)


@pytest.mark.parametrize("M,K,N", [(1, 896, 128), (8, 2048, 512), (13, 300, 200),
                                   (16, 296, 77)])
@pytest.mark.parametrize("pol", ABFT_PAIRS)
def test_abft_decode_tile_bitwise_flags_and_recovery(cuda, pol, M, K, N):
    """ABFT at decode height (the decode tile with the checksums beside the
    dense chain, 16-column flag tiles): on is bitwise off with no flag; a
    fault flags exactly its tile, in a row of A or in a padding row past M,
    and the flag map equals the plain version's; recovery is bitwise;
    max_retries = 0 raises SDCError naming the tile; int8 x int8 catches a
    delta of 1."""
    from repro_torch.kernels import abft as ab

    x, w, wg = (_randn(s, torch.float32, cuda, 20 + i) for i, s in
                enumerate(((M, K), (K, N), (K, N))))
    qa, a_s, qb, b_s, qg, bg_s = _quantized(pol, x, w, wg)
    e = mm.Epilogue(activation="swiglu", a_scale=a_s is not None, b_scale=b_s is not None)
    kw = dict(epilogue=e, b_gate=qg, a_scale=a_s, b_scale=b_s, bg_scale=bg_s,
              out_dtype=torch.float32)
    spec = mm.abft_spec_for(qa, qb)
    off = mm.mx_matmul_fused(qa, qb, **kw)
    kernels.reset_launch_counts()
    on, flags = mm.mx_matmul_fused(qa, qb, abft=spec, **kw)
    assert kernels.decode_launch_counts()["mx_matmul_fused"] == 1
    assert torch.equal(on, off) and not flags.any()
    assert tuple(flags.shape) == (1, -(-N // 16))
    gn = flags.shape[1]
    delta = 1.0 if spec.exact else 1e8
    for tile, row in (((0, gn - 1), M - 1), ((0, gn // 2), 15)):
        fault = ab.TileFault(*tile, row, 3, delta)
        fd, fr, fc = ab.build_fault_operands(fault, 1, gn, 16, 16, device=cuda)
        fkw = dict(abft=spec.with_inject(True), fault_delta=fd, fault_row=fr, fault_col=fc)
        _, kflags = mm.mx_matmul_fused(qa, qb, **fkw, **kw)
        _, pflags = mm.mx_matmul_fused_plain(qa, qb, **fkw, **kw)
        want = torch.zeros_like(kflags)
        want[tile] = 1
        assert torch.equal(kflags, want) and torch.equal(kflags, pflags.to(cuda)), (tile, row)
    fault = ab.TileFault(0, gn - 1, M - 1, 3, delta)

    def recover(cfg):
        return ops._abft_fused_gemm(qa, qb, ep=e, bias=None, residual=None, w_gate=qg,
                                    a_s=a_s, b_s=b_s, bg_s=bg_s, out_dtype=torch.float32,
                                    cfg=cfg)

    ab.reset_abft_stats()
    assert torch.equal(recover(ab.AbftConfig(fault=fault)), off)
    assert ab.abft_stats()["tiles_recovered"] == 1
    with pytest.raises(ab.SDCError) as err:
        recover(ab.AbftConfig(max_retries=0, fault=fault))
    assert list(err.value.flagged) == [(0, gn - 1)]


@pytest.mark.parametrize("name,precision,abft", [
    ("llama3.2-1b-smoke", "sparse24", False), ("llama3.2-1b-smoke", "sparse24_int8", False),
    ("llama3.2-1b-smoke", "none", True), ("grok-1-314b-smoke", "sparse24_int8", False),
    ("grok-1-314b-smoke", "none", True)])
def test_sparse_and_abft_streams_equal_across_backends(cuda, name, precision, abft):
    import dataclasses

    from repro_torch.kernels import abft as ab

    cfg = dataclasses.replace(get_config(name), precision=precision)
    model = build_model(cfg)
    params = model.init(0, device=cuda)
    rng = np.random.default_rng(3)
    prompts = [rng.integers(0, cfg.vocab, n).astype(np.int32) for n in (6, 9, 13, 7)]
    out = {}
    for backend in ("cuda_mx", "torch"):
        with ops.use_policy(ops.MXPolicy(backend)):
            kernels.reset_launch_counts()
            ab.reset_abft_stats()
            b = ContinuousBatcher(model, params, batch_slots=3, max_len=24, page_size=4,
                                  prefill_chunk=4, abft=abft)
            for i, p in enumerate(prompts):
                b.submit(Request(rid=i, prompt=p, max_new=8))
            fin = b.run_to_completion()
            steps = sum(h.active > 0 for h in b.health) + b.prefill_launches
            out[backend] = ({r: fin[r].output for r in fin}, kernels.variant_launch_counts(),
                            ab.abft_stats(), steps)
    assert out["cuda_mx"][0] == out["torch"][0]
    v, stats, steps = out["cuda_mx"][1:]
    kind = "abft" if abft else "sparse"  # ABFT checksums the decode step, not prefill
    # a 2:4 run launches no dense GEMM but the untied head's, one per step or
    # chunk (the head keeps its declared precision, as in JAX)
    heads = 0 if cfg.tie_embeddings else steps
    names = ("mx_matmul_fused", "mx_grouped_matmul") if cfg.n_experts else ("mx_matmul_fused",)
    for n in names:
        assert v[f"{n} {kind}"] > 0
        assert abft or v[f"{n} dense"] == (heads if n == "mx_matmul_fused" else 0)
    if abft:
        assert stats["gemms_verified"] > 0 and stats["tiles_flagged"] == 0


# ---------------------------------------------------------------------------
# ssd_scan and mx_flash_attention
# ---------------------------------------------------------------------------


def _ssd_inputs(dev, B, L, H, G, P, S, dtype, seed, decay=0.3):
    g = torch.Generator(device=dev).manual_seed(seed)
    x = torch.randn((B, L, H, P), generator=g, device=dev).to(dtype)
    a = -torch.rand((B, L, H), generator=g, device=dev) * decay
    b = (torch.randn((B, L, G, S), generator=g, device=dev) * 0.3).to(dtype)
    c = (torch.randn((B, L, G, S), generator=g, device=dev) * 0.3).to(dtype)
    return x, a, b, c


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("B,L,H,G,P,S,chunk", [
    (2, 512, 8, 1, 64, 64, 128),   # zamba2's head shape, four full chunks
    (2, 200, 8, 1, 64, 64, 128),   # a ragged last chunk
    (1, 70, 4, 2, 16, 8, 32),      # grouped b / c
    (1, 33, 3, 3, 128, 16, 16),    # P at the tile limit, one group per head
    (3, 1, 2, 1, 8, 4, 128),       # one step
])
def test_ssd_scan_kernel_matches_plain(cuda, dtype, B, L, H, G, P, S, chunk):
    x, a, b, c = _ssd_inputs(cuda, B, L, H, G, P, S, dtype, L + P)
    before = ssd_scan.launches
    got = ssd_scan(x, a, b, c, chunk=chunk)
    torch.cuda.synchronize()
    assert ssd_scan.launches == before + 1
    _close(got, ssd_scan_plain(x, a, b, c, chunk), dtype)


def test_ssd_scan_kernel_against_the_sequential_scan_and_a_hard_reset(cuda):
    """One head against the exact scan; a_log = -50 at one step keeps every
    value finite (the decay is masked before the exp) and cuts the state."""
    x, a, b, c = (t[0, :, 0] for t in _ssd_inputs(cuda, 1, 300, 1, 1, 32, 16,
                                                   torch.float32, 7))
    a = a.clone()
    a[150] = -50.0
    got = ssd_scan(x, a, b, c, chunk=128)
    assert torch.isfinite(got).all()
    _close(got, ssd_scan_ref(x, a, b, c), torch.float32)
    x2 = x.clone()
    x2[:100] = 0
    again = ssd_scan(x2, a, b, c, chunk=128)
    assert (got[151:] - again[151:]).abs().max().item() <= 1e-4 * got.abs().max().item()


def test_ssd_scan_refuses_what_it_does_not_take(cuda):
    x, a, b, c = _ssd_inputs(cuda, 1, 16, 2, 1, 8, 4, torch.float32, 0)
    with pytest.raises(ValueError, match="at most 128"):
        ssd_scan(x, a, b, c, chunk=256)
    with pytest.raises(TypeError):
        ssd_scan(x, a, b.bfloat16(), c, chunk=16)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("B,L,H,G,P,S,chunk,reset", [
    (2, 64, 4, 1, 128, 4, 16, False),   # P at the limit, S and chunk at the MMA's edge
    (1, 45, 3, 1, 128, 4, 16, True),    # a ragged last chunk and a hard reset
    (2, 100, 4, 2, 24, 12, 20, False),  # chunk, P and S off the MMA shapes
    (1, 300, 2, 1, 64, 64, 128, True),  # zamba2's head, a hard reset mid-chunk
    (1, 77, 2, 1, 40, 128, 64, False),  # S at the limit
])
def test_ssd_scan_tensor_core_edges(cuda, dtype, B, L, H, G, P, S, chunk, reset):
    """The tensor-core scan at the padded edges of its MMAs (P = 128, S = 4,
    chunk 16, sizes off 8 and 16) and a hard reset (a_log = -50: the decay is
    masked before the exp), against the plain version; the library's SASS
    holds tensor-core instructions, and its shared memory layout is the
    launch table's."""
    x, a, b, c = _ssd_inputs(cuda, B, L, H, G, P, S, dtype, 3 * L + S)
    if reset:
        a = a.clone()
        a[:, L // 2] = -50.0
    got = ssd_scan(x, a, b, c, chunk=chunk)
    torch.cuda.synchronize()
    assert torch.isfinite(got).all()
    _close(got, ssd_scan_plain(x, a, b, c, chunk), dtype)
    tile = _build.ssd_tile(chunk, P, S, dtype)
    smem = _build.function("ssd_scan", "ssd_scan_smem_bytes", [ctypes.c_int] * 5,
                           restype=ctypes.c_size_t)
    assert smem(chunk, P, S, _build.dtype_code(dtype, "x"), tile.stages) == tile.smem
    sass = _sass_ops("ssd_scan", "ssd_scan_kernel")
    assert len(sass) >= 2 and all(ops_["mma"] > 0 for ops_ in sass.values()), sass


def _sass_ops(lib, marker):
    """Per kernel of csrc/<lib>.cu's library whose name holds `marker`: its
    tensor-core (HMMA) and FFMA instruction counts, from cuobjdump."""
    import subprocess
    from pathlib import Path

    cuobjdump = Path(_build._nvcc()).with_name("cuobjdump")
    text = subprocess.run([str(cuobjdump), "-sass", str(_build._target(lib))],
                          capture_output=True, text=True, check=True).stdout
    out, name = {}, None
    for line in text.splitlines():
        if "Function : " in line:
            name = line.split("Function : ")[1].strip()
            name = name if marker in name else None
            if name:
                out[name] = dict(mma=0, ffma=0)
        elif name is not None and "*/" in line:
            op = line.split("*/")[1].split()
            op = op[0] if op and not op[0].startswith("@") else (op[1] if len(op) > 1 else "")
            out[name]["mma"] += op.startswith(("HMMA", "HGMMA"))
            out[name]["ffma"] += op.startswith("FFMA")
    return out


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("B,Lq,Lk,H,Hkv,d,causal", [
    (2, 512, 512, 32, 32, 80, True),   # zamba2's shared block
    (2, 256, 256, 32, 8, 64, True),    # the llama draft forward, GQA 4
    (1, 33, 70, 1, 1, 8, False),       # tests/test_kernels_flash.py's cross shape
    (2, 100, 100, 4, 2, 128, True),    # d at the accumulator limit, ragged tiles
    (1, 40, 100, 4, 4, 32, True),      # causal top-left, Lq < Lk
    (1, 100, 40, 4, 1, 32, True),      # causal top-left, Lq > Lk
    (3, 1, 7, 2, 2, 16, False),        # one query row
])
def test_flash_attention_kernel_matches_plain(cuda, dtype, B, Lq, Lk, H, Hkv, d, causal):
    q = _randn((B, Lq, H, d), dtype, cuda, Lq + d)
    k = _randn((B, Lk, Hkv, d), dtype, cuda, Lk + d + 1)
    v = _randn((B, Lk, Hkv, d), dtype, cuda, Lk + d + 2)
    before = mx_flash_attention.launches
    got = mx_flash_attention(q, k, v, causal=causal)
    torch.cuda.synchronize()
    assert mx_flash_attention.launches == before + 1
    _close(got, flash_attention_plain(q, k, v, causal=causal), dtype)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("B,Lq,Lk,H,Hkv,d,causal", [
    (2, 70, 70, 4, 2, 16, True),       # d = 16: one MMA K step
    (2, 70, 90, 4, 4, 8, False),       # d = 8, padded with zeros to 16
    (1, 65, 65, 4, 1, 64, True),       # one row past a 64-row tile
    (2, 129, 129, 8, 2, 80, True),     # one row past two tiles, d = 80
    (1, 200, 200, 2, 2, 5, True),      # d = 5: 2- and 4-byte copies
])
def test_flash_attention_kernel_tile_edges(cuda, dtype, B, Lq, Lk, H, Hkv, d, causal):
    q = _randn((B, Lq, H, d), dtype, cuda, 3 * Lq + d)
    k = _randn((B, Lk, Hkv, d), dtype, cuda, 3 * Lk + d + 1)
    v = _randn((B, Lk, Hkv, d), dtype, cuda, 3 * Lk + d + 2)
    got = mx_flash_attention(q, k, v, causal=causal)
    torch.cuda.synchronize()
    _close(got, flash_attention_plain(q, k, v, causal=causal), dtype)


def test_flash_attention_bf16_keeps_probabilities_in_f32(cuda):
    """k = [[0, 0], [1, 0]], v = I, q = [[0.0648, 0]] in bf16: the output is
    the softmax itself; JAX and the plain version give 0.48828125, a
    probability rounded to bf16 gave 0.49023438.  The kernel equals the plain
    version exactly."""
    q = torch.tensor([[0.0648, 0.0]], device=cuda).bfloat16()
    k = torch.tensor([[0.0, 0.0], [1.0, 0.0]], device=cuda).bfloat16()
    v = torch.eye(2, device=cuda).bfloat16()
    got = mx_flash_attention(q, k, v, causal=False)
    want = flash_attention_plain(q[None, :, None], k[None, :, None], v[None, :, None],
                                 causal=False)[0, :, 0]
    torch.cuda.synchronize()
    assert got[0, 0].item() == 0.48828125
    assert torch.equal(got, want)


def test_flash_attention_refuses_what_it_does_not_take(cuda):
    q = _randn((1, 8, 2, 160), torch.float32, cuda, 0)
    with pytest.raises(RuntimeError, match="head dim of at most 128"):
        mx_flash_attention(q, q, q)
    q = _randn((1, 8, 2, 16), torch.float32, cuda, 0)
    with pytest.raises(TypeError):
        mx_flash_attention(q, q.bfloat16(), q)


def test_zamba2_forward_and_dense_streams_across_backends(cuda):
    """zamba2-smoke on the card: the full forward launches ssd_scan once per
    Mamba2 layer and mx_flash_attention once per shared-block application,
    its logits within 1e-3 * max|ref| of the plain path; the dense
    batcher's streams are equal across backends (decode is plain apart
    from the GEMMs)."""
    cfg = get_config("zamba2-2.7b-smoke")
    model = build_model(cfg)
    params = model.init(0, device=cuda)
    toks = torch.randint(0, cfg.vocab, (2, 150), device=cuda,
                         generator=torch.Generator(device=cuda).manual_seed(1))
    out = {}
    for backend in ("cuda_mx", "torch"):
        with ops.use_policy(ops.MXPolicy(backend)):
            kernels.reset_launch_counts()
            logits, _ = model(params, toks)
            counts = kernels.launch_counts()
            b = ContinuousBatcher(model, params, batch_slots=3, max_len=24, paged=False)
            rng = np.random.default_rng(3)
            for i, n in enumerate((6, 9, 13, 7)):
                b.submit(Request(rid=i, prompt=rng.integers(0, cfg.vocab, n).astype(np.int32),
                                 max_new=8))
            fin = b.run_to_completion()
        out[backend] = (logits, counts, {r: fin[r].output for r in fin})
    n_mamba = sum(n for kind, n in cfg.blocks if kind == "mamba2")
    assert out["cuda_mx"][1]["ssd_scan"] == n_mamba
    assert out["cuda_mx"][1]["mx_flash_attention"] == n_mamba // cfg.shared_attn_every
    assert out["torch"][1]["ssd_scan"] == out["torch"][1]["mx_flash_attention"] == 0
    ref = out["torch"][0]
    err = (out["cuda_mx"][0] - ref).abs().max().item()
    assert err <= 1e-3 * ref.abs().max().item()
    assert out["cuda_mx"][2] == out["torch"][2]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("B,Lq,Lk,H,Hkv,d,causal", [
    (4, 512, 512, 16, 16, 64, False),   # seamless-m4t-medium's encoder: non-causal, Lq = Lk
    (4, 64, 512, 16, 16, 64, False),    # its cross-attention, Lq < Lk
    (4, 1, 512, 16, 16, 64, False),     # its cross-attention at decode, Lq = 1
    (3, 1, 32, 16, 16, 64, False),      # the static launcher's 32 encoder frames
    (1, 1088, 1088, 48, 8, 128, True),  # internvl2-26b: 1024 prefix + 64 text, d = 128
])
def test_flash_attention_model_family_shapes(cuda, dtype, B, Lq, Lk, H, Hkv, d, causal):
    """The shapes the encoder-decoder and the prefix model give the kernel,
    one launch each, against the plain version."""
    q = _randn((B, Lq, H, d), dtype, cuda, 7 * Lq + d)
    k = _randn((B, Lk, Hkv, d), dtype, cuda, 7 * Lk + d + 1)
    v = _randn((B, Lk, Hkv, d), dtype, cuda, 7 * Lk + d + 2)
    before = mx_flash_attention.launches
    got = mx_flash_attention(q, k, v, causal=causal)
    torch.cuda.synchronize()
    assert mx_flash_attention.launches == before + 1
    _close(got, flash_attention_plain(q, k, v, causal=causal), dtype)


def test_xlstm_decode_step_launches_51_decode_tile_gemms(cuda):
    """xlstm-125m at full width (9 mLSTM + 3 sLSTM blocks): one decode step
    at 4 slots launches mx_matmul_fused 5 times per mLSTM block and twice
    per sLSTM block, 51 in all, every one on the decode tile, and nothing
    else; its logits within 1e-3 * max|ref| of the plain path."""
    cfg = get_config("xlstm-125m")
    model = build_model(cfg)
    params = model.init(0, device=cuda)
    tok = torch.randint(0, cfg.vocab, (4, 1), device=cuda,
                        generator=torch.Generator(device=cuda).manual_seed(2))
    out = {}
    for backend in ("cuda_mx", "torch"):
        cache = model.make_cache(4, 8, dtype=torch.float32, device=cuda)
        with ops.use_policy(ops.MXPolicy(backend)):
            model.decode_step(params, tok, cache, 0)
            kernels.reset_launch_counts()
            logits, _ = model.decode_step(params, tok, cache, 1)
            torch.cuda.synchronize()
        out[backend] = (logits, kernels.launch_counts(), kernels.decode_launch_counts())
    logits, counts, decode = out["cuda_mx"]
    assert counts["mx_matmul_fused"] == decode["mx_matmul_fused"] == 51
    assert sum(counts.values()) == 51
    assert not any(out["torch"][1].values())
    ref = out["torch"][0]
    assert (logits - ref).abs().max().item() <= 1e-3 * ref.abs().max().item()


@pytest.mark.parametrize("name", ["seamless-m4t-medium-smoke", "internvl2-26b-smoke"])
def test_encdec_and_prefix_forwards_across_backends(cuda, name):
    """The smoke models' forwards on the card: seamless launches the
    attention kernel once per encoder layer and twice per decoder layer
    (causal self-attention, cross-attention), internvl2 once per layer over
    prefix and text; logits within 1e-3 * max|ref| of the plain path."""
    from repro_torch.launch.steps import make_prefill_step

    cfg = get_config(name)
    model = build_model(cfg)
    params = model.init(0, device=cuda)
    g = torch.Generator(device=cuda).manual_seed(4)
    batch = {"tokens": torch.randint(0, cfg.vocab, (2, 40), device=cuda, generator=g)}
    if cfg.model_kind == "encdec":
        batch["frames"] = torch.randn((2, 70, cfg.frontend_dim), device=cuda, generator=g)
        want = cfg.enc_layers + 2 * cfg.n_layers
    else:
        batch["pixel_embeds"] = torch.randn((2, cfg.frontend_tokens, cfg.frontend_dim),
                                            device=cuda, generator=g)
        want = cfg.n_layers
    step = make_prefill_step(model, cfg)
    out = {}
    for backend in ("cuda_mx", "torch"):
        with ops.use_policy(ops.MXPolicy(backend)):
            kernels.reset_launch_counts()
            logits = step(params, batch)
            torch.cuda.synchronize()
        out[backend] = (logits, kernels.launch_counts())
    assert out["cuda_mx"][1]["mx_flash_attention"] == want
    assert not any(out["torch"][1].values())
    ref = out["torch"][0]
    assert out["cuda_mx"][0].shape == (2, 40, cfg.vocab)
    assert (out["cuda_mx"][0] - ref).abs().max().item() <= 1e-3 * ref.abs().max().item()


# ---------------------------------------------------------------------------
# chaos and disaggregated serving on the kernels
# ---------------------------------------------------------------------------


def _llama_smoke(dev):
    model = build_model(get_config("llama3.2-1b-smoke"))
    return model, model.init(0, device=dev)


def _smoke_prompts(n=5, seed=4):
    rng = np.random.default_rng(seed)
    vocab = get_config("llama3.2-1b-smoke").vocab
    return [rng.integers(0, vocab, (9, 14, 6, 17, 11)[i % 5]).astype(np.int32)
            for i in range(n)]


@pytest.mark.parametrize("kv", [None, "int8"])
def test_retried_step_leaves_the_pages_bitwise_unfailed_on_the_card(cuda, kv):
    """The injected failure comes before the kernels run: after every step
    the pages of a run with failures equal those of a run without, bit for
    bit, and so do the streams; the kernels ran."""
    from repro_torch.runtime.lifecycle import ChaosConfig, ChaosInjector, RetryPolicy

    model, params = _llama_smoke(cuda)
    runs = []
    with ops.use_policy(ops.MXPolicy("cuda_mx")):
        for chaos in (None, ChaosInjector(ChaosConfig(fail_at_steps=(0, 1, 3, 6, 10)))):
            b = ContinuousBatcher(model, params, batch_slots=3, max_len=32, page_size=4,
                                  prefill_chunk=4, prefix_cache=True, chaos=chaos,
                                  kv_quant=QuantSpec(kv) if kv else None,
                                  retry=RetryPolicy(max_retries=1))
            for i, p in enumerate(_smoke_prompts()):
                b.submit(Request(rid=i, prompt=p, max_new=6))
            runs.append(b)
        kernels.reset_launch_counts()
        while any(b.queue or b.active for b in runs):
            for b in runs:
                b.step()
            leaves = [[t for seg in b.cache.values() for t in seg.values()] for b in runs]
            assert all(torch.equal(x, y) for x, y in zip(*leaves))
    n = kernels.launch_counts()
    assert n["mx_matmul_fused"] > 0 and n["mx_flash_decode"] > 0
    assert runs[1].retries_total == 5
    assert {r: v.output for r, v in runs[0].finished.items()} == \
        {r: v.output for r, v in runs[1].finished.items()}


@pytest.mark.parametrize("speculate", [0, 3])
def test_bitflips_under_abft_detected_and_corrected_on_the_card(cuda, speculate):
    """abft=True with the chaos bit-flip stream: every flip of the audited
    host copy is detected and corrected, the ABFT kernels flag no tile, and
    the streams are those of the run without flips."""
    from repro_torch.kernels import abft as ab
    from repro_torch.runtime.lifecycle import ChaosConfig, ChaosInjector

    model, params = _llama_smoke(cuda)
    out = []
    with ops.use_policy(ops.MXPolicy("cuda_mx")):
        for chaos in (None, ChaosInjector(ChaosConfig(seed=2, bitflip_rate=0.5))):
            kernels.reset_launch_counts()
            ab.reset_abft_stats()
            b = ContinuousBatcher(model, params, batch_slots=3, max_len=32, page_size=4,
                                  prefill_chunk=4, abft=True, chaos=chaos, speculate=speculate,
                                  drafter=NGramDrafter() if speculate else None)
            for i, p in enumerate(_smoke_prompts()):
                b.submit(Request(rid=i, prompt=p, max_new=6))
            fin = b.run_to_completion()
            out.append(({r: fin[r].output for r in fin}, b, kernels.variant_launch_counts(),
                        ab.abft_stats()))
    (base, _, _, _), (flipped, b, v, stats) = out
    assert flipped == base
    assert b.sdc_detected == b.sdc_corrected == b.chaos.bitflips_injected > 0
    assert v["mx_matmul_fused abft"] > 0 and stats["tiles_flagged"] == 0
    assert kernels.launch_counts()["mx_flash_verify" if speculate else "mx_flash_decode"] > 0


@pytest.mark.parametrize("shared_pool,kv", [(True, None), (False, None), (False, "int8")])
def test_disagg_streams_equal_the_paged_batcher_on_the_card(cuda, shared_pool, kv):
    """The disaggregated engine on "cuda_mx" (2 workers, batch-1 chunks of
    4 rows on the decode tile) emits the paged batcher's streams; migrated
    pages (int8 payloads and scale pages too) are bitwise their sources."""
    from repro_torch.runtime.disagg import DisaggEngine

    model, params = _llama_smoke(cuda)
    kvq = QuantSpec(kv) if kv else None
    with ops.use_policy(ops.MXPolicy("cuda_mx")):
        ref = ContinuousBatcher(model, params, batch_slots=2, max_len=32, page_size=4,
                                kv_quant=kvq)
        for i, p in enumerate(_smoke_prompts(6)):
            ref.submit(Request(rid=i, prompt=p, max_new=5))
        want = {r: v.output for r, v in ref.run_to_completion().items()}
        eng = DisaggEngine(model, params, prefill_workers=2, batch_slots=2, max_len=32,
                           page_size=4, prefill_chunk=4, shared_pool=shared_pool, kv_quant=kvq)
        held = []
        if not shared_pool:
            migrate = eng._migrate_pages

            def checked(dst, src):
                migrate(dst, src)
                for name, seg in eng.batcher.cache.items():
                    for leaf, t in seg.items():
                        held.append(torch.equal(t[:, dst], eng.cache_p[name][leaf][:, src]))

            eng._migrate_pages = checked
        kernels.reset_launch_counts()
        for i, p in enumerate(_smoke_prompts(6)):
            eng.submit(Request(rid=i, prompt=p, max_new=5))
        fin = eng.run_to_completion()
    n = kernels.decode_launch_counts()
    assert {r: v.output for r, v in fin.items()} == want
    assert eng.summary()["handoffs_completed"] == 6 and eng.prefill_launches > 0
    assert n["mx_matmul_fused"] > 0 and kernels.launch_counts()["mx_flash_decode"] > 0
    if not shared_pool:
        assert eng.migrated_pages > 0 and held and all(held)


# ---------------------------------------------------------------------------
# tensor parallelism on one card: the ring collective GEMMs over LocalRing
# ---------------------------------------------------------------------------


def _ring_operands(dev, mode, M, K, N, dtype, P, seed=0, gelu=False):
    """Per-rank shards of one ring GEMM and the whole operands: the
    all-gather ring's x rows and contiguous w / bias / residual columns,
    or the reduce-scatter ring's x and w K-slices and residual rows."""
    from repro_torch.kernels.mx_matmul import Epilogue

    x = _randn((M, K), dtype, dev, seed)
    w = (_randn((K, N), torch.float32, dev, seed + 1) / K ** 0.5).to(dtype)
    b = _randn((N,), dtype, dev, seed + 2)
    res = _randn((M, N), dtype, dev, seed + 3)
    if mode == "allgather":
        m, n = M // P, N // P
        cols = [slice(r * n, (r + 1) * n) for r in range(P)]
        shards = ([x[r * m:(r + 1) * m] for r in range(P)], [w[:, c].contiguous() for c in cols],
                  dict(bias=[b[c] for c in cols], residual=[res[:, c].contiguous() for c in cols]))
        ep = Epilogue(activation="gelu" if gelu else "none", bias=True, residual=True)
    else:
        k, m = K // P, M // P
        shards = ([x[:, r * k:(r + 1) * k].contiguous() for r in range(P)],
                  [w[r * k:(r + 1) * k] for r in range(P)],
                  dict(bias=[b] * P, residual=[res[r * m:(r + 1) * m] for r in range(P)]))
        ep = Epilogue(bias=True, residual=True)
    return (x, w, b, res), shards, ep


def _run_ring(mode, ring, shards, ep, direction):
    from repro_torch.kernels import mx_collective_matmul as cm

    xs, ws, kw = shards
    fn = cm.ring_allgather_matmul if mode == "allgather" else cm.ring_matmul_reduce_scatter
    return fn(ring, xs, ws, compute=cm.ChunkCompute("cuda_mx"), epilogue=ep,
              direction=direction, **kw)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("M", [8, 64])
@pytest.mark.parametrize("direction", ["fwd", "bwd", "bidir"])
@pytest.mark.parametrize("mode", ["allgather", "reduce_scatter"])
def test_rings_match_the_serialized_references_on_the_card(cuda, mode, direction, M, dtype):
    """Every chunk GEMM on kernel 1 (P^2 launches over LocalRing(8)); the
    ring within the dtype's tolerance of its serialized reference and of
    one kernel-1 launch on the whole GEMM."""
    from repro_torch.kernels import mx_collective_matmul as cm
    from repro_torch.parallel.ring import LocalRing

    P = 8
    (x, w, b, res), shards, ep = _ring_operands(cuda, mode, M, 512, 384, dtype, P, gelu=True)
    ring = LocalRing(P)
    kernels.reset_launch_counts()
    outs = _run_ring(mode, ring, shards, ep, direction)
    assert kernels.launch_counts()["mx_matmul_fused"] == P * P
    ser_fn = cm.serialized_allgather_matmul if mode == "allgather" else cm.serialized_matmul_psum
    ser = ser_fn(ring, shards[0], shards[1], compute=cm.ChunkCompute("cuda_mx"), epilogue=ep,
                 **shards[2])
    dim = 1 if mode == "allgather" else 0
    got = torch.cat(outs, dim)
    whole = mm.mx_matmul_fused(x, w, epilogue=ep, bias=b, residual=res)
    _close(got, torch.cat(ser, dim), dtype)
    _close(got, whole, dtype)
    assert ring.bytes_moved > 0


@pytest.mark.parametrize("M", [8, 16, 64])
@pytest.mark.parametrize("direction", ["fwd", "bwd", "bidir"])
def test_allgather_chunk_rows_are_bitwise_kernel_1(cuda, direction, M):
    """Each all-gather step's output rows are bitwise kernel 1 on the same
    rows (the two half-chunks of a bidir step concatenated) and shard."""
    from repro_torch.parallel.ring import LocalRing

    P = 8
    (x, _, _, _), shards, ep = _ring_operands(cuda, "allgather", M, 512, 384, torch.float32,
                                              P, gelu=True)
    outs = _run_ring("allgather", LocalRing(P), shards, ep, direction)
    m = M // P
    bidir = direction == "bidir" and m % 2 == 0
    for i in range(P):
        for step in range(P):
            if bidir:
                f, bk = (i - step) % P, (i + step) % P
                rows = torch.cat([torch.arange(f * m, f * m + m // 2),
                                  torch.arange(bk * m + m // 2, (bk + 1) * m)])
            else:
                src = ((i + step) if direction == "bwd" else (i - step)) % P
                rows = torch.arange(src * m, (src + 1) * m)
            rows = rows.to(cuda)
            want = mm.mx_matmul_fused(x[rows].contiguous(), shards[1][i], epilogue=ep,
                                      bias=shards[2]["bias"][i],
                                      residual=shards[2]["residual"][i][rows].contiguous())
            assert torch.equal(outs[i][rows], want), (i, step)


@pytest.mark.parametrize("mode", ["allgather", "reduce_scatter"])
def test_ring_abft_recovery_on_the_card(cuda, mode):
    """ABFT on the ring: the chunk GEMMs on kernel 1's checksummed variant,
    a ring fault flagged, the rerun bitwise the fault-free ring, the
    counters advanced, one host read of the flag total per clean ring
    linear (and one per rerun)."""
    from repro_torch.kernels import abft as A
    from repro_torch.kernels import mx_collective_matmul as cm
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.parallel.sharding import collective_policy

    (x, w, b, res), _, _ = _ring_operands(cuda, mode, 64, 512, 384, torch.float32, 8)
    with ops.use_policy(ops.MXPolicy("cuda_mx")), collective_policy(
            make_mesh((1, 8), ("data", "model"))):
        cm.reset_ring_stats()
        clean = ops.linear(x, w, b, residual=res, tp_mode=mode, abft=True)
        assert cm.ring_stats()["flag_reads"] == 1
        A.reset_abft_stats()
        kernels.reset_launch_counts()
        got = ops.linear(x, w, b, residual=res, tp_mode=mode,
                         abft=A.AbftConfig(fault=A.TileFault(3, 0, 1, 2, 5.0)))
        assert torch.equal(got, clean)
        assert A.abft_stats() == dict(gemms_verified=1, tiles_flagged=1, tiles_recovered=1,
                                      sdc_errors=0)
        assert kernels.variant_launch_counts()["mx_matmul_fused abft"] == 2 * 64
        assert cm.ring_stats()["flag_reads"] == 3
        _close(got, ops.linear(x, w, b, residual=res, tp_mode=mode), torch.float32)


@pytest.mark.parametrize("mode", ["allgather", "reduce_scatter"])
@pytest.mark.parametrize("busy", ["side", "current"])
def test_local_ring_stream_ordering(cuda, mode, busy):
    """A ring whose hops copy on the side stream gives the bits of one that
    copies on the current stream, with a long spin kernel queued first on
    either stream (a copy that ran early, or a buffer the allocator reused,
    would change them)."""
    from repro_torch.parallel.ring import LocalRing

    _, shards, ep = _ring_operands(cuda, mode, 64, 2048, 1024, torch.float32, 8, gelu=True)
    want = torch.cat(_run_ring(mode, LocalRing(8, sync=True), shards, ep, "bidir"), 0)
    ring = LocalRing(8)
    stream = ring.side_stream(cuda) if busy == "side" else torch.cuda.current_stream()
    with torch.cuda.stream(stream):
        torch.cuda._sleep(50_000_000)  # 5e7 cycles: milliseconds at the SM clock
    got = torch.cat(_run_ring(mode, ring, shards, ep, "bidir"), 0)
    torch.cuda.synchronize()
    assert torch.equal(got, want)


def test_llama_smoke_under_the_ring_on_the_card(cuda):
    """llama3.2-1b-smoke's forward and the paged batcher under the policy
    over LocalRing(4): logits within 1e-3 * max|ref| of the plain forward,
    the streams the batcher's without the policy, both rings on kernel 1."""
    import contextlib

    from repro_torch.kernels import mx_collective_matmul as cm
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.parallel.sharding import collective_policy

    model, params = _llama_smoke(cuda)
    toks = torch.as_tensor(np.random.default_rng(2).integers(0, 256, (2, 16)), device=cuda)
    with ops.use_policy(ops.MXPolicy("cuda_mx")):
        ref, _ = model(params, toks)
        cm.reset_ring_stats()
        with collective_policy(make_mesh((1, 4), ("data", "model"))):
            got, _ = model(params, toks)
        s = cm.ring_stats()
        assert s["allgather_chunks"] > 0 and s["reduce_scatter_chunks"] > 0
        assert (got - ref).abs().max().item() <= 1e-3 * ref.abs().max().item()

        def streams(ctx):
            with ctx:
                b = ContinuousBatcher(model, params, batch_slots=4, max_len=32, page_size=4,
                                      prefill_chunk=4)
                for i, p in enumerate(_smoke_prompts(6)):
                    b.submit(Request(rid=i, prompt=p, max_new=5))
                return {r: v.output for r, v in b.run_to_completion().items()}
        want = streams(contextlib.nullcontext())
        cm.reset_ring_stats()
        assert streams(collective_policy(make_mesh((1, 4), ("data", "model")))) == want
        s = cm.ring_stats()
        assert s["allgather_chunks"] > 0 and s["reduce_scatter_chunks"] > 0


def test_moe_collective_branch_and_gpipe_on_the_card(cuda):
    """The MoE's collective branch against its grouped launch, and GPipe
    over 4 stages of smoke-width blocks against the blocks in sequence
    (f32, 1e-4 * max|ref|)."""
    from repro_torch.kernels import mx_collective_matmul as cm
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.models.moe import MoE
    from repro_torch.models.transformer import TransformerBlock
    from repro_torch.parallel.pipeline import gpipe_apply
    from repro_torch.parallel.sharding import collective_policy

    moe = MoE(d_model=64, d_ff=128, n_experts=8, top_k=2)
    mp = moe.init(0, device=cuda)
    x = _randn((2, 64, 64), torch.float32, cuda, 5)
    with ops.use_policy(ops.MXPolicy("cuda_mx")):
        ref, aux = moe(mp, x)
        cm.reset_ring_stats()
        with collective_policy(make_mesh((1, 8), ("data", "model"))):
            got, aux2 = moe(mp, x)
        assert cm.ring_stats()["allgather_chunks"] == 8 * 64
        _close(got, ref, torch.float32)
        assert float(aux) == float(aux2)
        blk = TransformerBlock(d_model=64, n_heads=4, n_kv_heads=2, d_ff=128)
        layers = [blk.init(s, device=cuda) for s in range(4)]
        stacked = {k: (torch.stack([lp[k] for lp in layers]) if torch.is_tensor(v) else
                       {kk: torch.stack([lp[k][kk] for lp in layers]) for kk in v})
                   for k, v in layers[0].items()}
        xs = _randn((4, 1, 16, 64), torch.float32, cuda, 6)
        got = gpipe_apply(lambda p, h: blk(p, h)[0], stacked, xs,
                          mesh=make_mesh((4,), ("pod",)))
        want = xs
        for lp in layers:
            want = torch.stack([blk(lp, h)[0] for h in want])
        _close(got, want, torch.float32)


# ---------------------------------------------------------------------------
# training (chip_smoke.py phase 13): the plain path under autograd on the card
# ---------------------------------------------------------------------------


def _chip_smoke():
    import importlib
    import sys
    from pathlib import Path

    root = str(Path(__file__).resolve().parents[1])
    if root not in sys.path:
        sys.path.insert(0, root)
    return importlib.import_module("chip_smoke")


def test_kernels_refuse_grad_on_the_card(cuda):
    """A "cuda_mx" linear and the flash attention refuse an operand that
    requires grad (nothing launches); under no_grad they give the bits of
    an operand that does not."""
    x, w = _randn((8, 512), torch.float32, cuda, 0), _randn((512, 256), torch.float32, cuda, 1)
    q, k, v = (_randn((2, 64, h, 64), torch.float32, cuda, 2 + h) for h in (8, 2, 2))
    for call, operand in ((lambda t: ops.linear(x, t, policy=ops.MXPolicy("cuda_mx")), w),
                          (lambda t: mx_flash_attention(t, k, v), q)):
        plain = call(operand)
        before = kernels.launch_counts()
        with pytest.raises(RuntimeError, match="requires grad"):
            call(operand.clone().requires_grad_())
        assert kernels.launch_counts() == before
        with torch.no_grad():
            assert torch.equal(call(operand.clone().requires_grad_()), plain)


@pytest.mark.parametrize("arch", ["llama3.2-1b", "qwen2-0.5b", "grok-1-314b", "zamba2-2.7b",
                                  "xlstm-125m", "seamless-m4t-medium", "internvl2-26b"])
def test_train_step_on_the_card_matches_the_cpu(cuda, arch):
    """One train step of a smoke config on the card against the same step
    on the CPU (chip_smoke's `_hold_step` at its `TRAIN_STEP_TOL`); no kernel
    launches, every leaf on the card."""
    from repro_torch.core import tree as T
    from repro_torch.data.pipeline import SyntheticLM
    from repro_torch.launch.steps import make_train_step
    from repro_torch.optim.adamw import AdamW

    cs = _chip_smoke()
    cfg = get_config(arch + "-smoke")
    model, opt = build_model(cfg), AdamW(lr=1e-3)
    batch = SyntheticLM(cfg, seq_len=32, global_batch=2).next_batch()
    p_cpu = model.init(0, device="cpu")
    p_dev = T.map(lambda t: t.to(cuda), p_cpu)
    step = make_train_step(model, cfg, opt)
    ref = step(p_cpu, opt.init(p_cpu), batch)
    kernels.reset_launch_counts()
    got = step(p_dev, opt.init(p_dev), batch)
    assert not any(kernels.launch_counts().values())
    assert all(t.is_cuda for t in T.leaves(got[:2]))
    rec, ok = cs._hold_step(torch, ref, got, cs.TRAIN_STEP_TOL.get(arch, 1e-5), 1e-3, 0.1)
    assert ok, rec


def test_gpipe_gradient_on_the_card(cuda):
    """GPipe over LocalRing(4) on CUDA tensors (the hops copy on a side
    stream, forward and backward) against the blocks in sequence: the
    gradients of every stage weight and of the input within 1e-5 *
    max|ref|."""
    from repro_torch.core import tree as T
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.models.transformer import TransformerBlock
    from repro_torch.parallel.pipeline import gpipe_apply

    blk = TransformerBlock(d_model=64, n_heads=4, n_kv_heads=2, d_ff=128)
    layers = [blk.init(s, device=cuda) for s in range(4)]
    stacked = {k: (torch.stack([lp[k] for lp in layers]) if torch.is_tensor(v) else
                   {kk: torch.stack([lp[k][kk] for lp in layers]) for kk in v})
               for k, v in layers[0].items()}
    xs, ct = _randn((4, 1, 16, 64), torch.float32, cuda, 6), _randn((4, 1, 16, 64),
                                                                    torch.float32, cuda, 7)
    with ops.use_policy(ops.MXPolicy("torch")):
        st = T.map(lambda t: t.clone().requires_grad_(), stacked)
        xg = xs.clone().requires_grad_()
        with torch.cuda.stream(torch.cuda.current_stream()):
            torch.cuda._sleep(20_000_000)  # a copy that ran early would read stale values
            got = gpipe_apply(lambda p, h: blk(p, h)[0], st, xg, mesh=make_mesh((4,), ("pod",)))
            gg = torch.autograd.grad((got * ct).sum(), [xg, *T.leaves(st)])
        sq = T.map(lambda t: t.clone().requires_grad_(), stacked)
        xq = xs.clone().requires_grad_()
        want = xq
        for j in range(4):
            want = torch.stack([blk(T.map(lambda t, j=j: t[j], sq), h)[0] for h in want])
        gw = torch.autograd.grad((want * ct).sum(), [xq, *T.leaves(sq)])
    for a, b in zip(gg, gw):
        assert (a - b).abs().max().item() <= 1e-5 * b.abs().max().item()


def test_train_loop_recovers_bitwise_on_the_card(cuda, tmp_path):
    """chip_smoke's deterministic child (phase 13d): a failure at step 6 of
    10 ends bitwise the uninterrupted run, a NaN loss raises, the last
    checkpoint restores onto the CPU with the card's bits."""
    import json
    import os
    import subprocess
    import sys

    cs = _chip_smoke()
    out = tmp_path / "loop.json"
    r = subprocess.run([sys.executable, "-c", cs.LOOP_CHILD, str(out)], capture_output=True,
                       text=True, timeout=600, cwd=cs.ROOT,
                       env=dict(os.environ, PYTHONPATH=str(cs.ROOT / "src"),
                                CUBLAS_WORKSPACE_CONFIG=":4096:8"))
    assert r.returncode == 0, r.stderr[-4000:]
    res = json.loads(out.read_text())
    assert res["restarts"] == [0, 1] and res["steps_run"] == [10, 12]
    assert res["bitwise"] and res["on_cuda"] and res["nan_raised"] and res["cpu_bits"]
    assert res["restored_step"] == 10 and not any(res["launches"].values())


def test_train_launcher_recovers_on_the_card(cuda, tmp_path):
    import os
    import subprocess
    import sys

    cs = _chip_smoke()
    r = subprocess.run([sys.executable, "-m", "repro_torch.launch.train", "--smoke", "--steps",
                        "20", "--inject-failure", "7", "--ckpt-dir", str(tmp_path / "ck")],
                       capture_output=True, text=True, timeout=600, cwd=cs.ROOT,
                       env=dict(os.environ, PYTHONPATH=str(cs.ROOT / "src")))
    assert r.returncode == 0, r.stderr[-4000:]
    assert "1 restarts" in r.stdout and "done: " in r.stdout


@pytest.mark.parametrize("arch", ["llama3.2-1b", "grok-1-314b"])
def test_census_flops_equal_flop_counter_on_the_card(cuda, arch):
    """The dry run's census of a smoke train step and a dense decode step,
    counted on "meta", equals FlopCounterMode on the same steps on the
    card, exactly (the decode under "torch", so no ctypes launch escapes
    the counter)."""
    from torch.utils.flop_counter import FlopCounterMode

    from repro_torch.configs import get_config
    from repro_torch.configs.shapes import ShapePreset
    from repro_torch.core import ops
    from repro_torch.core import tree as T
    from repro_torch.core.op_census import census
    from repro_torch.data.pipeline import SyntheticLM
    from repro_torch.launch import steps
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.launch.specs import cell_specs
    from repro_torch.models import build_model
    from repro_torch.optim.adamw import AdamW
    from repro_torch.parallel.sharding import make_rules

    cfg = get_config(arch + "-smoke")
    model, opt = build_model(cfg), AdamW()
    rules = make_rules(make_mesh((1, 1), ("data", "model")))
    train = cell_specs(cfg, ShapePreset("t", 32, 2, "train"), rules, opt=opt,
                       param_dtype=torch.float32)
    step = steps.make_train_step(model, cfg, opt, inplace=True)
    on_meta, _ = census(step, *train.args)
    params = model.init(0, device=cuda)
    batch = SyntheticLM(cfg, seq_len=32, global_batch=2).next_batch()
    with FlopCounterMode(display=False) as fc:
        step(T.map(torch.clone, params), opt.init(params), batch)
    assert on_meta.flops == fc.get_total_flops() > 0
    dec = cell_specs(cfg, ShapePreset("d", 64, 4, "decode"), rules, param_dtype=torch.float32)
    serve = steps.make_serve_step(model, cfg)
    on_meta, _ = census(serve, *dec.args)
    cache = model.make_cache(4, 64, device=cuda)
    token = torch.zeros((4, 1), dtype=torch.int32, device=cuda)
    with ops.use_policy(ops.MXPolicy("torch")), FlopCounterMode(display=False) as fc:
        serve(params, cache, token, 63)
    assert on_meta.flops == fc.get_total_flops() > 0
