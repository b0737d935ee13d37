"""The GEMMs' decode tile rule on the CPU: `kernels/_build.decode_tile`
(the CTA shape, ring depth and copy width that `csrc/mx_matmul*.cu` -- the
dense, 2:4 and ABFT variants -- and `csrc/baseline_matmul.cu` launch at
M <= 16), `copy_width` (the narrow copies for ragged and misaligned rows)
and `gemm_tile`, which the prefill tiles and every ABFT flag map keep
reading.

The kernels themselves run only on the card (`tests/test_torch_cuda.py`):
here the tile's arithmetic is held against the limits of an H100 -- 227 KB
of shared memory per CTA, 228 KB per SM, 512 threads -- and against the
loop's own constraints (csrc/decode_tile.cuh `decode_check`).
"""
import math

import pytest

torch = pytest.importorskip("torch")

from repro_torch.kernels import _build  # noqa: E402
from repro_torch.kernels import mx_matmul as mm  # noqa: E402
from repro_torch.kernels.mx_matmul import decode_launch_tile  # noqa: E402

PAIRS = {f"{str(a).removeprefix('torch.')}-{str(b).removeprefix('torch.')}": (a, b)
         for a, b in _build.GEMM_PAIRS}
# every decode width of the repo's models: llama3.2-1b (512, 2048, 8192), qwen2
# (128, 896, 4864), zamba2-2.7b (2560, 10448), grok-1 (6144, 32768, its
# 131072 head), llama's 128256 vocab, and the tests' ragged 77 and 200
WIDTHS = (77, 128, 200, 512, 896, 2048, 2560, 4864, 6144, 8192, 10448, 32768, 128256,
          131072)


@pytest.mark.parametrize("gated", [False, True], ids=["plain", "swiglu"])
@pytest.mark.parametrize("pair", sorted(PAIRS))
@pytest.mark.parametrize("M", [1, 2, 7, 8, 13, 16])
def test_decode_tile_fits_the_card_and_the_loop(M, pair, gated):
    a_dt, b_dt = PAIRS[pair]
    ea, eb = a_dt.itemsize, b_dt.itemsize
    mats = 2 if gated else 1
    for N in WIDTHS:
        t = _build.decode_tile(M, N, a_dt, b_dt, gated=gated)
        slot = _build.decode_slot_bytes(M, t.bn, t.bk, ea, eb, gated)
        # the stages fit 227 KB, and the CTAs an SM holds at once fit its 228 KB
        resident = min(math.ceil(t.ctas / _build.SMS), 2)
        assert t.smem == t.stages * slot <= _build.SMEM_PER_CTA, (N, t)
        assert resident * (t.smem + 1024) <= _build.SMEM_PER_SM, (N, t)
        assert 4 <= t.stages <= _build.DECODE_MAX_STAGES, (N, t)
        # at least 32 KB of weight in flight per SM (the stages behind the one
        # being multiplied)
        assert (t.stages - 1) * t.bk * t.bn * eb * mats * resident >= 32 * 1024, (N, t)
        # no padding rows: one column per computing thread, tm rows dividing
        # M; the threads past those only issue copies
        assert M % t.tm == 0 and M // t.tm * t.bn <= t.threads <= _build.DECODE_MAX_THREADS
        assert t.threads == max(M // t.tm * t.bn, _build.DECODE_MIN_THREADS)
        # a staged weight row and an A step are whole 16-byte copies
        assert t.vec == 16 and t.bn * eb % t.vec == 0 and t.bk * ea % t.vec == 0
        assert t.bn & (t.bn - 1) == 0 and t.bn <= 64
        # whole 64-row MAC blocks (the baseline's 128-row round trips fall
        # on their ends)
        assert t.bk in (64, 128, 256, 512)
        # about one CTA per SM, unless the strip is already one copy wide
        assert t.ctas == math.ceil(N / t.bn)
        assert t.ctas >= 0.9 * _build.SMS or t.bn * eb == 16, (N, t)


@pytest.mark.parametrize("M", [0, 17, 64])
def test_decode_tile_takes_only_decode_rows(M):
    with pytest.raises(ValueError, match="M <= 16"):
        _build.decode_tile(M, 2048, torch.float32, torch.float32)


@pytest.mark.parametrize("offset", [0, 1, 2, 4, 8, 12, 16])
@pytest.mark.parametrize("row_bytes", [8192, 2048 * 2, 77 * 4, 77 * 2, 77, 300 * 2, 296,
                                       300, 10448 * 2, 0])
def test_copy_width_divides_the_row_and_the_address(row_bytes, offset):
    """The vector width divides the row bytes and the base address, or the
    narrow path (a smaller power of two, down to 1 byte) is chosen."""
    base = 0x7F0000000000 + offset
    v = _build.copy_width(row_bytes, base)
    assert v in (1, 2, 4, 8, 16)
    assert row_bytes % v == 0 and base % v == 0
    if v < 16:  # the next width would not divide one of them
        assert row_bytes % (2 * v) or base % (2 * v)


def test_copy_width_takes_every_address_of_an_operand():
    base = 0x7F0000000000
    assert _build.copy_width(8192, base, base + 16) == 16
    assert _build.copy_width(8192, base, base + 8) == 8
    assert _build.copy_width(8192, base + 4, base) == 4


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_decode_launch_tile_narrows_a_misaligned_view(dtype):
    """A contiguous view at a 4-byte offset takes 4-byte copies; the aligned
    weight keeps 16-byte ones, a gate weight 8 bytes off narrows both
    weights' copies to 8, and the tile is decode_tile's."""
    M, K, N = 8, 256, 96
    buf = torch.zeros(M * K + 16, dtype=dtype)
    a = buf[4 // buf.element_size():][:M * K].view(M, K)
    assert a.is_contiguous() and a.data_ptr() % 16 == 4
    b = torch.zeros((K, N), dtype=dtype)
    assert b.data_ptr() % 16 == 0
    bn, bk, tm, stages, threads, va, vb = decode_launch_tile(a, b)
    t = _build.decode_tile(M, N, dtype, dtype)
    assert (bn, bk, tm, stages, threads) == (t.bn, t.bk, t.tm, t.stages, t.threads)
    assert (va, vb) == (4, 16)
    gbuf = torch.zeros(K * N + 16, dtype=dtype)  # a gate weight 8 bytes off
    gate = gbuf[8 // gbuf.element_size():][:K * N].view(K, N)
    *_, vb_gated = decode_launch_tile(a, b, gate)
    assert vb_gated == 8


@pytest.mark.parametrize("M,tile", [
    (1, (16, 16, 128)), (8, (16, 16, 128)), (16, (16, 16, 128)), (17, (32, 64, 16)),
    (40, (32, 64, 16)), (64, (32, 64, 16)), (65, (64, 64, 16)), (256, (64, 64, 16)),
])
def test_gemm_tile_keeps_its_values(M, tile):
    """Every ABFT flag map, abft_rtol and the plain checksum tiling read
    these tiles (and the ABFT prefill launch its CTA tile at M > 16)."""
    assert _build.gemm_tile(M) == tile


# the decode widths of llama3.2-1b (512, 2048, 8192), qwen2-0.5b (128, 896,
# 4864), grok-1's attention (1024, 6144) and xlstm-125m (768, 1536, 3072)
VARIANT_WIDTHS = (128, 512, 768, 896, 1024, 1536, 2048, 3072, 4864, 6144, 8192)
VARIANT_CASES = [(v, pair) for v in ("sparse", "abft") for pair in sorted(PAIRS)
                 if v == "abft" or PAIRS[pair] in _build.SPARSE_PAIRS]


@pytest.mark.parametrize("gated", [False, True], ids=["plain", "swiglu"])
@pytest.mark.parametrize("variant,pair", VARIANT_CASES)
@pytest.mark.parametrize("M", [1, 8, 13, 16])
def test_decode_tile_of_the_2_4_and_abft_launches(M, variant, pair, gated):
    """The 2:4 and ABFT variants' decode tiles: a slot is
    `decode_slot_bytes` of the variant (the 2:4 payload's bk/2 rows and the
    metadata's bk/8), the ABFT scratch rides beside the ring, and both fit
    227 KB per CTA and the SM's 228 KB; an
    ABFT CTA owns whole 16-column flag tiles and keeps its checksums on
    warps of their own, a 2:4 step covers whole metadata bytes."""
    a_dt, b_dt = PAIRS[pair]
    ea, eb = a_dt.itemsize, b_dt.itemsize
    mats = 2 if gated else 1
    for N in VARIANT_WIDTHS:
        t = _build.decode_tile(M, N, a_dt, b_dt, gated, variant)
        slot = _build.decode_slot_bytes(M, t.bn, t.bk, ea, eb, gated, variant)
        extra = _build.decode_abft_bytes(M, t.bn, t.bk) if variant == "abft" else 0
        assert t.smem == t.stages * slot + extra == _build.decode_smem(
            M, t.bn, t.bk, ea, eb, t.stages, gated, variant) <= _build.SMEM_PER_CTA, (N, t)
        resident = min(math.ceil(t.ctas / _build.SMS), 2)
        assert resident * (t.smem + 1024) <= _build.SMEM_PER_SM, (N, t)
        assert 4 <= t.stages <= _build.DECODE_MAX_STAGES, (N, t)
        assert (t.tm, t.threads) == _build.decode_threads(M, t.bn, variant, gated, eb)
        assert M % t.tm == 0 and M // t.tm * t.bn <= t.threads <= _build.DECODE_MAX_THREADS
        assert t.bn & (t.bn - 1) == 0 and t.bn <= 64 and t.bn * eb % 16 == 0
        assert t.bk in (64, 128, 256, 512) and t.bk * ea % 16 == 0
        assert t.ctas == math.ceil(N / t.bn)
        if variant == "sparse":
            assert t.bk % 8 == 0 and slot == M * (t.bk * ea + 16) + mats * (
                t.bk // 2 * t.bn * eb + t.bk // 8 * t.bn)
            # one stage's payload and metadata stay within 32 KB of weight
            assert slot - M * (t.bk * ea + 16) <= _build.DECODE_STAGE_BYTES or t.bk == 64
        else:  # whole flag tiles, and the checksums' own warps past the computing ones
            hook0 = -(-(M // t.tm * t.bn) // 32) * 32
            assert t.bn % 16 == 0 and t.threads % 32 == 0
            assert t.threads - hook0 >= _build.ABFT_HOOK_THREADS
            assert slot == _build.decode_slot_bytes(M, t.bn, t.bk, ea, eb, gated)


def test_the_dense_decode_tile_is_the_variant_default():
    for M, N in ((1, 2048), (8, 512), (16, 8192)):
        for a_dt, b_dt in _build.GEMM_PAIRS:
            assert _build.decode_tile(M, N, a_dt, b_dt, True) == _build.decode_tile(
                M, N, a_dt, b_dt, True, "dense")
    with pytest.raises(ValueError, match="variant"):
        _build.decode_tile(8, 2048, torch.float32, torch.float32, variant="simt")


@pytest.mark.parametrize("variant", ["dense", "sparse", "abft"])
@pytest.mark.parametrize("M,N", [(8, 200), (1, 2048), (16, 77)])
def test_decode_height_launches_take_the_decode_tile(monkeypatch, M, N, variant):
    """The CUDA branch of mx_matmul_fused at M <= 16, its C entry replaced by
    a recorder: every variant reaches its decode-tile launcher
    (mx_matmul_decode_launch, mx_matmul_sparse_launch,
    mx_matmul_abft_launch) with decode_launch_tile's arguments (and the
    metadata's copy width for 2:4), counts one decode-tile launch, and the
    ABFT flag map stays gemm_tile's (1, ceil(N / 16))."""
    from repro_torch.kernels.abft import make_abft_spec
    from repro_torch.kernels.sparse import compress_24, prune_24

    K = 296
    calls = []

    def function(source, symbol, argtypes):
        def fn(*args):
            assert len(args) == len(argtypes)
            calls.append((source, symbol, args))
            return 0
        return fn

    monkeypatch.setattr(_build, "function", function)
    monkeypatch.setattr(_build, "stream_ptr", lambda t: 0)
    gen = torch.Generator().manual_seed(M)
    a = torch.randn((M, K), generator=gen)
    w = torch.randn((K, N), generator=gen)
    wg = torch.randn((K, N), generator=gen)
    ep = mm.Epilogue(activation="swiglu")
    meta = gmeta = abft = None
    if variant == "sparse":
        (w, meta), (wg, gmeta) = compress_24(prune_24(w)), compress_24(prune_24(wg))
    if variant == "abft":
        abft = make_abft_spec(a.dtype, w.dtype, K, 16, 16)
    mm.mx_matmul_fused.decode_launches = 0
    got = mm._launch_fused(a, w, ep, wg, None, None, None, None, None, torch.float32,
                           meta, gmeta, abft)
    source, symbol, args = calls[0]
    assert (source, symbol) == mm._LAUNCHERS["decode" if variant == "dense" else variant][:2]
    want = decode_launch_tile(a, w, wg, meta, gmeta, variant)
    assert len(want) == (8 if variant == "sparse" else 7)
    first = 22 if variant == "sparse" else 20  # the tile follows the operands and _EPI
    assert tuple(args[first:first + len(want)]) == want
    assert mm.fused_route(M, N, K, a.dtype, w.dtype, True, variant) == "decode"
    assert mm.mx_matmul_fused.decode_launches == 1
    if variant == "abft":
        assert tuple(got[1].shape) == (1, -(-N // 16))
        t = _build.decode_tile(M, N, a.dtype, w.dtype, True, "abft")
        assert want[0] == t.bn and t.bn % 16 == 0
