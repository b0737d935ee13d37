"""The dense GEMMs' decode tile rule on the CPU: `kernels/_build.decode_tile`
(the CTA shape, ring depth and copy width that `csrc/mx_matmul.cu` and
`csrc/baseline_matmul.cu` launch at M <= 16), `copy_width` (the narrow
copies for ragged and misaligned rows) and `gemm_tile`, which the 2:4 and
ABFT variants, the prefill tiles and every ABFT flag map keep reading.

The kernels themselves run only on the card (`tests/test_torch_cuda.py`):
here the tile's arithmetic is held against the limits of an H100 -- 227 KB
of shared memory per CTA, 228 KB per SM, 512 threads -- and against the
loop's own constraints (csrc/decode_tile.cuh `decode_check`).
"""
import math

import pytest

torch = pytest.importorskip("torch")

from repro_torch.kernels import _build  # noqa: E402
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
    """The 2:4 and ABFT variants launch these tiles at every M (and the dense
    kernels at M > 16); every ABFT flag map, abft_rtol and the plain
    checksum tiling read them."""
    assert _build.gemm_tile(M) == tile
