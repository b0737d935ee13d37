"""The SSD scan's launch table on the CPU: `kernels/_build.ssd_tile` (the
chunk slots, threads and shared memory that `csrc/ssd_scan.cu` launches
with) and `ssd_p_tiles` (the compile-time count of P's n8 tiles the kernel
is instantiated for).

The kernel runs only on the card (`tests/test_torch_cuda.py`): here the
table is held against the limits of an H100 -- 232,448 bytes of shared
memory per CTA, 65,536 registers per SM -- and against the kernel's own
constraints: chunk, P and S at most 128, 8 warps of 16 chunk rows each, two
chunk slots (the next chunk's copies in flight) wherever they fit, and a
refusal only where one slot alone is past the card.
"""
import pytest

torch = pytest.importorskip("torch")

from repro_torch.kernels import _build  # noqa: E402
from repro_torch.kernels.ssd_scan import ssd_scan  # noqa: E402

REGISTERS_PER_SM = 65536
MAX_REGISTERS = 255  # a thread's, the most the compiler can give it
SIZES = (1, 4, 8, 12, 16, 20, 24, 33, 40, 64, 65, 100, 128)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["float32", "bfloat16"])
@pytest.mark.parametrize("Q", [1, 16, 20, 33, 64, 100, 128])
def test_ssd_tile_fits_the_card(dtype, Q):
    for P in SIZES:
        for S in SIZES:
            one = _build.ssd_smem(Q, P, S, dtype.itemsize, 1)
            if one > _build.SMEM_PER_CTA:
                with pytest.raises(ValueError, match="232448"):
                    _build.ssd_tile(Q, P, S, dtype)
                continue
            t = _build.ssd_tile(Q, P, S, dtype)
            what = (Q, P, S, t)
            assert t.smem == _build.ssd_smem(Q, P, S, dtype.itemsize, t.stages) <= \
                _build.SMEM_PER_CTA, what
            two = _build.ssd_smem(Q, P, S, dtype.itemsize, 2)
            assert t.stages == (2 if two <= _build.SMEM_PER_CTA else 1), what
            assert t.threads == 32 * _build.SSD_WARPS == 256, what
            assert 16 * _build.SSD_WARPS >= Q, what  # a warp per 16 rows of the chunk
            assert t.threads * MAX_REGISTERS <= REGISTERS_PER_SM, what


@pytest.mark.parametrize("P", [1, 7, 8, 9, 16, 24, 33, 64, 65, 80, 128])
def test_ssd_p_tiles_cover_p_in_a_power_of_two(P):
    n = _build.ssd_p_tiles(P)
    assert n & (n - 1) == 0 and 8 * n >= P and (n == 1 or 4 * n < P)
    assert n <= 16


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["float32", "bfloat16"])
def test_zamba2_head_keeps_the_next_chunk_in_flight(dtype):
    """zamba2-2.7b's Mamba2 heads (chunk 128, P = S = 64): two chunk slots,
    one CTA of 8 warps on an SM (f32 229,888 bytes)."""
    t = _build.ssd_tile(128, 64, 64, dtype)
    assert t.stages == 2 and t.threads == 256
    assert t.smem == {torch.float32: 229888, torch.bfloat16: 131584}[dtype]


@pytest.mark.parametrize("chunk,P,S", [(129, 64, 64), (64, 129, 64), (64, 64, 129), (0, 8, 4)])
def test_ssd_tile_refuses_past_128(chunk, P, S):
    with pytest.raises(ValueError, match="at most 128"):
        _build.ssd_tile(chunk, P, S, torch.float32)


def test_ssd_scan_on_the_cpu_counts_no_launch():
    """On CPU tensors the wrapper runs the plain version and counts nothing."""
    g = torch.Generator().manual_seed(0)
    x = torch.randn((1, 20, 2, 8), generator=g)
    a = -torch.rand((1, 20, 2), generator=g)
    b = torch.randn((1, 20, 1, 4), generator=g)
    before = ssd_scan.launches
    y = ssd_scan(x, a, b, b.clone(), chunk=16)
    assert y.shape == x.shape and ssd_scan.launches == before
