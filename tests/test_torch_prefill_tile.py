"""The GEMMs' prefill tile rule on the CPU: `kernels/_build.prefill_tile` (the
CTA tile, ring depth, K parts and cluster split that `csrc/mx_matmul.cu`,
its 2:4 and ABFT variants and `csrc/baseline_matmul.cu` launch at M > 16)
and `prefill_parts`, beside `gemm_tile`, which every ABFT flag map keeps
reading.

The kernels themselves run only on the card (`tests/test_torch_cuda.py`):
here the tile's arithmetic is held against the limits of an H100 -- 227 KB
of shared memory per CTA, 228 KB per SM, 65,536 registers per SM, a
portable cluster of 8 -- and against the loop's own constraints
(csrc/prefill_tile.cuh `prefill_check`): the parts divide the K steps and
depend on K alone, the split is 1 or the parts, and the CTA tile is a whole
multiple of gemm_tile's.
"""
import math

import pytest

torch = pytest.importorskip("torch")

from repro_torch.core import ops  # noqa: E402
from repro_torch.kernels import _build  # noqa: E402
from repro_torch.kernels import abft as ab  # noqa: E402
from repro_torch.kernels import mx_matmul as mm  # noqa: E402
from repro_torch.kernels.mx_matmul import fused_route, prefill_launch_tile  # noqa: E402

PAIRS = {f"{str(a).removeprefix('torch.')}-{str(b).removeprefix('torch.')}": (a, b)
         for a, b in _build.GEMM_PAIRS}
# the widths of tests/test_torch_decode_tile.py: every width of the repo's
# models and the tests' ragged 77 and 200, each as N and as K
WIDTHS = (77, 128, 200, 512, 896, 2048, 2560, 4864, 6144, 8192, 10448, 32768, 128256,
          131072)
ROWS = (17, 40, 64, 65, 256, 2048)
REGISTERS_PER_SM = 65536
MAX_CLUSTER = 8


@pytest.mark.parametrize("variant", _build.PREFILL_VARIANTS)
@pytest.mark.parametrize("pair", sorted(PAIRS))
@pytest.mark.parametrize("M", ROWS)
def test_prefill_tile_fits_the_card_and_the_loop(M, pair, variant):
    a_dt, b_dt = PAIRS[pair]
    gm, gn, _ = _build.gemm_tile(M)
    for gated in ((False,) if variant == "baseline" else (False, True)):
        for N in WIDTHS:
            for K in WIDTHS:
                t = _build.prefill_tile(M, N, K, a_dt, b_dt, gated, variant)
                what = (N, K, gated, t)
                # each flag tile lies in one CTA (the ABFT variant's CTA is one)
                assert t.bm % gm == 0 and t.bn % gn == 0, what
                if variant == "abft":
                    assert (t.bm, t.bn) == (gm, gn), what
                assert t.ctas == math.ceil(M / t.bm) * math.ceil(N / t.bn) * t.split, what
                # every pair on the tensor cores (int8 x int8, fp8 x fp8 on the
                # 8-bit route), none on gemm_tile.cuh's loop any more
                assert (a_dt, b_dt) in _build.MMA_PAIRS and t.route == "mma", what
                assert (t.bm, t.bn, t.bk) != _build.gemm_tile(M) or variant == "abft", what
                assert (t.bm, t.bn) in _build.PREFILL_TILES, what
                # shared memory of at most 227 KB per CTA (the ABFT variant's
                # checksums take static shared memory beside it)
                reserve = _build.prefill_abft_static(t.bk) if variant == "abft" else 0
                assert t.smem + reserve <= _build.SMEM_PER_CTA, what
                # threads: 2 x bn / 32 warps, and 255 registers for each fit an SM
                assert t.threads == 2 * t.bn and t.threads % 32 == 0, what
                assert t.threads * 255 <= REGISTERS_PER_SM, what
                # a ring of at least 3 slots (2 only where nothing larger fits)
                assert 3 <= t.stages <= _build.PREFILL_MAX_STAGES, what
                assert t.bk * a_dt.itemsize == _build.PREFILL_STAGE_ROW, what
                # the parts divide the K steps; the split is 1 or the parts,
                # a portable cluster
                steps = math.ceil(K / t.bk)
                assert steps % t.parts == 0 and t.parts <= _build.PREFILL_MAX_PARTS, what
                assert t.parts & (t.parts - 1) == 0, what
                assert t.split in (1, t.parts) and t.split <= MAX_CLUSTER, what
                assert t.bm % t.split == 0, what  # each rank stores bm / split rows
                if variant in ("abft", "baseline"):
                    assert t.split == 1, what
                # the smem the C side computes (prefill_smem)
                assert t.smem == _build.prefill_smem(
                    t.bm, t.bn, t.bk, a_dt.itemsize, b_dt.itemsize, t.stages, t.split,
                    t.parts, gated, variant == "sparse", epilogue=variant != "baseline"), what


@pytest.mark.parametrize("a_dt,b_dt", _build.MMA_PAIRS,
                         ids=["f32", "bf16", "bf16-int8", "bf16-fp8", "int8", "fp8"])
def test_prefill_parts_depend_on_k_alone(a_dt, b_dt):
    """Every launch at one K -- dense, 2:4, ABFT, any M, N or CTA tile --
    cuts K into the same parts, so they all sum in one order and give the
    same bits (a recomputed ABFT tile too)."""
    for K in WIDTHS + (300, 296, 517, 1024, 5120, 10240):
        want = _build.prefill_parts(K, 128 // a_dt.itemsize)
        seen = {_build.prefill_tile(M, N, K, a_dt, b_dt, gated, variant).parts
                for M in ROWS for N in (64, 77, 2048, 131072) for gated in (False, True)
                for variant in ("dense", "sparse", "abft")}
        assert seen == {want}, K
        assert want * _build.PREFILL_PART_ROWS <= K or want == 1


@pytest.mark.parametrize("K,parts", [(300, 1), (896, 1), (1024, 2), (2048, 4), (2560, 4),
                                     (4864, 8), (5120, 8), (8192, 8), (32768, 8)])
def test_prefill_parts_values_f32(K, parts):
    assert _build.prefill_parts(K, 32) == parts


@pytest.mark.parametrize("M,N,K,tile,split", [
    (64, 2048, 8192, (64, 64), 8),    # llama's down projection: 32 tiles x 8 parts
    (64, 2048, 2048, (64, 64), 4),    # q / wo: 32 tiles x 4 parts
    (40, 512, 2048, (64, 64), 4),     # a verify step's k / v: 8 tiles x 4 parts
    (17, 2048, 8192, (32, 64), 8),    # M <= 32: half-height tiles
    (256, 2048, 8192, (64, 64), 8),   # 128 tiles: still split
    (256, 8192, 2048, (64, 128), 1),  # 512 small tiles: the wide tile, one CTA each
    (2048, 10448, 2560, (64, 128), 1),  # zamba2's in_proj at M = 2048: one CTA per tile
])
def test_prefill_tile_fills_the_card(M, N, K, tile, split):
    """Small grids split K across a cluster, large ones take the wide tile
    (the thresholds timed on an H100, PERF.md section 6)."""
    t = _build.prefill_tile(M, N, K, torch.float32, torch.float32)
    assert (t.bm, t.bn) == tile and t.split == split


@pytest.mark.parametrize("M", [0, 1, 8, 16])
def test_prefill_tile_takes_only_prefill_rows(M):
    with pytest.raises(ValueError, match="M > 16"):
        _build.prefill_tile(M, 2048, 2048, torch.float32, torch.float32)


def test_prefill_tile_refuses_an_unknown_variant():
    with pytest.raises(ValueError, match="variant"):
        _build.prefill_tile(64, 2048, 2048, torch.float32, torch.float32, variant="grouped")


@pytest.mark.parametrize("M", ROWS)
def test_baseline_keeps_one_cta_per_tile(M):
    """The baseline's partials go to the output, so it splits nothing: the
    MX kernel's tile where that fills the card, else a smaller one."""
    for N, K in ((2048, 8192), (8192, 2048), (96, 517), (10448, 2560)):
        for dt in (torch.float32, torch.bfloat16):
            mx = _build.prefill_tile(M, N, K, dt, dt)
            base = _build.prefill_tile(M, N, K, dt, dt, variant="baseline")
            assert base.split == base.parts == 1 and base.bk == mx.bk
            assert base.ctas >= min(mx.ctas, 0.9 * _build.SMS) or (base.bm, base.bn) == (
                _build.gemm_tile(M)[:2])
            if mx.split == 1 and mx.ctas >= 0.9 * _build.SMS:
                assert (base.bm, base.bn) == (mx.bm, mx.bn)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_prefill_launch_tile_narrows_a_misaligned_view(dtype):
    """A contiguous view at a 4-byte offset takes 4-byte copies, a ragged
    N narrower ones, and the tile is prefill_tile's."""
    M, K, N = 40, 256, 96
    buf = torch.zeros(M * K + 16, dtype=dtype)
    a = buf[4 // buf.element_size():][:M * K].view(M, K)
    assert a.is_contiguous() and a.data_ptr() % 16 == 4
    b = torch.zeros((K, N), dtype=dtype)
    bm, bn, stages, split, parts, va, vb, vm = prefill_launch_tile(a, b)
    t = _build.prefill_tile(M, N, K, dtype, dtype)
    assert (bm, bn, stages, split, parts) == (t.bm, t.bn, t.stages, t.split, t.parts)
    assert (va, vb, vm) == (4, 16, 16)
    ragged = torch.zeros((K, 77), dtype=dtype)
    assert prefill_launch_tile(a, ragged)[6] == (4 if dtype == torch.float32 else 2)


def test_prefill_launch_tile_of_a_sparse_weight_reads_the_metadata_width():
    M, K, N = 64, 256, 100
    a = torch.zeros((M, K))
    payload = torch.zeros((K // 2, N))
    meta = torch.zeros((K // 8, N), dtype=torch.uint8)
    *_, vb, vm = prefill_launch_tile(a, payload, b_meta=meta, variant="sparse")
    assert vb == 16 and vm == 4  # 100 bytes of metadata per row


@pytest.mark.parametrize("M,tile", [
    (1, (16, 16, 128)), (8, (16, 16, 128)), (16, (16, 16, 128)), (17, (32, 64, 16)),
    (40, (32, 64, 16)), (64, (32, 64, 16)), (65, (64, 64, 16)), (256, (64, 64, 16)),
    (2048, (64, 64, 16)),
])
def test_gemm_tile_is_unchanged(M, tile):
    """gemm_tile keeps its values and meaning: the ABFT flag grid, the fault
    grid, abft_rtol's tile and the plain ABFT tiling."""
    assert _build.gemm_tile(M) == tile


@pytest.mark.parametrize("variant", ["dense", "sparse", "abft"])
@pytest.mark.parametrize("pair", sorted(PAIRS))
@pytest.mark.parametrize("M", (1, 8, 16, *ROWS))
def test_fused_route_by_rows_pair_and_variant(M, pair, variant):
    """The one place the fused GEMM's K loop is chosen: the decode rows of
    every variant take the decode tile; above 16 rows every pair takes the
    tensor cores (int8 x int8 and fp8 x fp8 in their own byte)."""
    a_dt, b_dt = PAIRS[pair]
    route = fused_route(M, 2048, 8192, a_dt, b_dt, False, variant)
    if M <= _build.DECODE_MAX_M:
        assert route == "decode"
    else:
        assert (a_dt, b_dt) in _build.MMA_PAIRS and route == "mma"


@pytest.mark.parametrize("M", [1, 8, 16])
def test_a_recomputed_abft_tile_of_few_rows_takes_the_tile_of_17_rows(M):
    """A last row tile of <= 16 rows recomputed on the tensor cores runs
    the CTA tile of M = 17 (gemm_tile's 32 x 64), its rows zero filled."""
    K, N = 2048, 64
    a, b = torch.zeros((M, K)), torch.zeros((K, N))
    t = _build.prefill_tile(17, N, K, torch.float32, torch.float32, variant="abft")
    bm, bn, stages, split, parts, *_ = prefill_launch_tile(a, b, variant="abft")
    assert (bm, bn, stages, split, parts) == (t.bm, t.bn, t.stages, t.split, t.parts)
    assert (bm, bn) == _build.gemm_tile(17)[:2] and split == 1


@pytest.mark.parametrize("M,dtype,want", [
    (40, torch.float32, "mma"), (65, torch.float32, "mma"), (40, torch.bfloat16, "mma"),
    (65, torch.int8, "mma"), (8, torch.float32, "decode"),
])
def test_fused_recovery_recomputes_on_the_route_of_the_launch(monkeypatch, M, dtype, want):
    """A fault in the LAST row tile (8 rows at M = 40, 1 at M = 65) is
    recomputed on the route of the launch it recovers, not on the route
    its own few rows would pick, so the recovered bits are that launch's
    (on the card; `test_torch_cuda.py::test_prefill_abft_bitwise_flags_and_recovery`)."""
    K, N = 96, 200
    gen = torch.Generator().manual_seed(M)
    if dtype == torch.int8:
        x = torch.randint(-8, 8, (M, K), generator=gen, dtype=torch.int8)
        w = torch.randint(-8, 8, (K, N), generator=gen, dtype=torch.int8)
        out_dtype = torch.int32
    else:
        x = torch.randn((M, K), generator=gen).to(dtype)
        w = torch.randn((K, N), generator=gen).to(dtype)
        out_dtype = torch.float32
    routes = []

    def spy(route, *args, **kw):
        routes.append(route)
        return mm.recompute_fused(route, *args, **kw)

    monkeypatch.setattr(ops, "recompute_fused", spy)
    bm, bn, _ = _build.gemm_tile(M)
    last = (-(-M // bm) - 1, -(-N // bn) - 1)
    kw = dict(ep=mm.Epilogue(), bias=None, residual=None, w_gate=None, a_s=None, b_s=None,
              bg_s=None, out_dtype=out_dtype)
    ab.reset_abft_stats()
    clean = ops._abft_fused_gemm(x, w, cfg=ab.AbftConfig(), **kw)
    fault = ab.TileFault(*last, 0, 3, 1.0 if dtype == torch.int8 else 2.0 ** 16)
    got = ops._abft_fused_gemm(x, w, cfg=ab.AbftConfig(fault=fault), **kw)
    assert routes == [want]
    assert ab.abft_stats()["tiles_recovered"] == 1
    assert torch.equal(got, clean)


def test_int8_launches_refuse_a_k_past_the_exact_int32_sums():
    """int8 x int8 sums in int32 (|sum| <= K * 127^2 < 2^31 for K < 133,143):
    both GEMM wrappers refuse a longer K before any launch is built; the
    other pairs sum in f32 and take any K."""
    assert _build.INT8_MAX_K * 127 ** 2 < 2 ** 31
    _build.check_int8_k(torch.int8, torch.int8, _build.INT8_MAX_K, "k")
    with pytest.raises(ValueError, match="int32"):
        _build.check_int8_k(torch.int8, torch.int8, _build.INT8_MAX_K + 1, "k")
    for dt in (torch.float8_e4m3fn, torch.bfloat16):
        _build.check_int8_k(dt, dt, 10 ** 6, "k")
