"""The grouped GEMM's tile rule on the CPU: `kernels/_build.grouped_tile` (the
route, CTA tile, ring depth, K parts and cluster split that
`csrc/mx_grouped_matmul*.cu` launch), `grouped_flag_tile` (the ABFT flag
map's grid) and `mx_matmul.grouped_route`, the one place the grouped K loop
is chosen.

The kernels themselves run only on the card (`tests/test_torch_cuda.py`):
here the table is held against the limits of an H100 -- 227 KB of shared
memory per CTA, 65,536 registers per SM, a portable cluster of 8 -- and
against the loop's own constraints (csrc/prefill_tile.cuh `prefill_check`):
the parts divide the K steps and are the fused prefill tile's for the same
K and pair (so the ABFT recovery, which recomputes a flagged tile on the
fused GEMM, gets the grouped launch's bits), the split is 1 or the parts,
and the ABFT launch's CTA tile is the flag map's.
"""
import math

import pytest

torch = pytest.importorskip("torch")

from repro_torch.core import ops  # noqa: E402
from repro_torch.kernels import _build  # noqa: E402
from repro_torch.kernels import abft as ab  # noqa: E402
from repro_torch.kernels import mx_matmul as mm  # noqa: E402
from repro_torch.kernels.mx_grouped_matmul import launch_tile  # noqa: E402
from repro_torch.kernels.mx_matmul import grouped_route  # noqa: E402

PAIRS = {f"{str(a).removeprefix('torch.')}-{str(b).removeprefix('torch.')}": (a, b)
         for a, b in _build.GEMM_PAIRS}
# (T, G): grok's decode (8 x 8) and prefill chunk (8 x 128), kimi-k2's 384
# experts at decode, the tests' ragged 70 rows, the regimes' edges
SHAPES = ((64, 8), (1024, 8), (3072, 384), (70, 8), (70, 20), (72, 9), (64, 1), (520, 8),
          (1, 1), (40, 3))
WIDTHS = (77, 200, 300, 2048, 2050, 6100, 6144, 7168, 32768)
REGISTERS_PER_SM = 65536
MAX_CLUSTER = 8


@pytest.mark.parametrize("variant", ["dense", "sparse", "abft"])
@pytest.mark.parametrize("pair", sorted(PAIRS))
def test_grouped_tile_fits_the_card_and_the_loop(pair, variant):
    a_dt, b_dt = PAIRS[pair]
    if variant == "sparse" and (a_dt, b_dt) not in _build.SPARSE_PAIRS:
        pytest.skip("no 2:4 kernel for this pair")
    for T, G in SHAPES:
        flag = _build.grouped_flag_tile(T, G, a_dt, b_dt)
        for gated in (False, True):
            for N in WIDTHS:
                for K in WIDTHS:
                    t = _build.grouped_tile(T, N, K, G, a_dt, b_dt, gated, variant)
                    what = (T, G, N, K, gated, t)
                    assert t.ctas == math.ceil(T / t.bm) * math.ceil(N / t.bn) * t.split, what
                    # every pair on the tensor cores (int8 x int8, fp8 x fp8 on
                    # the 8-bit route), none on gemm_tile.cuh's loop any more
                    assert (a_dt, b_dt) in _build.MMA_PAIRS and t.route == "mma", what
                    if variant == "abft":  # one CTA per flag
                        assert (t.bm, t.bn) == flag and t.split == 1, what
                        assert flag in _build.GROUPED_ABFT_TILES, what
                    else:  # the same rows per tile as the flag map
                        assert (t.bm, t.bn) in _build.GROUPED_TILES, what
                        assert t.bm == flag[0], what
                    # shared memory of at most 227 KB per CTA, the ABFT
                    # checksums' static shared memory beside it
                    reserve = _build.prefill_abft_static(t.bk) if variant == "abft" else 0
                    assert t.smem + reserve <= _build.SMEM_PER_CTA, what
                    assert t.smem == _build.prefill_smem(
                        t.bm, t.bn, t.bk, a_dt.itemsize, b_dt.itemsize, t.stages, t.split,
                        t.parts, gated, variant == "sparse"), what
                    # warps of 16 x 32 (bm = 16) or (bm / 2) x 32 outputs
                    assert t.threads == (1 if t.bm == 16 else 2) * t.bn, what
                    assert t.threads * 255 <= REGISTERS_PER_SM, what
                    assert 2 <= t.stages <= max(*_build.GROUPED_STAGES, _build.GROUPED_DEEP_STAGES), what
                    assert t.bk * a_dt.itemsize == _build.PREFILL_STAGE_ROW, what
                    steps = math.ceil(K / t.bk)
                    assert steps % t.parts == 0 and t.parts <= MAX_CLUSTER, what
                    assert t.split in (1, t.parts) and t.bm % t.split == 0, what


@pytest.mark.parametrize("a_dt,b_dt", _build.MMA_PAIRS,
                         ids=["f32", "bf16", "bf16-int8", "bf16-fp8", "int8", "fp8"])
def test_grouped_parts_are_the_fused_prefill_tiles(a_dt, b_dt):
    """A grouped launch cuts K into the parts the fused GEMM's prefill tile
    cuts it into for the same K and pair, at every T, G, N and variant, so
    a flagged grouped tile recomputed on the fused GEMM ("mma") sums the
    same parts in the same order."""
    for K in WIDTHS + (296, 512, 4096, 8192):
        fused = {_build.prefill_tile(M, 2048, K, a_dt, b_dt, False, v).parts
                 for M in (17, 64, 2048) for v in ("dense", "abft")}
        grouped = {_build.grouped_tile(T, N, K, G, a_dt, b_dt, gated, v).parts
                   for T, G in SHAPES for N in (77, 6144) for gated in (False, True)
                   for v in ("dense", "abft")}
        assert grouped == fused == {_build.prefill_parts(K, 128 // a_dt.itemsize)}, K


@pytest.mark.parametrize("pair", sorted(PAIRS))
def test_grouped_route_by_pair(pair):
    """The one place the grouped K loop is chosen: the tensor cores for
    every pair at every regime and variant (int8 x int8 and e4m3 x e4m3 on
    the 8-bit route)."""
    a_dt, b_dt = PAIRS[pair]
    assert (a_dt, b_dt) in _build.MMA_PAIRS
    want = "mma"
    for T, G in SHAPES:
        for variant in ("dense", "abft") + (("sparse",) if (a_dt, b_dt) in
                                            _build.SPARSE_PAIRS else ()):
            assert grouped_route(T, 6144, 32768, G, a_dt, b_dt, False, variant) == want


@pytest.mark.parametrize("T,G,bm", [
    (64, 8, 16), (70, 20, 16), (72, 9, 16), (70, 8, 16), (72, 8, 32), (40, 3, 32),
    (512, 8, 32), (520, 8, 64), (1024, 8, 64), (3072, 384, 16), (64, 1, 32), (1, 1, 16),
])
def test_grouped_rows_follow_the_mean_rows_per_group(T, G, bm):
    """16-row tiles at decode height (<= 8 rows per group: a tile covers two
    of an MoE's 8-row capacity groups, each expert read once), 32 up to 64,
    64 above; the flag map's tiles are the same for the 8-bit pairs."""
    for a_dt, b_dt in _build.MMA_PAIRS:
        assert _build.grouped_tile(T, 2048, 4096, G, a_dt, b_dt).bm == bm
        assert _build.grouped_flag_tile(T, G, a_dt, b_dt) == (bm, 64)
    assert _build.grouped_flag_tile(T, G, torch.int8, torch.int8) == (bm, 64)


@pytest.mark.parametrize("label,T,G,K,N,gated,tile", [
    ("grok decode down", 64, 8, 32768, 6144, False, (16, 128, 8)),
    ("grok decode up+gate", 64, 8, 6144, 32768, True, (16, 128, 8)),
    ("grok prefill down", 1024, 8, 32768, 6144, False, (64, 64, 1)),
    ("kimi decode", 3072, 384, 7168, 2048, False, (16, 128, 1)),
])
def test_grouped_tile_at_the_models_widths(label, T, G, K, N, gated, tile):
    """The f32 tiles of grok-1's and kimi-k2's expert GEMMs, 8 K parts each:
    grok's decode-height grids (192 and 1024 tiles of 16 x 128) split K
    across clusters, kimi-k2's 384 experts (3072 tiles) and grok's prefill
    chunk (64 x 64 tiles without a gate) run one CTA per tile."""
    t = _build.grouped_tile(T, N, K, G, torch.float32, torch.float32, gated)
    assert (t.bm, t.bn, t.split) == tile and t.parts == 8, t


@pytest.mark.parametrize("T,G,K,N,gated", [
    (70, 8, 6100, 2050, True), (70, 2, 6100, 2050, False), (200, 3, 6100, 2050, False),
    (70, 20, 300, 77, False),
])
def test_grouped_small_grids_take_a_deep_ring(T, G, K, N, gated):
    """A grid of at most one CTA per SM (f32 at K = 6100: one K part, no
    split) keeps its ring's copies in flight alone, so it takes the deepest
    ring that fits (up to GROUPED_DEEP_STAGES); larger grids keep
    GROUPED_STAGES."""
    t = _build.grouped_tile(T, N, K, G, torch.float32, torch.float32, gated)
    assert t.ctas <= _build.SMS and t.split == 1, t
    assert t.stages > max(_build.GROUPED_STAGES), t
    big = _build.grouped_tile(64, 6144, 32768, 8, torch.float32, torch.float32)
    assert big.ctas > _build.SMS and big.stages == _build.GROUPED_STAGES[0], big


def test_grouped_tile_refuses_an_unknown_variant():
    with pytest.raises(ValueError, match="variant"):
        _build.grouped_tile(64, 2048, 2048, 8, torch.float32, torch.float32,
                            variant="baseline")


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_grouped_launch_tile_narrows_a_misaligned_view(dtype):
    """A contiguous x at a 4-byte offset takes 4-byte copies, a ragged N
    narrower ones; the tile is grouped_tile's."""
    T, K, N, G = 64, 256, 96, 8
    buf = torch.zeros(T * K + 16, dtype=dtype)
    x = buf[4 // buf.element_size():][:T * K].view(T, K)
    assert x.is_contiguous() and x.data_ptr() % 16 == 4
    w = torch.zeros((G, K, N), dtype=dtype)
    route, tile = launch_tile(x, w)
    t = _build.grouped_tile(T, N, K, G, dtype, dtype)
    assert route == "mma" and tile[:5] == (t.bm, t.bn, t.stages, t.split, t.parts)
    assert tile[5:] == (4, 16, 16)
    ragged = torch.zeros((G, K, 77), dtype=dtype)
    assert launch_tile(x, ragged)[1][6] == (4 if dtype == torch.float32 else 2)
    meta = torch.zeros((G, K // 8, 100), dtype=torch.uint8)
    payload = torch.zeros((G, K // 2, 100), dtype=dtype)
    assert launch_tile(x, payload, w_meta=meta, variant="sparse")[1][7] == 4
    q = torch.zeros((G, K, N), dtype=torch.int8)  # int8 x int8: the 8-bit route
    x8 = torch.zeros(T * K + 16, dtype=torch.int8)[4:][:T * K].view(T, K)
    t8 = _build.grouped_tile(T, N, K, G, torch.int8, torch.int8)
    assert launch_tile(x8, q) == (
        "mma", (t8.bm, t8.bn, t8.stages, t8.split, t8.parts, 4, 16, 16))


@pytest.mark.parametrize("dtype,want", [
    (torch.float32, "mma"), (torch.bfloat16, "mma"), (torch.int8, "mma"),
])
@pytest.mark.parametrize("sizes", [[8] * 8, [0, 13, 0, 0, 40, 3, 0, 7]])
def test_grouped_recovery_recomputes_on_the_grouped_route(monkeypatch, sizes, dtype, want):
    """A flagged grouped tile is recomputed per overlapping expert on
    `grouped_route`'s loop ("mma" for every pair), so the recovered rows are
    the grouped launch's bits on the card
    (`test_torch_cuda.py::test_abft_grouped_recovery_at_decode_height_is_bitwise`)."""
    T, K, N, G = sum(sizes) + 6, 96, 200, len(sizes)
    gen = torch.Generator().manual_seed(T)
    if dtype == torch.int8:
        x = torch.randint(-8, 8, (T, K), generator=gen, dtype=torch.int8)
        w = torch.randint(-8, 8, (G, K, N), generator=gen, dtype=torch.int8)
        out_dtype = torch.int32
    else:
        x = torch.randn((T, K), generator=gen).to(dtype)
        w = torch.randn((G, K, N), generator=gen).to(dtype)
        out_dtype = torch.float32
    routes = []

    def spy(route, *args, **kw):
        routes.append(route)
        return mm.recompute_fused(route, *args, **kw)

    monkeypatch.setattr(ops, "recompute_fused", spy)
    gs = torch.tensor(sizes, dtype=torch.int32)
    kw = dict(activation="none", w_gate=None, a_s=None, b_s=None, bg_s=None,
              out_dtype=out_dtype)
    ab.reset_abft_stats()
    clean = ops._abft_grouped_gemm(x, w, gs, cfg=ab.AbftConfig(), **kw)
    fault = ab.TileFault(0, 1, 2, 3, 1.0 if dtype == torch.int8 else 2.0 ** 16)
    got = ops._abft_grouped_gemm(x, w, gs, cfg=ab.AbftConfig(fault=fault), **kw)
    assert routes and set(routes) == {want}
    assert ab.abft_stats()["tiles_recovered"] == 1
    assert torch.equal(got, clean)
