"""The Hopper tile pricer (`core/tiling.plan_matmul_tiles`) takes the tile
each launch already takes: over a sweep of shapes, operand pairs and
variants its tile, stages, split, parts and shared memory are
`kernels/_build.py`'s, its shared memory is what `prefill_smem` /
`decode_slot_bytes` give and fits `SMEM_PER_CTA`, and `prefill_parts` is
untouched.  No GPU needed."""
import itertools

import pytest

torch = pytest.importorskip("torch")

from repro_torch.core import tiling  # noqa: E402
from repro_torch.core.transfer_model import GemmProblem, HopperGemmTiling  # noqa: E402
from repro_torch.kernels import _build  # noqa: E402
from repro_torch.kernels import mx_matmul as mm  # noqa: E402

F32, BF16 = torch.float32, torch.bfloat16
SHAPES = [(1, 2048, 2048), (8, 512, 2048), (16, 8192, 2048), (8, 2048, 8192),
          (17, 200, 2056), (40, 2048, 8192), (64, 2048, 2048), (64, 8192, 2048),
          (256, 2048, 8192), (2048, 10448, 2560), (100, 70, 300)]  # (M, N, K)


def _cases():
    for (M, N, K), (a, b), gated in itertools.product(SHAPES, _build.GEMM_PAIRS,
                                                      (False, True)):
        for variant in ("dense", "sparse", "abft", "baseline"):
            if variant == "sparse" and (a, b) not in _build.SPARSE_PAIRS:
                continue
            if variant == "baseline" and (a != b or a not in _build.FLOATS or gated):
                continue
            yield M, N, K, a, b, gated, variant


CASES = list(_cases())


@pytest.mark.parametrize("M,N,K,a,b,gated,variant", CASES)
def test_pricer_takes_the_launch_tile(M, N, K, a, b, gated, variant):
    plan = tiling.plan_matmul_tiles(M, N, K, a, b, variant, gated=gated)
    assert plan.smem_bytes <= _build.SMEM_PER_CTA
    dense_decode = M <= _build.DECODE_MAX_M and variant in ("dense", "baseline")
    if dense_decode:
        t = _build.decode_tile(M, N, a, b, gated)
        assert (plan.route, plan.bm, plan.bn, plan.bk, plan.stages, plan.ctas, plan.smem_bytes) \
            == ("decode", M, t.bn, t.bk, t.stages, t.ctas, t.smem)
        assert plan.smem_bytes == t.stages * _build.decode_slot_bytes(
            M, t.bn, t.bk, a.itemsize, b.itemsize, gated)
        assert mm.fused_route(M, N, K, a, b, gated) == "decode" or variant == "baseline"
    elif M <= _build.DECODE_MAX_M:  # the 2:4 and ABFT rows: the decode tile of the variant
        t = _build.decode_tile(M, N, a, b, gated, variant)
        assert (plan.route, plan.bm, plan.bn, plan.bk, plan.stages, plan.ctas, plan.smem_bytes) \
            == ("decode", M, t.bn, t.bk, t.stages, t.ctas, t.smem)
        assert plan.smem_bytes == _build.decode_smem(
            M, t.bn, t.bk, a.itemsize, b.itemsize, t.stages, gated, variant)
        assert mm.fused_route(M, N, K, a, b, gated, variant) == "decode"
    else:
        t = _build.prefill_tile(M, N, K, a, b, gated, variant)
        assert (plan.route, plan.bm, plan.bn, plan.bk, plan.stages, plan.split, plan.parts,
                plan.ctas, plan.smem_bytes) == (t.route, t.bm, t.bn, t.bk, t.stages, t.split,
                                                t.parts, t.ctas, t.smem)
        if t.route == "mma":
            assert plan.smem_bytes == _build.prefill_smem(
                t.bm, t.bn, t.bk, a.itemsize, b.itemsize, t.stages, t.split, t.parts, gated,
                variant == "sparse", variant != "baseline")
            assert t.parts == (1 if variant == "baseline" else _build.prefill_parts(K, t.bk))
            gm, gn, _ = _build.gemm_tile(M)
            assert t.bm % gm == 0 and t.bn % gn == 0
    assert plan.flag_tile == (_build.gemm_tile(M)[:2] if variant == "abft" else None)
    assert plan.acc_bytes == (M if M <= _build.DECODE_MAX_M else plan.bm) * plan.bn * 4 * (
        1 + gated)
    # the HBM bytes are the transfer model's at that tile
    p = plan.problem
    assert (p.M, p.N, p.K, p.a_elem_bytes, p.b_elem_bytes, p.b_sparse) == (
        M, N, K, a.itemsize, b.itemsize, variant == "sparse")
    assert plan.hbm_bytes == plan.tiling.hbm_bytes(p)
    assert plan.tiling.accumulate_in_registers == (variant != "baseline")
    assert plan.tiling.bk == (tiling.BASELINE_BK if variant == "baseline" else plan.bk)


@pytest.mark.parametrize("T,G", [(64, 8), (1024, 8), (70, 8), (3072, 384), (128, 1)])
@pytest.mark.parametrize("pair,variant", [
    (pair, v) for pair in _build.GEMM_PAIRS for v in ("dense", "sparse", "abft")
    if v != "sparse" or pair in _build.SPARSE_PAIRS])
def test_pricer_takes_the_grouped_tile(T, G, pair, variant):
    a, b = pair
    for K, N, gated in ((6144, 32768, True), (32768, 6144, False), (7168, 2048, False)):
        plan = tiling.plan_matmul_tiles(T, N, K, a, b, variant, gated=gated, groups=G)
        t = _build.grouped_tile(T, N, K, G, a, b, gated, variant)
        assert (plan.route, plan.bm, plan.bn, plan.bk, plan.stages, plan.split, plan.parts,
                plan.ctas, plan.smem_bytes) == (t.route, t.bm, t.bn, t.bk, t.stages, t.split,
                                                t.parts, t.ctas, t.smem)
        assert plan.smem_bytes <= _build.SMEM_PER_CTA
        assert plan.flag_tile == (_build.grouped_flag_tile(T, G, a, b)
                                  if variant == "abft" else None)
        per_group = HopperGemmTiling(t.bm, t.bn, t.bk, route=t.route, stages=t.stages,
                                     gated=gated)
        assert plan.hbm_bytes == G * per_group.hbm_bytes(
            GemmProblem(-(-T // G), N, K, a.itemsize, b_bytes=b.itemsize,
                        out_bytes=plan.problem.out_elem_bytes, b_sparse=variant == "sparse"))


def test_pricer_refuses_what_the_launchers_refuse():
    with pytest.raises(ValueError):
        tiling.plan_matmul_tiles(64, 64, 64, F32, F32, "bogus")
    with pytest.raises(ValueError):
        tiling.plan_matmul_tiles(64, 64, 64, F32, F32, "baseline", groups=8)
    with pytest.raises(ValueError):
        HopperGemmTiling(16, 16, 16, route="wgmma")


def test_the_paper_ab_at_llama_shapes():
    """Kernel 1 (inter-k buffering) moves fewer bytes than kernel 2 at the
    same tile wherever K takes more than one round-trip step."""
    for (M, N, K), dt in itertools.product([(8, 2048, 8192), (64, 8192, 2048)], (F32, BF16)):
        mx = tiling.plan_matmul_tiles(M, N, K, dt, dt)
        t = mx.tiling
        base = HopperGemmTiling(t.bm, t.bn, tiling.BASELINE_BK, accumulate_in_registers=False,
                                route=t.route, stages=t.stages, ring_bk=t.bk)
        assert mx.hbm_bytes < base.hbm_bytes(mx.problem)
        assert (base.hbm_bytes(mx.problem) - mx.hbm_bytes
                == 2 * (K // tiling.BASELINE_BK - 1) * M * N * dt.itemsize)
        if t.route == "mma":  # kernel 2's ring: kernel 1's without the parts' f32 tile
            assert base.smem_bytes(mx.problem) == _build.prefill_smem(
                t.bm, t.bn, t.bk, dt.itemsize, dt.itemsize, t.stages, t.split, t.parts, False,
                False, False)
        else:
            assert base.smem_bytes(mx.problem) == mx.smem_bytes
