"""The port's config registry equals the JAX package's, field for field."""
import dataclasses

import pytest

torch = pytest.importorskip("torch")

from repro import configs as jcfg  # noqa: E402
from repro_torch import configs as tcfg  # noqa: E402

NAMES = sorted(jcfg.REGISTRY) + sorted(n + "-smoke" for n in jcfg.REGISTRY)


def test_same_arch_ids():
    assert tcfg.ARCH_IDS == jcfg.ARCH_IDS


@pytest.mark.parametrize("name", NAMES)
def test_config_fields_equal(name):
    a = dataclasses.asdict(jcfg.get_config(name))
    b = dataclasses.asdict(tcfg.get_config(name))
    assert a == b


def test_shapes_and_mx_gemm_tables_equal():
    from repro.configs import mx_gemm as jm
    from repro_torch.configs import mx_gemm as tm

    assert {k: dataclasses.asdict(v) for k, v in jcfg.SHAPES.items()} == \
        {k: dataclasses.asdict(v) for k, v in tcfg.SHAPES.items()}
    assert (jm.DUAL_CORE_SIZES, jm.MEMPOOL_SIZES, jm.TPU_GEMM_SIZES) == \
        (tm.DUAL_CORE_SIZES, tm.MEMPOOL_SIZES, tm.TPU_GEMM_SIZES)
