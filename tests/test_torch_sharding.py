"""The port's sharding rules and ring autotuner against JAX's: the rule
tests of tests/test_sharding.py (divisibility fallback, warnings and
per-axis counts, axis reuse, the profiles) and its autotune tests, each
holding the port's choice equal to JAX's for the same problem and
arguments; and llama3.2-1b's parameter spec tree, the port's shapes under
JAX's logical axes.  (The sharded train step comes with training.)"""
import warnings

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
from jax.sharding import Mesh as JMesh  # noqa: E402
from jax.sharding import PartitionSpec as JP  # noqa: E402

from repro.configs import get_config as j_get_config  # noqa: E402
from repro.core.transfer_model import GemmProblem as JGemmProblem  # noqa: E402
from repro.models import build_model as j_build  # noqa: E402
from repro.parallel import sharding as js  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.core.transfer_model import GemmProblem  # noqa: E402
from repro_torch.launch.mesh import make_mesh, single_device_mesh  # noqa: E402
from repro_torch.models import build_model  # noqa: E402
from repro_torch.parallel import sharding as ts  # noqa: E402


def _meshes(shape=(2, 2)):
    n = int(np.prod(shape))
    dev = np.array([jax.devices()[0]] * n).reshape(shape)  # spec-only mesh
    axes = ("data", "model")
    return JMesh(dev, axes), make_mesh(shape, axes)


def _tuple(spec: JP) -> tuple:
    """A JAX PartitionSpec as the port's spec tuple."""
    return tuple(spec)


def _both(args, **kw):
    jm, tm = _meshes(kw.pop("shape", (2, 2)))
    jr, tr = js.make_rules(jm, **kw), ts.make_rules(tm, **kw)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        return jr, tr, jr.spec(*args), tr.spec(*args)


@pytest.mark.parametrize("shape,axes,kw,want", [
    ((8, 16), ("embed", "mlp"), {}, (None, "model")),          # divisible dims shard
    ((7, 13), ("batch", "mlp"), {}, ()),                        # non-divisible fall back
    ((6, 10), ("batch", None), dict(profile="dp"), ("data",)),  # progressive prefix
    ((8, 16), ("embed", "mlp"), dict(fsdp=True), ("data", "model")),
    ((8, 8, 8), ("heads", "mlp", "vocab"), {}, ("model",)),  # "model" used once
    ((16, 4), ("batch", "heads"), dict(profile="dp"), (("data", "model"),)),
    ((8, 32), ("expert", "seq"), dict(expert_data_shard=True, seq_parallel=True),
     (("model", "data"),)),
])
def test_rules_match_jax(shape, axes, kw, want):
    jr, tr, jspec, tspec = _both((shape, axes), **kw)
    assert tspec == _tuple(jspec) == want
    assert tr.drops_by_axis == jr.drops_by_axis
    assert [d[1:] for d in tr.dropped] == [d[1:] for d in jr.dropped]


def test_no_mesh_axis_used_twice():
    _, tm = _meshes()
    spec = ts.make_rules(tm).spec((8, 8, 8), ("heads", "mlp", "vocab"))
    assert [s for s in spec if s is not None].count("model") <= 1


def test_drop_emits_warning_and_counts_per_axis():
    _, tm = _meshes()
    rules = ts.make_rules(tm)
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        rules.spec((7, 13), ("batch", "mlp"))
    msgs = [str(w.message) for w in caught]
    assert any("batch" in m and "7" in m for m in msgs), msgs
    assert any("mlp" in m and "13" in m for m in msgs), msgs
    assert rules.drops_by_axis == {"batch": 1, "mlp": 1}
    # a repeated fallback: counted again, warned only once
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        rules.spec((7, 13), ("batch", "mlp"))
    assert not caught, [str(w.message) for w in caught]
    assert rules.drops_by_axis == {"batch": 2, "mlp": 2}


def test_no_warning_when_everything_divides():
    _, tm = _meshes()
    rules = ts.make_rules(tm)
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        rules.spec((8, 16), ("embed", "mlp"))
    assert not caught
    assert rules.drops_by_axis == {}


def test_rules_context_and_constrain_is_the_identity():
    _, tm = _meshes()
    rules = ts.make_rules(tm)
    x = torch.ones(4, 8)
    assert ts.current_rules() is None
    with ts.use_rules(rules):
        assert ts.current_rules() is rules
        assert ts.constrain(x, ("batch", "mlp")) is x
    assert ts.current_rules() is None
    assert single_device_mesh().shape == {"data": 1, "model": 1}


def test_param_spec_tree_for_llama_matches_jax():
    """llama3.2-1b's spec tree: the port's parameter shapes ("meta"
    tensors) under JAX's logical axes give JAX's specs."""
    jm, tm = _meshes()
    model = j_build(j_get_config("llama3.2-1b"))
    jspecs = js.tree_specs(js.make_rules(jm), model.abstract(), model.axes())
    shapes = build_model(get_config("llama3.2-1b")).init(0, device="meta")
    tspecs = ts.tree_specs(ts.make_rules(tm), shapes, model.axes())
    flat_j = jax.tree.leaves(jspecs, is_leaf=lambda x: isinstance(x, JP))
    flat_t = jax.tree.leaves(tspecs, is_leaf=lambda x: isinstance(x, tuple))
    assert [_tuple(s) for s in flat_j] == flat_t
    seg = tspecs["seg0"]["attn"]
    assert "model" in str(seg["wq"]) and "model" in str(seg["wo"])


AUTOTUNE = {  # name -> (mesh shape, problems, ici_bw, peak_flops, chosen)
    "comm_bound": ((1, 4), [("allgather", (1024, 1024, 8192, 2)),
                            ("reduce_scatter", (1024, 1024, 8192, 2))], 1e9, 1e15, "bidir"),
    "compute_bound": ((1, 4), [("allgather", (4096, 4096, 4096, 2))], 1e15, 1e9, "fwd"),
    "llama_layer": ((1, 8), [("allgather", (64, 2048, 2048, 4)),
                             ("allgather", (64, 16384, 2048, 4)),
                             ("reduce_scatter", (64, 2048, 8192, 4))], 450e9, 67e12, None),
}


@pytest.mark.parametrize("name", sorted(AUTOTUNE))
def test_autotune_matches_jax(name):
    shape, problems, bw, peak, want = AUTOTUNE[name]
    jm, tm = _meshes(shape)
    jpol, jrep = js.autotune_collective_policy(
        jm, [(m, JGemmProblem(*p)) for m, p in problems], ici_bw=bw, peak_flops=peak)
    tpol, trep = ts.autotune_collective_policy(
        tm, [(m, GemmProblem(*p)) for m, p in problems], ici_bw=bw, peak_flops=peak)
    assert trep == jrep
    assert tpol.direction == jpol.direction == (want or jpol.direction)
    assert tpol.enabled and tpol.axis_size == shape[1]
    assert min(trep["candidate_time_s"].values()) <= trep["serialized_time_s"]


def test_autotune_rejects_unknown_axis():
    _, tm = _meshes()
    with pytest.raises(ValueError, match="mesh"):
        ts.autotune_collective_policy(tm, [("allgather", GemmProblem(64, 64, 64, 2))],
                                      axis="nonexistent", ici_bw=1e9, peak_flops=1e12)


def test_mesh_rings_check_their_axis():
    from repro_torch.parallel.ring import LocalRing

    mesh = make_mesh((2, 4), ("data", "model"), rings={"model": LocalRing(4)})
    assert mesh.ring("model").size == 4 and mesh.ring("data").size == 2
    with pytest.raises(ValueError):
        make_mesh((2, 4), ("data", "model"), rings={"model": LocalRing(2)})
    with pytest.raises(ValueError):
        mesh.ring("pod")
