"""The port's dry run against JAX's, on the CPU: the cell specs of every
(arch x shape) cell on the "meta" device (shapes, dtypes, specs and
tokens_per_step those of JAX's `cell_specs`), the logical axes of every
model's parameters and cache, the op census (exact FLOPs of a loop, the
exact live peak of a chain, FlopCounterMode's count of a real train step),
the transfer-model reports (counts equal, floats at rel 1e-12, JAX's
called at the port's H100 rates), a whole cell through `run_cell` and the
command line.  Nothing here allocates a full-size tensor."""
import json
import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
from jax.sharding import Mesh as JMesh  # noqa: E402

from repro.configs import ARCH_IDS  # noqa: E402
from repro.configs import SHAPES as J_SHAPES  # noqa: E402
from repro.configs import cell_applicable as j_applicable  # noqa: E402
from repro.configs import get_config as j_get_config  # noqa: E402
from repro.launch.specs import cell_specs as j_cell_specs  # noqa: E402
from repro.models import build_model as j_build  # noqa: E402
from repro.optim.adamw import AdamW as JAdamW  # noqa: E402
from repro.parallel import sharding as js  # noqa: E402
from repro_torch.configs import SHAPES, get_config  # noqa: E402
from repro_torch.configs.shapes import ShapePreset  # noqa: E402
from repro_torch.core import roofline as tr  # noqa: E402
from repro_torch.core.op_census import census, distinct_bytes  # noqa: E402
from repro_torch.data.pipeline import SyntheticLM  # noqa: E402
from repro_torch.launch import dryrun  # noqa: E402
from repro_torch.launch import steps  # noqa: E402
from repro_torch.launch.mesh import make_mesh  # noqa: E402
from repro_torch.launch.specs import cell_specs  # noqa: E402
from repro_torch.models import build_model  # noqa: E402
from repro_torch.optim.adamw import AdamW  # noqa: E402
from repro_torch.parallel import sharding as ts  # noqa: E402

REL = 1e-12
CELLS = [(a, s) for a in ARCH_IDS for s in SHAPES]


def _jax_dryrun(monkeypatch):
    """JAX's dry-run module, its rates set to the port's.  Importing it
    asks XLA for 512 host devices through XLA_FLAGS; the backend here is
    already up, and the variable is put back for later subprocesses."""
    jax.devices()
    saved = os.environ.get("XLA_FLAGS")
    try:
        from repro.launch import dryrun as jd
    finally:
        if saved is None:
            os.environ.pop("XLA_FLAGS", None)
        else:
            os.environ["XLA_FLAGS"] = saved
    monkeypatch.setattr(jd, "ICI_BW", tr.NVLINK_BW)
    monkeypatch.setattr(jd, "PEAK_FLOPS_BF16", tr.PEAK_FLOPS["bfloat16"])
    monkeypatch.setattr(jd, "HBM_BW", tr.HBM_BW)
    return jd


def _close(a, b):
    return a == b or abs(a - b) <= REL * max(abs(a), abs(b))


def _same(got, want, path=()):
    """Two records: the same keys, counts equal, floats at rel 1e-12.  The
    transfer model's shared memory takes VMEM's place: ABFT's extra bytes
    under its new name, the 2:4 tile's from the launcher's table (another
    number, held in tests/test_torch_analytics.py)."""
    if isinstance(want, dict):
        want, got = dict(want), dict(got)
        if "extra_vmem_bytes" in want:
            want["extra_smem_bytes"] = want.pop("extra_vmem_bytes")
        if "vmem_bytes" in want:
            want.pop("vmem_bytes")
            assert got.pop("smem_bytes") > 0, path
        assert isinstance(got, dict) and got.keys() == want.keys(), path
        for k in want:
            _same(got[k], want[k], path + (k,))
    elif isinstance(want, float):
        assert _close(got, want), (path, got, want)
    else:
        assert got == want and type(got) is type(want), (path, got, want)


def _leaves(tree):
    """Leaves in JAX's order (dict keys sorted)."""
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in _leaves(tree[k])]
    if isinstance(tree, (tuple, list)) and not isinstance(tree, torch.Size):
        return [x for v in tree for x in _leaves(v)]
    return [tree]


def _spec_leaves(args, specs):
    """The spec tuple of each argument leaf (tensor or host int), in JAX's
    order."""
    if isinstance(args, dict):
        return [x for k in sorted(args) for x in _spec_leaves(args[k], specs[k])]
    if isinstance(args, (tuple, list)):
        return [x for a, s in zip(args, specs) for x in _spec_leaves(a, s)]
    return [specs]


@pytest.mark.parametrize("arch,shape", CELLS, ids=[f"{a}-{s}" for a, s in CELLS])
def test_cell_specs_on_meta_are_jaxs(arch, shape):
    """Every applicable cell's arguments lie on "meta" with JAX's shapes
    and dtypes, its specs are JAX's shardings at 1x1, and tokens_per_step
    is JAX's; a long_500k cell of a full-attention model is skipped with
    JAX's reason."""
    cfg, jcfg = get_config(arch), j_get_config(arch)
    ok, reason = j_applicable(jcfg, J_SHAPES[shape])
    if not ok:
        rec = dryrun.run_cell(arch, shape)
        assert rec["status"] == "skipped" and rec["reason"] == reason
        assert "long_500k needs sub-quadratic attention" in reason
        return
    rules = ts.make_rules(make_mesh((1, 1), ("data", "model")), profile=cfg.parallelism,
                          fsdp=cfg.fsdp)
    got = cell_specs(cfg, SHAPES[shape], rules, opt=AdamW())
    jmesh = JMesh(np.array(jax.devices()[:1]).reshape(1, 1), ("data", "model"))
    jrules = js.make_rules(jmesh, profile=jcfg.parallelism, fsdp=jcfg.fsdp)
    want = j_cell_specs(jcfg, J_SHAPES[shape], jrules, opt=JAdamW())
    assert (got.kind, got.tokens_per_step, got.donate_argnums) == (
        want.kind, want.tokens_per_step, want.donate_argnums)
    t_args = [x for x in _leaves(got.args) if isinstance(x, torch.Tensor)]
    j_args = [x for x in jax.tree.leaves(want.args)]
    if got.kind == "decode":  # the index: a host int here, an int32 scalar in JAX
        idx = [x for x in _leaves(got.args) if isinstance(x, int)]
        assert idx == [SHAPES[shape].seq_len - 1]
        j_args = [x for x in j_args if x.shape != ()]
    assert all(t.device.type == "meta" for t in t_args)
    assert [tuple(t.shape) for t in t_args] == [tuple(j.shape) for j in j_args]
    assert [str(t.dtype).removeprefix("torch.") for t in t_args] == [
        str(j.dtype) for j in j_args]
    j_specs = [tuple(s.spec) for s in jax.tree.leaves(want.in_shardings)]
    assert _spec_leaves(got.args, got.in_specs) == j_specs


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_logical_axes_are_jaxs(arch):
    """`Module.axes()` and `cache_axes()` give JAX's `axes()` and
    `make_cache(mode="axes")` trees, leaf for leaf."""
    jm, tm = j_build(j_get_config(arch)), build_model(get_config(arch))

    def norm(t):
        return {k: norm(v) for k, v in t.items()} if isinstance(t, dict) else tuple(t)

    assert norm(tm.axes()) == norm(jm.axes())
    assert norm(tm.cache_axes()) == norm(jm.make_cache(2, 16, mode="axes"))


def test_census_counts_every_iteration_of_a_loop():
    """A Python loop of 10 N x N matmuls on meta: 10 * 2 N^3 FLOPs exactly
    (JAX's cost analysis counts a scan body once; the census has no trip
    count to recover), each matmul's 3 N^2 elements moved, and only the
    last two products alive at once."""
    N = 96
    x = torch.empty((N, N), device="meta")

    def loop(x):
        for _ in range(10):
            x = x @ x
        return x

    res, out = census(loop, x)
    assert out.shape == (N, N)
    assert res.flops == 10 * 2 * N ** 3
    assert res.op_bytes == 10 * 3 * N * N * 4
    assert res.by_op["aten.mm"] == {"calls": 10, "flops": 10 * 2 * N ** 3,
                                    "bytes": 10 * 3 * N * N * 4}
    assert res.peak_live_bytes == 2 * N * N * 4
    assert res.argument_bytes == N * N * 4 and res.output_bytes == N * N * 4
    assert res.floor_bytes == 2 * N * N * 4 and res.alias_bytes == 0


def test_census_live_peak_of_a_chain_is_exact():
    """A hand-built chain: the peak is the three temporaries alive at once,
    a view adds nothing, an expand reads its row once, an in-place write
    into the argument counts as alias bytes and only its written rows in
    the floor."""
    n = 1000
    x = torch.empty((n,), device="meta")
    cache = torch.empty((8, n), device="meta")

    def chain(x, cache):
        a = x * 2.0             # n live
        b = a.view(10, 100)     # a view: no bytes, no storage
        c = b + 1.0             # 2n
        d = c.expand(4, 10, 100).sum(0)  # 3n (the expand reads c once)
        del a, b, c             # n
        cache[3].copy_(d.reshape(n))     # writes one row of the argument
        e = d * d               # 2n
        return e, cache

    res, (e, _) = census(chain, x, cache)
    assert res.peak_live_bytes == 3 * n * 4
    assert res.argument_bytes == 9 * n * 4
    assert res.output_bytes == (n + 8 * n) * 4 and res.alias_bytes == 8 * n * 4
    assert res.floor_bytes == (9 * n + n + n) * 4  # arguments, e, the row written
    assert res.temp_bytes == 2 * n * 4
    assert res.by_op["aten.view"]["bytes"] == 0
    assert res.by_op["aten.sum"]["bytes"] == (n + n) * 4
    assert distinct_bytes(torch.empty((4, 10), device="meta").expand(3, 4, 10)) == 160


def test_census_of_a_smoke_train_step_is_flop_counter_mode():
    """llama3.2-1b-smoke's train step (f32, in-place AdamW) on meta: the
    census's FLOPs equal FlopCounterMode's on the CPU's real step, and the
    census of the real step gives the meta one's bytes and peak."""
    from torch.utils.flop_counter import FlopCounterMode

    cfg = get_config("llama3.2-1b-smoke")
    model, opt = build_model(cfg), AdamW()
    rules = ts.make_rules(make_mesh((1, 1), ("data", "model")))
    spec = cell_specs(cfg, ShapePreset("t", 32, 2, "train"), rules, opt=opt,
                      param_dtype=torch.float32)
    step = steps.make_train_step(model, cfg, opt, inplace=True)
    on_meta, _ = census(step, *spec.args)
    params = model.init(0, device="cpu")
    batch = steps.batch_to(SyntheticLM(cfg, seq_len=32, global_batch=2).next_batch(), "cpu")
    with FlopCounterMode(display=False) as fc:
        step(params, opt.init(params), batch)
    assert on_meta.flops == fc.get_total_flops() > 6 * sum(
        t.numel() for t in _leaves(params)) * 64 * 0.5
    on_cpu, _ = census(step, params, opt.init(params), batch)
    assert (on_cpu.flops, on_cpu.op_bytes, on_cpu.floor_bytes, on_cpu.peak_live_bytes,
            on_cpu.argument_bytes) == (on_meta.flops, on_meta.op_bytes, on_meta.floor_bytes,
                                       on_meta.peak_live_bytes, on_meta.argument_bytes)


REPORTS = ["quantized_gemm_reports", "sparse_gemm_reports", "abft_gemm_reports",
           "collective_gemm_reports", "paged_kv_decode_reports", "shared_prefix_reports"]


@pytest.mark.parametrize("fn", REPORTS)
@pytest.mark.parametrize("arch", ARCH_IDS)
def test_reports_equal_jaxs(monkeypatch, arch, fn):
    """Each report function of the dry run on each architecture equals
    JAX's, which runs at the port's H100 rates (NVLink for ICI, the bf16
    tensor-core peak, HBM3); the ring at a 1 x 4 mesh."""
    jd = _jax_dryrun(monkeypatch)
    cfg, jcfg = get_config(arch), j_get_config(arch)
    tokens = 4096
    if fn == "collective_gemm_reports":
        jmesh = JMesh(np.array([jax.devices()[0]] * 4).reshape(1, 4), ("data", "model"))
        got = dryrun.collective_gemm_reports(cfg, make_mesh((1, 4), ("data", "model")), tokens)
        want = jd.collective_gemm_reports(jcfg, jmesh, tokens)
        assert got["schedule"]["chosen_direction"] in ("fwd", "bidir")
    elif fn in ("paged_kv_decode_reports", "shared_prefix_reports"):
        got = getattr(dryrun, fn)(cfg, SHAPES["decode_32k"])
        want = getattr(jd, fn)(jcfg, J_SHAPES["decode_32k"])
    else:
        got = getattr(dryrun, fn)(cfg, tokens)
        want = getattr(jd, fn)(jcfg, tokens)
    _same(got, want)


def test_run_cell_xlstm_decode_on_one_card():
    """A whole cell: xlstm-125m at decode_32k on the 1x1 mesh, its memory
    identity JAX's (peak = argument + output + temp - alias), its bytes
    and FLOPs those of the census, MODEL_FLOPS 2 N_active B."""
    rec = dryrun.run_cell("xlstm-125m", "decode_32k", "1x1")
    assert rec["status"] == "ok" and rec["chips"] == 1 and rec["kind"] == "decode"
    assert rec["roofline"]["bound"] in {"compute", "memory", "collective"}
    m, c = rec["memory"], rec["cost"]
    assert m["peak_bytes_per_device"] == (m["argument_bytes_per_device"]
                                          + m["output_bytes_per_device"]
                                          + m["temp_bytes_per_device"]
                                          - m["alias_bytes_per_device"])
    assert m["fits_h100_80gb"] == (m["peak_bytes_per_device"] < tr.HBM_CAPACITY)
    assert c["per_device_flops"] == c["census_flops"] > 0
    assert c["per_device_bytes"] == c["census_floor_bytes"] < c["op_bytes_per_device"]
    assert c["per_device_collective_bytes"] == 0 and rec["collective_gemms"] == {}
    assert rec["roofline"]["model_flops"] == 2.0 * rec["n_active_params"] * 128
    assert rec["paged_kv_decode"] == {}  # xLSTM serves no pages
    json.dumps(rec)


def test_collective_bytes_on_a_mesh():
    """At T > 1 the rings' bytes (three passes in a train step), at D > 1
    the gradients' all-reduce, 2(D-1)/D x 4N/T per device; none at 1x1."""
    cfg = get_config("llama3.2-1b")
    m = make_mesh((2, 4), ("data", "model"))
    reps = dryrun.collective_gemm_reports(cfg, m, 4096)
    ring = (sum(reps[k]["comm_bytes_total"] for k in ("qkv", "attn_out", "mlp_up", "mlp_down"))
            * 16 + reps["lm_head"]["comm_bytes_total"])
    assert dryrun.collective_bytes(cfg, m, "decode", 4096, reps) == {"tp_rings": float(ring)}
    got = dryrun.collective_bytes(cfg, m, "train", 4096, reps)
    assert got == {"tp_rings": float(3 * ring),
                   "grad_all_reduce": 2 * 1 / 2 * 4 * cfg.n_params() / 4}
    one = make_mesh((1, 1), ("data", "model"))
    assert dryrun.collective_bytes(cfg, one, "train", 4096, {}) == {}
    assert dryrun.parse_mesh("2x4") == (2, 4)
    with pytest.raises(ValueError, match="DxT"):
        dryrun.parse_mesh("8")


def test_dryrun_command_line(tmp_path, capsys):
    """`--arch --shape` writes one record; a skipped cell writes its
    reason; `--skip-existing` leaves a written record alone."""
    assert dryrun.main(["--arch", "zamba2-2.7b", "--shape", "long_500k",
                        "--out", str(tmp_path)]) == 0
    rec = json.loads((tmp_path / "zamba2-2.7b__long_500k__1x1.json").read_text())
    assert rec["status"] == "ok" and rec["tokens_per_step"] == 1
    assert "fits_h100_80gb=True" in capsys.readouterr().out
    assert dryrun.main(["--arch", "qwen2-0.5b", "--shape", "long_500k",
                        "--out", str(tmp_path)]) == 0
    skip = json.loads((tmp_path / "qwen2-0.5b__long_500k__1x1.json").read_text())
    assert skip["status"] == "skipped"
    assert dryrun.main(["--arch", "zamba2-2.7b", "--shape", "long_500k", "--skip-existing",
                        "--out", str(tmp_path)]) == 0
    assert "[skip-existing]" in capsys.readouterr().out
    table = dryrun.summary_table(tmp_path).splitlines()
    assert len(table) == 4 and table[2].startswith("| qwen2-0.5b | long_500k | skipped |")
    assert table[3].startswith("| zamba2-2.7b | long_500k | decode | ")
    assert "| yes | memory |" in table[3]


def test_decode_with_a_host_index_keeps_the_bits():
    """The dense cache's decode with a Python-int index (the dry run's, so a
    meta step reads no tensor back) gives the bits of a tensor index."""
    cfg = get_config("llama3.2-1b-smoke")
    model = build_model(cfg)
    params = model.init(0, device="cpu")
    token = torch.tensor([[3], [5]])
    outs = []
    for index in (7, torch.tensor(7)):
        cache = model.make_cache(2, 16, device="cpu")
        logits, cache = model.decode_step(params, token, cache, index)
        outs.append((logits, cache["seg0"]["k"]))
    assert torch.equal(outs[0][0], outs[1][0]) and torch.equal(outs[0][1], outs[1][1])
