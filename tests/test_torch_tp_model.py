"""The model under the ring: a transformer block and a MoE layer under the
port's `collective_policy` over `LocalRing(8)`, against JAX's plain block
and MoE (JAX's own tolerances: 3e-4, aux loss 1e-6) and against JAX's
collective ones on an 8-device host mesh (one subprocess); llama3.2-1b-
smoke's forward and the paged batcher's token streams under `LocalRing(2)`
and `LocalRing(4)`, against JAX's, with both ring modes launched."""
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import get_config as j_get_config  # noqa: E402
from repro.core import ops as jops  # noqa: E402
from repro.models import build_model as j_build  # noqa: E402
from repro.runtime.batcher import ContinuousBatcher as JBatcher  # noqa: E402
from repro.runtime.lifecycle import Request as JRequest  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.core import ops  # noqa: E402
from repro_torch.kernels import mx_collective_matmul as cm  # noqa: E402
from repro_torch.launch.mesh import make_mesh  # noqa: E402
from repro_torch.models import build_model, from_jax_params  # noqa: E402
from repro_torch.models.moe import MoE  # noqa: E402
from repro_torch.models.transformer import TransformerBlock  # noqa: E402
from repro_torch.parallel.sharding import collective_policy  # noqa: E402
from repro_torch.runtime.batcher import ContinuousBatcher  # noqa: E402
from repro_torch.runtime.lifecycle import Request  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
TOL = dict(rtol=1e-5, atol=1e-5)
BLOCK = dict(d_model=64, n_heads=8, n_kv_heads=8, d_ff=128)
MOE = dict(d_model=32, d_ff=64, n_experts=4, top_k=2, n_groups=1)

_JAX_CODE = r"""
import os, sys
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=8"
import jax, jax.numpy as jnp, numpy as np
from repro.launch.mesh import make_mesh
from repro.models.moe import MoE
from repro.models.transformer import TransformerBlock
from repro.parallel.sharding import collective_policy

def flat(tree, pre):
    return {pre + "/".join(str(k.key) for k in path): np.asarray(v)
            for path, v in jax.tree_util.tree_flatten_with_path(tree)[0]}

mesh = make_mesh((1, 8), ("data", "model"))
blk = TransformerBlock(d_model=64, n_heads=8, n_kv_heads=8, d_ff=128)
bp = blk.init(jax.random.PRNGKey(0))
xb = np.random.default_rng(1).standard_normal((2, 16, 64)).astype(np.float32)
moe = MoE(d_model=32, d_ff=64, n_experts=4, top_k=2, n_groups=1)
mp = moe.init(jax.random.PRNGKey(2))
xm = np.random.default_rng(3).standard_normal((2, 16, 32)).astype(np.float32)
save = dict(flat(bp, "block:"), **flat(mp, "moe:"), xb=xb, xm=xm)
save["block_plain"] = blk(bp, jnp.asarray(xb))[0]
save["moe_plain"], save["moe_plain_aux"] = moe(mp, jnp.asarray(xm))
with collective_policy(mesh, axis="model"):
    save["block_coll"] = blk(bp, jnp.asarray(xb))[0]
    save["moe_coll"], save["moe_coll_aux"] = moe(mp, jnp.asarray(xm))
np.savez(sys.argv[1], **{k: np.asarray(v) for k, v in save.items()})
print("JAX_MODEL_OK")
"""


@pytest.fixture(scope="module")
def jx(tmp_path_factory):
    path = tmp_path_factory.mktemp("jax_tp") / "model.npz"
    r = subprocess.run([sys.executable, "-c", _JAX_CODE, str(path)], capture_output=True,
                       text=True, timeout=300, cwd=ROOT,
                       env={**os.environ, "PYTHONPATH": "src", "JAX_PLATFORMS": "cpu"})
    assert "JAX_MODEL_OK" in r.stdout, f"stdout={r.stdout}\nstderr={r.stderr[-3000:]}"
    d = np.load(path)
    return {k: d[k] for k in d.files}


def _tree(jx, prefix):
    out = {}
    for k, v in jx.items():
        if k.startswith(prefix):
            node, *path = k[len(prefix):].split("/")
            keys = [node, *path]
            cur = out
            for key in keys[:-1]:
                cur = cur.setdefault(key, {})
            cur[keys[-1]] = torch.from_numpy(np.array(v))
    return out


def _policy(P=8, direction="bidir"):
    return collective_policy(make_mesh((1, P), ("data", "model")), direction=direction)


@pytest.mark.parametrize("backend", ["torch", "cuda_mx"])
def test_block_under_the_ring_matches_jax(jx, backend):
    blk, bp, x = TransformerBlock(**BLOCK), _tree(jx, "block:"), torch.from_numpy(jx["xb"])
    cm.reset_ring_stats()
    with ops.use_policy(ops.MXPolicy(backend)), _policy():
        y, _ = blk(bp, x)
    s = cm.ring_stats()
    # q / k / v and up+gate on the all-gather ring, out and down on the other
    assert (s["allgather"], s["reduce_scatter"], s["fallbacks"]) == (4, 2, 0)
    np.testing.assert_allclose(y.numpy(), jx["block_plain"], atol=3e-4)
    np.testing.assert_allclose(y.numpy(), jx["block_coll"], **TOL)


@pytest.mark.parametrize("backend", ["torch", "cuda_mx"])
def test_moe_collective_branch_matches_jax(jx, backend):
    moe, mp, x = MoE(**MOE), _tree(jx, "moe:"), torch.from_numpy(jx["xm"])
    cm.reset_ring_stats()
    with ops.use_policy(ops.MXPolicy(backend)), _policy():
        y, aux = moe(mp, x)
    s = cm.ring_stats()
    assert s["allgather"] == s["reduce_scatter"] == 4  # one ring pair per expert
    np.testing.assert_allclose(y.numpy(), jx["moe_plain"], atol=3e-4)
    np.testing.assert_allclose(float(aux), float(jx["moe_plain_aux"]), atol=1e-6)
    np.testing.assert_allclose(y.numpy(), jx["moe_coll"], **TOL)
    np.testing.assert_allclose(float(aux), float(jx["moe_coll_aux"]), **TOL)


def test_moe_collective_branch_needs_divisible_chunks(jx):
    """Rows that do not divide over the ring keep the grouped path (JAX's
    condition), so no expert falls back one linear at a time."""
    moe = MoE(**dict(MOE, d_ff=60))  # 60 % 8 != 0
    mp, x = moe.init(0, device="cpu"), torch.from_numpy(jx["xm"])
    ref, _ = moe(mp, x)
    cm.reset_ring_stats()
    with _policy():
        y, _ = moe(mp, x)
    assert cm.ring_stats()["allgather"] == 0
    assert torch.equal(y, ref)


NAME = "llama3.2-1b-smoke"


def _trace(vocab):
    rng = np.random.default_rng(11)
    sysp = rng.integers(0, vocab, 8)
    out = []
    for rid, (tail, max_new) in enumerate([(1, 4), (3, 5), (2, 4), (5, 6), (4, 3), (7, 4)]):
        prompt = np.concatenate([sysp, rng.integers(0, vocab, tail)]).astype(np.int32)
        out.append((rid, prompt, max_new))
    return out


KW = dict(batch_slots=4, max_len=24, page_size=4, prefix_cache=True, prefill_chunk=4)


@pytest.fixture(scope="module")
def llama():
    """The smoke model in both packages on JAX's weights, JAX's forward
    logits on one batch and its batcher's streams on the trace (JAX's plain
    "xla" path)."""
    jcfg, cfg = j_get_config(NAME), get_config(NAME)
    jm = j_build(jcfg)
    jp = jm.init(jax.random.PRNGKey(0))
    tm = build_model(cfg)
    tp = from_jax_params(jax.tree.map(np.asarray, jp), cfg, device="cpu")
    toks = np.random.default_rng(5).integers(0, cfg.vocab, (2, 8)).astype(np.int32)
    jl, _ = jm(jp, jnp.asarray(toks))
    jb = JBatcher(jm, jp, paged=True, **KW)
    with jops.use_policy(jops.MXPolicy("xla")):
        for rid, prompt, max_new in _trace(cfg.vocab):
            jb.submit(JRequest(rid=rid, prompt=prompt, max_new=max_new))
        jfin = jb.run_to_completion()
    return tm, tp, cfg, toks, np.asarray(jl), {r: jfin[r].output for r in jfin}


@pytest.mark.parametrize("P", [2, 4])
def test_smoke_forward_under_the_ring_matches_jax(llama, P):
    tm, tp, cfg, toks, jl, _ = llama
    cm.reset_ring_stats()
    with _policy(P):
        tl, _ = tm(tp, torch.from_numpy(toks).long())
    s = cm.ring_stats()
    assert s["allgather"] == 4 * cfg.n_layers and s["reduce_scatter"] == 2 * cfg.n_layers
    np.testing.assert_allclose(tl.numpy(), jl, **TOL)


@pytest.mark.parametrize("P", [2, 4])
def test_batcher_streams_under_the_ring_match_jax(llama, P):
    """The paged batcher (prefill chunks of 4 rows, decode steps of 4
    slots) under the ring: the streams equal JAX's batcher's; both ring
    modes launch, and the chunks that do not divide fall back, counted."""
    tm, tp, cfg, _, _, jstreams = llama
    cm.reset_ring_stats()
    with _policy(P):
        tb = ContinuousBatcher(tm, tp, **KW)
        for rid, prompt, max_new in _trace(cfg.vocab):
            tb.submit(Request(rid=rid, prompt=prompt, max_new=max_new))
        tfin = tb.run_to_completion()
    s = cm.ring_stats()
    assert {r: tfin[r].output for r in tfin} == jstreams
    assert s["allgather"] > 0 and s["reduce_scatter"] > 0 and s["fallbacks"] > 0
