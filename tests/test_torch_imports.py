"""The port stands alone: it imports neither JAX nor the JAX package, its
entry points refuse to fall back to the CPU silently, and the CPU smoke
serve runs end to end."""
import os
import pkgutil
import subprocess
import sys
from pathlib import Path

import pytest

torch = pytest.importorskip("torch")

import repro_torch  # noqa: E402
from repro_torch.launch import serve  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]


def test_port_imports_no_jax_and_no_reference_package():
    mods = sorted(m.name for m in pkgutil.walk_packages(repro_torch.__path__,
                                                         "repro_torch."))
    assert "repro_torch.runtime.batcher" in mods and "repro_torch.kernels._build" in mods
    assert {"repro_torch.models.moe", "repro_torch.kernels.mx_grouped_matmul",
            "repro_torch.core.precision", "repro_torch.kernels.quant",
            "repro_torch.kernels.sparse", "repro_torch.kernels.abft",
            "repro_torch.models.ssm", "repro_torch.kernels.ssd_scan",
            "repro_torch.kernels.mx_flash_attention", "repro_torch.launch.steps",
            "repro_torch.kernels.mx_collective_matmul", "repro_torch.core.transfer_model",
            "repro_torch.parallel.ring", "repro_torch.parallel.sharding",
            "repro_torch.parallel.pipeline", "repro_torch.launch.mesh",
            "repro_torch.optim.adamw", "repro_torch.optim.schedules",
            "repro_torch.optim.compression", "repro_torch.data.pipeline",
            "repro_torch.checkpoint.manager", "repro_torch.runtime.fault",
            "repro_torch.runtime.elastic", "repro_torch.launch.train",
            "repro_torch.core.tree", "repro_torch.core.paper_data",
            "repro_torch.core.energy", "repro_torch.core.roofline",
            "repro_torch.core.tiling"} <= set(mods)
    code = (
        "import importlib, sys\n"
        f"sys.path[:0] = [{str(ROOT / 'src')!r}, {str(ROOT)!r}]\n"
        f"for m in {mods!r} + ['chip_smoke']:\n"
        "    importlib.import_module(m)\n"
        "bad = sorted(m for m in sys.modules if m == 'jax' or m.startswith('jax.')\n"
        "             or m == 'repro' or m.startswith('repro.') or m == 'ml_dtypes')\n"
        "assert not bad, bad\n"
        "print('ok', len(sys.modules))\n")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         timeout=120, cwd=ROOT)
    assert out.returncode == 0, out.stderr
    assert out.stdout.startswith("ok")


def test_xla_specific_analytics_are_deliberately_absent():
    """JAX's HLO census, dry run and cell specs read XLA's HLO text and
    ShapeDtypeStruct specs, `parse_collective_bytes` reads HLO text and
    `tpu_step_energy_j` prices a TPU step: none has a counterpart, and the
    docstrings say so."""
    from repro_torch import core
    from repro_torch.core import energy, roofline

    for name in ("hlo_census", "dryrun", "specs"):
        assert not any(m.name.endswith(f".{name}") for m in pkgutil.walk_packages(
            repro_torch.__path__, "repro_torch."))
        assert name in core.__doc__
    assert not hasattr(roofline, "parse_collective_bytes")
    assert "parse_collective_bytes" in roofline.__doc__
    assert not hasattr(energy, "tpu_step_energy_j")
    assert "tpu_step_energy_j" in energy.__doc__


def test_serve_refuses_to_fall_back_to_the_cpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        serve.main(["--smoke", "--prefix-cache", "--prefill-chunk", "4"])


def test_serve_smoke_on_cpu_returns_zero(capsys):
    assert serve.main(["--smoke", "--prefix-cache", "--prefill-chunk", "4",
                       "--device", "cpu"]) == 0
    out = capsys.readouterr().out
    assert "continuous batching [paged+prefix cache]: 8 requests" in out
    assert "prefix cache:" in out


@pytest.mark.parametrize("arch", ["grok-1-314b", "kimi-k2-1t-a32b"])
def test_serve_moe_smoke_on_cpu(capsys, arch):
    assert serve.main(["--arch", arch, "--smoke", "--prefix-cache", "--prefill-chunk",
                       "4", "--device", "cpu"]) == 0
    assert "continuous batching [paged+prefix cache]: 8 requests" in capsys.readouterr().out


@pytest.mark.parametrize("arch,flags,line", [
    ("xlstm-125m", [], "generated (4, 16) tokens"),  # static, token-stepped prompt
    ("xlstm-125m", ["--continuous"], "continuous batching [dense cache]: 8 requests"),
    ("internvl2-26b", ["--continuous"], "continuous batching [dense cache]: 8 requests"),
    ("internvl2-26b", ["--prefill-chunk", "4"],
     "chunked prefill unsupported for internvl2-26b-smoke"),
    ("seamless-m4t-medium", [], "enc-dec serving: decoder decode against a fixed encoder"),
    # the encoder-decoder never goes to the batcher, as in JAX
    ("seamless-m4t-medium", ["--continuous"], "generated (4, 16) tokens"),
])
def test_serve_model_families_on_cpu(capsys, arch, flags, line):
    """The xLSTM, prefix-embedding (text only) and encoder-decoder models
    through the launcher on the CPU."""
    assert serve.main(["--arch", arch, "--smoke", "--device", "cpu", *flags]) == 0
    out = capsys.readouterr().out
    assert line in out
    assert ("sample:" in out) != ("req 0:" in out)  # static xor batched


@pytest.mark.parametrize("arch", ["xlstm-125m", "internvl2-26b"])
def test_serve_paged_refuses_the_state_and_prefix_models(arch):
    with pytest.raises(ValueError, match="paged"):
        serve.main(["--arch", arch, "--smoke", "--paged", "--device", "cpu"])


@pytest.mark.parametrize("flags,line", [
    ([], "sample:"),  # static: token-stepped prompt, bf16 dense cache
    (["--prefill-chunk", "4"], "chunked prefill unsupported for zamba2-2.7b-smoke"),
    (["--continuous", "--max-len", "40"], "continuous batching [dense cache]: 8 requests"),
])
def test_serve_zamba2_smoke_on_cpu(capsys, flags, line):
    """The Mamba2 hybrid through the launcher, statically (with JAX's
    fallback message for --prefill-chunk) and through the dense batcher."""
    assert serve.main(["--arch", "zamba2-2.7b", "--smoke", "--device", "cpu", *flags]) == 0
    assert line in capsys.readouterr().out


def test_serve_static_llama_on_cpu(capsys):
    """Without --continuous / --paged the launcher generates statically, as
    JAX's does: chunked prefill, then greedy decode."""
    assert serve.main(["--smoke", "--prefill-chunk", "8", "--device", "cpu"]) == 0
    out = capsys.readouterr().out
    assert "prefill: 16 tokens in chunks of 8" in out
    assert "generated (4, 16) tokens" in out


def test_serve_paged_needs_an_attention_only_model():
    with pytest.raises(ValueError, match="paged"):
        serve.main(["--arch", "zamba2-2.7b", "--smoke", "--paged", "--device", "cpu"])


@pytest.mark.parametrize("flag", ["--chaos", "--disagg=2", "--disagg-migrate"])
def test_serve_rejects_unported_flags(capsys, flag):
    """The flags the launcher refused until chaos and disaggregated serving
    were ported: each now serves on the CPU and prints JAX's lines (the
    "+chaos" mode with its health record; the `disagg serving [...]`
    summary with handoffs and workers)."""
    flags = ["--disagg", "2", "--prompt-len", "40", "--prefill-chunk", "8", flag] \
        if flag == "--disagg-migrate" else [flag]
    assert serve.main(["--smoke", "--device", "cpu", *flags]) == 0
    out = capsys.readouterr().out
    if flag == "--chaos":
        assert "continuous batching [dense+chaos cache]: 8 requests" in out
        assert "chaos [seed 0]:" in out and "finish reasons:" in out
    else:
        mode = "page-migration" if flag == "--disagg-migrate" else "shared-pool"
        assert f"disagg serving [{mode}]: 16 requests, 2 prefill workers -> 4 decode" in out
        assert "handoffs: 16 completed" in out and "workers: w0=healthy" in out
        migrated = int(out.split(" pages migrated")[0].rsplit("(", 1)[1])
        assert (migrated > 0) == (flag == "--disagg-migrate"), out


@pytest.mark.parametrize("flags,lines", [
    (["--prefix-cache", "--prefill-chunk", "4", "--chaos", "--fault-rate", "0.3"],
     ["continuous batching [paged+prefix+chaos cache]", "health:"]),
    (["--paged", "--abft", "--chaos", "--fault-rate", "0.3", "--prefill-chunk", "4"],
     ["[paged+chaos+abft cache]", "abft: 10 SDC detected / 10 corrected (10 bit flips"]),
    (["--disagg", "2", "--chaos", "--fault-rate", "0.3", "--prefill-chunk", "4"],
     ["disagg serving [shared-pool+chaos]", "chaos [seed 0]: 2 worker kills"]),
])
def test_serve_chaos_on_cpu_as_jax_prints_it(capsys, flags, lines):
    """--chaos over the paged batcher, with ABFT (every injected bit flip
    caught), and over the disaggregated engine (worker kills); the counters
    are pure in the seed, so they are JAX's launcher's."""
    assert serve.main(["--smoke", "--device", "cpu", *flags]) == 0
    out = capsys.readouterr().out
    for line in lines:
        assert line in out


@pytest.mark.parametrize("flags", [["--disagg-migrate"], ["--disagg", "2", "--abft"],
                                   ["--disagg", "2", "--speculate", "2"]])
def test_serve_refuses_what_jax_refuses(flags):
    with pytest.raises(SystemExit):
        serve.main(["--smoke", "--device", "cpu", *flags])


@pytest.mark.parametrize("flags,mode", [
    (["--speculate", "2", "--draft", "ngram"], "paged+spec2"),
    (["--speculate", "2", "--draft", "qwen2-0.5b"], "paged+spec2"),
    (["--kv-cache", "int8", "--paged"], "paged+int8"),
])
def test_serve_speculative_and_int8_on_cpu(capsys, flags, mode):
    assert serve.main(["--smoke", "--prefill-chunk", "4", "--device", "cpu",
                       *flags]) == 0
    out = capsys.readouterr().out
    assert f"continuous batching [{mode} cache]: 8 requests" in out
    assert ("speculation [k=2" in out) == ("--speculate" in flags)


@pytest.mark.parametrize("flags,mode", [
    (["--abft", "--paged"], "paged+abft"),
    (["--abft", "--speculate", "2", "--draft", "ngram"], "paged+spec2+abft"),
    (["--abft", "--arch", "grok-1-314b", "--prefix-cache"], "paged+prefix+abft"),
])
def test_serve_abft_on_cpu(capsys, flags, mode):
    """--abft as JAX's launcher prints it: the mode's +abft and the audit
    line (without --chaos no flip is injected)."""
    assert serve.main(["--smoke", "--prefill-chunk", "4", "--device", "cpu", *flags]) == 0
    out = capsys.readouterr().out
    assert f"continuous batching [{mode} cache]: 8 requests" in out
    assert "abft: 0 SDC detected / 0 corrected" in out


def test_serve_rejects_a_draft_model_of_another_vocab():
    """llama3.2-1b (128256 tokens) cannot draft for qwen2-0.5b (151936)."""
    with pytest.raises(SystemExit, match="vocab"):
        serve.main(["--arch", "qwen2-0.5b", "--speculate", "2", "--draft",
                    "llama3.2-1b", "--device", "cpu"])


def test_chip_smoke_fails_without_a_gpu():
    """Without a visible GPU the smoke test exits non-zero and prints no
    result line."""
    out = subprocess.run([sys.executable, str(ROOT / "chip_smoke.py")],
                         capture_output=True, text=True, timeout=120, cwd=ROOT,
                         env=dict(os.environ, CUDA_VISIBLE_DEVICES=""))
    assert out.returncode != 0
    assert "no CUDA device" in out.stderr
    assert '"ok": true' not in out.stdout


def test_serve_reaches_quantization_as_jax_does():
    """Like JAX's launcher, the port's has no precision flag and offers f32
    or int8 pages; the quantized path is reached through Config.precision
    or use_precision, and fp8 pages through the batcher's kv_quant."""
    ap_src = Path(serve.__file__).read_text()
    jax_src = (ROOT / "src" / "repro" / "launch" / "serve.py").read_text()
    for src in (ap_src, jax_src):
        assert "--precision" not in src
        assert 'add_argument("--kv-cache", choices=("f32", "int8")' in src


@pytest.mark.parametrize("arch,precision,kv", [
    ("llama3.2-1b", "int8", "fp8_e4m3"),
    ("llama3.2-1b", "fp8_all", None),
    ("grok-1-314b", "int8_tensor", "int8"),
])
def test_quantized_serving_on_cpu(arch, precision, kv):
    """The serving recipe of the README on the CPU: dataclasses.replace(cfg,
    precision=...) and QuantSpec pages through the paged batcher, every
    request to its max_new; under an ambient use_precision the streams of
    a dense model equal the declared ones (its tied head is never
    quantized)."""
    import contextlib
    import dataclasses

    from repro_torch.configs import get_config
    from repro_torch.core.precision import QuantSpec, use_precision
    from repro_torch.models import build_model
    from repro_torch.runtime.batcher import ContinuousBatcher

    base = get_config(f"{arch}-smoke")
    kw = dict(batch_slots=2, max_len=24, page_size=4, prefix_cache=True, prefill_chunk=4,
              kv_quant=QuantSpec(kv) if kv else None)

    def run(cfg, ctx):
        model = build_model(cfg)
        params = model.init(0, device="cpu")
        with ctx:
            b = ContinuousBatcher(model, params, **kw)
            for r in serve.make_trace(cfg, 4, 12, 5, prefix_cache=True):
                b.submit(r)
            fin = b.run_to_completion()
        assert all(r.finish_reason == "max_new" and len(r.output) == 5
                   for r in fin.values())
        return {r: fin[r].output for r in fin}

    declared = run(dataclasses.replace(base, precision=precision), contextlib.nullcontext())
    ambient = run(base, use_precision(precision))
    if base.tie_embeddings:
        assert declared == ambient
