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
    code = (
        "import importlib, sys\n"
        f"sys.path[:0] = [{str(ROOT / 'src')!r}, {str(ROOT)!r}]\n"
        f"for m in {mods!r} + ['chip_smoke']:\n"
        "    importlib.import_module(m)\n"
        "bad = sorted(m for m in sys.modules if m == 'jax' or m.startswith('jax.')\n"
        "             or m == 'repro' or m.startswith('repro.'))\n"
        "assert not bad, bad\n"
        "print('ok', len(sys.modules))\n")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         timeout=120, cwd=ROOT)
    assert out.returncode == 0, out.stderr
    assert out.stdout.startswith("ok")


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


@pytest.mark.parametrize("flag", ["--chaos", "--speculate=2", "--kv-cache=int8",
                                  "--disagg=2"])
def test_serve_rejects_unported_flags(flag):
    with pytest.raises(SystemExit):
        serve.main(["--smoke", "--device", "cpu", flag])


def test_chip_smoke_fails_without_a_gpu():
    """Without a visible GPU the smoke test exits non-zero and prints no
    result line."""
    out = subprocess.run([sys.executable, str(ROOT / "chip_smoke.py")],
                         capture_output=True, text=True, timeout=120, cwd=ROOT,
                         env=dict(os.environ, CUDA_VISIBLE_DEVICES=""))
    assert out.returncode != 0
    assert "no CUDA device" in out.stderr
    assert '"ok": true' not in out.stdout
