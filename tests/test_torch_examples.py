"""The port's examples (`examples/torch/`) run in-process on the CPU at smoke
size, import neither JAX nor the JAX package, and the tile explorer's
search over the paper's sub-tile space prints JAX's example's lines."""
import contextlib
import importlib.util
import io
import subprocess
import sys
from pathlib import Path

import pytest

torch = pytest.importorskip("torch")

ROOT = Path(__file__).resolve().parents[1]
EXAMPLES = ROOT / "examples" / "torch"
NAMES = ("quickstart", "serve_decode", "tile_explorer", "train_lm")


def _load(path: Path, name: str):
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_quickstart_on_cpu(capsys):
    assert _load(EXAMPLES / "quickstart.py", "torch_quickstart").main(
        ["--device", "cpu", "--steps", "3"]) == 0
    out = capsys.readouterr().out
    assert "VRF-access reduction:         3.71x" in out
    assert "route mma, CTA tile (bm, bn, bk) = (64, 128, 64)" in out
    assert "kernel vs plain: max |err| 0.00e+00 * max|ref| (tol 0.0001) ok" in out
    assert "loss fell: True" in out


def test_serve_decode_on_cpu(capsys):
    assert _load(EXAMPLES / "serve_decode.py", "torch_serve_decode").main(
        ["--device", "cpu"]) == 0
    out = capsys.readouterr().out
    for arch in ("llama3.2-1b", "zamba2-2.7b", "xlstm-125m"):
        assert f"===== {arch} (smoke config) =====" in out
    assert out.count("generated (2, 8) tokens") == 3


def test_tile_explorer_prints_jaxs_paper_search(capsys):
    mod = _load(EXAMPLES / "tile_explorer.py", "torch_tile_explorer")
    assert mod.main(["256", "512", "1024", "float32"]) == 0
    out = capsys.readouterr().out
    assert "== Hopper tiles for 256x512x1024 (torch.float32) ==" in out
    for variant in ("dense", "sparse", "abft", "baseline"):
        assert f" {variant:>8}: route " in out
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        _load(ROOT / "examples" / "tile_explorer.py", "jax_tile_explorer").paper_search()
    with contextlib.redirect_stdout(io.StringIO()) as ours:
        mod.paper_search()
    assert ours.getvalue() == buf.getvalue()


def test_train_lm_on_cpu(tmp_path, capsys):
    assert _load(EXAMPLES / "train_lm.py", "torch_train_lm").main(
        ["--device", "cpu", "--steps", "2", "--batch", "2", "--seq", "16",
         "--ckpt-dir", str(tmp_path / "ckpt")]) == 0
    out = capsys.readouterr().out
    assert "arch=xlstm-125m-smoke" in out and "done: 2 steps" in out


def test_examples_import_no_jax():
    code = (
        "import importlib.util, sys\n"
        f"sys.path[:0] = [{str(ROOT / 'src')!r}]\n"
        f"for name in {NAMES!r}:\n"
        f"    spec = importlib.util.spec_from_file_location(name, {str(EXAMPLES)!r} + "
        "'/' + name + '.py')\n"
        "    spec.loader.exec_module(importlib.util.module_from_spec(spec))\n"
        "bad = sorted(m for m in sys.modules if m == 'jax' or m.startswith('jax.')\n"
        "             or m == 'repro' or m.startswith('repro.'))\n"
        "assert not bad, bad\n"
        "print('ok')\n")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         timeout=120, cwd=ROOT)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "ok"
