"""The port stands alone: no module of ``repro_torch`` (nor chip_smoke.py,
nor the port's examples) imports ``jax``, the JAX package or its
evaluation (``benchmarks``), and its entry
points refuse to run on a card that is absent unless the caller asks for
the CPU."""
import ast
import os
import subprocess
import sys
from pathlib import Path

import pytest

torch = pytest.importorskip("torch")

ROOT = Path(__file__).resolve().parents[1]
PORT = ROOT / "src" / "repro_torch"


def _modules():
    for path in sorted(PORT.rglob("*.py")):
        rel = path.relative_to(ROOT / "src").with_suffix("")
        parts = rel.parts[:-1] if rel.name == "__init__" else rel.parts
        yield ".".join(parts)


def test_import_every_module_without_jax_in_a_subprocess():
    """A fresh interpreter (this one already holds jax through conftest)."""
    code = (
        "import importlib, sys\n"
        f"for m in {list(_modules())!r}:\n"
        "    importlib.import_module(m)\n"
        "bad = sorted(m for m in sys.modules if m == 'jax' or "
        "m.startswith('jax.') or m == 'repro' or m.startswith('repro.'))\n"
        "assert not bad, bad\n"
        "print('ok', len(sys.modules))\n")
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    res = subprocess.run([sys.executable, "-c", code], env=env, cwd=ROOT,
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stderr
    assert res.stdout.startswith("ok")


def _imports(path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.module:
            yield node.module


@pytest.mark.parametrize("path", sorted(PORT.rglob("*.py")) +
                         [ROOT / "chip_smoke.py"] +
                         sorted(ROOT.glob("examples/*_torch.py")),
                         ids=lambda p: str(p.relative_to(ROOT)))
def test_no_jax_or_repro_import(path):
    for name in _imports(path):
        top = name.split(".")[0]
        assert top not in ("jax", "jaxlib", "repro", "benchmarks"), \
            (path, name)


def test_entry_points_need_a_card_unless_told_cpu(monkeypatch):
    from repro_torch.configs import get_config
    from repro_torch.models import build_model
    from repro_torch.serving.engine import ServingEngine
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = get_config("llama3.2-3b").reduced()
    with pytest.raises(RuntimeError, match="device='cpu'"):
        build_model(cfg)
    model = build_model(cfg, device="cpu")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        ServingEngine(model, model.init(0))
    ServingEngine(model, model.init(0), device="cpu")


def test_train_entry_point_needs_a_card_unless_told_cpu(monkeypatch):
    from repro_torch.launch.train import main, run
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        run("llama3.2-3b", steps=1)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        main(["--arch", "llama3.2-3b", "--steps", "1"])
    out = run("llama3.2-3b", steps=1, batch=1, seq_len=8, log_every=0,
              device="cpu")
    assert out["steps"] == 1 and out["losses"] == []


@pytest.mark.parametrize("script", ["quickstart_torch.py",
                                    "serve_demo_torch.py",
                                    "train_100m_torch.py"])
def test_examples_need_a_card_unless_told_cpu(monkeypatch, script):
    import importlib.util
    spec = importlib.util.spec_from_file_location(
        script[:-3], ROOT / "examples" / script)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        mod.main([])
