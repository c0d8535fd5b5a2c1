"""The benchmark's own tests: ``python -m pytest -q portbench/tests`` from
the checkout's root.  Tests marked ``card`` need an NVIDIA card and skip
without one (the ``card`` fixture decides, at run time)."""
import os
import shutil
import sys
from pathlib import Path

import pytest

BENCH = Path(__file__).resolve().parents[1]
ROOT = BENCH.parent
for p in (str(ROOT / "src"), str(BENCH)):
    if p not in sys.path:
        sys.path.insert(0, p)


def pytest_configure(config):
    config.addinivalue_line("markers", "card: needs an NVIDIA card")


@pytest.fixture
def card():
    import torch
    if not torch.cuda.is_available():
        pytest.skip("no CUDA card here: the run measures on the card only")
    return torch.device("cuda", 0)


@pytest.fixture
def checkout(tmp_path):
    """A checkout of the benchmark beside a link to the program."""
    root = tmp_path / "co"
    root.mkdir()
    shutil.copytree(BENCH, root / "portbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    shutil.copy(ROOT / "BENCHMARK.json", root)
    os.symlink(ROOT / "src", root / "src")
    return root
