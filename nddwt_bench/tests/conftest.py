"""CPU tests of the port's benchmark (``nddwt_bench/``).

Run from the repository's root:

    python -m pytest nddwt_bench/tests -q

They drive the harness on the CPU at tiny sizes (``tiny``: a copy of the
benchmark's files with tiny configurations), where the program runs its
plain torch path. Tests marked ``cuda`` need the card and skip elsewhere.
"""

import json
import shutil
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

# The tiny stand-ins of each configuration and traffic mix.
TINY_SHAPES = {3: [16, 16, 12], 2: [24, 16]}
TINY_COILS = 3
TINY_TRAFFIC = {"iters": 4, "ring": 4}


def pytest_configure(config):
    config.addinivalue_line("markers", "cuda: needs an NVIDIA GPU; skips elsewhere")


@pytest.fixture
def cuda():
    """The card, or a skip where this machine has none."""
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return "cuda"


def make_tiny(root: Path) -> dict:
    """Copy the benchmark under ``root`` with every configuration and
    traffic mix cut to a tiny size; returns its ``BENCHMARK.json``."""
    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    shutil.copytree(ROOT / "nddwt_bench", root / "nddwt_bench",
                    ignore=shutil.ignore_patterns("__pycache__", "tests"))
    for entry in bench["configs"]:
        path = root / entry["file"]
        cfg = json.loads(path.read_text())
        cfg["shape"] = TINY_SHAPES[len(cfg["shape"])]
        cfg["coils"] = min(cfg["coils"], TINY_COILS)
        path.write_text(json.dumps(cfg))
    for path in (root / "nddwt_bench" / "traffic").glob("*.json"):
        traffic = json.loads(path.read_text())
        traffic.update({k: v for k, v in TINY_TRAFFIC.items() if k in traffic})
        path.write_text(json.dumps(traffic))
    (root / "BENCHMARK.json").write_text(json.dumps(bench))
    return bench


@pytest.fixture
def tiny(tmp_path):
    """``(bench, root)`` of a tiny copy of the benchmark."""
    return make_tiny(tmp_path), tmp_path


def run_tiny(bench, root, workload, seed=20250101, seconds=0.3, trace=False):
    from nddwt_bench import harness

    return harness.run_cell(bench, workload, seed, seconds, trace, "cpu", root=root)[0]
