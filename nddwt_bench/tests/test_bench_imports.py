"""What the benchmark loads: never JAX, its libraries or the JAX package
(top-level names compared whole: the port's name begins with the JAX
package's), and a reference that loads nothing of the program."""

import ast
import json
import subprocess
import sys

import pytest
from conftest import ROOT

from nddwt_bench import harness

_RUN_ALL = """
import json, sys
from pathlib import Path
sys.path.insert(0, {root!r})
sys.path.insert(0, {tests!r})
from conftest import make_tiny
from nddwt_bench import harness
root = Path({tmp!r})
bench = make_tiny(root)
for cell in bench["workloads"]:
    for trace in (False, True):
        harness.run_cell(bench, cell["name"], 11, 0.2, trace, "cpu", root=root)
print(json.dumps(sorted({{m.partition(".")[0] for m in sys.modules}})))
"""

_REFERENCE = """
import json, sys
sys.path.insert(0, {root!r})
import nddwt_bench.reference.solvers, nddwt_bench.reference.nddwt_fft
print(json.dumps(sorted({{m.partition(".")[0] for m in sys.modules}})))
"""


def _top_level(code, tmp_path):
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         cwd=tmp_path, timeout=600, check=True).stdout
    return set(json.loads(out.strip().splitlines()[-1]))


def test_a_run_loads_no_jax(tmp_path):
    code = _RUN_ALL.format(root=str(ROOT), tests=str(ROOT / "nddwt_bench" / "tests"),
                           tmp=str(tmp_path))
    loaded = _top_level(code, tmp_path)
    assert "non_decimated_wavelets_tpu_torch" in loaded  # the program ran
    assert not loaded & harness.FORBIDDEN, loaded & harness.FORBIDDEN


def test_reference_loads_nothing_of_the_program(tmp_path):
    loaded = _top_level(_REFERENCE.format(root=str(ROOT)), tmp_path)
    assert "non_decimated_wavelets_tpu_torch" not in loaded
    assert not loaded & harness.FORBIDDEN


@pytest.mark.parametrize("path", sorted((ROOT / "nddwt_bench" / "reference").glob("*.py")),
                         ids=lambda p: p.name)
def test_reference_imports(path):
    """The reference's own imports: torch, the standard library and itself."""
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            names = [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom):
            names = [node.module or ""] if node.level == 0 else []
        else:
            continue
        for name in names:
            assert name.partition(".")[0] in {"torch", "math", "__future__"}, name


def test_forbidden_names_compared_whole(monkeypatch):
    monkeypatch.setitem(sys.modules, "non_decimated_wavelets_tpu_torch_extra", sys)
    assert "non_decimated_wavelets_tpu_torch_extra" not in harness.forbidden_modules()
    monkeypatch.setitem(sys.modules, "non_decimated_wavelets_tpu.ops", sys)
    monkeypatch.setitem(sys.modules, "jaxlib", sys)
    found = harness.forbidden_modules()
    assert "non_decimated_wavelets_tpu" in found and "jaxlib" in found
