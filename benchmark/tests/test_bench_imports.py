"""Nothing a run imports is JAX or the JAX package, compared by whole
top-level names (``recbox_tpu_torch``, the port, begins with
``recbox_tpu``); the plain references import nothing of the port."""

import ast
import json
import subprocess
import sys

import pytest

from benchmark.run import FORBIDDEN
from benchmark.spec import ROOT, Spec

SPEC = Spec()
PORT = "recbox_tpu_torch"


def _run(code: str) -> str:
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, timeout=600)
    assert out.returncode == 0, out.stderr[-3000:]
    return out.stdout.strip().splitlines()[-1]


@pytest.mark.parametrize("cell", sorted(SPEC.cells))
def test_dry_run_loads_no_jax(cell):
    """A whole run of the cell, cut to a small size, on the CPU."""
    loaded = json.loads(_run(
        "import json\n"
        "from benchmark.spec import Spec\n"
        "from benchmark.run import run_cell, forbidden_modules\n"
        "from benchmark.tests.sizes import small\n"
        f"spec = Spec(); cfg, t = small(spec, {cell!r})\n"
        f"run_cell(spec, {cell!r}, 5, 0.2, True, device='cpu', config=cfg,"
        " traffic=t)\n"
        "print(json.dumps(forbidden_modules()))"))
    assert loaded == []


def test_forbidden_names_compare_whole():
    assert "recbox_tpu" in FORBIDDEN and PORT.split(".")[0] not in FORBIDDEN


@pytest.mark.parametrize("name", sorted({c["reference"] for c in (
    SPEC.config(SPEC.cell(w)) for w in SPEC.cells)}))
def test_reference_imports_nothing_of_the_port(name):
    path = ROOT / "benchmark" / "reference" / f"{name}.py"
    tree = ast.parse(path.read_text())
    tops = {a.name.split(".")[0] for node in ast.walk(tree)
            if isinstance(node, ast.Import) for a in node.names}
    tops |= {node.module.split(".")[0] for node in ast.walk(tree)
             if isinstance(node, ast.ImportFrom) and node.module}
    assert not tops & (set(FORBIDDEN) | {PORT, "benchmark"}), tops
    loaded = json.loads(_run(
        "import json, sys\n"
        "from benchmark.spec import load_module\n"
        f"load_module(__import__('pathlib').Path({str(path)!r}))\n"
        "print(json.dumps(sorted({m.split('.')[0] for m in sys.modules})))"))
    assert PORT not in loaded and not set(loaded) & set(FORBIDDEN)


def test_harness_sources_import_no_jax():
    for path in (ROOT / "benchmark").rglob("*.py"):
        tree = ast.parse(path.read_text())
        for node in ast.walk(tree):
            names = [a.name for a in node.names] \
                if isinstance(node, ast.Import) else \
                [node.module] if isinstance(node, ast.ImportFrom) \
                and node.module else []
            assert not {n.split(".")[0] for n in names} & set(FORBIDDEN), \
                (path, names)
