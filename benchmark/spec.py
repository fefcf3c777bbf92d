"""`BENCHMARK.json` and the files it names, found by name.

A cell (an entry of ``workloads``) names a configuration and a traffic mix;
each resolves to a file of its own, and so does each per-layer metric and
each cell's limits. A later change adds a configuration, a traffic mix, a
cell or a metric by adding files and entries, never by editing one.
"""

from __future__ import annotations

import importlib.util
import json
import re
from pathlib import Path
from types import ModuleType
from typing import Dict, List, Optional

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent

NAME = re.compile(r"[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}")
UNIT = re.compile(r"[A-Za-z0-9_/%.-]{1,16}")


def valid_name(s: str) -> bool:
    return isinstance(s, str) and NAME.fullmatch(s) is not None


def valid_unit(s: str) -> bool:
    return isinstance(s, str) and UNIT.fullmatch(s) is not None


def load_module(path: Path) -> ModuleType:
    """The Python file at ``path`` as a module of its own (metric readers
    carry dots in their names, so they are loaded by path)."""
    spec = importlib.util.spec_from_file_location(
        "benchmark_" + path.stem.replace(".", "_").replace("-", "_"), path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def _json(path: Path) -> dict:
    with open(path) as fh:
        return json.load(fh)


class Spec:
    """The parsed `BENCHMARK.json` of ``root``, with the files under this
    folder that its names resolve to."""

    def __init__(self, root: Path = ROOT, folder: Optional[Path] = None):
        self.root = Path(root)
        self.folder = Path(folder) if folder else HERE
        self.data = _json(self.root / "BENCHMARK.json")
        self.configs = {c["name"]: c for c in self.data["configs"]}
        self.cells = {w["name"]: w for w in self.data["workloads"]}
        self.end_to_end = {m["name"]: m for m in self.data["end_to_end"]}
        self.per_layer = {m["name"]: m for m in self.data["per_layer"]}

    def cell(self, name: str) -> dict:
        if name not in self.cells:
            raise KeyError(f"no workload {name!r} in BENCHMARK.json; "
                           f"cells: {sorted(self.cells)}")
        return self.cells[name]

    def config(self, cell: dict) -> dict:
        return _json(self.root / self.configs[cell["config"]]["file"])

    def traffic_path(self, cell: dict) -> Path:
        return self.folder / "traffic" / f"{cell['traffic']}.json"

    def traffic(self, cell: dict) -> dict:
        return _json(self.traffic_path(cell))

    def limits_path(self, cell: dict) -> Path:
        return self.folder / "limits" / f"{cell['name']}.json"

    def limits(self, cell: dict) -> Dict[str, float]:
        return {k: float(v["limit"])
                for k, v in _json(self.limits_path(cell)).items()}

    def system_path(self, config: dict) -> Path:
        return self.folder / "systems" / f"{config['system']}.py"

    def reference_path(self, config: dict) -> Path:
        return self.folder / "reference" / f"{config['reference']}.py"

    def metric_path(self, name: str) -> Path:
        return self.folder / "metrics" / f"{name}.py"

    def end_to_end_of(self, cell: dict) -> List[str]:
        """The end-to-end metrics ``cell`` reports: those without a
        ``workloads`` key, and those whose key lists it."""
        return [n for n, m in self.end_to_end.items()
                if cell["name"] in m.get("workloads", [cell["name"]])]

    def per_layer_of(self, cell: dict) -> List[str]:
        """The per-layer metrics ``cell`` reports: those listing it, and
        those without a ``workloads`` key whose moved metric it reports."""
        e2e = set(self.end_to_end_of(cell))
        return [n for n, m in self.per_layer.items()
                if (cell["name"] in m["workloads"] if "workloads" in m
                    else m["moves"] in e2e)]
