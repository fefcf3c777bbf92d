"""`BENCHMARK.json` against the benchmark's contract, and the harness's
lookup of every file by name."""

import json
import shutil

import pytest

from benchmark.spec import ROOT, Spec, load_module, valid_name, valid_unit

SPEC = Spec()
CELLS = sorted(SPEC.cells)
METRICS = sorted(SPEC.per_layer)
SOURCES = {"device_trace", "program_span", "program_counter", "host_clock"}


def test_top_level_keys():
    assert set(SPEC.data) == {"command", "paths", "run_seconds", "configs",
                              "workloads", "end_to_end", "per_layer"}
    assert 1 <= SPEC.data["run_seconds"] <= 51
    assert all(not p.endswith("_torch") and (ROOT / p).is_dir()
               for p in SPEC.data["paths"])
    assert len(SPEC.data["command"]) <= 32
    assert (ROOT / "BENCHMARK.json").stat().st_size <= 64 * 1024


@pytest.mark.parametrize("cell", CELLS)
def test_cell_resolves_its_files(cell):
    c = SPEC.cell(cell)
    cfg = SPEC.config(c)
    assert SPEC.traffic_path(c).is_file()
    assert SPEC.limits(c)
    assert SPEC.system_path(cfg).is_file()
    assert SPEC.reference_path(cfg).is_file()
    for metric in SPEC.per_layer_of(c):
        assert SPEC.metric_path(metric).is_file(), metric
    assert "setup_s" in SPEC.end_to_end_of(c)
    assert len(SPEC.end_to_end_of(c)) >= 2 and SPEC.per_layer_of(c)
    assert c["chips"] in (1, 4)


@pytest.mark.parametrize("metric", METRICS)
def test_metric_moves_one_end_to_end_metric(metric):
    m = SPEC.per_layer[metric]
    reader = load_module(SPEC.metric_path(metric))
    assert reader.MOVES == m["moves"] and reader.UNIT == m["unit"]
    assert m["moves"] in SPEC.end_to_end and m["moves"] != "setup_s"
    for cell in m.get("workloads", CELLS):
        if metric in SPEC.per_layer_of(SPEC.cell(cell)):
            assert m["moves"] in SPEC.end_to_end_of(SPEC.cell(cell))
    if metric.endswith("_roofline") or "mfu" in metric:
        assert m["unit"] == "%"


def test_layers_name_alike():
    layers = {m["layer"] for m in SPEC.per_layer.values()}
    assert all(0 < len(x) <= 200 and "\n" not in x for x in layers)


def test_names_units_and_limits():
    names = [c["name"] for c in SPEC.data["configs"]] \
        + [w["name"] for w in SPEC.data["workloads"]] \
        + list(SPEC.end_to_end) + list(SPEC.per_layer)
    assert len(names) == len(set(names))
    for n in names:
        assert valid_name(n), n
    for w in SPEC.data["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert valid_name(w["traffic"]) and w["config"] in SPEC.configs
        assert 0 < len(w["why"]) <= 200
    for c in SPEC.data["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert len(c["reduced"]) <= 16 and 0 < len(c["source"]) <= 200
        assert all(valid_name(k) for k in c["reduced"])
        assert c["file"].startswith("benchmark/")
    for m in SPEC.end_to_end.values():
        assert set(m) - {"workloads"} == {"name", "unit", "better", "bound",
                                          "source"}
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    for m in SPEC.per_layer.values():
        assert set(m) - {"workloads"} == {"name", "unit", "better", "source",
                                          "layer", "moves"}
        assert m["source"] in SOURCES
    for m in list(SPEC.end_to_end.values()) + list(SPEC.per_layer.values()):
        assert valid_unit(m["unit"]) and m["better"] in ("lower", "higher")


def test_chips_fit_and_check_budget():
    rs, cells = SPEC.data["run_seconds"], len(SPEC.cells)
    assert sum(w["chips"] == 4 for w in SPEC.data["workloads"]) <= \
        max(1, cells // 4)
    full = 2 + 14 * 24
    assert full * (rs + 60) + 24 * 2 * 90 + 1200 <= 43200


def test_new_files_are_picked_up(tmp_path):
    """A configuration, a traffic mix, a cell and a metric added as files
    and entries only: the harness finds and runs them."""
    import torch

    from benchmark.run import run_cell
    from benchmark.tests.sizes import small

    folder = tmp_path / "benchmark"
    shutil.copytree(ROOT / "benchmark", folder,
                    ignore=shutil.ignore_patterns("__pycache__", "tests"))
    cfg, traffic = small(SPEC, "youtubednn-1m.cascade-k10000")
    cfg["name"] = "youtubednn-small"
    (folder / "configs" / "youtubednn-small.json").write_text(
        json.dumps(cfg))
    (folder / "traffic" / "tiny.json").write_text(json.dumps(traffic))
    limits = json.loads((folder / "limits" /
                         "youtubednn-1m.cascade-k10000.json").read_text())
    (folder / "limits" / "youtubednn-small.tiny.json").write_text(
        json.dumps(limits))
    (folder / "metrics" / "calls_per_s.py").write_text(
        'UNIT = "calls/s"\nMOVES = "serve_users_per_s"\n\n\n'
        'def read(run):\n    return run.calls / run.window_s\n')
    data = json.loads((ROOT / "BENCHMARK.json").read_text())
    data["configs"].append({"name": "youtubednn-small", "source": "x",
                            "file": "benchmark/configs/youtubednn-small.json",
                            "reduced": [], "why": "a test"})
    data["workloads"].append({"name": "youtubednn-small.tiny",
                              "config": "youtubednn-small",
                              "traffic": "tiny", "chips": 1, "why": "a test"})
    data["per_layer"].append({"name": "calls_per_s", "unit": "calls/s",
                              "better": "higher", "source": "host_clock",
                              "layer": "service",
                              "moves": "serve_users_per_s",
                              "workloads": ["youtubednn-small.tiny"]})
    for m in data["end_to_end"]:
        if "workloads" in m and m["name"] != "train_examples_per_s":
            m["workloads"].append("youtubednn-small.tiny")
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(data))
    spec = Spec(root=tmp_path, folder=folder)
    cell = spec.cell("youtubednn-small.tiny")
    assert "calls_per_s" in spec.per_layer_of(cell)
    assert spec.config(cell)["name"] == "youtubednn-small"
    out = run_cell(spec, "youtubednn-small.tiny", 7, 0.2, True,
                   device="cpu")
    assert out.per_layer["calls_per_s"][0] > 0
    assert set(out.end_to_end) == {"serve_users_per_s", "query_p95_ms",
                                   "setup_s"}
    assert torch.isfinite(torch.tensor(list(out.numbers.values()))).all()
