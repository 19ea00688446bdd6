"""The harness finds every configuration, traffic, traffic kind, limit
file and per-layer metric of BENCHMARK.json by its name, and BENCHMARK.json
keeps the contract's shape."""

import importlib
import json
import re

import pytest

from splatbench import run

SPEC = run.load_json(run.ROOT / "BENCHMARK.json")
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
KIND_API = ("setup", "window", "traced_window", "wind_down", "numbers",
            "control", "work")


@pytest.mark.parametrize("cell", [c["name"] for c in SPEC["workloads"]])
def test_cell_found_by_name(cell):
    c = run.find_cell(SPEC, cell)
    config, traffic = run.load_cell(c)
    assert config["render"]["width"] > 0
    kind = importlib.import_module(f"splatbench.kinds.{traffic['kind']}")
    for fn in KIND_API:
        assert callable(getattr(kind, fn))
    limits = run.load_limits(cell)
    assert limits, f"no limits file for {cell}"
    e2e = {m["name"] for m in run.cell_metrics(SPEC, "end_to_end", cell)}
    assert "setup_s" in e2e and len(e2e) >= 2
    assert run.cell_metrics(SPEC, "per_layer", cell)


@pytest.mark.parametrize("metric", [m["name"] for m in SPEC["per_layer"]])
def test_metric_reader_found_by_name(metric):
    assert callable(run.metric_reader(metric))


@pytest.mark.parametrize("config", SPEC["configs"], ids=lambda c: c["name"])
def test_config_file_matches_its_entry(config):
    path = run.ROOT / config["file"]
    data = json.loads(path.read_text())
    assert data["source"] == config["source"]
    assert data["reduced"] == config["reduced"]
    assert len(config["source"]) <= 200


def test_names_units_and_keys():
    assert set(SPEC) == {"command", "paths", "run_seconds", "configs",
                         "workloads", "end_to_end", "per_layer"}
    names = ([c["name"] for c in SPEC["configs"]]
             + [w["name"] for w in SPEC["workloads"]]
             + [m["name"] for m in SPEC["end_to_end"] + SPEC["per_layer"]])
    assert len(names) == len(set(names))
    assert all(NAME.match(n) for n in names)
    e2e = {m["name"]: m for m in SPEC["end_to_end"]}
    for m in SPEC["per_layer"]:
        assert m["moves"] in e2e
        for w in m["workloads"]:
            assert w in e2e[m["moves"]].get("workloads", [w])
    for m in SPEC["end_to_end"]:
        assert 0.01 <= m["bound"] <= 0.25
        assert m["source"] in ("host_clock", "device_trace")
    assert len(json.dumps(SPEC)) < 64 * 1024


def test_a_new_metric_file_is_found(tmp_path, monkeypatch):
    """Adding a metric is adding its file: the reader is loaded from
    splatbench/metrics/<name>.py, nothing else is edited."""
    (tmp_path / "metrics").mkdir()
    (tmp_path / "metrics" / "new_metric.x.py").write_text(
        "def read(trace):\n    return trace['calls'] * 2\n")
    monkeypatch.setattr(run, "HERE", tmp_path)
    assert run.metric_reader("new_metric.x")({"calls": 3}) == 6
