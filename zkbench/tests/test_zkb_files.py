"""Every configuration, mix and metric that BENCHMARK.json names loads by
name, and the manifest keeps to the benchmark's contract."""

import json
import re

import pytest

from zkbench import check, harness, spans

BENCH = json.loads(harness.MANIFEST.read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")


@pytest.mark.parametrize("cell", [w["name"] for w in BENCH["workloads"]])
def test_cell_loads_by_name(cell):
    w, config, mix, metrics = harness.cell_files(cell)
    assert cell == f"{w['config']}.{w['traffic']}"
    assert config["name"] == w["config"]
    assert config["guest"] in harness.GUESTS
    assert harness.scheme(config)[0] in check.SCHEMES
    assert mix["warmup_steps"] >= 1 and mix["checked_steps"] >= 1
    data = harness.inputs(config, mix, 2**31 + 12345)
    assert data["elf"][:4] == b"\x7fELF"
    again = harness.inputs(config, mix, 2**31 + 12345)
    assert data == again
    names = {m["name"] for m, _ in metrics}
    listed = {m["name"] for m in BENCH["per_layer"]
              if cell in m["workloads"]}
    assert names == listed
    for _, mod in metrics:
        assert callable(mod.read)


@pytest.mark.parametrize("metric", [m["name"] for m in BENCH["per_layer"]])
def test_metric_targets_exist_in_the_program(metric):
    """Every function a metric's spans wrap is there today (a rename
    later leaves the metric silent, not the run broken)."""
    mod = harness.reader(metric)
    for span, targets in getattr(mod, "TARGETS", {}).items():
        for module, path in targets:
            owner, attr = spans.resolve(module, path)
            assert owner is not None, (span, module, path)


def test_manifest_keeps_to_the_contract():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs",
                          "workloads", "end_to_end", "per_layer"}
    assert 1 <= BENCH["run_seconds"] <= 51
    names = [x["name"] for k in ("configs", "workloads", "end_to_end",
                                 "per_layer") for x in BENCH[k]]
    for n in names:
        assert NAME.match(n), n
    for k in ("configs", "workloads"):
        assert len({x["name"] for x in BENCH[k]}) == len(BENCH[k])
    metric_names = [m["name"] for m in BENCH["end_to_end"]
                    + BENCH["per_layer"]]
    assert len(set(metric_names)) == len(metric_names)
    cells = {w["name"] for w in BENCH["workloads"]}
    for c in BENCH["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert c["file"].startswith("zkbench/")
        assert 0 < len(c["source"]) <= 200 and 0 < len(c["why"]) <= 200
    for w in BENCH["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert w["chips"] == 1 and len(w["why"]) <= 200
    e2e = {m["name"] for m in BENCH["end_to_end"]}
    assert "setup_s" in e2e
    for m in BENCH["end_to_end"]:
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
        assert 0.01 <= m["bound"] <= 0.25
        assert m["source"] in ("host_clock", "device_trace")
    layers = {}
    for m in BENCH["per_layer"]:
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
        assert m["moves"] in e2e and set(m["workloads"]) <= cells
        assert m["source"] in ("device_trace", "program_span",
                               "program_counter", "host_clock")
        layers.setdefault(m["layer"], 0)
    for cell in cells:
        assert any(cell in m["workloads"] for m in BENCH["per_layer"])
    assert len(harness.MANIFEST.read_bytes()) <= 64 * 1024


@pytest.mark.parametrize("cell", [w["name"] for w in BENCH["workloads"]])
def test_cell_reports_setup_and_another_end_to_end_metric(cell):
    e2e = harness.end_to_end(cell)
    assert "setup_s" in e2e and len(e2e) >= 2
    for m in BENCH["per_layer"]:
        if cell in m["workloads"]:
            assert m["moves"] in e2e, (cell, m["name"])


def test_end_to_end_metrics_follow_their_workloads():
    bench = {"end_to_end": [{"name": "a"}, {"name": "b", "workloads": ["x"]}]}
    assert harness.end_to_end("x", bench) == ["a", "b"]
    assert harness.end_to_end("y", bench) == ["a"]
