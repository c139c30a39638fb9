"""The harness finds everything by name, from files alone, and
BENCHMARK.json keeps to the benchmark's contract."""

from __future__ import annotations

import json
import os
import re
import shutil

import pytest

from portbench import harness

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")


def _bench(root):
    with open(os.path.join(root, "BENCHMARK.json")) as fp:
        return json.load(fp)


def test_benchmark_json_keeps_to_the_contract(root):
    b = _bench(root)
    assert set(b) == {"command", "paths", "run_seconds", "configs", "workloads", "end_to_end", "per_layer"}
    assert b["paths"] == ["portbench"] and b["command"] == ["python3", "portbench/run.py"]
    assert 1 <= b["run_seconds"] <= 51
    metrics = b["end_to_end"] + b["per_layer"]
    names = [x["name"] for x in b["configs"] + b["workloads"] + metrics]
    assert len(names) == len(set(names)) and all(NAME.match(n) for n in names)
    assert all(UNIT.match(m["unit"]) and m["better"] in ("lower", "higher") for m in metrics)
    e2e = {m["name"]: m for m in b["end_to_end"]}
    assert e2e["setup_s"]["bound"] <= 0.25
    assert all(0.01 <= m["bound"] <= 0.25 and m["source"] in ("host_clock", "device_trace") for m in e2e.values())
    for c in b["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"} and c["file"].startswith("portbench/")
        assert os.path.isfile(os.path.join(root, c["file"]))
    for w in b["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"} and w["chips"] == 1
        assert len(w["why"]) <= 200 and NAME.match(w["traffic"])
        cell = harness.find_cell(root, w["name"])
        reported = {m["name"] for m in cell.metrics_e2e}
        assert "setup_s" in reported and len(reported) >= 2 and cell.metrics_layer
    for m in b["per_layer"]:
        assert set(m) <= {"name", "unit", "better", "source", "layer", "moves", "workloads"}
        assert m["moves"] in e2e
        for cell in m["workloads"]:  # every listed cell reports the metric it moves
            assert cell in e2e[m["moves"]].get("workloads", [cell])
    for m in metrics:  # every metric has its reader, its own or its kind's
        base = os.path.join(root, "portbench", "metrics")
        assert os.path.isfile(os.path.join(base, m["name"] + ".py")) or os.path.isfile(
            os.path.join(base, m["name"].split(".")[0] + ".py"))


def test_a_new_cell_is_new_files_and_entries(root, tmp_path):
    """A configuration, a traffic mix, a cell's limits and a per-layer
    metric added as new files, and entries added to BENCHMARK.json: the
    harness finds them all by name, and no file it had was edited."""
    new = tmp_path / "checkout"
    shutil.copytree(os.path.join(root, "portbench"), new / "portbench",
                    ignore=shutil.ignore_patterns("__pycache__", "tests"))
    before = {p: (new / "portbench" / p).read_bytes() for p in ("traffic/recon_scan.json", "configs/avatar_fast.json")}
    b = _bench(root)
    (new / "portbench/configs/avatar_small.json").write_text(json.dumps({"name": "avatar_small", "field": {}}))
    (new / "portbench/traffic/recon_small.json").write_text(json.dumps({"job": "recon_scan", "views": 10}))
    (new / "portbench/limits/recon_small.small.json").write_text(json.dumps({"loss": 1e-5}))
    (new / "portbench/metrics/steps_per_s.py").write_text(
        "def read(view):\n    return view.units / view.window_s\n")
    b["configs"].append({"name": "avatar_small", "source": "https://example.org/x", "reduced": [],
                         "file": "portbench/configs/avatar_small.json", "why": "a smaller field"})
    b["workloads"].append({"name": "recon_small.small", "config": "avatar_small", "traffic": "recon_small",
                           "chips": 1, "why": "a smaller set"})
    b["per_layer"].append({"name": "steps_per_s", "unit": "1/s", "better": "higher", "source": "host_clock",
                           "layer": "train step", "moves": "train_step_ms", "workloads": ["recon_small.small"]})
    b["per_layer"].append({"name": "idle_share.small", "unit": "%", "better": "lower", "source": "device_trace",
                           "layer": "device", "moves": "train_step_ms", "workloads": ["recon_small.small"]})
    next(m for m in b["end_to_end"] if m["name"] == "train_step_ms")["workloads"].append("recon_small.small")
    (new / "BENCHMARK.json").write_text(json.dumps(b))
    cell = harness.find_cell(str(new), "recon_small.small")
    assert cell.config["name"] == "avatar_small" and cell.traffic["views"] == 10 and cell.limits == {"loss": 1e-5}
    assert [m["name"] for m in cell.metrics_layer] == ["steps_per_s", "idle_share.small"]
    assert {m["name"] for m in cell.metrics_e2e} == {"train_step_ms", "setup_s"}
    view = harness.View(cell=cell, job=None, device_name="cpu", setup_s=1.5, window_s=2.0, window_start=0.0,
                        window_end=2.0, units=8, spans=harness.Spans())
    # a metric of a kind the harness reads already needs no file of its own
    view.cuda = harness.Traced(window_s=1.0, units=4, counters={}, events=[], dev_events=[], busy_us=2.5e5)
    assert harness.read_metrics(str(new), cell.metrics_layer, view) == {
        "steps_per_s": {"value": 4.0, "unit": "1/s"}, "idle_share.small": {"value": 75.0, "unit": "%"}}
    assert harness.read_metrics(str(new), cell.metrics_e2e, view) == {
        "train_step_ms": {"value": 250.0, "unit": "ms"}, "setup_s": {"value": 1.5, "unit": "s"}}
    assert harness.job_module(cell.traffic["job"]).build  # the traffic names a job the harness has
    assert all((new / "portbench" / p).read_bytes() == v for p, v in before.items())


def test_unknown_workload_is_refused(root):
    with pytest.raises(SystemExit):
        harness.find_cell(root, "no_such.cell")


def test_a_metric_with_nothing_to_read_is_left_out(root):
    cell = harness.find_cell(root, "recon_scan.fast")
    view = harness.View(cell=cell, job=None, device_name="cpu", setup_s=1.0, window_s=1.0, window_start=0.0,
                        window_end=1.0, units=3, spans=harness.Spans())
    # no trace: every per-layer reader finds nothing and says so
    assert harness.read_metrics(root, cell.metrics_layer, view) == {}
