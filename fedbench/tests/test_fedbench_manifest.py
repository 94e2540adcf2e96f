"""BENCHMARK.json against the contract the harness is written to, and the
harness's data-driven layout: every cell, configuration, traffic mix and
per-layer metric is a file that the harness finds by name."""
import json
import re
import shutil

import pytest
import torch

from fedbench.harness import cell, manifest
from fedbench.tests import small

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
SOURCES = {"device_trace", "program_span", "program_counter", "host_clock"}


@pytest.fixture(scope="module")
def bench():
    return manifest.benchmark()


def test_keys_names_and_units(bench):
    assert set(bench) == {"command", "paths", "run_seconds", "configs",
                          "workloads", "end_to_end", "per_layer"}
    assert bench["command"][0] == "python3" and len(bench["command"]) <= 32
    assert 1 <= bench["run_seconds"] <= 51
    for path in bench["paths"]:
        assert (manifest.ROOT / path).is_dir()
    names = [e["name"] for key in ("configs", "workloads", "end_to_end",
                                   "per_layer") for e in bench[key]]
    assert len(names) == len(set(names))
    for n in names:
        assert NAME.match(n), n
    for m in bench["end_to_end"] + bench["per_layer"]:
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
        assert m["source"] in SOURCES
    for m in bench["end_to_end"]:
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    assert "setup_s" in {m["name"] for m in bench["end_to_end"]}
    for w in bench["workloads"]:
        assert len(w["why"]) <= 200 and w["chips"] in (1, 4)
        assert NAME.match(w["config"]) and NAME.match(w["traffic"])
    fours = sum(w["chips"] == 4 for w in bench["workloads"])
    assert fours <= max(1, len(bench["workloads"]) // 4)


def test_every_part_is_a_file_found_by_name(bench):
    used = {w["config"] for w in bench["workloads"]}
    for c in bench["configs"]:
        assert c["name"] in used, f"configuration {c['name']} has no cell"
        cfg = manifest.config(bench, c["name"])
        assert cfg["name"] == c["name"]
        assert set(c["reduced"]) <= set(cfg) and len(c["reduced"]) <= 16
    for w in bench["workloads"]:
        traffic = manifest.traffic(w["traffic"])
        assert (manifest.BENCH / "kinds" / f"{traffic['kind']}.py").is_file()
        assert set(cell.EXACT) <= set(manifest.limits(w["name"])["limits"])
    for m in bench["per_layer"]:
        assert callable(manifest.metric(m["name"]).read), m["name"]


def test_every_cell_reports_what_its_metrics_move(bench):
    e2e = {m["name"]: m for m in bench["end_to_end"]}
    for m in bench["per_layer"]:
        assert m["moves"] in e2e
        for w in m.get("workloads", []):
            manifest.workload(bench, w)
            assert w in e2e[m["moves"]].get("workloads", [w])
    for w in bench["workloads"]:
        assert manifest.per_layer_for(bench, w["name"])
        assert any(w["name"] in m.get("workloads", [w["name"]])
                   for m in bench["end_to_end"] if m["name"] != "setup_s")


def test_harness_names_no_cell_configuration_traffic_or_metric(bench):
    names = ([e["name"] for key in ("configs", "workloads", "per_layer")
              for e in bench[key]] + [w["traffic"] for w in
                                      bench["workloads"]])
    code = [p.read_text() for p in
            list((manifest.BENCH / "harness").glob("*.py"))
            + [manifest.BENCH / "run.py"]]
    for n in names:
        assert not any(f'"{n}"' in text for text in code), n


def test_a_new_cell_configuration_and_metric_are_new_files(
        bench, tmp_path, monkeypatch):
    """A cell on a new configuration and traffic mix, with a new metric,
    runs from files added to a copy of the benchmark, no file changed."""
    shutil.copytree(manifest.BENCH, tmp_path / "fedbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    shutil.copy(manifest.ROOT / "BENCHMARK.json", tmp_path)
    monkeypatch.setattr(manifest, "ROOT", tmp_path)
    monkeypatch.setattr(manifest, "BENCH", tmp_path / "fedbench")
    _, cfg, traffic, limits = small.small("mnist_paper.fleet16_int8", bench)
    cfg["name"] = "mnist_small"
    new = tmp_path / "fedbench"
    (new / "configs" / "mnist_small.json").write_text(json.dumps(cfg))
    (new / "traffic" / "fleet2.json").write_text(json.dumps(traffic))
    (new / "limits" / "mnist_small.fleet2.json").write_text(
        json.dumps(limits))
    (new / "metrics" / "test.rounds.py").write_text(
        'def read(ctx):\n    return ctx["member_rounds"]\n')
    grown = json.loads(json.dumps(bench))
    grown["configs"].append({"name": "mnist_small", "source": "test",
                             "file": "fedbench/configs/mnist_small.json",
                             "reduced": [], "why": "test"})
    grown["workloads"].append({"name": "mnist_small.fleet2",
                               "config": "mnist_small", "traffic": "fleet2",
                               "chips": 1, "why": "test"})
    grown["per_layer"].append({"name": "test.rounds", "unit": "rounds",
                               "better": "higher", "source":
                               "program_counter", "layer": "the window",
                               "moves": "setup_s",
                               "workloads": ["mnist_small.fleet2"]})
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(grown))
    res = cell.run_cell("mnist_small.fleet2", 5, 0.1, False,
                        torch.device("cpu"), 0.0)
    assert res["correct"], res["checks"]
    assert set(cell.metrics(grown, res, False)) == {
        m["name"] for m in grown["end_to_end"]
        if "mnist_small.fleet2" in m.get("workloads", ["mnist_small.fleet2"])}
    assert cell.metrics(grown, res, True)["test.rounds"]["value"] == \
        res["attempted"]
