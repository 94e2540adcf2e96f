"""Finding a cell's parts by name: the manifest (BENCHMARK.json at the root
of the checkout), a configuration's file, a traffic mix's file, a cell's
limits, a traffic kind's module and a per-layer metric's reader. Nothing
here names a cell, a configuration or a metric: adding one is adding
files."""
from __future__ import annotations

import importlib.util
import json
from pathlib import Path

BENCH = Path(__file__).resolve().parents[1]
ROOT = BENCH.parent


def benchmark() -> dict:
    return json.loads((ROOT / "BENCHMARK.json").read_text())


def _one(entries, name, what):
    found = [e for e in entries if e["name"] == name]
    if len(found) != 1:
        raise SystemExit(f"no {what} named {name!r} in BENCHMARK.json")
    return found[0]


def workload(bench: dict, name: str) -> dict:
    return _one(bench["workloads"], name, "workload")


def config(bench: dict, name: str) -> dict:
    entry = _one(bench["configs"], name, "configuration")
    return json.loads((ROOT / entry["file"]).read_text())


def traffic(name: str) -> dict:
    return json.loads((BENCH / "traffic" / f"{name}.json").read_text())


def limits(cell: str) -> dict:
    return json.loads((BENCH / "limits" / f"{cell}.json").read_text())


def _module(path: Path, name: str):
    spec = importlib.util.spec_from_file_location(name, path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def kind(name: str):
    """The traffic kind's module: fedbench/kinds/<name>.py."""
    return _module(BENCH / "kinds" / f"{name}.py", f"fedbench_kind_{name}")


def metric(name: str):
    """A per-layer metric's reader: fedbench/metrics/<name>.py, with
    read(ctx) -> a number, or None when the run holds nothing to read.
    Its unit, layer, source and what it moves are its BENCHMARK.json
    entry's."""
    return _module(BENCH / "metrics" / f"{name}.py",
                   "fedbench_metric_" + name.replace(".", "_"))


def per_layer_for(bench: dict, cell: str) -> list:
    """The per-layer metrics a cell reports: those that list it, and those
    without a list (the contract allows an entry without one) whose
    end-to-end metric it reports."""
    e2e = {m["name"]: m.get("workloads", [cell]) for m in bench["end_to_end"]}
    return [m for m in bench["per_layer"]
            if cell in m.get("workloads", e2e[m["moves"]])]
