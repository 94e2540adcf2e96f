"""Finding a cell's parts by name: the manifest (BENCHMARK.json at the root
of the checkout), a configuration's file, its model family's module, a
traffic mix's file, a cell's limits, a traffic kind's module and a
per-layer metric's reader. Nothing here names a cell, a configuration, a
family or a metric: adding one is adding files."""
from __future__ import annotations

import functools
import importlib.util
import json
from pathlib import Path

BENCH = Path(__file__).resolve().parents[1]
ROOT = BENCH.parent

# What a model family's module gives the harness (families/cnn.py says
# what each is).
FAMILY = ("registry_differences", "param_shapes", "init_params",
          "reference", "CONTROL", "member_round", "member_eval",
          "peak_flops")


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
    cfg = json.loads((ROOT / entry["file"]).read_text())
    if "family" not in cfg:
        raise SystemExit(f"configuration {name!r} names no model family: "
                         f"{entry['file']} needs a \"family\" key, the "
                         f"name of a module under fedbench/families/")
    return cfg


def traffic(name: str) -> dict:
    return json.loads((BENCH / "traffic" / f"{name}.json").read_text())


def limits(cell: str) -> dict:
    return json.loads((BENCH / "limits" / f"{cell}.json").read_text())


def _module(path: Path, name: str):
    spec = importlib.util.spec_from_file_location(name, path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


@functools.lru_cache(maxsize=None)
def _family_at(path: Path, name: str):
    return _module(path, name)


def family(name: str):
    """A model family's module: fedbench/families/<name>.py, giving the
    names in FAMILY. Loaded once a process: the harness asks for it at
    every step, and a module executed again each time leaves the garbage
    collector at another phase when the program starts, which moves the
    Study cells' peak memory by up to 5% (PERF.md §7)."""
    return _family_at(BENCH / "families" / f"{name}.py",
                      f"fedbench_family_{name}")


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
