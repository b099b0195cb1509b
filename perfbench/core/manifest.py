"""`BENCHMARK.json` and the files it names, found by name.

A cell's entry in `workloads` names its configuration (`configs/<config>
.json`) and traffic (`traffic/<traffic>.json`, whose `driver` names
`drivers/<driver>.py`); `workloads/<cell>.json` holds the cell's
correctness limits.  A metric is read by `metrics/<name>.py`.  The
end-to-end metrics a cell reports are those that list it under
`workloads`, or that have no such list; a per-layer metric is reported in
the cells it lists, or in every cell that reports its `moves` metric.
"""

from __future__ import annotations

import importlib
import importlib.util
import json
import os
from types import ModuleType

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ROOT = os.path.dirname(HERE)
MANIFEST = os.path.join(ROOT, "BENCHMARK.json")


def _json(base: str, *parts: str) -> dict:
    with open(os.path.join(base, *parts)) as f:
        return json.load(f)


def load(path: str = MANIFEST) -> dict:
    with open(path) as f:
        return json.load(f)


def cell(manifest: dict, name: str, base: str = HERE) -> dict:
    """The cell's manifest entry with its files, under `base`, read in:
    `config_file`, `traffic_file` and `workload` dicts."""
    entries = [w for w in manifest["workloads"] if w["name"] == name]
    if not entries:
        raise KeyError(f"no workload {name!r} in BENCHMARK.json")
    entry = dict(entries[0])
    workload = _json(base, "workloads", f"{name}.json")
    for key in ("config", "traffic"):
        if workload.get(key) != entry[key]:
            raise ValueError(f"workloads/{name}.json names {key} "
                             f"{workload.get(key)!r}, BENCHMARK.json "
                             f"{entry[key]!r}")
    entry["workload"] = workload
    entry["config_file"] = _json(base, "configs", f"{entry['config']}.json")
    entry["traffic_file"] = _json(base, "traffic",
                                  f"{entry['traffic']}.json")
    return entry


def end_to_end(manifest: dict, name: str) -> list[dict]:
    return [m for m in manifest["end_to_end"]
            if name in m.get("workloads", [name])]


def per_layer(manifest: dict, name: str) -> list[dict]:
    e2e = {m["name"] for m in end_to_end(manifest, name)}
    return [m for m in manifest["per_layer"]
            if (name in m["workloads"] if "workloads" in m
                else m["moves"] in e2e)]


def _load_file(path: str, modname: str) -> ModuleType:
    spec = importlib.util.spec_from_file_location(modname, path)
    if spec is None or spec.loader is None:
        raise ImportError(f"cannot load {path}")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def metric_reader(name: str, base: str = HERE) -> ModuleType:
    return _load_file(os.path.join(base, "metrics", f"{name}.py"),
                      f"perfbench_metric_{name.replace('.', '_')}")


def driver(name: str) -> ModuleType:
    return importlib.import_module(f"perfbench.drivers.{name}")
