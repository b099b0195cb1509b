"""BENCHMARK.json against the benchmark's contract, and the files it names
found by name."""

import json
import os
import re

import pytest

from perfbench.core import manifest

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
WIDTHS = re.compile(r"(_dim|_rank)$|hidden|intermediate|latent|state|"
                    r"projection|head|expansion|experts_per|token_dim|"
                    r"mlp_ratio")


@pytest.fixture(scope="module")
def bench():
    return manifest.load()


def test_top_level_keys_and_command(bench):
    assert set(bench) == {"command", "paths", "run_seconds", "configs",
                          "workloads", "end_to_end", "per_layer"}
    assert bench["command"] == ["python3", "perfbench/run.py"]
    assert bench["paths"] == ["perfbench"]
    assert isinstance(bench["run_seconds"], int)
    assert 1 <= bench["run_seconds"] <= 51
    cells = len(bench["workloads"])
    # the check's whole length, at the full 24 cells a later PR may reach
    for n in (cells, 24):
        runs = 2 + 14 * n
        assert (runs * (bench["run_seconds"] + 60) + n * 2 * 90
                + 1200) <= 43200


def test_names_and_units_are_plain(bench):
    names = ([c["name"] for c in bench["configs"]]
             + [w["name"] for w in bench["workloads"]]
             + [w["config"] for w in bench["workloads"]]
             + [w["traffic"] for w in bench["workloads"]]
             + [m["name"] for m in bench["end_to_end"] + bench["per_layer"]]
             + [k for c in bench["configs"] for k in c["reduced"]])
    for n in names:
        assert NAME.match(n), n
    for m in bench["end_to_end"] + bench["per_layer"]:
        assert UNIT.match(m["unit"]), m["unit"]
        assert m["better"] in ("lower", "higher")
    metric_names = [m["name"] for m in bench["end_to_end"]
                    + bench["per_layer"]]
    assert len(set(metric_names)) == len(metric_names)
    assert len({w["name"] for w in bench["workloads"]}) \
        == len(bench["workloads"])
    assert len({(w["config"], w["traffic"]) for w in bench["workloads"]}) \
        == len(bench["workloads"])


def test_entries_have_only_their_keys(bench):
    for c in bench["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert c["file"].startswith("perfbench/")
        assert os.path.exists(os.path.join(manifest.ROOT, c["file"]))
        assert len(c["reduced"]) <= 16
        assert not any(WIDTHS.search(k) for k in c["reduced"])
    for w in bench["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert w["chips"] in (1, 4)
    for m in bench["end_to_end"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "bound",
                                          "source"}
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    for m in bench["per_layer"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better",
                                          "source", "layer", "moves"}
        assert m["source"] in ("device_trace", "program_span",
                               "program_counter", "host_clock")
    texts = ([c["why"] for c in bench["configs"]]
             + [c["source"] for c in bench["configs"]]
             + [w["why"] for w in bench["workloads"]]
             + [m["layer"] for m in bench["per_layer"]]
             + bench["command"])
    for t in texts:
        assert 1 <= len(t) <= 200 and "\n" not in t and "\t" not in t, t
    assert len(json.dumps(bench)) <= 64 * 1024


def test_setup_bound_and_every_cell_reports_enough(bench):
    setup = [m for m in bench["end_to_end"] if m["name"] == "setup_s"]
    assert setup and setup[0]["bound"] <= 0.25
    for w in bench["workloads"]:
        e2e = {m["name"] for m in manifest.end_to_end(bench, w["name"])}
        assert "setup_s" in e2e and len(e2e) >= 2
        assert manifest.per_layer(bench, w["name"])


def test_every_moves_metric_is_reported_in_each_of_its_cells(bench):
    for m in bench["per_layer"]:
        for cell in m["workloads"]:
            e2e = {e["name"] for e in manifest.end_to_end(bench, cell)}
            assert m["moves"] in e2e, (m["name"], cell)


def test_every_named_file_is_found(bench):
    used = set()
    for w in bench["workloads"]:
        entry = manifest.cell(bench, w["name"])
        used.add(w["config"])
        assert entry["config_file"]["name"] == w["config"]
        assert manifest.driver(entry["traffic_file"]["driver"]).run
        assert entry["workload"]["limits"]
    assert used == {c["name"] for c in bench["configs"]}
    for m in bench["end_to_end"] + bench["per_layer"]:
        assert callable(manifest.metric_reader(m["name"]).read)


def test_layers_of_one_name_agree(bench):
    layers = {m["layer"] for m in bench["per_layer"]}
    assert "device" in layers
    assert all("\n" not in layer for layer in layers)
