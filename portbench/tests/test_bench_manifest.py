"""BENCHMARK.json against the contract's rules that a file can show:
names and units in the allowed characters, every cell's files present and
found by name, every per-layer metric reported with the end-to-end metric
it moves, one chip a cell."""
import json
import os
import re

import pytest
from harness import registry

from conftest import BENCH, REPO

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")


@pytest.fixture(scope="module")
def man():
    with open(os.path.join(REPO, "BENCHMARK.json")) as f:
        return json.load(f)


def test_keys_and_command(man):
    assert list(man) == ["command", "paths", "run_seconds", "configs",
                         "workloads", "end_to_end", "per_layer"]
    assert man["command"] == ["python3", "portbench/run.py"]
    assert man["paths"] == ["portbench"]
    assert 1 <= man["run_seconds"] <= 51
    assert os.path.getsize(os.path.join(REPO, "BENCHMARK.json")) < 64 * 1024


def test_names_and_units(man):
    names = []
    for c in man["configs"]:
        assert NAME.match(c["name"]) and set(c) == {
            "name", "source", "file", "reduced", "why"}
        assert all(NAME.match(k) for k in c["reduced"])
        assert len(c["reduced"]) <= 16
        names.append(c["name"])
    for w in man["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert NAME.match(w["name"]) and NAME.match(w["traffic"])
        assert len(w["why"]) <= 200 and "\n" not in w["why"]
        names.append(w["name"])
    for m in man["end_to_end"] + man["per_layer"]:
        assert NAME.match(m["name"]) and UNIT.match(m["unit"])
        assert m["better"] in ("lower", "higher")
        names.append(m["name"])
    for text in ([c["source"] for c in man["configs"]]
                 + [m["layer"] for m in man["per_layer"]]):
        assert 1 <= len(text) <= 200 and "\n" not in text and "\t" not in text
    assert len(names) == len(set(names))


def test_one_chip_a_cell(man):
    assert all(w["chips"] == 1 for w in man["workloads"])


def test_bounds(man):
    for m in man["end_to_end"]:
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    assert any(m["name"] == "setup_s" for m in man["end_to_end"])


def test_every_file_a_cell_needs(man):
    cfg_names = {c["name"] for c in man["configs"]}
    for c in man["configs"]:
        assert c["file"] == f"portbench/configs/{c['name']}.json"
        assert os.path.exists(os.path.join(REPO, c["file"]))
    for w in man["workloads"]:
        assert w["config"] in cfg_names
        for sub in (f"mixes/{w['traffic']}.json", f"limits/{w['name']}.json"):
            assert os.path.exists(os.path.join(BENCH, sub)), sub
    for m in man["end_to_end"]:
        if m["name"] != "setup_s":
            registry.reader_path(BENCH, "end_to_end", m["name"])
    for m in man["per_layer"]:
        registry.reader_path(BENCH, "metrics", m["name"])


def test_per_layer_moves_are_reported_in_its_cells(man):
    e2e = {m["name"]: m for m in man["end_to_end"]}
    cells = {w["name"] for w in man["workloads"]}
    layers = {}
    for m in man["per_layer"]:
        assert m["moves"] in e2e and m["moves"] != "setup_s"
        assert m["source"] in ("device_trace", "program_span",
                               "program_counter", "host_clock")
        target = e2e[m["moves"]]
        for cell in m["workloads"]:
            assert cell in cells
            assert "workloads" not in target or cell in target["workloads"]
        layers.setdefault(m["layer"], m["layer"])
    for cell in cells:
        reports = [m for m in man["end_to_end"]
                   if "workloads" not in m or cell in m["workloads"]]
        assert len(reports) >= 2
        assert any(cell in m["workloads"] for m in man["per_layer"])


def test_config_files_hold_the_cells_shapes(man):
    for c in man["configs"]:
        with open(os.path.join(REPO, c["file"])) as f:
            cfg = json.load(f)
        assert cfg["name"] == c["name"] and cfg["source"] == c["source"]
        assert set(c["reduced"]) == set(cfg["reduced"])
        assert cfg["forest"]["early_stop_rounds"] == 0
