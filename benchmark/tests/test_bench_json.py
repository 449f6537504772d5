"""``BENCHMARK.json`` keeps to the benchmark's contract: its keys, names,
units and characters, and every cell, configuration and metric it names
has its file here."""

import json
import os
import re

import pytest

BENCH = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
REPO = os.path.dirname(BENCH)
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
PATH = re.compile(r"^[A-Za-z0-9_./-]{1,200}$")


@pytest.fixture(scope="module")
def bench():
    with open(os.path.join(REPO, "BENCHMARK.json")) as f:
        text = f.read()
    assert len(text.encode()) <= 64 * 1024
    return json.loads(text)


def _line(s):
    return isinstance(s, str) and 1 <= len(s) <= 200 and "\n" not in s \
        and "\t" not in s


def test_top_level_keys(bench):
    assert set(bench) == {"command", "paths", "run_seconds", "configs",
                          "workloads", "end_to_end", "per_layer"}
    assert 1 <= len(bench["command"]) <= 32
    assert all(_line(w) for w in bench["command"])
    assert 1 <= len(bench["paths"]) <= 16
    for p in bench["paths"]:
        assert PATH.match(p) and not p.startswith("/") and ".." not in p
        assert not p.endswith("_torch")
    for word in bench["command"][1:]:
        if "/" in word:
            assert any(word.startswith(p + "/") for p in bench["paths"])
    assert isinstance(bench["run_seconds"], int)
    assert 1 <= bench["run_seconds"] <= 51


def test_names_units_and_characters(bench):
    names = []
    for c in bench["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert NAME.match(c["name"]) and _line(c["source"]) and _line(c["why"])
        assert len(c["reduced"]) <= 16
        assert all(NAME.match(k) for k in c["reduced"])
        assert any(c["file"].startswith(p + "/") for p in bench["paths"])
        names.append(c["name"])
    assert len(set(names)) == len(names)
    cells = []
    for w in bench["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        for k in ("name", "config", "traffic"):
            assert NAME.match(w[k]), w[k]
        assert w["config"] in names and w["chips"] in (1, 4)
        assert _line(w["why"])
        cells.append(w["name"])
    assert len(set(cells)) == len(cells)
    assert len({(w["config"], w["traffic"])
                for w in bench["workloads"]}) == len(cells)
    assert sum(w["chips"] == 4 for w in bench["workloads"]) <= max(
        1, len(cells) // 4)
    metrics = []
    for m in bench["end_to_end"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "bound",
                                          "source"}
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
        metrics.append(m["name"])
    assert "setup_s" in metrics
    for m in bench["per_layer"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "source",
                                          "layer", "moves"}
        assert m["moves"] in metrics and _line(m["layer"])
        assert m["source"] in ("device_trace", "program_span",
                               "program_counter", "host_clock")
        for cell in m.get("workloads", ()):
            assert cell in cells
        metrics.append(m["name"])
    assert len(set(metrics)) == len(metrics)
    for m in bench["end_to_end"] + bench["per_layer"]:
        assert NAME.match(m["name"]) and UNIT.match(m["unit"])
        assert m["better"] in ("lower", "higher")


def test_every_piece_has_its_file(bench):
    from benchlib import registry

    units = {m["name"]: m["unit"] for m in bench["per_layer"]}
    for w in bench["workloads"]:
        cell = registry.Cell(w["name"])
        assert cell.spec["config"] == w["config"]
        assert cell.chips == w["chips"]
        assert cell.spec["why"] == w["why"]
        assert cell.limits, "a cell compares at least one number"
        for name, reader in cell.metrics.items():
            assert units[name] == reader.UNIT
            listed = [m for m in bench["per_layer"] if m["name"] == name][0]
            assert w["name"] in listed.get("workloads", [w["name"]])
    for c in bench["configs"]:
        cfg = registry.load_json("configs", c["name"])
        assert os.path.join(REPO, c["file"]) == os.path.join(
            BENCH, "configs", c["name"] + ".json")
        assert sorted(cfg["reduced"]) == sorted(c["reduced"])
        assert len(cfg["source"]) <= 200
