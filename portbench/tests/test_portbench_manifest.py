"""BENCHMARK.json keeps to the benchmark's contract, and every name in it
has its file in ``portbench/``."""

from __future__ import annotations

import json
import re

import pytest

from conftest import BENCH, ROOT

from portbench.lib.registry import Cell, metric_readers

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.\-]{1,16}$")
KEYS = {
    "top": {"command", "paths", "run_seconds", "configs", "workloads", "end_to_end", "per_layer"},
    "config": {"name", "source", "file", "reduced", "why"},
    "workload": {"name", "config", "traffic", "chips", "why"},
    "end_to_end": {"name", "unit", "better", "bound", "source"},
    "per_layer": {"name", "unit", "better", "source", "layer", "moves"},
}


@pytest.fixture(scope="module")
def manifest():
    return json.loads((ROOT / "BENCHMARK.json").read_text())


def _line(text: str) -> bool:
    return 1 <= len(text) <= 200 and "\n" not in text and "\t" not in text


def test_shape_and_names(manifest):
    assert set(manifest) == KEYS["top"]
    assert manifest["paths"] == ["portbench"] and manifest["command"][1] == "portbench/run.py"
    assert 1 <= manifest["run_seconds"] <= 51
    for key, kind in (("configs", "config"), ("workloads", "workload"),
                      ("end_to_end", "end_to_end"), ("per_layer", "per_layer")):
        names = [e["name"] for e in manifest[key]]
        assert len(names) == len(set(names)), key
        for e in manifest[key]:
            extra = {"workloads"} if kind in ("end_to_end", "per_layer") else set()
            assert KEYS[kind] <= set(e) <= KEYS[kind] | extra, e
            assert NAME.match(e["name"]), e["name"]
            if "unit" in e:
                assert UNIT.match(e["unit"]) and e["better"] in ("lower", "higher")
            for k in ("why", "layer") + (("source",) if kind == "config" else ()):
                if k in e:
                    assert _line(e[k]), (e["name"], k)


def test_every_name_has_its_file(manifest):
    used = set()
    for w in manifest["workloads"]:
        cell = Cell(w["name"])
        assert (cell.workload["config"], cell.workload["traffic"]) == (w["config"], w["traffic"])
        assert cell.chips == w["chips"] == 1
        assert (BENCH / "traffic" / f"{cell.mix['kind']}.py").is_file()
        used.add(w["config"])
    for c in manifest["configs"]:
        assert (ROOT / c["file"]).is_file() and c["file"].startswith("portbench/")
        assert json.loads((ROOT / c["file"]).read_text())["reduced"] == c["reduced"]
    assert used == {c["name"] for c in manifest["configs"]}
    readers = metric_readers()
    cells = {w["name"] for w in manifest["workloads"]}
    e2e = {m["name"] for m in manifest["end_to_end"]}
    for m in manifest["per_layer"]:
        assert m["name"] in readers and readers[m["name"]].UNIT == m["unit"], m["name"]
        assert m["moves"] in e2e and set(m["workloads"]) <= cells
    for m in manifest["end_to_end"]:
        assert 0.01 <= m["bound"] <= 0.25 and m["source"] in ("host_clock", "device_trace")
        assert set(m.get("workloads", cells)) <= cells
    assert any(m["name"] == "setup_s" and m["bound"] <= 0.25 for m in manifest["end_to_end"])
