"""BENCHMARK.json keeps to the contract's characters and finds every file."""

import re
from pathlib import Path

import pytest

from benchmark.lib import cell

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
PATH = re.compile(r"^[A-Za-z0-9_./-]{1,200}$")


def line(s):
    return isinstance(s, str) and 1 <= len(s) <= 200 and "\n" not in s and "\t" not in s


def test_top_level_keys(bench):
    assert set(bench) == {"command", "paths", "run_seconds", "configs", "workloads",
                          "end_to_end", "per_layer"}
    assert 1 <= bench["run_seconds"] <= 51 and isinstance(bench["run_seconds"], int)
    assert all(PATH.match(p) and ".." not in p and not p.startswith("/") for p in bench["paths"])
    assert len(bench["command"]) <= 32 and all(line(w) for w in bench["command"])


def test_names_and_units(bench):
    metrics = bench["end_to_end"] + bench["per_layer"]
    for group in (bench["configs"], bench["workloads"], metrics):
        names = [x["name"] for x in group]
        assert len(names) == len(set(names))
        assert all(NAME.match(n) for n in names), names
    for m in metrics:
        assert UNIT.match(m["unit"]), m
        assert m["better"] in ("lower", "higher")
    for w in bench["workloads"]:
        assert NAME.match(w["config"]) and NAME.match(w["traffic"]) and line(w["why"])
        assert w["chips"] in (1, 4)
    for c in bench["configs"]:
        assert line(c["source"]) and line(c["why"]) and len(c["reduced"]) <= 16
        assert all(NAME.match(k) for k in c["reduced"])


def test_entries_have_the_contract_keys(bench):
    for c in bench["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
    for w in bench["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
    for m in bench["end_to_end"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "bound", "source"}
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    assert any(m["name"] == "setup_s" for m in bench["end_to_end"])
    e2e = {m["name"] for m in bench["end_to_end"]}
    for m in bench["per_layer"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "source", "layer", "moves"}
        assert m["moves"] in e2e and line(m["layer"])


def test_every_part_is_found(bench):
    root = cell.ROOT
    for c in bench["configs"]:
        f = Path(c["file"])
        assert f.parts[0] in bench["paths"] and (root / f).is_file()
        cfg = cell.config(bench, c["name"])
        assert cfg["name"] == c["name"] and cell.engine(cfg).reference is not None
        assert set(cfg["check_limits"]) == {"missing_share", "score_err"}
    for w in bench["workloads"]:
        cell.config(bench, w["config"])
        t = cell.traffic(w["traffic"])
        assert t["queries_per_call"] >= 1 and t["trace_calls"] >= 1
    for m in bench["end_to_end"] + bench["per_layer"]:
        assert callable(cell.reader(m["name"]).read)


def test_every_cell_reports_what_it_must(bench):
    for w in bench["workloads"]:
        e2e = {m["name"] for m in cell.metrics_of(bench, w["name"], "end_to_end")}
        layer = cell.metrics_of(bench, w["name"], "per_layer")
        assert "setup_s" in e2e and len(e2e) >= 2 and layer
        assert all(m["moves"] in e2e for m in layer)
    for m in bench["per_layer"]:
        for name in m.get("workloads", []):
            cell.workload(bench, name)


@pytest.mark.parametrize("path", sorted((cell.HERE).rglob("*")))
def test_file_names_use_name_characters(path):
    rel = path.relative_to(cell.ROOT).as_posix()
    if "__pycache__" in rel:
        return
    assert PATH.match(rel), rel
