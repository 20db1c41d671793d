"""``BENCHMARK.json`` against the rules a benchmark file keeps, and every
cell resolving by name to its configuration, traffic, driver, limits and
metric files."""

import json
import os
import re

import pytest

from portbench.common import HERE, ROOT, applies, cell_files, load_module, read_json

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
PATH = re.compile(r"^[A-Za-z0-9_./-]{1,200}$")
SOURCES = {"device_trace", "program_span", "program_counter", "host_clock"}
BENCH = read_json(os.path.join(ROOT, "BENCHMARK.json"))
CELLS = [w["name"] for w in BENCH["workloads"]]


def _line(text):
    return isinstance(text, str) and 1 <= len(text) <= 200 and "\n" not in text \
        and "\t" not in text


def test_top_level_keys_and_size():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs", "workloads",
                          "end_to_end", "per_layer"}
    assert os.path.getsize(os.path.join(ROOT, "BENCHMARK.json")) <= 64 * 1024
    assert 1 <= len(BENCH["paths"]) <= 16
    for p in BENCH["paths"]:
        assert PATH.match(p) and not p.startswith("/") and ".." not in p.split("/")
        assert not p.endswith("_torch")
    assert 1 <= len(BENCH["command"]) <= 32
    assert all(_line(w) for w in BENCH["command"])
    named = [w for w in BENCH["command"] if "/" in w]
    assert all(any(w.startswith(p + "/") for p in BENCH["paths"]) for w in named)


def test_run_seconds_fit_a_full_check():
    rs = BENCH["run_seconds"]
    assert isinstance(rs, int) and 1 <= rs <= 51
    assert (2 + 14 * 24) * (rs + 60) + 24 * 2 * 90 + 1200 <= 43200


@pytest.mark.parametrize("section", ["configs", "workloads", "end_to_end", "per_layer"])
def test_names_units_and_keys(section):
    keys = {"configs": {"name", "source", "file", "reduced", "why"},
            "workloads": {"name", "config", "traffic", "chips", "why"},
            "end_to_end": {"name", "unit", "better", "bound", "source"},
            "per_layer": {"name", "unit", "better", "source", "layer", "moves"}}[section]
    limits = {"configs": 24, "workloads": 24, "end_to_end": 16, "per_layer": 128}[section]
    entries = BENCH[section]
    assert 1 <= len(entries) <= limits
    names = [e["name"] for e in entries]
    assert len(names) == len(set(names))
    for e in entries:
        assert set(e) - {"workloads"} == keys, e["name"]
        assert NAME.match(e["name"])
        if section in ("end_to_end", "per_layer"):
            assert UNIT.match(e["unit"]) and e["better"] in ("lower", "higher")
            assert e["source"] in SOURCES
            assert set(e.get("workloads", CELLS)) <= set(CELLS)
        if section == "configs":
            assert _line(e["source"]) and _line(e["why"]) and len(e["reduced"]) <= 16
            assert all(NAME.match(k) for k in e["reduced"])
        if section == "workloads":
            assert e["chips"] in (1, 4) and _line(e["why"])
            assert NAME.match(e["config"]) and NAME.match(e["traffic"])


def test_metric_rules():
    e2e = {m["name"]: m for m in BENCH["end_to_end"]}
    assert "setup_s" in e2e and e2e["setup_s"]["bound"] <= 0.25
    for m in e2e.values():
        assert 0.01 <= m["bound"] <= 0.25
        assert m["source"] in ("host_clock", "device_trace")
    for m in BENCH["per_layer"]:
        assert m["moves"] in e2e and _line(m["layer"])
        # a per-layer metric names its cells, each of which reports what it moves
        assert m["workloads"] and all(applies(e2e[m["moves"]], w) for w in m["workloads"])
        if m["name"].endswith("_roofline"):
            assert m["unit"] == "%"
    pairs = [(w["config"], w["traffic"]) for w in BENCH["workloads"]]
    assert len(pairs) == len(set(pairs))
    four = sum(w["chips"] == 4 for w in BENCH["workloads"])
    assert four <= max(1, len(BENCH["workloads"]) // 4)


@pytest.mark.parametrize("cell", CELLS)
def test_cell_reports_enough(cell):
    e2e = [m["name"] for m in BENCH["end_to_end"] if applies(m, cell)]
    assert "setup_s" in e2e and len(e2e) >= 2
    per = [m for m in BENCH["per_layer"] if applies(m, cell)]
    assert per
    for m in per:
        assert m["moves"] in e2e, (cell, m["name"])


@pytest.mark.parametrize("cell", CELLS)
def test_cell_resolves_by_name(cell):
    f = cell_files(BENCH, cell)
    for key in ("config_file", "traffic_file", "limits_file"):
        assert os.path.isfile(f[key]), f[key]
    cfg = read_json(f["config_file"])
    entry = f["config"]
    assert entry["file"].startswith(tuple(p + "/" for p in BENCH["paths"]))
    assert cfg["name"] == entry["name"] and cfg["source"] == entry["source"]
    assert cfg["reduced"] == entry["reduced"] and all(k in cfg for k in cfg["reduced"])
    traffic = read_json(f["traffic_file"])
    assert os.path.isfile(os.path.join(HERE, "drivers", traffic["driver"] + ".py"))
    limits = read_json(f["limits_file"])
    assert limits and all(v > 0 for v in limits.values())
    e2e = [m for m in BENCH["end_to_end"] if applies(m, cell)]
    for m in e2e + [m for m in BENCH["per_layer"] if applies(m, cell)]:
        mod = load_module(os.path.join(HERE, "metrics", m["name"] + ".py"), "m_" + m["name"])
        assert callable(mod.read)


def test_config_files_are_distinct():
    files = [c["file"] for c in BENCH["configs"]]
    assert len(files) == len(set(files))
    used = {w["config"] for w in BENCH["workloads"]}
    assert used == {c["name"] for c in BENCH["configs"]}
    for c in BENCH["configs"]:
        json.loads(open(os.path.join(ROOT, c["file"])).read())
