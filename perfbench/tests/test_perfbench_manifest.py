"""BENCHMARK.json against the benchmark's contract, and the files it names."""

import json
import re
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
BENCH = json.loads((ROOT / "BENCHMARK.json").read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
PATHCH = re.compile(r"^[A-Za-z0-9_./-]{1,200}$")
WIDTH = re.compile(r"(hidden|intermediate|latent|state|projection|_dim$|_rank$|head|expansion|"
                   r"per_tok|planes|mlps)")
METRIC_KEYS = {"name", "unit", "better", "source", "layer", "moves"}


def test_top_level_keys():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs", "workloads",
                          "end_to_end", "per_layer"}
    assert len(json.dumps(BENCH).encode()) <= 64 * 1024
    assert 1 <= len(BENCH["command"]) <= 32
    for word in BENCH["command"]:
        assert 1 <= len(word) <= 200 and "\n" not in word and "\t" not in word
        assert not word.startswith("/") and ".." not in word.split("/")
    for p in BENCH["paths"]:
        assert PATHCH.match(p) and (ROOT / p).is_dir()
    assert 1 <= BENCH["run_seconds"] <= 51


def test_run_seconds_fit_a_full_check():
    rs, cells = BENCH["run_seconds"], 24
    assert (2 + 14 * cells) * (rs + 60) + cells * 2 * 90 + 1200 <= 43200


def test_names_units_and_entries():
    for group in ("configs", "workloads", "end_to_end", "per_layer"):
        names = [e["name"] for e in BENCH[group]]
        assert len(names) == len(set(names)), group
        for e in BENCH[group]:
            assert NAME.match(e["name"]), e["name"]
    for m in BENCH["end_to_end"] + BENCH["per_layer"]:
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
    for m in BENCH["end_to_end"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "bound", "source"}
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    for m in BENCH["per_layer"]:
        assert set(m) - {"workloads"} == METRIC_KEYS
        assert m["source"] in ("device_trace", "program_span", "program_counter", "host_clock")
        assert 1 <= len(m["layer"]) <= 200 and "\n" not in m["layer"]
    for w in BENCH["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert w["chips"] in (1, 4) and 1 <= len(w["why"]) <= 200
        assert NAME.match(w["config"]) and NAME.match(w["traffic"])
    pairs = [(w["config"], w["traffic"]) for w in BENCH["workloads"]]
    assert len(pairs) == len(set(pairs))


def cells_reporting(metric):
    return [w["name"] for w in BENCH["workloads"]
            if "workloads" not in metric or w["name"] in metric["workloads"]]


def test_every_cell_reports_setup_another_end_to_end_and_a_layer():
    for w in BENCH["workloads"]:
        e2e = [m["name"] for m in BENCH["end_to_end"] if w["name"] in cells_reporting(m)]
        assert "setup_s" in e2e and len(e2e) >= 2, w["name"]
        assert any(w["name"] in cells_reporting(m) for m in BENCH["per_layer"]), w["name"]


def test_per_layer_metric_moves_an_end_to_end_metric_its_cells_report():
    e2e = {m["name"]: m for m in BENCH["end_to_end"]}
    layers = {}
    for m in BENCH["per_layer"]:
        assert m["moves"] in e2e, m["name"]
        for cell in cells_reporting(m):
            assert cell in cells_reporting(e2e[m["moves"]]), (m["name"], cell)
        assert (ROOT / "perfbench" / "metrics" / f"{m['name']}.py").is_file(), m["name"]
        layers.setdefault(m["layer"].lower(), set()).add(m["layer"])
    assert all(len(v) == 1 for v in layers.values())


@pytest.mark.parametrize("conf", BENCH["configs"], ids=lambda c: c["name"])
def test_config_files(conf):
    path = ROOT / conf["file"]
    assert conf["file"].startswith("perfbench/") and path.is_file()
    body = json.loads(path.read_text())
    assert body["source"] == conf["source"] and body["reduced"] == conf["reduced"]
    assert not [k for k in conf["reduced"] if WIDTH.search(k)]
    assert [w for w in BENCH["workloads"] if w["config"] == conf["name"]]


@pytest.mark.parametrize("cell", BENCH["workloads"], ids=lambda w: w["name"])
def test_cell_files(cell):
    assert (ROOT / "perfbench" / "traffic" / f"{cell['traffic']}.json").is_file()
    limits = json.loads((ROOT / "perfbench" / "limits" / f"{cell['name']}.json").read_text())
    assert limits and all(v["limit"] > 0 for v in limits.values())
