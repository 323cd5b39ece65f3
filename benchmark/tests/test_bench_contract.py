"""BENCHMARK.json against the rules it is checked by, and every cell's files
found by name."""

from __future__ import annotations

import json
import math
import os
import re
import shutil
import time

import pytest

from benchmark import run
from benchmark.harness import ROOT, Window

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.\-]{1,16}$")
PATH = re.compile(r"^[A-Za-z0-9_.\-/]{1,200}$")
TOP_KEYS = {"command", "paths", "run_seconds", "configs", "workloads", "end_to_end", "per_layer"}
SOURCES = {"device_trace", "program_span", "program_counter", "host_clock"}


@pytest.fixture(scope="module")
def bench():
    with open(os.path.join(ROOT, "BENCHMARK.json"), encoding="utf-8") as f:
        return json.load(f)


def line(text):
    return isinstance(text, str) and 1 <= len(text) <= 200 and "\n" not in text and "\t" not in text


def test_loads_with_exactly_the_keys(bench):
    assert set(bench) == TOP_KEYS
    assert os.path.getsize(os.path.join(ROOT, "BENCHMARK.json")) <= 64 * 1024


def test_command_and_paths(bench):
    assert 1 <= len(bench["paths"]) <= 16
    for p in bench["paths"]:
        assert PATH.match(p) and not p.startswith("/") and ".." not in p.split("/")
        assert not p.endswith("_torch")
    assert 1 <= len(bench["command"]) <= 32 and all(line(w) for w in bench["command"])
    assert isinstance(bench["run_seconds"], int) and 1 <= bench["run_seconds"] <= 51
    # a full check of 24 cells: 2 + 14 runs a cell, each run_seconds + 60 s,
    # 2 x 90 s of compiling a cell, 1200 s spare
    assert (2 + 14 * 24) * (bench["run_seconds"] + 60) + 24 * 180 + 1200 <= 43200


def test_names_units_and_lines(bench):
    names = []
    for group in ("configs", "workloads", "end_to_end", "per_layer"):
        for entry in bench[group]:
            assert NAME.match(entry["name"]), entry["name"]
            names.append((group if group in ("configs", "workloads") else "metric", entry["name"]))
            if "unit" in entry:
                assert UNIT.match(entry["unit"]), entry["unit"]
                assert entry["better"] in ("lower", "higher")
                assert entry["source"] in SOURCES
            for key in ("why", "layer", "source"):
                if key in entry and group != "end_to_end":
                    assert line(entry[key]), (entry["name"], key)
    assert len(names) == len(set(names))


def test_configs(bench):
    assert 1 <= len(bench["configs"]) <= 24
    used = {w["config"] for w in bench["workloads"]}
    files = set()
    for c in bench["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert c["name"] in used
        assert c["file"].startswith("benchmark/") and c["file"] not in files
        files.add(c["file"])
        with open(os.path.join(ROOT, c["file"]), encoding="utf-8") as f:
            body = json.load(f)
        assert body["source"] == c["source"] and body["reduced"] == c["reduced"]
        assert len(c["reduced"]) <= 16 and all(NAME.match(k) for k in c["reduced"])


def test_cells_find_their_files(bench):
    configs = {c["name"] for c in bench["configs"]}
    pairs = set()
    for w in bench["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert w["config"] in configs and w["chips"] in (1, 4) and line(w["why"])
        assert NAME.match(w["traffic"])
        assert (w["config"], w["traffic"]) not in pairs
        pairs.add((w["config"], w["traffic"]))
        with open(os.path.join(ROOT, "benchmark", "traffic", w["traffic"] + ".json"), encoding="utf-8") as f:
            mix = json.load(f)
        assert os.path.isfile(os.path.join(ROOT, "benchmark", "drivers", mix["driver"] + ".py"))
        assert os.path.isfile(os.path.join(ROOT, "benchmark", "limits", w["name"] + ".json"))
    for m in bench["end_to_end"] + bench["per_layer"]:
        assert os.path.isfile(os.path.join(ROOT, "benchmark", "metrics", m["name"] + ".py")), m["name"]


def test_metrics(bench):
    e2e = {m["name"]: m for m in bench["end_to_end"]}
    assert "setup_s" in e2e and e2e["setup_s"]["bound"] <= 0.25
    for m in bench["end_to_end"]:
        assert set(m) <= {"name", "unit", "better", "bound", "source", "workloads"}
        assert 0.01 <= m["bound"] <= 0.25 and m["source"] in ("host_clock", "device_trace")
    layers = {}
    for m in bench["per_layer"]:
        assert set(m) <= {"name", "unit", "better", "source", "layer", "moves", "workloads"}
        assert m["moves"] in e2e
        for w in m.get("workloads", []):
            assert w in e2e[m["moves"]].get("workloads", [w])
        layers.setdefault(m["layer"], set()).add(m["name"])
        if m["name"].endswith("_roofline") or "mfu" in m["name"]:
            assert m["unit"] == "%"
    cells = {w["name"] for w in bench["workloads"]}
    for cell in cells:
        mine = [m for m in bench["end_to_end"] if cell in m.get("workloads", [cell])]
        assert "setup_s" in {m["name"] for m in mine} and len(mine) >= 2
        assert any(cell in m.get("workloads", [cell]) for m in bench["per_layer"])


class StubDriver:
    """A cell of another kind: its records carry neither audio nor latency."""

    arithmetic = "fp32"

    def __init__(self, ctx):
        self.ctx, self.items = ctx, 0

    def setup(self):
        pass

    def counters(self):
        return {"items": float(self.items)}

    def call(self):
        time.sleep(0.01)
        self.items += 3
        return {"items": 3}

    def free(self):
        pass

    def check(self, records, seed):
        return {"stub_gap": 0.0}


STUB_BENCH = {
    "workloads": [{"name": "stub_cell", "config": "stub", "traffic": "stub_mix", "chips": 1, "why": "a stub"}],
    "end_to_end": [
        {"name": "stub_items_per_s", "unit": "items/s", "better": "higher", "bound": 0.05,
         "source": "host_clock", "workloads": ["stub_cell"]},
        {"name": "setup_s", "unit": "s", "better": "lower", "bound": 0.25, "source": "host_clock"}],
    "per_layer": [{"name": "stub_items", "unit": "items", "better": "higher", "source": "program_counter",
                   "layer": "stub", "moves": "stub_items_per_s"}],
}


@pytest.mark.parametrize("trace", [0, 1])
def test_a_new_cell_and_metrics_run_without_an_edit_of_the_harness(tmp_path, trace):
    """A cell with an end-to-end metric and a per-layer metric of its own,
    added as files only, runs through ``benchmark.run`` unchanged."""
    def put(rel, text):
        path = tmp_path / rel
        path.parent.mkdir(parents=True, exist_ok=True)
        path.write_text(text)

    put("BENCHMARK.json", json.dumps(STUB_BENCH))
    put("benchmark/configs/stub.json", "{}")
    put("benchmark/traffic/stub_mix.json", json.dumps({"driver": "stub", "trace_calls": 1}))
    put("benchmark/limits/stub_cell.json", json.dumps({"stub_gap": 0}))
    put("benchmark/metrics/stub_items_per_s.py",
        "def read(w):\n    return sum(r['items'] for r in w.records) / w.seconds\n")
    put("benchmark/metrics/stub_items.py",
        "def read(w):\n    return w.counters['items_after'] - w.counters['items_before']\n")
    shutil.copy(os.path.join(ROOT, "benchmark", "metrics", "setup_s.py"), tmp_path / "benchmark" / "metrics")
    res = run.run(["--workload", "stub_cell", "--seed", str(2**31 + 5), "--seconds", "0.2",
                   "--trace", str(trace)], root=str(tmp_path), device="cpu", overrides={"driver": StubDriver})
    assert res["correct"] and res["attempted"] >= 1 and res["metrics"] == {}

    window = Window([{"items": 3}] * 4, 2.0, {}, {"items_before": 1.0, "items_after": 13.0}, math.nan,
                    setup_s=1.5)
    cell = STUB_BENCH["workloads"][0]
    assert run.end_to_end(STUB_BENCH, cell, window, str(tmp_path)) == {
        "stub_items_per_s": {"value": 6.0, "unit": "items/s"}, "setup_s": {"value": 1.5, "unit": "s"}}
    assert run.per_layer(STUB_BENCH, cell, window, str(tmp_path)) == {
        "stub_items": {"value": 12.0, "unit": "items"}}
