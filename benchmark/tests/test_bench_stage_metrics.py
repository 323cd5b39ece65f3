"""The readers of the program's device stage marks
(``benchmark/metrics/*_device_ms*.py``, ``graph_launch_gap_ms``,
``device_idle_untraced_pct.infer``) on synthetic windows, their entries in
BENCHMARK.json, and a run of each cell on the CPU at small widths in which
every one of its stage metrics finds its span."""

from __future__ import annotations

import json
import os

import pytest

from benchmark import run
from benchmark.harness import ROOT, Window
from benchmark.tests import tiny

STAGES = {  # metric -> (span, cells)
    "codec_encode_device_ms.infer": ("device.codec_encode", ["flamed_serve_single"]),
    "durations_device_ms": ("device.durations", ["flamed_serve_single", "flamed_batch4_offline"]),
    "prior_decode_device_ms": ("device.prior_decode", ["flamed_serve_single", "flamed_batch4_offline"]),
    "denoiser_device_ms": ("device.denoiser", ["flamed_serve_single", "flamed_batch4_offline"]),
    "codec_decode_device_ms.infer": ("device.codec_decode", ["flamed_serve_single", "flamed_batch4_offline"]),
    "graph_launch_gap_ms": ("device_gap.graph_launch", ["flamed_serve_single", "flamed_batch4_offline"]),
    "codec_encode_device_ms.codec": ("device.codec_encode", ["facodec_roundtrip"]),
    "codec_decode_device_ms.codec": ("device.codec_decode", ["facodec_roundtrip"]),
}
IDLE = "device_idle_untraced_pct.infer"


def window(spans, calls=4, seconds=2.0):
    return Window([{} for _ in range(calls)], seconds, spans, {}, 1.0)


@pytest.fixture(scope="module")
def entries():
    with open(os.path.join(ROOT, "BENCHMARK.json"), encoding="utf-8") as f:
        return {m["name"]: m for m in json.load(f)["per_layer"]}


@pytest.mark.parametrize("name", sorted(STAGES))
def test_stage_reader_is_its_span_a_call(name):
    span, _ = STAGES[name]
    read = run.metric_reader(ROOT, name)
    spans = {span: (0.5, 4), "device.other": (9.0, 4), "fused_dispatch": (1.0, 4)}
    assert read(window(spans)) == pytest.approx(125.0)  # 0.5 s over 4 calls
    assert read(window(spans, calls=2)) == pytest.approx(250.0)  # a retry's second run counts
    assert read(window({"device.other": (9.0, 4)})) is None
    assert read(window({span: (0.0, 0)})) is None
    assert read(window(spans, calls=0)) is None


def test_idle_untraced_is_the_window_without_the_device_stages():
    read = run.metric_reader(ROOT, IDLE)
    spans = {"device.durations": (0.2, 4), "device.denoiser": (1.0, 4), "device.graph_copy_in": (0.1, 4),
             "device_gap.graph_launch": (0.3, 4), "fused_get": (1.5, 4)}
    assert read(window(spans, seconds=2.0)) == pytest.approx(100.0 * (1 - 1.3 / 2.0))
    assert read(window({"fused_get": (1.5, 4), "device_gap.graph_launch": (0.3, 4)})) is None
    assert read(window({})) is None


def test_entries(entries):
    for name, (_, cells) in STAGES.items():
        m = entries[name]
        assert m["source"] == "program_span" and m["unit"] == "ms" and m["better"] == "lower"
        assert m["workloads"] == cells
        assert m["moves"] == ("codec_rtf" if cells == ["facodec_roundtrip"] else "rtf")
        assert m["layer"] == ("captured executor" if name == "graph_launch_gap_ms" else "prior, denoiser, codec")
    idle = entries[IDLE]
    assert (idle["unit"], idle["moves"], idle["layer"], idle["source"]) == ("%", "rtf", "device", "program_span")
    assert idle["workloads"] == entries["device_idle_pct.infer"]["workloads"]


@pytest.mark.parametrize("workload", ["flamed_serve_single", "facodec_roundtrip", "flamed_batch4_offline"])
def test_a_cpu_run_reads_every_stage_of_its_cell(workload, monkeypatch):
    """The program's marks reach the readers through the harness's spans:
    a traced run on the CPU (whose numbers the run drops) reads each of the
    cell's stage metrics but the graph launch gap (the CPU runs every call
    eagerly), the stages a call sum to less than its latency, and the
    untraced idle share lies in [0, 100]."""
    read = {}
    per_layer = run.per_layer

    def keep(bench, cell, w, root):
        out = per_layer(bench, cell, w, root)
        read.update(out, latency_ms=1e3 * sum(r["latency_s"] for r in w.records) / len(w.records))
        return out

    monkeypatch.setattr(run, "per_layer", keep)
    res = run.run(["--workload", workload, "--seed", str(2**31 + 5), "--seconds", "1", "--trace", "1"],
                  device="cpu", overrides=tiny.overrides(workload))
    assert res["correct"] and res["metrics"] == {}
    mine = {n for n, (_, cells) in STAGES.items() if workload in cells}
    if workload != "facodec_roundtrip":
        mine.add(IDLE)
    assert mine - set(read) == ({"graph_launch_gap_ms"} & mine), sorted(mine - set(read))
    stages = [read[n]["value"] for n in mine if n not in (IDLE, "graph_launch_gap_ms")]
    assert all(v > 0 for v in stages) and sum(stages) <= read["latency_ms"]
    if IDLE in mine:
        assert 0 <= read[IDLE]["value"] <= 100
