"""Run one cell of the benchmark once.

    python3 -m benchmark.run --workload <name> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout.  ``BENCHMARK.json`` names the cell's
configuration (``benchmark/configs/<config>.json``) and traffic mix
(``benchmark/traffic/<mix>.json``, whose ``driver`` names the loop in
``benchmark/drivers/``); every metric, end-to-end or per-layer, is a reader
in ``benchmark/metrics/<metric>.py``, and a run reads only the cell's own.
Nothing here names a cell or a metric.

A run: set-up (weights from the seed, the program built, every shape the
mix uses warmed up: ``setup_s``), a closed-loop window of ``--seconds``,
with ``--trace 1`` a profiled slice of a few calls after it, then the check
of a sample of the window's outputs against the plain reference (a driver's
optional ``keep`` takes what the check needs from the program before the
program is freed).  The last
line of standard output is one JSON object; the numbers compared, each
beside its limit, are the last lines of standard error and the last key of
that object.  Without a CUDA card, or with fewer than the cell asks for, or
with JAX or the JAX package loaded, the run exits non-zero and prints no
result.
"""

from __future__ import annotations

import time

T0 = time.perf_counter()

import argparse  # noqa: E402
import importlib  # noqa: E402
import importlib.util  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
import traceback  # noqa: E402
from typing import Dict, List, Optional  # noqa: E402

import torch  # noqa: E402

from benchmark import costs, generator  # noqa: E402
from benchmark.harness import ROOT, Ctx, Window, forbidden_modules, load_json  # noqa: E402


def fail(msg: str, code: int) -> None:
    print(f"[benchmark] {msg}", file=sys.stderr)
    sys.exit(code)


def cell(root: str, workload: str):
    bench = load_json(root, "BENCHMARK.json")
    cells = {w["name"]: w for w in bench["workloads"]}
    if workload not in cells:
        fail(f"no workload {workload!r} in BENCHMARK.json", 2)
    return bench, cells[workload]


def metric_reader(root: str, name: str):
    spec = importlib.util.spec_from_file_location(f"benchmark_metric_{name.replace('.', '_')}",
                                                  os.path.join(root, "benchmark", "metrics", name + ".py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def per_layer_names(bench: Dict, workload: Dict) -> List[str]:
    """The per-layer metrics this cell reports: those listing it, and those
    without a list whose end-to-end metric it reports."""
    mine = set(m["name"] for m in bench["end_to_end"]
               if workload["name"] in m.get("workloads", [workload["name"]]))
    out = []
    for m in bench["per_layer"]:
        if "workloads" in m:
            if workload["name"] in m["workloads"]:
                out.append(m["name"])
        elif m["moves"] in mine:
            out.append(m["name"])
    return out


def end_to_end(bench: Dict, workload: Dict, window: Window, root: str) -> Dict[str, Dict]:
    """The cell's end-to-end metrics, each read by its own reader; one that
    reads nothing ends the run, since the cell has to report it."""
    out = {}
    for m in bench["end_to_end"]:
        if workload["name"] in m.get("workloads", [workload["name"]]):
            value = metric_reader(root, m["name"])(window)
            if value is None:
                fail(f"the end-to-end metric {m['name']} read nothing in this run", 6)
            out[m["name"]] = {"value": float(value), "unit": m["unit"]}
    return out


def per_layer(bench: Dict, workload: Dict, window: Window, root: str) -> Dict[str, Dict]:
    """The cell's per-layer metrics that found something to read."""
    out = {}
    names = per_layer_names(bench, workload)
    for m in bench["per_layer"]:
        if m["name"] in names:
            value = metric_reader(root, m["name"])(window)
            if value is not None:
                out[m["name"]] = {"value": float(value), "unit": m["unit"]}
    return out


def run(argv: Optional[List[str]] = None, root: str = ROOT, device: Optional[str] = None,
        overrides: Optional[Dict] = None) -> Dict:
    """One run; returns the result object.  ``device`` and ``overrides``
    (configuration and mix keys replaced, another driver) are for the tests
    on the CPU and for the controls (``benchmark/control.py``)."""
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    bench, workload = cell(root, args.workload)
    if device is None:
        if not torch.cuda.is_available():
            fail("torch.cuda.is_available() is false: the benchmark runs on a CUDA card", 3)
        if torch.cuda.device_count() < workload["chips"]:
            fail(f"{torch.cuda.device_count()} CUDA devices, the cell asks for {workload['chips']}", 3)
        device = "cuda"
    overrides = overrides or {}
    cfg = load_json(root, "benchmark", "configs", workload["config"] + ".json")
    cfg.update(overrides.get("config", {}))
    mix = generator.load(root, workload["traffic"])
    mix.update(overrides.get("mix", {}))
    ctx = Ctx(root, cfg, mix, args.seed, torch.device(device), args.seconds)

    from flamed_tts_tpu_torch.utils import profiling

    profiling.SAMPLE_TIMER = ctx.spans
    if "driver" in overrides:
        driver = overrides["driver"](ctx)
    else:
        driver = importlib.import_module(f"benchmark.drivers.{mix['driver']}").DRIVER(ctx)
    on_card = ctx.device.type == "cuda"

    driver.setup()
    if on_card:
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
    setup_s = time.perf_counter() - T0

    # --- the window ------------------------------------------------------------
    counters = {k + "_before": v for k, v in driver.counters().items()}
    spans0 = ctx.spans.snapshot()
    records: List[Dict] = []
    failed = 0
    t_start = time.perf_counter()
    while time.perf_counter() - t_start < args.seconds:
        try:
            records.append(driver.call())
        except Exception:  # a request that fails counts against the run
            traceback.print_exc()
            failed += 1
            if failed > 3:
                break
    window_s = time.perf_counter() - t_start
    counters.update({k + "_after": v for k, v in driver.counters().items()})
    spans1 = ctx.spans.snapshot()
    spans = {k: (v[0] - spans0.get(k, (0.0, 0))[0], v[1] - spans0.get(k, (0, 0))[1])
             for k, v in spans1.items()}
    attempted = len(records) + failed

    result: Dict = {"correct": False, "attempted": attempted, "failed": failed}
    bound = forbidden_modules(sys.modules)
    if bound:
        fail(f"loaded in the run's process: {', '.join(bound)}", 4)
    peaks = costs.PEAKS.get(torch.cuda.get_device_name(0)) if on_card else None
    slice_ = None
    if args.trace and on_card:
        if peaks is None:
            fail(f"no peak rates for {torch.cuda.get_device_name(0)!r} in benchmark/costs.py", 5)
        from benchmark import trace

        ctx.spans.annotate = True
        traced: List[Dict] = []

        def calls(mark):
            for _ in range(int(mix["trace_calls"])):
                with mark():
                    traced.append(driver.call())

        slice_ = trace.profile(calls, set(ctx.spans.totals))
        ctx.spans.annotate = False
        slice_.records, slice_.peaks = traced, peaks
        slice_.arithmetic, slice_.io_bytes = driver.arithmetic, getattr(driver, "io_bytes", 4)

    if on_card:
        torch.cuda.synchronize()
        memory_peak = max(torch.cuda.max_memory_allocated(i) for i in range(torch.cuda.device_count()))
        device_info = {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                       "count": workload["chips"], "memory_peak_bytes": int(memory_peak)}
    else:
        device_info = {"platform": "cpu", "kind": "cpu", "count": 0, "memory_peak_bytes": 0}

    flop_per_s = peaks.flop_per_s(driver.arithmetic) if peaks else float("nan")
    window = Window(records, window_s, spans, counters, flop_per_s, slice_, setup_s=setup_s)
    if args.trace:
        # on the CPU the readers run and their numbers are dropped
        metrics = per_layer(bench, workload, window, root)
        if slice_ is not None:
            device_info.update(busy_s=slice_.busy_s, window_s=slice_.window_s)
            result["breakdown"] = {"device_ops": slice_.top_ops(), "idle_gaps": slice_.idle_gaps()}
    else:
        metrics = end_to_end(bench, workload, window, root) if records else {}
    if not on_card:
        metrics = {}

    # --- correct -----------------------------------------------------------------
    keep = getattr(driver, "keep", None)
    if keep is not None and records:
        keep(records, args.seed)  # what the check takes from the program, before it is freed
    driver.free()
    if on_card:
        torch.cuda.empty_cache()
    limits = load_json(root, "benchmark", "limits", workload["name"] + ".json")
    t_check = time.perf_counter()
    numbers = driver.check(records, args.seed) if records else {}
    print(f"[benchmark] setup {setup_s:.1f} s, window {window_s:.1f} s ({len(records)} calls), "
          f"check {time.perf_counter() - t_check:.1f} s", file=sys.stderr)
    compared = {k: {"value": float(v), "limit": float(limits[k])} for k, v in numbers.items()}
    correct = (bool(records) and failed == 0 and set(numbers) == set(limits)
               and all(c["value"] <= c["limit"] for c in compared.values()))
    bound = forbidden_modules(sys.modules)
    if bound:
        fail(f"loaded in the run's process: {', '.join(bound)}", 4)
    for k, c in compared.items():
        print(f"[compared] {k} {c['value']!r} limit {c['limit']!r}", file=sys.stderr)
    result.update(correct=correct, metrics=metrics, device=device_info, compared=compared)
    return result


def main() -> None:
    result = run()
    print(json.dumps(result))
    sys.stdout.flush()


if __name__ == "__main__":
    main()
