"""One run of one cell: the driver its traffic mix names, the metrics its
``BENCHMARK.json`` entries name, and the result line.

``--trace 0`` reports the cell's end-to-end metrics, ``--trace 1`` its
per-layer metrics from a run under ``torch.profiler`` with the metrics'
spans installed. Every run decides ``correct`` and prints each number
compared beside its limit: as the last lines on standard error, and under
``checks``, the result line's last key. The result is the last line on
standard output.
"""
from __future__ import annotations

import argparse
import json
import sys

from chaosbench.catalog import HERE, Catalog

#: top-level module names that may not be loaded in a run: JAX and the
#: JAX package the program was ported from.
BANNED = ("jax", "jaxlib", "flax", "repro")


def banned_modules() -> list:
    return sorted(name for name, mod in list(sys.modules.items())
                  if mod is not None and name.split(".")[0] in BANNED)


def parse(argv):
    ap = argparse.ArgumentParser(prog="chaosbench/run.py",
                                 description="Run one cell of BENCHMARK.json.")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return ap.parse_args(argv)


def execute(cat: Catalog, workload: str, seed: int, seconds: float, traced: bool,
            t0: float, device: str = "cuda") -> dict:
    """Run the cell and build its result line (without the look for a card)."""
    import torch

    cell = cat.workload(workload)
    mix = cat.traffic(cell["traffic"])
    driver = cat.driver(mix["driver"])
    metrics = cat.per_layer(workload) if traced else cat.end_to_end(workload)
    readers = {m["name"]: cat.metric(m["name"]) for m in metrics}
    run, checks, attempted, info, readings = driver.run(cat, cell, seed, seconds, traced, t0,
                                                     readers, device)
    values = {}
    for m in metrics:
        value = readers[m["name"]].read(run)
        if value is not None:
            values[m["name"]] = {"value": float(value), "unit": m["unit"]}
    on_card = device == "cuda"
    dev = {"platform": "gpu" if on_card else "cpu",
           "kind": torch.cuda.get_device_name(0) if on_card else "cpu",
           "count": cell["chips"], "memory_peak_bytes": int(info["memory_peak_bytes"])}
    if traced and run.trace is not None:
        dev["busy_s"] = run.trace.busy_s
        dev["window_s"] = run.trace.window_s
    result = {"correct": all(c["value"] <= c["limit"] for c in checks.values()),
              "attempted": attempted, "failed": 0, "metrics": values, "device": dev}
    if traced and run.breakdown is not None:
        result["breakdown"] = run.breakdown
    result["summary"] = summary(run)
    result["readings"] = readings
    result["checks"] = checks
    return result


def summary(run) -> dict:
    """The window at a glance: steps by membership (count, median ms),
    events by kind and spans (count, mean, least and most ms)."""
    import statistics

    steps, events = {}, {}
    for s in run.steps:
        steps.setdefault(str(s["n"]), []).append(1e3 * s["s"])
    for e in run.events:
        events.setdefault(e["kind"], []).append(1e3 * e["s"])
    return {"steps": {n: [len(xs), statistics.median(xs)] for n, xs in sorted(steps.items())},
            "events": {k: [len(xs), statistics.fmean(xs), min(xs), max(xs)]
                       for k, xs in sorted(events.items())},
            "spans": {k: [len(xs), 1e3 * statistics.fmean(xs), 1e3 * min(xs), 1e3 * max(xs)]
                      for k, xs in sorted(run.spans.items())}}


def report(result: dict) -> None:
    """The compared numbers, last on standard error; the result line, last
    on standard output."""
    for name, c in result["checks"].items():
        verdict = "ok" if c["value"] <= c["limit"] else "FAILED"
        print(f"check {name} {c['value']!r} limit {c['limit']!r} {verdict}", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)


def main(argv, t0: float) -> int:
    args = parse(argv)
    import torch

    cat = Catalog.load(HERE)
    chips = cat.workload(args.workload)["chips"]
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"chaosbench: {args.workload} needs {chips} CUDA device(s); "
              f"found {torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 2
    result = execute(cat, args.workload, args.seed, args.seconds, bool(args.trace), t0)
    found = banned_modules()
    if found:
        print(f"chaosbench: loaded in the run: {', '.join(found)}", file=sys.stderr)
        return 3
    report(result)
    return 0
