"""Readings that set the limits of ``limits/<config>.json``, taken on the
card at a cell's own size.

    python3 chaosbench/calibrate.py --workload gpt2.churn_stress --seeds 101 102 ... \
        [--control 3] [--out chiprun_out/calibrate.jsonl]

For each seed, the program's readings: a run of the cell with an empty
window (set-up and the check alone). For the first ``--control`` seeds also
the control's, the reference with every product's operands in float8
(``reference.common.Precision("fp8")``) put in the program's place, and
the control's with its parameters and moments kept in bfloat16 between
updates, and the fault's, the reference with half of each step's rows left
out and the mean taken over the rest; each against the float32 reference
on the same weights and rows. A state left unchanged reads 1 by the measure and needs
no run. One JSON line per reading.
"""
import time

T0 = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent


def reference_readings(cat, cell, seed, device):
    import torch

    from chaosbench import judge, traffic
    from chaosbench.reference import common as C

    cfg, mix = cat.config(cell["config"]), cat.traffic(cell["traffic"])
    ref = cat.reference(cfg["family"])
    C.strict_fp32()
    gen = torch.Generator(device=device).manual_seed(seed)
    params0 = C.make_params(ref.specs(cfg), gen, device)
    data = ref.make_inputs(cfg, gen, mix["ring_rows"], device)
    batches, start = [], 0
    for rows in traffic.setup_rows(mix)[:3]:
        batches.append({k: v[start:start + rows] for k, v in data.items()})
        start += rows
    base = C.train(ref, cfg, params0, batches)
    halves = [{k: v[:v.shape[0] // 2] for k, v in b.items()} for b in batches]
    return {"control_fp8": judge.step_readings(
                C.train(ref, cfg, params0, batches, prec=C.Precision("fp8")), base),
            "control_bf16_state": judge.step_readings(
                C.train(ref, cfg, params0, batches, state_dtype=torch.bfloat16), base),
            "fault_half_batch": judge.step_readings(C.train(ref, cfg, params0, halves), base)}


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--control", type=int, default=3)
    ap.add_argument("--out")
    args = ap.parse_args()
    sys.path[0:1] = [str(ROOT), str(ROOT / "src")]
    from chaosbench import bench

    for name in bench.BANNED:
        sys.modules[name] = None
    from chaosbench.catalog import HERE, Catalog

    cat = Catalog.load(HERE)
    cell = cat.workload(args.workload)
    out = open(args.out, "a") if args.out else None

    def emit(line):
        text = json.dumps(line)
        print(text, flush=True)
        if out:
            out.write(text + "\n")
            out.flush()

    for i, seed in enumerate(args.seeds):
        t0 = time.perf_counter()
        result = bench.execute(cat, args.workload, seed, 0.0, False, t0)
        emit({"workload": args.workload, "seed": seed, "kind": "program",
              "readings": result["readings"],
              "checks": {k: c["value"] for k, c in result["checks"].items()},
              "s": time.perf_counter() - t0})
        if i < args.control:
            t0 = time.perf_counter()
            for kind, r in reference_readings(cat, cell, seed, "cuda").items():
                emit({"workload": args.workload, "seed": seed, "kind": kind, "readings": r,
                      "s": time.perf_counter() - t0})
    if out:
        out.close()
    return 0


if __name__ == "__main__":
    sys.exit(main())
