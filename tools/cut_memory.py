#!/usr/bin/env python3
"""Which cut of a training path fits on one NVIDIA GPU: PaliGemma's depth,
Snowflake Arctic's and Kimi-K2's layers and experts.

    python3 tools/cut_memory.py --arch paligemma-3b [--cuts 18 14 12] [--fixed-segments]
    python3 tools/cut_memory.py --arch arctic-480b [--cuts 3x8 2x8]
    python3 tools/cut_memory.py --arch kimi-k2-1t-a32b [--cuts 2x16 1x16]

For each cut, in the order given, runs ``chip_smoke.py``'s training path
of ``--arch`` at full width on that cut: PaliGemma on LAYERS of its layers
(``chip_smoke.PALIGEMMA_LAYERS``), Arctic on LAYERSxEXPERTS
(``chip_smoke.ARCTIC_LAYERS``, ``chip_smoke.ARCTIC_EXPERTS``), Kimi on
LAYERSxEXPERTS (``chip_smoke.KIMI_LAYERS``, ``chip_smoke.KIMI_EXPERTS``).
``main_path`` (3 steps on 2 logical devices, an int8 scale-out, 2 steps on
3, a scale-in, 2 steps, at the path's per-device batch; exact launches and
a bit-unchanged state) and ``replica_tier`` (two pushes of the state and a
restore) run under ``chip_smoke.allocator_segments`` as the script runs
them (``--fixed-segments``: the allocator's default segments instead). A
cut that runs out of device memory is reported as such and the next one is
tried; the first cut that passes ends the run. Prints each cut's result in
one JSON line (the peaks are in ``main_path``'s and ``replica_tier``'s own
lines), then the card's name and power limit. Needs ``nvcc`` and a CUDA
device.
"""
import argparse
import gc
import importlib.util
import json
import pathlib
import sys

import torch

ROOT = pathlib.Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))
DEFAULT_CUTS = {"paligemma-3b": ["18", "14", "12"], "arctic-480b": ["3x8", "2x8"],
                "kimi-k2-1t-a32b": ["2x16", "1x16"]}


def _chip_smoke():
    spec = importlib.util.spec_from_file_location("chip_smoke", ROOT / "chip_smoke.py")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def _set_cut(cs, arch, cut):
    """Sets the script's cut of ``arch``; returns its description."""
    if arch == "paligemma-3b":
        cs.PALIGEMMA_LAYERS = int(cut)
        return {"n_layers": cs.PALIGEMMA_LAYERS}
    layers, experts = (int(n) for n in cut.split("x"))
    if arch == "arctic-480b":
        cs.ARCTIC_LAYERS, cs.ARCTIC_EXPERTS = layers, experts
        cfg = cs.arctic_cut()
    else:
        cs.KIMI_LAYERS, cs.KIMI_EXPERTS = layers, experts
        cfg = cs.kimi_cut()
    return {"n_layers": layers, "n_experts": experts, "n_params": cfg.param_count()}


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--arch", choices=sorted(DEFAULT_CUTS), required=True)
    ap.add_argument("--cuts", nargs="+",
                    help="LAYERS (paligemma-3b) or LAYERSxEXPERTS (arctic-480b, "
                         "kimi-k2-1t-a32b), "
                         "tried in this order")
    ap.add_argument("--fixed-segments", action="store_true")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("cut_memory: needs a CUDA device", file=sys.stderr)
        return 1
    cs = _chip_smoke()
    from repro_torch.kernels import build, ops

    build.load()
    out = []
    for cut in args.cuts or DEFAULT_CUTS[args.arch]:
        row = _set_cut(cs, args.arch, cut)
        trainer = None
        try:
            expandable = args.arch in cs.EXPANDABLE_SEGMENTS and not args.fixed_segments
            with cs.allocator_segments(expandable):
                trainer, _ = cs.main_path(ops, args.arch)
                row["replica_tier"] = cs.replica_tier(trainer, args.arch)
                trainer = None
            row["fits"] = True
        except torch.cuda.OutOfMemoryError as e:
            row["fits"] = False
            row["error"] = str(e).splitlines()[0]
        trainer = None
        gc.collect()
        torch.cuda.empty_cache()
        out.append(row)
        print(json.dumps({"cut_memory": {"arch": args.arch, **row}}), flush=True)
        if row["fits"]:
            break
    print(json.dumps({"cut_memory_runs": out}))
    print(cs.card_line())
    return 0


if __name__ == "__main__":
    sys.exit(main())
