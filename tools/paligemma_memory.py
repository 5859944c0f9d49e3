#!/usr/bin/env python3
"""How deep PaliGemma's training path fits on one NVIDIA GPU.

    python3 tools/paligemma_memory.py [--layers 18 14 12]

For each depth, deepest first, runs ``chip_smoke.py``'s PaliGemma training
path at full width on that many layers (``chip_smoke.PALIGEMMA_LAYERS``):
``main_path`` (3 steps on 2 logical devices, an int8 scale-out, 2 steps on
3, a scale-in, 2 steps, at ``chip_smoke.PATH_PER_DEVICE_BATCH``'s batch;
1024 text tokens behind 256 patches; exact launches and a bit-unchanged
state) and ``replica_tier`` (two pushes of the state and a restore), under
``chip_smoke.allocator_segments`` as the script runs them
(``--fixed-segments``: the allocator's default segments instead). A depth
that runs out of device memory is reported as such and the next one is
tried; the first depth that passes ends the run. Prints each depth's
result in one JSON line (the peaks are in ``main_path``'s and
``replica_tier``'s own lines), then the card's name and power limit.
Needs ``nvcc`` and a CUDA device.
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


def _chip_smoke():
    spec = importlib.util.spec_from_file_location("chip_smoke", ROOT / "chip_smoke.py")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--layers", type=int, nargs="+", default=[18, 14, 12])
    ap.add_argument("--fixed-segments", action="store_true")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("paligemma_memory: needs a CUDA device", file=sys.stderr)
        return 1
    cs = _chip_smoke()
    from repro_torch.kernels import build, ops

    build.load()
    out = []
    for n_layers in sorted(args.layers, reverse=True):
        cs.PALIGEMMA_LAYERS = n_layers
        row = {"n_layers": n_layers}
        trainer = None
        try:
            with cs.allocator_segments(not args.fixed_segments):
                trainer, _ = cs.main_path(ops, "paligemma-3b")
                row["replica_tier"] = cs.replica_tier(trainer, "paligemma-3b")
                trainer = None
            row["fits"] = True
        except torch.cuda.OutOfMemoryError as e:
            row["fits"] = False
            row["error"] = str(e).splitlines()[0]
        trainer = None
        gc.collect()
        torch.cuda.empty_cache()
        out.append(row)
        print(json.dumps({"paligemma_memory": row}), flush=True)
        if row["fits"]:
            break
    print(json.dumps({"paligemma_memory_runs": out}))
    print(cs.card_line())
    return 0


if __name__ == "__main__":
    sys.exit(main())
