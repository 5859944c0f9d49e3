#!/usr/bin/env python3
"""Time the attention kernel's decode regime at each split count on one
NVIDIA GPU.

    python3 tools/decode_splits.py [--out FILE]

For each serving decode shape that ``chip_smoke.py``'s phase 5 times
(``time_decode_attention``: one query row over each layer's own cache, the
config's scale, softcap and window), runs the kernel at every split count
from 1 up to the most the entry allows (powers of two, and the count that
``decode_split_plan`` picks), each held to the plain version at ``_tol``,
and reports the device time per launch (``chip_smoke._per_launch``) beside
the bound. Prints one line per shape and a JSON object of all times (also
written to ``--out``); the card's name and power limit last. It is how
``kernels/flash_attention.py``'s split rule was chosen. Needs ``nvcc`` and
a CUDA device.
"""
import argparse
import importlib.util
import json
import pathlib
import sys
import time

import torch

ROOT = pathlib.Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))


def _chip_smoke():
    spec = importlib.util.spec_from_file_location("chip_smoke", ROOT / "chip_smoke.py")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def shapes(cs):
    """``(label, cfg, B, cache_len, q_offset, window, kind, n_sets)`` of the
    decode shapes of ``chip_smoke.py``'s phase 5."""
    from repro_torch.configs import get_config
    from repro_torch.models import zamba2

    out = []
    for label, cfg, B, P, n in cs.serve_runs():
        if cfg.family == "ssm":
            continue
        n_sets = (get_config(cfg.name).n_layers // 2 if cfg.alt_local_global
                  else zamba2.n_shared_apps(cfg) if cfg.family == "hybrid"
                  else cfg.n_layers)
        cache = cs.prefix_rows(cfg) + P + n
        q_offset = cs.prefix_rows(cfg) + P + n // 2
        for kind, window in cs.layer_kinds(cfg):
            out.append((label + kind, cfg, B, cache, q_offset, window, "causal", n_sets))
        if cfg.family == "encdec":
            out.append((label + " cross", cfg, B, cfg.enc_len, 0, 0, "full", n_sets))
    return out


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--out", help="also write the JSON object here")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("decode_splits: no CUDA device", file=sys.stderr)
        return 1
    cs = _chip_smoke()
    sys.modules.update(dict.fromkeys(cs.BLOCKED))
    from repro_torch.kernels import build, cost
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.models.layers import MaskSpec

    t0 = time.perf_counter()
    build.load()
    print(f"build: {time.perf_counter() - t0:.1f} s (nvcc {build.last_build_s:.1f} s)",
          flush=True)
    gen = torch.Generator(device="cuda").manual_seed(0)
    bf16 = torch.bfloat16
    results = []
    for label, cfg, B, cache, q_offset, window, kind, n_sets in shapes(cs):
        H, K, hd = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
        scale = cfg.query_scale or hd ** -0.5
        softcap = cfg.attn_softcap
        spec = MaskSpec(kind, window=window)
        sets = [tuple(torch.randn(shape, generator=gen, device="cuda").to(bf16)
                      for shape in ((B, 1, H, hd), (B, cache, K, hd), (B, cache, K, hd)))
                for _ in range(n_sets)]
        plan = fa.decode_split_plan(B, 1, cache, K, kind, window, 0, q_offset)
        most = min(fa.MAX_SPLITS, max(plan.n_tiles, 1))
        counts = sorted({n for n in (1, 2, 4, 8, 16, 32, 64) if n <= most}
                        | {plan.n_split, most})
        q, k, v = sets[0]
        want = fa.attention_plain(q, k, v, spec, scale=scale, softcap=softcap,
                                  q_offset=q_offset).float()
        times = {}
        for n in counts:
            def kernel(q, k, v, n=n):
                return fa.flash_attention_kernel(q, k, v, scale=scale, softcap=softcap,
                                                 kind=kind, window=window,
                                                 q_offset=q_offset, n_split=n)

            torch.testing.assert_close(kernel(q, k, v).float(), want, **cs.tol(bf16))
            times[n] = cs._per_launch(kernel, sets)[0]
        lo, hi = plan.lo, plan.hi
        flops, nbytes = cost.attention(B, 1, cache, H, K, hd, hi - lo, kv_rows=hi - lo)
        bound_ms = cs.bound(nbytes, flops, cs.PEAK_BF16_FLOPS)[0]
        row = dict(shape=label, B=B, cache=cache, H=H, K=K, hd=hd, q_offset=q_offset,
                   window=window, tiles=plan.n_tiles, plan_n_split=plan.n_split,
                   bound_ms=bound_ms, ms={str(n): t for n, t in times.items()})
        results.append(row)
        best = min((t, n) for n, t in times.items() if t is not None)
        print(f"{label}: B·K {B * K}, {plan.n_tiles} tiles, plan {plan.n_split}: "
              + ", ".join(f"{n}: {cs._ms(t)}" for n, t in times.items())
              + f"; best {best[1]} ({best[0]:.4f} ms), bound {bound_ms:.4f} ms", flush=True)
        del sets
        torch.cuda.empty_cache()
    text = json.dumps({"decode_splits": results})
    print(text)
    if args.out:
        pathlib.Path(args.out).write_text(text + "\n")
    print(cs.card_line())
    return 0


if __name__ == "__main__":
    sys.exit(main())
