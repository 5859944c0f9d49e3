#!/usr/bin/env python3
"""Trace Zamba2's bf16 decode drift to its source, on one NVIDIA GPU.

    python3 tools/zamba2_decode_drift.py

Zamba2 1.2B at full width and depth, served as ``chip_smoke.py`` serves it
(params from the port's init, seeded; batch 8, a 1024-token prompt, 128
greedy new tokens, a cache of 1152), bf16:

(a) at the first decode step, the residual stream after every application
    of the shared block and every Mamba2 block, cached (``decode_step`` at
    position 1024) against cache-free (the forward over prompt + token, its
    last position): max |diff|, one bf16 unit at the stream's scale, the
    elements that differ; and the first module beyond one unit;
(b) the per-step drift of the 127 decode steps, forced to the served
    tokens, against the cache-free forward over the same tokens: with the
    kernels, and with the SSD kernel, the attention kernel or both swapped
    for their plain versions on both sides;
(c) whether cuBLAS rounds the last 8 rows of an M = 8,200 bf16 product
    (a cache-free forward's) as it rounds the same rows at M = 8 (a decode
    step's), for each weight shape of the path.

Prints one line per reading, then one JSON object of them all, and the
card's name and power limit last. Needs ``nvcc`` and a CUDA device.
"""
import importlib.util
import json
import pathlib
import sys

import numpy as np
import torch

ROOT = pathlib.Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))

B, PROMPT, TOKENS = 8, 1024, 128


def _chip_smoke():
    spec = importlib.util.spec_from_file_location("chip_smoke", ROOT / "chip_smoke.py")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def unit(x):
    """One bf16 unit in the last place at the scale of max |x|."""
    m = float(x.float().abs().max())
    return 2.0 ** (np.floor(np.log2(m)) - 7) if m > 0 else 0.0


def first_step(cfg, model, params, prompts):
    """(a): the residual stream after each module at the first decode step,
    cached against cache-free."""
    from repro_torch.models import mamba2, zamba2

    seen = []
    block, shared = mamba2.block_apply, zamba2._shared_apply

    def block_seen(lp, x, c, state=None):
        out, st = block(lp, x, c, state)
        seen.append(("block", (x + out)[:, -1].clone()))
        return out, st

    def shared_seen(sp, x, x0, c, positions, cache_kv=None, cache_pos=None):
        out = shared(sp, x, x0, c, positions, cache_kv, cache_pos)
        seen.append(("app", out[:, -1].clone()))
        return out

    with torch.no_grad():
        logits, cache = model.prefill(params, {"tokens": prompts},
                                      max_len=PROMPT + TOKENS)
        tok = logits[:, -1:].argmax(-1)
        mamba2.block_apply, zamba2._shared_apply = block_seen, shared_seen
        try:
            cached_logits, _ = model.decode_step(
                params, {"tokens": tok, "pos": PROMPT, "cache": cache})
            cached = seen[:]
            seen.clear()
            free_logits, _ = zamba2.forward(cfg, params,
                                            torch.cat([prompts, tok], 1))
            free = seen[:]
        finally:
            mamba2.block_apply, zamba2._shared_apply = block, shared
    rows, first, count = [], None, {"block": 0, "app": 0}
    for (kind, a), (_, b) in zip(cached, free):
        label = f"{kind} {count[kind]}"
        count[kind] += 1
        d, u = float((a.float() - b.float()).abs().max()), unit(b)
        rows.append({"module": label, "max_abs_diff": d, "unit": u,
                     "differing": int((a != b).sum()), "of": a.numel()})
        if first is None and d > u:
            first = label
    d_logits = float((cached_logits[:, -1].float()
                      - free_logits[:, -1].float()).abs().max())
    return {"modules": rows, "first_beyond_one_unit": first,
            "logits_max_abs_diff": d_logits}


def drift(cs, cfg, params, prompts, forced, plain):
    """(b): per-step max |diff| of the forced decode against the cache-free
    forward, with the kernels named in ``plain`` run as their plain
    versions on both sides."""
    from repro_torch.kernels import ops
    from repro_torch.models import layers as L
    from repro_torch.models import zamba2

    on_card = ops._on_card
    ops._on_card = lambda t, what: False if what in plain else on_card(t, what)
    try:
        with torch.no_grad():
            served = cs.serve_forced(cfg, params, forced, PROMPT,
                                     PROMPT + TOKENS, torch.bfloat16)
            hidden, _ = zamba2.forward(cfg, params, forced, return_hidden=True)
            ref = L.unembed(params["embed"], hidden[:, PROMPT - 1:], cfg)
    finally:
        ops._on_card = on_card
    d = (served.float() - ref.float()).abs()
    t = cs.tol(torch.bfloat16)
    per_step = d.amax(dim=(0, 2)).tolist()
    return {"plain": list(plain), "max_abs_diff_per_step": per_step,
            "mean_steps_1_32": float(np.mean(per_step[1:33])),
            "mean_steps_96_127": float(np.mean(per_step[-32:])),
            "outside": int((d > t["atol"] + t["rtol"] * ref.float().abs()).sum()),
            "n_logits": d.numel()}


def gemm_rows(params):
    """(c): the last 8 rows of X @ W at M = 8 against the same rows inside
    M = 8 x 1025, on random bf16 X, for each weight shape of the path."""
    gen = torch.Generator(device="cuda").manual_seed(5)
    weights = {"mamba2 in_proj": params["mamba"]["in_proj"][0],
               "mamba2 out_proj": params["mamba"]["out_proj"][0],
               "shared in_proj": params["shared"]["in_proj"],
               "attention wq": params["shared"]["attn"]["wq"],
               "mlp w1": params["shared"]["mlp"]["w1"],
               "mlp w2": params["shared"]["mlp"]["w2"],
               "unembedding": params["embed"]["tok"].T}
    out = {}
    for name, w in weights.items():
        wb = w.to(torch.bfloat16)
        x = torch.randn((B * (PROMPT + 1), w.shape[0]), generator=gen,
                        device="cuda").to(torch.bfloat16)
        big, small = (x @ wb)[-B:], x[-B:] @ wb
        out[name] = {"shape": list(w.shape), "differing": int((big != small).sum()),
                     "of": small.numel(),
                     "max_abs_diff": float((big.float() - small.float()).abs().max())}
    return out


def main():
    if not torch.cuda.is_available():
        print("zamba2_decode_drift: needs a CUDA device", file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    cs = _chip_smoke()
    from repro_torch.configs import get_config
    from repro_torch.launch.serve import generate
    from repro_torch.models import build_model

    cfg = get_config("zamba2-1.2b")
    model = build_model(cfg)
    params = model.init(torch.Generator(device="cuda").manual_seed(0))
    host = torch.Generator().manual_seed(1)
    prompts = torch.randint(0, cfg.vocab, (B, PROMPT), generator=host).cuda()

    result = {"first_step": first_step(cfg, model, params, prompts)}
    for row in result["first_step"]["modules"]:
        print(json.dumps(row), flush=True)
    print(f"(a) first module beyond one bf16 unit of its scale: "
          f"{result['first_step']['first_beyond_one_unit']}; logits max |diff| "
          f"{result['first_step']['logits_max_abs_diff']:.4f}", flush=True)

    run = generate(model, params, prompts, TOKENS)
    forced = torch.cat([prompts, run.tokens[:, :-1]], 1)
    result["drift"] = {}
    for label, plain in (("kernels", ()), ("SSD plain", ("ssd",)),
                         ("attention plain", ("flash_attention",)),
                         ("both plain", ("ssd", "flash_attention"))):
        r = drift(cs, cfg, params, prompts, forced, plain)
        result["drift"][label] = r
        print(f"(b) {label}: per-step max |diff| {max(r['max_abs_diff_per_step']):.4f} "
              f"at most, mean {r['mean_steps_1_32']:.4f} over steps 1-32, "
              f"{r['mean_steps_96_127']:.4f} over 96-127; {r['outside']} of "
              f"{r['n_logits']} logits outside bf16 _tol", flush=True)

    result["gemm_rows"] = gemm_rows(params)
    for name, r in result["gemm_rows"].items():
        print(f"(c) {name} {r['shape']}: {r['differing']} of {r['of']} outputs "
              f"differ at M = 8, by up to {r['max_abs_diff']:.4g}", flush=True)
    print(json.dumps({"zamba2_decode_drift": result}))
    print(cs.card_line())
    return 0


if __name__ == "__main__":
    sys.exit(main())
