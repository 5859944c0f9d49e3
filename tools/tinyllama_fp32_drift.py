#!/usr/bin/env python3
"""Where TinyLlama's fp32 cached decode and its cache-free forward part, on
one NVIDIA GPU.

    python3 tools/tinyllama_fp32_drift.py [--arch gemma2-27b --layers 2 \
        --batch 2 --prompt 4608 --tokens 64] [--arch paligemma-3b]

TinyLlama 1.1B at full width and depth (or another dense or vlm config,
its depth cut to ``--layers``), as ``chip_smoke.py``'s fp32 serving check
runs it (params from the port's init, seeded; batch 8, a 1024-token prompt
and 7 forced tokens, a cache of 1152, fp32 activations and caches; a vlm's
``chip_smoke.patches_for`` patches in front of every forward, its cache
and positions shifted by their rows, which the row counts below leave
out):

(a) at the first decode step (position 1024), the residual stream after
    every layer and the logits, cached (the prefill, then one decode step)
    against cache-free (the forward over the prompt and that token, its
    last position): max |diff| and max |diff| / max |value|; with the
    attention kernel, and with its plain version on both sides;
(b) the control without a cache: the cache-free forward over the prompt
    and 1 token against the one over the prompt and all 7, at the same
    position 1024. The same positions see the same keys; only the number
    of rows of every GEMM differs (8 x 1025 against 8 x 1031), and with it
    the kernel cuBLAS picks;
(c) the fp32 check's comparison as ``chip_smoke.serve_fp32_check`` made
    it before it ran its cached side at the cache-free row counts (planted
    faults left out): max |diff| and the logits outside fp32 ``_tol``, with
    the kernel and with the plain attention on both sides;
(d) cuBLAS alone: for each fp32 product of the path (TinyLlama: K 2,048
    into 2,048, 256 and 5,632; K 5,632 into 2,048; the unembedding's 2,048
    into 32,000), the last 8 rows of X @ W at M = 9,216 (a cache-free
    forward's 8 x 1152 rows) against the same rows at M = 8 (a decode
    step's), and each against an fp64 product;
(e) the fp32 check of (c) with every fp32 product of the cached side that
    has fewer rows than the cache-free forward's padded with zero rows to
    that forward's row count (the unembedding to its 8 x 8 rows, the
    layers' products to its 8 x 1031), so that cuBLAS runs the same
    kernels on both sides: what is left of the gap is not the products'
    summation order;
(f) (e) with the norms' rows padded the same way (their mean over
    d_model is a reduction whose order PyTorch picks by the row count
    too): what is left then is neither. ``serve_fp32_check`` runs this way
    (``chip_smoke.at_cache_free_rows``, which also pads an MoE's expert
    products to the cache-free capacity).

Prints one line per reading, then one JSON object of them all, and the
card's name and power limit last. Needs ``nvcc`` and a CUDA device.
"""
import argparse
import contextlib
import dataclasses
import importlib.util
import json
import pathlib
import sys

import numpy as np
import torch

ROOT = pathlib.Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))

B, PROMPT, FORCED = 8, 1024, 7
CACHE = PROMPT + 128
F32 = torch.float32
#: a vlm's patch embeddings (B, n_patches, d) on the card, None otherwise.
PATCHES = None


def _chip_smoke():
    spec = importlib.util.spec_from_file_location("chip_smoke", ROOT / "chip_smoke.py")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def _diff(a, b):
    d = float((a - b).abs().max())
    return {"max_abs_diff": d, "relative": d / float(b.abs().max())}


def _plain_attention(plain):
    """A context that runs the attention's plain version (on both sides)."""
    from repro_torch.kernels import ops

    @contextlib.contextmanager
    def ctx():
        on_card = ops._on_card
        if plain:
            ops._on_card = lambda t, what: (False if what == "flash_attention"
                                            else on_card(t, what))
        try:
            yield
        finally:
            ops._on_card = on_card
    return ctx()


def _kw():
    return {} if PATCHES is None else {"patch_embeds": PATCHES}


def first_step(cfg, params, tokens, plain):
    """(a): each layer's output at position 1024, cached against cache-free."""
    from repro_torch.models import transformer

    pre = 0 if PATCHES is None else PATCHES.shape[1]
    seen = []
    body = transformer._layer_body

    def body_seen(*args, **kw):
        out = body(*args, **kw)
        seen.append(out[0][:, -1].clone())
        return out

    with torch.no_grad(), _plain_attention(plain):
        cache = transformer.make_cache(cfg, B, CACHE, F32, tokens.device, prefix=pre)
        transformer.forward(cfg, params, tokens[:, :PROMPT], cache=cache, cache_pos=0,
                            last_only=True, dtype=F32, **_kw())
        transformer._layer_body = body_seen
        try:
            cached_logits, _, _ = transformer.forward(
                cfg, params, tokens[:, PROMPT:PROMPT + 1], cache=cache,
                cache_pos=pre + PROMPT, dtype=F32)
            cached = seen[:]
            seen.clear()
            free_logits, _ = transformer.forward(cfg, params, tokens[:, :PROMPT + 1],
                                                 dtype=F32, **_kw())
            free = seen[:]
        finally:
            transformer._layer_body = body
    rows = [dict(layer=i, **_diff(a, b)) for i, (a, b) in enumerate(zip(cached, free))]
    return {"plain_attention": plain, "layers": rows,
            "logits": _diff(cached_logits[:, -1], free_logits[:, -1])}


def no_cache_control(cfg, params, tokens, plain):
    """(b): the cache-free forward at position 1024 over 1025 and 1031 rows."""
    from repro_torch.models import transformer

    with torch.no_grad(), _plain_attention(plain):
        short, _ = transformer.forward(cfg, params, tokens[:, :PROMPT + 1], dtype=F32,
                                       **_kw())
        long, _ = transformer.forward(cfg, params, tokens, dtype=F32, **_kw())
    return {"plain_attention": plain, **_diff(short[:, PROMPT], long[:, PROMPT])}


@contextlib.contextmanager
def _padded_norms(rows):
    """(f): every rmsnorm and layernorm over fewer rows than ``rows`` runs
    inside zero rows up to that count."""
    from repro_torch.models import layers as L

    norms = {"rmsnorm": L.rmsnorm, "layernorm": L.layernorm}

    def padded(norm):
        def run(x, *args, **kw):
            flat = x.reshape(-1, x.shape[-1])
            if flat.shape[0] >= rows:
                return norm(x, *args, **kw)
            big = flat.new_zeros((rows, flat.shape[1]))
            big[:flat.shape[0]] = flat
            return norm(big, *args, **kw)[:flat.shape[0]].reshape(x.shape)
        return run

    for name, norm in norms.items():
        setattr(L, name, padded(norm))
    try:
        yield
    finally:
        for name, norm in norms.items():
            setattr(L, name, norm)


@contextlib.contextmanager
def _padded_products(rows, unembed_rows, vocab):
    """(e): every fp32 ``x @ w`` with fewer rows than the cache-free
    forward's runs inside zero rows up to its count: ``unembed_rows`` for
    the unembedding (``w`` of ``vocab`` columns), ``rows`` for the others."""
    matmul = torch.Tensor.__matmul__

    def padded(a, b):
        if a.dtype == F32 and a.dim() >= 2 and b.dim() == 2:
            m = unembed_rows if b.shape[-1] == vocab else rows
            flat = a.reshape(-1, a.shape[-1])
            if flat.shape[0] < m:
                big = flat.new_zeros((m, flat.shape[1]))
                big[:flat.shape[0]] = flat
                out = matmul(big, b)[:flat.shape[0]]
                return out.reshape(*a.shape[:-1], b.shape[-1])
        return matmul(a, b)

    torch.Tensor.__matmul__ = padded
    try:
        yield
    finally:
        torch.Tensor.__matmul__ = matmul


def fp32_check(cs, cfg, params, tokens, plain, padded=""):
    """(c), or with ``padded`` "products" (e) or "products and norms" (f):
    ``serve_fp32_check``'s comparison, without the planted faults."""
    from repro_torch.models import layers as L
    from repro_torch.models import transformer

    n_out = tokens.shape[1] - PROMPT + 1
    rows = tokens.numel() + (0 if PATCHES is None else PATCHES.shape[:2].numel())
    with torch.no_grad(), _plain_attention(plain):
        hidden, _ = transformer.forward(cfg, params, tokens, return_hidden=True,
                                        dtype=F32, **_kw())
        want = L.unembed(params["embed"], hidden[:, PROMPT - 1:], cfg)
        with contextlib.ExitStack() as pads:
            if padded:
                pads.enter_context(_padded_products(rows, B * n_out, cfg.vocab))
            if "norms" in padded:
                pads.enter_context(_padded_norms(rows))
            got = cs.serve_forced(cfg, params, tokens, PROMPT, CACHE, patches=PATCHES)
    t = cs.tol(F32)
    d = (got - want).abs()
    return {"plain_attention": plain, "padded_products": padded,
            "max_abs_diff": float(d.max()),
            "outside": int((d > t["atol"] + t["rtol"] * want.abs()).sum()),
            "n_logits": d.numel(), "max_abs_logit": float(want.abs().max())}


def gemm_rows(params):
    """(d): the last 8 rows of X @ W at M = 9,216 and at M = 8, fp32, each
    against fp64."""
    gen = torch.Generator(device="cuda").manual_seed(5)
    layer = {k: v[0] for k, v in params["layers"]["attn"].items()}
    mlp = {k: v[0] for k, v in params["layers"]["mlp"].items()}
    embed = params["embed"]
    weights = {"wq": layer["wq"], "wk": layer["wk"], "w1": mlp["w1"], "w2": mlp["w2"],
               "unembed": embed["unembed"] if "unembed" in embed else embed["tok"].T}
    out = {}
    for name, w in weights.items():
        name = f"{name} ({w.shape[0]} -> {w.shape[1]})"
        x = torch.randn((B * CACHE, w.shape[0]), generator=gen, device="cuda")
        big, small = (x @ w)[-B:], x[-B:] @ w
        exact = (x[-B:].double() @ w.double())
        out[name] = {"shape": list(w.shape),
                     "differing": int((big != small).sum()), "of": small.numel(),
                     "m_9216_vs_m_8": _diff(big, small),
                     "m_9216_vs_fp64": _diff(big.double(), exact),
                     "m_8_vs_fp64": _diff(small.double(), exact)}
    return out


def main(argv=None):
    global B, PROMPT, CACHE, PATCHES
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--arch", default="tinyllama-1.1b")
    ap.add_argument("--layers", type=int, default=0, help="cut depth (0: full)")
    ap.add_argument("--batch", type=int, default=B)
    ap.add_argument("--prompt", type=int, default=PROMPT)
    ap.add_argument("--tokens", type=int, default=CACHE - PROMPT,
                    help="new tokens the cache holds room for")
    args = ap.parse_args(argv)
    B, PROMPT, CACHE = args.batch, args.prompt, args.prompt + args.tokens
    if not torch.cuda.is_available():
        print("tinyllama_fp32_drift: needs a CUDA device", file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cs = _chip_smoke()
    from repro_torch.configs import get_config
    from repro_torch.kernels import build
    from repro_torch.models import build_model

    build.load()
    cfg = get_config(args.arch)
    if args.layers:
        cfg = dataclasses.replace(cfg, n_layers=args.layers)
    print(f"{cfg.name}, {cfg.n_layers} layers: batch {B}, prompt {PROMPT}, "
          f"{FORCED} forced tokens, a cache of {CACHE}; fp32", flush=True)
    params = build_model(cfg).init(torch.Generator(device="cuda").manual_seed(0))
    host = torch.Generator().manual_seed(1)
    tokens = torch.cat([torch.randint(0, cfg.vocab, (B, PROMPT), generator=host),
                        torch.randint(0, cfg.vocab, (B, FORCED), generator=host)],
                       dim=1).cuda()
    patches = cs.patches_for(cfg, B, np.random.default_rng(1))
    PATCHES = None if patches is None else torch.from_numpy(patches).cuda()

    result = {"config": cfg.name, "n_layers": cfg.n_layers, "batch": B,
              "prompt": PROMPT, "cache": CACHE, "first_step": [],
              "no_cache_control": [], "fp32_check": [], "padded": []}
    for plain in (False, True):
        r = first_step(cfg, params, tokens, plain)
        result["first_step"].append(r)
        worst = max(r["layers"], key=lambda row: row["relative"])
        print(f"(a) plain attention {plain}: layer outputs up to "
              f"{worst['max_abs_diff']:.3e} ({worst['relative']:.3e} of the "
              f"scale, layer {worst['layer']}); logits "
              f"{r['logits']['max_abs_diff']:.3e}", flush=True)
        for row in r["layers"]:
            print("    " + json.dumps(row), flush=True)
        r = no_cache_control(cfg, params, tokens, plain)
        result["no_cache_control"].append(r)
        print(f"(b) plain attention {plain}: cache-free logits at position "
              f"{PROMPT}, 1025 rows vs 1031 rows: {r['max_abs_diff']:.3e}", flush=True)
        r = fp32_check(cs, cfg, params, tokens, plain)
        result["fp32_check"].append(r)
        print(f"(c) plain attention {plain}: fp32 check max |diff| "
              f"{r['max_abs_diff']:.3e}, {r['outside']} of {r['n_logits']} "
              f"outside fp32 _tol", flush=True)
        for mark, padded in (("(e)", "products"), ("(f)", "products and norms")):
            r = fp32_check(cs, cfg, params, tokens, plain, padded=padded)
            result["padded"].append(r)
            print(f"{mark} plain attention {plain}: fp32 check with the cached "
                  f"side's {padded} padded to the cache-free row counts: max "
                  f"|diff| {r['max_abs_diff']:.3e}, {r['outside']} of "
                  f"{r['n_logits']} outside fp32 _tol", flush=True)
    result["gemm_rows"] = gemm_rows(params)
    for name, r in result["gemm_rows"].items():
        print(f"(d) {name}: {r['differing']} of {r['of']} outputs differ between "
              f"M = 9216 and M = 8, by up to {r['m_9216_vs_m_8']['max_abs_diff']:.3e}; "
              f"against fp64 {r['m_9216_vs_fp64']['max_abs_diff']:.3e} (M = 9216), "
              f"{r['m_8_vs_fp64']['max_abs_diff']:.3e} (M = 8)", flush=True)
    print(json.dumps({"tinyllama_fp32_drift": result}))
    print(cs.card_line())
    return 0


if __name__ == "__main__":
    sys.exit(main())
