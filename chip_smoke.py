#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (``src/repro_torch``) on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, each of which fails hard (any mismatch exits non-zero):

1. build the CUDA kernels from ``src/repro_torch/csrc`` (one ``nvcc`` per
   source, all at once) and print the build time and ptxas's register and
   spill lines;
2. hold every kernel against its plain PyTorch version on the card, at the
   shapes the main paths give it (read from the configs, at both global
   batches, 8 and 12) and over the JAX kernel sweeps; the many-leaf encode
   and decode (one launch per state) bit for bit against the per-leaf plain
   versions, the decode over all of GPT-2's fp32 leaf shapes and a ragged
   set;
3. the main paths, one per trained family, each at full width and full
   depth under ``ElasticTrainer`` with int8 state replication — 3 steps on
   2 logical devices, a scale-out, 2 steps on 3, a scale-in, 2 steps on 2 —
   with the launch counters zeroed just before each path, read just after
   it and held to the exact counts its config gives: GPT-2 (codec, flash
   attention), RWKV-6 1.6B (codec, WKV6) and Zamba2 1.2B (codec, SSD, flash
   attention); each path's full state encoded by the many-leaf kernel bit
   for bit as the per-leaf plain encode; one scale-out's phases timed apart
   on the trainer's state (plan, encode, decode, round-trip check), the
   decoded state bit for bit as the per-leaf plain decode; one profiled
   step each;
4. a reference check on a small input: each reduced model's loss and
   gradient norm through the kernels on the card against the plain
   versions on the CPU;
5. times: each kernel, its plain version and (attention) the library call,
   beside the least time the card could take (H100 SXM data sheet: 3.35 TB/s,
   989 TFLOP/s bf16, 67 TFLOP/s fp32); for the codec over GPT-2's state
   also the device time (the kernels' own durations in a profiler trace)
   beside the CUDA-event window, which holds the host's dispatch too, and
   for the decode the library call ``torch.mul(codes, scales[:, None])``
   leaf by leaf.

    python3 chip_smoke.py --baseline DIR

adds to phase 5 the times of the attention, SSD and WKV6 kernels and the
per-leaf encode and decode built from the checkout at DIR (an earlier
commit, unpacked), on the same inputs, in turns with this checkout's
(baseline, kernel, kernel, baseline).

It prints one JSON line per kernel and per path, the ``kernels`` line, the
card's name and power limit from ``nvidia-smi``, and last the line
``{"ok": true, "device": {...}}``. Without a CUDA device, or without the
repository around it, it exits non-zero and prints no result.
"""
import bisect
import gc
import json
import math
import os
import pathlib
import subprocess
import sys
import time

import numpy as np
import torch

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.join(HERE, "src"))

PEAK_BYTES_PER_S = 3.35e12
PEAK_BF16_FLOPS = 989e12
PEAK_FP32_FLOPS = 67e12
SEQ = 1024
PER_DEVICE_BATCH = 4

# The sweep of tests/test_kernels.py (ATTN_SWEEP).
ATTN_SWEEP = [
    # (B, Sq, Skv, H, K, hd, kind, window, prefix, softcap, dtype)
    (1, 128, 128, 2, 2, 32, "causal", 0, 0, 0.0, torch.float32),
    (2, 256, 256, 4, 2, 64, "causal", 0, 0, 0.0, torch.float32),
    (2, 256, 256, 4, 1, 64, "causal", 0, 0, 0.0, torch.float32),
    (1, 128, 128, 4, 4, 16, "full", 0, 0, 0.0, torch.float32),
    (1, 256, 256, 2, 2, 32, "causal", 64, 0, 0.0, torch.float32),
    (1, 256, 256, 2, 1, 32, "prefix", 0, 32, 0.0, torch.float32),
    (1, 128, 128, 2, 2, 32, "causal", 0, 0, 50.0, torch.float32),
    (1, 256, 256, 8, 2, 64, "causal", 0, 0, 0.0, torch.bfloat16),
    (1, 128, 512, 2, 2, 32, "full", 0, 0, 0.0, torch.float32),
]
# The bf16 kernel's own edges: a bf16 twin of every fp32 case of ATTN_SWEEP
# (window, prefix, softcap, GQA, full, hd 16 and 32, Skv != Sq), then GQA
# 8:1, hd 128, ragged Sq/Skv that no tile size divides, and a prefix with a
# window, where whole, partial and empty KV tiles meet — at S = 1024 with
# long runs of empty tiles between the prefix and the window.
ATTN_BF16_EDGES = [c[:-1] + (torch.bfloat16,) for c in ATTN_SWEEP
                   if c[-1] == torch.float32] + [
    (1, 256, 256, 8, 1, 64, "causal", 0, 0, 0.0, torch.bfloat16),
    (1, 256, 256, 2, 2, 128, "causal", 0, 0, 0.0, torch.bfloat16),
    (1, 192, 192, 2, 2, 128, "causal", 48, 0, 30.0, torch.bfloat16),
    (2, 1000, 1000, 4, 2, 64, "causal", 0, 0, 0.0, torch.bfloat16),
    (1, 100, 300, 2, 1, 32, "full", 0, 0, 0.0, torch.bfloat16),
    (1, 300, 300, 2, 2, 64, "prefix", 100, 40, 0.0, torch.bfloat16),
    (1, 1024, 1024, 2, 2, 64, "prefix", 64, 64, 0.0, torch.bfloat16),
    (1, 1024, 1024, 2, 1, 64, "causal", 128, 0, 0.0, torch.bfloat16),
]


# The sweeps of tests/test_kernels.py (WKV_SWEEP, SSD_SWEEP); every case
# runs with a given initial state, as there.
WKV_SWEEP = [
    # (B, S, H, hd, decay_lo, dtype)
    (1, 64, 2, 16, -1.0, torch.float32),
    (2, 128, 4, 32, -0.5, torch.float32),
    (1, 128, 2, 64, -5.0, torch.float32),  # strong decay
    (1, 96, 3, 16, -1.0, torch.float32),
    (2, 128, 2, 32, -1.0, torch.bfloat16),
]
SSD_SWEEP = [
    # (B, S, H, P, N, dtype)
    (1, 64, 2, 16, 8, torch.float32),
    (2, 128, 4, 32, 16, torch.float32),
    (1, 128, 2, 64, 64, torch.float32),
    (2, 128, 2, 32, 16, torch.bfloat16),
]
# The bf16 kernel's own edges: ragged last chunks (S 96, 100, 200), N 8 (padded
# to the mma depth), every P, and a long sequence at the path's P and N.
SSD_BF16_EDGES = [
    (1, 96, 2, 16, 8, torch.bfloat16),
    (1, 100, 3, 16, 8, torch.bfloat16),
    (2, 200, 2, 32, 64, torch.bfloat16),
    (1, 130, 2, 64, 16, torch.bfloat16),
    (2, 1024, 4, 64, 64, torch.bfloat16),
]
# The main paths, one per trained family, and their steps: before the
# scale-out (2 logical devices), between it and the scale-in (3), after (2).
PATHS = ["gpt2", "rwkv6-1.6b", "zamba2-1.2b"]
STEPS = (3, 2, 2)
MAIN_BATCHES = (PER_DEVICE_BATCH * 2, PER_DEVICE_BATCH * 3)


def tol(dtype):
    """``_tol`` of tests/test_kernels.py."""
    return (dict(rtol=2e-2, atol=2e-2) if dtype == torch.bfloat16
            else dict(rtol=2e-5, atol=2e-5))


def rec_tol(dtype):
    """``_rec_tol`` of tests/test_kernels.py: the sequential kernels and the
    chunked plain versions sum in different orders."""
    return (dict(rtol=2e-2, atol=2e-2) if dtype == torch.bfloat16
            else dict(rtol=1e-3, atol=1e-4))


T_START = time.perf_counter()


def log(msg):
    """A progress line, stamped with the seconds since the script started."""
    print(f"[{time.perf_counter() - T_START:6.1f} s] {msg}", flush=True)


def cuda_ms(fn, iters=10, warmup=2):
    """Mean device time of ``fn`` over ``iters`` calls, by CUDA events."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def bound(nbytes, flops, peak_flops):
    t_bytes = nbytes / PEAK_BYTES_PER_S * 1e3
    t_ops = flops / peak_flops * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


# ---------------------------------------------------------------------------
# Phase 2: kernels against their plain versions.
# ---------------------------------------------------------------------------


def check_codec(codec, gen):
    """Bit-identical codes, scales and decoded values on the GPT-2 leaf
    shapes (embed/tok, a 768-vector), a ragged size and nb = 1."""
    err = 0.0
    for shape in [(50257, 768), (768,), (3 * 768 + 5,), (256,)]:
        x = torch.randn(shape, generator=gen, device="cuda") * 3.0
        kc, ks = codec.shard_encode_kernel(x)
        pc, ps = codec.shard_encode_plain(x)
        if not (torch.equal(kc, pc) and torch.equal(ks, ps)):
            raise AssertionError(f"shard_encode differs from plain at {shape}")
        n = x.numel()
        kd = codec.shard_decode_kernel(kc, ks, n)
        pd = codec.shard_decode_plain(pc, ps, n)
        if not torch.equal(kd, pd):
            raise AssertionError(f"shard_decode differs from plain at {shape}")
        err = max(err, float((kc.int() - pc.int()).abs().max()),
                  float((ks - ps).abs().max()), float((kd - pd).abs().max()))
        if not torch.equal(codec.shard_decode_kernel(kc, ks),
                           codec.shard_decode_plain(pc, ps)):
            raise AssertionError(f"shard_decode (nb, 256) differs at {shape}")
    torch.cuda.synchronize()
    log("codec: encode and decode bit-identical to plain on "
        "(50257, 768), (768,), (2309,), (256,)")
    leaves = codec_many_leaves(gen)
    check_encode_many(codec, leaves)
    log(f"codec: many-leaf encode bit-identical to per-leaf plain over "
        f"{len(leaves)} leaves {[tuple(x.shape) for x in leaves]}")
    leaves = [torch.randn(shape, generator=gen, device="cuda")
              for shape in gpt2_fp32_shapes()]
    check_decode_many(codec, *leaf_rows(*codec.shard_encode_many_kernel(leaves)),
                      [x.numel() for x in leaves])
    log(f"codec: many-leaf decode bit-identical to per-leaf plain over "
        f"GPT-2's {len(leaves)} fp32 leaf shapes "
        f"({sum(x.numel() for x in leaves)} elements)")
    del leaves
    ragged = codec_decode_leaves(codec, gen)
    check_decode_many(codec, *ragged)
    log(f"codec: many-leaf decode bit-identical to per-leaf plain over the "
        f"ragged set, numels {ragged[2]}")
    return err


def gpt2_fp32_shapes():
    """The shapes of the non-empty fp32 leaves of GPT-2's training state,
    from an init on the meta device."""
    from repro_torch import tree as T
    from repro_torch.configs import get_config
    from repro_torch.models import build_model

    state = build_model(get_config("gpt2"), device="meta").init_train_state(
        torch.Generator())
    return [tuple(leaf.shape) for leaf in T.leaves(state)
            if leaf.dtype == torch.float32 and leaf.numel()]


def codec_decode_leaves(codec, gen):
    """Leaves for the many-leaf decode, as (codes, scales, numels) lists:
    separate encodes of 1, 255, 257 and 65,539 values; an empty leaf; codes
    that are a view 3 bytes off a 16-byte boundary (the kernel's
    element-wise loads); a numel below what the codes hold; and the rows of
    one many-leaf encode (views of shared buffers)."""
    codes, scales, numels = [], [], []

    def add(c, s, n):
        codes.append(c)
        scales.append(s)
        numels.append(n)

    for n in (1, 255, 257, 65539):
        add(*codec.shard_encode_kernel(
            torch.randn(n, generator=gen, device="cuda") * 2.0), n)
    add(torch.empty((0, 256), dtype=torch.int8, device="cuda"),
        torch.empty((0,), device="cuda"), 0)
    c, s = codec.shard_encode_kernel(torch.randn(1000, generator=gen, device="cuda"))
    raw = torch.empty(c.numel() + 3, dtype=torch.int8, device="cuda")
    raw[3:] = c.reshape(-1)
    add(raw[3:].view(c.shape), s, 1000)
    add(c, s, 300)
    many = [torch.randn(n, generator=gen, device="cuda") for n in (700, 256, 3, 4101)]
    for c, s, x in zip(*leaf_rows(*codec.shard_encode_many_kernel(many)), many):
        add(c, s, x.numel())
    return codes, scales, numels


def leaf_rows(codes, scales, firsts):
    """Each leaf's rows of a many-leaf encode: (codes list, scales list)."""
    spans = list(zip(firsts, firsts[1:]))
    return [codes[a:b] for a, b in spans], [scales[a:b] for a, b in spans]


def check_decode_many(codec, codes, scales, numels):
    """``shard_decode_many_kernel`` against ``shard_decode_plain`` leaf by
    leaf, bit for bit; each output flat, of its numel, 16-byte aligned."""
    outs = codec.shard_decode_many_kernel(codes, scales, numels)
    for i, (c, s, n, out) in enumerate(zip(codes, scales, numels, outs)):
        if out.shape != (n,) or out.data_ptr() % 16:
            raise AssertionError(f"shard_decode_many leaf {i}: shape "
                                 f"{tuple(out.shape)} at {out.data_ptr():#x}")
        if not torch.equal(out, codec.shard_decode_plain(c, s, n)):
            raise AssertionError(f"shard_decode_many differs from plain at leaf "
                                 f"{i} (numel {n})")
    torch.cuda.synchronize()


def codec_many_leaves(gen):
    """Leaves for the many-leaf encode: an empty leaf, n < 256, ragged
    tails, whole blocks, 2-D leaves, and views that start off a 16-byte
    boundary (the kernel's element-wise path)."""
    base = torch.randn(5000, generator=gen, device="cuda") * 2.0
    return [torch.randn((50257 // 7, 768), generator=gen, device="cuda"),
            base[:0], base[:100], base[1:1001], base[3:3 + 256 * 2],
            torch.randn((3, 256), generator=gen, device="cuda") * 1e-3,
            torch.zeros(300, device="cuda"), base[:256 * 4 + 7],
            torch.randn((768,), generator=gen, device="cuda")]


def check_encode_many(codec, leaves):
    """``shard_encode_many_kernel`` over ``leaves`` against
    ``shard_encode_plain`` leaf by leaf: codes and scales bit for bit, and
    each leaf's rows where ``firsts`` puts them."""
    codes, scales, firsts = codec.shard_encode_many_kernel(leaves)
    if firsts != codec.block_firsts(x.numel() for x in leaves):
        raise AssertionError(f"shard_encode_many: block prefix {firsts[:8]}...")
    if codes.shape != (firsts[-1], 256) or scales.shape != (firsts[-1],):
        raise AssertionError(f"shard_encode_many: {tuple(codes.shape)}, "
                             f"{tuple(scales.shape)} for {firsts[-1]} blocks")
    for i, x in enumerate(leaves):
        pc, ps = codec.shard_encode_plain(x)
        lo, hi = firsts[i], firsts[i + 1]
        if not (torch.equal(codes[lo:hi], pc) and torch.equal(scales[lo:hi], ps)):
            raise AssertionError(f"shard_encode_many differs from plain at leaf "
                                 f"{i} {tuple(x.shape)}")
    torch.cuda.synchronize()


def main_shapes():
    """The shapes each recurrent or attention kernel gets on the main paths,
    read from the configs, at both global batches: ``{kernel: [(path,
    shape), ...]}`` with attention ``(B, H, K, hd, softcap, rope_theta or
    0)`` (causal, bf16, scale 1/sqrt(hd) as every config here), wkv6 ``(B,
    S, H, hd)`` and ssd ``(B, S, H, P, N)``. One forward runs over the
    global batch, so the batch is the cluster's."""
    from repro_torch.configs import get_config
    from repro_torch.models import mamba2

    shapes = {"flash_attention": [], "wkv6": [], "ssd": []}
    for name in PATHS:
        cfg = get_config(name)
        for B in MAIN_BATCHES:
            if cfg.family in ("dense", "hybrid"):
                theta = cfg.rope_theta if cfg.positions == "rope" else 0.0
                shapes["flash_attention"].append((name, (
                    B, cfg.n_heads, cfg.n_kv_heads, cfg.head_dim,
                    cfg.attn_softcap, theta)))
            if cfg.family == "ssm":
                shapes["wkv6"].append((name, (B, SEQ, cfg.n_heads, cfg.head_dim)))
            if cfg.family == "hybrid":
                _, H, P, N = mamba2._dims(cfg)
                shapes["ssd"].append((name, (B, SEQ, H, P, N)))
    return shapes


def attention_cases():
    """``(label, case, rope_theta)``: the main paths' shapes, then the JAX
    sweep and the bf16 edges; ``case`` in ATTN_SWEEP's layout."""
    cases = [(f"{path} B={B}", (B, SEQ, SEQ, H, K, hd, "causal", 0, 0, softcap,
                                torch.bfloat16), theta)
             for path, (B, H, K, hd, softcap, theta)
             in main_shapes()["flash_attention"]]
    return (cases + [(f"sweep {i}", c, 0.0) for i, c in enumerate(ATTN_SWEEP)]
            + [(f"sweep bf16 {i}", c, 0.0) for i, c in enumerate(ATTN_BF16_EDGES)])


def attention_case(fa, gen, case, theta=0.0):
    """The kernel against ``attention_plain`` at ``_tol`` on one case; q and
    k go through RoPE first where ``theta`` is given, as in a RoPE config's
    attention. Returns max |kernel - plain|."""
    from repro_torch.models.layers import MaskSpec, rope

    B, Sq, Skv, H, K, d, kind, window, prefix, softcap, dt = case
    q = torch.randn((B, Sq, H, d), generator=gen, device="cuda").to(dt)
    k = torch.randn((B, Skv, K, d), generator=gen, device="cuda").to(dt)
    v = torch.randn((B, Skv, K, d), generator=gen, device="cuda").to(dt)
    if theta:
        q = rope(q, torch.arange(Sq, device="cuda"), theta)
        k = rope(k, torch.arange(Skv, device="cuda"), theta)
    out = fa.flash_attention_kernel(q, k, v, scale=d ** -0.5, softcap=softcap,
                                    kind=kind, window=window, prefix_len=prefix)
    ref = fa.attention_plain(q, k, v, MaskSpec(kind, window=window,
                                               prefix_len=prefix),
                             scale=d ** -0.5, softcap=softcap)
    torch.testing.assert_close(out.float(), ref.float(), **tol(dt))
    return float((out.float() - ref.float()).abs().max())


def check_attention(fa, gen):
    """Every case of ``attention_cases``; returns the largest error at the
    main paths' shapes."""
    main_err = 0.0
    for label, case, theta in attention_cases():
        err = attention_case(fa, gen, case, theta)
        if not label.startswith("sweep"):
            main_err = max(main_err, err)
            log(f"attention {label} {case[:6]} bf16 causal"
                f"{', RoPE' if theta else ''}: max |kernel - plain| {err:.3e} "
                f"(rtol/atol 2e-2)")
    log(f"attention: {len(ATTN_SWEEP)} sweep cases and {len(ATTN_BF16_EDGES)} "
        f"bf16 edges within _tol")
    return main_err


def wkv6_inputs(gen, B, S, H, hd, dtype, decay=(-8.0, 3.0), state=False):
    """r, k, v in ``dtype``; lw = -exp(uniform(decay)) clipped as
    ``rwkv6._decay`` clips (the default spans its whole clip range), or,
    with ``decay="init"``, -exp(-0.6 + 0.1·normal): the decays the RWKV-6
    init gives (``w0`` = -0.6, the decay LoRA scaled 0.01); u; state."""
    r, k, v = (torch.randn((B, S, H, hd), generator=gen, device="cuda").to(dtype)
               for _ in range(3))
    if decay == "init":
        lw = -torch.exp(-0.6 + 0.1 * torch.randn((B, S, H, hd), generator=gen,
                                                 device="cuda"))
    else:
        lo, hi = decay
        lw = -torch.exp(lo + (hi - lo) * torch.rand((B, S, H, hd), generator=gen,
                                                    device="cuda"))
    lw = torch.clamp(lw, -60.0, -1e-6)
    u = torch.randn((H, hd), generator=gen, device="cuda") * 0.3
    st = (torch.randn((B, H, hd, hd), generator=gen, device="cuda") * 0.1
          if state else None)
    return r, k, v, lw, u, st


def ssd_inputs(gen, B, S, H, P, N, dtype, state=False):
    """x, Bm, Cm in ``dtype``; dt = softplus(normal) + 0.01 and A_log in
    [-1, 1.5), as the JAX sweep draws them; state."""
    x = torch.randn((B, S, H, P), generator=gen, device="cuda").to(dtype)
    dt = torch.nn.functional.softplus(
        torch.randn((B, S, H), generator=gen, device="cuda")) + 0.01
    A_log = torch.rand((H,), generator=gen, device="cuda") * 2.5 - 1.0
    Bm, Cm = (torch.randn((B, S, N), generator=gen, device="cuda").to(dtype)
              for _ in range(2))
    st = (torch.randn((B, H, P, N), generator=gen, device="cuda") * 0.1
          if state else None)
    return x, dt, A_log, Bm, Cm, st


def _close(name, got, want, dt):
    torch.testing.assert_close(got, want, **rec_tol(dt), msg=lambda m: f"{name}: {m}")
    return float((got - want).abs().max())


def wkv6_cases():
    """``(label, case)``, case ``(B, S, H, hd, decays, dtype, with_state,
    chunk of the plain version, fp64 oracle too)``. At each of the RWKV-6
    path's shapes:

    * fp32 r/k/v (what the path gives) with the decays of the RWKV-6 init,
      against the plain version at chunk 64;
    * fp32 with decays over ``_decay``'s whole clip range, against the plain
      version at chunk 16 and against the fp64 sequential oracle. There the
      chunked form loses fp32 digits in its cumulative log-decay sums: at
      chunk 64 it leaves ``_rec_tol`` of the fp64 oracle on a few elements
      (logged), where the sequential kernel does not;
    * bf16 r/k/v over the clip range, against chunk 64.

    Then the JAX sweep with initial states, at chunk 64."""
    f32, bf16 = torch.float32, torch.bfloat16
    cases = []
    for path, shape in main_shapes()["wkv6"]:
        label = f"{path} B={shape[0]}"
        cases += [(label, (*shape, "init", f32, False, 64, False)),
                  (label, (*shape, (-8.0, 3.0), f32, False, 16, True)),
                  (label, (*shape, (-8.0, 3.0), bf16, False, 64, False))]
    return cases + [(f"sweep {i}", (B, S, H, hd, (lo, 0.5), dt, True, 64, False))
                    for i, (B, S, H, hd, lo, dt) in enumerate(WKV_SWEEP)]


def wkv6_case(W, gen, case):
    """The kernel against ``wkv6_plain``, out and final state, at
    ``_rec_tol`` on one case of ``wkv6_cases``. Returns max |kernel -
    plain| of out."""
    B, S, H, hd, decay, dt, with_state, chunk, oracle = case
    args = wkv6_inputs(gen, B, S, H, hd, dt, decay=decay, state=with_state)
    out, sf = W.wkv6_kernel(*args)
    ref_o, ref_s = W.wkv6_plain(*args, chunk=chunk)
    err = _close(f"wkv6 {case}", out, ref_o, dt)
    _close(f"wkv6 {case}, state", sf, ref_s, dt)
    if oracle:
        del ref_o, ref_s
        o64, s64 = W.wkv6_ref(*(t.double() for t in args[:5]),
                              None if args[5] is None else args[5].double())
        err64 = _close(f"wkv6 {case} vs fp64", out.double(), o64, dt)
        _close(f"wkv6 {case} vs fp64, state", sf.double(), s64, dt)
        p_o, _ = W.wkv6_plain(*args, chunk=64)
        t = rec_tol(dt)
        p_bad = int(((p_o.double() - o64).abs() > t["atol"] + t["rtol"] * o64.abs()).sum())
        log(f"wkv6 {(B, S, H, hd)} clip-range decays: |kernel - fp64 oracle| "
            f"{err64:.3e}; the plain version at chunk "
            f"64 is {float((p_o.double() - o64).abs().max()):.3e} from the "
            f"oracle, outside _rec_tol on {p_bad} of {o64.numel()} outputs")
    return err


def check_wkv6(W, gen):
    """Every case of ``wkv6_cases``; returns the largest error at the main
    path's shapes."""
    main_err = 0.0
    for label, case in wkv6_cases():
        err = wkv6_case(W, gen, case)
        if not label.startswith("sweep"):
            main_err = max(main_err, err)
            B, S, H, hd, decay, dt, _, chunk, _ = case
            log(f"wkv6 {label} {(B, S, H, hd)} {str(dt)[6:]} r/k/v, decays "
                f"{decay}: max |kernel - plain (chunk {chunk})| {err:.3e}")
    torch.cuda.synchronize()
    log(f"wkv6: {len(WKV_SWEEP)} sweep cases within _rec_tol")
    return main_err


def ssd_cases():
    """``(label, case)``, case ``(B, S, H, P, N, dtype, with_state)``: the
    Zamba2 path's shapes (bf16 x/B/C, as the path gives them), then the JAX
    sweep and the bf16 edges with initial states."""
    cases = [(f"{path} B={shape[0]}", (*shape, torch.bfloat16, False))
             for path, shape in main_shapes()["ssd"]]
    return (cases + [(f"sweep {i}", (*c, True)) for i, c in enumerate(SSD_SWEEP)]
            + [(f"sweep bf16 {i}", (*c, True)) for i, c in enumerate(SSD_BF16_EDGES)])


def ssd_case(SD, gen, case):
    """The kernel against ``ssd_plain`` (chunk 64), y and final state, at
    ``_rec_tol`` on one case of ``ssd_cases``. Returns max |kernel - plain|
    of y."""
    B, S, H, P, N, dt, with_state = case
    args = ssd_inputs(gen, B, S, H, P, N, dt, state=with_state)
    y, hf = SD.ssd_kernel(*args)
    ref_y, ref_h = SD.ssd_plain(*args, chunk=64)
    err = _close(f"ssd {case}", y, ref_y, dt)
    _close(f"ssd {case}, state", hf, ref_h, dt)
    return err


def check_ssd(SD, gen):
    """Every case of ``ssd_cases``; returns the largest error at the main
    path's shapes."""
    main_err = 0.0
    for label, case in ssd_cases():
        err = ssd_case(SD, gen, case)
        if not label.startswith("sweep"):
            main_err = max(main_err, err)
            log(f"ssd {label} {case[:4]} N={case[4]} bf16: max |kernel - plain| "
                f"{err:.3e}")
    torch.cuda.synchronize()
    log(f"ssd: {len(SSD_SWEEP)} sweep cases and {len(SSD_BF16_EDGES)} bf16 "
        f"edges within _rec_tol")
    return main_err


# ---------------------------------------------------------------------------
# Phase 3: the main paths.
# ---------------------------------------------------------------------------


def _bytes(t):
    return t.reshape(-1).view(torch.uint8)


def expected_launches(cfg, n_coded_leaves):
    """The launches of one path's run, kernel by kernel: per step, each
    layer's kernel once in the forward and once more in its remat
    recompute (the backwards differentiate the plain versions and launch
    nothing); Zamba2's shared attention block, applied outside the remat,
    once per application; in the one scale-out, the encode once for all
    fp32 leaves together and the decode once for all of them."""
    from repro_torch.kernels import ops
    from repro_torch.models import zamba2

    steps = sum(STEPS)
    per_layer = steps * cfg.n_layers * (2 if cfg.remat else 1)
    n = dict.fromkeys(ops.launches, 0)
    n["shard_encode"] = 1 if n_coded_leaves else 0
    n["shard_decode"] = 1 if n_coded_leaves else 0
    if cfg.family == "dense":
        n["flash_attention"] = per_layer
    elif cfg.family == "ssm":
        n["wkv6"] = per_layer
    elif cfg.family == "hybrid":
        n["ssd"] = per_layer
        n["flash_attention"] = steps * zamba2.n_shared_apps(cfg)
    else:
        raise ValueError(f"no main path for family {cfg.family!r}")
    return n


def main_path(ops, name):
    """One family's main path. Returns (trainer, launches)."""
    from repro_torch import tree as T
    from repro_torch.configs import get_config
    from repro_torch.core.replication import build_manifest
    from repro_torch.core.sharding_alg import NeighborLink
    from repro_torch.data import ShardedLoader, TokenStream
    from repro_torch.elastic import ElasticTrainer
    from repro_torch.kernels import shard_codec as codec_module
    from repro_torch.models import build_model

    cfg = get_config(name)
    model = build_model(cfg)
    loader = ShardedLoader(TokenStream(cfg.vocab, SEQ, seed=0), 4096, [0],
                           PER_DEVICE_BATCH)

    def link_model(device_id):  # as in examples/elastic_training.py
        fast = device_id % 2 == 0
        return NeighborLink(prop_s=0.002 if fast else 0.01,
                            trans_s_per_byte=(1 / (500e6 / 8) if fast
                                              else 1 / (120e6 / 8)),
                            sync_s=0.0)

    trainer = ElasticTrainer(model, initial=2,
                             per_device_batch=PER_DEVICE_BATCH,
                             link_model=link_model, codec="int8",
                             on_reshard=loader.reshard)
    trainer.init()
    n_params = sum(p.numel() for p in T.leaves(trainer.state["params"]))
    manifest = build_manifest(trainer.state)
    log(f"path {name}: full width and depth ({cfg.n_layers} layers, d_model "
        f"{cfg.d_model}, {n_params} params; state {manifest.total_bytes} "
        f"bytes in {len(manifest.entries)} leaves), seq {SEQ}, per-device "
        f"batch {PER_DEVICE_BATCH}, int8 codec")
    losses = []

    def steps(n):
        for _ in range(n):
            toks = np.concatenate([loader.next_batch(i)
                                   for i in trainer.device_ids()])
            m = trainer.step({"tokens": toks})
            losses.append(m["loss"])
            log(f"  step {trainer.step_count} on {len(trainer.active)} "
                f"devices: loss {m['loss']:.4f} grad_norm {m['grad_norm']:.4f}")

    torch.cuda.reset_peak_memory_stats()
    torch.cuda.synchronize()
    ops.reset_launches()
    t0 = time.perf_counter()
    steps(STEPS[0])
    # The state before the scale-out, kept on the host (a device copy of a
    # 19 GB state would crowd the card) and compared leaf by leaf, bit for
    # bit, after it.
    before = [leaf.detach().to("cpu", copy=True) for leaf in T.leaves(trainer.state)]
    expected = expected_launches(cfg, sum(
        1 for leaf in before if leaf.dtype == torch.float32 and leaf.numel()))
    torch.cuda.empty_cache()
    peak_train = torch.cuda.max_memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    ev_out = trainer.scale_out()
    peak_scale_out = torch.cuda.max_memory_allocated()
    unchanged = all(torch.equal(_bytes(b.to(leaf.device)), _bytes(leaf))
                    for b, leaf in zip(before, T.leaves(trainer.state)))
    del before
    steps(STEPS[1])
    ev_in = trainer.scale_in()
    steps(STEPS[2])
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = dict(ops.launches)
    peak = max(peak_train, peak_scale_out, torch.cuda.max_memory_allocated())

    if not unchanged:
        raise AssertionError(f"{name}: scale-out changed the training state")
    if not all(math.isfinite(x) for x in losses):
        raise AssertionError(f"{name}: non-finite loss: {losses}")
    if launches != expected:
        raise AssertionError(f"{name}: launches {launches}, expected {expected}")
    check_encode_many(codec_module, [leaf for leaf in T.leaves(trainer.state)
                                      if leaf.dtype == torch.float32
                                      and leaf.numel()])
    log(f"{name}: the many-leaf encode of the full state is bit-identical to "
        f"the per-leaf plain encode")
    breakdown = scale_out_breakdown(trainer, codec_module)
    log(f"{name} scale-out phases on the trainer's state, each closed by a "
        f"sync: {json.dumps(breakdown)} (the trainer's own scale-out "
        f"{ev_out.wall_s * 1e3:.1f} ms); the decoded state bit-identical to "
        f"the per-leaf plain decode")
    codec = ev_out.plan_summary["codec"]
    summary = {
        "path": name,
        "n_params": n_params,
        "state_bytes": manifest.total_bytes,
        "losses": losses,
        "step_ms": {n: [t * 1e3 for t in ts] for n, ts in
                    trainer.metrics_snapshot()["step_times"].items()},
        "scale_out_ms": ev_out.wall_s * 1e3,
        "scale_out_phases_ms": breakdown,
        "scale_in_ms": ev_in.wall_s * 1e3,
        "plan": {k: ev_out.plan_summary[k]
                 for k in ("shard_size", "n_shards", "bytes_per_source",
                           "predicted_completion_s")},
        "codec": codec,
        "launches": launches,
        "wall_s": wall,
        "peak_mem_gb": peak / 1e9,
        "peak_mem_scale_out_gb": peak_scale_out / 1e9,
    }
    log(f"{name} scale-out: state bit-unchanged, round-trip within scale/2, "
        f"wire {codec['wire_bytes']} of {codec['payload_bytes']} bytes; peak "
        f"device memory {peak / 1e9:.1f} GB (scale-out "
        f"{peak_scale_out / 1e9:.1f} GB)")
    log(json.dumps({"main_path": summary}))
    profile_step(trainer, loader, ops)
    return trainer, launches


def scale_out_breakdown(trainer, codec):
    """The phases of one scale-out, run as ``ElasticTrainer.scale_out``
    runs them on the trainer's state, each timed on the host clock and
    closed by a sync: ``plan_replication``, ``encode_state``,
    ``decode_state``, ``roundtrip_max_error_ok``. Fails unless the check
    passes and every decoded int8 leaf equals its per-leaf plain decode."""
    from repro_torch import tree as T
    from repro_torch.core import replication as rep

    state = trainer.state
    ms = {}

    def timed(key, fn):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        ms[key] = (time.perf_counter() - t0) * 1e3
        return out

    timed("plan_replication", lambda: rep.plan_replication(
        state, trainer.replication_neighbors()))
    enc, manifest, _ = timed("encode_state", lambda: rep.encode_state(state, "int8"))
    dec = timed("decode_state", lambda: rep.decode_state(enc, manifest))
    if not timed("roundtrip_max_error_ok",
                 lambda: rep.roundtrip_max_error_ok(state, dec, enc)):
        raise AssertionError("scale-out breakdown: round-trip check failed")
    for e, d in zip(enc, T.leaves(dec)):
        if e.kind == "int8" and not torch.equal(
                d.reshape(-1), codec.shard_decode_plain(e.codes, e.scales, d.numel())):
            raise AssertionError("decode_state differs from the per-leaf plain decode")
    return ms


def profile_step(trainer, loader, ops):
    """Where one steady step's device time goes: kernels by device time
    (torch.profiler), and the device's busy share of the step's wall time;
    the device time inside each plain backward (a ``record_function`` range
    in ``kernels.ops``). Runs after the launch counters were read."""
    from torch.profiler import ProfilerActivity, profile

    toks = np.concatenate([loader.next_batch(i) for i in trainer.device_ids()])
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        trainer.step({"tokens": toks})
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    rows, ranges = device_times(prof.profiler.kineto_results.events(),
                                ops.BACKWARD_RANGES)
    busy_ms = sum(r[0] for r in rows)
    steady = trainer.metrics_snapshot()["step_times"][len(trainer.active)][1:-1]
    step_ms = float(np.median(steady)) * 1e3
    log(f"profile of one step on {len(trainer.active)} devices (global batch "
        f"{trainer.global_batch}): device busy {busy_ms:.1f} ms; wall "
        f"{wall_ms:.1f} ms under the profiler, {step_ms:.1f} ms median "
        f"unprofiled step ({busy_ms / step_ms:.1%} busy)")
    groups = {}
    for ms, count, key in rows:
        name = _kernel_group(key)
        groups[name] = groups.get(name, 0.0) + ms
    for name, ms in sorted(groups.items(), key=lambda kv: -kv[1]):
        log(f"  {ms:8.2f} ms {ms / busy_ms:6.1%}  {name}")
    for ms, count, key in rows[:12]:
        log(f"  {ms:8.2f} ms {ms / busy_ms:6.1%} {count:5d}x  {key[:80]}")
    for key, (ms, count) in sorted(ranges.items()):
        log(f"  inside {key} ({count}x, kernels of every group above): "
            f"{ms:8.2f} ms {ms / busy_ms:6.1%}")


def device_times(events, range_names):
    """From a profile's raw events: ``rows``, (ms, count, name) of each
    device event name (kernels, memcpys) by total duration, largest first;
    and ``ranges``, name → (ms, count): the device time of the kernels
    launched inside each CPU-side ``record_function`` range of
    ``range_names``. A kernel's ``linked_correlation_id`` names the operator
    that launched it. Raw events, not ``key_averages()``: building the
    profiler's event tree takes minutes for the recurrent paths' hundreds of
    thousands of events."""
    cuda = torch.autograd.DeviceType.CUDA
    per_name = {}
    kernels = []  # (linked correlation id, ns)
    launch_ns = {}  # operator correlation id -> its start
    spans = {name: [] for name in range_names}
    for e in events:
        name = e.name()
        if e.device_type() == cuda:
            if name in spans or e.duration_ns() <= 0:
                continue  # a range's device-side marker
            ns, count = per_name.get(name, (0, 0))
            per_name[name] = (ns + e.duration_ns(), count + 1)
            kernels.append((e.linked_correlation_id(), e.duration_ns()))
        elif name in spans:
            spans[name].append((e.start_ns(), e.start_ns() + e.duration_ns()))
        elif e.linked_correlation_id() == 0 and e.correlation_id() > 0:
            launch_ns[e.correlation_id()] = e.start_ns()
    rows = sorted(((ns / 1e6, count, name)
                   for name, (ns, count) in per_name.items()), reverse=True)
    ranges = {}
    for name, intervals in spans.items():
        if not intervals:
            continue
        intervals.sort()
        starts = [s for s, _ in intervals]
        ns = 0
        for corr, dur in kernels:
            t = launch_ns.get(corr)
            if t is None:
                continue
            i = bisect.bisect_right(starts, t) - 1
            if i >= 0 and t <= intervals[i][1]:
                ns += dur
        ranges[name] = (ns / 1e6, len(intervals))
    return rows, ranges


def _kernel_group(key):
    """Coarse class of a device event, by kernel name."""
    k = key.lower()
    if "flash_attention" in k:
        return "flash-attention kernel (forward and remat recompute)"
    if "wkv6_fwd" in k:
        return "wkv6 kernel (forward and remat recompute)"
    if "ssd_fwd" in k or "ssd_chunked" in k:
        return "ssd kernel (forward and remat recompute)"
    if "gemm" in k and "bf16" in k:
        return "bf16 GEMMs (projections, MLP, unembedding)"
    if "gemm" in k:
        return "fp32 GEMMs (plain backwards, fp32 projections)"
    if "softmax" in k:
        return "softmax (plain attention backward)"
    if "memcpy" in k or "copy" in k:
        return "copies and casts"
    if "reduce" in k:
        return "reductions"
    return "other elementwise"


# ---------------------------------------------------------------------------
# Phase 4: a small input against the plain versions on the CPU.
# ---------------------------------------------------------------------------


def reference_check(name):
    from repro_torch import tree as T
    from repro_torch.configs import get_config
    from repro_torch.models import build_model

    cfg = get_config(name).reduced()
    cpu = build_model(cfg, device="cpu")
    gpu = build_model(cfg)
    state = cpu.init_train_state(torch.Generator().manual_seed(0))
    gstate = T.tree_map(lambda t: t.to("cuda", copy=True), state)
    tokens = np.random.default_rng(0).integers(0, cfg.vocab, size=(4, 129))
    _, m_cpu = cpu.make_train_step()(state, {"tokens": tokens})
    _, m_gpu = gpu.make_train_step()(gstate, {"tokens": tokens})
    for key in ("loss", "grad_norm"):
        a, b = float(m_gpu[key]), float(m_cpu[key])
        # bf16 activations on both sides; the kernels and the plain
        # versions round differently: bf16's 2e-2.
        if not math.isclose(a, b, rel_tol=2e-2):
            raise AssertionError(f"reduced {name} {key}: card {a} vs cpu {b}")
    for path, leaf in T.flatten_with_paths(gstate["params"]):
        if not bool(torch.isfinite(leaf).all()):
            raise AssertionError(f"non-finite params at {path}")
    log(f"reference: reduced {name} loss {float(m_gpu['loss']):.5f} on the "
        f"card vs {float(m_cpu['loss']):.5f} on the cpu; grad_norm "
        f"{float(m_gpu['grad_norm']):.5f} vs {float(m_cpu['grad_norm']):.5f}")


# ---------------------------------------------------------------------------
# Phase 5: times.
# ---------------------------------------------------------------------------


def device_ms(fn, name, tries=3):
    """Device time of one call of ``fn``: the summed durations of the
    kernels whose name holds ``name``, in a profiler trace read from the
    raw events as ``device_times`` reads them (after a warm-up call). Now
    and then a trace lacks the kernel (seen for the one-launch encode, in
    this script after the recurrent paths' large traces and once in a short
    script); then it profiles again, up to ``tries`` traces, and returns
    None if none holds the kernel."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    for _ in range(tries):
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            fn()
            torch.cuda.synchronize()
        rows, _ = device_times(prof.profiler.kineto_results.events(), ())
        hits = [ms for ms, _, key in rows if name in key]
        if hits:
            return sum(hits)
    return None


def _ms(x):
    return "not measured" if x is None else f"{x:.4f} ms"


def time_codec(codec, state):
    """Encode and decode of every fp32 leaf of the full state, as one
    scale-out runs them: each in one launch, as a CUDA-event window and as
    device time. Beside them the plain versions and, for the decode, the
    library call ``torch.mul(codes, scales[:, None])`` (int8 times fp32
    promotes to fp32: one IEEE multiply an element) leaf by leaf, first
    checked bit-identical to the plain decode."""
    from repro_torch import tree as T

    leaves = [leaf for leaf in T.leaves(state) if leaf.dtype == torch.float32]
    n = sum(leaf.numel() for leaf in leaves)
    nb = sum(-(-leaf.numel() // 256) for leaf in leaves)
    codes_list, scales_list = leaf_rows(*codec.shard_encode_many_kernel(leaves))
    enc = list(zip(codes_list, scales_list))
    numels = [leaf.numel() for leaf in leaves]

    def encode_many():
        codec.shard_encode_many_kernel(leaves)

    def decode_many():
        codec.shard_decode_many_kernel(codes_list, scales_list, numels)

    def library():
        for c, sc in enc:
            torch.mul(c, sc[:, None])

    for c, sc in enc:
        if not torch.equal(torch.mul(c, sc[:, None]), codec.shard_decode_plain(c, sc)):
            raise AssertionError("torch.mul(codes, scales[:, None]) differs from "
                                 "the plain decode")
    e_ms = cuda_ms(encode_many, 5)
    e_dev = device_ms(encode_many, "shard_encode")
    e_plain = cuda_ms(lambda: [codec.shard_encode_plain(x) for x in leaves], 2, 1)
    d_ms = cuda_ms(decode_many, 5)
    d_dev = device_ms(decode_many, "shard_decode")
    d_plain = cuda_ms(lambda: [codec.shard_decode_plain(c, sc, m)
                               for (c, sc), m in zip(enc, numels)], 2, 1)
    d_lib = cuda_ms(library, 5)
    coded = nb * 256 + 4 * nb  # codes + scales
    enc_bound = bound(4 * n + coded, 6 * n, PEAK_FP32_FLOPS)
    dec_bound = bound(coded + 4 * n, n, PEAK_FP32_FLOPS)
    log(f"codec over the full state: {len(leaves)} fp32 leaves, {n} elements; "
        f"encode in one launch {e_ms:.4f} ms (device {_ms(e_dev)}); decode "
        f"in one launch {d_ms:.4f} ms (device {_ms(d_dev)}); torch.mul leaf "
        f"by leaf {d_lib:.4f} ms (bit-identical to the plain decode)")
    return (dict(ms=e_ms, device_ms=e_dev, plain_ms=e_plain,
                 bound=enc_bound, elements=n),
            dict(ms=d_ms, device_ms=d_dev, plain_ms=d_plain, bound=dec_bound,
                 library_ms=d_lib, elements=n))


def time_attention(fa, MaskSpec, gen):
    B, S, H, hd = PER_DEVICE_BATCH * 2, SEQ, 12, 64
    q, k, v = (torch.randn((B, S, H, hd), generator=gen, device="cuda")
               .to(torch.bfloat16) for _ in range(3))
    scale = hd ** -0.5
    spec = MaskSpec("causal")
    k_ms = cuda_ms(lambda: fa.flash_attention_kernel(q, k, v, scale=scale), 20)
    p_ms = cuda_ms(lambda: fa.attention_plain(q, k, v, spec, scale=scale), 5)
    qt, kt, vt = (t.transpose(1, 2) for t in (q, k, v))
    l_ms = cuda_ms(lambda: torch.nn.functional.scaled_dot_product_attention(
        qt, kt, vt, is_causal=True, scale=scale), 20)
    pairs = S * (S + 1) // 2  # causal (q, k) pairs this run computes
    flops = 4 * B * H * hd * pairs
    nbytes = 4 * B * S * H * hd * 2  # q, k, v read, o written, bf16
    return dict(ms=k_ms, plain_ms=p_ms, library_ms=l_ms,
                bound=bound(nbytes, flops, PEAK_BF16_FLOPS))


def time_wkv6(W, gen, shape):
    """At the RWKV-6 path's shape (global batch 8) and dtypes (fp32 r/k/v
    and decays)."""
    args = wkv6_inputs(gen, *shape, torch.float32)
    k_ms = cuda_ms(lambda: W.wkv6_kernel(*args), 20)
    p_ms = cuda_ms(lambda: W.wkv6_plain(*args, chunk=64), 3, 1)
    B, S, H, hd = shape
    n = B * S * H * hd
    # r, k, v, lw read, out written (fp32); u read; the final state written.
    nbytes = 5 * 4 * n + 4 * H * hd + 4 * B * H * hd * hd
    # Per (b, t, h) and state element: S = e*S + k*v (mul + FMA), o += r*S
    # (FMA): 5 fp32 operations.
    flops = 5 * n * hd
    return dict(ms=k_ms, plain_ms=p_ms, library_ms=None,
                bound=bound(nbytes, flops, PEAK_FP32_FLOPS))


def time_ssd(SD, gen, shape):
    """At the Zamba2 path's shape (global batch 8) and dtypes (bf16 x/B/C,
    fp32 dt)."""
    args = ssd_inputs(gen, *shape, torch.bfloat16)
    k_ms = cuda_ms(lambda: SD.ssd_kernel(*args), 20)
    p_ms = cuda_ms(lambda: SD.ssd_plain(*args, chunk=64), 3, 1)
    B, S, H, P, N = shape
    # x read (bf16), y written (fp32); dt, A_log read (fp32), B and C read
    # (bf16); the final state written.
    nbytes = (2 * B * S * H * P + 4 * B * S * H * P + 4 * B * S * H + 4 * H
              + 2 * 2 * B * S * N + 4 * B * H * P * N)
    # The chunked form's products per (b, h) and chunk of L = 64, at the bf16
    # tensor-core peak (2 flops a multiply-add): C·Bᵀ (L·L·N), M·X (L·L·P),
    # C·hᵀ (L·N·P) and the state update (L·P·N). (Counted as the
    # recurrence's 5·P·N fp32 operations per step at 67 TFLOP/s they gave
    # 0.160 ms, which is not the work the bf16 kernel does.) The bytes bound
    # it either way.
    L = 64
    chunks = B * H * -(-S // L)
    flops = 2 * chunks * (L * L * N + L * L * P + 2 * L * N * P)
    return dict(ms=k_ms, plain_ms=p_ms, library_ms=None,
                bound=bound(nbytes, flops, PEAK_BF16_FLOPS))


def open_baseline(csrc):
    """The kernel library built from another checkout's ``csrc`` (same C
    interface), with the entry points ``time_baseline*`` call."""
    from repro_torch.kernels import build

    t0 = time.perf_counter()
    old = build.open_library(build.build(csrc), names=(
        "repro_flash_attention_fwd", "repro_ssd_fwd", "repro_wkv6_fwd",
        "repro_shard_encode", "repro_shard_decode"))
    log(f"baseline build from {csrc}: {time.perf_counter() - t0:.1f} s")
    return old


def _in_turns(name, base_fn, new_fn):
    """CUDA-event times of baseline, kernel, kernel, baseline; the mean of
    each pair."""
    b1, n1, n2, b2 = (cuda_ms(fn, 20) for fn in (base_fn, new_fn, new_fn, base_fn))
    log(f"{name} at the path's shape: baseline {b1:.4f} / {b2:.4f} ms, "
        f"this checkout {n1:.4f} / {n2:.4f} ms")
    return dict(baseline_ms=(b1 + b2) / 2, ms=(n1 + n2) / 2)


def time_baseline_codec(old, leaves):
    """The baseline's per-leaf encode and decode against this checkout's one
    launch each, over the fp32 ``leaves`` of GPT-2's state, in turns: the
    baseline leaf by leaf with that checkout's wrappers' host work (flatten
    or contiguous, outputs allocated, the launch on the leaf's stream). Both
    as CUDA-event windows and as device time. Returns {name: times}."""
    from repro_torch.kernels import build
    from repro_torch.kernels import shard_codec as codec

    def old_encode():  # that checkout's shard_encode_kernel, leaf by leaf
        for leaf in leaves:
            xf = leaf.contiguous().reshape(-1)
            n = xf.numel()
            nb = -(-n // 256)
            c = torch.empty((nb, 256), dtype=torch.int8, device=leaf.device)
            sc = torch.empty((nb,), dtype=torch.float32, device=leaf.device)
            build.check(old.repro_shard_encode(xf.data_ptr(), n, c.data_ptr(),
                                               sc.data_ptr(), nb,
                                               build.stream_of(leaf)),
                        "baseline shard_encode")

    def new_encode():
        codec.shard_encode_many_kernel(leaves)

    codes_list, scales_list = leaf_rows(*codec.shard_encode_many_kernel(leaves))
    numels = [leaf.numel() for leaf in leaves]

    def old_decode():  # that checkout's shard_decode_kernel, leaf by leaf
        for c, sc, n in zip(codes_list, scales_list, numels):
            c, sc = c.contiguous(), sc.contiguous()
            out = torch.empty((n,), dtype=torch.float32, device=c.device)
            build.check(old.repro_shard_decode(c.data_ptr(), sc.data_ptr(), n,
                                               out.data_ptr(), build.stream_of(c)),
                        "baseline shard_decode")

    def new_decode():
        codec.shard_decode_many_kernel(codes_list, scales_list, numels)

    times = {}
    for name, old_fn, new_fn in (("shard_encode", old_encode, new_encode),
                                 ("shard_decode", old_decode, new_decode)):
        t = _in_turns(name, old_fn, new_fn)
        bd1, nd1, nd2, bd2 = (device_ms(fn, name) for fn in (
            old_fn, new_fn, new_fn, old_fn))
        log(f"{name} device time over {len(leaves)} leaves: baseline "
            f"{_ms(bd1)} / {_ms(bd2)}, this checkout {_ms(nd1)} / {_ms(nd2)}")
        if None not in (bd1, bd2, nd1, nd2):
            t.update(baseline_device_ms=(bd1 + bd2) / 2, device_ms=(nd1 + nd2) / 2)
        times[name] = t
    return times


def time_baseline(old, gen, shapes):
    """The baseline's attention, SSD and WKV6 kernels, timed on the same
    inputs as ``time_attention``/``time_ssd``/``time_wkv6`` in turns with
    this checkout's: baseline, kernel, kernel, baseline. Returns {name:
    {"baseline_ms", "ms"}}, each the mean of its two turns."""
    from repro_torch.kernels import build
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import ssd as SD
    from repro_torch.kernels import wkv6 as W

    B, S, H, hd = PER_DEVICE_BATCH * 2, SEQ, 12, 64
    q, k, v = (torch.randn((B, S, H, hd), generator=gen, device="cuda")
               .to(torch.bfloat16) for _ in range(3))
    out = torch.empty_like(q)
    stream = torch.cuda.current_stream().cuda_stream

    def old_attention():
        build.check(old.repro_flash_attention_fwd(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), 1, B, S,
            S, H, H, hd, hd ** -0.5, 0.0, 0, 0, 0, 0, stream), "baseline attention")

    x, dt, A_log, Bm, Cm, _ = ssd_inputs(gen, *shapes["ssd"][0][1], torch.bfloat16)
    Bs, Ss, Hs, P = x.shape
    N = Bm.shape[-1]
    y = torch.empty((Bs, Ss, Hs, P), dtype=torch.float32, device="cuda")
    hf = torch.empty((Bs, Hs, P, N), dtype=torch.float32, device="cuda")

    def old_ssd():
        build.check(old.repro_ssd_fwd(
            x.data_ptr(), dt.data_ptr(), A_log.data_ptr(), Bm.data_ptr(),
            Cm.data_ptr(), None, y.data_ptr(), hf.data_ptr(), 1, Bs, Ss, Hs, P,
            N, stream), "baseline ssd")

    wargs = wkv6_inputs(gen, *shapes["wkv6"][0][1], torch.float32)
    Bw, Sw, Hw, hw = wargs[0].shape
    wo = torch.empty((Bw, Sw, Hw, hw), dtype=torch.float32, device="cuda")
    ws = torch.empty((Bw, Hw, hw, hw), dtype=torch.float32, device="cuda")

    def old_wkv6():
        r, k_, v_, lw, u, _ = wargs
        build.check(old.repro_wkv6_fwd(
            r.data_ptr(), k_.data_ptr(), v_.data_ptr(), lw.data_ptr(),
            u.data_ptr(), None, wo.data_ptr(), ws.data_ptr(), 0, Bw, Sw, Hw,
            hw, stream), "baseline wkv6")

    return {
        "flash_attention": _in_turns("flash_attention", old_attention, lambda: (
            fa.flash_attention_kernel(q, k, v, scale=hd ** -0.5))),
        "ssd": _in_turns("ssd", old_ssd, lambda: SD.ssd_kernel(x, dt, A_log, Bm, Cm)),
        "wkv6": _in_turns("wkv6", old_wkv6, lambda: W.wkv6_kernel(*wargs)),
    }


def card_line():
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=60)
        return out.stdout.strip().splitlines()[0] if out.stdout.strip() else \
            f"nvidia-smi gave nothing (rc {out.returncode})"
    except (OSError, subprocess.TimeoutExpired) as e:
        return f"nvidia-smi unavailable: {e}"


def main():
    import argparse

    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--baseline", metavar="DIR",
                    help="root of an earlier checkout whose attention, SSD "
                         "and WKV6 kernels and per-leaf encode and decode "
                         "phase 5 times beside this one's")
    baseline = ap.parse_args().baseline
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; the port's kernels run only on a GPU",
              file=sys.stderr)
        return 1
    from repro_torch import tree as T
    from repro_torch.kernels import build
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import ops
    from repro_torch.kernels import shard_codec as codec
    from repro_torch.kernels import ssd as SD
    from repro_torch.kernels import wkv6 as W
    from repro_torch.models.layers import MaskSpec

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    log(f"torch {torch.__version__}, CUDA {torch.version.cuda}, "
        f"{torch.cuda.get_device_name(0)}")

    # Phase 1: build.
    t0 = time.perf_counter()
    build.load()
    log(f"build: {time.perf_counter() - t0:.1f} s (nvcc {build.last_build_s:.1f} s)")
    for line in build.build_log().splitlines():
        if "Compiling entry" in line or "registers" in line or "spill" in line:
            log("  ptxas: " + line.strip().removeprefix("ptxas info    : "))
    old = (open_baseline(pathlib.Path(baseline, "src", "repro_torch", "csrc"))
           if baseline else None)

    # Phase 2: kernels against plain versions.
    gen = torch.Generator(device="cuda").manual_seed(0)
    errs = {"shard_encode": check_codec(codec, gen)}
    errs["shard_decode"] = errs["shard_encode"]
    errs["flash_attention"] = check_attention(fa, gen)
    errs["wkv6"] = check_wkv6(W, gen)
    errs["ssd"] = check_ssd(SD, gen)

    # Phase 3: the main paths, one family at a time. GPT-2's state is the
    # codec's timing input (phase 5), timed while it is on the card.
    launches = {name: 0 for name in ops.launches}
    times = {}
    for name in PATHS:
        trainer, path_launches = main_path(ops, name)
        for k, n in path_launches.items():
            launches[k] += n
        if name == "gpt2":
            times["shard_encode"], times["shard_decode"] = time_codec(
                codec, trainer.state)
            if old is not None:
                leaves = [leaf for leaf in T.leaves(trainer.state)
                          if leaf.dtype == torch.float32]
                for key, base in time_baseline_codec(old, leaves).items():
                    for field in ("baseline_ms", "baseline_device_ms"):
                        if field in base:
                            times[key][field] = base[field]
                del leaves
        del trainer
        gc.collect()
        torch.cuda.empty_cache()
    log(f"launches over the three paths: {json.dumps(launches)}")

    # Phase 4: small-input references.
    for name in PATHS:
        reference_check(name)

    # Phase 5: times (the codec's were taken after the GPT-2 path).
    times["flash_attention"] = time_attention(fa, MaskSpec, gen)
    shapes = main_shapes()
    times["wkv6"] = time_wkv6(W, gen, shapes["wkv6"][0][1])
    times["ssd"] = time_ssd(SD, gen, shapes["ssd"][0][1])
    if old is not None:
        for name, t in time_baseline(old, gen, shapes).items():
            times[name]["baseline_ms"] = t["baseline_ms"]
    rows = [
        ("shard_encode", "src/repro_torch/csrc/shard_codec.cu",
         "src/repro/kernels/shard_codec.py:46"),
        ("shard_decode", "src/repro_torch/csrc/shard_codec.cu",
         "src/repro/kernels/shard_codec.py:70"),
        ("flash_attention", "src/repro_torch/csrc/flash_attention.cu",
         "src/repro/kernels/flash_attention.py:81"),
        ("wkv6", "src/repro_torch/csrc/wkv6.cu",
         "src/repro/kernels/wkv6.py:68"),
        ("ssd", "src/repro_torch/csrc/ssd.cu",
         "src/repro/kernels/ssd.py:66"),
    ]
    kernels = []
    for name, source, replaces in rows:
        t = times[name]
        bound_ms, bound_by = t["bound"]
        row = {"name": name, "route": "cuda", "source": source,
               "replaces": replaces, "launches": launches[name],
               "max_abs_err": errs[name], "ms": t["ms"],
               "plain_ms": t["plain_ms"], "bound_ms": bound_ms,
               "bound_by": bound_by, "library_ms": t.get("library_ms")}
        kernels.append(row)
        log(json.dumps({"kernel": name, "kernel_ms": t["ms"],
                        "plain_ms": t["plain_ms"], "bound_ms": bound_ms,
                        "library_ms": t.get("library_ms"),
                        "baseline_ms": t.get("baseline_ms"),
                        **{key: t[key] for key in (
                            "device_ms", "baseline_device_ms") if key in t},
                        "launches": launches[name]}))
    print(json.dumps({"kernels": kernels}))
    print(card_line())
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
