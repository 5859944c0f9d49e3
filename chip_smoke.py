#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (``src/repro_torch``) on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, each of which fails hard (any mismatch exits non-zero):

1. build the CUDA kernels from ``src/repro_torch/csrc`` (one ``nvcc`` per
   source, all at once) and print the build time and ptxas's register and
   spill lines;
2. hold every kernel against its plain PyTorch version on the card, at the
   main path's shapes and over the JAX kernel sweep;
3. the main path: full-width GPT-2 under ``ElasticTrainer`` with int8 state
   replication — 3 steps on 2 logical devices, a scale-out, 2 steps on 3, a
   scale-in, 2 steps on 2 — with the launch counters zeroed just before and
   read just after;
4. a reference check on a small input: reduced GPT-2's loss and gradient
   norm through the kernels on the card against the plain versions on the
   CPU;
5. times: each kernel, its plain version and (attention) the library call,
   beside the least time the card could take (H100 SXM data sheet: 3.35 TB/s,
   989 TFLOP/s bf16, 67 TFLOP/s fp32).

It prints one JSON line per kernel, a main-path line, the ``kernels`` line,
the card's name and power limit from ``nvidia-smi``, and last the line
``{"ok": true, "device": {...}}``. Without a CUDA device, or without the
repository around it, it exits non-zero and prints no result.
"""
import json
import math
import os
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


def tol(dtype):
    """``_tol`` of tests/test_kernels.py."""
    return (dict(rtol=2e-2, atol=2e-2) if dtype == torch.bfloat16
            else dict(rtol=2e-5, atol=2e-5))


def log(msg):
    print(msg, flush=True)


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
    return err


def check_attention(fa, MaskSpec, gen):
    B, S, H, hd = 8, SEQ, 12, 64
    q, k, v = (torch.randn((B, S, H, hd), generator=gen, device="cuda")
               .to(torch.bfloat16) for _ in range(3))
    spec = MaskSpec("causal")
    out = fa.flash_attention_kernel(q, k, v, scale=hd ** -0.5)
    ref = fa.attention_plain(q, k, v, spec, scale=hd ** -0.5)
    torch.testing.assert_close(out.float(), ref.float(), **tol(torch.bfloat16))
    main_err = float((out.float() - ref.float()).abs().max())
    log(f"attention (8, 1024, 12, 64) bf16 causal: max |kernel - plain| "
        f"{main_err:.3e} (rtol/atol 2e-2)")
    for i, (Bq, Sq, Skv, Hq, K, d, kind, window, prefix, softcap, dt) in \
            enumerate(ATTN_SWEEP):
        q = torch.randn((Bq, Sq, Hq, d), generator=gen, device="cuda").to(dt)
        k = torch.randn((Bq, Skv, K, d), generator=gen, device="cuda").to(dt)
        v = torch.randn((Bq, Skv, K, d), generator=gen, device="cuda").to(dt)
        spec = MaskSpec(kind, window=window, prefix_len=prefix)
        out = fa.flash_attention_kernel(q, k, v, scale=d ** -0.5,
                                        softcap=softcap, kind=kind,
                                        window=window, prefix_len=prefix)
        ref = fa.attention_plain(q, k, v, spec, scale=d ** -0.5,
                                 softcap=softcap)
        torch.testing.assert_close(out.float(), ref.float(), **tol(dt))
    log(f"attention: {len(ATTN_SWEEP)} sweep cases within _tol")
    return main_err


# ---------------------------------------------------------------------------
# Phase 3: the main path.
# ---------------------------------------------------------------------------


def main_path(ops):
    from repro_torch import tree as T
    from repro_torch.configs import get_config
    from repro_torch.core.replication import flatten_state
    from repro_torch.core.sharding_alg import NeighborLink
    from repro_torch.data import ShardedLoader, TokenStream
    from repro_torch.elastic import ElasticTrainer
    from repro_torch.models import build_model

    cfg = get_config("gpt2")
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
    log(f"main path: gpt2 at full width ({cfg.n_layers} layers, d_model "
        f"{cfg.d_model}, {n_params} params), seq {SEQ}, per-device batch "
        f"{PER_DEVICE_BATCH}, int8 codec")
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
    steps(3)
    before = flatten_state(trainer.state)[0].clone()
    ev_out = trainer.scale_out()
    unchanged = torch.equal(before, flatten_state(trainer.state)[0])
    del before
    steps(2)
    ev_in = trainer.scale_in()
    steps(2)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = dict(ops.launches)

    if not unchanged:
        raise AssertionError("scale-out changed the training state")
    if not all(math.isfinite(x) for x in losses):
        raise AssertionError(f"non-finite loss: {losses}")
    for name, count in launches.items():
        if count <= 0:
            raise AssertionError(f"kernel {name} was not launched on the "
                                 f"main path: {launches}")
    codec = ev_out.plan_summary["codec"]
    summary = {
        "losses": losses,
        "step_ms": {n: [t * 1e3 for t in ts] for n, ts in
                    trainer.metrics_snapshot()["step_times"].items()},
        "scale_out_ms": ev_out.wall_s * 1e3,
        "scale_in_ms": ev_in.wall_s * 1e3,
        "plan": {k: ev_out.plan_summary[k]
                 for k in ("shard_size", "n_shards", "bytes_per_source",
                           "predicted_completion_s")},
        "codec": codec,
        "launches": launches,
        "wall_s": wall,
        "peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9,
    }
    log("scale-out: state bit-unchanged, round-trip within scale/2, "
        f"wire {codec['wire_bytes']} of {codec['payload_bytes']} bytes")
    log(json.dumps({"main_path": summary}))
    profile_step(trainer, loader)
    return trainer, launches


def profile_step(trainer, loader):
    """Where one steady step's device time goes: kernels by self device
    time (torch.profiler), and the device's busy share of the step's wall
    time. Runs after the launch counters were read."""
    from torch.profiler import ProfilerActivity, profile

    toks = np.concatenate([loader.next_batch(i) for i in trainer.device_ids()])
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        trainer.step({"tokens": toks})
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    # Device-side events only (kernels, memcpys): the CPU-side operator rows
    # of key_averages() would count their kernels a second time.
    rows = [(e.self_device_time_total / 1e3, e.count, e.key)
            for e in prof.key_averages()
            if e.device_type == torch.autograd.DeviceType.CUDA
            and e.self_device_time_total > 0]
    rows.sort(reverse=True)
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


def _kernel_group(key):
    """Coarse class of a device event, by kernel name."""
    k = key.lower()
    if "flash_attention" in k:
        return "flash-attention kernel (forward and remat recompute)"
    if "gemm" in k and "bf16" in k:
        return "bf16 GEMMs (projections, MLP, unembedding)"
    if "gemm" in k:
        return "fp32 GEMMs (plain attention backward)"
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


def reference_check():
    from repro_torch import tree as T
    from repro_torch.configs import get_config
    from repro_torch.models import build_model

    cfg = get_config("gpt2").reduced()
    cpu = build_model(cfg, device="cpu")
    gpu = build_model(cfg)
    state = cpu.init_train_state(torch.Generator().manual_seed(0))
    gstate = T.tree_map(lambda t: t.to("cuda", copy=True), state)
    tokens = np.random.default_rng(0).integers(0, cfg.vocab, size=(4, 129))
    _, m_cpu = cpu.make_train_step()(state, {"tokens": tokens})
    _, m_gpu = gpu.make_train_step()(gstate, {"tokens": tokens})
    for key in ("loss", "grad_norm"):
        a, b = float(m_gpu[key]), float(m_cpu[key])
        # bf16 activations on both sides; the kernel and the plain
        # attention round differently: bf16's 2e-2.
        if not math.isclose(a, b, rel_tol=2e-2):
            raise AssertionError(f"reduced gpt2 {key}: card {a} vs cpu {b}")
    for path, leaf in T.flatten_with_paths(gstate["params"]):
        if not bool(torch.isfinite(leaf).all()):
            raise AssertionError(f"non-finite params at {path}")
    log(f"reference: reduced gpt2 loss {float(m_gpu['loss']):.5f} on the card "
        f"vs {float(m_cpu['loss']):.5f} on the cpu; grad_norm "
        f"{float(m_gpu['grad_norm']):.5f} vs {float(m_cpu['grad_norm']):.5f}")


# ---------------------------------------------------------------------------
# Phase 5: times.
# ---------------------------------------------------------------------------


def time_codec(codec, state):
    """Encode and decode of every fp32 leaf of the full state, as one
    scale-out runs them."""
    from repro_torch import tree as T

    leaves = [leaf for leaf in T.leaves(state) if leaf.dtype == torch.float32]
    n = sum(leaf.numel() for leaf in leaves)
    nb = sum(-(-leaf.numel() // 256) for leaf in leaves)
    enc = [codec.shard_encode_kernel(leaf) for leaf in leaves]
    enc_plain = [codec.shard_encode_plain(leaf) for leaf in leaves]
    for (kc, ks), (pc, ps) in zip(enc, enc_plain):
        if not (torch.equal(kc, pc) and torch.equal(ks, ps)):
            raise AssertionError("shard_encode differs from plain on the state")
    del enc_plain
    numels = [leaf.numel() for leaf in leaves]
    e_ms = cuda_ms(lambda: [codec.shard_encode_kernel(x) for x in leaves], 5)
    e_plain = cuda_ms(lambda: [codec.shard_encode_plain(x) for x in leaves], 2, 1)
    d_ms = cuda_ms(lambda: [codec.shard_decode_kernel(c, s, m)
                            for (c, s), m in zip(enc, numels)], 5)
    d_plain = cuda_ms(lambda: [codec.shard_decode_plain(c, s, m)
                               for (c, s), m in zip(enc, numels)], 2, 1)
    coded = nb * 256 + 4 * nb  # codes + scales
    enc_bound = bound(4 * n + coded, 6 * n, PEAK_FP32_FLOPS)
    dec_bound = bound(coded + 4 * n, n, PEAK_FP32_FLOPS)
    log(f"codec over the full state: {len(leaves)} fp32 leaves, {n} elements")
    return (dict(ms=e_ms, plain_ms=e_plain, bound=enc_bound, elements=n),
            dict(ms=d_ms, plain_ms=d_plain, bound=dec_bound, elements=n))


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
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; the port's kernels run only on a GPU",
              file=sys.stderr)
        return 1
    from repro_torch.kernels import build
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import ops
    from repro_torch.kernels import shard_codec as codec
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

    # Phase 2: kernels against plain versions.
    gen = torch.Generator(device="cuda").manual_seed(0)
    codec_err = check_codec(codec, gen)
    attn_err = check_attention(fa, MaskSpec, gen)

    # Phase 3: the main path.
    trainer, launches = main_path(ops)

    # Phase 4: small-input reference.
    reference_check()

    # Phase 5: times.
    enc, dec = time_codec(codec, trainer.state)
    attn = time_attention(fa, MaskSpec, gen)
    rows = [
        ("shard_encode", "src/repro_torch/csrc/shard_codec.cu",
         "src/repro/kernels/shard_codec.py:46", codec_err, enc),
        ("shard_decode", "src/repro_torch/csrc/shard_codec.cu",
         "src/repro/kernels/shard_codec.py:70", codec_err, dec),
        ("flash_attention", "src/repro_torch/csrc/flash_attention.cu",
         "src/repro/kernels/flash_attention.py:81", attn_err, attn),
    ]
    kernels = []
    for name, source, replaces, err, t in rows:
        bound_ms, bound_by = t["bound"]
        row = {"name": name, "route": "cuda", "source": source,
               "replaces": replaces, "launches": launches[name],
               "max_abs_err": err, "ms": t["ms"], "plain_ms": t["plain_ms"],
               "bound_ms": bound_ms, "bound_by": bound_by,
               "library_ms": t.get("library_ms")}
        kernels.append(row)
        log(json.dumps({"kernel": name, "kernel_ms": t["ms"],
                        "plain_ms": t["plain_ms"], "bound_ms": bound_ms,
                        "library_ms": t.get("library_ms"),
                        "launches": launches[name]}))
    print(json.dumps({"kernels": kernels}))
    print(card_line())
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
