#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (``src/repro_torch``) on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, each of which fails hard (any mismatch exits non-zero):

1. build the CUDA kernels from ``src/repro_torch/csrc`` (one ``nvcc`` per
   source, all at once) and print the build time and ptxas's register and
   spill lines;
2. hold every kernel against its plain PyTorch version on the card, at the
   shapes the main paths give it (read from the configs, at both global
   batches, 8 and 12 (PaliGemma's 4 and 6), and at the serving runs' prefill and decode shapes:
   attention over the cache at q_offsets 0 to the cache's last row and a
   ragged Skv, gemma2's local (window 4,096) and global layers with softcap
   50 and scale 0.0625 either side of where the window binds, granite's
   48:1 and llama3's 128:8 at full width; WKV6 at S 1 to 33 from a state;
   SSD at S 1 to 65 from a state on the views ``block_apply`` passes;
   the SSD and WKV6 decode regimes at every (P, N) and head dim in both
   dtypes, SSD's on such views)
   PaliGemma's prefix mask over 256 patches at head dim 256, MQA 8:1, in
   training, the serving prefill and decode, and fp32 and bf16 cases at
   head dim 256; Arctic's GQA 56:8 at head dim 128 and Kimi's 64:8 at head
   dim 112 in training, the serving prefill and decode; Whisper's encoder
   (full over 1,500 frames), decoder and cross-attention (Sq != Skv) in
   training, its serving prefill and decode; fp32 and bf16 cases at head
   dim 112) and over the JAX kernel sweeps; the attention backward kernels'
   dq, dk and dv within 1e-2 of the norm of fp32 autograd of the plain
   version, at the benchmark's GPT-2 layer (12, 1024, 12, 64, causal),
   Whisper's encoder, decoder and cross-attention and every main path's
   bf16 shape at a head dim they take; the many-leaf encode and decode (one
   launch per state) bit for bit against the per-leaf plain versions, the
   decode over all of GPT-2's fp32 leaf shapes and a ragged set; adamw8bit's
   block quantizer on TinyLlama's embedding bit for bit as on the CPU;
3. the main paths, one per trained family and TinyLlama, each at full
   width and full depth under ``ElasticTrainer`` with int8 state
   replication — 3 steps on 2 logical devices, a scale-out, 2 steps on 3,
   a scale-in, 2 steps on 2 — with the launch counters zeroed just before
   each path, read just after it and held to the exact counts its config
   gives: GPT-2 (codec, flash attention), RWKV-6 1.6B (codec, WKV6), Zamba2
   1.2B (codec, SSD, flash attention), TinyLlama 1.1B (codec, flash
   attention at GQA 32:4) and PaliGemma 3B at full width on
   ``PALIGEMMA_LAYERS`` of its 18 layers (``paligemma_cut``; codec, flash
   attention at hd 256 under the prefix mask, 1024 text tokens behind 256
   seeded patch embeddings per row) and Snowflake Arctic (moe) at full
   width on a cut of ``ARCTIC_LAYERS`` layers of ``ARCTIC_EXPERTS``
   experts, top-2, the dense residual, adamw8bit (``arctic_cut``; codec on
   the (L, E, d, ff) expert leaves, flash attention at GQA 56:8) and
   Kimi-K2 (moe) at full width on a cut of ``KIMI_LAYERS`` layers of
   ``KIMI_EXPERTS`` experts, top-8, one shared expert, adamw8bit
   (``kimi_cut``; flash attention at GQA 64:8, head dim 112), each
   step's aux loss and the first step's dropped (token, choice) pairs per
   MoE call printed; Whisper-small (encdec) at full width and depth
   (codec, flash attention: the encoder's over 1,500 seeded frame
   embeddings, the decoder's self- and cross-attention over 448 text
   tokens a row); each path's full state encoded by the many-leaf kernel bit
   for bit as the per-leaf plain encode; one scale-out's phases timed apart
   on the trainer's state (plan, encode, decode, round-trip check), the
   decoded state bit for bit as the per-leaf plain decode; one profiled
   step each; the replica tier on each path's full state (two
   ``MemoryReplicaStore`` pushes and a restore, bit for bit);
3b. self-healing: GPT-2 at full width and depth with both recovery tiers
   attached replays a churn trace (checkpoint, int8 join, degraded link,
   int8 join, that node's failure, checkpoint, leave) through
   ``replay_scenario`` under the adaptive recovery policy, then restores
   from the replica tier and from the disk tier, a step after each: both
   restores bit for bit the state the last checkpoint pushed, the losses
   after them that of the original step on the same batch within 1e-5, the
   launches the exact counts of the config, the ledger's actions the
   expected list; push, snapshot, background write and restore times; the
   ledger analytics over the replay's two ledgers (span forest and
   ``validate``, ``span_digest`` against the pinned
   ``SELF_HEALING_SPAN_DIGEST``, GoodPut, metrics exposition, Chrome trace
   into ``build/``, markdown) and their host time;
3c. the training launcher: ``python -m repro_torch.launch.train --arch gpt2
   --elastic --steps 9 --ckpt DIR --ckpt-every 3`` as a subprocess (reduced;
   exit 0, its checkpoints loaded with finite leaves); ``main`` in this
   process for reduced RWKV-6 and Zamba2 (``TRAIN_OK``, exact launches);
   ``train_elastic`` on GPT-2 at full width and depth, global batch 16 -> 20
   -> 16 over 4 -> 5 -> 4 logical devices, launches held to the exact
   counts, step times, the scale-out and peak memory;
3d. serving: GPT-2, RWKV-6 1.6B, Zamba2 1.2B, TinyLlama 1.1B and PaliGemma
   3B at full width and depth through the serving launcher's ``generate``
   (``Model.prefill``, ``Model.decode_step``): batch 8, a 1024-token
   prompt, 128 greedy new tokens, a cache of 1152 positions (PaliGemma:
   256 seeded patch embeddings in front, 1408 rows), bf16; Arctic on its
   training cut (``arctic_cut``) and Kimi on ``KIMI_SERVE_LAYERS`` layers
   of its cut's experts, the same request; Whisper-small over 1,500 seeded
   frames, a 4-token prompt and 224 new tokens (self cache 228); and
   gemma2-27b at full width on 2 layers (one local, one global), batch 2,
   a 4,608-token prompt (so that the window of 4,096 binds), 64 new
   tokens; launches held to the exact
   counts; prefill ms, decode ms per token (median, p90; each step closed
   by a sync), decode tokens/s,
   the decode loop timed as one window with one sync, peak memory, the
   device's busy share of one profiled decode step, its device events and
   its five largest device operations, the SSD and WKV6 decode regimes'
   kernels once per layer in it and no chunked or sequential launch; the
   bf16 prefill's logits against the cache-free
   forward over the same prompt within ``_tol`` (GPT-2) or ``_rec_tol``
   (RWKV-6, Zamba2); the bf16 drift of every decode step against the
   cache-free forward (reported, not gated); fp32 prefill and 7 forced
   decode steps against the cache-free fp32 forward at the same
   tolerances, and planted faults (the dense family: the cache written one
   slot off, and for gemma2 the local layer without its window, the global
   layer with it, the attention softcap dropped; RWKV-6: ``x_last`` or the
   state not carried; Zamba2: the conv or the SSM state not carried, the
   shared block's applications sharing one KV cache, the cache written one
   slot off, RoPE from position 0 at decode; PaliGemma: the cache written
   one slot off, decoding at the JAX launcher's ``S + t``, the causal mask
   on the cached prefill, and a cache without the patches' rows, which
   must raise; Arctic and Kimi: the dense family's; Whisper: the self cache
   written one slot off, the cross cache filled from another row's
   frames) that must fail that check; for
   Arctic and Kimi the check counts the (token, choice) pairs each MoE call drops
   past its experts' capacity on both sides (a prefill, a decode step and
   the cache-free forward each have their own capacity), leaves out every
   batch row that dropped a pair on either side and fails if none is
   left;
3e. granite-34b and llama3-405b, which fit no card, reduced: 2 steps
   under ``ElasticTrainer`` with the int8 codec, a scale-out that leaves
   the state bit-unchanged (llama3's adamw8bit codes ship raw, their fp32
   scales through the codec), a step, exact launches; a served request
   with exact launches and ``serve_fp32_check``;
4. a reference check on a small input: each reduced model's loss and
   gradient norm through the kernels on the card against the plain
   versions on the CPU;
5. times: each kernel, its plain version and (attention) the library call,
   beside the least time the card could take (H100 SXM data sheet: 3.35 TB/s,
   989 TFLOP/s bf16, 67 TFLOP/s fp32); for the codec over GPT-2's state
   also the device time (the kernels' own durations in a profiler trace)
   beside the CUDA-event window, which holds the host's dispatch too, and
   for the decode the library call ``torch.mul(codes, scales[:, None])``
   leaf by leaf; the decode shapes of attention (GPT-2's, Zamba2's,
   TinyLlama's, PaliGemma's and gemma2's local and global layers, beside
   ``scaled_dot_product_attention`` where it computes the same function:
   it has no softcap; each with the decode regime's split count, CTAs and
   share of the memory rate), WKV6 and SSD as device time per launch, one
   input set per layer (per application of Zamba2's shared block), the
   decode regimes in turns with this tree's sequential and chunked kernels
   at S = 1 (SSD's also with the copies the chunked kernel's wrapper makes)
   and at each of ``DECODE_STEP_SWEEP`` steps; attention
   at PaliGemma's training shape (prefix 256, hd 256), Arctic's (causal,
   GQA 56:8, hd 128) and Kimi's (causal, GQA 64:8, hd 112; both also their
   serving prefill into the cache of 1152) and Whisper's encoder, decoder
   and cross-attention shapes beside SDPA with the mask as an explicit
   boolean mask (a ``kernel_train_shape`` line), and Whisper's decode
   cross-attention over its 1,500 frames; the attention backward kernels at
   GPT-2's benchmark layer (the ``kernels`` line's ``flash_attention_bwd``
   row) and Whisper's three shapes beside the plain backward and SDPA's
   backward (a ``kernel_train_shape`` line each);
6. the simulator substrate (``repro_torch.core``: topology on a stdlib
   graph, the event simulator, the cluster monitor, the negotiation
   protocols, the baselines), host Python that launches no kernel:
   ``simulator_sweep`` (every strategy over the paper's GPT-2 and
   ResNet-101 state profiles on 6-12-node random overlays, seeds 0-3,
   codecs none and int8, the planner's charge pinned; scale-in,
   connect-link and disconnect-link; a monitor run per detector with a
   node fault, a link fault and 30% loss; the multi-source plans on
   ``pod_topology(32)``) held to the pinned ``SIMULATOR_DIGEST``; the same
   scale-outs with the planner's time measured give the paper's tables
   (mean delay and idle per strategy and cluster size, the primitives'
   largest delay, each under 1 ms), all in the simulator's virtual
   seconds; a join of GPT-2's fp32 state under int8 beside the codec's
   modelled charge and the codec kernels' device time from phase 5.
7. the churn backend (``repro_torch.core``: the control plane,
   ``SimBackend``, the checkpoint tier, the simulator collectors and
   ``repro_torch.scenarios``' generators), host Python that launches no
   kernel, with networkx, JAX and the JAX package absent: ``churn_sweep``
   replays the omniscient poisson trace held to the pinned
   ``PRE_RESHARD_DIGEST``, every generator family under the fixed and the
   adaptive recovery policy on the GPT-2 profile (checkpoint tier,
   reshard and int8 runs among them) and ``benchmarks/goodput.py``'s
   churn-rate sweep, omniscient and silent; the canonical JSON of every
   replay's trace, ledger, decision and span digests, ``validate``,
   GoodPut report and metrics exposition is held to the pinned
   ``CHURN_DIGEST``; it prints GoodPut and its BadPut components per
   family and policy and per churn rate, detection latency, time to
   recover and the largest handling of scale-in and link events (asserted
   under 20 ms), all in the simulator's virtual seconds.
8. sharding, meshes and the dry run (``sharding_phase``): the port's
   specs of every config on the four plans of ``launch/mesh.py`` held to
   the pinned ``SHARDING_DIGEST`` (the JAX package's, from
   ``tests/test_torch_sharding.py``); TinyLlama's full train state on the
   card cut into every device's block (views) under the debug plans' tp
   specs and the trainer's tp 2 and tp 4 layouts over 4 logical devices,
   each layout's blocks reassembled ``torch.equal`` to the state, the
   debug plans' per-device param bytes equal to ``shard_report``'s and a
   model row's blocks to its replication blowup × total; a one-rank
   ``DeviceMesh`` over NCCL (a ``HashStore``): every TinyLlama leaf
   through ``distribute_tensor`` bit for bit, ``constrain`` on a
   ``DTensor`` activation leaving its values; the dry run
   (``launch/dryrun.run_cell``, traced on the meta device) of every
   ``ASSIGNED`` arch at ``decode_32k`` on both production meshes and of
   TinyLlama at every shape, timed; TinyLlama's one-device cell at the
   main path's batch and sequence, whose argument bytes must equal the
   bytes its state and batch take on the card, its traced peak logged
   beside ``torch.cuda.max_memory_allocated`` of one real step; and
   ``python -m repro_torch.launch.train --lower-only`` as a subprocess
   (exit 0). It launches its own steps after the paths' counts are read.

    python3 chip_smoke.py --baseline DIR

adds to phase 5 the times of the attention, SSD and WKV6 kernels (at the
training and the decode shapes) and the per-leaf encode and decode
built from the checkout at DIR (an earlier commit, unpacked), on the
same inputs, in turns with this checkout's (baseline, kernel, kernel,
baseline).

It prints one JSON line per kernel, per path, for the self-healing phase,
for the launcher, per serving run and per reduced dense run, the
``simulator`` line, the ``churn`` line, the ``kernels`` line (launches
summed over the paths, the self-healing replay, the launcher's in-process
runs, the serving runs and the reduced dense runs), the card's
name and power limit from ``nvidia-smi``, and last the line ``{"ok": true, "device": {...}}``. Without a CUDA
device, or without the repository around it, it exits non-zero and prints
no result. The whole run has JAX, the JAX package and networkx set
unimportable in ``sys.modules``; it logs its seconds before the JSON lines.
"""
import bisect
import collections
import contextlib
import ctypes
import gc
import hashlib
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

from repro_torch import spans  # noqa: E402  (torch and the standard library only)

#: What the port must run without: JAX, the JAX package and networkx.
BLOCKED = ("networkx", "jax", "repro")
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
    # Head dim 256 (PaliGemma's; a 2-stage K/V ring): a ragged Sq at MQA
    # 8:1, a prefix of 100 (no multiple of the 64-key tile) with a window,
    # a prefix into a longer cache (Skv > Sq, ragged both), a softcap.
    (1, 300, 300, 8, 1, 256, "causal", 0, 0, 0.0, torch.bfloat16),
    (1, 300, 300, 4, 1, 256, "prefix", 64, 100, 0.0, torch.bfloat16),
    (2, 130, 330, 8, 1, 256, "prefix", 0, 100, 0.0, torch.bfloat16),
    (1, 257, 257, 2, 2, 256, "full", 0, 0, 30.0, torch.bfloat16),
    # Head dim 112 (Kimi-K2's; two 64-column panels, the second half
    # padding, seven QKᵀ k-steps): GQA 64:8 over a ragged Sq, MQA 8:1, a
    # window with a softcap, a prefix into a longer ragged cache, full with
    # Skv != Sq.
    (1, 300, 300, 64, 8, 112, "causal", 0, 0, 0.0, torch.bfloat16),
    (2, 200, 200, 8, 1, 112, "causal", 0, 0, 0.0, torch.bfloat16),
    (1, 192, 192, 2, 2, 112, "causal", 48, 0, 30.0, torch.bfloat16),
    (2, 130, 330, 8, 1, 112, "prefix", 0, 100, 0.0, torch.bfloat16),
    (1, 100, 300, 4, 2, 112, "full", 0, 0, 0.0, torch.bfloat16),
]
# Head dim 256 in fp32, beside the JAX sweep: the prefix mask with a prefix
# of 100 (no multiple of the 64-key tile), also into a longer cache (Skv >
# Sq) and with a window; causal at GQA 2:1; full.
ATTN_HD256 = [
    (2, 300, 300, 8, 1, 256, "prefix", 0, 100, 0.0, torch.float32),
    (1, 200, 330, 4, 1, 256, "prefix", 0, 100, 0.0, torch.float32),
    (1, 200, 200, 2, 1, 256, "prefix", 48, 100, 0.0, torch.float32),
    (1, 128, 128, 4, 2, 256, "causal", 0, 0, 0.0, torch.float32),
    (1, 96, 160, 2, 2, 256, "full", 0, 0, 0.0, torch.float32),
]
# Head dim 112 in fp32 (the FMA path: seven float4s per thread of a row):
# causal at GQA 64:8 over a ragged Sq, a window with a softcap, the prefix
# mask into a longer cache, full with Skv != Sq; the decode rows are in
# ``attention_cases``.
ATTN_HD112 = [
    (1, 200, 200, 64, 8, 112, "causal", 0, 0, 0.0, torch.float32),
    (1, 192, 192, 2, 2, 112, "causal", 48, 0, 30.0, torch.float32),
    (1, 200, 330, 4, 1, 112, "prefix", 0, 100, 0.0, torch.float32),
    (1, 96, 160, 2, 2, 112, "full", 0, 0, 0.0, torch.float32),
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
PATHS = ["gpt2", "rwkv6-1.6b", "zamba2-1.2b", "tinyllama-1.1b", "paligemma-3b",
         "arctic-480b", "kimi-k2-1t-a32b", "whisper-small"]
STEPS = (3, 2, 2)
# PaliGemma's path runs at per-device batch 2 (global batch 4, then 6):
# at 12 rows its loss over the 257,216-token vocabulary holds about five
# fp32 logits-sized buffers of 12.6 GB at once, and ran out of the card's
# memory at every depth tried, 6 to 18 layers (tools/cut_memory.py).
PATH_PER_DEVICE_BATCH = {"paligemma-3b": 2, "kimi-k2-1t-a32b": 2}
# Whisper's decoder trains on 448 text tokens a row, its published text
# context (n_text_ctx), behind the encoder's 1,500 frames; every other path
# on SEQ tokens.
WHISPER_TEXT = 448
PATH_SEQ = {"whisper-small": WHISPER_TEXT}
# The main paths that run with the caching allocator's expandable segments.
# PaliGemma's allocates state-sized blocks (the scale-out's decoded copy, 23
# GB at 14 layers) after steps whose logits buffers leave fixed segments cut
# up: the decode then ran out of memory with 10-21 GB reserved but
# unallocated (tools/cut_memory.py).
EXPANDABLE_SEGMENTS = ("paligemma-3b",)
# The serving runs (phase 3d), one per served family at full width and
# depth: batch 8, a 1024-token prompt, 128 greedy new tokens (the prefill's
# and 127 decode steps'), and so a cache of 1152 positions.
SERVE_PATHS = ("gpt2", "rwkv6-1.6b", "zamba2-1.2b", "tinyllama-1.1b", "paligemma-3b",
               "arctic-480b", "kimi-k2-1t-a32b", "whisper-small")
SERVE_BATCH, SERVE_PROMPT, SERVE_TOKENS = 8, 1024, 128
SERVE_CACHE = SERVE_PROMPT + SERVE_TOKENS
# Whisper's request: 1,500 frames through the encoder and the cross-KV
# cache, a 4-token prompt (the start-of-transcript sequence) and 224 new
# tokens (its default sample_len), so a self cache of 228 rows.
WHISPER_PROMPT, WHISPER_TOKENS = 4, 224
# The stubbed frontend's frame embeddings, seeded normals scaled as the
# port's training batches scale them (``data.synthetic.stub_inputs``).
FRAME_SCALE = 0.02
# gemma2-27b served at full width on a cut depth: one local (window 4,096)
# and one global layer, batch 2, a 4,608-token prompt (so that the local
# layer's window binds) and 64 new tokens.
GEMMA2_LAYERS = 2
GEMMA2_BATCH, GEMMA2_PROMPT, GEMMA2_TOKENS = 2, 4608, 64
# PaliGemma's image prefix: its 256 patch embeddings, seeded normals scaled
# as the port's training batches scale them, go in front of the text, so
# the training path attends over SEQ + 256 positions and a served request's
# cache holds 256 rows more. Its training path runs at full width on
# PALIGEMMA_LAYERS of its 18 layers (``paligemma_cut``); served, it runs at
# full width and depth.
PATCH_SCALE = 0.02
PALIGEMMA_LAYERS = 14
# Snowflake Arctic (moe) trains and serves at full width (d_model 7,168,
# 56:8 heads at hd 128, experts and the dense residual 4,864 wide, top-2,
# capacity factor 1.25) on a cut of ARCTIC_LAYERS layers of ARCTIC_EXPERTS
# experts (``arctic_cut``). One full layer's 128 experts are 13.4 B params
# (53.5 GB fp32); the port keeps fp32 master weights and adamw8bit's state,
# as JAX does, about 6.03 bytes a param. 2 x 8 is 2.58 B params and a 15.5
# GB state; its train step peaks at 59.7 GB (the fp32 gradients, their
# clipped copy, the updates and the largest leaf's dequantised moments
# beside the state) and its replica tier at 46.7 GB. 3 x 8 (3.64 B params,
# 21.9 GB of state) ran out of the card's memory in its first step's
# optimizer update, at 72.4 GiB allocated (tools/cut_memory.py --arch
# arctic-480b, PERF.md §4); 2 x 16 (4.25 B) is larger still.
ARCTIC_LAYERS = 2
ARCTIC_EXPERTS = 8
# Kimi-K2 1T-A32B (moe) trains at full width (d_model 7,168, 64:8 heads at
# hd 112, 384 experts of width 2,048 top-8 in the full config, one shared
# expert, vocab 163,840 untied, adamw8bit) on a cut of KIMI_LAYERS layers
# of KIMI_EXPERTS experts (``kimi_cut``): more than 8 experts, so that the
# top-8 routing chooses at all. Its embedding and unembedding leaves are
# 4.70 GB each in fp32. It is served on KIMI_SERVE_LAYERS layers of the
# same experts: serving holds only the params and their per-step bf16
# casts. The cut was chosen by ``tools/cut_memory.py --arch
# kimi-k2-1t-a32b`` (PERF.md §4, §6): 1 x 16 (3.21 B params, a 19.4 GB
# state) peaks at 61.8 GB with the leaf-by-leaf train step; 2 x 16 (4.08
# B, 24.6 GB) trains its 7 steps, then runs out of the card's memory at
# 73.7 GiB allocated, before its replica tier (3 x its state).
KIMI_LAYERS = 1
KIMI_EXPERTS = 16
KIMI_SERVE_LAYERS = 2
# The dense configs that fit no card, run reduced (phase 3e): a short
# elastic run with one int8 scale-out and a served request each.
REDUCED_DENSE = ("granite-34b", "llama3-405b")
# The attention kernel's cases at full width for configs the card runs
# only reduced: (name, batch).
FULL_WIDTH_ATTENTION = (("granite-34b", SERVE_BATCH), ("llama3-405b", 1))
# Teacher-forced decode steps after the prefill in the fp32 check.
FP32_DECODE_STEPS = 7
# The decode attention's q_offsets held against the plain version: the
# first rows of the first and second 64-key tiles, the tile edge, the
# middle, the cache's last row.
DECODE_Q_OFFSETS = (0, 1, 63, 64, 511, SERVE_CACHE - 1)
# The decode WKV6's sequence lengths: one step, two, and either side of the
# sequential kernel's 32-step staging (and of the decode regime's last
# step, added where the cases are made).
DECODE_WKV_STEPS = (1, 2, 31, 33)
# The decode SSD's sequence lengths from a carried state: one step, two,
# and either side of the bf16 kernel's 64-row chunk (the rows past S are
# zero-filled; and either side of the decode regime's last step).
DECODE_SSD_STEPS = (1, 2, 63, 65)
# The decode regimes' cases at every (P, N) and head dim: B·H = 15, so the
# SSD regime's last CTA is part-filled at most (P, N).
DECODE_B, DECODE_H = 3, 5
# Step counts at which phase 5 times each decode regime against the
# sequential or chunked kernel, in turns (kernels.ssd/wkv6.DECODE_MAX_STEPS).
DECODE_STEP_SWEEP = (1, 2, 4, 8, 16, 32, 64)


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
    read from the configs (``path_config``), at both global batches:
    ``{kernel: [(path, shape), ...]}`` with attention ``(B, S, H, K, hd,
    kind, prefix_len, softcap, rope_theta or 0)`` (bf16, scale 1/sqrt(hd)
    as every config here; causal, or for a vlm the prefix mask over its
    patches, which S counts), wkv6 ``(B, S, H, hd)`` and ssd ``(B, S, H,
    P, N)``. One forward runs over the global batch, so the batch is the
    cluster's."""
    from repro_torch.models import mamba2

    shapes = {"flash_attention": [], "wkv6": [], "ssd": []}
    for name in PATHS:
        cfg = path_config(name)
        prefix = prefix_rows(cfg)
        for B in path_batches(name):
            # Whisper's encoder, self and cross shapes differ in Sq and
            # Skv: ``whisper_attention_shapes``.
            if cfg.family in ("dense", "hybrid", "vlm", "moe"):
                theta = cfg.rope_theta if cfg.positions == "rope" else 0.0
                shapes["flash_attention"].append((name, (
                    B, SEQ + prefix, cfg.n_heads, cfg.n_kv_heads, cfg.head_dim,
                    "prefix" if prefix else "causal", prefix, cfg.attn_softcap,
                    theta)))
            if cfg.family == "ssm":
                shapes["wkv6"].append((name, (B, SEQ, cfg.n_heads, cfg.head_dim)))
            if cfg.family == "hybrid":
                _, H, P, N = mamba2._dims(cfg)
                shapes["ssd"].append((name, (B, SEQ, H, P, N)))
    return shapes


def gemma2_cut():
    """gemma2-27b at full width on ``GEMMA2_LAYERS`` layers: one local and
    one global (a config chosen here, not an option of the port)."""
    import dataclasses

    from repro_torch.configs import get_config

    return dataclasses.replace(get_config("gemma2-27b"), n_layers=GEMMA2_LAYERS)


def arctic_cut():
    """arctic-480b at full width on ``ARCTIC_LAYERS`` layers of
    ``ARCTIC_EXPERTS`` experts, ``top_k`` kept (a config chosen here, not an
    option of the port)."""
    import dataclasses

    from repro_torch.configs import get_config

    return dataclasses.replace(get_config("arctic-480b"), n_layers=ARCTIC_LAYERS,
                               n_experts=ARCTIC_EXPERTS)


def kimi_cut(n_layers=None):
    """kimi-k2-1t-a32b at full width on ``KIMI_LAYERS`` layers (or
    ``n_layers``) of ``KIMI_EXPERTS`` experts, ``top_k`` 8 and the shared
    expert kept (a config chosen here, not an option of the port)."""
    import dataclasses

    from repro_torch.configs import get_config

    return dataclasses.replace(get_config("kimi-k2-1t-a32b"),
                               n_layers=n_layers or KIMI_LAYERS,
                               n_experts=KIMI_EXPERTS)


def paligemma_cut():
    """paligemma-3b at full width on ``PALIGEMMA_LAYERS`` of its layers, the
    depth its training path fits in the card's memory (a config chosen
    here, not an option of the port)."""
    import dataclasses

    from repro_torch.configs import get_config

    return dataclasses.replace(get_config("paligemma-3b"), n_layers=PALIGEMMA_LAYERS)


@contextlib.contextmanager
def allocator_segments(expandable):
    """The caching allocator with expandable segments for the duration, if
    ``expandable``; its cache emptied before and after, so that each
    setting allocates its own segments. The other phases keep the default
    fixed segments."""
    if not expandable:
        yield
        return
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.memory._set_allocator_settings("expandable_segments:True")
    try:
        yield
    finally:
        gc.collect()
        torch.cuda.empty_cache()
        torch.cuda.memory._set_allocator_settings("expandable_segments:False")


def path_batches(name):
    """The global batches of the main path ``name``: on 2 and on 3 logical
    devices."""
    per_device = PATH_PER_DEVICE_BATCH.get(name, PER_DEVICE_BATCH)
    return (2 * per_device, 3 * per_device)


def path_config(name):
    """The config the main path ``name`` trains: PaliGemma's and Arctic's
    cuts, the full config otherwise."""
    from repro_torch.configs import get_config

    cuts = {"paligemma-3b": paligemma_cut, "arctic-480b": arctic_cut,
            "kimi-k2-1t-a32b": kimi_cut}
    return cuts[name]() if name in cuts else get_config(name)


def path_seq(name):
    """The text tokens a row of the main path ``name`` trains on."""
    return PATH_SEQ.get(name, SEQ)


def serve_config(name):
    """The config the serving run ``name`` serves: Arctic's cut, Kimi's on
    ``KIMI_SERVE_LAYERS`` layers, the full config otherwise (PaliGemma is
    served at full depth)."""
    from repro_torch.configs import get_config

    if name == "arctic-480b":
        return arctic_cut()
    if name == "kimi-k2-1t-a32b":
        return kimi_cut(KIMI_SERVE_LAYERS)
    return get_config(name)


def prefix_rows(cfg):
    """The rows a vlm's patches take in front of its text: in the
    attention, in the KV cache; 0 for the other families."""
    return cfg.n_patches if cfg.family == "vlm" else 0


def patches_for(cfg, n_rows, rng):
    """A vlm's patch embeddings for ``n_rows`` batch rows, (n_rows,
    n_patches, d_model) fp32 on the host from the numpy generator ``rng``:
    normals x ``PATCH_SCALE``; None for the other families."""
    if cfg.family != "vlm":
        return None
    return (rng.standard_normal((n_rows, cfg.n_patches, cfg.d_model), dtype=np.float32)
            * np.float32(PATCH_SCALE))


def frames_for(cfg, n_rows, rng):
    """An encdec model's frame embeddings for ``n_rows`` batch rows,
    (n_rows, enc_len, d_model) fp32 on the host from the numpy generator
    ``rng``: normals x ``FRAME_SCALE``; None for the other families."""
    if cfg.family != "encdec":
        return None
    return (rng.standard_normal((n_rows, cfg.enc_len, cfg.d_model), dtype=np.float32)
            * np.float32(FRAME_SCALE))


def stub_for(cfg, n_rows, rng):
    """The stubbed encoder inputs of ``n_rows`` batch rows, as keyword
    arguments of ``launch.serve.generate``: a vlm's ``patches``
    (``patches_for``), an encdec model's ``frames`` (``frames_for``), on
    the host; none for the other families."""
    if cfg.family == "vlm":
        return {"patches": patches_for(cfg, n_rows, rng)}
    if cfg.family == "encdec":
        return {"frames": frames_for(cfg, n_rows, rng)}
    return {}


def stub_kwargs(cfg, patches=None, frames=None):
    """The forward's keyword arguments for the stubbed inputs: a vlm's
    ``patch_embeds``, an encdec model's ``frames``."""
    if cfg.family == "vlm":
        return {"patch_embeds": patches}
    if cfg.family == "encdec":
        return {"frames": frames}
    return {}


def path_batch(cfg, toks, rng):
    """One step's global batch: the tokens and, for a vlm or an encdec
    model, one row of patches or frames per token row (``stub_for``)."""
    return {"tokens": toks, **stub_for(cfg, len(toks), rng)}


def serve_runs():
    """``(label, cfg, batch, prompt, new tokens)`` of each serving run
    (phase 3d): ``SERVE_PATHS`` at full width and depth (Arctic and Kimi
    on their cuts; Whisper's request its own), then gemma2's cut."""
    def request(name):
        if name == "whisper-small":
            return WHISPER_PROMPT, WHISPER_TOKENS
        return SERVE_PROMPT, SERVE_TOKENS

    return ([(name, serve_config(name), SERVE_BATCH, *request(name))
             for name in SERVE_PATHS]
            + [(f"gemma2-27b, {GEMMA2_LAYERS} layers", gemma2_cut(), GEMMA2_BATCH,
                GEMMA2_PROMPT, GEMMA2_TOKENS)])


def decode_q_offsets(cfg, cache_len, extra=()):
    """``DECODE_Q_OFFSETS``, ``extra``, and for a longer cache its last row;
    with a window, the rows either side of where it starts to bind."""
    offsets = set(DECODE_Q_OFFSETS) | set(extra) | {cache_len - 1}
    if cfg.sliding_window:
        offsets |= {cfg.sliding_window - 1, cfg.sliding_window}
    return sorted(o for o in offsets if o < cache_len)


def layer_kinds(cfg):
    """``(label, window)`` of each kind of attention layer of ``cfg``:
    gemma2's local (window) and global (none) layers, or one kind."""
    if cfg.alt_local_global and cfg.sliding_window:
        return [(" local", cfg.sliding_window), (" global", 0)]
    return [("", cfg.sliding_window)]


def serve_attention_cases():
    """``(label, case, rope_theta, q_offset, scale)`` at the shapes the
    serving runs give the kernel, for each with attention (GPT-2, TinyLlama,
    PaliGemma, gemma2's cut, each kind of its layers; Zamba2, whose queries
    and keys go through RoPE), and at full width for the dense configs the
    card runs only reduced (``FULL_WIDTH_ATTENTION``): the prefill of the
    prompt into the cache (its last rows masked; PaliGemma's patches and
    prompt under the prefix mask), the decode over the whole cache at each
    of ``decode_q_offsets`` (PaliGemma's also either side of the prefix's
    end and at the prompt's last row), and for GPT-2 over a ragged Skv of
    1000, bf16 as the runs give them; scale ``query_scale`` where the
    config sets one (None: 1/sqrt(hd))."""
    from repro_torch.configs import get_config

    runs = [(label, cfg, B, P, P + n) for label, cfg, B, P, n in serve_runs()]
    runs += [(name, get_config(name), B, SERVE_PROMPT, SERVE_CACHE)
             for name, B in FULL_WIDTH_ATTENTION]
    cases = []
    for label, cfg, B, P, cache_len in runs:
        if cfg.family == "encdec":
            cases += whisper_serve_cases(label, cfg, B, P, cache_len)
        if cfg.family not in ("dense", "hybrid", "vlm", "moe"):
            continue
        H, K, hd = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
        theta = cfg.rope_theta if cfg.positions == "rope" else 0.0
        pre = prefix_rows(cfg)
        extra = (pre - 1, pre, pre + P - 1) if pre else ()
        for kind, window in layer_kinds(cfg):
            def case(Sq, Skv, prefix=0):
                return (B, Sq, Skv, H, K, hd, "prefix" if prefix else "causal",
                        window, prefix, cfg.attn_softcap, torch.bfloat16)

            name = f"{label}{kind}"
            cases += ([(f"{name} serve prefill", case(pre + P, pre + cache_len, pre),
                        theta, 0, cfg.query_scale)]
                      + [(f"{name} serve decode q_offset={o}",
                          case(1, pre + cache_len), theta, o, cfg.query_scale)
                         for o in decode_q_offsets(cfg, pre + cache_len, extra)])
        if label == "gpt2":
            cases.append((f"{label} serve decode ragged Skv", case(1, 1000), theta,
                          999, None))
    return cases


def whisper_attention_shapes(cfg, B, text):
    """``(label, case)`` of Whisper's attention at batch ``B`` and ``text``
    decoder tokens, bf16 as the model runs it: the encoder's full
    attention over ``enc_len`` frames (1,500: no multiple of the kernel's
    tiles), the decoder's causal self-attention, and its full
    cross-attention from the text over the frames (Sq != Skv)."""
    H, K, hd, T = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim, cfg.enc_len

    def case(Sq, Skv, kind):
        return (B, Sq, Skv, H, K, hd, kind, 0, 0, 0.0, torch.bfloat16)

    return [("encoder", case(T, T, "full")), ("self", case(text, text, "causal")),
            ("cross", case(text, T, "full"))]


def whisper_serve_cases(label, cfg, B, P, cache_len):
    """``(label, case, rope_theta, q_offset, scale)`` of a Whisper request:
    the prefill's encoder over the frames, its self-attention of the
    prompt into the self cache of ``cache_len`` rows and its
    cross-attention over the cross cache, then the decode's
    self-attention at each of ``decode_q_offsets`` and its cross-attention
    (one query row over the frames, q_offset 0 as the model calls it)."""
    H, K, hd, T = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim, cfg.enc_len

    def case(Sq, Skv, kind):
        return (B, Sq, Skv, H, K, hd, kind, 0, 0, 0.0, torch.bfloat16)

    return ([(f"{label} serve encoder", case(T, T, "full"), 0.0, 0, None),
             (f"{label} serve prefill self", case(P, cache_len, "causal"), 0.0, 0,
              None),
             (f"{label} serve prefill cross", case(P, T, "full"), 0.0, 0, None),
             (f"{label} serve decode cross", case(1, T, "full"), 0.0, 0, None)]
            + [(f"{label} serve decode self q_offset={o}", case(1, cache_len, "causal"),
                0.0, o, None) for o in decode_q_offsets(cfg, cache_len, (P,))])


def attention_cases():
    """``(label, case, rope_theta, q_offset, scale)``: the main paths'
    shapes, the serving runs', then the JAX sweep, the fp32 cases at head
    dim 256 (one a decode row at q_offset 250 over a cache of 330) and the
    bf16 edges; ``case`` in ATTN_SWEEP's layout, ``scale`` None for
    1/sqrt(hd)."""
    cases = [(f"{path} B={B}", (B, S, S, H, K, hd, kind, 0, prefix, softcap,
                                torch.bfloat16), theta, 0, None)
             for path, (B, S, H, K, hd, kind, prefix, softcap, theta)
             in main_shapes()["flash_attention"]]
    for name in PATHS:
        cfg = path_config(name)
        if cfg.family == "encdec":
            cases += [(f"{name} B={B} {part}", case, 0.0, 0, None)
                      for B in path_batches(name)
                      for part, case in whisper_attention_shapes(cfg, B, path_seq(name))]
    return (cases + serve_attention_cases()
            + [(f"sweep {i}", c, 0.0, 0, None) for i, c in enumerate(ATTN_SWEEP)]
            + [(f"sweep hd256 {i}", c, 0.0, 0, None) for i, c in enumerate(ATTN_HD256)]
            + [("sweep hd256 decode", (2, 1, 330, 8, 1, 256, "causal", 0, 0, 0.0,
                                       torch.float32), 1e4, 250, None)]
            + [(f"sweep hd112 {i}", c, 0.0, 0, None) for i, c in enumerate(ATTN_HD112)]
            + [("sweep hd112 decode", (2, 1, 1152, 64, 8, 112, "causal", 0, 0, 0.0,
                                       torch.float32), 1e4, o, None)
               for o in DECODE_Q_OFFSETS]
            + [(f"sweep bf16 {i}", c, 0.0, 0, None)
               for i, c in enumerate(ATTN_BF16_EDGES)])


def attention_inputs(gen, case, theta=0.0, q_offset=0):
    """q, k, v of ``case`` on the card; q and k go through RoPE first where
    ``theta`` is given, as in a RoPE config's attention, the queries at
    ``q_offset`` onwards. Every key row holds data, so the rows the mask
    removes are random, not zero."""
    from repro_torch.models.layers import rope

    B, Sq, Skv, H, K, d, kind, window, prefix, softcap, dt = case
    q = torch.randn((B, Sq, H, d), generator=gen, device="cuda").to(dt)
    k = torch.randn((B, Skv, K, d), generator=gen, device="cuda").to(dt)
    v = torch.randn((B, Skv, K, d), generator=gen, device="cuda").to(dt)
    if theta:
        q = rope(q, q_offset + torch.arange(Sq, device="cuda"), theta)
        k = rope(k, torch.arange(Skv, device="cuda"), theta)
    return q, k, v


def attention_case(fa, gen, case, theta=0.0, q_offset=0, scale=None):
    """The kernel against ``attention_plain`` at ``_tol`` on one case
    (``attention_inputs``); ``scale`` None is 1/sqrt(hd). Returns
    max |kernel - plain|."""
    from repro_torch.models.layers import MaskSpec

    B, Sq, Skv, H, K, d, kind, window, prefix, softcap, dt = case
    scale = d ** -0.5 if scale is None else scale
    q, k, v = attention_inputs(gen, case, theta, q_offset)
    out = fa.flash_attention_kernel(q, k, v, scale=scale, softcap=softcap,
                                    kind=kind, window=window, prefix_len=prefix,
                                    q_offset=q_offset)
    ref = fa.attention_plain(q, k, v, MaskSpec(kind, window=window,
                                               prefix_len=prefix),
                             scale=scale, softcap=softcap, q_offset=q_offset)
    torch.testing.assert_close(out.float(), ref.float(), **tol(dt))
    return float((out.float() - ref.float()).abs().max())


def check_attention(fa, gen):
    """Every case of ``attention_cases``; returns the largest error at the
    main paths' shapes. Each line names the kernel the case took
    (``fa.regime``: decode, wgmma or fma) and, in the decode regime, its
    split count."""
    main_err = 0.0
    regimes = collections.Counter()
    for label, case, theta, q_offset, scale in attention_cases():
        err = attention_case(fa, gen, case, theta, q_offset, scale)
        B, Sq, Skv, H, K, d, kind, window, prefix, softcap, dt = case
        regime = fa.regime(dt, Sq, H, K)
        regimes[regime] += 1
        if not label.startswith("sweep"):
            main_err = max(main_err, err)
            extras = "".join(f", {name} {value}" for name, value in (
                ("window", window), ("prefix", prefix), ("softcap", softcap),
                ("scale", scale), ("RoPE", theta)) if value)
            if regime == "decode":
                plan = fa.decode_split_plan(B, Sq, Skv, K, kind, window, prefix, q_offset)
                regime += f" n_split {plan.n_split}"
            log(f"attention {label} {case[:6]} bf16 {kind}{extras}, q_offset "
                f"{q_offset} [{regime}]: max |kernel - plain| {err:.3e} "
                f"(rtol/atol 2e-2)")
        torch.cuda.empty_cache()
    log(f"attention: {len(ATTN_SWEEP)} sweep cases, {len(ATTN_HD256) + 1} fp32 "
        f"cases at hd 256, {len(ATTN_HD112) + len(DECODE_Q_OFFSETS)} at hd 112 "
        f"and {len(ATTN_BF16_EDGES)} bf16 edges within _tol; cases by kernel: "
        f"{dict(sorted(regimes.items()))}")
    return main_err


#: The backward's gradients against fp32 autograd of the plain version, as
#: the error's norm over the gradient's: bf16 operands and outputs, fp32
#: sums (measured 0.0023-0.0025 at GPT-2's and Whisper's shapes).
BWD_REL_TOL = 1e-2
#: The benchmark's GPT-2 layer: 3 members of batch 4, 1,024 tokens.
GPT2_BWD_CASE = (12, SEQ, SEQ, 12, 12, 64, "causal", 0, 0, 0.0, torch.bfloat16)


def attention_bwd_cases(paths=True):
    """``(label, case, rope_theta)`` of the backward: the benchmark's GPT-2
    layer, Whisper's encoder, decoder and cross-attention at the serving
    batch of 8, and (``paths``) each main path's bf16 training shape whose
    head dim the backward kernels take (``backward_regime``)."""
    from repro_torch.kernels import flash_attention as fa

    cfg = path_config("whisper-small")
    cases = [("gpt2 benchmark", GPT2_BWD_CASE, 0.0)]
    cases += [(f"whisper-small B={SERVE_BATCH} {part}", case, 0.0) for part, case
              in whisper_attention_shapes(cfg, SERVE_BATCH, path_seq("whisper-small"))]
    if not paths:
        return cases
    for path, (B, S, H, K, hd, kind, prefix, softcap, theta) in main_shapes()[
            "flash_attention"]:
        if fa.backward_regime(torch.bfloat16, hd) == "wgmma":
            cases.append((f"{path} B={B}", (B, S, S, H, K, hd, kind, 0, prefix, softcap,
                                            torch.bfloat16), theta))
    return cases


def attention_bwd_inputs(fa, gen, case, theta=0.0):
    """q, k, v (``attention_inputs``), the gradient of the output dO, the
    forward's output and its rows' log-sum-exp, as a training call keeps
    them for the backward."""
    B, Sq, Skv, H, K, d, kind, window, prefix, softcap, dt = case
    q, k, v = attention_inputs(gen, case, theta)
    do = torch.randn((B, Sq, H, d), generator=gen, device="cuda").to(dt)
    lse = torch.empty((B, H, Sq), dtype=torch.float32, device="cuda")
    with fa.writing_lse(lse):
        o = fa.flash_attention_kernel(q, k, v, scale=d ** -0.5, softcap=softcap,
                                      kind=kind, window=window, prefix_len=prefix)
    return q, k, v, do, o, lse


def attention_plain_grads(fa, q, k, v, do, case, dtype=None):
    """dq, dk, dv of ``attention_plain`` by autograd, on q, k and v cast to
    ``dtype`` (as they are when None: the plain backward the program runs
    for other calls)."""
    from repro_torch.models.layers import MaskSpec

    B, Sq, Skv, H, K, d, kind, window, prefix, softcap, dt = case
    live = [t.detach().to(dtype or t.dtype).requires_grad_(True) for t in (q, k, v)]
    with torch.enable_grad():
        out = fa.attention_plain(*live, MaskSpec(kind, window=window, prefix_len=prefix),
                                 scale=d ** -0.5, softcap=softcap)
        return torch.autograd.grad(out, live, do.to(out.dtype))


def attention_bwd_case(fa, gen, case, theta=0.0):
    """The backward kernels' dq, dk and dv against fp32 autograd of
    ``attention_plain`` on the same bf16 values, each within
    ``BWD_REL_TOL`` of the gradient's norm. Returns (max |kernel - plain|,
    the largest relative error)."""
    B, Sq, Skv, H, K, d, kind, window, prefix, softcap, dt = case
    q, k, v, do, o, lse = attention_bwd_inputs(fa, gen, case, theta)
    got = fa.flash_attention_bwd_kernel(q, k, v, o, lse, do, scale=d ** -0.5,
                                        softcap=softcap, kind=kind, window=window,
                                        prefix_len=prefix)
    want = attention_plain_grads(fa, q, k, v, do, case, torch.float32)
    abs_err = rel_err = 0.0
    for name, g, w in zip(("dq", "dk", "dv"), got, want):
        if g.shape != w.shape or g.dtype != dt or not bool(torch.isfinite(g).all()):
            raise AssertionError(f"attention backward {case[:7]}: {name} "
                                 f"{tuple(g.shape)} {g.dtype}, not finite or misshapen")
        rel = float((g.float() - w).norm() / w.norm())
        if not rel <= BWD_REL_TOL:
            raise AssertionError(f"attention backward {case[:7]}: {name} off the fp32 "
                                 f"autograd by {rel:.3e} of its norm (> {BWD_REL_TOL})")
        abs_err = max(abs_err, float((g.float() - w).abs().max()))
        rel_err = max(rel_err, rel)
    return abs_err, rel_err


def check_attention_bwd(fa, gen):
    """Every case of ``attention_bwd_cases``; returns the largest
    max |kernel - plain| over them."""
    main_err = 0.0
    for label, case, theta in attention_bwd_cases():
        abs_err, rel_err = attention_bwd_case(fa, gen, case, theta)
        main_err = max(main_err, abs_err)
        B, Sq, Skv, H, K, d, kind, window, prefix, softcap, dt = case
        extras = "".join(f", {name} {value}" for name, value in (
            ("prefix", prefix), ("softcap", softcap), ("RoPE", theta)) if value)
        log(f"attention backward {label} {case[:6]} bf16 {kind}{extras}: dq, dk, dv "
            f"within {rel_err:.3e} of the fp32 autograd's norm (<= {BWD_REL_TOL}), "
            f"max |kernel - plain| {abs_err:.3e}")
        torch.cuda.empty_cache()
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


def ssd_inputs(gen, B, S, H, P, N, dtype, state=False, strided=False):
    """x, Bm, Cm in ``dtype``; dt = softplus(normal) + 0.01 and A_log in
    [-1, 1.5), as the JAX sweep draws them; state. With ``strided``, x, Bm
    and Cm are views of one (B, S, H·P + 2N) tensor, as
    ``mamba2.block_apply`` splits them."""
    if strided:
        xbc = torch.randn((B, S, H * P + 2 * N), generator=gen, device="cuda").to(dtype)
        x, Bm, Cm = torch.split(xbc, [H * P, N, N], dim=-1)
        x = x.reshape(B, S, H, P)
    else:
        x = torch.randn((B, S, H, P), generator=gen, device="cuda").to(dtype)
    dt = torch.nn.functional.softplus(
        torch.randn((B, S, H), generator=gen, device="cuda")) + 0.01
    A_log = torch.rand((H,), generator=gen, device="cuda") * 2.5 - 1.0
    if not strided:
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

    Then the RWKV-6 serving run's decode, batch 8 at each of
    ``DECODE_WKV_STEPS`` steps and either side of the decode regime's last
    step from a nonzero state (fp32, as the run gives them), with the
    init's decays against the plain version and with decays over the clip
    range against it and the fp64 oracle; the decode regime at every head
    dim, fp32 and bf16, one step over the clip range; and the JAX sweep
    with initial states, at chunk 64."""
    from repro_torch.configs import get_config
    from repro_torch.kernels import wkv6 as W

    f32, bf16 = torch.float32, torch.bfloat16
    cases = []
    for path, shape in main_shapes()["wkv6"]:
        label = f"{path} B={shape[0]}"
        cases += [(label, (*shape, "init", f32, False, 64, False)),
                  (label, (*shape, (-8.0, 3.0), f32, False, 16, True)),
                  (label, (*shape, (-8.0, 3.0), bf16, False, 64, False))]
    cfg = get_config("rwkv6-1.6b")
    for S in sorted({*DECODE_WKV_STEPS, W.DECODE_MAX_STEPS, W.DECODE_MAX_STEPS + 1}):
        shape = (SERVE_BATCH, S, cfg.n_heads, cfg.head_dim)
        label = f"rwkv6-1.6b serve decode S={S}"
        cases += [(label, (*shape, "init", f32, True, 64, False)),
                  (label, (*shape, (-8.0, 3.0), f32, True, 16, True))]
    for hd in W.HEAD_DIMS:
        for dt in (f32, bf16):
            cases.append((f"decode regime hd={hd}",
                          (DECODE_B, 1, DECODE_H, hd, (-8.0, 3.0), dt, True, 16,
                           dt == f32)))
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
            B, S, H, hd, decay, dt, with_state, chunk, _ = case
            log(f"wkv6 {label} {(B, S, H, hd)} {str(dt)[6:]} r/k/v, decays "
                f"{decay}{', from a state' if with_state else ''} "
                f"({W.regime(dt, S)}): max |kernel - plain (chunk {chunk})| "
                f"{err:.3e}")
    torch.cuda.synchronize()
    log(f"wkv6: {len(WKV_SWEEP)} sweep cases within _rec_tol")
    return main_err


def ssd_cases():
    """``(label, case)``, case ``(B, S, H, P, N, dtype, with_state,
    strided)``: the Zamba2 path's shapes (bf16 x/B/C, as the path gives
    them); the Zamba2 serving run's prefill (batch 8, the prompt, from a
    state) and decode, batch 8 at each of ``DECODE_SSD_STEPS`` from a
    nonzero state, x/B/C as the views ``block_apply`` passes; the decode
    regime at every (P, N) in both dtypes on such views, at a B·H that
    leaves the last CTA part-filled at most (P, N); then the JAX sweep and
    the bf16 edges with initial states."""
    from repro_torch.configs import get_config
    from repro_torch.kernels import ssd as SD
    from repro_torch.models import mamba2

    f32, bf16 = torch.float32, torch.bfloat16
    cases = [(f"{path} B={shape[0]}", (*shape, bf16, False, False))
             for path, shape in main_shapes()["ssd"]]
    _, H, P, N = mamba2._dims(get_config("zamba2-1.2b"))
    cases.append(("zamba2-1.2b serve prefill",
                  (SERVE_BATCH, SERVE_PROMPT, H, P, N, bf16, True, True)))
    cases += [(f"zamba2-1.2b serve decode S={S}",
               (SERVE_BATCH, S, H, P, N, bf16, True, True))
              for S in sorted({*DECODE_SSD_STEPS, SD.DECODE_MAX_STEPS,
                               SD.DECODE_MAX_STEPS + 1})]
    cases += [(f"decode regime P={P} N={N}", (DECODE_B, 1, DECODE_H, P, N, dt, True, True))
              for P in SD.HEAD_DIMS for N in SD.STATE_DIMS for dt in (f32, bf16)]
    return (cases + [(f"sweep {i}", (*c, True, False)) for i, c in enumerate(SSD_SWEEP)]
            + [(f"sweep bf16 {i}", (*c, True, False))
               for i, c in enumerate(SSD_BF16_EDGES)])


def ssd_case(SD, gen, case):
    """The kernel against ``ssd_plain`` (chunk 64), y and final state, at
    ``_rec_tol`` on one case of ``ssd_cases``. Returns max |kernel - plain|
    of y."""
    B, S, H, P, N, dt, with_state, strided = case
    args = ssd_inputs(gen, B, S, H, P, N, dt, state=with_state, strided=strided)
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
            log(f"ssd {label} {case[:4]} N={case[4]} {str(case[5])[6:]}"
                f"{', from a state' if case[6] else ''}"
                f"{', strided views' if case[7] else ''} ({SD.regime(case[5], case[1])}): "
                f"max |kernel - plain| {err:.3e}")
    torch.cuda.synchronize()
    log(f"ssd: {len(SSD_SWEEP)} sweep cases and {len(SSD_BF16_EDGES)} bf16 "
        f"edges within _rec_tol")
    return main_err


def check_q8(gen):
    """adamw8bit's block quantizer on the card: ``_q8`` and ``_dq8_static``
    on a TinyLlama-sized leaf (its 32,000 x 2,048 embedding, magnitudes
    spread over 14 octaves from row to row as moments spread) give codes,
    scales and dequantized values bit for bit as the same calls on the
    CPU. Returns 0.0, the largest difference."""
    import importlib

    from repro_torch.configs import get_config

    adamw = importlib.import_module("repro_torch.optim.adamw")
    cfg = get_config("tinyllama-1.1b")
    shape = (cfg.vocab, cfg.d_model)
    spread = torch.exp(torch.rand((shape[0], 1), generator=gen, device="cuda")
                       * -14.0 * math.log(2.0))
    x = torch.randn(shape, generator=gen, device="cuda") * spread
    codes, scale = adamw._q8(x)
    host_codes, host_scale = adamw._q8(x.cpu())
    back = adamw._dq8_static(codes, scale, shape)
    host_back = adamw._dq8_static(host_codes, host_scale, shape)
    if not (torch.equal(codes.cpu(), host_codes)
            and torch.equal(_bytes(scale.cpu()), _bytes(host_scale))
            and torch.equal(_bytes(back.cpu()), _bytes(host_back))):
        raise AssertionError("adamw8bit _q8/_dq8_static on the card differ from the CPU")
    log(f"adamw8bit: _q8 and _dq8_static on {shape} fp32 (block "
        f"{adamw._block_of(shape[-1])}) bit-identical to the CPU: "
        f"{codes.numel()} codes, {scale.numel()} scales")
    return 0.0


# ---------------------------------------------------------------------------
# Phase 3: the main paths.
# ---------------------------------------------------------------------------


def _bytes(t):
    return t.reshape(-1).view(torch.uint8)


def expected_launches(cfg, n_coded_leaves, steps=sum(STEPS), scale_outs=1,
                      serving=False):
    """The launches of a run of ``steps`` steps and ``scale_outs`` int8
    scale-outs, kernel by kernel: per step, each layer's kernel once in the
    forward and once more in its remat recompute; each attention call's
    backward once, where the backward kernels take the training path's bf16
    at the config's head dim (the other backwards differentiate the plain
    versions and launch nothing); Zamba2's shared attention block, applied
    outside the remat, once per application; in each scale-out, the encode
    once for all fp32 leaves together and the decode once for all of them.
    ``serving``: the steps are one request's forwards (its prefill and
    decode steps), which run an encoder once and no backward."""
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import ops
    from repro_torch.models import zamba2

    per_layer = steps * cfg.n_layers * (2 if cfg.remat else 1)
    n = dict.fromkeys(ops.launches, 0)
    n["shard_encode"] = scale_outs if n_coded_leaves else 0
    n["shard_decode"] = scale_outs if n_coded_leaves else 0
    calls = 0  # attention calls a step, each once: the backwards
    if cfg.family in ("dense", "vlm", "moe"):
        n["flash_attention"] = per_layer
        calls = cfg.n_layers
    elif cfg.family == "encdec":
        # Each decoder layer's self- and cross-attention, each encoder
        # layer's attention; a served request runs the encoder once, in
        # its prefill.
        encodes = 1 if serving else steps
        n["flash_attention"] = 2 * per_layer + encodes * cfg.enc_layers * (
            2 if cfg.remat else 1)
        calls = 2 * cfg.n_layers + cfg.enc_layers
    elif cfg.family == "ssm":
        n["wkv6"] = per_layer
    elif cfg.family == "hybrid":
        n["ssd"] = per_layer
        n["flash_attention"] = steps * zamba2.n_shared_apps(cfg)
        calls = zamba2.n_shared_apps(cfg)
    else:
        raise ValueError(f"no main path for family {cfg.family!r}")
    if not serving and fa.backward_regime(torch.bfloat16, cfg.head_dim) == "wgmma":
        n["flash_attention_bwd"] = steps * calls
    return n


def main_path(ops, name):
    """One family's main path. Returns (trainer, launches)."""
    from repro_torch import tree as T
    from repro_torch.configs import get_config
    from repro_torch.core.replication import build_manifest
    from repro_torch.data import ShardedLoader, TokenStream
    from repro_torch.elastic import ElasticTrainer
    from repro_torch.kernels import shard_codec as codec_module
    from repro_torch.models import build_model

    cfg = path_config(name)
    model = build_model(cfg)
    per_device = PATH_PER_DEVICE_BATCH.get(name, PER_DEVICE_BATCH)
    seq = path_seq(name)
    loader = ShardedLoader(TokenStream(cfg.vocab, seq, seed=0), 4096, [0],
                           per_device)
    stub_rng = np.random.default_rng(0)

    def batch_of(toks):
        return path_batch(cfg, toks, stub_rng)

    trainer = ElasticTrainer(model, initial=2,
                             per_device_batch=per_device,
                             link_model=link_model, codec="int8",
                             on_reshard=loader.reshard)
    trainer.init()
    n_params = sum(p.numel() for p in T.leaves(trainer.state["params"]))
    manifest = build_manifest(trainer.state)
    depth = ("full width and depth" if cfg.n_layers == get_config(name).n_layers
             else f"full width, {cfg.n_layers} of {get_config(name).n_layers} layers")
    stub = {"vlm": f" and {cfg.n_patches} patch embeddings in front",
            "encdec": f" behind {cfg.enc_layers} encoder layers over "
                      f"{cfg.enc_len} frame embeddings"}.get(cfg.family, "")
    log(f"path {name}: {depth} ({cfg.n_layers} layers, d_model "
        f"{cfg.d_model}, {n_params} params; state {manifest.total_bytes} "
        f"bytes in {len(manifest.entries)} leaves), seq {seq}{stub}, "
        f"per-device batch {per_device}, int8 codec")
    losses, aux_losses, drops = [], [], []

    def steps(n):
        for _ in range(n):
            toks = np.concatenate([loader.next_batch(i)
                                   for i in trainer.device_ids()])
            # An MoE path's first step counts each MoE call's dropped pairs.
            count = cfg.is_moe and not drops
            with moe_drops(len(toks)) if count else contextlib.nullcontext() as seen:
                m = trainer.step(batch_of(toks))
            losses.append(m["loss"])
            aux_losses.append(m["aux_loss"])
            aux = f" aux_loss {m['aux_loss']:.6f}" if cfg.is_moe else ""
            log(f"  step {trainer.step_count} on {len(trainer.active)} "
                f"devices: loss {m['loss']:.4f} grad_norm {m['grad_norm']:.4f}{aux}")
            if count:
                from repro_torch.models import moe

                drops.extend(dropped_pairs(seen))
                C = moe._capacity(len(toks) * seq, cfg)
                log(f"  dropped (token, choice) pairs of each MoE call of that "
                    f"step (the forward's {cfg.n_layers} layers, then the remat "
                    f"recompute's): {drops}, of {len(toks) * seq * cfg.top_k} "
                    f"pairs a call; capacity {C} for each of {cfg.n_experts} experts")

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
    spans.drain()
    spans.enable()
    try:
        ev_out = trainer.scale_out()
    finally:
        spans.disable()
    phases = [r for r in spans.drain() if r.name.startswith("repro_torch.scale_out")]
    peak_scale_out = torch.cuda.max_memory_allocated()
    unchanged = all(torch.equal(_bytes(b.to(leaf.device)), _bytes(leaf))
                    for b, leaf in zip(before, T.leaves(trainer.state)))
    del before
    # The scale-out's codes and decoded copy go back to the device, so that
    # the larger global batch's steps find room for their large blocks
    # (PaliGemma's fp32 logits are 12.6 GB at batch 12).
    torch.cuda.empty_cache()
    steps(STEPS[1])
    ev_in = trainer.scale_in()
    steps(STEPS[2])
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = dict(ops.launches)
    peak = max(peak_train, peak_scale_out, torch.cuda.max_memory_allocated())

    if not unchanged:
        raise AssertionError(f"{name}: scale-out changed the training state")
    if not all(math.isfinite(x) for x in losses + aux_losses):
        raise AssertionError(f"{name}: non-finite loss: {losses}, aux {aux_losses}")
    if launches != expected:
        raise AssertionError(f"{name}: launches {launches}, expected {expected}")
    check_encode_many(codec_module, [leaf for leaf in T.leaves(trainer.state)
                                      if leaf.dtype == torch.float32
                                      and leaf.numel()])
    log(f"{name}: the many-leaf encode of the full state is bit-identical to "
        f"the per-leaf plain encode")
    breakdown = scale_out_breakdown(phases, trainer, codec_module)
    log(f"{name} scale-out phases from the trainer's own spans, host ms, no "
        f"sync of their own: {json.dumps(breakdown)} (the trainer's scale-out "
        f"{ev_out.wall_s * 1e3:.1f} ms); the decoded state bit-identical to "
        f"the per-leaf plain decode")
    codec = ev_out.plan_summary["codec"]
    summary = {
        "path": name,
        "n_layers": cfg.n_layers,
        "n_params": n_params,
        "state_bytes": manifest.total_bytes,
        "losses": losses,
        "aux_losses": aux_losses,
        "moe_dropped_pairs_first_step": drops,
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
    profile_step(trainer, loader, batch_of)
    return trainer, launches


def scale_out_breakdown(records, trainer, codec):
    """The phases of one scale-out from the trainer's own spans
    (``records``: its ``repro_torch.scale_out`` records), host ms by phase
    (``plan``, ``encode``, ``decode``, ``check``, ``layout``) and in all
    (``scale_out``). The spans make no sync of their own, so a phase's
    device work lands in the next phase that waits for it (the check's
    first sync). Fails unless the int8 encode and decode of the trainer's
    state, run again, decode every int8 leaf bit-identical to its per-leaf
    plain decode."""
    from repro_torch import tree as T
    from repro_torch.core import replication as rep

    ms = {r.name.removeprefix("repro_torch.scale_out").lstrip(".") or "scale_out":
          r.seconds * 1e3 for r in records}
    enc, manifest, _ = rep.encode_state(trainer.state, "int8")
    dec = rep.decode_state(enc, manifest)
    for e, d in zip(enc, T.leaves(dec)):
        if e.kind == "int8" and not torch.equal(
                d.reshape(-1), codec.shard_decode_plain(e.codes, e.scales, d.numel())):
            raise AssertionError("decode_state differs from the per-leaf plain decode")
    return ms


# ---------------------------------------------------------------------------
# Phase 3b: self-healing — the recovery tiers and a churn-trace replay.
# ---------------------------------------------------------------------------

#: The ledger actions of the self-healing replay (events 1-6, then event 7,
#: under the adaptive recovery policy with reshard "auto" and GPT-2's state
#: sizes); tests/test_torch_churn.py replays the trace on the CPU to the
#: same list.
SELF_HEALING_ACTIONS = [
    "ckpt-saved",  # 1 checkpoint: both tiers
    "scale-out", "recovery-decided",  # 2 join (int8), then the layout:
    "reshard-started", "reshard-ready",  # (3, 1) -> (1, 3)
    "link-degraded",  # 3 (0, 2) at 50 Mbit/s
    "scale-out", "recovery-decided",  # 4 join (int8), (1, 3) -> (1, 4)
    "reshard-started", "reshard-ready",
    "node-failed", "recovery-decided",  # 5 node 3 fails; at dp 1 no full
    "parked-degraded",  # replica survives, so the policy parks;
    "recovery-decided", "reshard-started", "reshard-ready",  # (1, 4) -> (1, 3)
    "ckpt-saved",  # 6 checkpoint: both tiers
    "scaled-in", "recovery-decided",  # 7 node 2 leaves, (2, 1) -> (1, 2)
    "reshard-started", "reshard-ready",
]


def self_healing_trace():
    """The churn trace of the self-healing phase: a checkpoint, an int8
    join, a degraded link, a second int8 join, that node's failure, a
    second checkpoint and a leave."""
    from repro_torch.core.engine import ChurnEvent

    return [ChurnEvent(1.0, "checkpoint"),
            ChurnEvent(2.0, "join", node=2, codec="int8"),
            ChurnEvent(3.0, "link-degrade", u=0, v=2, bandwidth_mbps=50.0),
            ChurnEvent(4.0, "join", node=3, codec="int8"),
            ChurnEvent(5.0, "node-failure", node=3),
            ChurnEvent(6.0, "checkpoint"),
            ChurnEvent(7.0, "leave", node=2)]


def link_model(device_id):
    """Heterogeneous links, as in examples/elastic_training.py."""
    from repro_torch.core.sharding_alg import NeighborLink

    fast = device_id % 2 == 0
    return NeighborLink(prop_s=0.002 if fast else 0.01,
                        trans_s_per_byte=(1 / (500e6 / 8) if fast
                                          else 1 / (120e6 / 8)),
                        sync_s=0.0)


def timed_tiers():
    """A ``MemoryReplicaStore`` whose ``push`` and an ``AsyncCheckpointer``
    whose ``save`` (the blocking copy to the host) record their host-clock
    seconds, each closed by a sync, in ``times``."""
    from repro_torch.checkpoint import AsyncCheckpointer, MemoryReplicaStore

    times = {"push": [], "snapshot": []}

    def timing(key, fn, *args):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fn(*args)
        torch.cuda.synchronize()
        times[key].append(time.perf_counter() - t0)
        return out

    class Store(MemoryReplicaStore):
        def push(self, *args):
            return timing("push", super().push, *args)

    class Checkpointer(AsyncCheckpointer):
        def save(self, *args):
            return timing("snapshot", super().save, *args)

    return Store, Checkpointer, times


def same_bits(host, state):
    """Leaf by leaf, bit for bit: a host copy against a state."""
    from repro_torch import tree as T

    leaves = T.leaves(state)
    return len(host) == len(leaves) and all(
        h.dtype == x.dtype and h.shape == x.shape
        and torch.equal(_bytes(h), _bytes(x.detach().cpu()))
        for h, x in zip(host, leaves))


def self_healing(ops):
    """GPT-2 at full width and depth under ``ElasticTrainer(initial=2,
    codec="int8")`` with both recovery tiers attached replays
    ``self_healing_trace`` (adaptive recovery policy, reshard "auto", a step
    before each event) in two calls: events 1-6, a host copy of the state
    the event-6 checkpoint pushed, then event 7. Then the first step after
    event 6 on a batch kept for the restores, ``restore_from("replica")``,
    a step on that batch, ``restore_from("checkpoint")``, a step on it. The
    step after event 6 runs after event 7, so that it and the steps after
    the restores run on the same two devices and global batch (a leave does
    not touch the state). Fails unless both restores are bit-identical to
    the host copy, the losses after them equal the original's within 1e-5
    relative, every loss is finite, the launches are the exact counts of
    the config and the ledger's actions are ``SELF_HEALING_ACTIONS``."""
    import shutil
    import tempfile

    from repro_torch import tree as T
    from repro_torch.configs import get_config
    from repro_torch.core.replication import build_manifest
    from repro_torch.data import ShardedLoader, TokenStream
    from repro_torch.elastic import ElasticTrainer
    from repro_torch.models import build_model

    cfg = get_config("gpt2")
    loader = ShardedLoader(TokenStream(cfg.vocab, SEQ, seed=1), 4096, [0],
                           PER_DEVICE_BATCH)
    losses = []

    class Trainer(ElasticTrainer):
        """Keeps every step's loss (the replay's steps return theirs to the
        churn backend, which drops them)."""

        def step(self, batch):
            m = super().step(batch)
            losses.append(m["loss"])
            log(f"  step {self.step_count} on {len(self.active)} devices: "
                f"loss {m['loss']!r}")
            return m

    trainer = Trainer(build_model(cfg), initial=2,
                      per_device_batch=PER_DEVICE_BATCH,
                      link_model=link_model, codec="int8",
                      on_reshard=loader.reshard)
    trainer.init()
    manifest = build_manifest(trainer.state)
    Store, Checkpointer, times = timed_tiers()
    os.makedirs(os.path.join(HERE, "build"), exist_ok=True)
    ckpt_dir = tempfile.mkdtemp(prefix="self_healing_", dir=os.path.join(HERE, "build"))
    ck = Checkpointer(ckpt_dir, keep=2)
    try:
        trainer.attach_recovery(replica_store=Store(), checkpointer=ck)
        log(f"self-healing: gpt2 at full width and depth ({cfg.n_layers} layers, "
            f"d_model {cfg.d_model}; state {manifest.total_bytes} bytes in "
            f"{len(manifest.entries)} leaves), both recovery tiers, checkpoints "
            f"in {ckpt_dir}")

        def batch_fn():
            return {"tokens": np.concatenate([loader.next_batch(i)
                                              for i in trainer.device_ids()])}

        replay = dict(steps_between=1, policy="adaptive", reshard="auto",
                      state_bytes=manifest.total_bytes,
                      tensor_sizes=manifest.tensor_sizes)
        trace = self_healing_trace()
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        ops.reset_launches()
        t0 = time.perf_counter()
        ledger_a = trainer.replay_scenario(trace[:6], batch_fn=batch_fn, **replay)
        backend_a = trainer.last_backend
        at_ckpt = [leaf.detach().to("cpu", copy=True)
                   for leaf in T.leaves(trainer.state)]
        ledger_b = trainer.replay_scenario(trace[6:], **replay)
        backend_b = trainer.last_backend
        batch = batch_fn()
        log("  the step after event 6:")
        original = trainer.step(batch)["loss"]
        restore_ms = {}
        after = {}
        for tier in ("replica", "checkpoint"):
            if tier == "checkpoint":
                torch.cuda.synchronize()
                t1 = time.perf_counter()
                ck.wait()
                restore_ms["wait_for_writes"] = (time.perf_counter() - t1) * 1e3
            torch.cuda.synchronize()
            t1 = time.perf_counter()
            restored_step = trainer.restore_from(tier)
            torch.cuda.synchronize()
            restore_ms[tier] = (time.perf_counter() - t1) * 1e3
            if restored_step != 6:
                raise AssertionError(f"restore_from({tier!r}) gave step {restored_step}")
            if not same_bits(at_ckpt, trainer.state):
                raise AssertionError(f"restore_from({tier!r}) is not the state the "
                                     f"event-6 checkpoint pushed")
            log(f"  restore_from({tier!r}) {restore_ms[tier]:.1f} ms, then:")
            after[tier] = trainer.step(batch)["loss"]
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = dict(ops.launches)
        peak = torch.cuda.max_memory_allocated()
    finally:
        ck.close()
        shutil.rmtree(ckpt_dir, ignore_errors=True)

    if trainer.step_count != 9 or len(losses) != 9:
        raise AssertionError(f"self-healing: {trainer.step_count} steps, expected 9")
    if not all(math.isfinite(x) for x in losses):
        raise AssertionError(f"self-healing: non-finite loss: {losses}")
    for tier, loss in after.items():
        if not math.isclose(loss, original, rel_tol=1e-5, abs_tol=0.0):
            raise AssertionError(f"self-healing: loss {loss!r} after restore_from"
                                 f"({tier!r}), {original!r} originally")
    n_coded = sum(1 for e in manifest.entries if e.dtype == "float32" and e.nbytes)
    expected = expected_launches(cfg, n_coded, steps=9, scale_outs=2)
    if launches != expected:
        raise AssertionError(f"self-healing: launches {launches}, expected {expected}")
    actions = ledger_a.actions() + ledger_b.actions()
    if actions != SELF_HEALING_ACTIONS:
        raise AssertionError(f"self-healing: ledger actions {actions}")
    saved = [r.detail for r in list(ledger_a) + list(ledger_b)
             if r.action == "ckpt-saved"]
    if saved != [{"step": 1, "tiers": ["replica", "checkpoint"]},
                 {"step": 6, "tiers": ["replica", "checkpoint"]}]:
        raise AssertionError(f"self-healing: checkpoints {saved}")
    joins = [ev for ev in trainer.events if ev.kind == "scale-out"]
    analytics = ledger_analytics([(ledger_a, backend_a), (ledger_b, backend_b)])
    summary = {
        "state_bytes": manifest.total_bytes,
        "ledger_digest": [ledger_a.digest(), ledger_b.digest()],
        "losses": losses,
        "loss_after_event_6": original,
        "loss_after_restore": after,
        "bit_equal_losses": {tier: loss == original for tier, loss in after.items()},
        "replica_push_ms": [t * 1e3 for t in times["push"]],
        "checkpoint_snapshot_ms": [t * 1e3 for t in times["snapshot"]],
        "checkpoint_write_s": {str(s): t for s, t in ck.writes},
        "restore_ms": restore_ms,
        "join_ms": [ev.wall_s * 1e3 for ev in joins],
        "join_n_shards": [ev.plan_summary["n_shards"] for ev in joins],
        "reshards": [ev.plan_summary for ev in trainer.events if ev.kind == "reshard"],
        "launches": launches,
        "wall_s": wall,
        "peak_mem_gb": peak / 1e9,
        "analytics": analytics,
    }
    log(f"self-healing: ledger {ledger_a.digest()} + {ledger_b.digest()}; "
        f"both restores bit-identical to the event-6 state; loss after event 6 "
        f"{original!r}, after the replica restore {after['replica']!r}, after "
        f"the checkpoint restore {after['checkpoint']!r} (bit-equal: "
        f"{summary['bit_equal_losses']})")
    log(json.dumps({"self_healing": summary}))
    return launches


#: The JAX package's ``span_digest`` of the self-healing replay's two
#: ledgers (events 1-6, then event 7); tests/test_torch_churn.py replays the
#: trace on the CPU and holds the JAX function to these values, so the
#: port's analytics on the card are held to the reference without JAX.
SELF_HEALING_SPAN_DIGEST = (
    "1205e817cd3907aaa0bbbbbc1543f3f9b5ea9eba3a90cfa360e4f7f84727a6a8",
    "0c7ffa622c1df105260e6d6c38214e5a6b9ac8ce0219eae8cc88034d707b7890")


def ledger_analytics(replays):
    """The ledger analytics over each ``(ledger, backend)`` of a replay:
    ``build_spans``, ``validate == []``, ``span_digest`` equal to
    ``SELF_HEALING_SPAN_DIGEST``, ``classify`` of the forest's windows
    equal to ``goodput_report``'s components, ``collect_trainer_backend``'s
    exposition, ``write_chrome_trace`` into ``build/`` and
    ``validate_trace_events == []`` on what it wrote, ``markdown_report``.
    Fails on any mismatch. Returns per ledger the digest, the GoodPut
    fraction and the host ms the analytics took."""
    from repro_torch.core import goodput, telemetry

    out = []
    for k, (ledger, backend) in enumerate(replays):
        t0 = time.perf_counter()
        forest = telemetry.build_spans(ledger)
        problems = telemetry.validate(ledger, forest)
        digest = telemetry.span_digest(ledger, forest)
        window = dict(t_start=forest.t_start, t_end=forest.t_end)
        report = goodput.goodput_report(ledger, **window)
        components = goodput.classify(
            [(a, b, cat) for a, b, cat, _, _ in forest.intervals], **window)
        reg = telemetry.MetricsRegistry()
        telemetry.collect_trainer_backend(reg, backend, ledger, report=report)
        prom = reg.exposition()
        path = os.path.join(HERE, "build", f"self_healing_{k}.trace.json")
        telemetry.write_chrome_trace(path, forest, metadata={"ledger": ledger.digest()})
        with open(path) as fh:
            trace_problems = telemetry.validate_trace_events(json.load(fh)["traceEvents"])
        markdown = telemetry.markdown_report(ledger, forest, report=report,
                                             title=f"self-healing ledger {k}")
        ms = (time.perf_counter() - t0) * 1e3
        if problems or trace_problems:
            raise AssertionError(f"analytics of ledger {k}: {problems + trace_problems}")
        if digest != SELF_HEALING_SPAN_DIGEST[k]:
            raise AssertionError(f"analytics of ledger {k}: span digest {digest}, "
                                 f"expected {SELF_HEALING_SPAN_DIGEST[k]}")
        if components != report.components:
            raise AssertionError(f"analytics of ledger {k}: the forest classifies to "
                                 f"{components}, the report {report.components}")
        steps = f"chaos_trainer_steps_total {backend.trainer.step_count}\n"
        degraded = f"chaos_engine_degraded {int(backend.degraded)}\n"
        if steps not in prom or degraded not in prom or not markdown.startswith("# "):
            raise AssertionError(f"analytics of ledger {k}: exposition {prom!r}")
        out.append({"span_digest": digest, "goodput_fraction": report.goodput_fraction,
                    "n_spans": len(forest.roots), "n_records": len(ledger),
                    "exposition_lines": prom.count("\n"), "chrome_trace": path,
                    "host_ms": ms})
        log(f"analytics of ledger {k}: span digest {digest}, goodput fraction "
            f"{report.goodput_fraction!r}, {len(forest.roots)} spans, "
            f"{prom.count(chr(10))} exposition lines; validate [], "
            f"classify == goodput_report, trace events valid; {ms:.3f} ms host")
    return out


# ---------------------------------------------------------------------------
# Phase 3c: the training launcher.
# ---------------------------------------------------------------------------

#: The launcher's reduced plain runs (phase 3c, b): the recurrent families.
LAUNCH_REDUCED = ("rwkv6-1.6b", "zamba2-1.2b")
#: The full-width launcher run (phase 3c, c): GPT-2 at global batch 32 on the
#: launcher's pool of 8, so per-device batch 4 on 4 -> 5 -> 4 devices.
LAUNCH_BATCH = 32
LAUNCH_STEPS = 9


def launcher_cli():
    """``python -m repro_torch.launch.train --arch gpt2 --elastic --steps 9
    --ckpt DIR --ckpt-every 3`` (reduced) in its own process: it must exit
    0, and its checkpoints, at steps 0, 3 and 6, load through the port's
    ``load_checkpoint`` with finite leaves. ``DIR`` is a temporary
    directory under ``build/``, removed at the end."""
    import shutil
    import tempfile

    from repro_torch import tree as T
    from repro_torch.checkpoint import load_checkpoint
    from repro_torch.configs import get_config
    from repro_torch.models import build_model

    os.makedirs(os.path.join(HERE, "build"), exist_ok=True)
    ckpt_dir = tempfile.mkdtemp(prefix="launcher_", dir=os.path.join(HERE, "build"))
    try:
        cmd = [sys.executable, "-m", "repro_torch.launch.train", "--arch", "gpt2",
               "--elastic", "--steps", "9", "--ckpt", ckpt_dir, "--ckpt-every", "3"]
        env = dict(os.environ, PYTHONPATH=os.path.join(HERE, "src"))
        t0 = time.perf_counter()
        proc = subprocess.run(cmd, capture_output=True, text=True, env=env,
                              cwd=HERE, timeout=600)
        wall = time.perf_counter() - t0
        for line in proc.stdout.splitlines():
            log(f"  launcher: {line}")
        if proc.returncode != 0:
            raise AssertionError(f"launcher exited {proc.returncode}: {proc.stderr[-3000:]}")
        names = sorted(os.listdir(ckpt_dir))
        if names != [f"step_{s:08d}.ckpt" for s in (0, 3, 6)]:
            raise AssertionError(f"launcher checkpoints: {names}")
        skeleton = build_model(get_config("gpt2").reduced(),
                               device="meta").init_train_state(torch.Generator())
        for name in names:
            leaves = T.leaves(load_checkpoint(os.path.join(ckpt_dir, name), skeleton))
            if not all(bool(torch.isfinite(leaf).all()) for leaf in leaves
                       if leaf.is_floating_point()):
                raise AssertionError(f"launcher checkpoint {name}: non-finite leaves")
    finally:
        shutil.rmtree(ckpt_dir, ignore_errors=True)
    log(f"launcher CLI (reduced gpt2, elastic, 9 steps): exit 0 in {wall:.1f} s; "
        f"checkpoints {names} load with finite leaves")
    return wall


def launcher_reduced(ops, arch):
    """``main(["--arch", arch, "--steps", "3"])`` in this process (reduced,
    plain mode, on the card): it must print ``TRAIN_OK`` and launch the
    family's kernels exactly as ``expected_launches`` gives them."""
    import contextlib
    import dataclasses
    import io

    from repro_torch.configs import get_config
    from repro_torch.launch import train

    out = io.StringIO()
    torch.cuda.synchronize()
    ops.reset_launches()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(out):
        rc = train.main(["--arch", arch, "--steps", "3"])
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = dict(ops.launches)
    for line in out.getvalue().splitlines():
        log(f"  launcher {arch}: {line}")
    if rc != 0 or not out.getvalue().rstrip().endswith("TRAIN_OK"):
        raise AssertionError(f"launcher {arch}: exit {rc}, output {out.getvalue()!r}")
    cfg = dataclasses.replace(get_config(arch).reduced(), learning_rate=1e-3)
    expected = expected_launches(cfg, 0, steps=3)
    if launches != expected:
        raise AssertionError(f"launcher {arch}: launches {launches}, expected {expected}")
    log(f"launcher {arch} (reduced, plain, 3 steps): TRAIN_OK in {wall:.1f} s; "
        f"launches {json.dumps(launches)}")
    return launches


def launcher_full_width(ops):
    """``train_elastic`` on GPT-2 at full width and depth, global batch
    ``LAUNCH_BATCH`` at sequence ``SEQ`` (the full-config ``train_4k`` cell,
    256 x 4096, does not fit one card), ``LAUNCH_STEPS`` steps on 4 -> 5 ->
    4 logical devices, codec "none". Fails unless the devices per step
    follow the launcher's schedule, every loss is finite and the launches
    are the exact counts of the config (no codec launch)."""
    import contextlib
    import io

    from repro_torch.configs import ShapeCell, get_config
    from repro_torch.launch import train
    from repro_torch.models import build_model

    cfg = get_config("gpt2")
    model = build_model(cfg)
    out = io.StringIO()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    ops.reset_launches()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(out):
        run = train.train_elastic(model, ShapeCell("launch", SEQ, LAUNCH_BATCH, "train"),
                                  LAUNCH_STEPS)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = dict(ops.launches)
    peak = torch.cuda.max_memory_allocated()
    for line in out.getvalue().splitlines():
        log(f"  launcher gpt2: {line}")
    expected = expected_launches(cfg, 0, steps=LAUNCH_STEPS, scale_outs=0)
    if launches != expected:
        raise AssertionError(f"launcher gpt2: launches {launches}, expected {expected}")
    if run.n_active != [4, 4, 4, 5, 5, 5, 4, 4, 4]:
        raise AssertionError(f"launcher gpt2: devices per step {run.n_active}")
    if not all(math.isfinite(x) for x in run.losses):
        raise AssertionError(f"launcher gpt2: non-finite loss: {run.losses}")
    times = run.trainer.metrics_snapshot()["step_times"]
    scale_out = [ev for ev in run.events if ev.kind == "scale-out"][0]
    summary = {
        "global_batch": {n: n * run.trainer.per_device_batch for n in times},
        "losses": run.losses,
        "step_ms": {n: [t * 1e3 for t in ts] for n, ts in times.items()},
        # The first step on 4 devices is the run's first: it holds warm-up.
        "median_step_ms": {n: float(np.median(ts[1:] if n == 4 else ts)) * 1e3
                           for n, ts in times.items()},
        "scale_out_ms": scale_out.wall_s * 1e3,
        "scale_out_plan": {k: scale_out.plan_summary[k]
                           for k in ("shard_size", "n_shards", "predicted_completion_s")},
        "launches": launches,
        "wall_s": wall,
        "peak_mem_gb": peak / 1e9,
    }
    log(f"launcher gpt2 at full width: median step {summary['median_step_ms'][4]:.1f} "
        f"ms on 4 devices (global batch {4 * run.trainer.per_device_batch}), "
        f"{summary['median_step_ms'][5]:.1f} ms on 5; scale-out "
        f"{summary['scale_out_ms']:.1f} ms; peak {peak / 1e9:.1f} GB")
    log(json.dumps({"launcher": summary}))
    del run, model
    return launches


def replica_tier(trainer, name):
    """The replica tier on a path's full state: push to a
    ``MemoryReplicaStore`` over the trainer's neighbors, twice (the second
    push replaces the first, and the allocator then has the shards' blocks
    cached), restore, and hold the restored leaves bit for bit against the
    state. Prints push and restore times, shard counts, bytes held and the
    peak memory."""
    from repro_torch import tree as T
    from repro_torch.checkpoint import MemoryReplicaStore

    store = MemoryReplicaStore()
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    push_ms = []
    for _ in range(2):
        t0 = time.perf_counter()
        meta = store.push(0, trainer.step_count, trainer.state,
                          trainer.replication_neighbors())
        torch.cuda.synchronize()
        push_ms.append((time.perf_counter() - t0) * 1e3)
    peak_push = torch.cuda.max_memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    tree, step = store.restore(0)
    torch.cuda.synchronize()
    restore_ms = (time.perf_counter() - t0) * 1e3
    peak_restore = torch.cuda.max_memory_allocated()
    ok = step == trainer.step_count and all(
        a.dtype == b.dtype and a.shape == b.shape and torch.equal(_bytes(a), _bytes(b))
        for a, b in zip(T.leaves(tree), T.leaves(trainer.state)))
    if not ok or len(T.leaves(tree)) != len(T.leaves(trainer.state)):
        raise AssertionError(f"{name}: the replica restore differs from the state")
    out = {"path": name, "state_bytes": meta.manifest.total_bytes,
           "push_ms": push_ms, "restore_ms": restore_ms,
           "n_shards": len(meta.ranges), "shard_size": meta.ranges[0].nbytes,
           "bytes_held": {str(h): store.bytes_held(h) for h in sorted(meta.holders)},
           "state_gb": base / 1e9, "peak_push_gb": peak_push / 1e9,
           "peak_restore_gb": peak_restore / 1e9}
    del tree, store
    log(f"{name} replica tier: push {push_ms[0]:.1f} ms, again {push_ms[1]:.1f} "
        f"ms; restore {restore_ms:.1f} ms over {out['n_shards']} shards, "
        f"bit-identical; {json.dumps(out)}")
    return out


# ---------------------------------------------------------------------------
# Phase 3d: serving.
# ---------------------------------------------------------------------------


def reduced_dense(ops, arch):
    """Phase 3e: a dense config that fits no card (``REDUCED_DENSE``),
    reduced: 2 steps under ``ElasticTrainer`` on 2 logical devices with the
    int8 codec, a scale-out, a step on 3, the launches held to
    ``expected_launches`` and the state bit-unchanged by the scale-out (for
    llama3 its adamw8bit state: the int8 moment codes ship raw, their fp32
    scales and the params through the codec); then one served request
    through ``generate`` (batch 2, a 32-token prompt, 8 new tokens, exact
    launches) and ``serve_fp32_check`` with the config's planted faults.
    Returns the launches of both."""
    from repro_torch import tree as T
    from repro_torch.configs import get_config
    from repro_torch.core import replication as rep
    from repro_torch.data import ShardedLoader, TokenStream
    from repro_torch.elastic import ElasticTrainer
    from repro_torch.launch.serve import generate
    from repro_torch.models import build_model

    cfg = get_config(arch).reduced()
    model = build_model(cfg)
    loader = ShardedLoader(TokenStream(cfg.vocab, SEQ, seed=0), 256, [0],
                           PER_DEVICE_BATCH)
    trainer = ElasticTrainer(model, initial=2, per_device_batch=PER_DEVICE_BATCH,
                             link_model=link_model, codec="int8",
                             on_reshard=loader.reshard)
    trainer.init()
    losses = []

    def steps(n):
        for _ in range(n):
            toks = np.concatenate([loader.next_batch(i) for i in trainer.device_ids()])
            losses.append(trainer.step({"tokens": toks})["loss"])

    torch.cuda.synchronize()
    ops.reset_launches()
    steps(2)
    before = [leaf.detach().clone() for leaf in T.leaves(trainer.state)]
    ev = trainer.scale_out()
    unchanged = all(a.dtype == b.dtype and torch.equal(_bytes(a), _bytes(b))
                    for a, b in zip(before, T.leaves(trainer.state)))
    steps(1)
    torch.cuda.synchronize()
    launches = dict(ops.launches)
    n_coded = sum(1 for leaf in before if leaf.dtype == torch.float32 and leaf.numel())
    expected = expected_launches(cfg, n_coded, steps=3)
    kinds = {}
    for e in rep.encode_state(trainer.state, "int8")[0]:
        kinds[e.kind] = kinds.get(e.kind, 0) + 1
    n_int8 = sum(1 for leaf in before if leaf.dtype == torch.int8)
    if not unchanged:
        raise AssertionError(f"{arch} reduced: the scale-out changed the state")
    if launches != expected:
        raise AssertionError(f"{arch} reduced: launches {launches}, expected {expected}")
    if not all(math.isfinite(x) for x in losses):
        raise AssertionError(f"{arch} reduced: non-finite loss {losses}")
    if (cfg.optimizer == "adamw8bit") != (n_int8 > 0) or kinds.get("int8") != n_coded:
        raise AssertionError(f"{arch} reduced: {n_int8} int8 leaves, encoded {kinds}")
    codec = ev.plan_summary["codec"]
    del before, trainer

    params = model.init(torch.Generator(device="cuda").manual_seed(0))
    prompts = torch.randint(0, cfg.vocab, (2, 32),
                            generator=torch.Generator().manual_seed(1)).cuda()
    ops.reset_launches()
    run = generate(model, params, prompts, 8)
    serve_launched = dict(ops.launches)
    if serve_launched != serve_launches(cfg, 8) or run.tokens.shape != (2, 8):
        raise AssertionError(f"{arch} reduced serving: launches {serve_launched}, "
                             f"tokens {tuple(run.tokens.shape)}")
    forced = torch.randint(0, cfg.vocab, (2, FP32_DECODE_STEPS),
                           generator=torch.Generator().manual_seed(2)).cuda()
    fp = serve_fp32_check(cfg, params, torch.cat([prompts, forced], 1), 32, 48)
    summary = {"arch": cfg.name, "optimizer": cfg.optimizer, "losses": losses,
               "scale_out_ms": ev.wall_s * 1e3, "codec": codec,
               "encoded_leaves": kinds, "int8_leaves": n_int8,
               "launches": launches, "serve_launches": serve_launched,
               "fp32_check": fp}
    log(f"{arch} reduced ({cfg.optimizer}): 3 steps, losses "
        f"{[round(x, 4) for x in losses]}, an int8 scale-out in "
        f"{ev.wall_s * 1e3:.1f} ms, state bit-unchanged ({kinds.get('raw', 0)} "
        f"leaves raw, {n_int8} of them int8; {kinds['int8']} coded), wire "
        f"{codec['wire_bytes']} of {codec['payload_bytes']} bytes; served 8 "
        f"tokens; fp32 check max |diff| {fp['max_abs_diff']:.3e}, faults "
        + "; ".join(f"{k} {v['max_abs_diff']:.3e}" for k, v in fp["faults"].items()))
    log(json.dumps({"reduced_dense": summary}))
    for k, n in serve_launched.items():
        launches[k] += n
    return launches


#: The families whose serving checks are held at ``_tol`` (``serve_tol``).
TOL_FAMILIES = ("dense", "vlm", "moe", "encdec")


def serve_tol(cfg, dtype):
    """The fixed tolerance of a serving check, tests/test_kernels.py's own:
    ``_tol`` for ``TOL_FAMILIES`` (attention); ``_rec_tol`` for the ssm and
    hybrid families, whose decode runs WKV6 or SSD one step per launch
    where the cache-free forward runs every step in one launch, so their
    fp32 sums come in another order."""
    if cfg.family in TOL_FAMILIES:
        return tol(dtype)
    return rec_tol(dtype)


@contextlib.contextmanager
def at_cache_free_rows(rows, unembed_rows, vocab, capacity):
    """For the duration, every fp32 product and norm of the cached side of
    ``serve_fp32_check`` runs at the cache-free forward's row count: an
    ``x @ w`` or an rmsnorm/layernorm over fewer than ``rows`` rows (the
    unembedding, ``w`` of ``vocab`` columns: ``unembed_rows``) runs inside
    zero rows up to that count, and an MoE expert product over a buffer of
    fewer than ``capacity`` slots runs inside zero slots up to it. cuBLAS
    (the products) and PyTorch (the norms' means over d_model) pick the
    order of their fp32 sums by the row count, so a decode step's 8 rows
    and the cache-free forward's 8 x 1,031 sum in other orders
    (``tools/tinyllama_fp32_drift.py``, PERF.md §6); padded, both sides
    compute each row in the same order, and the check sees the cache's
    logic alone. Each row's result is a function of that row only: the
    zero rows change no value of the others."""
    from repro_torch.models import layers as L

    f32 = torch.float32
    matmul, einsum = torch.Tensor.__matmul__, torch.einsum
    norms = {"rmsnorm": L.rmsnorm, "layernorm": L.layernorm}

    def pad_rows(flat, m):
        big = flat.new_zeros((m, flat.shape[1]))
        big[:flat.shape[0]] = flat
        return big

    def padded_matmul(a, b):
        if a.dtype == f32 and a.dim() >= 2 and b.dim() == 2:
            m = unembed_rows if b.shape[-1] == vocab else rows
            flat = a.reshape(-1, a.shape[-1])
            if flat.shape[0] < m:
                out = matmul(pad_rows(flat, m), b)[:flat.shape[0]]
                return out.reshape(*a.shape[:-1], b.shape[-1])
        return matmul(a, b)

    def padded_einsum(eq, a, *rest):
        # The experts' products: "gecd,edf->gecf" and "gecf,efd->gecd".
        if eq.startswith("gec") and a.dtype == f32 and a.shape[2] < capacity:
            big = a.new_zeros((*a.shape[:2], capacity, a.shape[3]))
            big[:, :, :a.shape[2]] = a
            return einsum(eq, big, *rest)[:, :, :a.shape[2]]
        return einsum(eq, a, *rest)

    def padded_norm(norm):
        def run(x, *args, **kw):
            flat = x.reshape(-1, x.shape[-1])
            if x.dtype != f32 or flat.shape[0] >= rows:
                return norm(x, *args, **kw)
            return norm(pad_rows(flat, rows), *args, **kw)[:flat.shape[0]].reshape(
                x.shape)
        return run

    torch.Tensor.__matmul__, torch.einsum = padded_matmul, padded_einsum
    for name, norm in norms.items():
        setattr(L, name, padded_norm(norm))
    try:
        yield
    finally:
        torch.Tensor.__matmul__, torch.einsum = matmul, einsum
        for name, norm in norms.items():
            setattr(L, name, norm)


def serve_launches(cfg, n_tokens):
    """The launches of one served request of ``n_tokens`` new tokens: a
    forward each (the prefill and ``n_tokens - 1`` decode steps), which
    serving runs without remat and without a scale-out."""
    import dataclasses

    return expected_launches(dataclasses.replace(cfg, remat=False), 0,
                             steps=n_tokens, scale_outs=0, serving=True)


#: Faults planted in the serving path, per family; each must fail the fp32
#: check of cached against cache-free logits.
SERVE_FAULTS = {"dense": ("cache written one slot off",
                          "the local layer loses its window",
                          "the global layer keeps the window",
                          "the attention softcap dropped"),
                "ssm": ("x_last not carried", "state not carried"),
                "hybrid": ("conv state not carried", "SSM state not carried",
                           "applications sharing one KV cache",
                           "cache written one slot off",
                           "RoPE positions from 0 at decode"),
                "vlm": ("cache written one slot off",
                        "decode at the JAX launcher's S + t",
                        "causal mask on the cached prefill",
                        "cache without the prefix rows"),
                "encdec": ("cache written one slot off",
                           "cross cache from other frames")}
SERVE_FAULTS["moe"] = SERVE_FAULTS["dense"]
#: Planted faults that make the cached side raise (a KV cache overflow)
#: instead of giving logits: the check holds them to raising.
RAISING_FAULTS = ("cache without the prefix rows",)


#: How far the attention softcap must move a score 4 standard deviations
#: out for its planted fault to be one the fp32 check can see.
SOFTCAP_VISIBLE = 1e-3


def softcap_shift(cfg):
    """What the attention softcap ``c`` takes off a score 4 standard
    deviations out, ``s - c·tanh(s/c)`` (about s³/3c²), at a random init:
    q and k entries about unit normal after the norm and the 1/sqrt(d)
    projections, so the scores spread as ``scale·sqrt(hd)``. Full gemma2:
    4 x 0.707, 3.0e-3; reduced (hd 16): 4 x 0.25, 1.3e-4."""
    c = cfg.attn_softcap
    scale = cfg.query_scale or cfg.head_dim ** -0.5
    s = 4.0 * scale * math.sqrt(cfg.head_dim)
    return s - c * math.tanh(s / c) if c else 0.0


def serve_faults(cfg):
    """The family's ``SERVE_FAULTS`` that can show on ``cfg``: a config
    that applies its shared block once has no second KV cache to share;
    only a config that alternates local and global layers (gemma2) has a
    window to lose or keep; only one with an attention softcap has one to
    drop, and only where random-init scores reach its curve
    (``softcap_shift`` above ``SOFTCAP_VISIBLE``): on the reduced gemma2
    the fault moves 0 to 3 of its 2,560 checked logits past fp32 ``_tol``,
    seed by seed."""
    from repro_torch.models import zamba2

    def shows(fault):
        if fault == "applications sharing one KV cache":
            return zamba2.n_shared_apps(cfg) > 1
        if fault in ("the local layer loses its window",
                     "the global layer keeps the window"):
            return cfg.alt_local_global and cfg.sliding_window > 0
        if fault == "the attention softcap dropped":
            return softcap_shift(cfg) > SOFTCAP_VISIBLE
        return True

    return tuple(f for f in SERVE_FAULTS[cfg.family] if shows(f))


@contextlib.contextmanager
def planted_fault(fault):
    """Plant ``fault`` (None or one of ``SERVE_FAULTS``) in the port's
    serving path for the duration: the KV cache written one row late (both
    the prefill's and each decode step's write); the token shift ignoring
    the carried ``x_last``; the WKV6 or SSD call ignoring the carried
    state; the causal conv ignoring its carried context (zeros in its
    place); every application of Zamba2's shared block reading and writing
    the first application's KV cache; RoPE rotating each call's rows from
    position 0 (a prefill from 0 is unchanged, a decode step is not); on
    the cache path (the prefill into the cache and each decode step), the
    local (even) layers attending without their window, or the global
    (odd) ones with it, or the attention without its softcap; a vlm's
    decode step written and rotated at ``S + t`` (its position without the
    patches' rows, as the JAX launcher decodes), its cached prefill under
    the causal mask instead of the prefix mask, or its cache made without
    the patches' rows; an encdec model's cross-KV cache filled from another
    batch row's frames (the encoder's output rolled by one row)."""
    import dataclasses

    from repro_torch.kernels import ops
    from repro_torch.models import layers as L
    from repro_torch.models import mamba2, rwkv6, transformer, whisper, zamba2

    if fault is None:
        yield
        return
    if fault == "cache written one slot off":
        module, name = L, "_write_cache"
        orig = L._write_cache

        def faulty(cache, new, pos):
            return orig(cache, new, pos + 1)
    elif fault == "x_last not carried":
        module, name = rwkv6, "_shift"
        orig = rwkv6._shift

        def faulty(x, x_last=None):
            return orig(x)
    elif fault == "state not carried":
        module, name = ops, "wkv6"
        orig = ops.wkv6

        def faulty(r, k, v, lw, u, state=None, **kw):
            return orig(r, k, v, lw, u, None, **kw)
    elif fault == "SSM state not carried":
        module, name = ops, "ssd"
        orig = ops.ssd

        def faulty(x, dt, A_log, Bm, Cm, state=None, **kw):
            return orig(x, dt, A_log, Bm, Cm, None, **kw)
    elif fault == "conv state not carried":
        module, name = mamba2, "causal_conv"
        orig = mamba2.causal_conv

        def faulty(x, w, b, conv_state=None):
            return orig(x, w, b, None if conv_state is None
                        else torch.zeros_like(conv_state))
    elif fault == "applications sharing one KV cache":
        module, name = zamba2, "_shared_apply"
        orig = zamba2._shared_apply

        def faulty(sp, x, x0, cfg, positions, cache_kv=None, cache_pos=None):
            if cache_kv is not None:  # views of (apps, B, Smax, K, hd)
                cache_kv = tuple(c._base[0] for c in cache_kv)
            return orig(sp, x, x0, cfg, positions, cache_kv, cache_pos)
    elif fault == "RoPE positions from 0 at decode":
        module, name = L, "rope"
        orig = L.rope

        def faulty(x, positions, theta):
            return orig(x, positions - positions[..., :1], theta)
    elif fault in ("the local layer loses its window",
                   "the global layer keeps the window"):
        module, name = transformer, "_layer_body"
        orig = transformer._layer_body
        keep = fault == "the global layer keeps the window"

        def faulty(cfg, x, lp, spec, is_local, positions, cache_kv=None,
                   cache_pos=None):
            if cache_kv is not None and is_local is not None:
                is_local = keep
            return orig(cfg, x, lp, spec, is_local, positions, cache_kv, cache_pos)
    elif fault == "decode at the JAX launcher's S + t":
        module, name = transformer, "forward"
        orig = transformer.forward

        def faulty(cfg, params, tokens, *, patch_embeds=None, cache=None,
                   cache_pos=None, **kw):
            if cache is not None and patch_embeds is None and cfg.family == "vlm":
                cache_pos = int(cache_pos) - cfg.n_patches
            return orig(cfg, params, tokens, patch_embeds=patch_embeds, cache=cache,
                        cache_pos=cache_pos, **kw)
    elif fault == "causal mask on the cached prefill":
        module, name = L, "attention_sublayer"
        orig = L.attention_sublayer

        def faulty(params, x, cfg, spec, *, cache_kv=None, **kw):
            if cache_kv is not None and spec.kind == "prefix":
                spec = L.MaskSpec("causal", window=spec.window)
            return orig(params, x, cfg, spec, cache_kv=cache_kv, **kw)
    elif fault == "cache without the prefix rows":
        module, name = transformer, "make_cache"
        orig = transformer.make_cache

        def faulty(cfg, batch, max_len, dtype=torch.bfloat16, device=None, prefix=0):
            return orig(cfg, batch, max_len, dtype, device)
    elif fault == "cross cache from other frames":
        module, name = whisper, "precompute_cross_kv"
        orig = whisper.precompute_cross_kv

        def faulty(cfg, params, enc_out):
            return orig(cfg, params, enc_out.roll(1, dims=0))
    elif fault == "the attention softcap dropped":
        module, name = L, "attention_sublayer"
        orig = L.attention_sublayer

        def faulty(params, x, cfg, spec, *, cache_kv=None, **kw):
            if cache_kv is not None:
                cfg = dataclasses.replace(cfg, attn_softcap=0.0)
            return orig(params, x, cfg, spec, cache_kv=cache_kv, **kw)
    else:
        raise ValueError(f"unknown fault {fault!r}")
    setattr(module, name, faulty)
    try:
        yield
    finally:
        setattr(module, name, orig)


def serve_forced(cfg, params, tokens, n_prompt, cache_len, dtype=torch.float32,
                 patches=None, frames=None):
    """Serving teacher-forced, activations and KV caches in ``dtype``:
    prefill ``tokens[:, :n_prompt]`` into a cache of ``cache_len``
    positions (dense, hybrid; a vlm prefills ``patches`` in front, into a
    cache of ``cache_len`` + n_patches rows; an encdec model runs
    ``frames`` through its encoder into the cross-KV cache) or from a zero
    state (ssm, and hybrid's Mamba2 blocks), then decode the other tokens
    one per step, each at its position (a vlm's after the patches' rows).
    Returns the logits at positions ``n_prompt - 1`` onwards, (B, n -
    n_prompt + 1, V) in ``dtype``."""
    from repro_torch.models import rwkv6, transformer, whisper, zamba2

    B, n = tokens.shape
    pre, first = prefix_rows(cfg), {}
    with torch.no_grad():
        if cfg.family == "encdec":
            cache = whisper.make_cache(cfg, B, cache_len, dtype, tokens.device)
            first = {"frames": frames}

            def step(toks, pos, cache, **kw):
                return whisper.forward(cfg, params, toks, cache=cache, cache_pos=pos,
                                       last_only=True, dtype=dtype, **kw)[:2]
        elif cfg.family in ("dense", "vlm", "moe"):
            cache = transformer.make_cache(cfg, B, cache_len, dtype, tokens.device,
                                           prefix=pre)
            if pre:
                first = {"patch_embeds": patches}

            def step(toks, pos, cache, **kw):
                return transformer.forward(cfg, params, toks, cache=cache,
                                           cache_pos=pos, last_only=True,
                                           dtype=dtype, **kw)[:2]
        elif cfg.family == "hybrid":
            cache = zamba2.make_state(cfg, B, cache_len, dtype, tokens.device)

            def step(toks, pos, state):
                return zamba2.forward(cfg, params, toks, state=dict(state, pos=pos),
                                      last_only=True, dtype=dtype)[:2]
        else:
            cache = rwkv6.make_state(cfg, B, tokens.device)

            def step(toks, pos, state):
                return rwkv6.forward(cfg, params, toks, state=state,
                                     last_only=True, dtype=dtype)[:2]

        logits, cache = step(tokens[:, :n_prompt], 0, cache, **first)
        out = [logits[:, -1]]
        for pos in range(n_prompt, n):
            logits, cache = step(tokens[:, pos:pos + 1], pre + pos, cache)
            out.append(logits[:, -1])
    return torch.stack(out, dim=1)


@contextlib.contextmanager
def moe_drops(n_rows):
    """For the duration, counts the (token, choice) pairs each MoE layer
    call drops past its experts' capacity, from the keeps of
    ``moe._dispatch_indices`` (wrapped here, as ``planted_fault`` wraps
    code; the package is not changed). Each call's group is ``n_rows``
    batch rows of consecutive tokens (``n_groups=1``). Yields a dict whose
    ``calls`` gets each call's count of dropped pairs (0-d tensors, read
    after the run, so that no call waits for the device) and whose
    ``rows`` gets each call's (n_rows,) mask of rows with a dropped pair;
    ``dropped_pairs(seen)`` and ``dropped_rows(seen)`` read them."""
    from repro_torch.models import moe

    orig = moe._dispatch_indices
    seen = {"calls": [], "rows": []}

    def counted(idx, E, C):
        e, p, keep = orig(idx, E, C)
        dropped = ~keep.reshape(n_rows, -1)
        seen["calls"].append(dropped.sum())
        seen["rows"].append(dropped.any(dim=1))
        return e, p, keep

    moe._dispatch_indices = counted
    try:
        yield seen
    finally:
        moe._dispatch_indices = orig


def dropped_pairs(seen):
    """Each call's dropped pairs, as ints, from ``moe_drops``."""
    return [int(n) for n in seen["calls"]]


def dropped_rows(seen, n_rows):
    """The (n_rows,) bool mask, on the host, of the batch rows that dropped a
    pair in any call recorded by ``moe_drops``."""
    rows = torch.zeros(n_rows, dtype=torch.bool)
    for r in seen["rows"]:
        rows |= r.cpu()
    return rows


def serve_fp32_check(cfg, params, tokens, n_prompt, cache_len, patches=None,
                     frames=None):
    """fp32 cached against cache-free logits: ``serve_forced`` (for
    ``TOL_FAMILIES``, its products and norms at the cache-free row counts:
    ``at_cache_free_rows``) against the cache-free fp32 forward over all of ``tokens`` (a vlm's
    behind its ``patches``, an encdec model's over its ``frames``), at
    every position from the prompt's last on, within
    ``serve_tol(cfg, fp32)``; then each of ``serve_faults(cfg)`` planted,
    each of which must leave that tolerance, or, for ``RAISING_FAULTS``,
    raise a KV cache overflow. Raises if either fails; returns the
    errors.

    An MoE layer's expert capacity depends on how many tokens its call
    routes: the cache-free forward, the prefill and each decode step have
    their own, and drop in their own token order, so the two sides compute
    the same function only where neither drops. The dropped (token,
    choice) pairs are counted on both sides (``moe_drops``); a batch row
    with a dropped pair on either side is compared with nothing, and the
    check fails if no row is left. The faults are held on the rows the
    check compared. The tolerance is the same for every row."""
    from repro_torch.models import layers as L
    from repro_torch.models.model_api import _family_forward

    f32 = torch.float32
    B = tokens.shape[0]
    kw = stub_kwargs(cfg, patches, frames)
    with torch.no_grad(), moe_drops(B) as free_drops:
        hidden, _ = _family_forward(cfg)(cfg, params, tokens,
                                         return_hidden=True, dtype=f32, **kw)
        want = L.unembed(params["embed"], hidden[:, n_prompt - 1:], cfg)
    del hidden
    t = serve_tol(cfg, f32)
    rows = None  # the rows compared, set by the check without a fault
    # The cache-free forward's row counts: its tokens (a vlm's patches in
    # front), the positions it unembeds, its MoE calls' capacity.
    free_rows = B * (tokens.shape[1] + prefix_rows(cfg))
    capacity = 0
    if cfg.is_moe:
        from repro_torch.models import moe

        capacity = moe._capacity(free_rows, cfg)

    def padded():
        if cfg.family not in TOL_FAMILIES:
            return contextlib.nullcontext()
        return at_cache_free_rows(free_rows, B * want.shape[1], cfg.vocab, capacity)

    def run(fault):
        nonlocal rows
        with planted_fault(fault), moe_drops(B) as cached_drops, padded():
            got = serve_forced(cfg, params, tokens, n_prompt, cache_len,
                               patches=patches, frames=frames)
        if rows is None:
            rows = ~(dropped_rows(free_drops, B) | dropped_rows(cached_drops, B))
            drops["cached"] = sum(dropped_pairs(cached_drops))
        keep = rows.to(want.device)
        d = (got[keep] - want[keep]).abs()
        if not d.numel():
            return 0.0, 0
        return (float(d.max()),
                int((d > t["atol"] + t["rtol"] * want[keep].abs()).sum()))

    drops = {"cache_free": sum(dropped_pairs(free_drops))}
    err, bad = run(None)
    n_rows = int(rows.sum())
    out = {"tolerance": t, "positions": want.shape[1],
           "n_logits": n_rows * want[0].numel(),
           "max_abs_logit": float(want.abs().max()), "max_abs_diff": err,
           "outside": bad, "drops": drops, "rows_compared": n_rows,
           "rows_left_out": B - n_rows, "faults": {}}
    if not n_rows:
        raise AssertionError(f"{cfg.name}: every batch row dropped a (token, "
                             f"choice) pair on one side ({drops}): no row to "
                             f"compare")
    if bad:
        raise AssertionError(f"{cfg.name}: fp32 cached logits differ from the "
                             f"cache-free forward by up to {err:.3e}, {bad} "
                             f"outside {t}")
    for fault in serve_faults(cfg):
        if fault in RAISING_FAULTS:
            try:
                run(fault)
            except ValueError as e:
                if "KV cache overflow" not in str(e):
                    raise
                out["faults"][fault] = {"raised": str(e)}
                continue
            raise AssertionError(f"{cfg.name}: the planted fault {fault!r} "
                                 f"does not raise")
        f_err, f_bad = run(fault)
        out["faults"][fault] = {"max_abs_diff": f_err, "outside": f_bad}
        if not f_bad:
            raise AssertionError(f"{cfg.name}: the planted fault {fault!r} "
                                 f"passes the fp32 check (max |diff| {f_err:.3e})")
    return out


#: (kernel, the decode regime's CUDA kernel, the other kernels of its
#: wrapper) by name, as a profile lists them.
DECODE_KERNELS = (("ssd", "ssd_decode_kernel", ("ssd_chunked_kernel", "ssd_fwd_kernel")),
                  ("wkv6", "wkv6_decode_kernel", ("wkv6_fwd_kernel",)))


def serve_path(ops, name, cfg, B, P, n_tokens):
    """One serving run (``serve_runs``) at full width through the serving
    launcher's ``generate`` (``Model.prefill`` and ``Model.decode_step``):
    a batch of ``B`` random prompts of ``P`` tokens, ``n_tokens`` greedy
    new tokens, a cache of ``P + n_tokens`` positions, bf16 as served;
    params from the port's init, seeded. Each
    decode step is closed by a sync and timed (``generate(stream=True)``).
    The launch counters are zeroed just before the run and read just after
    it, and held to the exact count (``serve_launches``: each layer's
    kernel once in the prefill and once per decode step). Then, the counts
    read:

    * the same request again, its decode loop timed as one window closed
      by one sync, as the JAX launcher times it;

    * the bf16 prefill's logits against the last position of the bf16
      cache-free forward over the same prompt, within ``serve_tol``
      (gated);
    * each step's served logits against the cache-free bf16 forward over
      the prompt and the generated tokens, reported per step, not gated;
      beside it the same forward's logits at the prompt's last position
      against the prompt-only forward's (the same positions, only the
      sequence length differs);
    * fp32 prefill + ``FP32_DECODE_STEPS`` forced decode steps against the
      cache-free fp32 forward (``serve_fp32_check``, gated), with the
      family's planted faults;
    * one profiled decode step: device busy time, its share of the median
      step, and the five device operations that take the most of it; the
      SSD and WKV6 decode regimes' kernels launched once per layer in it
      and their other kernels not at all (``DECODE_KERNELS``, gated).

    Returns the launches."""
    from torch.profiler import ProfilerActivity, profile

    from repro_torch import tree as T
    from repro_torch.launch.serve import generate
    from repro_torch.models import build_model
    from repro_torch.models import layers as L
    from repro_torch.models.model_api import _family_forward

    model = build_model(cfg)
    params = model.init(torch.Generator(device="cuda").manual_seed(0))
    n_params = sum(p.numel() for p in T.leaves(params))
    host = torch.Generator().manual_seed(1)
    prompts = torch.randint(0, cfg.vocab, (B, P), generator=host).cuda()
    forced = torch.randint(0, cfg.vocab, (B, FP32_DECODE_STEPS), generator=host).cuda()
    pre = prefix_rows(cfg)
    stub = {key: torch.from_numpy(x).cuda()
            for key, x in stub_for(cfg, B, np.random.default_rng(1)).items()}
    kw = stub_kwargs(cfg, **stub)
    # A warm-up request (a prefill and one decode step) first, so that the
    # timed one reads steady times, not the first call's library set-up.
    generate(model, params, prompts, 2, **stub)
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.synchronize()
    params_gb = torch.cuda.memory_allocated() / 1e9
    torch.cuda.reset_peak_memory_stats()
    ops.reset_launches()
    t0 = time.perf_counter()
    run = generate(model, params, prompts, n_tokens, stream=True, keep_logits=True,
                   **stub)
    wall = time.perf_counter() - t0
    launches = dict(ops.launches)
    peak = torch.cuda.max_memory_allocated()
    expected = serve_launches(cfg, n_tokens)
    if launches != expected:
        raise AssertionError(f"serving {name}: launches {launches}, expected {expected}")
    served = torch.stack(run.logits, dim=1)  # (B, n_tokens, V) bf16
    if (served.shape != (B, n_tokens, cfg.vocab)
            or run.tokens.shape != (B, n_tokens)
            or not bool(torch.isfinite(served).all())
            or not bool(((run.tokens >= 0) & (run.tokens < cfg.vocab)).all())):
        raise AssertionError(f"serving {name}: logits {tuple(served.shape)}, "
                             f"tokens {tuple(run.tokens.shape)}, finite "
                             f"{bool(torch.isfinite(served).all())}")
    window = generate(model, params, prompts, n_tokens, **stub).decode_ms
    steps = np.array(run.step_ms)
    summary = {
        "model": name, "n_params": n_params, "batch": B, "prompt": P,
        "prefix_rows": pre, "new_tokens": n_tokens, "cache_len": pre + P + n_tokens,
        "prefill_ms": run.prefill_ms,
        "decode_ms_median": float(np.median(steps)),
        "decode_ms_p90": float(np.percentile(steps, 90)),
        "decode_ms_min": float(steps.min()), "decode_ms_max": float(steps.max()),
        "decode_steps": len(steps), "decode_ms_sum": float(steps.sum()),
        "decode_tokens_per_s": B * len(steps) / (steps.sum() / 1e3),
        "decode_window_ms": window,
        "decode_window_ms_per_token": window / len(steps),
        "decode_window_tokens_per_s": B * len(steps) / (window / 1e3),
        "wall_s": wall, "params_gb": params_gb, "peak_mem_gb": peak / 1e9,
        "launches": launches,
    }

    # The bf16 prefill against the cache-free forward over the same prompt.
    fwd = _family_forward(cfg)
    t = serve_tol(cfg, torch.bfloat16)
    with torch.no_grad():
        hidden, _ = fwd(cfg, params, prompts, return_hidden=True, **kw)
        ref_prefill = L.unembed(params["embed"], hidden[:, -1], cfg)
        del hidden
        full = torch.cat([prompts, run.tokens[:, :-1]], dim=1)
        hidden, _ = fwd(cfg, params, full, return_hidden=True, **kw)
        ref = L.unembed(params["embed"], hidden[:, P - 1:], cfg)
        del hidden
    d_prefill = (served[:, 0].float() - ref_prefill.float()).abs()
    prefill_bad = int((d_prefill > t["atol"] + t["rtol"] * ref_prefill.float().abs()).sum())
    d = (served.float() - ref.float()).abs()
    summary["bf16_prefill"] = {
        "tolerance": t, "max_abs_diff": float(d_prefill.max()),
        "outside": prefill_bad, "max_abs_logit": float(ref_prefill.abs().max())}
    summary["bf16_drift"] = {
        "max_abs_diff_per_step": [float(x) for x in d.amax(dim=(0, 2))],
        "outside": int((d > t["atol"] + t["rtol"] * ref.float().abs()).sum()),
        "n_logits": d.numel(),
        "greedy_equal": int((ref.argmax(-1) == run.tokens).sum()),
        "greedy_compared": run.tokens.numel(),
        "same_positions_longer_sequence": float(
            (ref[:, 0].float() - ref_prefill.float()).abs().max())}
    del d, d_prefill, ref, served
    if prefill_bad:
        raise AssertionError(f"serving {name}: bf16 prefill logits differ from "
                             f"the cache-free forward over the same prompt by up "
                             f"to {summary['bf16_prefill']['max_abs_diff']:.4f}, "
                             f"{prefill_bad} outside {t}")

    # fp32 cached against cache-free, with the planted faults.
    t0 = time.perf_counter()
    summary["fp32_check"] = serve_fp32_check(
        cfg, params, torch.cat([prompts, forced], dim=1), P, P + n_tokens, **stub)
    summary["fp32_check"]["s"] = time.perf_counter() - t0

    # One profiled decode step, from a fresh prefill and one warm step.
    batch = {"tokens": prompts, **stub}
    logits, cache = model.prefill(params, batch, max_len=P + n_tokens)
    tok = torch.argmax(logits[:, -1:], dim=-1)
    logits, cache = model.decode_step(params, {"tokens": tok, "pos": pre + P,
                                               "cache": cache})
    tok = torch.argmax(logits[:, -1:], dim=-1)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        logits, cache = model.decode_step(params, {"tokens": tok, "pos": pre + P + 1,
                                                   "cache": cache})
        torch.argmax(logits[:, -1:], dim=-1)
        torch.cuda.synchronize()
        prof_ms = (time.perf_counter() - t0) * 1e3
    rows, _ = device_times(prof.profiler.kineto_results.events(), spans.NAMES)
    busy = sum(r[0] for r in rows)
    summary["profiled_decode"] = {
        "wall_ms": prof_ms, "device_busy_ms": busy,
        "device_events": sum(r[1] for r in rows),
        "busy_share_of_median_step": busy / summary["decode_ms_median"],
        "busy_share_of_window_step": busy / summary["decode_window_ms_per_token"],
        "top_device_ops": [{"ms": ms, "count": count, "name": key[:120]}
                           for ms, count, key in rows[:5]]}
    # The recurrences' decode regimes: each layer's kernel once in the step,
    # and no launch of the chunked or sequential kernels.
    first = serve_launches(cfg, 1)
    for kernel, want, others in DECODE_KERNELS:
        n_step = serve_launches(cfg, 2)[kernel] - first[kernel]
        if not n_step:
            continue
        got = sum(count for _, count, key in rows if want in key)
        other = sum(count for _, count, key in rows if any(o in key for o in others))
        if got != n_step or other:
            raise AssertionError(f"serving {name}: a profiled decode step launched "
                                 f"{want} {got} times (expected {n_step}) and "
                                 f"{other} of {others}")
        summary["profiled_decode"][f"{want}_launches"] = got
    del logits, cache

    fp = summary["fp32_check"]
    log(f"serving {name} ({n_params} params) at batch {B}, prompt {P}, "
        f"{n_tokens} new tokens: prefill {run.prefill_ms:.1f} ms; decode "
        f"median {summary['decode_ms_median']:.2f} ms/token (p90 "
        f"{summary['decode_ms_p90']:.2f}); {summary['decode_tokens_per_s']:.0f} "
        f"tokens/s over {len(steps)} steps, each closed by a sync; the same "
        f"steps timed as one window closed by one sync: "
        f"{summary['decode_window_ms_per_token']:.2f} ms/token, "
        f"{summary['decode_window_tokens_per_s']:.0f} tokens/s; peak "
        f"{peak / 1e9:.2f} GB; launches "
        f"{json.dumps(launches)}; a profiled "
        f"decode step: device busy {busy:.3f} ms, "
        f"{summary['profiled_decode']['device_events']} device events, "
        f"{summary['profiled_decode']['busy_share_of_median_step']:.1%} of the "
        f"median step, "
        f"{summary['profiled_decode']['busy_share_of_window_step']:.1%} of the "
        f"window's per-token time")
    for op in summary["profiled_decode"]["top_device_ops"]:
        log(f"  decode step device time {op['ms']:.3f} ms ({op['ms'] / busy:.1%}), "
            f"{op['count']}x {op['name'][:80]}")
    log(f"  bf16 prefill vs the cache-free forward over the same prompt: max "
        f"|diff| {summary['bf16_prefill']['max_abs_diff']:.4f} (within {t}); "
        f"over the decode steps (not gated) up to "
        f"{max(summary['bf16_drift']['max_abs_diff_per_step']):.4f}, "
        f"{summary['bf16_drift']['outside']} of {summary['bf16_drift']['n_logits']} "
        f"outside; the longer cache-free forward at the prompt's last position "
        f"vs the prompt-only one: "
        f"{summary['bf16_drift']['same_positions_longer_sequence']:.4f}")
    log(f"  fp32 prefill + {FP32_DECODE_STEPS} forced decode steps vs the "
        f"cache-free forward: max |diff| {fp['max_abs_diff']:.3e} (within "
        f"{fp['tolerance']}); planted faults: "
        + "; ".join(f"{k}: raised {v['raised']!r}" if "raised" in v else
                    f"{k} {v['max_abs_diff']:.3e}, {v['outside']} outside"
                    for k, v in fp["faults"].items()))
    if cfg.is_moe:
        log(f"  fp32 check, MoE drops: {fp['drops']['cache_free']} dropped "
            f"(token, choice) pairs in the cache-free forward, "
            f"{fp['drops']['cached']} in the prefill and decode steps; "
            f"{fp['rows_left_out']} of {B} batch rows left out, "
            f"{fp['rows_compared']} compared")
    log(json.dumps({"serving": summary}))
    del params, model, run
    gc.collect()
    torch.cuda.empty_cache()
    return launches


def profile_step(trainer, loader, batch_of):
    """Where one steady step's device time goes: kernels by device time
    (torch.profiler), and the device's busy share of the step's wall time;
    the device time inside each of the program's ranges (``spans.NAMES``:
    the step's phases, the plain backwards). ``batch_of`` makes the step's
    batch of the loader's tokens. Runs after the launch counters were
    read."""
    from torch.profiler import ProfilerActivity, profile

    batch = batch_of(np.concatenate([loader.next_batch(i)
                                     for i in trainer.device_ids()]))
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        trainer.step(batch)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    rows, ranges = device_times(prof.profiler.kineto_results.events(), spans.NAMES)
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
    if "wkv6_fwd" in k or "wkv6_decode" in k:
        return "wkv6 kernel (forward and remat recompute)"
    if "ssd_fwd" in k or "ssd_chunked" in k or "ssd_decode" in k:
        return "ssd kernel (forward and remat recompute)"
    if "gemm" in k and "bf16" in k:
        return "bf16 GEMMs (projections, MLP, unembedding)"
    if "nvjet" in k:  # cuBLAS's Hopper GEMMs, which name no dtype
        return "cuBLAS nvjet GEMMs (the bf16 projections, MLP, unembedding)"
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
    batch = path_batch(cfg, tokens, np.random.default_rng(1))
    _, m_cpu = cpu.make_train_step()(state, batch)
    _, m_gpu = gpu.make_train_step()(gstate, batch)
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
        rows, _ = device_times(prof.profiler.kineto_results.events(), spans.NAMES)
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
    from repro_torch.kernels import cost

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
    flops, nbytes = cost.attention(B, S, S, H, H, hd, pairs)
    return dict(ms=k_ms, plain_ms=p_ms, library_ms=l_ms,
                bound=bound(nbytes, flops, PEAK_BF16_FLOPS))


def time_train_attention(fa, MaskSpec, gen, name, cfg, B, Skv=None, Sq=None,
                         kind=None):
    """The bf16 kernel at a training path's attention shape: batch ``B``,
    ``SEQ`` positions (a vlm's text behind its patches, under the prefix
    mask; causal otherwise) over ``Skv`` keys (default as many; more for a
    serving prefill into its cache, whose last rows the mask removes), or
    ``Sq`` queries under the mask ``kind`` (Whisper's encoder and
    cross-attention, full);
    beside it the plain version and ``scaled_dot_product_attention`` with
    the same mask as an explicit boolean mask (checked against the plain
    version at ``_tol``). The bound counts the (q, k) pairs the mask
    admits."""
    from repro_torch.kernels import cost
    from repro_torch.models.layers import _mask_block

    H, K, hd = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    pre = prefix_rows(cfg)
    S = SEQ + pre if Sq is None else Sq
    Skv = S if Skv is None else Skv
    kind = kind or ("prefix" if pre else "causal")
    bf16 = torch.bfloat16
    q = torch.randn((B, S, H, hd), generator=gen, device="cuda").to(bf16)
    k, v = (torch.randn((B, Skv, K, hd), generator=gen, device="cuda").to(bf16)
            for _ in range(2))
    scale = cfg.query_scale or hd ** -0.5
    spec = MaskSpec(kind, prefix_len=pre)
    mask = _mask_block(spec, torch.arange(S, device="cuda"),
                       torch.arange(Skv, device="cuda"))

    def kernel():
        return fa.flash_attention_kernel(q, k, v, scale=scale, kind=kind,
                                         prefix_len=pre)

    def plain():
        return fa.attention_plain(q, k, v, spec, scale=scale)

    def library():
        return torch.nn.functional.scaled_dot_product_attention(
            q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2),
            attn_mask=mask[None, None], scale=scale,
            enable_gqa=H != K).transpose(1, 2)

    want = plain().float()
    torch.testing.assert_close(kernel().float(), want, **tol(bf16))
    torch.testing.assert_close(library().float(), want, **tol(bf16))
    del want
    pairs = int(mask.sum())
    flops, nbytes = cost.attention(B, S, Skv, H, K, hd, pairs)
    return dict(model=name, shape=[B, S, Skv, H, K, hd], mask=kind, prefix=pre,
                admitted_pairs_per_head=pairs, ms=cuda_ms(kernel, 20),
                plain_ms=cuda_ms(plain, 5), library_ms=cuda_ms(library, 20),
                bound=bound(nbytes, flops, PEAK_BF16_FLOPS))


def time_attention_bwd(fa, gen, case):
    """The backward kernels (``flash_attention_bwd_kernel``: prep, dK/dV,
    dQ) at one shape of ``attention_bwd_cases``, beside the plain backward
    they replace (autograd of ``attention_plain`` on the bf16 leaves,
    recomputing its forward as ``kernels/ops.py`` does) and the library's:
    the backward of ``scaled_dot_product_attention`` over a graph kept for
    repeats, its gradients first checked within ``BWD_REL_TOL`` of the
    plain version's in fp32. The bound counts ``cost.attention_bwd`` over
    the pairs the mask admits."""
    from repro_torch.kernels import cost

    B, Sq, Skv, H, K, d, kind, window, prefix, softcap, dt = case
    if window or prefix or softcap:
        raise ValueError("time_attention_bwd: SDPA computes no window, prefix or softcap")
    scale = d ** -0.5
    q, k, v, do, o, lse = attention_bwd_inputs(fa, gen, case)

    def kernel():
        return fa.flash_attention_bwd_kernel(q, k, v, o, lse, do, scale=scale, kind=kind)

    def plain():
        return attention_plain_grads(fa, q, k, v, do, case)

    live = [t.transpose(1, 2).detach().requires_grad_(True) for t in (q, k, v)]
    do_t = do.transpose(1, 2)
    with torch.enable_grad():
        out = torch.nn.functional.scaled_dot_product_attention(
            *live, is_causal=kind == "causal", scale=scale, enable_gqa=H != K)

    def library():
        return torch.autograd.grad(out, live, do_t, retain_graph=True)

    want = attention_plain_grads(fa, q, k, v, do, case, torch.float32)
    for name, g, w in zip(("dq", "dk", "dv"), library(), want):
        rel = float((g.transpose(1, 2).float() - w).norm() / w.norm())
        if not rel <= BWD_REL_TOL:
            raise AssertionError(f"SDPA's backward {case[:7]}: {name} off the fp32 "
                                 f"autograd by {rel:.3e} of its norm")
    del want
    pairs = cost.admitted_pairs(kind, 0, 0, Sq, Skv)
    flops, nbytes = cost.attention_bwd(B, Sq, Skv, H, K, d, pairs)
    return dict(shape=[B, Sq, Skv, H, K, d], mask=kind, admitted_pairs_per_head=pairs,
                ms=cuda_ms(kernel, 20), plain_ms=cuda_ms(plain, 3, 1),
                library_ms=cuda_ms(library, 20),
                bound=bound(nbytes, flops, PEAK_BF16_FLOPS))


def time_wkv6(W, gen, shape):
    """At the RWKV-6 path's shape (global batch 8) and dtypes (fp32 r/k/v
    and decays)."""
    from repro_torch.kernels import cost

    args = wkv6_inputs(gen, *shape, torch.float32)
    k_ms = cuda_ms(lambda: W.wkv6_kernel(*args), 20)
    p_ms = cuda_ms(lambda: W.wkv6_plain(*args, chunk=64), 3, 1)
    # r, k, v, lw read, out written (fp32); u read; the final state written.
    # Per (b, t, h) and state element: S = e*S + k*v (mul + FMA), o += r*S
    # (FMA): 5 fp32 operations.
    flops, nbytes = cost.wkv6(*shape)
    return dict(ms=k_ms, plain_ms=p_ms, library_ms=None,
                bound=bound(nbytes, flops, PEAK_FP32_FLOPS))


def time_ssd(SD, gen, shape):
    """At the Zamba2 path's shape (global batch 8) and dtypes (bf16 x/B/C,
    fp32 dt)."""
    from repro_torch.kernels import cost

    args = ssd_inputs(gen, *shape, torch.bfloat16)
    k_ms = cuda_ms(lambda: SD.ssd_kernel(*args), 20)
    p_ms = cuda_ms(lambda: SD.ssd_plain(*args, chunk=64), 3, 1)
    # x read (bf16), y written (fp32); dt, A_log read (fp32), B and C read
    # (bf16); the final state written. The chunked form's products, at the
    # bf16 tensor-core peak (``cost.ssd``). (Counted as the recurrence's
    # 5·P·N fp32 operations per step at 67 TFLOP/s they gave 0.160 ms,
    # which is not the work the bf16 kernel does.) The bytes bound it
    # either way.
    flops, nbytes = cost.ssd(*shape)
    return dict(ms=k_ms, plain_ms=p_ms, library_ms=None,
                bound=bound(nbytes, flops, PEAK_BF16_FLOPS))


#: Cycles of the device-side wait ``_per_launch`` queues ahead of the
#: launches it times: about 0.2 s at the H100's clocks.
QUEUE_WAIT_CYCLES = 400_000_000


def _per_launch(fn, sets, reps=5):
    """``fn`` over every input set of ``sets``, ``reps`` passes, as a decode
    step runs a kernel once per layer, each on its own layer's tensors (so
    each launch finds its inputs outside the L2 cache). Returns (device ms
    per launch, the CUDA-event window per launch, host dispatch included).

    For the device time the passes queue up behind a device-side wait
    (``torch.cuda._sleep``): the events then time the launches back to
    back, not the host that issues them. If the host's enqueue outlasts the
    wait, the device time is None (not measured)."""
    def one_pass():
        for args in sets:
            fn(*args)

    one_pass()
    torch.cuda.synchronize()
    wait, start, end = (torch.cuda.Event(enable_timing=True) for _ in range(3))
    wait.record()
    torch.cuda._sleep(QUEUE_WAIT_CYCLES)
    start.record()
    t0 = time.perf_counter()
    for _ in range(reps):
        one_pass()
    end.record()
    enqueue_ms = (time.perf_counter() - t0) * 1e3
    torch.cuda.synchronize()
    device = start.elapsed_time(end) / (reps * len(sets))
    if enqueue_ms >= wait.elapsed_time(start):
        device = None
    return device, cuda_ms(one_pass, reps, 1) / len(sets)


def time_decode_attention(fa, MaskSpec, gen, name, cfg, B, P, n_tokens,
                          window=0, n_sets=None, cross=False, old=None):
    """The bf16 kernel at a serving run's decode shape (batch ``B``, a cache
    of ``P + n_tokens``), one query row over the whole cache at the middle
    of the decode's positions, with the config's scale and softcap and the
    layer's ``window``, on one cache per layer (``n_sets``; default the
    config's layers, or Zamba2's applications of its shared block); with
    ``cross``, an encdec decode step's cross-attention instead: one query
    row over the ``enc_len`` rows of the cross cache, full; beside
    it the plain version and ``scaled_dot_product_attention`` with the same
    mask (checked against the plain version at ``_tol``), which has no
    softcap (None for a config with one). The bound counts the cache rows
    the mask admits. Beside the times: the decode regime's ``n_split``, its
    CTAs (and the merge's), and the share of the card's memory rate that
    the bound's bytes reach at the kernel's time; with a baseline library
    ``old`` (``--baseline``), that checkout's kernel on the same sets, in
    turns with this one's (baseline, kernel, kernel, baseline)."""
    from repro_torch.kernels import cost
    from repro_torch.models import zamba2

    H, K, hd = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    if n_sets is None:
        n_sets = zamba2.n_shared_apps(cfg) if cfg.family == "hybrid" else cfg.n_layers
    cache_len = cfg.enc_len if cross else prefix_rows(cfg) + P + n_tokens
    q_offset = 0 if cross else prefix_rows(cfg) + P + n_tokens // 2
    kind = "full" if cross else "causal"
    bf16 = torch.bfloat16
    sets = [(torch.randn((B, 1, H, hd), generator=gen, device="cuda").to(bf16),
             torch.randn((B, cache_len, K, hd), generator=gen, device="cuda").to(bf16),
             torch.randn((B, cache_len, K, hd), generator=gen, device="cuda").to(bf16))
            for _ in range(n_sets)]
    scale = cfg.query_scale or hd ** -0.5
    softcap = cfg.attn_softcap
    spec = MaskSpec(kind, window=window)
    rows = torch.arange(cache_len, device="cuda")
    admitted = (rows <= q_offset) | cross
    if window:
        admitted &= q_offset - rows < window
    mask = admitted[None, None, None, :]

    def kernel(q, k, v):
        return fa.flash_attention_kernel(q, k, v, scale=scale, softcap=softcap,
                                         kind=kind, window=window, q_offset=q_offset)

    def plain(q, k, v):
        return fa.attention_plain(q, k, v, spec, scale=scale, softcap=softcap,
                                  q_offset=q_offset)

    gqa = {"enable_gqa": True} if H != K else {}

    def library(q, k, v):
        return torch.nn.functional.scaled_dot_product_attention(
            q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2),
            attn_mask=mask, scale=scale, **gqa).transpose(1, 2)

    q, k, v = sets[0]
    want = plain(q, k, v).float()
    torch.testing.assert_close(kernel(q, k, v).float(), want, **tol(bf16))
    ms, window_ms = _per_launch(kernel, sets)
    baseline = {}
    if old is not None:
        out = torch.empty_like(q)

        def base(q, k, v):
            baseline_attention(old, q, k, v, out, scale, softcap, kind, window, 0,
                               q_offset)

        base(q, k, v)
        torch.testing.assert_close(out.float(), want, **tol(bf16))
        b1, n1, n2, b2 = (_per_launch(fn, sets)[0] for fn in (base, kernel, kernel, base))
        if None not in (b1, n1, n2, b2):
            baseline = dict(baseline_ms=(b1 + b2) / 2, turns_ms=(n1 + n2) / 2)
    plain_ms, plain_window = _per_launch(plain, sets, reps=1)
    library_ms = library_window = None
    if not softcap:
        torch.testing.assert_close(library(q, k, v).float(), plain(q, k, v).float(),
                                   **tol(bf16))
        library_ms, library_window = _per_launch(library, sets)
    n_kv = int(admitted.sum())
    flops, nbytes = cost.attention(B, 1, cache_len, H, K, hd, n_kv, kv_rows=n_kv)
    n_split = fa.decode_split_plan(B, 1, cache_len, K, kind, window, 0, q_offset).n_split
    del sets
    return dict(model=name, shape=[B, 1, cache_len, H, K, hd], mask=kind,
                q_offset=q_offset, window=window, softcap=softcap, scale=scale, admitted_rows=n_kv,
                regime=fa.regime(bf16, 1, H, K), n_split=n_split, ctas=B * K * n_split,
                merge_ctas=B * H if n_split > 1 else 0,
                bytes_rate_share=None if ms is None else nbytes / (ms * 1e-3) / PEAK_BYTES_PER_S,
                ms=ms, window_ms=window_ms, plain_ms=plain_ms,
                plain_window_ms=plain_window, library_ms=library_ms,
                library_window_ms=library_window, **baseline,
                bound=bound(nbytes, flops, PEAK_BF16_FLOPS))


def _launch_floor(sets):
    """Device ms per launch of a kernel that does next to nothing (one
    float zeroed), in ``_per_launch``'s loop over as many sets: what a
    launch costs the decode timings before any work."""
    one = torch.zeros(1, device="cuda")
    return _per_launch(lambda *a: one.zero_(), sets)[0]


def _decode_turns(old_fn, new_fn, sets):
    """Device ms per launch of ``old_fn`` and ``new_fn`` over ``sets``, in
    turns (old, new, new, old): the mean of each pair, None if a turn's
    device time was not measured."""
    o1, n1, n2, o2 = (_per_launch(fn, sets)[0] for fn in (old_fn, new_fn, new_fn, old_fn))
    if None in (o1, n1, n2, o2):
        return None, None
    return (o1 + o2) / 2, (n1 + n2) / 2


def _step_sweep(make_sets, launch, others, name):
    """The decode regime against the kernel ``others[dtype]`` (the chunked
    or sequential one) through ``launch(kind, *args)`` at each of
    ``DECODE_STEP_SWEEP``, in turns, one input set per layer, for each
    dtype: the step counts ``DECODE_MAX_STEPS`` is set from."""
    sweep = []
    for dtype, other in others.items():
        for S in DECODE_STEP_SWEEP:
            sets = make_sets(S, dtype)
            old_ms, new_ms = _decode_turns(lambda *a: launch(other, *a),
                                           lambda *a: launch("decode", *a), sets)
            sweep.append({"dtype": str(dtype)[6:], "S": S, "decode_ms": new_ms,
                          f"{other}_ms": old_ms})
            log(f"{name} {str(dtype)[6:]} at S={S}: decode regime {_ms(new_ms)}, "
                f"the {other} kernel {_ms(old_ms)} per launch")
            del sets
    return sweep


def time_decode_wkv6(W, gen, old=None):
    """The kernel at RWKV-6's decode shape, one step from a carried state,
    fp32 r/k/v as the run gives them, on one state per layer; beside it the
    plain version. No library call computes the recurrence. In turns with
    it: this tree's sequential kernel at S = 1 (the old path, through
    ``repro_wkv6_fwd``), and with a baseline library ``old`` that
    checkout's; then both regimes at each of ``DECODE_STEP_SWEEP``, fp32
    and bf16 r/k/v."""
    from repro_torch.configs import get_config
    from repro_torch.kernels import build
    from repro_torch.kernels import cost

    cfg = get_config("rwkv6-1.6b")
    B, H, hd = SERVE_BATCH, cfg.n_heads, cfg.head_dim
    f32 = torch.float32

    def make_sets(S, dtype=f32):
        return [wkv6_inputs(gen, B, S, H, hd, dtype, decay="init", state=True)
                for _ in range(cfg.n_layers)]

    def sequential(*a):
        return W.wkv6_launch("sequential", *a)

    sets = make_sets(1)
    if W.regime(f32, 1) != "decode":
        raise AssertionError("wkv6: a decode step does not take the decode regime")
    for got, want in zip(W.wkv6_kernel(*sets[0]), sequential(*sets[0])):
        torch.testing.assert_close(got, want, **rec_tol(f32))
    ms, window = _per_launch(W.wkv6_kernel, sets)
    floor_ms = _launch_floor(sets)
    old_ms, turns_ms = _decode_turns(sequential, W.wkv6_kernel, sets)
    baseline = {}
    if old is not None:
        out = torch.empty((B, 1, H, hd), dtype=f32, device="cuda")
        sf = torch.empty((B, H, hd, hd), dtype=f32, device="cuda")

        def base(r, k, v, lw, u, st):
            build.check(old.repro_wkv6_fwd(
                r.data_ptr(), k.data_ptr(), v.data_ptr(), lw.data_ptr(),
                u.data_ptr(), st.data_ptr(), out.data_ptr(), sf.data_ptr(), 0, B,
                1, H, hd, torch.cuda.current_stream().cuda_stream), "baseline wkv6")

        base(*sets[0])
        torch.testing.assert_close(out, W.wkv6_kernel(*sets[0])[0], **rec_tol(f32))
        b_ms, n_ms = _decode_turns(base, W.wkv6_kernel, sets)
        baseline = dict(baseline_ms=b_ms, baseline_turns_ms=n_ms)
    plain_ms, plain_window = _per_launch(lambda *a: W.wkv6_plain(*a, chunk=64),
                                         sets, reps=1)
    del sets
    steps = _step_sweep(make_sets, W.wkv6_launch,
                        {f32: "sequential", torch.bfloat16: "sequential"}, "wkv6")
    # r, k, v, lw read, out written; u read; the state read and written.
    flops, nbytes = cost.wkv6(B, 1, H, hd, state_in=True)
    return dict(shape=[B, 1, H, hd], regime=W.regime(f32, 1),
                decode_max_steps=W.DECODE_MAX_STEPS,
                ctas=B * H * (2 if hd == 64 else 1),
                bytes_rate_share=None if ms is None else nbytes / (ms * 1e-3) / PEAK_BYTES_PER_S,
                ms=ms, window_ms=window, turns_ms=turns_ms, old_path_ms=old_ms,
                launch_floor_ms=floor_ms, **baseline, plain_ms=plain_ms, plain_window_ms=plain_window,
                library_ms=None, steps=steps,
                bound=bound(nbytes, flops, PEAK_FP32_FLOPS))


def time_decode_ssd(SD, gen, old=None):
    """The kernel at Zamba2's decode shape, one step from a carried state,
    bf16 x/B/C as the views ``block_apply`` passes, on one state per layer;
    beside it the plain version (at the chunk ``ops.ssd`` gives it). No
    library call computes the scan. The bound counts the recurrence's fp32
    work. In turns with it: this tree's chunked kernel at S = 1 (the old
    path through ``repro_ssd_fwd``, with the three copies its wrapper makes
    of the views), the same kernel on contiguous copies made beforehand
    (the kernel alone), and with a baseline library ``old`` that
    checkout's kernel on those copies; then the decode regime against the
    chunked (bf16) and sequential (fp32) kernels at each of
    ``DECODE_STEP_SWEEP``."""
    from repro_torch.configs import get_config
    from repro_torch.kernels import build
    from repro_torch.kernels import cost
    from repro_torch.models import mamba2

    cfg = get_config("zamba2-1.2b")
    _, H, P, N = mamba2._dims(cfg)
    B = SERVE_BATCH
    bf16 = torch.bfloat16

    def make_sets(S, dtype=bf16):
        return [ssd_inputs(gen, B, S, H, P, N, dtype, state=True, strided=True)
                for _ in range(cfg.n_layers)]

    def chunked(*a):
        return SD.ssd_launch("chunked", *a)

    sets = make_sets(1)
    if SD.regime(bf16, 1) != "decode":
        raise AssertionError("ssd: a decode step does not take the decode regime")
    for got, want in zip(SD.ssd_kernel(*sets[0]), chunked(*sets[0])):
        torch.testing.assert_close(got, want, **rec_tol(bf16))
    ms, window = _per_launch(SD.ssd_kernel, sets)
    floor_ms = _launch_floor(sets)
    old_ms, turns_ms = _decode_turns(chunked, SD.ssd_kernel, sets)
    copies = [tuple(t.contiguous() for t in a[:5]) + a[5:] for a in sets]
    old_kernel_ms, _ = _decode_turns(chunked, SD.ssd_kernel, copies)
    baseline = {}
    if old is not None:
        y = torch.empty((B, 1, H, P), dtype=torch.float32, device="cuda")
        hf = torch.empty((B, H, P, N), dtype=torch.float32, device="cuda")

        def base(x, dt, A_log, Bm, Cm, st):
            build.check(old.repro_ssd_fwd(
                x.data_ptr(), dt.data_ptr(), A_log.data_ptr(), Bm.data_ptr(),
                Cm.data_ptr(), st.data_ptr(), y.data_ptr(), hf.data_ptr(), 1, B, 1,
                H, P, N, torch.cuda.current_stream().cuda_stream), "baseline ssd")

        base(*copies[0])
        torch.testing.assert_close(y, SD.ssd_kernel(*sets[0])[0], **rec_tol(bf16))
        b_ms, n_ms = _decode_turns(base, SD.ssd_kernel, copies)
        baseline = dict(baseline_ms=b_ms, baseline_turns_ms=n_ms)
    del copies
    plain_ms, plain_window = _per_launch(lambda *a: SD.ssd_plain(*a, chunk=64),
                                         sets, reps=1)
    del sets
    steps = _step_sweep(make_sets, SD.ssd_launch,
                        {bf16: "chunked", torch.float32: "sequential"}, "ssd")
    # x, B, C read (bf16), dt and A_log read, y written (fp32); the state
    # read and written (fp32). Per state element: h = a*h + (dt*x)*B (mul,
    # FMA), y += C*h (FMA).
    flops, nbytes = cost.ssd(B, 1, H, P, N, state_in=True)
    return dict(shape=[B, 1, H, P, N], regime=SD.regime(bf16, 1),
                decode_max_steps=SD.DECODE_MAX_STEPS,
                ctas=-(-B * H * (P // 8) * (N // 4) // 128),
                bytes_rate_share=None if ms is None else nbytes / (ms * 1e-3) / PEAK_BYTES_PER_S,
                ms=ms, window_ms=window, turns_ms=turns_ms, old_path_ms=old_ms,
                old_kernel_ms=old_kernel_ms, launch_floor_ms=floor_ms, **baseline, plain_ms=plain_ms,
                plain_window_ms=plain_window, library_ms=None, steps=steps,
                bound=bound(nbytes, flops, PEAK_FP32_FLOPS))


def open_baseline(csrc):
    """The kernel library built from another checkout's ``csrc`` (same C
    interface), with the entry points ``time_baseline*`` call."""
    from repro_torch.kernels import build

    t0 = time.perf_counter()
    old = build.open_library(build.build(csrc), names=(
        "repro_ssd_fwd", "repro_wkv6_fwd", "repro_shard_encode", "repro_shard_decode"))
    # The attention entry took n_split and a workspace from the decode regime
    # on; an earlier checkout's takes neither (18 arguments). ``takes_split``
    # is the one record of which, for ``baseline_attention``.
    # From the backward kernels on it also takes an lse pointer before the
    # stream; ``takes_lse`` records which.
    source = (pathlib.Path(csrc) / "flash_attention.cu").read_text()
    old.takes_split = "int n_split" in source
    old.takes_lse = "void* lse" in source
    sig = list(build.SIGNATURES["repro_flash_attention_fwd"])
    if not old.takes_lse:
        sig = sig[:-2] + sig[-1:]
    old.repro_flash_attention_fwd.argtypes = sig if old.takes_split else sig[:-3] + sig[-1:]
    old.repro_flash_attention_fwd.restype = ctypes.c_int
    log(f"baseline build from {csrc}: {time.perf_counter() - t0:.1f} s")
    return old


def baseline_attention(old, q, k, v, out, scale, softcap=0.0, kind="causal",
                       window=0, prefix_len=0, q_offset=0):
    """The baseline checkout's attention into ``out``, through its C entry:
    without the split arguments where it has none, else with this
    checkout's ``decode_split_plan`` in the decode regime."""
    from repro_torch.kernels import build
    from repro_torch.kernels import flash_attention as fa

    B, Sq, H, hd = q.shape
    Skv, K = k.shape[1], k.shape[2]
    split, ws = [], None
    if old.takes_split:
        n = 1
        if fa.regime(q.dtype, Sq, H, K) == "decode":
            n = fa.decode_split_plan(B, Sq, Skv, K, kind, window, prefix_len,
                                     q_offset).n_split
            size = fa.decode_workspace_floats(B, Sq, H, K, hd, n)
            ws = torch.empty(size, dtype=torch.float32, device=q.device) if size else None
        split = [n, None if ws is None else ws.data_ptr()]
    build.check(old.repro_flash_attention_fwd(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
        1 if q.dtype == torch.bfloat16 else 0, B, Sq, Skv, H, K, hd, scale, softcap,
        {"causal": 0, "full": 1, "prefix": 2}[kind], window, prefix_len, q_offset,
        *split, *([None] if old.takes_lse else []),
        torch.cuda.current_stream().cuda_stream), "baseline attention")


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
        baseline_attention(old, q, k, v, out, hd ** -0.5)

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


# ---------------------------------------------------------------------------
# Phase 6: the simulator substrate (host Python; no kernel).
# ---------------------------------------------------------------------------

MiB = 1024 * 1024
#: The paper's state profiles (``benchmarks/common.py``: GPT-2 and
#: ResNet-101): (name, training-state bytes, typical tensor bytes).
SIM_PROFILES = (("gpt2", 468 * MiB, 4 * MiB), ("resnet101", 178 * MiB, 2 * MiB))
SIM_NODES = (6, 8, 10, 12)
SIM_SEEDS = (0, 1, 2, 3)
SIM_CODECS = ("none", "int8")
#: The pinned charge for Algorithm 1+2 on the virtual clock in the digest's
#: sweep (``ChaosScheduler.solver_time_model``); the tables measure it.
SIM_SOLVER_S = 1e-3
#: Virtual seconds of each monitor run, and its injected 30% link loss.
SIM_MONITOR_S = 60.0
SIM_LOSS = 0.3

#: sha256 of ``simulator_sweep``'s canonical JSON; tests/test_torch_simulator.py
#: runs the sweep through the JAX package and holds it to this value, so the
#: port's substrate on the GPU machine is held to the reference without JAX.
SIMULATOR_DIGEST = (
    "19a1d4dfc3503acd262002255826619b8d1ffef82314b39cf03cddfd2fc4e8ad")


def sim_tensor_sizes(state_bytes, typ):
    """``benchmarks/common.tensor_sizes_for``."""
    n = max(4, state_bytes // typ)
    sizes = [typ] * n
    rest = state_bytes - typ * n
    if rest > 0:
        sizes.append(rest)
    return sizes


def sim_join_links(core, topo, n_links, seed):
    """``benchmarks/common.join_links``: ``n_links`` random peers of the
    active nodes, each link drawn at 100-1000 Mbit/s and 1-20 ms."""
    import random

    rng = random.Random(seed)
    peers = rng.sample(sorted(topo.active_nodes()),
                       min(n_links, len(topo.active_nodes())))
    return {p: core.topology.Link(rng.uniform(100, 1000), rng.uniform(0.001, 0.02))
            for p in peers}


def _plan_record(plan):
    return {"summary": plan.summary(),
            "routes": {str(u): r for u, r in sorted(plan.routes.items())}}


def _scale_out_record(res):
    if hasattr(res, "breakdown"):  # Pollux: stop-resume, no plan
        return {"delay_s": res.delay_s, "idle_s": res.idle_s,
                "breakdown": res.breakdown}
    return {"delay_s": res.delay_s, "replication_s": res.replication_s,
            "solver_s": res.solver_s, "idle_s": res.idle_s,
            "timeline": res.timeline, "replans": res.replans,
            **_plan_record(res.plan)}


def _primitive_record(res):
    return {"delay_s": res.delay_s, "wall_s": res.wall_s,
            "timeline": res.timeline, "detection_s": res.detection_s}


def sim_scale_outs(core, solver_s):
    """Every profile, cluster size, seed, strategy of ``baselines.STRATEGIES``
    and codec: a join over 3 links after two iterations, as
    ``benchmarks/common.measure_scale_out`` draws it. ``solver_s`` pins
    the planner's charge; None measures it. Yields (key, result)."""
    B = core.baselines
    for name, state, typ in SIM_PROFILES:
        sizes = sim_tensor_sizes(state, typ)
        for n in SIM_NODES:
            for seed in SIM_SEEDS:
                for strategy in B.STRATEGIES:
                    for codec in SIM_CODECS:
                        topo = core.topology.random_edge_topology(n, seed=seed)
                        cl = B.make_cluster(topo, state_bytes=state,
                                            tensor_sizes=sizes,
                                            strategy=strategy, codec=codec)
                        cl.scheduler.solver_time_model = solver_s
                        cl.train(2)
                        new = 1000 + seed
                        links = sim_join_links(core, topo, 3, seed + 7)
                        _, _, res = B.run_scale_out(cl, strategy, new, links,
                                                    state)
                        yield (name, n, seed, strategy, codec), res


def sim_primitives(core, n, seed):
    """Scale-in, connect-link and disconnect-link on one topology, as
    tests/test_simulator.py runs them, and the topology's snapshot after."""
    name, state, typ = SIM_PROFILES[0]
    topo = core.topology.random_edge_topology(n, seed=seed)
    cl = core.baselines.make_cluster(topo, state_bytes=state,
                                     tensor_sizes=sim_tensor_sizes(state, typ),
                                     strategy="chaos")
    cl.train(1)
    victim = [u for u in topo.active_nodes() if u != cl.scheduler.node][0]
    out = {"scale_in": _primitive_record(cl.scale_in(victim))}
    nodes = topo.active_nodes()
    u, v = nodes[0], nodes[-1]
    if topo.has_link(u, v):
        topo.remove_link(u, v)
    out["connect_link"] = _primitive_record(
        cl.connect_link(u, v, core.topology.Link(500, 0.005)))
    out["disconnect_link"] = _primitive_record(cl.disconnect_link(u, v))
    out["snapshot"] = topo.snapshot()
    return out


def sim_monitor_run(core, detector, seed):
    """The cluster monitor on an 8-node topology after one iteration:
    sweeps started with ``seed``, then a silent node fault 5 s later, a
    blackholed link at 10 s and ``SIM_LOSS`` loss on another link at 15 s,
    run for ``SIM_MONITOR_S`` virtual seconds; detections scale in and
    disconnect through the scheduler. Returns the event records and
    counters."""
    name, state, typ = SIM_PROFILES[0]
    topo = core.topology.random_edge_topology(8, seed=seed)
    cl = core.baselines.make_cluster(topo, state_bytes=state,
                                     tensor_sizes=sim_tensor_sizes(state, typ),
                                     strategy="chaos")
    cl.train(1)
    mon = cl.scheduler.monitor
    mon.start_sweeps(seed=seed, detector=detector)
    victim = max(u for u in topo.active_nodes() if u != cl.scheduler.node)
    edges = sorted((min(a, b), max(a, b)) for a, b in topo.g.edges
                   if victim not in (a, b))
    t0 = cl.sim.now
    cl.sim.at(t0 + 5.0, lambda: mon.inject_node_fault(victim))
    cl.sim.at(t0 + 10.0, lambda: mon.inject_link_fault(*edges[0]))
    cl.sim.at(t0 + 15.0, lambda: mon.inject_link_loss(*edges[-1], SIM_LOSS))
    cl.sim.run(until=t0 + SIM_MONITOR_S)
    return {"events": [[e.t, e.kind, list(e.subject), e.detail]
                       for e in mon.events],
            "monitor": mon.metrics_snapshot(),
            "network": cl.net.metrics_snapshot(),
            "snapshot": topo.snapshot()}


def sim_pod_plans(core):
    """The multi-source plan into every host of ``pod_topology(32)``: its
    routes cross ties that only the bidirectional search breaks as the
    reference does."""
    name, state, typ = SIM_PROFILES[0]
    topo = core.topology.pod_topology(32)
    sizes = sim_tensor_sizes(state, typ)
    return [_plan_record(core.plans.build_plan("multi-source", topo, new,
                                               state, sizes))
            for new in range(32)]


def simulator_sweep(core):
    """The substrate's deterministic outputs through ``core``, a namespace
    holding the ``topology``, ``baselines`` and ``plans`` modules of either
    package: the scale-out sweep with the planner's charge pinned, the
    primitives and reshuffled snapshot of every topology, a monitor run
    per detector and the pod plans."""
    out = {"scale_outs": {"|".join(map(str, key)): _scale_out_record(res)
                          for key, res in sim_scale_outs(core, SIM_SOLVER_S)}}
    for n in SIM_NODES:
        for seed in SIM_SEEDS:
            prim = sim_primitives(core, n, seed)
            topo = core.topology.random_edge_topology(n, seed=seed)
            core.topology.reshuffle_bandwidths(topo, seed=seed + 100)
            prim["reshuffled"] = topo.snapshot()
            out[f"topology|{n}|{seed}"] = prim
    for detector in ("phi", "fixed"):
        out[f"monitor|{detector}"] = sim_monitor_run(core, detector, seed=0)
    out["pod_multi_source"] = sim_pod_plans(core)
    return out


def sweep_digest(sweep):
    blob = json.dumps(sweep, sort_keys=True, separators=(",", ":"))
    return hashlib.sha256(blob.encode()).hexdigest()


def simulator_phase(ops, gpt2_leaf_bytes, codec_times):
    """Phase 6: the port's simulator substrate on this host. The pinned
    sweep's digest; the paper's tables with the planner's time measured
    (virtual seconds from the simulator, not card time); a join of GPT-2's
    fp32 state under int8 beside the codec kernels' device time. Launches
    no kernel."""
    import statistics

    from repro_torch.core import baselines, codec, plans, topology
    from repro_torch import core

    for name in BLOCKED:
        if sys.modules.get(name) is not None:  # None: blocked, not imported
            raise AssertionError(f"the simulator phase imported {name}")
    before = dict(ops.launches)
    t0 = time.perf_counter()
    digest = sweep_digest(simulator_sweep(core))
    if digest != SIMULATOR_DIGEST:
        raise AssertionError(f"simulator sweep digest {digest} != "
                             f"SIMULATOR_DIGEST {SIMULATOR_DIGEST}")
    t_digest = time.perf_counter() - t0

    t1 = time.perf_counter()
    delays, idles, solver = {}, {}, []
    for (name, n, seed, strategy, cname), res in sim_scale_outs(core, None):
        if cname != "none":
            continue
        key = f"{name}|{strategy}|{n}"
        delays.setdefault(key, []).append(res.delay_s)
        idles.setdefault(key, []).append(sum(res.idle_s.values()))
        if strategy != "pollux":
            solver.append(res.solver_s)
    table_i = {"scale_in": 0.0, "connect_link": 0.0, "disconnect_link": 0.0}
    for n in SIM_NODES:
        for seed in SIM_SEEDS:
            prim = sim_primitives(core, n, seed)
            for k in table_i:
                table_i[k] = max(table_i[k], prim[k]["delay_s"])
    for k, d in table_i.items():
        if not d < 1e-3:
            raise AssertionError(f"{k} took {d} virtual s, not under 1 ms")
    t_tables = time.perf_counter() - t1

    state = sum(gpt2_leaf_bytes)
    topo = topology.random_edge_topology(8, seed=0)
    cl = baselines.make_cluster(topo, state_bytes=state,
                                tensor_sizes=gpt2_leaf_bytes,
                                strategy="chaos", codec="int8")
    cl.train(2)
    res = cl.scale_out(1000, sim_join_links(core, topo, 3, 7))
    join = {
        "state_bytes": state, "leaves": len(gpt2_leaf_bytes),
        "delay_s": res.delay_s, "replication_s": res.replication_s,
        "sources": len(res.plan.sources),
        "model_encode_s": codec.encode_s("int8", state),
        "model_decode_s": codec.decode_s("int8", state),
        "model_stream_encode_s": max(codec.encode_s(res.plan.codec_for(u), b)
                                     for u, b in res.plan.sources.items()),
        "model_stream_decode_s": max(codec.decode_s(res.plan.codec_for(u), b)
                                     for u, b in res.plan.sources.items()),
        "card_encode_device_ms": codec_times[0].get("device_ms"),
        "card_decode_device_ms": codec_times[1].get("device_ms"),
    }
    if dict(ops.launches) != before:
        raise AssertionError(f"the simulator phase launched kernels: "
                             f"{before} -> {dict(ops.launches)}")
    summary = {
        "digest": digest, "digest_s": t_digest, "tables_s": t_tables,
        "host_s": time.perf_counter() - t0,
        "virtual_mean_delay_s": {k: statistics.fmean(v) for k, v in delays.items()},
        "virtual_mean_idle_s": {k: statistics.fmean(v) for k, v in idles.items()},
        "virtual_table_i_max_s": table_i,
        "solver_s_median": statistics.median(solver),
        "solver_s_max": max(solver), "solver_runs": len(solver),
        "gpt2_int8_join": join,
    }
    log(f"simulator substrate: digest {digest} held; Table I (virtual s) "
        f"{json.dumps(table_i)}; solver_s median {summary['solver_s_median']:.6f} "
        f"max {summary['solver_s_max']:.6f} over {len(solver)} plans; "
        f"GPT-2 int8 join {res.delay_s:.4f} virtual s, modelled encode "
        f"{join['model_encode_s']:.4f} s / decode {join['model_decode_s']:.4f} s "
        f"for the whole state against the card's {_ms(join['card_encode_device_ms'])}"
        f" / {_ms(join['card_decode_device_ms'])}; host {summary['host_s']:.1f} s")
    return summary


# ---------------------------------------------------------------------------
# Phase 7: the simulator's churn backend (host Python; no kernel).
# ---------------------------------------------------------------------------

#: ``ledger.digest()`` of the seeded omniscient poisson replay
#: (``tests/test_resharding.py:PRE_RESHARD_DIGEST``), copied here so the GPU
#: machine holds the port's replay to the reference without JAX.
PRE_RESHARD_DIGEST = (
    "42f38e8cb5bb947daed699b7ee21d07c4aba991dbfb783a8978debd726bab42b")
#: (b): every generator family on the GPT-2 profile on one overlay.
CHURN_NODES = 12
CHURN_SEED = 3
CHURN_POLICIES = ("fixed", "adaptive")
#: Each family's arguments past ``seed``, from the JAX test that generates
#: it, and whether it takes the topology or its sorted active nodes.
CHURN_FAMILY_ARGS = {
    # tests/test_scenarios.py:28-37
    "poisson-churn": ("nodes", {"horizon_s": 600.0}),
    "diurnal-waves": ("nodes", {"horizon_s": 600.0, "period_s": 120.0}),
    "regional-partition": ("topo", {"t_cut": 10.0, "heal_after_s": 30.0}),
    "flash-crowd": ("nodes", {"t_start": 3.0, "n_joins": 12}),
    "link-flaps": ("topo", {"horizon_s": 600.0, "n_flaps": 9}),
    "adversarial-churn": ("nodes", {"horizon_s": 600.0, "n_joins": 6}),
    "bandwidth-degradation": ("nodes", {"horizon_s": 600.0, "n_joins": 5,
                                        "restore_after_s": 10.0}),
    "checkpointed-training": ("nodes", {"horizon_s": 600.0}),
    # tests/test_detection.py:471 (_silent_trace)
    "silent-failures": ("topo", {"horizon_s": 30.0, "n_node_faults": 2,
                                 "n_link_faults": 2, "n_lossy_links": 1,
                                 "loss_rate": 0.6, "n_joins": 1}),
    # tests/test_goodput.py:55
    "detector-stress": ("topo", {"horizon_s": 60.0}),
    # tests/test_failover.py:126 (_failover_trace)
    "scheduler-churn": ("topo", {"horizon_s": 40.0, "t_fault": 12.0,
                                 "n_joins_before": 2, "n_joins_after": 1}),
    # tests/test_resharding.py:394
    "reshard-churn": ("nodes", {"n_failures": 4, "n_joins": 0}),
    # tests/test_recovery_policy.py:195
    "mixed-faults": ("topo", {"horizon_s": 200.0}),
}
#: reshard-churn's state: its test's own (tests/test_resharding.py:390),
#: 64 MiB in 2 MiB tensors. On the GPT-2 profile the reference's
#: ``plans.reshard_plan`` cuts the state at boundaries whose gcd is 1 byte,
#: so one fetch becomes a list of about 2e8 one-byte shards: a replay then
#: takes about 20 s and 15 GB of host memory in either package.
RESHARD_STATE = (64 * MiB, 2 * MiB)
#: Engine settings past the policy for the families that need them.
CHURN_FAMILY_KW = {"checkpointed-training": {"checkpoint": "adaptive"},
                   "mixed-faults": {"checkpoint": "adaptive"},
                   "reshard-churn": {"reshard": "auto"}}
#: (c): ``benchmarks/goodput.py``'s churn sweep at its own sizes.
GOODPUT_NODES = 12
GOODPUT_STATE = 16 * MiB
GOODPUT_TENSOR = 1 * MiB
GOODPUT_HORIZON_S = 600.0
GOODPUT_RATES = (0.005, 0.01, 0.02, 0.04, 0.08)
GOODPUT_SEEDS = (3, 7, 11)
#: The paper's bound on scale-in, connect-link and disconnect-link handling.
HANDLING_BOUND_S = 0.020

#: sha256 of ``churn_sweep``'s canonical JSON; tests/test_torch_churn_sim.py
#: runs the sweep through the JAX package and holds it to this value.
CHURN_DIGEST = (
    "c2d24843df26195ed2b48cd41ec2f7b665ccf81a0c34256bcec7d1fbe454e858")


def churn_modules(package):
    """The namespace ``churn_sweep`` reads: ``engine``, ``topology``,
    ``baselines``, ``scenarios``, ``goodput``, ``telemetry`` and
    ``recovery`` of ``package`` (``"repro_torch"``, or the reference's
    name in the CPU tests)."""
    import importlib
    import types

    mods = {name: importlib.import_module(f"{package}.core.{name}")
            for name in ("engine", "topology", "baselines", "goodput",
                         "telemetry", "recovery")}
    mods["scenarios"] = importlib.import_module(f"{package}.scenarios")
    return types.SimpleNamespace(**mods)


def family_trace(sim, family, topo, seed):
    """``family``'s trace on ``topo`` at ``seed``, with the arguments of
    ``CHURN_FAMILY_ARGS``."""
    takes, kw = CHURN_FAMILY_ARGS[family]
    base = topo if takes == "topo" else sorted(topo.active_nodes())
    return sim.scenarios.GENERATORS[family](base, seed=seed, **kw)


def trace_jsonl(trace, events=None):
    """The text ``ScenarioTrace.save`` writes, for ``events`` (the trace's
    own by default)."""
    lines = [json.dumps({"scenario": trace.name, "seed": trace.seed,
                         "meta": trace.meta}, sort_keys=True)]
    lines += [json.dumps(e.to_json(), sort_keys=True)
              for e in (trace.events if events is None else events)]
    return "\n".join(lines) + "\n"


def _sha(text):
    return hashlib.sha256(text.encode()).hexdigest()


def churn_replay(sim, cluster, events, **kw):
    """``engine.run_trace_goodput``'s replay, keeping the backend for the
    metrics scrape: returns (ledger, backend)."""
    backend = sim.engine.SimBackend(cluster, accounting=True, **kw)
    ledger = sim.engine.ChurnEngine(backend).run(events)
    return ledger, backend


def churn_record(sim, text, ledger, backend):
    """What ``churn_sweep`` keeps of one replay."""
    T = sim.telemetry
    reg = T.MetricsRegistry()
    T.collect_backend(reg, backend, ledger, report=backend.goodput)
    return {"trace_sha256": _sha(text), "ledger": ledger.digest(),
            "decisions": sim.recovery.decision_digest(ledger),
            "spans": T.span_digest(ledger), "valid": T.validate(ledger) == [],
            "goodput": backend.goodput.to_json(),
            "metrics_sha256": _sha(reg.exposition())}


def churn_runs(sim):
    """Every replay of the sweep, as (key, trace text, cluster, events,
    engine settings), clusters built after ``train(1)``:

    (a) the omniscient poisson replay of ``tests/test_resharding.py:40-48``
        (16 nodes, 32 MiB in 1 MiB tensors, ``reshard="never"``);
    (b) every family of ``scenarios.GENERATORS`` at ``CHURN_SEED`` with the
        arguments of ``CHURN_FAMILY_ARGS`` (their tests are named there), on
        the GPT-2 profile (reshard-churn on ``RESHARD_STATE``) over
        ``random_edge_topology(12, seed=0)``, under each of
        ``CHURN_POLICIES`` with ``CHURN_FAMILY_KW``, and one poisson run
        under int8;
    (c) ``benchmarks/goodput.py``'s churn sweep as ``measure_goodput``
        builds it: every rate of ``GOODPUT_RATES`` and seed of
        ``GOODPUT_SEEDS``, omniscient and with the crashes silent."""
    import dataclasses

    topo_mod, S = sim.topology, sim.scenarios
    topo = topo_mod.random_edge_topology(16, seed=0)
    cl = sim.baselines.SimCluster(topo, state_bytes=32 * MiB,
                                  tensor_sizes=[MiB] * 32)
    cl.train(1)
    trace = S.poisson_churn(sorted(topo.active_nodes()), seed=3,
                            horizon_s=600.0, rate_join=0.05, rate_leave=0.04)
    yield "omniscient-poisson", trace_jsonl(trace), cl, list(trace), \
        {"reshard": "never"}

    name, state, typ = SIM_PROFILES[0]
    profiles = {"gpt2": (state, sim_tensor_sizes(state, typ)),
                "reshard": (RESHARD_STATE[0], sim_tensor_sizes(*RESHARD_STATE))}

    def cluster(family):
        state_bytes, sizes = profiles["reshard" if family == "reshard-churn"
                                      else "gpt2"]
        c = sim.baselines.make_cluster(
            topo_mod.random_edge_topology(CHURN_NODES, seed=0),
            state_bytes=state_bytes, tensor_sizes=sizes, strategy="chaos")
        c.train(1)
        return c

    for family in S.GENERATORS:
        trace = family_trace(sim, family,
                             topo_mod.random_edge_topology(CHURN_NODES, seed=0),
                             CHURN_SEED)
        runs = [(f"{family}|{policy}",
                 {"policy": policy, "detector": "phi",
                  **CHURN_FAMILY_KW.get(family, {})})
                for policy in CHURN_POLICIES]
        if family == "poisson-churn":
            runs.append((f"{family}|fixed|int8",
                         {"policy": "fixed", "detector": "phi", "codec": "int8"}))
        for key, kw in runs:
            yield key, trace_jsonl(trace), cluster(family), list(trace), kw

    for rate in GOODPUT_RATES:
        for seed in GOODPUT_SEEDS:
            for silent in (False, True):
                topo = topo_mod.random_edge_topology(GOODPUT_NODES, seed=seed)
                trace = S.poisson_churn(topo.active_nodes(), seed=seed + 3,
                                        horizon_s=GOODPUT_HORIZON_S,
                                        rate_join=0.02, rate_leave=rate,
                                        failure_fraction=1.0)
                events = list(trace)
                if silent:
                    events = [dataclasses.replace(e, kind="node-fault")
                              if e.kind == "node-failure" else e
                              for e in events]
                c = sim.baselines.make_cluster(
                    topo, state_bytes=GOODPUT_STATE,
                    tensor_sizes=[GOODPUT_TENSOR] * (GOODPUT_STATE // GOODPUT_TENSOR),
                    strategy="chaos")
                c.train(1)
                yield (f"goodput|{rate}|{seed}|{'silent' if silent else 'omniscient'}",
                       trace_jsonl(trace, events), c, events, {})


def churn_sweep(sim, keep=None):
    """The churn backend's deterministic outputs through ``sim`` (see
    ``churn_modules``), one record per run of ``churn_runs``: the trace's
    JSONL sha256, ``ledger.digest()``, ``decision_digest``,
    ``span_digest``, ``validate(ledger) == []``, the GoodPut report and the
    sha256 of the ``collect_backend`` exposition. ``keep``, a dict, also
    receives each run's (ledger, backend)."""
    out = {}
    for key, text, cluster, events, kw in churn_runs(sim):
        ledger, backend = churn_replay(sim, cluster, events, **kw)
        out[key] = churn_record(sim, text, ledger, backend)
        if keep is not None:
            keep[key] = (ledger, backend)
    return out


def _median_max(xs):
    import statistics

    return ({"median": statistics.median(xs), "max": max(xs), "n": len(xs)}
            if xs else {"median": None, "max": None, "n": 0})


def churn_phase(ops):
    """Phase 7: the port's churn backend on this host. The pinned
    omniscient-poisson digest and ``CHURN_DIGEST``; GoodPut and its BadPut
    components per family and policy and along the churn-rate sweep;
    detection latency, time to recover and the largest handling
    (``blocking_s``) of scale-in and link events, all in the simulator's
    virtual seconds, not card time. Launches no kernel."""
    import statistics

    for name in BLOCKED:
        if sys.modules.get(name) is not None:  # None: blocked, not imported
            raise AssertionError(f"the churn phase imported {name}")
    before = dict(ops.launches)
    t0 = time.perf_counter()
    # The sweep runs with the three unimportable: an import of any raises.
    absent = [name for name in BLOCKED if name not in sys.modules]
    sys.modules.update(dict.fromkeys(BLOCKED))
    try:
        sim = churn_modules("repro_torch")
        keep = {}
        sweep = churn_sweep(sim, keep)
    finally:
        for name in absent:
            del sys.modules[name]
    digest = sweep_digest(sweep)
    t_digest = time.perf_counter() - t0
    if sweep["omniscient-poisson"]["ledger"] != PRE_RESHARD_DIGEST:
        raise AssertionError(
            f"omniscient poisson ledger {sweep['omniscient-poisson']['ledger']}"
            f" != PRE_RESHARD_DIGEST {PRE_RESHARD_DIGEST}")
    if digest != CHURN_DIGEST:
        raise AssertionError(f"churn sweep digest {digest} != CHURN_DIGEST "
                             f"{CHURN_DIGEST}")
    invalid = [key for key, rec in sweep.items() if not rec["valid"]]
    if invalid:
        raise AssertionError(f"span forests fail validate(): {invalid}")

    T = sim.telemetry
    families = {}
    for key, rec in sweep.items():
        if key.startswith("goodput|") or key == "omniscient-poisson":
            continue
        g = rec["goodput"]
        families[key] = {"goodput_fraction": g["goodput_fraction"],
                         "virtual_badput_s": {c: v for c, v in
                                              g["components"].items()
                                              if c != "productive"}}
    rates = {}
    for rate in GOODPUT_RATES:
        for mode in ("omniscient", "silent"):
            fr = [sweep[f"goodput|{rate}|{seed}|{mode}"]["goodput"]
                  ["goodput_fraction"] for seed in GOODPUT_SEEDS]
            rates.setdefault(str(rate), {})[mode] = statistics.fmean(fr)
    detection, ttr, blocking = [], [], {}
    for ledger, _ in keep.values():
        detection += [r["detection_s"] for r in T.detection_rows(ledger)
                      if r["detected_t"] is not None]
        ttr += [r["ttr_s"] for r in T.ttr_rows(ledger)]
        for r in ledger:
            group = "leave" if r.kind == "leave" else r.action
            if group in ("leave", "link-connected", "link-disconnected",
                         "link-failed", "node-failed"):
                b = r.detail.get("blocking_s")
                if b is not None:
                    blocking[group] = max(blocking.get(group, 0.0), b)
    for group in ("leave", "link-connected", "link-failed", "node-failed"):
        if group not in blocking:
            raise AssertionError(f"the churn sweep handled no {group} record")
    # No generator emits link-leave, so link-disconnected has no record;
    # link-failed is the same handler's failure twin.
    blocking.setdefault("link-disconnected", None)
    over = {g: b for g, b in blocking.items()
            if b is not None and not b < HANDLING_BOUND_S}
    if over:
        raise AssertionError(f"handling over {HANDLING_BOUND_S} virtual s: "
                             f"{over}")
    if dict(ops.launches) != before:
        raise AssertionError(f"the churn phase launched kernels: "
                             f"{before} -> {dict(ops.launches)}")
    summary = {
        "digest": digest, "pre_reshard_digest": PRE_RESHARD_DIGEST,
        "replays": len(sweep), "digest_s": t_digest,
        "host_s": time.perf_counter() - t0,
        "families": families, "goodput_by_rate_seed_mean": rates,
        "virtual_detection_s": _median_max(detection),
        "virtual_ttr_s": _median_max(ttr),
        "virtual_max_blocking_s": blocking,
    }
    log(f"churn backend: {len(sweep)} replays, digest {digest} and "
        f"{PRE_RESHARD_DIGEST[:8]}... held; largest handling (virtual s) "
        f"{json.dumps(blocking)}; detection {json.dumps(summary['virtual_detection_s'])}"
        f"; host {summary['host_s']:.2f} s")
    return summary


# ---------------------------------------------------------------------------
# Phase 8: sharding, meshes, the trainer's layouts and the dry run.
# ---------------------------------------------------------------------------

#: The configs whose specs phase 8 holds to the digest: GPT-2 and ASSIGNED.
SHARDING_ARCHS = ("gpt2", "paligemma-3b", "whisper-small", "gemma2-27b",
                  "tinyllama-1.1b", "granite-34b", "llama3-405b", "kimi-k2-1t-a32b",
                  "arctic-480b", "rwkv6-1.6b", "zamba2-1.2b")
#: sha256 of ``sharding_records`` over every config and the four plans, equal
#: to the JAX package's specs (``tests/test_torch_sharding.py`` computes it
#: from both packages; change the records and that test prints the new one).
SHARDING_DIGEST = "e84ef029704ddf647117b85b347b4710f473f12aca0f74728eecff62338271bb"


def spec_entry(spec):
    """A spec as JSON: a list with tuples of axes as lists."""
    return [list(e) if isinstance(e, tuple) else e for e in spec]


def spec_tree_entries(paths_specs):
    """``{"a/b": spec entry}`` of ``(path, spec)`` pairs, ``path`` a
    sequence of keys."""
    return {"/".join(str(k) for k in path): spec_entry(spec)
            for path, spec in paths_specs}


def sharding_records(archs=SHARDING_ARCHS):
    """For each config and each of the four plans of ``launch/mesh.py``: the
    train state's specs (tp), the train cell's batch specs, the decode
    cell's (its cache included), the logits spec at the decode batch and
    ``shard_report`` of the params, as JSON-ready records."""
    from repro_torch import tree as T
    from repro_torch.configs import SHAPES, get_config
    from repro_torch.launch import mesh as M
    from repro_torch.models import build_model
    from repro_torch.models import sharding as SH

    plans = (M.PRODUCTION_PLAN, M.PRODUCTION_MULTI_POD_PLAN, M.DEBUG_PLAN,
             M.DEBUG_MULTI_POD_PLAN)
    train, decode = SHAPES["train_4k"], SHAPES["decode_32k"]
    records = []
    for arch in archs:
        cfg = get_config(arch)
        model = build_model(cfg, device="meta")
        state = model.train_state_specs()
        batches = {"train": model.input_specs(train), "decode": model.input_specs(decode)}
        for plan in plans:
            mesh = M.mesh_from_plan(plan)
            key = [arch, list(plan.shape)]
            records.append(key + ["state", spec_tree_entries(T.flatten_with_paths(
                SH.state_specs_tree(state, cfg, mesh)))])
            for name, cell in (("train", train), ("decode", decode)):
                records.append(key + [f"batch/{name}", spec_tree_entries(
                    T.flatten_with_paths(SH.batch_spec_tree(
                        batches[name], cfg, mesh, cell=cell)))])
            records.append(key + ["logits", spec_entry(
                SH.logits_spec(cfg, mesh, decode.global_batch))])
            records.append(key + ["shard_report",
                                  SH.shard_report(mesh, state["params"], cfg)])
    return records


def records_digest(records):
    return hashlib.sha256(json.dumps(records, sort_keys=True).encode()).hexdigest()


def _nbytes(t):
    return t.numel() * t.element_size()


def device_blocks(state, shardings, positions):
    """Each mesh position's blocks of every leaf of ``state`` under the
    sharding tree ``shardings`` (views, no copies): ``{position: [block,
    ...]}`` in leaf order."""
    from repro_torch import tree as T

    pairs = list(zip(T.leaves(state), T.leaves(shardings)))
    return {pos: [leaf[sh.indices(leaf.shape, pos)] for leaf, sh in pairs]
            for pos in positions}


def reassembles(state, shardings, blocks):
    """Whether writing every position's blocks back into fresh tensors gives
    every leaf of ``state`` bit for bit (one leaf at a time)."""
    from repro_torch import tree as T

    for i, (leaf, sh) in enumerate(zip(T.leaves(state), T.leaves(shardings))):
        out = torch.empty_like(leaf)
        for pos, bl in blocks.items():
            out[sh.indices(leaf.shape, pos)] = bl[i]
        if not torch.equal(out, leaf):
            return False
    return True


def sharding_phase(ops):
    """Phase 8 (the module docstring). Returns its record."""
    import torch.distributed as dist
    from torch.distributed.tensor import DTensor, distribute_tensor

    from repro_torch import tree as T
    from repro_torch.configs import ASSIGNED, SHAPES, ShapeCell, get_config
    from repro_torch.core.plans import ParallelismPlan
    from repro_torch.elastic import ElasticTrainer
    from repro_torch.launch import dryrun
    from repro_torch.launch import mesh as M
    from repro_torch.models import build_model
    from repro_torch.models import sharding as SH
    from repro_torch.models.shardctx import activation_sharding, constrain

    t_phase = time.perf_counter()
    rec = {}
    t0 = time.perf_counter()
    digest = records_digest(sharding_records())
    if digest != SHARDING_DIGEST:
        raise AssertionError(f"sharding specs digest {digest}, pinned {SHARDING_DIGEST}")
    rec["specs_s"] = time.perf_counter() - t0

    # The full-width state, cut into every device's block under four layouts.
    t0 = time.perf_counter()
    name = "tinyllama-1.1b"
    cfg = get_config(name)
    model = build_model(cfg)
    state = model.init_train_state(torch.Generator(device="cuda").manual_seed(0))
    state_bytes = sum(_nbytes(leaf) for leaf in T.leaves(state))
    layouts = []
    for plan in (M.DEBUG_PLAN, M.DEBUG_MULTI_POD_PLAN):
        mesh = M.mesh_from_plan(plan)
        shardings = SH.named(mesh, SH.state_specs_tree(state, cfg, mesh, tp=True))
        positions = list(np.ndindex(*plan.shape))
        blocks = device_blocks(state, shardings, positions)
        report = SH.shard_report(mesh, state["params"], cfg)
        per_dev = {pos: sum(_nbytes(b) for b in bl) for pos, bl in device_blocks(
            state["params"], shardings["params"], positions).items()}
        if set(per_dev.values()) != {report["per_device_bytes"]}:
            raise AssertionError(f"{plan.shape}: param bytes per device {per_dev}, "
                                 f"shard_report {report['per_device_bytes']}")
        model_row = sum(v for pos, v in per_dev.items() if all(i == 0 for i in pos[:-1]))
        want = report["replication_blowup"] * report["total_bytes"]
        if abs(model_row - want) > 1e-6 * report["total_bytes"]:
            raise AssertionError(f"{plan.shape}: a model row holds {model_row} param "
                                 f"bytes, blowup x total {want}")
        layouts.append((f"plan {list(plan.shape)}", state, shardings, blocks))
        rec[f"plan {list(plan.shape)}"] = dict(
            param_bytes_per_device=report["per_device_bytes"],
            replication_blowup=report["replication_blowup"],
            state_bytes_per_device=sum(_nbytes(b) for b in blocks[positions[0]]))
    trainer = ElasticTrainer(model, initial=4)
    trainer.init(state=state)
    for tp in (2, 4):
        trainer.apply_reshard(tp)
        positions = list(np.ndindex(*trainer.mesh().devices.shape))
        blocks = {pos: T.leaves(trainer.local_state(trainer.mesh().devices[pos]))
                  for pos in positions}
        layouts.append((f"trainer tp {tp}", trainer.state, trainer.layout, blocks))
        rec[f"trainer tp {tp}"] = dict(
            state_bytes_per_device=sum(_nbytes(b) for b in blocks[positions[0]]))
    for label, st, shardings, blocks in layouts:
        ptrs = {leaf.untyped_storage().data_ptr() for leaf in T.leaves(st)}
        if not all(b.untyped_storage().data_ptr() in ptrs for bl in blocks.values()
                   for b in bl):
            raise AssertionError(f"{label}: a block is not a view of the state")
        if not reassembles(st, shardings, blocks):
            raise AssertionError(f"{label}: the blocks do not reassemble the state")
    del layouts, blocks, trainer
    rec["state_bytes"] = state_bytes
    rec["blocks_s"] = time.perf_counter() - t0
    log(f"sharding: TinyLlama's state ({state_bytes} bytes) cut and reassembled "
        f"bit for bit under the debug plans and the trainer's tp 2 and 4: "
        f"{json.dumps(rec)}")

    # A one-rank DeviceMesh over NCCL.
    t0 = time.perf_counter()
    torch.cuda.set_device(0)
    dist.init_process_group("nccl", store=dist.HashStore(), rank=0, world_size=1)
    try:
        mesh = M.mesh_from_plan(ParallelismPlan((1, 1), ("data", "model")))
        dm = mesh.device_mesh()
        if dm.device_type != "cuda" or dm.mesh_dim_names != ("data", "model"):
            raise AssertionError(f"one-rank mesh {dm}")
        specs = SH.state_specs_tree(state, cfg, mesh)
        for leaf, spec in zip(T.leaves(state), T.leaves(specs)):
            dt = distribute_tensor(leaf, dm, SH.placements(spec, dm.mesh_dim_names))
            local = dt.to_local()
            if _nbytes(local) != _nbytes(leaf) or not torch.equal(local, leaf):
                raise AssertionError("distribute_tensor on one rank changed a leaf")
            del dt, local
        x = torch.randn((8, 64, cfg.d_model), device="cuda").to(torch.bfloat16)
        xd = distribute_tensor(x, dm, SH.placements(SH.P(), dm.mesh_dim_names))
        with activation_sharding(mesh):
            y = constrain(xd, "batch", None, None)
        if not isinstance(y, DTensor) or not torch.equal(y.to_local(), x):
            raise AssertionError("constrain changed a DTensor on one rank")
    finally:
        dist.destroy_process_group()
    rec["device_mesh_s"] = time.perf_counter() - t0

    # The dry run: the launcher's --lower-only in a subprocess beside the
    # cells traced here.
    code = ("import runpy, sys; sys.modules.update(jax=None, repro=None, networkx=None); "
            f"sys.argv = ['train', '--arch', '{name}', '--lower-only']; "
            "runpy.run_module('repro_torch.launch.train', run_name='__main__')")
    t_lower = time.perf_counter()
    lower = subprocess.Popen([sys.executable, "-c", code], stdout=subprocess.PIPE,
                             stderr=subprocess.PIPE, text=True,
                             env=dict(os.environ, PYTHONPATH=os.path.join(HERE, "src")))
    t0 = time.perf_counter()
    cells = [(arch, "decode_32k", kind) for arch in ASSIGNED for kind in ("single", "multi")]
    cells += [(name, shape, kind) for shape in SHAPES for kind in ("single", "multi")
              if (name, shape, kind) not in cells]
    dry = []
    for arch, shape, kind in cells:
        t1 = time.perf_counter()
        r = dryrun.run_cell(arch, shape, kind)
        if r.get("skipped"):
            dry.append({"cell": f"{arch}|{shape}|{kind}", "skipped": r["reason"]})
            continue
        dry.append({"cell": f"{arch}|{shape}|{kind}", "s": time.perf_counter() - t1,
                    "trace_s": r["trace_s"],
                    "argument_bytes": r["memory_analysis"]["argument_bytes"],
                    "dominant": r["roofline"]["dominant"],
                    "step_time_lower_bound_s": r["roofline"]["step_time_lower_bound_s"]})
    rec["dryrun_cells_s"] = time.perf_counter() - t0
    log(json.dumps({"dryrun_cells": dry}))

    # TinyLlama's one-device cell against the card.
    B, S = path_batches(name)[0], path_seq(name)
    cell = ShapeCell("path", S, B, "train")
    r = dryrun.run_cell(name, cell, ParallelismPlan((1, 1), ("data", "model")))
    batch = model.make_batch(cell)
    real = state_bytes + sum(_nbytes(t) for t in T.leaves(batch))
    mem = r["memory_analysis"]
    if mem["argument_bytes"] != real:
        raise AssertionError(f"dry run argument bytes {mem['argument_bytes']}, "
                             f"the card's state and batch {real}")
    step = model.make_train_step()
    gc.collect()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    state, metrics = step(state, batch)
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated()
    if not math.isfinite(float(metrics["loss"])):
        raise AssertionError("the one-device step's loss is not finite")
    rec["one_device"] = dict(
        batch=B, seq=S, argument_bytes=mem["argument_bytes"], card_argument_bytes=real,
        predicted_peak_bytes=mem["peak_bytes"], predicted_temp_bytes=mem["temp_bytes"],
        card_peak_bytes=peak, card_allocated_before_step=base,
        peak_ratio=mem["peak_bytes"] / peak, trace_s=r["trace_s"])
    del state, batch, model, step
    gc.collect()
    torch.cuda.empty_cache()

    try:
        out, err = lower.communicate(timeout=300)
    finally:
        lower.kill()
    if lower.returncode != 0:
        raise AssertionError(f"--lower-only exited {lower.returncode}: {err[-2000:]}")
    rec["lower_only_s"] = time.perf_counter() - t_lower
    rec["lower_only_record"] = out.strip().splitlines()[-1][:200]
    rec["phase_s"] = time.perf_counter() - t_phase
    log(json.dumps({"sharding_phase": rec}))
    return rec


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
                    help="root of an earlier checkout whose attention "
                         "(training and decode shapes), SSD and WKV6 kernels "
                         "and per-leaf encode and decode phase 5 times beside "
                         "this one's")
    baseline = ap.parse_args().baseline
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; the port's kernels run only on a GPU",
              file=sys.stderr)
        return 1
    # The port runs without JAX, the JAX package and networkx: all three are
    # made unimportable for the whole run (an import of any raises).
    for name in BLOCKED:
        if sys.modules.get(name) is not None:
            raise AssertionError(f"chip_smoke imported {name} before its run")
    sys.modules.update(dict.fromkeys(BLOCKED))
    from repro_torch import tree as T
    from repro_torch.configs import get_config
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
    errs["flash_attention_bwd"] = check_attention_bwd(fa, gen)
    errs["wkv6"] = check_wkv6(W, gen)
    errs["ssd"] = check_ssd(SD, gen)
    check_q8(gen)

    # Phase 3: the main paths, one family at a time. GPT-2's state is the
    # codec's timing input (phase 5), timed while it is on the card.
    launches = {name: 0 for name in ops.launches}
    times = {}
    for name in PATHS:
        with allocator_segments(name in EXPANDABLE_SEGMENTS):
            trainer, path_launches = main_path(ops, name)
            for k, n in path_launches.items():
                launches[k] += n
            if name == "gpt2":
                times["shard_encode"], times["shard_decode"] = time_codec(
                    codec, trainer.state)
                gpt2_leaf_bytes = [leaf.numel() * 4 for leaf in T.leaves(trainer.state)
                                   if leaf.dtype == torch.float32]
                if old is not None:
                    leaves = [leaf for leaf in T.leaves(trainer.state)
                              if leaf.dtype == torch.float32]
                    for key, base in time_baseline_codec(old, leaves).items():
                        for field in ("baseline_ms", "baseline_device_ms"):
                            if field in base:
                                times[key][field] = base[field]
                    del leaves
            replica_tier(trainer, name)
            del trainer
            gc.collect()
            torch.cuda.empty_cache()

    # Phase 3b: self-healing on GPT-2, its launches counted like a path's.
    for k, n in self_healing(ops).items():
        launches[k] += n
    gc.collect()
    torch.cuda.empty_cache()
    # Phase 3c: the launcher, its in-process launches counted like a path's.
    launcher_cli()
    for arch in LAUNCH_REDUCED:
        for k, n in launcher_reduced(ops, arch).items():
            launches[k] += n
    for k, n in launcher_full_width(ops).items():
        launches[k] += n
    gc.collect()
    torch.cuda.empty_cache()
    # Phase 3d: serving, its launches counted like a path's.
    t0 = time.perf_counter()
    for label, cfg, B, P, n_tokens in serve_runs():
        for k, n in serve_path(ops, label, cfg, B, P, n_tokens).items():
            launches[k] += n
    log(f"serving phase: {time.perf_counter() - t0:.1f} s")
    # Phase 3e: the dense configs that fit no card, reduced.
    for arch in REDUCED_DENSE:
        for k, n in reduced_dense(ops, arch).items():
            launches[k] += n
    gc.collect()
    torch.cuda.empty_cache()
    log(f"launches over the {len(PATHS)} paths, the self-healing replay, the "
        f"launcher, the serving runs and the reduced dense runs: "
        f"{json.dumps(launches)}")

    # Phase 4: small-input references.
    for name in PATHS:
        reference_check(name)

    # Phase 5: times (the codec's were taken after the GPT-2 path).
    times["flash_attention"] = time_attention(fa, MaskSpec, gen)
    for name in PATHS:
        cfg = path_config(name)
        if cfg.family not in ("vlm", "moe", "encdec"):
            continue
        # The path's global batch and the serving runs' batch of 8; for
        # Arctic (GQA 7:1) and Kimi (8:1, hd 112) also the serving prefill
        # into its cache; for Whisper, at the batch of 8, its encoder's,
        # decoder's and cross-attention's shapes.
        shapes = [(B, None, None, None)
                  for B in sorted({path_batches(name)[0], SERVE_BATCH})]
        if cfg.family == "moe":
            shapes.append((SERVE_BATCH, SERVE_CACHE, None, None))
        if cfg.family == "encdec":
            shapes = [(c[0], c[2], c[1], c[6])
                      for _, c in whisper_attention_shapes(cfg, SERVE_BATCH,
                                                           path_seq(name))]
        for B, Skv, Sq, kind in shapes:
            t = time_train_attention(fa, MaskSpec, gen, name, cfg, B, Skv, Sq, kind)
            bound_ms, bound_by = t.pop("bound")
            log(json.dumps({"kernel_train_shape": "flash_attention", **t,
                            "bound_ms": bound_ms, "bound_by": bound_by}))
            torch.cuda.empty_cache()
    for label, case, _ in attention_bwd_cases(paths=False):
        t = time_attention_bwd(fa, gen, case)
        if label == "gpt2 benchmark":
            times["flash_attention_bwd"] = t
        bound_ms, bound_by = t["bound"]
        log(json.dumps({"kernel_train_shape": "flash_attention_bwd", "model": label,
                        **{key: t[key] for key in t if key != "bound"},
                        "bound_ms": bound_ms, "bound_by": bound_by}))
        torch.cuda.empty_cache()
    shapes = main_shapes()
    times["wkv6"] = time_wkv6(W, gen, shapes["wkv6"][0][1])
    times["ssd"] = time_ssd(SD, gen, shapes["ssd"][0][1])
    if old is not None:
        for name, t in time_baseline(old, gen, shapes).items():
            times[name]["baseline_ms"] = t["baseline_ms"]
    decode = []
    for label, cfg, B, P, n in serve_runs():
        if cfg.family == "ssm":
            continue
        for kind, window in layer_kinds(cfg):
            # gemma2's cut: one cache per layer of that kind in the full config.
            n_sets = (get_config(cfg.name).n_layers // 2 if cfg.alt_local_global
                      else None)
            decode.append(("flash_attention", time_decode_attention,
                           (fa, MaskSpec, gen, label + kind, cfg, B, P, n, window,
                            n_sets, False, old)))
        if cfg.family == "encdec":
            decode.append(("flash_attention", time_decode_attention,
                           (fa, MaskSpec, gen, label + " cross", cfg, B, P, n, 0,
                            None, True, old)))
    decode += [("wkv6", time_decode_wkv6, (W, gen, old)),
               ("ssd", time_decode_ssd, (SD, gen, old))]
    for name, timer, args in decode:
        t = timer(*args)
        bound_ms, bound_by = t.pop("bound")
        log(json.dumps({"kernel_decode": name, **t, "bound_ms": bound_ms,
                        "bound_by": bound_by}))
        torch.cuda.empty_cache()

    # Phase 6: the simulator substrate, beside the codec's device times.
    simulator = simulator_phase(ops, gpt2_leaf_bytes,
                                (times["shard_encode"], times["shard_decode"]))
    # Phase 7: the churn backend replays traces on the simulator.
    churn = churn_phase(ops)
    # Phase 8: sharding, meshes, the trainer's layouts and the dry run.
    sharding_phase(ops)
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
        ("flash_attention_bwd", "src/repro_torch/csrc/attention_bwd.cu",
         "src/repro/kernels/ops.py:51"),
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
    log(f"chip_smoke: every phase passed in {time.perf_counter() - T_START:.1f} s")
    print(json.dumps({"simulator": simulator}))
    print(json.dumps({"churn": churn}))
    print(json.dumps({"kernels": kernels}))
    print(card_line())
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
