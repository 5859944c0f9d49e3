"""Serving launcher of the port, from ``repro/launch/serve.py``: batched
prefill + greedy autoregressive decode with a KV cache (dense: GPT-2,
TinyLlama, granite, llama3, gemma2; vlm: PaliGemma, whose cache holds the
image patches' rows before the prompt's; moe: Arctic, Kimi-K2; encdec:
Whisper, whose prefill also fills a cross-KV cache from the frames), a
recurrent state (ssm) or both
(hybrid: one KV cache per application of the shared attention block, and
each Mamba2 block's conv and SSM states), request after request, with
per-phase timing.

    PYTHONPATH=src python -m repro_torch.launch.serve [--arch tinyllama-1.1b] \
        [--requests 3] [--batch 4] [--prompt-len 32] [--tokens 16] [--device cpu]

Serves the reduced config, as the JAX launcher does. The JAX launcher's
flags keep their defaults and meanings, ``--arch`` defaulting to
``tinyllama-1.1b`` as there. ``--temperature`` is accepted and, as there,
unused: decoding is greedy. ``--device`` is the port's own: CUDA unless
given, and asking for CUDA where there is none raises
(``repro_torch.device.resolve_device``). An arch that no config names
exits non-zero with get_config's unknown-arch message. Arctic and Kimi-K2
(moe) are served as the dense family is, their layers' experts routing
each call's tokens as one group.

PaliGemma (``--arch paligemma-3b``) is served with seeded random patch
embeddings (normals × 0.02, as the training batches make them), where the
JAX launcher passes zeros, and each decode step writes the cache row after
the patches and the prompt, ``n_patches + S + t``. The JAX launcher
decodes at ``S + t``, which overwrites rows its prefill filled and rotates
the step at the wrong RoPE position.

Whisper (``--arch whisper-small``) is served with seeded random frame
embeddings (normals × 0.02, as the training batches make them), where the
JAX launcher passes zeros: they go through the encoder once, in the
prefill, into each decoder layer's cross-KV cache, which every decode step
reads as it is; the self cache holds the prompt and the new tokens.
"""
from __future__ import annotations

import argparse
import sys
import time
from dataclasses import dataclass, field
from typing import List, Optional

import torch

from repro_torch.configs import get_config
from repro_torch.models import build_model
from repro_torch.models.model_api import SERVED


@dataclass
class Generation:
    """One request's result: ``tokens`` (B, n_tokens) int64, the logits
    that chose them (``logits[i]`` (B, V) chose ``tokens[:, i]``, kept
    only when asked for), the prefill's host time and the decode loop's,
    in ms, each closed by a device sync on CUDA; with ``stream``, also
    each decode step's."""
    tokens: torch.Tensor
    prefill_ms: float
    decode_ms: float = 0.0
    step_ms: List[float] = field(default_factory=list)
    logits: Optional[List[torch.Tensor]] = None


def _sync(device):
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def generate(model, params, prompts, n_tokens: int, *, patches=None,
             frames=None, stream: bool = False,
             keep_logits: bool = False) -> Generation:
    """Prefill ``prompts`` (B, S) into a cache of ``S + n_tokens``
    positions (for every family: the JAX launcher serves the hybrid one
    through its ``Model.prefill``, which sizes the cache at S), then
    ``n_tokens - 1`` greedy decode steps: ``n_tokens`` new tokens. A vlm
    takes ``patches`` (B, n_patches, d): they are prefilled in front of
    the prompt, the cache holds ``n_patches`` rows more, and step ``t``
    decodes at row ``n_patches + S + t``. An encdec takes ``frames`` (B,
    enc_len, d): the prefill runs them through the encoder into the
    cross-KV cache. The
    decode loop is timed as one window closed by one sync, as the JAX
    launcher times it; with ``stream`` each step is closed by a sync and
    timed, as for a server that hands out each token as it comes, and the
    window then holds those syncs too."""
    dev = model.device
    prompts = torch.as_tensor(prompts, device=dev).long()
    B, S = prompts.shape
    batch, prefix = {"tokens": prompts}, 0
    if model.cfg.family == "vlm":
        if patches is None:
            raise ValueError("serving a vlm needs its patches")
        batch["patches"] = torch.as_tensor(patches, device=dev)
        prefix = model.cfg.n_patches
    if model.cfg.family == "encdec":
        if frames is None:
            raise ValueError("serving an encdec model needs its frames")
        batch["frames"] = torch.as_tensor(frames, device=dev)
    _sync(dev)
    t0 = time.perf_counter()
    logits, cache = model.prefill(params, batch, max_len=S + n_tokens)
    tok = torch.argmax(logits[:, -1:], dim=-1)
    _sync(dev)
    run = Generation(tokens=tok, prefill_ms=(time.perf_counter() - t0) * 1e3,
                     logits=[logits[:, -1]] if keep_logits else None)
    out = [tok]
    t0 = time.perf_counter()
    for t in range(n_tokens - 1):
        t1 = time.perf_counter()
        logits, cache = model.decode_step(params, {"tokens": tok,
                                                   "pos": prefix + S + t,
                                                   "cache": cache})
        tok = torch.argmax(logits[:, -1:], dim=-1)
        if stream:
            _sync(dev)
            run.step_ms.append((time.perf_counter() - t1) * 1e3)
        out.append(tok)
        if keep_logits:
            run.logits.append(logits[:, -1])
    _sync(dev)
    run.decode_ms = (time.perf_counter() - t0) * 1e3
    run.tokens = torch.cat(out, dim=1)
    return run


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--arch", default="tinyllama-1.1b")
    ap.add_argument("--requests", type=int, default=3)
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=32)
    ap.add_argument("--tokens", type=int, default=16)
    ap.add_argument("--temperature", type=float, default=0.0)
    ap.add_argument("--device", default=None,
                    help="torch device (default: cuda)")
    args = ap.parse_args(argv)

    try:
        cfg = get_config(args.arch).reduced()
    except KeyError as e:
        print(f"serve: {e.args[0]}", file=sys.stderr)
        return 2
    if cfg.family not in SERVED:
        print(f"serve: {args.arch} ({cfg.family}) is not served by the port yet; "
              f"served families: {', '.join(SERVED)}", file=sys.stderr)
        return 2
    model = build_model(cfg, device=args.device)
    params = model.init()
    B, S, T = args.batch, args.prompt_len, args.tokens
    gen = torch.Generator().manual_seed(1)

    for req in range(args.requests):
        prompts = torch.randint(0, cfg.vocab, (B, S), generator=gen)
        patches = (torch.randn((B, cfg.n_patches, cfg.d_model), generator=gen) * 0.02
                   if cfg.family == "vlm" else None)
        frames = (torch.randn((B, cfg.enc_len, cfg.d_model), generator=gen) * 0.02
                  if cfg.family == "encdec" else None)
        run = generate(model, params, prompts, T, patches=patches, frames=frames)
        print(f"req {req}: prefill {run.prefill_ms:.0f} ms | decode {T} toks "
              f"{run.decode_ms:.0f} ms ({run.decode_ms / max(T - 1, 1):.1f} ms/tok) | "
              f"sample {run.tokens[0, :8].tolist()}")
    print("SERVE_OK")
    return 0


if __name__ == "__main__":
    sys.exit(main())
