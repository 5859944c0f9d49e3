"""Serving demo on the PyTorch port: batched prefill + greedy decode with
a KV cache (the dense family: TinyLlama, GPT-2, granite, llama3, gemma2;
PaliGemma, whose cache starts with its image patches' rows; Arctic and
Kimi-K2, whose layers route to experts; Whisper, whose prefill fills a
cross-KV cache from its frames),
a recurrent state (RWKV-6) or both (Zamba2: a KV cache per application of
its shared attention block beside the Mamba2 blocks' conv and SSM states),
the twin of ``examples/serve.py``.

Serves the reduced config: prefill a batch of prompts into a cache sized
for the whole generation, then decode tokens autoregressively through
``Model.prefill`` and ``Model.decode_step``.

    PYTHONPATH=src python examples/torch_serve.py [--arch tinyllama-1.1b] [--tokens 16] [--device cpu]

The default arch is ``tinyllama-1.1b``, as in the JAX demo; ``--arch``
takes ``gpt2``, ``granite-34b``, ``llama3-405b``, ``gemma2-27b``,
``rwkv6-1.6b``, ``zamba2-1.2b``, ``arctic-480b``, ``kimi-k2-1t-a32b``,
``paligemma-3b`` (seeded random patch embeddings in front of the prompts)
and ``whisper-small`` (seeded random frame embeddings) too. Runs on CUDA unless ``--device``
names another device (``cpu`` runs the kernels' plain versions).
"""
import argparse
import sys

import torch

from repro_torch.configs import get_config
from repro_torch.launch.serve import generate
from repro_torch.models import build_model
from repro_torch.models.model_api import SERVED


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--arch", default="tinyllama-1.1b")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=32)
    ap.add_argument("--tokens", type=int, default=16)
    ap.add_argument("--device", default=None,
                    help="torch device (default: cuda)")
    args = ap.parse_args(argv)

    try:
        cfg = get_config(args.arch).reduced()
    except KeyError as e:
        print(f"serve demo: {e.args[0]}", file=sys.stderr)
        return 1
    if cfg.family not in SERVED:
        print(f"serve demo: {args.arch} ({cfg.family}) is not served by the "
              f"port yet; pick one of the {', '.join(SERVED)} archs", file=sys.stderr)
        return 1
    model = build_model(cfg, device=args.device)
    params = model.init()

    B, S = args.batch, args.prompt_len
    host = torch.Generator().manual_seed(1)
    prompts = torch.randint(0, cfg.vocab, (B, S), generator=host)
    patches = (torch.randn((B, cfg.n_patches, cfg.d_model), generator=host) * 0.02
               if cfg.family == "vlm" else None)
    frames = (torch.randn((B, cfg.enc_len, cfg.d_model), generator=host) * 0.02
              if cfg.family == "encdec" else None)
    gen = generate(model, params, prompts, args.tokens, patches=patches,
                   frames=frames).tokens.cpu()

    print(f"arch={cfg.name} prefill={S} decode={args.tokens} batch={B}")
    for b in range(B):
        print(f"  seq{b}: {gen[b, :12].tolist()} ...")
    ok = bool((gen >= 0).all() and (gen < cfg.vocab).all())
    print("SERVE_OK" if ok else "SERVE_FAILED")
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
