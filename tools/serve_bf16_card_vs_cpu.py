#!/usr/bin/env python3
"""Where reduced models' bf16 serving on the card parts from the CPU's, on
one NVIDIA GPU.

    python3 tools/serve_bf16_card_vs_cpu.py

For reduced TinyLlama, llama3 and GPT-2 (params from the port's init on
the card, seeded; batch 2, a 64-token prompt, 7 forced tokens, a cache of
80, bf16), ``chip_smoke.serve_forced`` on the card against the same on
the CPU (the kernels' plain versions): max |diff| and the logits outside
bf16 ``_tol``, with the kernels, with the attention's plain version on the
card (fp32 probabilities, where the kernel's P·V on bf16 tensor cores
rounds them to bf16), and with cuBLAS's reduced-precision bf16 reductions
allowed and not. Prints one line per reading and the card's name and
power limit last. Needs ``nvcc`` and a CUDA device.
"""
import importlib.util
import pathlib
import sys

import numpy as np
import torch

ROOT = pathlib.Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))

ARCHS = ("tinyllama-1.1b", "llama3-405b", "gpt2")


def _chip_smoke():
    spec = importlib.util.spec_from_file_location("chip_smoke", ROOT / "chip_smoke.py")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def _cpu(tree):
    return {k: _cpu(v) if isinstance(v, dict) else v.cpu() for k, v in tree.items()}


def main():
    if not torch.cuda.is_available():
        print("serve_bf16_card_vs_cpu: needs a CUDA device", file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    cs = _chip_smoke()
    from repro_torch.configs import get_config
    from repro_torch.kernels import ops
    from repro_torch.models import build_model

    bf16 = torch.bfloat16
    t = cs.tol(bf16)
    for arch in ARCHS:
        cfg = get_config(arch).reduced()
        params = build_model(cfg).init(torch.Generator(device="cuda").manual_seed(0))
        tokens = torch.from_numpy(np.random.default_rng(0).integers(
            0, cfg.vocab, size=(2, 64 + cs.FP32_DECODE_STEPS))).cuda()
        cpu = cs.serve_forced(cfg, _cpu(params), tokens.cpu(), 64, 80, bf16).float()
        runs = (("kernels", (), True), ("plain attention", ("flash_attention",), True),
                ("kernels, no reduced-precision bf16 reductions", (), False))
        for label, plain, reduced in runs:
            on_card = ops._on_card
            ops._on_card = lambda x, what: False if what in plain else on_card(x, what)
            torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = reduced
            try:
                card = cs.serve_forced(cfg, params, tokens, 64, 80, bf16).cpu().float()
            finally:
                ops._on_card = on_card
                torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = True
            d = (card - cpu).abs()
            bad = int((d > t["atol"] + t["rtol"] * cpu.abs()).sum())
            print(f"{cfg.name}, {label}: card vs CPU max |diff| {float(d.max()):.4g}, "
                  f"{bad} of {d.numel()} logits outside bf16 _tol", flush=True)
    print(cs.card_line())
    return 0


if __name__ == "__main__":
    sys.exit(main())
