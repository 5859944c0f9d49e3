#!/usr/bin/env python3
"""Time the attention backward kernels at the training paths' shapes on one
NVIDIA GPU.

    python3 tools/attention_bwd_times.py [--out FILE]

For GPT-2's layer at batch 12 (12, 1024, 12, 64, causal) and Whisper's
three at batch 8 (the encoder's 1,500 frames, full; the decoder's 448
tokens, causal; its cross-attention over the frames), in bf16: the forward
that writes the log-sum-exp, the backward kernels (``flash_attention_bwd_kernel``:
prep, dK/dV and dQ) as device time per call over CUDA events, their bound
(``kernels.cost.attention_bwd`` over the H100 SXM data sheet's 989 TFLOP/s
bf16 and 3.35 TB/s), the plain backward they replace (the autograd of
``attention_plain`` that ``kernels/ops.py`` runs for other calls), and the
kernels' dq, dk and dv against that autograd in fp32 (the error's norm over
the gradient's). Prints
one JSON line a shape (also written to ``--out``), the card's name and
power limit last. Needs ``nvcc`` and a CUDA device.
"""
import argparse
import json
import pathlib
import subprocess
import sys

import torch

ROOT = pathlib.Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))

from repro_torch.kernels import cost  # noqa: E402
from repro_torch.kernels import flash_attention as fa  # noqa: E402
from repro_torch.models.layers import MaskSpec  # noqa: E402

PEAK_FLOPS, PEAK_BYTES = 989e12, 3.35e12
#: label: (B, Sq, Skv, H, K, hd, kind)
SHAPES = {
    "gpt2": (12, 1024, 1024, 12, 12, 64, "causal"),
    "whisper encoder": (8, 1500, 1500, 12, 12, 64, "full"),
    "whisper decoder": (8, 448, 448, 12, 12, 64, "causal"),
    "whisper cross": (8, 448, 1500, 12, 12, 64, "full"),
}


def device_ms(fn, iters):
    fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def time_shape(label, shape, gen):
    B, Sq, Skv, H, K, hd, kind = shape
    q, do = (torch.randn((B, Sq, H, hd), generator=gen, device="cuda").to(torch.bfloat16)
             for _ in range(2))
    k, v = (torch.randn((B, Skv, K, hd), generator=gen, device="cuda").to(torch.bfloat16)
            for _ in range(2))
    scale = hd ** -0.5
    lse = torch.empty((B, H, Sq), dtype=torch.float32, device="cuda")

    def forward():
        with fa.writing_lse(lse):
            return fa.flash_attention_kernel(q, k, v, scale=scale, kind=kind)

    o = forward()

    def backward():
        return fa.flash_attention_bwd_kernel(q, k, v, o, lse, do, scale=scale, kind=kind)

    def plain():
        live = [t.detach().requires_grad_(True) for t in (q, k, v)]
        with torch.enable_grad():
            out = fa.attention_plain(*live, MaskSpec(kind), scale=scale)
            return torch.autograd.grad(out, live, do)

    # The kernels' gradients against the fp32 autograd of the plain version:
    # the error's norm over the oracle's.
    ref = [t.float().requires_grad_(True) for t in (q, k, v)]
    with torch.enable_grad():
        fa.attention_plain(*ref, MaskSpec(kind), scale=scale).backward(do.float())
    rel = {name: float((g.float() - t.grad).norm() / t.grad.norm())
           for name, g, t in zip(("dq", "dk", "dv"), backward(), ref)}
    del ref

    pairs = cost.admitted_pairs(kind, 0, 0, Sq, Skv)
    flops, nbytes = cost.attention_bwd(B, Sq, Skv, H, K, hd, pairs)
    bound = 1e3 * max(flops / PEAK_FLOPS, nbytes / PEAK_BYTES)
    bwd = device_ms(backward, 20)
    return {"shape": label, "B_Sq_Skv_H_K_hd_kind": shape, "forward_ms": device_ms(forward, 20),
            "backward_ms": bwd, "bound_ms": bound,
            "bound_by": "operations" if flops / PEAK_FLOPS >= nbytes / PEAK_BYTES else "bytes",
            "roofline_pct": 100 * bound / bwd, "plain_ms": device_ms(plain, 3),
            "grad_rel_err": rel}


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out", default=None)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("needs a CUDA device")
    gen = torch.Generator(device="cuda").manual_seed(0)
    rows = [time_shape(label, shape, gen) for label, shape in SHAPES.items()]
    for row in rows:
        print(json.dumps(row), flush=True)
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True, text=True).stdout
    print(card.strip())
    if args.out:
        pathlib.Path(args.out).write_text(json.dumps({"rows": rows, "card": card.strip()}))


if __name__ == "__main__":
    main()
