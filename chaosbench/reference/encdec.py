"""Plain reference of the encoder-decoder family as Whisper-small uses it:
the encoder over ``enc_len`` frame embeddings (the conv front end stubbed:
the frames are inputs) plus learned frame positions, full self-attention;
the decoder over text tokens with learned positions, causal
self-attention, cross-attention to the encoder's output and a tanh-GELU
MLP; pre-LayerNorm blocks with ``(1 + scale)`` gains, no biases, the
embedding tied to the unembedding, the mean next-token loss. Float32.

The parameter tree, shapes and initial deviations are the program's
(``repro_torch/models/whisper.py``).
"""
from __future__ import annotations

import math

import torch

from chaosbench.reference import common as C
from chaosbench.reference.dense import attention_specs, mlp_specs, norm_specs
from chaosbench.yardstick import admitted_pairs

FAMILY = "encdec"
#: the frames' scale: seeded normals times this, as stubbed embeddings.
FRAME_SCALE = 0.02


def check(cfg: dict) -> None:
    a = cfg["arch"]
    want = dict(family=FAMILY, norm="layernorm", mlp="gelu2", positions="learned",
                tie_embeddings=True)
    for key, value in want.items():
        if a.get(key) != value:
            raise ValueError(f"{cfg['name']}: the encdec reference needs {key}={value!r}")
    if a["n_kv_heads"] != a["n_heads"] or a["head_dim"] * a["n_heads"] != a["d_model"]:
        raise ValueError(f"{cfg['name']}: the encdec reference needs plain multi-head attention")


def positions(cfg: dict) -> int:
    return cfg["seq"]


def specs(cfg: dict):
    check(cfg)
    a = cfg["arch"]
    L, E, d, ff, V = a["n_layers"], a["enc_layers"], a["d_model"], a["d_ff"], a["vocab"]
    # Both stacks scale their output projections by the decoder's depth,
    # as the program's ``init_attention`` does.
    std_out = 1.0 / math.sqrt(d) / math.sqrt(2 * L)
    dec, enc = ("decoder",), ("encoder",)
    return ([(("embed", "pos"), (cfg["position_table_rows"], d), 0.02),
             (("embed", "tok"), (V, d), 0.02),
             (("enc_pos",), (a["enc_len"], d), 0.02)]
            + norm_specs(("enc_norm",), (d,)) + norm_specs(("final_norm",), (d,))
            + attention_specs(dec + ("attn",), L, d, std_out)
            + norm_specs(dec + ("ln1",), (L, d)) + norm_specs(dec + ("ln2",), (L, d))
            + norm_specs(dec + ("ln_x",), (L, d))
            + mlp_specs(dec + ("mlp",), L, d, ff)
            + attention_specs(dec + ("xattn",), L, d, std_out)
            + attention_specs(enc + ("attn",), E, d, std_out)
            + norm_specs(enc + ("ln1",), (E, d)) + norm_specs(enc + ("ln2",), (E, d))
            + mlp_specs(enc + ("mlp",), E, d, ff))


def make_inputs(cfg: dict, gen: torch.Generator, rows: int, device) -> dict:
    """Rows of ``seq + 1`` tokens, uniform over the vocabulary, and each
    row's frames: (enc_len, d_model) normals times ``FRAME_SCALE``, in
    bfloat16, the activations' type."""
    a = cfg["arch"]
    tokens = torch.randint(0, a["vocab"], (rows, cfg["seq"] + 1), generator=gen,
                           device=device)
    frames = torch.randn((rows, a["enc_len"], a["d_model"]), generator=gen,
                         device=device) * FRAME_SCALE
    return {"tokens": tokens, "frames": frames.to(torch.bfloat16)}


def loss_sum(cfg: dict, p: dict, batch: dict, prec) -> torch.Tensor:
    a = cfg["arch"]
    eps, H = a["norm_eps"], a["n_heads"]
    x = batch["frames"].to(torch.float32) + p["enc_pos"]
    for i in range(a["enc_layers"]):
        lp = C.layer(p["encoder"], i)
        h = C.layernorm(x, lp["ln1"], eps)
        x = x + C.attention(h, h, lp["attn"], H, False, prec)
        x = x + C.mlp(C.layernorm(x, lp["ln2"], eps), lp["mlp"], prec)
    enc = C.layernorm(x, p["enc_norm"], eps)

    tokens = batch["tokens"]
    inputs, labels = tokens[:, :-1], tokens[:, 1:]
    x = p["embed"]["tok"][inputs] + p["embed"]["pos"][:inputs.shape[1]]
    for i in range(a["n_layers"]):
        lp = C.layer(p["decoder"], i)
        h = C.layernorm(x, lp["ln1"], eps)
        x = x + C.attention(h, h, lp["attn"], H, True, prec)
        h = C.layernorm(x, lp["ln_x"], eps)
        x = x + C.attention(h, enc, lp["xattn"], H, False, prec)
        x = x + C.mlp(C.layernorm(x, lp["ln2"], eps), lp["mlp"], prec)
    return C.nll_sum(C.layernorm(x, p["final_norm"], eps), p["embed"]["tok"], labels, prec)


def train_flops(cfg: dict, rows: int) -> float:
    """Model FLOPs of one training step over ``rows`` rows, 6 per matmul
    parameter and token and 12 per head dimension and admitted (query,
    key) pair, no remat: the encoder's layers over ``enc_len`` frames; the
    decoder's self-attention projections, cross queries and outputs, MLP
    and unembedding over ``seq`` tokens; the cross keys and values over the
    frames; attention full over the frames, causal over the text, and
    cross from text to frames."""
    a = cfg["arch"]
    L, E, d, ff, V = a["n_layers"], a["enc_layers"], a["d_model"], a["d_ff"], a["vocab"]
    S, F = cfg["seq"], a["enc_len"]
    per_row = 6 * (F * E * (4 * d * d + 2 * d * ff)
                   + S * (L * (4 * d * d + 2 * d * d + 2 * d * ff) + d * V)
                   + F * L * 2 * d * d)
    pairs = (E * admitted_pairs("full", 0, 0, F, F) + L * admitted_pairs("causal", 0, 0, S, S)
             + L * admitted_pairs("full", 0, 0, S, F))
    return float(rows * (per_row + 12 * d * pairs))
