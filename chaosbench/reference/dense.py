"""Plain reference of the dense family as GPT-2 uses it: learned positions,
pre-LayerNorm blocks with ``(1 + scale)`` gains, multi-head causal
attention and a tanh-GELU MLP without biases, the embedding tied to the
unembedding, the mean next-token loss. Float32 throughout.

The parameter tree, shapes and initial deviations are the program's
(``repro_torch/models/transformer.py``, ``layers.py``): layers stacked on a
leading axis, ``embed/pos`` of ``position_table_rows`` rows.
"""
from __future__ import annotations

import math

import torch

from chaosbench.reference import common as C
from chaosbench.yardstick import admitted_pairs

FAMILY = "dense"


def check(cfg: dict) -> None:
    a = cfg["arch"]
    want = dict(family=FAMILY, norm="layernorm", mlp="gelu2", positions="learned",
                tie_embeddings=True)
    for key, value in want.items():
        if a.get(key) != value:
            raise ValueError(f"{cfg['name']}: the dense reference needs {key}={value!r}")
    if a["n_kv_heads"] != a["n_heads"] or a["head_dim"] * a["n_heads"] != a["d_model"]:
        raise ValueError(f"{cfg['name']}: the dense reference needs plain multi-head attention")


def positions(cfg: dict) -> int:
    return cfg["seq"]


def attention_specs(prefix, L, d, std_out):
    s = 1.0 / math.sqrt(d)
    return [(prefix + ("wk",), (L, d, d), s), (prefix + ("wo",), (L, d, d), std_out),
            (prefix + ("wq",), (L, d, d), s), (prefix + ("wv",), (L, d, d), s)]


def norm_specs(prefix, shape):
    return [(prefix + ("bias",), shape, 0.0), (prefix + ("scale",), shape, 0.0)]


def mlp_specs(prefix, L, d, ff):
    return [(prefix + ("w1",), (L, d, ff), 1.0 / math.sqrt(d)),
            (prefix + ("w2",), (L, ff, d), 1.0 / math.sqrt(ff))]


def specs(cfg: dict):
    check(cfg)
    a = cfg["arch"]
    L, d, ff, V = a["n_layers"], a["d_model"], a["d_ff"], a["vocab"]
    std_out = 1.0 / math.sqrt(d) / math.sqrt(2 * L)
    return ([(("embed", "pos"), (cfg["position_table_rows"], d), 0.02),
             (("embed", "tok"), (V, d), 0.02)]
            + norm_specs(("final_norm",), (d,))
            + attention_specs(("layers", "attn"), L, d, std_out)
            + norm_specs(("layers", "ln1"), (L, d)) + norm_specs(("layers", "ln2"), (L, d))
            + mlp_specs(("layers", "mlp"), L, d, ff))


def make_inputs(cfg: dict, gen: torch.Generator, rows: int, device) -> dict:
    """Rows of ``seq + 1`` tokens, uniform over the vocabulary."""
    return {"tokens": torch.randint(0, cfg["arch"]["vocab"], (rows, cfg["seq"] + 1),
                                    generator=gen, device=device)}


def loss_sum(cfg: dict, p: dict, batch: dict, prec) -> torch.Tensor:
    a = cfg["arch"]
    tokens = batch["tokens"]
    inputs, labels = tokens[:, :-1], tokens[:, 1:]
    eps = a["norm_eps"]
    x = p["embed"]["tok"][inputs] + p["embed"]["pos"][:inputs.shape[1]]
    for i in range(a["n_layers"]):
        lp = C.layer(p["layers"], i)
        h = C.layernorm(x, lp["ln1"], eps)
        x = x + C.attention(h, h, lp["attn"], a["n_heads"], True, prec)
        x = x + C.mlp(C.layernorm(x, lp["ln2"], eps), lp["mlp"], prec)
    return C.nll_sum(C.layernorm(x, p["final_norm"], eps), p["embed"]["tok"], labels, prec)


def train_flops(cfg: dict, rows: int) -> float:
    """Model FLOPs of one training step over ``rows`` rows: 6 per matmul
    parameter and token (the projections, the MLP, the unembedding), and
    12 per head dimension and admitted causal (query, key) pair of each
    layer (QKᵀ and PV forward, four products backward); no remat."""
    a = cfg["arch"]
    L, d, ff, V, S = a["n_layers"], a["d_model"], a["d_ff"], a["vocab"], cfg["seq"]
    matmul = L * (4 * d * d + 2 * d * ff) + d * V
    attn = 12 * d * admitted_pairs("causal", 0, 0, S, S) * L
    return float(rows * (6 * matmul * S + attn))
