"""What the plain references share: weights from a seed, the layers'
float32 math, the training steps with AdamW and global-norm clipping, and
the int8 block encode of a replication payload.

A family module (``dense.py``, ``encdec.py``) gives ``specs(cfg)`` (each
parameter's path, shape and initial standard deviation, in the program's
tree), ``make_inputs``, ``positions`` (the tokens a row's loss covers),
``loss_sum`` (the summed next-token loss of some rows) and ``train_flops``.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F

Q_BLOCK = 256


def strict_fp32() -> None:
    """Float32 products in float32: no TF32 on the card."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")


def fp8(x, dtype=torch.float8_e4m3fn):
    """``x`` rounded to float8 under one scale per tensor, its largest
    magnitude at the format's largest value."""
    top = torch.finfo(dtype).max
    s = x.abs().amax().clamp(min=1e-30) / top
    return (x / s).to(dtype).to(torch.float32) * s


def _sum_to(g, shape):
    """``g`` summed over the dimensions that broadcasting added to
    ``shape``."""
    while g.dim() > len(shape):
        g = g.sum(0)
    for i, n in enumerate(shape):
        if n == 1 and g.shape[i] != 1:
            g = g.sum(i, keepdim=True)
    return g


class _FP8MatMul(torch.autograd.Function):
    """``a @ b`` with both operands in e4m3, and in the backward the
    output's gradient in e5m2, each under one scale per tensor: the hybrid
    float8 recipe for training on Hopper."""

    @staticmethod
    def forward(ctx, a, b):
        qa, qb = fp8(a), fp8(b)
        ctx.save_for_backward(qa, qb)
        ctx.shapes = (a.shape, b.shape)
        return torch.matmul(qa, qb)

    @staticmethod
    def backward(ctx, g):
        qa, qb = ctx.saved_tensors
        qg = fp8(g, torch.float8_e5m2)
        ga = torch.matmul(qg, qb.transpose(-1, -2))
        gb = torch.matmul(qa.transpose(-1, -2), qg)
        return _sum_to(ga, ctx.shapes[0]), _sum_to(gb, ctx.shapes[1])


class Precision:
    """How the reference multiplies. ``fp32``: as the configuration's
    float32 parameters state. ``fp8``, the control: every product of the
    forward and the backward with its operands in float8 (``_FP8MatMul``),
    as an fp8 training path would compute a bf16 model's products."""

    def __init__(self, name: str = "fp32"):
        if name not in ("fp32", "fp8"):
            raise ValueError(f"no precision {name!r}")
        self.name = name

    def mm(self, a, b):
        if self.name == "fp32":
            return torch.matmul(a, b)
        return _FP8MatMul.apply(a, b)


# ---------------------------------------------------------------------------
# Trees of parameters: flat {path tuple: tensor} <-> nested dicts.
# ---------------------------------------------------------------------------


def flat_items(tree, path=()):
    """``[(path, leaf)]``, dict keys in sorted order, depth first."""
    if isinstance(tree, dict):
        out = []
        for key in sorted(tree):
            out += flat_items(tree[key], path + (key,))
        return out
    return [(path, tree)]


def nest(flat: dict) -> dict:
    out: dict = {}
    for path, value in flat.items():
        node = out
        for key in path[:-1]:
            node = node.setdefault(key, {})
        node[path[-1]] = value
    return out


def layer(stacked: dict, i: int) -> dict:
    """Layer ``i`` of parameters stacked on a leading axis."""
    return {k: layer(v, i) if isinstance(v, dict) else v[i] for k, v in stacked.items()}


def make_params(specs, gen: torch.Generator, device) -> dict:
    """{path: float32 tensor}: normals times each spec's deviation, drawn
    on ``device`` from ``gen`` in one call, in the specs' order; zeros where
    the deviation is 0."""
    specs = sorted(specs)
    sizes = [math.prod(shape) for _, shape, std in specs if std]
    noise = torch.randn(sum(sizes), generator=gen, dtype=torch.float32,
                        device=device).split(sizes)
    out, it = {}, iter(noise)
    for path, shape, std in specs:
        out[path] = (next(it).view(shape) * std if std else
                     torch.zeros(shape, dtype=torch.float32, device=device))
    return out


# ---------------------------------------------------------------------------
# Layers, in float32.
# ---------------------------------------------------------------------------


def layernorm(x, p, eps):
    mu = x.mean(-1, keepdim=True)
    var = torch.square(x - mu).mean(-1, keepdim=True)
    return (x - mu) * torch.rsqrt(var + eps) * (1.0 + p["scale"]) + p["bias"]


def attention(hq, hkv, p, n_heads, causal, prec):
    """Multi-head attention without biases: queries from ``hq``, keys and
    values from ``hkv``, scores scaled by 1/sqrt(head dim)."""
    b, sq, _ = hq.shape
    skv = hkv.shape[1]
    hd = p["wq"].shape[1] // n_heads

    def heads(x, w, s):
        return prec.mm(x, w).view(b, s, n_heads, hd).transpose(1, 2)

    q, k, v = heads(hq, p["wq"], sq), heads(hkv, p["wk"], skv), heads(hkv, p["wv"], skv)
    s = prec.mm(q, k.transpose(-1, -2)) / math.sqrt(hd)
    if causal:
        future = torch.ones(sq, skv, dtype=torch.bool, device=s.device).triu(1)
        s = s.masked_fill(future, float("-inf"))
    o = prec.mm(torch.softmax(s, dim=-1), v)
    return prec.mm(o.transpose(1, 2).reshape(b, sq, n_heads * hd), p["wo"])


def mlp(h, p, prec):
    """``gelu_tanh(h @ w1) @ w2``."""
    return prec.mm(F.gelu(prec.mm(h, p["w1"]), approximate="tanh"), p["w2"])


def nll_sum(x, table, labels, prec):
    """Summed next-token loss against the tied embedding ``table``."""
    logits = prec.mm(x, table.t())
    ll = torch.gather(logits, -1, labels[..., None])[..., 0]
    return torch.sum(torch.logsumexp(logits, dim=-1) - ll)


# ---------------------------------------------------------------------------
# Training: AdamW with global-norm clipping, the optimizer the configs state.
# ---------------------------------------------------------------------------


def hyper(cfg: dict) -> dict:
    a, o = cfg["arch"], cfg["optimizer"]
    if a.get("optimizer", "adamw") != "adamw":
        raise ValueError(f"the reference runs AdamW, not {a['optimizer']!r}")
    return dict(lr=a["learning_rate"], wd=a["weight_decay"], clip=a["grad_clip"],
                b1=o["b1"], b2=o["b2"], eps=o["eps"])


def train(model, cfg, params0: dict, batches, prec=None, block_rows=4,
          state_dtype=torch.float32) -> dict:
    """The steps of ``batches`` from ``params0`` (left as they are): each
    step's mean loss over its rows, the global norm, every gradient scaled
    by ``min(1, clip / norm)``, AdamW with bias correction and decoupled
    weight decay, a constant learning rate. The rows go through in blocks
    of ``block_rows``, their gradients summed. ``state_dtype`` is the type
    the parameters and moments are kept in between steps (the control's
    bfloat16 state rounds them after every update). Returns the losses,
    each leaf's clipped gradient norm at the first step, and each leaf's
    change over all the steps."""
    prec = prec or Precision()
    hp = hyper(cfg)
    paths = sorted(params0)

    def keep(x):
        return x.to(state_dtype).to(torch.float32)

    start = {k: keep(params0[k].detach()) for k in paths}
    params = {k: start[k].clone().requires_grad_(True) for k in paths}
    m = {k: torch.zeros_like(params[k]) for k in paths}
    v = {k: torch.zeros_like(params[k]) for k in paths}
    out = {"losses": []}
    for t, batch in enumerate(batches, 1):
        rows = batch["tokens"].shape[0]
        count = rows * model.positions(cfg)
        total = 0.0
        for r0 in range(0, rows, block_rows):
            part = {k: x[r0:r0 + block_rows] for k, x in batch.items()}
            s = model.loss_sum(cfg, nest(params), part, prec)
            (s / count).backward()
            total += float(s.detach())
        out["losses"].append(total / count)
        with torch.no_grad():
            norm = torch.sqrt(sum(torch.sum(torch.square(params[k].grad)) for k in paths))
            scale = torch.clamp(hp["clip"] / torch.clamp(norm, min=1e-9), max=1.0)
            bc1, bc2 = 1.0 - hp["b1"] ** t, 1.0 - hp["b2"] ** t
            if t == 1:
                out["grads"] = {k: params[k].grad * scale for k in paths}
                out["grad_norms"] = {k: float(torch.linalg.vector_norm(g))
                                     for k, g in out["grads"].items()}
            for k in paths:
                p, g = params[k], params[k].grad * scale
                m[k].mul_(hp["b1"]).add_((1 - hp["b1"]) * g)
                v[k].mul_(hp["b2"]).add_((1 - hp["b2"]) * torch.square(g))
                u = (m[k] / bc1) / (torch.sqrt(v[k] / bc2) + hp["eps"]) + hp["wd"] * p
                p.sub_(hp["lr"] * u)
                for x in (p, m[k], v[k]):
                    x.copy_(keep(x))
                p.grad = None
    out["change_norms"] = {k: float(torch.linalg.vector_norm(params[k].detach() - start[k]))
                           for k in paths}
    return out


# ---------------------------------------------------------------------------
# The replication payload's int8 block encode.
# ---------------------------------------------------------------------------


def encode(x):
    """A float32 tensor read flat, zero-padded to whole blocks of 256 →
    (int8 codes (nb, 256), float32 scales (nb,)): ``scale = max(max|x|,
    1e-12) * float32(1/127)``, ``code = clamp(round_half_even(x / scale),
    ±127)``."""
    xf = x.reshape(-1).to(torch.float32)
    xb = F.pad(xf, (0, (-xf.numel()) % Q_BLOCK)).reshape(-1, Q_BLOCK)
    scale = torch.clamp(torch.amax(torch.abs(xb), dim=1), min=1e-12) * (1.0 / 127.0)
    codes = torch.clamp(torch.round(xb / scale[:, None]), -127, 127).to(torch.int8)
    return codes, scale
