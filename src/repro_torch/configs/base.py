"""Architecture / run configuration, a copy of ``repro/configs/base.py``.

Every architecture is described by an :class:`ArchConfig`, a plain frozen
dataclass. ``reduced()`` derives the small smoke-test variant of the same
family. The port keeps its own copy so that it runs where the JAX package
cannot be imported; the two must stay field-for-field equal.
"""
from __future__ import annotations

import dataclasses
import math
from dataclasses import dataclass, field, replace
from typing import Optional, Tuple

# ---------------------------------------------------------------------------
# Shape cells (assigned input shapes; identical for every LM-family arch).
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class ShapeCell:
    name: str
    seq_len: int
    global_batch: int
    kind: str  # "train" | "prefill" | "decode"


SHAPE_CELLS: Tuple[ShapeCell, ...] = (
    ShapeCell("train_4k", 4_096, 256, "train"),
    ShapeCell("prefill_32k", 32_768, 32, "prefill"),
    ShapeCell("decode_32k", 32_768, 128, "decode"),
    ShapeCell("long_500k", 524_288, 1, "decode"),
)

SHAPES = {c.name: c for c in SHAPE_CELLS}


# ---------------------------------------------------------------------------
# Architecture config.
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class ArchConfig:
    name: str
    family: str  # dense | moe | ssm | hybrid | encdec | vlm
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab: int
    head_dim: int = 0  # 0 -> d_model // n_heads

    # Norm / MLP / position variants.
    norm: str = "rmsnorm"  # rmsnorm | layernorm
    mlp: str = "swiglu"  # swiglu | geglu | gelu2 (2-matrix)
    positions: str = "rope"  # rope | learned
    rope_theta: float = 10_000.0
    tie_embeddings: bool = False
    norm_eps: float = 1e-6

    # Gemma2-style extras.
    attn_softcap: float = 0.0  # 0 disables
    final_softcap: float = 0.0
    sliding_window: int = 0  # 0 disables; >0 with alt_local_global on even layers
    alt_local_global: bool = False
    query_scale: Optional[float] = None  # override 1/sqrt(head_dim)
    post_norm: bool = False  # gemma2 sandwich norms
    embed_scale: bool = False  # gemma family: x *= sqrt(d_model)

    # MoE extras.
    n_experts: int = 0
    top_k: int = 0
    moe_d_ff: int = 0
    n_shared_experts: int = 0
    dense_residual: bool = False  # arctic: dense FFN in parallel with MoE
    capacity_factor: float = 1.25

    # SSM / hybrid extras.
    ssm_state: int = 0
    ssm_expand: int = 2
    ssm_heads: int = 0  # mamba2 heads (d_inner // head size)
    shared_attn_every: int = 0  # zamba2: shared block applied every N blocks

    # Encoder-decoder / VLM extras.
    enc_layers: int = 0
    enc_len: int = 0  # stub frontend sequence length (whisper frames)
    n_patches: int = 0  # vlm stub patch count

    # Training knobs.
    dtype: str = "bfloat16"
    param_dtype: str = "float32"
    optimizer: str = "adamw"  # adamw | adamw8bit | sgdm
    learning_rate: float = 3e-4
    weight_decay: float = 0.1
    grad_clip: float = 1.0
    remat: bool = True

    # Sharding policy knobs (see launch/mesh.py for axis names).
    fsdp: bool = True  # shard params over "data" too (ZeRO-3 style)
    shard_cache_heads_min: int = 16  # kv-heads >= this -> shard heads, else seq

    def __post_init__(self):
        if self.head_dim == 0:
            object.__setattr__(self, "head_dim", self.d_model // max(self.n_heads, 1))

    # -- derived quantities ------------------------------------------------

    @property
    def attn_free(self) -> bool:
        return self.family == "ssm"

    @property
    def is_moe(self) -> bool:
        return self.n_experts > 0

    @property
    def q_dim(self) -> int:
        return self.n_heads * self.head_dim

    @property
    def kv_dim(self) -> int:
        return self.n_kv_heads * self.head_dim

    def supports_cell(self, cell: ShapeCell) -> Tuple[bool, str]:
        """Whether this arch runs the given shape cell (DESIGN.md §4 skips)."""
        if cell.name == "long_500k" and self.family not in ("ssm", "hybrid"):
            return False, "long_500k needs sub-quadratic attention (full-attn arch)"
        return True, ""

    # -- parameter counting (analytic; cross-checked in tests) --------------

    def param_count(self) -> int:
        d, ff, V = self.d_model, self.d_ff, self.vocab
        emb = V * d * (1 if self.tie_embeddings else 2)
        if self.family == "ssm":  # rwkv6
            per = self._rwkv6_layer_params()
            return emb + self.n_layers * per + 2 * d  # final norm
        if self.family == "hybrid":  # zamba2
            per = self._mamba2_layer_params()
            shared = self._shared_block_params()
            return emb + self.n_layers * per + shared + d
        attn = self._attn_params()
        if self.is_moe:
            ffp = self.n_experts * self._expert_params()
            ffp += self.n_shared_experts * self._expert_params()
            ffp += d * self.n_experts  # router
            if self.dense_residual:
                ffp += self._mlp_params(self.d_ff)
        else:
            ffp = self._mlp_params(ff)
        norms = 2 * d
        per_layer = attn + ffp + norms
        n_attn_layers = self.n_layers
        if self.family == "encdec":
            # enc self-attn + dec self-attn + dec cross-attn, each with own MLP.
            enc = self.enc_layers * (attn + self._mlp_params(ff) + norms)
            dec = self.n_layers * (2 * attn + self._mlp_params(ff) + 3 * d)
            pos = (32_768 + self.enc_len) * d if self.positions == "learned" else 0
            return emb + enc + dec + pos + 2 * d
        pos = 32_768 * d if self.positions == "learned" else 0
        return emb + self.n_layers * per_layer + pos + d

    def _attn_params(self) -> int:
        d = self.d_model
        return d * self.q_dim + 2 * d * self.kv_dim + self.q_dim * d

    def _mlp_params(self, ff: int) -> int:
        d = self.d_model
        return (3 if self.mlp in ("swiglu", "geglu") else 2) * d * ff

    def _expert_params(self) -> int:
        return 3 * self.d_model * self.moe_d_ff

    def _rwkv6_layer_params(self) -> int:
        d, ff = self.d_model, self.d_ff
        tm = 5 * d * d + 2 * 64 * d + 6 * d  # r,k,v,g,o + decay lora + mus
        cm = 2 * d * ff + d * d  # ffn k,v + receptance
        return tm + cm + 4 * d

    def _mamba2_layer_params(self) -> int:
        d = self.d_model
        d_in = self.ssm_expand * d
        heads = self.ssm_heads or (d_in // 64)
        # in_proj -> [z, x, B, C, dt], conv (x,B,C), out_proj, norms, A/D.
        conv_dim = d_in + 2 * self.ssm_state
        return (
            d * (2 * d_in + 2 * self.ssm_state + heads)
            + 4 * conv_dim
            + d_in * d
            + 2 * heads
            + 2 * d
            + d_in
        )

    def _shared_block_params(self) -> int:
        d = self.d_model
        proj = 2 * d * d  # concat([h, h0]) -> d
        attn = self._attn_params()
        mlp = self._mlp_params(self.d_ff)
        return proj + attn + mlp + 3 * d

    def model_flops_per_token(self, train: bool = True) -> float:
        """6*N (train) or 2*N (inference) with N = active params (MoE-aware)."""
        n = self.active_param_count()
        return (6.0 if train else 2.0) * n

    def active_param_count(self) -> int:
        if not self.is_moe:
            return self.param_count()
        total = self.param_count()
        inactive = (self.n_experts - self.top_k) * self._expert_params() * self.n_layers
        return total - inactive

    # -- smoke-test reduction ------------------------------------------------

    def reduced(self) -> "ArchConfig":
        """Tiny same-family variant for CPU smoke tests."""
        kw = dict(
            n_layers=max(2, min(self.n_layers, 2)),
            d_model=64,
            n_heads=4,
            n_kv_heads=min(self.n_kv_heads, 2) if self.n_kv_heads else 0,
            head_dim=16,
            d_ff=128,
            vocab=256,
            remat=False,
            fsdp=False,
        )
        if self.is_moe:
            kw.update(n_experts=4, top_k=min(self.top_k, 2), moe_d_ff=32)
        if self.family in ("ssm", "hybrid"):
            kw.update(ssm_state=8, ssm_heads=4)
        if self.family == "hybrid":
            kw.update(shared_attn_every=2, n_kv_heads=4)
        if self.family == "encdec":
            kw.update(enc_layers=2, enc_len=16)
        if self.family == "vlm":
            kw.update(n_patches=4)
        if self.sliding_window:
            kw.update(sliding_window=8)
        return replace(self, name=self.name + "-reduced", **kw)


# Registry filled by the per-arch modules.
_REGISTRY: dict = {}


def register(cfg: ArchConfig) -> ArchConfig:
    _REGISTRY[cfg.name] = cfg
    return cfg


def get_config(name: str) -> ArchConfig:
    from repro_torch import configs  # noqa: F401  (triggers per-arch module imports)

    if name not in _REGISTRY:
        raise KeyError(f"unknown arch {name!r}; known: {sorted(_REGISTRY)}")
    return _REGISTRY[name]


def list_configs() -> list:
    from repro_torch import configs  # noqa: F401

    return sorted(_REGISTRY)
