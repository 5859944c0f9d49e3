"""Public wrappers for the port's kernels, from ``repro/kernels/ops.py``.

Each wrapper launches its CUDA kernel for CUDA tensors and uses the plain
PyTorch version only for CPU tensors; any other device raises. There is no
fallback from a CUDA tensor to a plain version.

``launches`` counts the kernel launches made through these wrappers (plain
ints, one per kernel), so a run can show that the main path went through
the kernels. Calls of the kernel functions themselves — as when a check
compares a kernel with its plain version — do not count.

Autodiff: ``flash_attention`` is a ``torch.autograd.Function`` whose forward
is the kernel and whose backward differentiates the plain attention, as the
JAX package's ``_fa_bwd`` differentiates its XLA path. The JAX package has
no backward kernel, so the port has none either.
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.kernels import flash_attention as _fa
from repro_torch.kernels import shard_codec as _codec

launches = {"shard_encode": 0, "shard_decode": 0, "flash_attention": 0}


def reset_launches() -> None:
    for name in launches:
        launches[name] = 0


def _on_card(t: torch.Tensor, what: str) -> bool:
    if t.is_cuda:
        return True
    if t.device.type == "cpu":
        return False
    raise ValueError(f"{what}: no kernel or plain version for {t.device}")


# ---------------------------------------------------------------------------
# Flash attention.
# ---------------------------------------------------------------------------


class _FlashAttention(torch.autograd.Function):
    @staticmethod
    def forward(ctx, q, k, v, spec, scale, softcap, q_offset):
        ctx.save_for_backward(q, k, v)
        ctx.static = (spec, scale, softcap, q_offset)
        if _on_card(q, "flash_attention"):
            launches["flash_attention"] += 1
            return _fa.flash_attention_kernel(
                q, k, v, scale=scale, softcap=softcap, kind=spec.kind,
                window=spec.window, prefix_len=spec.prefix_len,
                q_offset=q_offset)
        return _fa.attention_plain(q, k, v, spec, scale=scale,
                                   softcap=softcap, q_offset=q_offset)

    @staticmethod
    def backward(ctx, g):
        spec, scale, softcap, q_offset = ctx.static
        q, k, v = (t.detach().requires_grad_(True) for t in ctx.saved_tensors)
        with torch.enable_grad():
            out = _fa.attention_plain(q, k, v, spec, scale=scale,
                                      softcap=softcap, q_offset=q_offset)
            dq, dk, dv = torch.autograd.grad(out, (q, k, v), g)
        return dq, dk, dv, None, None, None, None


def flash_attention(q, k, v, spec, *, scale, softcap=0.0, q_offset=0,
                    is_local: Optional[bool] = None):
    """Contract-compatible with ``models.layers.blocked_attention``.
    ``is_local`` is None or a bool: ``False`` drops the window."""
    from repro_torch.models.layers import MaskSpec

    if is_local is not None and not isinstance(is_local, bool):
        raise ValueError("flash_attention needs a static (bool) is_local")
    if is_local is False:
        spec = MaskSpec(spec.kind, window=0, prefix_len=spec.prefix_len)
    return _FlashAttention.apply(q, k, v, spec, float(scale), float(softcap),
                                 int(q_offset))


# ---------------------------------------------------------------------------
# Shard codec.
# ---------------------------------------------------------------------------


def shard_encode(x: torch.Tensor):
    """Flat fp32 leaf → (codes int8 (nb, 256), scales fp32 (nb,))."""
    if _on_card(x, "shard_encode"):
        launches["shard_encode"] += 1
        return _codec.shard_encode_kernel(x)
    return _codec.shard_encode_plain(x)


def shard_decode(codes: torch.Tensor, scales: torch.Tensor,
                 numel: Optional[int] = None) -> torch.Tensor:
    if _on_card(codes, "shard_decode"):
        launches["shard_decode"] += 1
        return _codec.shard_decode_kernel(codes, scales, numel)
    return _codec.shard_decode_plain(codes, scales, numel)
