"""Public wrappers for the port's kernels, from ``repro/kernels/ops.py``.

Each wrapper launches its CUDA kernel for CUDA tensors and uses the plain
PyTorch version only for CPU tensors; any other device raises. There is no
fallback from a CUDA tensor to a plain version.

``launches`` counts the kernel launches made through these wrappers (plain
ints, one per kernel), so a run can show that the main path went through
the kernels. Calls of the kernel functions themselves — as when a check
compares a kernel with its plain version — do not count.

Autodiff: ``flash_attention``, ``wkv6`` and ``ssd`` are
``torch.autograd.Function``s whose forward is the kernel. A bf16 attention
call on the card that needs gradients, at a head dim the backward kernels
take (``flash_attention.backward_regime``), gets dq, dk and dv from them
(``csrc/attention_bwd.cuh``): its forward writes each query row's
log-sum-exp beside the output, and ``launches["flash_attention_bwd"]``
counts the backward calls. Every other backward differentiates the plain
version, as the JAX package's ``_fa_bwd``, ``_wkv6_bwd`` and ``_ssd_bwd``
differentiate their XLA paths (the scans at ``chunk=min(chunk, 32)``): the
CPU path, fp32 attention on the card, head dim 256, and WKV6 and SSD, which
have no backward kernel. Each plain backward runs inside a span
(``repro_torch.spans``) named ``<name>_plain_backward``: under a profiler a
``record_function`` range, so that a profile can attribute its device time.

On the meta device (the dry run's trace) ``flash_attention``, ``wkv6`` and
``ssd`` return empty outputs of the kernel's shapes and report the
kernel's analytic operations and bytes (``kernels.cost``) to ``trace_sink``
when one is set; nothing launches and nothing is counted in ``launches``.
Their backwards trace the plain versions, as they run them.
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch import spans
from repro_torch.kernels import cost as _cost
from repro_torch.kernels import flash_attention as _fa
from repro_torch.kernels import shard_codec as _codec
from repro_torch.kernels import ssd as _ssd
from repro_torch.kernels import wkv6 as _wkv6

launches = {"shard_encode": 0, "shard_decode": 0, "flash_attention": 0,
            "wkv6": 0, "ssd": 0, "flash_attention_bwd": 0}
#: names of the profiler ranges around the plain backwards.
BACKWARD_RANGES = ("flash_attention_plain_backward", "wkv6_plain_backward",
                   "ssd_plain_backward")


#: Set by ``launch/trace_analysis.py`` while it traces: its ``kernel(name,
#: flops, nbytes)`` is called for each kernel entry met on the meta device,
#: and its ``vjp(key, run)`` runs or replays a plain backward.
trace_sink = None


def _traced(name, flops_bytes, *outs):
    if trace_sink is not None:
        trace_sink.kernel(name, *flops_bytes)
    return outs[0] if len(outs) == 1 else outs


def reset_launches() -> None:
    for name in launches:
        launches[name] = 0


def _on_card(t: torch.Tensor, what: str) -> bool:
    if t.is_cuda:
        return True
    if t.device.type == "cpu":
        return False
    raise ValueError(f"{what}: no kernel or plain version for {t.device}")


def _plain_vjp(fn, args, n_diff, grads, name, static=()):
    """Gradients of the plain version ``fn(*args)`` (a tuple of outputs)
    with respect to its first ``n_diff`` args, against the output grads
    ``grads`` (None where an output was unused), inside the span ``name``. Args past ``n_diff`` are passed as they are. On the meta
    device under a trace, the trace may stand in its record of an earlier
    call with the same shapes and ``static`` arguments (``trace_sink.vjp``)."""
    if trace_sink is not None and args[0].is_meta:
        key = (name, static, n_diff, tuple(g is not None for g in grads),
               tuple(None if a is None else (tuple(a.shape), a.dtype) for a in args))
        return trace_sink.vjp(key, lambda: _run_vjp(fn, args, n_diff, grads, name))
    return _run_vjp(fn, args, n_diff, grads, name)


def _run_vjp(fn, args, n_diff, grads, name):
    live = [a.detach().requires_grad_(True) for a in args[:n_diff]]
    with torch.enable_grad(), spans.span(name):
        outs = fn(*live, *args[n_diff:])
        used = [(o, g) for o, g in zip(outs, grads) if g is not None]
        if not used:
            return [None] * n_diff
        return list(torch.autograd.grad([o for o, _ in used],
                                        live, [g for _, g in used]))


# ---------------------------------------------------------------------------
# Flash attention.
# ---------------------------------------------------------------------------


class _FlashAttention(torch.autograd.Function):
    @staticmethod
    def forward(ctx, q, k, v, spec, scale, softcap, q_offset, grad_enabled):
        ctx.static = (spec, scale, softcap, q_offset)
        if q.is_meta:
            ctx.save_for_backward(q, k, v, None, None)
            B, Sq, H, hd = q.shape
            Skv, K = k.shape[1], k.shape[2]
            pairs = _cost.admitted_pairs(spec.kind, spec.window, spec.prefix_len,
                                         Sq, Skv, q_offset)
            return _traced("flash_attention", _cost.attention(
                B, Sq, Skv, H, K, hd, pairs, itemsize=q.element_size()),
                torch.empty_like(q))
        if not _on_card(q, "flash_attention"):
            ctx.save_for_backward(q, k, v, None, None)
            return _fa.attention_plain(q, k, v, spec, scale=scale,
                                       softcap=softcap, q_offset=q_offset)
        launches["flash_attention"] += 1
        mask = dict(scale=scale, softcap=softcap, kind=spec.kind, window=spec.window,
                    prefix_len=spec.prefix_len, q_offset=q_offset)
        if not (grad_enabled and any(ctx.needs_input_grad[:3])
                and _fa.backward_regime(q.dtype, q.shape[-1]) == "wgmma"):
            ctx.save_for_backward(q, k, v, None, None)
            return _fa.flash_attention_kernel(q, k, v, **mask)
        B, Sq, H, _ = q.shape
        lse = torch.empty((B, H, Sq), dtype=torch.float32, device=q.device)
        with _fa.writing_lse(lse):
            o = _fa.flash_attention_kernel(q, k, v, **mask)
        ctx.save_for_backward(q, k, v, o, lse)
        return o

    @staticmethod
    def backward(ctx, g):
        spec, scale, softcap, q_offset = ctx.static
        q, k, v, o, lse = ctx.saved_tensors
        if lse is not None:
            launches["flash_attention_bwd"] += 1
            dq, dk, dv = _fa.flash_attention_bwd_kernel(
                q, k, v, o, lse, g, scale=scale, softcap=softcap, kind=spec.kind,
                window=spec.window, prefix_len=spec.prefix_len, q_offset=q_offset)
            return dq, dk, dv, None, None, None, None, None

        def plain(q, k, v):
            return (_fa.attention_plain(q, k, v, spec, scale=scale,
                                        softcap=softcap, q_offset=q_offset),)

        dq, dk, dv = _plain_vjp(plain, (q, k, v), 3, (g,),
                                BACKWARD_RANGES[0], ctx.static)
        return dq, dk, dv, None, None, None, None, None


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
                                 int(q_offset), torch.is_grad_enabled())


# ---------------------------------------------------------------------------
# Recurrences: WKV6 and SSD.
# ---------------------------------------------------------------------------


class _WKV6(torch.autograd.Function):
    @staticmethod
    def forward(ctx, r, k, v, lw, u, state, chunk):
        ctx.set_materialize_grads(False)
        ctx.save_for_backward(r, k, v, lw, u, state)
        ctx.chunk = chunk
        if r.is_meta:
            B, S, H, hd = r.shape
            return _traced("wkv6", _cost.wkv6(B, S, H, hd, state_in=state is not None,
                                              itemsize=r.element_size()),
                           r.new_empty((B, S, H, hd), dtype=torch.float32),
                           r.new_empty((B, H, hd, hd), dtype=torch.float32))
        if _on_card(r, "wkv6"):
            launches["wkv6"] += 1
            return _wkv6.wkv6_kernel(r, k, v, lw, u, state, chunk=chunk)
        return _wkv6.wkv6_plain(r, k, v, lw, u, state, chunk=chunk)

    @staticmethod
    def backward(ctx, g_out, g_state):
        r, k, v, lw, u, state = ctx.saved_tensors
        chunk = min(ctx.chunk, 32)

        def plain(r, k, v, lw, u, state):
            return _wkv6.wkv6_plain(r, k, v, lw, u, state, chunk=chunk)

        n_diff = 5 if state is None else 6  # no initial state, no gradient
        grads = _plain_vjp(plain, (r, k, v, lw, u, state), n_diff,
                           (g_out, g_state), BACKWARD_RANGES[1], (chunk,))
        return (*grads, *[None] * (7 - n_diff))


def wkv6(r, k, v, lw, u, state=None, *, chunk=64):
    """RWKV-6 recurrence, contract of ``kernels.wkv6``: returns (out fp32,
    final state fp32). Gradients flow to r, k, v, lw, u, and to ``state``
    when one is given."""
    return _WKV6.apply(r, k, v, lw, u, state, int(chunk))


class _SSD(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, dt, A_log, Bm, Cm, state, chunk):
        ctx.set_materialize_grads(False)
        ctx.save_for_backward(x, dt, A_log, Bm, Cm, state)
        ctx.chunk = chunk
        if x.is_meta:
            B, S, H, P = x.shape
            N = Bm.shape[-1]
            return _traced("ssd", _cost.ssd(B, S, H, P, N, state_in=state is not None,
                                            itemsize=x.element_size()),
                           x.new_empty((B, S, H, P), dtype=torch.float32),
                           x.new_empty((B, H, P, N), dtype=torch.float32))
        if _on_card(x, "ssd"):
            launches["ssd"] += 1
            return _ssd.ssd_kernel(x, dt, A_log, Bm, Cm, state, chunk=chunk)
        return _ssd.ssd_plain(x, dt, A_log, Bm, Cm, state, chunk=chunk)

    @staticmethod
    def backward(ctx, g_y, g_state):
        x, dt, A_log, Bm, Cm, state = ctx.saved_tensors
        chunk = min(ctx.chunk, 32)

        def plain(x, dt, A_log, Bm, Cm, state):
            return _ssd.ssd_plain(x, dt, A_log, Bm, Cm, state, chunk=chunk)

        n_diff = 5 if state is None else 6  # no initial state, no gradient
        grads = _plain_vjp(plain, (x, dt, A_log, Bm, Cm, state), n_diff,
                           (g_y, g_state), BACKWARD_RANGES[2], (chunk,))
        return (*grads, *[None] * (7 - n_diff))


def ssd(x, dt, A_log, Bm, Cm, state=None, *, chunk=64):
    """Mamba2 SSD scan, contract of ``kernels.ssd``: returns (y fp32, final
    state fp32). Gradients flow to x, dt, A_log, Bm, Cm, and to ``state``
    when one is given."""
    return _SSD.apply(x, dt, A_log, Bm, Cm, state, int(chunk))


# ---------------------------------------------------------------------------
# Shard codec.
# ---------------------------------------------------------------------------


def shard_encode_many(leaves):
    """fp32 leaves on one device → (codes int8 (Σnb, 256), scales fp32
    (Σnb,), firsts): leaf ``i`` is rows ``firsts[i]:firsts[i + 1]``, equal
    to its one-leaf encode. One kernel launch for all leaves on the card."""
    if leaves and _on_card(leaves[0], "shard_encode_many"):
        if any(x.numel() for x in leaves):
            launches["shard_encode"] += 1
        return _codec.shard_encode_many_kernel(leaves)
    return _codec.shard_encode_many_plain(leaves)


def shard_decode(codes: torch.Tensor, scales: torch.Tensor,
                 numel: Optional[int] = None) -> torch.Tensor:
    if _on_card(codes, "shard_decode"):
        launches["shard_decode"] += 1
        return _codec.shard_decode_kernel(codes, scales, numel)
    return _codec.shard_decode_plain(codes, scales, numel)


def shard_decode_many(codes_list, scales_list, numels):
    """Per leaf int8 codes ``(nb, 256)``, fp32 scales ``(nb,)`` and a numel
    → one flat fp32 tensor of ``numel`` values per leaf, each equal to its
    one-leaf decode. One kernel launch for all leaves on the card."""
    if codes_list and _on_card(codes_list[0], "shard_decode_many"):
        if any(numels):
            launches["shard_decode"] += 1
        return _codec.shard_decode_many_kernel(codes_list, scales_list, numels)
    return _codec.shard_decode_many_plain(codes_list, scales_list, numels)
