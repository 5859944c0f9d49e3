"""attention_bwd_roofline (kernels, ``csrc/attention_bwd.cuh``): the least
time the window's attention backward launches could take, each the larger
of its operations over the bf16 peak and its bytes over the memory rate,
over the device time of the backward's kernels (``attn_bwd_*``) in the
trace.

The yardstick, written here and frozen: 10·hd operations per admitted
(query, key) pair and head (``yardstick.admitted_pairs``), the five
products of an attention backward (S = QKᵀ, dV = Pᵀ dO, dP = dO Vᵀ,
dK = dSᵀ Q, dQ = dS K) at 2·hd each; bytes for q, k, v, o and dO read once
and dq, dk and dv written once, in the inputs' type, and each query row's
log-sum-exp and D = rowsum(dO ∘ O) once each in fp32.

A program without the backward kernels has nothing to hook: the metric
then records no call and reads nothing.
"""
import importlib

from chaosbench import yardstick as Y

TARGET = "repro_torch.kernels.flash_attention:flash_attention_bwd_kernel"


def shape(q, k, v, o, lse, do, *, scale, softcap=0.0, kind="causal", window=0,
          prefix_len=0, q_offset=0):
    B, Sq, H, hd = q.shape
    return (B, Sq, k.shape[1], H, k.shape[2], hd, kind, int(window), int(prefix_len),
            int(q_offset), q.element_size())


def present(target: str) -> bool:
    """Whether the program has the ``"module:attribute"`` ``target``."""
    module, _, name = target.partition(":")
    try:
        return hasattr(importlib.import_module(module), name)
    except ImportError:
        return False


CALLS = {"attention_bwd": (TARGET, shape)} if present(TARGET) else {}


def cost(B, Sq, Skv, H, K, hd, pairs, itemsize=2):
    """(operations, bytes) of one attention backward over ``pairs``
    admitted pairs per head."""
    flops = 10 * B * H * hd * pairs
    nbytes = (itemsize * (4 * B * Sq * H * hd + 4 * B * Skv * K * hd)
              + 4 * 2 * B * H * Sq)
    return flops, nbytes


def read(run):
    calls = run.calls.get("attention_bwd", [])
    if run.trace is None or not calls:
        return None
    device = run.trace.seconds_of("attn_bwd")
    if device <= 0:
        return None
    least = 0.0
    for B, Sq, Skv, H, K, hd, kind, window, prefix, q_offset, itemsize in calls:
        pairs = Y.admitted_pairs(kind, window, prefix, Sq, Skv, q_offset)
        flops, nbytes = cost(B, Sq, Skv, H, K, hd, pairs, itemsize)
        least += Y.bound_s(flops, nbytes, Y.PEAK_BF16_FLOPS)
    return 100.0 * least / device
