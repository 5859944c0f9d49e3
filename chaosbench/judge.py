"""The numbers that decide ``correct``, each compared with its limit
(``limits/<config>.json``).

Training steps (the first three, which the reference follows):

- ``loss_gap``: the largest relative gap of a step's loss;
- ``grad_gap``: over the leaves, the largest gap between the norm of the
  program's first clipped gradient (worked out from its first moment after
  one step, ``m / (1 - b1)``) and the reference's, over the reference's
  norm of that leaf or of the median leaf, whichever is larger;
- ``change_gap``: the same of each leaf's change over the three steps,
  leaving out the leaves whose reference gradient is under ``NOUGHT`` of
  the median leaf's (they move by rounding alone);
- ``grad_diff``: over the leaves, the largest norm of the difference
  between the program's first clipped gradient and the reference's, over
  the same base as ``grad_gap``. A gap of norms moves only in second order
  when every element of a leaf is rounded (the errors average out over
  the leaf), so it cannot tell products in float8 from products in
  bfloat16; the difference moves in first order. ``grad_diff_median``
  is the median leaf's, where the worst leaf's swings with the rounding
  noise of one small leaf.

Exact ones, whose limit is 0: ``codec_mismatch`` (codes, scales and raw
leaves of an int8 encode against the reference's encode of the same
state), ``push_mismatch`` (bytes of a replica push, restored, against the
state pushed), ``join_state_mismatch`` (bytes of a join's state after it
against before it).
"""
from __future__ import annotations

import statistics

import torch

from chaosbench.reference.common import encode

NOUGHT = 1e-3


def _gap(prog: dict, ref: dict, keys) -> tuple:
    base = statistics.median(ref[k] for k in keys)
    worst = max(keys, key=lambda k: abs(prog[k] - ref[k]) / max(ref[k], base))
    return abs(prog[worst] - ref[worst]) / max(ref[worst], base), worst


def step_readings(prog: dict, ref: dict) -> dict:
    """Readings of ``prog`` against ``ref``, each a dict of ``losses``,
    ``grad_norms`` and ``change_norms`` (path → norm), and ``grads`` (path →
    the first clipped gradient, or a callable giving it). Beside the
    compared ones, the first step's loss gap."""
    gaps = [abs(a - b) / abs(b) for a, b in zip(prog["losses"], ref["losses"], strict=True)]
    keys = sorted(ref["grad_norms"])
    grad_gap, grad_leaf = _gap(prog["grad_norms"], ref["grad_norms"], keys)
    median = statistics.median(ref["grad_norms"][k] for k in keys)
    moved = [k for k in keys if ref["grad_norms"][k] >= NOUGHT * median]
    change_gap, change_leaf = _gap(prog["change_norms"], ref["change_norms"], moved)
    diffs = {k: float(torch.linalg.vector_norm(_tensor(prog["grads"][k])
                                               - _tensor(ref["grads"][k])))
             / max(ref["grad_norms"][k], median) for k in keys}
    diff_leaf = max(keys, key=diffs.get)
    return {"loss_gap": max(gaps), "grad_gap": grad_gap, "change_gap": change_gap,
            "grad_diff": diffs[diff_leaf],
            "grad_diff_median": statistics.median(diffs.values()),
            "loss_gap_first": gaps[0],
            "worst": {"grad_gap": "/".join(grad_leaf), "change_gap": "/".join(change_leaf),
                      "grad_diff": "/".join(diff_leaf),
                      "left_out": ["/".join(k) for k in keys if k not in moved]}}


def _tensor(x):
    return x() if callable(x) else x


def _bytes(t: torch.Tensor) -> torch.Tensor:
    return t.detach().contiguous().reshape(-1).view(torch.uint8)


def byte_mismatch(got: torch.Tensor, want: torch.Tensor) -> int:
    """Bytes that differ; every byte when dtype or shape differ."""
    if got.dtype != want.dtype or tuple(got.shape) != tuple(want.shape):
        return max(_bytes(want).numel(), 1)
    return int((_bytes(got) != _bytes(want.to(got.device))).sum())


def codec_mismatch(captured, state: dict, device) -> int:
    """``captured``: (path, kind, codes, scales, raw) of each leaf of an
    int8 encode; ``state``: path → the leaf encoded. Codes and scales of
    an int8 leaf count one each that differ from the reference's encode;
    a raw leaf counts its bytes that differ."""
    bad = 0
    if sorted(p for p, *_ in captured) != sorted(state):
        return max(len(state), 1)
    for path, kind, codes, scales, raw in captured:
        leaf = state[path].to(device)
        coded = leaf.dtype == torch.float32 and leaf.numel() > 0
        if kind != ("int8" if coded else "raw"):
            bad += max(leaf.numel(), 1)
        elif kind == "raw":
            bad += byte_mismatch(raw.to(device), leaf)
        else:
            want_codes, want_scales = encode(leaf)
            if codes.shape != want_codes.shape or scales.shape != want_scales.shape:
                bad += want_codes.numel() + want_scales.numel()
                continue
            bad += int((codes.to(device) != want_codes).sum())
            bad += int((scales.to(device).view(torch.int32)
                        != want_scales.view(torch.int32)).sum())
    return bad
