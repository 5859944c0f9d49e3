"""The attention kernel's decode regime, on the CPU.

The regime (``csrc/flash_attention.cu``, bf16 with ``Sq·G <= 64``) cuts the
admitted keys into runs of whole 64-key tiles (``decode_split_plan``), one
CTA each, and merges the runs' fp32 partials in split order. The CUDA
kernels run only on the card (``tests/test_torch_cuda.py``); here:

- the plan, over the full-width decode shapes of every serving config
  (``chip_smoke.serve_attention_cases`` and each config of
  ``repro_torch.configs`` with attention): every key that
  ``layers._mask_block`` admits lies in exactly one split, no split holds a
  key the mask removes, no split is empty, and ``n_split`` stays within its
  limits;
- the merge: a plain split-and-merge (below, test-only) computes fp32
  partials per split in the kernel's log2 units and merges them in the
  kernel's order; it equals ``attention_plain`` and the JAX Pallas
  ``flash_attention_kernel`` (interpret mode) at fp32 ``_tol``.
"""
import importlib.util
import math
import pathlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.flash_attention import flash_attention_kernel as jax_flash_attention
from repro_torch.configs import get_config, list_configs
from repro_torch.kernels import flash_attention as fa
from repro_torch.models.layers import MaskSpec, _mask_block


def _load_chip_smoke():
    path = pathlib.Path(__file__).resolve().parents[1] / "chip_smoke.py"
    spec = importlib.util.spec_from_file_location("chip_smoke", path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


cs = _load_chip_smoke()
LOG2E = 1.4426950408889634
M_INIT = -1e30  # the kernel's kMInit
TOL = dict(rtol=2e-5, atol=2e-5)  # fp32 ``_tol`` of tests/test_kernels.py


# ---------------------------------------------------------------------------
# The plan.
# ---------------------------------------------------------------------------


def _serving_decode_cases():
    """``(label, B, Skv, H, K, hd, kind, window, prefix, q_offset)`` of every
    one-row bf16 case of ``chip_smoke.serve_attention_cases`` (the serving
    runs, gemma2's local and global layers, granite's 48:1 and llama3's
    128:8 at full width, Whisper's self and cross-attention), and of each
    config with attention at batch 1 and 8 over a cache of
    ``SERVE_CACHE`` rows behind its patches, at ``decode_q_offsets``."""
    cases = [(label, c[0], c[2], c[3], c[4], c[5], c[6], c[7], c[8], o)
             for label, c, _, o, _ in cs.serve_attention_cases() if c[1] == 1]
    for name in list_configs():
        cfg = get_config(name)
        if cfg.family == "ssm":
            continue
        pre = cs.prefix_rows(cfg)
        cache = pre + cs.SERVE_CACHE
        extra = (pre - 1, pre, pre + cs.SERVE_PROMPT - 1) if pre else ()
        for _, window in cs.layer_kinds(cfg):
            for B in (1, cs.SERVE_BATCH):
                cases += [(f"{name} B={B} window={window}", B, cache, cfg.n_heads,
                           cfg.n_kv_heads, cfg.head_dim, "prefix" if pre else "causal",
                           window, pre, o)
                          for o in cs.decode_q_offsets(cfg, cache, extra)]
    return cases


def _ranges(plan):
    """Each split's keys, ``[k0, k1)`` inside the admitted ``[lo, hi)``."""
    return [(max(plan.lo, t0 * fa.DECODE_KEYS), min(plan.hi, t1 * fa.DECODE_KEYS))
            for t0, t1 in map(plan.tiles, range(plan.n_split))]


DECODE_CASES = _serving_decode_cases()
#: One test per config (or serving label): the cases grouped by their first
#: word.
PLAN_GROUPS = sorted({c[0].split()[0] for c in DECODE_CASES})


def test_plan_covers_granite_and_llama3_full_width():
    heads = {(c[3], c[4]) for c in DECODE_CASES}
    assert (48, 1) in heads and (128, 8) in heads  # granite 48:1, llama3 128:8
    assert len(PLAN_GROUPS) >= 10


def _split_admitted(groups, n_tiles, n):
    """Whether ``decode_split_plan``'s rule admits ``n`` splits: within
    ``CTAS_PER_SM`` CTAs an SM, and either within one CTA an SM at
    ``MIN_SPLIT_TILES`` tiles a run or at ``LONG_RUN_TILES`` tiles a run."""
    ctas = groups * n
    return ctas <= fa.SMS * fa.CTAS_PER_SM and (
        (ctas <= fa.SMS and n_tiles >= fa.MIN_SPLIT_TILES * n)
        or n_tiles >= fa.LONG_RUN_TILES * n)


@pytest.mark.parametrize("group", PLAN_GROUPS)
def test_split_plan_puts_each_admitted_key_in_one_split(group):
    n = 0
    for label, B, Skv, H, K, hd, kind, window, prefix, q_offset in DECODE_CASES:
        if label.split()[0] != group:
            continue
        n += 1
        assert fa.regime(torch.bfloat16, 1, H, K) == "decode", label
        plan = fa.decode_split_plan(B, 1, Skv, K, kind, window, prefix, q_offset)
        admitted = _mask_block(MaskSpec(kind, window=window, prefix_len=prefix),
                               torch.tensor([q_offset]), torch.arange(Skv))[0]
        owner = torch.zeros(Skv, dtype=torch.int64)
        for k0, k1 in _ranges(plan):
            assert k1 > k0, (label, q_offset, plan)  # no split is empty
            owner[k0:k1] += 1
            assert bool(admitted[k0:k1].all()), (label, q_offset, plan)
        assert torch.equal(owner, admitted.long()), (label, q_offset, plan)
        assert 1 <= plan.n_split <= min(fa.MAX_SPLITS, max(plan.n_tiles, 1))
        # The most splits that the rule admits: the plan's count is admitted
        # (or 1), one more is not (or past MAX_SPLITS).
        assert plan.n_split == 1 or _split_admitted(B * K, plan.n_tiles, plan.n_split)
        assert (plan.n_split == fa.MAX_SPLITS
                or not _split_admitted(B * K, plan.n_tiles, plan.n_split + 1)), (label, plan)
        # The tiles the kernel walks are exactly the split's, end to end.
        tiles = [plan.tiles(j) for j in range(plan.n_split)]
        assert tiles[0][0] == plan.t_begin
        assert tiles[-1][1] == plan.t_begin + plan.n_tiles
        assert all(a[1] == b[0] for a, b in zip(tiles, tiles[1:]))
    assert n


def test_plan_of_an_empty_range_and_pinned_splits():
    plan = fa.decode_split_plan(2, 1, 0, 4)  # no key at all
    assert plan.n_tiles == 0 and plan.n_split == 1 and _ranges(plan) == [(0, 0)]
    plan = fa.decode_split_plan(1, 1, 1152, 1, q_offset=1151, n_split=7)
    assert plan.n_split == 7 and sum(k1 - k0 for k0, k1 in _ranges(plan)) == 1152
    # Sq rows widen the range: causal up to the last row's position.
    assert fa.admitted_keys("causal", 0, 0, 4, 1152, 100) == (0, 104)
    assert fa.admitted_keys("causal", 64, 0, 1, 1152, 100) == (37, 101)
    assert fa.admitted_keys("prefix", 64, 256, 1, 1408, 100) == (0, 256)
    assert fa.admitted_keys("full", 0, 0, 1, 1500, 0) == (0, 1500)


@pytest.mark.parametrize("Sq, H, K, want", [
    (1, 12, 12, "decode"), (1, 48, 1, "decode"), (1, 64, 1, "decode"),
    (1, 65, 1, "wgmma"), (8, 64, 8, "decode"), (9, 64, 8, "wgmma"),
    (64, 4, 4, "decode"), (65, 4, 4, "wgmma"), (1024, 12, 12, "wgmma")])
def test_regime_is_decided_by_shape(Sq, H, K, want):
    assert fa.regime(torch.bfloat16, Sq, H, K) == want
    assert fa.regime(torch.float32, Sq, H, K) == "fma"


def test_workspace_size():
    assert fa.decode_workspace_floats(8, 1, 56, 8, 128, 1) == 0
    assert fa.decode_workspace_floats(8, 1, 56, 8, 128, 5) == 8 * 8 * 5 * 7 * 130


# ---------------------------------------------------------------------------
# The merge.
# ---------------------------------------------------------------------------


def split_merge(q, k, v, spec, plan, *, scale, softcap=0.0, q_offset=0):
    """The decode regime's arithmetic in fp32, without its bf16 roundings:
    for each split (whole tiles, as the kernel walks them) its running max
    ``m`` in log2 units (from ``M_INIT``), its ``l`` and unnormalised ``o``;
    then the merge in split order: ``M = max m``, weights
    ``exp2(m - M)``, ``o / max(l, 1e-30)``."""
    B, Sq, H, hd = q.shape
    Skv, K = k.shape[1], k.shape[2]
    G = H // K
    s = torch.einsum("bqkgd,bjkd->bkgqj", q.reshape(B, Sq, K, G, hd), k)
    if softcap > 0:
        s = softcap * torch.tanh(s * scale / softcap)
        mul = LOG2E
    else:
        mul = scale * LOG2E
    mask = _mask_block(spec, q_offset + torch.arange(Sq), torch.arange(Skv))
    s = s.masked_fill(~mask, fa.NEG_INF)
    parts = []
    for j in range(plan.n_split):
        t0, t1 = plan.tiles(j)
        a, b = t0 * fa.DECODE_KEYS, min(t1 * fa.DECODE_KEYS, Skv)
        sj = s[..., a:b] * mul
        m = torch.clamp(sj.amax(-1, keepdim=True), min=M_INIT * LOG2E) if b > a \
            else torch.full(s.shape[:-1] + (1,), M_INIT * LOG2E)
        p = torch.exp2(sj - m)
        parts.append((m, p.sum(-1, keepdim=True),
                      torch.einsum("bkgqj,bjkd->bkgqd", p, v[:, a:b])))
    M = parts[0][0]
    for m, _, _ in parts[1:]:
        M = torch.maximum(M, m)
    L = torch.zeros_like(M)
    O = torch.zeros(B, K, G, Sq, hd)
    for m, l, o in parts:
        w = torch.exp2(m - M)
        L = L + l * w
        O = O + o * w
    out = O / torch.clamp(L, min=1e-30)
    return out.permute(0, 3, 1, 2, 4).reshape(B, Sq, H, hd)


def _jax_block_k(Skv):
    """block_k 64 as tests/test_torch_attention.py runs the Pallas kernel,
    or for a ragged Skv (which it asserts away) the largest divisor under
    64."""
    return max(d for d in range(1, min(64, Skv) + 1) if Skv % d == 0)


# (B, Skv, H, K, hd, kind, window, prefix, softcap, q_offset, scale)
GQA_CASES = [(1, 256, G * (2 if G <= 8 else 1), 2 if G <= 8 else 1, hd, "causal",
              0, 0, 0.0, 200, None)
             for G in (1, 2, 7, 8, 16, 48) for hd in (64, 112, 128, 256)]
MASK_CASES = [
    # a window that binds, with gemma2's softcap and query scale
    ("window softcap", (1, 400, 4, 2, 128, "causal", 200, 0, 50.0, 300, 0.0625)),
    # PaliGemma: a row past its prefix of patches
    ("prefix past the prefix", (1, 320, 8, 1, 256, "prefix", 0, 100, 0.0, 250, None)),
    # Whisper's cross-attention: full, q_offset 0, a ragged Skv
    ("full", (2, 300, 4, 4, 64, "full", 0, 0, 0.0, 0, None)),
    ("ragged Skv", (1, 200, 8, 1, 112, "causal", 0, 0, 0.0, 199, None)),
    # one key admitted
    ("q_offset 0", (1, 256, 8, 2, 64, "causal", 0, 0, 0.0, 0, None)),
    # a prefix and a window leave a gap: splits 1-4 hold no admitted key
    ("split the mask empties", (1, 512, 4, 1, 64, "prefix", 64, 64, 0.0, 400, None)),
]
MERGE_CASES = ([(f"G={c[2] // c[3]} hd={c[4]}", c) for c in GQA_CASES] + MASK_CASES)


@pytest.mark.parametrize("label, case", MERGE_CASES, ids=[c[0] for c in MERGE_CASES])
def test_split_merge_matches_plain_and_pallas(label, case):
    B, Skv, H, K, hd, kind, window, prefix, softcap, q_offset, scale = case
    scale = hd ** -0.5 if scale is None else scale
    rng = np.random.default_rng(11)
    q = rng.standard_normal((B, 1, H, hd)).astype(np.float32)
    k = rng.standard_normal((B, Skv, K, hd)).astype(np.float32)
    v = rng.standard_normal((B, Skv, K, hd)).astype(np.float32)
    spec = MaskSpec(kind, window=window, prefix_len=prefix)
    tq, tk, tv = (torch.from_numpy(x) for x in (q, k, v))
    plan = fa.decode_split_plan(B, 1, Skv, K, kind, window, prefix, q_offset)
    if label != "q_offset 0":
        assert plan.n_split > 1, plan  # the merge is exercised
    got = split_merge(tq, tk, tv, spec, plan, scale=scale, softcap=softcap,
                      q_offset=q_offset)
    if label == "split the mask empties":
        mask = _mask_block(spec, torch.tensor([q_offset]), torch.arange(Skv))[0]
        assert any(not bool(mask[a:b].any()) for a, b in
                   ((t0 * 64, t1 * 64) for t0, t1 in map(plan.tiles, range(plan.n_split))))
    plain = fa.attention_plain(tq, tk, tv, spec, scale=scale, softcap=softcap,
                               q_offset=q_offset)
    np.testing.assert_allclose(got.numpy(), plain.numpy(), **TOL)
    pallas = jax_flash_attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                                 scale=scale, softcap=softcap, kind=kind,
                                 window=window, prefix_len=prefix, q_offset=q_offset,
                                 block_q=64, block_k=_jax_block_k(Skv))
    np.testing.assert_allclose(got.numpy(), np.asarray(pallas), **TOL)
    assert math.isfinite(float(got.abs().max()))
