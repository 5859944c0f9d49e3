"""Deterministic synthetic data pipelines, copied from
``repro/data/synthetic.py`` (numpy only).

The paper evenly splits the dataset across training nodes (§VI-A); node
joins/leaves add/remove their split (§VI-E convergence study). These streams
reproduce that: a global deterministic corpus, ``node_split`` assigning
disjoint index ranges per node, and batch iterators that re-shard when
membership changes.

Token streams are Zipf-ish Markov chains so that models can actually *learn*
(loss decreases) without external datasets. The same seed yields the same
tokens as the JAX package's stream, and ``make_train_batch`` the same
global batch of a shape cell.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, Optional, Sequence

import numpy as np


def node_split(n_examples: int, node_ids: Sequence[int]) -> Dict[int, np.ndarray]:
    """Even disjoint split of example indices across the given nodes."""
    ids = sorted(node_ids)
    chunks = np.array_split(np.arange(n_examples), len(ids))
    return {n: c for n, c in zip(ids, chunks)}


@dataclass
class TokenStream:
    """Markov-chain token corpus with learnable structure."""
    vocab: int
    seq_len: int
    n_examples: int = 4096
    seed: int = 0

    def __post_init__(self):
        rng = np.random.RandomState(self.seed)
        v = min(self.vocab, 512)
        # Sparse-ish transition matrix: each token strongly predicts few next.
        self._next = rng.randint(0, v, size=(v, 4))
        self._v = v

    def example(self, idx: int) -> np.ndarray:
        rng = np.random.RandomState(self.seed * 1_000_003 + idx)
        out = np.empty(self.seq_len + 1, np.int32)
        t = rng.randint(0, self._v)
        for i in range(self.seq_len + 1):
            out[i] = t
            if rng.rand() < 0.85:
                t = self._next[t, rng.randint(0, 4)]
            else:
                t = rng.randint(0, self._v)
        return out

    def batch(self, indices: Sequence[int]) -> np.ndarray:
        return np.stack([self.example(int(i) % self.n_examples) for i in indices])


class ShardedLoader:
    """Per-node batch iterator over a node's split; resharding on membership
    change is just calling ``reshard`` with the new node set."""

    def __init__(self, stream, n_examples: int, node_ids: Sequence[int],
                 batch_per_node: int, seed: int = 0):
        self.stream = stream
        self.n_examples = n_examples
        self.batch_per_node = batch_per_node
        self.seed = seed
        self._epoch = 0
        self.reshard(node_ids)

    def reshard(self, node_ids: Sequence[int]):
        self.splits = node_split(self.n_examples, node_ids)
        self._cursors = {n: 0 for n in self.splits}

    def next_batch(self, node_id: int):
        split = self.splits[node_id]
        cur = self._cursors[node_id]
        idx = [split[(cur + i) % len(split)] for i in range(self.batch_per_node)]
        self._cursors[node_id] = (cur + self.batch_per_node) % max(len(split), 1)
        return self.stream.batch(idx)


def make_train_batch(cfg, cell, stream: Optional[TokenStream] = None,
                     seed: int = 0) -> dict:
    """Host-side global batch for a shape cell (used by the launcher)."""
    stream = stream or TokenStream(cfg.vocab, cell.seq_len, seed=seed)
    tokens = stream.batch(range(cell.global_batch))
    batch = {"tokens": tokens}
    if cfg.family == "vlm":
        rng = np.random.RandomState(seed)
        batch["patches"] = rng.randn(cell.global_batch, cfg.n_patches,
                                     cfg.d_model).astype(np.float32) * 0.02
    if cfg.family == "encdec":
        rng = np.random.RandomState(seed)
        batch["frames"] = rng.randn(cell.global_batch, cfg.enc_len,
                                    cfg.d_model).astype(np.float32) * 0.02
    return batch
