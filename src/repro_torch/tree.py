"""Nested-dict trees of tensors, walked the way ``jax.tree_util`` walks
dict pytrees: keys in sorted order, depth first. The training state is
such a tree, so the port's leaf order — and with it every replication
manifest offset — equals the JAX package's."""
from __future__ import annotations

from typing import Any, Callable, List, Sequence, Tuple

Path = Tuple[str, ...]


def flatten_with_paths(tree) -> List[Tuple[Path, Any]]:
    """``[(path, leaf), ...]`` with dict keys visited in sorted order."""
    out: List[Tuple[Path, Any]] = []

    def walk(node, path):
        if isinstance(node, dict):
            for key in sorted(node):
                walk(node[key], path + (key,))
        else:
            out.append((path, node))

    walk(tree, ())
    return out


def leaves(tree) -> list:
    return [leaf for _, leaf in flatten_with_paths(tree)]


def unflatten(paths: Sequence[Path], values: Sequence) -> dict:
    """Inverse of :func:`flatten_with_paths`."""
    out: dict = {}
    for path, value in zip(paths, values):
        node = out
        for key in path[:-1]:
            node = node.setdefault(key, {})
        node[path[-1]] = value
    return out


def tree_map(fn: Callable, tree, *rest):
    """Apply ``fn`` leafwise over trees of one structure."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, tree[k], *(r[k] for r in rest)) for k in tree}
    return fn(tree, *rest)


def unstack(stacked, n: int) -> list:
    """Per-layer views of the stacked params (one ``unbind`` per leaf, so
    the backward stacks each leaf's gradient once)."""
    paths, leaves = zip(*flatten_with_paths(stacked))
    slices = [leaf.unbind(0) for leaf in leaves]
    return [unflatten(paths, [s[i] for s in slices]) for i in range(n)]
