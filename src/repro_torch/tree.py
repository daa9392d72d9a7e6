"""Trees of tensors (nested dicts, lists and tuples), walked in one order.

Every walk of the port's state trees goes through ``walk``: the leaves
come in ``jax.tree.leaves``' order (dict keys sorted), each keyed as
``jax.tree_util.keystr`` keys it (``['blocks'][0]['moe']['wg']``), so
the optimizer, the checkpoints and anything that pairs a leaf with its
gradient agree on the order by construction.
"""
from __future__ import annotations

from typing import Any, Callable, Iterator, List, Tuple

import torch

STACKED = ("blocks", "enc_blocks")   # params keys whose leaves are stacked


def walk(tree: Any, key: str = "",
         stacked: bool = False) -> Iterator[Tuple[str, bool, Any]]:
    """``(key, stacked, leaf)`` of every leaf; ``stacked`` marks a leaf
    under a stacked key of a parameter tree (its first axis is the
    superblock or encoder layer)."""
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from walk(tree[k], f"{key}[{k!r}]",
                            stacked or k in STACKED)
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield from walk(v, f"{key}[{i}]", stacked)
    else:
        yield key, stacked, tree


def tree_leaves(tree: Any) -> List[torch.Tensor]:
    """The leaves in ``walk``'s order."""
    return [leaf for _, _, leaf in walk(tree)]


def tree_map(fn: Callable, tree: Any) -> Any:
    """``tree`` with every leaf ``t`` replaced by ``fn(t)``; ``fn`` sees
    the leaves in ``walk``'s order."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, tree[k]) for k in sorted(tree)}
    if isinstance(tree, (list, tuple)):
        return type(tree)(tree_map(fn, v) for v in tree)
    return fn(tree)
