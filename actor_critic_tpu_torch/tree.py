"""Nested env states: NamedTuples and tuples of tensors (the port's
counterpart of the `jax.tree` calls the JAX package makes on env states).

A mixture fleet's state holds one member state per type, and each member
state may hold its scenario, so the trainer's state is a tree, not a flat
NamedTuple. These three functions are all the port does with it: map a
function over the leaves (auto-reset's select, the init's copies), list
the leaves in a fixed order (the rollout's in-place write-back), and name
them (checks that compare two states leaf by leaf).
"""

from __future__ import annotations

from typing import Any, Callable

import torch


def _is_node(x: Any) -> bool:
    return isinstance(x, tuple)


def tree_map(fn: Callable[..., Any], tree: Any, *rest: Any) -> Any:
    """`fn` over the leaves of `tree` and of the same-shaped `rest`, in a
    tree of `tree`'s shape (a NamedTuple stays its own type)."""
    if not _is_node(tree):
        return fn(tree, *rest)
    children = [tree_map(fn, *xs) for xs in zip(tree, *rest, strict=True)]
    return type(tree)(*children) if hasattr(tree, "_fields") else tuple(children)


def tree_leaves(tree: Any) -> list[torch.Tensor]:
    """The leaves of `tree`, depth first, in field order."""
    if not _is_node(tree):
        return [tree]
    return [leaf for child in tree for leaf in tree_leaves(child)]


def named_leaves(tree: Any, prefix: str = "") -> dict[str, torch.Tensor]:
    """{dotted path: leaf}, e.g. `members.0.x` (a NamedTuple's fields by
    name, a tuple's items by index)."""
    if not _is_node(tree):
        return {prefix: tree}
    names = tree._fields if hasattr(tree, "_fields") else range(len(tree))
    out: dict[str, torch.Tensor] = {}
    for name, child in zip(names, tree):
        out.update(named_leaves(child, f"{prefix}.{name}" if prefix else str(name)))
    return out
