"""Trees of the port: nested dicts, tuples and lists of tensors, the
layout of the JAX package's pytrees (``params["blocks"]`` is a tuple of
stacked dicts).  ``None`` is a leaf here, as the reference's peft split
and optimizer treat it (``is_leaf=lambda x: x is None``).  Paths are
spelled as ``jax.tree_util.keystr`` spells them (``['blocks'][0]
['attn']['wq']``), so adapter trees keyed by path cross the bridge
under the reference's names.
"""
from __future__ import annotations

from typing import Any, Callable, Iterator, Tuple


def tree_map(fn: Callable, tree: Any, *rest: Any) -> Any:
    """Map ``fn`` over the leaves of one tree, or of several trees of
    the same structure (``fn`` gets one leaf of each)."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, v, *(r[k] for r in rest))
                for k, v in tree.items()}
    if isinstance(tree, (tuple, list)):
        out = [tree_map(fn, v, *(r[i] for r in rest))
               for i, v in enumerate(tree)]
        return tuple(out) if isinstance(tree, tuple) else out
    return fn(tree, *rest)


def tree_leaves_with_path(tree: Any, path: str = "", *,
                          sort_keys: bool = False
                          ) -> Iterator[Tuple[str, Any]]:
    """(keystr path, leaf) for every leaf, ``None`` leaves included, in
    tree order (``sort_keys``: dict keys sorted, JAX's flatten order)."""
    if isinstance(tree, dict):
        for k in (sorted(tree) if sort_keys else tree):
            yield from tree_leaves_with_path(tree[k], f"{path}[{k!r}]",
                                             sort_keys=sort_keys)
    elif isinstance(tree, (tuple, list)):
        for i, v in enumerate(tree):
            yield from tree_leaves_with_path(v, f"{path}[{i}]",
                                             sort_keys=sort_keys)
    else:
        yield path, tree


def tree_map_with_path(fn: Callable, tree: Any, path: str = "") -> Any:
    """``fn(keystr path, leaf)`` over every leaf."""
    if isinstance(tree, dict):
        return {k: tree_map_with_path(fn, v, f"{path}[{k!r}]")
                for k, v in tree.items()}
    if isinstance(tree, (tuple, list)):
        out = [tree_map_with_path(fn, v, f"{path}[{i}]")
               for i, v in enumerate(tree)]
        return tuple(out) if isinstance(tree, tuple) else out
    return fn(path, tree)


def tree_leaves(tree: Any) -> list:
    """Every non-``None`` leaf, in tree order."""
    return [leaf for _, leaf in tree_leaves_with_path(tree)
            if leaf is not None]
