"""Nested state as the runtime walks it: dicts, lists and tuples (named
tuples such as a ``TrainState`` included) of leaves (tensors, arrays,
scalars), keyed as the reference's pytrees are — a leaf's key is its dict
keys and sequence indices joined by ``/``, and ``None`` holds no leaf.  An
``nn.Module`` is walked as the dict of its ``named_parameters()``."""

from __future__ import annotations

from typing import Any, Callable

from torch import nn


def _sequence(tree: tuple | list, items: list) -> Any:
    """``items`` in the sequence type of ``tree`` (a named tuple by field)."""
    if isinstance(tree, list):
        return items
    return type(tree)(*items) if hasattr(tree, "_fields") else tuple(items)


def tree_map_with_keys(fn: Callable, tree: Any, prefix: str = "") -> Any:
    """``fn(key, leaf)`` of each leaf of ``tree``, in a tree of its shape.  A
    module maps to itself when ``fn`` gives back each of its parameters (as
    a checkpoint restore does, writing them in place), else to the dict of
    ``fn``'s results by parameter name."""
    if tree is None:
        return None
    if isinstance(tree, nn.Module):
        named = dict(tree.named_parameters())
        out = tree_map_with_keys(fn, named, prefix)
        return tree if all(out[k] is p for k, p in named.items()) else out
    if isinstance(tree, dict):
        return type(tree)((k, tree_map_with_keys(
            fn, v, f"{prefix}/{k}" if prefix else str(k)))
            for k, v in tree.items())
    if isinstance(tree, (list, tuple)):
        out = [tree_map_with_keys(fn, v, f"{prefix}/{i}" if prefix else str(i))
               for i, v in enumerate(tree)]
        return _sequence(tree, out)
    return fn(prefix, tree)


def tree_leaves_with_keys(tree: Any) -> list[tuple[str, Any]]:
    """``(key, leaf)`` of every leaf of ``tree``."""
    out: list[tuple[str, Any]] = []
    tree_map_with_keys(lambda key, leaf: out.append((key, leaf)), tree)
    return out


def tree_map(fn: Callable, tree: Any, *rest: Any) -> Any:
    """``fn`` of each leaf of ``tree`` (and of the parts of ``rest`` at the
    same place, taken whole: a spec may itself be a tuple), in a tree of
    ``tree``'s shape."""
    if tree is None:
        return None
    if isinstance(tree, dict):
        return type(tree)((k, tree_map(fn, v, *(r[k] for r in rest)))
                          for k, v in tree.items())
    if isinstance(tree, (list, tuple)):
        out = [tree_map(fn, v, *(r[i] for r in rest))
               for i, v in enumerate(tree)]
        return _sequence(tree, out)
    return fn(tree, *rest)
