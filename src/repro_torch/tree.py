"""Trees of tensors: dictionaries, lists and tuples (a named tuple keeps its
type); anything else is a leaf. The port's parameters (a list of
per-layer dictionaries under ``stack``), optimizer state and caches are
such trees, and every walk over them visits leaves in one order:
dictionary order, then list and tuple order.
"""

from __future__ import annotations

from typing import Any, Callable, Iterator, Tuple


def walk(tree, path: Tuple = ()) -> Iterator[Tuple[Tuple, Any]]:
    """(path, leaf) pairs, the path the keys and indices down to the leaf."""
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from walk(v, path + (k,))
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield from walk(v, path + (i,))
    else:
        yield path, tree


def leaves(tree) -> Iterator[Any]:
    return (leaf for _, leaf in walk(tree))


def tree_map(fn: Callable, tree, *rest):
    """``fn`` applied leafwise across trees of one structure."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, v, *(r[k] for r in rest)) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        items = [tree_map(fn, v, *(r[i] for r in rest)) for i, v in enumerate(tree)]
        return type(tree)(*items) if hasattr(tree, "_fields") else type(tree)(items)
    return fn(tree, *rest)
