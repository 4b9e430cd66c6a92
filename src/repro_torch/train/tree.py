"""Trees of tensors: the reference's ``jax.tree`` operations for the
nested dicts, lists and tuples the training code passes around.

Dict keys are visited in sorted order, as JAX visits them, so sums over
leaves (the global gradient norm) add in the reference's order. An
``LMParams`` found in a tree stands for the reference's tree of its
parameters (``LMParams.tree()``: nested dicts, each stacked layer leaf
stacked along a first layer axis).
"""

from __future__ import annotations

from typing import Any, Callable, Iterator

from repro_torch.models.transformer import LMParams


def as_tree(tree: Any) -> Any:
    """``tree`` with every ``LMParams`` in it replaced by its reference tree."""
    if isinstance(tree, LMParams):
        return tree.tree()
    if isinstance(tree, dict):
        return {k: as_tree(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(as_tree(v) for v in tree)
    return tree


def _is_node(x) -> bool:
    return isinstance(x, (dict, list, tuple))


def _children(node) -> Iterator[tuple[Any, Any]]:
    if isinstance(node, dict):
        for k in sorted(node):
            yield k, node[k]
    else:
        yield from enumerate(node)


def leaves_with_paths(tree: Any, path: tuple = ()) -> list[tuple[tuple, Any]]:
    """Every leaf with its path of keys (dict keys; list/tuple indices)."""
    if not _is_node(tree):
        return [(path, tree)]
    out = []
    for k, child in _children(tree):
        out += leaves_with_paths(child, path + (k,))
    return out


def leaves(tree: Any) -> list:
    return [leaf for _, leaf in leaves_with_paths(tree)]


def tree_map(fn: Callable, tree: Any, *rest: Any) -> Any:
    """``fn`` applied leaf by leaf, ``rest`` read at ``tree``'s leaf
    positions (a whole subtree there, as ``flatten_up_to`` gives it)."""
    if not _is_node(tree):
        return fn(tree, *rest)
    if isinstance(tree, dict):
        return {k: tree_map(fn, v, *(r[k] for r in rest)) for k, v in _children(tree)}
    return type(tree)(tree_map(fn, v, *(r[k] for r in rest)) for k, v in _children(tree))


def tree_map_with_path(fn: Callable, tree: Any, path: tuple = ()) -> Any:
    """``fn(path, leaf)`` at every leaf."""
    if not _is_node(tree):
        return fn(path, tree)
    out = {k: tree_map_with_path(fn, v, path + (k,)) for k, v in _children(tree)}
    return out if isinstance(tree, dict) else type(tree)(out[i] for i in range(len(tree)))


def unzip(tree: Any, template: Any, n: int) -> tuple:
    """A tree of n-tuples at ``template``'s leaf positions -> n trees."""
    return tuple(tree_map(lambda _, t, i=i: t[i], template, tree) for i in range(n))
