"""Nested containers as flat leaf lists: the port's stand-in for the
``jax.tree_util`` calls of ``ray_tpu/train/`` and ``ray_tpu/tune/``.

Flattening follows JAX's rules, so the port's leaf order and leaf paths
are the reference's for the same tree:

- a ``dict`` is a node whose children are its values in sorted-key order
  (an ``OrderedDict`` keeps its insertion order, as JAX keeps it);
- a ``list`` or ``tuple`` is a node whose children are its items, the
  index being the child's path part;
- ``None`` is an empty node and has no leaf;
- anything else (tensors, arrays, scalars, strings) is a leaf.

A path is the node keys from the root joined with ``/``. A ``TreeDef``
is a plain picklable description of the nodes, so a sealed payload or a
checkpoint carries it between processes.
"""
from __future__ import annotations

from collections import OrderedDict
from dataclasses import dataclass
from typing import Any, Callable, List, Optional, Tuple

LEAF = "leaf"


@dataclass(frozen=True)
class TreeDef:
    kind: str  # "leaf", "none", "dict", "odict", "list", "tuple"
    keys: Tuple[Any, ...] = ()
    children: Tuple["TreeDef", ...] = ()

    def flatten_up_to(self, tree: Any) -> List[Any]:
        """The subtrees of ``tree`` at this treedef's leaves (``tree``
        must have this structure down to them), as JAX's
        ``treedef.flatten_up_to``."""
        if self.kind == LEAF:
            return [tree]
        if self.kind == "none":
            return []
        out: List[Any] = []
        for k, c in zip(self.keys, self.children):
            out.extend(c.flatten_up_to(tree[k]))
        return out


def _node(tree: Any) -> Optional[Tuple[str, Tuple[Any, ...]]]:
    if tree is None:
        return "none", ()
    if isinstance(tree, OrderedDict):
        return "odict", tuple(tree)
    if isinstance(tree, dict):
        return "dict", tuple(sorted(tree))
    if type(tree) is list:
        return "list", tuple(range(len(tree)))
    if type(tree) is tuple:
        return "tuple", tuple(range(len(tree)))
    return None


def flatten_with_path(
    tree: Any, is_leaf: Optional[Callable[[Any], bool]] = None
) -> Tuple[List[Tuple[Tuple[Any, ...], Any]], TreeDef]:
    """([(key path, leaf), ...], treedef) in JAX's leaf order."""
    flat: List[Tuple[Tuple[Any, ...], Any]] = []

    def walk(t: Any, path: Tuple[Any, ...]) -> TreeDef:
        node = None if (is_leaf is not None and is_leaf(t)) else _node(t)
        if node is None:
            flat.append((path, t))
            return TreeDef(LEAF)
        kind, keys = node
        children = tuple(walk(t[k], path + (k,)) for k in keys)
        return TreeDef(kind, keys, children)

    treedef = walk(tree, ())
    return flat, treedef


def flatten(
    tree: Any, is_leaf: Optional[Callable[[Any], bool]] = None
) -> Tuple[List[Any], TreeDef]:
    flat, treedef = flatten_with_path(tree, is_leaf)
    return [leaf for _, leaf in flat], treedef


def leaves(tree: Any, is_leaf: Optional[Callable[[Any], bool]] = None) -> List[Any]:
    return flatten(tree, is_leaf)[0]


def unflatten(treedef: TreeDef, leaves_: List[Any]) -> Any:
    it = iter(leaves_)

    def build(td: TreeDef) -> Any:
        if td.kind == LEAF:
            return next(it)
        if td.kind == "none":
            return None
        vals = [build(c) for c in td.children]
        if td.kind == "dict":
            return dict(zip(td.keys, vals))
        if td.kind == "odict":
            return OrderedDict(zip(td.keys, vals))
        if td.kind == "list":
            return vals
        return tuple(vals)

    out = build(treedef)
    rest = sum(1 for _ in it)
    if rest:
        raise ValueError(f"unflatten: {rest} leaves more than the treedef holds")
    return out


def tree_map(
    fn: Callable[..., Any],
    tree: Any,
    *rest: Any,
    is_leaf: Optional[Callable[[Any], bool]] = None,
) -> Any:
    """``fn`` over the leaves of ``tree`` (and the matching subtrees of
    ``rest``), rebuilt in ``tree``'s structure."""
    xs, treedef = flatten(tree, is_leaf)
    others = [treedef.flatten_up_to(r) for r in rest]
    return unflatten(treedef, [fn(x, *ys) for x, *ys in zip(xs, *others)])


def path_str(path: Tuple[Any, ...]) -> str:
    return "/".join(str(k) for k in path)
