"""Minimal pytree helpers over the containers the port uses.

Parameter trees, optimizer states and ``ServerState`` are nested dicts,
tuples, lists and NamedTuples of tensors.  Flattening follows
``jax.tree_util`` exactly: dict keys in sorted order, sequence items in
order, NamedTuple fields in declaration order, ``None`` holding no leaf.
``flatten_with_paths`` renders each leaf's path the way the JAX package's
checkpoints name it (``.w/['conv1']``, ``.extra/['v']/['b1']``, ``.t``), so
a state flattened here lines up leaf for leaf with the reference's.
"""
from __future__ import annotations

from typing import Any, Callable, List, Tuple


def _is_namedtuple(x) -> bool:
    return isinstance(x, tuple) and hasattr(x, "_fields")


def _children(node) -> Tuple[list, Callable[[list], Any]] | None:
    """(labelled children, rebuild) for a container, ``None`` for a leaf."""
    if isinstance(node, dict):
        keys = sorted(node)
        return ([(f"[{k!r}]", node[k]) for k in keys],
                lambda vals: dict(zip(keys, vals)))
    if _is_namedtuple(node):
        return ([(f".{f}", getattr(node, f)) for f in node._fields],
                lambda vals: type(node)(*vals))
    if isinstance(node, (tuple, list)):
        kind = type(node)
        return ([(f"[{i}]", v) for i, v in enumerate(node)],
                lambda vals: kind(vals))
    if node is None:
        return [], lambda vals: None
    return None


def flatten_with_paths(tree) -> Tuple[List[str], list]:
    """(path strings, leaves) in ``jax.tree_util`` order."""
    paths: List[str] = []
    leaves: list = []

    def walk(node, prefix):
        kids = _children(node)
        if kids is None:
            paths.append("/".join(prefix))
            leaves.append(node)
            return
        for label, child in kids[0]:
            walk(child, prefix + [label])

    walk(tree, [])
    return paths, leaves


def leaves(tree) -> list:
    """The leaves in ``flatten_with_paths`` order, without their paths
    (the per-step hot path of every server update)."""
    out: list = []

    def walk(node):
        if isinstance(node, dict):
            for k in sorted(node):
                walk(node[k])
        elif isinstance(node, (tuple, list)):
            for child in node:        # a NamedTuple iterates its fields
                walk(child)
        elif node is not None:
            out.append(node)

    walk(tree)
    return out


def unflatten_like(like, new_leaves) -> Any:
    """Rebuild ``like``'s structure around ``new_leaves`` (same order)."""
    it = iter(new_leaves)

    def build(node):
        if isinstance(node, dict):
            return {k: build(node[k]) for k in sorted(node)}
        if _is_namedtuple(node):
            return type(node)(*[build(child) for child in node])
        if isinstance(node, (tuple, list)):
            return type(node)([build(child) for child in node])
        return None if node is None else next(it)

    out = build(like)
    if next(it, None) is not None:
        raise ValueError("more leaves than the structure holds")
    return out


def tree_map(fn: Callable, tree, *rest) -> Any:
    """Apply ``fn`` leafwise over trees of one structure."""
    flat = leaves(tree)
    others = [leaves(r) for r in rest]
    for o in others:
        if len(o) != len(flat):
            raise ValueError(
                f"tree_map over trees with {len(flat)} and {len(o)} leaves")
    return unflatten_like(tree, [fn(*xs) for xs in zip(flat, *others)])
