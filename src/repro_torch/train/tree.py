"""Trees of tensors as the reference's ``jax.tree`` sees them.

A tree is a dict, a tuple, a list or a NamedTuple of trees, ``None``, or
a leaf (a tensor, or any other object).  As in JAX, ``None`` and ``()``
hold no leaf, and a dict's leaves come in the order of its sorted keys;
so :func:`leaves` lists them in ``jax.tree.leaves`` order.  That order is
float order where leaves are summed (``optim.global_norm``), and each
leaf's path is its checkpoint key (``checkpoint``): a dict key, a
sequence index or a NamedTuple field name per level, as
``jax.tree_util.tree_flatten_with_path`` gives them.
"""

from __future__ import annotations

from typing import Any, Callable, Iterator, List, Tuple

__all__ = ["leaves", "leaves_with_paths", "tree_map", "unflatten"]


def _is_namedtuple(x) -> bool:
    return isinstance(x, tuple) and hasattr(x, "_fields")


def leaves_with_paths(tree, path: Tuple = ()) -> Iterator[Tuple[Tuple, Any]]:
    """(path, leaf) pairs in ``jax.tree.leaves`` order."""
    if tree is None:
        return
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from leaves_with_paths(tree[k], path + (k,))
    elif _is_namedtuple(tree):
        for name, v in zip(tree._fields, tree):
            yield from leaves_with_paths(v, path + (name,))
    elif isinstance(tree, (tuple, list)):
        for i, v in enumerate(tree):
            yield from leaves_with_paths(v, path + (i,))
    else:
        yield path, tree


def leaves(tree) -> List[Any]:
    return [leaf for _, leaf in leaves_with_paths(tree)]


def tree_map(fn: Callable, tree, *rest):
    """``fn`` over the leaves of ``tree`` and the matching subtrees of
    ``rest`` (where ``tree`` has a leaf, a tree of ``rest`` may hold a
    whole subtree, as ``flatten_up_to`` reads it).  The result keeps
    ``tree``'s structure."""
    if tree is None:
        return None
    if isinstance(tree, dict):
        return {k: tree_map(fn, v, *(r[k] for r in rest))
                for k, v in tree.items()}
    if isinstance(tree, (tuple, list)):
        out = [tree_map(fn, v, *(r[i] for r in rest))
               for i, v in enumerate(tree)]
        return type(tree)(*out) if _is_namedtuple(tree) else type(tree)(out)
    return fn(tree, *rest)


_END = object()


def unflatten(like, new_leaves) -> Any:
    """``like``'s structure with its leaves replaced, in
    :func:`leaves` order, by ``new_leaves``."""
    it = iter(new_leaves)
    placed = {}
    for path, _ in leaves_with_paths(like):
        placed[path] = next(it)
    if next(it, _END) is not _END:
        raise ValueError("more leaves than the tree holds")

    def build(t, path):
        if t is None:
            return None
        if isinstance(t, dict):
            return {k: build(v, path + (k,)) for k, v in t.items()}
        if _is_namedtuple(t):
            return type(t)(*(build(v, path + (n,))
                             for n, v in zip(t._fields, t)))
        if isinstance(t, (tuple, list)):
            return type(t)(build(v, path + (i,)) for i, v in enumerate(t))
        return placed[path]

    return build(like, ())
