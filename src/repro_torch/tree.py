"""One order for the leaves of a tree of tensors, shared by the checkpoint
manager and gradient compression.

Dicts (keys sorted, as the JAX package's tree flattening sorts them),
dataclasses (fields in order), tuples and lists are containers; what a
caller's ``is_leaf`` accepts is a leaf; anything else is structure, which
``rebuild`` keeps from its template.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable


def children(tree: Any) -> list:
    """``(name suffix, child)`` of a container, in flatten order; [] for
    anything else."""
    if isinstance(tree, dict):
        return [(f'[{k!r}]', tree[k]) for k in sorted(tree)]
    if dataclasses.is_dataclass(tree) and not isinstance(tree, type):
        return [(f'.{f.name}', getattr(tree, f.name))
                for f in dataclasses.fields(tree)]
    if isinstance(tree, (tuple, list)):
        return [(f'[{i}]', x) for i, x in enumerate(tree)]
    return []


def leaves(tree: Any, is_leaf: Callable[[Any], bool]) -> list:
    """The leaves of ``tree``, in flatten order."""
    if is_leaf(tree):
        return [tree]
    return [x for _, child in children(tree) for x in leaves(child, is_leaf)]


def rebuild(template: Any, is_leaf: Callable[[Any], bool],
            leaf: Callable[[Any], Any]) -> Any:
    """``template`` with each leaf ``x`` replaced by ``leaf(x)``, called in
    flatten order."""
    if is_leaf(template):
        return leaf(template)
    if isinstance(template, dict):
        built = {k: rebuild(template[k], is_leaf, leaf)
                 for k in sorted(template)}
        return {k: built[k] for k in template}
    if dataclasses.is_dataclass(template) and not isinstance(template, type):
        return dataclasses.replace(template, **{
            f.name: rebuild(getattr(template, f.name), is_leaf, leaf)
            for f in dataclasses.fields(template)})
    if isinstance(template, (tuple, list)):
        vals = [rebuild(x, is_leaf, leaf) for x in template]
        if hasattr(template, '_fields'):     # a NamedTuple
            return type(template)(*vals)
        return type(template)(vals)
    return template
