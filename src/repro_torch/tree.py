"""Nested dicts of tensors as the port's pytrees.

The port's parameters and optimizer state are nested dicts, laid out as
the reference's pytrees. These helpers walk them in the order JAX
flattens a dict (sorted keys), so a sum over leaves adds them in the
reference's order and a leaf's path is the reference's key path
("params/layers/attn/wq").
"""

from __future__ import annotations

from typing import Callable, Dict, Iterator, List, Tuple


def items(tree: Dict, prefix: str = "") -> Iterator[Tuple[str, object]]:
    """(the "/"-joined key path, leaf) of every leaf, keys sorted."""
    for k in sorted(tree):
        v = tree[k]
        path = f"{prefix}{k}"
        if isinstance(v, dict):
            yield from items(v, path + "/")
        else:
            yield path, v


def leaves(tree: Dict) -> List:
    return [leaf for _, leaf in items(tree)]


def map_(fn: Callable, tree: Dict, *rest: Dict) -> Dict:
    """``fn`` over the leaves of ``tree`` and the same leaves of ``rest``."""
    return {k: (map_(fn, v, *(r[k] for r in rest)) if isinstance(v, dict)
                else fn(v, *(r[k] for r in rest)))
            for k, v in tree.items()}


def unflatten(like: Dict, flat: List) -> Dict:
    """The tree of ``like``'s structure whose leaves, in `leaves` order,
    are ``flat``."""
    it = iter(flat)
    out = map_(lambda _: None, like)

    def fill(node):
        for k in sorted(node):
            if isinstance(node[k], dict):
                fill(node[k])
            else:
                node[k] = next(it)
    fill(out)
    return out
