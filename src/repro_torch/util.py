"""Helpers shared by every layer of the port: a map over nested
containers of tensors, their leaves and paths in the reference's order,
and the device an entry point runs on.

It imports nothing of the port, so the core, the analytics engine,
``convert`` and the model stack can all depend on it without pulling
one another in.
"""
from __future__ import annotations

from typing import Any, Callable, Iterator, List, Tuple, Union

import torch

Device = Union[str, torch.device]


def tree_map(fn: Callable, *trees: Any) -> Any:
    """`fn` on matching leaves of one or more trees of nested dicts,
    lists and tuples (the first tree gives the structure)."""
    first = trees[0]
    if isinstance(first, dict):
        return {k: tree_map(fn, *(t[k] for t in trees)) for k in first}
    if isinstance(first, (tuple, list)):
        return type(first)(tree_map(fn, *parts) for parts in zip(*trees))
    return fn(*trees)


def tree_paths(tree: Any, prefix: Tuple = ()) -> Iterator[Tuple[Tuple, Any]]:
    """(path, leaf) for every leaf, in the order ``jax.tree.leaves`` gives
    the same nested dicts and lists: dict keys sorted, sequences in
    order.  A path is the tuple of keys and indices down to the leaf."""
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from tree_paths(tree[k], prefix + (k,))
    elif isinstance(tree, (tuple, list)):
        for i, v in enumerate(tree):
            yield from tree_paths(v, prefix + (i,))
    else:
        yield prefix, tree


def tree_leaves(tree: Any) -> List[Any]:
    """The leaves of `tree` in :func:`tree_paths`'s order."""
    return [leaf for _, leaf in tree_paths(tree)]


def resolve_device(device: Device = "cuda") -> torch.device:
    """`device` as a ``torch.device``; raises if it names CUDA and there
    is none (the entry points never fall back to the CPU)."""
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("no CUDA device is available; pass device='cpu' "
                           "to run on the CPU")
    return device
