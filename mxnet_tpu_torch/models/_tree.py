"""Params trees shared by the models: nested dicts and lists of tensors
with the reference's keys (≙ the JAX package's params pytrees)."""
from __future__ import annotations

from typing import Dict, List

import numpy as np
import torch
from torch import nn

from .. import context as _context

__all__ = ["map_tree", "leaves", "params_from_numpy", "params_to",
           "as_modules", "from_modules"]


def map_tree(tree, fn):
    if isinstance(tree, dict):
        return {k: map_tree(v, fn) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [map_tree(v, fn) for v in tree]
    return fn(tree)


def leaves(tree) -> List[torch.Tensor]:
    """The tensors of ``tree`` in ``jax.tree_util.tree_leaves`` order
    (dict keys sorted, lists in order)."""
    if isinstance(tree, dict):
        return [t for k in sorted(tree) for t in leaves(tree[k])]
    if isinstance(tree, (list, tuple)):
        return [t for v in tree for t in leaves(v)]
    return [tree]


def params_from_numpy(tree, device=None) -> Dict:
    """The reference's params pytree as numpy arrays (``np.asarray`` of
    each leaf of its ``init_params``) → the port's tree with the same
    keys, shapes and layouts on ``device``."""
    device = _context.resolve(device)
    return map_tree(tree, lambda a: torch.from_numpy(
        np.ascontiguousarray(a)).to(device))


def params_to(params, device) -> Dict:
    """The tree on ``device`` (leaves already there are not copied)."""
    return map_tree(params, lambda t: t.to(device))


def as_modules(tree, requires_grad: bool = False):
    """The tree as nested ``nn.Module``s whose parameters carry its keys."""
    if isinstance(tree, list):
        return nn.ModuleList([as_modules(t, requires_grad) for t in tree])
    m = nn.Module()
    for k, v in tree.items():
        if isinstance(v, torch.Tensor):
            m.register_parameter(k, nn.Parameter(v, requires_grad))
        else:
            m.add_module(k, as_modules(v, requires_grad))
    return m


def from_modules(m):
    """The inverse of :func:`as_modules`: the dict the functions take."""
    if isinstance(m, nn.ModuleList):
        return [from_modules(c) for c in m]
    out = dict(m.named_parameters(recurse=False))
    for k, c in m.named_children():
        out[k] = from_modules(c)
    return out
