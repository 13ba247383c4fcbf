"""Hand the benchmark's weights to the program: one map a family from a
leaf of the benchmark's layout (``l<i>.<what>`` for layer ``i``, or a
bare name) to its place in the port's parameter tree (per-layer leaves
stacked ``[L, ...]``, as ``models/transformer.init_params`` makes them)."""
from __future__ import annotations

from typing import Callable, Dict, List, Tuple

import torch

from ..core.weights import Leaf, layer_of

# (leaf name without its layer prefix, path in the port's tree)
Map = List[Tuple[str, Tuple[str, ...]]]


def _split(name: str):
    i = layer_of(name)
    return (i, name.split(".", 1)[1]) if i is not None else (None, name)


def port_tree(mapping: Map, leaves: List[Leaf], draw: Callable,
              n_layers: int, device) -> Dict:
    """The port's tree, each leaf drawn by ``draw(leaf)`` and copied into
    its place; the stacked leaves allocated once, ``[L, ...]``."""
    where = dict(mapping)
    tree: Dict = {}
    for leaf in leaves:
        i, key = _split(leaf.name)
        path = where[key]
        node = tree
        for k in path[:-1]:
            node = node.setdefault(k, {})
        x = draw(leaf)
        if i is None:
            node[path[-1]] = x
            continue
        if path[-1] not in node:
            node[path[-1]] = torch.empty((n_layers, *x.shape), dtype=x.dtype,
                                         device=device)
        node[path[-1]][i].copy_(x)
        del x
    return tree


def view(tree: Dict, mapping: Map, name: str) -> torch.Tensor:
    """The program's tensor (or a tree shaped like the params, such as a
    moment) at the place of the benchmark's leaf ``name``."""
    i, key = _split(name)
    node = tree
    for k in dict(mapping)[key]:
        node = node[k]
    return node if i is None else node[i]
