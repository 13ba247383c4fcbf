"""Weights made from the seed, one leaf at a time, on the device.

A leaf of the benchmark's own layout (``reference/<family>.layout``) is a
name, a shape and how it is drawn. Each leaf has a generator of its own,
seeded from the run's seed and the leaf's name, so that any leaf can be
drawn again alone: the program's copy is drawn once in set-up, and the
reference draws a layer's leaves again when it reaches that layer. Every
leaf is drawn in the type it is served in (bf16) and scaled in that type;
the reference reads those same values in f32."""
from __future__ import annotations

import hashlib
import math
from typing import NamedTuple, Tuple

import torch


class Leaf(NamedTuple):
    name: str
    shape: Tuple[int, ...]
    init: str = "normal"        # normal | ones | zeros | a_log | dt_bias
    scale: float = 1.0


def leaf_seed(seed: int, name: str) -> int:
    h = hashlib.blake2b(f"{int(seed)}/{name}".encode(), digest_size=8)
    return int.from_bytes(h.digest(), "little") & ((1 << 63) - 1)


def draw(leaf: Leaf, seed: int, device, dtype=torch.bfloat16) -> torch.Tensor:
    """The leaf's values, the same for the same seed on the same device."""
    if leaf.init == "normal":
        gen = torch.Generator(device=device)
        gen.manual_seed(leaf_seed(seed, leaf.name))
        return torch.randn(leaf.shape, generator=gen, device=device,
                           dtype=dtype).mul_(leaf.scale)
    if leaf.init == "ones":
        return torch.ones(leaf.shape, device=device, dtype=dtype)
    if leaf.init == "zeros":
        return torch.zeros(leaf.shape, device=device, dtype=dtype)
    (n,) = leaf.shape
    if leaf.init == "a_log":            # Mamba2's decay rates 1..16
        v = torch.log(torch.linspace(1.0, 16.0, n))
    elif leaf.init == "dt_bias":        # softplus(dt_bias) = 0.01
        v = torch.full((n,), math.log(math.expm1(0.01)))
    else:
        raise ValueError(f"unknown init {leaf.init!r} of {leaf.name}")
    return v.to(device=device, dtype=dtype)


def layer_of(name: str):
    """The layer index of a per-layer leaf (``l<i>.<what>``), else None."""
    if name.startswith("l") and "." in name:
        head = name.split(".", 1)[0][1:]
        if head.isdigit():
            return int(head)
    return None
