"""N:M structured sparsity — the weight-memory substrate (``repro.core.sparsity``).

A unit is one element (``block == 1``, the paper's form) or a ``block``-row
slab of the input dimension; units are grouped ``m`` at a time along the
fan-in and ``n`` of each group are kept, with one pattern per ``out_tile``
wide output tile. Unit masks are bool ``[KB, J]`` (``KB = K / block``,
``J = O / out_tile``).
"""
from __future__ import annotations

import dataclasses
from typing import Tuple

import torch


@dataclasses.dataclass(frozen=True)
class NMSpec:
    """Keep ``n`` of every ``m`` units (elements or blocks) along the input dim."""

    n: int
    m: int
    block: int = 1
    out_tile: int = 1

    def __post_init__(self):
        if not (0 < self.n <= self.m):
            raise ValueError(f"need 0 < n <= m, got n={self.n} m={self.m}")
        if self.block < 1 or self.out_tile < 1:
            raise ValueError("block/out_tile must be >= 1")

    @property
    def density(self) -> float:
        return self.n / self.m

    @property
    def sparsity(self) -> float:
        return 1.0 - self.density

    def group_shape(self, k: int, o: int) -> Tuple[int, int, int]:
        """(num_groups G, units per group M, num out tiles J) for a [k, o] weight."""
        kb, ob = self.unit_counts(k, o)
        if kb % self.m:
            raise ValueError(f"K units {kb} not divisible by m={self.m}")
        return kb // self.m, self.m, ob

    def unit_counts(self, k: int, o: int) -> Tuple[int, int]:
        if k % self.block:
            raise ValueError(f"K={k} not divisible by block={self.block}")
        if o % self.out_tile:
            raise ValueError(f"O={o} not divisible by out_tile={self.out_tile}")
        return k // self.block, o // self.out_tile


def paper_spec_4groups(k: int, sparsity: float = 0.8) -> NMSpec:
    """ElfCore's configuration: 4 N:M groups across the fan-in, each keeping
    ``round(M * (1 - s))`` connections."""
    if k % 4:
        raise ValueError("fan-in must divide into 4 groups")
    m = k // 4
    n = max(1, int(round(m * (1.0 - sparsity))))
    return NMSpec(n=n, m=m, block=1, out_tile=1)


def random_unit_mask(gen: torch.Generator, spec: NMSpec, k: int,
                     o: int) -> torch.Tensor:
    """Uniform random N:M pattern at unit granularity: bool ``[KB, J]``
    with exactly ``n`` kept units per (group, out tile). Drawn on the CPU
    from ``gen`` so a seed gives the same mask on every device."""
    kb, j = spec.unit_counts(k, o)
    g, m, _ = spec.group_shape(k, o)
    scores = torch.rand((g, m, j), generator=gen)
    kth = torch.sort(scores, dim=1).values[:, m - spec.n, :]   # n-th largest
    return (scores >= kth[:, None, :]).reshape(kb, j)


def expand_unit_mask(unit_mask: torch.Tensor, spec: NMSpec, k: int,
                     o: int) -> torch.Tensor:
    """Unit-granular mask ``[KB, J]`` -> dense boolean ``[K, O]``."""
    kb, j = spec.unit_counts(k, o)
    if tuple(unit_mask.shape) != (kb, j):
        raise ValueError(f"unit mask {tuple(unit_mask.shape)} != {(kb, j)}")
    return unit_mask.repeat_interleave(spec.block, 0).repeat_interleave(
        spec.out_tile, 1)


def apply_mask(w: torch.Tensor, unit_mask: torch.Tensor,
               spec: NMSpec) -> torch.Tensor:
    return w * expand_unit_mask(unit_mask, spec, *w.shape).to(w.dtype)
