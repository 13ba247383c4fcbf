"""N:M structured sparsity — the weight-memory substrate (``repro.core.sparsity``).

A unit is one element (``block == 1``, the paper's form) or a ``block``-row
slab of the input dimension; units are grouped ``m`` at a time along the
fan-in and ``n`` of each group are kept, with one pattern per ``out_tile``
wide output tile. Unit masks are bool ``[KB, J]`` (``KB = K / block``,
``J = O / out_tile``).
"""
from __future__ import annotations

import dataclasses
import math
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


def check_unit_mask(unit_mask: torch.Tensor, spec: NMSpec) -> torch.Tensor:
    """True (0-dim bool tensor) iff every (group, out-tile) keeps exactly n
    units. Accepts leading batch dims (``[..., KB, J]``) sharing one spec."""
    *lead, kb, j = unit_mask.shape
    counts = unit_mask.reshape(*lead, kb // spec.m, spec.m, j).sum(dim=-2)
    return (counts == spec.n).all()


def compact_indices(unit_mask: torch.Tensor, spec: NMSpec) -> torch.Tensor:
    """Per (group, out-tile): the ``n`` kept unit indices (local in
    ``[0, m)``), int32 ``[G, n, J]`` ascending per group — the chip's index
    SRAM. A stable argsort of ``~mask`` (cast to int: torch sorts no bool)
    puts kept units first in ascending order, as the reference does."""
    kb, j = unit_mask.shape
    grouped = unit_mask.reshape(kb // spec.m, spec.m, j)
    order = torch.argsort((~grouped).to(torch.int8), dim=1, stable=True)
    return order[:, :spec.n, :].to(torch.int32)


def memory_bits(k: int, o: int, spec: NMSpec, weight_bits: int = 8) -> dict:
    """Weight-memory cost of dense vs compact N:M storage, in bits:
    ``weight_bits`` per kept value plus a ``ceil(log2 m)``-bit index per
    kept unit per out-tile column group (the paper's on-chip memory cut)."""
    g, m, j = spec.group_shape(k, o)
    idx_bits = max(1, math.ceil(math.log2(spec.m)))
    dense = k * o * weight_bits
    kept_values = g * spec.n * spec.block * o * weight_bits
    kept_index = g * spec.n * j * idx_bits
    comp = kept_values + kept_index
    return {"dense_bits": dense, "compact_bits": comp,
            "reduction": 1.0 - comp / dense,
            "index_overhead": kept_index / comp}


def apply_mask(w: torch.Tensor, unit_mask: torch.Tensor,
               spec: NMSpec) -> torch.Tensor:
    return w * expand_unit_mask(unit_mask, spec, *w.shape).to(w.dtype)


def unit_scores(x: torch.Tensor, spec: NMSpec, k: int, o: int,
                reduce: str = "abs_sum") -> torch.Tensor:
    """Summarise a dense ``[K, O]`` tensor to unit granularity ``[KB, J]``
    (``abs_sum``: the "k smallest weights" prune key at block resolution)."""
    kb, j = spec.unit_counts(k, o)
    xg = x.reshape(kb, spec.block, j, spec.out_tile)
    if reduce == "abs_sum":
        return xg.abs().sum(dim=(1, 3))
    if reduce == "sum":
        return xg.sum(dim=(1, 3))
    if reduce == "max":
        return xg.abs().amax(dim=(1, 3))
    raise ValueError(reduce)


def indices_to_unit_mask(idx: torch.Tensor, spec: NMSpec) -> torch.Tensor:
    """Inverse of :func:`compact_indices`: int32 ``[G, n, J]`` -> bool
    ``[KB, J]``."""
    g, _, j = idx.shape
    grouped = torch.zeros((g, spec.m, j), dtype=torch.bool, device=idx.device)
    return grouped.scatter_(1, idx.long(), True).reshape(g * spec.m, j)


def _idx_cols(idx: torch.Tensor, spec: NMSpec, o: int) -> torch.Tensor:
    """Local unit ids ``[G, n, J]`` repeated over each out tile's columns,
    shaped ``[G, n, block, O]`` for a gather or scatter along dim 1."""
    g, n, _ = idx.shape
    cols = idx.long().repeat_interleave(spec.out_tile, dim=2)   # [G, n, O]
    return cols[:, :, None, :].expand(g, n, spec.block, o)


def compact_values(w: torch.Tensor, idx: torch.Tensor,
                   spec: NMSpec) -> torch.Tensor:
    """Gather the kept weights of dense ``w [K, O]`` into compact storage
    ``[G, n, block, O]`` (``idx``: ``[G, n, J]`` local unit ids; the out
    tile's pattern repeats over its columns)."""
    k, o = w.shape
    g = idx.shape[0]
    wg = w.reshape(g, spec.m, spec.block, o)
    return torch.gather(wg, 1, _idx_cols(idx, spec, o))


def densify_values(values: torch.Tensor, idx: torch.Tensor, spec: NMSpec,
                   k: int, o: int) -> torch.Tensor:
    """Scatter compact ``[G, n, block, O]`` back to dense ``[K, O]`` (zeros
    elsewhere)."""
    g = idx.shape[0]
    dense = values.new_zeros((g, spec.m, spec.block, o))
    return dense.scatter_(1, _idx_cols(idx, spec, o), values).reshape(k, o)
