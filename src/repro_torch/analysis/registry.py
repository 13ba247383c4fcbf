"""Contract registry (``repro.analysis.registry``): the port's real entry
points bound to contract sets.

Each entry names one production entry point plus the invariants its
callers rely on; ``check_all()`` runs every set on a small-but-real
configuration (compact AND dense delta layouts, both QoS tiers' chunk
geometries, factors on and off, sharded over a slot mesh and not) on the
device asked for, so a change that breaks a hot-path contract (a
collective in the chunk step, a dense mask in the compact run, a factor
accumulator surviving ``want_factors=False``) fails with the contract's
name, not as a parity diff later::

    python -m repro_torch.analysis.registry --device cpu

Entries are built lazily (registering costs nothing at import), each
returning ``(fn, args, contracts, kwargs)`` for
:func:`repro_torch.analysis.dispatch_contracts.check`.
"""
from __future__ import annotations

from typing import Callable, Dict, List, Optional, Sequence

from . import dispatch_contracts as dc

_REG: Dict[str, Callable[[str], tuple]] = {}

# small-but-real geometry shared by the SNN entries; S is distinct from the
# chunk length, layer count and n_out so slot_separable cannot pass
# vacuously (see its docstring); so is the sharded entry's per-shard count
# (_S_SHARDED slots over _MESH entries of the device: 3 a shard)
_S, _C = 4, 5
_S_SHARDED, _MESH = 6, 2


def register(name: str):
    def deco(build: Callable[[str], tuple]):
        _REG[name] = build
        return build
    return deco


def names() -> List[str]:
    return sorted(_REG)


def build(name: str, device: str = "cuda") -> tuple:
    """Entry ``name``'s ``(fn, args, contracts, kwargs)`` on ``device``."""
    return _REG[name](device)


def check_entry(name: str, device: str = "cuda") -> dc.Report:
    fn, args, contracts, kwargs = build(name, device)
    return dc.check(fn, args, contracts, kwargs=kwargs, name=name)


def check_all(only: Optional[Sequence[str]] = None,
              device: str = "cuda") -> Dict[str, dc.Report]:
    return {n: check_entry(n, device) for n in names()
            if only is None or n in only}


def summary(reports: Optional[Dict[str, dc.Report]] = None,
            device: str = "cuda") -> dict:
    """Compact roll-up: how many entry points and contracts ran and whether
    all held."""
    reports = check_all(device=device) if reports is None else reports
    return {
        "entrypoints": sorted(reports),
        "contracts": sum(len(r.contracts) for r in reports.values()),
        "violations": sum(len(r.violations) for r in reports.values()),
        "ok": all(r.ok for r in reports.values()),
    }


# --------------------------------------------------------------------------
# shared helpers
# --------------------------------------------------------------------------

def snn_cfg():
    """The registry's SNN geometry (the reference's), on the kernels
    backend so a CUDA run launches the fused ``nm_spmm``, ``lif`` and
    ``wu_outer_slots`` kernels (a CPU run takes their plain versions)."""
    from ..core.snn import SNNConfig
    return SNNConfig(n_in=32, n_hidden=32, n_layers=2, n_out=8, t_steps=8,
                     backend="kernels")


def _snn_inputs(cfg, device: str, *, compact: bool, chunk_len: int = _C,
                n_slots: int = _S):
    import numpy as np
    import torch
    from ..core import snn

    params = snn.init_params(0, cfg, device=device)
    deltas = snn.init_stream_deltas(cfg, n_slots, device=device,
                                    compact=compact)
    state = snn.init_stream_state(cfg, n_slots, device=device)
    rng = np.random.default_rng(0)
    events = torch.tensor(rng.random((chunk_len, n_slots, cfg.n_in)) < 0.25,
                          dtype=torch.float32, device=device)
    valid = torch.ones((chunk_len, n_slots), dtype=torch.bool, device=device)
    amask = torch.ones((n_slots,), dtype=torch.bool, device=device)
    return params, deltas, state, events, valid, amask


def chunk_contracts(cfg, n_slots: int, chunk_len: int, *, compact: bool,
                    want_factors: bool) -> List[dc.Contract]:
    """The serving chunk fn's contract set (the reference's)."""
    contracts = [
        dc.no_collectives(),
        dc.slot_separable(
            n_slots,
            exempt=(".pre_mag", ".post_mag") if want_factors else ()),
        dc.dtype_discipline(),
        dc.compile_count(),
    ]
    if compact:
        contracts += [dc.mask_free(cfg), dc.no_dense_deltas(cfg, n_slots)]
    if not want_factors:
        contracts += [dc.no_factor_carries(cfg, n_slots,
                                           chunk_len=chunk_len)]
    return contracts


def counted(fn):
    """``fn`` with the ``n_traces`` hook ``compile_count`` reads: the port's
    compile events (:func:`dispatch_contracts.compile_events`)."""
    fn.n_traces = dc.compile_events
    return fn


def _chunk_entry(device: str, *, want_factors: bool, compact: bool,
                 chunk_len: int = _C, n_slots: int = _S, mesh=None):
    """A serving chunk fn on the registry's inputs; with a slot ``mesh``
    the per-shard slot count is the one the contracts hold every result
    leaf to (a sharded result's leaves are its shards)."""
    from ..core import snn
    from ..serving.adapt import AdaptConfig, make_chunk_fn

    cfg = snn_cfg()
    params, deltas, state, events, valid, amask = _snn_inputs(
        cfg, device, compact=compact, chunk_len=chunk_len, n_slots=n_slots)
    exec_params = snn.serving_params(params, cfg, compact=compact)
    fn = counted(make_chunk_fn(cfg, AdaptConfig(), want_factors=want_factors,
                               mesh=mesh))
    per_shard = n_slots if mesh is None else n_slots // mesh.size
    return fn, (exec_params, deltas, state, events, valid, amask), \
        chunk_contracts(cfg, per_shard, chunk_len, compact=compact,
                        want_factors=want_factors), None


# --------------------------------------------------------------------------
# entries
# --------------------------------------------------------------------------

@register("serving.chunk_fn[compact,factors]")
def _chunk_compact_factors(device):
    """The default serving hot path: mask-free exec params, compact deltas,
    DSST factors slot-reduced on the device."""
    return _chunk_entry(device, want_factors=True, compact=True)


@register("serving.chunk_fn[compact,frozen]")
def _chunk_compact_frozen(device):
    """Frozen-topology fleet: the factors left out of the chunk step."""
    return _chunk_entry(device, want_factors=False, compact=True)


@register("serving.chunk_fn[dense]")
def _chunk_dense(device):
    """The dense A/B layout (no mask-free claim, but the zero-collective /
    slot-separable / compile-once contracts still bind)."""
    return _chunk_entry(device, want_factors=True, compact=False)


@register("serving.chunk_fn[tier=interactive]")
def _chunk_tier_interactive(device):
    """The interactive QoS tier's geometry: a short chunk. Same compact rep
    and contract set as the default hot path."""
    return _chunk_entry(device, want_factors=True, compact=True,
                        chunk_len=3, n_slots=4)


@register("serving.chunk_fn[tier=bulk]")
def _chunk_tier_bulk(device):
    """The bulk QoS tier's geometry: a long chunk."""
    return _chunk_entry(device, want_factors=True, compact=True,
                        chunk_len=12, n_slots=4)


@register("serving.chunk_fn[sharded]")
def _chunk_sharded(device):
    """The slot-sharded step (the port's ``shard_map``) on a mesh of two
    entries of ``device``: no collective anywhere in the call, placement
    and gather included, and every result leaf, a shard, keeping its
    per-shard slot axis. The same code runs on distinct cards."""
    from ..launch.mesh import make_serving_mesh
    return _chunk_entry(device, want_factors=True, compact=True,
                        n_slots=_S_SHARDED,
                        mesh=make_serving_mesh(devices=[device] * _MESH))


@register("snn.run_chunk[compact]")
def _run_chunk_compact(device):
    """The raw engine chunk step on the compact layout: the per-slot factor
    metrics keep their S axis here (slot reduction happens in the serving
    wrapper, not the engine)."""
    from ..core import snn

    cfg = snn_cfg()
    params, deltas, state, events, valid, _ = _snn_inputs(cfg, device,
                                                          compact=True)
    sp = snn.serving_params(params, cfg, compact=True)

    def run_chunk_compact(p, d, s, e, v):
        return snn.run_chunk(p, d, s, e, v, cfg)

    contracts = [dc.no_collectives(), dc.slot_separable(_S),
                 dc.mask_free(cfg), dc.no_dense_deltas(cfg, _S),
                 dc.dtype_discipline()]
    return run_chunk_compact, (sp, deltas, state, events, valid), \
        contracts, None


@register("snn.run_chunk[dense]")
def _run_chunk_dense(device):
    from ..core import snn

    cfg = snn_cfg()
    params, deltas, state, events, valid, _ = _snn_inputs(cfg, device,
                                                          compact=False)

    def run_chunk_dense(p, d, s, e, v):
        return snn.run_chunk(p, d, s, e, v, cfg)

    contracts = [dc.no_collectives(), dc.slot_separable(_S),
                 dc.dtype_discipline()]
    return run_chunk_dense, (params, deltas, state, events, valid), \
        contracts, None


@register("launch.decode_step")
def _decode_step(device):
    """The continuous batcher's one-token decode: slot (batch) separability
    is what makes slot multiplexing sound; the cache's host ``pos`` is the
    one sanctioned slot-reduced output."""
    import torch
    from .. import configs as C
    from ..models import transformer as T

    cfg = C.get_reduced("phi3_medium_14b")
    params = T.init_params(torch.Generator().manual_seed(0), cfg,
                           device=device)
    batch = _S
    cache = T.init_cache(cfg, batch, 32, device=device)
    tokens = torch.zeros((batch,), dtype=torch.int32, device=device)

    def decode_step(p, c, t):
        return T.decode_step(p, c, t, cfg)

    contracts = [dc.no_collectives(), dc.dtype_discipline(),
                 dc.slot_separable(batch, exempt=("pos",))]
    return decode_step, (params, cache, tokens), contracts, None


# --------------------------------------------------------------------------
# CLI
# --------------------------------------------------------------------------

def main(argv: Optional[Sequence[str]] = None) -> int:
    import argparse

    ap = argparse.ArgumentParser(
        prog="python -m repro_torch.analysis.registry",
        description="run every registered entry point's contract set")
    ap.add_argument("entries", nargs="*", help="entry names (default: all)")
    ap.add_argument("--list", action="store_true",
                    help="list registered entries and exit")
    ap.add_argument("--device", choices=("cpu", "cuda"), default="cuda",
                    help="where the entry points run (default: cuda)")
    args = ap.parse_args(argv)

    if args.list:
        for n in names():
            print(n)
        return 0

    reports = check_all(only=args.entries or None, device=args.device)
    bad = 0
    for name in sorted(reports):
        r = reports[name]
        status = "PASS" if r.ok else "FAIL"
        print(f"{status} {name} ({', '.join(r.contracts)})")
        for v in r.violations:
            bad += 1
            print(f"  {v}")
    s = summary(reports)
    print(f"{len(reports)} entrypoints, {s['contracts']} contracts, "
          f"{s['violations']} violation(s) on {args.device}")
    return 1 if bad else 0


if __name__ == "__main__":
    import sys
    sys.exit(main())
