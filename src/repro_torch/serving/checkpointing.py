"""Fleet checkpointing in either delta layout, with migration
(``repro.serving.checkpointing``).

:func:`save_fleet` snapshots one serving fleet's weight state, the dense
``params``, the per-stream deltas in the layout the fleet runs (compact
``[S, L, J, T, bk, bo]`` or dense ``[S, L, Kmax, N]``) and the carried
``StreamState``, through the atomic keep-K ``checkpoint`` layer.

:func:`restore_fleet` reads the stored delta leaf's rank first
(``checkpoint.peek``), restores into a template built from the stored
shapes alone, on the ``meta`` device (no weights are drawn for it), and migrates when
the caller's fleet runs the other layout: ``engine.compact_deltas`` or
``engine.densify_deltas`` over the restored mask's ``stacked_kept_ids``,
a gather or a scatter, so the deltas are bitwise at every kept coordinate
(off the mask the dense layout is zero by the topology invariant).

A slot-sharded fleet (``launch.sharding.SlotSharded`` deltas and state) is
saved gathered, so it writes the files a 1-device fleet writes;
``restore_fleet(..., mesh=)`` shards what it reads over a slot mesh.
"""
from __future__ import annotations

from typing import Any, Dict, Optional, Tuple

import torch

from ..checkpoint import checkpoint
from ..core import engine
from ..core import topology as topology_lib
from ..core.snn import SNNConfig, StreamState, init_stream_state
from ..launch import sharding

_DENSE_DELTA_RANK = 4      # [S, L, Kmax, N]


def _fleet_tree(params, deltas, state: StreamState):
    return {"params": params, "deltas": deltas, "state": state}


def save_fleet(base: str, step: int, params: Dict[str, Any],
               deltas: torch.Tensor, state: StreamState,
               extra: Optional[Dict] = None, keep: int = 3) -> str:
    """Checkpoint one fleet's ``(params, deltas, state)`` at ``step``; the
    deltas are stored in their own layout, slot-sharded ones gathered."""
    extra = dict(extra or {})
    extra["n_slots"] = int(deltas.shape[0])
    extra["delta_layout"] = "compact" if deltas.dim() == 6 else "dense"
    tree = _fleet_tree(params, *sharding.gather((deltas, state)))
    return checkpoint.save(base, step, tree, extra=extra, keep=keep)


def _template(cfg: SNNConfig, shapes: Dict[str, Tuple]) -> Dict[str, Any]:
    """The fleet tree at the stored shapes, on the ``meta`` device."""
    meta = torch.device("meta")

    def empty(key, dtype=torch.float32):
        return torch.empty(shapes[key][0], dtype=dtype, device=meta)
    params = {"hidden": {"w": empty("params/hidden/w"),
                         "mask": empty("params/hidden/mask", torch.bool)},
              "readout": empty("params/readout")}
    n_slots = shapes["deltas"][0][0]
    return _fleet_tree(params, empty("deltas"),
                       init_stream_state(cfg, n_slots, meta))


def restore_fleet(base: str, cfg: SNNConfig, step: Optional[int] = None,
                  compact: Optional[bool] = None, device="cuda", *,
                  mesh=None) -> Tuple[int, Dict[str, Any], torch.Tensor,
                                      StreamState, Dict]:
    """Restore ``(step, params, deltas, state, extra)`` onto ``device``,
    migrating the delta layout to ``compact`` (None = the
    ``init_stream_deltas`` auto choice). With a slot ``mesh`` the deltas
    and state come back sharded over it and the params on its first
    entry's device."""
    if mesh is not None:
        device = mesh.devices[0]
    step, shapes, _ = checkpoint.peek(base, step)
    stored_compact = len(shapes["deltas"][0]) != _DENSE_DELTA_RANK
    step, tree, extra = checkpoint.restore(base, _template(cfg, shapes),
                                           step=step, device=device)
    params, deltas = tree["params"], tree["deltas"]
    want_compact = engine.geometry(cfg).uniform if compact is None \
        else compact
    if want_compact != stored_compact:
        idx = topology_lib.stacked_kept_ids(params["hidden"]["mask"], cfg)
        deltas = (engine.compact_deltas(deltas, idx, cfg) if want_compact
                  else engine.densify_deltas(deltas, idx, cfg))
    state = tree["state"]
    if mesh is not None:
        deltas, state = sharding.device_put(
            (deltas, state), sharding.slot_sharding(mesh))
    return step, params, deltas, state, extra
