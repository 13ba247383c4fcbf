"""The serving mesh (``repro.launch.mesh``, its serving part).

The event-stream chunk step is per-slot separable (no collectives), so the
one useful serving topology is a flat slot axis over the devices a host
has: the software analogue of the paper's replicated on-chip learning
datapaths, each with strictly core-local state. :func:`make_serving_mesh`
builds that 1-D ``("slots",)`` mesh: a frozen list of devices, one shard
of every slot grid on each entry, in order.

A mesh may list one device more than once (``devices=[cuda:0] * 4``): the
port's counterpart of XLA's forced host device count, with which the
reference fakes eight CPU devices in its tests. The same code then runs
the shards of one card one after another, on its one stream, and runs
them on distinct cards where there are any.

The production meshes of the LM path (``make_production_mesh``,
``make_host_mesh``, ``dp_axes``, ``dp_size``) are not ported yet
(``ROADMAP.md`` Queue 1 item 10b).
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Sequence, Tuple

import torch

SLOT_AXIS = "slots"


@dataclasses.dataclass(frozen=True)
class SlotMesh:
    """A 1-D ``("slots",)`` mesh: ``devices[i]`` holds shard ``i`` of every
    slot grid. ``shape`` reads ``{"slots": n}``, as a JAX mesh's does."""
    devices: Tuple[torch.device, ...]
    axis_names: Tuple[str, ...] = (SLOT_AXIS,)

    @property
    def shape(self) -> Dict[str, int]:
        return {SLOT_AXIS: len(self.devices)}

    @property
    def size(self) -> int:
        return len(self.devices)


def make_serving_mesh(n_devices: Optional[int] = None, *,
                      devices: Optional[Sequence] = None) -> SlotMesh:
    """1-D ``("slots",)`` mesh over the first ``n_devices`` of ``devices``
    (default: every visible CUDA device; all of them when ``n_devices`` is
    None). ``devices`` may repeat a device; it may not mix device types.
    Raises when ``n_devices`` exceeds the devices there are."""
    if devices is None:
        devs = [torch.device("cuda", i)
                for i in range(torch.cuda.device_count())]
        hint = "visible CUDA devices"
    else:
        devs = [torch.device(d) for d in devices]
        hint = "devices listed"
    n = len(devs) if n_devices is None else int(n_devices)
    if n < 1 or len(devs) < n:
        raise RuntimeError(
            f"serving mesh needs {max(n, 1)} devices, found {len(devs)} "
            f"{hint} — pass devices=[...] (a device may repeat) to build a "
            f"mesh over fewer")
    devs = devs[:n]
    kinds = sorted({d.type for d in devs})
    if len(kinds) > 1:
        raise ValueError(f"a serving mesh holds one device type, got {kinds}")
    return SlotMesh(tuple(devs))
