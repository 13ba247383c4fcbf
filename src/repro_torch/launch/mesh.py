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

The LM meshes. :func:`make_production_mesh` builds the reference's
``(data 16, model 16)`` mesh of one pod, or ``(pod 2, data 16, model 16)``
across two (the pod axis carries only data parallelism), as a
``torch.distributed`` ``DeviceMesh`` over the default process group: one
rank a device. :func:`make_host_mesh` gives ``(data = world // model,
model)`` over whatever group there is; with none it gives a 1 × 1
:class:`AbstractMesh` on the caller's device, which issues no collective,
so a single-host run never initialises a group. An :class:`AbstractMesh`
(the counterpart of ``jax.sharding.AbstractMesh``) holds axis names and
sizes only: the placement rules of ``launch.sharding`` need no more, so
they run at full mesh size with no process. :func:`dp_axes` and
:func:`dp_size` read any of these meshes (a :class:`SlotMesh` has no DP
axes).
"""
from __future__ import annotations

import dataclasses
import math
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


# ---------------------------------------------------------------------------
# the LM meshes
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class AbstractMesh:
    """Mesh axis names and sizes with no devices and no process group
    (``jax.sharding.AbstractMesh``): what the placement rules read.
    ``shape`` and ``mesh_dim_names`` read as a ``DeviceMesh``'s do.
    ``device`` is where a 1 × 1 host mesh's tensors live; a step on it
    issues no collective (it has no process groups)."""
    axis_sizes: Tuple[int, ...]
    axis_names: Tuple[str, ...]
    device: Optional[torch.device] = None

    @property
    def mesh_dim_names(self) -> Tuple[str, ...]:
        return self.axis_names

    @property
    def shape(self) -> Tuple[int, ...]:
        return self.axis_sizes

    def size(self, mesh_dim: Optional[int] = None) -> int:
        return math.prod(self.axis_sizes) if mesh_dim is None \
            else self.axis_sizes[mesh_dim]


def axis_sizes(mesh) -> Dict[str, int]:
    """``{axis name: size}`` of any mesh of the port (a ``DeviceMesh``, an
    :class:`AbstractMesh`, a :class:`SlotMesh`), as a JAX mesh's
    ``shape`` reads."""
    if isinstance(mesh, SlotMesh):
        return dict(mesh.shape)
    return dict(zip(mesh.mesh_dim_names, mesh.shape))


def _device_type(device) -> str:
    """The mesh's device type: ``device``'s, else the default group's
    (``cuda`` under NCCL, the CPU otherwise)."""
    if device is not None:
        return torch.device(device).type
    import torch.distributed as dist
    return "cuda" if dist.get_backend() == "nccl" else "cpu"


def make_production_mesh(*, multi_pod: bool = False, device=None):
    """The ``(data 16, model 16)`` mesh of one pod, or ``(pod 2, data 16,
    model 16)``, over the first 256 or 512 ranks of the default process
    group (``device``'s type; default: ``cuda`` under NCCL, else the CPU).
    Raises ``RuntimeError`` when there is no group or it is smaller, as
    the reference does when devices are short."""
    import torch.distributed as dist
    from torch.distributed.device_mesh import DeviceMesh
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    need = math.prod(shape)
    have = dist.get_world_size() if dist.is_initialized() else 1
    if have < need:
        raise RuntimeError(
            f"mesh {shape} needs {need} ranks, found {have}: join that many "
            "processes through launcher.fleet_init's COORDINATOR_ADDRESS, "
            "PROCESS_COUNT and PROCESS_ID, or build the mesh on a fake "
            f"process group of {need} ranks (init_fake_group; tests, the "
            "dry run)")
    if dist.get_rank() >= need:
        raise RuntimeError(f"rank {dist.get_rank()} lies outside the mesh's "
                           f"first {need} ranks")
    return DeviceMesh(_device_type(device), torch.arange(need).reshape(shape),
                      mesh_dim_names=axes)


def init_fake_group(world_size: int) -> None:
    """A process group of ``world_size`` ranks inside this one process, as
    rank 0: it builds meshes and places nothing real (torch's fake
    backend). The dry run's counterpart of the reference's forced host
    device count; destroy it with ``dist.destroy_process_group()``."""
    import torch.distributed as dist
    from torch.testing._internal.distributed.fake_pg import FakeStore
    dist.init_process_group("fake", store=FakeStore(), rank=0,
                            world_size=world_size)


def make_host_mesh(model: int = 1, *, device=None):
    """``(data = world // model, model)`` over the default process group,
    or, with none initialised, a 1 × 1 :class:`AbstractMesh` on
    ``device`` (default ``cuda``) that issues no collective."""
    import torch.distributed as dist
    if not dist.is_initialized():
        if model != 1:
            raise ValueError(f"a host mesh without a process group has one "
                             f"device; model={model}")
        return AbstractMesh((1, 1), ("data", "model"),
                            torch.device(device or "cuda"))
    from torch.distributed.device_mesh import init_device_mesh
    world = dist.get_world_size()
    if model < 1 or world % model:
        raise ValueError(f"model={model} does not divide the {world} ranks")
    return init_device_mesh(_device_type(device), (world // model, model),
                            mesh_dim_names=("data", "model"))


def dp_axes(mesh) -> Tuple[str, ...]:
    """The mesh's data-parallel axes, ``pod`` before ``data``."""
    names = mesh.axis_names if isinstance(mesh, SlotMesh) \
        else mesh.mesh_dim_names
    return tuple(a for a in ("pod", "data") if a in names)


def dp_size(mesh) -> int:
    sizes = axis_sizes(mesh)
    return math.prod(sizes[a] for a in dp_axes(mesh))
