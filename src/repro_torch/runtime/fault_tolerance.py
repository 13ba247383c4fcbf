"""Fault tolerance (``repro.runtime.fault_tolerance``): failure recovery,
elastic placement, straggler policy.

Exercised by *simulation*, as in the reference: failures are injected.

* ``run_with_recovery`` — a supervisor loop around a training step: on a
  (simulated) node failure it restores the latest valid checkpoint through
  the port's ``checkpoint`` and continues; the continuation equals an
  uninterrupted run bit for bit (the data is indexed by step).
* ``elastic_remesh`` — re-place a tree onto a new mesh or one device, bit
  for bit: a slot mesh of any size (``launch.mesh.make_serving_mesh``;
  slot-axis leaves shard, the rest replicate), an LM mesh of any shape
  (a ``DeviceMesh``; leaves become ``DTensor`` s by their spec), or one
  device.
* ``HeartbeatMonitor`` / ``StragglerPolicy`` — per-replica step-time EMAs;
  replicas slower than ``threshold ×`` the fleet median are flagged
  (numpy only, the reference's code).
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, List, Optional, Tuple

import numpy as np
import torch

from .. import checkpoint as ckpt
from ..checkpoint.checkpoint import _children, _flatten, _is_namedtuple
from ..launch import sharding
from ..launch.mesh import SlotMesh, make_serving_mesh
from ..placed import full_tensor


# ---------------------------------------------------------------------------
# straggler detection
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class StragglerPolicy:
    threshold: float = 1.5        # x median step time
    ema: float = 0.3
    min_steps: int = 3            # grace period before flagging


class HeartbeatMonitor:
    def __init__(self, n_replicas: int, policy: Optional[StragglerPolicy] = None):
        self.policy = policy or StragglerPolicy()
        self.ema = np.zeros(n_replicas)
        self.count = np.zeros(n_replicas, int)

    def record(self, replica: int, step_time: float):
        a = self.policy.ema
        if self.count[replica] == 0:
            self.ema[replica] = step_time
        else:
            self.ema[replica] = (1 - a) * self.ema[replica] + a * step_time
        self.count[replica] += 1

    def stragglers(self) -> List[int]:
        ready = self.count >= self.policy.min_steps
        if not ready.any():
            return []
        med = float(np.median(self.ema[ready]))
        flag = ready & (self.ema > self.policy.threshold * med)
        return [int(i) for i in np.where(flag)[0]]

    def healthy_replicas(self) -> List[int]:
        bad = set(self.stragglers())
        return [i for i in range(len(self.ema)) if i not in bad]


# ---------------------------------------------------------------------------
# elastic placement
# ---------------------------------------------------------------------------

def _map_with_path(fn, tree, path=()):
    """``fn(path, leaf)`` over the leaves of ``tree`` (the checkpoint's
    containers and keys), rebuilt in the same structure."""
    kids = _children(tree)
    if kids is None:
        return fn(path, tree)
    if tree is None:
        return None
    vals = [_map_with_path(fn, v, path + (k,)) for k, v in kids]
    if isinstance(tree, dict):
        by_key = dict(zip(sorted(tree), vals))
        return {k: by_key[k] for k in tree}
    if _is_namedtuple(tree):
        return type(tree)(*vals)
    return type(tree)(vals)


def _whole(leaf):
    """A placed leaf as one tensor: a slot mesh's pieces gathered, a
    ``DTensor`` gathered whole (every rank of its mesh calls this, in the
    tree's order)."""
    from torch.distributed.tensor import DTensor
    if isinstance(leaf, DTensor):
        return full_tensor(leaf)
    return sharding.gather(leaf)


def elastic_remesh(tree: Any, target, spec_fn: Callable[[Any], Any]) -> Any:
    """Place every tensor leaf of ``tree`` on ``target``: a slot mesh, an
    LM mesh (a ``DeviceMesh`` from ``launch.mesh``, or a 1 × 1
    ``AbstractMesh`` on a device), a list of devices (two or more make a
    slot mesh, which may repeat a device but not mix types), or one
    ``torch.device`` (or a list of one).

    ``spec_fn(path)`` gives a leaf's spec (``path``: its keys from the root:
    dict keys, sequence indices, ``.field`` for a NamedTuple), as the
    reference's ``NamedSharding(new_mesh, spec_fn(path))``. On a slot mesh
    ``launch.sharding.slot_spec(k)`` splits axis ``k`` over the mesh's
    entries and ``None`` or ``()`` replicates (one copy an entry); a model
    or data axis is refused there. On an LM mesh the spec names its axes
    (``launch.sharding.tree_shardings`` gives the reference's) and a leaf
    becomes a ``DTensor`` holding this rank's block; every rank of that
    mesh calls this with the same tree. On one device every leaf is moved
    whole, whatever its spec. Leaves already placed (``SlotSharded``,
    ``Replicated``, ``DTensor``) are gathered whole first, so a tree moves
    between meshes of any shape with its values unchanged.
    """
    mesh = dev = None
    if isinstance(target, SlotMesh) or hasattr(target, "mesh_dim_names"):
        mesh = target
    else:
        devices = list(target) if isinstance(target, (list, tuple)) \
            else [target]
        if len(devices) > 1:
            mesh = make_serving_mesh(devices=devices)
        else:
            dev = torch.device(devices[0])

    def one(path, leaf):
        if not isinstance(leaf, (torch.Tensor, sharding.SlotSharded,
                                 sharding.Replicated)):
            return leaf
        spec = sharding.P(*(spec_fn(path) or ()))
        whole = _whole(leaf)
        if mesh is None:
            return whole.to(dev)
        return sharding.NamedSharding(mesh, spec).place(whole)
    return _map_with_path(one, tree)


class SimulatedFailure(RuntimeError):
    """Injected stand-in for a lost node / preempted slice."""


# ---------------------------------------------------------------------------
# supervisor loop
# ---------------------------------------------------------------------------

def _meta_template(tree):
    """``tree`` with every tensor leaf an empty ``meta`` tensor of its
    shape and dtype (host ints stay): a restore template that holds no
    memory."""
    return _map_with_path(
        lambda _, x: torch.empty_like(x, device="meta")
        if isinstance(x, torch.Tensor) else x, tree)


def _device_of(tree):
    for _, x in _flatten(tree):
        if isinstance(x, torch.Tensor):
            return x.device
    return torch.device("cpu")


def _release(tree) -> None:
    """Free the card memory of every CUDA tensor leaf of ``tree`` now,
    whoever else still holds the tensor (the caller's ``init_state`` among
    them): the state is lost, and a restore must not hold it beside the
    restored one."""
    for _, x in _flatten(tree):
        if isinstance(x, torch.Tensor) and x.is_cuda:
            x.untyped_storage().resize_(0)


def run_with_recovery(
    step_fn: Callable[[Any, int], Tuple[Any, Dict]],
    init_state: Any,
    n_steps: int,
    ckpt_dir: str,
    ckpt_every: int = 10,
    fail_at: Optional[Dict[int, int]] = None,
    max_restarts: int = 8,
) -> Tuple[Any, Dict]:
    """Run ``state, metrics = step_fn(state, step)`` for ``n_steps`` with
    checkpoint/restart. ``fail_at``: {step: how_many_times} injected
    faults. Returns ``(state, log)``, ``log`` holding ``restarts`` and
    ``restored_from`` (the step each restart restored).

    The state (tensors on one device, host ints, in dicts, lists, tuples
    and NamedTuples) must be fully step-indexed, data position included,
    so that recovery is deterministic bit for bit. It is saved as step -1
    before the first step, and after every step ``s`` with ``s %
    ckpt_every == ckpt_every - 1``. A directory that already holds a valid
    step resumes after it.

    ``init_state`` is donated: the port's steps update tensors in place
    (``adamw_update``), so its tensors are the running state's, and at a
    failure the lost state's card memory is freed before the checkpoint is
    restored (into a ``meta`` template, straight onto the state's device),
    so that two training states are never on the card at once. A caller
    that compares two runs clones the initial state for each; nothing
    here reads a tensor that a failed or later step has written.

    The reference saves step -1 under a name its ``latest_step`` never
    matches (``step_-00000001``), so a failure before the first periodic
    save raises ``FileNotFoundError`` there; here that restart restores
    step -1 by name and starts again from step 0 (``restored_from`` logs
    -1). The directory layout is the reference's."""
    fail_at = dict(fail_at or {})
    restarts = 0
    log: Dict[str, Any] = {"restarts": 0, "restored_from": []}
    device = _device_of(init_state)

    start = ckpt.latest_step(ckpt_dir)
    if start is not None:
        tpl = _meta_template(init_state)
        _release(init_state)
        _, state, _ = ckpt.restore(ckpt_dir, tpl, device=device)
        step = start + 1
    else:
        ckpt.save(ckpt_dir, -1, init_state)
        state, step = init_state, 0
    del init_state

    while step < n_steps:
        try:
            if fail_at.get(step, 0) > 0:
                fail_at[step] -= 1
                raise SimulatedFailure(f"node lost at step {step}")
            state, _ = step_fn(state, step)
            if step % ckpt_every == ckpt_every - 1:
                ckpt.save(ckpt_dir, step, state)
            step += 1
        except SimulatedFailure:
            restarts += 1
            log["restarts"] = restarts
            if restarts > max_restarts:
                raise
            last = ckpt.latest_step(ckpt_dir)
            last = -1 if last is None else last
            log["restored_from"].append(last)
            tpl = _meta_template(state)
            _release(state)
            state = None
            _, state, _ = ckpt.restore(ckpt_dir, tpl, step=last, device=device)
            step = last + 1
    return state, log
