"""Fault-tolerant checkpointing: atomic, step-tagged, keep-K, resumable
(``repro.checkpoint``).

Layout, the reference's, so that either package restores what the other
saved::

    <dir>/step_000000123/
        manifest.json        # sorted leaf keys, a tree description, extra
        arrays.npz           # flattened leaves, key = path string
    <dir>/step_000000123.tmp # staging dir, renamed when complete

* **atomicity**: writes go to a ``.tmp`` dir and ``os.rename`` commits;
* **self-validating restore**: a step whose manifest or ``arrays.npz`` is
  missing, incomplete or unreadable is skipped for the previous valid one;
* **keep-K**: older steps are pruned after a successful commit;
* **resume determinism**: restore gives back the exact tree, bit for bit,
  plus the ``extra`` dict (data-pipeline position and the like).

Leaf keys follow ``jax.tree_util.tree_flatten_with_path`` as the reference
joins them: a dict entry by its key, a list or tuple element by its index,
a NamedTuple field as ``.field``, joined with ``/`` (``state/.layers/.v``,
``.m/a``); dicts flatten in sorted key order. Leaves: a tensor is written
as numpy (int64 as int32, the reference's integer width; bf16 as its raw
2-byte words, numpy ``|V2``, which is how the reference's bfloat16 arrays
land in a ``.npz``); a host int as a 0-d int32 array. Each leaf goes to
the host once, in :func:`save`. :func:`restore` puts every leaf into the
template's dtype and device (an int template leaf gives back a host int).
The manifest's ``treedef`` is a description of the port's own tree for a
reader's eye; nothing reads it back.

A tensor-parallel state (``DTensor`` leaves, ``launch/spmd``) is written
in the unsharded layout that a 1-process checkpoint has: :func:`save`
gathers one such leaf at a time whole by eager ``all_gather`` over its
mesh dims (every rank calls it, in the tree's order); rank 0 moves it to
the host at once and the others drop it, rank 0 writes, and the ranks meet
at a barrier.
:func:`restore` into a ``DTensor`` template keeps each rank's block of the
stored whole tensor by the template's placements (``placed.place_like``), so
a checkpoint from a tensor-parallel run restores in one process and a
1-process checkpoint restores under tensor parallelism.
"""
from __future__ import annotations

import json
import os
import re
import shutil
import zipfile
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch

from ..placed import full_tensor, place_like

_STEP_RE = re.compile(r"^step_(\d{9})$")


def _step_dir(base: str, step: int) -> str:
    return os.path.join(base, f"step_{step:09d}")


def _is_namedtuple(x) -> bool:
    return isinstance(x, tuple) and hasattr(x, "_fields")


def _children(tree) -> Optional[List[Tuple[str, Any]]]:
    """``(key, child)`` pairs of a container, or None for a leaf. None
    (an empty subtree, as in JAX) has no children and no leaf."""
    if tree is None:
        return []
    if isinstance(tree, dict):
        return [(str(k), tree[k]) for k in sorted(tree)]
    if _is_namedtuple(tree):
        return [("." + f, getattr(tree, f)) for f in tree._fields]
    if isinstance(tree, (list, tuple)):
        return [(str(i), v) for i, v in enumerate(tree)]
    return None


def _flatten(tree, prefix: str = "") -> List[Tuple[str, Any]]:
    kids = _children(tree)
    if kids is None:
        return [(prefix, tree)]
    out = []
    for key, child in kids:
        out.extend(_flatten(child, f"{prefix}/{key}" if prefix else key))
    return out


def _describe(tree) -> str:
    kids = _children(tree)
    if kids is None:
        return "*"
    if tree is None:
        return "None"
    inner = ", ".join(f"{k}: {_describe(v)}" for k, v in kids)
    name = type(tree).__name__
    return f"{name}({inner})"


def _to_numpy(leaf) -> np.ndarray:
    """One leaf as the array the reference would write for it."""
    if isinstance(leaf, torch.Tensor):
        t = leaf.detach()
        if t.dtype == torch.bfloat16:
            return t.view(torch.int16).cpu().numpy().view("V2")
        a = t.cpu().numpy()
        if a.dtype == np.int64:
            if a.size and (a.max() > np.iinfo(np.int32).max
                           or a.min() < np.iinfo(np.int32).min):
                raise ValueError("int64 leaf does not fit the int32 the "
                                 "checkpoint stores")
            a = a.astype(np.int32)
        return a
    if isinstance(leaf, (bool, np.bool_)):
        return np.asarray(leaf, np.bool_)
    if isinstance(leaf, (int, np.integer)):
        return np.asarray(leaf, np.int32)
    return np.asarray(leaf)


def _is_placed(leaf) -> bool:
    return hasattr(leaf, "device_mesh") and hasattr(leaf, "to_local")


def save(base: str, step: int, tree: Any, extra: Optional[Dict] = None,
         keep: int = 3) -> str:
    """Write ``tree`` as step ``step`` under ``base`` (atomic), then keep
    the newest ``keep`` steps. Returns the step's directory. A tree with
    ``DTensor`` leaves is a collective (module docstring): every rank calls
    it, and rank 0 writes."""
    leaves = _flatten(tree)
    if any(_is_placed(v) for _, v in leaves):
        import torch.distributed as dist
        writer = dist.get_rank() == 0
        host = []
        for k, v in leaves:             # one whole leaf on the card at a time
            if _is_placed(v):
                v = full_tensor(v)
            host.append((k, _to_numpy(v) if writer else None))
            del v
        final = _step_dir(base, step)
        if writer:
            _write(base, step, host, _describe(tree), extra, keep)
        dist.barrier()
        return final
    return _write(base, step, leaves, _describe(tree), extra, keep)


def _write(base: str, step: int, leaves, treedef: str,
           extra: Optional[Dict], keep: int) -> str:
    os.makedirs(base, exist_ok=True)
    final = _step_dir(base, step)
    tmp = final + ".tmp"
    if os.path.exists(tmp):
        shutil.rmtree(tmp)
    os.makedirs(tmp)
    flat = {k: _to_numpy(v) for k, v in leaves}
    np.savez(os.path.join(tmp, "arrays.npz"), **flat)
    manifest = {"step": step, "treedef": treedef,
                "keys": sorted(flat), "extra": extra or {},
                "complete": True}
    with open(os.path.join(tmp, "manifest.json"), "w") as f:
        json.dump(manifest, f)
    if os.path.exists(final):
        shutil.rmtree(final)
    os.rename(tmp, final)
    _prune(base, keep)
    return final


def _prune(base: str, keep: int) -> None:
    for s in list_steps(base)[:-keep]:
        shutil.rmtree(_step_dir(base, s), ignore_errors=True)


def list_steps(base: str) -> List[int]:
    """Committed step numbers under ``base``, ascending (valid or not)."""
    if not os.path.isdir(base):
        return []
    return sorted(int(m.group(1)) for m in map(_STEP_RE.match,
                                                os.listdir(base)) if m)


def _valid(base: str, step: int) -> bool:
    d = _step_dir(base, step)
    mf = os.path.join(d, "manifest.json")
    az = os.path.join(d, "arrays.npz")
    if not (os.path.isfile(mf) and os.path.isfile(az)):
        return False
    try:
        with open(mf) as f:
            man = json.load(f)
        if not man.get("complete"):
            return False
        with np.load(az) as z:
            return sorted(z.files) == man["keys"]
    except Exception:
        return False


def latest_step(base: str) -> Optional[int]:
    """The newest valid step under ``base``, or None."""
    for s in reversed(list_steps(base)):
        if _valid(base, s):
            return s
    return None


def _resolve(base: str, step: Optional[int]) -> int:
    if step is None:
        step = latest_step(base)
        if step is None:
            raise FileNotFoundError(f"no valid checkpoint under {base}")
    return step


def peek(base: str, step: Optional[int] = None
         ) -> Tuple[int, Dict[str, Tuple[Tuple[int, ...], str]], Dict]:
    """Shapes and dtypes of a checkpoint's leaves without building a
    template: ``(step, {key: (shape, dtype_str)}, extra)``. Reads only the
    ``.npy`` headers inside the archive, not the arrays."""
    step = _resolve(base, step)
    d = _step_dir(base, step)
    with open(os.path.join(d, "manifest.json")) as f:
        man = json.load(f)
    shapes = {}
    with zipfile.ZipFile(os.path.join(d, "arrays.npz")) as zf:
        for name in zf.namelist():
            with zf.open(name) as fh:
                version = np.lib.format.read_magic(fh)
                read = (np.lib.format.read_array_header_1_0 if version == (1, 0)
                        else np.lib.format.read_array_header_2_0)
                shape, _, dtype = read(fh)
            shapes[name[:-len(".npy")]] = (tuple(shape), str(dtype))
    return step, shapes, man["extra"]


def _from_numpy(arr: np.ndarray, leaf, device=None):
    """A stored array in the template leaf's type, dtype and device."""
    if isinstance(leaf, torch.Tensor):
        if arr.dtype.kind == "V":                  # bf16 words
            t = torch.from_numpy(arr.view(np.int16)).view(torch.bfloat16)
        else:
            # ascontiguousarray makes a 0-d array 1-d: reshape it back
            t = torch.from_numpy(np.ascontiguousarray(arr).reshape(arr.shape))
        if tuple(t.shape) != tuple(leaf.shape):
            raise ValueError(f"stored shape {tuple(t.shape)} != template "
                             f"{tuple(leaf.shape)}")
        t = t.to(device=leaf.device if device is None else device,
                 dtype=leaf.dtype)
        if _is_placed(leaf):
            return place_like(t, leaf)
        return t
    if isinstance(leaf, (bool, np.bool_)):
        return bool(arr)
    if isinstance(leaf, (int, np.integer)):
        return int(arr)
    return np.asarray(arr, dtype=np.asarray(leaf).dtype)


def _rebuild(template, leaves):
    """``template``'s structure with its leaves taken in flatten order."""
    kids = _children(template)
    if kids is None:
        return next(leaves)
    if template is None:
        return None
    vals = [_rebuild(v, leaves) for _, v in kids]
    if isinstance(template, dict):
        by_key = dict(zip(sorted(template), vals))
        return {k: by_key[k] for k in template}
    if _is_namedtuple(template):
        return type(template)(*vals)
    return type(template)(vals)


def restore(base: str, template: Any, step: Optional[int] = None,
            device=None) -> Tuple[int, Any, Dict]:
    """Restore into the structure of ``template``: ``(step, tree, extra)``,
    every leaf in the template leaf's dtype and on its device (or on
    ``device`` when given: a template on the ``meta`` device then costs no
    memory); a ``DTensor`` leaf as this rank's block of the stored whole
    tensor, placed as the template leaf is."""
    step = _resolve(base, step)
    d = _step_dir(base, step)
    with open(os.path.join(d, "manifest.json")) as f:
        man = json.load(f)
    with np.load(os.path.join(d, "arrays.npz")) as z:
        leaves = [_from_numpy(z[key], leaf, device)
                  for key, leaf in _flatten(template)]
    return step, _rebuild(template, iter(leaves)), man["extra"]
