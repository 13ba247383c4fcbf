"""Launch of the fused AdamW (``adamw.cu`` beside this file): the launch
plan, argument checks and the launch counters.

Replaces no TPU kernel (the JAX package's ``adamw_update`` is jnp that XLA
fuses); the design note (what bounds it, how it stays bit for bit the
plain update) heads the CUDA source. This module holds what the CPU tests
can reach: how a view is described (:func:`runs`, :func:`scale_terms`),
the table of leaves the two kernels walk (:func:`update_entry`,
:func:`norm_entry`, :func:`table`) and the f32 scalars (:func:`scalars`).

A table row is ``FIELDS`` int64: pointers, the view's elements and
contiguous run, each tensor's row stride, flags, the leaf's first chunk
(a block takes ``CHUNK`` elements of one leaf) and up to ``MAX_TERMS``
terms ``(div, size, stride)`` of the gate scale: element ``e`` reads the
scale at ``Σ (e // div % size) · stride``. The table ends in one int64
more, the norm's ticket (0).

Each launcher counts its ``launches`` (``kernels.launch_counters()``,
as ``adamw_norm`` and ``adamw_update``); the update's also counts the
``elems`` it updated. The LM step reads both into its ``train.adamw``
span.
"""
from __future__ import annotations

import ctypes
import dataclasses
import functools
import os
from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch

SOURCE = os.path.join(os.path.dirname(os.path.abspath(__file__)), "adamw.cu")
THREADS = 256            # threads a block
VEC = 8                  # elements a thread moves a turn on the vector path
CHUNK = 1 << 16          # elements of one leaf a block takes
FIELDS = 24              # int64 a table row
MAX_TERMS = 3            # (div, size, stride) terms of a scale
(F_P, F_G, F_M, F_V, F_S, F_N, F_RUN, F_RS_P, F_RS_G, F_RS_M, F_RS_V,
 F_FLAGS, F_FIRST, F_NTERMS, F_TERMS) = range(15)
P_BF16, G_BF16, S_BF16, HAS_SCALE, VECTOR, SPLIT = 1, 2, 4, 8, 16, 32
_BF16 = {torch.float32: 0, torch.bfloat16: 1}


def runs(t: torch.Tensor) -> Optional[Tuple[int, int, int]]:
    """``(rows, run, row_stride)`` where ``t``'s elements, in order, lie in
    ``rows`` contiguous runs of ``run`` elements, ``row_stride`` apart (a
    contiguous tensor: one row); None for any other layout. A narrow of a
    contiguous tensor along any dim is such a view."""
    dims = [(n, s) for n, s in zip(t.shape, t.stride()) if n != 1]
    run, i = 1, len(dims)
    while i and dims[i - 1][1] == run:
        run *= dims[i - 1][0]
        i -= 1
    if i == 0:
        return 1, run, run
    if i == len(dims):
        return None                     # the last dim is not unit-stride
    rows, stride = dims[i - 1]
    for n, s in reversed(dims[:i - 1]):
        if s != stride * rows:
            return None
        rows *= n
    return rows, run, stride


def scale_terms(s: torch.Tensor, shape) -> List[Tuple[int, int, int]]:
    """The ``(div, size, stride)`` terms that find the scale of element
    ``e`` of a view of ``shape``: ``Σ (e // div % size) · stride`` elements
    from ``s.data_ptr()`` (``s`` as broadcast to ``shape``). Dims along
    which the scale is broadcast take no term; adjacent dims the scale
    holds contiguously merge. Raises where the scale varies along the last
    axis or needs more than ``MAX_TERMS`` terms."""
    sb = torch.broadcast_to(s, shape)
    dims = list(zip(sb.shape, sb.stride()))
    if not dims:
        return []
    if dims[-1][0] > 1 and dims[-1][1] != 0:
        raise ValueError(f"adamw: scale {tuple(s.shape)} varies along the "
                         f"last axis of {tuple(shape)}")
    terms, div = [], dims[-1][0]
    for n, st in reversed(dims[:-1]):
        if n > 1 and st != 0:
            if terms and terms[-1][0] * terms[-1][1] == div \
                    and st == terms[-1][2] * terms[-1][1]:
                d0, n0, s0 = terms[-1]
                terms[-1] = (d0, n0 * n, s0)
            else:
                terms.append((div, n, st))
        div *= n
    if len(terms) > MAX_TERMS:
        raise ValueError(f"adamw: scale {tuple(s.shape)} over {tuple(shape)} "
                         f"needs {len(terms)} terms, the kernel reads "
                         f"{MAX_TERMS}")
    return terms


def _check_float(name: str, t: torch.Tensor) -> None:
    if t.dtype not in _BF16:
        raise TypeError(f"adamw: {name} must be float32 or bfloat16, got "
                        f"{t.dtype}")


def _aligned(t: torch.Tensor) -> bool:
    return t.data_ptr() % 16 == 0


def update_entry(g: torch.Tensor, p: torch.Tensor, m: torch.Tensor,
                 v: torch.Tensor, s: Optional[torch.Tensor]
                 ) -> Tuple[np.ndarray, List[torch.Tensor]]:
    """One leaf's table row for the update (``first`` chunk left 0), and
    the tensors it points into that the caller must keep alive (a copy of
    ``g`` where its layout is not ``p``'s). ``p`` and ``g`` f32 or bf16,
    ``m`` and ``v`` f32, all of one shape; ``p``, ``m``, ``v`` rows of
    runs, not overlapping (written in place); ``s`` None or a f32 / bf16
    scale broadcastable to the shape, constant along its last axis."""
    _check_float("p", p)
    _check_float("g", g)
    if m.dtype != torch.float32 or v.dtype != torch.float32:
        raise TypeError(f"adamw: m and v must be float32, got {m.dtype} / "
                        f"{v.dtype}")
    if s is not None:
        _check_float("scale", s)
    shape = tuple(p.shape)
    if not tuple(g.shape) == tuple(m.shape) == tuple(v.shape) == shape:
        raise ValueError(f"adamw: shapes g{tuple(g.shape)} p{shape} "
                         f"m{tuple(m.shape)} v{tuple(v.shape)} differ")
    keep = [g, p, m, v]
    descs = [runs(t) for t in keep]
    for name, t, d in zip("pmv", keep[1:], descs[1:]):
        if d is None or (d[0] > 1 and d[2] < d[1]):
            raise ValueError(f"adamw: {name} must be rows of contiguous runs, "
                             f"not overlapping (a narrow of a contiguous "
                             f"tensor), got strides {t.stride()}")
    run = None if descs[0] is None else _common_run(p.numel(), descs)
    if run is None:                     # g laid out otherwise: copy it once
        keep[0] = g = g.contiguous()
        descs[0] = runs(g)
        run = _common_run(p.numel(), descs)
        if run is None:
            raise ValueError(f"adamw: p, m and v runs differ: {descs[1:]}")
    row = np.zeros(FIELDS, np.int64)
    row[[F_G, F_P, F_M, F_V]] = [t.data_ptr() for t in keep]
    row[F_N], row[F_RUN] = p.numel(), run
    row[[F_RS_G, F_RS_P, F_RS_M, F_RS_V]] = [
        d[2] if d[0] > 1 else run for d in descs]
    flags = P_BF16 * _BF16[p.dtype] + G_BF16 * _BF16[g.dtype]
    vector = run % VEC == 0 and all(
        x % VEC == 0 for x in row[[F_RS_G, F_RS_P, F_RS_M, F_RS_V]]) \
        and all(_aligned(t) for t in keep)
    if s is not None:
        terms = scale_terms(s, shape)
        keep.append(s)
        row[F_S] = s.data_ptr()
        row[F_NTERMS] = len(terms)
        for k, term in enumerate(terms):
            row[F_TERMS + 3 * k:F_TERMS + 3 * k + 3] = term
        vector = vector and all(d % VEC == 0 for d, _, _ in terms)
        flags |= HAS_SCALE | S_BF16 * _BF16[s.dtype]
    row[F_FLAGS] = flags | (VECTOR if vector else 0)
    return row, keep


def _common_run(n: int, descs) -> Optional[int]:
    """The run all the descriptors share: a one-row (contiguous) tensor
    takes any run, with its row stride equal to it."""
    multi = {d[1] for d in descs if d[0] > 1}
    if len(multi) > 1:
        return None
    return multi.pop() if multi else n


def norm_entry(g: torch.Tensor, split: bool
               ) -> Tuple[np.ndarray, List[torch.Tensor]]:
    """One gradient block's table row for the norm (``split``: the block of
    a model-split leaf, summed apart), and the tensors to keep alive."""
    _check_float("g", g)
    d = runs(g)
    if d is None:
        g = g.contiguous()
        d = runs(g)
    row = np.zeros(FIELDS, np.int64)
    row[F_G], row[F_N], row[F_RUN] = g.data_ptr(), g.numel(), d[1]
    row[F_RS_G] = d[2] if d[0] > 1 else d[1]
    vector = d[1] % VEC == 0 and row[F_RS_G] % VEC == 0 and _aligned(g)
    row[F_FLAGS] = (G_BF16 * _BF16[g.dtype] | (VECTOR if vector else 0)
                    | (SPLIT if split else 0))
    return row, [g]


@dataclasses.dataclass
class Plan:
    table: np.ndarray        # [leaves · FIELDS + 1] int64: rows, the ticket
    leaves: int
    chunks: int              # blocks of the launch
    elems: int               # elements the rows cover
    keep: list               # tensors the table points into


def table(entries: Sequence[Tuple[np.ndarray, list]]) -> Plan:
    """The launch's table: the rows of the non-empty leaves in order, each
    with its first chunk, and the ticket."""
    rows, keep, chunks, elems = [], [], 0, 0
    for row, tensors in entries:
        n = int(row[F_N])
        if n == 0:
            continue
        row = row.copy()
        row[F_FIRST] = chunks
        chunks += -(-n // CHUNK)
        elems += n
        rows.append(row)
        keep += tensors
    flat = np.zeros(len(rows) * FIELDS + 1, np.int64)
    if rows:
        flat[:-1] = np.concatenate(rows)
    if chunks >= 2 ** 31:
        raise ValueError(f"adamw: {chunks} chunks exceed one launch's grid")
    return Plan(flat, len(rows), chunks, elems, keep)


def scalars(cfg, lr: float, bc1: float, bc2: float) -> Tuple[float, ...]:
    """The update's f32 scalars as PyTorch casts the plain update's Python
    scalars: ``b1``, ``1 - b1``, ``b2``, ``1 - b2``, ``lr``, ``1 / bc1``,
    ``1 / bc2`` (a CUDA tensor divided by a Python scalar is multiplied by
    its f32 reciprocal), ``eps``, ``lr · weight_decay`` (a Python product
    first)."""
    f = np.float32
    return tuple(float(x) for x in (
        f(cfg.b1), f(1 - cfg.b1), f(cfg.b2), f(1 - cfg.b2), f(lr),
        f(1) / f(bc1), f(1) / f(bc2), f(cfg.eps), f(lr * cfg.weight_decay)))


@functools.cache
def _lib():
    from .._build import load_library
    lib = load_library("adamw", SOURCE)
    lib.adamw_norm_launch.restype = ctypes.c_int
    lib.adamw_norm_launch.argtypes = (
        [ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong]
        + [ctypes.c_void_p] * 4)
    lib.adamw_update_launch.restype = ctypes.c_int
    lib.adamw_update_launch.argtypes = (
        [ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong, ctypes.c_void_p]
        + [ctypes.c_float] * 9 + [ctypes.c_void_p])
    lib.adamw_geometry.restype = None
    lib.adamw_geometry.argtypes = [ctypes.POINTER(ctypes.c_int)]
    geo = (ctypes.c_int * 5)()
    lib.adamw_geometry(geo)
    if tuple(geo) != (THREADS, VEC, CHUNK, FIELDS, MAX_TERMS):
        raise RuntimeError("adamw.cu geometry disagrees with kernel.py")
    return lib


def build() -> None:
    """Compile and load the kernel library now (otherwise: at first launch)."""
    _lib()


def _device_of(tensors) -> torch.device:
    dev = tensors[0].device
    for t in tensors:
        if not t.is_cuda or t.device != dev:
            raise ValueError(f"adamw: every tensor must be on {dev}, got "
                             f"{t.device}")
    return dev


def _upload(plan: Plan, dev: torch.device) -> torch.Tensor:
    """The table on the card: one copy from pinned memory, no sync."""
    return torch.from_numpy(plan.table).pin_memory().to(dev, non_blocking=True)


def _raise_on(err: int, what: str) -> None:
    if err != 0:
        raise RuntimeError(f"{what} kernel launch failed: cudaError {err}")


def adamw_norm_cuda(blocks: Sequence[torch.Tensor],
                    split: Sequence[bool]) -> torch.Tensor:
    """``[2]`` f32 on the card: the sum of squares of the ``blocks`` not
    ``split`` and of those ``split``, each block f32 or bf16, in one
    launch; the same bits on every run."""
    entries = [norm_entry(g, sp) for g, sp in zip(blocks, split)]
    dev = _device_of([t for _, keep in entries for t in keep])
    plan = table(entries)
    out = torch.empty(2, dtype=torch.float32, device=dev)
    if plan.chunks == 0:
        return out.zero_()
    part = torch.empty(2 * plan.chunks, dtype=torch.float32, device=dev)
    tab = _upload(plan, dev)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = _lib().adamw_norm_launch(
            tab.data_ptr(), plan.leaves, plan.chunks, part.data_ptr(),
            out.data_ptr(), tab.data_ptr() + 8 * plan.leaves * FIELDS, stream)
    _raise_on(err, "adamw_norm")
    adamw_norm_cuda.launches += 1
    return out


def adamw_update_cuda(leaves: Sequence[tuple], clip: torch.Tensor, cfg,
                      lr: float, bc1: float, bc2: float) -> None:
    """The AdamW update of every ``(g, p, m, v, scale)`` of ``leaves`` in
    place, in one launch (:func:`update_entry` says what each takes);
    ``clip`` a one-element f32 tensor on the card."""
    entries = [update_entry(*leaf) for leaf in leaves]
    if clip.dtype != torch.float32 or clip.numel() != 1:
        raise TypeError(f"adamw: clip must be one float32, got {clip.dtype} "
                        f"{tuple(clip.shape)}")
    dev = _device_of([clip] + [t for _, keep in entries for t in keep])
    plan = table(entries)
    if plan.chunks == 0:
        return
    tab = _upload(plan, dev)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = _lib().adamw_update_launch(
            tab.data_ptr(), plan.leaves, plan.chunks, clip.data_ptr(),
            *scalars(cfg, lr, bc1, bc2), stream)
    _raise_on(err, "adamw_update")
    adamw_update_cuda.launches += 1
    adamw_update_cuda.elems += plan.elems


adamw_norm_cuda.launches = 0
adamw_update_cuda.launches = 0
adamw_update_cuda.elems = 0
