"""Launch of the hand-written CUDA compact weight updates (``wu_outer.cu``
beside this file).

Replaces ``src/repro/kernels/wu_outer/kernel.py`` (``wu_outer_pallas``)
and, in place, the serving path's per-slot update (``wu_outer_slots``, jnp
in the reference). The design note (what bounds each kernel, how a block
owns its outputs) heads the CUDA source. This module holds what surrounds
the kernels and the CPU tests can reach: which kernel a shape takes and its
grid and shared memory (:func:`launch_config`, :func:`gather_launch_config`,
:func:`slots_launch_config`), argument checks, and the launch counters.
"""
from __future__ import annotations

import ctypes
import dataclasses
import functools
import os
from typing import Optional

import torch

SOURCE = os.path.join(os.path.dirname(os.path.abspath(__file__)), "wu_outer.cu")
ELEMS_PER_BLOCK = 512           # tiled kernel: NT * R in wu_outer.cu
ROW_TARGET = 32                 # batch rows staged per chunk, at most
GATHER_WARPS = 4                # gather kernel: output neurons (one warp each) a block
GATHER_T_PER_LANE = 4           # gather kernel: t positions a lane takes per pass
SLOT_THREADS = 256              # per-slot kernel: threads per block
SLOT_VECTORS = 2                # per-slot kernel: vectors a thread
MAX_GRID_Y = 65535              # CUDA's limit; the per-slot kernel loops over more slots
SMEM_LIMIT = 232448             # opt-in shared memory per block on sm_90
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}


def _align16(n: int) -> int:
    return (n + 15) & ~15


@dataclasses.dataclass(frozen=True)
class LaunchConfig:
    nblocks: int     # grid: ceil(J*T*bk*bo / ELEMS_PER_BLOCK)
    bc: int          # batch rows staged per chunk
    mw: int          # mod columns staged per block (whole out tiles)
    smem_bytes: int


def launch_config(b: int, k: int, j: int, t: int, bk: int, bo: int,
                  esize: int) -> LaunchConfig:
    """Grid and shared memory of the tiled kernel (any bk, bo).

    A block owns ``ELEMS_PER_BLOCK`` consecutive output elements, which
    span at most ``(E - 1) // (T·bk·bo) + 2`` out tiles: their mod columns
    (``mw``) are staged beside full rows of pre. The chunk of batch rows
    shrinks from ``ROW_TARGET`` until both fit one block's shared memory.
    """
    per_tile = t * bk * bo
    mw = min(j, (ELEMS_PER_BLOCK - 1) // max(1, per_tile) + 2) * bo

    def smem(bc):
        return _align16(esize * bc * k) + esize * bc * mw

    bc = max(1, min(ROW_TARGET, b))
    while smem(bc) > SMEM_LIMIT:
        if bc == 1:
            raise ValueError(
                f"wu_outer: K={k} with bo={bo} does not fit one block's shared "
                f"memory ({smem(1)} > {SMEM_LIMIT} bytes)")
        bc //= 2
    return LaunchConfig(nblocks=-(-j * per_tile // ELEMS_PER_BLOCK), bc=bc,
                        mw=mw, smem_bytes=smem(bc))


def takes_gather_kernel(bk: int, bo: int) -> bool:
    """Whether a batch-summed update goes to the gather kernel: the
    element-granular layout, as every SNN spec has."""
    return bk == bo == 1


@dataclasses.dataclass(frozen=True)
class GatherConfig:
    nblocks: int     # ceil(J / GATHER_WARPS): a warp per output neuron
    threads: int     # 32 * GATHER_WARPS
    passes: int      # ceil(T / (32 * GATHER_T_PER_LANE)) passes over t a warp
    bc: int          # batch rows of pre staged per chunk (f32)
    smem_bytes: int


def gather_launch_config(b: int, k: int, j: int, t: int) -> GatherConfig:
    """Grid and shared memory of the gather kernel (bk = bo = 1): one warp
    per output neuron, its lanes on t, ``GATHER_T_PER_LANE`` positions a
    lane per pass. A block stages chunks of ``bc`` batch rows of pre (f32,
    whatever the dtype) and its warps' mod columns; ``bc`` shrinks from
    ``ROW_TARGET`` until they fit one block's shared memory."""
    def smem(bc):
        return _align16(4 * bc * k) + 4 * bc * GATHER_WARPS

    bc = max(1, min(ROW_TARGET, b))
    while smem(bc) > SMEM_LIMIT:
        if bc == 1:
            raise ValueError(
                f"wu_outer: K={k} does not fit one block's shared memory "
                f"({smem(1)} > {SMEM_LIMIT} bytes)")
        bc //= 2
    return GatherConfig(nblocks=-(-j // GATHER_WARPS),
                        threads=32 * GATHER_WARPS,
                        passes=-(-t // (32 * GATHER_T_PER_LANE)),
                        bc=bc, smem_bytes=smem(bc))


@dataclasses.dataclass(frozen=True)
class SlotsConfig:
    vec: int         # delta elements a vector: 4 (16-byte loads and stores) or 1
    grid: tuple      # (chunks of a slot, slots a column of blocks walks)


def slots_launch_config(s: int, j: int, t: int, bk: int, bo: int,
                        aligned: bool) -> SlotsConfig:
    """Vector width and grid of the per-slot kernel. Vectors of 4 where a
    row of ``T·bk·bo`` elements is a multiple of 4 and the operands are
    16-byte aligned (``aligned``), else of 1; each block takes
    ``SLOT_THREADS · SLOT_VECTORS`` vectors of one slot. Past CUDA's grid
    limit a column of blocks walks several slots."""
    row = t * bk * bo
    vec = 4 if row % 4 == 0 and aligned else 1
    per_block = SLOT_THREADS * SLOT_VECTORS
    return SlotsConfig(vec=vec, grid=(-(-j * (row // vec) // per_block),
                                      min(s, MAX_GRID_Y)))


@functools.cache
def _lib():
    from .._build import load_library
    lib = load_library("wu_outer", SOURCE)
    lib.wu_outer_launch.restype = ctypes.c_int
    lib.wu_outer_launch.argtypes = (
        [ctypes.c_void_p] * 6 + [ctypes.c_int] * 11 + [ctypes.c_void_p])
    lib.wu_outer_gather_launch.restype = ctypes.c_int
    lib.wu_outer_gather_launch.argtypes = (
        [ctypes.c_void_p] * 6 + [ctypes.c_int] * 8 + [ctypes.c_void_p])
    lib.wu_outer_slots_launch.restype = ctypes.c_int
    lib.wu_outer_slots_launch.argtypes = (
        [ctypes.c_void_p, ctypes.c_longlong] + [ctypes.c_void_p] * 4
        + [ctypes.c_int] * 9 + [ctypes.c_void_p])
    lib.wu_outer_geometry.restype = None
    lib.wu_outer_geometry.argtypes = [ctypes.POINTER(ctypes.c_int)]
    geo = (ctypes.c_int * 5)()
    lib.wu_outer_geometry(geo)
    if tuple(geo) != (ELEMS_PER_BLOCK, GATHER_WARPS, GATHER_T_PER_LANE,
                      SLOT_THREADS, SLOT_VECTORS):
        raise RuntimeError("wu_outer.cu block geometry disagrees with kernel.py")
    return lib


def build() -> None:
    """Compile and load the kernel library now (otherwise: at first launch)."""
    _lib()


def _check_devices(what: str, tensors: dict, device) -> None:
    for name, a in tensors.items():
        if not a.is_cuda or a.device != device:
            raise ValueError(f"{what}: {name} is not on {device}")


def _raise_on(err: int, what: str) -> None:
    if err != 0:
        raise RuntimeError(f"{what} kernel launch failed: cudaError {err}")


def wu_outer_cuda(pre: torch.Tensor, mod: torch.Tensor, idx: torch.Tensor,
                  scale: torch.Tensor, *, bk: int, bo: int,
                  wc: Optional[torch.Tensor] = None) -> torch.Tensor:
    """``dw [J, T, bk, bo]`` on the card, or with ``wc`` (``[J, T, bk, bo]``
    of pre's dtype) ``wc + dw`` in a fresh tensor, in the same launch:
    ``pre [B, K]`` and ``mod [B, N]`` f32 or bf16 of one dtype, ``idx [J,
    T]`` int32, ``scale`` a one-element tensor of ``pre``'s dtype, all
    contiguous CUDA tensors of one device. ``bk = bo = 1`` takes the gather
    kernel, anything else the tiled one. Raises on anything else."""
    if pre.dim() != 2 or mod.dim() != 2 or idx.dim() != 2:
        raise ValueError("wu_outer: need pre [B,K], mod [B,N], idx [J,T]")
    b, k = pre.shape
    j, t = idx.shape
    if mod.shape[0] != b or mod.shape[1] != j * bo or k % bk or (
            wc is not None and tuple(wc.shape) != (j, t, bk, bo)):
        raise ValueError(f"wu_outer: shapes pre{tuple(pre.shape)} "
                         f"mod{tuple(mod.shape)} idx{tuple(idx.shape)} "
                         + ("" if wc is None else f"wc{tuple(wc.shape)} ")
                         + f"bk={bk} bo={bo}")
    if pre.dtype not in _DTYPES or mod.dtype != pre.dtype \
            or scale.dtype != pre.dtype or (wc is not None
                                            and wc.dtype != pre.dtype):
        raise TypeError(f"wu_outer: pre/mod/scale/wc must share f32 or bf16, "
                        f"got {pre.dtype}/{mod.dtype}/{scale.dtype}"
                        + ("" if wc is None else f"/{wc.dtype}"))
    if idx.dtype != torch.int32:
        raise TypeError(f"wu_outer: idx must be int32, got {idx.dtype}")
    if scale.numel() != 1:
        raise ValueError(f"wu_outer: scale must hold one element, got "
                         f"{tuple(scale.shape)}")
    tensors = {"pre": pre, "mod": mod, "idx": idx, "scale": scale}
    if wc is not None:
        tensors["wc"] = wc
    _check_devices("wu_outer", tensors, pre.device)
    for name, a in tensors.items():
        if not a.is_contiguous():
            raise ValueError(f"wu_outer: {name} must be contiguous")
    out = torch.empty((j, t, bk, bo), dtype=pre.dtype, device=pre.device)
    if out.numel() == 0:
        return out              # nothing to compute: no launch
    args = (pre.data_ptr(), mod.data_ptr(), idx.data_ptr(), scale.data_ptr(),
            None if wc is None else wc.data_ptr(), out.data_ptr())
    with torch.cuda.device(pre.device):
        stream = torch.cuda.current_stream(pre.device).cuda_stream
        if takes_gather_kernel(bk, bo):
            cfg = gather_launch_config(b, k, j, t)
            err = _lib().wu_outer_gather_launch(
                *args, b, k, j, t, cfg.bc, cfg.nblocks, cfg.smem_bytes,
                _DTYPES[pre.dtype], stream)
        else:
            cfg = launch_config(b, k, j, t, bk, bo, pre.element_size())
            err = _lib().wu_outer_launch(
                *args, b, k, j, t, bk, bo, cfg.bc, cfg.mw, cfg.nblocks,
                cfg.smem_bytes, _DTYPES[pre.dtype], stream)
    _raise_on(err, "wu_outer")
    wu_outer_cuda.launches += 1
    return out


def wu_outer_slots_cuda(delta: torch.Tensor, pre: torch.Tensor,
                        mod: torch.Tensor, idx: torch.Tensor,
                        scale: torch.Tensor, *, bk: int, bo: int) -> torch.Tensor:
    """In place on the card: ``delta[s] += (scale[s] · gather(pre[s])) ·
    mod[s]`` at the kept blocks, slot by slot; returns ``delta``.

    ``delta [S, J, T, bk, bo]`` f32 with each slot's block contiguous and
    the slots ``delta.stride(0)`` elements apart, not overlapping (one layer
    of the engine's slot-leading deltas); ``pre [S, K]``, ``mod [S, J·bo]``
    and ``scale [S]`` f32, ``idx [J, T]`` int32, contiguous, all on one
    device. A slot whose scale is 0 is neither read nor written. Raises on
    anything else."""
    if delta.dim() != 5 or pre.dim() != 2 or mod.dim() != 2 or idx.dim() != 2:
        raise ValueError("wu_outer_slots: need delta [S,J,T,bk,bo], pre [S,K], "
                         "mod [S,N], idx [J,T]")
    s, k = pre.shape
    j, t = idx.shape
    if tuple(delta.shape) != (s, j, t, bk, bo) or tuple(mod.shape) != (s, j * bo) \
            or tuple(scale.shape) != (s,) or k % bk:
        raise ValueError(f"wu_outer_slots: shapes delta{tuple(delta.shape)} "
                         f"pre{tuple(pre.shape)} mod{tuple(mod.shape)} "
                         f"idx{tuple(idx.shape)} scale{tuple(scale.shape)} "
                         f"bk={bk} bo={bo}")
    if any(a.dtype != torch.float32 for a in (delta, pre, mod, scale)):
        raise TypeError(f"wu_outer_slots: delta/pre/mod/scale must be f32, got "
                        f"{delta.dtype}/{pre.dtype}/{mod.dtype}/{scale.dtype}")
    if idx.dtype != torch.int32:
        raise TypeError(f"wu_outer_slots: idx must be int32, got {idx.dtype}")
    tensors = {"delta": delta, "pre": pre, "mod": mod, "idx": idx,
               "scale": scale}
    _check_devices("wu_outer_slots", tensors, delta.device)
    for name, a in tensors.items():
        if name != "delta" and not a.is_contiguous():
            raise ValueError(f"wu_outer_slots: {name} must be contiguous")
    per_slot = j * t * bk * bo
    if not (delta[:1].is_contiguous()
            and (s <= 1 or delta.stride(0) >= per_slot)):
        raise ValueError("wu_outer_slots: delta needs each slot's [J,T,bk,bo] "
                         "contiguous and the slots apart, not overlapping")
    if per_slot >= 2 ** 31:
        raise ValueError(f"wu_outer_slots: {per_slot} elements a slot exceed "
                         f"the kernel's 32-bit offsets")
    if delta.numel() == 0:
        return delta            # nothing to compute: no launch
    aligned = (delta.data_ptr() % 16 == 0 and delta.stride(0) % 4 == 0
               and idx.data_ptr() % 16 == 0)
    cfg = slots_launch_config(s, j, t, bk, bo, aligned)
    with torch.cuda.device(delta.device):
        stream = torch.cuda.current_stream(delta.device).cuda_stream
        err = _lib().wu_outer_slots_launch(
            delta.data_ptr(), delta.stride(0), pre.data_ptr(), mod.data_ptr(),
            idx.data_ptr(), scale.data_ptr(), s, k, j, t, bk, bo, cfg.vec,
            *cfg.grid, stream)
    _raise_on(err, "wu_outer_slots")
    wu_outer_slots_cuda.launches += 1
    return delta


wu_outer_cuda.launches = 0
wu_outer_slots_cuda.launches = 0
