"""Launch of the hand-written CUDA compact weight update (``wu_outer.cu``
beside this file).

Replaces ``src/repro/kernels/wu_outer/kernel.py`` (``wu_outer_pallas``).
The design note (what bounds it, how a block owns its outputs) heads the
CUDA source. This module holds what surrounds the kernel and the CPU tests
can reach: the grid and shared-memory size (:func:`launch_config`),
argument checks, and the launch counter.
"""
from __future__ import annotations

import ctypes
import dataclasses
import functools
import os

import torch

SOURCE = os.path.join(os.path.dirname(os.path.abspath(__file__)), "wu_outer.cu")
ELEMS_PER_BLOCK = 512           # NT * R in wu_outer.cu
ROW_TARGET = 32                 # batch rows staged per chunk, at most
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
    """Grid and shared memory for one launch.

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


@functools.cache
def _lib():
    from .._build import load_library
    lib = load_library("wu_outer", SOURCE)
    lib.wu_outer_launch.restype = ctypes.c_int
    lib.wu_outer_launch.argtypes = (
        [ctypes.c_void_p] * 5 + [ctypes.c_int] * 11 + [ctypes.c_void_p])
    lib.wu_outer_elems_per_block.restype = ctypes.c_int
    if lib.wu_outer_elems_per_block() != ELEMS_PER_BLOCK:
        raise RuntimeError("wu_outer.cu elements per block disagree with kernel.py")
    return lib


def build() -> None:
    """Compile and load the kernel library now (otherwise: at first launch)."""
    _lib()


def wu_outer_cuda(pre: torch.Tensor, mod: torch.Tensor, idx: torch.Tensor,
                  scale: torch.Tensor, *, bk: int, bo: int) -> torch.Tensor:
    """``dw [J, T, bk, bo]`` on the card: ``pre [B, K]`` and ``mod [B, N]``
    f32 or bf16 of one dtype, ``idx [J, T]`` int32, ``scale`` a one-element
    tensor of ``pre``'s dtype, all contiguous CUDA tensors of one device.
    Raises on anything else."""
    if pre.dim() != 2 or mod.dim() != 2 or idx.dim() != 2:
        raise ValueError("wu_outer: need pre [B,K], mod [B,N], idx [J,T]")
    b, k = pre.shape
    j, t = idx.shape
    if mod.shape[0] != b or mod.shape[1] != j * bo or k % bk:
        raise ValueError(f"wu_outer: shapes pre{tuple(pre.shape)} "
                         f"mod{tuple(mod.shape)} idx{tuple(idx.shape)} "
                         f"bk={bk} bo={bo}")
    if pre.dtype not in _DTYPES or mod.dtype != pre.dtype \
            or scale.dtype != pre.dtype:
        raise TypeError(f"wu_outer: pre/mod/scale must share f32 or bf16, got "
                        f"{pre.dtype}/{mod.dtype}/{scale.dtype}")
    if idx.dtype != torch.int32:
        raise TypeError(f"wu_outer: idx must be int32, got {idx.dtype}")
    if scale.numel() != 1:
        raise ValueError(f"wu_outer: scale must hold one element, got "
                         f"{tuple(scale.shape)}")
    for name, a in (("pre", pre), ("mod", mod), ("idx", idx), ("scale", scale)):
        if not a.is_cuda or a.device != pre.device:
            raise ValueError(f"wu_outer: {name} is not on {pre.device}")
        if not a.is_contiguous():
            raise ValueError(f"wu_outer: {name} must be contiguous")
    dw = torch.empty((j, t, bk, bo), dtype=pre.dtype, device=pre.device)
    if dw.numel() == 0:
        return dw               # nothing to compute: no launch
    cfg = launch_config(b, k, j, t, bk, bo, pre.element_size())
    with torch.cuda.device(pre.device):
        stream = torch.cuda.current_stream(pre.device).cuda_stream
        err = _lib().wu_outer_launch(
            pre.data_ptr(), mod.data_ptr(), idx.data_ptr(), scale.data_ptr(),
            dw.data_ptr(), b, k, j, t, bk, bo, cfg.bc, cfg.mw, cfg.nblocks,
            cfg.smem_bytes, _DTYPES[pre.dtype], stream)
    if err != 0:
        raise RuntimeError(f"wu_outer kernel launch failed: cudaError {err}")
    wu_outer_cuda.launches += 1
    return dw


wu_outer_cuda.launches = 0
