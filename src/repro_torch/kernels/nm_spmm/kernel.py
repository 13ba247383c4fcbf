"""Launch of the hand-written CUDA block-N:M SpMM (``nm_spmm.cu`` beside this file).

Replaces ``src/repro/kernels/nm_spmm/kernel.py`` (``nm_spmm_pallas``). The
design note (what bounds it, how the block tiles the work) heads the CUDA
source. This module holds what surrounds the kernel and the CPU tests can
reach: the choice of column group and the shared-memory size
(:func:`launch_config`), argument checks, and the launch counter.
"""
from __future__ import annotations

import ctypes
import dataclasses
import functools
import os

import torch

SOURCE = os.path.join(os.path.dirname(os.path.abspath(__file__)), "nm_spmm.cu")
BLOCK_ROWS = 16                 # ROWS * RY in nm_spmm.cu
COLUMN_TARGET = 64              # output columns (threads along x) per block
SMEM_LIMIT = 232448             # opt-in shared memory per block on sm_90
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}


def _align16(n: int) -> int:
    return (n + 15) & ~15


@dataclasses.dataclass(frozen=True)
class LaunchConfig:
    bn: int          # output columns per block (threads along x)
    jg: int          # whole out tiles per block (1 when a block slices a tile)
    bnc: int         # columns taken from each tile
    ngroups: int     # column groups (grid x)
    smem_bytes: int


def launch_config(k: int, j: int, t: int, bk: int, bo: int,
                  esize: int) -> LaunchConfig:
    """Column grouping and shared memory for one launch.

    Blocks take ``COLUMN_TARGET`` columns where they can: whole tiles when
    ``bo`` is at most that (``jg`` tiles of ``bo``), else a slice of one tile
    whose width divides ``bo``. Groups shrink until the staged x rows,
    weight slice and index slice fit one block's shared memory.
    """
    if bo <= COLUMN_TARGET:
        jg, bnc = max(1, min(j, COLUMN_TARGET // bo)), bo
    else:
        jg = 1
        bnc = max(d for d in range(1, COLUMN_TARGET + 1) if bo % d == 0)

    def smem(jg_, bnc_):
        return (_align16(esize * BLOCK_ROWS * k)
                + _align16(esize * t * bk * jg_ * bnc_) + 4 * t * jg_)

    while smem(jg, bnc) > SMEM_LIMIT:
        if jg > 1:
            jg //= 2
        elif bnc > 1:
            bnc = max(d for d in range(1, bnc) if bo % d == 0)
        else:
            raise ValueError(
                f"nm_spmm: K={k} with T={t}, bk={bk} does not fit one block's "
                f"shared memory ({smem(1, 1)} > {SMEM_LIMIT} bytes)")
    ngroups = -(-j // jg) * (bo // bnc)
    return LaunchConfig(bn=jg * bnc, jg=jg, bnc=bnc, ngroups=ngroups,
                        smem_bytes=smem(jg, bnc))


@functools.cache
def _lib():
    from .._build import load_library
    lib = load_library("nm_spmm", SOURCE)
    lib.nm_spmm_launch.restype = ctypes.c_int
    lib.nm_spmm_launch.argtypes = (
        [ctypes.c_void_p] * 4 + [ctypes.c_int] * 12 + [ctypes.c_void_p])
    lib.nm_spmm_block_rows.restype = ctypes.c_int
    if lib.nm_spmm_block_rows() != BLOCK_ROWS:
        raise RuntimeError("nm_spmm.cu block rows disagree with kernel.py")
    return lib


def build() -> None:
    """Compile and load the kernel library now (otherwise: at first launch)."""
    _lib()


def nm_spmm_cuda(x: torch.Tensor, w_compact: torch.Tensor,
                 idx: torch.Tensor) -> torch.Tensor:
    """``y [B, J*bo]`` on the card; ``x [B, K]`` and ``w_compact
    [J, T, bk, bo]`` f32 or bf16 of one dtype, ``idx [J, T]`` int32, all
    contiguous CUDA tensors of one device. Raises on anything else."""
    if x.dim() != 2 or w_compact.dim() != 4 or idx.dim() != 2:
        raise ValueError("nm_spmm: need x [B,K], w_compact [J,T,bk,bo], idx [J,T]")
    b, k = x.shape
    j, t, bk, bo = w_compact.shape
    if tuple(idx.shape) != (j, t) or k % bk:
        raise ValueError(f"nm_spmm: shapes x{tuple(x.shape)} "
                         f"wc{tuple(w_compact.shape)} idx{tuple(idx.shape)}")
    if x.dtype not in _DTYPES or w_compact.dtype != x.dtype:
        raise TypeError(f"nm_spmm: x/w_compact must share f32 or bf16, got "
                        f"{x.dtype}/{w_compact.dtype}")
    if idx.dtype != torch.int32:
        raise TypeError(f"nm_spmm: idx must be int32, got {idx.dtype}")
    for name, a in (("x", x), ("w_compact", w_compact), ("idx", idx)):
        if not a.is_cuda or a.device != x.device:
            raise ValueError(f"nm_spmm: {name} is not on {x.device}")
        if not a.is_contiguous():
            raise ValueError(f"nm_spmm: {name} must be contiguous")
    y = torch.empty((b, j * bo), dtype=x.dtype, device=x.device)
    if b == 0 or j == 0:
        return y                # nothing to compute: no launch
    cfg = launch_config(k, j, t, bk, bo, x.element_size())
    # the runtime launches (and sets the shared-memory attribute) on the
    # current device, so make it the tensors' device
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        err = _lib().nm_spmm_launch(
            x.data_ptr(), w_compact.data_ptr(), idx.data_ptr(), y.data_ptr(),
            b, k, j, t, bk, bo, cfg.bn, cfg.jg, cfg.bnc, cfg.ngroups,
            cfg.smem_bytes, _DTYPES[x.dtype], stream)
    if err != 0:
        raise RuntimeError(f"nm_spmm kernel launch failed: cudaError {err}")
    nm_spmm_cuda.launches += 1
    return y


nm_spmm_cuda.launches = 0
