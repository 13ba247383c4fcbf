"""Launch of the hand-written CUDA block-N:M SpMM (``nm_spmm.cu`` beside this file).

Replaces ``src/repro/kernels/nm_spmm/kernel.py`` (``nm_spmm_pallas``) and,
fused into the same launch, the per-row compact delta product of the
serving path (``nm_spmm_deltas``, jnp in the reference). The design note
(what bounds each kernel, how a block tiles the work) heads the CUDA source.
This module holds what surrounds the kernels and the CPU tests can reach:
which kernel a shape takes and its grid and shared memory
(:func:`launch_config`), argument checks, and the launch counter.
"""
from __future__ import annotations

import ctypes
import dataclasses
import functools
import os
from typing import Union

import torch

SOURCE = os.path.join(os.path.dirname(os.path.abspath(__file__)), "nm_spmm.cu")
BLOCK_ROWS = 16                 # tiled kernel: ROWS * RY in nm_spmm.cu
COLUMN_TARGET = 64              # tiled kernel: output columns (threads along x) per block
ELL_THREADS = (256, 1024)       # gather kernel (bk = bo = 1): narrow, wide blocks
ELL_WIDE_ROWS = 64              # gather kernel: the base product takes wide blocks above it
ELL_ROWS = 4                    # gather kernel: rows a lane computes
ELL_TS = 4                      # gather kernel: lanes sharing a column's t-chunks
ELL_MAX_PASSES = 16             # gather kernel: column passes a block may make
NUM_SMS = 132                   # H100 SXM
# the gather kernel's grid: at least a block on all but NUM_SMS % 128 SMs;
# halving its column groups again would stage x twice as often, which costs
# more on the card than the few idle SMs (nm_spmm.cu's design note)
ELL_MIN_BLOCKS = 128
SMEM_LIMIT = 232448             # opt-in shared memory per block on sm_90
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}


def _align16(n: int) -> int:
    return (n + 15) & ~15


@dataclasses.dataclass(frozen=True)
class TiledConfig:
    bn: int          # output columns per block (threads along x)
    jg: int          # whole out tiles per block (1 when a block slices a tile)
    bnc: int         # columns taken from each tile
    ngroups: int     # column groups (grid x)
    smem_bytes: int


def tiled_launch_config(k: int, j: int, t: int, bk: int, bo: int,
                        esize: int) -> TiledConfig:
    """Column grouping and shared memory of the tiled kernel (any bk, bo).

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
    return TiledConfig(bn=jg * bnc, jg=jg, bnc=bnc, ngroups=ngroups,
                        smem_bytes=smem(jg, bnc))


@dataclasses.dataclass(frozen=True)
class EllConfig:
    block_rows: int      # BM: rows a block stages and computes (4 to 32, a power of two)
    block_cols: int      # BN: output columns a block owns (a power of two)
    threads: int         # one of ELL_THREADS
    grid: tuple          # (column groups, row tiles)
    smem_bytes: int

    @property
    def lanes_per_col(self) -> int:
        """ELL_TS lanes for each ELL_ROWS rows."""
        return ELL_TS * self.block_rows // ELL_ROWS


def _pow2_at_least(n: int) -> int:
    return 1 << max(0, n - 1).bit_length()


def ell_launch_config(b: int, k: int, j: int, fused: bool = False) -> EllConfig:
    """Grid, threads and shared memory of the gather kernel (bk = bo = 1).

    Rows a block: the next power of two of ``b``, 4 to 32. Threads: 1024
    for the base product above ``ELL_WIDE_ROWS`` rows (one block an SM has to
    hide its load latency), else 256. Columns a block owns: the largest
    power of two, up to ``ELL_MAX_PASSES`` passes of its column groups, that
    still gives ``ELL_MIN_BLOCKS`` blocks (128 of the 132 SMs busy at B = 16
    as at B = 1024): each block stages its x rows once for all its columns.
    Rows shrink until x's staged rows (f32, K-major) and the output tile fit
    shared memory."""
    bm = min(32, max(ELL_ROWS, _pow2_at_least(b)))
    threads = ELL_THREADS[1] if b > ELL_WIDE_ROWS and not fused else ELL_THREADS[0]

    def smem(bm_, bn_):
        return 4 * (k * bm_ + bm_ * (bn_ + 1))
    while smem(bm, 1) > SMEM_LIMIT and bm > ELL_ROWS:
        bm //= 2
    if smem(bm, 1) > SMEM_LIMIT:
        raise ValueError(f"nm_spmm: K={k} does not fit one block's shared "
                         f"memory ({smem(bm, 1)} > {SMEM_LIMIT} bytes)")
    rows = -(-b // bm)
    groups = threads // (ELL_TS * bm // ELL_ROWS)
    bn = 1
    while (2 * bn <= ELL_MAX_PASSES * groups
           and rows * -(-j // (2 * bn)) >= ELL_MIN_BLOCKS
           and smem(bm, 2 * bn) <= SMEM_LIMIT):
        bn *= 2
    return EllConfig(block_rows=bm, block_cols=bn, threads=threads,
                     grid=(-(-j // bn), rows), smem_bytes=smem(bm, bn))


def takes_gather_kernel(k: int, bk: int, bo: int) -> bool:
    """Whether a shape goes to the gather kernel: the element-granular
    layout with K a multiple of 4 (its 4 x 4 staging), as every SNN spec
    has."""
    return bk == bo == 1 and k % 4 == 0


def launch_config(b: int, k: int, j: int, t: int, bk: int, bo: int,
                  esize: int, fused: bool = False) -> Union[EllConfig, TiledConfig]:
    """The kernel one launch takes and its geometry: the gather kernel
    (:func:`ell_launch_config`) where :func:`takes_gather_kernel`, else the
    tiled one (:func:`tiled_launch_config`)."""
    if takes_gather_kernel(k, bk, bo):
        return ell_launch_config(b, k, j, fused)
    return tiled_launch_config(k, j, t, bk, bo, esize)


@functools.cache
def _lib():
    from .._build import load_library
    lib = load_library("nm_spmm", SOURCE)
    lib.nm_spmm_launch.restype = ctypes.c_int
    lib.nm_spmm_launch.argtypes = (
        [ctypes.c_void_p] * 4 + [ctypes.c_int] * 12 + [ctypes.c_void_p])
    lib.nm_spmm_ell_launch.restype = ctypes.c_int
    lib.nm_spmm_ell_launch.argtypes = (
        [ctypes.c_void_p] * 4 + [ctypes.c_longlong, ctypes.c_void_p]
        + [ctypes.c_int] * 9 + [ctypes.c_void_p])
    lib.nm_spmm_block_rows.restype = ctypes.c_int
    lib.nm_spmm_ell_geometry.restype = None
    lib.nm_spmm_ell_geometry.argtypes = [ctypes.POINTER(ctypes.c_int)]
    ell = (ctypes.c_int * 4)()
    lib.nm_spmm_ell_geometry(ell)
    if lib.nm_spmm_block_rows() != BLOCK_ROWS \
            or tuple(ell) != (*ELL_THREADS, ELL_ROWS, ELL_TS):
        raise RuntimeError("nm_spmm.cu block geometry disagrees with kernel.py")
    return lib


def build() -> None:
    """Compile and load the kernel library now (otherwise: at first launch)."""
    _lib()


def _check(what: str, x, w_compact, idx, delta=None):
    """Shapes, dtypes, devices and layout. Returns ``(b, k, j, t, bk, bo)``."""
    if x.dim() != 2 or w_compact.dim() != 4 or idx.dim() != 2:
        raise ValueError(f"{what}: need x [B,K], w_compact [J,T,bk,bo], idx [J,T]")
    b, k = x.shape
    j, t, bk, bo = w_compact.shape
    if tuple(idx.shape) != (j, t) or k % bk or (
            delta is not None and tuple(delta.shape) != (b, j, t, bk, bo)):
        raise ValueError(f"{what}: shapes x{tuple(x.shape)} "
                         f"wc{tuple(w_compact.shape)} idx{tuple(idx.shape)}"
                         + ("" if delta is None else f" delta{tuple(delta.shape)}"))
    tensors = {"x": x, "w_compact": w_compact, "idx": idx}
    if delta is not None:
        tensors["delta"] = delta
    if x.dtype not in _DTYPES or any(a.dtype != x.dtype for n, a in tensors.items()
                                     if n != "idx"):
        raise TypeError(f"{what}: x/w_compact/delta must share f32 or bf16, got "
                        + "/".join(str(a.dtype) for n, a in tensors.items()
                                   if n != "idx"))
    if idx.dtype != torch.int32:
        raise TypeError(f"{what}: idx must be int32, got {idx.dtype}")
    for name, a in tensors.items():
        if not a.is_cuda or a.device != x.device:
            raise ValueError(f"{what}: {name} is not on {x.device}")
        # delta's rows may lie apart (one layer of slot-leading deltas),
        # each row contiguous and starting on a 16-byte boundary
        rows_apart = name == "delta" and a[:1].is_contiguous() \
            and a.stride(0) * a.element_size() % 16 == 0
        if not (a.is_contiguous() or rows_apart):
            raise ValueError(f"{what}: {name} must be contiguous"
                             + (" in each row, rows 16-byte aligned"
                                if name == "delta" else ""))
        if takes_gather_kernel(k, bk, bo) and a.data_ptr() % 16:
            raise ValueError(f"{what}: {name} must start on a 16-byte boundary")
    return b, k, j, t, bk, bo


def _raise_on(err: int, what: str) -> None:
    if err != 0:
        raise RuntimeError(f"{what} kernel launch failed: cudaError {err}")


def _launch_gather(x, w_compact, idx, delta, y, b, k, j, t) -> None:
    cfg = ell_launch_config(b, k, j, fused=delta is not None)
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        err = _lib().nm_spmm_ell_launch(
            x.data_ptr(), w_compact.data_ptr(), idx.data_ptr(),
            None if delta is None else delta.data_ptr(),
            0 if delta is None else delta.stride(0), y.data_ptr(),
            b, k, j, t, cfg.block_rows.bit_length() - 1,
            cfg.block_cols.bit_length() - 1, cfg.threads, cfg.smem_bytes,
            _DTYPES[x.dtype], stream)
    _raise_on(err, "nm_spmm")


def nm_spmm_cuda(x: torch.Tensor, w_compact: torch.Tensor,
                 idx: torch.Tensor) -> torch.Tensor:
    """``y [B, J*bo]`` on the card; ``x [B, K]`` and ``w_compact
    [J, T, bk, bo]`` f32 or bf16 of one dtype, ``idx [J, T]`` int32, all
    contiguous CUDA tensors of one device (16-byte aligned for the gather
    kernel). Raises on anything else."""
    b, k, j, t, bk, bo = _check("nm_spmm", x, w_compact, idx)
    y = torch.empty((b, j * bo), dtype=x.dtype, device=x.device)
    if b == 0 or j == 0:
        return y                # nothing to compute: no launch
    if takes_gather_kernel(k, bk, bo):
        _launch_gather(x, w_compact, idx, None, y, b, k, j, t)
    else:
        cfg = tiled_launch_config(k, j, t, bk, bo, x.element_size())
        # the runtime launches (and sets the shared-memory attribute) on the
        # current device, so make it the tensors' device
        with torch.cuda.device(x.device):
            stream = torch.cuda.current_stream(x.device).cuda_stream
            err = _lib().nm_spmm_launch(
                x.data_ptr(), w_compact.data_ptr(), idx.data_ptr(), y.data_ptr(),
                b, k, j, t, bk, bo, cfg.bn, cfg.jg, cfg.bnc, cfg.ngroups,
                cfg.smem_bytes, _DTYPES[x.dtype], stream)
        _raise_on(err, "nm_spmm")
    nm_spmm_cuda.launches += 1
    return y


def nm_spmm_fused_cuda(x: torch.Tensor, w_compact: torch.Tensor,
                       idx: torch.Tensor, delta: torch.Tensor) -> torch.Tensor:
    """``y = x @ densify(w_compact) + (x[s] @ densify(delta[s]))_s`` in one
    launch of the gather kernel; operands as for :func:`nm_spmm_cuda`, with
    ``delta [B, J, T, 1, 1]`` of x's dtype. Only the element-granular layout
    (bk = bo = 1, K a multiple of 4) has the fused kernel; raises on
    anything else. Counts on ``nm_spmm_cuda.launches`` as well as its own counter."""
    b, k, j, t, bk, bo = _check("nm_spmm_fused", x, w_compact, idx, delta)
    if not takes_gather_kernel(k, bk, bo):
        raise ValueError(f"nm_spmm_fused: the fused kernel takes bk = bo = 1 "
                         f"and K a multiple of 4, got bk={bk}, bo={bo}, K={k}")
    y = torch.empty((b, j), dtype=x.dtype, device=x.device)
    if b == 0 or j == 0:
        return y                # nothing to compute: no launch
    _launch_gather(x, w_compact, idx, delta, y, b, k, j, t)
    nm_spmm_cuda.launches += 1
    nm_spmm_fused_cuda.launches += 1
    return y


nm_spmm_cuda.launches = 0
nm_spmm_fused_cuda.launches = 0
