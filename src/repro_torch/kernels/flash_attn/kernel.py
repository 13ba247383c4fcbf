"""Launch of the hand-written CUDA flash-attention kernels: the forward
(``flash_attn.cu``) and the two backward kernels (``flash_bwd.cu``), each
source its own library, so the two build in parallel.

Replaces ``src/repro/kernels/flash_attn/kernel.py``: ``flash_fwd`` (body
``_fwd_kernel``) and ``flash_bwd`` (``_dkv_kernel``, ``_dq_kernel``). The
design notes (what bounds each kernel, how a block walks its tiles) head
the CUDA sources; the three bf16 kernels share the Hopper building blocks
of ``hopper.cuh`` (wgmma, TMA, mbarriers). This module holds
what surrounds the kernels and the CPU tests can reach: grids, tile sizes,
threads and shared memory (:func:`launch_config`, :func:`bwd_launch_config`),
the dK/dV head split (:func:`dkv_gsplit`, :func:`dkv_heads`), the tiles a
block visits (:func:`kv_tile_range`, :func:`q_tile_range`) and the tiles it
masks (:func:`tile_needs_mask`), all mirrored from the sources, argument
checks, and one launch counter per kernel.
"""
from __future__ import annotations

import ctypes
import dataclasses
import functools
import os
from typing import Optional, Tuple

import torch

SOURCE = os.path.join(os.path.dirname(os.path.abspath(__file__)), "flash_attn.cu")
THREADS = {torch.bfloat16: 384, torch.float32: 128}   # bf16: producer + 2 consumers
TILES = {torch.bfloat16: (128, None), torch.float32: (32, 32)}   # (query rows, keys)
FWD_BK = {64: 128, 128: 128, 160: 64}   # bf16: keys per KV tile by head width
FWD_STAGES = 3                   # bf16: K/V tiles in flight (TMA ring)
SMEM_EXTRA = 64 + 1024           # bf16: mbarriers + room to align tiles to 1 KB
HEAD_DIMS = (64, 128, 160)       # head widths with a kernel instance
SMEM_LIMIT = 232448              # opt-in shared memory per block on sm_90
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}


@dataclasses.dataclass(frozen=True)
class LaunchConfig:
    bq: int          # query rows per block
    bk: int          # keys per KV tile
    nq: int          # query tiles (grid x); grid y is B*H
    nbh: int         # batch * query heads
    threads: int
    smem_bytes: int


def launch_config(b: int, s: int, h: int, dh: int,
                  dtype: torch.dtype) -> LaunchConfig:
    """Grid and shared memory of one launch: one block per (batch*head,
    query tile). bf16 keeps the q tile and a ring of ``FWD_STAGES`` K and V
    tiles of ``FWD_BK[dh]`` keys (TMA, 64-byte swizzle, no padding) plus its
    mbarriers; f32 stages one K and one V tile."""
    if dtype not in TILES:
        raise TypeError(f"flash_fwd: no kernel for {dtype}")
    if dh not in HEAD_DIMS:
        raise ValueError(f"flash_fwd: no kernel instance for head width {dh} "
                         f"(have {HEAD_DIMS})")
    bq, bk = TILES[dtype]
    if dtype == torch.bfloat16:
        bk = FWD_BK[dh]
        smem = 2 * dh * (bq + 2 * FWD_STAGES * bk) + SMEM_EXTRA
    else:
        smem = 4 * 2 * bk * dh
    if smem > SMEM_LIMIT:
        raise ValueError(f"flash_fwd: head width {dh} needs {smem} bytes of "
                         f"shared memory (> {SMEM_LIMIT})")
    return LaunchConfig(bq=bq, bk=bk, nq=-(-s // bq), nbh=b * h,
                        threads=THREADS[dtype], smem_bytes=smem)


def tile_needs_mask(q0: int, q1: int, k0: int, k1: int, t: int,
                    window: Optional[int]) -> bool:
    """Whether query rows ``[q0, q1)`` by keys ``[k0, k1)`` (``k1`` not
    clipped to ``t``) hold a pair that is not visible: a key at or past
    ``t``, a key above the diagonal, or a pair at or past the window. The
    bf16 kernels mask only such tiles (``tile_needs_mask`` in both CUDA
    sources); every other tile is wholly visible."""
    return (k1 > t or k1 - 1 > q0
            or (window is not None and q1 - 1 - k0 >= window))


def kv_tile_range(q0: int, q1: int, t: int, window: Optional[int],
                  bk: int) -> Tuple[int, int]:
    """KV tiles ``[lo, hi)`` the block of query rows ``[q0, q1)`` visits:
    those holding a key ``j <= q1 - 1`` and, with a window,
    ``j >= q0 - window + 1`` (``kv_tile_range`` in ``flash_attn.cu``)."""
    end = min(t, q1)
    start = max(0, q0 - window + 1) if window is not None else 0
    return start // bk, -(-end // bk)


@functools.cache
def _lib():
    from .._build import load_library
    lib = load_library("flash_attn", SOURCE)
    lib.flash_fwd_launch.restype = ctypes.c_int
    lib.flash_fwd_launch.argtypes = (
        [ctypes.c_void_p] * 5 + [ctypes.c_longlong] * 12 + [ctypes.c_int] * 7
        + [ctypes.c_float] + [ctypes.c_int] * 3 + [ctypes.c_void_p])
    lib.flash_fwd_tiles.restype = None
    lib.flash_fwd_tiles.argtypes = [ctypes.POINTER(ctypes.c_int)]
    tiles = (ctypes.c_int * 14)()
    lib.flash_fwd_tiles(tiles)
    bf, f32 = torch.bfloat16, torch.float32
    want = (THREADS[bf], TILES[bf][0], THREADS[f32], *TILES[f32],
            *(x for dh in HEAD_DIMS for x in (
                FWD_BK[dh], FWD_STAGES, launch_config(1, 1, 1, dh, bf).smem_bytes)))
    if tuple(tiles) != want:
        raise RuntimeError(f"flash_attn.cu tiles {tuple(tiles)} disagree with "
                           f"kernel.py {want}")
    return lib


def build() -> None:
    """Compile and load the kernel library now (otherwise: at first launch)."""
    _lib()


def row_aligned(a: torch.Tensor) -> bool:
    """Whether the kernels can read ``a`` through its strides: a contiguous
    last dim, every other stride and the base a multiple of 16 bytes."""
    es = a.element_size()
    return (a.stride(-1) == 1 and a.data_ptr() % 16 == 0
            and not any(st * es % 16 for st in a.stride()[:-1]))


def _check_qkv(what: str, q, k, v, window, **more) -> Tuple[int, int, int, int]:
    """Shapes, dtypes, devices and strides of the model-layout operands
    (``more``: further tensors laid out as ``q``). Returns ``(B, S, H, dh)``."""
    if q.dim() != 4 or k.dim() != 4 or v.dim() != 4:
        raise ValueError(f"{what}: need q [B,S,H,dh], k/v [B,T,KV,dh]")
    b, s, h, dh = q.shape
    t, kvh = k.shape[1], k.shape[2]
    if tuple(k.shape) != (b, t, kvh, dh) or v.shape != k.shape \
            or kvh == 0 or h % kvh \
            or any(a.shape != q.shape for a in more.values()):
        raise ValueError(f"{what}: shapes q{tuple(q.shape)} "
                         f"k{tuple(k.shape)} v{tuple(v.shape)} "
                         + " ".join(f"{n}{tuple(a.shape)}" for n, a in more.items()))
    tensors = {"q": q, "k": k, "v": v, **more}
    if q.dtype not in _DTYPES or any(a.dtype != q.dtype for a in tensors.values()):
        raise TypeError(f"{what}: operands must share f32 or bf16, got "
                        + "/".join(str(a.dtype) for a in tensors.values()))
    if window is not None and window < 1:
        raise ValueError(f"{what}: window must be >= 1, got {window}")
    for name, a in tensors.items():
        if not a.is_cuda or a.device != q.device:
            raise ValueError(f"{what}: {name} is not on {q.device}")
        if not row_aligned(a):
            raise ValueError(f"{what}: {name} needs a contiguous last dim "
                             f"and 16-byte aligned rows, strides {a.stride()}")
    if t == 0 and q.numel():
        raise ValueError(f"{what}: no keys to attend to")
    return b, s, h, dh


MAP_ERROR = 10000                # hopper.cuh: MAP_ERROR + CUresult


def _raise_on(err: int, what: str) -> None:
    if err >= MAP_ERROR:
        raise RuntimeError(f"{what}: cuTensorMapEncodeTiled failed: CUresult "
                           f"{err - MAP_ERROR}")
    if err != 0:
        raise RuntimeError(f"{what} kernel launch failed: cudaError {err}")


def flash_fwd_cuda(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                   window: Optional[int] = None
                   ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Causal attention on the card in the model layout: ``q [B, S, H, dh]``,
    ``k, v [B, T, KV, dh]`` of one dtype (f32 or bf16), ``H`` a multiple of
    ``KV``, the last dim contiguous and every other stride a multiple of 16
    bytes. Returns ``(out [B, S, H, dh], lse [B*H, S] f32)``. Raises on
    anything else."""
    b, s, h, dh = _check_qkv("flash_fwd", q, k, v, window)
    t, kvh = k.shape[1], k.shape[2]
    cfg = launch_config(b, s, h, dh, q.dtype)
    out = torch.empty((b, s, h, dh), dtype=q.dtype, device=q.device)
    lse = torch.empty((b * h, s), dtype=torch.float32, device=q.device)
    if out.numel() == 0:
        return out, lse          # nothing to compute: no launch
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        err = _lib().flash_fwd_launch(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
            lse.data_ptr(), *q.stride()[:3], *k.stride()[:3],
            *v.stride()[:3], *out.stride()[:3], b, s, t, h, kvh, dh,
            window or 0, dh ** -0.5, cfg.nq, cfg.smem_bytes,
            _DTYPES[q.dtype], stream)
    _raise_on(err, "flash_fwd")
    flash_fwd_cuda.launches += 1
    return out, lse


flash_fwd_cuda.launches = 0


# ---------------------------------------------------------------------------
# backward: flash_bwd.cu (dK/dV and dQ)
# ---------------------------------------------------------------------------

BWD_SOURCE = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                          "flash_bwd.cu")
# (rows a block owns, rows of each inner tile). bf16 (wgmma): dK/dV 128-key
# blocks over query tiles of DKV_QTILE[dh], dQ 128-query blocks over key
# tiles of DQ_KTILE[dh]; f32 (FMA): 32 and 32 for both.
BWD_TILES = {torch.bfloat16: {"dkv": (128, None), "dq": (128, None)},
             torch.float32: {"dkv": (32, 32), "dq": (32, 32)}}
DKV_QTILE = {64: 64, 128: 64, 160: 32}   # bf16 dK/dV query tile by head width
DQ_KTILE = {64: 128, 128: 128, 160: 64}  # bf16 dQ key tile by head width
BWD_THREADS = 384                # bf16: a producer + two consumer warpgroups
DKV_STAGES = 2                   # bf16 dK/dV: (q, dO) tiles in flight
DQ_STAGES = 2                    # bf16 dQ: (K, V) tiles in flight
NUM_SMS = 132                    # H100 SXM
DKV_MIN_BLOCKS = 4 * NUM_SMS     # the head split's target: 4 blocks per SM


@dataclasses.dataclass(frozen=True)
class BwdLaunchConfig:
    block_rows: int  # keys (dK/dV) or queries (dQ) a block owns
    tile: int        # queries (dK/dV) or keys (dQ) per inner tile
    grid: Tuple[int, int]
    smem_bytes: int
    gsplit: int = 1  # dK/dV: blocks sharing one GQA group's heads


def dkv_gsplit(b: int, kvh: int, g: int, t: int) -> int:
    """The bf16 dK/dV head split: the smallest divisor of the group size
    ``g`` that gives at least ``DKV_MIN_BLOCKS`` blocks of 128 keys, else
    ``g`` (one head per block)."""
    nk = -(-t // BWD_TILES[torch.bfloat16]["dkv"][0])
    for d in range(1, g + 1):
        if g % d == 0 and b * kvh * d * nk >= DKV_MIN_BLOCKS:
            return d
    return g


def dkv_heads(kvh: int, gs: int, g: int, gsplit: int) -> range:
    """Query heads that split ``gs`` of KV head ``kvh`` sums over
    (``h0`` in ``flash_bwd_dkv_wgmma``)."""
    per = g // gsplit
    return range(kvh * g + gs * per, kvh * g + (gs + 1) * per)


def bwd_launch_config(which: str, b: int, s: int, t: int, h: int, kvh: int,
                      dh: int, dtype: torch.dtype) -> BwdLaunchConfig:
    """Grid and shared memory of one backward launch. ``which="dkv"``: one
    block per (batch·KV head·head split, key tile), grid ``(B·KV·gsplit,
    key tiles)``; bf16 keeps its K and V tiles and a ring of ``DKV_STAGES``
    (q, dO) tiles (TMA, 64-byte swizzle) with their lse and delta rows, f32
    stages the q, do, lse and delta tiles (``gsplit`` 1). ``which="dq"``:
    one block per (query tile, batch·head), grid ``(query tiles, B·H)``;
    bf16 keeps its q and dO tiles and a ring of ``DQ_STAGES`` K and V tiles
    of ``DQ_KTILE[dh]`` keys (TMA, 64-byte swizzle), f32 stages one K and
    one V tile."""
    if dtype not in BWD_TILES:
        raise TypeError(f"flash_bwd: no kernel for {dtype}")
    if dh not in HEAD_DIMS:
        raise ValueError(f"flash_bwd: no kernel instance for head width {dh} "
                         f"(have {HEAD_DIMS})")
    rows, tile = BWD_TILES[dtype][which]
    gsplit = 1
    if dtype == torch.bfloat16 and which == "dkv":
        tile = DKV_QTILE[dh]
        smem = (2 * 2 * rows * dh + DKV_STAGES * (2 * 2 * tile * dh + 2 * 4 * tile)
                + SMEM_EXTRA)
        gsplit = dkv_gsplit(b, kvh, h // kvh, t)
    elif dtype == torch.bfloat16:
        tile = DQ_KTILE[dh]
        smem = 2 * 2 * rows * dh + DQ_STAGES * 2 * 2 * tile * dh + SMEM_EXTRA
    else:
        smem = 4 * 2 * tile * dh + (8 * tile if which == "dkv" else 0)
    if smem > SMEM_LIMIT:
        raise ValueError(f"flash_bwd: head width {dh} needs {smem} bytes of "
                         f"shared memory (> {SMEM_LIMIT})")
    grid = ((b * kvh * gsplit, -(-t // rows)) if which == "dkv"
            else (-(-s // rows), b * h))
    return BwdLaunchConfig(block_rows=rows, tile=tile, grid=grid,
                           smem_bytes=smem, gsplit=gsplit)


def q_tile_range(k0: int, k1: int, s: int, window: Optional[int],
                 bq: int) -> Tuple[int, int]:
    """Query tiles ``[lo, hi)`` the dK/dV block of keys ``[k0, k1)`` visits:
    those holding a row ``i >= k0`` and, with a window, ``i <= k1 - 2 +
    window``, all below ``s`` (``q_tile_range`` in ``flash_bwd.cu``)."""
    end = min(s, k1 - 1 + window) if window is not None else s
    return k0 // bq, -(-end // bq)


@functools.cache
def _bwd_lib():
    from .._build import load_library
    lib = load_library("flash_bwd", BWD_SOURCE)
    lib.flash_bwd_launch.restype = ctypes.c_int
    lib.flash_bwd_launch.argtypes = (
        [ctypes.c_int] + [ctypes.c_void_p] * 10 + [ctypes.c_longlong] * 18
        + [ctypes.c_int] * 7 + [ctypes.c_float] + [ctypes.c_int] * 5
        + [ctypes.c_void_p])
    lib.flash_bwd_tiles.restype = None
    lib.flash_bwd_tiles.argtypes = [ctypes.POINTER(ctypes.c_int)]
    tiles = (ctypes.c_int * 19)()
    lib.flash_bwd_tiles(tiles)
    bf, f32 = BWD_TILES[torch.bfloat16], BWD_TILES[torch.float32]
    per_dh = [(DKV_QTILE[dh], bwd_launch_config(
        "dkv", 1, 1, 1, 1, 1, dh, torch.bfloat16).smem_bytes,
        DQ_KTILE[dh], bwd_launch_config(
        "dq", 1, 1, 1, 1, 1, dh, torch.bfloat16).smem_bytes) for dh in HEAD_DIMS]
    want = (THREADS[torch.float32], f32["dkv"][0], BWD_THREADS, bf["dkv"][0],
            DKV_STAGES, bf["dq"][0], DQ_STAGES,
            *(x for four in per_dh for x in four))
    if tuple(tiles) != want or f32["dkv"] != f32["dq"] \
            or f32["dkv"][0] != f32["dkv"][1]:
        raise RuntimeError(f"flash_bwd.cu tiles {tuple(tiles)} disagree with "
                           f"kernel.py {want}")
    return lib


def build_bwd() -> None:
    """Compile and load the backward library now (otherwise: at first launch)."""
    _bwd_lib()


def _check_rows(what: str, q, lse, delta) -> None:
    b, s, h, _ = q.shape
    for name, a in (("lse", lse), ("delta", delta)):
        if a.dtype != torch.float32 or tuple(a.shape) != (b * h, s) \
                or not a.is_contiguous() or a.device != q.device:
            raise ValueError(f"{what}: {name} must be contiguous f32 [B*H, S] "
                             f"= ({b * h}, {s}) on {q.device}, got "
                             f"{a.dtype} {tuple(a.shape)}")


def _bwd_launch(which: str, q, k, v, dout, lse, delta, window, dq, dk, dv):
    """One launch. bf16 dK/dV with a head split > 1 writes each split's f32
    partials to a workspace; they are summed here in split order and
    rounded once into ``dk``, ``dv``."""
    b, s, h, dh = q.shape
    t, kvh = k.shape[1], k.shape[2]
    cfg = bwd_launch_config(which, b, s, t, h, kvh, dh, q.dtype)
    ws = None
    if cfg.gsplit > 1:
        ws = torch.empty((2, cfg.gsplit, b, t, kvh, dh), dtype=torch.float32,
                         device=q.device)
    zero = (0, 0, 0)
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        err = _bwd_lib().flash_bwd_launch(
            0 if which == "dkv" else 1, q.data_ptr(), k.data_ptr(),
            v.data_ptr(), dout.data_ptr(), lse.data_ptr(), delta.data_ptr(),
            *(None if a is None else a.data_ptr() for a in (dq, dk, dv, ws)),
            *q.stride()[:3], *k.stride()[:3], *v.stride()[:3],
            *dout.stride()[:3],
            *(dq.stride()[:3] if dq is not None else zero),
            *(dk.stride()[:3] if dk is not None else zero),
            b, s, t, h, kvh, dh, window or 0, dh ** -0.5, cfg.gsplit,
            *cfg.grid, cfg.smem_bytes, _DTYPES[q.dtype], stream)
        _raise_on(err, f"flash_bwd_{which}")
        if ws is not None:
            summed = ws.sum(1)
            dk.copy_(summed[0])
            dv.copy_(summed[1])


def flash_bwd_dkv_cuda(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                       dout: torch.Tensor, lse: torch.Tensor,
                       delta: torch.Tensor, window: Optional[int] = None
                       ) -> Tuple[torch.Tensor, torch.Tensor]:
    """dK and dV on the card in the model layout: ``q, dout [B, S, H, dh]``,
    ``k, v [B, T, KV, dh]`` of one dtype (f32 or bf16; strides as for
    :func:`flash_fwd_cuda`), the forward's ``lse`` and ``delta =
    rowsum(dout·out)`` as contiguous f32 ``[B*H, S]``. Returns ``(dk, dv)``
    ``[B, T, KV, dh]`` in k's dtype, each summed in f32 over the G query
    heads of its KV head (inside the kernel, or over the head split's
    partials after it) and rounded once. Raises on anything else."""
    _check_qkv("flash_bwd_dkv", q, k, v, window, dout=dout)
    _check_rows("flash_bwd_dkv", q, lse, delta)
    dk, dv = torch.empty_like(k, memory_format=torch.contiguous_format), \
        torch.empty_like(v, memory_format=torch.contiguous_format)
    if dk.numel() == 0:
        return dk, dv                # nothing to compute: no launch
    if q.numel() == 0:
        return dk.zero_(), dv.zero_()
    _bwd_launch("dkv", q, k, v, dout, lse, delta, window, None, dk, dv)
    flash_bwd_dkv_cuda.launches += 1
    return dk, dv


def flash_bwd_dq_cuda(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                      dout: torch.Tensor, lse: torch.Tensor,
                      delta: torch.Tensor, window: Optional[int] = None
                      ) -> torch.Tensor:
    """dQ on the card, operands as for :func:`flash_bwd_dkv_cuda`. Returns
    ``dq [B, S, H, dh]`` in q's dtype. Raises on anything else."""
    _check_qkv("flash_bwd_dq", q, k, v, window, dout=dout)
    _check_rows("flash_bwd_dq", q, lse, delta)
    dq = torch.empty_like(q, memory_format=torch.contiguous_format)
    if dq.numel() == 0:
        return dq                    # nothing to compute: no launch
    _bwd_launch("dq", q, k, v, dout, lse, delta, window, dq, None, None)
    flash_bwd_dq_cuda.launches += 1
    return dq


flash_bwd_dkv_cuda.launches = 0
flash_bwd_dq_cuda.launches = 0
