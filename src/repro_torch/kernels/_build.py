"""Build CUDA C++ kernel sources with ``nvcc`` and load them with ``ctypes``.

The sources have a plain C interface (no PyTorch headers), so one ``nvcc``
call per library takes seconds; the shared object lands in
``build/torch_kernels/`` inside the checkout and is rebuilt whenever a
source, or a header it includes by ``#include "..."``, is newer than it.
Libraries are built once per process.
"""
from __future__ import annotations

import ctypes
import functools
import os
import pathlib
import re
import shutil
import subprocess

REPO_ROOT = pathlib.Path(__file__).resolve().parents[3]
BUILD_DIR = REPO_ROOT / "build" / "torch_kernels"
ARCH_FLAGS = ("-gencode=arch=compute_90a,code=sm_90a",)


def nvcc_path() -> str:
    """``$CUDA_HOME/bin/nvcc``, else ``/usr/local/cuda/bin/nvcc``, else PATH."""
    for home in (os.environ.get("CUDA_HOME"), "/usr/local/cuda"):
        if home and os.path.exists(os.path.join(home, "bin", "nvcc")):
            return os.path.join(home, "bin", "nvcc")
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found: set CUDA_HOME or put nvcc on PATH")
    return found


_LOCAL_INCLUDE = re.compile(r'^\s*#\s*include\s+"([^"]+)"', re.MULTILINE)


def local_headers(path: str) -> list:
    """The headers ``path`` includes by ``#include "..."``, found beside the
    including file, and theirs in turn."""
    seen, todo = [], [path]
    while todo:
        cur = todo.pop()
        with open(cur) as f:
            text = f.read()
        for name in _LOCAL_INCLUDE.findall(text):
            hdr = os.path.join(os.path.dirname(cur), name)
            if os.path.exists(hdr) and hdr not in seen:
                seen.append(hdr)
                todo.append(hdr)
    return seen


def stale(out: pathlib.Path, sources) -> bool:
    """Whether ``out`` is missing or older than a source or a header one
    includes."""
    watched = [*sources, *(h for src in sources for h in local_headers(src))]
    return not out.exists() or os.path.getmtime(out) < max(
        os.path.getmtime(w) for w in watched)


@functools.cache
def load_library(name: str, *sources: str) -> ctypes.CDLL:
    """Compile ``sources`` (paths) into ``lib<name>.so`` and load it.

    ``load_library.ptxas_log[name]`` keeps what ``ptxas -v`` said
    (registers, shared memory and spills of each kernel), also kept beside
    the library for a build made earlier.
    """
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    out = BUILD_DIR / f"lib{name}.so"
    log = BUILD_DIR / f"lib{name}.ptxas.txt"
    if stale(out, sources):
        tmp = out.with_suffix(f".{os.getpid()}.tmp")
        cmd = [nvcc_path(), *ARCH_FLAGS, "-std=c++17", "-O3", "-Xptxas=-v",
               "-shared", "-Xcompiler", "-fPIC", "-o", str(tmp), *sources]
        proc = subprocess.run(cmd, capture_output=True, text=True)
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed for {name}:\n{proc.stderr}")
        log.write_text(proc.stderr)
        os.replace(tmp, out)
    load_library.ptxas_log[name] = log.read_text() if log.exists() else ""
    return ctypes.CDLL(str(out))


load_library.ptxas_log = {}
