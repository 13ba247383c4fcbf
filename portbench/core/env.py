"""The process around a run: the cache directories inside the checkout,
the device check, and the guard against the JAX reference package."""
from __future__ import annotations

import os
import sys

from .spec import REPO

# top-level module names that a run of the port may not hold: JAX, its
# libraries, the JAX package that the port was made from, and the script
# that drives it on the card
FORBIDDEN = ("jax", "jaxlib", "flax", "repro", "chip_smoke")


def prepare() -> None:
    """Put the program's package on the path and every cache it may write
    at a fixed place inside the checkout: the port's ``nvcc`` builds go to
    ``build/torch_kernels/`` (``kernels/_build.py``), Triton's to
    ``build/triton``, torch's extensions to ``build/torch_extensions``.
    ``USE_FLAX=0`` keeps a library that could load JAX from doing so."""
    src = str(REPO / "src")
    if src not in sys.path:
        sys.path.insert(0, src)
    build = REPO / "build"
    os.environ["TRITON_CACHE_DIR"] = str(build / "triton")
    os.environ["TORCH_EXTENSIONS_DIR"] = str(build / "torch_extensions")
    os.environ["USE_FLAX"] = "0"


def forbidden_loaded(modules=None) -> list:
    """The modules of ``modules`` (``sys.modules``) whose top-level name
    (before the first dot) is one of ``FORBIDDEN``, compared whole:
    ``repro_torch`` is not ``repro``."""
    names = list(sys.modules if modules is None else modules)
    return sorted(m for m in names if m.split(".", 1)[0] in FORBIDDEN)


def need_devices(torch, n: int) -> None:
    """Raise unless ``n`` CUDA devices are visible: a run never falls back
    to the CPU."""
    if not torch.cuda.is_available():
        raise SystemExit("no CUDA device: this benchmark measures the card")
    if torch.cuda.device_count() < n:
        raise SystemExit(f"the cell needs {n} CUDA devices, "
                         f"{torch.cuda.device_count()} are visible")
