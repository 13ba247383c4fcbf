"""LM model zoo (``repro.models``) for the attention families the port
serves (dense, moe, vlm, audio): pure functions over parameter dict trees
(init / apply), per-layer leaves stacked ``[L, ...]`` as in the reference.
Mamba2 (``mamba2.py``) is not ported yet."""
from . import layers, moe, transformer  # noqa: F401
