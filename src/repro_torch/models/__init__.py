"""LM model zoo (``repro.models``) for the attention families the port
serves (dense, vlm, audio): pure functions over parameter dict trees
(init / apply), per-layer leaves stacked ``[L, ...]`` as in the reference.
MoE (``moe.py``) and Mamba2 (``mamba2.py``) are not ported yet."""
from . import layers, transformer  # noqa: F401
