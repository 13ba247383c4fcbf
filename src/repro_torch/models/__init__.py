"""LM model zoo (``repro.models``) for every family of the pool (dense,
moe, ssm, hybrid, vlm, audio): pure functions over parameter dict trees
(init / apply), per-layer leaves stacked ``[L, ...]`` as in the reference.
``mamba2.py`` is the ssm and hybrid families' mixer."""
from . import layers, mamba2, moe, transformer  # noqa: F401
