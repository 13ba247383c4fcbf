"""Architecture registry (``repro.configs``): the 10 assigned configs (+ the
paper's own SNN).

``get_config(name)`` returns the exact published full-scale config;
``get_reduced(name)`` returns a same-family CPU-smoke shrink.
"""
from __future__ import annotations

import dataclasses
import importlib
from typing import Dict, List

from .base import ModelConfig, ShapeConfig, SparsityConfig, SHAPES, shape_applicable  # noqa: F401

ARCH_IDS: List[str] = [
    "deepseek_67b",
    "nemotron_4_15b",
    "stablelm_12b",
    "phi3_medium_14b",
    "qwen2_vl_2b",
    "mixtral_8x7b",
    "moonshot_v1_16b_a3b",
    "mamba2_2p7b",
    "musicgen_large",
    "zamba2_1p2b",
]


def normalize(name: str) -> str:
    return name.replace("-", "_").replace(".", "p")


def get_config(name: str) -> ModelConfig:
    mod = importlib.import_module(f"repro_torch.configs.{normalize(name)}")
    return mod.CONFIG


def make_reduced(cfg: ModelConfig) -> ModelConfig:
    """Shrink any config to a CPU-runnable smoke size of the same family."""
    kv_ratio = max(1, cfg.n_heads // max(1, cfg.n_kv_heads))
    n_heads = 4
    kw = dict(
        name=cfg.name + "-reduced",
        n_layers=4 if cfg.family == "hybrid" else 2,
        d_model=64,
        n_heads=n_heads,
        n_kv_heads=max(1, n_heads // kv_ratio),
        d_head=16,
        d_ff=128 if cfg.d_ff else 0,
        vocab=256,
        dtype="float32",
        remat=False,
    )
    if cfg.rope_mode == "mrope":
        kw["mrope_sections"] = (2, 3, 3)
    if cfg.swa_window:
        kw["swa_window"] = 8
    if cfg.family == "moe":
        kw.update(moe_experts=4, moe_top_k=min(2, cfg.moe_top_k))
    if cfg.family in ("ssm", "hybrid"):
        kw.update(ssm_state=16, ssm_head_dim=16, ssm_chunk=8)
    if cfg.family == "hybrid":
        kw.update(hybrid_attn_every=2)
    if cfg.frontend:
        kw.update(frontend_dim=24)
    if cfg.sparsity:
        kw["sparsity"] = dataclasses.replace(cfg.sparsity, block=8, n=1, m=2)
    return dataclasses.replace(cfg, **kw)


def get_reduced(name: str) -> ModelConfig:
    return make_reduced(get_config(name))


def all_configs() -> Dict[str, ModelConfig]:
    return {a: get_config(a) for a in ARCH_IDS}


def flash_ready(cfg: ModelConfig) -> ModelConfig:
    """``cfg`` with a head width that the flash kernels have an instance
    for (``kernels/flash_attn/kernel.HEAD_DIMS``): a reduced config's
    16-wide heads widen to the smallest (M-RoPE's sections scaled with
    them), so that it takes the flash route on the card; a config whose
    heads have an instance, or that has no attention, is returned as it
    is."""
    from ..kernels.flash_attn.kernel import HEAD_DIMS
    if cfg.family == "ssm" or cfg.head_dim in HEAD_DIMS:
        return cfg
    dh = min(d for d in HEAD_DIMS if d >= cfg.head_dim)
    kw = {"d_head": dh}
    if cfg.rope_mode == "mrope":
        kw["mrope_sections"] = tuple(s * dh // cfg.head_dim
                                     for s in cfg.mrope_sections)
    return dataclasses.replace(cfg, **kw)
