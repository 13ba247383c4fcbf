"""Mixtral-8x7B — 8-expert top-2 MoE with sliding-window attention
[arXiv:2401.04088; hf]. Experts are big (d_ff=14336): TP *inside* each
expert (F on "model"), not EP — see models/moe.py."""
from .base import ModelConfig

CONFIG = ModelConfig(
    name="mixtral-8x7b", family="moe",
    n_layers=32, d_model=4096, n_heads=32, n_kv_heads=8, d_head=128,
    d_ff=14336, vocab=32000, act="swiglu", rope_theta=1e6,
    swa_window=4096,
    moe_experts=8, moe_top_k=2, moe_shard_experts=False,
)
