"""Moonlight-16B-A3B (moonshot) — 64-expert top-6 fine-grained MoE
[hf:moonshotai/Moonlight-16B-A3B]. Experts are small (d_ff=1408): EP —
experts sharded over "model" (4 per chip at model=16)."""
from .base import ModelConfig

CONFIG = ModelConfig(
    name="moonshot-v1-16b-a3b", family="moe",
    n_layers=48, d_model=2048, n_heads=16, n_kv_heads=16, d_head=128,
    d_ff=1408, vocab=163840, act="swiglu", rope_theta=5e4,
    moe_experts=64, moe_top_k=6, moe_shard_experts=True,
)
