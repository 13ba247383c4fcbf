"""Zamba2-1.2B — Mamba2 trunk + ONE shared attention+MLP block applied every
6 layers (weights reused across invocations) [arXiv:2411.15242; hf].
``long_500k`` runs here (SSM state + periodically-refreshed shared-attn ring
caches)."""
from .base import ModelConfig

CONFIG = ModelConfig(
    name="zamba2-1.2b", family="hybrid",
    n_layers=38, d_model=2048, n_heads=32, n_kv_heads=32, d_head=64,
    d_ff=8192, vocab=32000, act="swiglu", rope_theta=1e4,
    ssm_state=64, ssm_head_dim=64, ssm_expand=2, ssm_conv=4, ssm_chunk=256,
    hybrid_attn_every=6,
    swa_window=4096,   # shared-block ring cache bound for long-context decode
)
