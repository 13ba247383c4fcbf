"""Qwen2-VL-2B backbone — M-RoPE, dynamic-resolution vision [arXiv:2409.12191].

The vision encoder is a STUB per the assignment: ``input_specs`` supplies
precomputed patch embeddings (14×14×3×2 = 1176-dim) which the backbone
projects into d_model. M-RoPE carries 3-axis (t, h, w) positions.
"""
from .base import ModelConfig

CONFIG = ModelConfig(
    name="qwen2-vl-2b", family="vlm",
    n_layers=28, d_model=1536, n_heads=12, n_kv_heads=2, d_head=128,
    d_ff=8960, vocab=151936, act="swiglu",
    rope_mode="mrope", mrope_sections=(16, 24, 24), rope_theta=1e6,
    frontend="vision_stub", frontend_dim=1176,
)
