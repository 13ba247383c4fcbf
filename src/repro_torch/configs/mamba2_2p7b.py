"""Mamba2-2.7B — attention-free SSD [arXiv:2405.21060].

d_inner = 2·2560 = 5120, head_dim 64 → 80 SSD heads, state N=128.
``long_500k`` runs here (recurrent decode, O(state) memory).
"""
from .base import ModelConfig

CONFIG = ModelConfig(
    name="mamba2-2.7b", family="ssm",
    n_layers=64, d_model=2560, n_heads=0, n_kv_heads=0,
    d_ff=0, vocab=50280, rope_mode="none",
    ssm_state=128, ssm_head_dim=64, ssm_expand=2, ssm_conv=4, ssm_chunk=256,
    d_head=64,
)
