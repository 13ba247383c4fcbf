"""Nemotron-3-Nano-30B-A3B — 52 single-mixer layers in the published order
(23 Mamba2, 23 MoE, 6 attention) [hf:nvidia/NVIDIA-Nemotron-3-Nano-30B-A3B-BF16].
Mamba2: 64 heads of 64 (``d_inner`` 4096), 8 groups of B and C, state 128,
the gated norm per group; MoE: 128 relu² experts top 6 on sigmoid scores
chosen with a correction bias, gates renormalised × 2.5, one shared relu²
expert of 3712; attention: GQA 32 over 2 KV heads of 128, no position
embedding. The port's own family (``mixed``): not in ``ARCH_IDS``, which
mirrors the JAX registry."""
from .base import ModelConfig

CONFIG = ModelConfig(
    name="nemotron-3-nano-30b-a3b", family="mixed",
    n_layers=52, d_model=2688, n_heads=32, n_kv_heads=2, d_head=128,
    d_ff=1856, vocab=131072, act="relu2", rope_mode="none", rope_theta=1e4,
    moe_experts=128, moe_top_k=6, moe_scoring="sigmoid", moe_route_scale=2.5,
    moe_shared_ff=3712,
    ssm_state=128, ssm_head_dim=64, ssm_n_heads=64, ssm_groups=8,
    ssm_conv=4, ssm_expand=2, ssm_chunk=128,
    layer_pattern="MEMEM*EMEMEM*EMEMEM*EMEMEM*EMEMEM*EMEMEMEM*EMEMEMEME",
)
