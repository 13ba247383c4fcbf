"""The ``mixed`` family (Nemotron-H) into the port: its ``ModelConfig``
and its tree (``models/transformer``'s mixed family: each kind's leaves
stacked over that kind's layers, ``layers.norm`` / ``a_log`` /
``dt_bias`` over all of them; the experts' ``w1`` up and ``w2`` down,
the shared expert an MLP under ``moe/shared``)."""
from __future__ import annotations

from typing import Dict

MAP = [("embed", ("embed", "tok")),
       ("head", ("lm_head",)),
       ("final_norm", ("final_norm",)),
       ("norm", ("layers", "norm")),
       ("a_log", ("layers", "a_log")),
       ("dt_bias", ("layers", "dt_bias")),
       ("mamba.in_proj", ("mamba", "in_proj", "w")),
       ("mamba.conv_w", ("mamba", "conv_w")),
       ("mamba.conv_b", ("mamba", "conv_b")),
       ("mamba.d_skip", ("mamba", "d_skip")),
       ("mamba.norm_g", ("mamba", "norm_g")),
       ("mamba.out_proj", ("mamba", "out_proj", "w")),
       ("moe.router", ("moe", "router")),
       ("moe.bias", ("moe", "bias")),
       ("moe.w_up", ("moe", "w1", "w")),
       ("moe.w_down", ("moe", "w2", "w")),
       ("moe.shared_up", ("moe", "shared", "w1", "w")),
       ("moe.shared_down", ("moe", "shared", "w2", "w")),
       ("attn.wq", ("attn", "wq", "w")),
       ("attn.wk", ("attn", "wk", "w")),
       ("attn.wv", ("attn", "wv", "w")),
       ("attn.wo", ("attn", "wo", "w"))]

FIELDS = ("name", "family", "n_layers", "d_model", "n_heads", "n_kv_heads",
          "d_head", "d_ff", "vocab", "act", "rope_theta", "rope_mode",
          "moe_experts", "moe_top_k", "moe_capacity_factor", "moe_scoring",
          "moe_route_scale", "moe_shared_ff", "ssm_state", "ssm_head_dim",
          "ssm_n_heads", "ssm_groups", "ssm_conv", "ssm_expand", "ssm_chunk",
          "layer_pattern", "norm_eps", "dtype", "remat")


def model_config(port: Dict):
    from repro_torch.configs.base import ModelConfig
    return ModelConfig(**{k: port[k] for k in FIELDS if k in port})
