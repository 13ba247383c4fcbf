"""The ``moe`` family into the port: its ``ModelConfig`` and its tree
(``models/moe.moe_init``: ``w1`` the gate projection, ``w3`` the up
projection, ``w2`` the down projection)."""
from __future__ import annotations

from typing import Dict

MAP = [("embed", ("embed", "tok")),
       ("head", ("lm_head",)),
       ("final_norm", ("final_norm",)),
       ("norm1", ("layers", "norm1")),
       ("wq", ("layers", "attn", "wq", "w")),
       ("wk", ("layers", "attn", "wk", "w")),
       ("wv", ("layers", "attn", "wv", "w")),
       ("wo", ("layers", "attn", "wo", "w")),
       ("norm2", ("layers", "norm2")),
       ("router", ("layers", "moe", "router")),
       ("w_gate", ("layers", "moe", "w1", "w")),
       ("w_up", ("layers", "moe", "w3", "w")),
       ("w_down", ("layers", "moe", "w2", "w"))]

FIELDS = ("name", "family", "n_layers", "d_model", "n_heads", "n_kv_heads",
          "d_head", "d_ff", "vocab", "act", "rope_theta", "moe_experts",
          "moe_top_k", "moe_capacity_factor", "moe_shard_experts",
          "norm_eps", "dtype", "remat")


def model_config(port: Dict):
    from repro_torch.configs.base import ModelConfig
    return ModelConfig(**{k: port[k] for k in FIELDS if k in port})
