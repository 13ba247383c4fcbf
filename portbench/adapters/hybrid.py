"""The ``hybrid`` family (Zamba2) into the port: its ``ModelConfig`` and
its tree (``models/mamba2.mamba2_init`` under ``layers/mixer``; the shared
block ``transformer._shared_block_init``: ``mlp`` ``w1`` gate, ``w3`` up,
``w2`` down)."""
from __future__ import annotations

from typing import Dict

MAP = [("embed", ("embed", "tok")),
       ("head", ("lm_head",)),
       ("final_norm", ("final_norm",)),
       ("norm1", ("layers", "norm1")),
       ("in_proj", ("layers", "mixer", "in_proj", "w")),
       ("conv_w", ("layers", "mixer", "conv_w")),
       ("conv_b", ("layers", "mixer", "conv_b")),
       ("a_log", ("layers", "mixer", "a_log")),
       ("d_skip", ("layers", "mixer", "d_skip")),
       ("dt_bias", ("layers", "mixer", "dt_bias")),
       ("norm_g", ("layers", "mixer", "norm_g")),
       ("out_proj", ("layers", "mixer", "out_proj", "w")),
       ("s.norm1", ("shared", "norm1")),
       ("s.wq", ("shared", "attn", "wq", "w")),
       ("s.wk", ("shared", "attn", "wk", "w")),
       ("s.wv", ("shared", "attn", "wv", "w")),
       ("s.wo", ("shared", "attn", "wo", "w")),
       ("s.norm2", ("shared", "norm2")),
       ("s.w_gate", ("shared", "mlp", "w1", "w")),
       ("s.w_up", ("shared", "mlp", "w3", "w")),
       ("s.w_down", ("shared", "mlp", "w2", "w"))]

FIELDS = ("name", "family", "n_layers", "d_model", "n_heads", "n_kv_heads",
          "d_head", "d_ff", "vocab", "act", "rope_theta", "swa_window",
          "ssm_state", "ssm_head_dim", "ssm_conv", "ssm_expand", "ssm_chunk",
          "hybrid_attn_every", "norm_eps", "dtype", "remat")


def model_config(port: Dict):
    from repro_torch.configs.base import ModelConfig
    return ModelConfig(**{k: port[k] for k in FIELDS if k in port})
