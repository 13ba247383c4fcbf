"""StableLM-2-12B — dense GQA [hf:stabilityai/stablelm-2-12b]."""
from .base import ModelConfig

CONFIG = ModelConfig(
    name="stablelm-12b", family="dense",
    n_layers=40, d_model=5120, n_heads=32, n_kv_heads=8, d_head=160,
    d_ff=13824, vocab=100352, act="swiglu", rope_theta=1e4,
)
