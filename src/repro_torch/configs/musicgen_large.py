"""MusicGen-large backbone — decoder-only over EnCodec tokens
[arXiv:2306.05284; hf]. The EnCodec tokenizer is a STUB per the assignment:
``input_specs`` supplies precomputed 128-dim frame embeddings for the train
shape; decode shapes run on the 2048-entry codebook vocabulary."""
from .base import ModelConfig

CONFIG = ModelConfig(
    name="musicgen-large", family="audio",
    n_layers=48, d_model=2048, n_heads=32, n_kv_heads=32, d_head=64,
    d_ff=8192, vocab=2048, act="gelu", rope_theta=1e4,
    frontend="audio_stub", frontend_dim=128,
)
