"""Causal GQA flash attention: the forward (``flash_fwd``) and the two
backward kernels (``flash_bwd``: dK/dV and dQ) as CUDA kernels, for LM
prefill and training."""
