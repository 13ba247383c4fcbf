"""Causal GQA flash attention: the forward as a CUDA kernel (``flash_fwd``)
for the LM prefill; the backward waits for LM training."""
