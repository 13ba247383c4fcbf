"""Fused AdamW for LM training: the gradients' sum of squares and the
in-place update, each one CUDA launch over the whole parameter tree. No
TPU kernel: the reference's update is jnp that XLA fuses."""
