"""Gated three-factor sparse weight update: the batch-summed ``wu_outer``
(CUDA kernel for the training path, the add into the weights fused in) and
the per-slot ``wu_outer_slots`` (CUDA kernel updating the serving deltas in
place)."""
